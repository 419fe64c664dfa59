"""Mean milliseconds a single MCP search waits in the query batcher: its
``batcher.queue_wait`` (submit to dispatch) and its device batch's
``inflight_wait``, ``completion_wait`` and ``delivery_wait`` summed."""

from evdb_bench.progspans import mean_wait_ms


def read(ctx):
    return mean_wait_ms(ctx, "mcp.request")
