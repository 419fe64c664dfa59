"""Mean milliseconds of an MCP request in the frontend itself: its
``mcp.request`` span (line decode to the reply's sendall) less the union of
the batcher, store and index spans of its id and of its device batch's."""

from evdb_bench.progspans import mean_self_ms


def read(ctx):
    return mean_self_ms(ctx, "mcp.request")
