"""Mean milliseconds a gRPC SearchBatch request waits in the query batcher:
its ``batcher.inflight_wait``, ``completion_wait`` and ``delivery_wait``
spans (the in-flight semaphore and the two hand-off queues) summed."""

from evdb_bench.progspans import mean_wait_ms


def read(ctx):
    return mean_wait_ms(ctx, "grpc.request")
