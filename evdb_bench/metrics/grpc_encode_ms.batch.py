"""Mean milliseconds a gRPC SearchBatch request spends encoding its reply,
from the program's own ``grpc.encode`` span: the ids as strings, the
``SearchBatchReply`` and its ``SerializeToString``."""

from evdb_bench.progspans import mean_request_stage_ms


def read(ctx):
    return mean_request_stage_ms(ctx, "grpc.request", "grpc.encode")
