"""Mean milliseconds a gRPC SearchBatch request spends decoding, from the
program's own spans: its ``grpc.decode`` parts (the protobuf parse on
grpc's polling thread, then the rows in the handler) summed."""

from evdb_bench.progspans import mean_request_stage_ms


def read(ctx):
    return mean_request_stage_ms(ctx, "grpc.request", "grpc.decode")
