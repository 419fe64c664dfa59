"""Mean queries a coalesced device batch of the program's query batcher:
sum over count of its ``batcher.batch_size`` histogram in the window."""

from evdb_bench.readers import hist_mean


def read(ctx):
    return hist_mean(ctx, "batcher.batch_size")
