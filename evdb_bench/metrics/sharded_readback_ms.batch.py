"""Mean milliseconds of a sharded store's readback of a search, from the
program's ``store.readback`` span: the shards' candidates staged to the
host (the wait on the scans, the copies, the all-gather)."""

from evdb_bench.progspans import mean_stage_ms


def read(ctx):
    return mean_stage_ms(ctx, "store.readback")
