"""Mean milliseconds of a sharded store's merge of a search, from the
program's ``store.merge`` span: the host's stable top-k over the shards'
candidates."""

from evdb_bench.progspans import mean_stage_ms


def read(ctx):
    return mean_stage_ms(ctx, "store.merge")
