"""Mean milliseconds of a sharded store's ``search_batch_submit``, from the
program's ``store.submit`` span: validation, the query's upload and the
shards' scans enqueued."""

from evdb_bench.progspans import mean_stage_ms


def read(ctx):
    return mean_stage_ms(ctx, "store.submit")
