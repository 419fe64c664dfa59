"""Mean host milliseconds of a store search, from its submit to the end of
its completion (the store, its glue and the kernels; the harness span
around ``search_batch_submit`` .. ``search_batch_complete[_raw]``)."""

from evdb_bench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "store")
