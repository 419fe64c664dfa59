"""Mean milliseconds of an ``IndexManager.search`` call (the harness span
around it): routing, the multiprobe glue, B7 and the row mapping."""

from evdb_bench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "index")
