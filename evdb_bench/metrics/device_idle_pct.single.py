"""Share of the traced window with no device activity on the card (the
union of kernels, copies and fills in the profiler's trace)."""

from evdb_bench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
