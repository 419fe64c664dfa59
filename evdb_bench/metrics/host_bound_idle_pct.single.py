"""Share of the traced window (%) with the device idle while a request is
open in the program (a ``*.request`` span): idle a faster host path could
remove.  ``device_idle_pct`` less it is idle with nothing in the system."""

from evdb_bench.progspans import host_bound_idle_pct


def read(ctx):
    return host_bound_idle_pct(ctx)
