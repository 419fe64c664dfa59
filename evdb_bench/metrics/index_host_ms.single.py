"""Mean host milliseconds of an index search: the program's ``index.search``
span less its ``index.readback`` (the copies that wait for the device),
leaving routing, the multiprobe glue's launches and the row mapping."""

from evdb_bench.progspans import mean_less_child_ms


def read(ctx):
    return mean_less_child_ms(ctx, "index.search", "index.readback")
