"""Mean milliseconds of the store's readback of a search ticket, from the
program's ``store.readback`` span: the wait on the ticket's CUDA event and
the one device-to-host copy."""

from evdb_bench.progspans import mean_stage_ms


def read(ctx):
    return mean_stage_ms(ctx, "store.readback")
