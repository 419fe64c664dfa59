"""Device operations (kernels, copies, fills) in the traced window over the
queries of the requests the program completed in it (its ``*.request``
spans): the launches each query costs the host."""

from evdb_bench.progspans import device_ops_per_query


def read(ctx):
    return device_ops_per_query(ctx)
