"""Seconds of the cellprobe build's balanced assignment of every row to a
cell: ``assign_s`` of the ``stats.build`` that set-up's ``build_index``
reply carries."""

from evdb_bench.readers import prepare_stat


def read(ctx):
    return prepare_stat(ctx, "assign_s")
