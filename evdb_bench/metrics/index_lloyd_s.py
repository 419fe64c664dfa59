"""Seconds of the cellprobe build's Lloyd iterations over its training
sample: ``lloyd_s`` of the ``stats.build`` that set-up's ``build_index``
reply carries."""

from evdb_bench.readers import prepare_stat


def read(ctx):
    return prepare_stat(ctx, "lloyd_s")
