"""Seconds of the cellprobe build's k-means++ seeding over its training
sample: ``kpp_s`` of the ``stats.build`` that set-up's ``build_index``
reply carries."""

from evdb_bench.readers import prepare_stat


def read(ctx):
    return prepare_stat(ctx, "kpp_s")
