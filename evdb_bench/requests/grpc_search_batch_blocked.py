"""Request kind ``grpc_search_batch_blocked``: the wire of
``grpc_search_batch`` (its functions, from its file), with the answers
judged by the blocked reference (``reference/exact_blocked.py``), which
fits beside a corpus too large for ``Exact``: at 10M x 768 the corpus and
one block of rows.  The reference is imported where it judges, so that the
client processes, which load this kind to encode, load no ``torch``."""

from __future__ import annotations

from evdb_bench.spec import request_kind

_wire = request_kind("grpc_search_batch")

TRANSPORT = _wire.TRANSPORT
METHOD = _wire.METHOD
ANSWERS = "store"

target = _wire.target
queries_per_request = _wire.queries_per_request
keys = _wire.keys
encode = _wire.encode
answers = _wire.answers


def numbers(answers, queries, data, config: dict, seed: int) -> dict:
    from evdb_bench.reference import exact_blocked

    return exact_blocked.numbers(ANSWERS, answers, queries, data,
                                 config["k"], bits=config["store"]["bits"])
