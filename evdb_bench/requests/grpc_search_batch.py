"""Request kind ``grpc_search_batch``: a gRPC ``SearchBatch`` of ``batch``
float32 queries against the configuration's store, one of
``distinct_requests`` fixed batches over the test queries, each connection
taking them in turn.  Answers: the store's exact top-k of every query.

A request kind gives the client its transport and, for each request key,
the bytes to send; it gives the judge the per-query answers of a reply.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from evdb_bench.wire import f32_bytes, int_id, pb_field, pb_fields

TRANSPORT = "grpc"
METHOD = "/evdb.ErlVectorDB/SearchBatch"
ANSWERS = "store"


def target(config: dict) -> str:
    return config["name"]


def queries_per_request(traffic: dict) -> int:
    return int(traffic["batch"])


def batch_rows(r: int, batch: int, n_queries: int) -> np.ndarray:
    """Query indices of the ``r``-th fixed SearchBatch request."""
    return (r * batch + np.arange(batch)) % n_queries


def keys(traffic: dict, ci: int, rng: np.random.Generator, n_queries: int,
         n: int) -> np.ndarray:
    return (ci * 7919 + np.arange(n)) % traffic["distinct_requests"]


def encode(traffic: dict, target_name: str, k: int, queries: np.ndarray,
           key: int) -> bytes:
    """evdb.SearchBatchRequest (proto/evdb.proto): store = 1, vectors_f32
    = 2, dim = 3, k = 4."""
    rows = queries[batch_rows(key, traffic["batch"], queries.shape[0])]
    return (pb_field(1, 2, target_name.encode()) + pb_field(2, 2, f32_bytes(rows))
            + pb_field(3, 0, rows.shape[1]) + pb_field(4, 0, k))


def parse_reply(buf: bytes):
    """evdb.SearchBatchReply: count = 1, k = 2, ids = 3 (repeated string),
    distances_f32 = 4.  Returns (count, k, ids [str], distances f32)."""
    count = k = 0
    ids: List[str] = []
    dists = np.zeros(0, np.float32)
    for num, val in pb_fields(buf):
        if num == 1:
            count = val
        elif num == 2:
            k = val
        elif num == 3:
            ids.append(val.decode())
        elif num == 4:
            dists = np.frombuffer(val, "<f4")
    return count, k, ids, dists


def answers(traffic: dict, key: int, body: bytes, n_queries: int
            ) -> List[Tuple[int, list, list]]:
    """(query, row ids, distances) of each query of the reply; a reply of
    the wrong shape gives its first query an empty (malformed) answer."""
    count, k, ids, dists = parse_reply(body)
    rows = batch_rows(key, traffic["batch"], n_queries)
    if count != len(rows) or len(ids) != count * k or dists.size != count * k:
        return [(int(rows[0]), [], [])]
    id_arr = np.array([int_id(s) for s in ids], np.int64)
    return [(int(qi), id_arr[i * k:(i + 1) * k], dists[i * k:(i + 1) * k])
            for i, qi in enumerate(rows)]
