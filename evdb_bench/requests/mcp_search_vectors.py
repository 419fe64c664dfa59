"""Request kind ``mcp_search_vectors``: one query a request, MCP's
``search_vectors`` tool with the query as base64 float32, against the
configuration's store; the query drawn uniformly from the test queries.
Answers: the store's exact top-k."""

from __future__ import annotations

import base64
import json
import math

import numpy as np

from evdb_bench.wire import f32_bytes, int_id, mcp_tail

TRANSPORT = "mcp"
ANSWERS = "store"


def target(config: dict) -> str:
    return config["name"]


def queries_per_request(traffic: dict) -> int:
    return 1


def keys(traffic: dict, ci: int, rng: np.random.Generator, n_queries: int,
         n: int) -> np.ndarray:
    return rng.integers(0, n_queries, n)


def encode(traffic: dict, target_name: str, k: int, queries: np.ndarray,
           key: int) -> bytes:
    return mcp_tail("search_vectors", {
        "store": target_name, "k": k,
        "vector_b64": base64.b64encode(f32_bytes(queries[key])).decode()})


def answers(traffic: dict, key: int, body: bytes, n_queries: int):
    hits = json.loads(body)["results"]
    return [(int(key), [int_id(h.get("id")) for h in hits],
             [float(h.get("distance", math.nan)) for h in hits])]
