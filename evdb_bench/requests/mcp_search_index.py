"""Request kind ``mcp_search_index``: one query a request, MCP's
``search_index`` tool (k, the index's own nprobe) with the query as a JSON
list, against the configuration's ``index``, which set-up builds over MCP's
``create_index`` and ``build_index``; the query drawn uniformly from the
test queries.  Answers: approximate by design, judged against the exact
float search."""

from __future__ import annotations

import json
import math

import numpy as np

from evdb_bench.wire import int_id, mcp_tail

TRANSPORT = "mcp"
ANSWERS = "index"


def target(config: dict) -> str:
    return config["index"]["name"]


def prepare(config: dict, mcp_call, log) -> None:
    """Build the configuration's index over the store, as a user would."""
    ix = config["index"]
    mcp_call("create_index", {"name": ix["name"], "store": config["name"],
                              "type": ix["type"],
                              "parameters": ix["parameters"]})
    info = mcp_call("build_index", {"name": ix["name"], "wait": True})
    if not info.get("built"):
        raise RuntimeError(f"index build failed: {info}")
    log(f"index build: {info.get('build_seconds')} s, "
        f"{json.dumps(info.get('stats', {}).get('build', {}))}")


def queries_per_request(traffic: dict) -> int:
    return 1


def keys(traffic: dict, ci: int, rng: np.random.Generator, n_queries: int,
         n: int) -> np.ndarray:
    return rng.integers(0, n_queries, n)


def encode(traffic: dict, target_name: str, k: int, queries: np.ndarray,
           key: int) -> bytes:
    return mcp_tail("search_index", {"name": target_name, "k": k,
                                     "vector": queries[key].tolist()})


def answers(traffic: dict, key: int, body: bytes, n_queries: int):
    hits = json.loads(body)["results"]
    return [(int(key), [int_id(h.get("id")) for h in hits],
             [float(h.get("distance", math.nan)) for h in hits])]
