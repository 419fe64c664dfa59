"""MCP tool schemas and dispatch — scope-gated, with the reference bug fixed.

The reference advertises 7 tools (src/mcp_server.erl:221-318) but its
dispatcher is broken: the ``create_store`` clause actually performs an
*insert* (reads store/id/vector args, :320-332) and there is no
``insert_vector`` clause at all, so insert_vector falls through to "Unknown
tool" (:398-399; independently documented in INTEGRATION_TEST_RESULTS.md
"Parameter Schema Mismatch").  Here each tool does what its schema says.

The table holds the JAX server's 19 tools, with their schemas and the JSON
shapes of their answers.

Scope matrix (reference check_tool_permission :414-427):
  read  — search_vectors, search_vectors_batch, get_store_stats, list_stores,
          list_indexes, search_index
  write — create_store, insert_vector, delete_vector, sync_store,
          calibrate_store, create_index, build_index, calibrate_index
  admin — backup_store, restore_store, list_backups, delete_store, drop_index
"""

from __future__ import annotations

import base64
import binascii
from typing import TYPE_CHECKING, Any, Dict, List, Set

import numpy as np

if TYPE_CHECKING:  # avoid circular import: api.py imports serve.oauth
    from erlvectordb_tpu_torch.api import Database


class ToolError(ValueError):
    """Domain error in a tool call (ValueError so every protocol surface
    maps it to its 400-class response)."""


def decode_query(args: Dict[str, Any]):
    """Query vector from tool args: ``vector`` (JSON number array) or
    ``vector_b64`` (base64 little-endian float32 — ~5x cheaper to parse,
    the production serving encoding)."""
    if "vector" in args:
        return args["vector"]
    b64 = args.get("vector_b64")
    if b64 is None:
        raise ToolError("one of 'vector' or 'vector_b64' is required")
    try:
        return np.frombuffer(base64.b64decode(b64), dtype="<f4")
    except (binascii.Error, ValueError) as e:
        raise ToolError(f"bad vector_b64: {e}") from e


def decode_queries(args: Dict[str, Any]) -> np.ndarray:
    """[B, D] query matrix from batch tool args: ``vectors`` (array of
    arrays) or ``vectors_b64`` (base64 f32, row-major) + ``dim``."""
    if "vectors" in args:
        arr = np.asarray(args["vectors"], dtype=np.float32)
        if arr.ndim != 2:
            raise ToolError("'vectors' must be a non-ragged array of arrays")
        return arr
    b64 = args.get("vectors_b64")
    if b64 is None:
        raise ToolError("one of 'vectors' or 'vectors_b64' is required")
    dim = args.get("dim")
    if not dim:
        raise ToolError("'dim' is required with 'vectors_b64'")
    try:
        flat = np.frombuffer(base64.b64decode(b64), dtype="<f4")
    except (binascii.Error, ValueError) as e:
        raise ToolError(f"bad vectors_b64: {e}") from e
    if flat.size == 0 or flat.size % int(dim):
        raise ToolError("vectors_b64 length is not a multiple of dim")
    return flat.reshape(-1, int(dim))


def format_hits(hits) -> dict:
    return {
        "results": [
            {"id": vid, "metadata": meta, "distance": dist}
            for vid, meta, dist in hits
        ]
    }


def format_batch(results) -> dict:
    """Full per-hit batch results (id + metadata + distance)."""
    return {"results": [format_hits(hits)["results"] for hits in results]}


def format_batch_columns(cols) -> dict:
    """Compact JSON from raw result columns: parallel ids/distances arrays,
    no metadata, no per-hit tuples — cheap to encode at high QPS."""
    import math

    dists, _rows, ids = cols
    if ids is None or dists.size == 0:
        empty = [[] for _ in range(dists.shape[0])]
        return {"ids": empty, "distances": [list(r) for r in empty]}
    finite = np.isfinite(dists)
    if finite.all() and not (ids == None).any():  # noqa: E711 — elementwise
        return {"ids": ids.tolist(),
                "distances": np.round(dists.astype(np.float64), 6).tolist()}
    out_i, out_d = [], []
    for irow, drow in zip(ids.tolist(), dists.tolist()):
        ri, rd = [], []
        for vid, d in zip(irow, drow):
            if not math.isfinite(d):
                break
            if vid is None:
                continue
            ri.append(vid)
            rd.append(round(d, 6))
        out_i.append(ri)
        out_d.append(rd)
    return {"ids": out_i, "distances": out_d}


def format_batch_b64(cols) -> dict:
    """Binary columnar batch results: little-endian f32 distances and int32
    row indices, base64'd.  Near-zero host encode cost — the production
    bulk-serving format.  Row index == implicit id for bulk-built stores
    (ids '0'..'n-1'); absent hits carry distance inf."""
    dists, rows, _ids = cols
    return {
        "count": int(dists.shape[0]),
        "k": int(dists.shape[1]),
        "distances_b64": base64.b64encode(
            np.ascontiguousarray(dists, dtype="<f4").tobytes()).decode(),
        "rows_b64": base64.b64encode(
            np.ascontiguousarray(rows, dtype="<i4").tobytes()).decode(),
    }


def _schema(name: str, description: str, scope: str, properties: dict,
            required: List[str]) -> dict:
    return {
        "name": name,
        "description": description,
        "inputSchema": {
            "type": "object",
            "properties": properties,
            "required": required,
        },
        # carried internally for scope checks; stripped before tools/list
        "x-scope": scope,
    }


TOOLS: Dict[str, dict] = {
    t["name"]: t
    for t in [
        _schema(
            "create_store",
            "Create a new vector store",
            "write",
            {
                "name": {"type": "string", "description": "Store name"},
                "dimension": {"type": "integer", "description": "Optional fixed dimension"},
                "metric": {"type": "string", "enum": ["cosine", "euclidean", "manhattan", "dot"]},
                "dtype": {"type": "string", "enum": ["float32", "int8", "int4"]},
                "intkey": {"type": "boolean",
                           "description": "int8 stores: keep the int8 key "
                           "plane that the fastest scans select on"},
            },
            ["name"],
        ),
        _schema(
            "insert_vector",
            "Insert (or overwrite) a vector with optional metadata",
            "write",
            {
                "store": {"type": "string"},
                "id": {"type": "string"},
                "vector": {"type": "array", "items": {"type": "number"}},
                "metadata": {"type": "object"},
            },
            ["store", "id", "vector"],
        ),
        _schema(
            "search_vectors",
            "Exact top-k similarity search",
            "read",
            {
                "store": {"type": "string"},
                "vector": {"type": "array", "items": {"type": "number"}},
                "vector_b64": {"type": "string",
                               "description": "base64 little-endian float32 "
                               "(alternative to 'vector')"},
                "k": {"type": "integer", "default": 10},
                "metric": {"type": "string"},
                "filter": {"type": "object",
                           "description": "metadata equality predicates (AND)"},
                "nprobe": {"type": "integer", "minimum": 1,
                           "description": "int4r stores: probe only the N "
                           "nearest cells (sub-linear low-latency path, "
                           "approximate)"},
                "recall_target": {"type": "number",
                                  "description": "int4r stores: pick the "
                                  "smallest calibrated nprobe meeting this "
                                  "recall@k (alternative to nprobe). "
                                  "Guarantee depends on the store's "
                                  "calibration mode (get_store_stats "
                                  "'calibration'): 'exact' curves measure "
                                  "ABSOLUTE recall vs exact f32 ground "
                                  "truth and reject targets above the "
                                  "quantization ceiling; uncalibrated "
                                  "stores lazily self-calibrate in "
                                  "'ceiling' mode, where recall is "
                                  "relative to the store's own deep probe "
                                  "and quantization loss is NOT counted"},
            },
            ["store"],
        ),
        _schema(
            "search_vectors_batch",
            "Exact top-k search for MANY queries in one call (one device "
            "batch — the high-throughput serving path)",
            "read",
            {
                "store": {"type": "string"},
                "vectors": {"type": "array",
                            "items": {"type": "array",
                                      "items": {"type": "number"}}},
                "vectors_b64": {"type": "string",
                                "description": "base64 little-endian float32, "
                                "row-major (alternative to 'vectors')"},
                "dim": {"type": "integer",
                        "description": "row width, required with vectors_b64"},
                "k": {"type": "integer", "default": 10},
                "metric": {"type": "string"},
                "filter": {"type": "object"},
                "nprobe": {"type": "integer", "minimum": 1,
                           "description": "int4r stores: sub-linear "
                           "multiprobe (approximate)"},
                "recall_target": {"type": "number",
                                  "description": "int4r stores: smallest "
                                  "calibrated nprobe meeting this recall@k "
                                  "(see search_vectors: absolute under "
                                  "'exact' calibration, deep-probe-"
                                  "relative under lazy 'ceiling' "
                                  "calibration)"},
                "compact": {"type": "boolean",
                            "description": "return parallel ids/distances "
                            "arrays without metadata (cheap to encode)"},
                "encoding": {"type": "string", "enum": ["json", "b64"],
                             "description": "'b64' returns binary columns "
                             "(distances_b64 f32 + rows_b64 int32) — the "
                             "highest-throughput response format; row index "
                             "== implicit id for bulk-built stores"},
            },
            ["store"],
        ),
        _schema(
            "delete_vector",
            "Delete a vector by id",
            "write",
            {"store": {"type": "string"}, "id": {"type": "string"}},
            ["store", "id"],
        ),
        _schema(
            "get_store_stats",
            "Store statistics (count, dimension, memory)",
            "read",
            {"store": {"type": "string"}},
            ["store"],
        ),
        _schema(
            "list_stores",
            "List all stores",
            "read",
            {},
            [],
        ),
        _schema(
            "sync_store",
            "Force a persistence sync of a store",
            "write",
            {"store": {"type": "string"}},
            ["store"],
        ),
        _schema(
            "calibrate_store",
            "Measure an int4r store's recall-vs-nprobe curve so "
            "recall_target searches answer without a lazy first-use "
            "calibration; returns the {nprobe: recall} curve (persisted "
            "with snapshots).  NOTE: this self-calibration is CEILING "
            "mode — recall relative to the store's own deep probe, "
            "quantization loss not counted; absolute (exact-mode) "
            "calibration needs the original f32 data and is available "
            "through the Python API (Database.calibrate_store with "
            "ground_truth) or calibrate_index for cellprobe indexes",
            "write",
            {
                "store": {"type": "string"},
                "n_sample": {"type": "integer", "default": 256},
                "k": {"type": "integer", "default": 10},
                "metric": {"type": "string"},
            },
            ["store"],
        ),
        _schema(
            "backup_store",
            "Write a point-in-time backup",
            "admin",
            {"store": {"type": "string"}, "backup_name": {"type": "string"}},
            ["store", "backup_name"],
        ),
        _schema(
            "restore_store",
            "Restore a store from a backup file",
            "admin",
            {"backup_file": {"type": "string"}, "new_name": {"type": "string"}},
            ["backup_file"],
        ),
        _schema(
            "list_backups",
            "List available backups",
            "admin",
            {},
            [],
        ),
        _schema(
            "delete_store",
            "Delete an entire store",
            "admin",
            {"store": {"type": "string"}},
            ["store"],
        ),
        _schema(
            "create_index",
            "Create an index descriptor over a store "
            "(flat | int8 | pq | opq | ivf)",
            "write",
            {
                "name": {"type": "string"},
                "store": {"type": "string"},
                "type": {"type": "string",
                         "enum": ["flat", "int8", "pq", "opq", "ivf",
                                  "ep_ivf", "hnsw", "cellprobe",
                                  "ep_cellprobe"]},
                "parameters": {"type": "object"},
            },
            ["name", "store", "type"],
        ),
        _schema(
            "build_index",
            "Build (or rebuild) an index; real k-means/quantization on device",
            "write",
            {"name": {"type": "string"},
             "wait": {"type": "boolean", "default": True}},
            ["name"],
        ),
        _schema(
            "list_indexes",
            "List index descriptors and build stats",
            "read",
            {},
            [],
        ),
        _schema(
            "search_index",
            "Top-k search through a built index",
            "read",
            {
                "name": {"type": "string"},
                "vector": {"type": "array", "items": {"type": "number"}},
                "k": {"type": "integer", "default": 10},
                "nprobe": {"type": "integer", "minimum": 1,
                           "description": "override the build-time probe "
                           "width (ivf/cellprobe-family indexes)"},
                "recall_target": {"type": "number",
                                  "description": "cellprobe-family indexes: "
                                  "smallest calibrated nprobe meeting this "
                                  "recall@k — ABSOLUTE vs exact f32 ground "
                                  "truth after calibrate_index "
                                  "(mode='exact', targets above the "
                                  "quantization ceiling are rejected); "
                                  "deep-probe-relative under lazy "
                                  "'ceiling' calibration (see "
                                  "list_indexes 'calibration')"},
            },
            ["name", "vector"],
        ),
        _schema(
            "calibrate_index",
            "Calibrate a cellprobe-family index's recall_target curve. "
            "mode='exact' (default) measures ABSOLUTE recall@k against "
            "exact float32 ground truth from the backing store (one brute "
            "device scan) and records the quantization ceiling, which "
            "recall_target searches then refuse to exceed; "
            "mode='ceiling' is the cheap self-relative curve. The curve "
            "persists with the index artifact",
            "write",
            {
                "name": {"type": "string"},
                "n_sample": {"type": "integer", "default": 256},
                "k": {"type": "integer", "default": 10},
                "mode": {"type": "string", "enum": ["exact", "ceiling"],
                         "default": "exact"},
                "metric": {"type": "string"},
            },
            ["name"],
        ),
        _schema(
            "drop_index",
            "Drop an index descriptor and its artifact",
            "admin",
            {"name": {"type": "string"}},
            ["name"],
        ),
    ]
}


def tool_scope(name: str) -> str:
    return TOOLS[name]["x-scope"]


def list_tools(scopes: Set[str]) -> List[dict]:
    """Tools visible to a client, filtered by its scopes
    (reference :157-165, :401-412); schemas without internal keys."""
    out = []
    for t in TOOLS.values():
        if t["x-scope"] in scopes:
            out.append({k: v for k, v in t.items() if not k.startswith("x-")})
    return out


def check_permission(name: str, scopes: Set[str]) -> bool:
    t = TOOLS.get(name)
    return t is not None and t["x-scope"] in scopes


def probe_kwargs(args: Dict[str, Any]) -> Dict[str, Any]:
    """Validated nprobe/recall_target kwargs from request args: degenerate
    values (nprobe=0, recall_target=1.5) get a clean domain error, never a
    0-probe dispatch."""
    kw: Dict[str, Any] = {}
    if args.get("nprobe") is not None:
        nprobe = int(args["nprobe"])
        if nprobe < 1:
            raise ToolError("nprobe must be >= 1")
        kw["nprobe"] = nprobe
    if args.get("recall_target") is not None:
        rt = float(args["recall_target"])
        if not (0.0 < rt <= 1.0):
            raise ToolError("recall_target must be in (0, 1]")
        kw["recall_target"] = rt
    if len(kw) == 2:
        raise ToolError("pass either nprobe or recall_target, not both")
    return kw


def call_tool(db: "Database", name: str, args: Dict[str, Any]) -> Any:
    """Execute one tool call against the database facade."""
    if name not in TOOLS:
        raise ToolError(f"Unknown tool: {name}")
    missing = [r for r in TOOLS[name]["inputSchema"]["required"] if r not in args]
    if missing:
        raise ToolError(f"{name}: missing required arguments {missing}")

    if name == "create_store":
        return db.create_store(
            args["name"],
            dim=args.get("dimension"),
            metric=args.get("metric", "cosine"),
            dtype=args.get("dtype", "float32"),
            intkey=bool(args.get("intkey", False)),
        )
    if name == "insert_vector":
        db.any_store(args["store"]).insert(
            args["id"], args["vector"], args.get("metadata") or {}
        )
        return {"status": "ok", "store": args["store"], "id": args["id"]}
    if name == "search_vectors":
        if (args.get("nprobe") is not None
                or args.get("recall_target") is not None):
            # the sub-linear latency path: a direct dispatch (no batching
            # window) that reads only the probed cells
            store = db.any_store(args["store"])
            db._check_nprobe(store)
            kw = probe_kwargs(args)
            hits = store.search(
                decode_query(args), k=int(args.get("k", 10)),
                metric=args.get("metric"), where=args.get("filter"), **kw)
            return format_hits(hits)
        # concurrent protocol requests coalesce into one device batch
        hits = db.batcher.search(
            args["store"], decode_query(args), k=int(args.get("k", 10)),
            metric=args.get("metric"), where=args.get("filter"),
        )
        return format_hits(hits)
    if name == "search_vectors_batch":
        # synchronous fallback (the MCP server normally routes this through
        # the batcher's async submit_group pipeline)
        store = db.any_store(args["store"])
        qs = decode_queries(args)
        kw = dict(k=int(args.get("k", 10)), metric=args.get("metric"),
                  where=args.get("filter"))
        pk = probe_kwargs(args)
        if pk:
            db._check_nprobe(store)
            kw.update(pk)
        if args.get("encoding") == "b64":
            cols = store.search_batch_complete_raw(
                store.search_batch_submit(qs, **kw))
            return format_batch_b64(cols)
        if args.get("compact"):
            cols = store.search_batch_complete_raw(
                store.search_batch_submit(qs, **kw))
            return format_batch_columns(cols)
        return format_batch(store.search_batch(qs, **kw))
    if name == "delete_vector":
        ok = db.any_store(args["store"]).delete(args["id"])
        if not ok:
            raise ToolError(f"vector {args['id']!r} not found")
        return {"status": "ok"}
    if name == "get_store_stats":
        return db.any_store(args["store"]).get_stats()
    if name == "list_stores":
        return {"stores": db.list_stores()}
    if name == "sync_store":
        return {"synced": db.sync(args["store"])}
    if name == "calibrate_store":
        curve = db.calibrate_store(
            args["store"], n_sample=int(args.get("n_sample", 256)),
            k=int(args.get("k", 10)), metric=args.get("metric"))
        return {"store": args["store"], "mode": "ceiling",
                "curve": {str(p): r for p, r in sorted(curve.items())}}
    if name == "calibrate_index":
        return db.calibrate_index(
            args["name"], n_sample=int(args.get("n_sample", 256)),
            k=int(args.get("k", 10)), mode=args.get("mode", "exact"),
            metric=args.get("metric"))
    if name == "backup_store":
        path = db.backup_store(args["store"], args["backup_name"])
        return {"status": "ok", "backup_file": path.rsplit("/", 1)[-1]}
    if name == "restore_store":
        return db.restore_store(args["backup_file"], args.get("new_name"))
    if name == "list_backups":
        return {"backups": db.list_backups()}
    if name == "delete_store":
        if not db.delete_store(args["store"]):
            raise ToolError(f"store {args['store']!r} not found")
        return {"status": "ok"}
    if name == "create_index":
        return db.create_index(args["name"], args["store"], args["type"],
                               args.get("parameters"))
    if name == "build_index":
        return db.build_index(args["name"], wait=bool(args.get("wait", True)))
    if name == "list_indexes":
        return {"indexes": db.list_indexes()}
    if name == "search_index":
        kw = probe_kwargs(args)
        hits = db.search_index(args["name"], args["vector"],
                               k=int(args.get("k", 10)), **kw)
        return format_hits(hits)
    if name == "drop_index":
        if not db.drop_index(args["name"]):
            raise ToolError(f"index {args['name']!r} not found")
        return {"status": "ok"}
    raise ToolError(f"Unknown tool: {name}")  # unreachable
