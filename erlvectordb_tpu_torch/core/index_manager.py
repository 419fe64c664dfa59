"""Index manager — a descriptor registry with real, threaded index builds.

Counterpart of ``erlvectordb_tpu/core/index_manager.py``:

  * ``flat``  — descriptor only (the store's exact scan is the index);
  * ``int8``  — symmetric per-row quantization of a float32 store's rows,
                searched by the exact int8 scan (core/search.py);
  * ``pq``    — product quantization (quant/pq.py), searched by the ADC
                gather scan with an exact top-k (ops/adc.py);
  * ``opq``   — PQ with a learned orthogonal rotation (quant/opq.py);
  * ``ivf``   — inverted-file index with sort-based query dispatch
                (core/ivf.py);
  * ``hnsw`` / ``cellprobe`` — balanced cells, int8 residual codes and the
                multiprobe gather (core/cell_probe.py, kernel B7).

  * ``ep_ivf`` / ``ep_cellprobe`` — the ivf and cellprobe cells sharded
                over a mesh of every device of the store's kind (every card;
                the logical CPU devices on the CPU), parallel/ep_*.py.

Built indexes persist under ``root/idx_<name>/`` (``save_index``,
``save_all``, ``load_indexes``) as a generation pair, ``arrays_<gen>.npz`` +
``meta_<gen>.json`` with the store snapshots' ``__saved_at__`` echo
(persist/snapshot.py): a crash mid-save leaves the previous pair.  The JAX
package writes ``arrays.npz`` and ``meta.json`` by two sequential renames, so
a crash between them pairs new arrays with old meta; its layout still loads
here.

Builds run on a background thread, record build time and memory stats and
are stamped with the store version, so staleness is detectable
(``is_stale``); ``search`` consults the built artifact.  Every artifact
lives on its store's device.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from erlvectordb_tpu_torch.core.store import VectorStore
from erlvectordb_tpu_torch.ops import fused_topk as ft
from erlvectordb_tpu_torch.utils.metrics import metrics

LOG = logging.getLogger(__name__)

INDEX_TYPES = ("flat", "int8", "pq", "opq", "ivf", "ep_ivf", "hnsw",
               "cellprobe", "ep_cellprobe")


class IndexError_(ValueError):
    pass


@dataclass
class IndexInfo:
    name: str
    store: str
    type: str
    parameters: Dict[str, Any] = field(default_factory=dict)
    built: bool = False
    building: bool = False
    built_at: Optional[float] = None
    built_version: Optional[int] = None
    build_seconds: Optional[float] = None
    error: Optional[str] = None
    stats: Dict[str, Any] = field(default_factory=dict)
    artifact: Any = None  # the built object (codebook+codes for pq, ...)

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "store": self.store,
            "type": self.type,
            "parameters": self.parameters,
            "built": self.built,
            "building": self.building,
            "built_at": self.built_at,
            "build_seconds": self.build_seconds,
            "error": self.error,
            "stats": self.stats,
        }
        idx = self.probe_artifact()
        calib = getattr(idx, "_calib", None)
        if calib:
            # which guarantee recall_target gives on this index: exact
            # (absolute recall, ceiling enforced) vs ceiling (relative to
            # the index's own deep probe)
            d["calibration"] = calib.summaries()
        return d

    def probe_artifact(self):
        """The cellprobe-family index object, if this is one."""
        if isinstance(self.artifact, dict):
            return (self.artifact.get("cell_probe")
                    or self.artifact.get("ep_cellprobe"))
        return None


def _search_metric(store: VectorStore) -> str:
    return store.metric if store.metric != "manhattan" else "euclidean"


class IndexManager:
    CALIBRATABLE = ("hnsw", "cellprobe", "ep_cellprobe")

    def __init__(self, registry):
        self._registry = registry  # StoreRegistry
        self._indexes: Dict[str, IndexInfo] = {}
        self._lock = threading.RLock()

    # ------------------------------------------------------------- registry

    def create_index(self, name: str, store: str, index_type: str,
                     parameters: Optional[dict] = None) -> dict:
        if index_type not in INDEX_TYPES:
            raise IndexError_(
                f"index type must be one of {INDEX_TYPES}, got {index_type!r}")
        self._registry.get(store)  # must exist
        with self._lock:
            if name in self._indexes:
                raise IndexError_(f"index {name!r} already exists")
            info = IndexInfo(name, store, index_type, parameters or {})
            if index_type == "flat":
                info.built = True  # exact scan needs no build
                info.built_at = time.time()
                info.build_seconds = 0.0
            self._indexes[name] = info
            return info.to_dict()

    def drop_index(self, name: str) -> bool:
        with self._lock:
            return self._indexes.pop(name, None) is not None

    def drop_for_store(self, store: str) -> List[str]:
        """Drop every index built over ``store`` (called when the store is
        deleted: an orphaned index would fail deep inside search)."""
        with self._lock:
            doomed = [n for n, i in self._indexes.items() if i.store == store]
            for n in doomed:
                self._indexes.pop(n, None)
            return doomed

    def list_indexes(self) -> List[dict]:
        with self._lock:
            return [i.to_dict() for i in self._indexes.values()]

    def get_index_info(self, name: str) -> Optional[dict]:
        with self._lock:
            info = self._indexes.get(name)
            return info.to_dict() if info else None

    # ---------------------------------------------------------------- build

    def build_index(self, name: str, wait: bool = True,
                    timeout: float = 300.0) -> dict:
        """Build (or rebuild) an index.  ``wait=False`` returns at once with
        the build running in the background."""
        with self._lock:
            info = self._indexes.get(name)
            if info is None:
                raise IndexError_(f"index {name!r} not found")
            if info.building:
                raise IndexError_(f"index {name!r} is already building")
            info.building = True
            info.error = None
        done = threading.Event()

        def run():
            try:
                self._build(info)
            except Exception as e:  # noqa: BLE001 — surfaced in info.error
                with self._lock:
                    info.error = f"{type(e).__name__}: {e}"
                    info.built = False
            finally:
                with self._lock:
                    info.building = False
                done.set()

        threading.Thread(target=run, name=f"evdb-index-{name}",
                         daemon=True).start()
        if wait and not done.wait(timeout):
            raise IndexError_(f"index {name!r} build timed out")
        return self.get_index_info(name)

    def _build(self, info: IndexInfo) -> None:
        store: VectorStore = self._registry.get(info.store)
        t0 = time.perf_counter()
        if info.type == "flat":
            artifact, stats = None, {"kind": "exact-scan"}
        elif info.type == "int8":
            artifact, stats = self._build_int8(store)
        elif info.type in ("pq", "opq"):
            artifact, stats = self._build_pq(store, info.parameters,
                                             rotated=info.type == "opq")
        elif info.type == "ivf":
            artifact, stats = self._build_ivf(store, info.parameters)
        elif info.type == "ep_ivf":
            artifact, stats = self._build_ep_ivf(store, info.parameters)
        elif info.type in ("hnsw", "cellprobe"):
            artifact, stats = self._build_cell_probe(store, info.parameters)
        else:  # ep_cellprobe
            artifact, stats = self._build_ep_cell_probe(store, info.parameters)
        if store.device.type == "cuda":
            torch.cuda.synchronize(store.device)
        dt = time.perf_counter() - t0
        with self._lock:
            info.artifact = artifact
            info.stats = {**stats, "rows": store.count}
            info.built = True
            info.built_at = time.time()
            info.built_version = store.version
            info.build_seconds = round(dt, 4)

    def _build_int8(self, store: VectorStore):
        if store._vectors is None or store.count == 0:
            raise IndexError_("store is empty")
        if store.dtype == "int8":
            return None, {"kind": "native-int8"}  # store already quantized
        if store.dtype != "float32":
            # int4/int4r buffers are packed nibble bytes: quantizing them as
            # float rows would build a silently garbage index
            raise IndexError_(
                f"int8 index requires a float32 store (got {store.dtype}; "
                "quantized stores are already searched natively)")
        with store._lock.read():
            vecs = store._vectors
            absmax = vecs.abs().amax(dim=-1)
            # the JAX package builds this eagerly: a true division by 127
            scale = torch.where(absmax > 0, ft.div_scalar(absmax, 127.0),
                                torch.ones_like(absmax))
            codes = torch.clamp(torch.round(vecs / scale[:, None]), -127,
                                127).to(torch.int8)
            # snapshot norms/valid: build-time codes must not be scored
            # against live arrays a later insert grows or mutates
            artifact = {"codes": codes, "scales": scale,
                        "norms": store._norms.clone(),
                        "valid": store._valid.clone()}
        return artifact, {
            "kind": "int8",
            "memory_bytes": int(codes.numel() + scale.numel() * 4),
        }

    @staticmethod
    def _store_matrix(store: VectorStore, pad128: bool = False):
        """(matrix, store rows) of a store's live rows for an index build —
        the shared front half of every builder; the matrix a tensor on the
        store's device."""
        if store.count == 0:
            raise IndexError_("store is empty")
        rows, mat = store.live_matrix()
        if pad128 and mat.shape[1] % 128:
            mat = torch.nn.functional.pad(mat, (0, 128 - mat.shape[1] % 128))
        return mat, rows

    @staticmethod
    def _row_norms(mat: np.ndarray) -> np.ndarray:
        """The rows' f32 norms (the IVF layouts score with them)."""
        return np.linalg.norm(mat, axis=1).astype(np.float32)

    def _build_pq(self, store: VectorStore, params: dict,
                  rotated: bool = False):
        from erlvectordb_tpu_torch.quant.opq import OPQCodebook
        from erlvectordb_tpu_torch.quant.pq import PQCodebook

        x, rows = self._store_matrix(store)
        m = int(params.get("m", 8))
        k = int(params.get("k", 256))
        iters = int(params.get("iters", 15))
        d = x.shape[1]
        if d % m:  # pad dims so D % M == 0
            x = torch.nn.functional.pad(x, (0, m - d % m))
        kk = min(k, max(16, x.shape[0] // 4))
        if rotated:
            cb = OPQCodebook.fit(x, m=m, k=kk, iters=iters,
                                 opq_iters=int(params.get("opq_iters", 4)))
        else:
            cb = PQCodebook.fit(x, m=m, k=kk, iters=iters)
        codes = cb.encode(x)
        artifact = {"codebook": cb, "codes": codes, "rows": rows,
                    "pad_dim": x.shape[1]}
        return artifact, {
            "kind": "opq" if rotated else "pq",
            "m": cb.m,
            "k": cb.k,
            "code_bytes_per_vector": cb.m,
            "memory_bytes": int(codes.numel() + cb.codebooks.numel() * 4),
        }

    def _build_ivf(self, store: VectorStore, params: dict):
        from erlvectordb_tpu_torch.core.ivf import IVFIndex

        mat, rows = self._store_matrix(store)
        mat = mat.cpu().numpy()
        idx = IVFIndex.build(
            mat, rows, self._row_norms(mat),
            n_cells=int(params.get("n_cells", 64)),
            iters=int(params.get("iters", 15)),
            device=store.device,
        )
        artifact = {"ivf": idx, "nprobe": int(params.get("nprobe", 8))}
        return artifact, idx.stats()

    @staticmethod
    def _ep_mesh(store: VectorStore):
        """The EP indexes' mesh: every device of the store's kind, one
        replica group."""
        from erlvectordb_tpu_torch.parallel.mesh import devices_of_kind, make_mesh

        devs = devices_of_kind(store.device)
        return make_mesh(n_data=len(devs), n_replica=1, devices=devs)

    def _build_ep_ivf(self, store: VectorStore, params: dict):
        """Expert-parallel IVF: cells sharded across the data axis of the
        mesh — the scale-out form of the ivf type."""
        from erlvectordb_tpu_torch.parallel.ep_ivf import EPIVFIndex

        mat, rows = self._store_matrix(store)
        mat = mat.cpu().numpy()
        idx = EPIVFIndex.build(
            mat, rows, self._row_norms(mat), self._ep_mesh(store),
            n_cells=int(params.get("n_cells", 64)),
            iters=int(params.get("iters", 15)),
        )
        artifact = {"ep_ivf": idx, "nprobe": int(params.get("nprobe", 8))}
        return artifact, idx.stats()

    def _build_ep_cell_probe(self, store: VectorStore, params: dict):
        """Scale-out hnsw slot: int8 residual cells sharded over the data
        axis of the mesh (parallel/ep_cell_probe.py)."""
        from erlvectordb_tpu_torch.parallel.ep_cell_probe import EPCellProbeIndex

        mat, rows = self._store_matrix(store, pad128=True)
        idx = EPCellProbeIndex.build(
            mat, rows, self._ep_mesh(store),
            cell_rows=int(params.get("cell_rows", 96)),
            cell_cap=int(params.get("cell_cap", 128)),
            iters=int(params.get("iters", 15)),
        )
        artifact = {"ep_cellprobe": idx,
                    "nprobe": int(params.get("nprobe", 32))}
        return artifact, idx.stats()

    def _build_cell_probe(self, store: VectorStore, params: dict):
        """The hnsw-slot build: balanced cells + int8 residual codes, served
        by the sub-linear multiprobe gather (core/cell_probe.py)."""
        from erlvectordb_tpu_torch.core.cell_probe import CellProbeIndex

        mat, rows = self._store_matrix(store, pad128=True)
        idx = CellProbeIndex.build(
            mat, rows,
            cell_rows=int(params.get("cell_rows", 96)),
            cell_cap=int(params.get("cell_cap", 128)),
            iters=int(params.get("iters", 15)),
            device=store.device,
        )
        del mat
        # how often the seeding's pruning engages, summed over builds
        for key in ("kpp_rows_scanned", "kpp_rows_total"):
            metrics.inc(f"index.{key}", idx.build_stats[key])
        artifact = {"cell_probe": idx,
                    "nprobe": int(params.get("nprobe", 32))}
        return artifact, idx.stats()

    # ---------------------------------------------------------- calibration

    def calibrate_index(self, name: str, queries=None, n_sample: int = 256,
                        k: int = 10, mode: str = "exact",
                        metric: Optional[str] = None) -> dict:
        """Calibrate a cellprobe-family index's recall_target curve.

        ``mode="exact"`` (default): sample (or take) queries, compute exact
        ground truth with one brute f32 scan over the backing store's rows
        (core/calibration.exact_ground_truth), and record an absolute
        recall@k curve whose deep-probe value is the index's quantization
        ceiling; recall_target searches then refuse targets above it.
        ``mode="ceiling"``: the index's cheap self-relative curve.
        ``queries`` default to sampled store rows.  Returns {"curve",
        "mode", "ceiling", "k", "metric", ...}."""
        with self._lock:
            info = self._indexes.get(name)
        if info is None:
            raise IndexError_(f"index {name!r} not found")
        if info.type not in self.CALIBRATABLE:
            raise IndexError_(
                f"index {name!r} ({info.type}) has no recall_target "
                "calibration — cellprobe-family only")
        if not info.built:
            raise IndexError_(f"index {name!r} is not built")
        idx = info.probe_artifact()
        store = self._registry.get(info.store)
        metric = metric or _search_metric(store)
        gt = None
        if mode == "exact":
            from erlvectordb_tpu_torch.core.calibration import (
                exact_ground_truth,
            )

            mat, rows = self._store_matrix(store, pad128=True)
            mat = mat.cpu().numpy()
            if queries is None:
                rng = np.random.default_rng(n_sample)
                sel = rng.choice(mat.shape[0],
                                 size=min(n_sample, mat.shape[0]),
                                 replace=False)
                queries = mat[sel]
            gt = exact_ground_truth(mat, np.asarray(queries, np.float32),
                                    k=k, metric=metric, rows=rows,
                                    device=store.device)
        elif mode != "ceiling":
            raise ValueError("mode must be 'exact' or 'ceiling'")
        curve = idx.calibrate_nprobe(queries=queries, n_sample=n_sample,
                                     k=k, metric=metric, ground_truth=gt)
        out = idx._calib.get(k, metric).summary()
        out["curve"] = {str(p): r for p, r in sorted(curve.items())}
        return out

    def dirty_calibrations(self) -> List[str]:
        """Built cellprobe-family indexes whose calibration curves were
        (lazily) computed since their artifact was last persisted."""
        with self._lock:
            out = []
            for info in self._indexes.values():
                calib = getattr(info.probe_artifact(), "_calib", None)
                if info.built and calib is not None and calib.dirty:
                    out.append(info.name)
            return out

    # --------------------------------------------------------------- search

    def is_stale(self, name: str) -> bool:
        with self._lock:
            info = self._indexes.get(name)
            if info is None or not info.built:
                return True
            store = self._registry.get(info.store)
            return (info.built_version is not None
                    and info.built_version != store.version)

    def search(self, name: str, query, k: int = 10,
               nprobe: Optional[int] = None,
               recall_target: Optional[float] = None):
        """Search through a built index; returns [(id, metadata, distance)].

        ``nprobe`` overrides the build-time probe width per request
        (ivf/cellprobe families); ``recall_target`` instead picks the
        smallest calibrated nprobe meeting a recall@k target (cellprobe
        family only): absolute after ``calibrate_index(mode="exact")``,
        relative to the index's own deep probe under the lazy ceiling-mode
        calibration.  Spans ``index.search`` (and ``index.map``, the
        row-to-hit mapping) for the thread's request."""
        with metrics.span("index.search"):
            if nprobe is not None and recall_target is not None:
                raise ValueError(
                    "pass either nprobe or recall_target, not both")
            if nprobe is not None and int(nprobe) < 1:
                raise ValueError("nprobe must be >= 1")
            with self._lock:
                info = self._indexes.get(name)
            if info is None:
                raise IndexError_(f"index {name!r} not found")
            if not info.built:
                raise IndexError_(f"index {name!r} is not built")
            probed = info.type in ("ivf", "ep_ivf", "hnsw", "cellprobe",
                                   "ep_cellprobe")
            if (nprobe is not None or recall_target is not None) \
                    and not probed:
                raise ValueError(
                    f"index {name!r} ({info.type}) has no probe knob — "
                    "nprobe/recall_target apply to ivf/cellprobe-family "
                    "indexes")
            store: VectorStore = self._registry.get(info.store)
            if info.type == "flat" or (info.type == "int8"
                                       and info.artifact is None):
                return store.search(query, k=k)
            q = np.asarray(query, np.float32)
            a = info.artifact
            if info.type in ("ivf", "ep_ivf"):
                if recall_target is not None:
                    raise ValueError(
                        "recall_target calibration is cellprobe-family only; "
                        "pass an explicit nprobe for ivf/ep_ivf indexes")
                dists, rows = a[info.type].search(
                    q, k=k,
                    nprobe=a["nprobe"] if nprobe is None else int(nprobe),
                    metric=_search_metric(store))
                return self._rows_to_hits(store, dists[0], rows[0])
            if info.type in ("hnsw", "cellprobe", "ep_cellprobe"):
                kw = {"nprobe": (a["nprobe"] if nprobe is None
                                 else int(nprobe))}
                if recall_target is not None:
                    kw = {"recall_target": float(recall_target)}
                dists, rows = info.probe_artifact().search(
                    q, k=k, metric=_search_metric(store), **kw)
                return self._rows_to_hits(store, dists[0], rows[0])
            if info.type == "int8":
                from erlvectordb_tpu_torch.core.search import exact_topk_int8

                qp = torch.zeros((1, a["codes"].shape[1]),
                                 dtype=torch.float32,
                                 device=a["codes"].device)
                qp[0, : q.shape[0]] = torch.as_tensor(q, device=qp.device)
                dists, rows = exact_topk_int8(
                    a["codes"], a["scales"], a["norms"], a["valid"], qp,
                    metric=store.metric, k=min(k, store.count))
                return self._rows_to_hits(store, dists[0].cpu().numpy(),
                                          rows[0].cpu().numpy())
            # pq/opq: the ADC scan over the codes; artifact rows map code
            # index -> store row
            from erlvectordb_tpu_torch.ops.adc import adc_search_exact_topk

            cbk = a["codebook"]
            qp = torch.zeros((1, a["pad_dim"]), dtype=torch.float32,
                             device=cbk.device)
            qp[0, : q.shape[0]] = torch.as_tensor(q, device=qp.device)
            if hasattr(cbk, "rotate"):  # OPQ: search in the rotated space
                qp = cbk.rotate(qp)
            kk = min(k, a["codes"].shape[0])
            dists, idx = adc_search_exact_topk(a["codes"], cbk.codebooks, qp,
                                               k=kk)
            dists = np.sqrt(np.maximum(dists[0].cpu().numpy(), 0.0))
            return self._rows_to_hits(store, dists,
                                      a["rows"][idx[0].cpu().numpy()])

    # ----------------------------------------------------------- persistence

    def save_index(self, name: str, root) -> str:
        """Persist one built index under ``root/idx_<name>/`` as a new
        generation pair."""
        from pathlib import Path

        from erlvectordb_tpu_torch.persist.snapshot import write_pair

        with self._lock:
            info = self._indexes.get(name)
            if info is None or not info.built:
                raise IndexError_(f"index {name!r} not found or not built")
            meta = info.to_dict()
            a = info.artifact
        arrays = {}
        if info.type == "int8" and a is not None:
            arrays = {k: a[k].cpu().numpy()
                      for k in ("codes", "scales", "norms", "valid")}
        elif info.type in ("pq", "opq") and a is not None:
            arrays = dict(a["codebook"].to_arrays())
            arrays["codes"] = a["codes"].cpu().numpy()
            arrays["rows"] = np.asarray(a["rows"])
            meta["pad_dim"] = int(a["pad_dim"])
        elif info.type in ("ivf", "ep_ivf") and a is not None:
            arrays = a[info.type].to_arrays()
            meta["nprobe"] = int(a["nprobe"])
        elif info.type in ("hnsw", "cellprobe", "ep_cellprobe") and a is not None:
            arrays = info.probe_artifact().to_arrays()
            meta["nprobe"] = int(a["nprobe"])
        idir = Path(root) / f"idx_{name}"
        write_pair(idir, "arrays", arrays, meta)
        return str(idir)

    def save_all(self, root) -> int:
        with self._lock:
            names = [i.name for i in self._indexes.values()
                     if i.built and i.type != "flat"]
        for name in names:
            self.save_index(name, root)
        return len(names)

    def load_indexes(self, root) -> List[str]:
        """Re-hydrate every persisted index whose store exists; an
        unreadable artifact is logged and skipped."""
        from pathlib import Path

        root = Path(root)
        loaded = []
        if not root.exists():
            return loaded
        for idir in sorted(root.glob("idx_*")):
            try:
                name = self._load_one_index(idir)
            except Exception:  # noqa: BLE001 — one bad artifact must not
                LOG.exception("skipping corrupt index artifact %s", idir)
                continue  # abort Database.start()
            if name is not None:
                loaded.append(name)
        return loaded

    def _load_one_index(self, idir):
        """Re-hydrate one persisted index dir (this package's generation
        pairs or the JAX package's arrays.npz + meta.json); returns its name,
        or None when it has no meta or its store is absent."""
        from erlvectordb_tpu_torch.persist.snapshot import (
            read_state,
            resolve_pair,
        )

        resolved = resolve_pair(idir, "arrays")
        if resolved is None:
            return None
        meta = resolved[2]
        store = self._registry.get_or_none(meta["store"])
        if store is None:
            return None
        arrays = read_state(resolved[1], {})
        dev = store.device
        info = IndexInfo(meta["name"], meta["store"], meta["type"],
                         meta.get("parameters") or {})
        info.built = bool(meta.get("built"))
        info.built_at = meta.get("built_at")
        info.build_seconds = meta.get("build_seconds")
        info.stats = meta.get("stats") or {}
        if info.type == "int8" and arrays:
            # artifacts saved before norms/valid were persisted take the
            # live store's
            norms = arrays.get("norms")
            valid = arrays.get("valid")
            info.artifact = {
                "codes": torch.as_tensor(arrays["codes"], device=dev),
                "scales": torch.as_tensor(arrays["scales"], device=dev),
                "norms": (store._norms.clone() if norms is None
                          else torch.as_tensor(norms, device=dev)),
                "valid": (store._valid.clone() if valid is None
                          else torch.as_tensor(valid, device=dev)),
            }
        elif info.type in ("pq", "opq") and arrays:
            if info.type == "opq":
                from erlvectordb_tpu_torch.quant.opq import OPQCodebook

                cb = OPQCodebook.from_arrays(arrays, device=dev)
            else:
                from erlvectordb_tpu_torch.quant.pq import PQCodebook

                cb = PQCodebook.from_arrays(arrays, device=dev)
            info.artifact = {
                "codebook": cb,
                "codes": torch.as_tensor(arrays["codes"], device=dev),
                "rows": np.asarray(arrays["rows"]),
                "pad_dim": int(meta["pad_dim"]),
            }
        elif info.type == "ivf" and arrays:
            from erlvectordb_tpu_torch.core.ivf import IVFIndex

            info.artifact = {"ivf": IVFIndex.from_arrays(arrays, device=dev),
                             "nprobe": int(meta.get("nprobe", 8))}
        elif info.type in ("hnsw", "cellprobe") and arrays:
            from erlvectordb_tpu_torch.core.cell_probe import CellProbeIndex

            info.artifact = {
                "cell_probe": CellProbeIndex.from_arrays(arrays, device=dev),
                "nprobe": int(meta.get("nprobe", 32)),
            }
        elif info.type == "ep_ivf" and arrays:
            from erlvectordb_tpu_torch.parallel.ep_ivf import EPIVFIndex

            info.artifact = {
                "ep_ivf": EPIVFIndex.from_arrays(arrays, self._ep_mesh(store)),
                "nprobe": int(meta.get("nprobe", 8))}
        elif info.type == "ep_cellprobe" and arrays:
            from erlvectordb_tpu_torch.parallel.ep_cell_probe import (
                EPCellProbeIndex,
            )

            info.artifact = {
                "ep_cellprobe": EPCellProbeIndex.from_arrays(
                    arrays, self._ep_mesh(store)),
                "nprobe": int(meta.get("nprobe", 32)),
            }
        with self._lock:
            self._indexes.setdefault(meta["name"], info)
        return meta["name"]

    @staticmethod
    def _rows_to_hits(store: VectorStore, dists, rows):
        hits = []
        with metrics.span("index.map"):
            for d, r in zip(dists, rows):
                if not np.isfinite(d):
                    break
                vid = store._rid(int(r))
                if vid is None:
                    continue
                hits.append((vid, store._metadata.get(vid, {}), float(d)))
        return hits
