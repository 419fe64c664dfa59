"""Device-resident vector store (f32 and int8 rows) on a torch device.

Counterpart of ``erlvectordb_tpu/core/store.py``, the f32/int8 subset.  Each
store is a struct-of-arrays on one ``torch.device``:

  * ``vectors [N_cap, W]`` float32 rows, or int8 absmax codes + per-row
    ``scales`` for a quantized store; W is the dimension padded to 128;
  * ``norms [N_cap]`` float32 L2 norms of the original rows;
  * ``valid [N_cap]`` bool — delete is a mask clear, insert reuses free rows;
  * optionally (``intkey=True``, int8 only) a second int8 KEY PLANE whose raw
    int32 dots rank the metric across rows: the UNIT plane 127*x/|x| for
    cosine, the MAGNITUDE plane 127*x/S (one global scale S) for
    euclidean/dot — see ops/fused_topk.py;

plus host-side id<->row and metadata tables.  Where the JAX package scatters
into donated buffers, this store updates its tensors in place
(``index_copy_`` / ``index_fill_``) under the write side of the store lock.
Capacity grows by doubling.  On a CUDA device, searches of stores of at least
one 4096-row tile go through the fused kernels; below that gate, and on the
CPU, the exact scans of core/search.py answer.

Insert semantics preserved: dimension is fixed by the first insert (or at
creation), every element must be a finite real number, inserting an existing
id overwrites it.  ``dtype="int4"``/``"int4r"`` and ``nprobe`` are not ported
yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import json
import math
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from erlvectordb_tpu_torch.core import search as search_mod
from erlvectordb_tpu_torch.core.search import VALID_METRICS
from erlvectordb_tpu_torch.ops import fused_topk as ft
from erlvectordb_tpu_torch.utils.locks import RWLock
from erlvectordb_tpu_torch.utils.metrics import metrics

MIN_CAPACITY = 1024


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _pad128(d: int) -> int:
    """Rows are stored zero-padded to a multiple of 128 columns, so every
    kernel can assume aligned rows (dots, norms and L1 are unaffected)."""
    return ((d + 127) // 128) * 128


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to erlvectordb_tpu_torch")


# --------------------------------------------------------------------------
# Row encoders and in-place scatters.  `rows` is an int64 tensor of distinct
# target rows on the store's device; `new_vecs` f32 [n, W] (zero-padded).
# --------------------------------------------------------------------------


def _row_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row absmax int8 codes and scales."""
    absmax = x.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, ft.div_scalar(absmax, 127.0),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def _encode_unit(x: torch.Tensor) -> torch.Tensor:
    """Unit-plane codes round(127 * x/|x|); zero rows stay zero."""
    n2 = _row_norms(x)
    c127 = torch.full_like(n2, 127.0)
    f = torch.where(n2 > 0, c127 / torch.where(n2 > 0, n2, 1.0),
                    torch.zeros_like(n2))
    return torch.clamp(torch.round(x * f[:, None]), -127, 127).to(torch.int8)


def _encode_mag(x: torch.Tensor, inv_scale: float) -> torch.Tensor:
    """Magnitude-plane codes round(x * 127/S); callers keep |x| <= S."""
    return torch.clamp(torch.round(x * inv_scale), -127, 127).to(torch.int8)


def _scatter_insert_f32(vectors, norms, valid, rows, new_vecs):
    vectors.index_copy_(0, rows, new_vecs)
    norms.index_copy_(0, rows, _row_norms(new_vecs))
    valid.index_fill_(0, rows, True)


def _scatter_insert_int8(codes, scales, norms, valid, rows, new_vecs):
    q, scale = _quantize_int8(new_vecs)
    codes.index_copy_(0, rows, q)
    scales.index_copy_(0, rows, scale)
    norms.index_copy_(0, rows, _row_norms(new_vecs))
    valid.index_fill_(0, rows, True)


def _scatter_insert_unit(unit, rows, new_vecs):
    """Maintain the unit key plane for written rows."""
    unit.index_copy_(0, rows, _encode_unit(new_vecs))


def _scatter_zero_unit(unit, rows):
    """Zero deleted rows of the key plane: their intkey becomes (0 << 10) |
    lane, ranked below every positive-dot row (the exact rescore rejects
    any that still reach the pool)."""
    unit.index_fill_(0, rows, 0)


def _bulk_build_unit(arr, cap):
    out = torch.zeros((cap, arr.shape[1]), dtype=torch.int8, device=arr.device)
    out[: arr.shape[0]] = _encode_unit(arr)
    return out


def _plane_kind(metric: str) -> str:
    """Which key plane a metric selects on: cosine ranks on the UNIT plane,
    euclidean/dot on the MAGNITUDE plane."""
    return "unit" if metric == "cosine" else "mag"


def _scatter_insert_mag(plane, rows, new_vecs, inv_scale):
    plane.index_copy_(0, rows, _encode_mag(new_vecs, inv_scale))


def _bulk_build_mag(arr, cap, inv_scale):
    out = torch.zeros((cap, arr.shape[1]), dtype=torch.int8, device=arr.device)
    out[: arr.shape[0]] = _encode_mag(arr, inv_scale)
    return out


def _scatter_delete(valid, rows):
    valid.index_fill_(0, rows, False)


def _bulk_build_f32(arr, cap):
    n, w = arr.shape
    vecs = torch.zeros((cap, w), dtype=torch.float32, device=arr.device)
    vecs[:n] = arr
    norms = torch.zeros((cap,), dtype=torch.float32, device=arr.device)
    norms[:n] = _row_norms(arr)
    valid = torch.zeros((cap,), dtype=torch.bool, device=arr.device)
    valid[:n] = True
    return vecs, norms, valid


def _bulk_build_int8(arr, cap):
    n, w = arr.shape
    q, scale = _quantize_int8(arr)
    codes = torch.zeros((cap, w), dtype=torch.int8, device=arr.device)
    codes[:n] = q
    scales = torch.ones((cap,), dtype=torch.float32, device=arr.device)
    scales[:n] = scale
    norms = torch.zeros((cap,), dtype=torch.float32, device=arr.device)
    norms[:n] = _row_norms(arr)
    valid = torch.zeros((cap,), dtype=torch.bool, device=arr.device)
    valid[:n] = True
    return codes, scales, norms, valid


def _pad_rows(t: torch.Tensor, new_cap: int, fill=0) -> torch.Tensor:
    out = torch.full((new_cap, *t.shape[1:]), fill, dtype=t.dtype,
                     device=t.device)
    out[: t.shape[0]] = t
    return out


@dataclass
class SearchTicket:
    """In-flight search: results enqueued on the device, not yet read back.

    ``search_batch_submit`` returns it as soon as the search is enqueued
    (CUDA work is asynchronous) with an event recorded behind it;
    ``search_batch_complete`` waits on that event — possibly on another
    thread, as the serving batcher does — and reads the one packed result
    tensor back."""

    packed: Any   # [B, 2*kb] f32: distances | rows bitcast to f32
    nq: int
    k: int        # caller's k (trim bound)
    kb: int       # result columns computed on the device (the k bucket)
    t0: float = 0.0  # submit timestamp (for the store.search latency metric)
    event: Any = None  # torch.cuda.Event recorded after the search (CUDA)


class DimensionMismatch(ValueError):
    """Vector dimension does not match the store's dimension."""


class InvalidVector(ValueError):
    """Vector contains non-finite or non-numeric elements."""


class VectorStore:
    """One named vector store: device tensors + host id/metadata tables.

    Parameters
    ----------
    name:    store name (unique within a registry).
    dim:     optional fixed dimension; otherwise set by the first insert.
    metric:  default distance metric ("cosine", like the reference).
    dtype:   "float32" (exact) or "int8" (symmetric per-row quantized —
             searched in the quantized domain).
    device:  the torch.device holding the store (default: CUDA if present).
    intkey:  int8 only: keep the key plane for the intkey scans.
    """

    def __init__(
        self,
        name: str,
        dim: Optional[int] = None,
        metric: str = "cosine",
        dtype: str = "float32",
        device: Optional[torch.device] = None,
        intkey: bool = False,
    ):
        if metric not in VALID_METRICS:
            raise ValueError(f"metric must be one of {VALID_METRICS}, got {metric!r}")
        if dtype in ("int4", "int4r"):
            raise _not_ported(f"dtype={dtype!r}")
        if dtype not in ("float32", "int8"):
            raise ValueError(f"dtype must be 'float32' or 'int8', got {dtype!r}")
        if intkey and dtype != "int8":
            raise ValueError("intkey requires dtype='int8'")
        self.name = name
        self.metric = metric
        self.dtype = dtype
        self.device = torch.device(device) if device is not None else default_device()
        self._dim: Optional[int] = dim
        self._capacity = 0
        self._lock = RWLock()
        self._mat_lock = threading.Lock()  # guards _materialize (see there)

        # Device state (allocated lazily once dim is known).
        self._vectors: Optional[torch.Tensor] = None  # f32 rows or int8 codes
        self._scales: Optional[torch.Tensor] = None   # int8 stores only
        self._norms: Optional[torch.Tensor] = None
        self._valid: Optional[torch.Tensor] = None
        # intkey key plane (unit for cosine stores, magnitude for
        # euclidean/dot with global scale _plane_scale); derived from the
        # absmax plane when missing (restored state / S outgrown)
        self.intkey = intkey
        self._codes_unit: Optional[torch.Tensor] = None
        self._plane_scale: Optional[float] = None

        # Host state.
        self._id_to_row: Dict[str, int] = {}
        self._row_to_id: Dict[int, str] = {}
        self._metadata: Dict[str, Any] = {}
        self._free_rows: List[int] = []
        self._next_row = 0
        # Columnar row -> id table (numpy object array [capacity], None for
        # dead rows), kept in lockstep with _row_to_id by every mutation.
        self._ids_np: Optional[np.ndarray] = None
        self._ids_contig_filled = 0  # rows [0, x) hold implicit str ids

        # Metadata filtering: an int32 code column per filtered-on key (0 =
        # absent), so a filter mask is one vectorized compare.
        self._tag_cols: Dict[str, np.ndarray] = {}
        self._tag_vocab: Dict[str, Dict[Any, int]] = {}
        # Device-resident mask cache: (store version, mask) per filter.
        self._dmask_cache: Dict[str, Tuple[int, torch.Tensor]] = {}

        # Bulk builds with implicit ids "0".."n-1" keep the dicts above empty
        # until the first targeted mutation materializes them.
        self._contig = 0

        self.version = 0
        self.created_at = time.time()

    # ---------------------------------------------------------------- props

    @property
    def dim(self) -> Optional[int]:
        return self._dim

    @property
    def count(self) -> int:
        return len(self._id_to_row) + self._contig

    @property
    def capacity(self) -> int:
        return self._capacity

    def __len__(self) -> int:
        return self.count

    def __contains__(self, vector_id: str) -> bool:
        if self._contig:
            sid = str(vector_id)
            # canonical form only: '007'/' 7'/'+7' are NOT stored ids
            if not (sid.isdigit() and (sid == "0" or sid[0] != "0")):
                return False
            return 0 <= int(sid) < self._contig
        return vector_id in self._id_to_row

    def _materialize(self) -> None:
        """Expand implicit contiguous ids into the dict tables (one-time, on
        the first targeted mutation after a bulk build).  Guarded by its own
        mutex with ``_contig`` cleared LAST, since callers may hold only the
        read side of the store lock."""
        if not self._contig:
            return
        with self._mat_lock:
            n = self._contig
            if not n:  # lost the race: another thread materialized
                return
            self._id_to_row = {str(i): i for i in range(n)}
            self._row_to_id = {i: str(i) for i in range(n)}
            self._fill_contig_ids(n)
            self._contig = 0  # publish: tables are complete

    def _fill_contig_ids(self, n: int) -> None:
        if self._ids_np is not None and self._ids_contig_filled < n:
            self._ids_np[self._ids_contig_filled:n] = np.arange(
                self._ids_contig_filled, n).astype(str).astype(object)
            self._ids_contig_filled = n

    def _ids_view(self) -> Optional[np.ndarray]:
        if self._contig:
            self._fill_contig_ids(self._contig)
        return self._ids_np

    # ------------------------------------------------------------ alloc/grow

    def _put(self, x) -> torch.Tensor:
        """A copy of a host array on the store's device (never a view of the
        caller's memory: store tensors are updated in place)."""
        return torch.tensor(np.ascontiguousarray(x), device=self.device)

    def _ensure_allocated(self, dim: int) -> None:
        if self._dim is None:
            self._dim = dim
        if self._vectors is not None:
            return
        width = _pad128(self._dim)
        cap = MIN_CAPACITY
        self._capacity = cap
        dev = self.device
        if self.dtype == "int8":
            self._vectors = torch.zeros((cap, width), dtype=torch.int8, device=dev)
            self._scales = torch.ones((cap,), dtype=torch.float32, device=dev)
            if self.intkey and _plane_kind(self.metric) == "unit":
                # mag planes wait for data: their global scale S comes from
                # the corpus (lazy derivation in _ensure_unit_plane)
                self._codes_unit = torch.zeros((cap, width), dtype=torch.int8,
                                               device=dev)
        else:
            self._vectors = torch.zeros((cap, width), dtype=torch.float32, device=dev)
        self._norms = torch.zeros((cap,), dtype=torch.float32, device=dev)
        self._valid = torch.zeros((cap,), dtype=torch.bool, device=dev)
        if self._ids_np is None:
            self._ids_np = np.full((cap,), None, object)

    def _grow_to(self, new_cap: int) -> None:
        new_cap = max(_next_pow2(new_cap), MIN_CAPACITY)
        if new_cap <= self._capacity:
            return
        self._vectors = _pad_rows(self._vectors, new_cap)
        if self._codes_unit is not None:
            self._codes_unit = _pad_rows(self._codes_unit, new_cap)
        if self._scales is not None:
            self._scales = _pad_rows(self._scales, new_cap, 1.0)
        self._norms = _pad_rows(self._norms, new_cap)
        self._valid = _pad_rows(self._valid, new_cap, False)
        if self._ids_np is not None:
            grown = np.full((new_cap,), None, object)
            grown[: self._capacity] = self._ids_np
            self._ids_np = grown
        for k, col in self._tag_cols.items():
            newcol = np.zeros(new_cap, np.int32)
            newcol[: self._capacity] = col
            self._tag_cols[k] = newcol
        self._capacity = new_cap

    def _alloc_rows(self, n: int) -> List[int]:
        rows: List[int] = []
        while self._free_rows and len(rows) < n:
            rows.append(self._free_rows.pop())
        remaining = n - len(rows)
        if remaining:
            if self._next_row + remaining > self._capacity:
                self._grow_to(self._next_row + remaining)
            rows.extend(range(self._next_row, self._next_row + remaining))
            self._next_row += remaining
        return rows

    # ------------------------------------------------------------ validation

    def _validate_batch(self, vectors) -> np.ndarray:
        arr = np.asarray(vectors, dtype=np.float32)
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.ndim != 2:
            raise InvalidVector("vectors must be 1-D or 2-D numeric arrays")
        if self._dim is not None and arr.shape[1] != self._dim:
            raise DimensionMismatch(
                f"store {self.name!r} has dimension {self._dim}, got {arr.shape[1]}"
            )
        if arr.shape[1] == 0:
            raise InvalidVector("vectors must be non-empty")
        if not np.all(np.isfinite(arr)):
            raise InvalidVector("vector elements must be finite numbers")
        return arr

    # ---------------------------------------------------------------- insert

    def insert(self, vector_id: str, vector, metadata: Optional[dict] = None) -> None:
        """Insert or overwrite one vector (reference insert/3 semantics)."""
        self.insert_batch([vector_id], [vector], [metadata or {}])

    def insert_batch(
        self,
        ids: Sequence[str],
        vectors,
        metadatas: Optional[Sequence[Optional[dict]]] = None,
    ) -> None:
        """Batched insert: one in-place device scatter for the whole batch."""
        if len(ids) == 0:
            return
        arr = self._validate_batch(vectors)
        if arr.shape[0] != len(ids):
            raise ValueError("ids and vectors length mismatch")
        if metadatas is None:
            metadatas = [{}] * len(ids)
        if len(ids) > 1:
            # Batch-internal duplicates collapse to the LAST occurrence
            # (last-write-wins): otherwise two new occurrences of one id would
            # each take a row, leaving a ghost row search returns forever.
            last = {str(v): i for i, v in enumerate(ids)}
            if len(last) != len(ids):
                keep = sorted(last.values())
                ids = [ids[i] for i in keep]
                arr = arr[keep]
                metadatas = [metadatas[i] for i in keep]
        with self._lock.write(), metrics.timed("store.insert"):
            self._materialize()
            self._ensure_allocated(arr.shape[1])
            # bulk-load fast path: an append-only store takes a contiguous
            # row range and builds the id tables at C speed
            fast = (
                not self._id_to_row
                and not self._free_rows
                and len(set(map(str, ids))) == len(ids)
            ) if len(ids) >= 1024 else False
            if fast:
                n_new = len(ids)
                if self._next_row + n_new > self._capacity:
                    self._grow_to(self._next_row + n_new)
                rows = np.arange(self._next_row, self._next_row + n_new,
                                 dtype=np.int64)
                self._next_row += n_new
            else:
                rows = np.empty(len(ids), np.int64)
                fresh_needed = []
                for i, vid in enumerate(ids):
                    existing = self._id_to_row.get(str(vid))
                    if existing is not None:
                        rows[i] = existing
                    else:
                        fresh_needed.append(i)
                fresh_rows = self._alloc_rows(len(fresh_needed))
                for i, row in zip(fresh_needed, fresh_rows):
                    rows[i] = row
            width = _pad128(arr.shape[1])
            arr_dev = np.zeros((len(ids), width), np.float32)
            arr_dev[:, : arr.shape[1]] = arr
            rows_t = self._put(rows)
            vecs_t = self._put(arr_dev)
            if self.dtype == "int8":
                _scatter_insert_int8(self._vectors, self._scales, self._norms,
                                     self._valid, rows_t, vecs_t)
                if self.intkey and self._codes_unit is not None:
                    if _plane_kind(self.metric) == "unit":
                        _scatter_insert_unit(self._codes_unit, rows_t, vecs_t)
                    else:
                        # a row outgrowing the global scale S invalidates the
                        # magnitude plane (rebuilt lazily with a fresh S on
                        # the next keyed search)
                        mx = float(np.sqrt((arr.astype(np.float64) ** 2)
                                           .sum(axis=1).max()))
                        if self._plane_scale is None or mx > self._plane_scale:
                            self._codes_unit = None
                            self._plane_scale = None
                        else:
                            _scatter_insert_mag(self._codes_unit, rows_t, vecs_t,
                                                127.0 / self._plane_scale)
            else:
                _scatter_insert_f32(self._vectors, self._norms, self._valid,
                                    rows_t, vecs_t)
            sids = [str(v) for v in ids]
            row_list = rows.tolist()
            if fast:
                self._id_to_row.update(zip(sids, row_list))
                self._row_to_id.update(zip(row_list, sids))
                if any(m for m in metadatas):
                    self._metadata.update(
                        (v, m if m is not None else {})
                        for v, m in zip(sids, metadatas))
            else:
                for vid, row, md in zip(sids, row_list, metadatas):
                    self._id_to_row[vid] = row
                    self._row_to_id[row] = vid
                    self._metadata[vid] = md if md is not None else {}
            self._ids_np[rows] = sids
            self._update_tags(rows, metadatas)
            self.version += 1

    # ---------------------------------------------------------------- delete

    def delete(self, vector_id: str) -> bool:
        """Delete by id; returns False if absent (reference {error, not_found})."""
        return self.delete_batch([vector_id]) == 1

    def delete_batch(self, ids: Iterable[str]) -> int:
        with self._lock.write():
            self._materialize()
            rows = []
            hit_ids = []
            seen = set()
            for vid in ids:
                vid = str(vid)
                if vid in seen:  # a second del would KeyError mid-mutation
                    continue
                seen.add(vid)
                row = self._id_to_row.get(vid)
                if row is not None:
                    rows.append(row)
                    hit_ids.append(vid)
            if not rows:
                return 0
            rows_t = self._put(np.asarray(rows, np.int64))
            _scatter_delete(self._valid, rows_t)
            if self._codes_unit is not None:
                _scatter_zero_unit(self._codes_unit, rows_t)
            for vid, row in zip(hit_ids, rows):
                del self._id_to_row[vid]
                del self._row_to_id[row]
                self._metadata.pop(vid, None)
                self._free_rows.append(row)
                self._ids_np[row] = None
            for col in self._tag_cols.values():
                col[rows] = 0
            self.version += 1
            return len(rows)

    # ---------------------------------------------------------------- search

    def search(self, query, k: int = 10, metric: Optional[str] = None,
               where: Optional[dict] = None, nprobe: Optional[int] = None,
               recall_target: Optional[float] = None,
               ) -> List[Tuple[str, Any, float]]:
        """Top-k search for one query; ``[(id, metadata, distance)]``
        ascending by distance.  ``where`` restricts results to vectors whose
        metadata matches every key/value equality predicate.  Above ~590k
        rows with k <= 16 on a CUDA device the key/pos scans keep the top-1
        of each 1024-row slice (see ops/fused_topk.py); ``EVDB_EXACT_SCAN=1``
        forces (near-)exact masked extraction."""
        results = self.search_batch(
            np.asarray(query, np.float32)[None, :], k, metric, where,
            nprobe=nprobe, recall_target=recall_target)
        return results[0]

    @staticmethod
    def _filter_indexable(where: dict) -> bool:
        try:
            for v in where.values():
                hash(v)
            return True
        except TypeError:
            return False

    def filter_mask(self, where: dict) -> np.ndarray:
        """Row mask for metadata equality predicates (AND semantics).
        Hashable values ride the columnar tag tables; unhashable values fall
        back to the per-row metadata walk."""
        if not self._metadata:  # no metadata anywhere: nothing can match
            return np.zeros(self._capacity, bool)
        if self._filter_indexable(where) and self._capacity:
            self._ensure_tag_cols(tuple(where))
            with self._lock.read():
                mask = np.ones(self._capacity, bool)
                for kk, vv in where.items():
                    code = self._tag_vocab.get(kk, {}).get(vv)
                    if code is None:  # value never seen for this key
                        mask[:] = False
                        break
                    mask &= self._tag_cols[kk] == code
                return mask
        mask = np.zeros(self._capacity, bool)
        with self._lock.read():
            self._materialize()
            for vid, meta in self._metadata.items():
                if all(meta.get(kk) == vv for kk, vv in where.items()):
                    row = self._id_to_row.get(vid)
                    if row is not None:
                        mask[row] = True
        return mask

    def _device_filter_mask(self, where: dict) -> torch.Tensor:
        """Device-resident filter mask, cached per (filter, store version)."""
        wk = json.dumps(where, sort_keys=True, default=repr)
        cached = self._dmask_cache.get(wk)
        if cached is not None and cached[0] == self.version:
            return cached[1]
        # snapshot the version BEFORE building: a write landing during the
        # build must not get its stale mask cached under the new version
        ver = self.version
        dm = self._put(self.filter_mask(where))
        if len(self._dmask_cache) >= 32:
            self._dmask_cache.pop(next(iter(self._dmask_cache)))
        self._dmask_cache[wk] = (ver, dm)
        return dm

    def _ensure_tag_cols(self, keys: Tuple[str, ...]) -> None:
        """Backfill tag columns for keys not yet indexed."""
        if all(k in self._tag_cols for k in keys):
            return
        with self._lock.write():
            self._materialize()
            for k in keys:
                if k in self._tag_cols:
                    continue
                col = np.zeros(self._capacity, np.int32)
                vocab = self._tag_vocab.setdefault(k, {})
                for vid, meta in self._metadata.items():
                    if isinstance(meta, dict) and k in meta:
                        try:
                            code = vocab.setdefault(meta[k], len(vocab) + 1)
                        except TypeError:
                            continue  # unhashable value: not indexable
                        row = self._id_to_row.get(vid)
                        if row is not None:
                            col[row] = code
                self._tag_cols[k] = col

    def _update_tags(self, rows, mds) -> None:
        """Maintain tag columns for written rows (caller holds write lock).
        Insert replaces a row's metadata wholesale, so absent keys clear."""
        if not self._tag_cols:
            return
        for i, row in enumerate(rows):
            md = mds[i] or {}
            for k, col in self._tag_cols.items():
                if k in md:
                    try:
                        col[row] = self._tag_vocab[k].setdefault(
                            md[k], len(self._tag_vocab[k]) + 1)
                    except TypeError:
                        col[row] = 0
                else:
                    col[row] = 0

    def search_batch(self, queries, k: int = 10, metric: Optional[str] = None,
                     where: Optional[dict] = None, nprobe: Optional[int] = None,
                     recall_target: Optional[float] = None,
                     ) -> List[List[Tuple[str, Any, float]]]:
        """Batched top-k for B queries."""
        return self.search_batch_complete(
            self.search_batch_submit(queries, k, metric, where, nprobe=nprobe,
                                     recall_target=recall_target))

    def search_batch_submit(self, queries, k: int = 10,
                            metric: Optional[str] = None,
                            where: Optional[dict] = None,
                            nprobe: Optional[int] = None,
                            recall_target: Optional[float] = None,
                            ) -> SearchTicket:
        """Enqueue a batched search WITHOUT waiting for the device: the
        serving batcher submits batch i+1 while batch i still runs."""
        if nprobe is not None or recall_target is not None:
            raise _not_ported("multiprobe search (nprobe / recall_target)")
        metric = metric or self.metric
        if metric not in VALID_METRICS:
            raise ValueError(f"metric must be one of {VALID_METRICS}, got {metric!r}")
        t0 = time.perf_counter()
        q = self._validate_batch(queries)
        fmask = self._device_filter_mask(where) if where else None
        # read side of the store lock: searches run concurrently, but never
        # against tensors an insert is updating in place
        with self._lock.read():
            t = self._dispatch_locked(q, k, metric, fmask)
        t.t0 = t0
        return t

    def search_batch_complete(self, t: SearchTicket
                              ) -> List[List[Tuple[str, Any, float]]]:
        """Wait for a ticket's device results and map rows to ids/metadata."""
        if t.kb == 0:
            return [[] for _ in range(t.nq)]
        dists_np, rows_np = self._readback(t)
        metrics.observe("store.search", time.perf_counter() - t.t0)
        metrics.inc("store.search_total")
        metrics.inc("store.queries_total", t.nq)
        with self._lock.read():
            return self._map_results(dists_np, rows_np, t.k, t.kb)

    def search_batch_complete_raw(self, t: SearchTicket):
        """Columnar completion: (distances [nq, kk] f32, rows [nq, kk] int32,
        ids [nq, kk] object-or-None), no per-hit tuples."""
        if t.kb == 0:
            return (np.zeros((t.nq, 0), np.float32),
                    np.zeros((t.nq, 0), np.int32), None)
        kk = min(t.k, t.kb)
        dists_np, rows_np = self._readback(t)
        dists_np = dists_np[:, :kk]
        rows_np = rows_np[:, :kk]
        with self._lock.read():
            ids = self._ids_view()[rows_np]
        return dists_np, rows_np, ids

    def _readback(self, t: SearchTicket):
        """One device->host copy per ticket, after the ticket's event."""
        if t.event is not None:
            t.event.synchronize()
        arr = t.packed.cpu().numpy()
        kb = t.kb
        return arr[:, :kb], np.ascontiguousarray(arr[:, kb:]).view(np.int32)

    def _map_results(self, dists_np, rows_np, k, kb):
        """Vectorized row->id mapping: one fancy-index into the columnar id
        table + tolist()."""
        kk = min(k, kb)
        ids_l = self._ids_view()[rows_np[:, :kk]].tolist()
        d_l = dists_np[:, :kk].tolist()
        md = self._metadata
        isfinite = math.isfinite
        out: List[List[Tuple[str, Any, float]]] = []
        for irow, drow in zip(ids_l, d_l):
            hits = []
            for vid, d in zip(irow, drow):
                if not isfinite(d):
                    break  # ran past the valid rows
                if vid is None:
                    continue  # row deleted between device scan and host map
                hits.append((vid, md.get(vid, {}), d))
            out.append(hits)
        return out

    def _dispatch_locked(self, q, k, metric, fmask=None) -> SearchTicket:
        nq = q.shape[0]
        if self._vectors is None or self.count == 0 or k <= 0:
            return SearchTicket(None, nq, k, 0)
        kb = search_mod.k_bucket(min(k, self.count), self._capacity)
        width = _pad128(q.shape[1])
        if width != q.shape[1]:
            qp = np.zeros((nq, width), np.float32)
            qp[:, : q.shape[1]] = q
            q = qp
        q_t = self._put(q)
        valid = self._valid
        if fmask is not None:
            # the mask is built OUTSIDE the store lock; a concurrent insert
            # may have grown capacity since: rows added after the mask was
            # built are excluded (pad False)
            fm = fmask
            if fm.shape[0] < valid.shape[0]:
                fm = torch.cat([fm, torch.zeros(valid.shape[0] - fm.shape[0],
                                                dtype=torch.bool, device=fm.device)])
            elif fm.shape[0] > valid.shape[0]:
                fm = fm[: valid.shape[0]]
            valid = valid & fm

        if ft.fused_topk_available(self.count, self._capacity, metric,
                                   self.device, kb):
            nt = ft.n_tiles_for(self._next_row, self._capacity)
            cu = None
            ps = None
            # the key plane serves only requests whose metric matches its
            # kind (unit ranks cosine; mag ranks dot AND euclidean) — other
            # per-request metrics ride the pos path
            if (self.intkey and ft.intkey_applies(metric, nt, kb)
                    and _plane_kind(metric) == _plane_kind(self.metric)):
                cu = self._ensure_unit_plane()
                if metric == "euclidean" and cu is not None:
                    ps = self._plane_scale
            dists, rows = ft.fused_topk(
                self._vectors,
                self._scales if self.dtype == "int8" else None,
                self._norms, valid, q_t, metric=metric, k=kb, n_tiles=nt,
                codes_unit=cu, plane_scale=ps)
        elif self.dtype == "int8":
            dists, rows = search_mod.exact_topk_int8(
                self._vectors, self._scales, self._norms, valid, q_t,
                metric=metric, k=kb)
        else:
            dists, rows = search_mod.exact_topk(
                self._vectors, self._norms, valid, q_t, metric=metric, k=kb)
        return self._finish_ticket(dists, rows, nq, k)

    def _ensure_unit_plane(self):
        """The intkey key plane (unit for cosine stores, magnitude for
        euclidean/dot), derived from the absmax plane when missing.
        Idempotent cache fill, safe under the read lock."""
        if self._vectors is None:
            return None
        if (self._codes_unit is None
                or self._codes_unit.shape[0] != self._capacity):
            if _plane_kind(self.metric) == "unit":
                self._codes_unit = ft.requantize_unit(
                    self._vectors, self._scales, self._norms, self._valid)
            else:
                nmax = float(torch.amax(torch.where(
                    self._valid, self._norms, torch.zeros_like(self._norms))))
                if nmax <= 0.0:
                    return None  # nothing valid to key; the pos path serves
                # 1.25x slack so typical future inserts stay inside S
                self._plane_scale = 1.25 * nmax
                self._codes_unit = ft.requantize_mag(
                    self._vectors, self._scales, self._valid, self._plane_scale)
        return self._codes_unit

    def _finish_ticket(self, dists, rows, nq, k):
        """Pack (dists | rows bitcast to f32) into one tensor so completion
        is a single device->host copy, and record an event behind it.  The
        ticket's width is the result's own: a key scan over fewer slices than
        the k bucket returns fewer columns."""
        packed = torch.cat([dists.float(),
                            rows.to(torch.int32).view(torch.float32)], dim=1)
        event = None
        if packed.is_cuda:
            event = torch.cuda.Event()
            event.record()
        return SearchTicket(packed, nq, min(k, self.count), int(dists.shape[1]),
                            event=event)

    # ------------------------------------------------------------- accessors

    def get(self, vector_id: str) -> Optional[Tuple[np.ndarray, Any]]:
        """Fetch one vector and its metadata (dequantized for int8 stores)."""
        with self._lock.read():
            self._materialize()
            row = self._id_to_row.get(str(vector_id))
            if row is None:
                return None
            vec = self._vectors[row].cpu().numpy()[: self._dim]
            if self.dtype == "int8":
                vec = vec.astype(np.float32) * float(self._scales[row])
            return vec, self._metadata.get(str(vector_id), {})

    def get_all_vectors(self) -> List[Tuple[str, np.ndarray, Any]]:
        """All live (id, vector, metadata) — migration/backup path."""
        with self._lock.read():
            self._materialize()
            if self.count == 0:
                return []
            rows = sorted(self._row_to_id)
            mat = self._vectors.cpu().numpy()  # one transfer
            scales = (self._scales.cpu().numpy() if self.dtype == "int8"
                      else None)
            out = []
            for row in rows:
                vid = self._row_to_id[row]
                vec = mat[row][: self._dim]
                if scales is not None:
                    vec = vec.astype(np.float32) * scales[row]
                out.append((vid, vec, self._metadata.get(vid, {})))
            return out

    def get_stats(self) -> dict:
        """Stats shape parity with reference get_stats."""
        return {
            "name": self.name,
            "count": self.count,
            "dimension": self._dim,
            "metric": self.metric,
            "dtype": self.dtype,
            "capacity": self._capacity,
            "version": self.version,
            "memory_bytes": self.device_memory_bytes(),
        }

    def device_memory_bytes(self) -> int:
        if self._vectors is None:
            return 0
        total = self._vectors.numel() * self._vectors.element_size()
        total += self._norms.numel() * 4 + self._valid.numel()
        if self._codes_unit is not None:
            total += self._codes_unit.numel()
        if self._scales is not None:
            total += self._scales.numel() * 4
        return int(total)

    # ----------------------------------------------------- state export/import

    def export_state(self) -> dict:
        """Host-side state (numpy arrays), in the JAX package's format 1."""
        with self._lock.read():
            self._materialize()
            state = {
                "format": 1,
                "name": self.name,
                "dim": self._dim,
                "metric": self.metric,
                "dtype": self.dtype,
                "created_at": self.created_at,
                "version": self.version,
                "id_to_row": dict(self._id_to_row),
                "metadata": dict(self._metadata),
                "next_row": self._next_row,
                "free_rows": list(self._free_rows),
                "intkey": self.intkey,
            }
            if self._vectors is not None:
                state["vectors"] = self._vectors.cpu().numpy()
                state["norms"] = self._norms.cpu().numpy()
                state["valid"] = self._valid.cpu().numpy()
                if self._scales is not None:
                    state["scales"] = self._scales.cpu().numpy()
            return state

    @classmethod
    def from_state(cls, state: dict, device: Optional[torch.device] = None
                   ) -> "VectorStore":
        """A store from an exported state dict — this package's or the JAX
        package's ``VectorStore.export_state()`` (numpy arrays).  An intkey
        store's key plane is re-derived from the absmax plane."""
        store = cls(
            state["name"],
            dim=state.get("dim"),
            metric=state.get("metric", "cosine"),
            dtype=state.get("dtype", "float32"),
            device=device,
            intkey=bool(state.get("intkey", False)),
        )
        store.created_at = state.get("created_at", time.time())
        store.version = state.get("version", 0)
        if state.get("vectors") is not None:
            vecs = np.asarray(state["vectors"])
            store._capacity = vecs.shape[0]
            store._vectors = store._put(vecs)
            store._norms = store._put(np.asarray(state["norms"], np.float32))
            store._valid = store._put(np.asarray(state["valid"], bool))
            if state.get("scales") is not None:
                store._scales = store._put(np.asarray(state["scales"], np.float32))
        store._id_to_row = {str(k): int(v)
                            for k, v in state.get("id_to_row", {}).items()}
        store._row_to_id = {v: k for k, v in store._id_to_row.items()}
        if store._capacity:
            store._ids_np = np.full((store._capacity,), None, object)
            if store._id_to_row:
                rows_arr = np.fromiter(store._row_to_id.keys(), np.int64,
                                       len(store._row_to_id))
                store._ids_np[rows_arr] = list(store._row_to_id.values())
        store._metadata = dict(state.get("metadata", {}))
        store._contig = int(state.get("contig", 0))
        store._next_row = int(state.get("next_row", store.count))
        store._free_rows = [int(r) for r in state.get("free_rows", [])]
        if store.intkey:
            store._ensure_unit_plane()
        return store

    def warmup(self, batch_sizes=(1, 64, 256), ks=(1, 10)) -> int:
        """Run the search path once per (batch, k) bucket so the first real
        query does not pay the kernel build.  Returns the searches run."""
        if self._vectors is None or self.count == 0 or self._dim is None:
            return 0
        n = 0
        for b in batch_sizes:
            q = np.zeros((b, self._dim), np.float32)
            for k in ks:
                self.search_batch(q, k=k)
                n += 1
        return n

    @classmethod
    def from_matrix(
        cls,
        name: str,
        matrix,
        ids: Optional[Sequence[str]] = None,
        metric: str = "cosine",
        dtype: str = "float32",
        device: Optional[torch.device] = None,
        metadatas: Optional[Sequence[dict]] = None,
        intkey: bool = False,
    ) -> "VectorStore":
        """Bulk index build: one host->device transfer and a few tensor ops,
        no per-row host bookkeeping.  With ``ids=None`` row i gets the
        implicit id ``str(i)`` and the id tables stay virtual until the first
        targeted mutation.  ``matrix`` may be a numpy array or a tensor
        (already on the device, for corpora generated there)."""
        store = cls(name, metric=metric, dtype=dtype, device=device,
                    intkey=intkey)
        if isinstance(matrix, torch.Tensor):
            arr = matrix.to(device=store.device, dtype=torch.float32)
        else:
            arr = store._put(np.asarray(matrix, np.float32))
        n, d = arr.shape
        store._dim = d
        cap = max(_next_pow2(n), MIN_CAPACITY)
        store._capacity = cap
        width = _pad128(d)
        if width != d:
            arr = torch.nn.functional.pad(arr, (0, width - d))
        if store.dtype == "int8":
            (store._vectors, store._scales, store._norms,
             store._valid) = _bulk_build_int8(arr, cap)
            if intkey:
                # exact key plane from the f32 rows (no double quantization)
                if _plane_kind(metric) == "unit":
                    store._codes_unit = _bulk_build_unit(arr, cap)
                else:
                    nmax = float(torch.amax(store._norms))
                    if nmax > 0.0:
                        store._plane_scale = 1.25 * nmax
                        store._codes_unit = _bulk_build_mag(
                            arr, cap, 127.0 / store._plane_scale)
        else:
            store._vectors, store._norms, store._valid = _bulk_build_f32(arr, cap)
        del arr
        store._next_row = n
        store._ids_np = np.full((cap,), None, object)
        if metadatas is not None:
            if len(metadatas) != n:
                raise ValueError("metadatas and matrix length mismatch")
            eff_ids = ids if ids is not None else range(n)
            store._metadata = {str(v): (m or {})
                               for v, m in zip(eff_ids, metadatas)}
        if ids is None:
            store._contig = n
        else:
            if len(ids) != n:
                raise ValueError("ids and matrix length mismatch")
            store._id_to_row = {str(v): i for i, v in enumerate(ids)}
            store._row_to_id = {i: str(v) for i, v in enumerate(ids)}
            if len(store._id_to_row) != n:
                raise ValueError("duplicate ids in bulk build")
            store._ids_np[:n] = [str(v) for v in ids]
        store.version = 1
        return store
