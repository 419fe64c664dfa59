"""Device-resident vector store (f32, int8, int4 and int4r rows) on a torch
device.

Counterpart of ``erlvectordb_tpu/core/store.py``.  Each store is a
struct-of-arrays on one ``torch.device``:

  * ``vectors [N_cap, W]`` float32 rows, or int8 absmax codes + per-row
    ``scales`` for a quantized store, or packed int4 codes ``[N_cap, W/2]``
    uint8 (two signed nibbles a byte) + scales; W is the dimension padded to
    128;
  * int4r (cell-residual) stores keep rows at ``cell * cell_cap + slot``
    with 4-bit codes of the row's RESIDUAL against its cell centroid
    (``centroids [K, W]``): the quantizer sees a 3-4x smaller range than
    whole-vector int4, which is what makes 4-bit rows search-grade;
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
id overwrites it.  int4r stores also answer the sub-linear multiprobe search
(``nprobe``, or ``recall_target`` through a calibration curve) over their own
cell layout (ops/cell_probe.py, kernel B7).  Streaming builds with spill
copies (``spill_mult``) over-fetch and dedup per query and refuse targeted
mutations.  ``rq_m`` adds the int4r second stage: OPQ codes (rq_m bytes a
row) of each row's int4 reconstruction error, rescored over a pool of
stage-1 winners in multiprobe searches.
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
from erlvectordb_tpu_torch.core.calibration import CalibrationSet, measure_curve
from erlvectordb_tpu_torch.core.search import VALID_METRICS
from erlvectordb_tpu_torch.ops import fused_topk as ft
from erlvectordb_tpu_torch.utils.locks import RWLock
from erlvectordb_tpu_torch.utils.metrics import metrics

MIN_CAPACITY = 1024


def default_device() -> torch.device:
    """The device a store takes when its caller names none: the CUDA card.
    Without one this raises; callers that mean the CPU say so."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: erlvectordb_tpu_torch runs on the card unless "
            "the caller asks for another device (device='cpu')")
    return torch.device("cuda")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _pad128(d: int) -> int:
    """Rows are stored zero-padded to a multiple of 128 columns, so every
    kernel can assume aligned rows (dots, norms and L1 are unaffected)."""
    return ((d + 127) // 128) * 128


# --------------------------------------------------------------------------
# Row encoders and in-place scatters.  `rows` is an int64 tensor of distinct
# target rows on the store's device; `new_vecs` f32 [n, W] (zero-padded).
# --------------------------------------------------------------------------


def _row_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row absmax int8 codes and scales."""
    absmax = x.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, ft.mul_recip(absmax, 127.0),
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


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7] -> packed uint8, first value in the high
    nibble."""
    nib = (q.to(torch.int16) & 0xF).to(torch.uint8)
    return (nib[:, 0::2] << 4) | nib[:, 1::2]


def _unpack_int4_np(packed: np.ndarray) -> np.ndarray:
    hi = (packed >> 4).astype(np.int8)
    lo = (packed & 0xF).astype(np.int8)
    hi = np.where(hi > 7, hi - 16, hi)
    lo = np.where(lo > 7, lo - 16, lo)
    return np.stack([hi, lo], axis=-1).reshape(packed.shape[0], -1)


def _quantize_int4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row absmax int4 codes (packed) and scales.  The scale
    is absmax times the f32 reciprocal of 7: XLA compiles the JAX package's
    ``absmax / 7.0`` so (one f32 multiply, the same on every device)."""
    absmax = x.abs().amax(dim=-1)
    inv7 = torch.tensor(1.0 / 7.0, dtype=torch.float32, device=x.device)
    scale = torch.where(absmax > 0, absmax * inv7, torch.ones_like(absmax))
    q = torch.clamp(torch.round(x / scale[:, None]), -7, 7).to(torch.int8)
    return _pack_int4(q), scale


def _scatter_insert_int4(packed, scales, norms, valid, rows, new_vecs):
    q, scale = _quantize_int4(new_vecs)
    packed.index_copy_(0, rows, q)
    scales.index_copy_(0, rows, scale)
    norms.index_copy_(0, rows, _row_norms(new_vecs))
    valid.index_fill_(0, rows, True)


def _bulk_build_int4(arr, cap):
    n, w = arr.shape
    q, scale = _quantize_int4(arr)
    packed = torch.zeros((cap, w // 2), dtype=torch.uint8, device=arr.device)
    packed[:n] = q
    scales = torch.ones((cap,), dtype=torch.float32, device=arr.device)
    scales[:n] = scale
    norms = torch.zeros((cap,), dtype=torch.float32, device=arr.device)
    norms[:n] = _row_norms(arr)
    valid = torch.zeros((cap,), dtype=torch.bool, device=arr.device)
    valid[:n] = True
    return packed, scales, norms, valid


def _quantize_residual(res: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """4-bit residual quantization with per-row optimal clipping: try a few
    clip fractions of absmax and keep the min-MSE one (clipping trades rare
    saturation for finer steps everywhere)."""
    absmax = res.abs().amax(dim=-1)
    best_q = best_s = best_e = None
    for c in (0.7, 0.8, 0.9, 1.0):
        s = torch.where(absmax > 0, ft.div_scalar(c * absmax, 7.0),
                        torch.ones_like(absmax))
        q = torch.clamp(torch.round(res / s[:, None]), -7, 7).to(torch.int8)
        e = torch.sum((q.float() * s[:, None] - res) ** 2, dim=-1)
        if best_q is None:
            best_q, best_s, best_e = q, s, e
        else:
            take = e < best_e
            best_q = torch.where(take[:, None], q, best_q)
            best_s = torch.where(take, s, best_s)
            best_e = torch.minimum(e, best_e)
    return best_q, best_s


def _encode_residual(new_vecs, cents_rows):
    """(packed codes, scales, reconstruction norms) of rows against their
    cells' centroids.  Stored norms are the norms of the RECONSTRUCTION
    c + q*s: cosine/euclidean then rank by the quantized vector's own
    geometry."""
    q, scale = _quantize_residual(new_vecs - cents_rows)
    recon = cents_rows + q.float() * scale[:, None]
    return _pack_int4(q), scale, _row_norms(recon)


def _scatter_insert_int4r(packed, scales, norms, valid, rows, new_vecs,
                          cents_rows):
    """Residual insert: quantize (x - centroid) to packed int4."""
    codes, scale, rnorm = _encode_residual(new_vecs, cents_rows)
    packed.index_copy_(0, rows, codes)
    scales.index_copy_(0, rows, scale)
    norms.index_copy_(0, rows, rnorm)
    valid.index_fill_(0, rows, True)


def _bulk_build_int4r(xp, cents_rows, pos, n_rows):
    """Bulk residual build into the cell-major layout: xp [n, W] f32,
    cents_rows [n, W] (each row's centroid), pos [n] target rows."""
    codes, scale, rnorm = _encode_residual(xp, cents_rows)
    dev = xp.device
    packed = torch.zeros((n_rows, xp.shape[1] // 2), dtype=torch.uint8,
                         device=dev)
    packed[pos] = codes
    scales = torch.ones((n_rows,), dtype=torch.float32, device=dev)
    scales[pos] = scale
    norms = torch.zeros((n_rows,), dtype=torch.float32, device=dev)
    norms[pos] = rnorm
    valid = torch.zeros((n_rows,), dtype=torch.bool, device=dev)
    valid[pos] = True
    return packed, scales, norms, valid


def _rq_encode_chunk(packed, scales, cents_rows, x_rows, rot, books, *, d,
                     dp2):
    """Second-stage encode of a slot chunk: the stage-1 reconstruction from
    the packed codes, its error against the original rows (zero-padded to
    the rq dim dp2), the OPQ encode, and the FULL-reconstruction norm (the
    numerator and denominator of a rescored cosine must describe the same
    vector).  Returns (codes [n, M2] uint8, norms [n])."""
    from erlvectordb_tpu_torch.quant.pq import _decode, _encode

    recon = cents_rows + ft.unpack_int4(packed).float() * scales[:, None]
    e = x_rows[:, :d] - recon[:, :d]
    if dp2 > d:
        e = torch.nn.functional.pad(e, (0, dp2 - d))
    with ft.full_f32_matmul():
        c2 = _encode(e @ rot, books)
        dec = _decode(c2, books) @ rot.T
    full = recon[:, :d] + dec[:, :d]
    return c2, torch.sqrt(torch.sum(full * full, dim=-1))


def _pad_rows(t: torch.Tensor, new_cap: int, fill=0) -> torch.Tensor:
    out = torch.full((new_cap, *t.shape[1:]), fill, dtype=t.dtype,
                     device=t.device)
    out[: t.shape[0]] = t
    return out


def _implicit_ids(rows_np: np.ndarray) -> np.ndarray:
    """Original-row results of a streaming-built store as ids (None where
    the slot was empty, perm == -1)."""
    return np.where(rows_np >= 0, rows_np.astype(str).astype(object), None)


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
    rows_are_orig: bool = False  # streaming-built store: rows were mapped
    #                    slot -> original row on the device, so ids are
    #                    str(row) (valid even if the store materializes its
    #                    host tables before completion)


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
    dtype:   "float32" (exact), "int8" (symmetric per-row quantized —
             searched in the quantized domain), "int4" (packed nibbles, half
             of int8's memory) or "int4r" (int4 cell residuals).
    device:  the torch.device holding the store (default: the CUDA card;
             without one, pass ``device="cpu"``).
    intkey:  int8 only: keep the key plane for the intkey scans.
    """

    CELL_BLOCK = 64  # cells appended per growth step; keeps K a multiple of
    #                  TILE_N / cell_cap so the fused scans stay tile-aligned

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
        if dtype not in ("float32", "int8", "int4", "int4r"):
            raise ValueError(
                "dtype must be 'float32', 'int8', 'int4' or 'int4r', "
                f"got {dtype!r}")
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

        # int4r (cell-residual) state: rows live at cell*cell_cap + slot;
        # codes are 4-bit residuals against the row's cell centroid
        self._centroids: Optional[torch.Tensor] = None  # [K, W] f32
        self._cell_cap = 0
        self._cell_next: Optional[np.ndarray] = None   # per-cell slot HWM
        self._cell_avail: Optional[np.ndarray] = None  # free slots per cell
        self._cell_free: Dict[int, List[int]] = {}     # freed rows per cell
        # realized max |int4 code|_2, the residual scan's key-window bound
        # (lazy; invalidated by int4r inserts — a stale underestimate only
        # costs worst-match rows their rank, never correctness)
        self._code_norm_max: Optional[float] = None
        # multiprobe routing: a persistent bf16 copy of the centroids and
        # their |c|^2, renewed when the centroid tensor changes
        self._cents_rt: Optional[torch.Tensor] = None
        self._cents_cn2: Optional[torch.Tensor] = None
        self._cents_rt_src: Optional[torch.Tensor] = None
        # recall_target calibration curves, keyed (k, metric); lazy
        # first-use calibration is serialized by the set's lock
        self._calib = CalibrationSet()
        # streaming builds with spill copies hold some rows twice: searches
        # over-fetch 2k and dedup, targeted mutations are refused
        self._spilled = False
        # cell-layout drift since the last bulk build/refit (is_stale)
        self._built_rows = 0
        self._churn_inserts = 0
        self._churn_deletes = 0
        self._cells_at_build = 0
        self.build_stats: dict = {}
        # optional second stage (``rq_m`` on from_matrix): OPQ codes of the
        # int4 reconstruction error, rq_m bytes a row, rescored over a pool
        # of stage-1 winners in multiprobe searches
        self._rq_m = 0
        self._rq_codes: Optional[torch.Tensor] = None  # [capacity, M2] uint8
        self._rq_books: Optional[torch.Tensor] = None  # [M2, 256, ds] f32
        self._rq_rot: Optional[torch.Tensor] = None    # [dp2, dp2] f32
        self.rq_pool = 64  # stage-2 rescore pool floor (max(4k_bucket, this))

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
        # Streaming cell builds (from_chunks) leave rows permuted by cell
        # with the slot -> original-row map on the device: ids stay implicit
        # ("0".."n-1" by original row) and search results are mapped by a
        # device gather; the first targeted mutation materializes host
        # tables from one perm readback.
        self._perm_dev: Optional[torch.Tensor] = None
        self._perm_count = 0

        # Change tracking for persistence (persist/snapshot.py): ``dirty``
        # and ``version`` say a sync is due; ``_touched_rows`` holds the rows
        # written since the last snapshot, so the sync loop can write an
        # O(delta) incremental snapshot.  ``_touched_reliable`` is False
        # until a full snapshot anchors the delta chain: bulk builds,
        # capacity growth, refits, restores and a rebuilt key plane force
        # the next sync to write a full base.
        self.version = 0
        self.dirty = False
        self.created_at = time.time()
        self._touched_rows: set = set()
        self._touched_reliable = False

    # ---------------------------------------------------------------- props

    @property
    def dim(self) -> Optional[int]:
        return self._dim

    @property
    def count(self) -> int:
        return len(self._id_to_row) + self._contig + self._perm_count

    @property
    def capacity(self) -> int:
        return self._capacity

    def __len__(self) -> int:
        return self.count

    def __contains__(self, vector_id: str) -> bool:
        implicit = self._contig or self._perm_count
        if implicit:
            sid = str(vector_id)
            # canonical form only: '007'/' 7'/'+7' are NOT stored ids
            if not (sid.isdigit() and (sid == "0" or sid[0] != "0")):
                return False
            return 0 <= int(sid) < implicit
        return vector_id in self._id_to_row

    def _materialize(self) -> None:
        """Expand implicit contiguous ids into the dict tables (one-time, on
        the first targeted mutation after a bulk build).  Guarded by its own
        mutex with ``_contig`` cleared LAST, since callers may hold only the
        read side of the store lock."""
        if not self._contig and not self._perm_count:
            return
        with self._mat_lock:
            if self._perm_count and self._spilled:
                raise ValueError(
                    "store was built with spill_mult (multi-assigned rows): "
                    "targeted mutations are not supported on spilled "
                    "layouts; rebuild without spill for mutable use")
            if self._perm_count:
                # streaming-built store: one perm readback (slot -> original
                # row), then id tables keyed by original row, valued by slot
                perm = self._perm_dev.cpu().numpy()
                slots = np.where(perm >= 0)[0]
                sids = perm[slots].astype(str)
                self._id_to_row = dict(zip(sids.tolist(), slots.tolist()))
                self._row_to_id = dict(zip(slots.tolist(), sids.tolist()))
                if self._ids_np is None or len(self._ids_np) < self._capacity:
                    self._ids_np = np.full((self._capacity,), None, object)
                self._ids_np[slots] = sids.astype(object)
                self._perm_count = 0   # publish: tables complete
                self._perm_dev = None  # dispatch stops perm-mapping rows
                return
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
        dev = self.device
        if self.dtype == "int4r":
            # cell-residual stores start with zero cells; capacity grows by
            # appending cells as inserts arrive (_place_in_cells)
            self._cell_cap = self._cell_cap or 128
            self._capacity = 0
            self._vectors = torch.zeros((0, width // 2), dtype=torch.uint8,
                                        device=dev)
            self._scales = torch.ones((0,), dtype=torch.float32, device=dev)
            self._norms = torch.zeros((0,), dtype=torch.float32, device=dev)
            self._valid = torch.zeros((0,), dtype=torch.bool, device=dev)
            self._centroids = torch.zeros((0, width), dtype=torch.float32,
                                          device=dev)
            self._cell_next = np.zeros((0,), np.int64)
            self._cell_avail = np.zeros((0,), np.int64)
            if self._ids_np is None:
                self._ids_np = np.full((0,), None, object)
            return
        cap = MIN_CAPACITY
        self._capacity = cap
        if self.dtype == "int4":
            self._vectors = torch.zeros((cap, width // 2), dtype=torch.uint8,
                                        device=dev)
            self._scales = torch.ones((cap,), dtype=torch.float32, device=dev)
        elif self.dtype == "int8":
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
        self._pad_capacity(new_cap)

    def _pad_capacity(self, new_cap: int) -> None:
        self._vectors = _pad_rows(self._vectors, new_cap)
        if self._codes_unit is not None:
            self._codes_unit = _pad_rows(self._codes_unit, new_cap)
        if self._scales is not None:
            self._scales = _pad_rows(self._scales, new_cap, 1.0)
        self._norms = _pad_rows(self._norms, new_cap)
        self._valid = _pad_rows(self._valid, new_cap, False)
        if self._rq_codes is not None:
            self._rq_codes = _pad_rows(self._rq_codes, new_cap)
        if self._ids_np is not None:
            grown = np.full((new_cap,), None, object)
            grown[: self._capacity] = self._ids_np
            self._ids_np = grown
        for k, col in self._tag_cols.items():
            newcol = np.zeros(new_cap, np.int32)
            newcol[: self._capacity] = col
            self._tag_cols[k] = newcol
        self._capacity = new_cap
        # array shapes changed: the delta chain no longer applies cleanly
        self._touched_reliable = False

    # ------------------------------------------------- int4r cell machinery

    def _take_slot(self, cell: int) -> int:
        free = self._cell_free.get(cell)
        if free:
            row = free.pop()
            if not free:
                self._cell_free.pop(cell, None)
        else:
            row = cell * self._cell_cap + int(self._cell_next[cell])
            self._cell_next[cell] += 1
        self._cell_avail[cell] -= 1
        return row

    def _append_cells(self, new_cents: np.ndarray) -> int:
        """Append real cells (padded to a CELL_BLOCK multiple with blocked
        dummy cells so capacity stays scan-tile-aligned).  Returns the index
        of the first new real cell."""
        k_old = int(self._cell_next.shape[0])
        a_real = new_cents.shape[0]
        a_total = -(-(k_old + a_real) // self.CELL_BLOCK) * self.CELL_BLOCK - k_old
        cents_pad = np.zeros((a_total, self._centroids.shape[1]), np.float32)
        cents_pad[:a_real] = new_cents
        self._centroids = torch.cat([self._centroids, self._put(cents_pad)])
        next_pad = np.zeros((a_total,), np.int64)
        next_pad[a_real:] = self._cell_cap  # blocked padding cells: full
        avail_pad = np.full((a_total,), self._cell_cap, np.int64)
        avail_pad[a_real:] = 0
        self._cell_next = np.concatenate([self._cell_next, next_pad])
        self._cell_avail = np.concatenate([self._cell_avail, avail_pad])
        self._pad_capacity(self._capacity + a_total * self._cell_cap)
        return k_old

    def _place_in_cells(self, vecs: np.ndarray) -> np.ndarray:
        """Assign fresh vectors to cells: nearest cell with space (top-J
        preference walk), overflow spawning new cells trained on the
        overflow itself.  Returns target rows."""
        from erlvectordb_tpu_torch.core.ivf import _top_choices

        m = vecs.shape[0]
        rows = np.empty(m, np.int64)
        unplaced = list(range(m))
        k_cur = int(self._cell_next.shape[0])
        width = self._centroids.shape[1]
        if k_cur and int(self._cell_avail.sum()) > 0:
            j = min(8, k_cur)
            vp = np.zeros((m, width), np.float32)
            vp[:, : vecs.shape[1]] = vecs
            _, choices = _top_choices(self._put(vp), self._centroids, j=j)
            choices = choices.cpu().numpy()
            still = []
            for i in unplaced:
                for jj in range(j):
                    c = int(choices[i, jj])
                    if self._cell_avail[c] > 0:
                        rows[i] = self._take_slot(c)
                        break
                else:
                    still.append(i)
            unplaced = still
        if unplaced:
            ovp = np.zeros((len(unplaced), width), np.float32)
            ovp[:, : vecs.shape[1]] = vecs[unplaced]
            # target half-full new cells so neighbours of these rows have room
            k_new = max(1, -(-len(unplaced) // max(1, self._cell_cap // 2)))
            if k_new == 1 or len(unplaced) <= 2:
                cents = ovp[:1]
            else:
                from erlvectordb_tpu_torch.ops.kmeans import kmeans_fit

                cj, _ = kmeans_fit(self._put(ovp), 7, k=k_new, iters=5)
                cents = cj.cpu().numpy()
            first = self._append_cells(cents)
            # nearest NEW cell with space (small set: host loop)
            d2 = ((ovp[:, None, :] - cents[None, :, :]) ** 2).sum(-1)
            pref = np.argsort(d2, axis=1)
            for i_local, i in enumerate(unplaced):
                for c_local in pref[i_local]:
                    c = first + int(c_local)
                    if self._cell_avail[c] > 0:
                        rows[i] = self._take_slot(c)
                        break
                else:  # every new cell full: spawn a singleton cell
                    rows[i] = self._take_slot(
                        self._append_cells(ovp[i_local:i_local + 1]))
        return rows

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
                and self.dtype != "int4r"  # rows place by cell, not append
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
                if self.dtype == "int4r":
                    rows[:] = self._place_int4r(ids, arr)
                else:
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
            if self.dtype == "int4r":
                cents_rows = self._centroids[self._put(rows // self._cell_cap)]
                _scatter_insert_int4r(self._vectors, self._scales, self._norms,
                                      self._valid, rows_t, vecs_t, cents_rows)
                self._code_norm_max = None  # realized bound may have grown
                if self._rq_codes is not None:
                    # stage-2 encode of the freshly written rows; their
                    # stored norms become full-reconstruction norms
                    c2, nrm = _rq_encode_chunk(
                        self._vectors[rows_t], self._scales[rows_t],
                        cents_rows, vecs_t, self._rq_rot, self._rq_books,
                        d=self._dim, dp2=self._rq_rot.shape[0])
                    self._rq_codes.index_copy_(0, rows_t, c2)
                    self._norms.index_copy_(0, rows_t, nrm)
            elif self.dtype == "int4":
                _scatter_insert_int4(self._vectors, self._scales, self._norms,
                                     self._valid, rows_t, vecs_t)
            elif self.dtype == "int8":
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
                            # the saved plane no longer matches: full base
                            self._touched_reliable = False
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
            self._touched_rows.update(row_list)
            self.version += 1
            self.dirty = True

    def _place_int4r(self, ids, arr) -> np.ndarray:
        """Target rows of an int4r insert batch.  Overwrites RE-PLACE: the
        residual of a new vector against the old cell's centroid can be
        whole-vector sized, so the old slot is freed and the row placed
        afresh; freed slots this batch does not reuse become invalid."""
        stale = []
        for vid in map(str, ids):
            old = self._id_to_row.get(vid)
            if old is not None:
                stale.append(old)
                cell = old // self._cell_cap
                self._cell_free.setdefault(cell, []).append(old)
                self._cell_avail[cell] += 1
                del self._id_to_row[vid]
                del self._row_to_id[old]
                self._ids_np[old] = None
                for col in self._tag_cols.values():
                    col[old] = 0
        rows = self._place_in_cells(arr)
        self._churn_inserts += len(ids)
        if stale:
            taken = set(rows.tolist())
            dead = [r for r in stale if r not in taken]
            if dead:
                _scatter_delete(self._valid,
                                self._put(np.asarray(dead, np.int64)))
                self._touched_rows.update(dead)
        return rows

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
                if self.dtype == "int4r":
                    cell = row // self._cell_cap
                    self._cell_free.setdefault(cell, []).append(row)
                    self._cell_avail[cell] += 1
                    self._churn_deletes += 1
                else:
                    self._free_rows.append(row)
                self._ids_np[row] = None
            for col in self._tag_cols.values():
                col[rows] = 0
            self._touched_rows.update(rows)
            self.version += 1
            self.dirty = True
            return len(rows)

    # ---------------------------------------------------------------- search

    def calibrate_nprobe(self, queries=None, n_sample: int = 256,
                         k: int = 10, metric: Optional[str] = None,
                         ground_truth=None) -> dict:
        """Measure the multiprobe recall@k curve so searches can take a
        ``recall_target=`` instead of a raw ``nprobe=`` (int4r stores).

        With ``ground_truth`` ([S, >=k] exact store rows for ``queries``,
        computed on the original f32 data with
        calibration.exact_ground_truth) the curve is in exact mode: values
        are absolute recall@k, the deep probe's value is the quantization
        ceiling, and recall_target refuses targets above it
        (RecallUnachievable).  Otherwise it is in ceiling mode, against the
        store's own deep probe (nprobe = min(n_cells, 512)).  ``queries``
        defaults to ``n_sample`` live rows decoded from the codes.  Curves
        are keyed by (k, metric) and travel with export_state."""
        if self.dtype != "int4r":
            raise ValueError("calibrate_nprobe requires an int4r store")
        if self.count == 0:
            raise ValueError("empty store")
        metric = metric or self.metric
        if queries is None:
            if ground_truth is not None:
                raise ValueError("ground_truth requires explicit queries")
            with self._lock.read():
                rows = np.flatnonzero(self._valid.cpu().numpy())
                rng = np.random.default_rng(len(rows))
                rows = rng.choice(rows, size=min(n_sample, len(rows)),
                                  replace=False)
                r = self._put(rows)
                res = (ft.unpack_int4(self._vectors[r]).float()
                       * self._scales[r][:, None])
                queries = (self._centroids[r // self._cell_cap]
                           + res)[:, : self._dim].cpu().numpy()
        queries = np.asarray(queries, np.float32)
        deep = min(int(self._centroids.shape[0]), 512)

        if ground_truth is None:
            # ceiling mode compares the layout against itself: internal
            # cell-slot rows are a consistent space on both sides
            def search_rows(qs, kk, nprobe):
                t = self.search_batch_submit(qs, k=kk, metric=metric,
                                             nprobe=nprobe)
                return self.search_batch_complete_raw(t)[1]
        else:
            # exact mode compares against original-row positions, which are
            # the implicit ids of bulk-built stores ("0".."n-1"): map the
            # results through their ids
            def search_rows(qs, kk, nprobe):
                t = self.search_batch_submit(qs, k=kk, metric=metric,
                                             nprobe=nprobe)
                dists_p, _rows_p, ids_p = self.search_batch_complete_raw(t)
                out = np.full((len(qs), kk), -1, np.int64)
                if ids_p is None:
                    return out
                for i, row in enumerate(ids_p.tolist()):
                    for j, vid in enumerate(row):
                        if vid is None or not np.isfinite(dists_p[i, j]):
                            continue
                        try:
                            out[i, j] = int(vid)
                        except ValueError as e:
                            raise ValueError(
                                "exact-mode calibration compares ground-"
                                "truth positions against implicit integer "
                                "ids; this store has custom string ids — "
                                "map your ground truth to ids and "
                                "calibrate through the index surface "
                                "instead") from e
                return out

        curve = measure_curve(search_rows, queries, k=k, metric=metric,
                              deep=deep,
                              ground_truth=ground_truth)
        self._calib.put(curve)
        return dict(curve.curve)

    def _nprobe_for_target(self, target: float, k: int,
                           metric: Optional[str] = None) -> int:
        """Smallest calibrated nprobe meeting ``target`` under the curve's
        mode; lazily self-calibrates (ceiling mode) per (k, metric)."""
        if not (0.0 < target <= 1.0):
            raise ValueError("recall_target must be in (0, 1]")
        metric = metric or self.metric

        def compute():
            self.calibrate_nprobe(k=k, metric=metric)
            return self._calib.get(k, metric)

        cur = self._calib.get(k, metric)
        if cur is None:
            cur = self._calib.get_or_compute(k, metric, compute)
        return cur.nprobe_for(target)

    def search(self, query, k: int = 10, metric: Optional[str] = None,
               where: Optional[dict] = None, nprobe: Optional[int] = None,
               recall_target: Optional[float] = None,
               ) -> List[Tuple[str, Any, float]]:
        """Top-k search for one query; ``[(id, metadata, distance)]``
        ascending by distance.  ``where`` restricts results to vectors whose
        metadata matches every key/value equality predicate.  Above ~590k
        rows with k <= 16 on a CUDA device the key/pos scans keep the top-1
        of each 1024-row slice (see ops/fused_topk.py); ``EVDB_EXACT_SCAN=1``
        forces (near-)exact masked extraction.  ``nprobe`` (int4r stores)
        switches to the sub-linear multiprobe search: only the ``nprobe``
        nearest cells are read."""
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
        metric = metric or self.metric
        if metric not in VALID_METRICS:
            raise ValueError(f"metric must be one of {VALID_METRICS}, got {metric!r}")
        if recall_target is not None:
            # map a recall target to the smallest calibrated nprobe under
            # the curve's mode (exact curves guarantee absolute recall,
            # ceiling curves are relative to the store's own deep probe)
            if nprobe is not None:
                raise ValueError(
                    "pass either nprobe or recall_target, not both")
            if self.dtype != "int4r":
                raise ValueError(
                    "recall_target requires an int4r store (cell layout)")
            nprobe = self._nprobe_for_target(recall_target, k, metric)
        if nprobe is not None:
            if self.dtype != "int4r":
                raise ValueError(
                    "nprobe requires an int4r store (cell-resident layout)")
            if metric == "manhattan":
                raise ValueError("nprobe does not support metric 'manhattan'")
            if nprobe <= 0:
                raise ValueError("nprobe must be positive")
        t0 = time.perf_counter()
        q = self._validate_batch(queries)
        fmask = self._device_filter_mask(where) if where else None
        # read side of the store lock: searches run concurrently, but never
        # against tensors an insert is updating in place
        with self._lock.read():
            t = self._dispatch_locked(q, k, metric, fmask, nprobe=nprobe)
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
            return self._map_results(dists_np, rows_np, t.k, t.kb,
                                     rows_are_orig=t.rows_are_orig,
                                     dedup=self._spilled)

    def search_batch_complete_raw(self, t: SearchTicket):
        """Columnar completion: (distances [nq, kk] f32, rows [nq, kk] int32,
        ids [nq, kk] object-or-None), no per-hit tuples."""
        if t.kb == 0:
            return (np.zeros((t.nq, 0), np.float32),
                    np.zeros((t.nq, 0), np.int32), None)
        kk = min(2 * t.k if self._spilled else t.k, t.kb)
        dists_np, rows_np = self._readback(t)
        dists_np = dists_np[:, :kk]
        rows_np = rows_np[:, :kk]
        if self._spilled:
            from erlvectordb_tpu_torch.ops.cell_probe import dedup_rows_topk

            dists_np, rows_np = dedup_rows_topk(dists_np, rows_np, t.k)
        if t.rows_are_orig:
            # streaming-built store: rows already ARE the implicit ids
            return dists_np, rows_np, _implicit_ids(rows_np)
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

    def _map_results(self, dists_np, rows_np, k, kb, rows_are_orig=False,
                     dedup=False):
        """Vectorized row->id mapping: one fancy-index into the columnar id
        table + tolist().  ``dedup`` (spilled layouts) scans the over-fetched
        columns, keeps each id's first (best) hit and caps output at k."""
        kk = min(2 * k if dedup else k, kb)
        if rows_are_orig:
            ids_l = _implicit_ids(rows_np[:, :kk]).tolist()
        else:
            ids_l = self._ids_view()[rows_np[:, :kk]].tolist()
        d_l = dists_np[:, :kk].tolist()
        md = self._metadata
        isfinite = math.isfinite
        out: List[List[Tuple[str, Any, float]]] = []
        for irow, drow in zip(ids_l, d_l):
            hits = []
            seen = set() if dedup else None
            for vid, d in zip(irow, drow):
                if not isfinite(d):
                    break  # ran past the valid rows
                if vid is None:
                    continue  # row deleted between device scan and host map
                if dedup:
                    if vid in seen or len(hits) >= k:
                        continue
                    seen.add(vid)
                hits.append((vid, md.get(vid, {}), d))
            out.append(hits)
        return out

    def _dispatch_locked(self, q, k, metric, fmask=None,
                         nprobe=None) -> SearchTicket:
        nq = q.shape[0]
        if self._vectors is None or self.count == 0 or k <= 0:
            return SearchTicket(None, nq, k, 0)
        # spilled layouts: over-fetch 2k so per-query dedup still fills k
        k_fetch = min(2 * k, self.count) if self._spilled else k
        kb = search_mod.k_bucket(min(k_fetch, self.count), self._capacity)
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

        if self.dtype == "int4r":
            return self._dispatch_int4r(q_t, valid, nq, k, kb, metric, nprobe)
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
                self._scales if self.dtype in ("int8", "int4") else None,
                self._norms, valid, q_t, metric=metric, k=kb, n_tiles=nt,
                codes_unit=cu, plane_scale=ps)
        elif self.dtype == "int8":
            dists, rows = search_mod.exact_topk_int8(
                self._vectors, self._scales, self._norms, valid, q_t,
                metric=metric, k=kb)
        elif self.dtype == "int4":
            dists, rows = search_mod.exact_topk_int4(
                self._vectors, self._scales, self._norms, valid, q_t,
                metric=metric, k=kb)
        else:
            dists, rows = search_mod.exact_topk(
                self._vectors, self._norms, valid, q_t, metric=metric, k=kb)
        return self._finish_ticket(dists, rows, nq, k)

    def _dispatch_int4r(self, q_t, valid, nq, k, kb, metric,
                        nprobe=None) -> SearchTicket:
        """int4r search: with ``nprobe`` the sub-linear multiprobe search
        over the store's own cell layout (B7 on a CUDA device); else the
        residual scans (B5 at >= POS_MIN_TILES tiles, B6 below) on a CUDA
        device, the exact scan otherwise.  Rows of a streaming-built store
        are mapped slot -> original row on the device."""
        if nprobe is not None:
            from erlvectordb_tpu_torch.ops.cell_probe import multiprobe_topk

            if self._cents_rt_src is not self._centroids:
                # persistent bf16 routing copy + |c|^2 buffer (recomputing
                # either per dispatch re-reads the full f32 centroid table)
                self._cents_rt = self._centroids.to(torch.bfloat16)
                self._cents_cn2 = torch.sum(
                    self._centroids * self._centroids, dim=-1)
                self._cents_rt_src = self._centroids
            rq_kw = {}
            if self._rq_codes is not None:
                # stage-2 pooled rescore: inner-product tables of the
                # rotated (zero-padded to the rq dim) queries
                from erlvectordb_tpu_torch.quant.pq import _adc_ip_tables

                dp2 = self._rq_rot.shape[0]
                qe = q_t[:, : self._dim]
                if dp2 > self._dim:
                    qe = torch.nn.functional.pad(qe, (0, dp2 - self._dim))
                with ft.full_f32_matmul():
                    qr = qe @ self._rq_rot
                rq_kw = dict(rq_codes=self._rq_codes,
                             rq_lut=_adc_ip_tables(qr, self._rq_books),
                             rq_pool=max(4 * kb, self.rq_pool))
            dists, rows = multiprobe_topk(
                self._vectors, self._scales, self._norms, valid,
                self._centroids, q_t, metric=metric, k=kb,
                nprobe=min(nprobe, max(1, self._centroids.shape[0])),
                cell_cap=self._cell_cap, centroids_route=self._cents_rt,
                cn2=self._cents_cn2, **rq_kw)
        elif ft.residual_scan_applies(self._capacity, self._cell_cap, metric,
                                      self.device, kb):
            if self._code_norm_max is None:
                self._code_norm_max = ft.max_code_norm(self._vectors)
            dists, rows = ft.fused_topk_residual(
                self._vectors, self._scales, self._norms, valid,
                self._centroids, q_t, metric=metric, k=kb,
                n_tiles=ft.n_tiles_for(self._capacity, self._capacity),
                cell_cap=self._cell_cap, code_norm_bound=self._code_norm_max,
                slice_w=ft.POS_RES_W, t_top=ft.POS_RES_T)
        else:
            dists, rows = search_mod.exact_topk_int4r(
                self._vectors, self._scales, self._norms, valid,
                self._centroids, q_t, metric=metric, k=kb,
                cell_cap=self._cell_cap)
        if self._perm_dev is not None:
            rows = self._perm_dev[torch.clamp(rows.long(), 0,
                                              self._perm_dev.shape[0] - 1)]
            return self._finish_ticket(dists, rows, nq, k, rows_are_orig=True)
        return self._finish_ticket(dists, rows, nq, k)

    def _ensure_unit_plane(self):
        """The intkey key plane (unit for cosine stores, magnitude for
        euclidean/dot), derived from the absmax plane when missing.
        Idempotent cache fill, safe under the read lock.  A plane derived
        here differs from the one a snapshot holds, so the next sync writes
        a full base."""
        if self._vectors is None:
            return None
        if (self._codes_unit is None
                or self._codes_unit.shape[0] != self._capacity):
            self._touched_reliable = False
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

    def _finish_ticket(self, dists, rows, nq, k, rows_are_orig=False):
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
                            event=event, rows_are_orig=rows_are_orig)

    # ------------------------------------------------------------- accessors

    def get(self, vector_id: str) -> Optional[Tuple[np.ndarray, Any]]:
        """Fetch one vector and its metadata (dequantized for int8 stores)."""
        with self._lock.read():
            self._materialize()
            row = self._id_to_row.get(str(vector_id))
            if row is None:
                return None
            vec = self._vectors[row].cpu().numpy()
            if self.dtype in ("int4", "int4r"):
                vec = _unpack_int4_np(vec[None, :])[0]
            vec = vec[: self._dim]
            if self.dtype != "float32":
                vec = vec.astype(np.float32) * float(self._scales[row])
            if self.dtype == "int4r":
                cent = self._centroids[row // self._cell_cap].cpu().numpy()
                vec = vec + cent[: self._dim]
            return vec, self._metadata.get(str(vector_id), {})

    def get_all_vectors(self) -> List[Tuple[str, np.ndarray, Any]]:
        """All live (id, vector, metadata) — migration/backup path."""
        with self._lock.read():
            self._materialize()
            if self.count == 0:
                return []
            rows = sorted(self._row_to_id)
            mat = self._vectors.cpu().numpy()  # one transfer
            if self.dtype in ("int4", "int4r"):
                mat = _unpack_int4_np(mat)
            scales = (self._scales.cpu().numpy() if self.dtype != "float32"
                      else None)
            cents = (self._centroids.cpu().numpy() if self.dtype == "int4r"
                     else None)
            out = []
            for row in rows:
                vid = self._row_to_id[row]
                vec = mat[row][: self._dim]
                if scales is not None:
                    vec = vec.astype(np.float32) * scales[row]
                if cents is not None:
                    vec = vec + cents[row // self._cell_cap][: self._dim]
                out.append((vid, vec, self._metadata.get(vid, {})))
            return out

    def live_matrix(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows [n] ascending, vectors [n, dim] f32) of every live row: the
        order and values of get_all_vectors, gathered on the device (the
        index builds' input)."""
        with self._lock.read():
            if self._contig:
                rows = np.arange(self._contig, dtype=np.int64)
            else:
                self._materialize()
                rows = np.fromiter(sorted(self._row_to_id), np.int64,
                                   len(self._row_to_id))
            if rows.size == 0:
                return rows, np.zeros((0, self._dim or 0), np.float32)
            r = self._put(rows)
            vec = self._vectors[r]
            if self.dtype in ("int4", "int4r"):
                vec = ft.unpack_int4(vec)
            vec = vec[:, : self._dim]
            if self.dtype != "float32":
                vec = vec.float() * self._scales[r][:, None]
            if self.dtype == "int4r":
                vec = vec + self._centroids[r // self._cell_cap][:, : self._dim]
            return rows, vec.cpu().numpy()

    def _rid(self, row: int) -> Optional[str]:
        """Row -> id, without materializing implicit contiguous ids."""
        if self._contig:
            return str(row) if 0 <= row < self._contig else None
        return self._row_to_id.get(row)

    def get_stats(self) -> dict:
        """Stats shape parity with reference get_stats."""
        stats = {
            "name": self.name,
            "count": self.count,
            "dimension": self._dim,
            "metric": self.metric,
            "dtype": self.dtype,
            "capacity": self._capacity,
            "version": self.version,
            "memory_bytes": self.device_memory_bytes(),
        }
        if self._calib:
            # which guarantee recall_target gives on this store: exact
            # (absolute, ceiling enforced) vs ceiling (deep-probe-relative)
            stats["calibration"] = self._calib.summaries()
        return stats

    def device_memory_bytes(self) -> int:
        if self._vectors is None:
            return 0
        total = self._vectors.numel() * self._vectors.element_size()
        total += self._norms.numel() * 4 + self._valid.numel()
        if self._codes_unit is not None:
            total += self._codes_unit.numel()
        if self._scales is not None:
            total += self._scales.numel() * 4
        if self._centroids is not None:
            total += self._centroids.numel() * 4
        if self._rq_codes is not None:
            total += self._rq_codes.numel()
            total += self._rq_books.numel() * 4 + self._rq_rot.numel() * 4
        return int(total)

    # ----------------------------------------------------- state export/import

    def export_state(self) -> dict:
        """Host-side state (numpy arrays), in the JAX package's format 1."""
        with self._lock.read():
            if not (self._spilled and self._perm_count):
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
                if (self._codes_unit is not None
                        and self._codes_unit.shape[0] == self._capacity):
                    # the key plane as built (from the f32 rows): a plane
                    # re-derived from the absmax codes keys some rows one
                    # step apart, so a restore keeps this one
                    state["codes_unit"] = self._codes_unit.cpu().numpy()
                    state["plane_scale"] = self._plane_scale
            if self.dtype == "int4r" and self._centroids is not None:
                state["centroids"] = self._centroids.cpu().numpy()
                state["cell_cap"] = self._cell_cap
                if self._calib:
                    state["calibrations"] = self._calib.to_json()
                    self._calib.mark_clean()
                state["cell_next"] = [int(x) for x in self._cell_next]
                state["cell_free"] = {
                    str(c): list(v) for c, v in self._cell_free.items()}
                if self._rq_codes is not None:
                    state["rq_m"] = self._rq_m
                    state["rq_codes"] = self._rq_codes.cpu().numpy()
                    state["rq_books"] = self._rq_books.cpu().numpy()
                    state["rq_rot"] = self._rq_rot.cpu().numpy()
            if self._spilled and self._perm_count:
                # spilled streaming layout: ids stay implicit (mutations are
                # refused anyway), so the slot -> row map travels instead
                state["perm"] = self._perm_dev.cpu().numpy()
                state["perm_count"] = self._perm_count
                state["spilled"] = True
            return state

    @classmethod
    def from_state(cls, state: dict, device: Optional[torch.device] = None
                   ) -> "VectorStore":
        """A store from an exported state dict — this package's or the JAX
        package's ``VectorStore.export_state()`` (numpy arrays).  An intkey
        store takes the key plane the state carries (``codes_unit``, which
        this package writes and the JAX package ignores), else re-derives
        it from the absmax plane."""
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
        if store.dtype == "int4r" and "centroids" in state:
            store._centroids = store._put(
                np.asarray(state["centroids"], np.float32))
            store._cell_cap = int(state.get("cell_cap", 64))
            if "calibrations" in state:
                store._calib = CalibrationSet.from_json(state["calibrations"])
            elif "nprobe_curve" in state:  # older un-keyed curve
                store._calib = CalibrationSet.from_legacy(
                    {int(p): float(r)
                     for p, r in state["nprobe_curve"].items()},
                    metric=state.get("metric", "cosine"))
            store._cell_next = np.asarray(state.get("cell_next", []), np.int64)
            store._cell_free = {
                int(c): [int(r) for r in v]
                for c, v in (state.get("cell_free") or {}).items()}
            if "rq_codes" in state:
                store._rq_m = int(state.get("rq_m", 0))
                store._rq_codes = store._put(
                    np.asarray(state["rq_codes"], np.uint8))
                store._rq_books = store._put(
                    np.asarray(state["rq_books"], np.float32))
                store._rq_rot = store._put(
                    np.asarray(state["rq_rot"], np.float32))
            store._cell_avail = (
                store._cell_cap - store._cell_next
                + np.array([len(store._cell_free.get(c, []))
                            for c in range(len(store._cell_next))], np.int64))
        if state.get("spilled") and "perm" in state:
            store._perm_dev = store._put(np.asarray(state["perm"], np.int32))
            store._perm_count = int(state["perm_count"])
            store._spilled = True
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
            plane = state.get("codes_unit")
            if plane is not None and plane.shape[0] == store._capacity:
                store._codes_unit = store._put(np.asarray(plane, np.int8))
                store._plane_scale = state.get("plane_scale")
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

    # ------------------------------------------------------- cell refit/drift

    def drift(self) -> dict:
        """Cell-layout drift since the last bulk build/refit (int4r):
        ``fraction`` is (inserts + deletes) / built rows, the knob
        ``is_stale`` thresholds on; ``overflow_cells`` counts cells spawned
        after the build (insert overflow)."""
        cells_now = (int(self._cell_next.shape[0])
                     if self._cell_next is not None else 0)
        churn = self._churn_inserts + self._churn_deletes
        return {
            "built_rows": self._built_rows,
            "inserts_since_build": self._churn_inserts,
            "deletes_since_build": self._churn_deletes,
            "overflow_cells": max(0, cells_now - self._cells_at_build),
            "fraction": churn / max(self._built_rows, 1),
        }

    def is_stale(self, threshold: float = 0.25) -> bool:
        """True when cell-layout churn exceeds ``threshold`` of the built
        corpus — the refit trigger."""
        if self.dtype != "int4r" or not self._built_rows:
            return False
        return self.drift()["fraction"] > threshold

    def rebuild_cells(self) -> dict:
        """Refit the cell layout in place: dequantize the live corpus, re-run
        the bulk residual build (fresh k-means + balanced assignment +
        encode), keep ids and metadata.  The refit sees only the store's
        quantized codes, so each refit re-quantizes reconstructions.
        Returns the post-refit drift dict (zeroed counters)."""
        if self.dtype != "int4r":
            raise ValueError("rebuild_cells applies to int4r stores only")
        with self._lock.write():
            self._materialize()
            if not self._id_to_row:
                return self.drift()
            ids, rows = zip(*sorted(self._id_to_row.items(),
                                    key=lambda kv: kv[1]))
            rows_t = self._put(np.asarray(rows, np.int64))
            q = ft.unpack_int4(self._vectors[rows_t]).float()
            vecs = (self._centroids[rows_t // self._cell_cap]
                    + q * self._scales[rows_t][:, None])
            vecs = vecs[:, : self._dim]
            if self._rq_codes is not None:
                # rebuild from the FULL reconstruction: the stage-2 error
                # term carries about half the row's precision
                from erlvectordb_tpu_torch.quant.pq import _decode

                with ft.full_f32_matmul():
                    dec = (_decode(self._rq_codes[rows_t], self._rq_books)
                           @ self._rq_rot.T)
                vecs = vecs + dec[:, : self._dim]
            self._build_int4r(vecs.cpu().numpy(), list(ids), rq_m=self._rq_m)
            self._tag_cols = {}
            self._dmask_cache = {}
            self._touched_rows = set()
            self.version += 1
            self.dirty = True
            self._touched_reliable = False
            return self.drift()

    # ------------------------------------------------------------ bulk build

    def _fit_rq(self, x: np.ndarray, perm: np.ndarray, rq_m: int) -> None:
        """Fit and encode the second-stage residual quantizer (``rq_m``):
        OPQ (rotation + product codebooks, 256 centroids a subspace) over
        the int4 reconstruction error of up to 131,072 sampled slots, then
        every live slot encoded; stored norms become full-reconstruction
        norms.  ``perm`` [capacity] maps slot -> row of ``x`` (-1: empty).
        Needs the original rows, so it runs on the from_matrix path."""
        from erlvectordb_tpu_torch.quant.opq import OPQCodebook

        d = self._dim
        dp2 = -(-d // rq_m) * rq_m
        perm = np.asarray(perm)
        cap = self._cell_cap

        # ---- sample the error field and fit the codebooks ---------------
        valid_slots = np.where(perm >= 0)[0]
        step = max(1, len(valid_slots) // 131072)
        samp = valid_slots[::step][:131072]
        sl = self._put(samp)
        q1 = ft.unpack_int4(self._vectors[sl]).float()
        recon_s = self._centroids[sl // cap] + q1 * self._scales[sl][:, None]
        err_s = self._put(x[perm[samp]])[:, :d] - recon_s[:, :d]
        if dp2 > d:
            err_s = torch.nn.functional.pad(err_s, (0, dp2 - d))
        cb = OPQCodebook.fit(err_s, m=rq_m, k=256, iters=10, opq_iters=3,
                             seed=0, max_train=131072)
        rot, books = cb.rotation, cb.pq.codebooks

        # ---- encode every live slot; norms -> full-reconstruction norms --
        codes2 = torch.zeros((self._capacity, rq_m), dtype=torch.uint8,
                             device=self.device)
        ch = 262_144
        for lo in range(0, self._capacity, ch):
            hi = min(lo + ch, self._capacity)
            live = np.where(perm[lo:hi] >= 0)[0] + lo
            if live.size == 0:
                continue
            lt = self._put(live)
            c2, nrm = _rq_encode_chunk(
                self._vectors[lt], self._scales[lt],
                self._centroids[lt // cap], self._put(x[perm[live]]), rot,
                books, d=d, dp2=dp2)
            codes2[lt] = c2
            self._norms[lt] = nrm
        self._rq_m = rq_m
        self._rq_codes = codes2
        self._rq_books = books
        self._rq_rot = rot

    def _build_int4r(self, matrix, ids: Optional[Sequence[str]],
                     rq_m: int = 0) -> None:
        """Bulk cell-residual build: k-means cells (~96 rows each), balanced
        capacity-128 assignment with two capacity-constrained Lloyd
        refinements, residual int4 quantization.  From 200k rows the
        device-side streaming engine builds instead (ops/cell_build.py)."""
        from erlvectordb_tpu_torch.core.ivf import _balanced_assign
        from erlvectordb_tpu_torch.ops.kmeans import kmeans_fit

        x = np.asarray(matrix, np.float32)
        n, d = x.shape
        self._rq_m, self._rq_codes = 0, None
        self._rq_books = self._rq_rot = None
        if n >= 200_000:
            self._build_int4r_device(x, ids, rq_m=rq_m)
            return
        width = _pad128(d)
        xp = x if width == d else np.pad(x, ((0, 0), (0, width - d)))
        cap_c = 128
        k_real = max(1, -(-n // 96))  # 75% occupancy of cap-128 cells
        k_total = -(-k_real // self.CELL_BLOCK) * self.CELL_BLOCK
        # the initial k-means only SEEDS the cells (the capacity-constrained
        # refit rounds below run full-data Lloyd steps)
        if n > 300_000:
            sel = np.random.default_rng(0).choice(n, 300_000, replace=False)
            train = xp[sel]
        else:
            train = xp
        cents_t, _ = kmeans_fit(self._put(train), 0, k=k_real, iters=10)
        cents_np = cents_t.cpu().numpy()
        owner = _balanced_assign(xp, cents_np, cap_c, j=16, device=self.device)
        # capacity-constrained Lloyd refinement: refit each centroid to the
        # members it actually got, then reassign
        xp_t = self._put(xp)
        for _ in range(2):
            owner_t = self._put(owner)
            sums = torch.zeros((k_real, width), dtype=torch.float32,
                               device=self.device).index_add_(0, owner_t, xp_t)
            cnt = torch.zeros((k_real,), dtype=torch.float32,
                              device=self.device).index_add_(
                0, owner_t, torch.ones((n,), dtype=torch.float32,
                                       device=self.device))
            cents_np = (sums / torch.clamp(cnt, min=1.0)[:, None]).cpu().numpy()
            owner = _balanced_assign(xp, cents_np, cap_c, j=16,
                                     device=self.device)
        order = np.argsort(owner, kind="stable")
        counts = np.bincount(owner, minlength=k_real)
        starts = np.zeros(k_real, np.int64)
        starts[1:] = np.cumsum(counts)[:-1]
        rank = np.empty(n, np.int64)
        rank[order] = np.arange(n) - starts[owner[order]]
        pos = owner * cap_c + rank

        n_rows = k_total * cap_c
        cents_rows = self._put(cents_np)[self._put(owner)]
        (self._vectors, self._scales, self._norms,
         self._valid) = _bulk_build_int4r(xp_t, cents_rows, self._put(pos),
                                          n_rows)
        del xp_t, cents_rows
        cents_pad = np.zeros((k_total, width), np.float32)
        cents_pad[:k_real] = cents_np
        cell_next = np.zeros(k_total, np.int64)
        cell_next[:k_real] = counts
        self._set_cells(self._put(cents_pad), cap_c, cell_next, k_real)
        sids = self._bulk_ids(ids, n)
        self._id_to_row = dict(zip(sids, pos.tolist()))
        self._row_to_id = dict(zip(pos.tolist(), sids))
        self._ids_np = np.full((n_rows,), None, object)
        self._ids_np[pos] = sids
        self._built_rows = n
        if rq_m:
            perm = np.full((n_rows,), -1, np.int64)
            perm[pos] = np.arange(n)
            self._fit_rq(x, perm, rq_m)

    def _set_cells(self, centroids, cell_cap, cell_next, k_real) -> None:
        """Adopt a freshly built cell layout (cells past ``k_real`` are
        blocked padding)."""
        self._centroids = centroids
        self._cell_cap = cell_cap
        self._capacity = centroids.shape[0] * cell_cap
        self._next_row = self._capacity
        cell_next = cell_next.copy()
        cell_next[k_real:] = cell_cap
        self._cell_next = cell_next
        self._cell_avail = np.where(np.arange(len(cell_next)) < k_real,
                                    cell_cap - cell_next, 0)
        self._cell_free = {}
        self._code_norm_max = None
        self._churn_inserts = self._churn_deletes = 0
        self._cells_at_build = k_real

    @staticmethod
    def _bulk_ids(ids, n) -> List[str]:
        sids = ([str(v) for v in ids] if ids is not None
                else [str(i) for i in range(n)])
        if ids is not None and len(sids) != n:
            raise ValueError("ids and matrix length mismatch")
        if len(set(sids)) != n:
            raise ValueError("duplicate ids in bulk build")
        return sids

    def _adopt_cell_build(self, res) -> None:
        self._vectors, self._scales = res.codes, res.scales
        self._norms, self._valid = res.norms, res.valid
        self._set_cells(res.centroids, res.cell_cap, res.counts,
                        res.stats["n_cells_real"])
        self.build_stats = res.stats

    def _build_int4r_device(self, x: np.ndarray,
                            ids: Optional[Sequence[str]],
                            rq_m: int = 0) -> None:
        """Bulk int4r build through the device streaming engine, with the
        from_matrix contract (explicit ids, materialized host tables).  The
        one O(N) readback is the slot permutation."""
        from erlvectordb_tpu_torch.ops.cell_build import build_cells_streaming

        n, d = x.shape
        ch = min(n, 262_144)
        res = build_cells_streaming(
            (x[i:i + ch] for i in range(0, n, ch)), n=n, dim=d, cell_rows=96,
            cell_cap=128, residual_bits=4, k_block=self.CELL_BLOCK,
            kmeans_init="random", kmeans_iters=6, refits=1,
            aniso_eta=4.0 if self.metric in ("cosine", "dot") else 1.0,
            device=self.device)
        self._adopt_cell_build(res)
        perm = res.perm.cpu().numpy()
        slots = np.where(perm >= 0)[0]
        sarr = np.asarray(self._bulk_ids(ids, n), object)[perm[slots]]
        self._id_to_row = dict(zip(sarr.tolist(), slots.tolist()))
        self._row_to_id = dict(zip(slots.tolist(), sarr.tolist()))
        self._ids_np = np.full((self._capacity,), None, object)
        self._ids_np[slots] = sarr
        self._built_rows = n
        if rq_m:
            self._fit_rq(x, perm, rq_m)

    @classmethod
    def from_chunks(cls, name: str, chunks, *, n: int, dim: int,
                    metric: str = "cosine",
                    device: Optional[torch.device] = None,
                    cell_rows: int = 96, cell_cap: int = 128,
                    **build_kw) -> "VectorStore":
        """Streaming int4r bulk build: consumes [CH, dim] f32 chunks (host
        arrays or tensors) through the device-side cell build engine
        (ops/cell_build.py) — centroids, balanced assignment, residual
        encode and the slot -> row permutation all stay on the device.

        Ids are implicit ("0".."n-1" by arrival order); the first targeted
        mutation (get/delete/insert) materializes host id tables from one
        perm readback.  Build stats land in ``store.build_stats``."""
        from erlvectordb_tpu_torch.ops.cell_build import build_cells_streaming

        store = cls(name, dim=dim, metric=metric, dtype="int4r", device=device)
        res = build_cells_streaming(
            chunks, n=n, dim=dim, cell_rows=cell_rows, cell_cap=cell_cap,
            residual_bits=4, k_block=cls.CELL_BLOCK, device=store.device,
            **build_kw)
        store._adopt_cell_build(res)
        store._perm_dev = res.perm
        store._perm_count = n
        store._spilled = res.stats.get("spilled_rows", 0) > 0
        store._ids_np = None   # allocated on materialization only
        store._built_rows = n
        store.version = 1
        store.dirty = True
        return store

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
        rq_m: int = 0,
    ) -> "VectorStore":
        """Bulk index build: one host->device transfer and a few tensor ops,
        no per-row host bookkeeping.  With ``ids=None`` row i gets the
        implicit id ``str(i)`` and the id tables stay virtual until the first
        targeted mutation.  ``matrix`` may be a numpy array or a tensor
        (already on the device, for corpora generated there).

        ``rq_m`` (int4r only): the second stage, OPQ error codes at rq_m
        bytes a row rescored in multiprobe searches (see _fit_rq); rq_m=9
        at 100-d keeps the store under half of int8's memory."""
        store = cls(name, metric=metric, dtype=dtype, device=device,
                    intkey=intkey)
        if rq_m and store.dtype != "int4r":
            raise ValueError("rq_m applies to int4r stores only")
        if store.dtype == "int4r":
            x = (matrix.detach().cpu().numpy() if isinstance(matrix, torch.Tensor)
                 else np.asarray(matrix, np.float32))
            store._dim = x.shape[1]
            store._build_int4r(x, ids, rq_m=rq_m)
            if metadatas is not None:
                if len(metadatas) != x.shape[0]:
                    raise ValueError("metadatas and matrix length mismatch")
                eff = ids if ids is not None else range(x.shape[0])
                store._metadata = {str(v): (m or {})
                                   for v, m in zip(eff, metadatas)}
            store.version = 1
            store.dirty = True
            return store
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
        elif store.dtype == "int4":
            (store._vectors, store._scales, store._norms,
             store._valid) = _bulk_build_int4(arr, cap)
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
        store.dirty = True
        return store
