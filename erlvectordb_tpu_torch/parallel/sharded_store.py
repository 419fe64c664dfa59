"""Row-sharded vector store over a device mesh — exact distributed search.

Counterpart of ``erlvectordb_tpu/parallel/sharded_store.py``.  One store's
rows are sharded across the mesh's ``data`` axis and every query is answered
exactly.  Where the JAX package runs one ``shard_map`` program, this store
loops over the shards, each on its own device:

    per shard:  the distance scan over its [cap, W] rows and a local top-k
                (the fused kernels on a CUDA device, the exact scans of
                core/search.py below their gate and on the CPU)
             -> rows offset to the global row ``shard * cap + local``
             -> the k candidates moved to the host at completion
    per group:  one stable top-k over the [B, S * kk] shard-major candidates
                (ties to the lower flat index, as ``lax.top_k``)

The query batch is split across the ``replica`` axis: replica group r scans
its slice of the batch over its own copies of the shards, so the replica
count multiplies query throughput.

Device layout: shard s keeps ``vectors [cap, W]`` (f32 rows or int8 codes),
``scales [cap]`` (int8), ``norms [cap]`` and ``valid [cap]`` on every
distinct device of its mesh column; replica groups whose devices coincide
(several shards of one card, or the logical CPU devices) share one copy, and
every mutation is applied to every copy.  Bulk store migration is
``from_store``/``to_store``.

Across processes (a mesh whose devices belong to several processes of one
group, parallel/mesh.py::init_distributed) the store is multi-controller,
as the JAX package's is: every process runs the same verbs with the same
arguments in the same order (bulk builds, ``insert_batch``, ``delete``,
``search_batch``, ``reshard_to``, ``export_state``, ``get``,
``get_all_vectors``) and keeps the host tables whole (ids, slots, metadata,
``next_local``, ``free``, the id table), so every process derives the same
bucket, ``kb`` and scan path.  Device buffers exist only for the shards on
this process's own devices: a write to a shard held elsewhere updates only
the host tables.  A search scans this process's (replica, shard) pairs, and
one all-gather (parallel/comm.py) brings every pair's candidates to every
process, which merges them in shard order on the host, as one process
merges its own, so the answer is the single-process store's bit for bit.  A verb that reaches
only some processes raises after the group's timeout.

Spans (utils/metrics.py), each with the ticket's request id, as
core/store.py records them: ``store.submit`` (``search_batch_submit``),
``store.readback`` (the candidates staged to the host: the wait on the
scans, the copies, the all-gather), ``store.merge`` (the host's stable
top-k over the shards' candidates) and ``store.map`` (the row remap and
the ids); the histogram ``store.search`` (submit to the merge's end) and
the counters ``store.search_total``, ``store.queries_total`` and
``store.shard_scans_total`` (the shard scans a search launches).
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from erlvectordb_tpu_torch.core import search as search_mod
from erlvectordb_tpu_torch.core.search import VALID_METRICS
from erlvectordb_tpu_torch.core.store import (
    DimensionMismatch,
    InvalidVector,
    SearchTicket,
    _empty_columns,
    _next_pow2,
    _pad128,
    _pad_rows,
    _quantize_int8,
    _row_norms,
    _scatter_delete,
    _scatter_insert_f32,
    _scatter_insert_int8,
    hits_from_columns,
)
from erlvectordb_tpu_torch.ops import fused_topk as ft
from erlvectordb_tpu_torch.ops.adc import topk_stable
from erlvectordb_tpu_torch.parallel import comm
from erlvectordb_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    REPLICA_AXIS,
    Mesh,
    spans_processes,
)
from erlvectordb_tpu_torch.utils.locks import RWLock
from erlvectordb_tpu_torch.utils.metrics import metrics, now_ns

MIN_SHARD_CAPACITY = 256

_INF = float("inf")


def _bulk_cap(n: int, s_count: int) -> int:
    """Per-shard capacity of a bulk build: tile-aligned (4096) above one
    tile instead of a power of two, so a 10M-row build allocates 10.002M
    rows, not 16.8M.  Growth after the build still doubles (``_grow_to``)."""
    per = -(-n // s_count)
    if per >= ft.TILE_N:
        return -(-per // ft.TILE_N) * ft.TILE_N
    return max(_next_pow2(per), MIN_SHARD_CAPACITY)


@dataclass
class ShardedTicket(SearchTicket):
    """A sharded search in flight; rows encode ``shard * cap + local`` at
    the submit-time per-shard capacity ``shard_cap``.  ``parts`` holds
    this process's (replica, shard, distances, rows), ``layout`` the
    (replica groups, shards, queries a group, kb) of the merge that
    completion runs after the all-gather, and ``seq`` the store's count of
    searches at submit, which names the all-gather."""

    shard_cap: int = 0
    seq: int = 0
    parts: Optional[list] = None
    layout: Optional[Tuple[int, int, int, int]] = None


def _new_buffers(dtype: str, cap: int, width: int, device) -> Dict[str, Any]:
    vdt = torch.int8 if dtype == "int8" else torch.float32
    return {
        "vectors": torch.zeros((cap, width), dtype=vdt, device=device),
        "scales": (torch.ones((cap,), dtype=torch.float32, device=device)
                   if dtype == "int8" else None),
        "norms": torch.zeros((cap,), dtype=torch.float32, device=device),
        "valid": torch.zeros((cap,), dtype=torch.bool, device=device),
    }


NO_MULTIPROBE = ("nprobe requires a local int4r store; distributed stores "
                 "do not support multiprobe")


class ShardedVectorStore:
    """One store whose rows live sharded across a device mesh."""

    def __init__(self, name: str, mesh: Mesh, dim: Optional[int] = None,
                 metric: str = "cosine", dtype: str = "float32"):
        if metric not in VALID_METRICS:
            raise ValueError(f"metric must be one of {VALID_METRICS}")
        if dtype not in ("float32", "int8"):
            raise ValueError("dtype must be 'float32' or 'int8'")
        self.name = name
        self.mesh = mesh
        self.metric = metric
        self.dtype = dtype
        self._dim = dim
        self.n_shards = mesh.shape[DATA_AXIS]
        self.n_replicas = mesh.shape[REPLICA_AXIS]
        self._spans = spans_processes(mesh)
        self._cap = 0  # per-shard capacity
        self._lock = RWLock()
        self._mat_lock = threading.Lock()  # guards _materialize
        self._searches = itertools.count()  # names a search's all-gather

        # per shard: torch.device -> {"vectors", "scales", "norms", "valid"},
        # one entry for each distinct device of the shard's mesh column that
        # this process owns (none for a shard held only by other processes)
        self._copies: List[Dict[torch.device, Dict[str, Any]]] = []

        self._id_to_slot: Dict[str, Tuple[int, int]] = {}  # id -> (shard, local)
        self._slot_to_id: Dict[Tuple[int, int], str] = {}
        self._metadata: Dict[str, Any] = {}
        self._free: List[List[int]] = [[] for _ in range(self.n_shards)]
        self._next_local = [0] * self.n_shards
        self._rr = 0  # round-robin shard cursor

        # bulk builds: rows [0, contig) carry the implicit id str(i) at slot
        # (i // cap, i % cap); the dicts above stay empty until the first
        # targeted mutation
        self._contig = 0
        # columnar global-row -> id table [S, cap] for result mapping
        self._ids_np: Optional[np.ndarray] = None
        self._ids_contig_filled = 0

        self.version = 0
        self.dirty = False
        self.created_at = time.time()

    # ------------------------------------------------------------ properties

    @property
    def dim(self) -> Optional[int]:
        return self._dim

    @property
    def count(self) -> int:
        return len(self._id_to_slot) + self._contig

    @property
    def capacity(self) -> int:
        return self._cap * self.n_shards

    @property
    def spans_processes(self) -> bool:
        """Whether the mesh spans processes (every verb a collective)."""
        return self._spans

    @property
    def device(self) -> torch.device:
        """The device results are gathered on: the mesh's first device that
        this process owns (the CPU in a process that owns none)."""
        return next((d.device for d in self.mesh.devices.flat if d.is_local),
                    torch.device("cpu"))

    def __len__(self) -> int:
        return self.count

    def __contains__(self, vid: str) -> bool:
        if self._contig:
            try:
                return 0 <= int(vid) < self._contig
            except (TypeError, ValueError):
                return False
        return vid in self._id_to_slot

    def _materialize(self) -> None:
        """Expand implicit contiguous ids into the slot dicts (once, before
        the first targeted mutation or dict-reading accessor, and before any
        capacity growth).  Guarded by its own mutex with ``_contig`` cleared
        last: callers may hold only the read side of the store lock."""
        if not self._contig:
            return
        with self._mat_lock:
            n, cap = self._contig, self._cap
            if not n:  # lost the race: another thread materialized
                return
            self._id_to_slot = {str(i): (i // cap, i % cap) for i in range(n)}
            self._slot_to_id = {v: k for k, v in self._id_to_slot.items()}
            self._fill_contig_ids(n)
            self._contig = 0  # publish: tables are complete

    def _fill_contig_ids(self, n: int) -> None:
        if self._ids_np is not None and self._ids_contig_filled < n:
            flat = self._ids_np.reshape(-1)
            flat[self._ids_contig_filled:n] = np.arange(
                self._ids_contig_filled, n).astype(str).astype(object)
            self._ids_contig_filled = n

    def _ids_view(self) -> Optional[np.ndarray]:
        if self._contig:
            self._fill_contig_ids(self._contig)
        return self._ids_np

    # --------------------------------------------------------------- device

    def _column_devices(self, s: int, mesh: Optional[Mesh] = None
                        ) -> List[torch.device]:
        """The distinct devices of shard s's mesh column that this process
        owns, in replica order."""
        mesh = mesh or self.mesh
        out: List[torch.device] = []
        for r in range(mesh.shape[REPLICA_AXIS]):
            d = mesh.devices[r, s]
            if d.is_local and d.device not in out:
                out.append(d.device)
        return out

    def _owner(self, s: int) -> int:
        """The process that contributes shard s to a cooperative read: the
        lowest-ranked owner of a device of its column."""
        return min(self.mesh.devices[r, s].process_index
                   for r in range(self.mesh.shape[REPLICA_AXIS]))

    def _place(self, s: int, bufs: Optional[Dict[str, Any]]) -> None:
        """Install shard s from buffers on its first local device, copied to
        every other distinct local device of its column (nothing where this
        process owns no device of the column)."""
        devs = self._column_devices(s)
        copies: Dict[torch.device, Dict[str, Any]] = {}
        if devs and bufs is not None:
            prim = {k: (v.to(devs[0]) if v is not None else None)
                    for k, v in bufs.items()}
            copies[devs[0]] = prim
            for d in devs[1:]:
                copies[d] = {k: (v.to(d) if v is not None else None)
                             for k, v in prim.items()}
        if s < len(self._copies):
            self._copies[s] = copies
        else:
            self._copies.append(copies)

    def _primary(self, s: int) -> Dict[str, Any]:
        """This process's first copy of shard s."""
        if not self._copies[s]:
            raise RuntimeError(
                f"store {self.name!r}: process {comm.rank()} holds no copy "
                f"of shard {s} (its devices belong to other processes)")
        return next(iter(self._copies[s].values()))

    def _shard_bufs(self, r: int, s: int) -> Dict[str, Any]:
        return self._copies[s][self.mesh.devices[r, s].device]

    def _ensure_allocated(self, dim: int) -> None:
        if self._dim is None:
            self._dim = dim
        if self._copies:
            return
        self._cap = MIN_SHARD_CAPACITY
        width = _pad128(self._dim)
        for s in range(self.n_shards):
            devs = self._column_devices(s)
            self._place(s, _new_buffers(self.dtype, self._cap, width, devs[0])
                        if devs else None)
        if self._ids_np is None:
            self._ids_np = np.full((self.n_shards, self._cap), None, object)

    def _grow_to(self, per_shard: int) -> None:
        new_cap = max(_next_pow2(per_shard), MIN_SHARD_CAPACITY)
        if new_cap <= self._cap:
            return
        self._materialize()  # implicit-id identity breaks when cap changes
        for copies in self._copies:
            for bufs in copies.values():
                bufs["vectors"] = _pad_rows(bufs["vectors"], new_cap)
                if bufs["scales"] is not None:
                    bufs["scales"] = _pad_rows(bufs["scales"], new_cap, 1.0)
                bufs["norms"] = _pad_rows(bufs["norms"], new_cap)
                bufs["valid"] = _pad_rows(bufs["valid"], new_cap, False)
        if self._ids_np is not None:
            grown = np.full((self.n_shards, new_cap), None, object)
            grown[:, : self._cap] = self._ids_np
            self._ids_np = grown
        self._cap = new_cap

    def _alloc_slots(self, n: int) -> List[Tuple[int, int]]:
        """Round-robin allocation across shards for balance."""
        slots: List[Tuple[int, int]] = []
        pending = [0] * self.n_shards
        for _ in range(n):
            s = self._rr
            self._rr = (self._rr + 1) % self.n_shards
            if self._free[s]:
                slots.append((s, self._free[s].pop()))
            else:
                slots.append((s, self._next_local[s] + pending[s]))
                pending[s] += 1
        max_needed = max((self._next_local[s] + pending[s]
                          for s in range(self.n_shards)), default=0)
        if max_needed > self._cap:
            self._grow_to(max_needed)
        for s in range(self.n_shards):
            self._next_local[s] += pending[s]
        return slots

    # --------------------------------------------------------------- insert

    def _validate_batch(self, vectors) -> np.ndarray:
        arr = np.asarray(vectors, dtype=np.float32)
        if arr.ndim == 1:
            arr = arr[None, :]
        if self._dim is not None and arr.shape[1] != self._dim:
            raise DimensionMismatch(
                f"store {self.name!r} has dimension {self._dim}, got {arr.shape[1]}")
        if not np.all(np.isfinite(arr)):
            raise InvalidVector("vector elements must be finite numbers")
        return arr

    def insert(self, vector_id: str, vector, metadata: Optional[dict] = None) -> None:
        self.insert_batch([vector_id], [vector], [metadata or {}])

    def insert_batch(self, ids: Sequence[str], vectors,
                     metadatas: Optional[Sequence[Optional[dict]]] = None) -> None:
        if len(ids) == 0:
            return
        arr = self._validate_batch(vectors)
        if arr.shape[0] != len(ids):
            raise ValueError("ids and vectors length mismatch")
        if metadatas is None:
            metadatas = [{}] * len(ids)
        if len(ids) > 1:
            # batch-internal duplicates collapse to the LAST occurrence
            # (last-write-wins): two new occurrences of one id would each take
            # a slot, leaving a ghost row only one of which delete can reach
            last = {str(v): i for i, v in enumerate(ids)}
            if len(last) != len(ids):
                keep = sorted(last.values())
                ids = [ids[i] for i in keep]
                arr = arr[keep]
                metadatas = [metadatas[i] for i in keep]
        with self._lock.write():
            self._materialize()
            self._ensure_allocated(arr.shape[1])
            n = len(ids)
            s_count = self.n_shards
            # bulk fast path: fresh ids into an append-only store take the
            # round-robin slots computed vectorized
            fast = (n >= 1024 and not self._id_to_slot
                    and all(not f for f in self._free)
                    and len(set(map(str, ids))) == n)
            if fast:
                pos = np.arange(n, dtype=np.int64)
                shard_idx = ((self._rr + pos) % s_count).astype(np.int64)
                base = np.asarray(self._next_local, np.int64)
                local_idx = base[shard_idx] + pos // s_count
                new_next = base + np.bincount(shard_idx, minlength=s_count)
                if int(new_next.max()) > self._cap:
                    self._grow_to(int(new_next.max()))
                self._next_local = [int(x) for x in new_next]
                self._rr = int((self._rr + n) % s_count)
            else:
                shard_idx = np.empty(n, np.int64)
                local_idx = np.empty(n, np.int64)
                fresh = []
                for i, vid in enumerate(ids):
                    slot = self._id_to_slot.get(str(vid))
                    if slot is not None:
                        shard_idx[i], local_idx[i] = slot
                    else:
                        fresh.append(i)
                for i, slot in zip(fresh, self._alloc_slots(len(fresh))):
                    shard_idx[i], local_idx[i] = slot
            width = _pad128(arr.shape[1])
            arr_w = np.zeros((n, width), np.float32)
            arr_w[:, : arr.shape[1]] = arr
            for s in range(s_count):
                sel = np.flatnonzero(shard_idx == s)
                if sel.size == 0:
                    continue
                for dev, bufs in self._copies[s].items():
                    rows_t = torch.from_numpy(local_idx[sel]).to(dev)
                    vecs_t = torch.from_numpy(arr_w[sel]).to(dev)
                    if self.dtype == "int8":
                        _scatter_insert_int8(bufs["vectors"], bufs["scales"],
                                             bufs["norms"], bufs["valid"],
                                             rows_t, vecs_t)
                    else:
                        _scatter_insert_f32(bufs["vectors"], bufs["norms"],
                                            bufs["valid"], rows_t, vecs_t)
            sids = [str(v) for v in ids]
            slots = list(zip(shard_idx.tolist(), local_idx.tolist()))
            self._id_to_slot.update(zip(sids, slots))
            self._slot_to_id.update(zip(slots, sids))
            if fast:
                if any(m for m in metadatas):
                    self._metadata.update(
                        (v, m if m is not None else {})
                        for v, m in zip(sids, metadatas))
            else:
                for vid, md in zip(sids, metadatas):
                    self._metadata[vid] = md if md is not None else {}
            self._ids_np.reshape(-1)[shard_idx * self._cap + local_idx] = sids
            self.version += 1
            self.dirty = True

    # --------------------------------------------------------------- delete

    def delete(self, vector_id: str) -> bool:
        with self._lock.write():
            self._materialize()
            slot = self._id_to_slot.pop(str(vector_id), None)
            if slot is None:
                return False
            self._slot_to_id.pop(slot, None)
            self._ids_np[slot[0], slot[1]] = None
            self._metadata.pop(str(vector_id), None)
            for dev, bufs in self._copies[slot[0]].items():
                _scatter_delete(bufs["valid"],
                                torch.tensor([slot[1]], device=dev))
            self._free[slot[0]].append(slot[1])
            self.version += 1
            self.dirty = True
            return True

    # --------------------------------------------------------------- search

    def search(self, query, k: int = 10, metric: Optional[str] = None,
               where: Optional[dict] = None, nprobe: Optional[int] = None,
               recall_target: Optional[float] = None):
        return self.search_batch(np.asarray(query, np.float32)[None, :], k,
                                 metric, where, nprobe=nprobe,
                                 recall_target=recall_target)[0]

    def filter_mask(self, where: dict) -> np.ndarray:
        """[S, cap] slot mask for metadata equality predicates."""
        with self._lock.read():
            # allocate inside the lock: a concurrent insert can grow _cap
            mask = np.zeros((self.n_shards, self._cap), bool)
            self._materialize()
            for vid, meta in self._metadata.items():
                if all(meta.get(kk) == vv for kk, vv in where.items()):
                    slot = self._id_to_slot.get(vid)
                    if slot is not None:
                        mask[slot[0], slot[1]] = True
        return mask

    def search_batch(self, queries, k: int = 10, metric: Optional[str] = None,
                     where: Optional[dict] = None, nprobe: Optional[int] = None,
                     recall_target: Optional[float] = None):
        return self.search_batch_complete(
            self.search_batch_submit(queries, k, metric, where, nprobe=nprobe,
                                     recall_target=recall_target))

    @staticmethod
    def calibrate_nprobe(**_kw) -> dict:
        """Multiprobe needs a local int4r store's cell layout."""
        raise ValueError(NO_MULTIPROBE)

    def search_batch_submit(self, queries, k: int = 10,
                            metric: Optional[str] = None,
                            where: Optional[dict] = None,
                            nprobe: Optional[int] = None,
                            recall_target: Optional[float] = None,
                            ) -> ShardedTicket:
        """Enqueue a batched search without waiting for the device (see
        VectorStore.search_batch_submit): the scans of this process's
        shards are enqueued here, and the candidates' all-gather and merge
        run at completion.  Across processes every process completes its
        tickets in the order it submitted them (a ticket completed out of
        that order raises ``comm.DistributedError``).  ``nprobe`` and
        ``recall_target`` are refused (``calibrate_nprobe``)."""
        if nprobe is not None or recall_target is not None:
            self.calibrate_nprobe()
        t0 = now_ns()
        seq = next(self._searches)
        metric = metric or self.metric
        if metric not in VALID_METRICS:
            raise ValueError(f"metric must be one of {VALID_METRICS}")
        q = self._validate_batch(queries)
        nq = q.shape[0]
        if not self._copies or self.count == 0 or k <= 0:
            t = ShardedTicket(None, nq, k, 0, seq=seq)
        else:
            fmask = self.filter_mask(where) if where else None
            with self._lock.read():
                t = self._dispatch_locked(q, nq, k, metric, fmask)
            t.seq = seq
            metrics.inc("store.shard_scans_total", len(t.parts))
        t.t0 = t0 / 1e9
        t.rid = metrics.current()[0]
        metrics.end("store.submit", t.rid, t0, t.nq)
        return t

    def _readback(self, t: ShardedTicket):
        """Every process's candidates (one all-gather; in one process this
        process's own), reassembled in shard order and merged per replica
        group with ``lax.top_k``'s ties, on the host; the merge's end kept
        as ``t.t_read``.  Counts the search in the ``store.search``
        histogram (submit to merged) and its counters."""
        t0 = now_ns()
        cand = comm.all_gather_dict(
            {(r, s): (comm.host(d), comm.host(g)) for r, s, d, g in t.parts},
            f"search {self.name} #{t.seq}", self._spans)
        t_m = metrics.end("store.readback", t.rid, t0, t.nq)
        r_count, s_count, b_r, kb = t.layout
        kb = min(kb, s_count * cand[(0, 0)][0].shape[1])
        out_d, out_r = [], []
        for r in range(r_count):
            d_flat = torch.from_numpy(np.stack(
                [cand[(r, s)][0] for s in range(s_count)], axis=1)
                .reshape(b_r, -1))
            g_flat = torch.from_numpy(np.stack(
                [cand[(r, s)][1] for s in range(s_count)], axis=1)
                .reshape(b_r, -1))
            neg, sel = topk_stable(-d_flat, kb)
            out_d.append(-neg)
            out_r.append(torch.gather(g_flat, 1, sel))
        dists = torch.cat(out_d).float().numpy()[: t.nq]
        rows = torch.cat(out_r).to(torch.int32).numpy()[: t.nq]
        t.t_read = metrics.end("store.merge", t.rid, t_m, t.nq)
        metrics.observe("store.search", t.t_read / 1e9 - t.t0)
        metrics.inc("store.search_total")
        metrics.inc("store.queries_total", t.nq)
        return dists, rows

    def search_batch_complete(self, t: ShardedTicket):
        """Per query, its hits as ``(id, metadata, distance)``."""
        return self._complete(t, lambda cols: hits_from_columns(
            cols, self._metadata))

    def search_batch_complete_raw(self, t: ShardedTicket):
        """Columnar completion (see VectorStore.search_batch_complete_raw)."""
        return self._complete(t, lambda cols: cols)

    def _complete(self, t: ShardedTicket, form):
        """Merge a ticket's candidates and map its rows to ids: the store's
        one map, ``form`` applied to its columns under the read lock."""
        if t.kb == 0 or t.parts is None:
            return form(_empty_columns(t.nq))
        kk = min(t.k, t.kb)
        dists_np, rows_np = self._readback(t)
        dists_np = dists_np[:, :kk]
        with self._lock.read():
            # device rows encode shard * cap + local at the SUBMIT-time
            # capacity; a concurrent insert may have grown _cap since, and
            # the remapped rows are the ones returned (rows_np would decode
            # wrongly against the current flat layout)
            cap_t = t.shard_cap or self._cap
            rows_np = rows_np[:, :kk]
            if cap_t != self._cap:
                rows_np = (rows_np // cap_t) * self._cap + rows_np % cap_t
            ids = self._ids_view().reshape(-1)[rows_np]
            out = form((dists_np, rows_np, ids))
        metrics.end("store.map", t.rid, t.t_read, t.nq)
        return out

    def _local_scan(self, bufs, q, metric, k, fused_nt):
        """One shard's top-k: (distances [B, kk], local rows [B, kk])."""
        vecs, nrm, vld = bufs["vectors"], bufs["norms"], bufs["valid"]
        is_int8 = self.dtype == "int8"
        kk = min(k, vecs.shape[0])
        if fused_nt > 0:
            return ft.fused_topk(vecs, bufs["scales"] if is_int8 else None,
                                 nrm, vld, q, metric=metric, k=kk,
                                 n_tiles=fused_nt)
        if is_int8:
            dists = search_mod.int8_distances(vecs, bufs["scales"], nrm, q,
                                              metric)
        else:
            dists = search_mod.pairwise_distances(vecs, nrm, q, metric)
        dists = torch.where(vld[None, :], dists, torch.full_like(dists, _INF))
        neg, loc = topk_stable(-dists, kk)
        return -neg, loc

    def _require_held(self) -> None:
        """Refuse a verb on a store that lies wholly on another process's
        devices: this process holds none of its rows."""
        if not self._spans and not self.mesh.devices[0, 0].is_local:
            raise RuntimeError(
                f"store {self.name!r} lies on the devices of process "
                f"{self.mesh.devices[0, 0].process_index}; process "
                f"{comm.rank()} holds no shard of it")

    def _dispatch_locked(self, q, nq, k, metric, fmask=None) -> ShardedTicket:
        self._require_held()
        # bucket the batch to a power of two and pad it so it splits evenly
        # across the replica groups
        r_count = self.n_replicas
        bq = _next_pow2(max(nq, 8))
        bq += (-bq) % r_count
        width = _pad128(q.shape[1])
        qp = np.zeros((bq, width), np.float32)
        qp[:nq, : q.shape[1]] = q
        kb = _next_pow2(min(k, max(self.count, 1)))
        fused_nt = 0
        # decided from the host tables and the mesh alone, so that every
        # process of a group takes the same path and candidate shapes
        if ft.fused_topk_available(self.count, self._cap, metric,
                                   self.mesh.devices[0, 0].device, kb):
            fused_nt = ft.n_tiles_for(max(self._next_local), self._cap)
        if fmask is not None:
            # the mask was built outside this read lock; reconcile it to the
            # current capacity (snapshot semantics, like VectorStore)
            if fmask.shape[1] < self._cap:
                fmask = np.pad(fmask, ((0, 0), (0, self._cap - fmask.shape[1])))
            elif fmask.shape[1] > self._cap:
                fmask = fmask[:, : self._cap]
        b_r = bq // r_count
        cap = self._cap
        # this process's (replica, shard) pairs; completion gathers every
        # process's candidates and merges them on the host
        parts = []
        for r in range(r_count):
            for s in range(self.n_shards):
                md = self.mesh.devices[r, s]
                if not md.is_local:
                    continue
                bufs = self._shard_bufs(r, s)
                if fmask is not None:
                    bufs = dict(bufs, valid=bufs["valid"] & torch.from_numpy(
                        fmask[s]).to(md.device))
                q_rs = torch.from_numpy(qp[r * b_r:(r + 1) * b_r]).to(md.device)
                d, loc = self._local_scan(bufs, q_rs, metric, kb, fused_nt)
                parts.append((r, s, d, loc.long() + s * cap))
        return ShardedTicket(None, nq, k, kb, shard_cap=cap, parts=parts,
                             layout=(r_count, self.n_shards, b_r, kb))

    # ------------------------------------------------------------ accessors

    def get(self, vector_id: str):
        """One row (dequantized) and its metadata.  Across processes this is
        a collective: the shard's owner sends the row to every process."""
        with self._lock.read():
            self._materialize()
            slot = self._id_to_slot.get(str(vector_id))
            if slot is None:
                return None
            self._require_held()
            mine = (self._row(slot) if self._owner(slot[0]) == comm.rank()
                    else None)
            vec = next(v for v in comm.all_gather_object(
                mine, f"get {self.name} {vector_id}", self._spans)
                if v is not None)
            return vec, self._metadata.get(str(vector_id), {})

    def _row(self, slot) -> np.ndarray:
        bufs = self._primary(slot[0])
        vec = bufs["vectors"][slot[1]].cpu().numpy()[: self._dim]
        if self.dtype == "int8":
            vec = vec.astype(np.float32) * float(bufs["scales"][slot[1]])
        return vec

    def get_stats(self) -> dict:
        with self._lock.read():  # _id_to_slot must not grow mid-iteration
            if self._contig:  # block partition: no dict walk needed
                per_shard = [min(self._cap, max(0, self._contig - s * self._cap))
                             for s in range(self.n_shards)]
            else:
                per_shard = [0] * self.n_shards
                for s, _ in self._id_to_slot.values():
                    per_shard[s] += 1
        return {
            "name": self.name,
            "count": self.count,
            "dimension": self._dim,
            "metric": self.metric,
            "dtype": self.dtype,
            "capacity": self.capacity,
            "shards": self.n_shards,
            "replicas": self.n_replicas,
            "per_shard_counts": per_shard,
            "version": self.version,
            "memory_bytes": self.device_memory_bytes(),
        }

    def device_memory_bytes(self) -> int:
        """Bytes of one copy of the store (the global arrays' size)."""
        if not self._copies:
            return 0
        rows = self.n_shards * self._cap
        width = _pad128(self._dim)
        if self.dtype == "int8":
            return int(rows * width + rows * 4 + rows + rows * 4)
        return int(rows * width * 4 + rows * 4 + rows)

    def local_device_bytes(self) -> int:
        """Bytes of the shard copies this process holds on its devices."""
        return int(sum(v.numel() * v.element_size()
                       for copies in self._copies for bufs in copies.values()
                       for v in bufs.values() if v is not None))

    def _own_arrays(self, keys: Sequence[str]) -> Dict[int, Dict[str, Any]]:
        """{shard: {key: array on the host}} of the shards this process
        owns (no collective)."""
        self._require_held()
        return {s: {k: comm.host(self._primary(s)[k]) for k in keys}
                for s in range(self.n_shards) if self._owner(s) == comm.rank()}

    def _stack_arrays(self, own: Dict[int, Dict[str, Any]],
                      keys: Sequence[str], group=None) -> Dict[str, np.ndarray]:
        """Every shard's arrays stacked [S, cap, ...] from each process's
        ``_own_arrays``: across processes a collective (``_host_global``'s
        counterpart) on ``group``, the verbs' group by default."""
        parts = comm.all_gather_dict(own, f"arrays {self.name} "
                                     f"{','.join(keys)}", self._spans, group)
        return {k: np.stack([parts[s][k] for s in range(self.n_shards)])
                for k in keys}

    def _host_arrays(self, keys: Sequence[str]) -> Dict[str, np.ndarray]:
        """Arrays of every shard on the host, stacked [S, cap, ...]; across
        processes every process gets them all."""
        return self._stack_arrays(self._own_arrays(keys), keys)

    def get_all_vectors(self):
        """Every live row (dequantized), sorted by id.  Across processes a
        collective, as export_state."""
        with self._lock.read():
            self._materialize()
            if self.count == 0:
                return []
            host = self._host_arrays(("vectors", "scales")
                                     if self.dtype == "int8" else ("vectors",))
            mat, scales = host["vectors"], host.get("scales")
            out = []
            for vid, (s, l) in sorted(self._id_to_slot.items()):
                vec = mat[s, l][: self._dim]
                if scales is not None:
                    vec = vec.astype(np.float32) * scales[s, l]
                out.append((vid, vec, self._metadata.get(vid, {})))
            return out

    # ------------------------------------------------------ state export

    def export_state(self) -> dict:
        """Snapshot-compatible state in the JAX package's format (arrays
        on the host as [S, cap, ...]).  Across processes a collective: every
        process calls it together and gets the whole arrays, as the JAX
        package's ``_host_global`` replicates them to every host."""
        return self.gather_export(*self.export_local())

    def _array_keys(self) -> Tuple[str, ...]:
        return (("vectors", "norms", "valid", "scales")
                if self.dtype == "int8" else ("vectors", "norms", "valid"))

    def export_local(self) -> Tuple[dict, Dict[int, Dict[str, Any]]]:
        """The first half of ``export_state``, under the read lock and with
        no collective: the host tables and this process's own shards'
        arrays, copied to the host."""
        with self._lock.read():
            self._materialize()
            state = {
                "format": 1,
                "sharded": True,
                "name": self.name,
                "dim": self._dim,
                "metric": self.metric,
                "dtype": self.dtype,
                "created_at": self.created_at,
                "version": self.version,
                "n_shards": self.n_shards,
                "id_to_slot": {k: list(v) for k, v in self._id_to_slot.items()},
                "metadata": dict(self._metadata),
                "next_local": list(self._next_local),
                "free": [list(f) for f in self._free],
            }
            own = (self._own_arrays(self._array_keys()) if self._copies
                   else None)
            return state, own

    def gather_export(self, state: dict, own, group=None) -> dict:
        """The second half: ``state`` with every shard's arrays (across
        processes a collective on ``group``; no lock is held)."""
        if own is not None:
            state.update(self._stack_arrays(own, self._array_keys(), group))
        return state

    @classmethod
    def from_state(cls, state: dict, mesh: Mesh) -> "ShardedVectorStore":
        """Re-hydrate onto a mesh (this package's or the JAX package's
        ``export_state``).  If the mesh's data-axis size differs from the
        snapshot's shard count, the rows are re-sharded by re-insertion.
        Across processes every process loads the same state and places only
        the shards on its own devices."""
        store = cls(state["name"], mesh, dim=state.get("dim"),
                    metric=state.get("metric", "cosine"),
                    dtype=state.get("dtype", "float32"))
        store.created_at = state.get("created_at", time.time())
        store.version = state.get("version", 0)
        snap_shards = int(state.get("n_shards", 1))
        if snap_shards != store.n_shards and "vectors" in state:
            # topology changed since the snapshot: bulk re-insert
            vecs = np.asarray(state["vectors"])
            scales = (np.asarray(state["scales"])
                      if state.get("scales") is not None else None)
            ids, mats, metas = [], [], []
            meta_map = state.get("metadata", {})
            for vid, (s, l) in state.get("id_to_slot", {}).items():
                row = vecs[s, l]
                if scales is not None:
                    row = row.astype(np.float32) * scales[s, l]
                ids.append(vid)
                mats.append(row[: state.get("dim") or row.shape[0]])
                metas.append(meta_map.get(vid, {}))
            if ids:
                store.insert_batch(ids, np.stack(mats), metas)
            return store
        if state.get("vectors") is not None:
            vecs = np.asarray(state["vectors"])
            norms = np.asarray(state["norms"], np.float32)
            valid = np.asarray(state["valid"], bool)
            scales = (np.asarray(state["scales"], np.float32)
                      if state.get("scales") is not None else None)
            store._cap = vecs.shape[1]
            for s in range(store.n_shards):
                if not store._column_devices(s):
                    store._place(s, None)
                    continue
                # copies: the store updates its tensors in place
                store._place(s, {
                    "vectors": torch.tensor(vecs[s]),
                    "scales": (torch.tensor(scales[s])
                               if scales is not None else None),
                    "norms": torch.tensor(norms[s]),
                    "valid": torch.tensor(valid[s])})
        store._id_to_slot = {str(k): (int(v[0]), int(v[1]))
                             for k, v in state.get("id_to_slot", {}).items()}
        store._slot_to_id = {v: k for k, v in store._id_to_slot.items()}
        if store._cap:
            store._ids_np = np.full((store.n_shards, store._cap), None, object)
            if store._id_to_slot:
                flat = store._ids_np.reshape(-1)
                pos = np.array([s * store._cap + l
                                for s, l in store._id_to_slot.values()], np.int64)
                flat[pos] = list(store._id_to_slot.keys())
        store._metadata = dict(state.get("metadata", {}))
        store._next_local = [int(x) for x in state.get(
            "next_local", [0] * store.n_shards)]
        store._free = [[int(x) for x in f] for f in state.get(
            "free", [[] for _ in range(store.n_shards)])]
        return store

    # ----------------------------------------------------------- resharding

    def reshard_to(self, new_mesh: Mesh) -> None:
        """Move this store onto another mesh with the same data-axis size:
        each shard is copied to the devices of its new column that hold no
        copy yet, and copies on devices the new mesh drops are freed.  The
        failover primitive: when a replica group dies, the cluster manager
        rebuilds a smaller mesh and reshards every store onto it.  Where
        either mesh spans processes this is a collective: a shard whose new
        devices belong to a process that holds no copy is sent to it, point
        to point, by the lowest-ranked process that holds one."""
        if new_mesh.shape[DATA_AXIS] != self.n_shards:
            raise ValueError(f"data axis must stay {self.n_shards}, "
                             f"got {new_mesh.shape[DATA_AXIS]}")
        with self._lock.write():
            if self._copies:
                self._copies = self._move_shards(
                    new_mesh, self._spans or spans_processes(new_mesh))
            self.mesh = new_mesh
            self.n_replicas = new_mesh.shape[REPLICA_AXIS]
            self._spans = spans_processes(new_mesh)

    def _move_shards(self, new_mesh: Mesh, spans: bool) -> list:
        """The copies this process keeps or receives for ``new_mesh``: where
        either mesh spans processes, one all-gather of which process holds
        which shard, then, shard by shard in one order that every process
        walks, a send from the lowest-ranked holder to each process that
        needs a copy it lacks; the rest are copies between this process's
        devices."""
        me = comm.rank()
        held = dict(comm.all_gather_object(
            (me, [s for s in range(self.n_shards) if self._copies[s]]),
            f"reshard {self.name}", spans))
        moved = []
        for s in range(self.n_shards):
            holders = sorted(p for p, h in held.items() if s in h)
            lacking = sorted({new_mesh.devices[r, s].process_index
                              for r in range(new_mesh.shape[REPLICA_AXIS])}
                             - set(holders))
            if lacking and not holders and (spans or me in lacking):
                raise RuntimeError(f"store {self.name!r}: no process holds "
                                   f"shard {s}")
            received = None
            for p in lacking if holders else ():
                tag = f"reshard {self.name} shard {s}"
                if me == holders[0]:
                    comm.send_object({k: comm.host(v) for k, v in
                                      self._primary(s).items()}, p, tag)
                elif me == p:
                    received = comm.recv_object(holders[0], tag)
            copies: Dict[torch.device, Dict[str, Any]] = {}
            old = self._copies[s]
            for d in self._column_devices(s, new_mesh):
                if d in old:
                    copies[d] = old[d]
                    continue
                src = next(iter(copies.values()), None) or next(
                    iter(old.values()), None)
                if src is None:
                    src = {k: (torch.from_numpy(v) if v is not None else None)
                           for k, v in received.items()}
                copies[d] = {k: (v.to(d) if v is not None else None)
                             for k, v in src.items()}
            moved.append(copies)
        return moved

    # ----------------------------------------------------------- bulk build

    @classmethod
    def from_matrix(cls, name: str, mesh: Mesh, matrix,
                    ids: Optional[Sequence[str]] = None, metric: str = "cosine",
                    dtype: str = "float32") -> "ShardedVectorStore":
        """Bulk sharded build (VectorStore.from_matrix's analogue).  Rows are
        block-partitioned: row i lives at (shard i // cap, local i % cap).
        ``matrix`` may be a numpy array or a tensor.  Across processes every
        process passes the same rows and writes only its own shards."""
        if dtype == "int4":
            raise ValueError("sharded int4 bulk build not supported yet")
        store = cls(name, mesh, metric=metric, dtype=dtype)
        arr = (matrix.to(torch.float32) if isinstance(matrix, torch.Tensor)
               else torch.from_numpy(np.ascontiguousarray(
                   np.asarray(matrix, np.float32))))
        n, d = arr.shape
        store._dim = d
        s_count = store.n_shards
        store._cap = cap = _bulk_cap(n, s_count)
        width = _pad128(d)
        for s in range(s_count):
            devs = store._column_devices(s)
            if not devs:
                store._place(s, None)
                continue
            dev = devs[0]
            part = arr[s * cap:(s + 1) * cap].to(dev)
            m = part.shape[0]
            bufs = _new_buffers(dtype, cap, width, dev)
            if m:
                norms = _row_norms(part)
                if dtype == "int8":
                    q, scale = _quantize_int8(part)
                    bufs["vectors"][:m, :d] = q
                    bufs["scales"][:m] = scale
                else:
                    bufs["vectors"][:m, :d] = part
                bufs["norms"][:m] = norms
                bufs["valid"][:m] = True
            store._place(s, bufs)
        store._ids_np = np.full((s_count, cap), None, object)
        if ids is None:
            # implicit contiguous ids: no dict materialization (at 10M rows
            # the dicts would cost GBs of host RAM and tens of seconds)
            store._contig = n
        else:
            if len(ids) != n:
                raise ValueError("ids and matrix length mismatch")
            slots = [(i // cap, i % cap) for i in range(n)]
            sids = [str(v) for v in ids]
            store._id_to_slot = dict(zip(sids, slots))
            store._slot_to_id = dict(zip(slots, sids))
            store._ids_np.reshape(-1)[:n] = sids
        store._next_local = [min(cap, max(0, n - s * cap)) for s in range(s_count)]
        store.version = 1
        store.dirty = True
        return store

    # ------------------------------------------------------ streaming build

    @classmethod
    def from_chunks(cls, name: str, mesh: Mesh, chunks, n: int, dim: int,
                    metric: str = "cosine", dtype: str = "int8"
                    ) -> "ShardedVectorStore":
        """Streaming bulk build: each [c, dim] f32 chunk (host array or
        tensor) is quantized into the preallocated shard buffers in place,
        so no [N, D] f32 temporary ever exists: at 10M x 768 the int8 store
        is 7.68 GB and the peak extra footprint is one f32 chunk.  Across
        processes every process passes the same chunk stream and writes only
        its own shards' rows."""
        if dtype not in ("float32", "int8"):
            raise ValueError("dtype must be 'float32' or 'int8'")
        store = cls(name, mesh, dim=dim, metric=metric, dtype=dtype)
        s_count = store.n_shards
        store._cap = cap = _bulk_cap(n, s_count)
        width = _pad128(dim)
        total = cap * s_count
        bufs = []
        for s in range(s_count):
            devs = store._column_devices(s)
            bufs.append(_new_buffers(dtype, cap, width, devs[0]) if devs
                        else None)
        written = 0
        chunk = None
        for chunk in chunks:
            c = int(chunk.shape[0])
            live = min(c, n - written)  # the final chunk may be zero-padded
            if live <= 0:
                raise ValueError("chunks exceed declared n")
            # rows written: the chunk, trimmed where a padded final chunk
            # overhangs the buffers; rows past ``live`` get codes and scales
            # but stay invalid with zero norms
            rows = min(c, total - written)
            _chunk_write(bufs, cap, chunk, written, live, rows, dtype, width)
            written += live
        if written != n:
            raise ValueError(f"chunks covered {written} rows, declared {n}")
        del chunk
        for s in range(s_count):
            store._place(s, bufs[s])
        store._contig = n
        store._ids_np = np.full((s_count, cap), None, object)
        store._next_local = [min(cap, max(0, n - s * cap)) for s in range(s_count)]
        store.version = 1
        store.dirty = True
        return store

    # ----------------------------------------------------------- migration

    @classmethod
    def from_store(cls, store, mesh: Mesh, name: Optional[str] = None
                   ) -> "ShardedVectorStore":
        """Distribute a store across a mesh: its live rows (dequantized)
        re-inserted, replacing the reference's per-vector rpc migration."""
        return cls.from_rows(name or store.name, mesh, store.get_all_vectors(),
                             dim=store.dim, metric=store.metric,
                             dtype=getattr(store, "dtype", "float32"))

    @classmethod
    def from_rows(cls, name: str, mesh: Mesh, allv, dim: Optional[int],
                  metric: str, dtype: str) -> "ShardedVectorStore":
        """A store on ``mesh`` of ``get_all_vectors()``'s rows."""
        out = cls(name, mesh, dim=dim, metric=metric, dtype=dtype)
        if allv:
            out.insert_batch([v[0] for v in allv], np.stack([v[1] for v in allv]),
                             [v[2] for v in allv])
        return out

    def to_store(self, name: Optional[str] = None, device=None):
        """Collapse back to a single-device store (the leave_cluster
        analogue), on ``device`` (default: the mesh's first device)."""
        from erlvectordb_tpu_torch.core.store import VectorStore

        out = VectorStore(name or self.name, dim=self._dim, metric=self.metric,
                          dtype=self.dtype,
                          device=device if device is not None else self.device)
        allv = self.get_all_vectors()
        if allv:
            out.insert_batch([v[0] for v in allv], np.stack([v[1] for v in allv]),
                             [v[2] for v in allv])
        return out


def _chunk_write(bufs, cap, chunk, off, live, rows, dtype, width):
    """Quantize one chunk and write its first ``rows`` rows at flat row
    ``off`` of the shard buffers (shard ``i // cap`` holds flat row i; a
    shard this process does not hold has no buffers and is skipped).  The
    whole chunk is encoded on the first held shard's device, so that every
    process writes the bits one process would."""
    s0, s1 = off // cap, (off + rows - 1) // cap
    if all(b is None for b in bufs[s0:s1 + 1]):
        return
    dev0 = next(b for b in bufs if b is not None)["vectors"].device
    x = (chunk if isinstance(chunk, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(np.asarray(chunk, np.float32))))
    x = x[:rows].to(device=dev0, dtype=torch.float32)
    if width != x.shape[1]:
        x = torch.nn.functional.pad(x, (0, width - x.shape[1]))
    nn = _row_norms(x)
    if dtype == "int8":
        codes, sc = _quantize_int8(x)
    else:
        codes, sc = x, None
    vld = torch.arange(rows, device=dev0) < live
    nn = torch.where(vld, nn, torch.zeros_like(nn))
    i = 0
    while i < rows:
        s, l0 = divmod(off + i, cap)
        m = min(rows - i, cap - l0)
        dst = bufs[s]
        if dst is None:
            i += m
            continue
        dev = dst["vectors"].device
        dst["vectors"][l0:l0 + m] = codes[i:i + m].to(dev)
        if sc is not None:
            dst["scales"][l0:l0 + m] = sc[i:i + m].to(dev)
        dst["norms"][l0:l0 + m] = nn[i:i + m].to(dev)
        dst["valid"][l0:l0 + m] = vld[i:i + m].to(dev)
        i += m
