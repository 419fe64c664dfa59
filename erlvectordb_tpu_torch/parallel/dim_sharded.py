"""Dimension-sharded search — the tensor-parallel axis of the design.

Counterpart of ``erlvectordb_tpu/parallel/dim_sharded.py``.  A store too
wide for one device splits its FEATURE dimension across a ``model`` mesh
axis: each device holds ``vectors[:, d0:d1]`` and computes partial dot
products (or partial L1 sums, for manhattan) over its columns; the partials
are moved to the first device and added in a fixed shard order, where the
JAX package runs one ``psum``.  Cosine, dot and euclidean need only the dot
``q . x`` and per-row norms (kept whole on the first device), so one sum of
partials per query batch gives exact results.

The scan runs over row chunks (``_ROW_CHUNK`` rows, so the [B, rows]
partials stay bounded) with a running stable top-k, which keeps the lower
row first among equal distances, as ``lax.top_k`` does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from erlvectordb_tpu_torch.core import search as search_mod
from erlvectordb_tpu_torch.core.store import (
    MIN_CAPACITY,
    SearchTicket,
    VectorStore,
    _next_pow2,
    _pad128,
    _pad_rows,
)
from erlvectordb_tpu_torch.ops.adc import topk_stable
from erlvectordb_tpu_torch.ops.fused_topk import full_f32_matmul
from erlvectordb_tpu_torch.parallel.mesh import Mesh, as_mesh_devices, cuda_devices

MODEL_AXIS = "model"

_INF = float("inf")
_ROW_CHUNK = 65536


def make_dim_mesh(n_model: int, devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the feature dimension (default devices: every card)."""
    devices = as_mesh_devices(devices) if devices is not None else cuda_devices()
    if n_model > len(devices):
        raise ValueError(f"need {n_model} devices, have {len(devices)}")
    grid = np.empty((n_model,), dtype=object)
    for i, d in enumerate(devices[:n_model]):
        grid[i] = d
    return Mesh(grid, (MODEL_AXIS,))


class ColumnShards:
    """A [rows, W] matrix split by columns across the devices of a model
    mesh: ``parts[m]`` holds columns [m * W/M, (m+1) * W/M) on device m.
    It answers the few tensor operations the store applies to its rows:
    in-place row writes, row gathers and the copy to the host."""

    def __init__(self, parts: List[torch.Tensor]):
        self.parts = parts
        self.bounds = np.cumsum([0] + [p.shape[1] for p in parts]).tolist()

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.parts[0].shape[0], self.bounds[-1])

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def numel(self) -> int:
        return sum(p.numel() for p in self.parts)

    def element_size(self) -> int:
        return self.parts[0].element_size()

    def index_copy_(self, dim: int, rows: torch.Tensor, src: torch.Tensor):
        for p, c0, c1 in zip(self.parts, self.bounds, self.bounds[1:]):
            p.index_copy_(dim, rows.to(p.device), src[:, c0:c1].to(p.device))
        return self

    def __getitem__(self, idx):
        dev = self.parts[0].device
        got = [p[idx.to(p.device) if isinstance(idx, torch.Tensor) else idx]
               for p in self.parts]
        return torch.cat([g.to(dev) for g in got], dim=-1)

    def cpu(self) -> torch.Tensor:
        return torch.cat([p.cpu() for p in self.parts], dim=-1)


def shard_by_dim(mesh: Mesh, vectors) -> ColumnShards:
    """Place [N, D] with D split across the model axis (D % n_model == 0)."""
    if isinstance(vectors, ColumnShards):
        return vectors
    x = (vectors if isinstance(vectors, torch.Tensor)
         else torch.tensor(np.asarray(vectors, np.float32)))
    n_model = mesh.shape[MODEL_AXIS]
    if x.shape[1] % n_model:
        raise ValueError(f"D={x.shape[1]} not divisible by model axis {n_model}")
    w = x.shape[1] // n_model
    return ColumnShards([x[:, m * w:(m + 1) * w].to(d.device).contiguous()
                         for m, d in enumerate(mesh.devices)])


def _dim_topk(vecs: ColumnShards, norms, valid, q, *, metric: str, k: int):
    """Exact top-k over column-sharded rows: per row chunk, each device's
    partial dots (or L1 sums) over its columns, added in shard order on the
    first device, masked, merged into the running stable top-k."""
    dev = vecs.device
    q_parts = [q[:, c0:c1].to(p.device)
               for p, c0, c1 in zip(vecs.parts, vecs.bounds, vecs.bounds[1:])]
    qsq = None
    if metric != "manhattan":
        for qp in q_parts:
            part = torch.sum(qp * qp, dim=-1).to(dev)
            qsq = part if qsq is None else qsq + part
    best_d = best_i = None
    n = vecs.shape[0]
    for r0 in range(0, n, _ROW_CHUNK):
        r1 = min(n, r0 + _ROW_CHUNK)
        acc = None
        for p, qp in zip(vecs.parts, q_parts):
            blk = p[r0:r1]
            if metric == "manhattan":
                part = torch.cdist(qp, blk, p=1.0)
            else:
                with full_f32_matmul():
                    part = qp @ blk.T
            part = part.to(dev)
            acc = part if acc is None else acc + part
        nrm = norms[r0:r1]
        if metric == "manhattan":
            dists = acc
        elif metric == "dot":
            dists = -acc
        elif metric == "cosine":
            denom = torch.sqrt(qsq)[:, None] * nrm[None, :]
            one = torch.ones_like(denom)
            sim = torch.where(denom > 0, acc / torch.where(denom > 0, denom, one),
                              torch.zeros_like(denom))
            dists = 1.0 - sim
        elif metric == "euclidean":
            d2 = qsq[:, None] - 2.0 * acc + (nrm * nrm)[None, :]
            dists = torch.sqrt(torch.clamp(d2, min=0.0))
        else:
            raise ValueError(metric)
        dists = torch.where(valid[None, r0:r1], dists,
                            torch.full_like(dists, _INF))
        idx = torch.arange(r0, r1, device=dev).expand(dists.shape[0], -1)
        if best_d is not None:
            dists = torch.cat([best_d, dists], dim=1)
            idx = torch.cat([best_i, idx], dim=1)
        neg, sel = topk_stable(-dists, min(k, dists.shape[1]))
        best_d, best_i = -neg, torch.gather(idx, 1, sel)
    return best_d, best_i.to(torch.int32)


def dim_sharded_topk(mesh: Mesh, vectors, norms, valid, queries, *,
                     metric: str = "cosine", k: int = 10
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k with the feature dimension split across the mesh:
    (distances [B, k], rows [B, k]) on the mesh's first device."""
    n_model = mesh.shape[MODEL_AXIS]
    width = vectors.shape[1]
    if width % n_model:
        raise ValueError(f"D={width} not divisible by model axis {n_model}")
    vecs = shard_by_dim(mesh, vectors)
    dev = vecs.device

    def put(x, dtype):
        t = x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))
        return t.to(device=dev, dtype=dtype)

    return _dim_topk(vecs, put(norms, torch.float32), put(valid, torch.bool),
                     put(queries, torch.float32), metric=metric,
                     k=min(k, vecs.shape[0]))


class DimShardedVectorStore(VectorStore):
    """A float32 store whose FEATURE dimension is split across a ``model``
    mesh axis — the tensor-parallel store for embeddings too wide for one
    device.  The full VectorStore API applies (insert, overwrite, delete,
    search, stats, snapshots); the rows are a :class:`ColumnShards`, the
    norms, valid mask and host tables live on the mesh's first device, and
    searches add one set of per-device partials per row chunk.

    float32 only: per-row quantization scales depend on the whole row,
    which a column-split layout cannot compute locally."""

    def __init__(self, name: str, mesh: Mesh, dim=None, metric: str = "cosine"):
        super().__init__(name, dim=dim, metric=metric, dtype="float32",
                         device=mesh.devices[0].device)
        self.mesh = mesh
        self.n_model = mesh.shape[MODEL_AXIS]
        if 128 % self.n_model:
            raise ValueError("model axis must divide the 128-lane pad width")

    def _ensure_allocated(self, dim: int) -> None:
        fresh = self._vectors is None
        super()._ensure_allocated(dim)
        if fresh:
            self._vectors = shard_by_dim(self.mesh, self._vectors)

    def _pad_capacity(self, new_cap: int) -> None:
        cols = self._vectors
        self._vectors = cols.parts[0]  # the base pads part 0 with the rest
        super()._pad_capacity(new_cap)
        self._vectors = ColumnShards([self._vectors] + [
            _pad_rows(p, new_cap) for p in cols.parts[1:]])

    def _dispatch_locked(self, q, k, metric, fmask=None,
                         nprobe=None) -> SearchTicket:
        # nprobe is refused in search_batch_submit (dim-sharded stores are
        # never int4r), so it is always None here
        nq = q.shape[0]
        if self._vectors is None or self.count == 0 or k <= 0:
            return SearchTicket(None, nq, k, 0)
        kb = search_mod.k_bucket(min(k, self.count), self._capacity)
        width = _pad128(q.shape[1])
        bq = _next_pow2(max(nq, 8))
        qp = np.zeros((bq, width), np.float32)
        qp[:nq, : q.shape[1]] = q
        valid = self._valid
        if fmask is not None:
            fm = fmask
            if fm.shape[0] < valid.shape[0]:
                fm = torch.cat([fm, torch.zeros(valid.shape[0] - fm.shape[0],
                                                dtype=torch.bool, device=fm.device)])
            valid = valid & fm[: valid.shape[0]]
        dists, rows = _dim_topk(self._vectors, self._norms, valid, self._put(qp),
                                metric=metric, k=kb)
        return self._finish_ticket(dists[:nq], rows[:nq], nq, k)

    def export_state(self) -> dict:
        state = super().export_state()
        state["dim_sharded"] = True
        state["n_model"] = self.n_model
        return state

    @classmethod
    def from_state(cls, state: dict, mesh: Optional[Mesh] = None,
                   device=None) -> "DimShardedVectorStore":
        """A store from this package's or the JAX package's export (default
        mesh: ``n_model`` cards)."""
        mesh = mesh or make_dim_mesh(int(state.get("n_model", 1)))
        base = VectorStore.from_state(state, device=mesh.devices[0].device)
        store = cls(state["name"], mesh, dim=base.dim, metric=base.metric)
        for attr in ("_capacity", "_id_to_row", "_row_to_id", "_metadata",
                     "_free_rows", "_next_row", "_contig", "_ids_np",
                     "version", "created_at", "_norms", "_valid"):
            setattr(store, attr, getattr(base, attr))
        if base._vectors is not None:
            store._vectors = shard_by_dim(mesh, base._vectors)
        return store

    @classmethod
    def from_matrix(cls, name: str, matrix, mesh: Optional[Mesh] = None,
                    ids=None, metric: str = "cosine",
                    metadatas=None) -> "DimShardedVectorStore":
        """Bulk build placed directly in column shards (no whole copy on one
        device); the norms are the per-device partial sums of squares added
        in shard order."""
        mesh = mesh or make_dim_mesh(len(cuda_devices()))
        arr = np.ascontiguousarray(np.asarray(matrix, np.float32))
        n, d = arr.shape
        store = cls(name, mesh, dim=d, metric=metric)
        cap = max(_next_pow2(n), MIN_CAPACITY)
        width = _pad128(d)
        store._capacity = cap
        xp = np.zeros((cap, width), np.float32)
        xp[:n, :d] = arr
        store._vectors = shard_by_dim(mesh, torch.from_numpy(xp))
        sq = None
        for p in store._vectors.parts:
            part = torch.sum(p * p, dim=-1).to(store.device)
            sq = part if sq is None else sq + part
        store._norms = torch.sqrt(sq)
        vmask = np.zeros((cap,), bool)
        vmask[:n] = True
        store._valid = store._put(vmask)
        store._next_row = n
        store._ids_np = np.full((cap,), None, object)
        if metadatas is not None:
            if len(metadatas) != n:
                raise ValueError("metadatas and matrix length mismatch")
            eff = ids if ids is not None else range(n)
            store._metadata = {str(v): (m or {}) for v, m in zip(eff, metadatas)}
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

    def get_stats(self) -> dict:
        stats = super().get_stats()
        stats["dim_sharded"] = True
        stats["model_shards"] = self.n_model
        return stats
