"""IVF index and the balanced cell assignment the int4r store's host build
shares with it.

Counterpart of ``erlvectordb_tpu/core/ivf.py``.  ``IVFIndex`` groups rows by
balanced k-means cells into a padded [cells, cell_cap, D] block; search
routes each query to its ``nprobe`` nearest centroids, buckets the (query,
cell) pairs per cell by a stable sort (pairs past a cell's ``q_cap`` bucket
are dropped, as in the JAX package), scores every bucket against its cell in
one batched product and merges per query.  There is no kernel: it is plain
tensor code, every top-k a stable sort (ties to the lower index, as
``lax.top_k``).

Every row gets its nearest centroid among its top-J choices subject to a
per-cell capacity: closest-first greedy rounds, bumped rows walking down
their own preference list, stragglers placed in the nearest cell with
space.  Choice lists are exact (a stable sort: equal distances keep the
lower cell first, as the JAX package's top-k does); the greedy runs on the
host in numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from erlvectordb_tpu_torch.core.store import default_device
from erlvectordb_tpu_torch.ops.adc import topk_stable
from erlvectordb_tpu_torch.ops.fused_topk import full_f32_matmul
from erlvectordb_tpu_torch.ops.kmeans import kmeans_fit

_NEG = -1e30


def _nearest(d2: torch.Tensor, j: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The j smallest of each row of d2, ascending, ties to the lower
    column."""
    vals, ids = torch.sort(d2, dim=1, stable=True)
    return vals[:, :j], ids[:, :j]


def _top_choices(chunk: torch.Tensor, centroids: torch.Tensor, *, j: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-j centroids of a row chunk: ([chunk, j] |c|^2 - 2 x.c, ids)."""
    with full_f32_matmul():
        dots = chunk @ centroids.T
    cn = torch.sum(centroids * centroids, dim=-1)
    return _nearest(cn[None, :] - 2.0 * dots, j)


def _top_choices_chunk(d_acc, i_acc, rows, centroids, cn, dscale, at, *, j):
    """One row chunk's nearest-j centroids into the [N, j] accumulators at
    row ``at``: distances scaled by ``dscale`` and stored as f16."""
    with full_f32_matmul():
        dots = rows @ centroids.T
    d, ids = _nearest(cn[None, :] - 2.0 * dots, j)
    d_acc[at:at + rows.shape[0]] = (d * dscale).to(torch.float16)
    i_acc[at:at + rows.shape[0]] = ids.to(i_acc.dtype)


def _top_choices_all(data: torch.Tensor, centroids: torch.Tensor, *, j: int,
                     chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """All rows' nearest-j centroids, chunked over rows.  Distances come
    back as f16 (they only order rows within a greedy round) under one
    global order-preserving scale so the cast cannot overflow, and ids as
    int16 where the cell count fits."""
    n = data.shape[0]
    c = centroids.shape[0]
    cn = torch.sum(centroids * centroids, dim=-1)
    id_t = torch.int16 if c <= 32767 else torch.int32
    # |dist| <= cn_max + 2*sqrt(xn2_max*cn_max)
    cn_max = torch.clamp(torch.amax(cn), min=1e-9)
    xn2_max = torch.amax(torch.sum(data * data, dim=-1))
    one = torch.ones((), dtype=torch.float32, device=data.device)
    dscale = one / (cn_max + 2.0 * torch.sqrt(xn2_max * cn_max) + 1.0)
    d_acc = torch.empty((n, j), dtype=torch.float16, device=data.device)
    i_acc = torch.empty((n, j), dtype=id_t, device=data.device)
    for at in range(0, n, chunk):
        _top_choices_chunk(d_acc, i_acc, data[at:at + chunk], centroids, cn,
                           dscale, at, j=j)
    return d_acc, i_acc


def _balanced_assign(data: np.ndarray, centroids: np.ndarray, cap: int,
                     j: int = 32, chunk: int = 131072,
                     device: Optional[torch.device] = None) -> np.ndarray:
    """owner[i] = cell of row i; closest-first greedy over J choice rounds
    with per-cell capacity.

    Placement quality is what routing recall lives or dies by: a row parked
    far from its natural cell is findable only by luck.  So bumped rows walk
    DOWN THEIR OWN preference list (J deep), and the rare stragglers get a
    genuine nearest-cell-with-space pass — never an arbitrary dump.  The
    choice lists are computed on ``device`` (default: the CUDA card)."""
    dev = torch.device(device) if device is not None else default_device()
    n = data.shape[0]
    c = centroids.shape[0]
    if c * cap < n:
        raise ValueError(f"{c} cells x {cap} slots cannot hold {n} rows")
    j = min(j, c)
    # bound the [chunk, C] distance intermediate for large cell counts
    chunk = min(chunk, max(4096, (1 << 27) // max(c, 1)))
    cj = torch.as_tensor(np.ascontiguousarray(centroids, np.float32), device=dev)
    xj = torch.as_tensor(np.ascontiguousarray(data, np.float32), device=dev)
    d_all, i_all = _top_choices_all(xj, cj, j=j, chunk=min(chunk, n))
    ch_d = d_all.cpu().numpy()
    ch_i = i_all.cpu().numpy().astype(np.int32)

    owner = np.full(n, -1, np.int64)
    fill = np.zeros(c, np.int64)
    remaining = np.arange(n)
    for round_j in range(j):
        if remaining.size == 0:
            break
        cells = ch_i[remaining, round_j].astype(np.int64)
        dists = ch_d[remaining, round_j]
        by_dist = np.argsort(dists, kind="stable")       # closest first
        rr, cc = remaining[by_dist], cells[by_dist]
        by_cell = np.argsort(cc, kind="stable")          # keeps dist order
        rr, cc = rr[by_cell], cc[by_cell]
        starts = np.searchsorted(cc, np.arange(c))
        rank = np.arange(rr.size) - starts[cc]
        accept = rank < (cap - fill[cc])
        owner[rr[accept]] = cc[accept]
        fill += np.bincount(cc[accept], minlength=c)
        remaining = rr[~accept]
    if remaining.size:
        # stragglers: nearest cell WITH SPACE (full distance row, masked)
        open_cells = np.where(fill < cap)[0]
        with full_f32_matmul():
            dists_all = (xj[torch.as_tensor(remaining, device=dev)]
                         @ cj[torch.as_tensor(open_cells, device=dev)].T)
        dists_all = dists_all.cpu().numpy()
        cn = (centroids[open_cells] ** 2).sum(axis=1)
        d2 = cn[None, :] - 2.0 * dists_all
        order = np.argsort(d2.min(axis=1), kind="stable")
        for ri in order:  # small set: per-row greedy is fine
            row = remaining[ri]
            for oc in np.argsort(d2[ri], kind="stable"):
                cell = open_cells[oc]
                if fill[cell] < cap:
                    owner[row] = cell
                    fill[cell] += 1
                    break
        # anything still unplaced (cap exhausted in open set) -> emptiest
        left = remaining[owner[remaining] < 0]
        if left.size:
            space_cells = np.repeat(np.arange(c), np.maximum(cap - fill, 0))
            owner[left] = space_cells[: left.size]
    return owner


class IVFIndex:
    """Cell-grouped rows + coarse centroids (balanced cells)."""

    def __init__(self, centroids, cells, cell_rows, cell_norms, device=None):
        dev = torch.device(device) if device is not None else default_device()

        def put(x, dt):
            a = np.asarray(x)
            if not a.flags.writeable:  # torch warns on read-only host memory
                a = a.copy()
            return torch.as_tensor(a, dtype=dt, device=dev)

        self.centroids = put(centroids, torch.float32)   # [C, D]
        self.cells = put(cells, torch.float32)           # [C, cap, D]
        self.cell_rows = put(cell_rows, torch.int32)     # [C, cap] store rows
        self.cell_norms = put(cell_norms, torch.float32)  # [C, cap]
        self.cell_valid = self.cell_rows >= 0
        self.row_map = np.asarray(cell_rows)             # host copy for stats
        self.n_cells = self.centroids.shape[0]
        self.cell_cap = self.cells.shape[1]

    # ------------------------------------------------------------------ build

    @classmethod
    def build(
        cls,
        data: np.ndarray,          # [N, D] f32 (store rows, already padded)
        rows: np.ndarray,          # [N] original store row ids
        norms: np.ndarray,         # [N]
        n_cells: int = 64,
        iters: int = 20,
        seed: int = 0,
        beta: float = 1.3,         # capacity factor over perfect balance
        max_train: int = 200_000,
        device=None,
    ) -> "IVFIndex":
        """k-means++ centroids on the device (a sample past ``max_train``
        rows, drawn with numpy as in the JAX package), then the balanced
        assignment at capacity ceil8(beta * N / n_cells)."""
        dev = torch.device(device) if device is not None else default_device()
        data = np.asarray(data, np.float32)
        n, d = data.shape
        n_cells = min(n_cells, max(1, n // 4))
        train = data
        if n > max_train:
            idx = np.random.default_rng(seed).choice(n, max_train, replace=False)
            train = data[idx]
        cents, _ = kmeans_fit(torch.as_tensor(train, device=dev), seed,
                              k=n_cells, iters=iters, init="kpp")
        cents = cents.cpu().numpy()

        cell_cap = int(-(-beta * n / n_cells // 8) * 8)
        cell_cap = max(8, min(cell_cap, n))
        owner = _balanced_assign(data, cents, cell_cap, device=dev)

        order = np.argsort(owner, kind="stable")
        oc = owner[order]
        starts = np.searchsorted(oc, np.arange(n_cells))
        slot = np.arange(n) - starts[oc]

        cells = np.zeros((n_cells, cell_cap, d), np.float32)
        cell_rows = np.full((n_cells, cell_cap), -1, np.int32)
        cell_norms = np.zeros((n_cells, cell_cap), np.float32)
        cells[oc, slot] = data[order]
        cell_rows[oc, slot] = np.asarray(rows)[order]
        cell_norms[oc, slot] = np.asarray(norms)[order]
        return cls(cents, cells, cell_rows, cell_norms, device=dev)

    # ----------------------------------------------------------------- search

    def search(self, queries, k: int = 10, nprobe: int = 8,
               metric: str = "euclidean") -> Tuple[np.ndarray, np.ndarray]:
        """Returns (distances [B, k], store-rows [B, k]; -1 rows = no hit)."""
        q = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.centroids.device)
        if q.ndim == 1:
            q = q[None, :]
        nprobe = min(nprobe, self.n_cells)
        b = q.shape[0]
        # per-cell query bucket size: 4x the uniform share absorbs routing
        # skew (balanced cells keep it bounded); pairs past it are dropped
        q_cap = int(-(-4 * b * nprobe / self.n_cells // 8) * 8 + 8)
        q_cap = max(8, min(q_cap, b))
        d, r = _ivf_search(
            self.cells, self.cell_rows, self.cell_norms, self.cell_valid,
            self.centroids, q, k=min(k, self.cell_cap * nprobe),
            nprobe=nprobe, q_cap=q_cap, metric=metric)
        return d.cpu().numpy(), r.cpu().numpy()

    def stats(self) -> dict:
        fill = (self.row_map >= 0).sum(axis=1)
        return {
            "kind": "ivf",
            "n_cells": int(self.n_cells),
            "cell_cap": int(self.cell_cap),
            "rows": int(fill.sum()),
            "min_cell": int(fill.min()),
            "max_cell": int(fill.max()),
        }

    def to_arrays(self) -> dict:
        return {
            "centroids": self.centroids.cpu().numpy(),
            "cells": self.cells.cpu().numpy(),
            "cell_rows": self.cell_rows.cpu().numpy(),
            "cell_norms": self.cell_norms.cpu().numpy(),
        }

    @classmethod
    def from_arrays(cls, d: dict, device=None) -> "IVFIndex":
        """An index from ``to_arrays`` of this package or the JAX one."""
        return cls(d["centroids"], d["cells"], d["cell_rows"], d["cell_norms"],
                   device=device)


def _ivf_search(cells, cell_rows, cell_norms, cell_valid, centroids, q, *,
                k, nprobe, q_cap, metric):
    b, d = q.shape
    n_cells, cap, _ = cells.shape
    p = b * nprobe
    dev = q.device

    # 1. route: top-nprobe cells per query (tiny product)
    with full_f32_matmul():
        cdots = q @ centroids.T
    cn = torch.sum(centroids * centroids, dim=-1)
    _, probe = topk_stable(-(cn[None, :] - 2.0 * cdots), nprobe)  # [B, nprobe]

    # 2. sort-based dispatch: (query, cell) pairs bucketed per cell
    pair_cell = probe.reshape(-1)                                  # [P]
    pair_query = torch.arange(b, device=dev).repeat_interleave(nprobe)
    pc, order = torch.sort(pair_cell, stable=True)
    pq = pair_query[order]
    starts = torch.searchsorted(pc, torch.arange(n_cells, device=dev))
    rank = torch.arange(p, device=dev) - starts[pc]
    keep = rank < q_cap
    q_per_cell = torch.zeros((n_cells, q_cap, d), dtype=torch.float32,
                             device=dev)
    q_per_cell[pc[keep], rank[keep]] = q[pq[keep]]                 # [C, q_cap, D]

    # 3. one batched product scores every bucketed pair
    with full_f32_matmul():
        dots = torch.einsum("cqd,crd->cqr", q_per_cell, cells)     # [C, q_cap, cap]
    if metric in ("euclidean", "l2"):
        qsq = torch.sum(q_per_cell * q_per_cell, dim=-1)
        sc = -(qsq[:, :, None] - 2.0 * dots + (cell_norms ** 2)[:, None, :])
    elif metric == "dot":
        sc = dots
    elif metric == "cosine":
        qn = torch.sqrt(torch.sum(q_per_cell * q_per_cell, dim=-1))
        denom = qn[:, :, None] * cell_norms[:, None, :]
        sc = torch.where(denom > 0,
                         dots / torch.where(denom > 0, denom, torch.ones_like(denom)),
                         torch.zeros_like(dots))
    else:
        raise ValueError(metric)
    sc = torch.where(cell_valid[:, None, :], sc, _NEG)             # mask padding

    # 4. per-(cell, slot) top-k', gathered back per pair, merged per query
    kk = min(k, cap)
    top_sc, top_i = topk_stable(sc, kk)                            # [C, q_cap, kk]
    top_rows = torch.gather(cell_rows[:, None, :].expand(-1, q_cap, -1), 2,
                            top_i)
    rank_c = torch.clamp(rank, max=q_cap - 1)
    pair_sc = torch.where(keep[:, None], top_sc[pc, rank_c], _NEG)  # [P, kk]
    pair_rows = torch.where(keep[:, None], top_rows[pc, rank_c], -1)
    # un-sort: back to (query-major, probe-slot) order
    cand_sc = torch.zeros((p, kk), dtype=torch.float32, device=dev)
    cand_sc[order] = pair_sc
    cand_rows = torch.full((p, kk), -1, dtype=torch.int32, device=dev)
    cand_rows[order] = pair_rows
    cand_sc = cand_sc.reshape(b, nprobe * kk)
    cand_rows = cand_rows.reshape(b, nprobe * kk)

    kf = min(k, cand_sc.shape[1])
    best, sel = topk_stable(cand_sc, kf)
    rows_out = torch.gather(cand_rows, 1, sel)
    rows_out = torch.where(best > _NEG / 2, rows_out, -1)

    if metric in ("euclidean", "l2"):
        dist = torch.sqrt(torch.clamp(-best, min=0.0))
    elif metric == "dot":
        dist = -best
    else:  # cosine
        dist = 1.0 - best
    dist = torch.where(rows_out >= 0, dist, float("inf"))
    return dist, rows_out
