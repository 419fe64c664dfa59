"""Balanced cell assignment — the part of the IVF module the int4r store's
host build uses.

Counterpart of ``_top_choices``, ``_top_choices_chunk``,
``_top_choices_all`` and ``_balanced_assign`` in
``erlvectordb_tpu/core/ivf.py`` (IVF search itself is not ported yet).
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
from erlvectordb_tpu_torch.ops.fused_topk import full_f32_matmul


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
