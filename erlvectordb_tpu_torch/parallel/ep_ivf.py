"""Expert-parallel IVF — cells sharded across the mesh's data axis.

Counterpart of ``erlvectordb_tpu/parallel/ep_ivf.py``.  The single-device
IVF (core/ivf.py) routes each query to its top-``nprobe`` cells; here the
[C, cap, D] cell blocks are split over the mesh's ``data`` axis (cells are
the experts), centroids and queries go to every shard, and each shard scores
only the probed cells it owns:

    route:      top-nprobe over the [B, C] centroid distances (the same on
                every shard, so it is computed once)
    per shard:  for each probe slot, gather MY probed cell blocks and score
                them -> local top-k over my (slot, row) candidates
    merge:      the candidates of every shard on the first device, one
                stable top-k (ties to the lower flat index, as lax.top_k)

Unlike the single-device sort-based dispatch there is no ``q_cap``: no
(query, cell) pair is dropped, so recall is at least the single-device
IVF's at equal nprobe.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from erlvectordb_tpu_torch.core.ivf import IVFIndex
from erlvectordb_tpu_torch.ops.adc import topk_stable
from erlvectordb_tpu_torch.ops.fused_topk import full_f32_matmul
from erlvectordb_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, make_mesh

_NEG = -1e30


def shard_devices(mesh: Mesh) -> List[torch.device]:
    """The device of each data shard (replica group 0's)."""
    return [mesh.devices[0, s].device for s in range(mesh.shape[DATA_AXIS])]


def merge_candidates(scores: List[torch.Tensor], rows: List[torch.Tensor],
                     k: int, dev: torch.device):
    """Candidates of every shard ([B, kk] each, shard-major) -> the best k
    by score, ties to the lower flat index; rows of empty slots -> -1."""
    sc = torch.stack([s.to(dev) for s in scores]).transpose(0, 1)
    rw = torch.stack([r.to(dev) for r in rows]).transpose(0, 1)
    b = sc.shape[0]
    sc, rw = sc.reshape(b, -1), rw.reshape(b, -1)
    best, sel = topk_stable(sc, min(k, sc.shape[1]))
    rows_out = torch.gather(rw, 1, sel)
    rows_out = torch.where(best > _NEG / 2, rows_out, torch.full_like(rows_out, -1))
    return best, rows_out


class EPIVFIndex:
    """IVF cells as experts, sharded over a mesh's data axis."""

    def __init__(self, mesh: Mesh, centroids, cells, cell_rows, cell_norms,
                 cell_valid, row_map):
        self.mesh = mesh
        self.n_shards = mesh.shape[DATA_AXIS]
        cells = np.asarray(cells, np.float32)
        if cells.shape[0] % self.n_shards:
            raise ValueError(f"{cells.shape[0]} cells not divisible by "
                             f"{self.n_shards} shards")
        self.n_cells = cells.shape[0]
        self.cell_cap = cells.shape[1]
        self.c_local = self.n_cells // self.n_shards
        self.devices = shard_devices(mesh)
        self.centroids = torch.tensor(np.asarray(centroids, np.float32),
                                      device=self.devices[0])

        def split(x, dt):
            x = np.asarray(x, dt)
            return [torch.tensor(x[s * self.c_local:(s + 1) * self.c_local],
                                 device=d) for s, d in enumerate(self.devices)]

        self.cells = split(cells, np.float32)          # per shard [c_local, cap, D]
        self.cell_rows = split(cell_rows, np.int32)    # store rows
        self.cell_norms = split(cell_norms, np.float32)
        self.cell_valid = split(cell_valid, bool)
        self.row_map = np.asarray(row_map)

    @classmethod
    def build(cls, data, rows, norms, mesh: Mesh, n_cells: int = 64,
              **kw) -> "EPIVFIndex":
        """Build through the single-device IVF build (k-means + balanced
        assignment) with the cell count rounded up to the shard count, on
        the mesh's first device, then shard."""
        s = mesh.shape[DATA_AXIS]
        n_cells = max(s, -(-n_cells // s) * s)
        base = IVFIndex.build(np.asarray(data), np.asarray(rows),
                              np.asarray(norms), n_cells=n_cells,
                              device=mesh.devices[0, 0].device, **kw)
        return cls.from_ivf(base, mesh)

    @classmethod
    def from_ivf(cls, ivf: IVFIndex, mesh: Mesh) -> "EPIVFIndex":
        """Distribute a single-device IVF across the mesh (the cell count is
        padded to a shard multiple with empty, far-away cells)."""
        s = mesh.shape[DATA_AXIS]
        c = ivf.n_cells
        c_pad = -(-c // s) * s - c
        arrays = ivf.to_arrays()
        cents, cells = arrays["centroids"], arrays["cells"]
        rows, nrms = arrays["cell_rows"], arrays["cell_norms"]
        vld = rows >= 0
        if c_pad:
            # padding centroids far away so routing never probes them
            cents = np.concatenate(
                [cents, np.full((c_pad, cents.shape[1]), 1e6, np.float32)])
            cells = np.concatenate(
                [cells, np.zeros((c_pad,) + cells.shape[1:], np.float32)])
            rows = np.concatenate([rows, np.full((c_pad, rows.shape[1]), -1, np.int32)])
            nrms = np.concatenate([nrms, np.zeros((c_pad, nrms.shape[1]), np.float32)])
            vld = np.concatenate([vld, np.zeros((c_pad, vld.shape[1]), bool)])
        return cls(mesh, cents, cells, rows, nrms, vld, rows)

    def search(self, queries, k: int = 10, nprobe: int = 8,
               metric: str = "euclidean") -> Tuple[np.ndarray, np.ndarray]:
        """Returns (distances [B, k], store rows [B, k]; -1 = no hit)."""
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        nprobe = min(nprobe, self.n_cells)
        k_all = min(k, self.cell_cap * nprobe)
        dev0 = self.devices[0]
        qd = torch.tensor(q, device=dev0)
        # route: the same on every shard
        with full_f32_matmul():
            cdots = qd @ self.centroids.T
        cn = torch.sum(self.centroids * self.centroids, dim=-1)
        _, probe = topk_stable(-(cn[None, :] - 2.0 * cdots), nprobe)  # [B, np]
        b = q.shape[0]
        top_sc, top_rw = [], []
        for s, dev in enumerate(self.devices):
            qs, pr = qd.to(dev), probe.to(dev)
            cells, crow = self.cells[s], self.cell_rows[s]
            cnrm, cvld = self.cell_norms[s], self.cell_valid[s]
            scs, rws = [], []
            for j in range(nprobe):
                lidx = pr[:, j] - s * self.c_local
                mine = (lidx >= 0) & (lidx < self.c_local)
                li = torch.clamp(lidx, 0, self.c_local - 1)
                with full_f32_matmul():
                    dots = torch.einsum("bcd,bd->bc", cells[li], qs)
                if metric in ("euclidean", "l2"):
                    qsq = torch.sum(qs * qs, dim=-1, keepdim=True)
                    sc = -(qsq - 2.0 * dots + cnrm[li] ** 2)
                elif metric == "dot":
                    sc = dots
                elif metric == "cosine":
                    qn = torch.sqrt(torch.sum(qs * qs, dim=-1, keepdim=True))
                    denom = qn * cnrm[li]
                    one = torch.ones_like(denom)
                    sc = torch.where(denom > 0,
                                     dots / torch.where(denom > 0, denom, one),
                                     torch.zeros_like(dots))
                else:
                    raise ValueError(metric)
                sc = torch.where(cvld[li] & mine[:, None], sc,
                                 torch.full_like(sc, _NEG))
                scs.append(sc)
                rws.append(crow[li])
            scs = torch.stack(scs, dim=1).reshape(b, -1)   # [B, np * cap]
            rws = torch.stack(rws, dim=1).reshape(b, -1)
            best, sel = topk_stable(scs, min(k_all, scs.shape[1]))
            top_sc.append(best)
            top_rw.append(torch.gather(rws, 1, sel))
        best, rows_out = merge_candidates(top_sc, top_rw, k_all, dev0)
        if metric in ("euclidean", "l2"):
            dist = torch.sqrt(torch.clamp(-best, min=0.0))
        elif metric == "dot":
            dist = -best
        else:
            dist = 1.0 - best
        dist = torch.where(rows_out >= 0, dist, torch.full_like(dist, float("inf")))
        return dist.cpu().numpy()[:, :k], rows_out.cpu().numpy()[:, :k]

    def _host(self, parts) -> np.ndarray:
        return np.concatenate([p.cpu().numpy() for p in parts])

    def to_arrays(self) -> dict:
        return {
            "centroids": self.centroids.cpu().numpy(),
            "cells": self._host(self.cells),
            "cell_rows": self._host(self.cell_rows),
            "cell_norms": self._host(self.cell_norms),
        }

    @classmethod
    def from_arrays(cls, d: dict, mesh: Optional[Mesh] = None) -> "EPIVFIndex":
        """An index from ``to_arrays`` of this package or the JAX one
        (default mesh: every card, one replica group)."""
        mesh = mesh or make_mesh(n_replica=1)
        return cls.from_ivf(IVFIndex.from_arrays(
            d, device=mesh.devices[0, 0].device), mesh)

    def stats(self) -> dict:
        fill = (self.row_map >= 0).sum(axis=1)
        return {
            "kind": "ep_ivf",
            "shards": int(self.n_shards),
            "n_cells": int(self.n_cells),
            "cell_cap": int(self.cell_cap),
            "rows": int(fill.sum()),
            "cells_per_shard": int(self.c_local),
        }
