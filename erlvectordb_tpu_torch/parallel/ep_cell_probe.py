"""Expert-parallel cell probe — the hnsw slot, sharded over the mesh.

Counterpart of ``erlvectordb_tpu/parallel/ep_cell_probe.py``: the scale-out
form of core/cell_probe.py.  The cell probe's int8 RESIDUAL codes are split
over the mesh's ``data`` axis (cells are the experts), with the same exact
f32 centroid term:

    route:      top-nprobe over a bf16 [B, C] centroid product, f32
                accumulation (the same on every shard, so computed once);
                empty and padding cells never win a probe
    per shard:  for each probe slot, gather MY probed cells' int8 residual
                blocks: a bf16 residual dot (f32 accumulation) plus the
                exact f32 centroid dot -> local top-k over my candidates
    merge:      the candidates of every shard on the first device, one
                stable top-k (ties to the lower flat index, as lax.top_k)

The gathers and dots are plain tensor code, as in the JAX package (no
kernel: B7 serves the single-device cell probe).  There is no ``q_cap``: no
(query, cell) pair is dropped, so recall is at least the single-device
index's at equal nprobe.  Across processes a search and ``to_arrays`` are
collectives, as in ep_ivf.py.
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import numpy as np
import torch

from erlvectordb_tpu_torch.core.calibration import CalibrationSet, measure_curve
from erlvectordb_tpu_torch.core.cell_probe import CellProbeIndex
from erlvectordb_tpu_torch.ops.fused_topk import full_f32_matmul
from erlvectordb_tpu_torch.parallel.ep_ivf import (
    _NEG,
    first_local,
    gather_shards,
    host_cells,
    merge_candidates,
    shard_devices,
    split_cells,
)
from erlvectordb_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    make_mesh,
    spans_processes,
)
from erlvectordb_tpu_torch.ops.adc import topk_stable


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, held in f32: a product of two such values (or of
    one and an int8 code) is exact in f32, so f32 sums of them are the bf16
    products with f32 accumulation."""
    return x.to(torch.bfloat16).float()


class EPCellProbeIndex:
    """Cell-probe int8 residual cells as experts over a mesh's data axis."""

    def __init__(self, mesh: Mesh, centroids, codes, scales, norms, valid,
                 row_map, cell_cap: int):
        self.mesh = mesh
        self.n_shards = mesh.shape[DATA_AXIS]
        cents = np.asarray(centroids, np.float32)
        n_cells = cents.shape[0]
        if n_cells % self.n_shards:
            raise ValueError(f"{n_cells} cells not divisible by "
                             f"{self.n_shards} shards")
        self.n_cells = n_cells
        self.cell_cap = int(cell_cap)
        self.c_local = n_cells // self.n_shards
        w = cents.shape[1]
        self.devices = shard_devices(mesh)
        self.spans = spans_processes(mesh)
        self._searches = itertools.count()  # names a search's all-gather
        dev0 = first_local(self.devices)
        self.centroids = torch.tensor(cents, device=dev0)
        self.cents_bf = _bf16(self.centroids)
        valid = np.asarray(valid, bool).reshape(n_cells, cell_cap)

        def split(x, dt, shape):
            return split_cells(np.asarray(x, dt).reshape(shape), self.devices,
                               self.c_local)

        self.codes = split(codes, np.int8, (n_cells, cell_cap, w))
        self.scales = split(scales, np.float32, (n_cells, cell_cap))
        self.norms = split(norms, np.float32, (n_cells, cell_cap))
        self.valid = split(valid, bool, (n_cells, cell_cap))
        self.rows = split(row_map, np.int32, (n_cells, cell_cap))
        self.row_map = np.asarray(row_map)
        self.active = torch.tensor(valid.any(axis=1), device=dev0)
        # recall_target calibration curves, keyed (k, metric)
        self._calib = CalibrationSet()

    # ------------------------------------------------------------------ build

    @classmethod
    def build(cls, data, rows, mesh: Mesh, **kw) -> "EPCellProbeIndex":
        # no hierarchy: the EP route is already sharded and from_cell_probe
        # drops the super route
        kw.setdefault("hierarchy", False)
        base = CellProbeIndex.build(data, np.asarray(rows),
                                    device=first_local(shard_devices(mesh)),
                                    **kw)
        return cls.from_cell_probe(base, mesh)

    @classmethod
    def from_cell_probe(cls, cp: CellProbeIndex, mesh: Mesh) -> "EPCellProbeIndex":
        """Distribute a single-device cell-probe index (the cell count is
        padded to a shard multiple with empty, far-away cells)."""
        s = mesh.shape[DATA_AXIS]
        c = cp.n_cells
        cap = cp.cell_cap
        pad = -(-c // s) * s - c
        cents = cp.centroids.cpu().numpy()
        codes = cp.codes.cpu().numpy()
        scales = cp.scales.cpu().numpy()
        norms = cp.norms.cpu().numpy()
        row_map = cp.row_map
        if pad:
            w = cents.shape[1]
            cents = np.concatenate([cents, np.full((pad, w), 1e6, np.float32)])
            codes = np.concatenate([codes, np.zeros((pad * cap, w), np.int8)])
            scales = np.concatenate([scales, np.ones(pad * cap, np.float32)])
            norms = np.concatenate([norms, np.zeros(pad * cap, np.float32)])
            row_map = np.concatenate([row_map, np.full(pad * cap, -1, np.int64)])
        idx = cls(mesh, cents, codes, scales, norms, row_map >= 0, row_map, cap)
        # single-device curves transfer conservatively: EP drops no (query,
        # cell) pair, so its recall is at least the single-device index's
        if cp._calib:
            idx._calib = CalibrationSet.from_json(cp._calib.to_json())
        return idx

    # ----------------------------------------------------------------- search

    def _member_queries(self, n_sample: int) -> np.ndarray:
        """Decode up to n_sample live rows of the sampled cells (across
        processes a collective: the valid masks and the sampled rows are
        gathered)."""
        valid = host_cells(self.valid, self.spans,
                           "ep_cellprobe valid").reshape(-1)
        live = np.flatnonzero(valid)
        if len(live) == 0:
            raise ValueError("cannot calibrate an empty index")
        rng = np.random.default_rng(len(live))
        sel = rng.choice(live, size=min(n_sample, len(live)), replace=False)
        cells, slots = sel // self.cell_cap, sel % self.cell_cap
        shard, lc = cells // self.c_local, cells % self.c_local
        picked = {}
        for s in range(self.n_shards):
            if self.devices[s] is None:
                continue
            at = shard == s
            li = torch.from_numpy(lc[at]).to(self.devices[s])
            sl = torch.from_numpy(slots[at]).to(self.devices[s])
            picked[s] = (self.codes[s][li, sl], self.scales[s][li, sl])
        got = gather_shards(picked, self.n_shards, self.spans,
                            "ep_cellprobe sampled rows")
        codes = np.zeros((len(sel), self.centroids.shape[1]), np.float32)
        scales = np.zeros(len(sel), np.float32)
        for s, (c, sc) in enumerate(got):
            codes[shard == s] = c.cpu().numpy()
            scales[shard == s] = sc.cpu().numpy()
        cents = self.centroids.cpu().numpy()[cells]
        return cents + codes * scales[:, None]

    def calibrate_nprobe(self, queries=None, n_sample: int = 256, k: int = 10,
                         metric: str = "cosine", ground_truth=None) -> dict:
        """Measure the recall@k-vs-nprobe curve so ``search(recall_target=
        ...)`` can pick the smallest qualifying global nprobe (modes as in
        CellProbeIndex.calibrate_nprobe: exact with ``ground_truth``, else
        ceiling against this index's own deep probe)."""
        if queries is None:
            if ground_truth is not None:
                raise ValueError("ground_truth requires explicit queries")
            queries = self._member_queries(n_sample)
        queries = np.asarray(queries, np.float32)
        deep = min(self.n_cells, 512)

        def search_rows(qs, kk, nprobe):
            _, got = self.search(qs, k=kk, nprobe=nprobe, metric=metric)
            return got

        curve = measure_curve(search_rows, queries, k=k, metric=metric,
                              deep=deep, ground_truth=ground_truth)
        self._calib.put(curve)
        return dict(curve.curve)

    def nprobe_for(self, recall_target: float, k: int = 10,
                   metric: str = "cosine") -> int:
        """Smallest calibrated global nprobe meeting the recall@k target
        under the curve's mode; lazily self-calibrates (ceiling mode) on
        first use per (k, metric)."""
        if not (0.0 < recall_target <= 1.0):
            raise ValueError("recall_target must be in (0, 1]")

        def compute():
            self.calibrate_nprobe(k=k, metric=metric)
            return self._calib.get(k, metric)

        cur = self._calib.get(k, metric)
        if cur is None:
            cur = self._calib.get_or_compute(k, metric, compute)
        return cur.nprobe_for(recall_target)

    def search(self, queries, k: int = 10, nprobe: int = 32,
               metric: str = "cosine",
               recall_target: Optional[float] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (distances [B, k], store rows [B, k]; -1 = no hit).
        ``recall_target`` overrides ``nprobe`` with the smallest calibrated
        value meeting the target."""
        if recall_target is not None:
            nprobe = self.nprobe_for(recall_target, k=k, metric=metric)
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        w = self.centroids.shape[1]
        if q.shape[1] != w:
            qp = np.zeros((q.shape[0], w), np.float32)
            qp[:, : q.shape[1]] = q
            q = qp
        nprobe = min(nprobe, self.n_cells)
        k_all = min(k, self.cell_cap * nprobe)
        dev0 = first_local(self.devices)
        qd = torch.tensor(q, device=dev0)
        b = q.shape[0]
        # route on the bf16 table (ranking-grade), f32 accumulation
        with full_f32_matmul():
            table_r = _bf16(qd) @ self.cents_bf.T               # [B, C]
        cn2 = torch.sum(self.centroids * self.centroids, dim=-1)
        if metric == "euclidean":
            route = 2.0 * table_r - cn2[None, :]
        elif metric == "cosine":
            cnorm = torch.sqrt(cn2)
            one = torch.ones_like(cnorm)
            route = torch.where(cnorm > 0, table_r / torch.where(cnorm > 0, cnorm, one),
                                torch.zeros_like(table_r))
        elif metric == "dot":
            route = table_r
        else:
            raise ValueError(metric)
        # padding cells (centroids 1e6) would dominate dot/cosine routing
        route = torch.where(self.active[None, :], route, torch.full_like(route, _NEG))
        _, probe = topk_stable(route, nprobe)                  # [B, np]
        # exact f32 centroid dots for the probed cells (scoring-grade)
        with full_f32_matmul():
            tgath = torch.einsum("bpw,bw->bp", self.centroids[probe], qd)
        qsq = torch.sum(qd * qd, dim=-1, keepdim=True)
        top = {}
        for s, dev in enumerate(self.devices):
            if dev is None:
                continue
            qs, pr, tg = qd.to(dev), probe.to(dev), tgath.to(dev)
            qbf = _bf16(qs)
            qn = torch.sqrt(qsq.to(dev))
            codes, scales = self.codes[s], self.scales[s]
            norms, valid, rows = self.norms[s], self.valid[s], self.rows[s]
            scs, rws = [], []
            for j in range(nprobe):
                lidx = pr[:, j] - s * self.c_local
                mine = (lidx >= 0) & (lidx < self.c_local)
                li = torch.clamp(lidx, 0, self.c_local - 1)
                with full_f32_matmul():
                    dots = torch.einsum("bcw,bw->bc", codes[li].float(), qbf)
                qx = dots * scales[li] + tg[:, j:j + 1]            # [B, cap]
                rnorm = norms[li]
                if metric == "euclidean":
                    sc = 2.0 * qx - rnorm * rnorm
                elif metric == "dot":
                    sc = qx
                else:  # cosine
                    denom = qn * rnorm
                    one = torch.ones_like(denom)
                    sc = torch.where(denom > 0,
                                     qx / torch.where(denom > 0, denom, one),
                                     torch.zeros_like(qx))
                sc = torch.where(valid[li] & mine[:, None], sc,
                                 torch.full_like(sc, _NEG))
                scs.append(sc)
                rws.append(rows[li])
            scs = torch.stack(scs, dim=1).reshape(b, -1)      # [B, np * cap]
            rws = torch.stack(rws, dim=1).reshape(b, -1)
            best, sel = topk_stable(scs, min(k_all, scs.shape[1]))
            top[s] = (best, torch.gather(rws, 1, sel))
        top_sc, top_rw = zip(*gather_shards(
            top, self.n_shards, self.spans,
            f"ep_cellprobe search #{next(self._searches)}"))
        best, rows_out = merge_candidates(top_sc, top_rw, k_all, dev0)
        if metric == "euclidean":
            dist = torch.sqrt(torch.clamp(qsq - best, min=0.0))
        elif metric == "dot":
            dist = -best
        else:
            dist = 1.0 - best
        dist = torch.where(rows_out >= 0, dist, torch.full_like(dist, float("inf")))
        return dist.cpu().numpy()[:, :k], rows_out.cpu().numpy()[:, :k]

    # ------------------------------------------------------------------ misc

    def to_arrays(self) -> dict:
        """The index's arrays on the host (across processes a collective:
        every process gets every shard's cells)."""
        out = {
            "centroids": self.centroids.cpu().numpy(),
            "codes": host_cells(self.codes, self.spans,
                                "ep_cellprobe codes").reshape(
                self.n_cells * self.cell_cap, -1),
            "scales": host_cells(self.scales, self.spans,
                                 "ep_cellprobe scales").reshape(-1),
            "norms": host_cells(self.norms, self.spans,
                                "ep_cellprobe norms").reshape(-1),
            "row_map": self.row_map,
            "cell_cap": np.asarray(self.cell_cap),
        }
        if self._calib:
            out["calibrations"] = np.asarray(self._calib.to_json())
            self._calib.mark_clean()
        return out

    @classmethod
    def from_arrays(cls, d: dict, mesh: Optional[Mesh] = None) -> "EPCellProbeIndex":
        """An index from ``to_arrays`` of this package or the JAX one
        (default mesh: every card, one replica group)."""
        mesh = mesh or make_mesh(n_replica=1)
        return cls.from_cell_probe(CellProbeIndex.from_arrays(
            d, device=first_local(shard_devices(mesh))), mesh)

    def stats(self) -> dict:
        fill = (self.row_map >= 0).reshape(self.n_cells, self.cell_cap).sum(1)
        return {
            "kind": "ep_cellprobe",
            "calibration": self._calib.summaries(),
            "shards": int(self.n_shards),
            "n_cells": int(self.n_cells),
            "cell_cap": int(self.cell_cap),
            "rows": int(fill.sum()),
            "cells_per_shard": int(self.c_local),
            "memory_bytes": int(self.n_cells * self.cell_cap
                                * (self.centroids.shape[1] + 8)),
        }
