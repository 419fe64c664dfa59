"""CellProbeIndex — the sub-linear index of the reference's ``hnsw`` slot.

Counterpart of ``erlvectordb_tpu/core/cell_probe.py``.  Build: k-means
coarse centroids (ops/kmeans.py) -> balanced capacity-bounded assignment
(core/ivf.py::_balanced_assign, or the streaming engine of
ops/cell_build.py) -> per-row int8 residual codes against the owning
centroid.  int8 residuals keep quantization error far below the routing
loss, so recall is governed by ``nprobe`` alone.

Search: ops/cell_probe.py::multiprobe_topk — one [B, K] routing product,
the probed cells' code blocks scored by kernel B7, an exact f32-query
rescore.  At ``HIER_MIN_CELLS`` cells the build adds a routing hierarchy
(supercells over the cell centroids, cells laid out supercell-major).

Tensors live on one torch device (default: the CUDA card).  Random draws
(k-means seeding, the build's sample) come from torch generators, so a build
here is not the JAX package's build of the same data; ``from_arrays`` takes
either package's ``to_arrays``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from erlvectordb_tpu_torch.core.calibration import CalibrationSet, measure_curve
from erlvectordb_tpu_torch.core.ivf import _balanced_assign
from erlvectordb_tpu_torch.core.store import default_device
from erlvectordb_tpu_torch.ops.cell_probe import dedup_rows_topk, multiprobe_topk
from erlvectordb_tpu_torch.ops.kmeans import kmeans_fit


class CellProbeIndex:
    """Cell-major int8 residual codes + coarse centroids.

    ``_with_hierarchy`` clusters the cell centroids into supercells and
    permutes the cells supercell-major (padded with empty cells to a fixed
    child count); search then routes L1 over the supercentroids and L2 over
    the probed supercells' children.  The build applies it from
    ``HIER_MIN_CELLS`` cells on."""

    HIER_MIN_CELLS = 131072

    def __init__(self, centroids, codes, scales, norms, valid, row_map,
                 cell_cap: int, super_cents=None, child_cap: int = 0,
                 row_map_dev=None, device=None):
        dev = torch.device(device) if device is not None else default_device()
        self.device = dev

        def put(x, dtype=None):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.array(x))  # a writable host copy
            return x.to(device=dev, dtype=dtype)

        self.centroids = put(centroids, torch.float32)             # [K, W]
        self.cents_route = self.centroids.to(torch.bfloat16)       # routing copy
        self.cn2 = torch.sum(self.centroids * self.centroids, dim=-1)
        self.codes = put(codes).contiguous()                       # [K*cap, W] i8
        self.scales = put(scales, torch.float32)                   # [K*cap]
        self.norms = put(norms, torch.float32)                     # [K*cap]
        self.valid = put(valid, torch.bool)                        # [K*cap]
        # slot -> store row.  Streaming builds keep it on the device
        # (row_map_dev) so results map without an O(N) readback; the host
        # copy is then fetched lazily (stats/persistence only).
        self._row_map_np = (None if row_map is None
                            else np.asarray(row_map).astype(np.int64))
        self.row_map_dev = row_map_dev
        self.cell_cap = int(cell_cap)
        self.n_cells = int(self.centroids.shape[0])
        self.child_cap = int(child_cap)
        self.super_route = (put(super_cents, torch.float32).to(torch.bfloat16)
                            if super_cents is not None else None)
        # multi-assigned (spilled) layouts carry duplicate rows: search
        # over-fetches and dedups per query
        self.spilled = False
        self._calib = CalibrationSet()
        self.build_stats: dict = {}

    @property
    def row_map(self) -> np.ndarray:
        if self._row_map_np is None:
            self._row_map_np = self.row_map_dev.cpu().numpy().astype(np.int64)
        return self._row_map_np

    # ------------------------------------------------------------------ build

    @classmethod
    def build(
        cls,
        data: np.ndarray,           # [N, D] f32 rows (dim-padded ok)
        rows: np.ndarray,           # [N] original store row ids
        *,
        cell_rows: int = 96,        # target valid rows per cell
        cell_cap: int = 128,        # physical slots per cell (>= cell_rows)
        iters: int = 15,
        seed: int = 0,
        max_train: int = 200_000,
        hierarchy: bool = True,     # auto-hierarchy past HIER_MIN_CELLS
        device=None,
    ) -> "CellProbeIndex":
        """Host build: k-means on the device, the balanced assignment, and
        int8 residuals encoded in numpy (a true division by 127, as the JAX
        package's host build does)."""
        dev = torch.device(device) if device is not None else default_device()
        data = np.asarray(data, np.float32)
        n, d = data.shape
        cell_cap = max(8, cell_cap)
        if cell_cap < cell_rows:
            raise ValueError(
                f"cell_cap ({cell_cap}) must be >= cell_rows ({cell_rows}): "
                "total capacity would be smaller than the corpus")
        n_cells = max(1, -(-n // max(8, cell_rows)))
        train = data
        if n > max_train:
            idx = np.random.default_rng(seed).choice(n, max_train,
                                                     replace=False)
            train = data[idx]
        cents, _ = kmeans_fit(torch.as_tensor(train, device=dev), seed,
                              k=min(n_cells, max(1, train.shape[0])),
                              iters=iters, init="kpp")
        cents = cents.cpu().numpy()
        n_cells = cents.shape[0]
        if n_cells * cell_cap < n:
            raise ValueError(
                f"{n_cells} cells x {cell_cap} slots < {n} rows; raise "
                "cell_cap or max_train")
        owner = _balanced_assign(data, cents, cell_cap, device=dev)

        order = np.argsort(owner, kind="stable")
        oc = owner[order]
        starts = np.searchsorted(oc, np.arange(n_cells))
        slot = np.arange(n) - starts[oc]

        res = data[order] - cents[oc]                          # residuals
        absmax = np.abs(res).max(axis=1)
        scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
        codes_rows = np.clip(np.round(res / scale[:, None]),
                             -127, 127).astype(np.int8)

        total = n_cells * cell_cap
        codes = np.zeros((total, d), np.int8)
        scales = np.ones((total,), np.float32)
        out_norms = np.zeros((total,), np.float32)
        row_map = np.full((total,), -1, np.int64)
        dest = oc * cell_cap + slot
        codes[dest] = codes_rows
        scales[dest] = scale
        # score with reconstruction norms (what the codes encode), as the
        # int4r store does
        recon = cents[oc] + codes_rows.astype(np.float32) * scale[:, None]
        out_norms[dest] = np.linalg.norm(recon, axis=1)
        row_map[dest] = np.asarray(rows)[order]
        valid = row_map >= 0
        idx = cls(cents, codes, scales, out_norms, valid, row_map, cell_cap,
                  device=dev)
        if hierarchy and n_cells >= cls.HIER_MIN_CELLS:
            idx = idx._with_hierarchy(seed=seed, iters=iters)
        return idx

    @classmethod
    def build_streaming(cls, chunks, *, n: int, dim: int, cell_rows: int = 96,
                        cell_cap: int = 128, device=None,
                        **build_kw) -> "CellProbeIndex":
        """Build through the device streaming engine (ops/cell_build.py):
        int8 residual codes, balanced cells and a device-resident slot ->
        row map, with no O(N) host round-trip.  Store rows are the implicit
        arrival order 0..n-1.  Build phase timings land in
        ``idx.build_stats``."""
        from erlvectordb_tpu_torch.ops.cell_build import build_cells_streaming

        dev = torch.device(device) if device is not None else default_device()
        res = build_cells_streaming(
            chunks, n=n, dim=dim, cell_rows=cell_rows, cell_cap=cell_cap,
            residual_bits=8, device=dev, **build_kw)
        idx = cls(res.centroids, res.codes, res.scales, res.norms, res.valid,
                  None, res.cell_cap, row_map_dev=res.perm, device=dev)
        idx.build_stats = res.stats
        idx.spilled = res.stats.get("spilled_rows", 0) > 0
        return idx

    def _with_hierarchy(self, *, seed: int = 0, iters: int = 10,
                        child_target: int = 192) -> "CellProbeIndex":
        """Cluster cell centroids into supercells, permute cells
        supercell-major, pad with empty cells to a fixed child count."""
        cents = self.centroids.cpu().numpy()
        k0, w = cents.shape
        cap = self.cell_cap
        s_count = max(2, -(-k0 // child_target))
        sc, _ = kmeans_fit(self.centroids, seed + 1, k=s_count, iters=iters,
                           init="kpp")
        sc = sc.cpu().numpy()
        s_count = sc.shape[0]
        child_cap = -(-max(child_target + child_target // 4,
                           -(-k0 // s_count)) // 8) * 8
        owner = _balanced_assign(cents, sc, child_cap, device=self.device)
        order = np.argsort(owner, kind="stable")
        oc = owner[order]
        starts = np.searchsorted(oc, np.arange(s_count))
        slot = np.arange(k0) - starts[oc]
        dest_cell = oc * child_cap + slot                  # new cell index
        k_new = s_count * child_cap

        def scatter_cells(arr, fill):
            out = np.full((k_new,) + arr.shape[1:], fill, arr.dtype)
            # the assignment above ran on the argsorted cells
            out[dest_cell] = arr[order]
            return out

        new_cents = scatter_cells(cents, 1e6)              # pad cells far away
        codes = self.codes.cpu().numpy().reshape(k0, cap, -1)
        scales = self.scales.cpu().numpy().reshape(k0, cap)
        norms = self.norms.cpu().numpy().reshape(k0, cap)
        row_map = self.row_map.reshape(k0, cap)
        new_codes = scatter_cells(codes, 0).reshape(k_new * cap, -1)
        new_scales = scatter_cells(scales, 1.0).reshape(-1)
        new_norms = scatter_cells(norms, 0.0).reshape(-1)
        new_rows = scatter_cells(row_map, -1).reshape(-1)
        return type(self)(new_cents, new_codes, new_scales, new_norms,
                          new_rows >= 0, new_rows, cap, super_cents=sc,
                          child_cap=child_cap, device=self.device)

    # ----------------------------------------------------------------- search

    def _member_queries(self, n_sample: int) -> np.ndarray:
        """Decode up to n_sample live rows for self-calibration."""
        rows = np.flatnonzero(self.valid.cpu().numpy())
        if len(rows) == 0:
            raise ValueError("cannot calibrate an empty index")
        rng = np.random.default_rng(len(rows))
        rows = rng.choice(rows, size=min(n_sample, len(rows)), replace=False)
        r = torch.as_tensor(rows, device=self.device)
        res = self.codes[r].float() * self.scales[r][:, None]
        return (res + self.centroids[r // self.cell_cap]).cpu().numpy()

    def calibrate_nprobe(self, queries=None, n_sample: int = 256,
                         k: int = 10, metric: str = "cosine",
                         ground_truth=None) -> dict:
        """Measure the recall@k-vs-nprobe curve so
        ``search(recall_target=...)`` can pick the smallest qualifying
        nprobe.  With ``ground_truth`` ([S, >=k] exact store rows for
        ``queries``, e.g. calibration.exact_ground_truth over the original
        f32 corpus) the curve is in exact mode (absolute recall, targets
        above the ceiling refused); otherwise in ceiling mode against the
        index's own deep probe (nprobe = min(n_cells, 512)).  ``queries``
        defaults to sampled live rows decoded from the codes."""
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
        """Smallest calibrated nprobe meeting the recall@k target under the
        curve's mode; lazily self-calibrates (ceiling mode) on first use per
        (k, metric)."""
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
               metric: str = "cosine", sprobe: int = 0,
               recall_target: Optional[float] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (distances [B, k], store rows [B, k]; -1 = no hit).
        ``recall_target`` overrides ``nprobe`` with the smallest calibrated
        value meeting the target (see calibrate_nprobe)."""
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
        # spilled layouts: over-fetch, then dedup duplicate rows per query
        k_eff = min(2 * k, self.n_cells * self.cell_cap) if self.spilled else k
        dists, dev_rows = multiprobe_topk(
            self.codes, self.scales, self.norms, self.valid, self.centroids,
            torch.as_tensor(q, device=self.device), metric=metric, k=k_eff,
            nprobe=min(nprobe, self.n_cells), cell_cap=self.cell_cap,
            centroids_route=self.cents_route, cn2=self.cn2,
            super_route=self.super_route, child_cap=self.child_cap,
            sprobe=sprobe)
        if self.row_map_dev is not None:
            dev_rows = self.row_map_dev[torch.clamp(
                dev_rows.long(), 0, self.row_map_dev.shape[0] - 1)]
        dists = dists.cpu().numpy()
        raw_rows = dev_rows.cpu().numpy().astype(np.int64)
        store_rows = (raw_rows if self.row_map_dev is not None
                      else self.row_map[raw_rows])
        store_rows = np.where(np.isfinite(dists), store_rows, -1)
        if k_eff > k:
            dists, store_rows = dedup_rows_topk(dists, store_rows, k)
        return dists, store_rows

    # ------------------------------------------------------------------ misc

    def stats(self) -> dict:
        fill = (self.row_map >= 0).reshape(self.n_cells, self.cell_cap).sum(1)
        return {
            "kind": "cell_probe",
            "calibration": self._calib.summaries(),
            "hierarchical": self.super_route is not None,
            "supercells": (int(self.super_route.shape[0])
                           if self.super_route is not None else 0),
            "n_cells": self.n_cells,
            "cell_cap": self.cell_cap,
            "rows": int(fill.sum()),
            "min_cell": int(fill.min()),
            "max_cell": int(fill.max()),
            "memory_bytes": int(self.codes.numel() + self.scales.numel() * 4
                                + self.norms.numel() * 4
                                + self.centroids.numel() * 4),
        }

    def to_arrays(self) -> dict:
        out = {
            "centroids": self.centroids.cpu().numpy(),
            "codes": self.codes.cpu().numpy(),
            "scales": self.scales.cpu().numpy(),
            "norms": self.norms.cpu().numpy(),
            "row_map": self.row_map,
            "cell_cap": np.asarray(self.cell_cap),
        }
        if self.spilled:
            out["spilled"] = np.asarray(1)
        if self.super_route is not None:
            out["super_cents"] = self.super_route.float().cpu().numpy()
            out["child_cap"] = np.asarray(self.child_cap)
        if self._calib:
            out["calibrations"] = np.asarray(self._calib.to_json())
            self._calib.mark_clean()
        return out

    @classmethod
    def from_arrays(cls, d: dict, device=None) -> "CellProbeIndex":
        """An index from ``to_arrays`` of this package or the JAX one."""
        row_map = np.asarray(d["row_map"])
        idx = cls(d["centroids"], d["codes"], d["scales"], d["norms"],
                  row_map >= 0, row_map, int(d["cell_cap"]),
                  super_cents=d.get("super_cents"),
                  child_cap=int(d["child_cap"]) if "child_cap" in d else 0,
                  device=device)
        idx.spilled = bool(int(d.get("spilled", 0)))
        if "calibrations" in d:
            idx._calib = CalibrationSet.from_json(
                np.asarray(d["calibrations"]).item())
            idx._calib.mark_clean()
        elif "curve_nprobe" in d:  # older single un-keyed curve
            idx._calib = CalibrationSet.from_legacy({
                int(p): float(r)
                for p, r in zip(np.asarray(d["curve_nprobe"]),
                                np.asarray(d["curve_recall"]))})
            idx._calib.mark_clean()
        return idx
