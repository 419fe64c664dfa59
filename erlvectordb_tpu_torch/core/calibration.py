"""Recall calibration for the ``recall_target`` SLA knob.

Counterpart of ``erlvectordb_tpu/core/calibration.py``, with the same curve
semantics and the same JSON, so a curve saved by either package loads in the
other.  A calibration curve maps ``nprobe -> measured recall@k`` so a search
can take ``recall_target=`` instead of a raw probe width.  Two modes:

  * ``"exact"``   — recall measured against exact float32 ground truth
                    (one streaming scan, :func:`exact_ground_truth`).  The
                    curve's values are absolute recall@k; the deep probe's
                    value is the layout's quantization ceiling, and a target
                    above it raises :class:`RecallUnachievable`.
  * ``"ceiling"`` — recall measured against the layout's own deep probe
                    (nprobe = min(n_cells, 512)), whose recall is 1.0 by
                    construction: cheap, but the quantization loss is
                    invisible to it.

Curves are keyed by ``(k, metric)``, and lazy first-use calibration is
serialized by a lock.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from erlvectordb_tpu_torch.ops.fused_topk import full_f32_matmul

NPROBE_GRID = (4, 8, 16, 32, 64, 128, 256, 512)


class RecallUnachievable(ValueError):
    """recall_target above the calibrated maximum (exact-mode ceiling)."""


@dataclass
class CalibrationCurve:
    """One measured recall@k-vs-nprobe curve."""

    curve: Dict[int, float]     # nprobe -> recall@k
    mode: str                   # "exact" | "ceiling"
    ceiling: float              # deep-probe recall (1.0 in ceiling mode)
    k: int
    metric: str
    n_queries: int = 0

    def nprobe_for(self, target: float, clamp: bool = False) -> int:
        """Smallest nprobe whose measured recall@k meets ``target``.
        Targets above the curve's best raise :class:`RecallUnachievable`
        (``clamp=True`` returns the deepest calibrated nprobe instead)."""
        if not (0.0 < target <= 1.0):
            raise ValueError("recall_target must be in (0, 1]")
        best = max(self.curve.values())
        if target > best + 1e-9:
            if clamp:
                return min(p for p, r in self.curve.items() if r >= best)
            raise RecallUnachievable(
                f"recall_target {target:g} exceeds the calibrated maximum "
                f"{best:.4f} (mode={self.mode!r}"
                + (f": quantization ceiling {self.ceiling:.4f} vs exact "
                   "float32 ground truth" if self.mode == "exact" else "")
                + f", k={self.k}, metric={self.metric!r}). Lower the "
                "target, or pass an explicit nprobe for best-effort.")
        for nprobe in sorted(self.curve):
            if self.curve[nprobe] >= target:
                return nprobe
        return max(self.curve)  # unreachable given the best check above

    def summary(self) -> dict:
        return {
            "mode": self.mode,
            "ceiling": round(float(self.ceiling), 4),
            "k": self.k,
            "metric": self.metric,
            "n_queries": self.n_queries,
        }

    def to_dict(self) -> dict:
        d = self.summary()
        d["ceiling"] = float(self.ceiling)  # full precision (summary rounds)
        d["curve"] = {str(p): float(r) for p, r in sorted(self.curve.items())}
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationCurve":
        return cls(
            curve={int(p): float(r) for p, r in d["curve"].items()},
            mode=str(d.get("mode", "ceiling")),
            ceiling=float(d.get("ceiling", 1.0)),
            k=int(d.get("k", 10)),
            metric=str(d.get("metric", "cosine")),
            n_queries=int(d.get("n_queries", 0)),
        )


class CalibrationSet:
    """Thread-safe ``(k, metric) -> CalibrationCurve`` map.

    ``get_or_compute`` serializes lazy first-use calibration (one
    calibration, not one per concurrent request) and keys the result by the
    request's (k, metric).  ``dirty`` flags curves added since the last
    persistence write."""

    def __init__(self):
        self._curves: Dict[Tuple[int, str], CalibrationCurve] = {}
        # reentrant: get_or_compute's compute callback may itself put()
        self._lock = threading.RLock()
        self.dirty = False

    def __bool__(self) -> bool:
        return bool(self._curves)

    def __len__(self) -> int:
        return len(self._curves)

    def get(self, k: int, metric: str) -> Optional[CalibrationCurve]:
        return self._curves.get((int(k), str(metric)))

    def put(self, curve: CalibrationCurve) -> None:
        with self._lock:
            self._curves[(curve.k, curve.metric)] = curve
            self.dirty = True

    def get_or_compute(
        self, k: int, metric: str,
        compute: Callable[[], CalibrationCurve],
    ) -> CalibrationCurve:
        key = (int(k), str(metric))
        cur = self._curves.get(key)
        if cur is not None:
            return cur
        with self._lock:
            cur = self._curves.get(key)
            if cur is None:
                cur = compute()
                assert (cur.k, cur.metric) == key, "curve keyed wrong"
                self._curves[key] = cur
                self.dirty = True
            return cur

    def summaries(self) -> List[dict]:
        return [c.summary() for _, c in sorted(self._curves.items())]

    def to_json(self) -> str:
        return json.dumps([c.to_dict() for _, c in
                           sorted(self._curves.items())])

    def mark_clean(self) -> None:
        self.dirty = False

    @classmethod
    def from_json(cls, s: str) -> "CalibrationSet":
        out = cls()
        for d in json.loads(s):
            c = CalibrationCurve.from_dict(d)
            out._curves[(c.k, c.metric)] = c
        return out

    @classmethod
    def from_legacy(cls, curve: Dict[int, float], k: int = 10,
                    metric: str = "cosine") -> "CalibrationSet":
        """Adopt an older single un-keyed curve (always ceiling mode)."""
        out = cls()
        out._curves[(k, metric)] = CalibrationCurve(
            curve={int(p): float(r) for p, r in curve.items()},
            mode="ceiling", ceiling=1.0, k=k, metric=metric)
        return out


# --------------------------------------------------------------- measurement


def recall_vs(ref_rows, got_rows, k: int) -> float:
    """Mean recall@k of ``got`` against reference rows (-1 = empty slot)."""
    hits = 0
    total = 0
    for i in range(len(ref_rows)):
        ref = [int(x) for x in np.asarray(ref_rows[i][:k]).tolist()
               if int(x) >= 0]
        got = set(int(x) for x in np.asarray(got_rows[i][:k]).tolist())
        hits += len(set(ref) & got)
        total += len(ref)
    return hits / max(total, 1)


def measure_curve(
    search_rows: Callable[[np.ndarray, int, int], np.ndarray],
    queries: np.ndarray,
    *,
    k: int,
    metric: str,
    deep: int,
    grid: Tuple[int, ...] = NPROBE_GRID,
    ground_truth: Optional[np.ndarray] = None,
) -> CalibrationCurve:
    """Measure one curve.  ``search_rows(queries, k, nprobe)`` returns the
    layout's result rows [S, k]; ``ground_truth`` rows [S, >=k] (from
    :func:`exact_ground_truth`) switch the curve to exact mode."""
    queries = np.asarray(queries, np.float32)
    if queries.ndim != 2 or queries.shape[0] == 0:
        raise ValueError("calibration needs a non-empty [S, D] query batch")
    deep_rows = search_rows(queries, k, deep)
    if ground_truth is not None:
        if len(ground_truth) != len(queries):
            raise ValueError("ground_truth/queries length mismatch")
        ref = np.asarray(ground_truth)[:, :k]
        ceiling = recall_vs(ref, deep_rows, k)
        mode = "exact"
    else:
        ref = deep_rows
        ceiling = 1.0
        mode = "ceiling"
    curve = {}
    for nprobe in [p for p in grid if p < deep]:
        got = search_rows(queries, k, nprobe)
        curve[nprobe] = round(recall_vs(ref, got, k), 4)
    curve[deep] = round(ceiling, 4)
    return CalibrationCurve(curve=curve, mode=mode, ceiling=ceiling, k=k,
                            metric=metric, n_queries=len(queries))


# ----------------------------------------------------------- exact GT scan

_GT_CHUNK = 262_144


def _gt_fold(block, qs, qn, best_s, best_r, row0, *, metric, k):
    """Fold one [C, D] f32 chunk into the running exact top-k."""
    with full_f32_matmul():
        dots = qs @ block.T
    if metric == "cosine":
        bn = torch.sqrt(torch.sum(block * block, dim=1))
        denom = qn[:, None] * bn[None, :]
        # zero-norm => similarity 0 (store semantics)
        sc = torch.where(denom > 0,
                         dots / torch.where(denom > 0, denom,
                                            torch.ones_like(denom)),
                         torch.zeros_like(dots))
    elif metric == "euclidean":
        # rank-equivalent to -|q - x|^2 (up to the per-query |q|^2)
        sc = 2.0 * dots - torch.sum(block * block, dim=1)[None, :]
    else:  # dot
        sc = dots
    kk = min(k, sc.shape[1])
    s, idx = torch.topk(sc, kk, dim=1)
    cat_s = torch.cat([best_s, s], dim=1)
    cat_r = torch.cat([best_r, idx + row0], dim=1)
    s, sel = torch.topk(cat_s, k, dim=1)
    return s, torch.gather(cat_r, 1, sel)


def exact_ground_truth(data, queries, k: int = 10, metric: str = "cosine",
                       rows: Optional[np.ndarray] = None,
                       chunk: int = _GT_CHUNK, device=None) -> np.ndarray:
    """Exact float32 brute-force top-k row ids: the ground truth of
    exact-mode calibration.  ``data`` is a [N, D] array or tensor, or an
    iterable of [n_i, D] f32 chunks (arrays or tensors; position = implicit
    row 0..N-1); ``rows`` maps positions to store rows.  One streaming scan
    on ``device`` (default: the CUDA card) in full f32 products, O(S·k)
    state.  Returns [S, k] int64 rows (-1 where the corpus is smaller than
    k)."""
    from erlvectordb_tpu_torch.core.store import default_device

    if metric not in ("cosine", "euclidean", "dot"):
        raise ValueError("exact_ground_truth supports cosine/euclidean/dot")
    dev = torch.device(device) if device is not None else default_device()
    q = np.asarray(queries, np.float32)
    if q.ndim == 1:
        q = q[None, :]
    s = q.shape[0]
    if hasattr(data, "shape") and not hasattr(data, "__next__"):
        chunks = (data[i:i + chunk] for i in range(0, data.shape[0], chunk))
    else:
        chunks = iter(data)

    qs = qn = best_s = best_r = None
    row0 = 0
    for blk in chunks:
        blk = torch.as_tensor(blk, dtype=torch.float32, device=dev)
        n_i, d = blk.shape
        if qs is None:
            if q.shape[1] != d:
                qp = np.zeros((s, d), np.float32)
                qp[:, : min(q.shape[1], d)] = q[:, :d]
                q = qp
            qs = torch.as_tensor(q, device=dev)
            qn = torch.sqrt(torch.sum(qs * qs, dim=1))
            best_s = torch.full((s, k), float("-inf"), device=dev)
            best_r = torch.full((s, k), -1, dtype=torch.int64, device=dev)
        best_s, best_r = _gt_fold(blk, qs, qn, best_s, best_r, row0,
                                  metric=metric, k=k)
        row0 += n_i
    if best_r is None:
        raise ValueError("empty corpus")
    out = best_r.cpu().numpy()
    out[~np.isfinite(best_s.cpu().numpy())] = -1
    if rows is not None:
        rows = np.asarray(rows)
        out = np.where(out >= 0, rows[np.clip(out, 0, len(rows) - 1)], -1)
    return out
