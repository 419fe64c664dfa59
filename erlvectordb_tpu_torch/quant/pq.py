"""Product quantization: trained codebooks, encode/decode and ADC tables.

Counterpart of ``erlvectordb_tpu/quant/pq.py``:

  * ``PQCodebook.fit``: M codebooks of K centroids, k-means on each D/M
    subspace (ops/kmeans.py) on the codebook's device;
  * ``encode``: the nearest centroid per subspace, uint8 codes [N, M]
    (K <= 256), one batched product per row chunk;
  * ``decode``: centroid gather -> reconstruction;
  * ``adc_tables``: per-query lookup tables LUT [B, M, K] of partial
    squared-L2 (or inner-product) distances, the input of the ADC scans
    (ops/adc.py, ops/adc_pallas.py).

The training subsample is drawn with ``np.random.default_rng(seed)``, as in
the JAX package, so both train on the same rows; the k-means seeding draws
from a ``torch.Generator`` and so differs from the JAX package's.  Every
product runs in full f32 (no TF32).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from erlvectordb_tpu_torch.ops.fused_topk import full_f32_matmul
from erlvectordb_tpu_torch.ops.kmeans import (
    kmeans_fit_subspaces,
    kmeans_refine_subspaces,
)

_ENCODE_BUDGET = 1 << 26  # cap on the [M, rows, K] f32 distances per chunk


def _device_of(data, device) -> torch.device:
    """The caller's device, else a tensor's own, else the CUDA card."""
    if device is not None:
        return torch.device(device)
    if isinstance(data, torch.Tensor):
        return data.device
    from erlvectordb_tpu_torch.core.store import default_device

    return default_device()


def _as_f32(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    a = np.asarray(x, np.float32)
    if not a.flags.writeable:  # torch warns on read-only host memory
        a = a.copy()
    return torch.as_tensor(a, device=device)


def _encode(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """x [N, D], codebooks [M, K, Dsub] -> codes uint8 [N, M]: per subspace
    the argmin of |c|^2 - 2 x.c (ties to the lower centroid)."""
    n = x.shape[0]
    m, k, dsub = codebooks.shape
    cn = torch.sum(codebooks * codebooks, dim=-1)               # [M, K]
    out = torch.empty((n, m), dtype=torch.uint8, device=x.device)
    chunk = max(1, _ENCODE_BUDGET // (m * k))
    with full_f32_matmul():
        for r0 in range(0, n, chunk):
            xs = x[r0:r0 + chunk].reshape(-1, m, dsub).transpose(0, 1)
            dots = torch.bmm(xs, codebooks.transpose(1, 2))     # [M, r, K]
            codes = torch.argmin(cn[:, None, :] - 2.0 * dots, dim=-1)
            out[r0:r0 + chunk] = codes.T.to(torch.uint8)
    return out


def _decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """codes [N, M] uint8, codebooks [M, K, Dsub] -> x_hat [N, D]."""
    m = codebooks.shape[0]
    idx = codes.long()
    return torch.cat([codebooks[j][idx[:, j]] for j in range(m)], dim=1)


def _adc_l2_tables(queries: torch.Tensor, codebooks: torch.Tensor
                   ) -> torch.Tensor:
    """queries [B, D], codebooks [M, K, Dsub] -> LUT [B, M, K] of squared-L2
    partial distances |q_m|^2 - 2 q_m.c_{m,k} + |c_{m,k}|^2."""
    b = queries.shape[0]
    m, _, dsub = codebooks.shape
    qs = queries.reshape(b, m, dsub)
    with full_f32_matmul():
        dots = torch.einsum("bmd,mkd->bmk", qs, codebooks)
    qn = torch.sum(qs * qs, dim=-1)
    cn = torch.sum(codebooks * codebooks, dim=-1)
    return qn[:, :, None] - 2.0 * dots + cn[None, :, :]


def _adc_ip_tables(queries: torch.Tensor, codebooks: torch.Tensor
                   ) -> torch.Tensor:
    """Inner-product partial tables q_m . c_{m,k} -> LUT [B, M, K]."""
    b = queries.shape[0]
    m, _, dsub = codebooks.shape
    with full_f32_matmul():
        return torch.einsum("bmd,mkd->bmk", queries.reshape(b, m, dsub),
                            codebooks)


class PQCodebook:
    """M x K product-quantization codebook over dimension D (D % M == 0)."""

    def __init__(self, codebooks, device=None):
        dev = _device_of(codebooks, device)
        self.codebooks = _as_f32(codebooks, dev)   # [M, K, Dsub]

    @property
    def device(self) -> torch.device:
        return self.codebooks.device

    @classmethod
    def fit(
        cls,
        data,
        m: int = 8,
        k: int = 256,
        iters: int = 25,
        seed: int = 0,
        max_train: int = 100_000,
        init_codebooks=None,
        device=None,
    ) -> "PQCodebook":
        """Train codebooks on ``device`` (default: the tensor's own, else the
        CUDA card); with ``init_codebooks`` the fit is a warm-started
        refinement (``iters`` Lloyd steps from the given centroids) — the
        OPQ alternation's inner retrain."""
        dev = _device_of(data, device)
        x = _as_f32(data, dev)
        if x.shape[1] % m:
            raise ValueError(f"dimension {x.shape[1]} not divisible by m={m}")
        if k > 256:
            raise ValueError("k > 256 does not fit uint8 codes")
        if x.shape[0] > max_train:
            idx = np.random.default_rng(seed).choice(x.shape[0], max_train,
                                                     replace=False)
            x = x[torch.as_tensor(idx, device=dev)]
        if init_codebooks is not None:
            cb = kmeans_refine_subspaces(x, _as_f32(init_codebooks, dev), m=m,
                                         k=k, iters=iters)
        else:
            cb = kmeans_fit_subspaces(x, seed, m=m, k=k, iters=iters)
        return cls(cb)

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def k(self) -> int:
        return self.codebooks.shape[1]

    @property
    def dim(self) -> int:
        return self.codebooks.shape[0] * self.codebooks.shape[2]

    def encode(self, x) -> torch.Tensor:
        return _encode(_as_f32(x, self.device), self.codebooks)

    def decode(self, codes) -> torch.Tensor:
        if not isinstance(codes, torch.Tensor):
            codes = torch.from_numpy(np.array(codes, np.uint8))
        return _decode(codes.to(self.device), self.codebooks)

    def adc_tables(self, queries, metric: str = "euclidean") -> torch.Tensor:
        q = _as_f32(queries, self.device)
        if q.ndim == 1:
            q = q[None, :]
        if metric in ("euclidean", "l2"):
            return _adc_l2_tables(q, self.codebooks)
        if metric in ("dot", "ip", "cosine"):
            # cosine rides inner-product tables + norm correction downstream
            return _adc_ip_tables(q, self.codebooks)
        raise ValueError(f"unsupported ADC metric {metric!r}")

    def to_arrays(self) -> dict:
        return {"codebooks": self.codebooks.cpu().numpy()}

    @classmethod
    def from_arrays(cls, d: dict, device=None) -> "PQCodebook":
        """A codebook from ``to_arrays`` of this package or the JAX one."""
        return cls(np.asarray(d["codebooks"], np.float32),
                   device=_device_of(None, device))
