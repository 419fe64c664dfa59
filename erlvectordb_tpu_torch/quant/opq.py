"""OPQ — product quantization with a learned orthogonal rotation.

Counterpart of ``erlvectordb_tpu/quant/opq.py``.  Training alternates:

  1. Y = X @ R;  (re)train PQ codebooks on Y          (ops/kmeans.py)
  2. Y_hat = decode(encode(Y))
  3. R <- argmin_R ||X R - Y_hat||_F  s.t. R orthogonal
         = U V^T from the SVD of X^T Y_hat            (orthogonal Procrustes)

``U V^T`` is unique for a nonsingular X^T Y_hat, so ``torch.linalg.svd``
gives the JAX package's rotation up to float rounding whatever its signs.
Search-side everything reduces to "rotate the query, then do PQ".
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from erlvectordb_tpu_torch.ops.fused_topk import full_f32_matmul
from erlvectordb_tpu_torch.quant.pq import PQCodebook, _as_f32, _device_of


class OPQCodebook:
    """Rotation + PQ codebook pair."""

    def __init__(self, rotation, pq: PQCodebook):
        self.pq = pq
        self.rotation = _as_f32(rotation, pq.device)   # [D, D]

    @classmethod
    def fit(
        cls,
        data,
        m: int = 8,
        k: int = 256,
        iters: int = 15,
        opq_iters: int = 5,
        seed: int = 0,
        max_train: int = 100_000,
        refine_iters: int = 4,
        device=None,
    ) -> "OPQCodebook":
        """Alternating OPQ fit on ``device`` (default: the tensor's own, else
        the CUDA card).  Only the first round trains codebooks from scratch
        (``iters`` Lloyd steps); later rounds warm-start from the previous
        round's codebooks and refine for ``refine_iters`` steps."""
        dev = _device_of(data, device)
        x = _as_f32(data, dev)
        if x.shape[0] > max_train:
            idx = np.random.default_rng(seed).choice(x.shape[0], max_train,
                                                     replace=False)
            x = x[torch.as_tensor(idx, device=dev)]
        d = x.shape[1]
        r = torch.eye(d, dtype=torch.float32, device=dev)
        pq: Optional[PQCodebook] = None
        with full_f32_matmul():
            for it in range(opq_iters):
                y = x @ r
                if pq is None:
                    pq = PQCodebook.fit(y, m=m, k=k, iters=iters,
                                        seed=seed + it, max_train=max_train)
                else:
                    pq = PQCodebook.fit(y, m=m, k=k, iters=refine_iters,
                                        max_train=max_train,
                                        init_codebooks=pq.codebooks)
                y_hat = pq.decode(pq.encode(y))
                # orthogonal Procrustes: R = U V^T of X^T Y_hat
                u, _, vt = torch.linalg.svd(x.T @ y_hat, full_matrices=False)
                r = u @ vt
            # final codebook refinement for the final rotation
            y = x @ r
        pq = PQCodebook.fit(y, m=m, k=k, iters=refine_iters,
                            max_train=max_train,
                            init_codebooks=pq.codebooks if pq else None)
        return cls(r, pq)

    # ----------------------------------------------------------- delegation

    @property
    def device(self) -> torch.device:
        return self.pq.device

    @property
    def m(self) -> int:
        return self.pq.m

    @property
    def k(self) -> int:
        return self.pq.k

    @property
    def dim(self) -> int:
        return self.rotation.shape[0]

    @property
    def codebooks(self) -> torch.Tensor:
        return self.pq.codebooks

    def rotate(self, x) -> torch.Tensor:
        with full_f32_matmul():
            return _as_f32(x, self.device) @ self.rotation

    def encode(self, x) -> torch.Tensor:
        return self.pq.encode(self.rotate(x))

    def decode(self, codes) -> torch.Tensor:
        with full_f32_matmul():
            return self.pq.decode(codes) @ self.rotation.T

    def adc_tables(self, queries, metric: str = "euclidean") -> torch.Tensor:
        """The rotation is orthogonal, so L2 in rotated space equals L2 in
        the original space: rotate the query and reuse the PQ tables."""
        q = _as_f32(queries, self.device)
        if q.ndim == 1:
            q = q[None, :]
        return self.pq.adc_tables(self.rotate(q), metric=metric)

    def reconstruction_mse(self, x) -> float:
        x = _as_f32(x, self.device)
        return float(torch.mean((self.decode(self.encode(x)) - x) ** 2))

    def to_arrays(self) -> dict:
        return {
            "rotation": self.rotation.cpu().numpy(),
            "codebooks": self.pq.codebooks.cpu().numpy(),
        }

    @classmethod
    def from_arrays(cls, d: dict, device=None) -> "OPQCodebook":
        """A codebook from ``to_arrays`` of this package or the JAX one."""
        return cls(np.asarray(d["rotation"], np.float32),
                   PQCodebook.from_arrays(d, device=device))
