"""PCA dimensionality reduction, trained on the device.

Counterpart of ``erlvectordb_tpu/quant/pca.py``: an orthogonal projection
trained from data (eigendecomposition of the covariance), with
``transform``/``inverse_transform``, and the data-free truncate-to-half
fallback of single-vector calls.  Eigenvector signs are free, so components
may differ from the JAX package's by sign; reconstructions agree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from erlvectordb_tpu_torch.ops.fused_topk import full_f32_matmul
from erlvectordb_tpu_torch.quant.pq import _as_f32, _device_of


def pca_fit(x: torch.Tensor, *, n_components: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, D] f32 -> (mean [D], components [n_components, D])."""
    x = x.to(torch.float32)
    mean = torch.mean(x, dim=0)
    xc = x - mean[None, :]
    with full_f32_matmul():
        cov = (xc.T @ xc) / max(x.shape[0] - 1, 1)
    _eigvals, eigvecs = torch.linalg.eigh(cov)  # ascending
    comps = torch.flip(eigvecs, dims=(1,))[:, :n_components].T.contiguous()
    return mean, comps


class PCAModel:
    """Trained PCA projection with transform / inverse_transform."""

    def __init__(self, mean, components, device=None):
        dev = _device_of(components, device)
        self.mean = _as_f32(mean, dev)
        self.components = _as_f32(components, dev)

    @classmethod
    def fit(cls, data, n_components: int, device=None) -> "PCAModel":
        dev = _device_of(data, device)
        mean, comps = pca_fit(_as_f32(data, dev), n_components=n_components)
        return cls(mean, comps)

    @property
    def device(self) -> torch.device:
        return self.components.device

    @property
    def n_components(self) -> int:
        return self.components.shape[0]

    @property
    def dim(self) -> int:
        return self.components.shape[1]

    def transform(self, x) -> torch.Tensor:
        with full_f32_matmul():
            return (_as_f32(x, self.device) - self.mean) @ self.components.T

    def inverse_transform(self, z) -> torch.Tensor:
        with full_f32_matmul():
            return _as_f32(z, self.device) @ self.components + self.mean

    def to_arrays(self) -> dict:
        return {"mean": self.mean.cpu().numpy(),
                "components": self.components.cpu().numpy()}

    @classmethod
    def from_arrays(cls, d: dict, device=None) -> "PCAModel":
        """A model from ``to_arrays`` of this package or the JAX one."""
        return cls(np.asarray(d["mean"], np.float32),
                   np.asarray(d["components"], np.float32),
                   device=_device_of(None, device))


def truncate_project(x: torch.Tensor,
                     n_components: Optional[int] = None) -> torch.Tensor:
    """Data-free fallback: keep the first half of the coordinates."""
    n = n_components or max(1, x.shape[-1] // 2)
    return x[..., :n]


def truncate_restore(z: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.nn.functional.pad(z.to(torch.float32),
                                   (0, dim - z.shape[-1]))
