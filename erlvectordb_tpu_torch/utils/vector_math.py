"""Vector math primitives (the reference's L0 layer), as torch functions.

Counterpart of ``erlvectordb_tpu/utils/vector_math.py``: the same nine
operations, batched over leading dimensions.  Semantics preserved:

  * ``cosine_similarity`` of a zero-norm vector is 0.0 (and the derived
    cosine *distance* is therefore 1.0);
  * distances are float32 scalars (0-d tensors) for 1-D inputs.
"""

from __future__ import annotations

import torch

__all__ = [
    "cosine_similarity",
    "cosine_distance",
    "euclidean_distance",
    "manhattan_distance",
    "dot_product",
    "normalize",
    "vector_norm",
    "vector_add",
    "vector_subtract",
    "vector_multiply",
]


def _as_f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32)


def dot_product(a, b) -> torch.Tensor:
    a, b = _as_f32(a), _as_f32(b)
    return torch.sum(a * b, dim=-1)


def vector_norm(a) -> torch.Tensor:
    a = _as_f32(a)
    return torch.sqrt(torch.sum(a * a, dim=-1))


def cosine_similarity(a, b) -> torch.Tensor:
    """Cosine similarity; 0.0 when either vector has zero norm."""
    a, b = _as_f32(a), _as_f32(b)
    denom = vector_norm(a) * vector_norm(b)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    return torch.where(denom > 0, dot_product(a, b) / safe,
                       torch.zeros_like(denom))


def cosine_distance(a, b) -> torch.Tensor:
    """1 - cosine_similarity; zero-norm input gives distance 1.0."""
    return 1.0 - cosine_similarity(a, b)


def euclidean_distance(a, b) -> torch.Tensor:
    a, b = _as_f32(a), _as_f32(b)
    d = a - b
    return torch.sqrt(torch.sum(d * d, dim=-1))


def manhattan_distance(a, b) -> torch.Tensor:
    a, b = _as_f32(a), _as_f32(b)
    return torch.sum(torch.abs(a - b), dim=-1)


def normalize(a) -> torch.Tensor:
    """Unit-normalize rows; a zero vector normalizes to itself (all zeros)."""
    a = _as_f32(a)
    n = torch.sqrt(torch.sum(a * a, dim=-1, keepdim=True))
    return torch.where(n > 0, a / torch.where(n > 0, n, torch.ones_like(n)), a)


def vector_add(a, b) -> torch.Tensor:
    return _as_f32(a) + _as_f32(b)


def vector_subtract(a, b) -> torch.Tensor:
    return _as_f32(a) - _as_f32(b)


def vector_multiply(a, scalar) -> torch.Tensor:
    return _as_f32(a) * float(scalar)
