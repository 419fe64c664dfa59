"""Batched exact-scan distance + top-k for f32, int8, int4 and int4r rows.

Counterpart of ``erlvectordb_tpu/core/search.py``.  These are the store's
path below the fused-kernel gate (small stores, manhattan, CPU tensors) and
the oracle the fused kernels are held against:

  * cosine / dot:   one ``Q @ X^T`` product, scaled by precomputed row norms;
  * euclidean:      the ``|x|^2 - 2 q.x + |q|^2`` expansion;
  * manhattan:      ``torch.cdist(p=1)`` (no matmul form exists);
  * int8 rows:      the query is quantized symmetrically and the int8 x int8
                    dot is taken exactly (in float64), then rescaled;
  * int4 rows:      packed nibbles unpacked to int8, then as int8 rows;
  * int4r rows:     the int4 residual dot plus the row's cell-centroid dot.

followed by ``torch.topk`` over masked distances.  ``k`` is bucketed to the
next power of two, as in the JAX package, so that the candidate depth of
every path matches the reference's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from erlvectordb_tpu_torch.ops.fused_topk import (  # noqa: F401 (re-export)
    div_scalar,
    full_f32_matmul,
    mul_recip,
    unpack_int4,
)

Metric = str  # "cosine" | "euclidean" | "manhattan" | "dot"

VALID_METRICS = ("cosine", "euclidean", "manhattan", "dot")


def k_bucket(k: int, n_cap: int) -> int:
    """Round k up to a power of two (capped at capacity)."""
    if k >= n_cap:
        return n_cap
    b = 1
    while b < k:
        b *= 2
    return min(b, n_cap)


def _from_dots(dots, norms, queries, metric):
    if metric == "dot":
        return -dots
    if metric == "cosine":
        qn = torch.sqrt(torch.sum(queries * queries, dim=-1))
        denom = qn[:, None] * norms[None, :]
        safe = torch.where(denom > 0, denom, torch.ones_like(denom))
        sim = torch.where(denom > 0, dots / safe, torch.zeros_like(denom))
        # zero-norm rows/queries: similarity 0 -> distance 1.0
        return 1.0 - sim
    if metric == "euclidean":
        qsq = torch.sum(queries * queries, dim=-1)
        d2 = qsq[:, None] - 2.0 * dots + (norms * norms)[None, :]
        return torch.sqrt(torch.clamp(d2, min=0.0))
    raise ValueError(f"unknown metric {metric!r}")


def pairwise_distances(
    vectors: torch.Tensor,   # [N, D] f32
    norms: torch.Tensor,     # [N]    f32 precomputed L2 norms of rows
    queries: torch.Tensor,   # [B, D] f32
    metric: Metric,
) -> torch.Tensor:           # [B, N] f32 distances (smaller = closer)
    if metric == "manhattan":
        return torch.cdist(queries, vectors, p=1.0)
    with full_f32_matmul():
        dots = queries @ vectors.T
    return _from_dots(dots, norms, queries, metric)


def _topk_smallest(dists, valid, k):
    dists = torch.where(valid[None, :], dists,
                        torch.full_like(dists, float("inf")))
    neg, rows = torch.topk(-dists, k, dim=1)
    return -neg, rows.to(torch.int32)


def exact_topk(vectors, norms, valid, queries, *, metric: Metric, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k nearest rows: (distances [B, k], rows [B, k] int32).
    Invalid rows surface as +inf; the host trims them."""
    return _topk_smallest(pairwise_distances(vectors, norms, queries, metric),
                          valid, k)


def _quantize_queries(queries):
    """Symmetric per-query int8 codes (as f32 values) and scales [B, 1]."""
    q_absmax = queries.abs().amax(dim=-1, keepdim=True)
    q_scale = torch.where(q_absmax > 0, mul_recip(q_absmax, 127.0),
                          torch.ones_like(q_absmax))
    return torch.clamp(torch.round(queries / q_scale), -127, 127), q_scale


def int8_distances(
    codes: torch.Tensor,     # [N, D] int8 symmetric-quantized rows
    scales: torch.Tensor,    # [N]    f32 per-row scale
    norms: torch.Tensor,     # [N]    f32 norms of the ORIGINAL f32 rows
    queries: torch.Tensor,   # [B, D] f32
    metric: Metric,
) -> torch.Tensor:           # [B, N] f32 distances (smaller = closer)
    """Distances against int8 rows in the quantized domain: exact int8 dots
    (taken in float64), rescaled by the per-query and per-row scales."""
    if metric == "manhattan":
        deq = codes.float() * scales[:, None]
        return torch.cdist(queries, deq, p=1.0)
    q_codes, q_scale = _quantize_queries(queries)
    idots = (q_codes.double() @ codes.double().T).float()
    dots = idots * q_scale * scales[None, :]
    return _from_dots(dots, norms, queries, metric)


def exact_topk_int8(codes, scales, norms, valid, queries, *, metric: Metric,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over an int8-quantized store, in the quantized domain."""
    return _topk_smallest(int8_distances(codes, scales, norms, queries, metric),
                          valid, k)


def exact_topk_int4(packed, scales, norms, valid, queries, *, metric: Metric,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a packed int4 store ([N, W/2] uint8, x ~= scale * code4):
    the nibbles unpack to int8 and the int8 scan answers."""
    return exact_topk_int8(unpack_int4(packed), scales, norms, valid, queries,
                           metric=metric, k=k)


def exact_topk_int4r(packed, scales, norms, valid, centroids, queries, *,
                     metric: Metric, k: int, cell_cap: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a cell-residual int4 store.  Row r's vector is
    ``centroids[r // cell_cap] + unpack(packed[r]) * scales[r]``, so the raw
    dot decomposes into the centroid table plus the quantized residual dot;
    ``norms`` are the rows' reconstruction norms."""
    codes = unpack_int4(packed)
    cells = torch.arange(packed.shape[0], device=packed.device) // cell_cap
    if metric == "manhattan":
        deq = centroids[cells] + codes.float() * scales[:, None]
        dists = torch.cdist(queries, deq, p=1.0)
    else:
        q_codes, q_scale = _quantize_queries(queries)
        rdots = ((q_codes.double() @ codes.double().T).float()
                 * q_scale * scales[None, :])
        with full_f32_matmul():
            table = queries @ centroids.T
        dists = _from_dots(rdots + table[:, cells], norms, queries, metric)
    return _topk_smallest(dists, valid, k)
