"""ADC (asymmetric distance computation) search over PQ codes — the gather
path.

Counterpart of ``erlvectordb_tpu/ops/adc.py``: per-query lookup tables
LUT [B, M, K] of partial squared-L2 distances (quant/pq.py), then
``dist[b, n] = sum_m LUT[b, m, codes[n, m]]``, summed over m in order.
These are plain gathers and a top-k in the JAX package (XLA, no Pallas), so
they stay plain PyTorch here; the hand-written scans are in
ops/adc_pallas.py.

The JAX package's ``lax.approx_max_k`` is exact off the TPU, which is where
the two packages are compared, so every top-k here is exact: a stable sort,
which also keeps the lower row first among equal distances, as
``lax.top_k`` does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from erlvectordb_tpu_torch.ops.fused_topk import full_f32_matmul
from erlvectordb_tpu_torch.quant.pq import _adc_l2_tables


def topk_stable(x: torch.Tensor, k: int, largest: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties to the lower index (``lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=largest, stable=True)
    return vals[..., :k], idx[..., :k]


def adc_distances(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """codes [N, M] uint8, lut [B, M, K] -> [B, N] f32, the M lookups added
    in subspace order."""
    codes_i = codes.long()
    dists = torch.zeros((lut.shape[0], codes.shape[0]), dtype=torch.float32,
                        device=lut.device)
    for j in range(codes.shape[1]):
        dists = dists + lut[:, j, :][:, codes_i[:, j]]
    return dists


def adc_search_rerank(pq_codes, codebooks, i8_codes, i8_scales, queries, *,
                      k: int, c: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage search: ADC over PQ codes retrieves top-c candidates, an
    exact int8 distance pass re-ranks them.  Returns exact-L2 (distances
    [B, k], rows [B, k])."""
    coarse = adc_distances(pq_codes, _adc_l2_tables(queries, codebooks))
    _, cand = topk_stable(coarse, c, largest=False)            # [B, c]
    x = i8_codes[cand].float() * i8_scales[cand][:, :, None]
    with full_f32_matmul():
        dots = torch.einsum("bcd,bd->bc", x, queries)
    xn2 = torch.sum(x * x, dim=-1)
    qsq = torch.sum(queries * queries, dim=-1, keepdim=True)
    d2 = qsq - 2.0 * dots + xn2                                # [B, c]
    neg, sel = topk_stable(-d2, k)
    return (torch.sqrt(torch.clamp(-neg, min=0.0)),
            torch.gather(cand, 1, sel))


def adc_search_exact_topk(codes, codebooks, queries, *, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k by ADC distance (the index manager's pq/opq search):
    (squared-L2 ADC distances [B, k], rows [B, k])."""
    dists = adc_distances(codes, _adc_l2_tables(queries, codebooks))
    return topk_stable(dists, k, largest=False)


# the JAX package's adc_search differs only by its approx_max_k, which is
# exact off the TPU
adc_search = adc_search_exact_topk
