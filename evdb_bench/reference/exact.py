"""Exact top-k by cosine distance, in plain PyTorch.

``Exact(data, bits)`` answers what a vector store of ``data`` answers:

  * ``bits=None``: the rows and queries as given (float32 data; the
    distances are taken in float64);
  * ``bits=8`` (an int8 store) or ``bits=4``: each row and each query
    quantized symmetrically by its own absolute maximum to the integers
    ``-L..L`` (L = 2**(bits-1) - 1; the scale is ``absmax * f32(1/L)``, codes
    ``round(x / scale)``), the integer dot product taken exactly, rescaled
    by both scales, and divided by the norms of the unquantized row and
    query.

The distance is ``1 - cos``.  Integer dots are taken as float32 products
of integer-valued tensors with TF32 off: every partial sum is an integer
below 2**24 (127**2 * 768 < 2**24), so they are exact in any order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

BLOCK = 256


def quantize(x: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(integer-valued float32 codes [n, d], float32 scales [n])."""
    levels = float(2 ** (bits - 1) - 1)
    absmax = x.abs().amax(dim=1)
    recip = torch.tensor(1.0 / levels, dtype=torch.float32, device=x.device)
    scale = torch.where(absmax > 0, absmax * recip, torch.ones_like(absmax))
    codes = torch.clamp(torch.round(x / scale[:, None]), -levels, levels)
    return codes, scale


class Exact:
    def __init__(self, data: torch.Tensor, bits: Optional[int] = None):
        self.bits = bits
        self.device = data.device
        self.norms = torch.linalg.vector_norm(data.double(), dim=1)
        if bits is None:
            self.rows, self.scales = data.float(), None
        else:
            self.rows, self.scales = quantize(data.float(), bits)

    def _queries(self, q: torch.Tensor):
        q = q.to(self.device, torch.float32)
        qn = torch.linalg.vector_norm(q.double(), dim=1)
        if self.bits is None:
            return q, None, qn
        codes, scale = quantize(q, self.bits)
        return codes, scale, qn

    def _cos_dist(self, dots, qs, xs, qn, xn):
        """1 - dots * qs * xs / (qn * xn), float64; zero norms give 1."""
        dots = dots.double()
        if qs is not None:
            dots = dots * qs.double()[:, None] * xs.double()
        denom = qn[:, None] * xn
        sim = torch.where(denom > 0, dots / torch.where(denom > 0, denom, 1.0),
                          torch.zeros_like(dots))
        return 1.0 - sim

    def _dots(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            if self.bits is None:
                return a.double() @ b.double().T
            return a @ b.T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old

    def topk(self, queries: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(distances [Q, k] float64 ascending, row ids [Q, k] int64)."""
        qc, qs, qn = self._queries(queries)
        out_d, out_i = [], []
        for b0 in range(0, qc.shape[0], BLOCK):
            b1 = min(b0 + BLOCK, qc.shape[0])
            d = self._cos_dist(self._dots(qc[b0:b1], self.rows),
                               None if qs is None else qs[b0:b1],
                               self.scales, qn[b0:b1], self.norms)
            dist, ids = torch.topk(d, k, dim=1, largest=False)
            out_d.append(dist)
            out_i.append(ids)
        return torch.cat(out_d), torch.cat(out_i)

    def dist_of(self, queries: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Distances [Q, k] float64 of the rows ``ids`` [Q, k] to each query."""
        qc, qs, qn = self._queries(queries)
        ids = ids.to(self.device)
        rows = self.rows[ids]                                   # [Q, k, d]
        if self.bits is None:
            dots = torch.einsum("qkd,qd->qk", rows.double(), qc.double())
        else:
            dots = torch.einsum("qkd,qd->qk", rows, qc)         # exact ints
        dots = dots.double()
        if qs is not None:
            dots = dots * qs.double()[:, None] * self.scales[ids].double()
        denom = qn[:, None] * self.norms[ids]
        sim = torch.where(denom > 0, dots / torch.where(denom > 0, denom, 1.0),
                          torch.zeros_like(dots))
        return 1.0 - sim
