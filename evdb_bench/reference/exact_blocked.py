"""Exact top-k by cosine distance over blocks of rows, in plain PyTorch.

``ExactBlocked(data, bits)`` answers what ``Exact(data, bits)``
(``reference/exact.py``) answers, with the device memory of the corpus
plus one block: ``Exact`` quantizes the whole corpus at once and takes its
norms over a float64 copy of it, at 10M x 768 a 30.7 GB float32 copy and
a 61 GB float64 one beside the 30.7 GB corpus.
Here each block of ``block`` rows is an ``Exact`` of its own.  Its rows
are quantized each on its own and its norms taken row by row, as ``Exact``
does for the whole corpus.  Its distances to the queries are sorted
stably, so ties go to the lower row.  Each block's best k, with global
row ids, are merged with the best so far, in order of (distance, row).
The result is ``torch.topk``'s over the whole matrix: the same distances,
and among rows tied at the k-th distance the lower rows.

``numbers`` computes ``judge.numbers``' quantities, under the same names,
with this reference in ``Exact``'s place.  Every product runs with TF32
off.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from evdb_bench.corpus import exact_f32
from evdb_bench.judge import _well_formed
from evdb_bench.reference.exact import BLOCK, Exact

BLOCK_ROWS = 1 << 18


class ExactBlocked:
    def __init__(self, data: torch.Tensor, bits: Optional[int] = None,
                 block: int = BLOCK_ROWS):
        self.data, self.bits, self.block = data, bits, int(block)

    def _block_topk(self, ref: Exact, qc, qs, qn, k: int):
        """The block's best k of each query in order of (distance, row)."""
        out_d, out_i = [], []
        for b0 in range(0, qc.shape[0], BLOCK):
            b1 = min(b0 + BLOCK, qc.shape[0])
            d = ref._cos_dist(ref._dots(qc[b0:b1], ref.rows),
                              None if qs is None else qs[b0:b1],
                              ref.scales, qn[b0:b1], ref.norms)
            dist, ids = torch.sort(d, dim=1, stable=True)
            out_d.append(dist[:, :k])
            out_i.append(ids[:, :k])
        return torch.cat(out_d), torch.cat(out_i)

    def topk(self, queries: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(distances [Q, k] float64 ascending, row ids [Q, k] int64)."""
        with exact_f32():
            return self._topk(queries, k)

    def _topk(self, queries, k):
        n = self.data.shape[0]
        best_d = best_i = None
        for r0 in range(0, n, self.block):
            ref = Exact(self.data[r0:r0 + self.block], self.bits)
            qc, qs, qn = ref._queries(queries)
            d, i = self._block_topk(ref, qc, qs, qn, k)
            i = i + r0
            if best_d is not None:
                # earlier blocks hold lower rows: a stable sort by distance
                # of [best so far, this block] keeps ties in row order
                d, i = torch.cat([best_d, d], 1), torch.cat([best_i, i], 1)
                d, order = torch.sort(d, dim=1, stable=True)
                i = torch.gather(i, 1, order)
            best_d, best_i = d[:, :k], i[:, :k]
            del ref
        return best_d, best_i

    def dist_of(self, queries: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Distances [Q, k] float64 of the rows ``ids`` [Q, k] to each query:
        ``Exact.dist_of`` on the rows named alone, each quantized on its
        own as in the whole corpus."""
        ids = ids.to(self.data.device)
        ref = Exact(self.data[ids.reshape(-1)], self.bits)
        local = torch.arange(ids.numel(), device=ids.device).reshape(ids.shape)
        with exact_f32():
            return ref.dist_of(queries, local)


def numbers(kind: str, answers: List[Tuple[int, np.ndarray, np.ndarray]],
            queries: torch.Tensor, data: torch.Tensor, k: int,
            bits: Optional[int], block: int = BLOCK_ROWS) -> Dict[str, float]:
    """``judge.numbers(kind, answers, queries, data, k, bits)`` with the
    blocked reference: the same numbers under the same names."""
    n = data.shape[0]
    good = [(qi, ids, d) for qi, ids, d in answers
            if _well_formed(ids, d, k, n)]
    out = {"answers": float(len(answers)),
           "malformed": float(len(answers) - len(good))}
    if not good:
        return out
    qidx = torch.tensor([qi for qi, _, _ in good], dtype=torch.long)
    ids = torch.tensor(np.stack([a for _, a, _ in good]), dtype=torch.long)
    served = torch.tensor(np.stack([d for _, _, d in good]),
                          dtype=torch.float64)
    ref = ExactBlocked(data, None if kind == "index" else bits, block)
    q = queries[qidx.to(queries.device)]
    ref_of_served = ref.dist_of(q, ids).cpu()
    out["dist_err"] = float((served - ref_of_served).abs().max())
    # the exact top-k of each distinct query once
    uq, inv = torch.unique(qidx, return_inverse=True)
    kth, top = ref.topk(queries[uq.to(queries.device)], k)
    top = top.cpu()[inv]
    hit = (ids[:, :, None] == top[:, None, :]).any(dim=2).sum(dim=1)
    if kind == "index":
        out["recall_at_10"] = float(hit.double().mean() / k)
    else:
        out["miss_at_10"] = float(1.0 - hit.double().mean() / k)
        kth = kth[:, -1].cpu()[inv]
        out["topk_gap"] = float(torch.clamp(
            ref_of_served.max(dim=1).values - kth, min=0).max())
    return out
