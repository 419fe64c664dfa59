"""Whether what the clients received is correct.

Every distinct answer the window's clients received (read by the traffic's
request kind, ``requests/<kind>.py``, whose ``ANSWERS`` names the kind of
answer below and the configuration's table of limits) (an answer is the hits
of one query; repeats of an identical answer are compared once) is held
against the plain reference of ``reference/exact.py``, worked out from the
corpus and queries the benchmark drew, never from the program's state:

  * ``store`` answers (a vector store's exact search, int8 here): the
    reference is the exact search of the quantized store.  ``dist_err`` is
    the widest gap between a served distance and the reference's distance
    of the same row; ``topk_gap`` the widest amount by which the worst
    served row's reference distance exceeds the reference's k-th best, so a
    near neighbour left out shows;
  * ``index`` answers (a sub-linear index, approximate by design): the
    reference is the exact float search of the corpus.  ``dist_err`` as
    above, against the float distance; ``recall_at_10`` the mean share of
    each query's exact top-10 among its served rows.

``missing`` counts requests of the window never answered, ``malformed``
answers with another number of hits than k, a repeated or unknown row, or
distances out of order.  Each number has its limit in the configuration's
``correct`` table; ``missing`` and ``malformed`` have the limit 0.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from evdb_bench.reference.exact import Exact

ORDER_SLACK = 1e-6   # served distances may step back by float rounding only


def _well_formed(ids: np.ndarray, dists: np.ndarray, k: int, n: int) -> bool:
    return (ids.shape == (k,) and dists.shape == (k,)
            and np.all(ids >= 0) and np.all(ids < n)
            and np.unique(ids).size == k
            and np.all(np.isfinite(dists))
            and np.all(np.diff(dists) >= -ORDER_SLACK))


def numbers(kind: str, answers: List[Tuple[int, np.ndarray, np.ndarray]],
            queries: torch.Tensor, data: torch.Tensor, k: int,
            bits: Optional[int]) -> Dict[str, float]:
    """The compared numbers of ``answers`` [(query index, row ids, served
    distances)].  ``bits`` is the store's precision (8 for int8; None for a
    float store, whose reference is the exact float search)."""
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
    ref = Exact(data, None if kind == "index" else bits)
    q = queries[qidx.to(queries.device)]
    ref_of_served = ref.dist_of(q, ids).cpu()
    out["dist_err"] = float((served - ref_of_served).abs().max())
    # the exact top-k of each distinct query once
    uq, inv = torch.unique(qidx, return_inverse=True)
    kth, top = ref.topk(queries[uq.to(queries.device)], k)
    if kind == "index":
        top = top.cpu()[inv]
        hit = (ids[:, :, None] == top[:, None, :]).any(dim=2).sum(dim=1)
        out["recall_at_10"] = float(hit.double().mean() / k)
    else:
        top = top.cpu()[inv]
        hit = (ids[:, :, None] == top[:, None, :]).any(dim=2).sum(dim=1)
        out["miss_at_10"] = float(1.0 - hit.double().mean() / k)
        kth = kth[:, -1].cpu()[inv]
        out["topk_gap"] = float(torch.clamp(
            ref_of_served.max(dim=1).values - kth, min=0).max())
    return out


def verdict(values: Dict[str, float], limits: Dict[str, dict]
            ) -> Tuple[bool, List[Tuple[str, float, str, float]]]:
    """(correct, [(name, value, "<=" or ">=", limit)]).  A number without a
    reading (no well-formed answer) fails its limit."""
    rows = [("missing", values.get("missing", 0.0), "<=", 0.0),
            ("malformed", values.get("malformed", 0.0), "<=", 0.0)]
    for name, lim in limits.items():
        op = ">=" if "min" in lim else "<="
        rows.append((name, values.get(name, float("nan")), op,
                     float(lim["min"] if "min" in lim else lim["max"])))
    ok = all((v >= lim) if op == ">=" else (v <= lim)
             for _, v, op, lim in rows)
    return ok, rows
