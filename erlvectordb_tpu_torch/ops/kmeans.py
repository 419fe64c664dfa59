"""Lloyd k-means — the cell trainer of the int4r store and the streaming
cell build, and the codebook trainer of product quantization.

Counterpart of ``erlvectordb_tpu/ops/kmeans.py`` (``kmeans_fit`` with random
and k-means++ seeding and the ``balance=`` price controller, and the
subspace variants ``kmeans_fit_subspaces``/``kmeans_refine_subspaces``,
where the JAX package vmaps over the M subspaces and this module loops).
The assignment step
is one ``X @ C^T`` product per row chunk and the update a segment sum
(``index_add_``).  Random draws come from a ``torch.Generator`` seeded with
``seed``: the same seed does not give the JAX package's draws, so its tests
hand both sides the same initial centroids.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from erlvectordb_tpu_torch.ops.fused_topk import full_f32_matmul

_ELEMS_BUDGET = 1 << 26  # cap on materialized [rows, K] f32 intermediates


def _assign(x: torch.Tensor, cents: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [N, D], cents [K, D] -> nearest-centroid index [N] (squared L2,
    up to the row-constant |x|^2).  ``bias`` [K] (balanced Lloyd) is added to
    each cluster's distances.  Rows run in chunks so the [N, K] distance
    matrix never materializes whole."""
    n, k = x.shape[0], cents.shape[0]
    cn = torch.sum(cents * cents, dim=-1)
    if bias is not None:
        cn = cn + bias
    chunk = n if n * k <= _ELEMS_BUDGET else max(1024, _ELEMS_BUDGET // k)
    out = torch.empty((n,), dtype=torch.int64, device=x.device)
    with full_f32_matmul():
        for r0 in range(0, n, chunk):
            dots = x[r0:r0 + chunk] @ cents.T
            out[r0:r0 + chunk] = torch.argmin(cn[None, :] - 2.0 * dots, dim=-1)
    return out


def _update(x: torch.Tensor, assign: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean per cluster (segment sums); returns (centroids, counts)."""
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=x.device)
    sums.index_add_(0, assign, x)
    counts = torch.zeros((k,), dtype=torch.float32, device=x.device)
    counts.index_add_(0, assign, torch.ones_like(assign, dtype=torch.float32))
    return sums / torch.clamp(counts, min=1.0)[:, None], counts


def _kpp_init(x: torch.Tensor, gen: torch.Generator, k: int) -> torch.Tensor:
    """k-means++ seeding: each next centroid drawn with probability
    proportional to its squared distance from the chosen set.

    Each draw is ``torch.multinomial(p, 1)``'s own computation (an
    exponential variate per row from ``gen``, then the argmax of p / e),
    kept on the device: multinomial checks its input with a host sync on
    every call, and the cell-probe build seeds up to ~175k centroids.  The
    same generator gives the same centroids as multinomial does."""
    n = x.shape[0]
    first = int(torch.randint(0, n, (1,), generator=gen, device=gen.device))
    cents = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    cents[0] = x[first]
    mind2 = torch.sum((x - x[first]) ** 2, dim=1)
    for i in range(1, k):
        w = torch.clamp(mind2, min=1e-20)
        p = w / w.sum()
        e = torch.empty_like(p).exponential_(1.0, generator=gen)
        pick = x.index_select(0, torch.argmax(p / e, dim=0, keepdim=True))
        cents[i:i + 1] = pick
        mind2 = torch.minimum(mind2, torch.sum((x - pick) ** 2, dim=1))
    return cents


def _reseed_candidates(x: torch.Tensor, d_to_own: torch.Tensor, k: int
                       ) -> torch.Tensor:
    """One farthest-ish point per contiguous N/k block (argmax per block);
    only empty clusters consume these."""
    n = x.shape[0]
    nb = -(-n // k)
    d = torch.nn.functional.pad(d_to_own, (0, nb * k - n), value=-1.0)
    idx = torch.argmax(d.reshape(k, nb), dim=1) + torch.arange(
        k, device=x.device) * nb
    return x[torch.clamp(idx, max=n - 1)]


def _lloyd(x: torch.Tensor, cents0: torch.Tensor, k: int, iters: int,
           balance: float = 0.0) -> torch.Tensor:
    """Lloyd iterations; ``balance`` > 0 runs capacity-constrained Lloyd: a
    per-cluster additive price, raised on overfull and lowered on underfull
    clusters each iteration (leaky integral control with a 25% deadband),
    rides the assignment only; the update step is the plain members-mean."""
    target = x.shape[0] / k
    cents = cents0.clone()
    bias = torch.zeros((k,), dtype=torch.float32, device=x.device)
    for _ in range(iters):
        assign = _assign(x, cents, bias if balance else None)
        new_cents, counts = _update(x, assign, k)
        # re-seed empty clusters with points far from their centroid
        d_to_own = torch.sum((x - new_cents[assign]) ** 2, dim=-1)
        empty = counts < 0.5
        new_cents = torch.where(empty[:, None],
                                _reseed_candidates(x, d_to_own, k), new_cents)
        if balance:
            scale = torch.mean(d_to_own)
            load = (counts - target) / target
            load = torch.where(load.abs() > 0.25, load, torch.zeros_like(load))
            bias = 0.8 * bias + balance * scale * torch.tanh(load)
            bias = bias - torch.mean(bias)
        cents = new_cents
    return cents


def kmeans_seeds(x: torch.Tensor, seed: int, *, k: int,
                 init: str = "random") -> torch.Tensor:
    """The k initial centroids of ``kmeans_fit``: k-means++ (``"kpp"``) or
    k distinct rows at random, drawn from a generator seeded with
    ``seed``."""
    n = x.shape[0]
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed))
    if init == "kpp":
        return _kpp_init(x, gen, k)
    if init != "random":
        raise ValueError(f"init must be 'random' or 'kpp', got {init!r}")
    if n < k:
        idx = torch.randint(0, n, (k,), generator=gen, device=x.device)
    else:
        idx = torch.randperm(n, generator=gen, device=x.device)[:k]
    return x[idx]


def kmeans_fit(x: torch.Tensor, seed: int, *, k: int, iters: int = 25,
               init: str = "random", balance: float = 0.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means on x [N, D] f32.  Returns (centroids [k, D],
    assignments [N] int64)."""
    cents = _lloyd(x, kmeans_seeds(x, seed, k=k, init=init), k, iters,
                  balance=balance)
    return cents, _assign(x, cents)


def _subspaces(x: torch.Tensor, m: int) -> torch.Tensor:
    """[N, D] -> [m, N, D/m] (subspace j holds columns j*D/m .. (j+1)*D/m)."""
    n, d = x.shape
    if d % m:
        raise ValueError(f"dimension {d} not divisible by m={m}")
    return x.reshape(n, m, d // m).transpose(0, 1).contiguous()


def kmeans_fit_subspaces(x: torch.Tensor, seed: int, *, m: int, k: int,
                         iters: int = 25) -> torch.Tensor:
    """All M product-quantization codebooks: k-means on each D/m-column
    subspace, subspace j seeded with ``seed + j``.  Returns [m, k, D/m]."""
    xs = _subspaces(x, m)
    return torch.stack([kmeans_fit(xs[j], seed + j, k=k, iters=iters)[0]
                        for j in range(m)])


def kmeans_refine_subspaces(x: torch.Tensor, init_codebooks: torch.Tensor, *,
                            m: int, k: int, iters: int = 5) -> torch.Tensor:
    """``iters`` Lloyd steps on each subspace from the given codebooks
    [m, k, D/m] (the OPQ alternation's warm-started retrain); deterministic
    given its inputs."""
    xs = _subspaces(x, m)
    return torch.stack([_lloyd(xs[j], init_codebooks[j], k, iters)
                        for j in range(m)])
