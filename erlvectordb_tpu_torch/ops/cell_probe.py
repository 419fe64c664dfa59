"""Multiprobe cell-gather search — the sub-linear path over cell-residual
layouts.

Counterpart of ``erlvectordb_tpu/ops/cell_probe.py``.  A brute-force scan
reads every code row per batch; this op routes each query to its ``nprobe``
nearest cells by one small [B, K] centroid product, reads only those cells'
code blocks (``nprobe * cell_cap`` rows) and scores them with the f32 query:
traffic per query is O(nprobe * cell_cap * W), sub-linear in the corpus, the
low-latency path at large N.

Layouts (detected by ``codes.dtype``):
  * uint8 — packed int4 nibble pairs [N, W/2], dim 2p in the high nibble:
    the int4r store's own rows;
  * int8  — full-width residual codes [N, W] with per-row scales: the
    cell-probe index (core/cell_probe.py).

Scoring matches the int4r store's exact rescore: q.x = q.c_cell + q.res.
The routing product is a bf16 query times the persistent bf16 centroid copy,
accumulated in f32 (ranking-grade); the probed cells' centroid term is
recomputed in full f32, and the residual dots come from the hand-written
gather+dot kernel B7 (``gather_dots``, ``csrc/cell_probe.cu``) on the
bf16-rounded query held as f32 — the precision class of the JAX package's
path, where the TPU kernel multiplies at bf16 class and its CPU path rounds
the query to bf16 with f32 accumulation.  Every multiprobe search on a CUDA
device launches B7, for any nprobe, cell size and batch: on packed int4
codes, with products on bf16 tensor cores, and from B7_SORT_MIN_PAIRS
(query, probe) pairs sorted by cell (``b7_plan``) so a block reads each
probed cell once for the queries of its window; on the CPU the plain
version ``gather_dots_ref`` answers.

The TPU accommodations of the JAX module do not carry over: the TPU gate and
the VMEM/SMEM batch chunking, the [evens | odds] query reorder and the
scalar-prefetch grid.  With the int4r second stage (``rq_codes``/``rq_lut``)
the top ``rq_pool`` of stage 1 are rescored with the error dot looked up in
the stage-2 LUT: a gather plus a top-k, plain tensor code as in the JAX
package (no kernel there either).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from erlvectordb_tpu_torch.ops.fused_topk import (
    _count,
    _stream,
    full_f32_matmul,
    unpack_int4,
)

_NEG = -1e30
# bytes of float64 operands the plain version materializes per query chunk
_REF_BUDGET = 1 << 30


def dedup_rows_topk(dists, rows, k):
    """Host-side per-query dedup for spilled (multi-assigned) layouts.

    ``rows`` [B, K'] store rows sorted best-first with possible duplicates (a
    spilled row lives in two cells); keeps each query's FIRST occurrence of
    every row and trims to k.  Returns (dists [B, k], rows [B, k]) with
    -1/inf past the unique hits."""
    dists = np.asarray(dists)
    rows = np.asarray(rows)
    order = np.argsort(rows, axis=1, kind="stable")
    sv = np.take_along_axis(rows, order, 1)
    dup_sorted = np.zeros_like(sv, bool)
    dup_sorted[:, 1:] = sv[:, 1:] == sv[:, :-1]
    dup = np.zeros_like(dup_sorted)
    np.put_along_axis(dup, order, dup_sorted, 1)
    keep = ~dup
    sel = np.argsort(~keep, axis=1, kind="stable")[:, :k]
    out_r = np.take_along_axis(rows, sel, 1)
    out_d = np.take_along_axis(dists, sel, 1)
    mask = np.take_along_axis(keep, sel, 1)
    return (np.where(mask, out_d, np.inf),
            np.where(mask, out_r, -1))


# ---------------------------------------------------------------- kernel B7


def gather_dots_ref(codes3, probe, queries):
    """Plain B7: out[b, j, c] = queries[b] . codes3[probe[b, j], c] for
    codes3 [K, cap, W] int8 or [K, cap, W/2] packed uint8, probe [B, nprobe]
    int, queries [B, W] f32; the products summed in float64 and rounded to
    f32.  The batch is worked through in query chunks: the gathered blocks of
    a whole batch would not fit (1024 queries x 64 probes x a 512 x 768 cell
    is 25.8 GB as int8)."""
    b, nprobe = probe.shape
    _, cap, wc = codes3.shape
    w = queries.shape[1]
    out = torch.empty((b, nprobe, cap), dtype=torch.float32,
                      device=queries.device)
    per_query = 8 * nprobe * cap * w
    bc = max(1, _REF_BUDGET // per_query)
    for i in range(0, b, bc):
        blk = codes3[probe[i:i + bc].long()]             # [bc, np, cap, wc]
        if codes3.dtype == torch.uint8:
            blk = unpack_int4(blk)
        out[i:i + bc] = torch.einsum("bpcw,bw->bpc", blk.double(),
                                     queries[i:i + bc].double()).float()
    return out


# B7-int4's plan: from B7_SORT_MIN_PAIRS (query, probe) pairs, windows of
# B7_WINDOW pairs sorted by cell; below, windows of 1 to B7_PIPELINE pairs
# in pair order, as few as fill B7_BLOCKS blocks (132 SMs x 4 resident
# blocks of the kernel); one pair a window for one query
B7_WINDOW = 32
B7_SORT_MIN_PAIRS = 65536
B7_PIPELINE = 8
B7_BLOCKS = 528
B7_CHUNK = 128   # k elements of the kernel's chunk


def b7_query_order(w: int) -> np.ndarray:
    """The k order of B7-int4 (``csrc/cell_probe.cu``): the element of a
    query row of width ``w`` staged at each position of its bf16 row, in
    chunks of 128 (the last one zero past ``w``: -1).  In each chunk, position
    32m + 8t + i holds element 32t + 8m + i: the 8-element groups transposed,
    so thread t of a quad reads its B fragments for mma k steps 2m, 2m + 1 as
    the 16 bytes at 64m + 16t, matching the A fragments it takes from bytes
    16t .. 16t + 15 of the packed code chunk."""
    n = -(-w // B7_CHUNK) * B7_CHUNK
    p = np.arange(n)
    m, t, i = (p % B7_CHUNK) // 32, (p % 32) // 8, p % 8
    e = p - p % B7_CHUNK + 32 * t + 8 * m + i
    return np.where(e < w, e, -1)


def b7_plan_for(n_pairs: int, batch: int):
    """(window, sort): B7-int4's plan for ``n_pairs`` (query, probe) pairs.
    One query's probes are distinct cells, and few pairs share few cells,
    so neither sorts (the sort's launches would cost more than the reads it
    saves): windows in pair order, one pair for one query."""
    if batch > 1 and n_pairs >= B7_SORT_MIN_PAIRS:
        return B7_WINDOW, True
    if batch == 1:
        return 1, False
    return max(1, min(B7_PIPELINE, -(-n_pairs // B7_BLOCKS))), False


def b7_plan(probe, sort):
    """(cells, order): the flat probe ids sorted, with their flat pairs b *
    nprobe + j (int64; stable, so equal cells keep pair order); unsorted,
    the ids in pair order and no order.  Sorting the raw ids sorts the
    clamped ones too (clamping is monotone)."""
    flat = probe.reshape(-1)
    if not sort:
        return flat, None
    return torch.sort(flat, stable=True)


def gather_dots(codes3, probe, queries, *, plan=None):
    """B7: the raw residual dots [B, nprobe, cap] f32 of each query against
    each probed cell's code block (int8 [K, cap, W] or packed int4 [K, cap,
    W/2] codes; probe [B, nprobe] int32; queries [B, W] f32, bf16-exact for
    packed codes, which the kernel multiplies in bf16).  Replaces
    erlvectordb_tpu ``_dma_gather_dots``.  Probe ids outside [0, K) are
    clamped into it by the kernel.  ``plan``: B7-int4's (window, sort)
    (default ``b7_plan_for``); the output does not depend on it."""
    if codes3.device.type == "cpu":
        return gather_dots_ref(codes3, probe, queries)
    from erlvectordb_tpu_torch.ops import cuda_lib

    variant = {torch.int8: "int8", torch.uint8: "int4"}.get(codes3.dtype)
    if variant is None:
        raise ValueError(f"gather_dots: unsupported codes dtype {codes3.dtype}")
    if codes3.dim() != 3 or probe.dim() != 2 or queries.dim() != 2:
        raise ValueError("gather_dots: codes3 [K, cap, Wc], probe [B, np], "
                         "queries [B, W]")
    k_cells, cap, wc = codes3.shape
    b, nprobe = probe.shape
    w = wc * (2 if variant == "int4" else 1)
    if not (codes3.is_cuda and probe.is_cuda and queries.is_cuda):
        raise ValueError("gather_dots: inputs must be CUDA tensors")
    if (probe.dtype != torch.int32 or queries.dtype != torch.float32
            or queries.shape != (b, w)):
        raise ValueError(f"gather_dots: need int32 probe and f32 [{b}, {w}] "
                         "queries")
    if not (codes3.is_contiguous() and probe.is_contiguous()
            and queries.is_contiguous()):
        raise ValueError("gather_dots: inputs must be contiguous")
    if wc % 16 or codes3.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError("gather_dots: rows must be 16-byte multiples, "
                         "16-byte aligned")
    if variant == "int8" and 4 * w > 48 * 1024:
        raise ValueError(f"gather_dots: query rows of {w} f32 exceed the "
                         "kernel's shared memory")
    if b * nprobe >= 2 ** 31:
        raise ValueError("gather_dots: more than 2^31 - 1 (query, probe) pairs")
    if variant == "int8":
        if plan is not None:
            raise ValueError("gather_dots: int8 codes take no plan")
    else:
        window, sort = b7_plan_for(b * nprobe, b) if plan is None else plan
        if not 1 <= window <= B7_WINDOW:
            raise ValueError(f"gather_dots: window {window} not in "
                             f"[1, {B7_WINDOW}]")
    out = torch.empty((b, nprobe, cap), dtype=torch.float32,
                      device=queries.device)
    if b == 0 or nprobe == 0:
        return out
    lib = cuda_lib.library()
    if variant == "int8":
        rc = lib.evdb_gather_dots(
            codes3.data_ptr(), probe.data_ptr(), queries.data_ptr(), k_cells,
            cap, wc, w, b, nprobe, out.data_ptr(), _stream())
    else:
        cells, order = b7_plan(probe, sort)
        rc = lib.evdb_gather_dots_i4(
            codes3.data_ptr(), cells.data_ptr(),
            None if order is None else order.data_ptr(), queries.data_ptr(),
            k_cells, cap, w, nprobe, b * nprobe, window, out.data_ptr(),
            _stream())
    cuda_lib.check(rc, "gather_dots")
    _count(gather_dots, variant)
    return out


KERNELS = (gather_dots,)


def reset_launches() -> None:
    """Zero B7's launch counts (``launches`` and ``launches_by``)."""
    for k in KERNELS:
        k.launches = 0
        k.launches_by = {}


reset_launches()


# ----------------------------------------------------------------- the search


def _route_score(metric, dots, c2, act):
    """The metric's centroid proxy of a routing product; inactive cells get
    -1e30."""
    if metric == "euclidean":
        r = 2.0 * dots - c2
    elif metric == "cosine":
        cnorm = torch.sqrt(c2)
        r = torch.where(cnorm > 0,
                        dots / torch.where(cnorm > 0, cnorm, torch.ones_like(cnorm)),
                        torch.zeros_like(dots))
    else:  # dot
        r = dots
    return torch.where(act, r, torch.full_like(r, _NEG))


def route_probes(
    centroids: torch.Tensor,   # [K, W] f32 cell centroids
    queries: torch.Tensor,     # [B, W] f32 raw queries
    active: torch.Tensor,      # [K] bool: cells holding a valid row
    *,
    metric: str,
    nprobe: int,
    centroids_route: Optional[torch.Tensor] = None,
    cn2: Optional[torch.Tensor] = None,
    super_route: Optional[torch.Tensor] = None,
    child_cap: int = 0,
    sprobe: int = 0,
) -> torch.Tensor:
    """The top-``nprobe`` cells [B, nprobe'] of each query by the metric's
    centroid proxy: the flat route over every cell, or the hierarchical one
    (L1 over the supercentroids, L2 over the probed supercells' children).

    bf16 operands, products and sums in f32 (a bf16 x bf16 product is exact
    in f32): the probe list the JAX package's preferred_element_type=f32
    product gives, up to the order of summation."""
    b, w = queries.shape
    n_cells = centroids.shape[0]
    nprobe = min(nprobe, n_cells)
    cr = (centroids_route if centroids_route is not None
          else centroids.to(torch.bfloat16)).float()
    qbf = queries.to(torch.bfloat16).float()
    if cn2 is None:
        cn2 = torch.sum(centroids * centroids, dim=-1)
    with full_f32_matmul():
        if super_route is None or not child_cap:
            route = _route_score(metric, qbf @ cr.T, cn2[None, :],
                                 active[None, :])                   # [B, K]
            return torch.topk(route, nprobe, dim=1).indices
        s_count = super_route.shape[0]
        if not sprobe:
            sprobe = max(8, -(-8 * nprobe // child_cap))
        sprobe = min(s_count, sprobe)
        sr = super_route.float()
        scn2 = torch.sum(sr ** 2, dim=-1)
        sactive = active.reshape(s_count, child_cap).any(dim=1)
        sp_idx = torch.topk(_route_score(metric, qbf @ sr.T, scn2[None, :],
                                         sactive[None, :]),
                            sprobe, dim=1).indices                  # [B, sp]
        csub = cr.reshape(s_count, child_cap, w)[sp_idx]         # [B, sp, cc, W]
        l2 = torch.einsum("bsgw,bw->bsg", csub, qbf)
        cn2g = cn2.reshape(s_count, child_cap)[sp_idx]
        actg = active.reshape(s_count, child_cap)[sp_idx]
        flat = _route_score(metric, l2, cn2g, actg).reshape(b, -1)
        sel = torch.topk(flat, min(nprobe, flat.shape[1]), dim=1).indices
        return (torch.gather(sp_idx, 1, sel // child_cap) * child_cap
                + sel % child_cap)                                  # [B, np]


def multiprobe_topk(
    codes: torch.Tensor,       # [K*cell_cap, W] int8 or [.., W/2] uint8
    scales: torch.Tensor,      # [K*cell_cap] f32 per-row residual scales
    norms: torch.Tensor,       # [K*cell_cap] f32 reconstruction norms
    valid: torch.Tensor,       # [K*cell_cap] bool
    centroids: torch.Tensor,   # [K, W] f32 cell centroids
    queries: torch.Tensor,     # [B, W] f32 raw queries
    *,
    metric: str,
    k: int,
    nprobe: int,
    cell_cap: int,
    centroids_route: Optional[torch.Tensor] = None,  # persistent bf16 [K, W]
    cn2: Optional[torch.Tensor] = None,              # persistent [K] |c|^2
    super_route: Optional[torch.Tensor] = None,      # bf16 [S, W]
    child_cap: int = 0,                              # children per supercell
    sprobe: int = 0,                                 # L1 width (0 = auto)
    rq_codes: Optional[torch.Tensor] = None,
    rq_lut: Optional[torch.Tensor] = None,
    rq_pool: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sub-linear multiprobe search.  Returns (distances [B, k] f32, rows
    [B, k] int32): rows index the cell-major layout, distances are inf past
    the valid hits.

    ``centroids_route``/``cn2``: the caller's persistent bf16 routing copy
    and |c|^2 buffer (derived here when absent).  ``super_route`` /
    ``child_cap``: the HIERARCHICAL route over a supercell-major layout (K ==
    S * child_cap): L1 over the [S, W] supercentroids, top-``sprobe``
    supercells, L2 over only their children (auto ``sprobe`` covers ~8x
    nprobe children, at least 8 supercells).  ``rq_codes`` [N, M2] uint8 /
    ``rq_lut`` [B, M2, 256] (inner-product tables of the rotated queries):
    the stage-2 pooled rescore of the top ``rq_pool`` rows."""
    if metric not in ("cosine", "euclidean", "dot"):
        raise ValueError(f"multiprobe does not support metric {metric!r}")
    b = queries.shape[0]
    n_cells = centroids.shape[0]
    active = valid.reshape(n_cells, cell_cap).any(dim=1)            # [K]
    probe = route_probes(centroids, queries, active, metric=metric,
                         nprobe=nprobe, centroids_route=centroids_route,
                         cn2=cn2, super_route=super_route,
                         child_cap=child_cap, sprobe=sprobe)        # [B, np]
    qbf = queries.to(torch.bfloat16).float()

    # ---- gather + dot: only the probed cells' code blocks (B7) -----------
    codes3 = codes.reshape(n_cells, cell_cap, codes.shape[1])
    dots_raw = gather_dots(codes3, probe.to(torch.int32).contiguous(), qbf)
    pscales = scales.reshape(n_cells, cell_cap)[probe]          # [B, np, cap]
    # the probed cells' centroid term in full f32 (the bf16 routing copy is
    # ranking-grade, not scoring-grade)
    with full_f32_matmul():
        tgath = torch.einsum("bpw,bw->bp", centroids[probe], queries)
    qx = (dots_raw * pscales + tgath[:, :, None]).reshape(b, -1)   # q . x

    # ---- exact distances + top-k ----------------------------------------
    vmask = valid.reshape(n_cells, cell_cap)[probe].reshape(b, -1)
    rnorm = norms.reshape(n_cells, cell_cap)[probe].reshape(b, -1)
    if metric == "cosine":
        qn = torch.sqrt(torch.sum(queries * queries, dim=-1, keepdim=True))

        def final(qx_, rn_, vm_):
            denom = qn * rn_
            sim = torch.where(
                denom > 0,
                qx_ / torch.where(denom > 0, denom, torch.ones_like(denom)),
                torch.zeros_like(qx_))
            return torch.where(vm_, sim, _NEG)
        dist_of = lambda s: 1.0 - s
    elif metric == "euclidean":
        qsq = torch.sum(queries * queries, dim=-1, keepdim=True)

        def final(qx_, rn_, vm_):
            return torch.where(vm_, 2.0 * qx_ - rn_ * rn_, _NEG)
        dist_of = lambda s: torch.sqrt(torch.clamp(qsq - s, min=0.0))
    else:  # dot
        def final(qx_, rn_, vm_):
            return torch.where(vm_, qx_, _NEG)
        dist_of = lambda s: -s
    score = final(qx, rnorm, vmask)
    # slot j of the probe list is row probe[j // cap] * cap + j % cap
    slot_row = lambda j: (torch.gather(probe, 1, j // cell_cap) * cell_cap
                          + j % cell_cap)
    if rq_codes is not None and rq_lut is not None:
        # stage-2 pooled rescore: the top rq_pool by stage-1 score get q.x
        # corrected by the LUT'd error dot and are re-ranked alone.  The
        # stored norms are full-reconstruction norms (set by the rq encode),
        # so the corrected numerator and the denominator describe the same
        # vector
        m2 = rq_codes.shape[1]
        r0 = min(rq_pool, score.shape[1])
        _, psel = torch.topk(score, r0, dim=1)                 # [B, r0]
        prow = slot_row(psel)                                  # store rows
        pcodes = rq_codes[prow].long()                         # [B, r0, M2]
        sub = torch.arange(m2, device=pcodes.device) * rq_lut.shape[2]
        qe = torch.gather(rq_lut.reshape(b, -1), 1,
                          (sub + pcodes).reshape(b, -1)
                          ).reshape(b, r0, m2).sum(dim=-1)      # [B, r0] q.e
        score_p = final(torch.gather(qx, 1, psel) + qe,
                        torch.gather(rnorm, 1, psel),
                        torch.gather(vmask, 1, psel))
        best, sel2 = torch.topk(score_p, min(k, r0), dim=1)
        out_rows = torch.gather(prow, 1, sel2)
    else:
        best, sel = torch.topk(score, min(k, score.shape[1]), dim=1)
        out_rows = slot_row(sel)
    dists = torch.where(best <= _NEG / 2, float("inf"), dist_of(best))
    return dists, out_rows.to(torch.int32)
