"""The ADC scans over PQ codes — kernels B8, B9 and B10 and their glue.

Counterpart of ``erlvectordb_tpu/ops/adc_pallas.py``.  Three scans do the
work, each a hand-written Hopper kernel in ``csrc/adc_scan.cu`` with a plain
PyTorch version beside it:

  adc_pallas_scan  (B10)  the ADC distance of every row from an int8 LUT
                          (exact int sums) or an f32 LUT rounded to bf16
                          (f32 sums in subspace order); top-T per 1024-row
                          tile, ties to the lower row;
  adc_exact_scan   (B9)   B10 from an int8 LUT, each of the T winners
                          exactly reranked against its int8 row:
                          d2 = |q|^2 - 2 (q . x) scale + |x|^2;
  adc_pos_scan     (B8)   the top-2 of every 1024-row slice by the TPU
                          kernel's packed key ((-dist) << 10) | lane, so ties
                          go to the HIGHER row, each winner exactly reranked.

Between them, plain tensor code decides the result as the JAX package does:
the per-subspace LUT min-shift and the int8 LUT quantizer, the ``t``
doubling rules, row padding and the ``n_big`` rule of the pos scan, the
``rows < n_valid`` mask, the final top-k (ties to the lower column, as
``lax.top_k``) and the XLA rerank of ``adc_search_fused``.

The int8-LUT kernels read the LUT packed by ``pack_lut``: 4 queries'
entries of one (subspace, code) in a 32-bit word, +128 each, the tables of
``s`` subspaces interleaved so a warp's 32 lookups hit 32 banks;
``packed_lut_dists`` is that arithmetic in plain PyTorch, and ``adc_layout``
sizes the launch.  B10-bf16's kernel takes the f32 LUT and stages it in
shared memory as the words of ``pack_lut_bf16``: 2 queries' bf16 entries a
word, interleaved the same way, its launch sized by ``adc_bf16_layout``.  It
adds each row's entries in the order of ``canonical_lut_dists``, not the
plain version's subspace order: ``adc_bf16_model`` is its arithmetic in
plain PyTorch (bit for bit), and ``bf16_agreement`` holds its result against
the plain version within the bound of a reordered f32 sum.

Each scan wrapper runs its plain version for tensors on the CPU and its CUDA
kernel for tensors on a CUDA device (raising if the kernel cannot run), and
counts kernel launches in its ``launches`` attribute.  The TPU accommodations
of the JAX module (query tiles padded to 8-256 rows, the transposed
[tiles, B, T] outputs, 8-slice big tiles as one grid step) do not carry over.
"""

from __future__ import annotations

from typing import Tuple

import torch

from erlvectordb_tpu_torch.ops.adc import topk_stable
from erlvectordb_tpu_torch.ops.fused_topk import _count, _stream, full_f32_matmul
from erlvectordb_tpu_torch.quant.pq import _adc_l2_tables

ADC_TILE_N = 1024
_ROW_CHUNK = 64 * ADC_TILE_N   # rows per step of the plain scans
_RERANK_CHUNK = 1 << 27        # bytes of f32 rows the plain rerank gathers per step
ADC_SMEM_MAX = 232_448         # shared memory a block may use (H100)
ADC_MAX_M = 256                # the packed 16-bit sums stay exact: M * 255 < 65,536
LUT_BIAS = 128                 # added to each int8 entry of the packed LUT


def adc_n_tiles(count: int) -> int:
    return -(-max(count, 1) // ADC_TILE_N)


# ------------------------------------------------------------------- glue


def quantize_lut(lut3: torch.Tensor, shift: bool) -> torch.Tensor:
    """[B, M, K] f32 LUT -> [B, M*K] int8 in [0, 127]: per query row,
    round(lut / max(row_max, 1e-20) * 127).  ``shift`` first subtracts each
    subspace's per-query minimum (ranking-invariant: every row's distance
    moves by the same constant; the 127 levels then span the spread, not the
    offset floor)."""
    if shift:
        lut3 = lut3 - torch.amin(lut3, dim=2, keepdim=True)
    lut = lut3.reshape(lut3.shape[0], -1)
    row_max = torch.amax(lut, dim=1, keepdim=True)
    return torch.clamp(torch.round(lut / torch.clamp(row_max, min=1e-20) * 127.0),
                       0, 127).to(torch.int8)


def exact_t(n_tiles: int, t: int = 4, pool: int = 512) -> int:
    """Per-tile extraction depth: doubled (up to 8) while tiles are too
    scarce for the candidate pool to reach ``pool``."""
    while t < 8 and t * n_tiles < pool:
        t *= 2
    return t


def _merge(vals, rows, n_valid, k):
    """Mask padding rows, take the top-k of -d2 (ties to the lower column),
    and return (distances, rows) with -1/inf past the valid hits."""
    vals = torch.where(rows < int(n_valid), vals, float("-inf"))
    best, sel = topk_stable(vals, min(k, vals.shape[1]))
    rows_out = torch.gather(rows, 1, sel)
    rows_out = torch.where(torch.isfinite(best), rows_out, -1)
    dist = torch.sqrt(torch.clamp(-best, min=0.0))
    return torch.where(rows_out >= 0, dist, float("inf")), rows_out


# ---------------------------------------------------------- plain versions


def _lut_dists(codes: torch.Tensor, lut_flat: torch.Tensor) -> torch.Tensor:
    """[R, M] uint8 codes against [B, M*K] LUTs -> [B, R]: int32 sums of an
    int8 LUT, or f32 sums (in subspace order) of an f32 LUT rounded to bf16."""
    m = codes.shape[1]
    k = lut_flat.shape[1] // m
    idx = codes.long()
    if lut_flat.dtype == torch.int8:
        lut = lut_flat.to(torch.int32)
        acc = torch.zeros((lut.shape[0], codes.shape[0]), dtype=torch.int32,
                          device=lut.device)
    else:
        lut = lut_flat.to(torch.bfloat16).float()
        acc = torch.zeros((lut.shape[0], codes.shape[0]), dtype=torch.float32,
                          device=lut.device)
    for j in range(m):
        acc = acc + lut[:, j * k + idx[:, j]]
    return acc


def bf16_chains(m: int) -> int:
    """S0 of the canonical f32 sum of M bf16 lookups: 8 chains if M % 8 ==
    0, else 4 (M % 4 == 0 always)."""
    return 8 if m % 8 == 0 else 4


def canonical_lut_dists(codes: torch.Tensor,
                        lut_flat: torch.Tensor) -> torch.Tensor:
    """B10-bf16's kernel's sums in plain PyTorch: [R, M] uint8 codes against
    an f32 [B, M*K] LUT rounded to bf16 (round to nearest even) -> f32 [B,
    R], added in the canonical order the kernel keeps for any subspace phase
    count S dividing S0 = bf16_chains(M): chain r < S0 sums subspaces r, r +
    S0, r + 2 S0, ... from 0 in increasing order, then a halving tree adds
    chain r + d into chain r (r < d) for d = S0/2, S0/4, ..., 1.  It
    differs from ``_lut_dists`` (subspace order) by at most
    ``bf16_sum_bound``."""
    m = codes.shape[1]
    k = lut_flat.shape[1] // m
    idx = codes.long()
    shape = (lut_flat.shape[0], codes.shape[0])
    lut = lut_flat.to(torch.bfloat16).float()
    s0 = bf16_chains(m)
    chains = []
    for r in range(s0):
        acc = torch.zeros(shape, dtype=torch.float32, device=lut.device)
        for j in range(r, m, s0):
            acc = acc + lut[:, j * k + idx[:, j]]
        chains.append(acc)
    d = s0 // 2
    while d:
        for r in range(d):
            chains[r] = chains[r] + chains[r + d]
        d //= 2
    return chains[0]


def _tile_picks(codes, lut_flat, n_tiles, t, high_lane, dist_fn=_lut_dists):
    """The t smallest distances (by ``dist_fn``) of every 1024-row tile and
    their rows, ties to the lower row (or the higher one): (dists [B,
    n_tiles*t], rows)."""
    b = lut_flat.shape[0]
    n = n_tiles * ADC_TILE_N
    dists = torch.empty((b, n_tiles, t), dtype=(
        torch.int32 if lut_flat.dtype == torch.int8 else torch.float32),
        device=lut_flat.device)
    rows = torch.empty((b, n_tiles, t), dtype=torch.int64,
                       device=lut_flat.device)
    for r0 in range(0, n, _ROW_CHUNK):
        r1 = min(n, r0 + _ROW_CHUNK)
        d = dist_fn(codes[r0:r1], lut_flat)
        d = d.reshape(b, (r1 - r0) // ADC_TILE_N, ADC_TILE_N)
        if high_lane:
            d = d.flip(-1)
        v, lane = torch.sort(d, dim=-1, stable=True)
        lane = lane[..., :t]
        if high_lane:
            lane = ADC_TILE_N - 1 - lane
        j0, j1 = r0 // ADC_TILE_N, r1 // ADC_TILE_N
        dists[:, j0:j1] = v[..., :t]
        rows[:, j0:j1] = (lane + ADC_TILE_N * torch.arange(
            j0, j1, device=lane.device)[None, :, None])
    return dists.reshape(b, -1), rows.reshape(b, -1)


def _rerank(q, i8_codes, i8_scales, i8_norms2, rows):
    """-d2 of each picked row: qdot = sum(q * x) * scale, d2 = |q|^2 - 2 qdot
    + |x|^2, every product and sum rounded in f32 (the TPU kernel's
    expression).  Works through the queries in chunks."""
    b, c = rows.shape
    d = q.shape[1]
    qsq = torch.sum(q * q, dim=1, keepdim=True)
    out = torch.empty((b, c), dtype=torch.float32, device=q.device)
    bc = max(1, _RERANK_CHUNK // (4 * c * d))
    for b0 in range(0, b, bc):
        r = rows[b0:b0 + bc]
        x = i8_codes[r].float()                                # [bc, c, D]
        qdot = torch.sum(q[b0:b0 + bc, None, :] * x, dim=-1) * i8_scales[r]
        out[b0:b0 + bc] = -(qsq[b0:b0 + bc] - 2.0 * qdot + i8_norms2[r])
    return out


def adc_pallas_scan_ref(codes, lut_flat, n_tiles, t_per_tile):
    """Plain B10: (-dist [B, T*n_tiles] f32, rows int32)."""
    dists, rows = _tile_picks(codes, lut_flat, n_tiles, t_per_tile, False)
    return -dists.float(), rows.to(torch.int32)


def adc_bf16_model(codes, lut_flat, n_tiles, t_per_tile):
    """B10-bf16's kernel in plain PyTorch: B10 on an f32 LUT with each
    row's sum in ``canonical_lut_dists``' order.  The kernel's picks and
    values equal these bit for bit; the plain version is
    ``adc_pallas_scan_ref``."""
    dists, rows = _tile_picks(codes, lut_flat, n_tiles, t_per_tile, False,
                              canonical_lut_dists)
    return -dists, rows.to(torch.int32)


def bf16_sum_bound(lut_flat: torch.Tensor, m: int) -> torch.Tensor:
    """[B] f64: for each query, a bound on how far two f32 sums (from 0, in
    any two orders) of one row's M entries of the bf16-rounded LUT lie
    apart.  Each is within gamma_{M-1} sum|l| of the exact sum (M - 1
    rounded adds on any path of the tree; gamma_n = n u / (1 - n u), u =
    2^-24), and sum|l| <= the sum over subspaces of the largest |entry|."""
    k = lut_flat.shape[1] // m
    mags = lut_flat.to(torch.bfloat16).double().abs().reshape(-1, m, k)
    nu = (m - 1) * 2.0 ** -24
    return 2 * nu / (1 - nu) * mags.amax(-1).sum(-1)


def lut_dists_at(codes, lut_flat, rows):
    """The plain version's distance (``_lut_dists``: f32 sum in subspace
    order of the bf16-rounded entries) of each row of ``rows`` [B, C] for
    its query -> f32 [B, C]."""
    m = codes.shape[1]
    k = lut_flat.shape[1] // m
    lut = lut_flat.to(torch.bfloat16).float()
    picked = codes[rows.long()].long()                        # [B, C, M]
    acc = torch.zeros(rows.shape, dtype=torch.float32, device=lut.device)
    for j in range(m):
        acc = acc + torch.gather(lut, 1, j * k + picked[..., j])
    return acc


def bf16_agreement(vals, rows, codes, lut_flat, n_tiles, t_per_tile,
                   ref=None):
    """How a B10-bf16 result (vals, rows) [B, n_tiles*T] agrees with the
    plain version, which adds each row's entries in another order than the
    kernel: with delta = bf16_sum_bound of the query, each value must lie
    within delta of the plain version's value in its column (the t-th
    smallest of a tile moves no further than any distance does), and each
    picked row must be a distinct row of its tile whose plain distance lies
    within 2 delta of the plain t-th value (the plain pick, or a near tie).
    Returns dict(max_abs_err, max_err_over_bound, bound (the largest delta),
    picks_differ (picks that are not the plain version's), bad_values,
    bad_picks); the result agrees iff both bad counts are 0.  ``ref``: the
    plain version's result, where the caller has it."""
    b = lut_flat.shape[0]
    m = codes.shape[1]
    vr, rr = ref if ref is not None else adc_pallas_scan_ref(
        codes, lut_flat, n_tiles, t_per_tile)
    delta = bf16_sum_bound(lut_flat, m)[:, None]
    err = (vals.double() - vr.double()).abs()
    gap = (lut_dists_at(codes, lut_flat, rows).double() + vr.double()).abs()
    tile = rows.long() // ADC_TILE_N
    want = torch.arange(n_tiles, device=rows.device).repeat_interleave(
        t_per_tile)
    srt = rows.reshape(b, n_tiles, t_per_tile).sort(-1).values
    dup = (srt[..., 1:] == srt[..., :-1]).any(-1).sum()
    bad_picks = (gap > 2 * delta) | (tile != want[None, :])
    return dict(max_abs_err=float(err.max()),
                max_err_over_bound=float(torch.where(
                    err == 0, 0.0, err / delta).max()),
                bound=float(delta.max()),
                picks_differ=int((rows != rr).sum()),
                bad_values=int((err > delta).sum()),
                bad_picks=int(bad_picks.sum() + dup))


def adc_exact_scan_ref(codes, lut_q, q, i8_codes, i8_scales, i8_norms2,
                       n_tiles, t_per_tile):
    """Plain B9: the int8-LUT picks of B10, exactly reranked: (-d2, rows)."""
    _, rows = _tile_picks(codes, lut_q, n_tiles, t_per_tile, False)
    return (_rerank(q, i8_codes, i8_scales, i8_norms2, rows),
            rows.to(torch.int32))


def adc_pos_scan_ref(codes, lut_q, q, i8_codes, i8_scales, i8_norms2,
                     n_slices):
    """Plain B8: the top-2 of each 1024-row slice, ties to the higher row,
    exactly reranked: (-d2 [B, 2*n_slices], rows)."""
    _, rows = _tile_picks(codes, lut_q, n_slices, 2, True)
    return (_rerank(q, i8_codes, i8_scales, i8_norms2, rows),
            rows.to(torch.int32))


# ------------------------------------------- the packed LUT of B8-B10-int8


def adc_t_max(t: int) -> int:
    """The list depth of the int8 kernels for T picks a tile: 2, 4, 8 or
    32 (the kernel keeps TMAX >= T keys a list and emits the first T)."""
    return 2 if t <= 2 else 4 if t <= 4 else 8 if t <= 8 else 32


def adc_packed_smem(m: int, k: int, s: int, tmax: int) -> int:
    """Shared memory of csrc/adc_scan.cu::adc_packed_kernel's block: the
    packed LUTs of 128 / s queries, two 1024-row code tiles, the warps'
    lists of tmax keys a query (padded), the picks, the queries' |q|^2."""
    qg, warps = 128 // s, (8 if tmax > 8 else 16)
    return (qg * m * k + 2 * ADC_TILE_N * m
            + 4 * warps * (qg * (tmax + 1) + 1) + 4 * qg * tmax + 4 * qg)


def adc_layout(b: int, m: int, k: int, t: int) -> dict:
    """The launch of the int8-LUT scans (B8, B9, B10-int8), the one place
    that sizes it.  A block holds the packed LUTs of ``qg`` = 128 / ``s``
    queries: 32 lanes of a warp are ``s`` subspace phases x ``g`` = 32 /
    ``s`` groups of 4 queries.  ``s`` is 2 (64 queries a block) unless the
    batch is small (<= 16 queries: 8; <= 32: 4, where M allows) or the LUTs
    do not fit; ``groups`` blocks' worth of queries, ``threads`` a block
    (16 warps, 8 for lists deeper than 8), ``smem`` bytes.  Raises where
    no layout fits: M past ADC_MAX_M, K past 256, T past 32, or shared
    memory."""
    if m < 4 or m % 4 or m > ADC_MAX_M or not 1 <= k <= 256:
        raise ValueError(f"need 4 <= M <= {ADC_MAX_M}, M % 4 == 0 and "
                         f"1 <= K <= 256 (M={m}, K={k})")
    if not 1 <= t <= 32 or b < 1:
        raise ValueError(f"need 1 <= T <= 32 and B >= 1 (T={t}, B={b})")
    tmax = adc_t_max(t)
    fits = [s for s in (2, 4, 8)
            if m % s == 0 and adc_packed_smem(m, k, s, tmax) <= ADC_SMEM_MAX]
    if not fits:
        raise ValueError(f"the packed LUTs of M={m}, K={k} (T={t}) exceed "
                         f"{ADC_SMEM_MAX} B of shared memory")
    want = 8 if b <= 16 else 4 if b <= 32 else 2
    s = min(fits, key=lambda x: (abs(x - want), x))
    qg = 128 // s
    return dict(s=s, g=32 // s, qg=qg, groups=-(-b // qg), tmax=tmax,
                threads=256 if tmax > 8 else 512,
                smem=adc_packed_smem(m, k, s, tmax))


def pack_lut(lut_q: torch.Tensor, m: int, s: int) -> torch.Tensor:
    """[B, M*K] int8 LUT -> the int8 kernels' packed words [groups, M/s, K,
    32] int32, groups of 4g queries (g = 32 / s).  Word (p, c, l) of a
    group, lane l = i * g + h, holds in byte j the entry of query 4h + j,
    subspace p*s + i, code c, plus 128 (an unsigned byte): the lanes of a
    warp, each reading the word of its own (subspace phase i, query group
    h) at a code, read 32 distinct banks.  Queries past B are zeros
    (entries of 128)."""
    b, mk = lut_q.shape
    k = mk // m
    g = 32 // s
    groups = -(-b // (4 * g))
    # + 128 as an unsigned byte: the sign bit flipped
    x = lut_q.view(torch.uint8) ^ LUT_BIAS
    if groups * 4 * g > b:
        x = torch.nn.functional.pad(x, (0, 0, 0, groups * 4 * g - b),
                                    value=LUT_BIAS)
    # [groups, h, j, p, i, K] -> [groups, p, K, i, h, j]
    x = x.reshape(groups, g, 4, m // s, s, k)
    x = x.permute(0, 3, 5, 4, 1, 2).contiguous()
    return x.view(torch.int32).reshape(groups, m // s, k, 32)


def packed_lut_dists(codes: torch.Tensor, packed: torch.Tensor, m: int,
                     s: int, b: int) -> torch.Tensor:
    """The int8 kernels' arithmetic in plain PyTorch: [R, M] uint8 codes
    against pack_lut's words -> [B, R] int32 distances.  Each word's even
    and odd bytes are summed as two 16-bit lanes (exact while M * 255 <
    65,536), the queries' sums taken from the lanes, and 128 * M taken
    off."""
    groups, _, k, _ = packed.shape
    g = 32 // s
    words = packed.long() & 0xFFFFFFFF
    idx = codes.long()
    out = torch.empty((b, codes.shape[0]), dtype=torch.int32,
                      device=codes.device)
    for r0 in range(0, codes.shape[0], _ROW_CHUNK):
        ic = idx[r0:r0 + _ROW_CHUNK]
        ae = torch.zeros((groups, ic.shape[0], g), dtype=torch.int64,
                         device=codes.device)
        ao = torch.zeros_like(ae)
        for mm in range(m):
            i = mm % s
            w = words[:, mm // s, :, i * g:(i + 1) * g][:, ic[:, mm], :]
            ae += w & 0x00FF00FF
            ao += (w >> 8) & 0x00FF00FF
        # query 4h + j: j = 0, 1 in the low lanes of ae, ao; 2, 3 the high
        q4 = torch.stack([ae & 0xFFFF, ao & 0xFFFF, ae >> 16, ao >> 16],
                         dim=-1)                              # [groups, R, g, 4]
        d = q4.permute(0, 2, 3, 1).reshape(groups * 4 * g, -1)[:b]
        out[:, r0:r0 + _ROW_CHUNK] = (d - LUT_BIAS * m).to(torch.int32)
    return out


# ------------------------------------------ the packed LUT of B10-bf16


def adc_bf16_smem(m: int, k: int, s: int, h: int, nbuf: int,
                  tmax: int) -> int:
    """Shared memory of csrc/adc_scan.cu::adc_bf16_packed_kernel's block:
    the packed LUT words of 2 h queries a subspace phase (4 M K h bytes),
    ``nbuf`` 1024-row code tiles, the warps' lists of tmax 64-bit keys for
    each of the 2 h queries (padded)."""
    warps = 8 if tmax > 8 else 16
    return (4 * m * k * h + nbuf * ADC_TILE_N * m
            + 8 * warps * (2 * h * (tmax + 1) + 1))


def adc_bf16_layout(b: int, m: int, k: int, t: int) -> dict:
    """The launch of B10-bf16, the one place that sizes it.  Lane l of a
    warp is (subspace phase ``s``, query pair ``g`` < 32 / s); a block holds
    the packed LUTs of ``qg`` = 2 ``h`` queries, the pairs g < ``h`` (all
    32 / s where the LUTs fit; fewer lanes work otherwise).  ``s`` divides
    S0 = bf16_chains(M): 2 (32 queries a block) unless the batch is small
    (<= 8 queries: 8; <= 16: 4) or the LUTs do not fit; ``nbuf`` code
    tiles (2: the next one arrives while this one is scored; 1 where two do
    not fit), ``threads`` (16 warps, 8 for lists deeper than 8), ``smem``
    bytes.  Refuses exactly the shapes the first design refused: M % 4,
    K past 256, T past 32, and 8 queries' bf16 LUTs plus one code tile past
    the shared memory (every shape inside that has a layout)."""
    if m < 4 or m % 4 or not 1 <= k <= 256:
        raise ValueError(f"need M >= 4, M % 4 == 0 and 1 <= K <= 256 "
                         f"(M={m}, K={k})")
    if not 1 <= t <= 32 or b < 1:
        raise ValueError(f"need 1 <= T <= 32 and B >= 1 (T={t}, B={b})")
    if 2 * 8 * m * k + ADC_TILE_N * m > ADC_SMEM_MAX:
        raise ValueError(f"adc_pallas_scan: bf16 LUTs of M*K={m * k} "
                         "exceed the kernel's shared memory")
    tmax = adc_t_max(t)
    s0 = bf16_chains(m)
    want = 8 if b <= 8 else 4 if b <= 16 else 2
    full = [s for s in (2, 4, 8) if s0 % s == 0 and adc_bf16_smem(
        m, k, s, 32 // s, 2, tmax) <= ADC_SMEM_MAX]
    if full:
        s = min(full, key=lambda x: (abs(x - want), x))
        h, nbuf = 32 // s, 2
    else:   # the most queries a block, then the most lanes at work
        s, h, nbuf = max(
            ((s, h, nbuf) for s in (2, 4, 8) if s0 % s == 0
             for h in (16, 8, 4, 2, 1) if h <= 32 // s for nbuf in (2, 1)
             if adc_bf16_smem(m, k, s, h, nbuf, tmax) <= ADC_SMEM_MAX),
            key=lambda o: (o[1], o[0] * o[1], o[2]))
    tpb = 256 if tmax > 8 else 512
    return dict(s=s, s0=s0, g=32 // s, h=h, qg=2 * h, groups=-(-b // (2 * h)),
                tmax=tmax, nbuf=nbuf, threads=tpb,
                smem=adc_bf16_smem(m, k, s, h, nbuf, tmax))


def pack_lut_bf16(lut_flat: torch.Tensor, m: int, s: int,
                  h: int) -> torch.Tensor:
    """The words B10-bf16's kernel stages in shared memory from the f32 LUT
    (csrc/adc_scan.cu::stage_bf16_lut), in plain PyTorch: [B, M*K] f32 LUT
    -> [groups, M/s, K, s*h] int32 (h <= 32 / s query pairs a phase),
    groups of 2h queries.  Each entry is rounded to bf16 (round to nearest
    even); word (p, c, i*h + j) of a group holds in its low half the entry
    of query 2j, in its high half that of query 2j + 1, for subspace p*s + i
    and code c.  With h = 32 / s
    lane l = i*h + j of a warp reads word l of a row at any code: the 32
    loads never share a bank, and each serves 2 lookups.  Queries past B
    are zeros, and -0 is stored as +0 (a sum from 0 never tells them apart,
    so the kernel starts each sum at its first term)."""
    b, mk = lut_flat.shape
    k = mk // m
    groups = -(-b // (2 * h))
    x = lut_flat.new_zeros((groups * 2 * h, mk), dtype=torch.bfloat16)
    x[:b] = lut_flat
    x += 0                                         # -0 + 0 is +0
    # [groups, j, query of the pair, p, i, K] -> [groups, p, K, i, j, pair]
    x = x.view(torch.int16).reshape(groups, h, 2, m // s, s, k)
    x = x.permute(0, 3, 5, 4, 1, 2)
    return x.contiguous().view(torch.int32).reshape(groups, m // s, k, s * h)


# ---------------------------------------------------------------- kernels


def _check_codes(codes, lut, n_tiles, name):
    """(B, M, K) of a kernel call, after the checks the kernel relies on."""
    if not (codes.is_cuda and lut.is_cuda):
        raise ValueError(f"{name}: inputs must be CUDA tensors")
    if codes.dtype != torch.uint8 or codes.dim() != 2 or lut.dim() != 2:
        raise ValueError(f"{name}: codes [N, M] uint8, lut [B, M*K]")
    m = codes.shape[1]
    b, mk = lut.shape
    if m % 4 or mk % m or not 1 <= mk // m <= 256:
        raise ValueError(f"{name}: need M % 4 == 0 and 1 <= K <= 256 "
                         f"(M={m}, M*K={mk})")
    if codes.shape[0] < n_tiles * ADC_TILE_N or n_tiles < 1:
        raise ValueError(f"{name}: codes must cover {n_tiles} tiles")
    if not (codes.is_contiguous() and lut.is_contiguous()) or codes.data_ptr() % 16:
        raise ValueError(f"{name}: inputs must be contiguous, codes 16-byte "
                         "aligned")
    return b, m, mk // m


def _outputs(b, cols, device):
    return (torch.empty((b, cols), dtype=torch.float32, device=device),
            torch.empty((b, cols), dtype=torch.int32, device=device))


def _rerank_args(q, i8_codes, i8_scales, i8_norms2, n_rows, b, name):
    d = q.shape[1] if q.dim() == 2 else -1
    if (q.dtype != torch.float32 or q.shape[0] != b or d % 4 or d < 4
            or i8_codes.dtype != torch.int8 or i8_codes.shape[1:] != (d,)
            or i8_codes.shape[0] < n_rows):
        raise ValueError(f"{name}: q [{b}, D] f32 (D % 4 == 0), i8 rows "
                         f"[>= {n_rows}, D] int8")
    args = [q, i8_codes]
    for v in (i8_scales, i8_norms2):
        if v.dtype != torch.float32 or v.dim() != 1 or v.shape[0] < n_rows:
            raise ValueError(f"{name}: scales and norms2 [>= {n_rows}] f32")
        args.append(v)
    if not all(a.is_cuda and a.is_contiguous() for a in args) or (
            i8_codes.data_ptr() % 4 or q.data_ptr() % 16):
        raise ValueError(f"{name}: rerank inputs must be contiguous CUDA "
                         "tensors, aligned")
    return d, [a.data_ptr() for a in args]


def adc_pallas_scan(codes, lut_flat, *, n_tiles: int, t_per_tile: int = 4
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B10: per-tile candidate scan.  Returns (-dist [B, T*n_tiles] f32,
    rows int32); column j*T + t holds tile j's t-th pick.  An int8 LUT gives
    distances in that row's quantized units (per-row selection only).
    Replaces erlvectordb_tpu ``adc_pallas_scan``."""
    if codes.device.type == "cpu":
        return adc_pallas_scan_ref(codes, lut_flat, n_tiles, t_per_tile)
    from erlvectordb_tpu_torch.ops import cuda_lib

    b, m, k = _check_codes(codes, lut_flat, n_tiles, "adc_pallas_scan")
    if lut_flat.dtype not in (torch.int8, torch.float32):
        raise ValueError("adc_pallas_scan: the LUT must be int8 or f32")
    if not 1 <= t_per_tile <= 32:
        raise ValueError(f"adc_pallas_scan: t_per_tile {t_per_tile}")
    variant = "int8" if lut_flat.dtype == torch.int8 else "bf16"
    vals, rows = _outputs(b, n_tiles * t_per_tile, codes.device)
    lib = cuda_lib.library()
    if variant == "int8":
        s = adc_layout(b, m, k, t_per_tile)["s"]
        rc = lib.evdb_adc_scan_i8(
            codes.data_ptr(), pack_lut(lut_flat, m, s).data_ptr(), b, m, k, s,
            n_tiles, t_per_tile, vals.data_ptr(), rows.data_ptr(), _stream())
    else:
        lay = adc_bf16_layout(b, m, k, t_per_tile)
        rc = lib.evdb_adc_scan_bf16(
            codes.data_ptr(), lut_flat.data_ptr(), b, m, k, lay["s"],
            lay["h"], lay["nbuf"], n_tiles, t_per_tile, vals.data_ptr(),
            rows.data_ptr(), _stream())
    cuda_lib.check(rc, "adc_pallas_scan")
    _count(adc_pallas_scan, variant)
    return vals, rows


def adc_exact_scan(codes, lut_q, q, i8_codes, i8_scales, i8_norms2, n_tiles,
                   t_per_tile):
    """B9: B10 over an int8 LUT with each pick exactly reranked; returns
    (-d2 [B, T*n_tiles] f32, rows int32).  Replaces the erlvectordb_tpu
    ``_make_adc_exact_kernel`` call of ``adc_search_exact_fused``."""
    if codes.device.type == "cpu":
        return adc_exact_scan_ref(codes, lut_q, q, i8_codes, i8_scales,
                                  i8_norms2, n_tiles, t_per_tile)
    return _rerank_scan(adc_exact_scan, codes, lut_q, q, i8_codes, i8_scales,
                        i8_norms2, n_tiles, t_per_tile, False)


def adc_pos_scan(codes, lut_q, q, i8_codes, i8_scales, i8_norms2, n_slices):
    """B8: the top-2 of each 1024-row slice by the packed key (ties to the
    higher row), each exactly reranked; returns (-d2 [B, 2*n_slices] f32,
    rows int32), column 2s + c.  Replaces the erlvectordb_tpu
    ``_make_adc_pos_kernel`` call of ``adc_search_exact_pos``."""
    if codes.device.type == "cpu":
        return adc_pos_scan_ref(codes, lut_q, q, i8_codes, i8_scales,
                                i8_norms2, n_slices)
    return _rerank_scan(adc_pos_scan, codes, lut_q, q, i8_codes, i8_scales,
                        i8_norms2, n_slices, 2, True)


def _rerank_scan(fn, codes, lut_q, q, i8_codes, i8_scales, i8_norms2,
                 n_tiles, t, high_lane):
    from erlvectordb_tpu_torch.ops import cuda_lib

    name = fn.__name__
    b, m, k = _check_codes(codes, lut_q, n_tiles, name)
    if lut_q.dtype != torch.int8:
        raise ValueError(f"{name}: the LUT must be int8")
    d, ptrs = _rerank_args(q, i8_codes, i8_scales, i8_norms2,
                           n_tiles * ADC_TILE_N, b, name)
    s = adc_layout(b, m, k, t)["s"]
    packed = pack_lut(lut_q, m, s)
    vals, rows = _outputs(b, n_tiles * t, codes.device)
    lib = cuda_lib.library()
    cuda_lib.check(lib.evdb_adc_rerank_scan(
        codes.data_ptr(), packed.data_ptr(), *ptrs, b, m, k, s, d, n_tiles,
        t, int(high_lane), vals.data_ptr(), rows.data_ptr(), _stream()), name)
    _count(fn, "int8")
    return vals, rows


KERNELS = (adc_pos_scan, adc_exact_scan, adc_pallas_scan)


def reset_launches() -> None:
    """Zero B8-B10's launch counts (``launches`` and ``launches_by``)."""
    for k in KERNELS:
        k.launches = 0
        k.launches_by = {}


reset_launches()


# ------------------------------------------------------------ the searches


def adc_search_exact_fused(pq_codes, codebooks, i8_codes, i8_scales,
                           i8_norms2, queries, n_valid, *, k: int,
                           n_tiles: int, t_per_tile: int = 4):
    """Single pass: ADC select from the min-shifted int8 LUT + exact rerank
    of every tile's picks (B9) + top-k merge.  ``pq_codes`` [N_pad, M] with
    N_pad >= n_tiles * 1024; rows >= n_valid are padding.  Returns
    (distances [B, k], rows [B, k])."""
    lut_q = quantize_lut(_adc_l2_tables(queries, codebooks), shift=True)
    t = exact_t(n_tiles, t_per_tile)
    vals, rows = adc_exact_scan(pq_codes, lut_q, queries, i8_codes,
                                i8_scales, i8_norms2, n_tiles, t)
    return _merge(vals, rows, n_valid, k)


def adc_search_exact_pos(pq_codes, codebooks, i8_codes, i8_scales, i8_norms2,
                         queries, n_valid, *, k: int, n_tiles: int,
                         sub: int = 8):
    """Packed-key ADC select (B8: the exactly reranked top-2 of every
    1024-row slice) + top-k merge.  ``pq_codes`` rows are padded to a
    multiple of ``sub`` * 1024; the scan covers n_big = min(ceil(n_tiles /
    sub), N_pad / (sub * 1024)) groups of ``sub`` slices.  Padding slices
    compete in their slice and are masked only before the merge, as in the
    JAX package."""
    lut_q = quantize_lut(_adc_l2_tables(queries, codebooks), shift=True)
    big_n = sub * ADC_TILE_N
    n_cap = pq_codes.shape[0]
    if n_cap % big_n:
        raise ValueError(f"pq_codes rows ({n_cap}) must be padded to a "
                         f"multiple of {big_n}")
    n_big = min(-(-n_tiles // sub), n_cap // big_n)
    vals, rows = adc_pos_scan(pq_codes, lut_q, queries, i8_codes, i8_scales,
                              i8_norms2, n_big * sub)
    return _merge(vals, rows, n_valid, k)


def adc_search_fused(pq_codes, codebooks, i8_codes, i8_scales, queries,
                     n_valid, *, k: int, c: int = 2048, n_tiles: int):
    """ADC scan (B10 from the int8 LUT) -> candidate pool of ``c`` -> exact
    int8 rerank -> top-k.  Rows >= n_valid are padding and never returned.
    Returns (distances [B, k], rows [B, k])."""
    lut_q = quantize_lut(_adc_l2_tables(queries, codebooks), shift=False)
    t = exact_t(n_tiles, 4, min(c, 512))
    vals, rows = adc_pallas_scan(pq_codes, lut_q, n_tiles=n_tiles,
                                 t_per_tile=t)
    cc = min(c, vals.shape[1])
    _, sel = topk_stable(vals, cc)
    cand = torch.gather(rows, 1, sel).long()                  # [B, cc]
    x = i8_codes[cand].float() * i8_scales[cand][:, :, None]
    with full_f32_matmul():
        dots = torch.einsum("bcd,bd->bc", x, queries)
    xn2 = torch.sum(x * x, dim=-1)
    qsq = torch.sum(queries * queries, dim=-1, keepdim=True)
    d2 = qsq - 2.0 * dots + xn2
    d2 = torch.where(cand < int(n_valid), d2, float("inf"))
    neg, ksel = topk_stable(-d2, min(k, cc))
    return (torch.sqrt(torch.clamp(-neg, min=0.0)),
            torch.gather(cand, 1, ksel).to(torch.int32))
