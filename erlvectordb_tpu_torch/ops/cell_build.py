"""Device-side streaming cell build — centroids, balanced assignment and
residual encode, with no O(N)-sized host round-trip.

Counterpart of ``erlvectordb_tpu/ops/cell_build.py``: packed int4 residual
cells for the int4r store (``residual_bits=4``) and int8 residual cells for
the cell-probe index (``residual_bits=8``).  Every per-row intermediate — staged codes, choice
lists, owners, ranks, slot positions — stays on the device; the host reads
back [K]-sized cell stats and scalars.  Phases:

  stage   corpus chunks -> int8 row codes (absmax/127) + scales + norms, the
          build's working set (a quarter of the f32 corpus), plus a strided
          training sample.
  seed    k-means centroids on the sample (ops/kmeans.py).
  route   [N, j] nearest-cell preference lists, one routing sub-chunk of
          ``route_sub`` rows at a time (bounds the [sub, K] temps).  The
          int8 x int8 dots are exact in an f32 product with TF32 off (sums
          stay below 2^24 for W <= 1040).
  assign  capacity-constrained greedy, closest-first (_assign_capacity):
          each cell accepts its closest proposals up to remaining capacity,
          rejected rows walk down their preference list.
  refit   capacity-constrained Lloyd: refit each centroid to the members it
          actually got, then re-route and re-assign.
  spill   (``spill_mult > 0``) SOAR-style second copies: a row whose
          closest other cell is within ``spill_mult`` of its owner's
          distance proposes a copy there, placed after the primary rows
          where space is left (one acceptance round, no dump).
  place   slot positions from one stable argsort of the owner vector.
  encode  residual quantize to packed int4 (per-row clip sweep) or int8
          (absmax, in place) in the cell-major slot layout, block by block.

The JAX package's TPU accommodations (buffer donation, the allocator
priming, phase barriers for its allocator) have no counterpart here: PyTorch
frees a buffer when its last reference goes.
"""

from __future__ import annotations

import time
from typing import Iterable, NamedTuple, Optional

import numpy as np
import torch

from erlvectordb_tpu_torch.core.store import default_device
from erlvectordb_tpu_torch.ops.fused_topk import (
    div_scalar,
    full_f32_matmul,
    mul_recip,
)
from erlvectordb_tpu_torch.ops.kmeans import (
    kmeans_fit,
    segment_sum_dtype,
    segment_sums_,
)

# Inputs above this row count finish the assignment in levels of a few
# rounds that give up early when a level places < 5% of its active rows.
_TAIL_MIN_N = 1 << 20


def _pad128(d: int) -> int:
    return -(-d // 128) * 128


class CellBuildResult(NamedTuple):
    """Device-resident cell build output (perm maps slot -> original row)."""

    centroids: torch.Tensor     # [K, W] f32 (trailing cells may be empty)
    codes: torch.Tensor         # [S, W//2] uint8 (int4 packed) or [S, W] int8
    scales: torch.Tensor        # [S] f32 per-row residual scales
    norms: torch.Tensor         # [S] f32 reconstruction norms
    valid: torch.Tensor         # [S] bool
    perm: torch.Tensor          # [S] int32 original row at slot (-1 empty)
    counts: np.ndarray          # [K] int64 rows per cell (host)
    n_cells: int
    cell_cap: int
    stats: dict


# --------------------------------------------------------------------- stage


def _quantize_rows_int8(x: torch.Tensor):
    """Per-row absmax int8 codes and scales."""
    am = x.abs().amax(dim=-1)
    s = torch.where(am > 0, mul_recip(am, 127.0), torch.ones_like(am))
    return torch.clamp(torch.round(x / s[:, None]), -127, 127).to(torch.int8), s


def _stage_chunk(codes8, scales, norms, chunk, at, *, w):
    """Quantize one f32 chunk to int8 rows and write it at row ``at``."""
    x = chunk.float()
    if x.shape[1] != w:
        x = torch.nn.functional.pad(x, (0, w - x.shape[1]))
    q, s = _quantize_rows_int8(x)
    codes8[at:at + x.shape[0]] = q
    scales[at:at + x.shape[0]] = s
    norms[at:at + x.shape[0]] = torch.sqrt(torch.sum(x * x, dim=-1))


def _stage_sample(sample, chunk, at, *, stride, take, w):
    """Strided training rows from a chunk into the sample buffer."""
    rows = chunk[::stride][:take].float()
    if rows.shape[1] != w:
        rows = torch.nn.functional.pad(rows, (0, w - rows.shape[1]))
    sample[at:at + rows.shape[0]] = rows


# --------------------------------------------------------------------- route


def _choices_all(codes8, scales, cents8, cscale, cn2, *, j, sub, step=1):
    """[N', j] nearest-cell preference lists (proxy distance |c|^2 - 2 x.c,
    ascending) over every step-th ``sub``-row sub-chunk of the staged int8
    corpus.  Returns (dists f32, cells int32)."""
    n_sub = codes8.shape[0] // (sub * step)
    d = torch.empty((n_sub * sub, j), dtype=torch.float32, device=codes8.device)
    i = torch.empty((n_sub * sub, j), dtype=torch.int32, device=codes8.device)
    c8t = cents8.float().T
    cs = cscale[None, :]
    with full_f32_matmul():
        for c in range(n_sub):
            r0 = c * sub * step
            di = codes8[r0:r0 + sub].float() @ c8t   # exact: |sum| < 2^24
            dots = di * (scales[r0:r0 + sub, None] * cs)
            negd, ids = torch.topk(-(cn2[None, :] - 2.0 * dots), j, dim=1)
            d[c * sub:(c + 1) * sub] = -negd
            i[c * sub:(c + 1) * sub] = ids.to(torch.int32)
    return d, i


# -------------------------------------------------------------------- assign


class _Rounds:
    """Acceptance rounds over fixed choice lists.

    INVARIANT: a row advances its preference pointer exactly once per round
    it stays active (rejected), so at round r every active row proposes its
    choice column r.  All active proposals are sorted by (cell, distance)
    and each cell accepts its closest proposals up to remaining capacity.
    For k < 32768 the sort key packs the cell into the high bits and the
    distance, globally quantized to 16 bits, below it."""

    def __init__(self, ch_d, ch_i, row_valid, *, k, cap, j):
        self.chd = ch_d.float()
        self.ch_i = ch_i.long()
        self.row_valid = row_valid
        self.k, self.cap, self.j = k, cap, j
        self.n = ch_d.shape[0]
        self.rows_idx = torch.arange(self.n, device=ch_d.device)
        self.packed = k < 32768
        if self.packed:
            # quantization range over FINITE entries only
            finite = torch.isfinite(self.chd)
            inf = torch.full_like(self.chd, float("inf"))
            self.dmin = torch.amin(torch.where(finite, self.chd, inf))
            dmax = torch.amax(torch.where(finite, self.chd, -inf))
            self.dspan = torch.clamp(dmax - self.dmin, min=1e-20)

    def run(self, owner, fill, r0, max_rounds, n_stop):
        """Up to ``max_rounds`` rounds from global round ``r0``, stopping once
        at most ``n_stop`` rows are active.  Returns (rounds run, active)."""
        k = self.k
        n_act = int(torch.sum((owner < 0) & self.row_valid))
        rnd = 0
        while n_act > n_stop and rnd < max_rounds:
            act = (owner < 0) & self.row_valid
            col = min(r0 + rnd, self.j - 1)
            cell = torch.where(act, self.ch_i[:, col],
                               torch.full_like(self.ch_i[:, col], k))
            dist_col = self.chd[:, col]
            if self.packed:
                dq = torch.clamp((dist_col - self.dmin) / self.dspan * 65534.0,
                                 0, 65534).long()
                dq = torch.where(act, dq, torch.full_like(dq, 65535))
                skey, sr = torch.sort(cell * 65536 + dq, stable=True)
                sc = skey >> 16
            else:
                dist = torch.where(act, dist_col,
                                   torch.full_like(dist_col, float("inf")))
                by_d = torch.sort(dist, stable=True).indices
                by_c = torch.sort(cell[by_d], stable=True).indices
                sr = by_d[by_c]
                sc = cell[sr]
            starts = torch.searchsorted(
                sc, torch.arange(k + 1, device=sc.device))
            rem = torch.cat([torch.clamp(self.cap - fill, min=0),
                             fill.new_zeros(1)])
            cutoff = starts + rem
            acc = (sc < k) & (self.rows_idx < cutoff[torch.clamp(sc, 0, k)])
            owner[sr[acc]] = sc[acc].to(owner.dtype)
            fill += torch.bincount(sc[acc], minlength=k + 1)[:k].to(fill.dtype)
            n_act = int(torch.sum((owner < 0) & self.row_valid))
            rnd += 1
        return rnd, n_act


def _assign_finish(owner, fill, row_valid, *, k, cap, dump):
    """Dump pass: unplaced rows -> cells with space (prefix sum over the
    remaining capacities).  Invalid rows get owner k."""
    left = (owner < 0) & row_valid
    if dump:
        cum_space = torch.cumsum(torch.clamp(cap - fill, min=0), dim=0)
        lrank = torch.cumsum(left.long(), dim=0) - 1
        dump_cell = torch.clamp(
            torch.searchsorted(cum_space, lrank, right=True), 0, k - 1)
        owner = torch.where(left, dump_cell.to(owner.dtype), owner)
        owner = torch.where(row_valid, owner, torch.full_like(owner, k))
    else:
        owner = torch.where(owner < 0, torch.full_like(owner, k), owner)
    return owner, int(torch.sum(left))


def _assign_capacity(ch_d, ch_i, row_valid, *, k, cap, j, fill0=None,
                     dump=True, stop_frac=1 / 4096, stats_out=None):
    """Capacity-constrained greedy assignment, closest-first (see _Rounds).

    The walk stops once fewer than ``stop_frac * n`` rows remain active; the
    stragglers take the dump pass.  Inputs above _TAIL_MIN_N rows run two
    rounds, then levels of up to four, abandoning the walk when a level
    places < 5% of its active rows (every remaining preference entry points
    at a full cell).  ``fill0`` seeds the per-cell occupancy (spill rounds
    start from the primary fill); ``dump=False`` skips the dump pass (an
    unplaced spill copy is simply not made).  ``stats_out`` receives
    ``rounds`` (rounds run) and ``rounds_cap`` (= j).  Returns (owner [N] int32 in [0, k), k for
    invalid/unplaced rows; number of rows the dump pass placed)."""
    n = ch_d.shape[0]
    n_stop = 0 if j <= 1 else int(n * stop_frac)
    owner = torch.full((n,), -1, dtype=torch.int32, device=ch_d.device)
    fill = (torch.zeros((k,), dtype=torch.int64, device=ch_d.device)
            if fill0 is None else fill0.to(torch.int64).clone())
    rounds = _Rounds(ch_d, ch_i, row_valid, k=k, cap=cap, j=j)
    if n <= _TAIL_MIN_N or j <= 1:
        rounds_done, _ = rounds.run(owner, fill, 0, j, n_stop)
    else:
        rounds_done, na = rounds.run(owner, fill, 0, 2, 0)
        while na > n_stop and rounds_done < j:
            ran, na_new = rounds.run(owner, fill, rounds_done,
                                     min(4, j - rounds_done), n_stop)
            rounds_done += ran
            na_prev, na = na, na_new
            if na > n_stop and na_prev - na < max(int(0.05 * na_prev), 1):
                break
    if stats_out is not None:
        stats_out["rounds"] = rounds_done
        stats_out["rounds_cap"] = j
    return _assign_finish(owner, fill, row_valid, k=k, cap=cap, dump=dump)


def _refit_centroids(codes8, scales, owner, cents_old, *, k, sub, step=1):
    """Mean of each cell's actual members over the staged int8 corpus
    (``owner`` indexes every step-th ``sub``-row sub-chunk densely); empty
    cells keep their old centroid."""
    w = codes8.shape[1]
    sums = torch.zeros((k + 1, w), dtype=segment_sum_dtype(codes8.device),
                       device=codes8.device)
    cnt = torch.zeros((k + 1,), dtype=torch.float32, device=codes8.device)
    o_all = owner.long()
    for c in range(owner.shape[0] // sub):
        r0 = c * sub * step
        x = codes8[r0:r0 + sub].float() * scales[r0:r0 + sub, None]
        segment_sums_(sums, cnt, o_all[c * sub:(c + 1) * sub], x)
    cents = (sums[:k] / torch.clamp(cnt[:k], min=1.0)[:, None]).float()
    return torch.where((cnt[:k] > 0.5)[:, None], cents, cents_old)


# --------------------------------------------------------------------- place


def _positions(owner, *, k, cap, base=None):
    """Slot position per row (pos = cell * cap + base[cell] + rank within
    the cell) from one stable argsort of the owner vector; invalid rows
    (owner == k) get positions past any layout.  ``base`` seeds per-cell
    slot offsets (spill copies go after the primary rows)."""
    n = owner.shape[0]
    order = torch.sort(owner.long(), stable=True).indices
    so = owner.long()[order]
    starts = torch.searchsorted(so, torch.arange(k + 1, device=so.device))
    rank = torch.arange(n, device=so.device) - starts[torch.clamp(so, 0, k)]
    if base is not None:
        rank = rank + base.long()[torch.clamp(so, 0, k - 1)]
    pos_sorted = torch.where(so < k, so * cap + rank,
                             torch.full_like(so, 1 << 30))
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos


def _spill_proposals(ch_d, ch_i, owner, *, k, spill_mult, xn2):
    """Secondary-cell (SOAR-style multi-assignment) proposals: for each
    placed row, the closest choice cell that is not its owner, eligible when
    its full squared distance is within ``spill_mult**2`` of the owner
    cell's.  ch_d holds the routing proxy |c|^2 - 2 x.c; adding |x|^2
    recovers squared distances for the ratio test.  Returns (cell [N]
    int32, proxy distance [N] f32 (inf where ineligible), eligible [N])."""
    inf = float("inf")
    chd = ch_d.float()
    is_owner = ch_i.long() == owner.long()[:, None]
    # the owner's own proxy distance (inf if the row was dump-placed off its
    # list: then there is no trustworthy margin, so no spill)
    own_d = torch.where(is_owner, chd, inf).amin(dim=1)
    masked = torch.where(is_owner, inf, chd)
    sec_col = torch.argmin(masked, dim=1, keepdim=True)
    sec_d = torch.gather(masked, 1, sec_col)[:, 0]
    sec_cell = torch.gather(ch_i, 1, sec_col)[:, 0].to(torch.int32)
    d2_own = torch.clamp(own_d + xn2, min=0.0)
    d2_sec = torch.clamp(sec_d + xn2, min=0.0)
    m = torch.tensor(spill_mult, dtype=torch.float32, device=chd.device)
    ok = ((owner < k) & torch.isfinite(own_d) & torch.isfinite(sec_d)
          & (d2_sec <= m * m * d2_own))
    return sec_cell, torch.where(ok, sec_d, inf), ok


# -------------------------------------------------------------------- encode


def _quantize_residual_int4(res, x=None, aniso_eta=1.0):
    """Per-row clip-swept int4 residual quantization: candidate scales (clip
    fractions of absmax) scored by MSE, or with ``aniso_eta > 1`` by the
    anisotropic loss |e|^2 + (eta - 1) (e . x/|x|)^2, which weights the
    error parallel to the row (what shifts its inner-product score)."""
    absmax = res.abs().amax(dim=-1)
    use_aniso = x is not None and aniso_eta > 1.0
    if use_aniso:
        xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
        u = x / torch.clamp(xn, min=1e-9)
    best_q = best_s = best_e = None
    for c in (0.6, 0.7, 0.8, 0.9, 1.0):
        s = torch.where(absmax > 0, div_scalar(c * absmax, 7.0),
                        torch.ones_like(absmax))
        q = torch.clamp(torch.round(res / s[:, None]), -7, 7).to(torch.int8)
        err = q.float() * s[:, None] - res
        e = torch.sum(err * err, dim=-1)
        if use_aniso:
            par = torch.sum(err * u, dim=-1)
            e = e + (aniso_eta - 1.0) * par * par
        if best_q is None:
            best_q, best_s, best_e = q, s, e
        else:
            take = e < best_e
            best_q = torch.where(take[:, None], q, best_q)
            best_s = torch.where(take, s, best_s)
            best_e = torch.minimum(e, best_e)
    return best_q, best_s


def _pack_int4(q):
    """[R, W] int4-valued int8 -> [R, W/2] uint8, dim 2p in the high nibble
    (the store's packing)."""
    u = (q.to(torch.int16) & 0xF).to(torch.uint8)
    return (u[:, 0::2] << 4) | u[:, 1::2]


def _slot_scatter(slot8, slot_sc, slot_pm, codes8, scales_in, owner, pos, *, k):
    """Scatter staged rows into the slot (cell-major) layout; rows whose
    position falls past the layout (owner == k) are dropped."""
    s_total = slot8.shape[0]
    keep = pos < s_total
    p = pos[keep]
    slot8[p] = codes8[keep]
    slot_sc[p] = scales_in[keep]
    orig = torch.arange(codes8.shape[0], device=codes8.device, dtype=torch.int32)
    slot_pm[p] = torch.where(owner[keep] < k, orig[keep],
                             torch.full_like(orig[keep], -1))


def _encode_slots(slot8, slot_sc, slot_pm, cents_pad, *, bits, cap, blk,
                  aniso_eta=1.0):
    """Residual-quantize the slot-ordered staged rows block by block: in slot
    order a block of ``blk`` cells sees its centroids as one contiguous
    slice broadcast across ``cap`` slots.  ``bits`` 4: packed int4 codes
    (per-row clip sweep); 8: int8 absmax codes written over ``slot8`` in
    place, with the scale absmax * f32(1/127) as the JAX package computes
    it.  Returns (codes, scales, reconstruction norms, valid)."""
    s_total, w = slot8.shape
    rows_blk = blk * cap
    live = slot_pm >= 0
    out_codes = (torch.zeros((s_total, w // 2), dtype=torch.uint8,
                             device=slot8.device) if bits == 4 else slot8)
    out_scales = slot_sc.clone()
    out_norms = torch.zeros((s_total,), dtype=torch.float32, device=slot8.device)
    for b in range(s_total // rows_blk):
        sl = slice(b * rows_blk, (b + 1) * rows_blk)
        lv = live[sl]
        cent = cents_pad[b * blk:(b + 1) * blk].repeat_interleave(cap, dim=0)
        if bits == 4:
            x = slot8[sl].float() * out_scales[sl, None]
            res = torch.where(lv[:, None], x - cent, torch.zeros_like(x))
            q, s = _quantize_residual_int4(res, x, aniso_eta)
            out_codes[sl] = _pack_int4(torch.where(lv[:, None], q,
                                                   torch.zeros_like(q)))
        else:
            # code * scale - centroid with one rounding: XLA contracts the
            # JAX encode's multiply and subtract into a fused multiply-add
            # (the float64 product of an int8 code and an f32 scale is exact)
            res = (slot8[sl].double() * out_scales[sl, None].double()
                   - cent.double()).float()
            res = torch.where(lv[:, None], res, torch.zeros_like(res))
            q, s = _quantize_rows_int8(res)
            out_codes[sl] = torch.where(lv[:, None], q, torch.zeros_like(q))
        recon = cent + q.float() * s[:, None]
        out_norms[sl] = torch.where(lv, torch.sqrt(torch.sum(recon * recon,
                                                             dim=-1)),
                                    torch.zeros_like(s))
        out_scales[sl] = torch.where(lv, s, torch.ones_like(s))
    return out_codes, out_scales, out_norms, live


# --------------------------------------------------------------------- build


def build_cells_streaming(
    chunks: Iterable,           # [CH, dim] f32 chunks (host arrays or tensors)
    *,
    n: int,                     # total rows (sum of chunk rows)
    dim: int,
    cell_rows: int = 96,        # target rows per cell
    cell_cap: int = 128,        # physical slots per cell
    residual_bits: int = 4,     # 4 (packed, int4r store) | 8 (CellProbe)
    j: int = 16,                # preference-list depth
    refits: int = 1,            # capacity-constrained Lloyd rounds
    refit_sample: Optional[float] = None,  # pre-refit rounds run on this
    #                             fraction of the corpus (every step-th
    #                             sub-chunk); default 0.25 for cells of
    #                             >= 256 rows, else 0.5
    final_refit: bool = True,   # refit centroids to their ACTUAL members
    #                             after the last assignment, encode against
    #                             those
    spill_mult: float = 0.0,    # SOAR-style multi-assignment: rows whose
    #                             second-closest cell is within this factor
    #                             of the owner distance get a second copy
    #                             there (0 = off); copies share the perm row,
    #                             so consumers dedup by row
    aniso_eta: float = 1.0,     # >1: anisotropic loss for the clip sweep
    seed: int = 0,
    train_rows: int = 262_144,
    kmeans_iters: int = 8,
    kmeans_init: str = "kpp",
    kmeans_balance: float = 0.0,  # > 0: capacity-constrained Lloyd training
    k_block: int = 64,          # pad the cell count to a multiple
    route_sub: int = 8192,      # rows per routing sub-chunk (bounds [sub, K])
    device=None,
) -> CellBuildResult:
    """Streaming device build of a balanced cell-residual layout.

    ``n`` must be exact; every chunk except the last must have the same row
    count.  Returns device tensors ready to serve as an int4r VectorStore
    (bits 4) or a CellProbeIndex (bits 8), on ``device`` (default: the CUDA
    card)."""
    if residual_bits not in (4, 8):
        raise ValueError("residual_bits must be 4 or 8")
    if refit_sample is None:
        refit_sample = 0.25 if cell_rows >= 256 else 0.5
    if cell_cap < cell_rows:
        raise ValueError(
            f"cell_cap ({cell_cap}) must be >= cell_rows ({cell_rows})")
    if n <= 0:
        raise ValueError("n must be positive")
    dev = torch.device(device) if device is not None else default_device()
    t_start = time.perf_counter()
    w = _pad128(dim)
    k_real = max(1, -(-n // cell_rows))
    k_total = -(-k_real // k_block) * k_block
    if k_real * cell_cap < n:
        raise ValueError(
            f"{k_real} cells x {cell_cap} slots < {n} rows; raise cell_cap")

    # ---- stage ----------------------------------------------------------
    chunks = iter(chunks)
    first = next(chunks)
    ch = int(first.shape[0])
    n_chunks = -(-n // ch)
    npad = n_chunks * ch
    codes8 = torch.zeros((npad, w), dtype=torch.int8, device=dev)
    scales = torch.ones((npad,), dtype=torch.float32, device=dev)
    norms = torch.zeros((npad,), dtype=torch.float32, device=dev)
    train_rows = min(n, max(train_rows, 3 * k_real))
    spc = -(-train_rows // n_chunks)           # sample rows per chunk
    stride = max(1, ch // spc)
    sample = torch.zeros((n_chunks * spc, w), dtype=torch.float32, device=dev)
    for i in range(n_chunks):
        try:
            chunk = first if i == 0 else next(chunks)
        except StopIteration:
            raise ValueError(
                f"chunks exhausted after {i * ch} rows, expected n={n}")
        if chunk.shape[0] != ch and i != n_chunks - 1:
            raise ValueError("all chunks but the last must be equal length")
        chunk = torch.as_tensor(chunk, dtype=torch.float32, device=dev)
        if chunk.shape[0] < ch:                # pad the final short chunk
            chunk = torch.nn.functional.pad(chunk, (0, 0, 0, ch - chunk.shape[0]))
        _stage_chunk(codes8, scales, norms, chunk, i * ch, w=w)
        _stage_sample(sample, chunk, i * spc, stride=stride, take=spc, w=w)
    del chunk, first
    row_valid = torch.arange(npad, device=dev) < n
    t_stage = time.perf_counter()

    # ---- seed k-means ---------------------------------------------------
    cents, _ = kmeans_fit(sample[:train_rows], seed, k=k_real,
                          iters=kmeans_iters, init=kmeans_init,
                          balance=kmeans_balance)
    del sample
    t_seed = time.perf_counter()

    # ---- route + assign (+ capacity-constrained Lloyd refits) -----------
    jj = min(j, k_real)
    sub = min(route_sub, npad)
    while npad % sub:
        sub //= 2
    step_h = max(1, int(round(1.0 / max(refit_sample, 1e-6))))
    half_ok = refit_sample < 1.0 and npad >= 2 * step_h * sub
    if half_ok:
        # the sub-chunks the strided routing visits, exactly
        n_half = npad // (sub * step_h)
        rv_h = row_valid.reshape(-1, sub)[::step_h][:n_half].reshape(-1)
        cap_h = max(1, int(cell_cap / step_h))
    asn_stats = {}
    n_dumped = 0
    for r in range(refits + 1):
        cents8, cscale = _quantize_rows_int8(cents)   # routing copy
        cn2 = torch.sum(cents * cents, dim=-1)
        if r < refits and half_ok:
            ch_d, ch_i = _choices_all(codes8, scales, cents8, cscale, cn2,
                                      j=jj, sub=sub, step=step_h)
            # dump=True keeps every row in the means: on contended corpora
            # most rows exhaust their lists before the refit, and leaving
            # them out freezes the Lloyd feedback loop
            owner_h, _ = _assign_capacity(ch_d, ch_i, rv_h, k=k_real,
                                          cap=cap_h, j=jj)
            cents = _refit_centroids(codes8, scales, owner_h, cents,
                                     k=k_real, sub=sub, step=step_h)
            del ch_d, ch_i, owner_h
            continue
        ch_d, ch_i = _choices_all(codes8, scales, cents8, cscale, cn2,
                                  j=jj, sub=sub)
        asn_stats = {}
        owner, n_dumped = _assign_capacity(ch_d, ch_i, row_valid, k=k_real,
                                           cap=cell_cap, j=jj,
                                           stats_out=asn_stats)
        if r < refits:
            del ch_d, ch_i
            cents = _refit_centroids(codes8, scales, owner, cents,
                                     k=k_real, sub=sub)
    if final_refit:
        cents = _refit_centroids(codes8, scales, owner, cents, k=k_real,
                                 sub=sub)
    t_assign = time.perf_counter()

    # ---- place: slot-scatter the staged rows ----------------------------
    pos = _positions(owner, k=k_real, cap=cell_cap)
    counts_dev = torch.bincount(owner[row_valid].long(),
                                minlength=k_real + 1)[:k_real]
    n_spilled = 0
    sp_owner = sp_pos = None
    if spill_mult:
        # spill routing reads the last full pass's choice lists, before the
        # slot arrays exist
        sc_cell, sc_d, sc_ok = _spill_proposals(
            ch_d, ch_i, owner, k=k_real, spill_mult=spill_mult,
            xn2=norms * norms)
        sp_owner, _ = _assign_capacity(
            sc_d[:, None], sc_cell[:, None], sc_ok, k=k_real, cap=cell_cap,
            j=1, fill0=counts_dev, dump=False)
        sp_pos = _positions(sp_owner, k=k_real, cap=cell_cap, base=counts_dev)
        del sc_cell, sc_d, sc_ok
    del ch_d, ch_i, norms
    t_spill = time.perf_counter()
    s_total = k_total * cell_cap
    slot8 = torch.zeros((s_total, w), dtype=torch.int8, device=dev)
    slot_sc = torch.ones((s_total,), dtype=torch.float32, device=dev)
    slot_pm = torch.full((s_total,), -1, dtype=torch.int32, device=dev)
    _slot_scatter(slot8, slot_sc, slot_pm, codes8, scales, owner, pos, k=k_real)
    if sp_owner is not None:
        # spill copies ride the same scatter and encode: the slot's cell
        # decides the residual target, so a copy quantizes against its cell
        _slot_scatter(slot8, slot_sc, slot_pm, codes8, scales, sp_owner,
                      sp_pos, k=k_real)
        sp_counts = torch.bincount(sp_owner.long(),
                                   minlength=k_real + 1)[:k_real]
        counts_dev = counts_dev + sp_counts
        n_spilled = int(torch.sum(sp_counts))
        del sp_owner, sp_pos, sp_counts
    del codes8, scales, pos
    t_scatter = time.perf_counter()

    # ---- encode in slot order -------------------------------------------
    cents_pad = torch.nn.functional.pad(cents, (0, 0, 0, k_total - k_real))
    blk = max(1, 16384 // cell_cap)
    while k_total % blk:
        blk //= 2
    out_codes, out_scales, out_norms, out_valid = _encode_slots(
        slot8, slot_sc, slot_pm, cents_pad, bits=residual_bits, cap=cell_cap,
        blk=blk, aniso_eta=aniso_eta)
    del slot8, slot_sc
    counts = np.zeros((k_total,), np.int64)
    counts[:k_real] = counts_dev.cpu().numpy()
    t_encode = time.perf_counter()

    # early-stopped stragglers (dump-placed while they still had untried
    # choices) are reported apart from rows that exhausted their lists
    early = (n_dumped if asn_stats.get("rounds", jj)
             < asn_stats.get("rounds_cap", jj) else 0)
    stats = {
        "n": n,
        "n_cells": k_total,
        "n_cells_real": k_real,
        "cell_cap": cell_cap,
        "dumped_rows": n_dumped - early,
        "earlystop_rows": early,
        "spilled_rows": n_spilled,
        "residual_bits": residual_bits,
        "stage_s": round(t_stage - t_start, 3),
        "kmeans_s": round(t_seed - t_stage, 3),
        "assign_s": round(t_assign - t_seed, 3),
        "spill_s": round(t_spill - t_assign, 3),
        "scatter_s": round(t_scatter - t_spill, 3),
        "encode_s": round(t_encode - t_scatter, 3),
        "total_s": round(t_encode - t_start, 3),
        "vec_per_sec": round(n / max(t_encode - t_start, 1e-9), 1),
    }
    return CellBuildResult(
        centroids=cents_pad, codes=out_codes, scales=out_scales,
        norms=out_norms, valid=out_valid, perm=slot_pm, counts=counts,
        n_cells=k_total, cell_cap=cell_cap, stats=stats)
