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


def _tile_picks(codes, lut_flat, n_tiles, t, high_lane):
    """The t smallest distances of every 1024-row tile and their rows, ties
    to the lower row (or the higher one): (dists [B, n_tiles*t], rows)."""
    b = lut_flat.shape[0]
    n = n_tiles * ADC_TILE_N
    dists = torch.empty((b, n_tiles, t), dtype=(
        torch.int32 if lut_flat.dtype == torch.int8 else torch.float32),
        device=lut_flat.device)
    rows = torch.empty((b, n_tiles, t), dtype=torch.int64,
                       device=lut_flat.device)
    for r0 in range(0, n, _ROW_CHUNK):
        r1 = min(n, r0 + _ROW_CHUNK)
        d = _lut_dists(codes[r0:r1], lut_flat)
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
    if 8 * mk * 2 + ADC_TILE_N * m > 200 * 1024:
        raise ValueError(f"{name}: LUTs of M*K={mk} exceed the kernel's "
                         "shared memory")
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
    if 8 * 4 * d > 32 * 1024:
        raise ValueError(f"{name}: query rows of {d} f32 exceed the "
                         "kernel's shared memory")
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
    cuda_lib.check(lib.evdb_adc_scan(
        codes.data_ptr(), lut_flat.data_ptr(), int(variant == "bf16"), b, m, k,
        n_tiles, t_per_tile, vals.data_ptr(), rows.data_ptr(), _stream()),
        "adc_pallas_scan")
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
    vals, rows = _outputs(b, n_tiles * t, codes.device)
    lib = cuda_lib.library()
    cuda_lib.check(lib.evdb_adc_rerank_scan(
        codes.data_ptr(), lut_q.data_ptr(), *ptrs, b, m, k, d, n_tiles, t,
        int(high_lane), vals.data_ptr(), rows.data_ptr(), _stream()), name)
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
