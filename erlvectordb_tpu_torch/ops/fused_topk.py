"""Fused distance + top-k over a device-resident store — the hot path.

PyTorch/CUDA counterpart of ``erlvectordb_tpu/ops/fused_topk.py``.  Four
scans do the work, each a hand-written Hopper kernel in
``csrc/fused_topk.cu`` with a plain PyTorch version beside it:

  intkey_scan  (B1)  raw int32 dots on the int8 key plane, one packed
                     ``(dot << 10) | lane`` key per (query, 1024-row slice);
  l2key_scan   (B2)  the same with a per-row integer bias (euclidean);
  pos_scan     (B3)  scaled-int window keys over the absmax plane;
  fused_scan   (B4)  masked extraction: top-T per 4096-row tile of a
                     monotone float->int key.

Everything between the scans is plain tensor code and decides the result
exactly as the JAX package does: the affine factors, the key windows f/g,
the pool sizes (max(4k, 64) on the key paths, max(4k, 32) on masked
extraction), the ``t_per_tile`` rule, and the exact rescore of the pool.

All three matmul metrics rank by ``dot * q_mult * row_mult + row_bias``:

  cosine:    q_mult = q_scale/|q|, row_mult = scale/|x|, bias = 0
  dot:       q_mult = q_scale,     row_mult = scale,     bias = 0
  euclidean: q_mult = 2*q_scale,   row_mult = scale,     bias = -|x|^2

Invalid (deleted/padded) rows get bias -1e30.  Zero-norm rows/queries get
mult 0 — cosine similarity 0, distance 1.0, the reference's semantics.

Each scan wrapper runs its plain version for tensors on the CPU and its CUDA
kernel for tensors on a CUDA device (raising if the kernel cannot run); it
counts kernel launches in its ``launches`` attribute.  The TPU-only parts of
the JAX module are gone: query-tile padding, sub-tile grouping, VMEM budgets
and transposed output layouts.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Tuple

import torch

TILE_N = 4096        # rows per masked-extraction tile (top-T per tile)
MAX_T_PER_TILE = 8
POS_SLICE = 1024     # rows per key slice (top-1 per slice)
POS_LANE_MASK = POS_SLICE - 1
POS_MIN_TILES = 144  # ~590k rows: expected candidate loss < 0.8%/query
POS_MAX_K = 16
INTKEY_SHIFT = 10    # log2(POS_SLICE): low bits carry the lane
# keys carry (dot - bias) in the high 22 bits; clamping bias below 2^20
# keeps |(D - bias)| < 2^21 for W <= 2048, so the << 10 never wraps int32
L2KEY_BIAS_MAX = float(1 << 20)
# Opt-out: EVDB_EXACT_SCAN=1 disables the approximate pos/key paths so
# large-N searches stay on the (near-)exact masked-extraction scan.
POS_PATH_ENABLED = os.environ.get("EVDB_EXACT_SCAN", "0") != "1"

_NEG = -1e30
_ROW_CHUNK = 65536   # rows per step of the plain scans (bounds [B, rows] temps)


# ------------------------------------------------------------ plain versions


@contextlib.contextmanager
def full_f32_matmul():
    """f32 products in full f32: TF32 keeps ~3 decimal digits."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def div_scalar(a: torch.Tensor, s: float) -> torch.Tensor:
    """a / s as a true f32 division on every device (CUDA divides by a Python
    scalar as a * (1/s), which can differ in the last bit)."""
    return a / torch.tensor(s, dtype=a.dtype, device=a.device)


def _dots(q: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """[B, W] x [R, W] -> [B, R] f32.  Integer codes are multiplied exactly
    in float64 (|dot| < 2^53) and land exactly in f32 (|dot| < 2^24)."""
    if codes.dtype == torch.int8:
        return (q.double() @ codes.double().T).float()
    with full_f32_matmul():
        return q.float() @ codes.float().T


def _int_dots(q: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Exact int8 dots as int64 (computed in float64)."""
    return (q.double() @ codes.double().T).long()


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap (JAX's int32 arithmetic)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _slice_max(keys: torch.Tensor) -> torch.Tensor:
    b, r = keys.shape
    return keys.reshape(b, r // POS_SLICE, POS_SLICE).amax(dim=2)


def intkey_scan_ref(codes_unit, q_in, n_tiles):
    """Plain B1: keys [B, 4*n_tiles] int32, key = (dot << 10) | lane, max
    over each 1024-row slice."""
    n_rows = n_tiles * TILE_N
    out = []
    lane = torch.arange(POS_SLICE, device=q_in.device).repeat(_ROW_CHUNK // POS_SLICE)
    for r0 in range(0, n_rows, _ROW_CHUNK):
        c = codes_unit[r0:min(r0 + _ROW_CHUNK, n_rows)]
        d = _wrap_i32(_int_dots(q_in, c)).long()
        out.append(_slice_max(_wrap_i32((d << INTKEY_SHIFT) | lane[:c.shape[0]])))
    return torch.cat(out, dim=1)


def l2key_scan_ref(codes_mag, q_in, bias_int, n_tiles):
    """Plain B2: key = ((dot - bias[r]) << 10) | lane in int32 arithmetic."""
    n_rows = n_tiles * TILE_N
    out = []
    lane = torch.arange(POS_SLICE, device=q_in.device).repeat(_ROW_CHUNK // POS_SLICE)
    for r0 in range(0, n_rows, _ROW_CHUNK):
        r1 = min(r0 + _ROW_CHUNK, n_rows)
        d = _wrap_i32(_int_dots(q_in, codes_mag[r0:r1])
                      - bias_int[r0:r1].long()[None, :]).long()
        out.append(_slice_max(_wrap_i32((d << INTKEY_SHIFT) | lane[:r1 - r0])))
    return torch.cat(out, dim=1)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a*b + c with one rounding, as XLA compiles the JAX kernels'
    ``x * m + b`` (a fused multiply-add); taken in float64, where the product
    is exact."""
    return (a.double() * b.double() + c.double()).float()


def pos_scan_ref(codes, q, qm, f, g, m, b, n_tiles, use_qm):
    """Plain B3: s = (fma(dots*m (*qm), b) - f) * g, key =
    (int32(clip(round(s), +-2e9)) & ~1023) | lane, max per slice.  The JAX
    kernel's ``s * m (* qm) + b`` is one fused multiply-add as XLA compiles
    it; every other step is its own f32 op, in the JAX order."""
    n_rows = n_tiles * TILE_N
    out = []
    lane = torch.arange(POS_SLICE, device=q.device, dtype=torch.int32).repeat(
        _ROW_CHUNK // POS_SLICE)
    for r0 in range(0, n_rows, _ROW_CHUNK):
        r1 = min(r0 + _ROW_CHUNK, n_rows)
        dots = _dots(q, codes[r0:r1])
        if use_qm:
            s = _fma(dots * m[None, r0:r1], qm, b[None, r0:r1])
        else:
            s = _fma(dots, m[None, r0:r1], b[None, r0:r1])
        s = (s - f) * g
        si = torch.clamp(torch.round(s), -2.0e9, 2.0e9).to(torch.int32)
        out.append(_slice_max((si & ~POS_LANE_MASK) | lane[:r1 - r0]))
    return torch.cat(out, dim=1)


_IMIN = -(1 << 31)


def _float_key(sims: torch.Tensor) -> torch.Tensor:
    """Monotone f32 -> int32: float order becomes int order."""
    si = sims.contiguous().view(torch.int32).long()
    return _wrap_i32(torch.where(si >= 0, si, _IMIN - si))


def fused_scan_ref(codes, q, qmult, rowmult, rowbias, n_tiles, t_per_tile):
    """Plain B4: sims = fma(dots*qmult, rowmult, rowbias); packed key =
    (monotone key & ~0xFFF) | lane-in-tile; top-T per 4096-row tile.
    Returns (vals [B, T*n_tiles] f32, rows [B, T*n_tiles] int32), tile-major
    columns, each tile's T in descending order."""
    n_rows = n_tiles * TILE_N
    vals, rows = [], []
    lane = torch.arange(TILE_N, device=q.device, dtype=torch.int32).repeat(
        _ROW_CHUNK // TILE_N)
    for r0 in range(0, n_rows, _ROW_CHUNK):
        r1 = min(r0 + _ROW_CHUNK, n_rows)
        sims = _fma(_dots(q, codes[r0:r1]) * qmult, rowmult[None, r0:r1],
                    rowbias[None, r0:r1])
        packed = (_float_key(sims) & ~0xFFF) | lane[:r1 - r0]
        bq = packed.shape[0]
        top = torch.topk(packed.reshape(bq, -1, TILE_N), t_per_tile,
                         dim=2).values                       # [B, tiles, T]
        kt = (top & ~0xFFF).long()
        sr = _wrap_i32(torch.where(kt >= 0, kt, _IMIN - kt))
        vals.append(sr.view(torch.float32).reshape(bq, -1))
        base = torch.arange(r0, r1, TILE_N, device=q.device,
                            dtype=torch.int32)[None, :, None]
        rows.append(((top & 0xFFF) + base).reshape(bq, -1))
    return torch.cat(vals, dim=1), torch.cat(rows, dim=1)


# ------------------------------------------------------------------ kernels


def _kernel_args(q_in: torch.Tensor, codes: torch.Tensor, n_tiles: int):
    """Validate what every kernel assumes; returns (B, row words)."""
    if not (q_in.is_cuda and codes.is_cuda):
        raise ValueError("kernel inputs must be CUDA tensors")
    if q_in.dtype != codes.dtype or codes.dtype not in (torch.int8, torch.float32):
        raise ValueError(f"unsupported dtypes {q_in.dtype}/{codes.dtype}")
    if not (q_in.is_contiguous() and codes.is_contiguous()):
        raise ValueError("kernel inputs must be contiguous")
    if q_in.data_ptr() % 16 or codes.data_ptr() % 16:
        raise ValueError("kernel inputs must be 16-byte aligned")
    w = codes.shape[1]
    if w % 128 or q_in.shape[1] != w:
        raise ValueError(f"row width must be a multiple of 128, got {w}")
    if n_tiles * TILE_N > codes.shape[0]:
        raise ValueError(f"{n_tiles} tiles exceed {codes.shape[0]} rows")
    return q_in.shape[0], (w // 4 if codes.dtype == torch.int8 else w)


def _f32_vec(x: torch.Tensor, n: int, name: str) -> torch.Tensor:
    x = x.reshape(-1)
    if x.dtype != torch.float32 or not x.is_cuda or x.shape[0] < n:
        raise ValueError(f"{name}: need >= {n} f32 CUDA values")
    return x.contiguous()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def intkey_scan(codes_unit, q_in, n_tiles):
    """B1: raw-int-dot scan over the key plane.  Returns keys [B,
    4*n_tiles] int32 with key = (dot << 10) | lane; slice i covers rows
    [i*1024, (i+1)*1024).  Replaces erlvectordb_tpu ``_intkey_scan``."""
    if codes_unit.device.type == "cpu":
        return intkey_scan_ref(codes_unit, q_in, n_tiles)
    from erlvectordb_tpu_torch.ops import cuda_lib

    bq, ww = _kernel_args(q_in, codes_unit, n_tiles)
    if codes_unit.dtype != torch.int8:
        raise ValueError("intkey_scan needs int8 codes")
    out = torch.empty((bq, 4 * n_tiles), dtype=torch.int32, device=q_in.device)
    lib = cuda_lib.library()
    cuda_lib.check(lib.evdb_intkey_scan(
        q_in.data_ptr(), codes_unit.data_ptr(), bq, ww, 4 * n_tiles,
        out.data_ptr(), _stream()), "intkey_scan")
    intkey_scan.launches += 1
    return out


def l2key_scan(codes_mag, q_in, bias_int, n_tiles):
    """B2: euclidean integer-key scan over the magnitude plane; ``bias_int``
    [N_cap] int32 is the quantized |x|^2/2 row bias (clamped < 2^20 by the
    caller).  Replaces erlvectordb_tpu ``_l2key_scan``."""
    if codes_mag.device.type == "cpu":
        return l2key_scan_ref(codes_mag, q_in, bias_int, n_tiles)
    from erlvectordb_tpu_torch.ops import cuda_lib

    bq, ww = _kernel_args(q_in, codes_mag, n_tiles)
    if codes_mag.dtype != torch.int8:
        raise ValueError("l2key_scan needs int8 codes")
    if (bias_int.dtype != torch.int32 or not bias_int.is_contiguous()
            or bias_int.shape[0] < n_tiles * TILE_N):
        raise ValueError("bias_int must be contiguous int32 covering the scan")
    out = torch.empty((bq, 4 * n_tiles), dtype=torch.int32, device=q_in.device)
    lib = cuda_lib.library()
    cuda_lib.check(lib.evdb_l2key_scan(
        q_in.data_ptr(), codes_mag.data_ptr(), bias_int.data_ptr(), bq, ww,
        4 * n_tiles, out.data_ptr(), _stream()), "l2key_scan")
    l2key_scan.launches += 1
    return out


def pos_scan(codes, q, qm, f, g, m, b, n_tiles, use_qm):
    """B3: positive-packed scaled-int key scan; keys [B, 4*n_tiles] int32,
    key = (round((score - f) * g) & ~1023) | lane.  ``qm``/``f``/``g`` are
    per query, ``m``/``b`` per row.  Replaces erlvectordb_tpu ``_pos_scan``
    (int8 and f32 codes; the packed-int4 variant is not ported yet)."""
    if codes.device.type == "cpu":
        return pos_scan_ref(codes, q, qm, f, g, m, b, n_tiles, use_qm)
    from erlvectordb_tpu_torch.ops import cuda_lib

    bq, ww = _kernel_args(q, codes, n_tiles)
    n = n_tiles * TILE_N
    args = [_f32_vec(qm, bq, "qm"), _f32_vec(f, bq, "f"), _f32_vec(g, bq, "g"),
            _f32_vec(m, n, "m"), _f32_vec(b, n, "b")]
    out = torch.empty((bq, 4 * n_tiles), dtype=torch.int32, device=q.device)
    lib = cuda_lib.library()
    fn = (lib.evdb_pos_scan_i8 if codes.dtype == torch.int8
          else lib.evdb_pos_scan_f32)
    cuda_lib.check(fn(q.data_ptr(), codes.data_ptr(),
                      *[a.data_ptr() for a in args], int(bool(use_qm)), bq, ww,
                      4 * n_tiles, out.data_ptr(), _stream()), "pos_scan")
    pos_scan.launches += 1
    return out


def fused_scan(codes, q, qmult, rowmult, rowbias, n_tiles, t_per_tile):
    """B4: masked-extraction scan; returns (vals, rows) [B, T*n_tiles], the
    top-T of each 4096-row tile.  Replaces erlvectordb_tpu ``_fused_scan``
    with ``cell_cap=0`` (int8 and f32 codes; packed int4 not ported yet)."""
    if codes.device.type == "cpu":
        return fused_scan_ref(codes, q, qmult, rowmult, rowbias, n_tiles,
                              t_per_tile)
    from erlvectordb_tpu_torch.ops import cuda_lib

    bq, ww = _kernel_args(q, codes, n_tiles)
    if t_per_tile not in (2, 4, 8):
        raise ValueError(f"t_per_tile must be 2, 4 or 8, got {t_per_tile}")
    n = n_tiles * TILE_N
    args = [_f32_vec(qmult, bq, "qmult"), _f32_vec(rowmult, n, "rowmult"),
            _f32_vec(rowbias, n, "rowbias")]
    cols = t_per_tile * n_tiles
    vals = torch.empty((bq, cols), dtype=torch.float32, device=q.device)
    rows = torch.empty((bq, cols), dtype=torch.int32, device=q.device)
    lib = cuda_lib.library()
    fn = (lib.evdb_fused_scan_i8 if codes.dtype == torch.int8
          else lib.evdb_fused_scan_f32)
    cuda_lib.check(fn(q.data_ptr(), codes.data_ptr(),
                      *[a.data_ptr() for a in args], bq, ww, n_tiles,
                      t_per_tile, vals.data_ptr(), rows.data_ptr(), _stream()),
                   "fused_scan")
    fused_scan.launches += 1
    return vals, rows


KERNELS = (intkey_scan, l2key_scan, pos_scan, fused_scan)
for _k in KERNELS:
    _k.launches = 0


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


# --------------------------------------------------------------------- glue


def intkey_applies(metric: str, n_tiles: int, k: int) -> bool:
    """Key-plane gate: the pos-path size/k gates, the three matmul metrics
    (cosine on the unit plane; euclidean/dot on the magnitude plane), and
    the EVDB_EXACT_SCAN opt-out."""
    return (POS_PATH_ENABLED and metric in ("cosine", "euclidean", "dot")
            and n_tiles >= POS_MIN_TILES and k <= POS_MAX_K)


def pos_path_applies(metric: str, n_tiles: int, k: int) -> bool:
    """Big-store gate for the positive-packed scan: top-1 per 1024-row slice
    loses ~0.4-0.8% of true top-k candidates per query at n_tiles >=
    POS_MIN_TILES.  ``EVDB_EXACT_SCAN=1`` (read at import) or
    ``POS_PATH_ENABLED = False`` forces masked extraction at any N."""
    return (POS_PATH_ENABLED and metric in ("cosine", "euclidean", "dot")
            and n_tiles >= POS_MIN_TILES and k <= POS_MAX_K)


def _affine_factors(metric, scales, norms, valid, queries):
    """Per-row and per-query affine factors; queries are f32 [B, W].
    Returns (q_int8_or_f32, qmult [B,1], rowmult [N], rowbias [N], post)."""
    b = queries.shape[0]
    if scales is not None:  # int8 store: quantize queries symmetrically
        q_absmax = queries.abs().amax(dim=-1, keepdim=True)
        q_scale = torch.where(q_absmax > 0, div_scalar(q_absmax, 127.0),
                              torch.ones_like(q_absmax))
        q_in = torch.clamp(torch.round(queries / q_scale), -127, 127).to(torch.int8)
        row_scale = scales
    else:
        q_scale = torch.ones((b, 1), dtype=torch.float32, device=queries.device)
        q_in = queries
        row_scale = torch.ones_like(norms)

    zero = torch.zeros((), dtype=torch.float32, device=queries.device)
    invalid_bias = torch.where(valid, zero, zero + _NEG)

    if metric == "cosine":
        qn = torch.sqrt(torch.sum(queries * queries, dim=-1, keepdim=True))
        qmult = torch.where(qn > 0, q_scale / torch.where(qn > 0, qn, 1.0), zero)
        rowmult = torch.where(norms > 0,
                              row_scale / torch.where(norms > 0, norms, 1.0), zero)
        rowbias = invalid_bias
        post = lambda vals, qsq: 1.0 - vals
    elif metric == "dot":
        qmult = q_scale
        rowmult = row_scale
        rowbias = invalid_bias
        post = lambda vals, qsq: -vals
    elif metric == "euclidean":
        qmult = 2.0 * q_scale
        rowmult = row_scale
        rowbias = -(norms * norms) + invalid_bias
        post = lambda vals, qsq: torch.sqrt(torch.clamp(qsq - vals, min=0.0))
    else:
        raise ValueError(f"fused path does not support metric {metric!r}")
    return q_in, qmult, rowmult, rowbias, post


def _rescore_pool(codes, q_in, qmult, m, rowbias, top_rows, post, queries, kk):
    """Exact rescore of the candidate pool: gather the pool's absmax rows and
    one packed [N, 2] aux plane, re-rank by the exact affine score, map to
    distances."""
    top_rows = top_rows.long()
    cand = codes[top_rows]                                   # [B, pool, W]
    if q_in.dtype == torch.int8:
        dots = torch.einsum("bkw,bw->bk", cand.double(), q_in.double()).float()
    else:
        with full_f32_matmul():
            dots = torch.einsum("bkw,bw->bk", cand, q_in)
    aux = torch.stack([m, rowbias.float()], dim=1)           # [N, 2]
    auxg = aux[top_rows]                                     # [B, pool, 2]
    exact_vals = _fma(dots * qmult, auxg[:, :, 0], auxg[:, :, 1])
    exact_sorted, sel2 = torch.topk(exact_vals, kk, dim=1)
    top_rows = torch.gather(top_rows, 1, sel2)
    qsq = torch.sum(queries * queries, dim=-1, keepdim=True)
    dists = post(exact_sorted, qsq)
    dists = torch.where(exact_sorted <= _NEG / 2,
                        torch.full_like(dists, float("inf")), dists)
    return dists, top_rows.to(torch.int32)


def _pool_rows(keys, k, pool_floor):
    kk = min(k, keys.shape[1])
    pool = min(max(4 * kk, pool_floor), keys.shape[1])
    topkeys, sel = torch.topk(keys, pool, dim=1)
    return kk, sel * POS_SLICE + (topkeys & POS_LANE_MASK)


def l2key_inputs(queries, norms, plane_scale):
    """The euclidean key scan's inputs: the batch quantized with ONE shared
    scale s_b, and the per-row bias round-down(127 |x|^2 / (2 S s_b)) in the
    same scaled-int dot domain, clamped below 2^20."""
    s_b = div_scalar(torch.clamp(queries.abs().amax(), min=1e-30), 127.0)
    q8b = torch.clamp(torch.round(queries / s_b), -127, 127).to(torch.int8)
    bias_f = norms * norms * (127.0 / 2.0) / (plane_scale * s_b)
    return q8b, torch.clamp(bias_f, max=L2KEY_BIAS_MAX).to(torch.int32)


def _intkey_topk(codes, codes_unit, norms, valid, queries, q_in, qmult,
                 rowmult, rowbias, post, *, metric, k, n_tiles,
                 plane_scale=None):
    """Key-plane merge: raw-int-key pool selection + exact absmax-plane
    rescore.  Euclidean folds the row bias into the key domain through a
    batch-shared query scale (``plane_scale`` = the magnitude plane's S)."""
    if metric == "euclidean":
        q8b, bias_i = l2key_inputs(queries, norms, plane_scale)
        keys = l2key_scan(codes_unit, q8b, bias_i, n_tiles)
    else:
        keys = intkey_scan(codes_unit, q_in, n_tiles)
    kk, top_rows = _pool_rows(keys, k, 64)
    m = torch.where(valid, rowmult, torch.zeros_like(rowmult)).float()
    return _rescore_pool(codes, q_in, qmult, m, rowbias, top_rows, post,
                         queries, kk)


def requantize_unit(codes, scales, norms, valid, chunk: int = 65536):
    """Derive the unit plane from an absmax int8 plane: round(codes *
    127*scale/norm).  Selection-grade; invalid/zero-norm rows get ZERO codes
    so their intkey ranks below every positive-dot row."""
    ok = valid & (norms > 0)
    f = torch.where(ok, 127.0 * scales / torch.where(norms > 0, norms, 1.0),
                    torch.zeros_like(scales))
    return _requantize_rows(codes, f, chunk)


def requantize_mag(codes, scales, valid, plane_scale, chunk: int = 65536):
    """Derive the MAGNITUDE plane (127*x/S, global ``plane_scale`` S) from an
    absmax int8 plane: round(codes * 127*scale/S); invalid rows get ZERO."""
    f = torch.where(valid, div_scalar(127.0 * scales, plane_scale),
                    torch.zeros_like(scales))
    return _requantize_rows(codes, f, chunk)


def _requantize_rows(codes, f, chunk):
    out = torch.empty_like(codes)
    for r0 in range(0, codes.shape[0], chunk):
        c = codes[r0:r0 + chunk].float()
        out[r0:r0 + chunk] = torch.clamp(
            torch.round(c * f[r0:r0 + chunk, None]), -127, 127).to(torch.int8)
    return out


def _pos_dot_term_bound(codes, scales, norms, rowmult, q_in):
    """Per-row bound on |dots * rowmult| — TIGHT, since the per-query key
    window is built from it (|codes_row|_2 <= norms/scale + sqrt(W)/2)."""
    w = q_in.shape[1]
    qf = q_in.float()
    qb = torch.sqrt(torch.amax(torch.sum(qf * qf, dim=-1)))
    if codes.dtype == torch.int8:
        cb = norms / scales + 0.5 * float(w) ** 0.5
    else:
        cb = norms
    return qb * cb * rowmult


def _pos_window(codes, scales, norms, valid, q_in, qmult, rowmult, rowbias,
                metric):
    """The pos scan's per-query window and per-row terms: (f, g) [B, 1] so
    that every valid score s lands in [f, s_ub] and (s - f) * g spends the
    key's 20 value bits uniformly across it; m, b [N] the row multiplier and
    offset (0 for invalid rows, which then rank below every valid row)."""
    use_qm = metric == "euclidean"
    zero = torch.zeros((), dtype=torch.float32, device=q_in.device)
    dot_term = _pos_dot_term_bound(codes, scales, norms, rowmult, q_in)
    qf = q_in.float()
    qb_per = torch.sqrt(torch.sum(qf * qf, dim=-1, keepdim=True))   # [B,1]
    qb_all = torch.clamp(torch.amax(qb_per), min=1e-9)
    row_coef = torch.amax(torch.where(valid, dot_term, zero)) / qb_all
    if use_qm:
        qm_eff = torch.amax(qmult * qb_per) / qb_all
        C = torch.amax(_fma(dot_term, qm_eff, norms * norms)) + 1.0
        b = torch.where(valid, C + rowbias, zero).float()
        rmax_q = qmult * qb_per * row_coef                            # [B,1]
        min_rb = torch.amin(torch.where(valid, rowbias, zero))
        f = C - rmax_q + min_rb
    else:
        C = torch.amax(dot_term) + 1.0
        b = torch.where(valid, C, zero).float()
        rmax_q = qb_per * row_coef
        f = C - rmax_q
    s_ub = C + rmax_q
    f = torch.clamp(f, min=0.0).float()
    # a true f32 division: `scalar / tensor` would run as reciprocal * scalar
    g = (zero + (float(1 << 30) - 1.0)) / torch.clamp(s_ub - f, min=1e-20)
    g = torch.where(torch.isfinite(g) & (g > 0), g, zero + 1.0).float()
    m = torch.where(valid, rowmult, zero).float()
    return f, g, m, b


def _pos_topk(codes, scales, norms, valid, queries, q_in, qmult, rowmult,
              rowbias, post, *, metric, k, n_tiles):
    """Pos-path merge: packed-key pool selection + exact affine rescore."""
    f, g, m, b = _pos_window(codes, scales, norms, valid, q_in, qmult, rowmult,
                             rowbias, metric)
    keys = pos_scan(codes, q_in, qmult, f, g, m, b, n_tiles,
                    metric == "euclidean")
    kk, top_rows = _pool_rows(keys, k, 64)
    return _rescore_pool(codes, q_in, qmult, m, rowbias, top_rows, post,
                         queries, kk)


def t_per_tile_for(n_tiles: int, k: int) -> int:
    """Masked extraction depth: deepen as tiles get scarce; for k <=
    t_per_tile the candidate set is exact regardless of distribution."""
    t_per_tile = 2
    while t_per_tile < MAX_T_PER_TILE and t_per_tile * n_tiles < max(k, 512):
        t_per_tile *= 2
    return t_per_tile


def fused_topk(codes, scales, norms, valid, queries, *, metric: str, k: int,
               n_tiles: int, codes_unit: Optional[torch.Tensor] = None,
               plane_scale: Optional[float] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused scan + candidate top-k over the first n_tiles*TILE_N rows.
    Returns (distances [B, k] f32, rows [B, k] int32).

    ``codes``: [N_cap, W] int8 or f32 (W % 128 == 0); ``scales`` [N_cap] for
    int8 stores, None for f32; ``codes_unit``: optional int8 key plane for
    the intkey scan (cosine: the UNIT plane 127*x/|x|; euclidean/dot: the
    MAGNITUDE plane 127*x/S, whose S ``plane_scale`` euclidean needs)."""
    q_in, qmult, rowmult, rowbias, post = _affine_factors(
        metric, scales, norms, valid, queries)

    if codes_unit is not None and intkey_applies(metric, n_tiles, k):
        return _intkey_topk(codes, codes_unit, norms, valid, queries, q_in,
                            qmult, rowmult, rowbias, post, metric=metric,
                            k=k, n_tiles=n_tiles, plane_scale=plane_scale)

    if pos_path_applies(metric, n_tiles, k):
        return _pos_topk(codes, scales, norms, valid, queries, q_in, qmult,
                         rowmult, rowbias, post, metric=metric, k=k,
                         n_tiles=n_tiles)

    vals, rows = fused_scan(codes, q_in, qmult, rowmult, rowbias, n_tiles,
                            t_per_tile_for(n_tiles, k))
    kk = min(k, vals.shape[1])
    pool = min(max(4 * kk, 32), vals.shape[1])
    _pv, sel = torch.topk(vals, pool, dim=1)
    top_rows = torch.gather(rows, 1, sel)
    return _rescore_pool(codes, q_in, qmult, rowmult, rowbias, top_rows,
                         post, queries, kk)


def fused_topk_available(count: int, capacity: int, metric: str,
                         device: torch.device, k: int = 10) -> bool:
    """The fused kernels apply on a CUDA device, matmul-form metrics, >= 1
    full tile, and k small enough for the per-tile candidate sets."""
    if device.type != "cuda" or metric not in ("cosine", "euclidean", "dot"):
        return False
    if capacity < TILE_N:
        return False
    return k <= MAX_T_PER_TILE * n_tiles_for(count, capacity)


def n_tiles_for(count_hwm: int, capacity: int) -> int:
    """Tiles needed to cover rows [0, count_hwm)."""
    used = min(max(count_hwm, 1), capacity)
    return -(-used // TILE_N)
