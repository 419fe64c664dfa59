"""Fused distance + top-k over a device-resident store — the hot path.

PyTorch/CUDA counterpart of ``erlvectordb_tpu/ops/fused_topk.py``.  Six
scans do the work, each a hand-written Hopper kernel in ``csrc/`` with a
plain PyTorch version beside it:

  intkey_scan        (B1)  raw int32 dots on the int8 key plane, one packed
                           ``(dot << 10) | lane`` key per (query, 1024-row
                           slice);
  l2key_scan         (B2)  the same with a per-row integer bias (euclidean);
  pos_scan           (B3)  scaled-int window keys over the absmax plane
                           (int8, f32 or packed int4 codes);
  fused_scan         (B4)  masked extraction: top-T per 4096-row tile of a
                           monotone float->int key (int8, f32, packed int4);
  pos_residual_scan  (B5)  the int4r store's window keys, residual dot plus
                           a per-(query, cell) centroid term, top-``t_top``
                           per slice;
  cell_scan          (B6)  B4 plus the same cell term (int4r, small stores).

Packed int4 codes are uint8 [N, W/2]: byte j of a row holds element 2j in
its high nibble and 2j+1 in its low one, signed.

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


def mul_recip(a: torch.Tensor, s: float) -> torch.Tensor:
    """a * f32(1/s): what XLA compiles the JAX package's ``a / s`` by a
    constant to inside ``jit`` (a true division differs in the last bit on
    ~4% of f32 values)."""
    return a * torch.tensor(1.0 / s, dtype=a.dtype, device=a.device)


def div_scalar(a: torch.Tensor, s: float) -> torch.Tensor:
    """a / s as a true f32 division on every device (CUDA divides by a Python
    scalar as a * (1/s), which can differ in the last bit)."""
    return a / torch.tensor(s, dtype=a.dtype, device=a.device)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., W/2] uint8 (two signed nibbles per byte, first value in the high
    nibble) -> [..., W] int8 codes in [-8, 7]."""
    p = packed.to(torch.int16)
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    lo = ((p & 0xF) ^ 8) - 8
    return torch.stack([hi, lo], dim=-1).reshape(
        *packed.shape[:-1], 2 * packed.shape[-1]).to(torch.int8)


def _dots(q: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """[B, W] x [R, W] -> [B, R] f32 (packed int4 codes: [R, W/2] uint8).
    Integer codes are multiplied exactly in float64 (|dot| < 2^53) and land
    exactly in f32 (|dot| < 2^24)."""
    if codes.dtype == torch.uint8:
        codes = unpack_int4(codes)
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


def _cell_term(table, cell_cap, r0, r1):
    """table[b, row // cell_cap] for rows [r0, r1): [B, r1 - r0]."""
    cells = torch.arange(r0, r1, device=table.device) // cell_cap
    return table[:, cells]


def fused_scan_ref(codes, q, qmult, rowmult, rowbias, n_tiles, t_per_tile,
                   cell=None):
    """Plain B4: sims = fma(dots*qmult, rowmult, rowbias); packed key =
    (monotone key & ~0xFFF) | lane-in-tile; top-T per 4096-row tile.
    ``cell`` = (qmult2, rowmult2, table, cell_cap) adds B6's centroid term,
    sims = fma(table[b, row // cell_cap] * qmult2, rowmult2, sims).
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
        if cell is not None:
            qmult2, rowmult2, table, cell_cap = cell
            sims = _fma(_cell_term(table, cell_cap, r0, r1) * qmult2,
                        rowmult2[None, r0:r1], sims)
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


def cell_scan_ref(codes, q, qmult, rowmult, rowbias, qmult2, rowmult2, table,
                  n_tiles, t_per_tile, cell_cap):
    """Plain B6: plain B4 with the int4r store's centroid term."""
    return fused_scan_ref(codes, q, qmult, rowmult, rowbias, n_tiles,
                          t_per_tile, cell=(qmult2, rowmult2, table, cell_cap))


def pos_residual_scan_ref(codes, q, qa, f, g, ma, mb, bb, table, n_tiles,
                          cell_cap, slice_w, t_top):
    """Plain B5: s = (fma(dots*qa, ma, tdot*mb) + bb - f) * g with tdot =
    table[b, row // cell_cap]; key = (int32(clip(round(s), +-2e9)) &
    ~(slice_w-1)) | lane; the top ``t_top`` keys of each slice_w-row slice,
    max first.  Returns [B, t_top * n_slices] int32, slice-major runs."""
    n_rows = n_tiles * TILE_N
    out = []
    lane = torch.arange(slice_w, device=q.device, dtype=torch.int32).repeat(
        _ROW_CHUNK // slice_w)
    for r0 in range(0, n_rows, _ROW_CHUNK):
        r1 = min(r0 + _ROW_CHUNK, n_rows)
        tdot = _cell_term(table, cell_cap, r0, r1)
        s = _fma(_dots(q, codes[r0:r1]) * qa, ma[None, r0:r1],
                 tdot * mb[None, r0:r1])
        s = ((s + bb[None, r0:r1]) - f) * g
        si = torch.clamp(torch.round(s), -2.0e9, 2.0e9).to(torch.int32)
        key = (si & ~(slice_w - 1)) | lane[:r1 - r0]
        top = torch.topk(key.reshape(key.shape[0], -1, slice_w), t_top,
                         dim=2).values
        out.append(top.reshape(key.shape[0], -1))
    return torch.cat(out, dim=1)


# ------------------------------------------------------------------ kernels


_VARIANTS = {(torch.int8, torch.int8): "int8",
             (torch.float32, torch.float32): "f32",
             (torch.int8, torch.uint8): "int4"}


def _kernel_args(q_in: torch.Tensor, codes: torch.Tensor, n_tiles: int):
    """Validate what every kernel assumes; returns (B, row width in 32-bit
    code words, variant: "int8" | "f32" | "int4")."""
    if not (q_in.is_cuda and codes.is_cuda):
        raise ValueError("kernel inputs must be CUDA tensors")
    variant = _VARIANTS.get((q_in.dtype, codes.dtype))
    if variant is None:
        raise ValueError(f"unsupported dtypes {q_in.dtype}/{codes.dtype}")
    if not (q_in.is_contiguous() and codes.is_contiguous()):
        raise ValueError("kernel inputs must be contiguous")
    if q_in.data_ptr() % 16 or codes.data_ptr() % 16:
        raise ValueError("kernel inputs must be 16-byte aligned")
    w = codes.shape[1] * (2 if variant == "int4" else 1)
    if w % 128 or q_in.shape[1] != w:
        raise ValueError(f"row width must be a multiple of 128, got {w}")
    if n_tiles * TILE_N > codes.shape[0]:
        raise ValueError(f"{n_tiles} tiles exceed {codes.shape[0]} rows")
    ww = {"int8": w // 4, "f32": w, "int4": w // 8}[variant]
    return q_in.shape[0], ww, variant


def _kernel_query(q_in: torch.Tensor, variant: str) -> torch.Tensor:
    """The query as the kernels read it: for packed int4 codes each
    8-element group is reordered to [evens | odds], the order in which a
    code word's high and low nibbles unpack."""
    if variant != "int4":
        return q_in
    b, w = q_in.shape
    return q_in.reshape(b, w // 8, 4, 2).transpose(2, 3).contiguous().reshape(b, w)


def _f32_vec(x: torch.Tensor, n: int, name: str) -> torch.Tensor:
    """A contiguous, 16-byte aligned f32 vector (the f32 scans copy row
    factors 16 bytes at a time)."""
    x = x.reshape(-1)
    if x.dtype != torch.float32 or not x.is_cuda or x.shape[0] < n:
        raise ValueError(f"{name}: need >= {n} f32 CUDA values")
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _table_arg(table: torch.Tensor, bq: int, n_rows: int, cell_cap: int):
    """The [B, cells] f32 centroid table covering rows [0, n_rows)."""
    if cell_cap < 1:
        raise ValueError(f"cell_cap must be positive, got {cell_cap}")
    need = -(-n_rows // cell_cap)
    if (table.dtype != torch.float32 or not table.is_cuda or table.dim() != 2
            or table.shape[0] != bq or table.shape[1] < need):
        raise ValueError(f"table: need f32 CUDA [{bq}, >= {need}]")
    return table.contiguous()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


MMA_Q_TILE = 128     # queries per block of the tensor-core scans (8 warps x 16)
MMA_ROWS = 64        # code rows per stage
MMA_K = 128          # int8 elements (k) per stage
MMA_PITCH = MMA_K + 16   # shared-memory row pitch of a k stage, bytes
MMA_STAGES = 4       # depth of the ring of staged copies
MMA_SMEM_MAX = 232_448   # the 227 KB of shared memory a block may use


def mma_scan_layout(bq: int, n_segs: int, seg_rows: int, w: int,
                    packed: bool, cell_cap: int, sm_count: int) -> dict:
    """The launch of the tensor-core scans (B1-B3 on int8 and packed int4
    codes, B4 on both, B5, B6), the one place that sizes it
    (csrc/mma_scan.cuh::scan_block carves its shared memory in this order).
    A 1-D grid of ``blocks`` = ``q_tiles`` x segment runs, the query tile
    fastest; a block covers MMA_Q_TILE queries x ``run`` consecutive
    segments of ``seg_rows`` rows (1024-row slices, 4096-row tiles), the
    last run ragged.  ``cells`` = the most cells a MMA_ROWS-row stage spans
    (the cell table's scans, ``cell_cap`` > 0; else 0).  ``smem`` = the
    block's dynamic shared memory: the codes (int8: a ring of MMA_STAGES
    stages; packed: two unpacked stages and a ring of MMA_STAGES packed
    ones), the query tile's k stages (all of them up to MMA_STAGES, else a
    ring of MMA_STAGES), and a ring of row factors and table blocks holding
    the pieces in flight.  The run grows with the work so that a block's
    query tile is staged once for up to 8192 rows while about 4 blocks per
    SM remain."""
    if cell_cap < 0:
        raise ValueError(f"cell_cap must be >= 0, got {cell_cap}")
    if w < MMA_K or w % MMA_K:
        raise ValueError(f"row width must be a multiple of {MMA_K}, got {w}")
    q_tiles = -(-bq // MMA_Q_TILE)
    max_run = max(1, 8 * POS_SLICE // seg_rows)
    run = max(1, min(max_run, n_segs * q_tiles // (4 * sm_count)))
    cells = min(MMA_ROWS, (MMA_ROWS - 1) // cell_cap + 2) if cell_cap else 0
    kw = w // MMA_K
    pieces = 4 if kw <= 2 else 2     # the factor slots: the pieces in flight
    stage = MMA_ROWS * MMA_PITCH
    codes = (2 * stage + MMA_STAGES * MMA_ROWS * MMA_K // 2 if packed
             else MMA_STAGES * stage)
    smem = (codes + min(kw, MMA_STAGES) * MMA_Q_TILE * MMA_PITCH
            + pieces * (MMA_ROWS * 16 + MMA_Q_TILE * cells * 4))
    if smem > MMA_SMEM_MAX:
        raise ValueError(f"{smem} B of shared memory exceed {MMA_SMEM_MAX}")
    return dict(q_tiles=q_tiles, run=run, blocks=q_tiles * -(-n_segs // run),
                cells=cells, smem=smem)


F32_Q_TILE = 128       # queries per block of the f32 scans (B3-f32, B4-f32)
F32_ROW_TILE = 128     # rows per row tile of their mainloop
# two stages of codes + queries, and two row tiles' two row-factor planes
F32_RING_BYTES = 2 * 2 * F32_ROW_TILE * (64 + 4) * 4 + 2 * 2 * F32_ROW_TILE * 4
F32_KEY_BYTES = F32_Q_TILE * (F32_ROW_TILE + 2) * 4    # B4-f32's staged key tile
F32_SPLITS = (1, 2, 4, 8, 16)   # pieces a 4096-row tile may be cut into
F32_BLOCK_COST_ROWS = 256       # a block's fixed cost (fill, lists, merge), in rows


def f32_tile_layout(bq: int, n_tiles: int, t_per_tile: int,
                    sm_count: int) -> dict:
    """B4-f32's launch (csrc/fused_topk.cu::tile_f32_kernel), the one place
    that sizes it.  A 1-D grid of ``blocks`` = ``q_tiles`` x ``n_tiles`` x
    ``split``, the query tile fastest; a block covers F32_Q_TILE queries x
    one piece of ``piece_rows`` = 4096 / ``split`` rows.  ``split`` is the
    one whose waves of one block an SM take the least time, a block's time
    being its rows plus F32_BLOCK_COST_ROWS (ties to fewer pieces).  ``jn``:
    the micro-tile's query columns, under 8 only for a batch under 65
    queries (16 ``jn`` queries a block).  With ``split`` > 1 the pieces'
    top-T lists go to a scratch buffer of ``part`` int32 keys, merged by a
    second launch of ``merge_blocks`` blocks of 256 threads.  ``smem``: the
    block's dynamic shared memory (the copy ring, the key tile, the
    threads' lists)."""
    if t_per_tile not in (2, 4, 8):
        raise ValueError(f"t_per_tile must be 2, 4 or 8, got {t_per_tile}")
    if bq < 1 or n_tiles < 1:
        raise ValueError(f"need >= 1 query and tile, got {bq}, {n_tiles}")
    q_tiles = -(-bq // F32_Q_TILE)
    jn = next(j for j in (1, 2, 4, 8) if bq <= 16 * j or j == 8)

    def cost(split):
        waves = -(-q_tiles * n_tiles * split // sm_count)
        return waves * (TILE_N // split + F32_BLOCK_COST_ROWS)

    split = min(F32_SPLITS, key=lambda s: (cost(s), s))
    smem = F32_RING_BYTES + F32_KEY_BYTES + t_per_tile * 256 * 4
    if smem > MMA_SMEM_MAX:
        raise ValueError(f"{smem} B of shared memory exceed {MMA_SMEM_MAX}")
    part = bq * n_tiles * split * t_per_tile if split > 1 else 0
    return dict(q_tiles=q_tiles, jn=jn, split=split,
                piece_rows=TILE_N // split,
                blocks=q_tiles * n_tiles * split, part=part,
                merge_blocks=-(-bq * n_tiles // 256) if split > 1 else 0,
                smem=smem)


def _layout(q: torch.Tensor, bq: int, n_segs: int, seg_rows: int, ww: int,
            variant: str, cell_cap: int = 0) -> dict:
    """mma_scan_layout for a kernel's arguments (``ww``: row words)."""
    packed = variant == "int4"
    return mma_scan_layout(
        bq, n_segs, seg_rows, ww * (8 if packed else 4), packed, cell_cap,
        torch.cuda.get_device_properties(q.device).multi_processor_count)


def _count(fn, variant: str) -> None:
    """One launch of ``fn``'s kernel (in its ``variant``)."""
    fn.launches += 1
    fn.launches_by[variant] = fn.launches_by.get(variant, 0) + 1


def intkey_scan(codes_unit, q_in, n_tiles):
    """B1: raw-int-dot scan over the key plane.  Returns keys [B,
    4*n_tiles] int32 with key = (dot << 10) | lane; slice i covers rows
    [i*1024, (i+1)*1024).  Replaces erlvectordb_tpu ``_intkey_scan``."""
    if codes_unit.device.type == "cpu":
        return intkey_scan_ref(codes_unit, q_in, n_tiles)
    from erlvectordb_tpu_torch.ops import cuda_lib

    bq, ww, variant = _kernel_args(q_in, codes_unit, n_tiles)
    if variant != "int8":
        raise ValueError("intkey_scan needs int8 codes")
    lay = _layout(q_in, bq, 4 * n_tiles, POS_SLICE, ww, variant)
    out = torch.empty((bq, 4 * n_tiles), dtype=torch.int32, device=q_in.device)
    lib = cuda_lib.library()
    cuda_lib.check(lib.evdb_intkey_scan(
        q_in.data_ptr(), codes_unit.data_ptr(), bq, ww, 4 * n_tiles,
        lay["run"], lay["smem"], out.data_ptr(), _stream()), "intkey_scan")
    _count(intkey_scan, variant)
    return out


def l2key_scan(codes_mag, q_in, bias_int, n_tiles):
    """B2: euclidean integer-key scan over the magnitude plane; ``bias_int``
    [N_cap] int32 is the quantized |x|^2/2 row bias (clamped < 2^20 by the
    caller).  Replaces erlvectordb_tpu ``_l2key_scan``."""
    if codes_mag.device.type == "cpu":
        return l2key_scan_ref(codes_mag, q_in, bias_int, n_tiles)
    from erlvectordb_tpu_torch.ops import cuda_lib

    bq, ww, variant = _kernel_args(q_in, codes_mag, n_tiles)
    if variant != "int8":
        raise ValueError("l2key_scan needs int8 codes")
    if (bias_int.dtype != torch.int32 or not bias_int.is_contiguous()
            or bias_int.shape[0] < n_tiles * TILE_N):
        raise ValueError("bias_int must be contiguous int32 covering the scan")
    lay = _layout(q_in, bq, 4 * n_tiles, POS_SLICE, ww, variant)
    out = torch.empty((bq, 4 * n_tiles), dtype=torch.int32, device=q_in.device)
    lib = cuda_lib.library()
    cuda_lib.check(lib.evdb_l2key_scan(
        q_in.data_ptr(), codes_mag.data_ptr(), bias_int.data_ptr(), bq, ww,
        4 * n_tiles, lay["run"], lay["smem"], out.data_ptr(), _stream()),
        "l2key_scan")
    _count(l2key_scan, variant)
    return out


def pos_scan(codes, q, qm, f, g, m, b, n_tiles, use_qm):
    """B3: positive-packed scaled-int key scan; keys [B, 4*n_tiles] int32,
    key = (round((score - f) * g) & ~1023) | lane.  ``qm``/``f``/``g`` are
    per query, ``m``/``b`` per row.  Int8, f32 or packed int4 codes (int8
    query).  Replaces erlvectordb_tpu ``_pos_scan``."""
    if codes.device.type == "cpu":
        return pos_scan_ref(codes, q, qm, f, g, m, b, n_tiles, use_qm)
    from erlvectordb_tpu_torch.ops import cuda_lib

    bq, ww, variant = _kernel_args(q, codes, n_tiles)
    n = n_tiles * TILE_N
    args = [_f32_vec(qm, bq, "qm"), _f32_vec(f, bq, "f"), _f32_vec(g, bq, "g"),
            _f32_vec(m, n, "m"), _f32_vec(b, n, "b")]
    out = torch.empty((bq, 4 * n_tiles), dtype=torch.int32, device=q.device)
    lib = cuda_lib.library()
    common = [a.data_ptr() for a in args] + [int(bool(use_qm)), bq, ww,
                                             4 * n_tiles]
    if variant == "f32":
        rc = lib.evdb_pos_scan_f32(q.data_ptr(), codes.data_ptr(), *common,
                                   out.data_ptr(), _stream())
    else:
        lay = _layout(q, bq, 4 * n_tiles, POS_SLICE, ww, variant)
        fn = lib.evdb_pos_scan_i8 if variant == "int8" else lib.evdb_pos_scan_i4
        rc = fn(_kernel_query(q, variant).data_ptr(), codes.data_ptr(), *common,
                lay["run"], lay["smem"], out.data_ptr(), _stream())
    cuda_lib.check(rc, "pos_scan")
    _count(pos_scan, variant)
    return out


def _tile_outputs(q, bq, n_tiles, t_per_tile):
    if t_per_tile not in (2, 4, 8):
        raise ValueError(f"t_per_tile must be 2, 4 or 8, got {t_per_tile}")
    cols = t_per_tile * n_tiles
    return (torch.empty((bq, cols), dtype=torch.float32, device=q.device),
            torch.empty((bq, cols), dtype=torch.int32, device=q.device))


def fused_scan(codes, q, qmult, rowmult, rowbias, n_tiles, t_per_tile):
    """B4: masked-extraction scan; returns (vals, rows) [B, T*n_tiles], the
    top-T of each 4096-row tile.  Int8, f32 or packed int4 codes.  Replaces
    erlvectordb_tpu ``_fused_scan`` with ``cell_cap=0``."""
    if codes.device.type == "cpu":
        return fused_scan_ref(codes, q, qmult, rowmult, rowbias, n_tiles,
                              t_per_tile)
    from erlvectordb_tpu_torch.ops import cuda_lib

    bq, ww, variant = _kernel_args(q, codes, n_tiles)
    vals, rows = _tile_outputs(q, bq, n_tiles, t_per_tile)
    n = n_tiles * TILE_N
    args = [_f32_vec(qmult, bq, "qmult"), _f32_vec(rowmult, n, "rowmult"),
            _f32_vec(rowbias, n, "rowbias")]
    lib = cuda_lib.library()
    common = [a.data_ptr() for a in args] + [bq, ww, n_tiles, t_per_tile]
    if variant == "f32":
        lay = f32_tile_layout(
            bq, n_tiles, t_per_tile,
            torch.cuda.get_device_properties(q.device).multi_processor_count)
        part = (torch.empty(lay["part"], dtype=torch.int32, device=q.device)
                if lay["part"] else None)
        rc = lib.evdb_fused_scan_f32(
            q.data_ptr(), codes.data_ptr(), *common, lay["split"], lay["jn"],
            None if part is None else part.data_ptr(), vals.data_ptr(),
            rows.data_ptr(), _stream())
    else:
        lay = _layout(q, bq, n_tiles, TILE_N, ww, variant)
        fn = lib.evdb_fused_scan_i8 if variant == "int8" else lib.evdb_fused_scan_i4
        rc = fn(_kernel_query(q, variant).data_ptr(), codes.data_ptr(), *common,
                lay["run"], lay["smem"], vals.data_ptr(), rows.data_ptr(),
                _stream())
    cuda_lib.check(rc, "fused_scan")
    _count(fused_scan, variant)
    return vals, rows


def cell_scan(codes, q, qmult, rowmult, rowbias, qmult2, rowmult2, table,
              n_tiles, t_per_tile, cell_cap):
    """B6: masked extraction over an int4r store's packed residual codes,
    with the centroid term table[b, row // cell_cap] * qmult2 * rowmult2
    (``table`` [B, >= cells] f32).  Replaces erlvectordb_tpu ``_fused_scan``
    with ``cell_cap > 0``."""
    if codes.device.type == "cpu":
        return cell_scan_ref(codes, q, qmult, rowmult, rowbias, qmult2,
                             rowmult2, table, n_tiles, t_per_tile, cell_cap)
    from erlvectordb_tpu_torch.ops import cuda_lib

    bq, ww, variant = _kernel_args(q, codes, n_tiles)
    if variant != "int4":
        raise ValueError("cell_scan needs packed int4 codes")
    vals, rows = _tile_outputs(q, bq, n_tiles, t_per_tile)
    n = n_tiles * TILE_N
    tb = _table_arg(table, bq, n, cell_cap)
    args = [_f32_vec(qmult, bq, "qmult"), _f32_vec(rowmult, n, "rowmult"),
            _f32_vec(rowbias, n, "rowbias"), _f32_vec(qmult2, bq, "qmult2"),
            _f32_vec(rowmult2, n, "rowmult2")]
    lay = _layout(q, bq, n_tiles, TILE_N, ww, variant, cell_cap)
    lib = cuda_lib.library()
    qk = _kernel_query(q, variant)
    cuda_lib.check(lib.evdb_cell_scan(
        qk.data_ptr(), codes.data_ptr(), *[a.data_ptr() for a in args],
        tb.data_ptr(), tb.shape[1], cell_cap, bq, ww, n_tiles, t_per_tile,
        lay["run"], lay["cells"], lay["smem"], vals.data_ptr(),
        rows.data_ptr(), _stream()), "cell_scan")
    _count(cell_scan, variant)
    return vals, rows


def residual_scan_layout(bq: int, n_slices: int, w: int, cell_cap: int,
                         sm_count: int) -> dict:
    """B5's launch: ``mma_scan_layout`` over 1024-row slices of packed
    codes with the cell table."""
    if cell_cap < 1:
        raise ValueError(f"cell_cap must be positive, got {cell_cap}")
    return mma_scan_layout(bq, n_slices, POS_SLICE, w, True, cell_cap,
                           sm_count)


def pos_residual_scan(codes, q, qa, f, g, ma, mb, bb, table, n_tiles,
                      cell_cap, slice_w=1024, t_top=2):
    """B5: the int4r store's scaled-int key scan; returns [B, t_top *
    n_slices] int32, the top ``t_top`` keys of slice s (max first) at
    columns t_top*s .. t_top*s + t_top - 1, so row = (col // t_top) *
    slice_w + (key & (slice_w - 1)).  ``table`` [B, >= cells] f32.
    Replaces erlvectordb_tpu ``_pos_residual_scan``."""
    if codes.device.type == "cpu":
        return pos_residual_scan_ref(codes, q, qa, f, g, ma, mb, bb, table,
                                     n_tiles, cell_cap, slice_w, t_top)
    from erlvectordb_tpu_torch.ops import cuda_lib

    bq, ww, variant = _kernel_args(q, codes, n_tiles)
    if variant != "int4":
        raise ValueError("pos_residual_scan needs packed int4 codes")
    if slice_w != POS_SLICE:   # the kernel's slice is fixed at 1024 rows
        raise ValueError(f"slice_w must be {POS_SLICE}, got {slice_w}")
    if t_top not in (2, 8):    # the store's depth (8) and the JAX default
        raise ValueError(f"t_top must be 2 or 8, got {t_top}")
    n = n_tiles * TILE_N
    n_slices = n // slice_w
    tb = _table_arg(table, bq, n, cell_cap)
    args = [_f32_vec(qa, bq, "qa"), _f32_vec(f, bq, "f"), _f32_vec(g, bq, "g"),
            _f32_vec(ma, n, "ma"), _f32_vec(mb, n, "mb"), _f32_vec(bb, n, "bb")]
    lay = residual_scan_layout(
        bq, n_slices, 8 * ww, cell_cap,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    out = torch.empty((bq, t_top * n_slices), dtype=torch.int32,
                      device=q.device)
    lib = cuda_lib.library()
    qk = _kernel_query(q, variant)
    cuda_lib.check(lib.evdb_pos_residual_scan(
        qk.data_ptr(), codes.data_ptr(), *[a.data_ptr() for a in args],
        tb.data_ptr(), tb.shape[1], cell_cap, bq, ww, n_slices, t_top,
        lay["run"], lay["cells"], lay["smem"], out.data_ptr(), _stream()),
        "pos_residual_scan")
    _count(pos_residual_scan, variant)
    return out


KERNELS = (intkey_scan, l2key_scan, pos_scan, fused_scan, pos_residual_scan,
           cell_scan)


def reset_launches() -> None:
    """Zero every kernel's launch counts (``launches`` and the per-variant
    ``launches_by``)."""
    for k in KERNELS:
        k.launches = 0
        k.launches_by = {}


reset_launches()


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
        q_scale = torch.where(q_absmax > 0, mul_recip(q_absmax, 127.0),
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
    if cand.dtype == torch.uint8:
        cand = unpack_int4(cand)
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


def l2key_batch_scale(queries):
    """The batch-shared query scale s_b of the euclidean key scan."""
    return mul_recip(torch.clamp(queries.abs().amax(), min=1e-30), 127.0)


def l2key_inputs(queries, norms, plane_scale):
    """The euclidean key scan's inputs: the batch quantized with ONE shared
    scale s_b, and the per-row bias round-down(127 |x|^2 / (2 S s_b)) in the
    same scaled-int dot domain, clamped below 2^20."""
    s_b = l2key_batch_scale(queries)
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
    if codes.dtype in (torch.int8, torch.uint8):
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


# ------------------------------------------------ cell-residual (int4r) path

POS_RES_W = 1024   # residual scan: slice width ...
POS_RES_T = 8      # ... and keys kept per slice (the store default)


def _affine_factors_residual(metric, norms, qn):
    """Second affine pair for the residual (cluster) term: the score is
    dot(q, x) = dot(q, c_cell) + dot(q, res), and the scans compute
    ``dots_res * qmult * rowmult + table * qmult2 * rowmult2 + rowbias``.
    Returns (qmult2 [B,1], rowmult2 [N])."""
    if metric == "cosine":
        one = torch.ones((), dtype=torch.float32, device=qn.device)
        qmult2 = torch.where(qn > 0, one / torch.where(qn > 0, qn, one), one * 0)
        rowmult2 = torch.where(norms > 0, one / torch.where(norms > 0, norms, one),
                               one * 0)
    elif metric == "dot":
        qmult2 = torch.ones_like(qn)
        rowmult2 = torch.ones_like(norms)
    elif metric == "euclidean":
        qmult2 = torch.full_like(qn, 2.0)
        rowmult2 = torch.ones_like(norms)
    else:
        raise ValueError(f"residual path does not support metric {metric!r}")
    return qmult2, rowmult2


def max_code_norm(codes: torch.Tensor, chunk: int = 65536) -> float:
    """max over rows of |unpacked int4 code|_2 — the realized bound the
    residual scan's key window is built from (5-20x under the all-sevens
    worst case 8*sqrt(W), and every factor of 2 is one more usable key
    bit)."""
    best = 0
    for r0 in range(0, codes.shape[0], chunk):
        c = unpack_int4(codes[r0:r0 + chunk]).to(torch.int32)
        best = max(best, int(torch.amax(torch.sum(c * c, dim=1))))
    # the square root in f32, as the JAX package takes it (the sum is exact)
    return float(torch.sqrt(torch.tensor(float(best), dtype=torch.float32)))


def _residual_window(metric, norms, valid, q_in, qa, rowmult, rowmult2,
                     table, cell_cap, code_norm_bound):
    """The residual scan's per-row terms (ma, mb, bb [N]) and per-query
    window (f, g [B,1]): every valid score lies in [f - rmax, s_ub] and the
    top-k band in [f, s_ub], so (s - f) * g spends the key's 20 value bits
    uniformly across the band (see the JAX package's fused_topk_residual
    for the derivation)."""
    zero = torch.zeros((), dtype=torch.float32, device=q_in.device)
    inf = zero + float("inf")
    w = q_in.shape[1]
    qf = q_in.float()
    qb_per = torch.sqrt(torch.sum(qf * qf, dim=-1, keepdim=True))      # [B,1]
    cnb = (code_norm_bound if code_norm_bound is not None
           else 8.0 * float(w) ** 0.5)
    cnb = zero + cnb
    dots_bound = torch.amax(qa * qb_per) * cnb
    C = (dots_bound * torch.amax(rowmult)
         + torch.amax(table.abs()) * torch.amax(rowmult2) + 1.0)
    extra = -0.5 * norms * norms if metric == "euclidean" else None
    ma = torch.where(valid, rowmult, zero).float()
    mb = torch.where(valid, rowmult2, zero).float()
    if metric == "euclidean":
        C = C + 0.5 * torch.amax(norms * norms)
    bb = torch.where(valid, C + (extra if extra is not None else 0.0),
                     zero).float()
    kreal = mb.shape[0] // cell_cap
    validc = valid.reshape(kreal, cell_cap)
    has_valid = torch.any(validc, dim=1)
    mbc = mb.reshape(kreal, cell_cap)
    mbmax_c = torch.amax(mbc, dim=1)
    mbmin_c = torch.amin(torch.where(validc, mbc, inf), dim=1)
    if extra is not None:
        extrac = extra.reshape(kreal, cell_cap)
        extramin_c = torch.amin(torch.where(validc, extrac, inf), dim=1)
        extramax_c = torch.amax(torch.where(validc, extrac, -inf), dim=1)
    else:
        extramin_c = torch.zeros_like(mbmax_c)
        extramax_c = extramin_c
    tb = table[:, :kreal]
    cellterm = torch.where(tb >= 0, tb * mbmax_c[None, :], tb * mbmin_c[None, :])
    cell_lb = torch.where(has_valid[None, :], cellterm + extramin_c[None, :], -inf)
    cell_ub = torch.where(has_valid[None, :], cellterm + extramax_c[None, :], -inf)
    rmax_q = qa.abs() * qb_per * cnb * torch.amax(ma)                  # [B,1]
    top_lb = torch.amax(cell_lb, dim=1, keepdim=True)
    top_ub = torch.amax(cell_ub, dim=1, keepdim=True)
    f = torch.clamp(top_lb + C - 2.0 * rmax_q, min=0.0)
    f = torch.where(torch.isfinite(f), f, zero).float()
    s_ub = top_ub + C + rmax_q
    # a true f32 division: `scalar / tensor` would run as reciprocal * scalar
    g = (zero + (float(1 << 30) - 1.0)) / torch.clamp(s_ub - f, min=1e-20)
    g = torch.where(torch.isfinite(g) & (g > 0), g, zero + 1.0).float()
    return ma, mb, bb, f, g


def residual_factors(metric, scales, norms, valid, centroids, queries,
                     n_tiles, cell_cap):
    """The residual scans' per-query and per-row factors: (q_in, qmult,
    rowmult, rowbias, post) as for any quantized store, the cell term's
    (qmult2, rowmult2), the [B, cells] centroid table (padded with zero
    cells to cover every scanned row) and B5's residual factor qa (the
    score divided by the positive per-query qmult2)."""
    q_in, qmult, rowmult, rowbias, post = _affine_factors(
        metric, scales, norms, valid, queries)
    qn = torch.sqrt(torch.sum(queries * queries, dim=-1, keepdim=True))
    qmult2, rowmult2 = _affine_factors_residual(metric, norms, qn)
    with full_f32_matmul():
        table = queries @ centroids.T
    need_cells = -(-n_tiles * TILE_N // cell_cap)
    if table.shape[1] < need_cells:
        table = torch.nn.functional.pad(table, (0, need_cells - table.shape[1]))
    if metric == "cosine":
        qa = qmult * qn                  # = q_scale, 0 for zero-norm q
    elif metric == "dot":
        qa = qmult
    else:                                # euclidean: qmult = 2 * q_scale
        qa = qmult * 0.5
    return q_in, qmult, rowmult, rowbias, post, qmult2, rowmult2, table, qa


def fused_topk_residual(codes, scales, norms, valid, centroids, queries, *,
                        metric: str, k: int, n_tiles: int, cell_cap: int,
                        code_norm_bound: Optional[float] = None,
                        slice_w: int = POS_SLICE, t_top: int = 2
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused scan over a cell-residual int4 store: the packed residual dot
    plus the per-(query, cell) centroid dot, then an exact rescore of the
    candidate pool with the raw f32 query.  Returns (distances [B, k] f32,
    rows [B, k] int32).

    ``codes`` [N_cap, W/2] packed residuals, ``scales`` their per-row
    scales, ``norms`` reconstruction norms, ``centroids`` [K, W] with
    N_cap == K * cell_cap.  At n_tiles >= POS_MIN_TILES (k <= 16) the B5
    scan keeps the top ``t_top`` keys of each ``slice_w``-row slice and the
    pool is max(8k, 256); below it B6 keeps the top-T of each 4096-row tile
    and the pool is max(4k, 32)."""
    t_per_tile = t_per_tile_for(n_tiles, k)
    (q_in, qmult, rowmult, rowbias, post, qmult2, rowmult2, table,
     qa) = residual_factors(metric, scales, norms, valid, centroids, queries,
                            n_tiles, cell_cap)
    if pos_path_applies(metric, n_tiles, k):
        # ranking score = s / qmult2 (a positive per-query factor); the exact
        # rescore below restores true distances
        ma, mb, bb, f, g = _residual_window(
            metric, norms, valid, q_in, qa, rowmult, rowmult2, table,
            cell_cap, code_norm_bound)
        keys = pos_residual_scan(codes, q_in, qa, f, g, ma, mb, bb, table,
                                 n_tiles, cell_cap, slice_w, t_top)
        kk = min(k, keys.shape[1])
        pool = min(max(8 * kk, 256), keys.shape[1])
        topkeys, sel = torch.topk(keys, pool, dim=1)
        # columns come in top-t_top-per-slice runs: slice = col // t_top
        top_rows = (torch.div(sel, t_top, rounding_mode="floor") * slice_w
                    + (topkeys & (slice_w - 1)))
    else:
        vals, rows = cell_scan(codes, q_in, qmult, rowmult, rowbias, qmult2,
                               rowmult2, table, n_tiles, t_per_tile, cell_cap)
        kk = min(k, vals.shape[1])
        pool = min(max(4 * kk, 32), vals.shape[1])
        _pv, sel = torch.topk(vals, pool, dim=1)
        top_rows = torch.gather(rows, 1, sel)
    # f32-query rescore of the pool: the scans quantize queries to int8;
    # re-scoring with the raw query removes that noise from the ranking
    top_rows = top_rows.long()
    cand = unpack_int4(codes[top_rows]).float()              # [B, pool, W]
    with full_f32_matmul():
        dots = torch.einsum("bkw,bw->bk", cand, queries)
    tgath = torch.gather(table, 1, torch.div(top_rows, cell_cap,
                                             rounding_mode="floor"))
    aux = torch.stack([rowmult, rowmult2, rowbias.float()], dim=1)  # [N, 3]
    auxg = aux[top_rows]                                     # [B, pool, 3]
    exact_vals = _fma(_fma(dots, auxg[:, :, 0], tgath * auxg[:, :, 1]),
                      qmult2, auxg[:, :, 2])
    exact_sorted, sel2 = torch.topk(exact_vals, kk, dim=1)
    top_rows = torch.gather(top_rows, 1, sel2)
    qsq = torch.sum(queries * queries, dim=-1, keepdim=True)
    dists = post(exact_sorted, qsq)
    dists = torch.where(exact_sorted <= _NEG / 2,
                        torch.full_like(dists, float("inf")), dists)
    return dists, top_rows.to(torch.int32)


def residual_scan_applies(capacity: int, cell_cap: int, metric: str,
                          device: torch.device, k: int = 10) -> bool:
    """The int4r store's fused gate: a CUDA device, a matmul-form metric, a
    tile-aligned cell layout of >= 1 tile, and k within the per-tile
    candidate sets."""
    if device.type != "cuda" or metric not in ("cosine", "euclidean", "dot"):
        return False
    if capacity < TILE_N or capacity % TILE_N or TILE_N % cell_cap:
        return False
    return k <= MAX_T_PER_TILE * n_tiles_for(capacity, capacity)
