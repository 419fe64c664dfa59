#!/usr/bin/env python3
"""Smoke run of erlvectordb_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing one JSON line of its own numbers:

  1. device   the card's name and power limit (nvidia-smi) and versions;
  2. build    the CUDA kernels compiled from csrc/ with nvcc (seconds,
              spills; registers and spills of every instantiation of the
              tensor-core scans B1-B6, the register-tiled B3-f32 and B4-f32,
              B7 (int4 and int8) and B8-B10, which must all be there and must
              not spill), and the stores built on the card (ms, device
              bytes);
  3. kernels  each kernel variant against its plain PyTorch version at the
              shapes its served path gives it (1024 queries, W=128; B4-f32
              also at 1 and 16 queries and at (c32)'s 1.2M rows at k = 32;
              B7-int4 also at nprobe 512 and at 1 and 16 queries, with the
              cell blocks its plan reads, and timed under each plan by
              batch), with the stated bars, median CUDA-event times and the
              bound;
  4. slice    the stores behind the MCP server, each path driven with the
              launch counts zeroed just before it and read just after:
                (a) int8 cosine intkey, 1.2M     -> B1 intkey_scan
                (b) int8 euclidean intkey, 1.2M  -> B2 l2key_scan
                (c) int8 cosine, 1.2M            -> B3 pos_scan int8, and
                    B4 fused_scan int8 at k=32 (past the pos path's k)
                (c32) f32 cosine, 1.2M           -> B3 pos_scan f32, and
                    a 1024-query store batch at k=32 -> B4 fused_scan f32
                (d) f32, 20k filled over MCP     -> B4 fused_scan f32
                (e) int4 cosine, 1.2M            -> B3 pos_scan int4
                (f) int4r cosine, 1.2M streaming -> B5 pos_residual_scan
                (g) int4, 100k filled over MCP   -> B4 fused_scan int4
                (h) int4r, 100k host build -> B6 cell_scan; then 1,000
                    rows inserted over MCP, each read back as its own top-1
                    (a row that finds its nearest cells full spawns a block
                    of 64 cells, so the read-back may run through B5)
                (f-mp) store (f) searched with nprobe and recall_target over
                    MCP (config 9), calibrate_store, and an exact-mode
                    calibration through the Python API -> B7 gather_dots int4
              recall@10 against exact f32 ground truth on the card, and
              overlap@10 of the int4/int4r stores with the plain exact scan
              of the same codes; 1024-query store batches of (a), (c32),
              (f) and (c32) at k=32 timed and profiled;
              (f-rq) an int4r store of the same corpus with the rq_m = 9
                    second stage (bench.py:1008): device bytes beside the
                    int8 stores', multiprobe recall@10 at nprobe 512 by
                    rescore pool, one 64-query dispatch at nprobe 64 beside
                    (f)'s -> B7 gather_dots int4 and the pooled rescore;
  5. index    (i) config 10 phase B: a CellProbeIndex of 8,388,608 x 768
              rows (int8 residual cells, SOAR spill) built by streaming from
              a manifold corpus drawn on the card, with the exact f32 top-10
              gathered while it is drawn; B7 int8 against its plain version
              at the index's shapes, the recall@10 curve over nprobe and the
              per-dispatch ms at 8 queries -> B7 gather_dots int8;
  6. adc      (j) config 4 (bench.py:351-475): 1M x 128 rows of a 20-d
              manifold, OPQ 8 x 8-bit codes trained on the card, int8 rerank
              rows; B8, B9, B10 (int8 and bf16 LUT) against their plain
              versions on one 512-query batch's LUT, then the three searches
              on 512-query batches -> B8 adc_pos_scan, B9 adc_exact_scan,
              B10 adc_pallas_scan int8, with recall@10 against exact f32
              ground truth;
  7. indexes  (k) the index manager over MCP: a 1M x 128 float32 euclidean
              store of (j)'s corpus, pq / opq / int8 / ivf / cellprobe
              indexes created, built, listed and searched through the MCP
              tools (256 search_index calls each, every answer the same as a
              direct IndexManager.search) -> B7 gather_dots int8 (cellprobe);

then the kernels summary line, the nvidia-smi line and, last, the contract
line ``{"ok": true, "device": {...}}``.  Any failed phase raises and the
script exits non-zero without that line, as it does without a CUDA device
or outside a checkout.  The stores' corpus follows bench.py's make_corpus
recipe (1024 Gaussian centres, noise 0.35), drawn with numpy from a seed;
the index's follows bench.py's _manifold_gen, drawn with torch generators on
the card.
"""

from __future__ import annotations

import base64
import json
import math
import os
import socket
import subprocess
import sys
import time

import numpy as np

N_ROWS, DIM, N_CENTRES, NOISE = 1_200_000, 100, 1024, 0.35
BATCH, K, N_RECALL, SEED = 1024, 10, 256, 0
F32_ROWS = 20_000    # store (d), filled over MCP
SMALL_ROWS = 100_000  # stores (g) and (h)
N_NEW = 1_000        # rows inserted into (h) over MCP
MP_NPROBE = (16, 32, 64, 512)  # (f-mp)'s recall curve over MCP
MP_PROBE, MP_TARGET = 64, 0.95  # (f-mp)'s latency probe width, recall target
# (i): bench.py config 10 phase B (bench.py:1549-1583), the corpus of
# bench.py::_manifold_gen: 4096 centres in a 48-d latent space, projected to
# 768-d, drawn in 262,144-row chunks
I_ROWS, I_DIM, I_CHUNK, I_QUERIES = 8_388_608, 768, 262_144, 1024
I_CENTRES, I_LATENT, I_NOISE, I_NOISE_D = 4096, 48, 0.35, 0.05
I_BUILD = dict(cell_rows=416, cell_cap=512, spill_mult=1.3,
               train_rows=262_144, kmeans_iters=6, kmeans_init="random",
               refits=1, j=16)
I_NPROBE = (8, 16, 32, 64, 128, 256)
I_DISPATCH_NPROBE, I_BQ = (8, 32, 64), 8
B7_BATCH = {"int4": 1024, "int8": 256}   # B7's kernel-phase shapes
B7_NPROBE = 64
RQ_M, RQ_POOLS, RQ_NPROBE = 9, (64, 128, 256), 512   # (f-rq), bench.py:1008
# (j): bench.py config 4 (bench.py:351-475): make_corpus with intrinsic_dim
# 20, OPQ m 8 x k 256 (iters 15, opq_iters 4, 200k training rows), 512-query
# batches, recall@10 on the first 256 of the 512 held-out points
J_ROWS, J_DIM, J_LATENT, J_BATCH, J_RECALL = 1_000_000, 128, 20, 512, 256
J_OPQ = dict(m=8, k=256, iters=15, opq_iters=4, max_train=200_000)
J_C, J_BATCHES = 2048, 4   # adc_search_fused's pool; timed batches
K_TYPES = ("pq", "opq", "int8", "ivf", "cellprobe")   # (k)'s index types
DEVICE = "cuda"
CSRC = "erlvectordb_tpu_torch/csrc/"
JAX_FT = "erlvectordb_tpu/ops/fused_topk.py:"
# kernel -> (source, the TPU kernel's pallas_call)
KERNEL_INFO = {
    "intkey_scan": ("fused_topk.cu", JAX_FT + "479"),
    "l2key_scan": ("fused_topk.cu", JAX_FT + "551"),
    "pos_scan": ("fused_topk.cu", JAX_FT + "335"),
    "fused_scan": ("tile_scan.cu", JAX_FT + "989"),   # f32 codes: F32_SOURCE
    "pos_residual_scan": ("residual_scan.cu", JAX_FT + "889"),
    "cell_scan": ("tile_scan.cu", JAX_FT + "989"),
    "gather_dots": ("cell_probe.cu", "erlvectordb_tpu/ops/cell_probe.py:150"),
    "adc_pos_scan": ("adc_scan.cu", "erlvectordb_tpu/ops/adc_pallas.py:419"),
    "adc_exact_scan": ("adc_scan.cu", "erlvectordb_tpu/ops/adc_pallas.py:253"),
    "adc_pallas_scan": ("adc_scan.cu", "erlvectordb_tpu/ops/adc_pallas.py:114"),
}
F32_SOURCE = "fused_topk.cu"   # B3 and B4 on f32 codes
# the kernels that must not spill, with their instantiations: B1-B3 on int8
# and packed int4 (B3: per-query multiplier x wide dots), B4 on both and B6
# (T 2 / 4 / 8 x wide dots), B5 (t_top 2 / 8 x wide dots), B3-f32, B4-f32
# (T 2 / 4 / 8 x 1, 2, 4, 8 query columns) and its merge (T), B8-B10 on the
# packed int8 LUT ((B10, B9 at list depths 2 / 4 / 8 / 32, B8) x 2, 4, 8
# subspace phases a warp), B7 on int4 (bf16 mma; windows of up to 8 or 32
# pairs) and int8, B10-bf16 on the packed bf16 LUT (list depths 2 / 4 / 8 /
# 32 x (S, S0) in (2, 8), (4, 8), (8, 8), (2, 4), (4, 4))
CHECKED_KERNELS = {"slice_scan_kernel": 10, "tile_scan_kernel": 18,
                   "residual_mma_kernel": 4, "pos_f32_kernel": 2,
                   "tile_f32_kernel": 12, "tile_merge_kernel": 3,
                   "adc_packed_kernel": 27, "gather_mma_kernel": 2,
                   "gather_dots_kernel": 1, "adc_bf16_packed_kernel": 20}
# H100 SXM peaks (NVIDIA data sheet, dense): int8 tensor-core ops/s (the
# int4 codes are counted at the int8 rate they run at after unpacking), bf16
# tensor-core FLOP/s (B7: a bf16-exact query against int8-exact codes), f32
# outside the tensor cores, and HBM bytes/s
PEAK = {"int8": 1979e12, "int4": 1979e12, "bf16": 989e12, "f32": 67e12}
HBM = 3.35e12
NO_LIBRARY = "none: no single PyTorch call computes the scan and its selection"
NO_LIBRARY_B7 = "none: a gather plus a product is not one PyTorch call"
NO_LIBRARY_ADC = "none: no single PyTorch call computes a LUT scan and its selection"
# LUT lookups have no tensor-core rate: they are bounded by shared-memory
# words, 32 a clock on each SM (132 on an H100 SXM), at the SM clock
# nvidia-smi reports as clocks.max.sm (both set by main from the device)
SM_COUNT = 132
SM_CLOCK_HZ = 1.98e9


def emit(phase: str, **numbers) -> None:
    print(json.dumps({"phase": phase, **numbers}), flush=True)


def make_corpus(seed: int, n: int) -> np.ndarray:
    """bench.py make_corpus's recipe with numpy's generator."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((N_CENTRES, DIM), dtype=np.float32)
    z = centres[rng.integers(0, N_CENTRES, n)]
    z += NOISE * rng.standard_normal((n, DIM), dtype=np.float32)
    return z


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of fn() over reps runs, by CUDA events."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def profile_calls(fn, reps: int = 20) -> dict:
    """Where one call of fn() spends its time: host ms per call (ending in a
    device synchronise) and device ms per call under torch.profiler after a
    warm-up, the device's busy share, and the five kernels with the most
    device time (ms per call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
    # device-side events only: an operator's entry repeats its kernels' time
    dev = {e.key: e.self_device_time_total / 1e3 / reps
           for e in prof.key_averages()
           if e.device_type != DeviceType.CPU and e.self_device_time_total > 0}
    device_ms = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:5]
    return dict(host_ms=1e3 * wall, device_ms=device_ms,
                device_busy_share=device_ms / (1e3 * wall),
                top_kernels_ms={k[:80]: v for k, v in top})


def timed(fn):
    """(result, host seconds) of fn() ending in a device synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# ------------------------------------------------------------------ kernels


def check_keys(name, kern, ref, exact):
    """Integer keys: bit-identical (exact) or, where f32 dots are summed in
    another order than cuBLAS's, one key step (1024) on <= 0.1% of entries."""
    import torch

    diff = kern.long() - ref.long()
    bad = diff != 0
    frac = int(bad.sum()) / bad.numel()
    steps_ok = bool(torch.all(diff[bad].abs() == 1024)) if frac else True
    if exact and frac:
        raise AssertionError(f"{name}: {frac:.2e} of keys differ")
    if not (frac <= 1e-3 and steps_ok):
        raise AssertionError(f"{name}: {frac:.2e} of keys differ (one-step: {steps_ok})")
    return float(diff.abs().max()), frac


def check_tile(name, kern, ref, exact_rows):
    """Masked extraction: rows identical (f32: on >= 99.9% of entries, the
    rest near-ties whose 11-bit keys straddle a step), vals to rtol 2.5e-4."""
    import torch

    (vk, rk), (vr, rr) = kern, ref
    same = rk == rr
    frac = int((~same).sum()) / same.numel()
    if frac > (0.0 if exact_rows else 1e-3):
        raise AssertionError(f"{name}: {frac:.2e} of rows differ")
    err = (vk[same] - vr[same]).abs()
    if not torch.all(err <= 2.5e-4 * vr[same].abs() + 1e-30):
        raise AssertionError(f"{name}: vals beyond rtol 2.5e-4")
    return float(err.max()), frac


def bound(variant, ops, nbytes):
    """Least time the card could take: the larger of the operations over the
    peak rate of their type and the bytes over the HBM rate."""
    t_ops, t_bytes = ops / PEAK[variant], nbytes / HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kernel_modules():
    import erlvectordb_tpu_torch.ops.adc_pallas as ap
    import erlvectordb_tpu_torch.ops.cell_probe as cp
    import erlvectordb_tpu_torch.ops.fused_topk as ft

    return ft, cp, ap


def reset_launches() -> None:
    for mod in kernel_modules():
        mod.reset_launches()


def read_launches() -> dict:
    """kernel -> {variant: launches} of every wrapper that launched."""
    return {k.__name__: dict(k.launches_by)
            for mod in kernel_modules() for k in mod.KERNELS if k.launches}


def b7_reads(probe, n_cells, plan):
    """Cell blocks B7-int4 reads for ``probe`` under ``plan`` (window,
    sort): one a run of equal cells within a window of the pairs."""
    import torch

    import erlvectordb_tpu_torch.ops.cell_probe as cp

    window, sort = plan
    cells, _ = cp.b7_plan(probe, sort)
    cells = cells.clamp(0, n_cells - 1)
    i = torch.arange(cells.numel(), device=cells.device)
    new_run = torch.ones_like(cells, dtype=torch.bool)
    new_run[1:] = cells[1:] != cells[:-1]
    return int((new_run | (i % window == 0)).sum())


def gather_check(out, variant, codes3, probe, q, row=None):
    """B7 against its plain version on the same inputs: every entry within
    1e-5 of sum |q| |c| (the kernel sums in f32, the plain version in
    float64); the largest ratio is reported beside the bar.  The bound
    counts each distinct probed cell's block once, the query and probe
    lists, and the [B, nprobe, cap] f32 output; the bytes the kernel reads
    (int8: a block per query and probe; int4: a block per run of its plan)
    are reported beside it.  ``row``: the summary row's label where the
    variant has several rows."""
    import torch

    import erlvectordb_tpu_torch.ops.cell_probe as cp
    from erlvectordb_tpu_torch.ops.fused_topk import unpack_int4

    kern = cp.gather_dots(codes3, probe, q)
    ref = cp.gather_dots_ref(codes3, probe, q)
    # |q| . |c| over the same blocks, a chunk of queries at a time (the
    # magnitudes of a whole code table would double the index's bytes)
    mag = torch.empty_like(ref)
    for i in range(0, q.shape[0], 64):
        cells, inv = torch.unique(probe[i:i + 64], return_inverse=True)
        blk = codes3[cells]
        blk = (unpack_int4(blk) if variant == "int4" else blk).abs()
        mag[i:i + 64] = cp.gather_dots_ref(blk, inv.to(torch.int32),
                                           q[i:i + 64].abs())
    torch.cuda.synchronize()
    err = (kern - ref).abs()
    over = float((err > 1e-5 * mag + 1e-30).float().mean())
    rel = float((err / (mag + 1e-30)).max())
    label = f"gather_dots[{row or variant}]"
    if over:
        raise AssertionError(f"{label}: {over:.2e} of entries beyond 1e-5 of "
                             f"sum |q| |c| (largest ratio {rel:.2e})")
    ms = cuda_ms(lambda: cp.gather_dots(codes3, probe, q))
    plain_ms = cuda_ms(lambda: cp.gather_dots_ref(codes3, probe, q), reps=3)
    b, nprobe = probe.shape
    n_cells, cap, wc = codes3.shape
    cells = int(torch.unique(probe).numel())
    nbytes = (cells * cap * wc + 4 * b * q.shape[1] + 4 * b * nprobe
              + 4 * b * nprobe * cap)
    b_ms, b_by = bound("bf16", 2.0 * b * nprobe * cap * q.shape[1], nbytes)
    extra = dict(batch=b, nprobe=nprobe, cap=cap, width=q.shape[1],
                 distinct_cells=cells, bound_bytes=nbytes, max_rel_err=rel)
    if variant == "int4":
        plan = cp.b7_plan_for(b * nprobe, b)
        reads = b7_reads(probe, n_cells, plan)
        extra.update(window=plan[0], sorted=plan[1], cell_reads=reads,
                     bytes_read=reads * cap * wc)
    else:
        extra.update(bytes_read=b * nprobe * cap * wc)
    rec = dict(max_abs_err=float(err.max()), mismatch=over, ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               rows=b * nprobe * cap, extra=extra)
    if row:
        rec["launch_variant"] = variant
    out[("gather_dots", row or variant)] = rec
    emit("kernel", name="gather_dots", variant=row or variant,
         **{k: v for k, v in rec.items() if k != "extra"}, **rec["extra"])


def b7_window_sweep(codes3, probe_of, q):
    """B7-int4 at nprobe 64 by batch under three plans: one pair a window,
    B7_PIPELINE pairs a window in pair order, B7_WINDOW sorted (the sort
    included), and the plan the wrapper picks: the CUDA-event ms (host
    bound at small batches) that set B7_SORT_MIN_PAIRS."""
    import erlvectordb_tpu_torch.ops.cell_probe as cp

    plans = {"s1": (1, False), f"s{cp.B7_PIPELINE}": (cp.B7_PIPELINE, False),
             f"s{cp.B7_WINDOW}-sorted": (cp.B7_WINDOW, True), "picked": None}
    sweep = {}
    for b in (16, 64, 256, 512, 1024):
        probe = probe_of(b, B7_NPROBE)
        sweep[b] = {k: cuda_ms(lambda: cp.gather_dots(codes3, probe, q[:b],
                                                      plan=v), reps=20)
                    for k, v in plans.items()}
        sweep[b]["plan"] = cp.b7_plan_for(b * B7_NPROBE, b)
    emit("b7_window_sweep", nprobe=B7_NPROBE, ms_by_batch_and_plan=sweep,
         sort_min_pairs=cp.B7_SORT_MIN_PAIRS)


def kernel_phase(st, queries):
    """Every kernel variant against its plain version at its path's shapes.
    ``st``: stores a, b, c, c32, e, f, g_ref (an int4 store of the first
    100k rows, the shapes of (g)), h."""
    import torch

    import erlvectordb_tpu_torch.ops.fused_topk as ft

    width = st["c"]._vectors.shape[1]
    qp = torch.zeros((BATCH, width), dtype=torch.float32, device=DEVICE)
    qp[:, :DIM] = torch.from_numpy(queries[:BATCH]).to(DEVICE)
    out = {}

    def run(name, variant, kern_fn, ref_fn, check, exact, *, rows, nbytes,
            batch=BATCH, row=None, extra=None):
        """``row``: the summary row's label where one kernel variant has
        several rows (its launches are the variant's)."""
        kern, ref = kern_fn(), ref_fn()
        torch.cuda.synchronize()
        err, frac = check(f"{name}[{row or variant}]", kern, ref, exact)
        ms, plain_ms = cuda_ms(kern_fn), cuda_ms(ref_fn, reps=3)
        b_ms, b_by = bound(variant, 2.0 * batch * rows * width, nbytes)
        rec = dict(max_abs_err=err, mismatch=frac, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, rows=rows,
                   extra=dict(batch=batch, width=width, **(extra or {})))
        if row:
            rec["launch_variant"] = variant
        out[(name, row or variant)] = rec
        emit("kernel", name=name, variant=row or variant,
             **{k: v for k, v in rec.items() if k != "extra"}, **rec["extra"])

    def code_bytes(store, rows):
        return rows * store._vectors.shape[1] * store._vectors.element_size()

    qbytes = {"int8": width, "f32": 4 * width, "int4": width}

    def slice_bytes(store, variant, nt, per_row, per_query=0, t=1,
                    out_per_key=4, per_tile=False, batch=BATCH):
        rows = nt * ft.TILE_N
        keys = batch * t * (nt if per_tile else rows // ft.POS_SLICE)
        return (code_bytes(store, rows) + qbytes[variant] * batch
                + per_row * rows + per_query * batch + out_per_key * keys)

    a, b, c, c32 = st["a"], st["b"], st["c"], st["c32"]
    nt = ft.n_tiles_for(c._next_row, c.capacity)
    rows = nt * ft.TILE_N
    # B1: cosine on the unit plane of store (a)
    q8, qmult, rowmult, rowbias, _ = ft._affine_factors(
        "cosine", a._scales, a._norms, a._valid, qp)
    run("intkey_scan", "int8", lambda: ft.intkey_scan(a._codes_unit, q8, nt),
        lambda: ft.intkey_scan_ref(a._codes_unit, q8, nt), check_keys, True,
        rows=rows, nbytes=slice_bytes(a, "int8", nt, 0))
    # B2: euclidean on the magnitude plane of store (b)
    q8b, bias = ft.l2key_inputs(qp, b._norms, b._plane_scale)
    run("l2key_scan", "int8", lambda: ft.l2key_scan(b._codes_unit, q8b, bias, nt),
        lambda: ft.l2key_scan_ref(b._codes_unit, q8b, bias, nt), check_keys,
        True, rows=rows, nbytes=slice_bytes(b, "int8", nt, 4))
    # B3 and B4 over store (c)'s absmax codes and store (c32)'s f32 rows
    f, g, m, bv = ft._pos_window(c._vectors, c._scales, c._norms, c._valid, q8,
                                 qmult, rowmult, rowbias, "cosine")
    run("pos_scan", "int8",
        lambda: ft.pos_scan(c._vectors, q8, qmult, f, g, m, bv, nt, False),
        lambda: ft.pos_scan_ref(c._vectors, q8, qmult, f, g, m, bv, nt, False),
        check_keys, False, rows=rows,
        nbytes=slice_bytes(c, "int8", nt, 8, 12))
    t32 = ft.t_per_tile_for(nt, 32)   # the k=32 request of path (c)
    run("fused_scan", "int8",
        lambda: ft.fused_scan(c._vectors, q8, qmult, rowmult, rowbias, nt, t32),
        lambda: ft.fused_scan_ref(c._vectors, q8, qmult, rowmult, rowbias, nt, t32),
        check_tile, True, rows=rows,
        nbytes=slice_bytes(c, "int8", nt, 8, 4, t32, 8, True))
    qf, qmf, rmf, rbf, _ = ft._affine_factors("cosine", None, c32._norms,
                                              c32._valid, qp)
    f, g, m, bv = ft._pos_window(c32._vectors, None, c32._norms, c32._valid, qf,
                                 qmf, rmf, rbf, "cosine")
    run("pos_scan", "f32",
        lambda: ft.pos_scan(c32._vectors, qf, qmf, f, g, m, bv, nt, False),
        lambda: ft.pos_scan_ref(c32._vectors, qf, qmf, f, g, m, bv, nt, False),
        check_keys, False, rows=rows,
        nbytes=slice_bytes(c32, "f32", nt, 8, 12))
    # B4 f32 at the 20k-row shape of path (d): 5 tiles of the same rows, at
    # 1024 queries, then at 1 and 16 (an MCP request on a default store)
    nt_d = ft.n_tiles_for(F32_ROWS, c32.capacity)
    t_d = ft.t_per_tile_for(nt_d, 16)
    for bq in (BATCH, 1, 16):
        qd, qmd = qf[:bq].contiguous(), qmf[:bq].contiguous()
        run("fused_scan", "f32",
            lambda: ft.fused_scan(c32._vectors, qd, qmd, rmf, rbf, nt_d, t_d),
            lambda: ft.fused_scan_ref(c32._vectors, qd, qmd, rmf, rbf, nt_d,
                                      t_d),
            check_tile, False, rows=nt_d * ft.TILE_N, batch=bq,
            row=None if bq == BATCH else f"f32_d_q{bq}",
            nbytes=slice_bytes(c32, "f32", nt_d, 8, 4, t_d, 8, True, bq),
            extra=dict(t_per_tile=t_d, layout=ft.f32_tile_layout(
                bq, nt_d, t_d, SM_COUNT)))
    # B4 f32 at (c32)'s full shape at k = 32 (past the pos path's k): the
    # f32 product alone by torch.matmul beside it (never called by the port)
    t_c = ft.t_per_tile_for(nt, 32)
    with ft.full_f32_matmul():
        product_ms = cuda_ms(lambda: qf @ c32._vectors[:rows].T, reps=3)
    run("fused_scan", "f32",
        lambda: ft.fused_scan(c32._vectors, qf, qmf, rmf, rbf, nt, t_c),
        lambda: ft.fused_scan_ref(c32._vectors, qf, qmf, rmf, rbf, nt, t_c),
        check_tile, False, rows=rows, row="f32_c32_k32",
        nbytes=slice_bytes(c32, "f32", nt, 8, 4, t_c, 8, True),
        extra=dict(t_per_tile=t_c, product_ms=product_ms,
                   product="torch.matmul of the same f32 product alone",
                   layout=ft.f32_tile_layout(BATCH, nt, t_c, SM_COUNT)))

    # B3 int4 over store (e)
    e = st["e"]
    q4, qm4, rm4, rb4, _ = ft._affine_factors("cosine", e._scales, e._norms,
                                              e._valid, qp)
    f, g, m, bv = ft._pos_window(e._vectors, e._scales, e._norms, e._valid, q4,
                                 qm4, rm4, rb4, "cosine")
    nt_e = ft.n_tiles_for(e._next_row, e.capacity)
    run("pos_scan", "int4",
        lambda: ft.pos_scan(e._vectors, q4, qm4, f, g, m, bv, nt_e, False),
        lambda: ft.pos_scan_ref(e._vectors, q4, qm4, f, g, m, bv, nt_e, False),
        check_keys, True, rows=nt_e * ft.TILE_N,
        nbytes=slice_bytes(e, "int4", nt_e, 8, 12))
    # B4 int4 at the shapes of path (g)
    gr = st["g_ref"]
    q4, qm4, rm4, rb4, _ = ft._affine_factors("cosine", gr._scales, gr._norms,
                                              gr._valid, qp)
    nt_g = ft.n_tiles_for(gr._next_row, gr.capacity)
    t_g = ft.t_per_tile_for(nt_g, 16)
    run("fused_scan", "int4",
        lambda: ft.fused_scan(gr._vectors, q4, qm4, rm4, rb4, nt_g, t_g),
        lambda: ft.fused_scan_ref(gr._vectors, q4, qm4, rm4, rb4, nt_g, t_g),
        check_tile, True, rows=nt_g * ft.TILE_N,
        nbytes=slice_bytes(gr, "int4", nt_g, 8, 4, t_g, 8, True))

    # B5 over store (f), B6 over store (h): the factors fused_topk_residual
    # hands them
    for key, name in (("f", "pos_residual_scan"), ("h", "cell_scan")):
        s = st[key]
        nt_r = ft.n_tiles_for(s.capacity, s.capacity)
        (q_in, qmult, rowmult, rowbias, _, qmult2, rowmult2, table,
         qa) = ft.residual_factors("cosine", s._scales, s._norms, s._valid,
                                   s._centroids, qp, nt_r, s._cell_cap)
        tb_bytes = 4 * table.numel()
        if name == "pos_residual_scan":
            ma, mb, bb, fw, gw = ft._residual_window(
                "cosine", s._norms, s._valid, q_in, qa, rowmult, rowmult2,
                table, s._cell_cap, ft.max_code_norm(s._vectors))
            args = (s._vectors, q_in, qa, fw, gw, ma, mb, bb, table, nt_r,
                    s._cell_cap, ft.POS_RES_W, ft.POS_RES_T)
            run(name, "int4", lambda: ft.pos_residual_scan(*args),
                lambda: ft.pos_residual_scan_ref(*args), check_keys, True,
                rows=nt_r * ft.TILE_N,
                nbytes=slice_bytes(s, "int4", nt_r, 12, 12, ft.POS_RES_T)
                + tb_bytes)
        else:
            t_h = ft.t_per_tile_for(nt_r, 16)
            args = (s._vectors, q_in, qmult, rowmult, rowbias, qmult2,
                    rowmult2, table, nt_r, t_h, s._cell_cap)
            run(name, "int4", lambda: ft.cell_scan(*args),
                lambda: ft.cell_scan_ref(*args), check_tile, True,
                rows=nt_r * ft.TILE_N,
                nbytes=slice_bytes(s, "int4", nt_r, 12, 8, t_h, 8, True)
                + tb_bytes)

    # B7 packed at (f-mp)'s shapes: store (f)'s cells, the probe lists of its
    # own routing, the bf16-rounded query multiprobe_topk hands the kernel
    import erlvectordb_tpu_torch.ops.cell_probe as cp

    f = st["f"]
    n_cells, cap = f._centroids.shape[0], f._cell_cap
    codes3 = f._vectors.reshape(n_cells, cap, -1)
    qbf = qp.to(torch.bfloat16).float()

    def probe_of(b, nprobe):
        return cp.route_probes(
            f._centroids, qp[:b], f._valid.reshape(n_cells, cap).any(dim=1),
            metric="cosine", nprobe=nprobe).to(torch.int32).contiguous()

    b = B7_BATCH["int4"]
    gather_check(out, "int4", codes3, probe_of(b, B7_NPROBE), qbf[:b])
    # (f-mp)'s deepest point and (f-rq)'s width, and small requests
    gather_check(out, "int4", codes3, probe_of(b, RQ_NPROBE), qbf[:b],
                 row=f"int4-np{RQ_NPROBE}")
    for bq in (1, 16):
        gather_check(out, "int4", codes3, probe_of(bq, B7_NPROBE), qbf[:bq],
                     row=f"int4-bq{bq}")
    b7_window_sweep(codes3, probe_of, qbf)
    return out


# -------------------------------------------------------------------- slice


class Client:
    def __init__(self, port: int, token: str):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=600)
        self.buf = b""
        self.token = token
        self.next_id = 0

    def _line(self):
        while b"\n" not in self.buf:
            chunk = self.sock.recv(1 << 20)
            if not chunk:
                raise ConnectionError("server closed")
            self.buf += chunk
        line, self.buf = self.buf.split(b"\n", 1)
        return json.loads(line)

    def tools(self, calls):
        """Pipelined tools/call requests; answers matched by id."""
        ids, out = [], []
        for name, args in calls:
            self.next_id += 1
            ids.append(self.next_id)
            out.append(json.dumps({
                "jsonrpc": "2.0", "id": self.next_id, "method": "tools/call",
                "params": {"name": name, "arguments": args},
                "auth": {"token": self.token}}))
        self.sock.sendall(("\n".join(out) + "\n").encode())
        got = {}
        while len(got) < len(ids):
            resp = self._line()
            got[resp["id"]] = resp
        res = []
        for i in ids:
            if "error" in got[i]:
                raise RuntimeError(f"MCP error: {got[i]['error']}")
            res.append(json.loads(got[i]["result"]["content"][0]["text"]))
        return res

    def tool(self, tool_name, **args):
        return self.tools([(tool_name, args)])[0]

    def insert_rows(self, store, rows, ids):
        """insert_vector requests pipelined 500 at a time."""
        for i in range(0, len(rows), 500):
            self.tools([("insert_vector", {"store": store, "id": ids[j],
                                           "vector": rows[j].tolist()})
                        for j in range(i, min(i + 500, len(rows)))])


def b64(a) -> str:
    return base64.b64encode(np.ascontiguousarray(a, "<f4").tobytes()).decode()


def batch_rows(client, store, qs, k=K):
    """Rows (== ids of the bulk-built and in-order filled stores) of one
    b64 search_vectors_batch."""
    r = client.tool("search_vectors_batch", store=store, vectors_b64=b64(qs),
                    dim=DIM, k=k, encoding="b64")
    rows = np.frombuffer(base64.b64decode(r["rows_b64"]), "<i4").reshape(len(qs), k)
    dists = np.frombuffer(base64.b64decode(r["distances_b64"]), "<f4").reshape(len(qs), k)
    if not np.all(np.isfinite(dists)):
        raise AssertionError(f"{store}: non-finite distances")
    return rows


def batch_ids(client, store, qs, **probe):
    """Ids of one compact search_vectors_batch (cell stores keep their rows
    permuted, so their answers are read by id); ``probe``: nprobe or
    recall_target."""
    r = client.tool("search_vectors_batch", store=store, vectors_b64=b64(qs),
                    dim=DIM, k=K, compact=True, **probe)
    if any(len(row) != K for row in r["ids"]):
        raise AssertionError(f"{store}: short answers")
    if not np.all(np.isfinite(np.asarray(r["distances"], np.float64))):
        raise AssertionError(f"{store}: non-finite distances")
    return r["ids"]


def exact_rows(corpus_dev, queries, metric):
    """Exact f32 top-k row indices on the card (the recall reference)."""
    import torch

    from erlvectordb_tpu_torch.ops.fused_topk import full_f32_matmul

    q = torch.from_numpy(queries).to(DEVICE)
    with full_f32_matmul():
        dots = q @ corpus_dev.T
    if metric == "cosine":
        score = dots / corpus_dev.norm(dim=1)[None, :]
    else:  # euclidean, up to the per-query constant |q|^2
        score = 2.0 * dots - (corpus_dev * corpus_dev).sum(dim=1)[None, :]
    return torch.topk(score, K, dim=1).indices.cpu().numpy()


def plain_exact_ids(store, queries):
    """Top-k ids of the plain exact scan over the store's own codes (the
    port's core/search.py on the card)."""
    import torch

    from erlvectordb_tpu_torch.core import search as search_mod

    q = torch.zeros((len(queries), store._vectors.shape[1] * 2),
                    dtype=torch.float32, device=DEVICE)
    q[:, :DIM] = torch.from_numpy(queries).to(DEVICE)
    if store.dtype == "int4":
        _, rows = search_mod.exact_topk_int4(
            store._vectors, store._scales, store._norms, store._valid, q,
            metric=store.metric, k=K)
    else:
        _, rows = search_mod.exact_topk_int4r(
            store._vectors, store._scales, store._norms, store._valid,
            store._centroids, q, metric=store.metric, k=K,
            cell_cap=store._cell_cap)
    return store._ids_view()[rows.cpu().numpy()].tolist()


def overlap(got, want) -> float:
    return float(np.mean([len(set(map(str, g)) & set(map(str, w))) / K
                          for g, w in zip(got, want)]))


def slice_phase(db, corpus, queries, f32_rows):
    import torch

    from erlvectordb_tpu_torch.core.calibration import (
        RecallUnachievable,
        exact_ground_truth,
    )
    from erlvectordb_tpu_torch.serve.mcp_server import MCPServer
    from erlvectordb_tpu_torch.utils.metrics import metrics

    nq = queries[:N_RECALL]
    launches, got, timing, exact_ids = {}, {}, {}, {}

    def path(name, fn):
        """Drive one path with the launch counts zeroed just before it and
        read just after."""
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = read_launches()
        return out

    server = MCPServer(db, host="127.0.0.1", port=0).start()
    try:
        port = server._sock.getsockname()[1]
        token = db.oauth.grant_client_credentials(
            "erlvectordb_client", "erlvectordb_secret")["access_token"]
        cl = Client(port, token)
        # (d): a 20k-row f32 store, (g): a 100k-row int4 store, both
        # created and filled over MCP
        cl.tool("create_store", name="d", dimension=DIM, metric="cosine",
                dtype="float32")
        _, timing["d_mcp_insert_s"] = timed(lambda: cl.insert_rows(
            "d", f32_rows, [str(j) for j in range(len(f32_rows))]))
        cl.tool("create_store", name="g", dimension=DIM, metric="cosine",
                dtype="int4")
        _, timing["g_mcp_insert_s"] = timed(lambda: cl.insert_rows(
            "g", corpus[:SMALL_ROWS], [str(j) for j in range(SMALL_ROWS)]))
        # warm every batch path, then count launches over the requests alone
        for s in ("a", "b", "c", "c32", "d", "e", "f", "g", "h"):
            batch_rows(cl, s, nq[:8])
        metrics.reset()

        def path_a():
            hit = cl.tool("search_vectors", store="a", vector=corpus[123].tolist(), k=K)
            if hit["results"][0]["id"] != "123":
                raise AssertionError(f"search_vectors: {hit['results'][:2]}")
            mcp_s = []
            for _ in range(5):
                t0 = time.perf_counter()
                rows_a = batch_rows(cl, "a", queries[:BATCH])
                mcp_s.append(time.perf_counter() - t0)
            timing["mcp_b64_batch_ms_all"] = [1e3 * x for x in mcp_s]
            # a fresh direction: int8 rescoring blurs cosine by ~1e-3, so the
            # vector must not sit that close to a stored row
            new = np.random.default_rng(SEED + 3).standard_normal(DIM).astype(np.float32)
            cl.tool("insert_vector", store="a", id="new", vector=new.tolist())
            first = cl.tool("search_vectors", store="a", vector=new.tolist(), k=K)
            if first["results"][0]["id"] != "new":
                raise AssertionError(f"inserted vector not first: {first['results'][:2]}")
            cl.tool("delete_vector", store="a", id="new")
            gone = cl.tool("search_vectors", store="a", vector=new.tolist(), k=K)
            if "new" in [h["id"] for h in gone["results"]]:
                raise AssertionError("deleted vector still returned")
            return rows_a[:N_RECALL]

        got["a"] = path("a", path_a)
        got["b"] = path("b", lambda: batch_rows(cl, "b", nq))
        got["c"] = path("c", lambda: (batch_rows(cl, "c", nq),
                                      batch_rows(cl, "c", nq, k=32)))[0]
        got["c32"] = path("c32", lambda: batch_rows(cl, "c32", nq))
        # (c32) at k = 32, past the pos path's k: B4-f32 over 1.2M rows
        c32 = db.get_store("c32")
        got["c32-k32"] = path("c32-k32", lambda: c32.search_batch_complete_raw(
            c32.search_batch_submit(queries[:BATCH], k=32))[1])[:N_RECALL, :K]
        got["d"] = path("d", lambda: batch_rows(cl, "d", nq))
        got["e"] = path("e", lambda: batch_rows(cl, "e", nq))
        got["f"] = path("f", lambda: batch_ids(cl, "f", queries[:BATCH]))[:N_RECALL]
        got["g"] = path("g", lambda: batch_rows(cl, "g", nq))

        # (h): 1,000 new rows inserted over MCP, each read back as its own
        # top-1 (the acknowledged-write read-back), plus the recall queries.
        # The new rows are the corpus rows after (h)'s 100k.  A row whose 8
        # nearest cells are full (its own, and the blocked zero-centroid
        # padding cells, which rank before most real cells, as in the JAX
        # package) spawns a block of 64 new cells
        new_rows = corpus[SMALL_ROWS:SMALL_ROWS + N_NEW]
        new_ids = [f"new{j}" for j in range(N_NEW)]

        def path_h():
            ids = batch_ids(cl, "h", nq)
            exact_ids["h"] = plain_exact_ids(db.get_store("h"), nq)
            _, timing["h_mcp_insert_s"] = timed(
                lambda: cl.insert_rows("h", new_rows, new_ids))
            return ids, batch_ids(cl, "h", new_rows)

        got["h"], back = path("h", path_h)
        readback = float(np.mean([r[0] == i for r, i in zip(back, new_ids)]))

        # (f-mp): store (f) through the multiprobe path (config 9): the
        # recall curve over nprobe and a recall_target batch after
        # calibrate_store (ceiling mode) over MCP, the single-query latency
        # over MCP, then an exact-mode calibration through the Python API,
        # whose ceiling refuses a target above it
        f_store = db.get_store("f")

        def path_fmp():
            curve = {p: batch_ids(cl, "f", nq, nprobe=p) for p in MP_NPROBE}
            cal = cl.tool("calibrate_store", store="f")
            at_target = batch_ids(cl, "f", nq, recall_target=MP_TARGET)
            lat = []
            for i in range(21):
                t0 = time.perf_counter()
                cl.tool("search_vectors", store="f", vector=nq[i].tolist(),
                        k=K, nprobe=MP_PROBE)
                lat.append(time.perf_counter() - t0)
            gt = exact_ground_truth(corpus, nq, k=K, metric="cosine",
                                    device=DEVICE)
            exact = f_store.calibrate_nprobe(queries=nq, k=K, metric="cosine",
                                             ground_truth=gt)
            ceiling = f_store._calib.get(K, "cosine").ceiling
            try:
                f_store.search(nq[0], k=K,
                               recall_target=min(1.0, ceiling + 0.01))
            except RecallUnachievable as e:
                refusal = str(e)
            else:
                raise AssertionError("a recall_target above the exact-mode "
                                     f"ceiling {ceiling} was served")
            return dict(curve=curve, cal=cal, at_target=at_target,
                        lat=lat[1:], exact=exact, ceiling=ceiling,
                        refusal=refusal)

        mp = path("f-mp", path_fmp)
        cl.sock.close()
    finally:
        server.stop()

    expect = {"a": ("intkey_scan", "int8"), "b": ("l2key_scan", "int8"),
              "c": ("pos_scan", "int8"), "c32": ("pos_scan", "f32"),
              "c32-k32": ("fused_scan", "f32"),
              "d": ("fused_scan", "f32"), "e": ("pos_scan", "int4"),
              "f": ("pos_residual_scan", "int4"), "g": ("fused_scan", "int4"),
              "h": ("cell_scan", "int4"), "f-mp": ("gather_dots", "int4")}
    for p, (kname, variant) in expect.items():
        if not launches[p].get(kname, {}).get(variant):
            raise AssertionError(f"path {p} never launched {kname}[{variant}]: "
                                 f"{launches[p]}")
    if not launches["c"].get("fused_scan", {}).get("int8"):
        raise AssertionError(f"path c (k=32) never launched fused_scan[int8]: "
                             f"{launches['c']}")
    if readback < 0.99:
        raise AssertionError(f"rows inserted into (h) read back as top-1: {readback}")

    corpus_dev = torch.from_numpy(corpus).to(DEVICE)
    gt_cos = exact_rows(corpus_dev, nq, "cosine")
    gt_l2 = exact_rows(corpus_dev, nq, "euclidean")
    del corpus_dev
    gt_small = exact_rows(torch.from_numpy(corpus[:SMALL_ROWS]).to(DEVICE), nq,
                          "cosine")
    gt_d = exact_rows(torch.from_numpy(f32_rows).to(DEVICE), nq, "cosine")
    # recall@10: overlap with the exact f32 top-10
    rec = {"a_int8_intkey_cosine": overlap(got["a"], gt_cos),
           "b_int8_intkey_euclidean": overlap(got["b"], gt_l2),
           "c_int8_cosine": overlap(got["c"], gt_cos),
           "c32_f32_cosine": overlap(got["c32"], gt_cos),
           "c32_f32_cosine_k32": overlap(got["c32-k32"], gt_cos),
           "d_f32_cosine_20k": overlap(got["d"], gt_d),
           "e_int4_cosine": overlap(got["e"], gt_cos),
           "f_int4r_cosine": overlap(got["f"], gt_cos),
           "g_int4_cosine_100k": overlap(got["g"], gt_small),
           "h_int4r_cosine_100k": overlap(got["h"], gt_small)}
    # (h) against its exact scan before the inserts, when its answers were
    # read
    ovl = {s: overlap(got[s], exact_ids.get(s) or plain_exact_ids(
        db.get_store(s), nq)) for s in ("e", "f", "g", "h")}
    if rec["a_int8_intkey_cosine"] < 0.95:
        raise AssertionError(f"recall@10 of store (a) below 0.95: {rec}")
    if min(rec["d_f32_cosine_20k"], rec["c32_f32_cosine_k32"]) < 0.99:
        raise AssertionError(f"an f32 store's masked extraction (B4-f32, "
                             f"(d) and (c32) at k = 32) disagrees with exact "
                             f"search: {rec}")
    if rec["f_int4r_cosine"] < 0.83:
        raise AssertionError(f"recall@10 of the int4r store (f) below 0.83: {rec}")
    if rec["f_int4r_cosine"] - rec["e_int4_cosine"] < 0.20:
        raise AssertionError(f"int4r (f) not 0.20 above plain int4 (e): {rec}")
    # (h)'s bar sits below (f)'s: its B6 scan keeps the top-8 of each tile
    # by an 11-bit-mantissa key and rescores a 64-row pool, and the bench's
    # queries (fresh centres) sit among near-ties.  Its overlap with the
    # exact scan moves with the build (0.9445 to 0.959 over card and CPU
    # builds); the JAX package's B6 path gives the port's overlap on the
    # same state, and the JAX package's own build of this corpus reads
    # 0.9519531 (tests/test_torch_int4r.py::
    # test_h_store_b6_overlap_is_the_reference_level,
    # test_h_store_jax_build_b6_overlap_is_the_port_level): the reference's
    # level, not a fault of the port
    if (min(ovl["e"], ovl["g"]) < 0.98 or ovl["f"] < 0.95
            or ovl["h"] < 0.93):
        raise AssertionError(f"overlap@10 with the plain exact scan: {ovl}")
    # (f-mp): recall@10 over nprobe against the same exact f32 top-10
    mp_curve = {p: overlap(ids, gt_cos) for p, ids in mp["curve"].items()}
    steps = [mp_curve[p] for p in MP_NPROBE]
    if (mp_curve[64] < 0.80 or mp_curve[512] < 0.83
            or min(b - a for a, b in zip(steps, steps[1:])) < -0.005):
        raise AssertionError(f"(f-mp) recall@10 over nprobe: {mp_curve}")
    cal_curve = {int(p): r for p, r in mp["cal"]["curve"].items()}
    chosen = min(p for p, r in cal_curve.items() if r >= MP_TARGET)

    # end to end on the store API: 1024-query batches, host clock around
    # submit -> complete (the readback waits for the device)
    batches = (("a", K), ("c32", K), ("f", K), ("c32", 32))
    tag = lambda s, k: s if k == K else f"{s}_k{k}"
    store_lat = {}
    for s, k in batches:
        store = db.get_store(s)
        lat = []
        for _ in range(6):
            t0 = time.perf_counter()
            store.search_batch_complete_raw(store.search_batch_submit(
                queries[:BATCH], k=k))
            lat.append(time.perf_counter() - t0)
        store_lat[tag(s, k)] = sorted(lat[1:])[len(lat[1:]) // 2]
    # where a store batch of (a) (B1), (f) (B5), (c32) (B3-f32) and (c32) at
    # k = 32 (B4-f32) spends its time
    batch_profile = {}
    for s, k in batches:
        store = db.get_store(s)
        batch_profile[tag(s, k)] = profile_calls(
            lambda: store.search_batch_complete_raw(store.search_batch_submit(
                queries[:BATCH], k=k)), reps=10)
    # (f-mp) at the store API: small batches through B7 at nprobe 64 beside
    # the full B5 scan of the same store (config 9's comparison)
    f_store = db.get_store("f")
    mp_lat = {}
    for bq in (1, 16):
        for label, kw in (("nprobe64", {"nprobe": MP_PROBE}), ("b5_scan", {})):
            lat = []
            for _ in range(11):
                t0 = time.perf_counter()
                f_store.search_batch_complete_raw(f_store.search_batch_submit(
                    queries[:bq], k=K, **kw))
                lat.append(time.perf_counter() - t0)
            mp_lat[f"bq{bq}_{label}"] = 1e3 * float(np.median(lat[1:]))
    mp_profile = profile_calls(lambda: f_store.search_batch_complete_raw(
        f_store.search_batch_submit(queries[:16], k=K, nprobe=MP_PROBE)))
    emit("multiprobe", store="f", recall_at_10_by_nprobe=mp_curve,
         calibrate_store=mp["cal"], recall_target=MP_TARGET,
         nprobe_chosen=chosen,
         recall_at_10_at_target=overlap(mp["at_target"], gt_cos),
         exact_mode_curve=mp["exact"], exact_mode_ceiling=mp["ceiling"],
         refusal_above_ceiling=mp["refusal"],
         mcp_search_vectors_ms_median=1e3 * float(np.median(mp["lat"])),
         mcp_search_vectors_ms_all=[1e3 * x for x in mp["lat"]],
         store_api_ms_median=mp_lat, profile_bq16_nprobe64=mp_profile,
         launches=launches["f-mp"])
    emit("slice", recall_at_10=rec, overlap_at_10_with_plain_exact=ovl,
         h_insert_readback_top1=readback, launches=launches,
         store_batch_ms_median={s: 1e3 * v for s, v in store_lat.items()},
         store_qps={s: BATCH / v for s, v in store_lat.items()},
         profile_store_batch=batch_profile,
         mcp_b64_batch_ms_median=float(np.median(timing["mcp_b64_batch_ms_all"])),
         mcp_b64_batch_ms_all=timing["mcp_b64_batch_ms_all"],
         mean_ms_by_span={k: v["mean_ms"] for k, v in
                          metrics.snapshot()["latencies"].items()},
         mcp_insert_rows_per_s={"d": F32_ROWS / timing["d_mcp_insert_s"],
                                "g": SMALL_ROWS / timing["g_mcp_insert_s"],
                                "h": N_NEW / timing["h_mcp_insert_s"]},
         device_bytes={s: db.get_store(s).device_memory_bytes()
                       for s in ("d", "g", "h")},
         h_capacity_after_inserts=db.get_store("h").capacity,
         torch_memory_allocated=int(torch.cuda.memory_allocated()),
         torch_max_memory_allocated=int(torch.cuda.max_memory_allocated()))
    return launches, mp_curve


def rq_phase(corpus, queries, stores, stage1, launches):
    """(f-rq): the int4r store of the config-3 corpus with the rq_m second
    stage (bench.py:1008), driven with the launch counts zeroed: the
    multiprobe recall@10 at nprobe 512 for each rescore pool, and one
    64-query dispatch at nprobe 64 beside store (f)'s (bench.py:1020-1031).
    ``stage1``: (f)'s recall@10 at nprobe 512, stage 1 alone."""
    import torch

    from erlvectordb_tpu_torch.core.store import VectorStore

    nq = queries[:N_RECALL]
    store, build_s = timed(lambda: VectorStore.from_matrix(
        "f-rq", corpus, dtype="int4r", rq_m=RQ_M, device=DEVICE))
    gt = exact_rows(torch.from_numpy(corpus).to(DEVICE), nq, "cosine")

    def ids(st, qs, nprobe):
        return st.search_batch_complete_raw(
            st.search_batch_submit(qs, k=K, nprobe=nprobe))[2]

    def probe_ms(st):
        qs = queries[:64]
        ids(st, qs, 64)
        lat = []
        for _ in range(11):
            t0 = time.perf_counter()
            ids(st, qs, 64)
            lat.append(time.perf_counter() - t0)
        return 1e3 * float(np.median(lat))

    def run():
        curve = {}
        for pool in RQ_POOLS:
            store.rq_pool = pool
            curve[pool] = overlap(ids(store, nq, RQ_NPROBE), gt)
        store.rq_pool = 64
        return curve, {"rq": probe_ms(store), "plain_f": probe_ms(stores["f"])}

    reset_launches()
    curve, dispatch = run()
    torch.cuda.synchronize()
    launches["f-rq"] = read_launches()
    nbytes = store.device_memory_bytes()
    ratio = {s: nbytes / stores[s].device_memory_bytes() for s in ("a", "c")}
    best = max(curve.values())
    emit("rq", store="f-rq", rq_m=RQ_M, build_s=build_s, device_bytes=nbytes,
         bytes_over_int8_a=ratio["a"], bytes_over_int8_c=ratio["c"],
         recall_at_10_nprobe512_by_pool=curve,
         stage1_recall_at_10_nprobe512=stage1,
         dispatch_ms_bq64_nprobe64=dispatch, launches=launches["f-rq"])
    if not launches["f-rq"].get("gather_dots", {}).get("int4"):
        raise AssertionError(f"path f-rq never launched gather_dots[int4]: "
                             f"{launches['f-rq']}")
    # the int8 store without a key plane (c) is the stricter of the two
    if best < 0.88 or ratio["c"] > 0.5 or best - stage1 < 0.02:
        raise AssertionError(f"(f-rq): recall {curve} (stage 1 {stage1}), "
                             f"bytes over int8 {ratio}")


# -------------------------------------------------------------------- index


def manifold(seed: int):
    """bench.py::_manifold_gen with torch generators on the card: 4096
    centres in a 48-d latent space, a latent -> 768 projection of N(0, 1) /
    sqrt(48) entries, latent noise 0.35 and 0.05 isotropic noise in 768-d.
    Returns chunk(stream, rows): the rows of one seeded stream."""
    import torch

    from erlvectordb_tpu_torch.ops.fused_topk import full_f32_matmul

    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    centres = torch.randn((I_CENTRES, I_LATENT), generator=g, device=DEVICE)
    proj = (torch.randn((I_LATENT, I_DIM), generator=g, device=DEVICE)
            / math.sqrt(I_LATENT))

    def chunk(stream: int, rows: int):
        gs = torch.Generator(device=DEVICE)
        gs.manual_seed((seed << 32) + stream + 1)
        z = centres[torch.randint(0, I_CENTRES, (rows,), generator=gs,
                                  device=DEVICE)]
        z = z + I_NOISE * torch.randn((rows, I_LATENT), generator=gs,
                                      device=DEVICE)
        with full_f32_matmul():
            x = z @ proj
        return x + I_NOISE_D * torch.randn((rows, I_DIM), generator=gs,
                                           device=DEVICE)

    return chunk


def index_phase(kernels, launches):
    """(i): the cell-probe index of config 10 phase B, built by streaming
    from chunks drawn on the card (never whole on the host) while the exact
    f32 cosine top-10 of the queries is gathered over them; B7 int8 against
    its plain version at the index's shapes; then the path, with the launch
    counts zeroed just before it: the recall@10 curve over nprobe (1024
    queries) and the per-dispatch ms of multiprobe_topk at 8 queries."""
    import torch

    import erlvectordb_tpu_torch.ops.cell_probe as cp
    from erlvectordb_tpu_torch.core.cell_probe import CellProbeIndex
    from erlvectordb_tpu_torch.ops.fused_topk import full_f32_matmul

    chunk = manifold(SEED)
    queries = chunk(10 ** 6, I_QUERIES)              # a stream of their own
    qn = queries / queries.norm(dim=1, keepdim=True)
    top = [torch.full((I_QUERIES, K), -2.0, device=DEVICE),
           torch.full((I_QUERIES, K), -1, dtype=torch.int64, device=DEVICE)]

    def chunks():
        for i in range(I_ROWS // I_CHUNK):
            c = chunk(i, I_CHUNK)
            with full_f32_matmul():
                sims = (qn @ c.T) / torch.clamp(c.norm(dim=1), min=1e-9)
            d, r = torch.topk(sims, K, dim=1)
            d, sel = torch.topk(torch.cat([top[0], d], 1), K, dim=1)
            top[1] = torch.gather(torch.cat([top[1], r + i * I_CHUNK], 1), 1,
                                  sel)
            top[0] = d
            yield c

    torch.cuda.reset_peak_memory_stats()
    idx, build_s = timed(lambda: CellProbeIndex.build_streaming(
        chunks(), n=I_ROWS, dim=I_DIM, device=DEVICE, **I_BUILD))
    build_peak = torch.cuda.max_memory_allocated()
    gt = top[1].cpu().numpy()
    n_cells, cap = idx.n_cells, idx.cell_cap
    qb = queries[:B7_BATCH["int8"]]
    probe = cp.route_probes(
        idx.centroids, qb, idx.valid.reshape(n_cells, cap).any(dim=1),
        metric="cosine", nprobe=B7_NPROBE, centroids_route=idx.cents_route,
        cn2=idx.cn2).to(torch.int32).contiguous()
    gather_check(kernels, "int8", idx.codes.reshape(n_cells, cap, -1), probe,
                 qb.to(torch.bfloat16).float())
    del probe, qb

    qnp = queries.cpu().numpy()
    q8 = queries[:I_BQ]

    def run():
        curve = {p: overlap(idx.search(qnp, k=K, nprobe=p)[1], gt)
                 for p in I_NPROBE}
        dispatch = {}
        for p in I_DISPATCH_NPROBE:
            def call():
                return cp.multiprobe_topk(
                    idx.codes, idx.scales, idx.norms, idx.valid,
                    idx.centroids, q8, metric="cosine", k=2 * K, nprobe=p,
                    cell_cap=cap, centroids_route=idx.cents_route,
                    cn2=idx.cn2)
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(32):
                call()
            torch.cuda.synchronize()
            dispatch[p] = 1e3 * (time.perf_counter() - t0) / 32
        return curve, dispatch

    reset_launches()
    curve, dispatch = run()
    torch.cuda.synchronize()
    launches["i"] = read_launches()
    if not launches["i"].get("gather_dots", {}).get("int8"):
        raise AssertionError(f"path i never launched gather_dots[int8]: "
                             f"{launches['i']}")
    if curve[64] < 0.95:
        raise AssertionError(f"(i) recall@10 at nprobe 64 below 0.95: {curve}")
    profile = profile_calls(lambda: cp.multiprobe_topk(
        idx.codes, idx.scales, idx.norms, idx.valid, idx.centroids, q8,
        metric="cosine", k=2 * K, nprobe=64, cell_cap=cap,
        centroids_route=idx.cents_route, cn2=idx.cn2))
    dev_bytes = sum(t.numel() * t.element_size() for t in (
        idx.codes, idx.scales, idx.norms, idx.valid, idx.centroids,
        idx.cents_route, idx.cn2, idx.row_map_dev))
    emit("index", rows=I_ROWS, dim=I_DIM, build_s=build_s,
         build_stats=idx.build_stats, stats=idx.stats(),
         device_bytes=dev_bytes, build_peak_bytes=build_peak,
         recall_at_10_by_nprobe=curve, dispatch_ms_bq8=dispatch,
         profile_bq8_nprobe64=profile, launches=launches["i"])


# ---------------------------------------------------------------------- adc


def adc_corpus(seed: int):
    """bench.py make_corpus's recipe with intrinsic_dim 20, with numpy's
    generator: 1024 centres in a 20-d latent space, noise 0.35, projected to
    128-d by N(0, 1) / sqrt(20) entries, plus 0.05 isotropic noise.  Returns
    (the 1M corpus rows, the 512 held-out points)."""
    rng = np.random.default_rng(seed)
    n = J_ROWS + J_BATCH
    centres = rng.standard_normal((N_CENTRES, J_LATENT), dtype=np.float32)
    z = centres[rng.integers(0, N_CENTRES, n)]
    z += NOISE * rng.standard_normal((n, J_LATENT), dtype=np.float32)
    proj = (rng.standard_normal((J_LATENT, J_DIM), dtype=np.float32)
            / np.float32(math.sqrt(J_LATENT)))
    x = z @ proj
    x += np.float32(0.05) * rng.standard_normal((n, J_DIM), dtype=np.float32)
    return x[:J_ROWS], x[J_ROWS:]


def adc_bound(lut, rows_scanned, rows, q=None, d=0):
    """(bound_ms, bound_by, extra): the least time for the LUT lookups (B x
    rows x M) against the bytes each input needs once — the codes, the LUT,
    the outputs, and for the rerank scans the queries and the int8 rows,
    scales and norms of the distinct winners.  The lookups are counted in
    32-bit shared-memory words at 32 words per clock on each SM: an int8
    LUT packed 4 queries to a word (ops/adc_pallas.py::pack_lut) needs a
    word per 4 lookups, a bf16 LUT staged 2 queries to a word (the words
    of pack_lut_bf16) a word per 2.  The one-lookup-a-word reckoning of the
    first designs is reported beside it."""
    import torch

    b, m = lut.shape[0], J_OPQ["m"]
    lookups = b * rows_scanned * m
    per_word = 4 if lut.dtype == torch.int8 else 2
    nbytes = (rows_scanned * m + lut.numel() * lut.element_size()
              + rows.numel() * 8)
    winners = 0
    if q is not None:
        winners = int(torch.unique(rows).numel())
        nbytes += q.numel() * 4 + winners * (d + 8)
    rate = SM_COUNT * 32 * SM_CLOCK_HZ
    t_ops, t_bytes = lookups / per_word / rate, nbytes / HBM
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes",
            dict(lookups=lookups, lookups_per_word=per_word,
                 bound_bytes=nbytes, distinct_winners=winners,
                 word_rate_per_s=rate,
                 word_rate_basis=f"{SM_COUNT} SMs x 32 banks x "
                 f"{SM_CLOCK_HZ / 1e6:.0f} MHz (clocks.max.sm), one 32-bit "
                 "shared-memory word per bank per clock",
                 bound_ms_one_lookup_a_lane=1e3 * max(lookups / rate, t_bytes)))


def adc_kernel_checks(kernels, codes_p, i8_p, sc_p, n2_p, q, books, nt):
    """B8, B9, B10 (int8 and bf16 LUT) against their plain versions on one
    512-query batch of path (j): the LUTs the searches make of it.  The
    int8 LUT's: rows bit-identical, B10's values bit-identical (integer
    sums), B8/B9's reranked values within 1e-5 of (|q| + |x|)^2 (the kernel
    sums q.x in another order).  B10-bf16 adds each row's bf16 entries in
    another order than the plain version (subspace order): its rows and
    values bit-identical to that order's plain PyTorch (adc_bf16_model),
    and against the plain version its values within the bound of a
    reordered f32 sum, its picks the plain ones or near ties
    (adc_pallas.bf16_agreement; max_abs_err is against the plain
    version)."""
    import torch

    import erlvectordb_tpu_torch.ops.adc_pallas as ap
    from erlvectordb_tpu_torch.quant.pq import _adc_l2_tables

    lut3 = _adc_l2_tables(q, books)
    lut_s = ap.quantize_lut(lut3, shift=True)
    lut_i = ap.quantize_lut(lut3, shift=False)
    lut_f = lut3.reshape(q.shape[0], -1).contiguous()
    n_slices = 8 * min(-(-nt // 8), codes_p.shape[0] // (8 * ap.ADC_TILE_N))
    t9, t10 = ap.exact_t(nt), ap.exact_t(nt, 4, min(J_C, 512))
    rr = (q, i8_p, sc_p, n2_p)
    cases = (
        ("adc_pos_scan", "int8", lut_s, n_slices, True,
         lambda: ap.adc_pos_scan(codes_p, lut_s, *rr, n_slices),
         lambda: ap.adc_pos_scan_ref(codes_p, lut_s, *rr, n_slices)),
        ("adc_exact_scan", "int8", lut_s, nt, True,
         lambda: ap.adc_exact_scan(codes_p, lut_s, *rr, nt, t9),
         lambda: ap.adc_exact_scan_ref(codes_p, lut_s, *rr, nt, t9)),
        ("adc_pallas_scan", "int8", lut_i, nt, False,
         lambda: ap.adc_pallas_scan(codes_p, lut_i, n_tiles=nt, t_per_tile=t10),
         lambda: ap.adc_pallas_scan_ref(codes_p, lut_i, nt, t10)),
        ("adc_pallas_scan", "bf16", lut_f, nt, False,
         lambda: ap.adc_pallas_scan(codes_p, lut_f, n_tiles=nt, t_per_tile=t10),
         lambda: ap.adc_pallas_scan_ref(codes_p, lut_f, nt, t10)),
    )
    qn = torch.sqrt(torch.sum(q * q, dim=1, keepdim=True))
    for name, variant, lut, tiles, rerank, kern_fn, ref_fn in cases:
        (vk, rk), (vr, rr_) = kern_fn(), ref_fn()
        torch.cuda.synchronize()
        err = (vk - vr).abs()
        checks = {}
        if variant == "bf16":
            vm, rm = ap.adc_bf16_model(codes_p, lut, tiles, t10)
            agree = ap.bf16_agreement(vk, rk, codes_p, lut, tiles, t10,
                                      ref=(vr, rr_))
            checks = dict(model_mismatch=int((rk != rm).sum()
                                             + (vk != vm).sum()),
                          tolerance=agree["bound"],
                          max_err_over_tolerance=agree["max_err_over_bound"],
                          picks_differ_from_plain=agree["picks_differ"],
                          values_past_tolerance=agree["bad_values"],
                          picks_not_near_ties=agree["bad_picks"])
            mismatch = (checks["model_mismatch"] + agree["bad_values"]
                        + agree["bad_picks"])
            del vm, rm
        elif rerank:
            mismatch = int((rk != rr_).sum())
            tol = 1e-5 * (qn + torch.sqrt(n2_p[rr_.long()])) ** 2
            mismatch += int((err > tol).sum())
        else:
            mismatch = int((rk != rr_).sum() + (err != 0).sum())
        if mismatch:
            raise AssertionError(f"{name}[{variant}]: {mismatch} entries "
                                 f"differ from the plain version {checks}")
        ms, plain_ms = cuda_ms(kern_fn), cuda_ms(ref_fn, reps=2)
        b_ms, b_by, extra = adc_bound(lut, tiles * ap.ADC_TILE_N, rk,
                                      q if rerank else None, q.shape[1])
        rec = dict(max_abs_err=float(err.max()), mismatch=mismatch, ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   rows=tiles * ap.ADC_TILE_N,
                   extra=dict(batch=q.shape[0], m=J_OPQ["m"], k=books.shape[1],
                              picks_per_query=rk.shape[1], **checks,
                              **extra))
        kernels[(name, variant)] = rec
        emit("kernel", name=name, variant=variant,
             **{k: v for k, v in rec.items() if k != "extra"}, **rec["extra"])


def adc_build(data_dev):
    """Config 4's index on the card (bench.py:381-404): OPQ fit, encode,
    rotation, int8 rerank rows, everything padded to whole 8-slice groups;
    the timed query batches (rotated standard normals, bench.py:421-425) and
    the three searches, each a function of a query batch: B8
    (adc_search_exact_pos), B9 (adc_search_exact_fused) and B10
    (adc_search_fused, c = 2048).  Returns (codebook, (codes, i8 rows,
    scales, norms2), tiles, timed queries, searches, build seconds)."""
    import torch
    import torch.nn.functional as F

    import erlvectordb_tpu_torch.ops.adc_pallas as ap
    from erlvectordb_tpu_torch.ops.fused_topk import mul_recip
    from erlvectordb_tpu_torch.quant import OPQCodebook

    def build():
        cb = OPQCodebook.fit(data_dev, **J_OPQ)
        codes = cb.encode(data_dev)
        data_r = cb.rotate(data_dev)
        absmax = data_r.abs().amax(dim=1)
        # absmax / 127.0 under jit: a multiply by f32(1/127)
        scales = torch.where(absmax > 0, mul_recip(absmax, 127.0),
                             torch.ones_like(absmax))
        i8 = torch.clamp(torch.round(data_r / scales[:, None]), -127,
                         127).to(torch.int8)
        norms2 = scales ** 2 * torch.sum(i8.float() ** 2, dim=1)
        return cb, codes, i8, scales, norms2

    (cb, codes, i8, scales, norms2), build_s = timed(build)
    pad = (-J_ROWS) % (8 * ap.ADC_TILE_N)
    codes_p = F.pad(codes, (0, 0, 0, pad)).contiguous()
    i8_p = F.pad(i8, (0, 0, 0, pad)).contiguous()
    sc_p = F.pad(scales, (0, pad), value=1.0)
    n2_p = F.pad(norms2, (0, pad))
    nt = ap.adc_n_tiles(J_ROWS)
    books = cb.codebooks
    gen = np.random.default_rng(5)
    tq = cb.rotate(torch.from_numpy(gen.standard_normal(
        (J_BATCHES * J_BATCH, J_DIM)).astype(np.float32)).to(DEVICE))
    searches = {
        "pos": lambda q: ap.adc_search_exact_pos(
            codes_p, books, i8_p, sc_p, n2_p, q, J_ROWS, k=K, n_tiles=nt),
        "tfused": lambda q: ap.adc_search_exact_fused(
            codes_p, books, i8_p, sc_p, n2_p, q, J_ROWS, k=K, n_tiles=nt),
        "fused": lambda q: ap.adc_search_fused(
            codes_p, books, i8_p, sc_p, q, J_ROWS, k=K, c=J_C, n_tiles=nt),
    }
    return cb, (codes_p, i8_p, sc_p, n2_p), nt, tq, searches, build_s


def adc_phase(kernels, launches):
    """(j): config 4 on the card.  Build (adc_build), the kernel checks of
    B8-B10 on one batch, then the path with the launch counts zeroed: the
    three searches on 512-query batches, and recall@10 of each on the 256
    held-out corpus points against exact f32 ground truth.  Returns (corpus,
    held-out points, ground truth) for path (k)."""
    import torch

    data, held = adc_corpus(SEED + 4)
    data_dev = torch.from_numpy(data).to(DEVICE)
    cb, (codes_p, i8_p, sc_p, n2_p), nt, tq, searches, build_s = adc_build(
        data_dev)
    rq = cb.rotate(torch.from_numpy(held[:J_RECALL]).to(DEVICE))
    gt = exact_rows(data_dev, held[:J_RECALL], "euclidean")
    del data_dev
    adc_kernel_checks(kernels, codes_p, i8_p, sc_p, n2_p,
                      tq[:J_BATCH].contiguous(), cb.codebooks, nt)

    def run():
        out = {}
        for name, fn in searches.items():
            timed(lambda: fn(tq[:J_BATCH]))   # warm
            secs = [timed(lambda: fn(tq[i * J_BATCH:(i + 1) * J_BATCH]))[1]
                    for i in range(J_BATCHES)]
            dists, rows = fn(rq)
            if not bool(torch.isfinite(dists).all()):
                raise AssertionError(f"(j) {name}: non-finite distances")
            med = float(np.median(secs))
            out[name] = dict(batch_ms_median=1e3 * med,
                             batch_ms_all=[1e3 * x for x in secs],
                             qps=J_BATCH / med,
                             recall_at_10=overlap(rows.cpu().numpy(), gt))
        return out

    reset_launches()
    res = run()
    torch.cuda.synchronize()
    launches["j"] = read_launches()
    profile = profile_calls(lambda: searches["pos"](tq[:J_BATCH]), reps=10)
    emit("adc", rows=J_ROWS, dim=J_DIM, build_s=build_s,
         n_tiles=nt, padded_rows=codes_p.shape[0], searches=res,
         profile_pos_batch512=profile, launches=launches["j"])
    for kname, variant in (("adc_pos_scan", "int8"), ("adc_exact_scan", "int8"),
                           ("adc_pallas_scan", "int8")):
        if not launches["j"].get(kname, {}).get(variant):
            raise AssertionError(f"path j never launched {kname}[{variant}]: "
                                 f"{launches['j']}")
    if min(res["pos"]["recall_at_10"], res["tfused"]["recall_at_10"]) < 0.95:
        raise AssertionError(f"(j) recall@10 below 0.95: {res}")
    return data, held, gt


def index_manager_phase(data, held, gt, launches):
    """(k): the index manager over MCP on a 1M x 128 float32 euclidean store
    of (j)'s corpus.  With the launch counts zeroed: each index type created,
    built and searched through the MCP tools (256 search_index calls of the
    held-out points), each answer checked against a direct
    IndexManager.search of the same query; recall@10 against (j)'s exact
    ground truth, the median search_index latency, build seconds."""
    import torch

    from erlvectordb_tpu_torch.api import Database
    from erlvectordb_tpu_torch.core.store import VectorStore
    from erlvectordb_tpu_torch.infra.config import load_config
    from erlvectordb_tpu_torch.serve.mcp_server import MCPServer

    db = Database(load_config(overrides={"persistence_enabled": False}, env={}),
                  device=torch.device(DEVICE)).start()
    server = None
    try:
        store, store_s = timed(lambda: VectorStore.from_matrix(
            "k", data, metric="euclidean", dtype="float32", device=DEVICE))
        db.registry.adopt(store)
        server = MCPServer(db, host="127.0.0.1", port=0).start()
        port = server._sock.getsockname()[1]
        token = db.oauth.grant_client_credentials(
            "erlvectordb_client", "erlvectordb_secret")["access_token"]
        cl = Client(port, token)
        qs = held[:J_RECALL]

        def run():
            res = {}
            for itype in K_TYPES:
                name = f"k_{itype}"
                cl.tool("create_index", name=name, store="k", type=itype)
                info = cl.tool("build_index", name=name)
                if not info["built"]:
                    raise AssertionError(f"(k) {itype} build failed: {info}")
                lat, got, same = [], [], 0
                for q in qs:
                    t0 = time.perf_counter()
                    r = cl.tool("search_index", name=name, vector=q.tolist(),
                                k=K)
                    lat.append(time.perf_counter() - t0)
                    ids = [h["id"] for h in r["results"]]
                    direct = [h[0] for h in db.indexes.search(name, q, k=K)]
                    same += ids == direct
                    got.append(ids)
                res[itype] = dict(build_s=info["build_seconds"],
                                  stats=info["stats"],
                                  recall_at_10=overlap(got, gt),
                                  search_index_ms_median=1e3 * float(
                                      np.median(lat)),
                                  same_as_direct=same / len(qs))
            return res, cl.tool("list_indexes")

        reset_launches()
        res, listed = run()
        torch.cuda.synchronize()
        launches["k"] = read_launches()
        cl.sock.close()
    finally:
        if server is not None:
            server.stop()
        db.stop()
    emit("indexes", rows=J_ROWS, store_build_s=store_s, by_type=res,
         listed=[i["name"] for i in listed["indexes"]], launches=launches["k"])
    if any(r["same_as_direct"] < 1.0 for r in res.values()):
        raise AssertionError(f"(k) search_index differs from a direct "
                             f"IndexManager.search: {res}")
    if sorted(i["name"] for i in listed["indexes"]) != sorted(
            f"k_{t}" for t in K_TYPES):
        raise AssertionError(f"(k) list_indexes: {listed}")
    if not launches["k"].get("gather_dots", {}).get("int8"):
        raise AssertionError(f"path k (cellprobe) never launched "
                             f"gather_dots[int8]: {launches['k']}")


def kernel_summary(kernels, launches) -> list:
    """The contract's kernel rows: each checked kernel row with its launches
    on the paths that serve it (a row of a variant checked at several
    shapes counts the variant's launches)."""
    served = {}   # (kernel, variant) -> launches on the path that serves it
    for counts in launches.values():
        for kname, by in counts.items():
            for variant, n in by.items():
                served[(kname, variant)] = served.get((kname, variant), 0) + n
    summary = []
    for (name, variant), r in kernels.items():
        src, replaces = KERNEL_INFO[name]
        launch_variant = r.get("launch_variant", variant)
        src = F32_SOURCE if launch_variant == "f32" else src
        summary.append({
            "name": (f"{name}_{variant}"
                     if name in ("pos_scan", "fused_scan", "gather_dots",
                                 "adc_pallas_scan")
                     else name),
            "route": "cuda", "source": CSRC + src, "replaces": replaces,
            "launches": served.get((name, launch_variant), 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "library": (NO_LIBRARY_B7 if name == "gather_dots" else
                        NO_LIBRARY_ADC if name.startswith("adc_") else
                        NO_LIBRARY),
            "variant": variant, "rows": r["rows"], "mismatch": r["mismatch"],
            **r.get("extra", {})})
    return summary


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import erlvectordb_tpu_torch.ops.fused_topk as ft
        from erlvectordb_tpu_torch.api import Database
        from erlvectordb_tpu_torch.core.store import VectorStore
        from erlvectordb_tpu_torch.infra.config import load_config
        from erlvectordb_tpu_torch.ops import cuda_lib
        from erlvectordb_tpu_torch.utils.metrics import device_stats
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1

    global SM_CLOCK_HZ, SM_COUNT
    smi = nvidia_smi()
    print(smi, flush=True)
    SM_CLOCK_HZ = 1e6 * float(nvidia_smi("clocks.max.sm").split()[0])
    SM_COUNT = torch.cuda.get_device_properties(0).multi_processor_count
    emit("device", nvidia_smi=smi, sm_clock_max_hz=SM_CLOCK_HZ, **device_stats(),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    cuda_lib.library()
    build_s = time.perf_counter() - t0
    log = cuda_lib.build_info.get("log", "").splitlines()
    spills = [f"{log[i - 2].split('entry function')[-1].strip()} {ln.strip()}"
              for i, ln in enumerate(log)
              if "spill stores" in ln and not ln.strip().startswith("0 bytes")
              and i >= 2]
    # registers and spills of each instantiation of the checked kernels
    # (ptxas: entry, properties, frame/spills, usage)
    redesigned = {}
    for i, ln in enumerate(log[:-3]):
        for kname in CHECKED_KERNELS:
            if "Compiling entry" in ln and kname in ln:
                tmpl = ln.split(kname)[1].split("EE")[0]
                redesigned[f"{kname}{tmpl}"] = (
                    f"{log[i + 2].strip()}; {log[i + 3].split(':')[-1].strip()}")
    spilled = {k: v for k, v in redesigned.items()
               if not v.split("bytes spill stores")[0].rstrip().endswith(" 0")}
    counts = {k: sum(n.startswith(k) for n in redesigned) for k in CHECKED_KERNELS}
    emit("build", kernel_build_s=build_s, spills=spills,
         entries=sum("Compiling entry" in ln for ln in log),
         redesigned_kernels=redesigned or None, instantiations=counts,
         **({} if log else {"redesigned_kernels_missing":
                            f"no ptxas report beside {cuda_lib.build_info['path']}"}))
    if counts != CHECKED_KERNELS or spilled:
        raise AssertionError(f"checked kernels {counts} (expected "
                             f"{CHECKED_KERNELS}), spilled: {spilled}")

    corpus = make_corpus(SEED, N_ROWS)
    queries = make_corpus(SEED + 1, BATCH)
    dev = torch.device(DEVICE)
    stores, build_ms = {}, {}
    specs = (("a", corpus, dict(dtype="int8", metric="cosine", intkey=True)),
             ("b", corpus, dict(dtype="int8", metric="euclidean", intkey=True)),
             ("c", corpus, dict(dtype="int8", metric="cosine")),
             ("c32", corpus, dict(dtype="float32", metric="cosine")),
             ("e", corpus, dict(dtype="int4", metric="cosine")),
             ("f", corpus, dict(dtype="int4r", metric="cosine")),
             ("g_ref", corpus[:SMALL_ROWS], dict(dtype="int4", metric="cosine")),
             ("h", corpus[:SMALL_ROWS], dict(dtype="int4r", metric="cosine")))
    for name, x, kw in specs:
        stores[name], secs = timed(lambda: VectorStore.from_matrix(
            name, x, device=dev, **kw))
        build_ms[name] = 1e3 * secs
    emit("build", store_build_ms=build_ms,
         build_rows_per_s={s: len(x) / (build_ms[s] / 1e3) for s, x, _ in specs},
         device_bytes={s: st.device_memory_bytes() for s, st in stores.items()},
         n_tiles={s: ft.n_tiles_for(st._next_row, st.capacity)
                  for s, st in stores.items()},
         f_cells=len(stores["f"]._cell_next), h_cells=len(stores["h"]._cell_next),
         f_build_stats=stores["f"].build_stats)

    kernels = kernel_phase(stores, queries)
    del stores["g_ref"]
    torch.cuda.empty_cache()

    db = Database(load_config(overrides={"persistence_enabled": False}, env={}),
                  device=dev).start()
    try:
        for s in stores.values():
            db.registry.adopt(s)
        f32_rows = make_corpus(SEED + 2, F32_ROWS)
        launches, mp_curve = slice_phase(db, corpus, queries, f32_rows)
    finally:
        db.stop()
    rq_phase(corpus, queries, stores, mp_curve[RQ_NPROBE], launches)
    stores.clear()
    del db, corpus
    torch.cuda.empty_cache()
    index_phase(kernels, launches)
    torch.cuda.empty_cache()
    data, held, gt = adc_phase(kernels, launches)
    torch.cuda.empty_cache()
    index_manager_phase(data, held, gt, launches)

    print(json.dumps({"kernels": kernel_summary(kernels, launches)}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
