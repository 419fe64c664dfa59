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
              store of (j)'s corpus, pq / opq / int8 / ivf / cellprobe and
              (n-ep) ep_ivf / ep_cellprobe (cells sharded over a mesh of
              every card) indexes created, built, listed and searched
              through the MCP tools (256 search_index calls each, every
              answer the same as a direct IndexManager.search; ep_ivf
              recall@10 >= 0.95, ep_cellprobe's at least cellprobe's less
              0.01) -> B7 gather_dots int8 (cellprobe);
              then (l) every index saved (save_all), loaded into a fresh
              IndexManager (load_indexes) and searched again: the same
              answers;
  8. durability (l), after (f-rq): stores (a), (h) (after its 1,000 MCP
              inserts) and the rq_m = 9 store of (f-rq), each adopted by a
              Database with the default configuration (persistence on):
              a full base, 1,000 inserts and 1,000 deletes through its verbs,
              a second sync (a delta on (a)), a stop, and a new Database
              started on the same directory: the time to recover, bytes on
              disk, the same ids for the 1024-query batch (store (a): and
              distances, bit for bit), inserted rows read back, deleted rows
              absent; (a) also recall@10 and a backup restored under a new
              name -> B1 at (a), B6/B5 at (h), B7 gather_dots int4 at (f-rq),
              through the recovered stores; (l-c) compress_batch /
              decompress_batch on the card over 65,536 rows of the corpus
              (8bit, 4bit, pca, product): rows/s, ratio, error;
  9. app      (m), after (l): the port's server through its entry points.
              An Application with the default configuration (a config file
              sets the directories, a sync interval of 3600 s and ports from
              28000; container mode, so the health endpoint starts) on the
              card; /health, /ready, /health/detailed over REST and the
              health endpoint, naming the card; a token over OAuth HTTP;
              store m (int8 cosine) created over REST and filled with the
              1.2M rows over gRPC InsertBatch (REST without grpcio); the
              MCP b64 batch and gRPC SearchBatch (1024 queries) equal to the
              in-process batch bit for bit, StreamSearch, REST (8 threads)
              and MCP search_vectors (256 single queries) equal to it within
              1e-6 relative, recall@10 >= 0.95; /metrics, the ports status
              and app.status(); app.stop() (a full base, every port free);
              then `python -m erlvectordb_tpu_torch.cli serve` from the same
              file: the time to recover to the same batch bit for bit,
              `cli check`, the stdio bridge (`cli bridge`), and SIGTERM to
              exit 0 within the graceful-shutdown timeout, every port free
              -> B3 pos_scan int8;
 10. distribution (n), after (m): the sharded stores (parallel/), each step
              with the launch counts zeroed just before it and read after:
                (n5) config 5 at full scale (bench.py:478-560): 10M x 768
                    int8 cosine rows drawn on the card in 262,144-row chunks
                    and streamed into ShardedVectorStore.from_chunks on
                    make_mesh() (1 x 1); 64 dequantized rows find themselves;
                    codes, scales and norms equal to a local int8 VectorStore
                    filled from the same chunk stream, and its 1024-query
                    batch equal bit for bit; sequential and pipelined batch
                    times; recall@10 of 256 held-out points against exact f32
                    -> B3 pos_scan int8 at W 768;
                (n3) config 3's corpus through Database.distribute_store on a
                    card Database (1 x 1), then on ClusterManagers over
                    cuda:0 x 4: 2 replica groups x 2 shards (the batch split
                    across the groups; fail_device(1) moves the store to the
                    surviving group and the batch stays bit for bit;
                    recover_device(1)) and 4 x 1; the 1 x 1 batch equal bit
                    for bit to a local store of the rows it was given
                    (get_all_vectors: dequantized, so its overlap@10 with
                    (c)'s batch is recorded), the others' overlap@10 with it
                    >= 0.99, recall@10 >= 0.95 on every mesh
                    -> B3 pos_scan int8 (1 x 1, 2 x 2), B4 fused_scan int8 at
                    T 8 (4 x 1);
                (n-dur) the 1 x 1 store synced by its Database (persistence
                    on), stopped and recovered by a new Database, then backed
                    up and restored under a new name: the batch bit for bit;
                (n-dim) config 3 as a DimShardedVectorStore over cuda:0 x 4,
                    f32: overlap@10 >= 0.99 with the exact f32 top-10;
              and the two kernel checks at (n)'s shapes: B3-int8 over the
              first 1,048,576 rows of (n5)'s shard and B4-int8 at T 8 over
              one 300,000-row shard of the 4 x 1 store, bit for bit;
              (n-ep) the ep_ivf and ep_cellprobe indexes ride path (k);

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
import gc
import json
import math
import os
import queue
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

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
K_TYPES = ("pq", "opq", "int8", "ivf", "cellprobe", "ep_ivf",
           "ep_cellprobe")   # (k)'s index types; the last two are (n-ep)
# (l): rows inserted into and deleted from (a), (h) and (f-rq) between their
# full base and the sync after it; (l-c): the rows compressed on the card
L_NEW = L_DELETE = 1_000
L_PROBE = {"a": {}, "h": {}, "f-rq": {"nprobe": 64}}
L_KERNELS = {"a": (("intkey_scan", "int8"),),
             "h": (("cell_scan", "int4"), ("pos_residual_scan", "int4")),
             "f-rq": (("gather_dots", "int4"),)}
C_ROWS, C_ALGS = 65_536, ("8bit", "4bit", "pca", "product")
# (m): the server through its entry points, on ports no other path and no
# test uses; fill messages of 8,192 rows over gRPC (3.3 MB, under gRPC's 4 MB
# default) or 32,768 rows over REST (under its 256 MB body cap); 256 single
# queries over REST from 8 threads, over MCP pipelined and over StreamSearch
M_BASE = 28000
M_SERVICES = ("mcp_server", "oauth_server", "rest_api", "grpc_server",
              "health_check")
M_GRPC_ROWS, M_REST_ROWS = 8_192, 32_768
M_SINGLES, M_THREADS, M_REPS = 256, 8, 5
# (n): config 5 (bench.py:478-560): 10M x 768 int8 cosine, 1024 Gaussian
# centres, noise 0.35, 262,144-row chunks drawn on the card, 1024 standard
# normal queries from np.random.default_rng(9), T = 4 pipelined tickets;
# 64 probe rows, 256 held-out points for recall; the B3 check's rows
N5_ROWS, N5_DIM, N5_CHUNK, N5_SEED = 10_000_000, 768, 262_144, 5
N5_PROBES, N5_PIPE, N5_CHECK_ROWS = 64, 4, 1_048_576
# (n3): the cluster over one card, cuda:0 repeated
N3_DEVICES = 4
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


def batch_answer(client, store, qs, k=K):
    """(rows, distances) of one b64 search_vectors_batch; rows are the ids
    of the bulk-built and in-order filled stores."""
    r = client.tool("search_vectors_batch", store=store, vectors_b64=b64(qs),
                    dim=DIM, k=k, encoding="b64")
    rows = np.frombuffer(base64.b64decode(r["rows_b64"]), "<i4").reshape(len(qs), k)
    dists = np.frombuffer(base64.b64decode(r["distances_b64"]), "<f4").reshape(len(qs), k)
    if not np.all(np.isfinite(dists)):
        raise AssertionError(f"{store}: non-finite distances")
    return rows, dists


def batch_rows(client, store, qs, k=K):
    return batch_answer(client, store, qs, k)[0]


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
    return launches, mp_curve, got["c"]


def rq_phase(corpus, queries, stores, stage1, launches):
    """(f-rq): the int4r store of the config-3 corpus with the rq_m second
    stage (bench.py:1008), driven with the launch counts zeroed: the
    multiprobe recall@10 at nprobe 512 for each rescore pool, and one
    64-query dispatch at nprobe 64 beside store (f)'s (bench.py:1020-1031).
    ``stage1``: (f)'s recall@10 at nprobe 512, stage 1 alone.  Returns the
    store, for path (l)."""
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
    return store


# --------------------------------------------------------------- durability


def dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def raw_search(store, qs, **probe):
    """(ids [nq, K] object, distances [nq, K] f32) of one store batch."""
    dists, _rows, ids = store.search_batch_complete_raw(
        store.search_batch_submit(qs, k=K, **probe))
    return ids, dists


def launch_diff(after, before) -> dict:
    out = {}
    for kname, by in after.items():
        d = {v: n - before.get(kname, {}).get(v, 0) for v, n in by.items()}
        d = {v: n for v, n in d.items() if n}
        if d:
            out[kname] = d
    return out


def exact_ids_after(corpus, deleted, new_rows, new_ids, qs):
    """Exact f32 cosine top-K ids over the corpus with ``deleted`` rows
    removed and ``new_rows`` added (the recall reference after (l)'s
    mutations)."""
    import torch

    from erlvectordb_tpu_torch.ops.fused_topk import full_f32_matmul

    q = torch.from_numpy(qs).to(DEVICE)
    scores = []
    for rows in (corpus, new_rows):
        x = torch.from_numpy(rows).to(DEVICE)
        with full_f32_matmul():
            scores.append((q @ x.T) / x.norm(dim=1)[None, :])
        del x
    scores[0][:, torch.from_numpy(deleted).to(DEVICE)] = -torch.inf
    top = torch.topk(torch.cat(scores, dim=1), K, dim=1).indices.cpu().numpy()
    n = len(corpus)
    return [[str(i) if i < n else new_ids[i - n] for i in row] for row in top]


def durable_path(name, store, root, corpus, queries, n_base, launches):
    """Path (l) on one store built on the card: a Database with the default
    configuration (persistence on; only the directories and a long sync
    interval set) adopts it, syncs a full base, takes L_NEW inserts and
    L_DELETE deletes through its verbs and syncs again (a delta where the
    store did not grow), then stops; the store is freed and a new Database
    starts on the same directory.  Gates: the same ids (store (a): and
    distances, bit for bit) for the 1024-query batch (with L_PROBE) as just
    before the stop, each inserted row its own top-1 through the full scan
    (>= 0.99), no deleted id returned for the deleted rows' own vectors, the
    recovered store's batch served by its kernel.  Store (a) also: the second sync a delta, recall@10 >= 0.95
    against exact f32 over the mutated corpus, and a backup restored under a
    new name answering the batch the same.  Returns the step numbers."""
    import torch

    from erlvectordb_tpu_torch.api import Database
    from erlvectordb_tpu_torch.infra.config import load_config

    probe = L_PROBE[name]
    cfg = load_config(overrides={"persistence_dir": f"{root}/{name}/data",
                                 "backup_dir": f"{root}/{name}/backups",
                                 "sync_interval": 3600.0}, env={})
    sdir = Path(cfg.persistence_dir) / name
    qs = queries[:BATCH]
    new_rows = make_corpus(SEED + 10, L_NEW)   # config 3's recipe, new seed
    new_ids = [f"l{j}" for j in range(L_NEW)]
    deleted = np.sort(np.random.default_rng(SEED + 11).choice(
        n_base, L_DELETE, replace=False))
    del_ids = [str(r) for r in deleted]
    out = {"store": name, "rows": store.count, "probe": probe}

    reset_launches()
    db = Database(cfg, device=torch.device(DEVICE)).start()
    # the store was built on the card before this phase: the Database
    # adopts it and tracks it, as restore_store and import_store do
    db.registry.adopt(store)
    db.persistence.track(store)
    _, out["full_sync_s"] = timed(lambda: db.sync(name))
    if list(sdir.glob("delta_*")):
        raise AssertionError(f"(l) {name}: the first sync wrote a delta")
    out["full_bytes"] = dir_bytes(sdir)
    _, out["insert_s"] = timed(lambda: db.insert_batch(name, new_ids, new_rows))
    _, out["delete_s"] = timed(lambda: [db.delete(name, v) for v in del_ids])
    mid_ids, mid_d = raw_search(store, qs, **probe)
    count = store.count
    _, out["second_sync_s"] = timed(lambda: db.sync(name))
    deltas = sorted(sdir.glob("delta_*"))
    out["second_sync"] = "delta" if deltas else "full"
    out["second_sync_bytes"] = (sum(p.stat().st_size for p in deltas)
                                if deltas else dir_bytes(sdir))
    db.stop()
    db = store = None
    gc.collect()
    torch.cuda.empty_cache()

    pre = read_launches()
    t0 = time.perf_counter()
    db = Database(cfg, device=torch.device(DEVICE)).start()
    back = db.get_store(name)
    ids, dists = raw_search(back, qs, **probe)
    torch.cuda.synchronize()
    out["time_to_recover_s"] = time.perf_counter() - t0
    out["recovered_launches"] = launch_diff(read_launches(), pre)
    # the read-back runs through the full scan: multiprobe misses rows that
    # an insert batch parks in cells spawned for its overflow (k-means of
    # rows of unrelated directions, as in the JAX package), so at nprobe 64
    # it is recorded, not gated
    top1, _ = raw_search(back, new_rows)
    out["inserted_top1"] = float(np.mean(top1[:, 0] == np.asarray(new_ids)))
    if probe:
        top1, _ = raw_search(back, new_rows, **probe)
        out["inserted_top1_probe"] = float(np.mean(
            top1[:, 0] == np.asarray(new_ids)))
    gone, _ = raw_search(back, corpus[deleted], **probe)
    out["deleted_returned"] = int(np.isin(np.concatenate(
        [gone.ravel(), ids.ravel()]).astype(str), del_ids).sum())
    out["same_ids"] = bool(np.array_equal(ids, mid_ids))
    out["same_distances"] = bool(np.array_equal(dists, mid_d))
    out["max_abs_distance_change"] = float(np.abs(dists - mid_d).max())
    out["count_after"] = back.count
    if name == "a":
        gt = exact_ids_after(corpus, deleted, new_rows, new_ids, qs[:N_RECALL])
        out["recall_at_10"] = overlap(ids[:N_RECALL].tolist(), gt)
        path, out["backup_s"] = timed(lambda: db.backup_store(name, "l"))
        out["backup_bytes"] = os.path.getsize(path)
        _, out["restore_s"] = timed(lambda: db.restore_store(
            os.path.basename(path), new_name="a-restored"))
        r_ids, r_d = raw_search(db.get_store("a-restored"), qs, **probe)
        out["restored_same_ids"] = bool(np.array_equal(r_ids, mid_ids))
        out["restored_same_distances"] = bool(np.array_equal(r_d, mid_d))
        db.delete_store("a-restored")
        db.delete_backup(os.path.basename(path))
    db.stop()
    torch.cuda.synchronize()
    launches[f"l-{name}"] = read_launches()
    del db, back
    gc.collect()
    torch.cuda.empty_cache()

    bad = []
    if not out["same_ids"] or out["count_after"] != count:
        bad.append("ids or count changed over the restart")
    if name == "a" and not (out["same_distances"] and out["second_sync"] == "delta"
                            and out["recall_at_10"] >= 0.95
                            and out["restored_same_ids"]
                            and out["restored_same_distances"]):
        bad.append("store (a): distances, delta path, recall or backup")
    if out["inserted_top1"] < 0.99 or out["deleted_returned"]:
        bad.append("inserted rows not read back, or deleted rows returned")
    if not any(out["recovered_launches"].get(k, {}).get(v)
               for k, v in L_KERNELS[name]):
        bad.append(f"the recovered store's batch launched none of "
                   f"{L_KERNELS[name]}")
    emit("durability", **out, launches=launches[f"l-{name}"])
    if bad:
        raise AssertionError(f"(l) {name}: {bad}: {out}")
    return out


def durability_phase(corpus, queries, stores, launches) -> None:
    """(l): durable_path on store (a) (B1), store (h) after its 1,000 MCP
    inserts (B6, or B5 where rows spawned cells) and the rq_m = 9 store of
    (f-rq) (B7-int4 and the pooled rescore), each in a directory of its own
    under a temporary root that the phase removes."""
    root = tempfile.mkdtemp(prefix="evdb_durability_")
    try:
        for name, n_base in (("a", N_ROWS), ("h", SMALL_ROWS),
                             ("f-rq", N_ROWS)):
            durable_path(name, stores.pop(name), root, corpus, queries,
                         n_base, launches)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def compression_phase(corpus) -> None:
    """(l-c): compress_batch / decompress_batch on the card over C_ROWS rows
    of config 3's corpus for 8bit, 4bit, pca (fit on those rows) and product
    (fit): rows/s each way, the payload ratio (and with the side arrays),
    and the reconstruction error beside the bounds of
    tests/test_compression.py (8bit: range/255, 4bit: range/15 per row,
    gated; pca: 1e-3 relative on rank-8 data, product: MSE < 0.05 of the
    variance on 32-cluster data — those hold for their tests' data and are
    recorded here, where the gate is an MSE below the variance)."""
    import torch

    from erlvectordb_tpu_torch.quant.compression import (
        compress_batch,
        decompress_batch,
    )

    x = corpus[:C_ROWS]
    rng = x.max(axis=1) - x.min(axis=1)
    res = {}
    for alg in C_ALGS:
        cvs, c_s = timed(lambda: compress_batch(x, alg, device=DEVICE))
        rec, d_s = timed(lambda: np.stack(decompress_batch(cvs,
                                                           device=DEVICE)))
        payload = sum(len(cv.payload) for cv in cvs)
        side = sum(a.nbytes for a in cvs[0].arrays.values())
        err = rec - x
        mse = float(np.mean(err ** 2))
        row = dict(compress_rows_per_s=len(x) / c_s, compress_s=c_s,
                   decompress_rows_per_s=len(x) / d_s, decompress_s=d_s,
                   ratio_payload=x.nbytes / payload,
                   ratio_with_side_arrays=x.nbytes / (payload + side),
                   mse=mse, mse_over_variance=mse / float(np.var(x)),
                   relative_error=float(np.linalg.norm(err) / np.linalg.norm(x)),
                   max_abs_err=float(np.abs(err).max()),
                   finite=bool(np.isfinite(rec).all()),
                   shape_ok=rec.shape == x.shape)
        if alg in ("8bit", "4bit"):
            levels = 255 if alg == "8bit" else 15
            row["within_test_bound"] = bool(np.all(
                np.abs(err).max(axis=1) <= rng / levels + 1e-6))
        res[alg] = row
    torch.cuda.synchronize()
    emit("compression", rows=C_ROWS, dim=DIM, by_algorithm=res,
         test_bounds={"8bit": "max |err| <= range/255 + 1e-6 per row",
                      "4bit": "max |err| <= range/15 + 1e-6 per row",
                      "pca": "relative error < 1e-3 on rank-8 data",
                      "product": "MSE < 0.05 variance on 32-cluster data"})
    bad = {a: r for a, r in res.items()
           if not (r["finite"] and r["shape_ok"] and r["mse_over_variance"] < 1.0
                   and r.get("within_test_bound", True))}
    if bad:
        raise AssertionError(f"(l-c) compression: {bad}")


# ---------------------------------------------------------------------- app


def http(url, body=None, token=None, form=False, timeout=600):
    """(status, body bytes) of one HTTP request; an error status is
    returned, not raised."""
    headers, data = {}, None
    if body is not None:
        if form:
            data = urllib.parse.urlencode(body).encode()
            headers["Content-Type"] = "application/x-www-form-urlencoded"
        else:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(url, data=data, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def get_token(oauth_port: int) -> str:
    status, body = http(f"http://127.0.0.1:{oauth_port}/oauth/token", {
        "grant_type": "client_credentials", "client_id": "erlvectordb_client",
        "client_secret": "erlvectordb_secret"}, form=True)
    if status != 200:
        raise AssertionError(f"(m) token: {status} {body[:200]}")
    return json.loads(body)["access_token"]


def health_of(port: int, device_name: str) -> dict:
    """/health, /ready and /health/detailed on one port; each must answer
    healthy, the devices check naming the card."""
    base = f"http://127.0.0.1:{port}"
    out = {}
    for path in ("/health", "/ready", "/health/detailed"):
        status, body = http(base + path)
        out[path] = (status, json.loads(body))
    dev = out["/health/detailed"][1]["checks"]["devices"]
    if not (out["/health"] == (200, {"status": "healthy"})
            and out["/ready"] == (200, {"ready": True})
            and out["/health/detailed"][1]["status"] == "healthy"
            and dev["status"] == "healthy"
            and dev["details"]["platform"] == "gpu"
            and dev["details"]["device"] == device_name):
        raise AssertionError(f"(m) health on port {port}: {out}")
    return dev["details"]


def ms_stats(seconds) -> dict:
    ms = 1e3 * np.asarray(seconds)
    return {"median_ms": float(np.median(ms)),
            "p99_ms": float(np.percentile(ms, 99)), "n": int(ms.size)}


def same_row(name, ids, dists, ref_ids, ref_d, exact):
    """A frontend's answer against the in-process batch: ids equal and the
    distances bit for bit (exact) or within 1e-6 relative."""
    ids = np.asarray(ids).astype(str)
    dists = np.asarray(dists, np.float32)
    if not np.array_equal(ids, ref_ids):
        raise AssertionError(f"(m) {name}: ids differ from the in-process batch")
    if exact and not np.array_equal(dists, ref_d):
        raise AssertionError(f"(m) {name}: distances not bit-identical")
    if not np.allclose(dists, ref_d, rtol=1e-6, atol=0):
        raise AssertionError(f"(m) {name}: distances beyond 1e-6 relative")
    return bool(np.array_equal(dists, ref_d))


def grpc_calls(port: int, token: str):
    """(channel, {method: callable}) of the ErlVectorDB service."""
    import grpc

    from erlvectordb_tpu_torch.serve import evdb_pb2 as pb

    ch = grpc.insecure_channel(f"127.0.0.1:{port}")
    md = [("authorization", f"Bearer {token}")]

    def unary(name, req, rep):
        fn = ch.unary_unary(f"/evdb.ErlVectorDB/{name}",
                            request_serializer=req.SerializeToString,
                            response_deserializer=rep.FromString)
        return lambda msg: fn(msg, timeout=600, metadata=md)

    stream = ch.stream_stream("/evdb.ErlVectorDB/StreamSearch",
                              request_serializer=pb.SearchRequest.SerializeToString,
                              response_deserializer=pb.SearchReply.FromString)
    return ch, pb, {
        "InsertBatch": unary("InsertBatch", pb.InsertBatchRequest, pb.StatusReply),
        "SearchBatch": unary("SearchBatch", pb.SearchBatchRequest, pb.SearchBatchReply),
        "StreamSearch": lambda reqs: stream(reqs, timeout=600, metadata=md)}


def fill_store(corpus, ports, token, use_grpc):
    """All of corpus into store m, ids "0".."n-1", over gRPC InsertBatch
    where grpcio imports, else REST batched inserts."""
    n = len(corpus)
    t0 = time.perf_counter()
    if use_grpc:
        ch, pb, calls = grpc_calls(ports["grpc_server"], token)
        with ch:
            for lo in range(0, n, M_GRPC_ROWS):
                rows = corpus[lo:lo + M_GRPC_ROWS]
                r = calls["InsertBatch"](pb.InsertBatchRequest(
                    store="m", ids=[str(i) for i in range(lo, lo + len(rows))],
                    vectors_f32=np.ascontiguousarray(rows, "<f4").tobytes(),
                    dim=DIM))
                if not (r.ok and r.message == str(len(rows))):
                    raise AssertionError(f"(m) InsertBatch at {lo}: {r}")
    else:
        url = f"http://127.0.0.1:{ports['rest_api']}/api/v1/stores/m/vectors"
        for lo in range(0, n, M_REST_ROWS):
            rows = corpus[lo:lo + M_REST_ROWS]
            status, body = http(url, {"vectors": [
                {"id": str(lo + j), "vector": v.tolist()}
                for j, v in enumerate(rows)]}, token)
            if status != 201 or json.loads(body)["inserted"] != len(rows):
                raise AssertionError(f"(m) REST insert at {lo}: {status} {body[:200]}")
    secs = time.perf_counter() - t0
    return {"frontend": "grpc" if use_grpc else "rest", "rows": n,
            "message_rows": M_GRPC_ROWS if use_grpc else M_REST_ROWS,
            "seconds": secs, "rows_per_s": n / secs}


def rest_singles(port, token, qs):
    """One REST /search per query from M_THREADS client threads (the
    batcher coalesces them): ([ids], [distances], [seconds])."""
    url = f"http://127.0.0.1:{port}/api/v1/stores/m/search"
    ids, dists, lat = [None] * len(qs), [None] * len(qs), [0.0] * len(qs)
    errors = []

    def run(lo):
        for i in range(lo, len(qs), M_THREADS):
            t0 = time.perf_counter()
            status, body = http(url, {"vector": qs[i].tolist(), "k": K}, token)
            lat[i] = time.perf_counter() - t0
            if status != 200:
                errors.append((i, status, body[:200]))
                return
            hits = json.loads(body)["results"]
            ids[i] = [h["id"] for h in hits]
            dists[i] = [h["distance"] for h in hits]

    threads = [threading.Thread(target=run, args=(lo,)) for lo in range(M_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"(m) REST singles: {errors[:3]}")
    return ids, dists, lat


def mcp_singles(cl, qs):
    """search_vectors for every query, pipelined in chunks of <= 500 (a
    larger pipeline fills the server's send buffer and deadlocks):
    ([ids], [distances], [seconds from the chunk's send to the answer])."""
    ids, dists, lat = [], [], []
    for lo in range(0, len(qs), 500):
        chunk = qs[lo:lo + 500]
        first = cl.next_id + 1
        reqs = []
        for q in chunk:
            cl.next_id += 1
            reqs.append(json.dumps({
                "jsonrpc": "2.0", "id": cl.next_id, "method": "tools/call",
                "params": {"name": "search_vectors",
                           "arguments": {"store": "m", "vector": q.tolist(), "k": K}},
                "auth": {"token": cl.token}}))
        t0 = time.perf_counter()
        cl.sock.sendall(("\n".join(reqs) + "\n").encode())
        got = {}
        while len(got) < len(chunk):
            resp = cl._line()
            got[resp["id"]] = (resp, time.perf_counter() - t0)
        for i in range(first, first + len(chunk)):
            resp, secs = got[i]
            if "error" in resp:
                raise AssertionError(f"(m) MCP search_vectors: {resp['error']}")
            hits = json.loads(resp["result"]["content"][0]["text"])["results"]
            ids.append([h["id"] for h in hits])
            dists.append([h["distance"] for h in hits])
            lat.append(secs)
    return ids, dists, lat


def grpc_serve(ports, token, qs):
    """SearchBatch over qs (M_REPS times) and StreamSearch over the first
    M_SINGLES queries, pipelined: the answers and their seconds."""
    ch, pb, calls = grpc_calls(ports["grpc_server"], token)
    with ch:
        req = pb.SearchBatchRequest(store="m", dim=DIM, k=K,
                                    vectors_f32=np.ascontiguousarray(qs, "<f4").tobytes())
        lat = []
        for _ in range(M_REPS):
            t0 = time.perf_counter()
            r = calls["SearchBatch"](req)
            lat.append(time.perf_counter() - t0)
        batch = (np.asarray(r.ids).reshape(r.count, r.k),
                 np.frombuffer(r.distances_f32, "<f4").reshape(r.count, r.k))
        reqs = [pb.SearchRequest(store="m", vector=q.tolist(), k=K, seq=i)
                for i, q in enumerate(qs[:M_SINGLES])]
        got = {}
        t0 = time.perf_counter()
        for rep in calls["StreamSearch"](iter(reqs)):
            if rep.error:
                raise AssertionError(f"(m) StreamSearch seq {rep.seq}: {rep.error}")
            got[rep.seq] = ([h.id for h in rep.hits], [h.distance for h in rep.hits],
                            time.perf_counter() - t0)
        stream_s = time.perf_counter() - t0
    if sorted(got) != list(range(M_SINGLES)):
        raise AssertionError(f"(m) StreamSearch answered {len(got)} of {M_SINGLES}")
    order = range(M_SINGLES)
    return (batch, lat, [got[i][0] for i in order], [got[i][1] for i in order],
            [got[i][2] for i in order], stream_s)


def line_reader(stream):
    """A queue fed with the lines of a child's stdout by a daemon thread."""
    lines = queue.Queue()

    def pump():
        for ln in iter(stream.readline, ""):
            lines.put(ln)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    return lines


def app_phase(corpus, queries, launches, c_rows, smi) -> None:
    """(m): the port's server through its entry points.  An Application
    with the default configuration (a config file sets only the
    directories, a sync interval of 3600 s and the ports; container mode on,
    so the health endpoint starts) starts on the card; store m (int8
    cosine, dimension 100) is created over REST and filled with the whole
    corpus over gRPC (REST without grpcio); MCP, gRPC and REST answer the
    queries as the in-process batch does; app.stop() syncs a full base and
    frees every port; then `python -m erlvectordb_tpu_torch.cli serve`
    restarts from the same file, answers the same batch, passes `cli check`
    and the stdio bridge, and exits 0 on SIGTERM with every port free.
    Launches: B3-int8 (pos_scan) over steps 1-5."""
    import torch

    from erlvectordb_tpu_torch.app import Application
    from erlvectordb_tpu_torch.infra.config import load_config
    from erlvectordb_tpu_torch.infra.ports import probe_port
    from erlvectordb_tpu_torch.serve.grpc_server import GRPC_AVAILABLE

    card = torch.cuda.get_device_name(0)
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="evdb_app_")
    cfg_path = os.path.join(tmp, "evdb.json")
    with open(cfg_path, "w") as f:
        json.dump({"persistence_dir": os.path.join(tmp, "data"),
                   "backup_dir": os.path.join(tmp, "backups"),
                   "sync_interval": 3600,
                   "services": {n: {"preferred_port": M_BASE + 10 * i,
                                    "port_range": [M_BASE + 10 * i, M_BASE + 10 * i + 9]}
                                for i, n in enumerate(M_SERVICES)}}, f)
    # container mode is read from the environment, not from the file
    env = dict(os.environ, EVDB_CONFIG_FILE=cfg_path, CONTAINER="1")
    qs, nq = queries[:BATCH], queries[:N_RECALL]
    proc = app = err = None
    try:
        # 1. start
        reset_launches()
        cfg = load_config(config_file=cfg_path, env=env)
        app, start_s = timed(lambda: Application(cfg).start())
        ports = {n: app.service_port(n) for n in M_SERVICES}
        if app.db.device != torch.device(DEVICE) or None in (
                ports["mcp_server"], ports["oauth_server"], ports["rest_api"],
                ports["health_check"]) or (GRPC_AVAILABLE and ports["grpc_server"] is None):
            raise AssertionError(f"(m) start: {app.db.device} {ports}")
        devices = health_of(ports["rest_api"], card)
        health_of(ports["health_check"], card)
        emit("app", step="start", nvidia_smi=smi, start_s=start_s, ports=ports,
             grpc=GRPC_AVAILABLE, devices_check=devices,
             container_mode=cfg.container_mode)
        # 2. token, 3. create and fill
        token = get_token(ports["oauth_server"])
        status, body = http(f"http://127.0.0.1:{ports['rest_api']}/api/v1/stores",
                            {"name": "m", "dimension": DIM, "metric": "cosine",
                             "dtype": "int8"}, token)
        if status != 201:
            raise AssertionError(f"(m) create: {status} {body[:200]}")
        fill = fill_store(corpus, ports, token, GRPC_AVAILABLE)
        store = app.db.get_store("m")
        if store.count != len(corpus):
            raise AssertionError(f"(m) filled {store.count} of {len(corpus)} rows")
        emit("app", step="fill", nvidia_smi=smi, **fill,
             device_bytes=store.device_memory_bytes(), capacity=store.capacity)

        # 4. serve: every frontend against the in-process batch
        torch.cuda.synchronize()
        ref = app.db.search_batch("m", qs, k=K)
        ref_ids = np.array([[h[0] for h in row] for row in ref]).astype(str)
        ref_d = np.array([[h[2] for h in row] for row in ref], np.float32)
        cl = Client(ports["mcp_server"], token)
        lat, bit = {}, {}
        mcp_s = []
        for _ in range(M_REPS):
            t0 = time.perf_counter()
            rows, d = batch_answer(cl, "m", qs)
            mcp_s.append(time.perf_counter() - t0)
        lat["mcp_batch_1024"] = ms_stats(mcp_s)
        bit["mcp_batch_1024"] = same_row("MCP batch", rows, d, ref_ids, ref_d, True)
        mcp_ids, mcp_d = rows.astype(str), d
        if GRPC_AVAILABLE:
            batch, g_s, s_ids, s_d, s_lat, stream_s = grpc_serve(ports, token, qs)
            lat["grpc_search_batch_1024"] = ms_stats(g_s)
            bit["grpc_search_batch_1024"] = same_row("gRPC SearchBatch", *batch,
                                                     ref_ids, ref_d, True)
            lat["grpc_stream_256"] = dict(ms_stats(s_lat), total_s=stream_s)
            bit["grpc_stream_256"] = same_row("gRPC StreamSearch", s_ids, s_d,
                                              ref_ids[:M_SINGLES], ref_d[:M_SINGLES],
                                              False)
        r_ids, r_d, r_lat = rest_singles(ports["rest_api"], token, qs[:M_SINGLES])
        lat["rest_single"] = ms_stats(r_lat)
        bit["rest_single"] = same_row("REST search", r_ids, r_d, ref_ids[:M_SINGLES],
                                      ref_d[:M_SINGLES], False)
        m_ids, m_d, m_lat = mcp_singles(cl, qs[:M_SINGLES])
        lat["mcp_single_pipelined"] = ms_stats(m_lat)
        bit["mcp_single"] = same_row("MCP search_vectors", m_ids, m_d,
                                     ref_ids[:M_SINGLES], ref_d[:M_SINGLES], False)
        corpus_dev = torch.from_numpy(corpus).to(DEVICE)
        gt = exact_rows(corpus_dev, nq, "cosine")
        del corpus_dev
        recall = overlap(mcp_ids[:N_RECALL].tolist(), gt)
        if recall < 0.95:
            raise AssertionError(f"(m) recall@10 of the MCP batch: {recall}")
        # 5. inspect
        rest = f"http://127.0.0.1:{ports['rest_api']}"
        _, prom = http(rest + "/metrics")
        status, pstat = http(rest + "/api/v1/ports/status", token=token)
        pstat = json.loads(pstat)
        st = app.status()
        torch.cuda.synchronize()
        launches["m"] = read_launches()
        if not launches["m"].get("pos_scan", {}).get("int8"):
            raise AssertionError(f"(m) never launched pos_scan[int8]: {launches['m']}")
        emit("app", step="serve", nvidia_smi=smi, latency=lat, bit_identical=bit,
             recall_at_10=recall, overlap_at_10_with_c=overlap(
                 mcp_ids[:N_RECALL].tolist(), c_rows.tolist()),
             launches=launches["m"],
             metrics_bytes=len(prom), metrics_lines=prom.count(b"\n"),
             ports_status={n: v["allocated_port"] for n, v in pstat.items()},
             app_status={"running": st["running"], "stores": st["stores"],
                         "services": {n: v["running"] for n, v in st["services"].items()},
                         "health": st["health"]["status"],
                         "oauth": st["oauth"]})

        # 6. graceful stop: a full base on disk, every port free
        cl.sock.close()
        held = {n: p for n, p in ports.items() if p is not None}
        _, stop_s = timed(app.stop)
        sdir = Path(cfg.persistence_dir) / "m"
        bases, deltas = list(sdir.glob("state_*.npz")), list(sdir.glob("delta_*"))
        busy = {n: p for n, p in held.items() if not probe_port(p)}
        if len(bases) != 1 or deltas or busy:
            raise AssertionError(f"(m) stop: bases {bases}, deltas {deltas}, busy {busy}")
        emit("app", step="stop", nvidia_smi=smi, stop_s=stop_s,
             full_base_bytes=dir_bytes(sdir), ports_free=True)
        app = store = None
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        emit("app", step="mem_before_restart", nvidia_smi=smi, free_bytes=free,
             total_bytes=total)

        # 7. restart through `cli serve`
        cli = [sys.executable, "-m", "erlvectordb_tpu_torch.cli"]
        err = open(os.path.join(tmp, "serve.err"), "w")
        t0 = time.perf_counter()
        proc = subprocess.Popen(cli + ["serve"], cwd=repo, env=env, text=True,
                                stdout=subprocess.PIPE, stderr=err)
        lines = line_reader(proc.stdout)
        line = lines.get(timeout=600)
        if line is None:
            raise AssertionError(f"(m) cli serve exited {proc.wait()}: "
                                 f"{Path(err.name).read_text()[-2000:]}")
        status_line = json.loads(line)
        rports = status_line["ports"]
        if status_line["status"] != "running" or any(
                rports[n] != p for n, p in ports.items() if p is not None):
            raise AssertionError(f"(m) cli serve: {status_line} (before: {ports})")
        cl = Client(rports["mcp_server"], get_token(rports["oauth_server"]))
        rows, d = batch_answer(cl, "m", qs)
        recover_s = time.perf_counter() - t0
        cl.sock.close()
        if not (np.array_equal(rows.astype(str), mcp_ids) and np.array_equal(d, mcp_d)):
            raise AssertionError("(m) the batch after the restart differs")
        check = subprocess.run(cli + ["check"], cwd=repo, env=env, text=True,
                               capture_output=True, timeout=300)
        if check.returncode != 0:
            raise AssertionError(f"(m) cli check: {check.stdout} {check.stderr[-2000:]}")
        bridge_in = "".join(json.dumps({"jsonrpc": "2.0", "id": i, "method": m,
                                        "params": p}) + "\n" for i, (m, p) in enumerate((
            ("initialize", {}), ("tools/list", {}),
            ("tools/call", {"name": "search_vectors", "arguments": {
                "store": "m", "vector": qs[0].tolist(), "k": K}})), 1))
        bridge = subprocess.run(cli + ["bridge"], cwd=repo, text=True, input=bridge_in,
                                capture_output=True, timeout=300, env=dict(
                                    env, EVDB_HOST="127.0.0.1",
                                    EVDB_MCP_PORT=str(rports["mcp_server"]),
                                    EVDB_OAUTH_URL=f"http://127.0.0.1:{rports['oauth_server']}/oauth/token"))
        out = [json.loads(ln) for ln in bridge.stdout.splitlines()]
        if bridge.returncode != 0 or [o.get("id") for o in out] != [1, 2, 3] or any(
                "error" in o for o in out):
            raise AssertionError(f"(m) bridge: {bridge.returncode} {out} {bridge.stderr[-2000:]}")
        hits = json.loads(out[2]["result"]["content"][0]["text"])["results"]
        same_row("bridge search_vectors", [[h["id"] for h in hits]],
                 [[h["distance"] for h in hits]], ref_ids[:1], ref_d[:1], False)
        tools = {t["name"] for t in out[1]["result"]["tools"]}
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=cfg.graceful_shutdown_timeout)
        sigterm_s = time.perf_counter() - t0
        busy = {n: p for n, p in rports.items() if p is not None and not probe_port(p)}
        if rc != 0 or busy:
            raise AssertionError(f"(m) SIGTERM: exit {rc}, busy {busy}")
        emit("app", step="restart", nvidia_smi=smi, time_to_recover_s=recover_s,
             same_ids=True, same_distances=True, cli_check_rc=check.returncode,
             bridge_protocol=out[0]["result"]["protocolVersion"],
             bridge_tools=len(tools), sigterm_exit_s=sigterm_s, sigterm_rc=rc,
             ports_free=True)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(60)
        if err is not None:
            err.close()
        if app is not None:
            app.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------- distribution


def n5_centres(seed: int):
    import torch

    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    return torch.randn((N_CENTRES, N5_DIM), generator=g, device=DEVICE)


def n5_chunks(centres, seed: int):
    """Config 5's corpus drawn on the card chunk by chunk (centres[a] +
    noise * N(0, 1)); the same seed gives the same stream."""
    import torch

    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    for i in range(0, N5_ROWS, N5_CHUNK):
        c = min(N5_CHUNK, N5_ROWS - i)
        a = torch.randint(0, N_CENTRES, (c,), generator=g, device=DEVICE)
        yield centres[a] + NOISE * torch.randn((c, N5_DIM), generator=g,
                                               device=DEVICE)


def local_from_chunks(chunks):
    """A local int8 VectorStore filled from a chunk stream with the store's
    own encoder (VectorStore.from_chunks builds int4r stores only)."""
    import torch

    from erlvectordb_tpu_torch.core.store import (
        VectorStore,
        _quantize_int8,
        _row_norms,
    )

    st = VectorStore("c5-local", dim=N5_DIM, metric="cosine", dtype="int8",
                     device=torch.device(DEVICE))
    st._ensure_allocated(N5_DIM)
    st._grow_to(N5_ROWS)
    off = 0
    for x in chunks:
        m = x.shape[0]
        q, sc = _quantize_int8(x)
        st._vectors[off:off + m] = q
        st._scales[off:off + m] = sc
        st._norms[off:off + m] = _row_norms(x)
        st._valid[off:off + m] = True
        off += m
    st._next_row = st._contig = off
    st.version = 1
    return st


def store_batch(store, qs, k=K):
    """(dists, ids) of one batch through submit/complete_raw."""
    d, _rows, ids = store.search_batch_complete_raw(
        store.search_batch_submit(qs, k=k))
    return d, ids


def raw_rows(store, qs, k=K):
    """(dists, rows) of one batch read back without the id mapping."""
    d, r = store._readback(store.search_batch_submit(qs, k=k))
    return d[:, :k], r[:, :k]


def same_batch(name, got, want):
    """Ids equal and distances bit for bit."""
    if not (np.array_equal(got[1], want[1]) and np.array_equal(got[0], want[0])):
        bad = int((got[1] != want[1]).any(axis=1).sum())
        raise AssertionError(f"{name}: {bad} queries differ from the reference "
                             "batch (ids or distance bits)")


def host_ms(fn, reps=5):
    """Median host ms of fn() (each ends in a readback)."""
    lat = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        fn()
        lat.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(lat[1:]))


def dist_kernel_checks(kernels, shard5, q5, shard41):
    """B3-int8 over the first N5_CHECK_ROWS rows of (n5)'s shard at W 768 and
    B4-int8 at T 8 over one 300,000-row shard of the 4 x 1 store, each
    against its plain version on the same inputs (bit for bit), timed by
    CUDA events, beside its bound."""
    import torch

    import erlvectordb_tpu_torch.ops.fused_topk as ft

    def record(key, variant, kern_fn, ref_fn, check, rows, width, batch,
               nbytes, extra):
        kern, ref = kern_fn(), ref_fn()
        torch.cuda.synchronize()
        err, frac = check(f"{key[0]}[{key[1]}]", kern, ref, True)
        ms, plain_ms = cuda_ms(kern_fn), cuda_ms(ref_fn, reps=3)
        b_ms, b_by = bound(variant, 2.0 * batch * rows * width, nbytes)
        rec = dict(max_abs_err=err, mismatch=frac, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, rows=rows,
                   launch_variant=variant,
                   extra=dict(batch=batch, width=width, **extra))
        kernels[key] = rec
        emit("kernel", name=key[0], variant=key[1],
             **{k: v for k, v in rec.items() if k != "extra"}, **rec["extra"])

    # B3 at config 5's shape: the factors the store's search hands it
    codes, scales, norms, valid = (shard5[k] for k in
                                   ("vectors", "scales", "norms", "valid"))
    width = codes.shape[1]
    q8, qmult, rowmult, rowbias, _ = ft._affine_factors(
        "cosine", scales, norms, valid, q5)
    f, g, m, b = ft._pos_window(codes, scales, norms, valid, q8, qmult,
                                rowmult, rowbias, "cosine")
    nt = N5_CHECK_ROWS // ft.TILE_N
    bq = q5.shape[0]
    keys = bq * N5_CHECK_ROWS // ft.POS_SLICE
    record(("pos_scan", "int8_c5_w768"), "int8",
           lambda: ft.pos_scan(codes, q8, qmult, f, g, m, b, nt, False),
           lambda: ft.pos_scan_ref(codes, q8, qmult, f, g, m, b, nt, False),
           check_keys, N5_CHECK_ROWS, width, bq,
           N5_CHECK_ROWS * (width + 8) + bq * (width + 12) + 4 * keys,
           dict(store_rows=N5_ROWS, full_store_bound_ms=bound(
               "int8", 2.0 * bq * N5_ROWS * width, N5_ROWS * (width + 8))[0]))
    # B4 at T 8 over one shard of the 4 x 1 store
    codes, scales, norms, valid = (shard41[k] for k in
                                   ("vectors", "scales", "norms", "valid"))
    width = codes.shape[1]
    qp = torch.zeros((BATCH, width), dtype=torch.float32, device=DEVICE)
    qp[:, :DIM] = q5.new_tensor(shard41["queries"])
    q8, qmult, rowmult, rowbias, _ = ft._affine_factors(
        "cosine", scales, norms, valid, qp)
    nt = ft.n_tiles_for(shard41["rows"], codes.shape[0])
    t = ft.t_per_tile_for(nt, 16)
    rows = nt * ft.TILE_N
    record(("fused_scan", "int8_t8_shard"), "int8",
           lambda: ft.fused_scan(codes, q8, qmult, rowmult, rowbias, nt, t),
           lambda: ft.fused_scan_ref(codes, q8, qmult, rowmult, rowbias, nt, t),
           check_tile, rows, width, BATCH,
           rows * (width + 8) + BATCH * (width + 4) + 8 * BATCH * t * nt,
           dict(t_per_tile=t, shard_rows=shard41["rows"]))


def n5_phase(kernels, launches, smi):
    """(n5): config 5 at full scale through the port's sharded store."""
    import torch

    from erlvectordb_tpu_torch.parallel import ShardedVectorStore, make_mesh

    centres = n5_centres(N5_SEED)
    qs = np.random.default_rng(9).standard_normal((BATCH, N5_DIM)).astype(np.float32)
    mesh = make_mesh()
    torch.cuda.reset_peak_memory_stats()
    store, build_s = timed(lambda: ShardedVectorStore.from_chunks(
        "c5", mesh, n5_chunks(centres, N5_SEED + 1), n=N5_ROWS, dim=N5_DIM,
        metric="cosine", dtype="int8"))
    shard = store._primary(0)
    probe_rows = np.linspace(0, N5_ROWS - 1, N5_PROBES).astype(np.int64)
    pr = torch.from_numpy(probe_rows).to(DEVICE)
    probes = (shard["vectors"][pr].float() * shard["scales"][pr][:, None]
              ).cpu().numpy()

    def drive():
        hits = store.search_batch(probes, k=1)
        bad = [int(r) for r, h in zip(probe_rows, hits) if h[0][0] != str(r)]
        if bad:
            raise AssertionError(f"(n5) dequantized rows not their own top-1: {bad}")
        got = raw_rows(store, qs)
        seq_ms = host_ms(lambda: store_batch(store, qs))

        def pipelined():
            tickets = [store.search_batch_submit(qs, k=K) for _ in range(N5_PIPE)]
            for t in tickets:
                store.search_batch_complete_raw(t)

        pipe_ms = host_ms(pipelined, reps=3) / N5_PIPE
        return got, seq_ms, pipe_ms

    reset_launches()
    (got, seq_ms, pipe_ms), _ = timed(drive)
    launches["n5"] = read_launches()
    if not launches["n5"].get("pos_scan", {}).get("int8"):
        raise AssertionError(f"(n5) never launched pos_scan[int8]: {launches['n5']}")

    # parity with a local store of the same chunk stream
    local, local_s = timed(lambda: local_from_chunks(
        n5_chunks(centres, N5_SEED + 1)))
    for key in ("vectors", "scales", "norms", "valid"):
        a, b = shard[key], getattr(local, "_" + key)
        for r0 in range(0, N5_ROWS, 1 << 20):
            r1 = min(N5_ROWS, r0 + (1 << 20))
            if not torch.equal(a[r0:r1], b[r0:r1]):
                raise AssertionError(f"(n5) {key} differ from the local store's "
                                     f"in rows [{r0}, {r1})")
    same_batch("(n5) sharded vs local store", got, raw_rows(local, qs))
    del local
    torch.cuda.empty_cache()

    # recall@10 of held-out points against exact f32, streamed over the
    # regenerated chunks
    g = torch.Generator(device=DEVICE)
    g.manual_seed(N5_SEED + 2)
    a = torch.randint(0, N_CENTRES, (N_RECALL,), generator=g, device=DEVICE)
    held = centres[a] + NOISE * torch.randn((N_RECALL, N5_DIM), generator=g,
                                            device=DEVICE)
    from erlvectordb_tpu_torch.ops.fused_topk import full_f32_matmul

    hn = held / held.norm(dim=1, keepdim=True)
    best_s = best_i = None
    off = 0
    with full_f32_matmul():
        for x in n5_chunks(centres, N5_SEED + 1):
            s = hn @ (x / x.norm(dim=1, keepdim=True)).T
            i = torch.arange(off, off + x.shape[0], device=DEVICE).expand_as(s)
            if best_s is not None:
                s, i = torch.cat([best_s, s], 1), torch.cat([best_i, i], 1)
            best_s, sel = torch.topk(s, K, dim=1)
            best_i = torch.gather(i, 1, sel)
            off += x.shape[0]
    _, ids = store_batch(store, held.cpu().numpy())
    recall = overlap(ids.tolist(), best_i.cpu().numpy().tolist())
    shard_bytes = {k: v.numel() * v.element_size() for k, v in shard.items()
                   if v is not None}
    emit("distribution", step="n5", nvidia_smi=smi, rows=N5_ROWS, dim=N5_DIM,
         build_s=build_s, build_rows_per_s=N5_ROWS / build_s,
         device_bytes=store.device_memory_bytes(), shard_bytes=shard_bytes,
         capacity=store.capacity, n_tiles=(store._cap // 4096),
         peak_memory_allocated=int(torch.cuda.max_memory_allocated()),
         probes_top1=N5_PROBES, local_parity="codes, scales, norms, batch",
         local_fill_s=local_s, batch_ms_sequential=seq_ms,
         qps_sequential=BATCH / (seq_ms / 1e3), batch_ms_pipelined=pipe_ms,
         qps_pipelined=BATCH / (pipe_ms / 1e3), pipelined_tickets=N5_PIPE,
         recall_at_10_heldout=recall, launches=launches["n5"])
    q5 = torch.from_numpy(qs).to(DEVICE)
    return store, q5


def n3_phase(corpus, queries, launches, c_rows, smi, tmp):
    """(n3) and (n-dur): config 3 distributed on the card: the 1 x 1 store
    of a card Database with persistence on, the 2 x 2 cluster with a
    failover, the 4 x 1 cluster; then a restart and a backup of the 1 x 1
    store.  Returns the 4 x 1 store's first shard for the kernel check."""
    import torch

    from erlvectordb_tpu_torch.api import Database
    from erlvectordb_tpu_torch.core.store import VectorStore
    from erlvectordb_tpu_torch.infra.config import load_config
    from erlvectordb_tpu_torch.parallel import ClusterManager

    dev = torch.device(DEVICE)
    nq = queries[:N_RECALL]
    corpus_dev = torch.from_numpy(corpus).to(DEVICE)
    gt = exact_rows(corpus_dev, nq, "cosine")
    del corpus_dev
    cfg = load_config(overrides={"persistence_dir": os.path.join(tmp, "data"),
                                 "backup_dir": os.path.join(tmp, "backups"),
                                 "sync_interval": 3600}, env={})
    db = Database(cfg, device=dev).start()
    out, ms = {}, {}
    db2 = None
    try:
        c = VectorStore.from_matrix("c", corpus, dtype="int8",
                                    metric="cosine", device=dev)
        # distribute_store re-inserts the rows get_all_vectors returns
        # (dequantized, so the norms are the dequantized rows', as in the
        # JAX package): a local store of the same rows answers alike
        allv = c.get_all_vectors()
        local = VectorStore("c-local", dim=DIM, metric="cosine", dtype="int8",
                            device=dev)
        local.insert_batch([v[0] for v in allv], np.stack([v[1] for v in allv]))
        del allv
        db.registry.adopt(c)
        _, out["distribute_s"] = timed(lambda: db.distribute_store("c"))
        sh11 = db.any_store("c")

        def rows_of(store):
            return np.array([[int(v) for v in row]
                             for row in store_batch(store, nq)[1]])

        reset_launches()
        r11 = rows_of(sh11)
        before = store_batch(sh11, queries[:BATCH])
        torch.cuda.synchronize()
        launches["n3-1x1"] = read_launches()
        ms["1x1"] = host_ms(lambda: store_batch(sh11, queries[:BATCH]))
        same_batch("(n3) 1 x 1 against a local store of the same rows",
                   before, store_batch(local, queries[:BATCH]))
        del local
        out["1x1"] = dict(overlap_with_c=overlap(r11.tolist(), c_rows.tolist()),
                          recall_at_10=overlap(r11.tolist(), gt.tolist()),
                          same_as_local_store_of_the_rows=True)

        cm = ClusterManager(devices=[DEVICE] * N3_DEVICES, replication_factor=2)
        sh22, out["distribute_2x2_s"] = timed(lambda: cm.distribute_store(sh11))
        reset_launches()
        r22 = rows_of(sh22)
        b22 = store_batch(sh22, queries[:BATCH])
        torch.cuda.synchronize()
        launches["n3-2x2"] = read_launches()
        ms["2x2"] = host_ms(lambda: store_batch(sh22, queries[:BATCH]))
        out["2x2"] = dict(overlap_with_1x1=overlap(r22.tolist(), r11.tolist()),
                          recall_at_10=overlap(r22.tolist(), gt.tolist()),
                          replica_groups=sh22.n_replicas, shards=sh22.n_shards)
        failed = cm.fail_device(1)
        if (cm.get_store("c").n_replicas != 1
                or failed["replica_groups"] != 1):
            raise AssertionError(f"(n3) fail_device(1): {failed}")
        same_batch("(n3) after fail_device(1)",
                   store_batch(cm.get_store("c"), queries[:BATCH]), b22)
        ms["2x2_after_failover"] = host_ms(
            lambda: store_batch(cm.get_store("c"), queries[:BATCH]))
        recovered = cm.recover_device(1)
        probes = cm.probe_devices()
        if not all(probes.values()) or recovered["replica_groups"] != 2:
            raise AssertionError(f"(n3) recover_device(1): {recovered} {probes}")
        out["cluster_stats"] = cm.get_cluster_stats()
        out["store_location"] = cm.get_store_location("c")
        del cm, sh22

        cm4 = ClusterManager(devices=[DEVICE] * N3_DEVICES, replication_factor=1)
        sh41, out["distribute_4x1_s"] = timed(lambda: cm4.distribute_store(sh11))
        reset_launches()
        r41 = rows_of(sh41)
        store_batch(sh41, queries[:BATCH])
        torch.cuda.synchronize()
        launches["n3-4x1"] = read_launches()
        ms["4x1"] = host_ms(lambda: store_batch(sh41, queries[:BATCH]))
        out["4x1"] = dict(overlap_with_1x1=overlap(r41.tolist(), r11.tolist()),
                          recall_at_10=overlap(r41.tolist(), gt.tolist()),
                          per_shard_counts=sh41.get_stats()["per_shard_counts"],
                          shard_capacity=sh41._cap)
        shard41 = dict(sh41._primary(0), queries=queries[:BATCH],
                       rows=sh41._next_local[0])
        del cm4, sh41

        # (n-dur): sync, stop, recover; backup, restore under a new name
        reset_launches()
        _, out["sync_s"] = timed(lambda: db.sync("c"))
        out["bytes_on_disk"] = dir_bytes(cfg.persistence_dir)
        db.stop()
        db = None
        db2, out["recover_s"] = timed(lambda: Database(cfg, device=dev).start())
        same_batch("(n-dur) after the restart",
                   store_batch(db2.any_store("c"), queries[:BATCH]), before)
        bpath, out["backup_s"] = timed(lambda: db2.backup_store("c", "n"))
        _, out["restore_s"] = timed(lambda: db2.restore_store(
            bpath.rsplit("/", 1)[-1], new_name="c-restored"))
        same_batch("(n-dur) restored backup",
                   store_batch(db2.any_store("c-restored"), queries[:BATCH]),
                   before)
        out["backup_bytes"] = os.path.getsize(bpath)
        torch.cuda.synchronize()
        launches["n-dur"] = read_launches()
    finally:
        for d in (db, db2):
            if d is not None:
                d.stop()
    emit("distribution", step="n3", nvidia_smi=smi, rows=len(corpus),
         batch_ms=ms, **out,
         launches={k: launches[k] for k in ("n3-1x1", "n3-2x2", "n3-4x1",
                                            "n-dur")})
    for step in ("n3-1x1", "n3-2x2", "n-dur"):
        if not launches[step].get("pos_scan", {}).get("int8"):
            raise AssertionError(f"({step}) never launched pos_scan[int8]: "
                                 f"{launches[step]}")
    if not launches["n3-4x1"].get("fused_scan", {}).get("int8"):
        raise AssertionError(f"(n3-4x1) never launched fused_scan[int8]: "
                             f"{launches['n3-4x1']}")
    # the 1 x 1 store is held bit for bit to a local store of its rows
    # above; its overlap with (c), whose norms are the f32 rows', is
    # recorded (the re-quantized norms move near-ties)
    bars = {"2x2": out["2x2"]["overlap_with_1x1"],
            "4x1": out["4x1"]["overlap_with_1x1"]}
    recalls = {m: out[m]["recall_at_10"] for m in ("1x1", "2x2", "4x1")}
    if min(bars.values()) < 0.99 or min(recalls.values()) < 0.95:
        raise AssertionError(f"(n3) overlap@10 {bars}, recall@10 {recalls}")
    return shard41


def dim_phase(corpus, queries, smi):
    """(n-dim): config 3 as a DimShardedVectorStore over cuda:0 x 4, f32."""
    import torch

    from erlvectordb_tpu_torch.parallel.dim_sharded import (
        DimShardedVectorStore,
        make_dim_mesh,
    )

    nq = queries[:N_RECALL]
    corpus_dev = torch.from_numpy(corpus).to(DEVICE)
    gt = exact_rows(corpus_dev, nq, "cosine")
    del corpus_dev
    st, build_s = timed(lambda: DimShardedVectorStore.from_matrix(
        "dim", corpus, mesh=make_dim_mesh(N3_DEVICES, devices=[DEVICE] * N3_DEVICES),
        metric="cosine"))
    rows = [[int(v) for v in row] for row in store_batch(st, nq)[1]]
    ovl = overlap(rows, gt.tolist())
    batch_ms = host_ms(lambda: store_batch(st, queries[:BATCH]), reps=3)
    emit("distribution", step="n-dim", nvidia_smi=smi, rows=len(corpus),
         model_shards=st.n_model, build_s=build_s, batch_ms=batch_ms,
         overlap_at_10_with_exact_f32=ovl,
         device_bytes=st.device_memory_bytes())
    if ovl < 0.99:
        raise AssertionError(f"(n-dim) overlap@10 with exact f32: {ovl}")


def distribution_phase(corpus, queries, kernels, launches, c_rows, smi):
    """(n): the distribution slice on the card (see the module docstring)."""
    import torch

    store5, q5 = n5_phase(kernels, launches, smi)
    tmp = tempfile.mkdtemp(prefix="evdb_dist_")
    try:
        shard41 = n3_phase(corpus, queries, launches, c_rows, smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dist_kernel_checks(kernels, store5._primary(0), q5, shard41)
    del store5, shard41
    torch.cuda.empty_cache()
    dim_phase(corpus, queries, smi)
    torch.cuda.empty_cache()


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
    ground truth, the median search_index latency, build seconds.  Then
    (path l) every index saved with save_all, loaded into a fresh
    IndexManager with load_indexes, and searched again: each answer must
    equal the one before the save."""
    import torch

    from erlvectordb_tpu_torch.api import Database
    from erlvectordb_tpu_torch.core.index_manager import IndexManager
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
        answers = {}

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
                    hits = db.indexes.search(name, q, k=K)
                    answers.setdefault(itype, []).append(hits)
                    same += ids == [h[0] for h in hits]
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

        def reload(idx_root):
            saved, save_s = timed(lambda: db.indexes.save_all(idx_root))
            fresh = IndexManager(db.registry)
            loaded, load_s = timed(lambda: fresh.load_indexes(idx_root))
            same = {t: float(np.mean([fresh.search(f"k_{t}", q, k=K) == a
                                      for q, a in zip(qs, answers[t])]))
                    for t in K_TYPES}
            return dict(saved=saved, loaded=sorted(loaded), save_s=save_s,
                        load_s=load_s, bytes=dir_bytes(idx_root),
                        same_answers=same)

        idx_root = tempfile.mkdtemp(prefix="evdb_indexes_")
        try:
            reset_launches()
            reloaded = reload(idx_root)
            torch.cuda.synchronize()
            launches["l-k"] = read_launches()
        finally:
            shutil.rmtree(idx_root, ignore_errors=True)
    finally:
        if server is not None:
            server.stop()
        db.stop()
    emit("indexes", rows=J_ROWS, store_build_s=store_s, by_type=res,
         listed=[i["name"] for i in listed["indexes"]], launches=launches["k"],
         reloaded=reloaded, reload_launches=launches["l-k"])
    if (reloaded["loaded"] != sorted(f"k_{t}" for t in K_TYPES)
            or min(reloaded["same_answers"].values()) < 1.0):
        raise AssertionError(f"(l) indexes saved and loaded again answer "
                             f"otherwise: {reloaded}")
    if (res["ep_ivf"]["recall_at_10"] < 0.95
            or res["ep_cellprobe"]["recall_at_10"]
            < res["cellprobe"]["recall_at_10"] - 0.01):
        raise AssertionError(f"(n-ep) recall@10: ep_ivf "
                             f"{res['ep_ivf']['recall_at_10']}, ep_cellprobe "
                             f"{res['ep_cellprobe']['recall_at_10']}, "
                             f"cellprobe {res['cellprobe']['recall_at_10']}")
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
        launches, mp_curve, c_rows = slice_phase(db, corpus, queries, f32_rows)
    finally:
        db.stop()
    del db
    stores["f-rq"] = rq_phase(corpus, queries, stores, mp_curve[RQ_NPROBE],
                              launches)
    durability_phase(corpus, queries, stores, launches)
    compression_phase(corpus)
    stores.clear()
    torch.cuda.empty_cache()
    app_phase(corpus, queries, launches, c_rows, smi)
    torch.cuda.empty_cache()
    distribution_phase(corpus, queries, kernels, launches, c_rows, smi)
    del corpus
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
