"""Compare the full-scan searches of checkouts of the PyTorch port on one card.

For each checkout, in a process of its own, this builds chip_smoke.py's
stores from its corpus (1,200,000 rows x 100 dims, numpy, seed 0) one at a
time and times batches through the store API, each path reaching the scan
chip_smoke.py names for it:

  * (a)   int8 cosine, intkey plane: 1024 queries        -> B1 intkey_scan
          and the same batch over MCP (search_vectors_batch, b64)
  * (b)   int8 euclidean, intkey plane: 1024             -> B2 l2key_scan
  * (c)   int8 cosine: 1024 at k=10 (B3 pos_scan int8) and at k=32 (B4
          fused_scan int8, past the pos path's k)
  * (c32) float32 cosine: 1024 at k=10 (B3 pos_scan f32) and at k=32 (B4
          fused_scan f32, past the pos path's k)
  * (d)   float32 cosine, 20,000 rows of their own (seed 2): 1, 16 and
          1024                                           -> B4 fused_scan f32
  * (e)   int4 cosine: 1024                              -> B3 pos_scan int4
  * (f)   int4r cosine: 1, 16 and 1024                   -> B5 pos_residual_scan
  * (g)   int4 cosine, the first 100k rows: 1024         -> B4 fused_scan int4
  * (h)   int4r cosine, the first 100k rows: 1024        -> B6 cell_scan
  * (j)   config 4 as chip_smoke.py builds it (1M x 128, OPQ 8 x 8 bits,
          int8 rerank rows): the three ADC searches on 512 queries
          -> B8 adc_pos_scan, B9 adc_exact_scan, B10 adc_pallas_scan int8
  * (f-mp) store (f) searched by nprobe: 1024 queries at nprobe 64 and 512,
    16 and 64 at 64 -> B7 gather_dots int4 and its glue (f_mp_*); the same
    for the rq_m = 9 store (f-rq) of the same corpus (f_rq_*)
  * B7 int4 alone on store (f)'s cells and routed probe lists: 1024 queries
    at nprobe 64 and 512, 1, 16, 64 and 256 queries at nprobe 64 (b7_int4_*)
  * B7 int8 alone at (i)'s shapes: 256 queries x 64 probes of a 20,224-cell
    table of 512 x 768 random int8 codes, probes drawn at random (seeded);
    also a hash of its output, equal between checkouts that share the kernel

    python3 compare_scans.py ROOT [ROOT ...]

Each ROOT is a directory holding an ``erlvectordb_tpu_torch`` package (a
checkout, or ``git archive`` of one); they run in the order given, so
``A B B A`` shows the drift between runs.  Each prints one JSON line: per
path, the median host milliseconds of submit -> complete (the readback
waits for the device; (j): the search function, synchronised) over 10
calls after a warm-up, torch.profiler's
device milliseconds per call, the device's busy share and the kernels that
took the most device time; for (a), also the median of 5 MCP batches.  The
card's name and power limit (nvidia-smi) come first.  Exits non-zero if a
checkout fails or no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

import chip_smoke as cs

REPS = 10
MCP_REPS = 5
# store -> (rows, store options, (batch, k) of each timed path)
STORES = {
    "a": (cs.N_ROWS, dict(dtype="int8", metric="cosine", intkey=True),
          ((cs.BATCH, cs.K),)),
    "b": (cs.N_ROWS, dict(dtype="int8", metric="euclidean", intkey=True),
          ((cs.BATCH, cs.K),)),
    "c": (cs.N_ROWS, dict(dtype="int8", metric="cosine"),
          ((cs.BATCH, cs.K), (cs.BATCH, 32))),
    "c32": (cs.N_ROWS, dict(dtype="float32", metric="cosine"),
            ((cs.BATCH, cs.K), (cs.BATCH, 32))),
    "d": (cs.F32_ROWS, dict(dtype="float32", metric="cosine"),
          ((1, cs.K), (16, cs.K), (cs.BATCH, cs.K))),
    "e": (cs.N_ROWS, dict(dtype="int4", metric="cosine"), ((cs.BATCH, cs.K),)),
    "f": (cs.N_ROWS, dict(dtype="int4r", metric="cosine"),
          ((1, cs.K), (16, cs.K), (cs.BATCH, cs.K))),
    "g": (cs.SMALL_ROWS, dict(dtype="int4", metric="cosine"),
          ((cs.BATCH, cs.K),)),
    "h": (cs.SMALL_ROWS, dict(dtype="int4r", metric="cosine"),
          ((cs.BATCH, cs.K),)),
}


def mcp_batch_ms(store, queries) -> list:
    """Host ms of MCP_REPS 1024-query search_vectors_batch calls (b64) on
    ``store`` behind the port's MCP server, after a warm-up."""
    from erlvectordb_tpu_torch.api import Database
    from erlvectordb_tpu_torch.infra.config import load_config
    from erlvectordb_tpu_torch.serve.mcp_server import MCPServer

    db = Database(load_config(overrides={"persistence_enabled": False}, env={}),
                  device=store.device).start()
    db.registry.adopt(store)
    server = MCPServer(db, host="127.0.0.1", port=0).start()
    try:
        token = db.oauth.grant_client_credentials(
            "erlvectordb_client", "erlvectordb_secret")["access_token"]
        cl = cs.Client(server._sock.getsockname()[1], token)
        cs.batch_rows(cl, store.name, queries)
        out = []
        for _ in range(MCP_REPS):
            t0 = time.perf_counter()
            cs.batch_rows(cl, store.name, queries)
            out.append(1e3 * (time.perf_counter() - t0))
        cl.sock.close()
        return out
    finally:
        server.stop()
        db.stop()


def timed_calls(call, out: dict, tag: str) -> None:
    """Host-clock median of REPS synchronised calls after a warm-up, and
    their profile, into ``out`` under ``tag``."""
    import torch

    def sync_call():
        call()
        torch.cuda.synchronize()

    sync_call()
    lat = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        sync_call()
        lat.append(time.perf_counter() - t0)
    out[f"{tag}_ms_median"] = 1e3 * float(np.median(lat))
    out[f"{tag}_profile"] = cs.profile_calls(sync_call, reps=REPS)


def multiprobe(store, queries, out, tag) -> None:
    """Multiprobe batches of an int4r store at the store API (B7 int4 and
    its glue): 1024 queries at nprobe 64 and 512, 16 and 64 at 64."""
    for bq, nprobe in ((cs.BATCH, cs.B7_NPROBE), (cs.BATCH, cs.RQ_NPROBE),
                       (16, cs.B7_NPROBE), (64, cs.B7_NPROBE)):
        timed_calls(lambda: store.search_batch_complete_raw(
            store.search_batch_submit(queries[:bq], k=cs.K, nprobe=nprobe)),
            out, f"{tag}_bq{bq}_np{nprobe}")


def b7_int4(store, queries, out) -> None:
    """B7 int4 on the int4r store's cells at (f-mp)'s shapes."""
    import torch

    import erlvectordb_tpu_torch.ops.cell_probe as cp

    n_cells, cap = store._centroids.shape[0], store._cell_cap
    codes3 = store._vectors.reshape(n_cells, cap, -1)
    qp = torch.zeros((cs.BATCH, codes3.shape[2] * 2), device=codes3.device)
    qp[:, :cs.DIM] = torch.from_numpy(queries[:cs.BATCH]).to(codes3.device)
    active = store._valid.reshape(n_cells, cap).any(dim=1)
    for bq, nprobe in ((cs.BATCH, cs.B7_NPROBE), (cs.BATCH, cs.RQ_NPROBE),
                       (1, cs.B7_NPROBE), (16, cs.B7_NPROBE),
                       (64, cs.B7_NPROBE), (256, cs.B7_NPROBE)):
        probe = cp.route_probes(store._centroids, qp[:bq], active,
                                metric="cosine", nprobe=nprobe
                                ).to(torch.int32).contiguous()
        qbf = qp[:bq].to(torch.bfloat16).float()
        timed_calls(lambda: cp.gather_dots(codes3, probe, qbf), out,
                    f"b7_int4_bq{bq}_np{nprobe}")


def b7_int8(out) -> None:
    """B7 int8 at the cell-probe index's shapes, on seeded random codes."""
    import hashlib

    import torch

    import erlvectordb_tpu_torch.ops.cell_probe as cp

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 5)
    codes3 = torch.randint(-127, 128, (20_224, 512, cs.I_DIM), generator=gen,
                           device="cuda", dtype=torch.int8)
    bq = cs.B7_BATCH["int8"]
    probe = torch.randint(0, codes3.shape[0], (bq, cs.B7_NPROBE), generator=gen,
                          device="cuda", dtype=torch.int32)
    q = torch.randn((bq, cs.I_DIM), generator=gen, device="cuda"
                    ).to(torch.bfloat16).float()
    res = cp.gather_dots(codes3, probe, q)
    out["b7_int8_output_sha256"] = hashlib.sha256(
        res.cpu().numpy().tobytes()).hexdigest()
    timed_calls(lambda: cp.gather_dots(codes3, probe, q), out,
                f"b7_int8_bq{bq}_np{cs.B7_NPROBE}")
    del codes3
    torch.cuda.empty_cache()


def measure(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import erlvectordb_tpu_torch
    from erlvectordb_tpu_torch.core.store import VectorStore

    dev = torch.device("cuda")
    corpus = cs.make_corpus(cs.SEED, cs.N_ROWS)
    queries = cs.make_corpus(cs.SEED + 1, cs.BATCH)
    out = {"root": root, "package": os.path.dirname(erlvectordb_tpu_torch.__file__)}
    for name, (rows, kw, paths) in STORES.items():
        data = (cs.make_corpus(cs.SEED + 2, rows) if name == "d"
                else corpus[:rows])
        store = VectorStore.from_matrix(name, data, device=dev, **kw)
        for bq, k in paths:
            timed_calls(lambda: store.search_batch_complete_raw(
                store.search_batch_submit(queries[:bq], k=k)), out,
                f"{name}_bq{bq}" + ("" if k == cs.K else f"_k{k}"))
        if name == "f":
            b7_int4(store, queries, out)
            multiprobe(store, queries, out, "f_mp")
        if name == "a":
            ms = mcp_batch_ms(store, queries)
            out["a_mcp_b64_batch_ms_median"] = float(np.median(ms))
            out["a_mcp_b64_batch_ms_all"] = ms
        del store
        torch.cuda.empty_cache()
    rq = VectorStore.from_matrix("f-rq", corpus, device=dev, dtype="int4r",
                                 rq_m=cs.RQ_M)
    multiprobe(rq, queries, out, "f_rq")
    del rq, corpus
    torch.cuda.empty_cache()
    b7_int8(out)
    data, _ = cs.adc_corpus(cs.SEED + 4)
    *_, tq, searches, _ = cs.adc_build(torch.from_numpy(data).to(dev))
    for name, fn in searches.items():
        timed_calls(lambda: fn(tq[:cs.J_BATCH]), out, f"j_{name}_bq{cs.J_BATCH}")
    return out


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("compare_scans: no CUDA device", file=sys.stderr)
        return 1
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(measure(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    rc = 0
    for root in argv:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], text=True, capture_output=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            rc = proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
