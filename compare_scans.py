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
  * (c32) float32 cosine: 1024                           -> B3 pos_scan f32
  * (e)   int4 cosine: 1024                              -> B3 pos_scan int4
  * (f)   int4r cosine: 1, 16 and 1024                   -> B5 pos_residual_scan
  * (g)   int4 cosine, the first 100k rows: 1024         -> B4 fused_scan int4
  * (h)   int4r cosine, the first 100k rows: 1024        -> B6 cell_scan

    python3 compare_scans.py ROOT [ROOT ...]

Each ROOT is a directory holding an ``erlvectordb_tpu_torch`` package (a
checkout, or ``git archive`` of one); they run in the order given, so
``A B B A`` shows the drift between runs.  Each prints one JSON line: per
path, the median host milliseconds of submit -> complete (the readback
waits for the device) over 10 calls after a warm-up, torch.profiler's
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
            ((cs.BATCH, cs.K),)),
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
        store = VectorStore.from_matrix(name, corpus[:rows], device=dev, **kw)
        for bq, k in paths:
            call = lambda: store.search_batch_complete_raw(
                store.search_batch_submit(queries[:bq], k=k))
            call()
            lat = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                call()
                lat.append(time.perf_counter() - t0)
            tag = f"{name}_bq{bq}" + ("" if k == cs.K else f"_k{k}")
            out[f"{tag}_ms_median"] = 1e3 * float(np.median(lat))
            out[f"{tag}_profile"] = cs.profile_calls(call, reps=REPS)
        if name == "a":
            ms = mcp_batch_ms(store, queries)
            out["a_mcp_b64_batch_ms_median"] = float(np.median(ms))
            out["a_mcp_b64_batch_ms_all"] = ms
        del store
        torch.cuda.empty_cache()
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
