"""Compare the full-scan searches of checkouts of the PyTorch port on one card.

For each checkout, in a process of its own, this builds chip_smoke.py's
stores (f) (int4r, cosine) and (c32) (float32, cosine) from its corpus of
1,200,000 rows x 100 dims and times, through the store API:

  * (f)   batches of 1, 16 and 1024 queries, which run the B5 scan
          (pos_residual_scan) over every row;
  * (c32) batches of 1024 queries, which run B3 on f32 codes (pos_scan).

    python3 compare_scans.py ROOT [ROOT ...]

Each ROOT is a directory holding an ``erlvectordb_tpu_torch`` package (a
checkout, or ``git archive`` of one); they run in the order given, so
``A B B A`` shows the drift between runs.  Each prints one JSON line: the
median host milliseconds of submit -> complete (the readback waits for the
device) over 10 calls after a warm-up, and torch.profiler's device
milliseconds per call of the kernels that took the most device time.  The
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
SMALL_BATCHES = (1, 16)


def measure(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import erlvectordb_tpu_torch
    from erlvectordb_tpu_torch.core.store import VectorStore

    dev = torch.device("cuda")
    corpus = cs.make_corpus(cs.SEED, cs.N_ROWS)
    queries = cs.make_corpus(cs.SEED + 1, cs.BATCH)
    out = {"root": root, "package": os.path.dirname(erlvectordb_tpu_torch.__file__)}
    for name, dtype, batches in (("f", "int4r", SMALL_BATCHES + (cs.BATCH,)),
                                 ("c32", "float32", (cs.BATCH,))):
        store = VectorStore.from_matrix(name, corpus, device=dev, dtype=dtype,
                                        metric="cosine")
        for bq in batches:
            call = lambda: store.search_batch_complete_raw(
                store.search_batch_submit(queries[:bq], k=cs.K))
            call()
            lat = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                call()
                lat.append(time.perf_counter() - t0)
            out[f"{name}_bq{bq}_ms_median"] = 1e3 * float(np.median(lat))
            out[f"{name}_bq{bq}_profile"] = cs.profile_calls(call, reps=REPS)
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
