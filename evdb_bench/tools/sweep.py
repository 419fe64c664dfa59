"""Find an open-loop cell's knee: serve the cell once, then offer its
traffic at each of several rates for a window of its own.

    python3 -m evdb_bench.tools.sweep --workload cohere1m.mcp_index --seed 5 --seconds 10 --rates 100 200 300

One JSON line a rate: offered and sent rates, queries answered a second
inside the window, latency p50 / p99 from the due time (and p99 of each
half of the window: a backlog that grows shows as a later half far above
the first), the send lateness and the failures.  The knee is the highest
rate whose answered rate keeps up with the offered one and whose halves
agree; a cell is set to about four fifths of it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, default=10)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    from evdb_bench.run import ROOT, cache_env

    cache_env(ROOT)
    import torch

    from evdb_bench import harness, spec

    if not torch.cuda.is_available():
        print("error: the sweep runs on the CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    srv = harness.serve(cell, args.seed, "cuda", False)
    try:
        for rate in args.rates:
            traffic = {**cell.traffic, "rate_per_s": rate}
            win = harness.measure(srv, traffic, args.seconds, False,
                                  time.perf_counter())
            recs = win.recs
            per_req = srv.kind.queries_per_request(traffic)
            qps, p50, p99, late = harness.end_to_end(recs, args.seconds,
                                                     per_req)
            due, recv, status = recs[:, 2], recs[:, 4], recs[:, 5]
            lat = np.where(status > 0, recv - due, np.inf)
            half = due < args.seconds / 2
            print(json.dumps({
                "workload": args.workload, "offered": rate,
                "sent_per_s": len(recs) / args.seconds,
                "answered_qps": qps, "p50_ms": p50, "p99_ms": p99,
                "p99_first_half_ms": float(np.percentile(lat[half], 99)) * 1e3,
                "p99_second_half_ms": float(np.percentile(lat[~half], 99))
                * 1e3,
                "late_p99_ms": float(np.percentile(late, 99)),
                "late_max_ms": float(late.max()),
                "failed": int(np.sum(status <= 0)),
                "batch_fill": (win.hist.get("batcher.batch_size", (0, 0))[1]
                               / max(1, win.hist.get("batcher.batch_size",
                                                     (0, 0))[0]))}),
                flush=True)
    finally:
        srv.app.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
