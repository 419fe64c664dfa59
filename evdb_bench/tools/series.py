"""Run cells of BENCHMARK.json several times, each run a process of its own,
and read the spreads a bound is set from.

    python3 -m evdb_bench.tools.series --out chiprun_out/series --seconds 20 \
        --plan glove100.grpc_batch:101,102,103:0 glove100.grpc_batch:104:1
    python3 -m evdb_bench.tools.series --read chiprun_out/series

Each plan entry is ``cell:seed,seed,...:trace``; the runs go in the order
given, and each writes ``<n>_<cell>_<seed>_<trace>.out`` and ``.err`` to the
output directory, with one summary line a run on standard output.
``--read`` takes those files back: for each cell and end-to-end metric, the
two sets (the first and second untraced runs of each seed run twice; a
seed run once, such as a checkout's first run, which builds, stands in
neither), their medians, their
spreads (the quartile distance of ``statistics.quantiles(n=4)`` over the
median), each set's spread with its run farthest from the median left out,
and the widest spread of all the runs.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
RUN = re.compile(r"^(\d+)_(.+)_(\d+)_([01])\.out$")


def run_plan(plan, seconds: int, out: Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    n = len(list(out.glob("*.out")))
    for entry in plan:
        cell, seeds, trace = entry.split(":")
        for seed in seeds.split(","):
            stem = f"{n:02d}_{cell}_{seed}_{trace}"
            t = time.perf_counter()
            with open(out / f"{stem}.out", "w") as fo, \
                    open(out / f"{stem}.err", "w") as fe:
                rc = subprocess.call(
                    [sys.executable, "evdb_bench/run.py", "--workload", cell,
                     "--seed", seed, "--seconds", str(seconds), "--trace",
                     trace], cwd=ROOT, stdout=fo, stderr=fe)
            lines = (out / f"{stem}.out").read_text().strip().splitlines()
            r = json.loads(lines[-1]) if lines else {}
            summary = {
                "correct": r.get("correct"), "attempted": r.get("attempted"),
                "failed": r.get("failed"),
                "metrics": {k: v["value"] for k, v in
                            r.get("metrics", {}).items()},
                "peak": r.get("device", {}).get("memory_peak_bytes"),
                "busy_s": r.get("device", {}).get("busy_s"),
                "checks": {k: v["value"] for k, v in
                           r.get("checks", {}).items()}}
            print(f"{stem} rc {rc} {time.perf_counter() - t:.1f}s "
                  f"{json.dumps(summary)}", flush=True)
            n += 1


def spread(v) -> float:
    q = statistics.quantiles(v, n=4)
    return (q[2] - q[0]) / statistics.median(v)


def trimmed(v) -> list:
    med = statistics.median(v)
    far = max(range(len(v)), key=lambda j: abs(v[j] - med))
    return [x for j, x in enumerate(v) if j != far]


def read(out: Path) -> None:
    runs = defaultdict(list)
    for f in sorted(out.glob("*.out")):
        m = RUN.match(f.name)
        lines = f.read_text().strip().splitlines()
        if not m or not lines or m.group(4) != "0":
            continue
        runs[m.group(2)].append((int(m.group(1)), m.group(3),
                                 json.loads(lines[-1])))
    for cell, rs in runs.items():
        seen = defaultdict(int)
        twice = {s for _i, s, _r in rs
                 if sum(1 for _j, t, _q in rs if t == s) >= 2}
        sets = ([], [])
        for _i, seed, r in sorted(rs):
            if seed in twice and seen[seed] < 2:
                sets[seen[seed]].append(r)
                seen[seed] += 1
        sets = [s for s in sets if len(s) >= 4]
        print(f"{cell}: runs {len(rs)}, correct "
              f"{sum(bool(r['correct']) for _i, _s, r in rs)}, sets "
              f"{[len(s) for s in sets]}")
        for m in rs[0][2]["metrics"]:
            vals = [[r["metrics"][m]["value"] for r in s] for s in sets]
            if not vals:
                continue
            every = [v for s in vals for v in s]
            print(f"  {m}: medians {[statistics.median(v) for v in vals]} "
                  f"spreads {[spread(v) for v in vals]} trimmed "
                  f"{[spread(trimmed(v)) for v in vals]} all {spread(every)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path)
    ap.add_argument("--seconds", type=int, default=20)
    ap.add_argument("--plan", nargs="*", default=[])
    ap.add_argument("--read", type=Path)
    args = ap.parse_args(argv)
    if args.plan:
        run_plan(args.plan, args.seconds, args.out)
    if args.read:
        read(args.read)
    return 0


if __name__ == "__main__":
    sys.exit(main())
