"""Where a served request's time goes, stage by stage, from the port's own
spans (``erlvectordb_tpu_torch/utils/metrics.py``) in traced runs of a cell.

    python3 -m evdb_bench.tools.stages --out build/stages --seconds 20 \
        --plan glove100.mcp_single:101,102,103 cohere1m.mcp_index:101,102,103
    python3 -m evdb_bench.tools.stages --read build/stages

Each run of the plan is a process of its own: a traced run of the cell
(``evdb_bench/run.py --trace 1``) that writes its result line, then one line
``stages {...}``, to ``<n>_<cell>_<seed>.out`` (its log to ``.err``).  That
line holds, over the requests begun in the window, each stage's median
and mean milliseconds per request (a request's own spans and its device
batch's, summed by name; ``self`` is the request less the union of its
batcher, store and index spans, ``uncovered`` the request less the union
of all of them); per store search, ``store.submit`` +
``batcher.completion_wait`` + ``store.readback`` + ``store.map`` beside the
harness's ``store`` span; the mean ``index.search`` beside the harness's
``index`` span; and the device's idle share beside the part of it in which
a request was open.  ``--read`` prints, for each cell, the median over its
runs of each stage's median, and the stages' means in its fastest and
slowest run (by mean request time) with their difference: the stage with
the largest difference carries the run-to-run spread.
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
from typing import Optional

ROOT = Path(__file__).resolve().parents[2]
RUN = re.compile(r"^(\d+)_(.+)_(\d+)\.out$")
STORE_STAGES = ("store.submit", "batcher.completion_wait", "store.readback",
                "store.map")
INNER = ("batcher.", "store.", "index.")


def _ms_of(s) -> float:
    return (s[4] - s[3]) / 1e6


def _uncovered_ms(req, spans) -> float:
    from evdb_bench.devtrace import union

    cover = union([(s[3], s[4]) for s in spans], req[3], req[4])
    return (req[4] - req[3] - sum(e - s for s, e in cover)) / 1e6


def _summary(per_stage: dict) -> tuple:
    med = {k: statistics.median(v) for k, v in per_stage.items() if v}
    mean = {k: statistics.fmean(v) for k, v in per_stage.items() if v}
    return med, mean


def decompose(ctx: dict) -> Optional[dict]:
    """The stage decomposition of a traced run's window (see the module's
    docstring); None where the run has no program spans to read."""
    from evdb_bench import progspans, readers

    spans = progspans.window(ctx)
    if spans is None:
        return None
    reqs = [r for name in progspans.REQUESTS
            for r in progspans._started_in(spans, name, ctx)]
    by_rid = progspans._by_rid(s for s in spans
                               if s[0] not in progspans.REQUESTS)
    per_stage = defaultdict(list)
    for r in reqs:
        related = list(progspans._related(by_rid, r))
        sums = defaultdict(float)
        for s in related:
            sums[s[0]] += _ms_of(s)
        for name, v in sums.items():
            per_stage[name].append(v)
        per_stage["request"].append(_ms_of(r))
        per_stage["self"].append(_uncovered_ms(
            r, [s for s in related if s[0].startswith(INNER)]))
        per_stage["uncovered"].append(_uncovered_ms(r, related))
    med, mean = _summary(per_stage)
    store = [sum(_ms_of(s) for s in by_rid[sub[1]] if s[0] in STORE_STAGES)
             for sub in progspans._started_in(spans, "store.submit", ctx)]
    index = [_ms_of(s)
             for s in progspans._started_in(spans, "index.search", ctx)]
    return {"requests": len(reqs),
            "stage_median_ms": med, "stage_mean_ms": mean,
            "store_stages_ms": statistics.fmean(store) if store else None,
            "store_ms_harness": readers.span_ms(ctx, "store"),
            "index_search_ms": statistics.fmean(index) if index else None,
            "index_search_ms_harness": readers.span_ms(ctx, "index"),
            "device_idle_pct": readers.idle_pct(ctx),
            "host_bound_idle_pct": progspans.host_bound_idle_pct(ctx),
            "trace_dropped": ctx["counters"].get("trace.dropped", 0)}


def run_one(cell: str, seed: int, seconds: int) -> int:
    """One traced run of ``cell``: its result line, then its stages."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from evdb_bench import harness
    from evdb_bench import run as runner

    seen = []
    trace_context = harness.trace_context

    def keep(*a, **kw):
        ctx = trace_context(*a, **kw)
        seen.append(ctx)
        return ctx

    harness.trace_context = keep
    rc = runner.main(["--workload", cell, "--seed", str(seed), "--seconds",
                      str(seconds), "--trace", "1"])
    if rc == 0 and seen:
        print("stages " + json.dumps(decompose(seen[0])), flush=True)
    return rc


def run_plan(plan, seconds: int, out: Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    n = len(list(out.glob("*.out")))
    for entry in plan:
        cell, seeds = entry.split(":")
        for seed in seeds.split(","):
            stem = f"{n:02d}_{cell}_{seed}"
            t = time.perf_counter()
            with open(out / f"{stem}.out", "w") as fo, \
                    open(out / f"{stem}.err", "w") as fe:
                rc = subprocess.call(
                    [sys.executable, "-m", "evdb_bench.tools.stages",
                     "--workload", cell, "--seed", seed, "--seconds",
                     str(seconds)], cwd=ROOT, stdout=fo, stderr=fe)
            print(f"{stem} rc {rc} {time.perf_counter() - t:.1f}s", flush=True)
            n += 1


def read(out: Path) -> None:
    runs = defaultdict(list)
    for f in sorted(out.glob("*.out")):
        m = RUN.match(f.name)
        lines = f.read_text().strip().splitlines()
        st = [json.loads(x[len("stages "):]) for x in lines
              if x.startswith("stages ")]
        if m and st and st[0]:
            runs[m.group(2)].append((m.group(3), st[0]))
    for cell, rs in runs.items():
        names = sorted({k for _s, r in rs for k in r["stage_median_ms"]})
        print(f"{cell}: {len(rs)} runs, requests "
              f"{[r['requests'] for _s, r in rs]}")
        print("  median ms a request: " + json.dumps({
            k: statistics.median(r["stage_median_ms"][k] for _s, r in rs
                                 if k in r["stage_median_ms"])
            for k in names}))
        for key in ("store_stages_ms", "store_ms_harness", "index_search_ms",
                    "index_search_ms_harness", "device_idle_pct",
                    "host_bound_idle_pct", "trace_dropped"):
            print(f"  {key}: {[r.get(key) for _s, r in rs]}")
        order = sorted(rs, key=lambda sr: sr[1]["stage_mean_ms"]["request"])
        fast, slow = order[0][1]["stage_mean_ms"], order[-1][1]["stage_mean_ms"]
        diff = {k: slow.get(k, 0.0) - fast.get(k, 0.0) for k in names}
        print(f"  fastest run (seed {order[0][0]}) mean ms: "
              + json.dumps(fast))
        print(f"  slowest run (seed {order[-1][0]}) mean ms: "
              + json.dumps(slow))
        print("  slowest less fastest: " + json.dumps(dict(sorted(
            diff.items(), key=lambda kv: -abs(kv[1])))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=int, default=20)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--plan", nargs="*", default=[])
    ap.add_argument("--read", type=Path)
    args = ap.parse_args(argv)
    if args.workload:
        return run_one(args.workload, args.seed, args.seconds)
    if args.plan:
        run_plan(args.plan, args.seconds, args.out)
    if args.read:
        read(args.read)
    return 0


if __name__ == "__main__":
    sys.exit(main())
