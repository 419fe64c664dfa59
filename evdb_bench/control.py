"""The control of the comparison that decides ``correct``: the reference put
in the program's place one precision below the configuration's (int4 where
the store is int8), judged as a run judges the program.  It has to fail.

    python3 -m evdb_bench.control --config cohere1m_int8 --kind index --seeds 11 12 13

prints one JSON line a seed with the compared numbers.  The runs of the
benchmark never run it; ``tests/test_evdb_bench_control.py`` does.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from evdb_bench import corpus, judge
from evdb_bench.reference.exact import Exact
from evdb_bench.spec import ROOT, benchmark, load_json

CONTROL_BITS = 4


def control_numbers(config: dict, kind: str, seed: int, device) -> dict:
    """The compared numbers of the control's answers to every test query."""
    queries = corpus.draw(config, seed, device, corpus.QUERIES)
    data = corpus.draw(config, seed, device, corpus.CORPUS)
    dist, ids = Exact(data, CONTROL_BITS).topk(queries, config["k"])
    ids, dist = ids.cpu().numpy(), dist.cpu().numpy()
    answers = [(i, ids[i], dist[i]) for i in range(ids.shape[0])]
    values = judge.numbers(kind, answers, queries, data, config["k"],
                           bits=int(config["store"].get("bits", 8)))
    values["missing"] = 0.0
    return values


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--kind", choices=("store", "index"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: the control is read on the CUDA card", file=sys.stderr)
        return 2
    entry = {c["name"]: c for c in benchmark()["configs"]}[args.config]
    config = load_json(ROOT / entry["file"])
    for seed in args.seeds:
        values = control_numbers(config, args.kind, seed, "cuda")
        ok, _rows = judge.verdict(values, config["correct"][args.kind])
        print(json.dumps({"config": args.config, "kind": args.kind,
                          "seed": seed, "passes_limits": ok, **values}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
