"""BENCHMARK.json and the files it names, looked up by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each is a JSON file of its own under ``configs/`` and ``traffic/``.  The
traffic file names its request kind, ``requests/<kind>.py`` (how a request
is encoded, sent and read back, and what its answers are judged as); the
configuration names its store builder, ``stores/<builder>.py``.  A
per-layer metric is a reader of its own, ``metrics/<name>.py``, exposing
``read(ctx) -> float | None``.  Nothing here lists the cells, mixes, kinds,
builders or metrics that exist: adding one is adding its files and its
entries.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[List[str]]
    moves: Optional[str] = None
    layer: Optional[str] = None

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _metrics(entries: List[dict], cell: str) -> List[Metric]:
    out = [Metric(e["name"], e["unit"], e["better"], e["source"],
                  e.get("workloads"), e.get("moves"), e.get("layer"))
           for e in entries]
    return [m for m in out if m.applies(cell)]


def cell(name: str, root: Path = ROOT, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` with its configuration and traffic files read."""
    bench = bench if bench is not None else benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(root / HERE.name / "traffic" / f"{w['traffic']}.json")
    traffic.setdefault("name", w["traffic"])
    return Cell(name, config, traffic, int(w["chips"]),
                _metrics(bench["end_to_end"], name),
                _metrics(bench["per_layer"], name))


_PLUGINS: Dict[Path, ModuleType] = {}


def plugin(folder: str, name: str, root: Path = ROOT) -> ModuleType:
    """The module ``<folder>/<name>.py`` of the benchmark, loaded from its
    file (a name may hold dots), once a process."""
    path = root / HERE.name / folder / f"{name}.py"
    if path not in _PLUGINS:
        mod_name = f"evdb_bench_{folder}_" + "".join(
            ch if ch.isalnum() else "_" for ch in name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None or spec.loader is None or not path.is_file():
            raise ImportError(f"no {folder} module {name!r} at {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _PLUGINS[path] = mod
    return _PLUGINS[path]


def request_kind(name: str, root: Path = ROOT) -> ModuleType:
    """``requests/<name>.py``: a traffic file's request kind.  It gives
    ``TRANSPORT`` (``"grpc"``, a unary call of its ``METHOD``, or
    ``"mcp"``, a ``tools/call`` line), ``ANSWERS`` (the configuration's
    table of limits its answers are held to), ``target(config)``,
    ``queries_per_request(traffic)``, ``keys(traffic, connection, rng,
    n_queries, n)`` (each request's key), ``encode(traffic, target, k,
    queries, key)`` (its bytes) and ``answers(traffic, key, reply,
    n_queries)`` (the reply's [(query, row ids, distances)]); and where it
    needs them ``prepare(config, mcp_call, log)`` (set-up on the server,
    such as an index built; returns what it reports of that, a dict of
    numbers such as the build's phase seconds, or None) and
    ``numbers(answers, queries, data, config, seed)`` (its own comparison,
    in place of ``judge.numbers``)."""
    return plugin("requests", name, root)


def store_builder(name: str, root: Path = ROOT) -> ModuleType:
    """``stores/<name>.py``: a configuration's store builder, with
    ``build(app, config, data, device)`` (the store, in the Application's
    registry) and ``warm(store, config, traffic)``."""
    return plugin("stores", name, root)


def reader(metric: str, root: Path = ROOT
           ) -> Callable[[dict], Optional[float]]:
    """The ``read`` function of ``metrics/<metric>.py``."""
    return plugin("metrics", metric, root).read


def read_metrics(metrics: List[Metric], ctx: dict,
                 root: Path = ROOT) -> Dict[str, dict]:
    """Each metric's reading; a reader that finds nothing returns None and
    the metric is left out."""
    out: Dict[str, dict] = {}
    for m in metrics:
        value = reader(m.name, root)(ctx)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out
