"""BENCHMARK.json, its files found by name, and the contract's limits."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from evdb_bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_every_cell_resolves(bench):
    for w in bench["workloads"]:
        c = spec.cell(w["name"], bench=bench)
        assert c.config["name"] == w["config"]
        kind = spec.request_kind(c.traffic["request"])
        assert kind.TRANSPORT in ("grpc", "mcp")
        assert kind.ANSWERS in c.config["correct"]
        for fn in ("target", "keys", "encode", "answers",
                   "queries_per_request"):
            assert callable(getattr(kind, fn))
        builder = spec.store_builder(c.config["store"]["builder"])
        assert callable(builder.build) and callable(builder.warm)
        names = {m.name for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert callable(spec.reader(m.name))


def test_names_units_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for entry in bench["workloads"] + bench["configs"]:
        assert NAME.match(entry["name"])
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert len(json.dumps(bench)) < 64 * 1024


def test_configurations_keep_their_source_shapes(bench):
    want = {"glove100_int8": (1183514, 100, 10000),
            "cohere1m_int8": (1000000, 768, 1000),
            "cohere10m_int8": (10000000, 768, 1000)}
    for c in bench["configs"]:
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert (cfg["rows"], cfg["dim"], cfg["test_queries"]) == want[c["name"]]
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["assumed"]


KINDS = sorted(p.stem for p in (spec.HERE / "requests").glob("*.py"))

LOAD_KIND = """
import sys
from evdb_bench import client, spec
spec.request_kind(sys.argv[1])
print(sorted({m.split(".")[0] for m in sys.modules}
             & {"torch", "erlvectordb_tpu_torch", "jax"}))
"""


@pytest.mark.parametrize("name", KINDS)
def test_a_client_loads_its_request_kind_without_torch(name):
    """A client process loads its request kind to encode; in a fresh
    interpreter that leaves torch, the port and JAX unloaded, so a
    client's start costs no import of them on its core."""
    env = {**os.environ, "PYTHONPATH": str(spec.ROOT)}
    p = subprocess.run([sys.executable, "-c", LOAD_KIND, name],
                       cwd=spec.ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip() == "[]"


@pytest.mark.parametrize("name", KINDS)
def test_index_build_s_is_the_prepare_phase_of_kinds_that_prepare(name):
    """``index_build_s`` is the ``prepare`` phase, read only where the
    request kind prepares its target; the other metrics as given."""
    from evdb_bench.harness import end_to_end_values

    kind = spec.request_kind(name)
    phases = {"start": 7.5, "draw_and_app": 1.25, "store": 0.5,
              "prepare": 5.125, "warm_store": 0.75}
    if not hasattr(kind, "prepare"):
        del phases["prepare"]
    e2e = end_to_end_values(kind, phases, 60.0, 16.0,
                            {"recall_at_10": 0.97})
    assert e2e["qps"] == 60.0 and e2e["setup_s"] == 16.0
    assert e2e["recall_at_10"] == 0.97
    if hasattr(kind, "prepare"):
        assert e2e["index_build_s"] == 5.125
    else:
        assert "index_build_s" not in e2e


def test_index_build_s_is_reported_in_the_index_cell_alone(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["index_build_s"]["workloads"] == ["cohere1m.mcp_index"]
    for w in bench["workloads"]:
        c = spec.cell(w["name"], bench=bench)
        prepares = hasattr(spec.request_kind(c.traffic["request"]),
                           "prepare")
        assert prepares == ("index_build_s" in
                            {m.name for m in c.end_to_end})


def test_added_files_are_found_by_name(tmp_path, bench):
    """A new configuration, traffic mix and per-layer metric are taken as
    added files and entries alone, no file of the harness edited."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / spec.HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = spec.load_json(spec.ROOT / bench["configs"][0]["file"])
    cfg["name"] = "glove100_int8_wide_k"
    cfg["k"] = 100
    (root / "evdb_bench/configs/glove100_int8_wide_k.json").write_text(
        json.dumps(cfg))
    traffic = spec.load_json(spec.HERE / "traffic/grpc_batch_c2.json")
    traffic["connections"] = traffic["processes"] = 1
    (root / "evdb_bench/traffic/grpc_batch_c1.json").write_text(
        json.dumps(traffic))
    (root / "evdb_bench/metrics/answered_share.batch.py").write_text(
        "def read(ctx):\n    return ctx.get('answered_share')\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": cfg["name"], "source": "s",
                           "file": "evdb_bench/configs/glove100_int8_wide_k.json",
                           "reduced": [], "why": "w"})
    new["workloads"].append({"name": "glove100.wide_k", "config": cfg["name"],
                             "traffic": "grpc_batch_c1", "chips": 1,
                             "why": "w"})
    new["per_layer"].append({"name": "answered_share.batch", "unit": "%",
                             "better": "higher", "source": "host_clock",
                             "layer": "frontends", "moves": "qps",
                             "workloads": ["glove100.wide_k"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    c = spec.cell("glove100.wide_k", root=root)
    assert c.config["k"] == 100 and c.traffic["connections"] == 1
    assert [m.name for m in c.per_layer] == ["answered_share.batch"]
    got = spec.read_metrics(c.per_layer, {"answered_share": 99.5}, root=root)
    assert got == {"answered_share.batch": {"value": 99.5, "unit": "%"}}
    assert spec.read_metrics(c.per_layer, {}, root=root) == {}


NEW_KIND = '''"""A request kind added as a file: search_vectors with the query as a
JSON list."""
import json

from evdb_bench.wire import int_id, mcp_tail

TRANSPORT = "mcp"
ANSWERS = "store"


def target(config):
    return config["name"]


def queries_per_request(traffic):
    return 1


def keys(traffic, ci, rng, n_queries, n):
    return rng.integers(0, n_queries, n)


def encode(traffic, target_name, k, queries, key):
    return mcp_tail("search_vectors", {"store": target_name, "k": k,
                                       "vector": queries[key].tolist()})


def answers(traffic, key, body, n_queries):
    hits = json.loads(body)["results"]
    return [(key, [int_id(h["id"]) for h in hits],
             [h["distance"] for h in hits])]


def numbers(answers, queries, data, config, seed):
    from evdb_bench import judge

    out = judge.numbers("store", answers, queries, data, config["k"], 8)
    out["seed_seen"] = float(seed)
    return out
'''

NEW_BUILDER = '''"""A store builder added as a file: the matrix store, counted."""
from erlvectordb_tpu_torch.core.store import VectorStore

BUILT = []


def build(app, config, data, device):
    st = config["store"]
    store = VectorStore.from_matrix(config["name"], data,
                                    metric=config["metric"],
                                    dtype=st["dtype"], device=device)
    app.db.registry.adopt(store)
    BUILT.append(store.count)
    return store


def warm(store, config, traffic):
    store.warmup(batch_sizes=(1, 2, 4), ks=(config["k"],))
'''

NEW_METRIC = '''"""Rows the added builder built (a metric added as a file)."""
from evdb_bench.spec import store_builder


def read(ctx):
    built = getattr(store_builder(ctx["config"]["store"]["builder"]),
                    "BUILT", None)
    return float(built[-1]) if built else None
'''

RUN_TINY = """
import json, sys, time
from evdb_bench import harness, spec
r = harness.run(spec.cell(sys.argv[1]), 5, 2, True, "cpu", time.perf_counter())
r.pop("_check_lines")
print(json.dumps(r))
"""


def test_a_new_request_kind_and_store_builder_run_as_added_files(
        tmp_path, bench):
    """A cell whose request kind, store builder, configuration, traffic
    and per-layer metric are all new files runs whole, on the CPU at a
    tiny size, from a copy of the benchmark: no file of it edited."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / spec.HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    here = root / spec.HERE.name
    (here / "requests/mcp_search_vectors_list.py").write_text(NEW_KIND)
    (here / "stores/matrix_counted.py").write_text(NEW_BUILDER)
    (here / "metrics/built_rows.tiny.py").write_text(NEW_METRIC)
    cfg = spec.load_json(spec.ROOT / "evdb_bench/configs/glove100_int8.json")
    cfg.update(name="glove_tiny", rows=5000, test_queries=300)
    cfg["store"] = {"builder": "matrix_counted", "dtype": "int8", "bits": 8}
    cfg["server"] = {"sync_interval": 9999.0}
    cfg["correct"]["store"]["seed_seen"] = {"min": 5}
    (here / "configs/glove_tiny.json").write_text(json.dumps(cfg))
    (here / "traffic/mcp_list_tiny.json").write_text(json.dumps({
        "request": "mcp_search_vectors_list", "rate_per_s": 40,
        "connections": 2, "processes": 1, "warmup_requests": 2,
        "warm_batches": [1]}))
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "glove_tiny", "source": "s",
                           "file": "evdb_bench/configs/glove_tiny.json",
                           "reduced": ["rows"], "why": "w"})
    new["workloads"].append({"name": "glove.tiny", "config": "glove_tiny",
                             "traffic": "mcp_list_tiny", "chips": 1,
                             "why": "w"})
    new["per_layer"].append({"name": "built_rows.tiny", "unit": "rows",
                             "better": "higher", "source": "host_clock",
                             "layer": "store", "moves": "qps",
                             "workloads": ["glove.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(root), str(spec.ROOT)])}
    p = subprocess.run([sys.executable, "-c", RUN_TINY, "glove.tiny"],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == 80
    assert r["metrics"] == {"built_rows.tiny": {"value": 5000.0,
                                                "unit": "rows"}}
    assert r["checks"]["malformed"]["value"] == 0.0
    assert r["checks"]["seed_seen"] == {"value": 5.0, "min": 5}
