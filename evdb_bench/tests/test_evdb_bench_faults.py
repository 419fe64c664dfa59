"""Whole runs on the CPU at a tiny size (the look for a card skipped), with
the timed path sound and with it broken underneath: each fault a cell can
have has to turn ``correct`` false.  The faults of a model (a state left
unchanged, the exchange between chips) do not arise: no cell trains and
every cell runs on one card."""

import subprocess
import sys
import time

import numpy as np
import pytest

from evdb_bench import harness, spec
from evdb_bench.run import forbidden_modules

SEED = 3_000_000_019


def tiny_run(cell, rows=20000, queries=2000, seconds=2, rate=None,
             trace=False):
    """A run on the CPU at a rate the CPU sustains (a 1,024-query batch
    takes about a second there)."""
    c = spec.cell(cell)
    c.config.update(rows=rows, test_queries=queries)
    c.traffic["rate_per_s"] = rate or (
        2.0 if c.traffic["request"] == "grpc_search_batch" else 60.0)
    result = harness.run(c, SEED, seconds, trace, "cpu", time.perf_counter())
    result.pop("_check_lines")
    return result


def alter_first_answer(monkeypatch):
    """An answer altered where it is produced: the store's device results
    of each search give query 0 a neighbour's row in place of its best."""
    from erlvectordb_tpu_torch.core.store import VectorStore

    orig = VectorStore._readback

    def readback(self, t):
        dists, rows = orig(self, t)
        rows = rows.copy()
        rows[0, 0] = (rows[0, 0] + 1) % self.count
        return dists, rows

    monkeypatch.setattr(VectorStore, "_readback", readback)


def drop_half_the_batch(monkeypatch):
    """Half of each batch left out: the second half of the queries gets the
    first half's answers."""
    from erlvectordb_tpu_torch.core.store import VectorStore

    orig = VectorStore._readback

    def readback(self, t):
        dists, rows = orig(self, t)
        half = rows.shape[0] // 2
        if half:
            dists, rows = dists.copy(), rows.copy()
            dists[half:2 * half], rows[half:2 * half] = dists[:half], rows[:half]
        return dists, rows

    monkeypatch.setattr(VectorStore, "_readback", readback)


def alter_index_answer(monkeypatch):
    """An index answer altered where it is produced."""
    from erlvectordb_tpu_torch.core.cell_probe import CellProbeIndex

    orig = CellProbeIndex.search

    def search(self, *a, **kw):
        dists, rows = orig(self, *a, **kw)
        rows = rows.copy()
        rows[0, 0] = (rows[0, 0] + 1) % 20000
        return dists, rows

    monkeypatch.setattr(CellProbeIndex, "search", search)


def test_sound_batch_run_is_correct_and_well_shaped():
    r = tiny_run("glove100.grpc_batch")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert set(r) == {"correct", "attempted", "failed", "metrics", "device",
                      "checks"}
    assert set(r["metrics"]) == {"qps", "setup_s"}
    assert r["metrics"]["qps"]["unit"] == "queries/s"
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert r["checks"]["dist_err"]["value"] < r["checks"]["dist_err"]["max"]


@pytest.mark.parametrize("fault", [alter_first_answer, drop_half_the_batch])
@pytest.mark.parametrize("cell", ["glove100.grpc_batch",
                                  "glove100.mcp_single"])
def test_a_broken_store_path_is_not_correct(monkeypatch, fault, cell):
    fault(monkeypatch)
    assert not tiny_run(cell)["correct"]


def test_sound_and_broken_index_runs():
    r = tiny_run("cohere1m.mcp_index", rows=8192, queries=200, rate=40.0,
                 trace=True)
    assert set(r["metrics"]) == {"index_search_ms.single"}
    assert r["checks"]["dist_err"]["value"] < r["checks"]["dist_err"]["max"]
    mp = pytest.MonkeyPatch()
    try:
        alter_index_answer(mp)
        bad = tiny_run("cohere1m.mcp_index", rows=8192, queries=200,
                       rate=40.0)
    finally:
        mp.undo()
    assert bad["checks"]["dist_err"]["value"] > bad["checks"]["dist_err"]["max"]
    assert not bad["correct"]


def test_the_import_guard_compares_whole_top_level_names(monkeypatch):
    import erlvectordb_tpu_torch  # noqa: F401

    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "erlvectordb_tpu.core", object())
    assert forbidden_modules() == ["erlvectordb_tpu", "jax"]


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "evdb_bench/run.py", "--workload",
                        "glove100.grpc_batch", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_closed_loop_answers_cover_every_test_query():
    """The 10 fixed batches of the glove cell cover all 10,000 queries."""
    batch_rows = spec.request_kind("grpc_search_batch").batch_rows
    c = spec.cell("glove100.grpc_batch")
    rows = np.concatenate([batch_rows(r, c.traffic["batch"],
                                      c.config["test_queries"])
                           for r in range(c.traffic["distinct_requests"])])
    assert np.unique(rows).size == c.config["test_queries"]
