"""The distributed store served as the benchmark's ``cohere10m.grpc_exact``
serves it, on the CPU at a tiny size: the blocked plain reference against
``Exact``, whole runs of the cell on a cluster of 4 logical CPU devices
(sound, and with the sharded store's readback broken), the sharded store's
spans and counters under a gRPC ``SearchBatch``, and the new readers'
arithmetic on a known trace."""

import time

import numpy as np
import pytest
import torch

from erlvectordb_tpu_torch.parallel.mesh import (
    cpu_device_count,
    set_cpu_device_count,
)
from erlvectordb_tpu_torch.parallel.sharded_store import ShardedVectorStore
from erlvectordb_tpu_torch.utils.metrics import metrics
from evdb_bench import harness, judge, roofline, spec
from evdb_bench.reference.exact import Exact
from evdb_bench.reference.exact_blocked import ExactBlocked, numbers

CELL = "cohere10m.grpc_exact"
SEED = 3_000_000_019
SHARDS = 4


@pytest.fixture
def four_cpu_devices():
    held = cpu_device_count()
    set_cpu_device_count(SHARDS)
    yield
    set_cpu_device_count(held)


# ------------------------------------------------------ blocked reference


def _corpus(n=3001, d=48, nq=40):
    """Rows with planted ties: copies of row 17 and a scaled copy (cosine
    ties), a zero row; the first queries close to row 17."""
    g = torch.Generator().manual_seed(7)
    data = torch.randn(n, d, generator=g)
    for r in (1999, 2400, 2999):
        data[r] = data[17]
    data[1000] = 2.0 * data[17]
    data[1500] = 0.0
    q = torch.randn(nq, d, generator=g)
    q[:12] = data[17] + 1e-3 * torch.randn(12, d, generator=g)
    return data, q


def _row_order(dist, ids):
    """``Exact``'s top-k put in order of (distance, row): ``torch.topk``
    leaves the order of tied rows open, not which rows it picks."""
    o = torch.argsort(ids, dim=1, stable=True)
    dist, ids = torch.gather(dist, 1, o), torch.gather(ids, 1, o)
    o = torch.argsort(dist, dim=1, stable=True)
    return torch.gather(dist, 1, o), torch.gather(ids, 1, o)


@pytest.mark.parametrize("bits", [8, 4, None])
@pytest.mark.parametrize("block", [1000, 1024, 3001, 4096, 333])
def test_blocked_reference_equals_exact(bits, block):
    data, q = _corpus()
    ref = Exact(data, bits)
    want_d, want_i = _row_order(*ref.topk(q, 10))
    got_d, got_i = ExactBlocked(data, bits, block).topk(q, 10)
    assert torch.equal(got_d, want_d) and torch.equal(got_i, want_i)
    # the planted ties are in the answers, lower rows first
    assert {17, 1000, 1999, 2400, 2999} <= set(got_i[0].tolist())
    assert torch.equal(ExactBlocked(data, bits, block).dist_of(q, want_i),
                       ref.dist_of(q, want_i))


@pytest.mark.parametrize("block", [1000, 3001])
def test_blocked_numbers_equal_the_judges(block):
    data, q = _corpus()
    dist, ids = Exact(data, 8).topk(q, 10)
    ids, dist = ids.numpy().copy(), dist.numpy()
    ids[3, 9] = 2222                       # a miss
    answers = [(i, ids[i], dist[i]) for i in range(q.shape[0])]
    answers.append((5, ids[5][:9], dist[5][:9]))    # malformed
    answers.append((6, ids[6][::-1], dist[6][::-1]))  # out of order
    want = judge.numbers("store", answers, q, data, 10, bits=8)
    got = numbers("store", answers, q, data, 10, bits=8, block=block)
    assert got == want
    assert got["malformed"] == 2.0 and got["miss_at_10"] > 0
    want = judge.numbers("index", answers, q, data, 10, bits=8)
    assert numbers("index", answers, q, data, 10, 8, block=block) == want


# ------------------------------------------------------------- whole runs


def tiny_run(seconds=1):
    """The cell at 20,000 rows on 4 logical CPU devices, one shard each,
    with batches of 64 queries at a rate the CPU sustains."""
    c = spec.cell(CELL)
    c.config.update(rows=20000, test_queries=256)
    c.config["store"]["chunk"] = 4096
    c.config["mesh"] = {"replicas": 1, "shards": SHARDS}
    c.traffic.update(rate_per_s=4.0, batch=64, warmup_requests=1,
                     warm_batches=[64])
    r = harness.run(c, SEED, seconds, False, "cpu", time.perf_counter())
    r.pop("_check_lines")
    return r


def test_sound_sharded_run_is_correct(four_cpu_devices):
    before = metrics.snapshot()["counters"].get("store.shard_scans_total", 0)
    r = tiny_run()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == 4
    assert r["checks"]["dist_err"]["value"] < 1e-5
    assert r["checks"]["miss_at_10"]["value"] < 0.1
    scans = metrics.snapshot()["counters"]["store.shard_scans_total"] - before
    assert scans >= SHARDS * r["attempted"]      # every shard scanned


def alter_one_row(t, dists, rows, count):
    rows[0, 0] = (rows[0, 0] + 1) % count


def swap_halves(t, dists, rows, count):
    half = rows.shape[0] // 2
    dists[half:2 * half], rows[half:2 * half] = dists[:half], rows[:half]


@pytest.mark.parametrize("fault", [alter_one_row, swap_halves])
def test_a_broken_sharded_readback_is_not_correct(four_cpu_devices,
                                                  monkeypatch, fault):
    orig = ShardedVectorStore._readback

    def readback(self, t):
        dists, rows = orig(self, t)
        dists, rows = dists.copy(), rows.copy()
        fault(t, dists, rows, self.count)
        return dists, rows

    monkeypatch.setattr(ShardedVectorStore, "_readback", readback)
    assert not tiny_run()["correct"]


def test_the_builder_refuses_another_layout(four_cpu_devices):
    from erlvectordb_tpu_torch.parallel.mesh import cpu_devices, make_mesh

    check = spec.store_builder("sharded").check_mesh
    config = spec.cell(CELL).config
    with pytest.raises(RuntimeError, match="1 replica group.*x 4 shard"):
        check(make_mesh(SHARDS, 1, devices=cpu_devices()), config, "cpu")
    one = make_mesh(1, 1, devices=cpu_devices()[:1])
    check(one, config, "cpu")
    with pytest.raises(RuntimeError, match="cuda:0"):
        check(one, config, torch.device("cuda", 0))


# ------------------------------------------------------- spans, counters


def test_sharded_search_batch_spans_and_counters(four_cpu_devices):
    grpc = pytest.importorskip("grpc")
    from erlvectordb_tpu_torch.app import Application
    from erlvectordb_tpu_torch.serve import evdb_pb2 as pb

    ports = harness.service_ports()
    app = Application(harness.app_config(ports), device=torch.device("cpu")).start()
    chan = None
    try:
        rng = np.random.default_rng(0)
        data = rng.standard_normal((6000, 32)).astype(np.float32)
        cluster = app.db.cluster
        store = ShardedVectorStore.from_chunks(
            "s", cluster.mesh, (data[i:i + 1024] for i in range(0, 6000, 1024)),
            6000, 32, metric="cosine", dtype="int8")
        cluster.distribute_store(store)
        assert app.db.any_store("s") is store
        chan = grpc.insecure_channel(f"127.0.0.1:{ports['grpc_server']}")
        call = chan.unary_unary(
            "/evdb.ErlVectorDB/SearchBatch",
            request_serializer=pb.SearchBatchRequest.SerializeToString,
            response_deserializer=pb.SearchBatchReply.FromString)
        c0 = metrics.snapshot()["counters"]
        since = time.perf_counter()
        qs = data[:5].astype("<f4")
        rep = call(pb.SearchBatchRequest(store="s", vectors_f32=qs.tobytes(),
                                         dim=32, k=3), timeout=60)
        assert rep.count == 5 and list(rep.ids[::3]) == [
            "0", "1", "2", "3", "4"]
        deadline = time.monotonic() + 10
        while True:
            spans = metrics.spans_between(since, time.perf_counter() + 1)
            reqs = [s for s in spans if s[0] == "grpc.request"]
            if reqs or time.monotonic() > deadline:
                break
            time.sleep(0.01)
        [req] = reqs
        c1 = metrics.snapshot()["counters"]
    finally:
        if chan is not None:
            chan.close()
        app.stop()
    mine = {}
    for s in spans:
        if s[1] == req[1]:
            mine.setdefault(s[0], []).append(s)
    order = ["store.submit", "store.readback", "store.merge", "store.map"]
    got = [mine[name] for name in order]
    assert all(len(g) == 1 and g[0][5] == 5 for g in got), mine
    assert all(req[3] <= g[0][3] <= g[0][4] <= req[4] for g in got)
    ends = [g[0][4] for g in got]
    assert ends == sorted(ends)
    # readback, merge and map follow one another on the completion thread
    assert got[1][0][4] == got[2][0][3] and got[2][0][4] == got[3][0][3]
    delta = {k: c1.get(k, 0) - c0.get(k, 0)
             for k in ("store.search_total", "store.queries_total",
                       "store.shard_scans_total")}
    assert delta == {"store.search_total": 1, "store.queries_total": 5,
                     "store.shard_scans_total": SHARDS}


# --------------------------------------------------------------- readers

KERNEL = ("void (anonymous namespace)::slice_scan_kernel<false, 2, false, "
          "true>(signed char const*, float const*)")


def _known_trace(monkeypatch):
    """A window of 10 s at t = 100 s: three searches submitted in it (1,024,
    1,024 and 512 queries) and one before it, and the kernel's device
    time 0.15 s among other operations."""
    t0, t1 = 100.0, 110.0
    ns = 1_000_000_000

    def span(name, start_s, ms, n):
        return (name, 7, 0, int(start_s * ns), int(start_s * ns + ms * 1e6), n)

    spans = [span("store.submit", 99.9, 3.0, 1024),
             span("store.submit", 101.0, 2.0, 1024),
             span("store.readback", 101.01, 40.0, 1024),
             span("store.merge", 101.05, 0.5, 1024),
             span("store.submit", 104.0, 4.0, 1024),
             span("store.readback", 104.01, 44.0, 1024),
             span("store.merge", 104.05, 1.5, 1024),
             span("store.submit", 108.0, 3.0, 512),
             span("grpc.request", 101.0, 60.0, 1024)]
    monkeypatch.setattr(metrics, "spans_between",
                        lambda a, b: [s for s in spans
                                      if s[4] >= a * ns and s[3] <= b * ns])
    events = [(KERNEL, 101.0, 101.05), (KERNEL, 104.0, 104.06),
              (KERNEL, 108.0, 108.04), ("Memcpy HtoD", 101.0, 101.001),
              ("void tile_scan_kernel<2>", 102.0, 102.5)]
    return {"t0": t0, "t1": t1, "device_events": events, "counters": {},
            "config": spec.cell(CELL).config}


def test_sharded_readers_on_a_known_trace(monkeypatch):
    ctx = _known_trace(monkeypatch)
    read = {name: spec.reader(name) for name in (
        "sharded_submit_ms.batch", "sharded_readback_ms.batch",
        "sharded_merge_ms.batch", "sharded_scan_roofline")}
    assert read["sharded_submit_ms.batch"](ctx) == pytest.approx(3.0)
    assert read["sharded_readback_ms.batch"](ctx) == pytest.approx(42.0)
    assert read["sharded_merge_ms.batch"](ctx) == pytest.approx(1.0)
    bound = (2 * roofline.int8_scan_bound_s(10_000_000, 768, 1024, 10, 8)
             + roofline.int8_scan_bound_s(10_000_000, 768, 512, 10, 8))
    # 2 * 10M * 768 * 1024 operations at 1,979 TOP/s: 7.95 ms a batch
    assert roofline.int8_scan_bound_s(10_000_000, 768, 1024, 10, 8) \
        == pytest.approx(7.948e-3, rel=1e-3)
    got = read["sharded_scan_roofline"](ctx)
    assert got == pytest.approx(100.0 * bound / 0.15)
    assert got == pytest.approx(100.0 * (2 * 7.9476e-3 + 3.9738e-3) / 0.15,
                                rel=1e-3)


@pytest.mark.parametrize("name", [
    "sharded_submit_ms.batch", "sharded_readback_ms.batch",
    "sharded_merge_ms.batch", "sharded_scan_roofline"])
def test_sharded_readers_read_nothing_without_a_trace_or_spans(
        monkeypatch, name):
    ctx = _known_trace(monkeypatch)
    read = spec.reader(name)
    assert read(dict(ctx, device_events=None)) is None
    assert read(dict(ctx, counters={"trace.dropped": 3})) is None
    monkeypatch.setattr(metrics, "spans_between", lambda a, b: [
        ("grpc.request", 7, 0, int(101e9), int(101.06e9), 1024)])
    assert read(ctx) is None          # a program without the store's spans
