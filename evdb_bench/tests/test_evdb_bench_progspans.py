"""The readers of the program's own spans (``evdb_bench/progspans.py`` and
the ``metrics/<name>.py`` files on it) on synthetic spans and device
events: each stage's arithmetic, the idle that overlaps an open request,
and every case in which a reader has nothing to read."""

import pytest

from erlvectordb_tpu_torch.utils.metrics import MetricsRegistry
from evdb_bench import progspans, spec

S = 1_000_000_000  # ns a second


def ns(sec):
    return int(round(sec * S))


# (name, rid, parent, start s, end s, n)
SPANS = [
    # a gRPC SearchBatch of 4 queries, its group's id its own
    ("grpc.decode", 1, 0, 10.100, 10.105, 4),
    ("grpc.decode", 1, 0, 10.110, 10.112, 4),
    ("batcher.inflight_wait", 1, 0, 10.112, 10.113, 4),
    ("store.submit", 1, 0, 10.113, 10.120, 4),
    ("batcher.completion_wait", 1, 0, 10.120, 10.150, 4),
    ("store.readback", 1, 0, 10.150, 10.170, 4),
    ("store.map", 1, 0, 10.170, 10.175, 4),
    ("batcher.delivery_wait", 1, 0, 10.175, 10.180, 4),
    ("grpc.encode", 1, 0, 10.185, 10.200, 4),
    ("grpc.request", 1, 0, 10.100, 10.200, 4),
    # one begun before the window: read by no mean, open in the idle
    ("store.readback", 2, 0, 9.950, 9.990, 4),
    ("grpc.request", 2, 0, 9.900, 10.020, 4),
    # an MCP search_vectors (id 10) through device batch 20
    ("mcp.parse", 10, 0, 11.000, 11.002, 1),
    ("batcher.queue_wait", 10, 20, 11.002, 11.010, 1),
    ("batcher.inflight_wait", 20, 0, 11.010, 11.011, 1),
    ("store.submit", 20, 0, 11.011, 11.015, 1),
    ("batcher.completion_wait", 20, 0, 11.015, 11.020, 1),
    ("store.readback", 20, 0, 11.020, 11.030, 1),
    ("store.map", 20, 0, 11.030, 11.031, 1),
    ("batcher.delivery_wait", 20, 0, 11.031, 11.040, 1),
    ("mcp.encode", 10, 20, 11.042, 11.050, 1),
    ("mcp.request", 10, 20, 11.000, 11.050, 1),
    # an MCP search_index (id 30)
    ("mcp.parse", 30, 0, 11.500, 11.501, 1),
    ("index.probe", 30, 0, 11.503, 11.506, 1),
    ("index.readback", 30, 0, 11.506, 11.512, 1),
    ("index.map", 30, 0, 11.512, 11.513, 1),
    ("index.map", 30, 0, 11.513, 11.515, 1),
    ("index.search", 30, 0, 11.502, 11.515, 1),
    ("mcp.encode", 30, 0, 11.515, 11.520, 1),
    ("mcp.request", 30, 0, 11.500, 11.520, 1),
    # after the window
    ("grpc.request", 3, 0, 12.500, 12.600, 4),
]

IDLE = [(10.0, 10.15), (10.17, 11.0), (11.03, 12.0)]
EVENTS = [("kernel", 10.15 + i * 1e-4, 10.15 + i * 1e-4 + 5e-5)
          for i in range(28)]


def registry(spans=SPANS):
    r = MetricsRegistry(span_capacity=1 << 10)
    for name, rid, parent, s, e, n in spans:
        r.record(name, rid, parent, ns(s), ns(e), n)
    return r


def context(**kw):
    ctx = {"t0": 10.0, "t1": 12.0, "counters": {}, "device_events": EVENTS,
           "idle": IDLE, "window_s": 2.0}
    ctx.update(kw)
    return ctx


@pytest.fixture
def program(monkeypatch):
    reg = registry()
    monkeypatch.setattr(progspans, "_registry", lambda: reg)
    return reg


EXPECTED = {
    "grpc_decode_ms.batch": 7.0,           # 5 ms parse + 2 ms rows
    "grpc_encode_ms.batch": 15.0,
    "batcher_wait_ms.batch": 36.0,         # 1 + 30 + 5
    "store_readback_ms.batch": (20.0 + 10.0) / 2,   # both begun inside
    "batcher_wait_ms.single": 23.0,        # 8 queued + 1 + 5 + 9
    # 50 less the union 11.002-11.040 (38); 20 less index.search (13)
    "mcp_self_ms.single": (12.0 + 7.0) / 2,
    "index_host_ms.single": 7.0,           # 13 less the 6 ms readback
    # idle meets open requests in 10.00-10.02, 10.10-10.15, 10.17-10.20,
    # 11.03-11.05 and 11.50-11.52: 0.14 s of 2
    "host_bound_idle_pct.batch": 7.0,
    "host_bound_idle_pct.single": 7.0,
    # 28 operations; completed inside: 4 + 4 + 1 + 1 queries
    "device_ops_per_query.single": 2.8,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_arithmetic(program, name):
    assert spec.reader(name)(context()) == pytest.approx(EXPECTED[name],
                                                         abs=1e-6)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_nothing_from_a_program_without_spans(monkeypatch, name):
    class Older:    # the registry as it was before spans: counters only
        def snapshot(self):
            return {}

    monkeypatch.setattr(progspans, "_registry", lambda: Older())
    assert spec.reader(name)(context()) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_nothing_once_spans_were_dropped(program, name):
    assert spec.reader(name)(context(
        counters={"trace.dropped": 3})) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_nothing_where_the_ring_lost_the_window(
        monkeypatch, name):
    reg = MetricsRegistry(span_capacity=4)
    for s in SPANS:   # the ring keeps the last 4, all after 11.5 s
        reg.record(s[0], s[1], s[2], ns(s[3]), ns(s[4]), s[5])
    monkeypatch.setattr(progspans, "_registry", lambda: reg)
    assert reg.snapshot()["counters"]["trace.dropped"] == len(SPANS) - 4
    assert spec.reader(name)(context()) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_readers_read_beside_the_device_trace_only(program, name):
    """A traced run off the card has no device trace: nothing to read."""
    assert spec.reader(name)(context(device_events=None)) is None


def test_readers_of_a_kind_absent_read_nothing(monkeypatch):
    mcp_only = [s for s in SPANS if not s[0].startswith("grpc.")
                and s[1] not in (1, 2, 3)]
    reg = registry(mcp_only)
    monkeypatch.setattr(progspans, "_registry", lambda: reg)
    for name in ("grpc_decode_ms.batch", "grpc_encode_ms.batch",
                 "batcher_wait_ms.batch"):
        assert spec.reader(name)(context()) is None
    assert spec.reader("batcher_wait_ms.single")(context()) == \
        pytest.approx(23.0)


def test_idle_overlap_is_the_intersection():
    """Idle ∩ open requests, on an idle list and request spans that
    interleave: each overlap counted once, requests overlapping each other
    merged first."""
    reg = registry([
        ("mcp.request", 1, 0, 1.0, 3.0, 1),
        ("mcp.request", 2, 0, 2.0, 4.0, 1),     # overlaps the first
        ("grpc.request", 3, 0, 6.0, 6.5, 1),
        ("store.readback", 4, 0, 0.0, 9.0, 1),  # not a request
    ])
    ctx = {"t0": 0.0, "t1": 10.0, "counters": {}, "window_s": 10.0,
           "device_events": [], "idle": [(0.5, 1.5), (2.5, 5.0), (5.5, 6.2),
                                         (6.4, 7.0)]}
    import unittest.mock as mock
    with mock.patch.object(progspans, "_registry", lambda: reg):
        got = progspans.host_bound_idle_pct(ctx)
    # 1.0-1.5, 2.5-4.0, 6.0-6.2, 6.4-6.5: 0.5 + 1.5 + 0.2 + 0.1 of 10 s
    assert got == pytest.approx(23.0)


def test_stage_decomposition(program):
    """``tools/stages.py`` on the synthetic spans: each request's stages
    (its own spans and its device batch's, summed by name), what no inner
    span covers, and the store's four stages a search."""
    from evdb_bench.tools.stages import decompose

    got = decompose(context(spans=None, busy_s=0.5))
    assert got["requests"] == 3      # the gRPC one and the two MCP ones
    med = got["stage_median_ms"]
    assert med["request"] == pytest.approx(50.0)      # of 100, 50, 20
    assert med["self"] == pytest.approx(12.0)         # of 32, 12, 7
    assert med["uncovered"] == pytest.approx(2.0)     # of 10, 2, 1
    assert med["grpc.decode"] == pytest.approx(7.0)
    assert med["store.readback"] == pytest.approx(15.0)   # of 20, 10
    assert med["index.map"] == pytest.approx(3.0)     # its two parts
    assert got["stage_mean_ms"]["batcher.queue_wait"] == pytest.approx(8.0)
    assert got["store_stages_ms"] == pytest.approx((62.0 + 20.0) / 2)
    assert got["index_search_ms"] == pytest.approx(13.0)
    assert got["store_ms_harness"] is None
    assert got["device_idle_pct"] == pytest.approx(75.0)
    assert got["host_bound_idle_pct"] == pytest.approx(7.0)
    assert got["trace_dropped"] == 0
    assert decompose(context(device_events=None)) is None
