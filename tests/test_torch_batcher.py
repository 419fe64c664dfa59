"""tests/test_batcher.py re-pointed at the port's micro-batcher
(erlvectordb_tpu_torch/serve/batcher.py) over a store on the CPU:
coalescing, correctness, error isolation, backpressure, the adaptive
window."""

import threading

import numpy as np
import pytest
import torch

from erlvectordb_tpu_torch.core import StoreRegistry
from erlvectordb_tpu_torch.serve.batcher import QueryBatcher
from erlvectordb_tpu_torch.utils.metrics import metrics

CPU = torch.device("cpu")


@pytest.fixture
def setup(rng):
    registry = StoreRegistry(CPU)
    store = registry.create("b", metric="euclidean")
    data = rng.standard_normal((300, 16)).astype(np.float32)
    store.insert_batch([f"v{i}" for i in range(300)], data)
    batcher = QueryBatcher(lambda name: registry.get(name), max_wait=0.005).start()
    yield registry, batcher, data
    batcher.stop()


def test_single_query(setup):
    _, batcher, data = setup
    hits = batcher.search("b", data[7], k=1)
    assert hits[0][0] == "v7"


def test_concurrent_queries_coalesce(setup):
    _, batcher, data = setup
    before = metrics.snapshot()["counters"].get("batcher.batched_queries", 0)
    results = {}
    errors = []

    def worker(i):
        try:
            results[i] = batcher.search("b", data[i], k=1)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for i in range(32):
        assert results[i][0][0] == f"v{i}"
    snap = metrics.snapshot()
    assert snap["counters"]["batcher.batched_queries"] >= before + 32
    # at least one multi-query batch happened
    assert snap["latencies"]["batcher.batch_size"]["count"] >= 1


def test_error_delivery(setup):
    registry, batcher, data = setup
    with pytest.raises(Exception):
        batcher.search("nonexistent", data[0], k=1)


def test_bad_dim_does_not_poison_batch(setup):
    _, batcher, data = setup
    results = {}
    errors = {}

    def good(i):
        results[i] = batcher.search("b", data[i], k=1)

    def bad():
        try:
            batcher.search("b", np.zeros(3, np.float32), k=1)
        except Exception as e:  # noqa: BLE001
            errors["bad"] = e

    threads = [threading.Thread(target=good, args=(i,)) for i in range(4)]
    threads.append(threading.Thread(target=bad))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert "bad" in errors  # dimension mismatch surfaced to its caller
    for i in range(4):
        assert results[i][0][0] == f"v{i}"  # others unaffected


def test_stop_fails_pending(setup):
    _, batcher, data = setup
    batcher.stop()
    # degraded direct path still works after stop
    hits = batcher.search("b", data[5], k=1)
    assert hits[0][0] == "v5"


def test_backpressure_sheds_past_max_queue(setup):
    from erlvectordb_tpu_torch.serve.batcher import OverloadedError

    registry, _, data = setup
    # a batcher that is NOT started: submissions accumulate, so the bound
    # is deterministic
    b = QueryBatcher(lambda name: registry.get(name), max_queue=3)
    errs = []
    oks = []
    for i in range(5):
        p = b.submit("b", data[0], k=1,
                     callback=lambda r, e: (errs if e else oks).append(e or r))
    assert len(errs) == 2
    assert all(isinstance(e, OverloadedError) for e in errs)
    assert metrics.snapshot()["counters"].get("batcher.shed", 0) >= 2


def test_adaptive_window_tracks_service_time(setup):
    registry, _, _ = setup
    b = QueryBatcher(lambda name: registry.get(name),
                     max_wait=0.004, min_wait=0.0002)
    # fully idle (no queue, no inflight) -> long sleep, woken by submit
    assert b._effective_wait() == 0.5
    # requests queued but device idle -> floor
    b._depth = 1
    assert b._effective_wait() == b.min_wait
    # busy device with slow batches -> capped at max_wait
    b._inflight_n = 2
    b._service_ewma = 0.1
    assert b._effective_wait() == b.max_wait
    # busy device with fast batches -> half the EWMA, floored
    b._service_ewma = 0.002
    assert abs(b._effective_wait() - 0.001) < 1e-9
    b._service_ewma = 0.0001
    assert b._effective_wait() == b.min_wait


def test_service_ewma_and_gauges_update(setup):
    _, batcher, data = setup
    metrics.reset()
    for _ in range(3):
        batcher.search("b", data[0], k=1)
    snap = metrics.snapshot()
    assert snap["gauges"].get("batcher.service_ewma_ms", 0) > 0
    assert "batcher.inflight" in snap["gauges"]
    assert batcher._service_ewma > 0


def test_malformed_2d_query_rejected_alone(setup):
    """Regression: a 2-D query with the right trailing dim must fail ONLY
    its own request, not poison the coalesced batch's np.stack."""
    import threading

    _, batcher, data = setup
    results = {}

    def good(i):
        results[i] = batcher.search("b", data[i], k=1)

    threads = [threading.Thread(target=good, args=(i,), daemon=True)
               for i in (1, 2)]
    p = batcher.submit("b", np.ones((1, 16), np.float32), k=1)
    for t in threads:
        t.start()
    assert p.event.wait(10)
    assert isinstance(p.error, ValueError)
    for t in threads:
        t.join(timeout=30)
    assert results[1][0][0] == "v1" and results[2][0][0] == "v2"


@pytest.mark.parametrize("call", ["submit", "submit_group"])
def test_probe_request_answers_on_the_callers_thread(setup, call):
    """A request with ``nprobe`` skips the window: on a running batcher it
    is answered on the caller's thread before the submit returns, its store
    spans carry its id, and it waits in no batcher queue."""
    import time

    from erlvectordb_tpu_torch.core.store import VectorStore

    registry, batcher, _ = setup
    rng = np.random.default_rng(5)
    centres = rng.standard_normal((8, 16)).astype(np.float32)
    data = (centres[rng.integers(0, 8, 2000)]
            + 0.2 * rng.standard_normal((2000, 16))).astype(np.float32)
    registry.adopt(VectorStore.from_matrix("r", data, dtype="int4r",
                                           device=CPU))
    assert batcher.is_alive()
    seen = []

    def cb(out, err):
        seen.append((threading.get_ident(), out, err))

    rid = metrics.new_id()
    since = time.perf_counter()
    with metrics.bound(rid):
        if call == "submit":
            batcher.submit("r", data[3], k=1, nprobe=4, callback=cb)
        else:
            batcher.submit_group("r", data[3:5], k=1, nprobe=4, callback=cb)
    [(thread, out, err)] = seen
    assert thread == threading.get_ident() and err is None
    hits = out if call == "submit" else out[0]
    assert hits[0][0] == "3"
    spans = metrics.spans_between(since, time.perf_counter() + 1)
    names = {s[0] for s in spans}
    assert "batcher.queue_wait" not in names
    assert "batcher.inflight_wait" not in names
    assert {s[0] for s in spans if s[1] == rid} >= {
        "store.submit", "store.readback", "store.map"}
