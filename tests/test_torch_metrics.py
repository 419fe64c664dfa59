"""tests/test_metrics.py re-pointed at the port's metrics registry
(erlvectordb_tpu_torch/utils/metrics.py): counters, histogram buckets,
timed spans, the Prometheus text, reset, and the store's own spans."""

import numpy as np
import torch

from erlvectordb_tpu_torch.utils.metrics import Histogram, MetricsRegistry, metrics


class TestRegistry:
    def test_counters(self):
        r = MetricsRegistry()
        r.inc("requests")
        r.inc("requests", 4)
        assert r.snapshot()["counters"]["requests"] == 5

    def test_histogram_buckets(self):
        h = Histogram()
        for v in (0.00005, 0.003, 0.3, 100.0):
            h.observe(v)
        snap = h.snapshot()
        assert snap["count"] == 4
        assert snap["buckets"]["inf"] == 1
        assert snap["mean_ms"] is not None

    def test_timed_context(self):
        r = MetricsRegistry()
        with r.timed("op"):
            pass
        snap = r.snapshot()
        assert snap["latencies"]["op"]["count"] == 1
        assert snap["counters"]["op_total"] == 1

    def test_prometheus_format(self):
        r = MetricsRegistry()
        r.inc("search.total", 3)
        with r.timed("search"):
            pass
        text = r.prometheus()
        assert "# TYPE evdb_search_total counter" in text
        assert "evdb_search_total 3" in text
        assert 'evdb_search_bucket{le="+Inf"} 1' in text
        assert "evdb_search_count 1" in text

    def test_reset(self):
        r = MetricsRegistry()
        r.inc("x")
        r.reset()
        assert r.snapshot()["counters"] == {}


class TestStoreInstrumentation:
    def test_search_and_insert_recorded(self, rng):
        from erlvectordb_tpu_torch.core.store import VectorStore

        before = metrics.snapshot()["counters"].get("store.queries_total", 0)
        store = VectorStore("m1", device=torch.device("cpu"))
        store.insert_batch(["a", "b"], rng.standard_normal((2, 4)).astype(np.float32))
        store.search(np.ones(4, np.float32), k=1)
        snap = metrics.snapshot()
        assert snap["counters"]["store.queries_total"] >= before + 1
        assert "store.search" in snap["latencies"]
        assert "store.insert" in snap["latencies"]
