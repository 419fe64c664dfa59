"""tests/test_ep_cell_probe.py re-pointed at the port's expert-parallel
cell probe (erlvectordb_tpu_torch/parallel/ep_cell_probe.py) on 8 logical
CPU devices: recall parity with the single-device cell probe, dot results
near the optimum, self-query top-1, the merge of the shards' candidates,
padding cells that never win a probe, shard padding, persistence, the
recall_target calibration, and the index-manager integration."""

import numpy as np
import pytest
import torch

from erlvectordb_tpu_torch.core.cell_probe import CellProbeIndex
from erlvectordb_tpu_torch.parallel import cpu_devices, make_mesh
from erlvectordb_tpu_torch.parallel.ep_cell_probe import EPCellProbeIndex
from erlvectordb_tpu_torch.parallel.mesh import cpu_device_count, set_cpu_device_count

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def eight_cpu_devices():
    held = cpu_device_count()
    set_cpu_device_count(8)
    yield cpu_devices()
    set_cpu_device_count(held)


@pytest.fixture(scope="module")
def setup(eight_cpu_devices):
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((48, 32)).astype(np.float32) * 2
    assign = rng.integers(0, 48, 12000)
    data = (centers[assign]
            + 0.3 * rng.standard_normal((12000, 32)).astype(np.float32))
    dp = np.pad(data, ((0, 0), (0, 96)))  # pad dims to 128
    cp = CellProbeIndex.build(dp, np.arange(12000, dtype=np.int64),
                              cell_rows=48, cell_cap=64, iters=8, device=CPU)
    mesh = make_mesh(n_data=8, n_replica=1, devices=eight_cpu_devices)
    ep = EPCellProbeIndex.from_cell_probe(cp, mesh)
    return data, cp, ep, data[:48]


class TestEPCellProbe:
    def test_recall_parity_with_single_chip(self, setup):
        data, cp, ep, queries = setup
        for metric in ("euclidean", "cosine"):
            _d_s, r_s = cp.search(queries, k=10, nprobe=8, metric=metric)
            _d_e, r_e = ep.search(queries, k=10, nprobe=8, metric=metric)
            overlap = np.mean([
                len(set(r_e[b]) & set(r_s[b][r_s[b] >= 0]))
                / max(1, (r_s[b] >= 0).sum())
                for b in range(queries.shape[0])])
            assert overlap >= 0.9, (metric, overlap)

    def test_dot_results_are_near_optimal(self, setup):
        # dot scores are near-tied across cluster members (spread ~ the
        # bf16 rounding): check containment in the exact top-40
        data, cp, ep, queries = setup
        gt = np.argsort(-(queries @ data.T), axis=1)[:, :40]
        _d_e, r_e = ep.search(queries, k=10, nprobe=8, metric="dot")
        cover = np.mean([len(set(r_e[b][r_e[b] >= 0]) & set(gt[b])) / 10
                         for b in range(queries.shape[0])])
        assert cover >= 0.85, cover

    def test_self_query_top1(self, setup):
        data, cp, ep, queries = setup
        _d, r = ep.search(queries, k=1, nprobe=8, metric="cosine")
        assert np.mean(r[:, 0] == np.arange(queries.shape[0])) >= 0.95

    def test_merge_across_shards(self, setup):
        """The candidates of all 8 shards merge into the answer of the same
        cells held by one device."""
        data, cp, ep, queries = setup
        one = EPCellProbeIndex.from_cell_probe(
            cp, make_mesh(n_data=1, n_replica=1, devices=cpu_devices()[:1]))
        d8, r8 = ep.search(queries, k=10, nprobe=8, metric="cosine")
        d1, r1 = one.search(queries, k=10, nprobe=8, metric="cosine")
        np.testing.assert_array_equal(r8, r1)
        np.testing.assert_array_equal(d8, d1)

    def test_padding_cells_never_win_probes(self, eight_cpu_devices):
        """Shard-count padding fills centroids with 1e6; for dot/cosine an
        unmasked route would rank every pad cell above every real cell."""
        rng = np.random.default_rng(11)
        data = np.abs(rng.standard_normal((900, 128))).astype(np.float32)
        cp = CellProbeIndex.build(data, np.arange(900, dtype=np.int64),
                                  cell_rows=30, cell_cap=40, iters=4,
                                  device=CPU)
        mesh = make_mesh(n_data=8, n_replica=1, devices=eight_cpu_devices)
        ep = EPCellProbeIndex.from_cell_probe(cp, mesh)
        assert ep.n_cells > cp.n_cells  # padding actually exists
        for metric in ("dot", "cosine"):
            d, r = ep.search(data[:8], k=3, nprobe=2, metric=metric)
            assert (r >= 0).all(), (metric, r)
            assert np.isfinite(d).all(), (metric, d)

    def test_shard_padding(self, setup):
        data, cp, ep, queries = setup
        assert ep.n_cells % ep.n_shards == 0
        assert ep.n_cells >= cp.n_cells

    def test_persistence_roundtrip(self, setup):
        data, cp, ep, queries = setup
        arrays = {k: np.asarray(v) for k, v in ep.to_arrays().items()}
        ep2 = EPCellProbeIndex.from_arrays(arrays, ep.mesh)
        _d1, r1 = ep.search(queries[:8], k=5, nprobe=8, metric="cosine")
        _d2, r2 = ep2.search(queries[:8], k=5, nprobe=8, metric="cosine")
        np.testing.assert_array_equal(r1, r2)

    def test_recall_target_calibration(self, setup):
        data, cp, ep, queries = setup
        curve = ep.calibrate_nprobe(n_sample=48, k=5)
        assert max(curve.values()) == 1.0  # deep probe == ceiling
        assert all(0.0 <= v <= 1.0 for v in curve.values())
        assert curve[max(curve)] >= curve[min(curve)]
        _d, r = ep.search(queries[:8], k=5, recall_target=0.8, metric="cosine")
        assert r.shape == (8, 5)
        assert (r[np.arange(8), 0] == np.arange(8)).all()  # self top-1
        with pytest.raises(ValueError):
            ep.nprobe_for(1.5)
        # the curve persists through to_arrays/from_arrays
        arrays = {k: np.asarray(v) for k, v in ep.to_arrays().items()}
        assert "calibrations" in arrays
        ep2 = EPCellProbeIndex.from_arrays(arrays, ep.mesh)
        assert (ep2._calib.get(5, "cosine").curve
                == ep._calib.get(5, "cosine").curve)


class TestIndexManagerEPCellProbe:
    def test_build_search_save_load(self, tmp_path):
        from erlvectordb_tpu_torch.core.index_manager import IndexManager
        from erlvectordb_tpu_torch.core.registry import StoreRegistry

        reg = StoreRegistry(CPU)
        st = reg.create("epcp", metric="cosine")
        rng = np.random.default_rng(9)
        centers = rng.standard_normal((16, 16)).astype(np.float32)
        data = (centers[rng.integers(0, 16, 1200)]
                + 0.2 * rng.standard_normal((1200, 16)).astype(np.float32))
        st.insert_batch([f"v{i}" for i in range(1200)], data)
        im = IndexManager(reg)
        im.create_index("e1", "epcp", "ep_cellprobe",
                        {"cell_rows": 24, "cell_cap": 32, "nprobe": 8})
        info = im.build_index("e1")
        assert info["built"] and not info["error"], info
        assert info["stats"]["kind"] == "ep_cellprobe"
        assert info["stats"]["shards"] == 8
        assert im.search("e1", data[5], k=3)[0][0] == "v5"

        im.save_index("e1", tmp_path)
        im2 = IndexManager(reg)
        assert "e1" in im2.load_indexes(tmp_path)
        assert im2.search("e1", data[7], k=3)[0][0] == "v7"
