"""tests/test_ep_ivf.py re-pointed at the port's expert-parallel IVF
(erlvectordb_tpu_torch/parallel/ep_ivf.py) on 8 logical CPU devices:
recall parity with the single-device IVF, self-query top-1, the merge of
the shards' candidates, stats and cell-count rounding, the direct build and
the index-manager integration with persistence."""

import numpy as np
import pytest
import torch

from erlvectordb_tpu_torch.core.ivf import IVFIndex
from erlvectordb_tpu_torch.parallel import cpu_devices, make_mesh
from erlvectordb_tpu_torch.parallel.ep_ivf import EPIVFIndex
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
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((64, 32)).astype(np.float32) * 2
    assign = rng.integers(0, 64, 20000)
    data = (centers[assign]
            + 0.4 * rng.standard_normal((20000, 32)).astype(np.float32))
    rows = np.arange(20000, dtype=np.int32)
    norms = np.linalg.norm(data, axis=1).astype(np.float32)
    ivf = IVFIndex.build(data, rows, norms, n_cells=64, iters=10, device=CPU)
    mesh = make_mesh(n_data=8, n_replica=1, devices=eight_cpu_devices)
    ep = EPIVFIndex.from_ivf(ivf, mesh)
    return data, norms, ivf, ep, data[:64]


class TestEPIVF:
    def test_recall_parity_with_single_chip(self, setup):
        data, norms, ivf, ep, queries = setup
        for metric in ("euclidean", "cosine"):
            _d_s, r_s = ivf.search(queries, k=10, nprobe=8, metric=metric)
            _d_e, r_e = ep.search(queries, k=10, nprobe=8, metric=metric)
            # EP never drops (query, cell) pairs (no q_cap), so it covers at
            # least the single-device results
            overlap = np.mean([
                len(set(r_e[b]) & set(r_s[b][r_s[b] >= 0]))
                / max(1, (r_s[b] >= 0).sum())
                for b in range(queries.shape[0])])
            assert overlap >= 0.95, (metric, overlap)

    def test_self_query_top1(self, setup):
        data, norms, ivf, ep, queries = setup
        _d, r = ep.search(queries, k=1, nprobe=8, metric="euclidean")
        assert np.mean(r[:, 0] == np.arange(queries.shape[0])) >= 0.95

    def test_merge_across_shards(self, setup):
        """The candidates of all 8 shards merge into the answer of the same
        cells held by one device, and the answer draws on several shards."""
        data, norms, ivf, ep, queries = setup
        one = EPIVFIndex.from_ivf(ivf, make_mesh(n_data=1, n_replica=1,
                                                 devices=cpu_devices()[:1]))
        d8, r8 = ep.search(queries, k=10, nprobe=8, metric="euclidean")
        d1, r1 = one.search(queries, k=10, nprobe=8, metric="euclidean")
        np.testing.assert_array_equal(r8, r1)
        np.testing.assert_array_equal(d8, d1)
        owner = {int(r): c // ep.c_local for c, cell in
                 enumerate(ep.to_arrays()["cell_rows"]) for r in cell if r >= 0}
        assert len({owner[int(r)] for r in r8.reshape(-1) if r >= 0}) > 1

    def test_stats_and_build_rounding(self, setup):
        data, norms, ivf, ep, queries = setup
        st = ep.stats()
        assert st["shards"] == 8
        assert st["n_cells"] % 8 == 0
        assert st["rows"] == 20000

    def test_build_direct(self, setup, eight_cpu_devices):
        data, norms, ivf, ep, queries = setup
        mesh = make_mesh(n_data=8, n_replica=1, devices=eight_cpu_devices)
        ep2 = EPIVFIndex.build(data, np.arange(20000, dtype=np.int32), norms,
                               mesh, n_cells=60)  # rounds to 64
        assert ep2.n_cells % 8 == 0
        _d, r = ep2.search(queries[:8], k=5, nprobe=6)
        assert (r >= 0).all()


class TestIndexManagerIntegration:
    def test_ep_ivf_through_index_manager(self, rng, tmp_path):
        from erlvectordb_tpu_torch.core import StoreRegistry
        from erlvectordb_tpu_torch.core.index_manager import IndexManager
        from erlvectordb_tpu_torch.core.store import VectorStore

        reg = StoreRegistry(CPU)
        data = rng.standard_normal((4000, 16)).astype(np.float32)
        st = VectorStore.from_matrix("epstore", data,
                                     ids=[f"v{i}" for i in range(4000)],
                                     metric="euclidean", device=CPU)
        reg.adopt(st)
        im = IndexManager(reg)
        im.create_index("epi", "epstore", "ep_ivf", {"n_cells": 32, "nprobe": 8})
        info = im.build_index("epi", wait=True)
        assert info["built"] and info["stats"]["kind"] == "ep_ivf"
        assert info["stats"]["shards"] == 8
        assert im.search("epi", data[7], k=3)[0][0] == "v7"
        # persistence roundtrip
        im.save_index("epi", tmp_path)
        im2 = IndexManager(reg)
        assert im2.load_indexes(tmp_path) == ["epi"]
        assert im2.search("epi", data[7], k=3)[0][0] == "v7"
