"""The port's index manager (core/index_manager.py) and IVF index
(core/ivf.py), on the CPU.

The JAX package's tests/test_index_manager.py (index persistence too: the
port writes each artifact as a generation pair, arrays_<gen>.npz +
meta_<gen>.json, and still reads the JAX package's arrays.npz + meta.json),
tests/test_ivf.py and the index-manager cases of
tests/test_cell_probe.py and tests/test_calibration.py, re-pointed at
erlvectordb_tpu_torch with every store, index and registry on the CPU.  Then
the manager's searches are held to the JAX package's on shared state: the
same store rows, and for the types whose build draws random numbers (pq,
opq, ivf, cellprobe) the JAX-built artifact carried across by its arrays;
the int8 index is deterministic and built by each package.  The bar is
overlap@k >= 0.99 with the JAX manager's answers.
"""

import time

import numpy as np
import pytest
import torch

from erlvectordb_tpu.core import StoreRegistry as JaxRegistry
from erlvectordb_tpu.core.index_manager import IndexManager as JaxManager
from erlvectordb_tpu_torch.api import Database
from erlvectordb_tpu_torch.core import StoreRegistry
from erlvectordb_tpu_torch.core.cell_probe import CellProbeIndex
from erlvectordb_tpu_torch.core.index_manager import IndexError_, IndexManager
from erlvectordb_tpu_torch.core.ivf import IVFIndex
from erlvectordb_tpu_torch.infra.config import load_config
from erlvectordb_tpu_torch.quant import OPQCodebook, PQCodebook

CPU = torch.device("cpu")
torch.set_num_threads(2)


@pytest.fixture
def setup(rng):
    registry = StoreRegistry(CPU)
    store = registry.create("s", metric="euclidean")
    data = rng.standard_normal((600, 32)).astype(np.float32)
    store.insert_batch([f"v{i}" for i in range(600)], data)
    return registry, IndexManager(registry), data


def _cpu_db():
    return Database(load_config(overrides={"persistence_enabled": False},
                                env={}), device=CPU)


class TestRegistry:
    def test_create_and_list(self, setup):
        _, im, _ = setup
        info = im.create_index("i1", "s", "flat")
        assert info["built"]  # flat needs no build
        assert [i["name"] for i in im.list_indexes()] == ["i1"]

    def test_duplicate_rejected(self, setup):
        _, im, _ = setup
        im.create_index("i1", "s", "flat")
        with pytest.raises(IndexError_):
            im.create_index("i1", "s", "flat")

    def test_unknown_type(self, setup):
        _, im, _ = setup
        with pytest.raises(IndexError_):
            im.create_index("i1", "s", "btree")

    def test_unknown_store(self, setup):
        _, im, _ = setup
        with pytest.raises(Exception):
            im.create_index("i1", "ghost", "flat")

    def test_drop(self, setup):
        _, im, _ = setup
        im.create_index("i1", "s", "flat")
        assert im.drop_index("i1")
        assert not im.drop_index("i1")

    @pytest.mark.parametrize("itype", ["ep_ivf", "ep_cellprobe"])
    def test_distributed_types_fail_in_info(self, setup, itype):
        """The mesh-sharded types build over the logical CPU devices (4
        here) with no error in info, and search like the other types: a
        stored row finds itself."""
        from erlvectordb_tpu_torch.parallel.mesh import (
            cpu_device_count,
            set_cpu_device_count,
        )

        _, im, data = setup
        held = cpu_device_count()
        set_cpu_device_count(4)
        try:
            im.create_index("ep", "s", itype,
                            {"n_cells": 16, "cell_rows": 24, "cell_cap": 32,
                             "nprobe": 16, "iters": 4})
            info = im.build_index("ep")
        finally:
            set_cpu_device_count(held)
        assert info["built"] and not info["building"] and info["error"] is None
        assert info["stats"]["kind"] == itype and info["stats"]["shards"] == 4
        assert im.search("ep", data[7], k=3)[0][0] == "v7"
        with pytest.raises(IndexError_, match="not found"):
            im.search("ghost", data[0], k=1)


class TestBuilds:
    def test_int8_build_and_search(self, setup):
        _, im, data = setup
        im.create_index("q8", "s", "int8")
        info = im.build_index("q8")
        assert info["built"] and not info["error"]
        assert info["build_seconds"] is not None
        assert info["stats"]["kind"] == "int8"
        hits = im.search("q8", data[42], k=1)
        assert hits[0][0] == "v42"

    def test_pq_build_and_search(self, setup):
        _, im, data = setup
        im.create_index("pq1", "s", "pq", {"m": 8, "iters": 8})
        info = im.build_index("pq1")
        assert info["built"], info["error"]
        assert info["stats"]["code_bytes_per_vector"] == 8
        hits = im.search("pq1", data[7], k=10)
        assert "v7" in [h[0] for h in hits[:3]]  # PQ is approximate

    def test_pq_recall(self, setup):
        registry, im, data = setup
        im.create_index("pq1", "s", "pq", {"m": 8, "iters": 10})
        im.build_index("pq1")
        store = registry.get("s")
        recalls = []
        for i in range(10):
            exact = {h[0] for h in store.search(data[i], k=10)}
            approx = {h[0] for h in im.search("pq1", data[i], k=10)}
            recalls.append(len(exact & approx) / 10)
        assert np.mean(recalls) >= 0.5  # small random corpus, modest bar

    def test_async_build(self, setup):
        _, im, data = setup
        im.create_index("q8", "s", "int8")
        info = im.build_index("q8", wait=False)
        deadline = time.time() + 30
        while time.time() < deadline:
            info = im.get_index_info("q8")
            if info["built"] or info["error"]:
                break
            time.sleep(0.02)
        assert info["built"]

    def test_staleness(self, setup):
        registry, im, data = setup
        im.create_index("q8", "s", "int8")
        im.build_index("q8")
        assert not im.is_stale("q8")
        registry.get("s").insert("new", np.ones(32, np.float32))
        assert im.is_stale("q8")
        im.build_index("q8")  # rebuild clears staleness
        assert not im.is_stale("q8")

    def test_probe_knob_overrides(self, setup):
        """Per-request nprobe / recall_target override the build-time probe
        width on probed index families; non-probed types reject them."""
        _, im, data = setup
        im.create_index("cp1", "s", "cellprobe", {"nprobe": 2})
        info = im.build_index("cp1")
        assert info["built"], info["error"]
        hits = im.search("cp1", data[11], k=3, nprobe=8)
        assert hits[0][0] == "v11"
        # recall_target lazily calibrates, then answers correctly
        hits = im.search("cp1", data[23], k=3, recall_target=0.9)
        assert hits[0][0] == "v23"
        with pytest.raises(ValueError, match="not both"):
            im.search("cp1", data[0], k=1, nprobe=4, recall_target=0.9)
        # ivf takes nprobe but not recall_target
        im.create_index("iv1", "s", "ivf", {"nprobe": 2})
        assert im.build_index("iv1")["built"]
        assert im.search("iv1", data[5], k=3, nprobe=8)[0][0] == "v5"
        with pytest.raises(ValueError, match="cellprobe-family"):
            im.search("iv1", data[0], k=1, recall_target=0.9)
        # non-probed types reject both knobs
        im.create_index("q8k", "s", "int8")
        im.build_index("q8k")
        with pytest.raises(ValueError, match="no probe knob"):
            im.search("q8k", data[0], k=1, nprobe=4)

    def test_build_empty_store_fails(self, setup):
        registry, im, _ = setup
        registry.create("empty", dim=4)
        im.create_index("e1", "empty", "int8")
        info = im.build_index("e1")
        assert not info["built"]
        assert "empty" in info["error"]

    def test_search_unbuilt_fails(self, setup):
        _, im, data = setup
        im.create_index("q8", "s", "int8")
        with pytest.raises(IndexError_):
            im.search("q8", data[0], k=1)


class TestDatabaseIntegration:
    def test_facade_verbs(self, rng):
        db = _cpu_db()
        db.create_store("s1")
        data = rng.standard_normal((300, 16)).astype(np.float32)
        db.insert_batch("s1", [f"v{i}" for i in range(300)], data)
        db.create_index("idx", "s1", "int8")
        db.build_index("idx")
        hits = db.search_index("idx", data[5], k=1)
        assert hits[0][0] == "v5"
        assert db.get_index_info("idx")["built"]
        assert [i["name"] for i in db.list_indexes()] == ["idx"]
        assert db.drop_index("idx")


class TestOPQIndex:
    def test_opq_build_and_search(self, setup):
        _, im, data = setup
        im.create_index("opq1", "s", "opq", {"m": 8, "iters": 8, "opq_iters": 2})
        info = im.build_index("opq1")
        assert info["built"], info["error"]
        assert info["stats"]["kind"] == "opq"
        hits = im.search("opq1", data[7], k=10)
        assert "v7" in [h[0] for h in hits[:3]]


class TestIndexPersistence:
    def test_save_load_roundtrip(self, setup, tmp_path):
        registry, im, data = setup
        im.create_index("p8", "s", "int8")
        im.build_index("p8")
        im.create_index("ppq", "s", "pq", {"m": 8, "iters": 6})
        im.build_index("ppq")
        im.save_all(tmp_path)
        im2 = IndexManager(registry)
        loaded = im2.load_indexes(tmp_path)
        assert set(loaded) == {"p8", "ppq"}
        assert im2.search("p8", data[42], k=1)[0][0] == "v42"
        hits = im2.search("ppq", data[7], k=5)
        assert "v7" in [h[0] for h in hits]

    def test_load_skips_missing_store(self, setup, tmp_path):
        registry, im, _ = setup
        im.create_index("p8", "s", "int8")
        im.build_index("p8")
        im.save_all(tmp_path)
        im2 = IndexManager(StoreRegistry(CPU))  # store 's' absent
        assert im2.load_indexes(tmp_path) == []

    def test_load_pre_norms_artifact(self, setup, tmp_path):
        """int8 artifacts saved before norms/valid were persisted
        re-hydrate from the live store instead of raising KeyError and
        aborting Database.start().  (The arrays are rewritten in place
        with their __saved_at__ echo, so the pair stays consistent.)"""
        registry, im, data = setup
        im.create_index("old8", "s", "int8")
        im.build_index("old8")
        im.save_all(tmp_path)
        [npz] = (tmp_path / "idx_old8").glob("arrays_*.npz")
        with np.load(npz) as z:
            arrays = {k: z[k] for k in z.files}
        arrays.pop("norms")
        arrays.pop("valid")
        np.savez(npz, **arrays)
        im2 = IndexManager(registry)
        assert im2.load_indexes(tmp_path) == ["old8"]
        assert im2.search("old8", data[42], k=1)[0][0] == "v42"

    def test_load_skips_corrupt_artifact(self, setup, tmp_path):
        """One unreadable artifact must not abort loading the others."""
        registry, im, data = setup
        im.create_index("good8", "s", "int8")
        im.build_index("good8")
        im.save_all(tmp_path)
        bad = tmp_path / "idx_bad"
        bad.mkdir()
        (bad / "meta.json").write_text('{"name": "bad", "store": "s", ')
        im2 = IndexManager(registry)
        assert im2.load_indexes(tmp_path) == ["good8"]

    def test_database_persists_indexes(self, rng, tmp_path):
        cfg = load_config(overrides={
            "persistence_dir": str(tmp_path / "data"),
            "backup_dir": str(tmp_path / "backups"),
            "sync_interval": 9999,
        }, env={})
        db = Database(cfg, device=CPU).start()
        db.create_store("ps")
        data = rng.standard_normal((200, 16)).astype(np.float32)
        db.insert_batch("ps", [f"v{i}" for i in range(200)], data)
        db.sync("ps")
        db.create_index("pidx", "ps", "int8")
        db.build_index("pidx")  # saved automatically
        db.stop()
        db2 = Database(cfg, device=CPU).start()
        try:
            assert db2.get_index_info("pidx")["built"]
            assert db2.search_index("pidx", data[3], k=1)[0][0] == "v3"
        finally:
            db2.stop()

    @pytest.mark.parametrize("itype", ["int8", "pq", "opq", "ivf", "cellprobe"])
    def test_every_type_answers_the_same_after_reload(self, setup, tmp_path,
                                                      itype):
        registry, im, data = setup
        params = {"pq": {"m": 8, "iters": 4}, "opq": {"m": 8, "iters": 4,
                                                       "opq_iters": 2},
                  "ivf": {"n_cells": 8}, "cellprobe": {"cell_rows": 32,
                                                        "cell_cap": 48}}
        im.create_index("x", "s", itype, params.get(itype))
        assert im.build_index("x")["built"]
        before = [im.search("x", q, k=5) for q in data[:20]]
        im.save_index("x", tmp_path)
        im2 = IndexManager(registry)
        assert im2.load_indexes(tmp_path) == ["x"]
        assert [im2.search("x", q, k=5) for q in data[:20]] == before

    def test_generation_pair_survives_a_torn_save(self, setup, tmp_path):
        """A newer generation whose meta landed without its arrays (or with
        a truncated npz) is skipped: the previous pair loads.  Each save
        leaves exactly one pair."""
        registry, im, data = setup
        im.create_index("g8", "s", "int8")
        im.build_index("g8")
        im.save_index("g8", tmp_path)
        im.save_index("g8", tmp_path)
        idir = tmp_path / "idx_g8"
        [meta] = idir.glob("meta_*.json")
        [npz] = idir.glob("arrays_*.npz")
        assert meta.name == "meta_00000002.json"
        (idir / "meta_00000003.json").write_text(meta.read_text())
        (idir / "arrays_00000004.npz").write_bytes(npz.read_bytes()[:100])
        (idir / "meta_00000004.json").write_text(meta.read_text())
        im2 = IndexManager(registry)
        assert im2.load_indexes(tmp_path) == ["g8"]
        assert im2.search("g8", data[9], k=1)[0][0] == "v9"

    @pytest.mark.parametrize("itype", ["int8", "pq", "ivf", "cellprobe"])
    def test_jax_written_artifact_loads(self, rng, tmp_path, itype):
        """An artifact the JAX package saved (arrays.npz + meta.json) loads
        in the port over the same store rows and answers as the JAX
        manager does."""
        data = rng.standard_normal((600, 32)).astype(np.float32)
        ids = [f"v{i}" for i in range(600)]
        jreg = JaxRegistry()
        jreg.create("s", metric="euclidean").insert_batch(ids, data)
        jm = JaxManager(jreg)
        params = {"pq": {"m": 8, "iters": 4}, "ivf": {"n_cells": 8},
                  "cellprobe": {"cell_rows": 32, "cell_cap": 48}}
        jm.create_index("j", "s", itype, params.get(itype))
        assert jm.build_index("j")["built"]
        jm.save_all(tmp_path)
        assert (tmp_path / "idx_j" / "arrays.npz").exists()
        reg = StoreRegistry(CPU)
        reg.create("s", metric="euclidean").insert_batch(ids, data)
        tm = IndexManager(reg)
        assert tm.load_indexes(tmp_path) == ["j"]
        for q in data[:12]:
            assert ([h[0] for h in tm.search("j", q, k=5)]
                    == [h[0] for h in jm.search("j", q, k=5)])


class TestIndexHardening:
    def test_int8_index_survives_store_growth(self):
        """The int8 index scores build-time codes against its own snapshot
        of norms/valid, not the live store's (which a capacity grow
        reshapes)."""
        reg = StoreRegistry(CPU)
        st = reg.create("g8", metric="cosine")
        rng = np.random.default_rng(0)
        data = rng.standard_normal((900, 8)).astype(np.float32)
        st.insert_batch([f"v{i}" for i in range(900)], data)
        im = IndexManager(reg)
        im.create_index("gi", "g8", "int8")
        info = im.build_index("gi")
        assert info["built"], info
        st.insert("x0", rng.standard_normal(8).astype(np.float32))
        assert im.search("gi", data[5], k=1)[0][0] == "v5"
        more = rng.standard_normal((2000, 8)).astype(np.float32)
        st.insert_batch([f"w{i}" for i in range(2000)], more)
        assert im.search("gi", data[5], k=1)[0][0] == "v5"

    def test_int8_index_rejects_packed_stores(self):
        """Building an int8 index over an int4 store would quantize the
        packed nibble bytes as float rows — a silently garbage index."""
        reg = StoreRegistry(CPU)
        st = reg.create("p4", dtype="int4")
        rng = np.random.default_rng(1)
        st.insert_batch([f"v{i}" for i in range(100)],
                        rng.standard_normal((100, 8)).astype(np.float32))
        im = IndexManager(reg)
        im.create_index("bad8", "p4", "int8")
        info = im.build_index("bad8")
        assert not info["built"]
        assert "float32" in (info["error"] or "")

    def test_delete_store_drops_dependent_indexes(self):
        db = _cpu_db()
        db.create_store("ds")
        rng = np.random.default_rng(2)
        db.insert_batch("ds", [f"v{i}" for i in range(64)],
                        rng.standard_normal((64, 8)).astype(np.float32))
        db.create_index("dsi", "ds", "flat")
        assert db.delete_store("ds")
        assert db.indexes.get_index_info("dsi") is None


# ------------------------------------------------------------------- IVF


@pytest.fixture(scope="module")
def ivf_built():
    rng = np.random.default_rng(0)
    n, d, n_centers = 4000, 32, 40
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * 4
    assign = rng.integers(0, n_centers, n)
    data = (centers[assign]
            + 0.3 * rng.standard_normal((n, d)).astype(np.float32))
    rows = np.arange(n, dtype=np.int64)
    norms = np.linalg.norm(data, axis=1).astype(np.float32)
    idx = IVFIndex.build(data, rows, norms, n_cells=64, iters=12, device=CPU)
    queries = (centers[rng.integers(0, n_centers, 25)]
               + 0.3 * rng.standard_normal((25, d)).astype(np.float32))
    return data, rows, norms, idx, queries


def _exact(data, queries, k):
    return np.asarray([np.argsort(np.linalg.norm(data - q, axis=1))[:k]
                       for q in queries])


class TestIVF:
    def test_all_rows_placed(self, ivf_built):
        data, _, _, idx, _ = ivf_built
        st = idx.stats()
        assert st["rows"] == data.shape[0]
        assert st["n_cells"] == 64
        assert idx.cells.shape[0] == 64 and idx.cells.shape[1] % 8 == 0

    def test_recall_increases_with_nprobe(self, ivf_built):
        data, _, _, idx, queries = ivf_built
        k = 10
        gt = _exact(data, queries, k)

        def recall(nprobe):
            _, rows = idx.search(queries, k=k, nprobe=nprobe)
            return np.mean([len(set(gt[i]) & set(rows[i])) / k
                            for i in range(len(queries))])

        r2, r8, r32 = recall(2), recall(8), recall(32)
        assert r8 >= r2 - 0.05
        assert r32 >= r8 - 0.02
        assert r8 >= 0.7, (r2, r8, r32)
        assert r32 >= 0.9, (r2, r8, r32)

    def test_distances_sorted_and_valid(self, ivf_built):
        _, _, _, idx, queries = ivf_built
        dists, rows = idx.search(queries[:5], k=8, nprobe=8)
        for i in range(5):
            d = dists[i][np.isfinite(dists[i])]
            assert np.all(np.diff(d) >= -1e-4)
            valid_rows = rows[i][rows[i] >= 0]
            assert len(set(valid_rows.tolist())) == len(valid_rows)

    def test_single_query_and_cosine(self, ivf_built):
        data, _, _, idx, _ = ivf_built
        dists, rows = idx.search(data[77], k=1, nprobe=8)
        assert rows[0][0] == 77
        assert dists[0][0] == pytest.approx(0.0, abs=1e-2)
        dists, rows = idx.search(data[5], k=1, nprobe=16, metric="cosine")
        assert rows[0][0] == 5
        assert dists[0][0] == pytest.approx(0.0, abs=1e-3)

    @pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot"])
    def test_search_matches_jax_on_shared_cells(self, ivf_built, metric):
        """The JAX package's IVF over the same cells (to_arrays ->
        from_arrays both ways): the same rows, including the routed
        dispatch's bucket drops at a batch large enough to overflow q_cap."""
        from erlvectordb_tpu.core.ivf import IVFIndex as JaxIVF

        data, rows, norms, idx, queries = ivf_built
        jidx = JaxIVF.from_arrays(idx.to_arrays())
        qs = np.concatenate([queries, data[:200]])
        for nprobe in (1, 8):
            dj, rj = jidx.search(qs, k=10, nprobe=nprobe, metric=metric)
            dt, rt = idx.search(qs, k=10, nprobe=nprobe, metric=metric)
            assert (rt == rj).mean() >= 0.99
            same = rt == rj
            # euclidean compares squares: |q|^2 - 2 q.x + |x|^2 over terms of
            # ~10^3 leaves ~10^-4 of rounding, which the square root of a
            # near-zero distance (a query's own row) magnifies
            sq = (lambda v: v * v) if metric == "euclidean" else (lambda v: v)
            np.testing.assert_allclose(sq(dt[same]), sq(dj[same]), rtol=1e-4,
                                       atol=2e-3)
        back = IVFIndex.from_arrays(jidx.to_arrays(), device=CPU)
        np.testing.assert_array_equal(back.search(qs, k=5)[1],
                                      idx.search(qs, k=5)[1])

    def test_ivf_through_manager(self, rng):
        registry = StoreRegistry(CPU)
        store = registry.create("s", metric="euclidean")
        centers = rng.standard_normal((16, 16)).astype(np.float32) * 4
        assign = rng.integers(0, 16, 800)
        data = centers[assign] + 0.2 * rng.standard_normal((800, 16)).astype(np.float32)
        store.insert_batch([f"v{i}" for i in range(800)], data)
        im = IndexManager(registry)
        im.create_index("ivf1", "s", "ivf", {"n_cells": 16, "nprobe": 8})
        info = im.build_index("ivf1")
        assert info["built"], info["error"]
        assert info["stats"]["kind"] == "ivf"
        hits = im.search("ivf1", data[42], k=3)
        assert hits[0][0] == "v42"


# ------------------------------------------- the cellprobe (hnsw) slot


def _clustered(n, d, n_centers=32, noise=0.25, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    return (centers[rng.integers(0, n_centers, n)]
            + noise * rng.standard_normal((n, d)).astype(np.float32)), centers


class TestCellProbeSlot:
    @pytest.mark.parametrize("itype", ["hnsw", "cellprobe"])
    def test_build_and_search(self, itype):
        reg = StoreRegistry(CPU)
        st = reg.create("hs", metric="cosine")
        data, _ = _clustered(1500, 16, seed=5)
        st.insert_batch([f"v{i}" for i in range(len(data))], data)
        im = IndexManager(reg)
        im.create_index(f"i_{itype}", "hs", itype,
                        {"cell_rows": 32, "cell_cap": 40, "nprobe": 8})
        info = im.build_index(f"i_{itype}")
        assert info["built"] and not info["error"], info
        assert info["stats"]["kind"] == "cell_probe"
        hits = im.search(f"i_{itype}", data[9], k=5)
        assert hits[0][0] == "v9"


class TestIndexManagerCalibrate:
    @pytest.fixture()
    def mgr(self):
        reg = StoreRegistry(CPU)
        st = reg.create("imx", metric="cosine")
        data, centers = _clustered(6_000, 16, n_centers=40, seed=11)
        rng = np.random.default_rng(12)
        held = (centers[rng.integers(0, 40, 64)]
                + 0.25 * rng.standard_normal((64, 16)).astype(np.float32))
        st.insert_batch([str(i) for i in range(len(data))], data)
        mgr = IndexManager(reg)
        mgr.create_index("cp", "imx", "cellprobe", {"cell_rows": 48})
        mgr.build_index("cp", wait=True)
        return mgr, held

    def test_exact_calibration_from_store_rows(self, mgr):
        m, held = mgr
        out = m.calibrate_index("cp", queries=held, k=10, mode="exact")
        assert out["mode"] == "exact" and 0 < out["ceiling"] <= 1.0
        assert out["curve"]
        info = m.get_index_info("cp")
        assert info["calibration"][0]["mode"] == "exact"

    def test_ceiling_mode_and_bad_modes(self, mgr):
        m, held = mgr
        out = m.calibrate_index("cp", k=5, mode="ceiling")
        assert out["mode"] == "ceiling" and out["ceiling"] == 1.0
        with pytest.raises(ValueError):
            m.calibrate_index("cp", mode="bogus")

    def test_non_cellprobe_rejected(self, mgr):
        m, held = mgr
        m.create_index("fl", "imx", "flat")
        with pytest.raises(ValueError):
            m.calibrate_index("fl")


# --------------------------------------------- parity on shared state


@pytest.fixture(scope="module")
def shared():
    """The same 2,000 clustered rows in a JAX store and a port store, each
    under its package's manager."""
    data, centers = _clustered(2000, 32, n_centers=24, seed=9)
    rng = np.random.default_rng(10)
    queries = (centers[rng.integers(0, 24, 24)]
               + 0.25 * rng.standard_normal((24, 32)).astype(np.float32))
    ids = [f"v{i}" for i in range(len(data))]
    jreg, treg = JaxRegistry(), StoreRegistry(CPU)
    for reg in (jreg, treg):
        reg.create("s", metric="euclidean").insert_batch(ids, data)
    return JaxManager(jreg), IndexManager(treg), queries


def _carry(jinfo, tm, name):
    """The JAX-built artifact into the port manager's descriptor."""
    a, t = jinfo.artifact, jinfo.type
    if t in ("pq", "opq"):
        cls = OPQCodebook if t == "opq" else PQCodebook
        art = {"codebook": cls.from_arrays(a["codebook"].to_arrays(),
                                           device=CPU),
               "codes": torch.from_numpy(np.array(a["codes"])),
               "rows": np.asarray(a["rows"]), "pad_dim": a["pad_dim"]}
    elif t == "ivf":
        art = {"ivf": IVFIndex.from_arrays(a["ivf"].to_arrays(), device=CPU),
               "nprobe": a["nprobe"]}
    else:
        art = {"cell_probe": CellProbeIndex.from_arrays(
            a["cell_probe"].to_arrays(), device=CPU), "nprobe": a["nprobe"]}
    info = tm._indexes[name]
    info.artifact, info.built = art, True
    info.built_version = tm._registry.get(info.store).version


@pytest.mark.parametrize("itype,params", [
    ("int8", {}),
    ("pq", {"m": 8, "iters": 6}),
    ("opq", {"m": 8, "iters": 6, "opq_iters": 2}),
    ("ivf", {"n_cells": 16, "nprobe": 4}),
    ("cellprobe", {"cell_rows": 48, "cell_cap": 64, "nprobe": 8}),
])
def test_manager_search_matches_jax(shared, itype, params):
    jm, tm, queries = shared
    name = f"p_{itype}"
    for m in (jm, tm):
        m.create_index(name, "s", itype, params)
    assert jm.build_index(name)["built"]
    if itype == "int8":   # deterministic: each package builds its own
        assert tm.build_index(name)["built"]
    else:
        _carry(jm._indexes[name], tm, name)
    got, want = [], []
    for q in queries:
        hj, ht = jm.search(name, q, k=10), tm.search(name, q, k=10)
        want.append([h[0] for h in hj])
        got.append([h[0] for h in ht])
        # squared euclidean distances (see the IVF parity test)
        same = [(a[2] ** 2, b[2] ** 2) for a, b in zip(ht, hj) if a[0] == b[0]]
        np.testing.assert_allclose(*zip(*same), rtol=1e-4, atol=2e-3)
    overlap = np.mean([len(set(g) & set(w)) / 10 for g, w in zip(got, want)])
    assert overlap >= 0.99, overlap
