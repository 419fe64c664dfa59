"""tests/test_sharding.py re-pointed at the port (erlvectordb_tpu_torch/
parallel/) on 8 logical CPU devices: multi-shard exact search with the
candidate merge, replica-split query batches, mutation and growth,
distribution and migration, sharded snapshots, the fused local scan against
the exact one, the dim-sharded (tensor-parallel) search and store, the
streaming build and the hardening regressions.

The reference store is the port's single-device VectorStore on the CPU;
the JAX package's own tests hold its stores to the same bars."""

import numpy as np
import pytest
import torch

from erlvectordb_tpu_torch.core import VectorStore
from erlvectordb_tpu_torch.parallel import (
    ShardedVectorStore,
    cpu_devices,
    make_mesh,
    mesh_shape,
)
from erlvectordb_tpu_torch.parallel.mesh import cpu_device_count, set_cpu_device_count

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def eight_cpu_devices():
    """8 logical CPU devices, the counterpart of the JAX tests' virtual
    CPU platform."""
    held = cpu_device_count()
    set_cpu_device_count(8)
    yield cpu_devices()
    set_cpu_device_count(held)


@pytest.fixture(scope="module")
def mesh8(eight_cpu_devices):
    return make_mesh(n_data=8, n_replica=1, devices=eight_cpu_devices)


@pytest.fixture(scope="module")
def mesh4x2(eight_cpu_devices):
    return make_mesh(n_data=4, n_replica=2, devices=eight_cpu_devices)


class TestMesh:
    def test_shape(self, mesh8, mesh4x2):
        assert mesh_shape(mesh8) == {"replica": 1, "data": 8, "devices": 8}
        assert mesh_shape(mesh4x2) == {"replica": 2, "data": 4, "devices": 8}

    def test_bad_factorization(self, eight_cpu_devices):
        with pytest.raises(ValueError):
            make_mesh(n_data=5, n_replica=3, devices=eight_cpu_devices)


class TestShardedExactness:
    def test_matches_single_device_store(self, mesh8, rng):
        n, d, k, nq = 3000, 32, 10, 16
        data = rng.standard_normal((n, d)).astype(np.float32)
        ids = [f"v{i}" for i in range(n)]
        qs = rng.standard_normal((nq, d)).astype(np.float32)

        ref = VectorStore("ref", metric="cosine", device=CPU)
        ref.insert_batch(ids, data)
        sh = ShardedVectorStore("sh", mesh8, metric="cosine")
        sh.insert_batch(ids, data)
        assert sh.count == n

        for a, b in zip(ref.search_batch(qs, k=k), sh.search_batch(qs, k=k)):
            assert [x[0] for x in a] == [y[0] for y in b]
            np.testing.assert_allclose([x[2] for x in a], [y[2] for y in b],
                                       atol=1e-4)

    @pytest.mark.parametrize("metric", ["euclidean", "manhattan", "dot"])
    def test_other_metrics(self, mesh8, rng, metric):
        n, d, k = 800, 16, 5
        data = rng.standard_normal((n, d)).astype(np.float32)
        ids = [f"v{i}" for i in range(n)]
        ref = VectorStore("ref", metric=metric, device=CPU)
        ref.insert_batch(ids, data)
        sh = ShardedVectorStore("sh", mesh8, metric=metric)
        sh.insert_batch(ids, data)
        q = rng.standard_normal(d).astype(np.float32)
        assert ([x[0] for x in ref.search(q, k=k)]
                == [y[0] for y in sh.search(q, k=k)])

    def test_replica_mesh_matches(self, mesh4x2, rng):
        n, d, k, nq = 1000, 24, 7, 10  # nq not divisible by replicas: pads
        data = rng.standard_normal((n, d)).astype(np.float32)
        ids = [f"v{i}" for i in range(n)]
        ref = VectorStore("ref", device=CPU)
        ref.insert_batch(ids, data)
        sh = ShardedVectorStore("sh", mesh4x2)
        sh.insert_batch(ids, data)
        qs = rng.standard_normal((nq, d)).astype(np.float32)
        for a, b in zip(ref.search_batch(qs, k=k), sh.search_batch(qs, k=k)):
            assert [x[0] for x in a] == [y[0] for y in b]

    def test_int8_sharded(self, mesh8, rng):
        n, d = 1000, 32
        data = rng.standard_normal((n, d)).astype(np.float32)
        sh = ShardedVectorStore("sh", mesh8, dtype="int8")
        sh.insert_batch([f"v{i}" for i in range(n)], data)
        assert sh.search(data[123], k=1)[0][0] == "v123"


class TestShardedMutation:
    def test_delete_and_overwrite(self, mesh8, rng):
        data = rng.standard_normal((50, 8)).astype(np.float32)
        sh = ShardedVectorStore("sh", mesh8)
        sh.insert_batch([f"v{i}" for i in range(50)], data)
        assert sh.delete("v7")
        assert not sh.delete("v7")
        assert sh.count == 49
        assert "v7" not in [r[0] for r in sh.search(data[7], k=50)]
        sh.insert("v3", np.ones(8, np.float32), {"new": True})
        vec, meta = sh.get("v3")
        assert meta == {"new": True}
        np.testing.assert_allclose(vec, np.ones(8), atol=1e-6)
        assert sh.count == 49

    def test_growth_across_shards(self, mesh8, rng):
        # exceed MIN_SHARD_CAPACITY * 8 to force per-shard growth
        n, d = 3000, 8
        data = rng.standard_normal((n, d)).astype(np.float32)
        sh = ShardedVectorStore("sh", mesh8)
        sh.insert_batch([f"v{i}" for i in range(n)], data)
        assert sh.count == n
        assert sh.search(data[2500], k=1)[0][0] == "v2500"

    def test_balance(self, mesh8, rng):
        data = rng.standard_normal((80, 4)).astype(np.float32)
        sh = ShardedVectorStore("sh", mesh8)
        sh.insert_batch([f"v{i}" for i in range(80)], data)
        counts = sh.get_stats()["per_shard_counts"]
        assert max(counts) - min(counts) <= 1  # round-robin balance


class TestMigration:
    def test_distribute_and_collapse(self, mesh8, rng):
        data = rng.standard_normal((300, 16)).astype(np.float32)
        local = VectorStore("m", metric="euclidean", device=CPU)
        local.insert_batch([f"v{i}" for i in range(300)], data,
                           [{"i": i} for i in range(300)])
        sharded = ShardedVectorStore.from_store(local, mesh8)
        assert sharded.count == 300
        assert sharded.metric == "euclidean"
        assert sharded.search(data[42], k=1)[0][0] == "v42"
        back = sharded.to_store("m2")
        assert back.count == 300 and back.device == CPU
        assert back.search(data[42], k=1)[0][0] == "v42"
        assert back.get("v5")[1] == {"i": 5}


class TestShardedPersistence:
    def test_snapshot_roundtrip_same_mesh(self, mesh8, rng, tmp_path):
        from erlvectordb_tpu_torch.persist.snapshot import load_store, save_store

        data = rng.standard_normal((200, 16)).astype(np.float32)
        sh = ShardedVectorStore("shp", mesh8, metric="euclidean")
        sh.insert_batch([f"v{i}" for i in range(200)], data,
                        [{"i": i} for i in range(200)])
        sh.delete("v5")
        save_store(sh, tmp_path)
        loaded = load_store("shp", tmp_path, device=CPU, mesh=mesh8)
        assert isinstance(loaded, ShardedVectorStore)
        assert loaded.count == 199
        assert loaded.metric == "euclidean"
        assert loaded.search(data[42], k=1)[0][0] == "v42"
        assert loaded.get("v5") is None
        assert loaded.get("v7")[1] == {"i": 7}

    def test_snapshot_reshards_onto_different_mesh(self, mesh8, mesh4x2, rng,
                                                   tmp_path):
        from erlvectordb_tpu_torch.persist.snapshot import load_store, save_store

        data = rng.standard_normal((100, 8)).astype(np.float32)
        sh = ShardedVectorStore("shp2", mesh8)  # 8 data shards
        sh.insert_batch([f"v{i}" for i in range(100)], data)
        save_store(sh, tmp_path)
        loaded = load_store("shp2", tmp_path, device=CPU, mesh=mesh4x2)
        assert loaded.n_shards == 4
        assert loaded.count == 100
        assert loaded.search(data[3], k=1)[0][0] == "v3"

    def test_int8_sharded_snapshot(self, mesh8, rng, tmp_path):
        from erlvectordb_tpu_torch.persist.snapshot import load_store, save_store

        data = rng.standard_normal((150, 16)).astype(np.float32)
        sh = ShardedVectorStore("shq", mesh8, dtype="int8")
        sh.insert_batch([f"v{i}" for i in range(150)], data)
        save_store(sh, tmp_path)
        loaded = load_store("shq", tmp_path, device=CPU, mesh=mesh8)
        assert loaded.dtype == "int8"
        assert loaded.search(data[9], k=1)[0][0] == "v9"


class TestFusedInShardMap:
    def test_fused_local_scan_matches_xla(self, mesh8, rng, monkeypatch):
        """The fused local scan (the kernels' plain versions on the CPU,
        forced through the store's dispatch) agrees with the exact scan."""
        import erlvectordb_tpu_torch.ops.fused_topk as ft

        cap, d, b, k = ft.TILE_N, 128, 8, 8
        n_live = ft.TILE_N - 100
        data = rng.standard_normal((8 * n_live, d)).astype(np.float32)
        sh = ShardedVectorStore("fz", mesh8)
        sh.insert_batch([f"v{i}" for i in range(len(data))], data)
        assert sh._cap == cap
        q = rng.standard_normal((b, d)).astype(np.float32)
        want = sh.search_batch(q, k=k)
        monkeypatch.setattr(ft, "fused_topk_available", lambda *a, **kw: True)
        got = sh.search_batch(q, k=k)
        for g, w in zip(got, want):
            assert len({h[0] for h in g} & {h[0] for h in w}) >= k - 1
        np.testing.assert_allclose([g[0][2] for g in got],
                                   [w[0][2] for w in want], atol=1e-4)


class TestDimSharded:
    """Feature-dimension (tensor-parallel) sharding: partial dots added in
    shard order."""

    @pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot", "manhattan"])
    def test_matches_exact(self, rng, metric, eight_cpu_devices):
        from erlvectordb_tpu_torch.core.search import exact_topk
        from erlvectordb_tpu_torch.parallel.dim_sharded import (
            dim_sharded_topk,
            make_dim_mesh,
        )

        n, d, b, k = 600, 64, 6, 7  # d split 8 ways -> 8 dims per device
        data = rng.standard_normal((n, d)).astype(np.float32)
        norms = np.linalg.norm(data, axis=1).astype(np.float32)
        valid = np.ones(n, bool)
        valid[10] = False
        q = rng.standard_normal((b, d)).astype(np.float32)
        mesh = make_dim_mesh(8, devices=eight_cpu_devices)
        d_s, r_s = dim_sharded_topk(mesh, data, norms, valid, q, metric=metric,
                                    k=k)
        d_x, r_x = exact_topk(torch.from_numpy(data), torch.from_numpy(norms),
                              torch.from_numpy(valid), torch.from_numpy(q),
                              metric=metric, k=k)
        np.testing.assert_array_equal(r_s.numpy(), r_x.numpy())
        np.testing.assert_allclose(d_s.numpy(), d_x.numpy(), rtol=1e-4,
                                   atol=1e-4)

    def test_indivisible_dim_rejected(self, eight_cpu_devices):
        from erlvectordb_tpu_torch.parallel.dim_sharded import (
            dim_sharded_topk,
            make_dim_mesh,
        )

        mesh = make_dim_mesh(8, devices=eight_cpu_devices)
        with pytest.raises(ValueError):
            dim_sharded_topk(mesh, np.zeros((10, 12), np.float32),
                             np.zeros(10), np.ones(10, bool),
                             np.zeros((1, 12), np.float32))


class TestShardedFilteredSearch:
    def test_where_on_sharded(self, mesh8, rng):
        data = rng.standard_normal((120, 8)).astype(np.float32)
        sh = ShardedVectorStore("fsh", mesh8, metric="euclidean")
        sh.insert_batch([f"v{i}" for i in range(120)], data,
                        [{"odd": i % 2} for i in range(120)])
        res = sh.search(data[7], k=5, where={"odd": 1})
        assert res[0][0] == "v7"
        assert all(int(r[0][1:]) % 2 == 1 for r in res)


class TestShardedBulkBuild:
    def test_from_matrix_f32(self, mesh8, rng):
        data = rng.standard_normal((2000, 24)).astype(np.float32)
        sh = ShardedVectorStore.from_matrix("bm", mesh8, data)
        assert sh.count == 2000
        assert sh.search(data[777], k=1)[0][0] == "777"
        # block partition invariant
        assert sh.get_stats()["per_shard_counts"][0] >= 1

    def test_from_matrix_int8(self, mesh8, rng):
        data = rng.standard_normal((1500, 32)).astype(np.float32)
        sh = ShardedVectorStore.from_matrix("bm8", mesh8, data, dtype="int8")
        assert sh.dtype == "int8"
        assert sh.search(data[42], k=1)[0][0] == "42"
        # follow-up mutations still work
        sh.delete("42")
        assert sh.search(data[42], k=1)[0][0] != "42"
        sh.insert("new", np.ones(32, np.float32))
        assert sh.count == 1500

    def test_from_matrix_explicit_ids(self, mesh8, rng):
        data = rng.standard_normal((100, 8)).astype(np.float32)
        sh = ShardedVectorStore.from_matrix(
            "bmi", mesh8, data, ids=[f"x{i}" for i in range(100)])
        assert sh.search(data[5], k=1)[0][0] == "x5"


class TestStreamingBuild:
    """from_chunks: the 10M-scale streaming build (no [N, D] f32 temp)."""

    def test_matches_from_matrix(self, mesh8, rng):
        data = rng.standard_normal((3000, 24)).astype("float32")
        ref = ShardedVectorStore.from_matrix("sb_ref", mesh8, data, dtype="int8")
        # uniform 1024-row chunks; the final chunk zero-padded to the shape
        chunks = []
        for i in range(0, 3000, 1024):
            c = data[i:i + 1024]
            if c.shape[0] < 1024:
                c = np.concatenate(
                    [c, np.zeros((1024 - c.shape[0], 24), np.float32)])
            chunks.append(c)
        st = ShardedVectorStore.from_chunks(
            "sb_chunks", mesh8, chunks, n=3000, dim=24, dtype="int8")
        assert st.count == 3000
        assert (st.get_stats()["per_shard_counts"]
                == ref.get_stats()["per_shard_counts"])
        q = data[:16]
        for g, w in zip(st.search_batch(q, k=5), ref.search_batch(q, k=5)):
            assert [h[0] for h in g] == [h[0] for h in w]
            np.testing.assert_allclose([h[2] for h in g], [h[2] for h in w],
                                       atol=1e-5)

    def test_implicit_ids_and_mutation_after_build(self, mesh8, rng):
        data = rng.standard_normal((2048, 16)).astype("float32")
        st = ShardedVectorStore.from_chunks(
            "sb_mut", mesh8, [data[:1024], data[1024:]], n=2048, dim=16,
            dtype="float32")
        assert "2047" in st and "2048" not in st
        assert st.search(data[77], k=1)[0][0] == "77"
        # a targeted mutation materializes the implicit ids correctly
        assert st.delete("77")
        assert st.search(data[77], k=1)[0][0] != "77"
        st.insert("fresh", data[77], {"tag": "x"})
        assert st.search(data[77], k=1)[0][0] == "fresh"

    def test_chunks_mismatch_rejected(self, mesh8, rng):
        data = rng.standard_normal((100, 8)).astype("float32")
        with pytest.raises(ValueError):
            ShardedVectorStore.from_chunks("sb_bad", mesh8, [data], n=200,
                                           dim=8, dtype="int8")


class TestDimShardedStore:
    """DimShardedVectorStore: the tensor-parallel store."""

    def test_matches_plain_store(self, rng, eight_cpu_devices):
        from erlvectordb_tpu_torch.parallel.dim_sharded import (
            DimShardedVectorStore,
            make_dim_mesh,
        )

        mesh = make_dim_mesh(4, devices=eight_cpu_devices)
        data = rng.standard_normal((500, 256)).astype(np.float32)
        ids = [f"v{i}" for i in range(500)]
        ds = DimShardedVectorStore("dstore", mesh, dim=256)
        ds.insert_batch(ids, data, [{"i": i} for i in range(500)])
        ref = VectorStore("dref", dim=256, device=CPU)
        ref.insert_batch(ids, data)
        q = data[:8]
        for metric in ("cosine", "euclidean", "dot", "manhattan"):
            got = ds.search_batch(q, k=5, metric=metric)
            want = ref.search_batch(q, k=5, metric=metric)
            for g, w in zip(got, want):
                assert [h[0] for h in g] == [h[0] for h in w], metric
        # mutation + filter
        assert ds.delete("v3")
        assert ds.search(data[3], k=1)[0][0] != "v3"
        hits = ds.search(data[5], k=3, where={"i": 5})
        assert hits[0][0] == "v5" and len(hits) == 1

    def test_bulk_build_and_snapshot(self, rng, tmp_path, eight_cpu_devices):
        from erlvectordb_tpu_torch.parallel.dim_sharded import (
            DimShardedVectorStore,
            make_dim_mesh,
        )
        from erlvectordb_tpu_torch.persist.snapshot import load_store, save_store

        mesh = make_dim_mesh(8, devices=eight_cpu_devices)
        data = rng.standard_normal((300, 128)).astype(np.float32)
        ds = DimShardedVectorStore.from_matrix("dbulk", data, mesh=mesh)
        assert ds.get_stats()["model_shards"] == 8
        assert ds.search(data[9], k=1)[0][0] == "9"
        save_store(ds, tmp_path)
        ld = load_store("dbulk", tmp_path, device=CPU)
        assert type(ld).__name__ == "DimShardedVectorStore"
        assert ld.search(data[9], k=1)[0][0] == "9"
        ld.insert("post", data[0] * 2)
        assert "post" in ld

    def test_facade_verb(self, rng, tmp_path):
        from erlvectordb_tpu_torch.api import Database
        from erlvectordb_tpu_torch.infra.config import load_config

        db = Database(load_config(overrides={
            "persistence_dir": str(tmp_path / "d"),
            "backup_dir": str(tmp_path / "b"),
            "sync_interval": 9999}, env={}), device=CPU)
        stats = db.create_dim_sharded_store("wide", dim=256, n_model=4)
        assert stats["dim_sharded"] and stats["model_shards"] == 4
        data = rng.standard_normal((50, 256)).astype(np.float32)
        st = db.any_store("wide")
        st.insert_batch([f"x{i}" for i in range(50)], data)
        assert db.search("wide", data[11], k=1)[0][0] == "x11"
        db.stop()


class TestShardedHardening:
    def test_duplicate_batch_ids_no_ghosts(self, mesh8):
        st = ShardedVectorStore("dupsh", mesh8)
        v1 = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
        v2 = np.array([0.0, 1.0, 0.0, 0.0], np.float32)
        st.insert_batch(["a", "a"], np.stack([v1, v2]))
        assert st.count == 1
        assert [h[0] for h in st.search(v1, k=2)] == ["a"]
        np.testing.assert_allclose(st.get("a")[0][:4], v2, atol=1e-6)
        assert st.delete("a") and st.count == 0

    def test_ticket_decodes_across_capacity_grow(self, mesh8):
        """Device rows encode shard * cap + local at SUBMIT time; a grow
        between submit and complete must not remap results to wrong ids."""
        st = ShardedVectorStore("growsh", mesh8)
        n0 = 64
        rng = np.random.default_rng(1)
        data = rng.standard_normal((n0, 8)).astype(np.float32)
        st.insert_batch([f"v{i}" for i in range(n0)], data)
        t = st.search_batch_submit(data[:4], k=1)
        cap_before = st._cap
        more = rng.standard_normal((4096, 8)).astype(np.float32)
        st.insert_batch([f"w{i}" for i in range(4096)], more)
        assert st._cap > cap_before, "test needs an actual grow"
        out = st.search_batch_complete(t)
        assert [out[i][0][0] for i in range(4)] == [f"v{i}" for i in range(4)]

    def test_cluster_overreplication_is_clear_error(self, eight_cpu_devices):
        from erlvectordb_tpu_torch.parallel.cluster import (
            ClusterError,
            ClusterManager,
        )

        with pytest.raises(ClusterError, match="replication_factor"):
            ClusterManager(devices=eight_cpu_devices[:1], replication_factor=2)
