"""tests/test_api.py re-pointed at the port's Database facade
(erlvectordb_tpu_torch/api.py) on the CPU, with persistence on as in the
default configuration: store CRUD, sync and restart durability, backup /
restore / export / import, compression and OAuth verbs, the recall_target
batch tool, compressed snapshots, warmup on start, and the streaming build.

The cases of tests/test_api.py that need a store distributed over a device
mesh (create_distributed_store, distribute_store, sharded persistence,
backup and export, distributed visibility and routing, name shadowing
against a distributed store) run on the port's cluster over 8 logical CPU
devices (the ``eight_cpu_devices`` fixture)."""

import numpy as np
import pytest
import torch

from erlvectordb_tpu_torch.api import Database
from erlvectordb_tpu_torch.core.registry import StoreNotFound
from erlvectordb_tpu_torch.infra.config import load_config
from erlvectordb_tpu_torch.parallel.mesh import cpu_device_count, set_cpu_device_count

CPU = torch.device("cpu")


@pytest.fixture
def db(tmp_path):
    cfg = load_config(overrides={
        "persistence_dir": str(tmp_path / "data"),
        "backup_dir": str(tmp_path / "backups"),
        "sync_interval": 9999,
    }, env={})
    database = Database(cfg, device=CPU).start()
    yield database
    database.stop()


class TestStoreVerbs:
    def test_crud(self, db, rng):
        stats = db.create_store("s1", metric="euclidean")
        assert stats["count"] == 0
        db.insert("s1", "a", [1.0, 2.0], {"m": 1})
        data = rng.standard_normal((20, 2)).astype(np.float32)
        db.insert_batch("s1", [f"v{i}" for i in range(20)], data)
        assert db.get_stats("s1")["count"] == 21
        hits = db.search("s1", [1.0, 2.0], k=1)
        assert hits[0][0] == "a"
        assert db.delete("s1", "a")
        assert len(db.get_all_vectors("s1")) == 20
        assert db.list_stores() == ["s1"]
        assert db.delete_store("s1")
        assert not db.delete_store("s1")

    def test_sync_and_restart_durability(self, db, rng, tmp_path):
        db.create_store("dur")
        db.insert("dur", "x", [1.0, 0.0, 0.0])
        assert db.sync("dur")
        # a brand-new Database over the same dirs reloads the store
        db2 = Database(db.config, device=CPU).start()
        try:
            assert "dur" in db2.list_stores()
            assert db2.search("dur", [1.0, 0.0, 0.0], k=1)[0][0] == "x"
        finally:
            db2.persistence.close()

    def test_sync_unknown_store(self, db):
        with pytest.raises(StoreNotFound):
            db.sync("ghost")


class TestBackupVerbs:
    def test_backup_restore_cycle(self, db, rng):
        db.create_store("b1")
        data = rng.standard_normal((10, 4)).astype(np.float32)
        db.insert_batch("b1", [f"v{i}" for i in range(10)], data)
        path = db.backup_store("b1", "snap")
        fname = path.rsplit("/", 1)[-1]
        assert any(b["file"] == fname for b in db.list_backups())
        stats = db.restore_store(fname, new_name="b1_restored")
        assert stats["count"] == 10
        assert db.search("b1_restored", data[3], k=1)[0][0] == "v3"
        assert db.delete_backup(fname)

    def test_export_import(self, db, rng, tmp_path):
        db.create_store("e1")
        data = rng.standard_normal((5, 3)).astype(np.float32)
        db.insert_batch("e1", [f"v{i}" for i in range(5)], data)
        path = str(tmp_path / "out.json")
        db.export_store("e1", path)
        stats = db.import_store(path, new_name="e2")
        assert stats["count"] == 5
        assert db.search("e2", data[2], k=1)[0][0] == "v2"


class TestCompressionVerbs:
    def test_passthrough(self, db, rng):
        v = rng.standard_normal(64).astype(np.float32)
        cv = db.compress_vector(v, "8bit")
        recon = db.decompress_vector(cv)
        assert np.max(np.abs(recon - v)) < 0.05
        assert "8bit" in db.get_supported_algorithms()
        out = db.benchmark_compression(v, "4bit", iterations=1)
        assert out["compression_ratio"] == pytest.approx(8.0)


class TestOAuthVerbs:
    def test_register_and_token(self, db):
        db.register_oauth_client("c9", "s9", ["read"])
        tok = db.get_access_token("c9", "s9")
        info = db.validate_token(tok["access_token"])
        assert info["client_id"] == "c9"
        assert info["scopes"] == {"read"}


class TestLocalRouting:
    def test_recall_target_batch_tool(self, db, rng):
        """search_vectors_batch accepts recall_target (auto-nprobe) like
        search_vectors does — parity across the MCP tool surface."""
        from erlvectordb_tpu_torch.serve.tools import call_tool

        db.create_store("rt4r", metric="cosine", dtype="int4r")
        centers = rng.standard_normal((8, 16)).astype(np.float32)
        data = (centers[rng.integers(0, 8, 400)]
                + 0.2 * rng.standard_normal((400, 16))).astype(np.float32)
        db.any_store("rt4r").insert_batch(
            [f"v{i}" for i in range(400)], data)
        # explicit calibration tool returns the curve (deep probe == 1.0)
        out = call_tool(db, "calibrate_store",
                        {"store": "rt4r", "n_sample": 64, "k": 5})
        assert max(out["curve"].values()) == 1.0
        out = call_tool(db, "search_vectors_batch", {
            "store": "rt4r", "vectors": data[:4].tolist(), "k": 2,
            "recall_target": 0.9, "compact": True})
        assert out["ids"][0][0] == "v0" and out["ids"][3][0] == "v3"

    def test_any_store_missing(self, db):
        with pytest.raises(StoreNotFound):
            db.any_store("nope")


class TestCompressionEnabledPersistence:
    def test_compressed_snapshots_via_config(self, rng, tmp_path):
        from erlvectordb_tpu_torch.persist.snapshot import get_store_info

        cfg = load_config(overrides={
            "persistence_dir": str(tmp_path / "data"),
            "backup_dir": str(tmp_path / "backups"),
            "sync_interval": 9999,
            "compression_enabled": True,
            "compression_algorithm": "zlib",
        }, env={})
        db = Database(cfg, device=CPU).start()
        try:
            db.create_store("cz")
            data = rng.standard_normal((50, 8)).astype(np.float32)
            db.insert_batch("cz", [f"v{i}" for i in range(50)], data)
            db.sync("cz")
            info = get_store_info("cz", cfg.persistence_dir)
            assert info["compression"] == "zlib"
            db2 = Database(cfg, device=CPU).start()
            try:
                assert db2.search("cz", data[3], k=1)[0][0] == "v3"
            finally:
                db2.persistence.close()
        finally:
            db.stop()


class TestWarmupOnStart:
    def test_flag_triggers_warmup(self, rng, tmp_path):
        cfg = load_config(overrides={
            "persistence_dir": str(tmp_path / "data"),
            "backup_dir": str(tmp_path / "backups"),
            "sync_interval": 9999,
        }, env={})
        db = Database(cfg, device=CPU).start()
        db.create_store("w")
        db.insert_batch("w", [f"v{i}" for i in range(10)],
                        rng.standard_normal((10, 4)).astype(np.float32))
        db.sync("w")
        db.stop()
        cfg2 = load_config(overrides={
            "persistence_dir": str(tmp_path / "data"),
            "backup_dir": str(tmp_path / "backups"),
            "sync_interval": 9999,
            "warmup_on_start": True,
        }, env={})
        db2 = Database(cfg2, device=CPU).start()  # warms the reloaded store
        try:
            assert db2.search("w", np.ones(4, np.float32), k=1)
        finally:
            db2.stop()


class TestStreamingFacade:
    def test_create_store_streaming(self, db, rng):
        data = rng.standard_normal((300, 32)).astype(np.float32)

        def chunks():
            for i in range(0, 300, 100):
                yield data[i:i + 100]

        stats = db.create_store_streaming(
            "stream-f", chunks(), n=300, dim=32, cell_rows=32, cell_cap=64,
            train_rows=256)
        assert stats["count"] == 300
        hits = db.search("stream-f", data[17], k=1)
        assert hits[0][0] == "17"
        with pytest.raises(Exception, match="exists"):
            db.create_store_streaming("stream-f", chunks(), n=300, dim=32)


# ------------------------------------------------ distributed (8 CPU devices)


@pytest.fixture
def eight_cpu_devices():
    held = cpu_device_count()
    set_cpu_device_count(8)
    yield
    set_cpu_device_count(held)


@pytest.mark.usefixtures("eight_cpu_devices")
class TestDistributedVerbs:
    def test_create_distributed_and_search(self, db, rng):
        stats = db.create_distributed_store("dist1", dtype="int8")
        assert stats["shards"] == 8
        data = rng.standard_normal((100, 16)).astype(np.float32)
        store = db.any_store("dist1")
        store.insert_batch([f"v{i}" for i in range(100)], data)
        assert store.search(data[7], k=1)[0][0] == "v7"
        loc = db.get_store_location("dist1")
        assert loc["shards"] == stats["shards"]
        assert db.get_cluster_stats()["stores"]["dist1"] == 100
        assert len(db.get_cluster_nodes()) == 8

    def test_nprobe_on_distributed_store_tool_error(self, db, rng):
        """The MCP nprobe fast path surfaces the domain ValueError for
        distributed stores, not a TypeError from the store signature."""
        from erlvectordb_tpu_torch.serve.tools import call_tool

        db.create_distributed_store("distnp", dtype="int8")
        data = rng.standard_normal((50, 16)).astype(np.float32)
        db.any_store("distnp").insert_batch([f"v{i}" for i in range(50)], data)
        with pytest.raises(ValueError, match="nprobe requires"):
            call_tool(db, "search_vectors", {
                "store": "distnp", "vector": data[0].tolist(), "k": 3,
                "nprobe": 4})

    def test_distribute_existing_store(self, db, rng):
        db.create_store("local1")
        data = rng.standard_normal((50, 8)).astype(np.float32)
        db.insert_batch("local1", [f"v{i}" for i in range(50)], data)
        stats = db.distribute_store("local1")
        assert stats["count"] == 50
        # moved out of the local registry but still visible as a store
        assert db.registry.get_or_none("local1") is None
        assert "local1" in db.list_stores()
        assert db.any_store("local1").search(data[3], k=1)[0][0] == "v3"

    def test_distributed_persistence_roundtrip(self, db, rng):
        db.create_distributed_store("dist2")
        data = rng.standard_normal((30, 8)).astype(np.float32)
        db.any_store("dist2").insert_batch([f"v{i}" for i in range(30)], data)
        assert db.persistence.sync("dist2")
        db2 = Database(db.config, device=CPU).start()
        try:
            sh = db2.any_store("dist2")
            assert sh.count == 30
            assert sh.search(data[9], k=1)[0][0] == "v9"
        finally:
            db2.persistence.close()


@pytest.mark.usefixtures("eight_cpu_devices")
class TestDistributedBackup:
    def test_backup_restore_sharded_store(self, db, rng):
        db.create_distributed_store("dsb")
        data = rng.standard_normal((60, 8)).astype(np.float32)
        db.any_store("dsb").insert_batch(
            [f"v{i}" for i in range(60)], data, [{"i": i} for i in range(60)])
        path = db.backup_store("dsb", "snap")
        stats = db.restore_store(path.rsplit("/", 1)[-1], new_name="dsb_restored")
        assert stats["count"] == 60
        restored = db.any_store("dsb_restored")
        assert restored.search(data[7], k=1)[0][0] == "v7"
        assert restored.get("v3")[1] == {"i": 3}

    def test_export_sharded_store(self, db, rng, tmp_path):
        db.create_distributed_store("dse")
        data = rng.standard_normal((20, 4)).astype(np.float32)
        db.any_store("dse").insert_batch([f"v{i}" for i in range(20)], data)
        path = str(tmp_path / "dse.json")
        db.export_store("dse", path)
        assert db.import_store(path, new_name="dse_imported")["count"] == 20


@pytest.mark.usefixtures("eight_cpu_devices")
class TestDistributedVisibility:
    def test_list_and_delete_distributed(self, db, rng):
        db.create_distributed_store("dvis")
        assert "dvis" in db.list_stores()
        assert db.delete_store("dvis")
        assert "dvis" not in db.list_stores()
        assert not db.delete_store("dvis")


@pytest.mark.usefixtures("eight_cpu_devices")
class TestFacadeRoutesDistributed:
    def test_all_verbs_on_distributed_store(self, db, rng):
        db.create_distributed_store("dall")
        data = rng.standard_normal((30, 8)).astype(np.float32)
        db.insert_batch("dall", [f"v{i}" for i in range(30)], data)
        db.insert("dall", "extra", np.ones(8, np.float32), {"t": 1})
        assert db.get_stats("dall")["count"] == 31
        assert db.search("dall", data[5], k=1)[0][0] == "v5"
        assert db.delete("dall", "extra")
        assert len(db.get_all_vectors("dall")) == 30
        assert db.sync("dall")


@pytest.mark.usefixtures("eight_cpu_devices")
class TestNameShadowing:
    def test_local_vs_distributed_name_collision(self, db):
        from erlvectordb_tpu_torch.core.registry import StoreExists

        db.create_distributed_store("shadow1")
        with pytest.raises(StoreExists):
            db.create_store("shadow1")
        db.create_store("shadow2")
        with pytest.raises(StoreExists):
            db.create_distributed_store("shadow2")
