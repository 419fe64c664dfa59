"""tests/test_persistence.py re-pointed at the port's persistence
(erlvectordb_tpu_torch/persist/): save -> load, restart durability, backup
-> restore, JSON export -> import, manual and background sync, incremental
deltas and their chain, compaction, stale deltas, the sync/write race and
the int4r backup — on the CPU (stores, loads and managers on
``device=CPU``)."""

import json
import time

import numpy as np
import pytest
import torch

from erlvectordb_tpu_torch.core import VectorStore
from erlvectordb_tpu_torch.persist import (
    PersistenceManager,
    backup_store,
    delete_backup,
    delete_persisted,
    export_store,
    get_store_info,
    import_store,
    list_backups,
    list_persisted,
    load_store,
    restore_store,
    save_store,
)

CPU = torch.device("cpu")


@pytest.fixture
def populated_store(rng):
    store = VectorStore("pstore", metric="cosine", device=CPU)
    data = rng.standard_normal((64, 16)).astype(np.float32)
    store.insert_batch(
        [f"v{i}" for i in range(64)], data, [{"i": i} for i in range(64)]
    )
    store.delete("v5")
    return store, data


class TestSnapshot:
    def test_save_load_roundtrip(self, populated_store, tmp_path):
        store, data = populated_store
        save_store(store, tmp_path)
        loaded = load_store("pstore", tmp_path, device=CPU)
        assert loaded is not None
        assert loaded.count == 63
        assert loaded.metric == "cosine"
        assert loaded.get("v5") is None
        vec, meta = loaded.get("v7")
        np.testing.assert_allclose(vec, data[7], atol=1e-6)
        assert meta == {"i": 7}
        # restart durability: searching the reloaded store works
        assert loaded.search(data[10], k=1)[0][0] == "v10"

    def test_load_missing_returns_none(self, tmp_path):
        assert load_store("ghost", tmp_path, device=CPU) is None

    def test_compressed_snapshot(self, populated_store, tmp_path):
        store, data = populated_store
        save_store(store, tmp_path, compression="zlib")
        info = get_store_info("pstore", tmp_path)
        assert info["compression"] == "zlib"
        loaded = load_store("pstore", tmp_path, device=CPU)
        np.testing.assert_allclose(loaded.get("v7")[0], data[7], atol=1e-6)

    def test_list_and_delete(self, populated_store, tmp_path):
        store, _ = populated_store
        save_store(store, tmp_path)
        assert list_persisted(tmp_path) == ["pstore"]
        assert delete_persisted("pstore", tmp_path)
        assert list_persisted(tmp_path) == []
        assert not delete_persisted("pstore", tmp_path)

    def test_store_info(self, populated_store, tmp_path):
        store, _ = populated_store
        save_store(store, tmp_path)
        info = get_store_info("pstore", tmp_path)
        assert info["count"] == 63
        assert info["dimension"] == 16

    def test_atomic_overwrite(self, populated_store, tmp_path):
        store, data = populated_store
        save_store(store, tmp_path)
        store.insert("new", np.ones(16, np.float32))
        save_store(store, tmp_path)
        loaded = load_store("pstore", tmp_path, device=CPU)
        assert loaded.count == 64


class TestPersistenceManager:
    def test_manual_sync_and_reopen(self, populated_store, tmp_path):
        store, data = populated_store
        mgr = PersistenceManager(tmp_path, sync_interval=9999, device=CPU)
        mgr.track(store)
        assert mgr.sync("pstore")
        reopened = mgr.open_store("pstore")
        assert reopened.count == 63

    def test_sync_all_only_dirty(self, populated_store, tmp_path):
        store, _ = populated_store
        mgr = PersistenceManager(tmp_path, sync_interval=9999, device=CPU)
        mgr.track(store)
        assert mgr.sync_all() == 1
        assert mgr.sync_all() == 0  # version unchanged -> no write
        store.insert("extra", np.ones(16, np.float32))
        assert mgr.sync_all() == 1

    def test_background_sync(self, populated_store, tmp_path):
        store, _ = populated_store
        mgr = PersistenceManager(tmp_path, sync_interval=0.1, device=CPU)
        mgr.track(store)
        mgr.start()
        try:
            deadline = time.time() + 5
            while (time.time() < deadline
                   and load_store("pstore", tmp_path, device=CPU) is None):
                time.sleep(0.05)
            assert load_store("pstore", tmp_path, device=CPU) is not None
        finally:
            mgr.close()

    def test_close_flushes(self, populated_store, tmp_path):
        store, _ = populated_store
        mgr = PersistenceManager(tmp_path, sync_interval=9999, device=CPU)
        mgr.track(store)
        mgr.close()
        assert load_store("pstore", tmp_path, device=CPU) is not None


class TestBackup:
    def test_backup_restore(self, populated_store, tmp_path):
        store, data = populated_store
        path = backup_store(store, "daily", tmp_path)
        restored = restore_store(path, new_name="pstore_restored", device=CPU)
        assert restored.name == "pstore_restored"
        assert restored.count == 63
        assert restored.search(data[20], k=1)[0][0] == "v20"

    def test_list_backups(self, populated_store, tmp_path):
        store, _ = populated_store
        backup_store(store, "b1", tmp_path)
        backup_store(store, "b2", tmp_path)
        listing = list_backups(tmp_path)
        assert len(listing) == 2
        assert {b["backup_name"] for b in listing} == {"b1", "b2"}
        assert all(b["vector_count"] == 63 for b in listing)

    def test_delete_backup(self, populated_store, tmp_path):
        store, _ = populated_store
        path = backup_store(store, "gone", tmp_path)
        fname = path.split("/")[-1]
        assert delete_backup(fname, tmp_path)
        assert list_backups(tmp_path) == []
        assert not delete_backup(fname, tmp_path)


class TestJsonExportImport:
    def test_export_import_roundtrip(self, populated_store, tmp_path):
        store, data = populated_store
        path = tmp_path / "export.json"
        export_store(store, path)
        doc = json.loads(path.read_text())
        assert doc["store_name"] == "pstore"
        assert doc["vector_count"] == 63
        imported = import_store(path, new_name="imported", device=CPU)
        assert imported.count == 63
        # reference asserts distance ~ 0 for an exported vector
        # (test/persistence_SUITE.erl:138-166)
        res = imported.search(data[3], k=1)
        assert res[0][0] == "v3"
        assert res[0][2] == pytest.approx(0.0, abs=1e-4)

    def test_import_into_int8(self, populated_store, tmp_path):
        store, data = populated_store
        path = tmp_path / "export.json"
        export_store(store, path)
        imported = import_store(path, new_name="q", dtype="int8", device=CPU)
        assert imported.dtype == "int8"
        assert imported.search(data[3], k=1)[0][0] == "v3"


class TestIncrementalSnapshots:
    """Round-2 dirty-range deltas: sync cost proportional to the delta, not
    the store (the reference rewrote the whole DETS table every 30 s —
    src/vector_persistence.erl:255-273)."""

    def _mk_manager(self, tmp_path, rng, n=3000, d=24):
        from erlvectordb_tpu_torch.core.store import VectorStore
        from erlvectordb_tpu_torch.persist.snapshot import PersistenceManager

        data = rng.standard_normal((n, d)).astype(np.float32)
        store = VectorStore("inc", dim=d, device=CPU)
        store.insert_batch([f"v{i}" for i in range(n)], data,
                           [{"i": i} for i in range(n)])
        pm = PersistenceManager(tmp_path, sync_interval=9999, device=CPU)
        pm.track(store)
        return pm, store, data

    def test_delta_written_and_small(self, tmp_path, rng):
        pm, store, data = self._mk_manager(tmp_path, rng)
        pm.sync("inc")  # full base
        sdir = tmp_path / "inc"
        [base] = sdir.glob("state_*.npz")  # generation-numbered pair
        base_size = base.stat().st_size
        base_mtime = base.stat().st_mtime_ns
        store.insert("extra", data[0] * 0.5, {"fresh": True})
        pm.sync("inc")
        deltas = list(sdir.glob("delta_*.npz"))
        assert len(deltas) == 1
        assert deltas[0].stat().st_size < base_size / 20  # O(delta), not O(N)
        assert base.stat().st_mtime_ns == base_mtime

    def test_reload_applies_deltas(self, tmp_path, rng):
        from erlvectordb_tpu_torch.persist.snapshot import load_store

        pm, store, data = self._mk_manager(tmp_path, rng)
        pm.sync("inc")
        store.insert("extra", data[7] * 2.0, {"fresh": True})
        store.insert("v5", data[11], {"i": "overwritten"})  # overwrite
        store.delete("v9")
        pm.sync("inc")
        loaded = load_store("inc", tmp_path, device=CPU)
        assert loaded.count == store.count
        assert "v9" not in loaded
        vec, meta = loaded.get("extra")
        np.testing.assert_allclose(vec, data[7] * 2.0, atol=1e-6)
        assert meta == {"fresh": True}
        assert loaded.get("v5")[1] == {"i": "overwritten"}
        # search agrees between live and reloaded store (euclidean: cosine
        # would tie "extra" = 2*data[7] with "v7" = data[7])
        got = loaded.search(data[7] * 2.0, k=1, metric="euclidean")
        assert got[0][0] == "extra"

    def test_chain_of_deltas(self, tmp_path, rng):
        from erlvectordb_tpu_torch.persist.snapshot import load_store

        pm, store, data = self._mk_manager(tmp_path, rng)
        pm.sync("inc")
        for j in range(5):
            store.insert(f"d{j}", data[j] + j, {"j": j})
            pm.sync("inc")
        sdir = tmp_path / "inc"
        assert len(list(sdir.glob("delta_*.npz"))) == 5
        loaded = load_store("inc", tmp_path, device=CPU)
        for j in range(5):
            np.testing.assert_allclose(loaded.get(f"d{j}")[0], data[j] + j,
                                       atol=1e-6)

    def test_compaction_after_max_deltas(self, tmp_path, rng):
        from erlvectordb_tpu_torch.persist.snapshot import PersistenceManager

        pm, store, data = self._mk_manager(tmp_path, rng)
        pm.MAX_DELTAS = 3
        pm.sync("inc")
        sdir = tmp_path / "inc"
        for j in range(5):
            store.insert(f"c{j}", data[j], {})
            pm.sync("inc")
        # 3 deltas then a compacting full snapshot cleared them
        assert len(list(sdir.glob("delta_*.npz"))) <= 3

    def test_stale_deltas_ignored_after_new_base(self, tmp_path, rng):
        from erlvectordb_tpu_torch.persist.snapshot import load_store, save_store

        pm, store, data = self._mk_manager(tmp_path, rng)
        pm.sync("inc")
        store.insert("x1", data[3], {})
        pm.sync("inc")  # delta 0
        sdir = tmp_path / "inc"
        # keep a stale copy of the delta around, then write a new base
        stale_j = (sdir / "delta_000000.json").read_text()
        stale_n = (sdir / "delta_000000.npz").read_bytes()
        store.delete("x1")
        save_store(store, tmp_path)  # new base (clears deltas)
        (sdir / "delta_000000.json").write_text(stale_j)
        (sdir / "delta_000000.npz").write_bytes(stale_n)
        loaded = load_store("inc", tmp_path, device=CPU)
        assert "x1" not in loaded  # stale delta must not resurrect it

    def test_reopened_store_continues_chain(self, tmp_path, rng):
        from erlvectordb_tpu_torch.persist.snapshot import PersistenceManager

        pm, store, data = self._mk_manager(tmp_path, rng)
        pm.sync("inc")
        store.insert("a", data[0], {})
        pm.sync("inc")
        pm2 = PersistenceManager(tmp_path, sync_interval=9999, device=CPU)
        reloaded = pm2.open_store("inc")
        assert "a" in reloaded
        reloaded.insert("b", data[1], {})
        pm2.sync("inc")
        sdir = tmp_path / "inc"
        assert len(list(sdir.glob("delta_*.npz"))) == 2  # chain continued
        from erlvectordb_tpu_torch.persist.snapshot import load_store
        final = load_store("inc", tmp_path, device=CPU)
        assert "a" in final and "b" in final


class TestSyncVersionRace:
    def test_write_during_save_stays_pending(self, tmp_path, monkeypatch):
        """Regression: a write landing DURING the (slow) save must leave the
        store pending for the next sync — recording the post-save version
        would mark the unsaved write as synced forever."""
        from erlvectordb_tpu_torch.persist import snapshot as snap_mod
        from erlvectordb_tpu_torch.persist.snapshot import PersistenceManager

        pm = PersistenceManager(str(tmp_path), sync_interval=9999, device=CPU)
        st = VectorStore("racer", device=CPU)
        st.insert("a", [1.0, 0.0])
        pm.track(st)

        real_save = snap_mod.save_store

        def slow_save(store, root, compression=None):
            out = real_save(store, root, compression)
            # a client write lands while the save was in flight
            store.insert("b", [0.0, 1.0])
            return out

        monkeypatch.setattr(snap_mod, "save_store", slow_save)
        monkeypatch.setattr(
            "erlvectordb_tpu_torch.persist.snapshot.save_store", slow_save)
        assert pm.sync_all() == 1
        monkeypatch.setattr(
            "erlvectordb_tpu_torch.persist.snapshot.save_store", real_save)
        # the racing write must still be considered unsynced
        assert pm.sync_all() == 1
        assert pm.sync_all() == 0

    def test_int4r_backup_roundtrip(self, tmp_path):
        """Regression: int4r stores carry a centroids ndarray that backup's
        manifest split must move into the npz (json.dumps crashed)."""
        from erlvectordb_tpu_torch.persist import backup as backup_mod

        rng = np.random.default_rng(0)
        data = rng.standard_normal((600, 16)).astype(np.float32)
        st = VectorStore.from_matrix("b4r", data, dtype="int4r", device=CPU)
        path = backup_mod.backup_store(st, "snap", str(tmp_path))
        st2 = backup_mod.restore_store(path, new_name="b4r_r", device=CPU)
        assert st2.dtype == "int4r" and st2.count == 600
        hits = st2.search(data[17], k=1)
        assert hits[0][0] == "17"
