"""Durability of the port across the two packages, on the CPU.

The port's snapshots (erlvectordb_tpu_torch/persist/snapshot.py), backups
and JSON exports (persist/backup.py) keep the JAX package's on-disk formats.
For each store type — f32, int8 with and without ``intkey``, int4, int4r
after single-row inserts and deletes (spawned cells, ``cell_free``, deltas),
and an int4r store with ``rq_m`` — a snapshot written by one package loads
in the other (the ``rq_m`` store one way only: the JAX writer fails on it),
and the loaded store answers ``search_batch`` with the ids of the store that
was saved (both packages answer through their exact scans on the CPU; the
``rq_m`` store also through multiprobe).  Then the port's own guarantees:
the store change tracking is the JAX store's, a delta restores the touched
rows' key plane, second-stage codes and cell slots, a Database with the
default configuration starts and recovers its stores bit for bit, and
sharded and dim-sharded snapshots and backups cross between the packages.
"""

import json

import numpy as np
import pytest
import torch

import erlvectordb_tpu.core.store as jstore
import erlvectordb_tpu.persist.backup as jbackup
import erlvectordb_tpu.persist.snapshot as jsnap
from erlvectordb_tpu_torch.api import Database
from erlvectordb_tpu_torch.core.store import VectorStore
from erlvectordb_tpu_torch.infra.config import load_config
from erlvectordb_tpu_torch.persist import backup as tbackup
from erlvectordb_tpu_torch.persist import snapshot as tsnap

CPU = torch.device("cpu")
torch.set_num_threads(2)

KINDS = {  # name -> from_matrix kwargs
    "f32": dict(dtype="float32", metric="cosine"),
    "int8": dict(dtype="int8", metric="euclidean"),
    "int8-intkey": dict(dtype="int8", metric="cosine", intkey=True),
    "int8-intkey-dot": dict(dtype="int8", metric="dot", intkey=True),
    "int4": dict(dtype="int4", metric="cosine"),
    "int4r": dict(dtype="int4r", metric="cosine"),
}


def _corpus(seed, n, d=24, centres=32):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centres, d)).astype(np.float32)
    return (c[rng.integers(0, centres, n)]
            + 0.3 * rng.standard_normal((n, d))).astype(np.float32)


def _ids(hits):
    return [[h[0] for h in row] for row in hits]


def _mutate(store, extra, single=False):
    """Inserts (one row a call when ``single``, as MCP insert_vector makes
    them), an overwrite and deletes."""
    ids = [f"n{i}" for i in range(len(extra))]
    if single:
        for vid, v in zip(ids, extra):
            store.insert(vid, v, {"new": vid})
    else:
        store.insert_batch(ids, extra, [{"new": v} for v in ids])
    store.insert("3", extra[0] * 0.5 + 0.1, {"over": 1})
    store.delete_batch(["5", "11", ids[1]])


def _sync_base_then_delta(pm, store, x, extra, single=False):
    """A full base, the mutations (a delta, or a full base where int4r
    inserts spawned cells and grew the store), then rows deleted and their
    vectors inserted again under new ids, which take the freed slots: a
    delta on every store type."""
    pm.track(store)
    pm.sync(store.name)
    _mutate(store, extra, single)
    pm.sync(store.name)
    store.delete_batch(["20", "21"])
    store.insert_batch(["r20", "r21"], x[20:22])
    pm.sync(store.name)
    assert list(pm.root.glob(f"{store.name}/delta_*.npz"))


# --------------------------------------------------------- change tracking


@pytest.mark.parametrize("kind", ["f32", "int8-intkey", "int4", "int4r"])
def test_touched_rows_match_jax(kind):
    """The port's ``_touched_rows``, ``dirty`` and ``_touched_reliable``
    equal the JAX store's after the same bulk build, inserts, deletes and
    re-inserts (int4r: the same rows, since placement is the JAX
    package's); a save clears them and anchors the chain."""
    x = _corpus(1, 1500)
    j = jstore.VectorStore.from_matrix("t", x[:1200], **KINDS[kind])
    t = VectorStore.from_state(j.export_state(), device=CPU)
    t.dirty, t._touched_reliable = j.dirty, j._touched_reliable
    steps = [
        lambda s: s.insert_batch([f"a{i}" for i in range(40)], x[1200:1240]),
        lambda s: s.delete_batch(["7", "a3", "nope"]),
        lambda s: s.insert("a3", x[1300]),          # re-insert a deleted id
        lambda s: s.insert("8", x[1301]),           # overwrite
        lambda s: s.delete("a3"),
    ]
    for step in steps:
        step(j)
        step(t)
        assert t._touched_rows == j._touched_rows
        assert (t.dirty, t._touched_reliable) == (j.dirty,
                                                   j._touched_reliable)


def test_bulk_builds_force_a_full_base(tmp_path):
    x = _corpus(2, 800)
    b, r = (VectorStore.from_matrix(n, x, dtype=dt, device=CPU)
            for n, dt in (("b", "int8"), ("r", "int4r")))
    for st in (b, r):
        assert st.dirty and not st._touched_reliable
        tsnap.save_store(st, tmp_path)
        assert st._touched_reliable and not st._touched_rows
    b.insert("z", x[0] + 1.0)
    assert b._touched_rows == {800} and b._touched_reliable
    r.delete("4")
    assert r._touched_rows == {r.capacity and r._cell_free[
        next(iter(r._cell_free))][0]} and r._touched_reliable
    r.rebuild_cells()
    assert not r._touched_rows and not r._touched_reliable and r.dirty


# ---------------------------------------------------- snapshots, both ways


@pytest.mark.parametrize("kind", list(KINDS))
def test_jax_snapshot_loads_in_port(tmp_path, kind):
    x = _corpus(3, 2300)
    j = jstore.VectorStore.from_matrix("s", x[:2000], **KINDS[kind])
    pm = jsnap.PersistenceManager(tmp_path, sync_interval=9999)
    _sync_base_then_delta(pm, j, x, x[2000:2030], single=kind == "int4r")
    t = tsnap.load_store("s", tmp_path, device=CPU)
    assert t.count == j.count and t.dtype == j.dtype
    qs = x[2100:2140]
    assert _ids(t.search_batch(qs, k=10)) == _ids(j.search_batch(qs, k=10))
    assert t.get("n0")[1] == {"new": "n0"} and t.get("5") is None
    assert t.get("20") is None and t.get("r20") is not None


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_snapshot_loads_in_jax(tmp_path, kind):
    x = _corpus(4, 2300)
    t = VectorStore.from_matrix("s", x[:2000], device=CPU, **KINDS[kind])
    pm = tsnap.PersistenceManager(tmp_path, sync_interval=9999, device=CPU)
    _sync_base_then_delta(pm, t, x, x[2000:2030], single=kind == "int4r")
    j = jsnap.load_store("s", tmp_path)
    assert j.count == t.count and j.dtype == t.dtype
    qs = x[2100:2140]
    assert _ids(j.search_batch(qs, k=10)) == _ids(t.search_batch(qs, k=10))
    assert j.get("n0")[1] == {"new": "n0"} and j.get("5") is None
    assert j.get("20") is None and j.get("r20") is not None
    # and back in the port, bit for bit
    back = tsnap.load_store("s", tmp_path, device=CPU)
    for key in ("_vectors", "_norms", "_valid", "_scales", "_codes_unit"):
        a, b = getattr(back, key), getattr(t, key)
        assert (a is None) == (b is None), key
        if a is not None:
            assert torch.equal(a, b), key
    assert back._plane_scale == t._plane_scale
    assert back.search_batch(qs, k=10) == t.search_batch(qs, k=10)


def test_int4r_single_row_inserts_spawn_cells_and_keep_slots(tmp_path):
    """Single-row inserts into a full store spawn cells (a full base, as
    capacity grew), then inserts into free slots and deletes give a delta;
    the reload keeps the cell slot tables, so a later insert takes the
    slot the live store would."""
    x = _corpus(5, 900)
    t = VectorStore.from_matrix("c", x[:600], dtype="int4r", device=CPU)
    pm = tsnap.PersistenceManager(tmp_path, sync_interval=9999, device=CPU)
    pm.track(t)
    pm.sync("c")
    cells = len(t._cell_next)
    for i in range(200):
        t.insert(f"m{i}", x[600 + i] * 3.0 + 5.0)   # far from every cell
    assert len(t._cell_next) > cells
    pm.sync("c")
    assert not list((tmp_path / "c").glob("delta_*"))   # grown: full base
    t.delete_batch(["m3", "m4", "20"])
    for i in range(3):
        t.insert(f"k{i}", x[850 + i])
    pm.sync("c")
    assert list((tmp_path / "c").glob("delta_*.npz"))
    back = tsnap.load_store("c", tmp_path, device=CPU)
    np.testing.assert_array_equal(back._cell_next, t._cell_next)
    np.testing.assert_array_equal(back._cell_avail, t._cell_avail)
    assert back._cell_free == t._cell_free
    qs = x[860:890]
    assert _ids(back.search_batch(qs, k=10)) == _ids(t.search_batch(qs, k=10))
    back.insert("late", x[899])
    t.insert("late", x[899])
    assert back._id_to_row["late"] == t._id_to_row["late"]
    j = jsnap.load_store("c", tmp_path)
    assert _ids(j.search_batch(qs, k=10)) == _ids(t.search_batch(qs, k=10))


def test_rq_store_port_to_jax(tmp_path):
    """An int4r store with the rq_m second stage: the JAX writer fails on
    it (its rq arrays stay in the JSON meta); the port's snapshot, with a
    delta of inserted rows and their second-stage codes, loads in the JAX
    package and in the port with the same multiprobe ids."""
    x = _corpus(6, 3000, d=20, centres=64)
    t = VectorStore.from_matrix("rq", x[:2800], dtype="int4r", rq_m=4,
                                device=CPU)
    j_same = jstore.VectorStore.from_state(t.export_state())
    with pytest.raises(TypeError, match="JSON serializable"):
        jsnap.save_store(j_same, tmp_path / "jax")
    pm = tsnap.PersistenceManager(tmp_path, sync_interval=9999, device=CPU)
    pm.track(t)
    pm.sync("rq")
    # rows deleted, then inserted again under new ids: they take the freed
    # slots of their own cells (a fresh direction would spawn cells and
    # grow the store, which writes a full base)
    t.delete_batch([str(i) for i in range(100, 120)])
    t.insert_batch([f"q{i}" for i in range(20)], x[100:120])
    t.delete("9")
    pm.sync("rq")
    assert list((tmp_path / "rq").glob("delta_*.npz"))
    back = tsnap.load_store("rq", tmp_path, device=CPU)
    assert torch.equal(back._rq_codes, t._rq_codes)
    j = jsnap.load_store("rq", tmp_path)
    qs = x[2850:2890]
    want = _ids(t.search_batch(qs, k=10, nprobe=8))
    assert _ids(back.search_batch(qs, k=10, nprobe=8)) == want
    # the JAX delta applies no rq codes: compare on the base rows' ids
    assert _ids(j.search_batch(x[:40], k=10)) == _ids(t.search_batch(x[:40],
                                                                      k=10))


# ----------------------------------------------------- backups and exports


@pytest.mark.parametrize("kind", ["f32", "int8-intkey", "int4", "int4r"])
def test_backups_cross_the_packages(tmp_path, kind):
    x = _corpus(7, 1300)
    j = jstore.VectorStore.from_matrix("bj", x[:1200], **KINDS[kind])
    t = VectorStore.from_matrix("bt", x[:1200], device=CPU, **KINDS[kind])
    for s in (j, t):
        _mutate(s, x[1200:1230])
    qs = x[1240:1270]
    t_from_j = tbackup.restore_store(jbackup.backup_store(j, "x", tmp_path),
                                     new_name="r1", device=CPU)
    j_from_t = jbackup.restore_store(tbackup.backup_store(t, "x", tmp_path),
                                     new_name="r2")
    assert _ids(t_from_j.search_batch(qs, k=10)) == _ids(j.search_batch(qs, k=10))
    assert _ids(j_from_t.search_batch(qs, k=10)) == _ids(t.search_batch(qs, k=10))
    listed = {b["backup_name"] for b in tbackup.list_backups(tmp_path)}
    assert listed == {"x"} and len(tbackup.list_backups(tmp_path)) == 2


def test_exports_cross_the_packages(tmp_path):
    x = _corpus(8, 300)
    j = jstore.VectorStore("ej", metric="euclidean")
    j.insert_batch([f"v{i}" for i in range(300)], x,
                   [{"i": i} for i in range(300)])
    t = tbackup.import_store(jbackup.export_store(j, tmp_path / "j.json"),
                             device=CPU)
    back = jbackup.import_store(tbackup.export_store(t, tmp_path / "t.json"),
                                new_name="ej2")
    for st in (t, back):
        assert st.count == 300 and st.get("v7")[1] == {"i": 7}
        assert st.search(x[42], k=1)[0][0] == "v42"
    assert json.loads((tmp_path / "t.json").read_text())["vector_count"] == 300


# ------------------------------------------------------------ the Database


def _cfg(tmp_path, **extra):
    return load_config(overrides={"persistence_dir": str(tmp_path / "data"),
                                  "backup_dir": str(tmp_path / "backups"),
                                  **extra}, env={})


def test_default_config_starts_with_persistence(tmp_path):
    cfg = _cfg(tmp_path)
    assert cfg.persistence_enabled and cfg.sync_interval == 30.0
    db = Database(cfg, device="cpu").start()
    try:
        assert db.persistence is not None and db.persistence.device == CPU
        db.create_store("d", metric="cosine")
        db.insert("d", "a", [1.0, 0.0, 0.0])
    finally:
        db.stop()   # syncs on the way down
    db2 = Database(cfg, device="cpu").start()
    try:
        assert db2.search("d", [1.0, 0.0, 0.0], k=1)[0][0] == "a"
    finally:
        db2.stop()


def test_restart_is_bit_identical_for_an_intkey_store(tmp_path):
    """An intkey store adopted by a Database, synced as a base, mutated and
    synced as a delta, then reloaded by a new Database: the same key plane
    bit for bit, and the same ids and distances."""
    x = _corpus(9, 5200, d=40)
    cfg = _cfg(tmp_path, sync_interval=9999)
    db = Database(cfg, device=CPU).start()
    st = VectorStore.from_matrix("a", x[:5000], dtype="int8", metric="cosine",
                                 intkey=True, device=CPU)
    db.registry.adopt(st)
    db.persistence.track(st)
    db.sync("a")
    db.insert_batch("a", [f"n{i}" for i in range(100)], x[5000:5100])
    for i in range(0, 200, 2):
        db.delete("a", str(i))
    db.sync("a")
    assert len(list((tmp_path / "data" / "a").glob("delta_*.npz"))) == 1
    qs = x[5100:5200]
    want = db.search_batch("a", qs, k=10)
    plane = st._codes_unit.clone()
    db.stop()
    db2 = Database(cfg, device=CPU).start()
    try:
        back = db2.get_store("a")
        assert torch.equal(back._codes_unit, plane)
        assert db2.search_batch("a", qs, k=10) == want
    finally:
        db2.stop()


def test_persistence_verbs_and_tools(tmp_path):
    from erlvectordb_tpu_torch.serve.tools import call_tool

    db = Database(_cfg(tmp_path, sync_interval=9999), device=CPU).start()
    try:
        x = _corpus(10, 50, d=8)
        db.create_store("v", metric="euclidean")
        db.insert_batch("v", [f"v{i}" for i in range(50)], x)
        assert call_tool(db, "sync_store", {"store": "v"}) == {"synced": True}
        out = call_tool(db, "backup_store", {"store": "v", "backup_name": "b"})
        [listed] = call_tool(db, "list_backups", {})["backups"]
        assert listed["file"] == out["backup_file"]
        stats = call_tool(db, "restore_store", {
            "backup_file": out["backup_file"], "new_name": "v2"})
        assert stats["count"] == 50
        assert db.search("v2", x[4], k=1)[0][0] == "v4"
        assert call_tool(db, "delete_store", {"store": "v2"}) == {"status": "ok"}
        assert "v2" not in db.list_stores()
    finally:
        db.stop()


@pytest.mark.parametrize("flag", ["sharded", "dim_sharded"])
def test_sharded_snapshots_and_backups_refused(tmp_path, flag):
    """A JAX snapshot and a JAX backup of a store sharded over a device mesh
    (rows over a 4 x 2 mesh, or the feature dimension over 4 devices) load
    in the port onto the logical CPU devices, and the port's snapshot and
    backup of it load in JAX: every load answers with the ids of the JAX
    store that was saved.  (A dim-sharded backup restores as a
    single-device store in both packages.)"""
    from erlvectordb_tpu.parallel import ShardedVectorStore as JSharded
    from erlvectordb_tpu.parallel import make_mesh as jmake_mesh
    from erlvectordb_tpu.parallel.dim_sharded import DimShardedVectorStore as JDim
    from erlvectordb_tpu.parallel.dim_sharded import make_dim_mesh as jdim_mesh
    from erlvectordb_tpu_torch.parallel import mesh as tmesh

    x, q = _corpus(31, 400), _corpus(32, 12)
    ids = [f"v{i}" for i in range(len(x))]
    held = tmesh.cpu_device_count()
    tmesh.set_cpu_device_count(8)
    try:
        if flag == "sharded":
            jm = jmake_mesh(n_data=4, n_replica=2)
            j = JSharded("sh", jm, metric="euclidean", dtype="int8")
            j.insert_batch(ids, x, [{"i": i} for i in range(len(x))])
            tm = tmesh.make_mesh(n_data=4, n_replica=2,
                                 devices=tmesh.cpu_devices())
        else:
            jm = tm = None
            j = JDim.from_matrix("sh", x, mesh=jdim_mesh(4), ids=ids,
                                 metric="euclidean")
        j.delete("v3")
        want = _ids(j.search_batch(q, k=5))
        jsnap.save_store(j, tmp_path / "j")
        t = tsnap.load_store("sh", tmp_path / "j", device=CPU, mesh=tm)
        assert type(t).__name__ == type(j).__name__ and t.count == j.count
        assert _ids(t.search_batch(q, k=5)) == want
        tb = tbackup.restore_store(
            jbackup.backup_store(j, "b", tmp_path / "jb"), device=CPU, mesh=tm)
        assert _ids(tb.search_batch(q, k=5)) == want
        # the port's writes, read by the JAX package
        tsnap.save_store(t, tmp_path / "t")
        j2 = jsnap.load_store("sh", tmp_path / "t", mesh=jm)
        assert type(j2).__name__ == type(j).__name__
        assert _ids(j2.search_batch(q, k=5)) == want
        j3 = jbackup.restore_store(
            tbackup.backup_store(t, "b", tmp_path / "tb"), mesh=jm)
        assert _ids(j3.search_batch(q, k=5)) == want
    finally:
        tmesh.set_cpu_device_count(held)


def test_deleted_store_stays_deleted_after_restart(tmp_path):
    """delete_store removes the store's snapshot and its indexes'
    artifacts, so a restart does not bring them back (the JAX package's
    delete_store leaves the snapshot, and its next start reloads it)."""
    from erlvectordb_tpu.api import Database as JaxDatabase
    from erlvectordb_tpu.infra.config import load_config as jax_load_config

    x = _corpus(11, 40, d=8)
    overrides = {"persistence_dir": str(tmp_path / "data"),
                 "backup_dir": str(tmp_path / "backups"),
                 "sync_interval": 9999}
    db = Database(load_config(overrides=overrides, env={}), device=CPU).start()
    for name in ("gone", "kept"):
        db.create_store(name, metric="euclidean")
        db.insert_batch(name, [f"v{i}" for i in range(40)], x)
        db.sync(name)
    db.create_index("gi", "gone", "int8")
    db.build_index("gi")
    assert db.delete_store("gone")
    db.stop()
    assert not (tmp_path / "data" / "gone").exists()
    assert not (tmp_path / "data" / "indexes" / "idx_gi").exists()
    db2 = Database(load_config(overrides=overrides, env={}), device=CPU).start()
    try:
        assert db2.list_stores() == ["kept"] and db2.list_indexes() == []
    finally:
        db2.stop()
    # the reference's behaviour, for the record
    jdb = JaxDatabase(jax_load_config(overrides=overrides, env={})).start()
    jdb.create_store("jgone")
    jdb.insert("jgone", "a", [1.0, 0.0])
    jdb.sync("jgone")
    assert jdb.delete_store("jgone")
    jdb.stop()
    jdb2 = JaxDatabase(jax_load_config(overrides=overrides, env={})).start()
    try:
        assert "jgone" in jdb2.list_stores()
    finally:
        jdb2.persistence.close()
