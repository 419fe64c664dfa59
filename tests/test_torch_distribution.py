"""The port's distribution layer (erlvectordb_tpu_torch/parallel/) against
the JAX package's, on the CPU: the same seeded numpy inputs go through the
JAX package on its 8 virtual CPU devices and through the port on 8 logical
CPU devices.

  * sharded store: float32 and int8 x cosine, euclidean and dot on 8 x 1 and
    4 x 2 meshes, after a bulk build, inserts past a shard's capacity (the
    shards grow), deletes and a ``where=`` mask: equal ids, and distances to
    the tolerance tests/test_torch_store.py states for the same exact scans
    (atol 1e-5; rtol 1e-6, 1e-5 for euclidean);
  * a JAX store carried across by ``export_state`` -> ``from_state`` on the
    same mesh shape and on another shard count (each package's from_state
    re-shards by re-inserting; the codes must be equal);
  * the dim-sharded store, including manhattan: its sums of per-device
    partials are f32 sums in another order, so the float-key rule holds:
    overlap@10 >= 0.99 and distances allclose (rtol 1e-5, atol 1e-5);
  * the EP IVF and EP cell probe, built by JAX and carried over with
    ``to_arrays`` / ``from_arrays`` so both hold the same cells, at nprobe 4
    and 16: the float-key rule (the cell probe's bf16 dots are f32 sums of
    exact products, in another order);
  * failover: fail_device / recover_device on a 4 x 2 cluster leave the same
    ids in both packages.

Snapshots and backups of sharded and dim-sharded stores cross between the
packages in tests/test_torch_durability.py."""

import numpy as np
import pytest
import torch

import erlvectordb_tpu.parallel as jpar
from erlvectordb_tpu.parallel.dim_sharded import DimShardedVectorStore as JDim
from erlvectordb_tpu.parallel.dim_sharded import make_dim_mesh as jdim_mesh
from erlvectordb_tpu.parallel.ep_cell_probe import EPCellProbeIndex as JEPCP
from erlvectordb_tpu.parallel.ep_ivf import EPIVFIndex as JEPIVF
from erlvectordb_tpu_torch.parallel import (
    ClusterManager,
    ShardedVectorStore,
    cpu_devices,
    make_mesh,
)
from erlvectordb_tpu_torch.parallel.dim_sharded import (
    DimShardedVectorStore,
    make_dim_mesh,
)
from erlvectordb_tpu_torch.parallel.ep_cell_probe import EPCellProbeIndex
from erlvectordb_tpu_torch.parallel.ep_ivf import EPIVFIndex
from erlvectordb_tpu_torch.parallel.mesh import cpu_device_count, set_cpu_device_count

torch.set_num_threads(2)

CPU = torch.device("cpu")
MESHES = {"8x1": (8, 1), "4x2": (4, 2)}


@pytest.fixture(scope="module", autouse=True)
def eight_cpu_devices():
    held = cpu_device_count()
    set_cpu_device_count(8)
    yield cpu_devices()
    set_cpu_device_count(held)


def _clustered(seed, n, d=48, centres=32, noise=0.35):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centres, d)).astype(np.float32)
    return (c[rng.integers(0, centres, n)]
            + noise * rng.standard_normal((n, d))).astype(np.float32)


def _meshes(shape):
    n_data, n_rep = MESHES[shape]
    return (jpar.make_mesh(n_data=n_data, n_replica=n_rep),
            make_mesh(n_data=n_data, n_replica=n_rep, devices=cpu_devices()))


def _assert_same_hits(got, want, metric):
    rtol = 1e-5 if metric == "euclidean" else 1e-6
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [h[0] for h in g] == [h[0] for h in w]
        assert [h[1] for h in g] == [h[1] for h in w]
        np.testing.assert_allclose([h[2] for h in g], [h[2] for h in w],
                                   atol=1e-5, rtol=rtol)


def _float_key(d_t, r_t, d_j, r_j, k=10):
    """overlap@k >= 0.99, and the distances of the rows both return agree
    to rtol 1e-5 / atol 1e-5."""
    hits = [len(set(a[a >= 0]) & set(b[b >= 0])) for a, b in zip(r_t, r_j)]
    assert sum(hits) / (k * len(r_t)) >= 0.99, sum(hits) / (k * len(r_t))
    same = r_t == r_j
    np.testing.assert_allclose(d_t[same], d_j[same], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", sorted(MESHES))
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_sharded_store_matches_jax(shape, metric, dtype):
    jm, tm = _meshes(shape)
    x = _clustered(1, 1500)
    extra = _clustered(2, 1400)  # past every shard's bulk capacity (256)
    q = _clustered(3, 24)
    stores = []
    for pkg, mesh in ((jpar.ShardedVectorStore, jm), (ShardedVectorStore, tm)):
        st = pkg.from_matrix("d", mesh, x, metric=metric, dtype=dtype)
        st.insert_batch([f"n{i}" for i in range(len(extra))], extra,
                        [{"odd": i % 2} for i in range(len(extra))])
        for vid in ("5", "77", "n3", "n400"):
            assert st.delete(vid)
        stores.append(st)
    j, t = stores
    assert t.count == j.count and t.capacity == j.capacity > 8 * 256
    assert t.get_stats()["per_shard_counts"] == j.get_stats()["per_shard_counts"]
    assert t.device_memory_bytes() == j.device_memory_bytes()
    _assert_same_hits(t.search_batch(q, k=10), j.search_batch(q, k=10), metric)
    _assert_same_hits(t.search_batch(q, k=10, where={"odd": 1}),
                      j.search_batch(q, k=10, where={"odd": 1}), metric)


@pytest.mark.parametrize("target", ["4x2", "8x1"])
def test_jax_store_carried_across(target):
    """A JAX store on a 4 x 2 mesh, exported and loaded onto the target
    mesh by each package's from_state (onto 8 x 1 both re-shard by
    re-inserting the dequantized rows): the port's answers are the JAX
    store's."""
    jm, _ = _meshes("4x2")
    jt, tm = _meshes(target)
    x, q = _clustered(4, 900), _clustered(5, 16)
    j = jpar.ShardedVectorStore("c", jm, metric="euclidean", dtype="int8")
    j.insert_batch([f"v{i}" for i in range(len(x))], x,
                   [{"i": i} for i in range(len(x))])
    j.delete("v10")
    state = {k: (np.asarray(v) if hasattr(v, "shape") else v)
             for k, v in j.export_state().items()}
    t = ShardedVectorStore.from_state(state, tm)
    want = jpar.ShardedVectorStore.from_state(j.export_state(), jt)
    assert t.count == want.count == j.count
    assert t.n_shards == want.n_shards == tm.shape["data"]
    np.testing.assert_array_equal(t.export_state()["vectors"],
                                  np.asarray(want.export_state()["vectors"]))
    _assert_same_hits(t.search_batch(q, k=10), want.search_batch(q, k=10),
                      "euclidean")


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot", "manhattan"])
def test_dim_sharded_store_matches_jax(metric):
    x, q = _clustered(6, 700, d=200), _clustered(7, 16, d=200)
    ids = [f"v{i}" for i in range(len(x))]
    j = JDim.from_matrix("w", x, mesh=jdim_mesh(4), ids=ids, metric=metric)
    t = DimShardedVectorStore.from_matrix(
        "w", x, mesh=make_dim_mesh(4, devices=cpu_devices()), ids=ids,
        metric=metric)
    for st in (j, t):
        st.insert_batch(["p0", "p1"], x[:2] * 1.5)
        st.delete("v9")
    assert t.count == j.count and t.capacity == j.capacity

    def cols(hits):
        d = np.array([[h[2] for h in row] for row in hits], np.float32)
        r = np.array([[int(h[0][1:]) + (10**6 if h[0][0] == "p" else 0)
                       for h in row] for row in hits])
        return d, r

    d_t, r_t = cols(t.search_batch(q, k=10, metric=metric))
    d_j, r_j = cols(j.search_batch(q, k=10, metric=metric))
    _float_key(d_t, r_t, d_j, r_j)


@pytest.mark.parametrize("nprobe", [4, 16])
@pytest.mark.parametrize("kind", ["ep_ivf", "ep_cellprobe"])
def test_ep_indexes_match_jax(kind, nprobe):
    x = _clustered(8, 6000, d=32, centres=48)
    q = _clustered(9, 64, d=32, centres=48)
    rows = np.arange(len(x))
    jm = jpar.make_mesh(n_data=8, n_replica=1)
    tm = make_mesh(n_data=8, n_replica=1, devices=cpu_devices())
    if kind == "ep_ivf":
        norms = np.linalg.norm(x, axis=1).astype(np.float32)
        j = JEPIVF.build(x, rows.astype(np.int32), norms, jm, n_cells=60,
                         iters=6)
        t = EPIVFIndex.from_arrays(
            {k: np.asarray(v) for k, v in j.to_arrays().items()}, tm)
        metrics = ("euclidean", "cosine")
    else:
        xp = np.pad(x, ((0, 0), (0, 96)))
        j = JEPCP.build(xp, rows, jm, cell_rows=40, cell_cap=48, iters=6)
        t = EPCellProbeIndex.from_arrays(
            {k: np.asarray(v) for k, v in j.to_arrays().items()}, tm)
        metrics = ("cosine", "euclidean")
    assert t.n_cells == j.n_cells and t.stats()["rows"] == j.stats()["rows"]
    for metric in metrics:
        d_t, r_t = t.search(q, k=10, nprobe=nprobe, metric=metric)
        d_j, r_j = j.search(q, k=10, nprobe=nprobe, metric=metric)
        _float_key(d_t, r_t, np.asarray(d_j), np.asarray(r_j))


def test_failover_leaves_the_same_ids():
    x, q = _clustered(10, 800), _clustered(11, 16)
    ids = [f"v{i}" for i in range(len(x))]
    managers = (jpar.ClusterManager(replication_factor=2),
                ClusterManager(devices=cpu_devices(), replication_factor=2))
    answers = []
    for cm in managers:
        st = cm.distribute_store("f")
        st.insert_batch(ids, x)
        got = [_ids(cm, q)]
        dead = cm.get_node_status()[1]["id"]
        stats = cm.fail_device(dead)
        assert stats["replica_groups"] == 1 and stats["healthy_devices"] == 7
        got.append(_ids(cm, q))
        assert cm.recover_device(dead)["replica_groups"] == 2
        assert all(cm.probe_devices().values())
        got.append(_ids(cm, q))
        answers.append(got)
    assert answers[0] == answers[1]
    assert answers[1][0] == answers[1][1] == answers[1][2]


def _ids(cm, q):
    return [[h[0] for h in row] for row in cm.get_store("f").search_batch(q, k=10)]


def test_from_store_takes_the_dequantized_rows_like_jax():
    """``from_store`` (``distribute_store``) re-inserts the rows of
    ``get_all_vectors``, which are dequantized: in the JAX package the
    migrated int8 store's norms are the dequantized rows', not the original
    f32 rows' the local store kept, so near-ties among its answers move
    (ROADMAP Queue C).  The port migrates alike: the same codes, the same
    norms to f32 rounding, the same answers."""
    import erlvectordb_tpu.core.store as jstore
    from erlvectordb_tpu_torch.core.store import VectorStore

    x, q = _clustered(12, 2000), _clustered(13, 16)
    jm, tm = _meshes("8x1")
    j = jpar.ShardedVectorStore.from_store(
        jstore.VectorStore.from_matrix("c", x, dtype="int8", metric="cosine"), jm)
    t = ShardedVectorStore.from_store(
        VectorStore.from_matrix("c", x, dtype="int8", metric="cosine",
                                device=CPU), tm)
    js, ts = j.export_state(), t.export_state()
    np.testing.assert_array_equal(ts["vectors"], np.asarray(js["vectors"]))
    np.testing.assert_allclose(ts["norms"], np.asarray(js["norms"]), rtol=1e-6)
    slots = np.array([js["id_to_slot"][str(i)] for i in range(len(x))])
    moved = np.abs(np.asarray(js["norms"])[slots[:, 0], slots[:, 1]]
                   - np.linalg.norm(x, axis=1))
    assert moved.max() > 1e-4  # the reference's norms left the f32 rows'
    _assert_same_hits(t.search_batch(q, k=10), j.search_batch(q, k=10), "cosine")
