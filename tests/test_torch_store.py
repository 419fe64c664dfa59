"""The port's VectorStore (erlvectordb_tpu_torch/core/store.py) against the
JAX package's, on the CPU, plus the cases of tests/test_store.py that apply
to f32/int8 stores, re-pointed at the port.

Both stores get the same seeded numpy data.  On the CPU both answer through
their exact scans (the fused paths are gated to a TPU / CUDA device), where
int8 dots are exact: ids agree exactly and distances to 1e-5 (f32 norms and
sums are accumulated in another order).  The intkey cases force the port's
fused dispatch on the CPU (the wrappers then run their plain versions), so
the key-plane wiring runs here as it does on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erlvectordb_tpu.core.store as jstore
import erlvectordb_tpu.ops.fused_topk as jft
import erlvectordb_tpu_torch.ops.fused_topk as tft
from erlvectordb_tpu_torch.core import (
    DimensionMismatch,
    InvalidVector,
    StoreExists,
    StoreNotFound,
    StoreRegistry,
    VectorStore,
)

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _clustered(rng, n, d=100, centers=32, noise=0.35):
    c = rng.standard_normal((centers, d)).astype(np.float32)
    a = rng.integers(0, centers, n)
    return (c[a] + noise * rng.standard_normal((n, d))).astype(np.float32)


def _assert_same_hits(got, want, metric=None):
    """Same ids and metadata in the same order; distances to 1e-5, plus a
    relative term where f32 itself is coarser: dot distances reach |q||x| ~
    100, where one f32 step is 7.6e-6 (rtol 1e-6, a few steps); euclidean
    distances come from the |q|^2 - 2 q.x + |x|^2 expansion, which cancels
    near a match, so f32 norms and sums taken in another order than XLA's
    move a distance of ~1 by ~1e-5 (rtol 1e-5)."""
    rtol = 1e-5 if metric == "euclidean" else 1e-6
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [h[0] for h in g] == [h[0] for h in w]
        assert [h[1] for h in g] == [h[1] for h in w]
        np.testing.assert_allclose([h[2] for h in g], [h[2] for h in w],
                                   atol=1e-5, rtol=rtol)


STORE_KINDS = [("float32", False), ("int8", False), ("int8", True)]
KIND_IDS = ["f32", "int8", "int8-intkey"]


# ------------------------------------------------------- parity with the JAX


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
@pytest.mark.parametrize("dtype,intkey", STORE_KINDS, ids=KIND_IDS)
def test_from_matrix_search_matches_jax(rng, metric, dtype, intkey):
    data = _clustered(rng, 3000)
    qs = _clustered(np.random.default_rng(9), 24)
    j = jstore.VectorStore.from_matrix("p", data, metric=metric, dtype=dtype,
                                       intkey=intkey)
    t = VectorStore.from_matrix("p", data, metric=metric, dtype=dtype,
                                device=CPU, intkey=intkey)
    assert t.count == j.count and t.capacity == j.capacity
    assert t.device_memory_bytes() == j.device_memory_bytes()
    _assert_same_hits(t.search_batch(qs, k=10), j.search_batch(qs, k=10),
                      metric)
    if intkey:  # the bulk-built key plane: same codes up to norm rounding
        diff = np.abs(t._codes_unit.numpy().astype(np.int32)
                      - np.asarray(j._codes_unit).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        if metric != "cosine":
            assert t._plane_scale == pytest.approx(j._plane_scale, rel=1e-6)


@pytest.mark.parametrize("dtype,intkey", STORE_KINDS, ids=KIND_IDS)
def test_insert_delete_filter_match_jax(rng, dtype, intkey):
    data = _clustered(rng, 1500, d=40)
    metas = [{"cat": i % 3, "hot": i % 50 == 0} for i in range(len(data))]
    ids = [f"v{i}" for i in range(len(data))]
    stores = [cls("s", dtype=dtype, intkey=intkey, **kw)
              for cls, kw in ((jstore.VectorStore, {}),
                              (VectorStore, {"device": CPU}))]
    for st in stores:
        st.insert_batch(ids[:1200], data[:1200], metas[:1200])
        st.insert_batch(ids[1200:], data[1200:], metas[1200:])  # grows
        st.insert("v7", data[8] * 0.5 + 0.2, {"cat": 9})        # overwrite
        assert st.delete("v11") and not st.delete("v11")
        assert st.delete_batch(["v12", "v13", "nope"]) == 2
        st.insert("fresh", data[20] + 0.01, {"cat": 1})         # reuses a row
    t, j = stores[1], stores[0]
    assert t.count == j.count and t.version == j.version
    assert t.get_stats() | {"memory_bytes": 0} == j.get_stats() | {"memory_bytes": 0}
    qs = data[:16] + 0.05
    _assert_same_hits(t.search_batch(qs, k=8), j.search_batch(qs, k=8))
    for where in ({"cat": 1}, {"cat": 0, "hot": True}, {"cat": 9}, {"cat": 7}):
        _assert_same_hits(t.search_batch(qs, k=5, where=where),
                          j.search_batch(qs, k=5, where=where))
    vt, mt = t.get("v7")
    vj, mj = j.get("v7")
    np.testing.assert_allclose(vt, vj, atol=1e-6)
    assert mt == mj == {"cat": 9}


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
@pytest.mark.parametrize("dtype,intkey", STORE_KINDS, ids=KIND_IDS)
def test_from_state_of_jax_store(rng, metric, dtype, intkey):
    data = _clustered(rng, 2000)
    j = jstore.VectorStore.from_matrix("st", data, metric=metric, dtype=dtype,
                                       intkey=intkey)
    j.delete("5")
    j.insert("x", data[9] * 2.0 + 0.3, {"m": 1})
    t = VectorStore.from_state(j.export_state(), device=CPU)
    assert (t.count, t.dtype, t.metric, t.intkey) == (j.count, dtype, metric,
                                                      intkey)
    qs = data[:12] + 0.1
    _assert_same_hits(t.search_batch(qs, k=10), j.search_batch(qs, k=10),
                      metric)
    assert t.get("5") is None and t.get("x")[1] == {"m": 1}
    if intkey:  # re-derived from the absmax plane, as the JAX store derives it
        st = j.export_state()
        args = [jnp.asarray(st[key]) for key in ("vectors", "scales")]
        if metric == "cosine":
            plane = jft.requantize_unit(*args, jnp.asarray(st["norms"]),
                                        jnp.asarray(st["valid"]))
        else:
            s = 1.25 * float(st["norms"][st["valid"]].max())
            assert t._plane_scale == s
            plane = jft.requantize_mag(*args, jnp.asarray(st["valid"]), s)
        np.testing.assert_array_equal(t._codes_unit.numpy(), np.asarray(plane))
    # and the port's own state round-trips
    back = VectorStore.from_state(t.export_state(), device=CPU)
    _assert_same_hits(back.search_batch(qs, k=10), t.search_batch(qs, k=10))


@pytest.mark.parametrize("kind", ["int4", "int4r"])
def test_unported_dtypes_refused(rng, kind):
    """int4 and int4r stores are ported.  Multiprobe search answers on int4r
    (its cell layout) and is refused on int4 as the JAX package refuses it;
    the int4r second stage (rq_m) builds and searches on int4r and is
    refused on other dtypes."""
    data = rng.standard_normal((300, 8)).astype(np.float32)
    st = VectorStore.from_matrix("x", data, dtype=kind, device=CPU)
    assert st.count == 300 and st.dtype == kind
    if kind == "int4":
        with pytest.raises(ValueError, match="int4r"):
            st.search(data[0], k=3, nprobe=4)
        with pytest.raises(ValueError, match="int4r"):
            VectorStore.from_matrix("y", data, dtype=kind, device=CPU, rq_m=4)
    else:
        assert st.search(data[0], k=3, nprobe=4)[0][0] == "0"
        rq = VectorStore.from_matrix("y", data, dtype=kind, device=CPU, rq_m=4)
        assert rq._rq_codes.shape == (rq.capacity, 4)
        assert rq.search(data[0], k=3, nprobe=4)[0][0] == "0"


def test_multiprobe_refused(rng):
    """Multiprobe search needs a cell layout: f32 stores refuse nprobe and
    recall_target with the JAX package's error."""
    data = rng.standard_normal((50, 8))
    st = VectorStore.from_matrix("m", data, device=CPU)
    js = jstore.VectorStore.from_matrix("m", data)
    for kw in ({"nprobe": 4}, {"recall_target": 0.9}):
        with pytest.raises(ValueError, match="int4r") as got:
            st.search(np.ones(8), k=3, **kw)
        with pytest.raises(ValueError, match="int4r") as want:
            js.search(np.ones(8), k=3, **kw)
        assert str(got.value) == str(want.value).split(";")[0]


# ------------------------------------- tests/test_store.py, re-pointed


@pytest.fixture
def registry():
    return StoreRegistry(CPU)


def _mk(name="t", **kw):
    return VectorStore(name, device=CPU, **kw)


DTYPES = pytest.mark.parametrize("dtype", ["float32", "int8"])


@DTYPES
def test_create_and_stats(registry, dtype):
    registry.create("s1", dim=4, dtype=dtype)
    stats = registry.get("s1").get_stats()
    assert (stats["name"], stats["count"], stats["dimension"],
            stats["dtype"]) == ("s1", 0, 4, dtype)
    with pytest.raises(StoreExists):
        registry.create("s1")
    with pytest.raises(StoreNotFound):
        registry.get("nope")


@DTYPES
def test_insert_and_search_top1_identity(dtype):
    store = _mk(dtype=dtype)
    store.insert("a", [1.0, 0.0, 0.0], {"tag": "a"})
    store.insert("b", [0.0, 1.0, 0.0], {"tag": "b"})
    store.insert("c", [0.7, 0.7, 0.0], {"tag": "c"})
    res = store.search([1.0, 0.0, 0.0], k=2)
    assert len(res) == 2
    vid, meta, dist = res[0]
    assert (vid, meta) == ("a", {"tag": "a"})
    assert dist == pytest.approx(0.0, abs=1e-5)
    assert res[0][2] <= res[1][2]


@DTYPES
def test_insert_overwrites_delete_and_reuse(dtype):
    store = _mk(dtype=dtype)
    store.insert("x", [1.0, 0.0], {"v": 1})
    store.insert("x", [0.0, 1.0], {"v": 2})
    assert store.count == 1
    vec, meta = store.get("x")
    assert meta == {"v": 2}
    np.testing.assert_allclose(vec, [0.0, 1.0], atol=1e-6)
    store.insert("b", [1.0, 0.0])
    assert store.delete("x") and not store.delete("x")
    assert [r[0] for r in store.search([0.0, 1.0], k=5)] == ["b"]
    store.insert("c", [0.5, 0.5])
    assert store.count == 2
    assert store.search([0.5, 0.5], k=1)[0][0] == "c"


@pytest.mark.parametrize("case", ["dim", "first_insert", "nan", "inf",
                                  "non_numeric", "search_dim"])
def test_validation(case):
    if case == "dim":
        with pytest.raises(DimensionMismatch):
            _mk(dim=3).insert("a", [1.0, 2.0])
    elif case == "first_insert":
        st = _mk()
        st.insert("a", [1.0, 2.0])
        with pytest.raises(DimensionMismatch):
            st.insert("b", [1.0, 2.0, 3.0])
    elif case in ("nan", "inf"):
        with pytest.raises(InvalidVector):
            _mk().insert("a", [1.0, float(case)])
    elif case == "non_numeric":
        with pytest.raises((InvalidVector, ValueError)):
            _mk().insert("a", [1.0, "zap"])
    else:
        st = _mk(dim=3)
        st.insert("a", [1.0, 0.0, 0.0])
        with pytest.raises(DimensionMismatch):
            st.search([1.0, 0.0], k=1)


@DTYPES
def test_search_semantics(dtype):
    store = _mk(dtype=dtype)
    assert _mk(dim=2).search([1.0, 0.0], k=3) == []
    store.insert("a", [1.0, 0.0])
    assert len(store.search([1.0, 0.0], k=100)) == 1
    store.insert("zero", [0.0, 0.0])
    # reference semantics: zero-norm -> cosine distance 1.0
    res = dict((h[0], h[2]) for h in store.search([1.0, 0.0], k=2))
    assert res["zero"] == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "manhattan", "dot"])
def test_metrics_match_numpy(rng, metric):
    n, d, k = 300, 16, 5
    data = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal(d).astype(np.float32)
    store = _mk(metric=metric)
    store.insert_batch([f"v{i}" for i in range(n)], data)
    if metric == "cosine":
        ref = 1.0 - data @ q / (np.linalg.norm(data, axis=1) * np.linalg.norm(q))
    elif metric == "euclidean":
        ref = np.linalg.norm(data - q, axis=1)
    elif metric == "manhattan":
        ref = np.abs(data - q).sum(axis=1)
    else:
        ref = -(data @ q)
    got = np.array([r[2] for r in store.search(q, k=k)])
    np.testing.assert_allclose(got, np.sort(ref)[:k], atol=1e-3)
    batch = store.search_batch(data[:7], k=1)
    if metric != "dot":
        assert [r[0][0] for r in batch] == [f"v{i}" for i in range(7)]


@DTYPES
def test_grow_past_initial_capacity(rng, dtype):
    store = _mk(dtype=dtype)
    data = rng.standard_normal((2500, 4)).astype(np.float32)
    store.insert_batch([f"v{i}" for i in range(2500)], data)
    assert store.count == 2500 and store.capacity >= 2500
    assert store.search(data[1234], k=1)[0][0] == "v1234"


def test_int8_roundtrip_and_recall(rng):
    n, d, k = 1000, 32, 10
    data = rng.standard_normal((n, d)).astype(np.float32)
    ids = [f"v{i}" for i in range(n)]
    quant = _mk("q", dtype="int8")
    quant.insert_batch(ids, data)
    vec, _ = quant.get("v7")
    assert np.max(np.abs(vec - data[7])) <= np.abs(data[7]).max() / 127 + 1e-6
    assert quant.search(data[42], k=1)[0][0] == "v42"
    exact = _mk("f32")
    exact.insert_batch(ids, data)
    qs = rng.standard_normal((20, d)).astype(np.float32)
    recall = np.mean([len({x[0] for x in a} & {x[0] for x in b}) / k
                      for a, b in zip(exact.search_batch(qs, k=k),
                                      quant.search_batch(qs, k=k))])
    assert recall >= 0.9


@DTYPES
def test_accessors_and_export(rng, dtype):
    store = _mk(metric="euclidean", dtype=dtype)
    data = rng.standard_normal((50, 8)).astype(np.float32)
    store.insert_batch([f"v{i}" for i in range(50)], data,
                       [{"i": i} for i in range(50)])
    by_id = {vid: (vec, meta) for vid, vec, meta in store.get_all_vectors()}
    assert len(by_id) == 50 and by_id["v3"][1] == {"i": 3}
    np.testing.assert_allclose(by_id["v3"][0], data[3],
                               atol=1e-6 if dtype == "float32" else 0.03)
    store.delete("v10")
    clone = VectorStore.from_state(store.export_state(), device=CPU)
    assert clone.count == 49 and clone.metric == "euclidean"
    assert clone.search(data[20], k=1)[0][0] == "v20"
    assert clone.get("v10") is None


@DTYPES
def test_from_matrix_ids(rng, dtype):
    data = rng.standard_normal((2000, 16)).astype(np.float32)
    store = VectorStore.from_matrix("bulk", data, dtype=dtype, device=CPU)
    assert store.count == 2000
    assert store.search(data[123], k=1)[0][0] == "123"
    assert "1999" in store and "2000" not in store
    for bad in ("007", "+7", " 7"):
        assert bad not in store
    store.delete("7")  # first mutation materializes the id tables
    assert store.count == 1999
    assert store.search(data[7], k=1)[0][0] != "7"
    named = VectorStore.from_matrix("bulk2", data[:100], dtype=dtype,
                                    ids=[f"x{i}" for i in range(100)],
                                    device=CPU)
    assert named.search(data[5], k=1)[0][0] == "x5"
    clone = VectorStore.from_state(named.export_state(), device=CPU)
    assert clone.search(data[9], k=1)[0][0] == "x9"


@pytest.mark.parametrize("case", ["equality", "no_match", "self_match"])
def test_where_filters(rng, case):
    store = _mk(metric="euclidean")
    if case == "no_match":
        store.insert("a", [1.0, 0.0], {"x": 1})
        assert store.search([1.0, 0.0], k=3, where={"x": 2}) == []
        return
    data = rng.standard_normal((100, 8)).astype(np.float32)
    if case == "equality":
        metas = [{"cat": "a" if i % 2 == 0 else "b", "n": i % 3}
                 for i in range(100)]
        store.insert_batch([f"v{i}" for i in range(100)], data, metas)
        res = store.search(data[3], k=5, where={"cat": "b"})
        assert all(int(r[0][1:]) % 2 == 1 for r in res)
        res = store.search(data[3], k=50, where={"cat": "a", "n": 0})
        assert all(r[1] == {"cat": "a", "n": 0} for r in res)
    else:
        store.insert_batch([f"v{i}" for i in range(50)], data[:50],
                           [{"g": i // 10} for i in range(50)])
        assert store.search(data[25], k=1, where={"g": 2})[0][0] == "v25"


def test_warmup_counts_searches(rng):
    store = _mk("w1")
    store.insert_batch([f"v{i}" for i in range(20)],
                       rng.standard_normal((20, 8)).astype(np.float32))
    assert store.warmup(batch_sizes=(1, 4), ks=(1, 5)) == 4
    assert _mk("w2", dim=4).warmup() == 0


def _columnar(rng, n=512, d=16):
    data = rng.standard_normal((n, d)).astype(np.float32)
    metas = [{"cat": i % 4, "hot": i % 100 == 0} for i in range(n)]
    store = VectorStore.from_matrix("filt", data, ids=[f"v{i}" for i in range(n)],
                                    metadatas=metas, device=CPU)
    return store, data


@pytest.mark.parametrize("case", ["slow_path", "results", "overwrite", "delete",
                                  "growth", "unhashable", "cache", "unseen"])
def test_columnar_filtering(rng, case):
    store, data = _columnar(rng, n=100 if case == "growth" else 512)
    if case == "slow_path":
        slow = np.zeros(store.capacity, bool)
        for vid, meta in store._metadata.items():
            if meta.get("cat") == 2:
                slow[store._id_to_row[vid]] = True
        np.testing.assert_array_equal(store.filter_mask({"cat": 2}), slow)
    elif case == "results":
        for row in store.search_batch(data[:8], k=4, where={"cat": 1}):
            assert row and all(meta["cat"] == 1 for _, meta, _ in row)
    elif case == "overwrite":
        store.filter_mask({"cat": 3})
        store.insert("v7", data[7], {"cat": 999})
        row7 = store._id_to_row["v7"]
        assert store.filter_mask({"cat": 999})[row7]
        assert not store.filter_mask({"cat": 3})[row7]
        store.insert("v7", data[7], {"other": 1})
        assert not store.filter_mask({"cat": 999})[row7]
    elif case == "delete":
        store.filter_mask({"cat": 0})
        row = store._id_to_row["v4"]
        store.delete("v4")
        assert not store.filter_mask({"cat": 0})[row]
    elif case == "growth":
        store.filter_mask({"cat": 1})
        more = rng.standard_normal((2000, 16)).astype(np.float32)
        store.insert_batch([f"n{i}" for i in range(2000)], more,
                           [{"cat": 1}] * 2000)
        assert store.filter_mask({"cat": 1}).sum() == 25 + 2000
    elif case == "unhashable":
        store.insert("weird", data[0], {"cat": [1, 2]})
        m = store.filter_mask({"cat": [1, 2]})
        assert m[store._id_to_row["weird"]] and m.sum() == 1
    elif case == "cache":
        assert store.search(data[8], k=1, where={"cat": 0})[0][0] == "v8"
        store.delete("v8")
        assert store.search(data[8], k=1, where={"cat": 0})[0][0] != "v8"
    else:
        assert store.filter_mask({"cat": 12345}).sum() == 0
        assert store.search(data[0], k=3, where={"cat": 12345}) == []


@pytest.mark.parametrize("case", ["new_ids", "existing_id", "metadata",
                                  "delete_batch"])
def test_duplicate_ids(case):
    st = _mk("dup")
    if case == "new_ids":
        v1 = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
        v2 = np.array([0.0, 1.0, 0.0, 0.0], np.float32)
        st.insert_batch(["a", "a"], np.stack([v1, v2]))
        assert st.count == 1
        np.testing.assert_allclose(st.get("a")[0][:4], v2, atol=1e-6)
        assert [h[0] for h in st.search(v1, k=2)] == ["a"]
        assert st.delete("a") and st.count == 0
        assert st.search(v1, k=1) == []
    elif case == "existing_id":
        st.insert("x", [1.0, 0.0])
        st.insert_batch(["x", "x"], np.array([[0.0, 1.0], [0.0, -1.0]], np.float32))
        np.testing.assert_allclose(st.get("x")[0][:2], [0.0, -1.0], atol=1e-6)
        assert st.count == 1
    elif case == "metadata":
        st.insert_batch(["m", "m"], np.array([[1.0, 0.0], [0.0, 1.0]], np.float32),
                        [{"v": 1}, {"v": 2}])
        assert st.get("m")[1] == {"v": 2}
    else:
        st.insert("a", [1.0, 0.0])
        st.insert("b", [0.0, 1.0])
        assert st.delete_batch(["a", "a", "b"]) == 2
        assert st.count == 0 and st.version > 1


# ------------------- intkey stores through the fused dispatch (plain scans)


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """Lower the key-path gate and let the store's fused dispatch run on the
    CPU, where each kernel wrapper takes its plain version."""
    monkeypatch.setattr(tft, "POS_MIN_TILES", 1)
    real = tft.fused_topk_available
    monkeypatch.setattr(
        tft, "fused_topk_available",
        lambda count, cap, metric, device, k=10: real(
            count, cap, metric, torch.device("cuda"), k))


def _keyed(rng, metric="cosine", n=5000, d=64, spread=False):
    data = rng.standard_normal((n, d)).astype(np.float32)
    if spread:  # heterogeneous magnitudes so euclidean/dot genuinely differ
        data *= (1.0 + 2.0 * rng.random((n, 1))).astype(np.float32)
    store = VectorStore("ik", dtype="int8", intkey=True, metric=metric,
                        device=CPU)
    store.insert_batch([f"v{i}" for i in range(n)], data)
    return store, data


def test_intkey_requires_int8():
    with pytest.raises(ValueError):
        VectorStore("bad", dtype="float32", intkey=True, device=CPU)


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_intkey_search_matches_plain_int8(rng, fused_on_cpu, metric):
    store, data = _keyed(rng, metric, n=20000, spread=metric != "cosine")
    assert (store._codes_unit is not None) == (metric == "cosine")
    assert store.search(data[42], k=1)[0][0] == "v42"
    assert store._codes_unit is not None  # mag planes derive on first search
    plain = VectorStore("pl", dtype="int8", metric=metric, device=CPU)
    plain.insert_batch([f"v{i}" for i in range(len(data))], data)
    qs = rng.standard_normal((16, data.shape[1])).astype(np.float32)
    hits = sum(len({x[0] for x in a} & {x[0] for x in b})
               for a, b in zip(store.search_batch(qs, k=10),
                               plain.search_batch(qs, k=10)))
    assert hits / 160 >= 0.9


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_intkey_delete_zeroes_plane_and_excludes(rng, fused_on_cpu, metric):
    store, data = _keyed(rng, metric, spread=metric != "cosine")
    store.search(data[0], k=1)  # materialize a lazy plane
    assert store.delete("v42")
    assert np.all(store._codes_unit[42].numpy() == 0)
    assert "v42" not in [r[0] for r in store.search(data[42], k=3)]


def test_intkey_overwrite_and_outgrown_scale(rng, fused_on_cpu):
    store, data = _keyed(rng)
    newv = rng.standard_normal(data.shape[1]).astype(np.float32)
    store.insert("v7", newv)
    assert store.search(newv, k=1)[0][0] == "v7"
    mag, data = _keyed(rng, "euclidean", spread=True)
    mag.search(data[0], k=1)
    big = (data[7] * 100.0).astype(np.float32)
    mag.insert("vbig", big)
    assert mag._codes_unit is None and mag._plane_scale is None
    assert mag.search(big, k=1)[0][0] == "vbig"
    assert mag._plane_scale > np.linalg.norm(big)
    # a metric outside the plane's kind rides the pos path, still correct
    assert mag.search(data[42], k=1, metric="cosine")[0][0] == "v42"


def test_intkey_memory_reports_plane(rng):
    store, _ = _keyed(rng, n=100)
    plain = _mk("pl2", dtype="int8")
    plain.insert_batch(["a"], np.ones((1, 64), np.float32))
    assert store.device_memory_bytes() > plain.device_memory_bytes()


def test_fused_dispatch_matches_jax_fused(rng, fused_on_cpu, monkeypatch):
    """The port store's pos path (plain scans) against the JAX fused_topk
    run on the same store arrays in interpret mode."""
    import jax.numpy as jnp

    monkeypatch.setattr(jft, "POS_MIN_TILES", 1)
    data = _clustered(rng, 9000, d=100)
    store = VectorStore.from_matrix("pp", data, dtype="int8", device=CPU)
    qs = _clustered(np.random.default_rng(11), 32)
    t = store.search_batch_submit(qs, k=10)
    d_t, r_t, _ = store.search_batch_complete_raw(t)
    qp = np.zeros((32, 128), np.float32)
    qp[:, :100] = qs
    d_j, r_j = jft.fused_topk(
        jnp.asarray(store._vectors.numpy()), jnp.asarray(store._scales.numpy()),
        jnp.asarray(store._norms.numpy()), jnp.asarray(store._valid.numpy()),
        jnp.asarray(qp), metric="cosine", k=16,
        n_tiles=tft.n_tiles_for(store._next_row, store.capacity))
    d_j, r_j = np.asarray(d_j)[:, :10], np.asarray(r_j)[:, :10]
    for b in range(32):
        assert len(set(r_t[b]) & set(r_j[b])) >= 9, b
    np.testing.assert_allclose(d_t[:, 0], d_j[:, 0], rtol=1e-4, atol=1e-4)


def test_default_device_is_the_card(monkeypatch):
    """With no device named, a store, a registry and a Database go to the
    CUDA card; without one they raise instead of falling back to the CPU."""
    from erlvectordb_tpu_torch.api import Database
    from erlvectordb_tpu_torch.core.store import default_device
    from erlvectordb_tpu_torch.infra.config import load_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(overrides={"persistence_enabled": False}, env={})
    for make in (default_device, lambda: VectorStore("x"), StoreRegistry,
                 lambda: Database(cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert VectorStore("x", device=CPU).device == CPU
    assert Database(cfg, device=CPU).device == CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda")
