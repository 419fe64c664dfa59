"""The port's int4 store (packed nibbles, erlvectordb_tpu_torch/core/store.py)
against the JAX package's, on the CPU, plus the int4 cases of
tests/test_fused_topk.py re-pointed at the port's fused top-k.

Both stores get the same seeded numpy data and answer through their exact
scans on the CPU (the fused paths are gated to a TPU / CUDA device), where
int4 x int8 dots are exact: ids agree exactly and distances to 1e-5.  The
fused cases run the port's plain scan versions (the CUDA kernels' twins).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erlvectordb_tpu.core.store as jstore
import erlvectordb_tpu_torch.ops.fused_topk as tft
from erlvectordb_tpu_torch.core import search as tsearch
from erlvectordb_tpu_torch.core.store import VectorStore

torch.set_num_threads(2)

CPU = torch.device("cpu")
TILE_N = tft.TILE_N


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _clustered(rng, n, d=100, centers=32, noise=0.35):
    c = rng.standard_normal((centers, d)).astype(np.float32)
    a = rng.integers(0, centers, n)
    return (c[a] + noise * rng.standard_normal((n, d))).astype(np.float32)


def _same_hits(got, want, metric=None):
    rtol = 1e-5 if metric == "euclidean" else 1e-6
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [h[0] for h in g] == [h[0] for h in w]
        assert [h[1] for h in g] == [h[1] for h in w]
        np.testing.assert_allclose([h[2] for h in g], [h[2] for h in w],
                                   atol=1e-5, rtol=rtol)


# ------------------------------------------------------- parity with the JAX


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot", "manhattan"])
def test_from_matrix_search_matches_jax(rng, metric):
    data = _clustered(rng, 3000)
    qs = _clustered(np.random.default_rng(9), 24)
    j = jstore.VectorStore.from_matrix("p", data, metric=metric, dtype="int4")
    t = VectorStore.from_matrix("p", data, metric=metric, dtype="int4",
                                device=CPU)
    assert t.count == j.count and t.capacity == j.capacity
    assert t.device_memory_bytes() == j.device_memory_bytes()
    np.testing.assert_array_equal(t._vectors.numpy(), np.asarray(j._vectors))
    np.testing.assert_array_equal(t._scales.numpy(), np.asarray(j._scales))
    _same_hits(t.search_batch(qs, k=10), j.search_batch(qs, k=10), metric)


def test_jax_state_loads_with_identical_ids(rng):
    """A JAX int4 store after inserts, overwrites and deletes, carried
    across by export_state() -> from_state: identical search ids."""
    data = _clustered(rng, 2500, d=72)
    qs = data[:30] + 0.01
    j = jstore.VectorStore("s", dtype="int4", metric="cosine")
    j.insert_batch([f"v{i}" for i in range(2000)], data[:2000],
                   [{"i": i} for i in range(2000)])
    j.insert_batch(["v3", "v4"], data[2000:2002])        # overwrites
    assert j.delete_batch(["v10", "v11", "v12"]) == 3
    j.insert_batch([f"w{i}" for i in range(400)], data[2100:2500])
    t = VectorStore.from_state(j.export_state(), device=CPU)
    assert t.count == j.count and t.dtype == "int4"
    _same_hits(t.search_batch(qs, k=10), j.search_batch(qs, k=10))
    vt, mt = t.get("v5")
    vj, mj = j.get("v5")
    np.testing.assert_array_equal(vt, vj)
    assert mt == mj == {"i": 5}
    back = VectorStore.from_state(t.export_state(), device=CPU)
    _same_hits(back.search_batch(qs, k=10), t.search_batch(qs, k=10))


def test_mutations_match_jax(rng):
    """The same insert/overwrite/delete sequence on both stores: the same
    rows, codes and answers."""
    data = _clustered(rng, 1500, d=40)
    stores = [jstore.VectorStore("m", dtype="int4"),
              VectorStore("m", dtype="int4", device=CPU)]
    for s in stores:
        s.insert_batch([str(i) for i in range(1200)], data[:1200])
        s.insert("7", data[1300])
        s.delete_batch(["1", "2", "3"])
        s.insert_batch(["x", "y"], data[1400:1402])
    j, t = stores
    assert t._id_to_row == j._id_to_row
    np.testing.assert_array_equal(t._vectors.numpy(), np.asarray(j._vectors))
    np.testing.assert_array_equal(t._valid.numpy(), np.asarray(j._valid))
    _same_hits(t.search_batch(data[:20], k=8), j.search_batch(data[:20], k=8))
    all_t = t.get_all_vectors()
    all_j = j.get_all_vectors()
    assert [a[0] for a in all_t] == [a[0] for a in all_j]
    np.testing.assert_array_equal(np.stack([a[1] for a in all_t]),
                                  np.stack([a[1] for a in all_j]))


def test_exact_topk_int4_matches_jax(rng):
    from erlvectordb_tpu.core.search import exact_topk_int4

    data = rng.standard_normal((700, 128)).astype(np.float32)
    packed, scales = _quantize4(data)
    norms = np.linalg.norm(data, axis=1).astype(np.float32)
    valid = np.ones(700, bool)
    valid[5] = False
    q = rng.standard_normal((9, 128)).astype(np.float32)
    for metric in ("cosine", "euclidean", "dot", "manhattan"):
        dj, rj = map(np.asarray, exact_topk_int4(
            jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(norms),
            jnp.asarray(valid), jnp.asarray(q), metric=metric, k=7))
        dt, rt = tsearch.exact_topk_int4(_t(packed), _t(scales), _t(norms),
                                         _t(valid), _t(q), metric=metric, k=7)
        np.testing.assert_array_equal(rt.numpy(), rj)
        np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-5, atol=1e-5)


# ---------------------------- tests/test_fused_topk.py int4 cases, re-pointed


def _quantize4(data):
    absmax = np.abs(data).max(axis=1)
    scales = np.where(absmax > 0, absmax / 7.0, 1.0).astype(np.float32)
    q4 = np.clip(np.round(data / scales[:, None]), -7, 7).astype(np.int8)
    u = q4.astype(np.uint8)
    return (((u[:, 0::2] & 0xF) << 4) | (u[:, 1::2] & 0xF)).astype(np.uint8), scales


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    n_cap, n, d = 2 * TILE_N, TILE_N + 1234, 128
    data = np.zeros((n_cap, d), np.float32)
    data[:n] = rng.standard_normal((n, d)).astype(np.float32)
    valid = np.zeros(n_cap, bool)
    valid[:n] = True
    valid[17] = False
    valid[4000] = False
    norms = np.linalg.norm(data, axis=1).astype(np.float32)
    queries = rng.standard_normal((40, d)).astype(np.float32)
    return data, norms, valid, queries, n


def _fused_vs_exact(data, norms, valid, queries, metric, k, nt):
    packed, scales = _quantize4(data)
    args = (_t(packed), _t(scales), _t(norms), _t(valid), _t(queries))
    d_f, r_f = tft.fused_topk(*args, metric=metric, k=k, n_tiles=nt)
    d_x, r_x = tsearch.exact_topk_int4(*args, metric=metric, k=k)
    return d_f.numpy(), r_f.numpy(), d_x.numpy(), r_x.numpy()


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_fused_int4_matches_exact_int4(corpus, metric):
    """tests/test_fused_topk.py::test_fused_int4_matches_xla_int4 and
    ::test_fused_int4_other_metrics: the masked path over packed codes."""
    data, norms, valid, queries, n = corpus
    k = 8
    d_f, r_f, d_x, r_x = _fused_vs_exact(data, norms, valid, queries, metric,
                                         k, tft.n_tiles_for(n, data.shape[0]))
    for b in range(queries.shape[0]):
        assert len(set(r_f[b]) & set(r_x[b])) >= k - 1, (b, r_f[b], r_x[b])
    np.testing.assert_allclose(d_f[:, 0], d_x[:, 0], rtol=1e-3, atol=1e-3)


def test_pos_path_int4_packed(monkeypatch):
    """tests/test_fused_topk.py::test_pos_path_int4_packed: planted matches
    in distinct slices survive the packed pos scan."""
    monkeypatch.setattr(tft, "POS_MIN_TILES", 1)
    rng = np.random.default_rng(3)
    n_cap = 3 * TILE_N
    n, d = n_cap - 500, 128
    data = np.zeros((n_cap, d), np.float32)
    data[:n] = rng.standard_normal((n, d)).astype(np.float32)
    valid = np.zeros(n_cap, bool)
    valid[:n] = True
    queries = rng.standard_normal((8, d)).astype(np.float32)
    targets = [100, 2100, 4200, 6300, 8400, 10500]
    for i, tg in enumerate(targets):
        data[tg] = queries[0] * (1.0 + 0.02 * (i + 1))
    norms = np.linalg.norm(data, axis=1).astype(np.float32)
    d_f, r_f, d_x, r_x = _fused_vs_exact(data, norms, valid, queries, "cosine",
                                         6, 3)
    assert set(r_f[0]) == set(r_x[0]) == set(targets)
    np.testing.assert_allclose(d_f[:, 0], d_x[:, 0], rtol=1e-3, atol=1e-3)


# ------------------------------------------------------------ store behaviour


def test_int4_store_through_the_fused_dispatch(rng, monkeypatch):
    """The store's fused dispatch (forced on the CPU, where the wrappers run
    their plain versions) answers like its exact scan; deleted rows never
    come back."""
    data = _clustered(rng, 9000, d=100)
    st = VectorStore.from_matrix("fd", data, dtype="int4", device=CPU)
    assert st.delete("3")
    want = st.search_batch(data[:32], k=10)
    real = tft.fused_topk_available
    monkeypatch.setattr(tft, "fused_topk_available",
                        lambda c, cap, m, d, k=10: real(
                            c, cap, m, torch.device("cuda"), k))
    got = st.search_batch(data[:32], k=10)
    overlap = np.mean([len({h[0] for h in a} & {h[0] for h in b}) / 10
                       for a, b in zip(got, want)])
    assert overlap >= 0.97
    assert "3" not in {h[0] for hits in got for h in hits}


def test_get_dequantizes_and_memory_halves(rng):
    data = rng.standard_normal((2000, 64)).astype(np.float32)
    i4 = VectorStore.from_matrix("g4", data, dtype="int4", device=CPU)
    i8 = VectorStore.from_matrix("g8", data, dtype="int8", device=CPU)
    vec, _ = i4.get("42")
    assert np.max(np.abs(vec - data[42])) <= np.abs(data[42]).max() / 7.0
    assert i4._vectors.numel() * 2 == i8._vectors.numel()
    assert i4.device_memory_bytes() < i8.device_memory_bytes()
