"""The port's cell-residual int4 store (dtype="int4r",
erlvectordb_tpu_torch/core/store.py) against the JAX package's, on the CPU,
plus the cases of tests/test_int4r.py and tests/test_store_streaming.py
re-pointed at the port.

Builds draw random numbers (k-means seeding) that torch does not share with
jax.random, so parity runs on JAX-built state carried across by
``export_state()`` -> ``from_state``: both stores then answer through their
exact scans on the CPU, with identical ids.  The fused residual path is
forced on the CPU in its own cases (the wrappers then run their plain
versions, the CUDA kernels' twins).  The snapshot layer is not ported yet,
so the persistence cases round-trip through export_state/from_state.
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


def _t(x):
    return torch.from_numpy(np.array(x))


def R(name, data=None, **kw):
    """A port int4r store on the CPU (from_matrix when data is given)."""
    if data is None:
        return VectorStore(name, dtype="int4r", device=CPU, **kw)
    return VectorStore.from_matrix(name, data, dtype="int4r", device=CPU, **kw)


@pytest.fixture
def corpus(rng):
    # clustered corpus: residuals ~3x smaller than vectors
    centers = rng.standard_normal((32, 24)).astype(np.float32)
    assign = rng.integers(0, 32, 3000)
    return (centers[assign]
            + 0.3 * rng.standard_normal((3000, 24)).astype(np.float32))


def _ids(hits):
    return [[h[0] for h in row] for row in hits]


def _force_fused(monkeypatch):
    real = tft.residual_scan_applies
    monkeypatch.setattr(tft, "residual_scan_applies",
                        lambda cap, cc, m, d, k=10: real(
                            cap, cc, m, torch.device("cuda"), k))


# ------------------------------------------------------- parity with the JAX


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot", "manhattan"])
def test_jax_state_loads_with_identical_ids(corpus, metric):
    """A JAX int4r store (host build, then inserts, an overwrite and
    deletes) carried across: the same ids from the port's exact scan, and
    the same dequantized rows."""
    j = jstore.VectorStore.from_matrix("s", corpus[:2500], dtype="int4r",
                                       metric=metric)
    j.insert_batch([f"n{i}" for i in range(200)], corpus[2500:2700])
    j.insert("9", corpus[2800])
    j.delete_batch(["5", "n7"])
    t = VectorStore.from_state(j.export_state(), device=CPU)
    assert t.count == j.count and t.capacity == j.capacity
    assert t._cell_cap == j._cell_cap
    np.testing.assert_array_equal(t._cell_avail, j._cell_avail)
    qs = corpus[2700:2760]
    got, want = t.search_batch(qs, k=10), j.search_batch(qs, k=10)
    assert _ids(got) == _ids(want)
    np.testing.assert_allclose([h[2] for r in got for h in r],
                               [h[2] for r in want for h in r],
                               rtol=1e-5, atol=1e-5)
    vt, vj = t.get("17")[0], j.get("17")[0]
    np.testing.assert_allclose(vt, vj, rtol=1e-6, atol=1e-6)
    back = VectorStore.from_state(t.export_state(), device=CPU)
    assert _ids(back.search_batch(qs, k=10)) == _ids(got)


def test_exact_topk_int4r_matches_jax(corpus):
    from erlvectordb_tpu.core.search import exact_topk_int4r

    j = jstore.VectorStore.from_matrix("e", corpus, dtype="int4r")
    q = np.zeros((20, 128), np.float32)
    q[:, :24] = corpus[:20] + 0.01
    for metric in ("cosine", "euclidean", "dot", "manhattan"):
        dj, rj = map(np.asarray, exact_topk_int4r(
            j._vectors, j._scales, j._norms, j._valid, j._centroids,
            jnp.asarray(q), metric=metric, k=9, cell_cap=j._cell_cap))
        dt, rt = tsearch.exact_topk_int4r(
            _t(np.asarray(j._vectors)), _t(np.asarray(j._scales)),
            _t(np.asarray(j._norms)), _t(np.asarray(j._valid)),
            _t(np.asarray(j._centroids)), _t(q), metric=metric, k=9,
            cell_cap=j._cell_cap)
        np.testing.assert_array_equal(rt.numpy(), rj)
        # euclidean distances near a self-match come from |q|^2 - 2 q.x +
        # |x|^2, which cancels: the f32 centroid table, summed in another
        # order than XLA's (~1e-6 of |q|^2 ~ 25), moves a distance of ~0.2
        # by up to ~5e-5
        tol = 1e-4 if metric == "euclidean" else 1e-5
        np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-5, atol=tol)


@pytest.mark.parametrize("pos", [False, True], ids=["masked", "pos"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_fused_dispatch_matches_jax_fused(monkeypatch, metric, pos):
    """A JAX-built 2-tile int4r store searched through each package's fused
    residual path (JAX: interpret mode; port: its store dispatch forced onto
    the plain scans).  Each side derives its own key window from f32
    reductions that XLA may fuse differently, and the pool rescore sums f32
    dots in another order, so a candidate at the edge of a slice's top-8 or
    of the final top-8 can differ: ids agree on >= 98% of entries (2 of
    128 differ at this size, where 8 slices hold the whole pool), and
    where they agree distances agree to 1e-5 (euclidean: 1e-4)."""
    import erlvectordb_tpu.ops.fused_topk as jft

    rng = np.random.default_rng(5)
    n, d = 2 * tft.TILE_N, 32
    centers = rng.standard_normal((64, d)).astype(np.float32)
    data = (centers[rng.integers(0, 64, n)]
            + 0.3 * rng.standard_normal((n, d)).astype(np.float32))
    j = jstore.VectorStore.from_matrix("f", data, dtype="int4r", metric=metric)
    t = VectorStore.from_state(j.export_state(), device=CPU)
    if pos:
        monkeypatch.setattr(jft, "POS_MIN_TILES", 1)
        monkeypatch.setattr(tft, "POS_MIN_TILES", 1)
    qs = data[rng.integers(0, n, 16)]
    qp = np.zeros((16, 128), np.float32)
    qp[:, :d] = qs
    nt = tft.n_tiles_for(j._capacity, j._capacity)
    cnb = float(jft.max_code_norm(j._vectors))
    # a k of its own per path: JAX caches the traced function by its static
    # arguments, and the path is chosen while tracing (POS_MIN_TILES)
    k = 8 if pos else 7
    dj, rj = jft.fused_topk_residual(
        j._vectors, j._scales, j._norms, j._valid, j._centroids,
        jnp.asarray(qp), metric=metric, k=k, n_tiles=nt, cell_cap=j._cell_cap,
        code_norm_bound=jnp.float32(cnb), slice_w=tft.POS_RES_W,
        t_top=tft.POS_RES_T)
    _force_fused(monkeypatch)
    tft.reset_launches()
    got = t.search_batch(qs, k=k)
    assert t._code_norm_max == pytest.approx(cnb, rel=1e-6)
    want = np.array([[j._rid(int(r)) for r in row] for row in np.asarray(rj)])
    same = np.array(_ids(got)) == want
    assert same.mean() >= 0.98
    # euclidean self-match distances cancel (see the exact-scan test above)
    np.testing.assert_allclose(
        np.array([[h[2] for h in row] for row in got])[same],
        np.asarray(dj)[same], rtol=1e-5,
        atol=1e-4 if metric == "euclidean" else 1e-5)


# ------------------------------------- tests/test_int4r.py, re-pointed


class TestBulkBuild:
    def test_build_and_search(self, corpus):
        st = R("r4", corpus)
        assert st.count == 3000 and st.dtype == "int4r"
        top1 = [h[0][0] for h in st.search_batch(corpus[:16], k=1)]
        assert sum(top1[i] == str(i) for i in range(16)) >= 12

    def test_recall_beats_plain_int4(self, corpus):
        q = corpus[:64]
        exact = VectorStore.from_matrix("ex", corpus, device=CPU)
        gt = _ids(exact.search_batch(q, k=5))
        plain = VectorStore.from_matrix("p4", corpus, dtype="int4", device=CPU)
        resid = R("r4b", corpus)
        i8 = VectorStore.from_matrix("i8b", corpus, dtype="int8", device=CPU)

        def recall(st):
            got = _ids(st.search_batch(q, k=5))
            return np.mean([len(set(g) & set(w)) / 5 for g, w in zip(got, gt)])

        r_plain, r_resid, r_i8 = recall(plain), recall(resid), recall(i8)
        assert r_resid >= r_plain + 0.2
        assert r_resid >= 0.75 * r_i8

    def test_all_metrics(self, corpus):
        st = R("rm", corpus)
        for metric in ("cosine", "euclidean", "dot", "manhattan"):
            hits = st.search(corpus[7], k=3, metric=metric)
            assert len(hits) == 3 and hits[0][0] == "7"

    def test_get_dequantizes(self, corpus):
        vec, _ = R("rg", corpus).get("42")
        assert np.linalg.norm(vec - corpus[42]) / np.linalg.norm(corpus[42]) < 0.08

    def test_memory_at_int4_footprint(self, rng):
        big = rng.standard_normal((30_000, 16)).astype(np.float32)
        r4 = R("rmem", big)
        i8 = VectorStore.from_matrix("imem", big, dtype="int8", device=CPU)
        assert r4.device_memory_bytes() < i8.device_memory_bytes()


class TestMutation:
    def test_insert_into_empty(self, corpus):
        st = R("mut", dim=24)
        st.insert_batch([f"v{i}" for i in range(200)], corpus[:200])
        assert st.count == 200
        assert st.search(corpus[5], k=1)[0][0] == "v5"
        st.insert("late", corpus[500], {"tag": "x"})
        hit = st.search(corpus[500], k=1)
        assert hit[0][0] == "late" and hit[0][1] == {"tag": "x"}

    def test_insert_after_bulk_build(self, corpus):
        st = R("mut2", corpus[:1000])
        st.insert("new", corpus[2000])
        assert st.search(corpus[2000], k=1)[0][0] == "new"
        assert st.count == 1001

    def test_delete_and_slot_reuse(self, corpus):
        st = R("mut3", corpus[:500])
        cap_before = st.capacity
        row = st._id_to_row["17"]
        assert st.delete("17")
        assert st.search(corpus[17], k=1)[0][0] != "17"
        st.insert("again", corpus[17])
        assert st.search(corpus[17], k=1)[0][0] == "again"
        assert st._id_to_row["again"] == row  # freed slot reused
        assert st.capacity == cap_before

    def test_overwrite(self, corpus):
        st = R("mut4", corpus[:300])
        st.insert("9", corpus[2500])
        assert st.count == 300
        assert st.search(corpus[2500], k=1)[0][0] == "9"

    def test_growth_appends_cells(self, corpus):
        st = R("grow", dim=24)
        st.insert_batch([f"a{i}" for i in range(100)], corpus[:100])
        k1 = len(st._cell_next)
        st.insert_batch([f"b{i}" for i in range(2000)], corpus[100:2100])
        assert len(st._cell_next) > k1
        assert st.capacity % 4096 == 0
        assert st.search(corpus[150], k=1)[0][0] == "b50"

    @pytest.mark.parametrize("kind", ["twins_of_full_cells", "in_distribution",
                                      "far_away"])
    def test_placement_matches_jax(self, corpus, kind):
        """Rows inserted one at a time into a JAX-built store carried across
        land in the same rows, cells and capacity as in the JAX store: the
        nearest cell with space among the 8 nearest centroids (blocked
        padding cells included), else a new block of cells."""
        j = jstore.VectorStore.from_matrix("p", corpus[:2000], dtype="int4r")
        t = VectorStore.from_state(j.export_state(), device=CPU)
        rng = np.random.default_rng(3)
        if kind == "twins_of_full_cells":
            full = {c for c in range(len(j._cell_next))
                    if j._cell_avail[c] == 0 and j._cell_next[c] > 0}
            src = [int(vid) for vid, r in j._id_to_row.items()
                   if r // j._cell_cap in full][:40]
            assert src, "the build left no full cell to aim at"
            new = corpus[src] + 0.01
        elif kind == "in_distribution":
            new = corpus[2000:2060]
        else:
            new = 6.0 * rng.standard_normal((6, corpus.shape[1])).astype(
                np.float32)
        cap0 = t.capacity
        for i, v in enumerate(new):
            j.insert(f"x{i}", v)
            t.insert(f"x{i}", v)
        assert t.capacity == j.capacity
        if kind == "twins_of_full_cells":   # a row whose 8 nearest cells
            assert t.capacity > cap0         # are full spawns new ones
        np.testing.assert_array_equal(t._cell_next, j._cell_next)
        np.testing.assert_array_equal(t._cell_avail, j._cell_avail)
        assert ({f"x{i}": t._id_to_row[f"x{i}"] for i in range(len(new))}
                == {f"x{i}": j._id_to_row[f"x{i}"] for i in range(len(new))})
        assert _ids(t.search_batch(new, k=3)) == _ids(j.search_batch(new, k=3))


class TestPersistence:
    def test_state_roundtrip(self, corpus):
        st = R("snap", corpus[:800])
        st.insert("extra", corpus[900], {"m": 1})
        ld = VectorStore.from_state(st.export_state(), device=CPU)
        assert ld.dtype == "int4r" and ld.count == st.count
        assert ld.search(corpus[3], k=1)[0][0] == "3"
        assert ld.search(corpus[900], k=1)[0][0] == "extra"
        ld.insert("post", corpus[901])
        assert ld.search(corpus[901], k=1)[0][0] == "post"

    def test_get_all_vectors_dequantizes(self, corpus):
        allv = R("bkr", corpus[:400]).get_all_vectors()
        assert len(allv) == 400
        vid, vec, _ = allv[0]
        assert (np.linalg.norm(vec - corpus[int(vid)])
                / np.linalg.norm(corpus[int(vid)])) < 0.08


class TestFusedResidualPath:
    """tests/test_int4r.py::TestFusedResidualKernel: both residual scan
    paths (B6 masked, B5 pos) against the exact scan, through the port's
    store dispatch forced onto the plain scans."""

    @pytest.fixture(scope="class")
    def big_store(self):
        rng = np.random.default_rng(5)
        n, d = 2 * tft.TILE_N, 32
        centers = rng.standard_normal((64, d)).astype(np.float32)
        data = (centers[rng.integers(0, 64, n)]
                + 0.3 * rng.standard_normal((n, d)).astype(np.float32))
        return R("i4rk", data), data[rng.integers(0, n, 16)].copy()

    def _exact(self, store, queries, metric, k):
        qp = np.zeros((len(queries), 128), np.float32)
        qp[:, :queries.shape[1]] = queries
        d, r = tsearch.exact_topk_int4r(
            store._vectors, store._scales, store._norms, store._valid,
            store._centroids, _t(qp), metric=metric, k=k,
            cell_cap=store._cell_cap)
        return d.numpy(), [[store._ids_view()[x] for x in row]
                           for row in r.numpy()]

    @pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
    def test_masked_path_matches_exact(self, big_store, metric, monkeypatch):
        store, queries = big_store
        _force_fused(monkeypatch)
        tft.reset_launches()
        got = store.search_batch(queries, k=8, metric=metric)
        d_x, r_x = self._exact(store, queries, metric, 8)
        for b in range(len(queries)):
            assert len(set(_ids(got)[b]) & set(r_x[b])) >= 7, (metric, b)
        d_f = np.array([row[0][2] for row in got])
        if metric == "euclidean":
            assert d_f.max() < 0.35 and d_x[:, 0].max() < 0.35
        else:
            np.testing.assert_allclose(d_f, d_x[:, 0], rtol=0.05, atol=0.08)

    @pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
    def test_pos_path_quality(self, big_store, metric, monkeypatch):
        """fused_topk_residual's pos path at top-2 per slice (its default):
        the global best survives, distances are exact rescores, and the
        home cell's two best rows are kept."""
        store, queries = big_store
        monkeypatch.setattr(tft, "POS_MIN_TILES", 1)
        qp = np.zeros((len(queries), 128), np.float32)
        qp[:, :queries.shape[1]] = queries
        _, rows = tft.fused_topk_residual(
            store._vectors, store._scales, store._norms, store._valid,
            store._centroids, _t(qp), metric=metric, k=5,
            n_tiles=tft.n_tiles_for(store.capacity, store.capacity),
            cell_cap=store._cell_cap)
        got = [[store._ids_view()[x] for x in row] for row in rows.numpy()]
        _, r_x = self._exact(store, queries, metric, 5)
        _, r_wide = self._exact(store, queries, metric, 24)
        for b in range(len(queries)):
            assert got[b][0] == r_x[b][0], (metric, b)
            assert len(set(got[b]) & set(r_wide[b])) >= 2, (metric, b)
            assert len(set(got[b])) == len(got[b])


def _bench_corpus(seed, n_draw, n):
    """The first n rows of chip_smoke.py's make_corpus(seed, n_draw): 1024
    Gaussian centres in 100 dims, noise 0.35, with numpy's generator."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((1024, 100), dtype=np.float32)
    z = centres[rng.integers(0, 1024, n_draw)[:n]]
    return z + 0.35 * rng.standard_normal((n, 100), dtype=np.float32)


def test_h_store_b6_overlap_is_the_reference_level(monkeypatch):
    """chip_smoke.py's store (h) (the first 100k rows of its corpus, int4r
    cosine, host build: 1,088 cells, 34 tiles), built by the port on the CPU
    and carried into the JAX package, searched with chip_smoke's 256 recall
    queries through each package's B6 path (JAX: fused_topk_residual in
    interpret mode; port: the store dispatch forced onto the plain
    versions).  Each path's overlap@10 with its own package's exact scan of
    the same codes is printed: the port's equals the reference's, and both
    paths return the same ids on >= 99.5% of entries."""
    import erlvectordb_tpu.ops.fused_topk as jft
    from erlvectordb_tpu.core.search import exact_topk_int4r

    x = _bench_corpus(0, 1_200_000, 100_000)
    q = _bench_corpus(1, 1024, 256)
    t = R("h", x, metric="cosine")
    assert len(t._cell_next) == 1088
    nt = tft.n_tiles_for(t.capacity, t.capacity)
    assert nt == 34 < tft.POS_MIN_TILES
    j = jstore.VectorStore.from_state(t.export_state())
    qp = np.zeros((len(q), 128), np.float32)
    qp[:, :100] = q
    kb = tsearch.k_bucket(10, t.capacity)

    def overlap(a, b):
        return float(np.mean([len(set(r[:10]) & set(w[:10])) / 10
                              for r, w in zip(a, b)]))

    _force_fused(monkeypatch)
    path_t = _ids(t.search_batch(q, k=10))
    _, rx = tsearch.exact_topk_int4r(
        t._vectors, t._scales, t._norms, t._valid, t._centroids, _t(qp),
        metric="cosine", k=10, cell_cap=t._cell_cap)
    exact_t = [[t._ids_view()[r] for r in row] for row in rx.numpy()]
    _, rj = jft.fused_topk_residual(
        j._vectors, j._scales, j._norms, j._valid, j._centroids,
        jnp.asarray(qp), metric="cosine", k=kb, n_tiles=nt,
        cell_cap=j._cell_cap, code_norm_bound=jft.max_code_norm(j._vectors),
        slice_w=tft.POS_RES_W, t_top=tft.POS_RES_T)
    path_j = [[j._rid(int(r)) for r in row[:10]] for row in np.asarray(rj)]
    _, rjx = exact_topk_int4r(
        j._vectors, j._scales, j._norms, j._valid, j._centroids,
        jnp.asarray(qp), metric="cosine", k=10, cell_cap=j._cell_cap)
    exact_j = [[j._rid(int(r)) for r in row] for row in np.asarray(rjx)]
    ov_t, ov_j = overlap(path_t, exact_t), overlap(path_j, exact_j)
    print(f"(h) overlap@10 with the exact scan: port B6 {ov_t!r}, "
          f"JAX B6 {ov_j!r}; paths agree on "
          f"{np.mean(np.array(path_t) == np.array(path_j))!r}")
    assert np.mean(np.array(path_t) == np.array(path_j)) >= 0.995
    assert ov_t == pytest.approx(ov_j, abs=0.005)


# (h)'s overlap@10 read by the test above on the port's own CPU build
H_PORT_BUILD_OVERLAP = 0.958984375


def test_h_store_jax_build_b6_overlap_is_the_port_level():
    """chip_smoke.py's store (h) built by the JAX package itself (its int4r
    host build, below 200k rows) from the same corpus, read through the JAX
    B6 path (fused_topk_residual in interpret mode) against the JAX exact
    scan of the same codes, on the same 256 queries.  The reference's own
    level is printed beside the port-built store's, and the two builds read
    within 0.01 of each other: (h)'s level is the reference's."""
    import erlvectordb_tpu.ops.fused_topk as jft
    from erlvectordb_tpu.core.search import exact_topk_int4r

    x = _bench_corpus(0, 1_200_000, 100_000)
    q = _bench_corpus(1, 1024, 256)
    j = jstore.VectorStore.from_matrix("h", x, metric="cosine", dtype="int4r")
    nt = tft.n_tiles_for(j.capacity, j.capacity)
    assert nt < tft.POS_MIN_TILES
    qp = np.zeros((len(q), 128), np.float32)
    qp[:, :100] = q
    _, rj = jft.fused_topk_residual(
        j._vectors, j._scales, j._norms, j._valid, j._centroids,
        jnp.asarray(qp), metric="cosine", k=tsearch.k_bucket(10, j.capacity),
        n_tiles=nt, cell_cap=j._cell_cap,
        code_norm_bound=jft.max_code_norm(j._vectors),
        slice_w=tft.POS_RES_W, t_top=tft.POS_RES_T)
    _, rx = exact_topk_int4r(
        j._vectors, j._scales, j._norms, j._valid, j._centroids,
        jnp.asarray(qp), metric="cosine", k=10, cell_cap=j._cell_cap)
    ov = float(np.mean([len(set(r[:10].tolist()) & set(w.tolist())) / 10
                        for r, w in zip(np.asarray(rj), np.asarray(rx))]))
    print(f"(h) overlap@10 of the JAX B6 path with the JAX exact scan on the "
          f"JAX package's own build ({len(j._cell_next)} cells, {nt} tiles): "
          f"{ov!r}; on the port's build: {H_PORT_BUILD_OVERLAP!r}")
    assert ov == pytest.approx(H_PORT_BUILD_OVERLAP, abs=0.01)


def test_top8_recovers_one_cell_topk(monkeypatch):
    """tests/test_int4r.py::TestDeepSliceExtraction: plant the top-8 inside
    one 512-row cell; top-8 per slice recovers them all, top-2 at most 2."""
    rng = np.random.default_rng(7)
    n, w, cc = 2 * tft.TILE_N, 32, 512
    cents = rng.standard_normal((n // cc, w)).astype(np.float32)
    resid = 0.05 * rng.standard_normal((n, w)).astype(np.float32)
    q = cents[3:4] + 0.01 * rng.standard_normal((1, w)).astype(np.float32)
    rows = cents.repeat(cc, axis=0) + resid
    norms = np.linalg.norm(rows, axis=1).astype(np.float32)
    scale = (np.abs(resid).max(axis=1) / 7.0).astype(np.float32)
    u = np.clip(np.round(resid / scale[:, None]), -7, 7).astype(np.int8).astype(np.uint8)
    packed = ((u[:, 0::2] & 0xF) << 4) | (u[:, 1::2] & 0xF)
    args = (_t(packed), _t(scale), _t(norms), torch.ones(n, dtype=torch.bool),
            _t(cents), _t(q))
    _, r_x = tsearch.exact_topk_int4r(*args, metric="cosine", k=8, cell_cap=cc)
    truth = set(r_x[0].tolist())
    assert len({t // 1024 for t in truth}) == 1
    monkeypatch.setattr(tft, "POS_MIN_TILES", 1)

    def pos(slice_w, t_top):
        _, r = tft.fused_topk_residual(*args, metric="cosine", k=8, n_tiles=2,
                                       cell_cap=cc, slice_w=slice_w,
                                       t_top=t_top)
        return set(r[0].tolist())

    assert len(pos(1024, 8) & truth) == 8
    assert len(pos(1024, 2) & truth) <= 2
    assert len(pos(512, 8) & truth) == 8


# -------------------------------------------------- drift and the refit


def test_drift_refit(corpus):
    st = R("drift", corpus[:2000])
    d0 = st.drift()
    assert d0["built_rows"] == 2000 and d0["fraction"] == 0 and not st.is_stale()
    st.insert_batch([f"n{i}" for i in range(400)], corpus[2000:2400])
    st.delete_batch([str(i) for i in range(200)])
    d1 = st.drift()
    assert d1["inserts_since_build"] == 400 and d1["deletes_since_build"] == 200
    assert d1["fraction"] == pytest.approx(0.3) and st.is_stale()
    assert not st.is_stale(threshold=0.5)
    d2 = st.rebuild_cells()
    assert d2["fraction"] == 0 and d2["built_rows"] == 2200
    assert st.count == 2200 and not st.is_stale()
    assert st.search(corpus[2100], k=1)[0][0] == "n100"
    assert st.search(corpus[500], k=1)[0][0] == "500"
    with pytest.raises(ValueError):
        VectorStore.from_matrix("x", corpus[:50], device=CPU).rebuild_cells()


def test_drift_matches_jax(corpus):
    stores = [jstore.VectorStore.from_matrix("d", corpus[:1500], dtype="int4r"),
              R("d", corpus[:1500])]
    for s in stores:
        s.insert_batch([f"n{i}" for i in range(100)], corpus[1500:1600])
        s.delete_batch(["3", "4"])
    dj, dt = stores[0].drift(), stores[1].drift()
    for key in ("built_rows", "inserts_since_build", "deletes_since_build",
                "fraction"):
        assert dt[key] == dj[key], key


# --------------------------------- tests/test_store_streaming.py, re-pointed


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(11)
    n, d = 600, 64
    data = rng.standard_normal((n, d)).astype(np.float32)
    store = VectorStore.from_chunks(
        "stream1", (data[i:i + 128] for i in range(0, n, 128)), n=n, dim=d,
        cell_rows=48, cell_cap=64, train_rows=512, device=CPU)
    return store, data


class TestStreamingBuild:
    def test_count_and_contains(self, built):
        store, data = built
        assert store.count == len(data)
        assert "0" in store and "599" in store
        assert "600" not in store and "007" not in store
        assert store.build_stats["vec_per_sec"] > 0

    def test_search_returns_original_ids(self, built):
        store, data = built
        hits = store.search(data[123], k=3)
        assert hits[0][0] == "123"
        ds = [h[2] for h in hits]
        assert ds == sorted(ds)

    def test_search_batch_and_raw(self, built):
        store, data = built
        res = store.search_batch(data[:8], k=2)
        assert [r[0][0] for r in res] == [str(i) for i in range(8)]
        dists, rows, ids = store.search_batch_complete_raw(
            store.search_batch_submit(data[:4], k=2))
        assert ids.shape == (4, 2)
        assert [ids[i][0] for i in range(4)] == ["0", "1", "2", "3"]
        np.testing.assert_array_equal(rows[:, 0], np.arange(4))

    def test_multiprobe_refused(self, built):
        """Multiprobe search is served on the streaming-built store (rows
        map slot -> original row on the device); what it refuses is a
        request naming both nprobe and recall_target."""
        store, data = built
        assert store.search(data[77], k=3, nprobe=8)[0][0] == "77"
        with pytest.raises(ValueError, match="not both"):
            store.search(data[77], k=3, nprobe=8, recall_target=0.9)

    def test_get_materializes_and_roundtrips(self, built):
        store, data = built
        vec, md = store.get("321")
        assert md == {}
        cos = float(vec @ data[321]) / (np.linalg.norm(vec)
                                         * np.linalg.norm(data[321]))
        assert cos > 0.98
        assert store._perm_count == 0 and store._perm_dev is None
        assert store.search(data[123], k=1)[0][0] == "123"

    def test_explicit_ids_unsupported(self):
        with pytest.raises(TypeError):
            VectorStore.from_chunks("x", iter([]), n=1, dim=4, ids=["a"],
                                    device=CPU)


class TestStreamingMutation:
    @pytest.fixture()
    def store(self):
        rng = np.random.default_rng(5)
        n, d = 300, 32
        data = rng.standard_normal((n, d)).astype(np.float32)
        s = VectorStore.from_chunks(
            "mut1", (data[i:i + 100] for i in range(0, n, 100)), n=n, dim=d,
            cell_rows=32, cell_cap=64, train_rows=256, device=CPU)
        return s, data

    def test_delete_then_search(self, store):
        s, data = store
        assert s.delete("42")
        assert s.count == 299
        assert s.search(data[42], k=1)[0][0] != "42"
        assert not s.delete("42")

    def test_insert_after_streaming_build(self, store):
        s, data = store
        v = np.random.default_rng(99).standard_normal(
            data.shape[1]).astype(np.float32)
        s.insert("new-row", v, {"tag": "fresh"})
        assert s.count == 301
        hits = s.search(v, k=1)
        assert hits[0][0] == "new-row" and hits[0][1] == {"tag": "fresh"}

    def test_persistence_roundtrip(self, store):
        s, data = store
        s2 = VectorStore.from_state(s.export_state(), device=CPU)
        assert s2.count == 300
        assert s2.search(data[10], k=1)[0][0] == "10"


def test_streaming_build_1m_path_through_from_matrix(monkeypatch, rng):
    """from_matrix goes through the streaming engine from 200k rows; the
    threshold lowered here sends a small corpus down that path: ids are
    materialized and searchable at once."""
    import erlvectordb_tpu_torch.core.store as tstore

    data = rng.standard_normal((3000, 20)).astype(np.float32)
    real = tstore.VectorStore._build_int4r_device
    calls = []

    def spy(self, x, ids):
        calls.append(len(x))
        return real(self, x, ids)

    monkeypatch.setattr(tstore.VectorStore, "_build_int4r_device", spy)
    st = VectorStore("big", dtype="int4r", device=CPU)
    st._dim = 20
    st._build_int4r_device(data, [f"id{i}" for i in range(3000)])
    assert calls == [3000] and st.count == 3000
    assert st.search(data[77], k=1)[0][0] == "id77"
    assert st._perm_dev is None and st.build_stats["n"] == 3000


def test_database_streaming_build(rng):
    """Database.create_store_streaming: an int4r store from a stream of
    chunks, registered and searchable by implicit id."""
    from erlvectordb_tpu_torch.api import Database
    from erlvectordb_tpu_torch.infra.config import load_config

    db = Database(load_config(overrides={"persistence_enabled": False}, env={}),
                  device=CPU)
    data = rng.standard_normal((500, 40)).astype(np.float32)
    stats = db.create_store_streaming(
        "big", (data[i:i + 100] for i in range(0, 500, 100)), n=500, dim=40,
        cell_rows=48, cell_cap=64, train_rows=400)
    assert stats["dtype"] == "int4r" and stats["count"] == 500
    assert db.search("big", data[42], k=1)[0][0] == "42"
    with pytest.raises(ValueError, match="already exists"):
        db.create_store_streaming("big", iter([data]), n=500, dim=40)


# ------------------------------------------------ multiprobe (nprobe, B7)


@pytest.fixture(scope="module")
def mp_pair():
    """A JAX int4r store (host build) and the port's copy of its state."""
    rng = np.random.default_rng(21)
    centers = rng.standard_normal((40, 24)).astype(np.float32)
    data = (centers[rng.integers(0, 40, 6000)]
            + 0.25 * rng.standard_normal((6000, 24)).astype(np.float32))
    js = jstore.VectorStore.from_matrix("mp", data, dtype="int4r")
    ts = VectorStore.from_state(js.export_state(), device=CPU)
    held = (centers[rng.integers(0, 40, 48)]
            + 0.25 * rng.standard_normal((48, 24)).astype(np.float32))
    return js, ts, data, held


def _raw(store, qs, **kw):
    d, r, ids = store.search_batch_complete_raw(
        store.search_batch_submit(qs, **kw))
    return d, ids


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
@pytest.mark.parametrize("nprobe", [1, 4, 512])
def test_multiprobe_matches_jax_on_carried_state(mp_pair, metric, nprobe):
    """nprobe 1, 4 and deep (512 > cells: every cell) on JAX state carried
    across: ids identical, distances within rtol 1e-5 (euclidean as squares
    to 1e-5 |q|^2: the distance formula cancels near a match)."""
    js, ts, _, held = mp_pair
    jd, jids = _raw(js, held, k=10, metric=metric, nprobe=nprobe)
    td, tids = _raw(ts, held, k=10, metric=metric, nprobe=nprobe)
    assert tids.tolist() == jids.tolist()
    if metric == "euclidean":
        q2 = (held * held).sum(1, keepdims=True)
        assert np.all(np.abs(td ** 2 - jd ** 2) <= 1e-5 * q2)
    else:
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)


def test_recall_target_matches_jax_on_carried_state(mp_pair):
    """The JAX store's calibration curve travels in its state: the port
    picks the same nprobe for a recall_target and answers alike."""
    js, _, _, held = mp_pair
    js.calibrate_nprobe(n_sample=64, k=10)
    ts = VectorStore.from_state(js.export_state(), device=CPU)
    assert ts._calib.get(10, "cosine").curve == js._calib.get(10, "cosine").curve
    assert ts._nprobe_for_target(0.9, 10) == js._nprobe_for_target(0.9, 10)
    jd, jids = _raw(js, held, k=10, recall_target=0.9)
    td, tids = _raw(ts, held, k=10, recall_target=0.9)
    assert tids.tolist() == jids.tolist()
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    assert ts.get_stats()["calibration"] == js.get_stats()["calibration"]


def test_multiprobe_routing_buffers_follow_the_centroids(mp_pair):
    """The persistent bf16 routing copy is renewed when the centroids
    change (an insert that spawns cells replaces the centroid tensor)."""
    _, _, data, _ = mp_pair
    st = R("rt", data[:500])          # 6 real cells, 268 free slots
    st.search(data[0], k=3, nprobe=4)
    first = st._cents_rt
    assert first is not None and st._cents_rt_src is st._centroids
    st.insert_batch([f"far{i}" for i in range(400)],
                    data[:400] * 40.0 + 100.0)       # overflow spawns cells
    assert st._centroids is not st._cents_rt_src
    assert st.search(data[0] * 40.0 + 100.0, k=1, nprobe=4)[0][0] == "far0"
    assert st._cents_rt is not first and st._cents_rt_src is st._centroids
    assert st._cents_rt.shape[0] == st._centroids.shape[0]


# ------------------------------------- tests/test_int4r.py, re-pointed


class TestNprobeCalibration:
    """recall_target -> nprobe (calibrate_nprobe): the curve is
    ceiling-relative (deep probe == 1.0), monotone non-decreasing, persists
    through state export/import, and recall_target searches match the
    curve's chosen nprobe exactly."""

    @pytest.fixture(scope="class")
    def cal_store(self):
        rng = np.random.default_rng(11)
        n, d = 6000, 24
        centers = rng.standard_normal((40, d)).astype(np.float32)
        data = (centers[rng.integers(0, 40, n)]
                + 0.25 * rng.standard_normal((n, d)).astype(np.float32))
        return R("cal", data)

    def test_curve_shape_and_persistence(self, cal_store):
        curve = cal_store.calibrate_nprobe(n_sample=64, k=5)
        assert curve[max(curve)] == 1.0
        vals = [curve[p] for p in sorted(curve)]
        for a, b in zip(vals, vals[1:]):
            assert b >= a - 0.05, curve
        state = cal_store.export_state()
        assert state["calibrations"]
        st2 = VectorStore.from_state(state, device=CPU)
        cal2 = st2._calib.get(5, "cosine")
        assert cal2 is not None and cal2.curve == curve
        assert cal2.mode == "ceiling" and cal2.ceiling == 1.0
        # and the JAX package reads the port's curves
        jst = jstore.VectorStore.from_state(state)
        assert jst._calib.get(5, "cosine").curve == curve

    def test_recall_target_search(self, cal_store):
        if cal_store._calib.get(5, "cosine") is None:
            cal_store.calibrate_nprobe(n_sample=64, k=5)
        q = np.asarray(cal_store.get("7")[0], np.float32)
        want = cal_store._nprobe_for_target(0.9, k=5)
        r_target = cal_store.search(q, k=5, recall_target=0.9)
        r_nprobe = cal_store.search(q, k=5, nprobe=want)
        assert [h[0] for h in r_target] == [h[0] for h in r_nprobe]
        with pytest.raises(ValueError):
            cal_store.search(q, k=5, nprobe=4, recall_target=0.9)
        with pytest.raises(ValueError):
            cal_store.search(q, k=5, recall_target=1.5)

    def test_recall_target_rejected_on_non_cell_store(self):
        rng = np.random.default_rng(3)
        st = VectorStore.from_matrix(
            "cal8", rng.standard_normal((64, 8)).astype(np.float32),
            dtype="int8", device=CPU)
        with pytest.raises(ValueError):
            st.search(np.zeros(8, np.float32), k=2, recall_target=0.9)


# ---------------------------------------- spilled streaming layouts


def _spill_corpus(seed=31, n=4096, d=32):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((24, d)).astype(np.float32)
    return (centers[rng.integers(0, 24, n)]
            + 0.3 * rng.standard_normal((n, d)).astype(np.float32))


def _spill_chunks(data):
    return (data[i:i + 1024] for i in range(0, len(data), 1024))


@pytest.fixture(scope="module")
def spilled():
    data = _spill_corpus()
    st = VectorStore.from_chunks("sp", _spill_chunks(data), n=len(data),
                                 dim=data.shape[1], cell_rows=48, cell_cap=64,
                                 spill_mult=1.3, train_rows=2048, device=CPU)
    return st, data


class TestSpilledStore:
    def test_built_with_copies(self, spilled):
        st, data = spilled
        assert st._spilled and st.build_stats["spilled_rows"] > 0
        assert st.count == len(data)

    @pytest.mark.parametrize("nprobe", [None, 8])
    def test_answers_dedup(self, spilled, nprobe):
        """Over-fetch 2k and keep each row's best hit: no id twice, k hits,
        the query's own row first."""
        st, data = spilled
        res = st.search_batch(data[:16], k=10, nprobe=nprobe)
        for i, hits in enumerate(res):
            ids = [h[0] for h in hits]
            assert ids[0] == str(i) and len(ids) == 10 == len(set(ids))
        d, _r, ids = st.search_batch_complete_raw(
            st.search_batch_submit(data[:16], k=10, nprobe=nprobe))
        assert ids.shape == (16, 10)
        for row in ids.tolist():
            assert len(set(row)) == len(row)

    def test_targeted_mutations_refused(self, spilled):
        st, data = spilled
        for call in (lambda: st.delete("3"), lambda: st.get("3"),
                     lambda: st.insert("new", data[0])):
            with pytest.raises(ValueError, match="spill"):
                call()

    def test_state_roundtrip_keeps_the_layout(self, spilled):
        st, data = spilled
        state = st.export_state()
        assert state["spilled"] and "perm" in state
        back = VectorStore.from_state(state, device=CPU)
        assert back._spilled and back.count == st.count
        for nprobe in (None, 8):
            assert (_ids(back.search_batch(data[:8], k=10, nprobe=nprobe))
                    == _ids(st.search_batch(data[:8], k=10, nprobe=nprobe)))


def test_spilled_jax_state_searches_alike():
    """A JAX spilled streaming build carried across: ids identical through
    the exact scan and the multiprobe path."""
    data = _spill_corpus(seed=33)
    js = jstore.VectorStore.from_chunks(
        "sp", _spill_chunks(data), n=len(data), dim=data.shape[1],
        cell_rows=48, cell_cap=64, spill_mult=1.3, train_rows=2048)
    assert js._spilled
    ts = VectorStore.from_state(js.export_state(), device=CPU)
    assert ts._spilled
    qs = data[::97][:24]
    for kw in ({}, {"nprobe": 6}):
        jd, jids = _raw(js, qs, k=10, **kw)
        td, tids = _raw(ts, qs, k=10, **kw)
        assert tids.tolist() == jids.tolist()
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
