"""The port's cell build (erlvectordb_tpu_torch/ops/cell_build.py,
ops/kmeans.py, core/ivf.py) against the JAX package's, on the CPU, plus the
cases of tests/test_cell_build.py that apply to int4 cells, re-pointed at
the port.

Builds draw random numbers (k-means seeding), and a torch.Generator does not
give jax.random's draws: the k-means parity tests hand both sides the same
initial centroids, and the build tests compare invariants and the recall of
the built store's exhaustive scan.  Inputs are made from seeds with numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erlvectordb_tpu.core.ivf as jivf
import erlvectordb_tpu.ops.cell_build as jcb
import erlvectordb_tpu.ops.kmeans as jkm
import erlvectordb_tpu_torch.core.ivf as tivf
import erlvectordb_tpu_torch.ops.cell_build as cb
import erlvectordb_tpu_torch.ops.kmeans as tkm
from erlvectordb_tpu_torch.ops.fused_topk import unpack_int4

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _chunks(data, ch):
    for i in range(0, len(data), ch):
        yield data[i:i + ch]


@pytest.fixture(scope="module")
def module_rng():
    return np.random.default_rng(7)


@pytest.fixture(scope="module")
def corpus(module_rng):
    centers = module_rng.standard_normal((20, 48)).astype(np.float32)
    assign = module_rng.integers(0, 20, 3000)
    return (centers[assign]
            + 0.3 * module_rng.standard_normal((3000, 48))).astype(np.float32)


def _clusters(seed, n, d, k, spread=3.0, noise=0.5):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((k, d)).astype(np.float32) * spread
    return (c[rng.integers(0, k, n)]
            + noise * rng.standard_normal((n, d))).astype(np.float32)


# ------------------------------------------------------------------ k-means


@pytest.mark.parametrize("balance", [0.0, 0.3])
def test_lloyd_matches_jax(balance):
    """Lloyd from the same initial centroids: centroids allclose at rtol
    1e-4, atol 1e-4 (f32 member sums taken in another order; well-separated
    clusters, so no assignment flips on a near-tie)."""
    x = _clusters(1, 4000, 16, 12)
    cents0 = x[np.random.default_rng(2).choice(len(x), 24, replace=False)]
    cj = np.asarray(jkm._lloyd(jnp.asarray(x), jnp.asarray(cents0), 24, 8,
                               balance=balance))
    ct = tkm._lloyd(_t(x), _t(cents0), 24, 8, balance=balance).numpy()
    np.testing.assert_allclose(ct, cj, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        tkm._assign(_t(x), _t(ct)).numpy(),
        np.asarray(jkm._assign(jnp.asarray(x), jnp.asarray(cj))))


def test_reseed_candidates_match_jax():
    x = _clusters(3, 1000, 8, 5)
    d = np.random.default_rng(4).random(1000).astype(np.float32)
    np.testing.assert_array_equal(
        tkm._reseed_candidates(_t(x), _t(d), 37).numpy(),
        np.asarray(jkm._reseed_candidates(jnp.asarray(x), jnp.asarray(d), 37)))


def test_kmeans_fit_quality():
    """k-means++ draws other rows than jax.random's, for the same job: on
    well-separated clusters the fit's error is within 10% of the JAX fit's."""
    x = _clusters(5, 3000, 16, 10)
    cj, aj = jkm.kmeans_fit(jnp.asarray(x), jnp.uint32(0), k=10, iters=10,
                            init="kpp")
    ct, at = tkm.kmeans_fit(_t(x), 0, k=10, iters=10, init="kpp")
    err = lambda c, a: float(np.mean(np.sum((x - np.asarray(c)[np.asarray(a)])
                                            ** 2, axis=1)))
    assert err(ct, at) <= 1.1 * err(cj, aj)
    assert ct.shape == (10, 16) and at.dtype == torch.int64


@pytest.mark.parametrize("n,k", [(500, 20), (10, 16)])
def test_kmeans_random_init_takes_rows(n, k):
    """Random seeding starts from k rows of x, distinct when n >= k (the
    JAX package's choice without replacement), and a seed fixes them."""
    x = _t(np.random.default_rng(8).standard_normal((n, 6)).astype(np.float32))
    c0, _ = tkm.kmeans_fit(x, 4, k=k, iters=0)
    hit = (c0[:, None, :] == x[None, :, :]).all(dim=2)
    assert bool(hit.any(dim=1).all())
    if n >= k:
        assert len({int(i) for i in hit.float().argmax(dim=1)}) == k
    torch.testing.assert_close(tkm.kmeans_fit(x, 4, k=k, iters=0)[0], c0)


class TestBalancedLloyd:
    """tests/test_cell_build.py::TestBalancedLloyd, re-pointed."""

    def test_balance_harmless_on_iid(self):
        x = _t(np.random.default_rng(5).standard_normal((20_000, 16))
               .astype(np.float32))

        def spread(balance):
            cents, assign = tkm.kmeans_fit(x, 0, k=64, iters=12, init="kpp",
                                           balance=balance)
            counts = np.bincount(assign.numpy(), minlength=64)
            err = float(torch.mean(torch.sum((x - cents[assign]) ** 2, dim=-1)))
            return counts.std() / counts.mean(), err

        cv0, err0 = spread(0.0)
        cv1, err1 = spread(0.3)
        assert cv1 < max(2 * cv0, 0.35), (cv0, cv1)
        assert err1 < err0 * 1.05, (err0, err1)

    def test_balance_moves_centroids_into_mass(self):
        rng = np.random.default_rng(5)
        fat = rng.standard_normal((6, 16)).astype(np.float32)
        thin = rng.standard_normal((58, 16)).astype(np.float32)
        n = 20_000
        nf = int(n * 0.7)
        x = _t(np.concatenate([
            fat[rng.integers(0, 6, nf)] + 0.15 * rng.standard_normal((nf, 16)),
            thin[rng.integers(0, 58, n - nf)]
            + 0.15 * rng.standard_normal((n - nf, 16)),
        ]).astype(np.float32))

        def err_of(balance):
            cents, assign = tkm.kmeans_fit(x, 0, k=64, iters=15, init="kpp",
                                           balance=balance)
            return float(torch.mean(torch.sum((x - cents[assign]) ** 2, dim=-1)))

        assert err_of(1.0) < err_of(0.0)

    def test_balance_zero_is_identity_path(self):
        x = _t(np.random.default_rng(7).standard_normal((2_000, 8))
               .astype(np.float32))
        c1, a1 = tkm.kmeans_fit(x, 3, k=16, iters=6, init="kpp")
        c2, a2 = tkm.kmeans_fit(x, 3, k=16, iters=6, init="kpp", balance=0.0)
        np.testing.assert_array_equal(a1.numpy(), a2.numpy())


# ------------------------------------------------------- balanced assignment


def _dyadic(seed, n, d, scale=16):
    """Rows whose dots are exact in f32 in any summation order (multiples of
    1/scale), so both packages see bit-equal distances."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-48, 49, (n, d)) / scale).astype(np.float32)


@pytest.mark.parametrize("cap,j", [(64, 8), (52, 16), (200, 4)])
def test_balanced_assign_identical_owners(cap, j):
    data = _dyadic(1, 3000, 8)
    cents = _dyadic(2, 60, 8)
    want = jivf._balanced_assign(data, cents, cap, j=j)
    got = tivf._balanced_assign(data, cents, cap, j=j, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert np.bincount(got, minlength=60).max() <= cap


def test_balanced_assign_refuses_too_little_capacity():
    with pytest.raises(ValueError, match="cannot hold"):
        tivf._balanced_assign(_dyadic(1, 3000, 8), _dyadic(2, 60, 8), 40,
                              device="cpu")


@pytest.mark.parametrize("build", ["balanced_assign", "build_cells_streaming"])
def test_default_device_is_the_card(monkeypatch, build):
    """With no device named, both builds run on the CUDA card; without one
    they raise instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, cents = _dyadic(1, 300, 8), _dyadic(2, 10, 8)
    run = {"balanced_assign": lambda **kw: tivf._balanced_assign(
               data, cents, 64, j=4, **kw),
           "build_cells_streaming": lambda **kw: cb.build_cells_streaming(
               _chunks(data, 100), n=300, dim=8, cell_rows=32, cell_cap=64,
               train_rows=300, k_block=1, **kw)}[build]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
    run(device="cpu")


def test_top_choices_match_jax():
    data, cents = _dyadic(3, 500, 8), _dyadic(4, 50, 8)
    dj, ij = map(np.asarray, jivf._top_choices(jnp.asarray(data),
                                               jnp.asarray(cents), j=8))
    dt, it = tivf._top_choices(_t(data), _t(cents), j=8)
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_array_equal(dt.numpy(), dj)


# ------------------------------------------- capacity assignment, re-pointed


class TestAssignCapacity:
    def test_capacity_respected_and_all_assigned(self, module_rng):
        n, k, j, cap = 2000, 40, 8, 64
        ch_d = np.sort(module_rng.random((n, j)).astype(np.float16), axis=1)
        ch_i = np.stack([module_rng.permutation(k)[:j] for _ in range(n)])
        owner, _ = cb._assign_capacity(_t(ch_d), _t(ch_i.astype(np.int32)),
                                       torch.ones(n, dtype=torch.bool),
                                       k=k, cap=cap, j=j)
        owner = owner.numpy()
        assert (owner >= 0).all() and (owner < k).all()
        fills = np.bincount(owner, minlength=k)
        assert fills.max() <= cap and fills.sum() == n

    def test_first_choice_wins_when_space(self, module_rng):
        n, k, j = 500, 50, 4
        ch_d = np.sort(module_rng.random((n, j)).astype(np.float16), axis=1)
        ch_i = np.stack([module_rng.permutation(k)[:j] for _ in range(n)])
        owner, dumped = cb._assign_capacity(
            _t(ch_d), _t(ch_i.astype(np.int32)), torch.ones(n, dtype=torch.bool),
            k=k, cap=n, j=j)
        np.testing.assert_array_equal(owner.numpy(), ch_i[:, 0])
        assert dumped == 0

    def test_closest_first_within_cell(self):
        n, k, cap = 20, 2, 10
        ch_d = np.stack([np.arange(n) / n, np.full(n, 0.99)], 1).astype(np.float16)
        ch_i = np.broadcast_to(np.array([0, 1], np.int32), (n, 2)).copy()
        owner, _ = cb._assign_capacity(_t(ch_d), _t(ch_i),
                                       torch.ones(n, dtype=torch.bool),
                                       k=k, cap=cap, j=2)
        owner = owner.numpy()
        assert (owner[:cap] == 0).all() and (owner[cap:] == 1).all()

    def test_invalid_rows_excluded(self, module_rng):
        n, k, j, cap = 64, 4, 2, 64
        ch_d = module_rng.random((n, j)).astype(np.float16)
        ch_i = module_rng.integers(0, k, (n, j)).astype(np.int32)
        rv = np.zeros(n, bool)
        rv[:10] = True
        owner, _ = cb._assign_capacity(_t(ch_d), _t(ch_i), _t(rv), k=k,
                                       cap=cap, j=j)
        owner = owner.numpy()
        assert (owner[10:] == k).all() and (owner[:10] < k).all()

    @pytest.mark.parametrize("cap", [8, 25, 60])
    def test_fills_match_jax(self, cap):
        """Same choice lists, same per-cell fills and dump count as the JAX
        assignment (owners may differ only among equal 16-bit sort keys)."""
        rng = np.random.default_rng(cap)
        n, k, j = 3000, 80, 6
        ch_d = np.sort(rng.random((n, j)).astype(np.float32), axis=1)
        ch_i = np.stack([rng.permutation(k)[:j] for _ in range(n)]).astype(np.int32)
        rv = np.ones(n, bool)
        rv[::17] = False
        oj, dj = jcb._assign_capacity(jnp.asarray(ch_d), jnp.asarray(ch_i),
                                      jnp.asarray(rv), k=k, cap=cap, j=j)
        ot, dt = cb._assign_capacity(_t(ch_d), _t(ch_i), _t(rv), k=k, cap=cap,
                                     j=j)
        np.testing.assert_array_equal(np.bincount(ot.numpy(), minlength=k + 1),
                                      np.bincount(np.asarray(oj), minlength=k + 1))
        assert dt == int(dj)


class TestCompactedTailPath:
    def test_tail_path_matches_single_path(self, monkeypatch):
        rng = np.random.default_rng(3)
        n, k, cap, j = 20_000, 64, 512, 8
        ch_d = np.sort(rng.random((n, j)).astype(np.float32), axis=1)
        ch_i = np.stack([(np.arange(n) * 13 + jj * 7) % k
                         for jj in range(j)], 1).astype(np.int32)
        rv = torch.ones(n, dtype=torch.bool)
        o1, d1 = cb._assign_capacity(_t(ch_d), _t(ch_i), rv, k=k, cap=cap, j=j)
        monkeypatch.setattr(cb, "_TAIL_MIN_N", 1024)
        o2, d2 = cb._assign_capacity(_t(ch_d), _t(ch_i), rv, k=k, cap=cap, j=j)
        o1, o2 = o1.numpy(), o2.numpy()
        assert d1 == d2
        f1 = np.bincount(o1[o1 < k], minlength=k)
        f2 = np.bincount(o2[o2 < k], minlength=k)
        assert (f1 <= cap).all() and (f2 <= cap).all()
        assert f1.sum() == f2.sum() == n - d1
        assert o2[0] < k

    def test_doomed_walk_abandons_early(self, monkeypatch):
        n, k, cap, j = 20_000, 64, 512, 16
        ch_d = np.tile(np.arange(j, dtype=np.float32), (n, 1))
        ch_d += np.random.default_rng(0).random((n, 1)).astype(np.float32)
        ch_i = np.tile(np.arange(j, dtype=np.int32) % 4, (n, 1))
        monkeypatch.setattr(cb, "_TAIL_MIN_N", 1024)
        stats = {}
        owner, _ = cb._assign_capacity(_t(ch_d), _t(ch_i),
                                       torch.ones(n, dtype=torch.bool), k=k,
                                       cap=cap, j=j, stats_out=stats)
        owner = owner.numpy()
        fills = np.bincount(owner[owner < k], minlength=k)
        assert (fills <= cap).all() and fills.sum() == n
        assert stats["rounds"] < j, stats

    def test_single_round_runs_below_stop_fraction(self):
        n, k, cap = 8192, 16, 512
        rv = np.zeros((n,), bool)
        rv[:100] = True
        owner, _ = cb._assign_capacity(
            _t(np.ones((n, 1), np.float32)), _t(np.zeros((n, 1), np.int32)),
            _t(rv), k=k, cap=cap, j=1, dump=False)
        owner = owner.numpy()
        assert (owner[:100] == 0).all() and (owner[100:] == k).all()


class TestPositions:
    def test_positions_unique_and_cell_local(self, module_rng):
        n, k, cap = 1000, 16, 128
        owner = np.sort(module_rng.integers(0, k, n).astype(np.int32))
        pos = cb._positions(_t(owner), k=k, cap=cap).numpy()
        assert len(set(pos.tolist())) == n
        np.testing.assert_array_equal(pos // cap, owner)

    def test_invalid_rows_dropped_far(self):
        pos = cb._positions(_t(np.array([0, 1, 2, 3, 3], np.int32)), k=3,
                            cap=8).numpy()
        assert (pos[3:] >= 1 << 30).all() and (pos[:3] < 3 * 8).all()

    def test_positions_match_jax(self, module_rng):
        owner = module_rng.integers(0, 21, 2000).astype(np.int32)
        np.testing.assert_array_equal(
            cb._positions(_t(owner), k=20, cap=128).numpy(),
            np.asarray(jcb._positions(jnp.asarray(owner), k=20, cap=128)))


# ---------------------------------------------------------- encode parity


@pytest.mark.parametrize("aniso", [1.0, 4.0])
def test_residual_quantizer_matches_jax(aniso):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((500, 128)).astype(np.float32)
    res = (0.3 * rng.standard_normal((500, 128))).astype(np.float32)
    res[7] = 0.0
    qj, sj = map(np.asarray, jcb._quantize_residual_int4(
        jnp.asarray(res), jnp.asarray(x), aniso))
    qt, st = cb._quantize_residual_int4(_t(res), _t(x), aniso)
    np.testing.assert_array_equal(qt.numpy(), qj)
    np.testing.assert_array_equal(st.numpy(), sj)
    np.testing.assert_array_equal(cb._pack_int4(qt).numpy(),
                                  np.asarray(jcb._pack_int4(jnp.asarray(qj))))


# ---------------------------------------------------------- streaming build


def _decode(res, d):
    """(slots, reconstructions [S, W], originals' row ids) of a build."""
    valid = res.valid.numpy()
    slots = np.where(valid)[0]
    q = unpack_int4(res.codes[_t(slots)]).float().numpy()
    recon = (res.centroids.numpy()[slots // res.cell_cap]
             + q * res.scales.numpy()[slots][:, None])
    return slots, recon, res.perm.numpy()[slots]


class TestBuildStreaming:
    def test_build_roundtrip(self, corpus):
        n, d = corpus.shape
        res = cb.build_cells_streaming(
            _chunks(corpus, 512), n=n, dim=d, cell_rows=24, cell_cap=32,
            residual_bits=4, train_rows=1024, k_block=8, device="cpu")
        assert res.stats["dumped_rows"] <= n * 0.02
        valid = res.valid.numpy()
        assert valid.sum() == n
        slots, recon, orig_rows = _decode(res, d)
        assert sorted(orig_rows.tolist()) == list(range(n))   # a permutation
        assert res.counts.sum() == n and res.counts.max() <= res.cell_cap
        orig = np.zeros_like(recon)
        orig[:, :d] = corpus[orig_rows]
        err = np.linalg.norm(recon - orig, axis=1)
        assert np.median(err / np.linalg.norm(orig, axis=1)) < 0.30
        np.testing.assert_allclose(res.norms.numpy()[slots],
                                   np.linalg.norm(recon, axis=1),
                                   rtol=6e-3, atol=6e-3)
        # every valid slot's cell is its own: slots grouped per cell
        np.testing.assert_array_equal(
            np.bincount(slots // res.cell_cap, minlength=res.n_cells),
            res.counts)

    def test_assignment_quality_vs_host_greedy(self, corpus):
        """Mean distance-to-owner-centroid within 10% of the host greedy run
        on the same centroids."""
        n, d = corpus.shape
        res = cb.build_cells_streaming(
            _chunks(corpus, 512), n=n, dim=d, cell_rows=24, cell_cap=32,
            train_rows=1024, k_block=8, refits=0, device="cpu")
        cents = res.centroids.numpy()[:res.stats["n_cells_real"], :d]
        slots, _, orig_rows = _decode(res, d)
        d_dev = np.linalg.norm(corpus[orig_rows]
                               - cents[slots // res.cell_cap], axis=1).mean()
        owner_host = tivf._balanced_assign(corpus, cents, 32, j=16,
                                          device="cpu")
        d_host = np.linalg.norm(corpus - cents[owner_host], axis=1).mean()
        assert d_dev <= d_host * 1.10

    def test_uneven_last_chunk_and_single_cell(self):
        data = np.random.default_rng(3).standard_normal((70, 16)).astype(np.float32)
        res = cb.build_cells_streaming(_chunks(data, 32), n=70, dim=16,
                                       cell_rows=128, cell_cap=128, k_block=1,
                                       device="cpu")
        assert res.n_cells == 1 and res.valid.numpy().sum() == 70

    def test_chunk_exhaustion_raises(self):
        data = np.random.default_rng(3).standard_normal((64, 16)).astype(np.float32)
        with pytest.raises(ValueError, match="exhausted"):
            cb.build_cells_streaming(_chunks(data, 32), n=200, dim=16,
                                     cell_rows=32, cell_cap=64, device="cpu")

    def test_refit_reduces_residuals(self, corpus):
        n, d = corpus.shape
        kw = dict(n=n, dim=d, cell_rows=24, cell_cap=32, train_rows=512,
                  kmeans_iters=2, k_block=8, device="cpu")
        r0 = cb.build_cells_streaming(_chunks(corpus, 512), refits=0, **kw)
        r2 = cb.build_cells_streaming(_chunks(corpus, 512), refits=2, **kw)

        def mean_res(res):
            slots, _, orig_rows = _decode(res, d)
            orig = np.zeros((len(slots), res.centroids.shape[1]), np.float32)
            orig[:, :d] = corpus[orig_rows]
            return np.linalg.norm(
                orig - res.centroids.numpy()[slots // res.cell_cap], axis=1).mean()

        assert mean_res(r2) <= mean_res(r0) * 1.01

    def test_contended_build_dumps_bounded(self):
        x = _clusters(7, 32_768, 32, 6)
        res = cb.build_cells_streaming(
            _chunks(x, 4096), n=len(x), dim=32, cell_rows=24, cell_cap=32,
            train_rows=2048, k_block=8, refits=1, device="cpu")
        assert res.stats["dumped_rows"] <= len(x) * 0.15, res.stats
        assert res.counts.sum() == len(x) and res.counts.max() <= res.cell_cap

    def test_half_round_odd_subchunk_count(self):
        x = np.random.default_rng(5).standard_normal((5 * 1024, 32)).astype(np.float32)
        res = cb.build_cells_streaming(
            _chunks(x, 1024), n=len(x), dim=32, cell_rows=24, cell_cap=32,
            train_rows=1024, k_block=8, refits=1, route_sub=1024, device="cpu")
        assert res.counts.sum() == len(x)

    def test_unported_options_refused(self, corpus):
        """Spill copies and 8-bit cells are ported; a residual width other
        than 4 or 8 is refused, as the JAX package refuses it."""
        n, d = corpus.shape
        res = cb.build_cells_streaming(_chunks(corpus, 512), n=n, dim=d,
                                       cell_rows=24, cell_cap=32,
                                       spill_mult=1.3, residual_bits=8,
                                       device="cpu")
        assert res.codes.dtype == torch.int8 and res.stats["spilled_rows"] > 0
        for build in (cb.build_cells_streaming, jcb.build_cells_streaming):
            with pytest.raises(ValueError, match="4 or 8"):
                build(_chunks(corpus, 512), n=n, dim=d, cell_rows=24,
                      cell_cap=32, residual_bits=2)

    def test_recall_close_to_jax_build(self):
        """The exhaustive scan of each package's build of the same corpus
        finds the f32 top-10 equally well: recall within 0.03."""
        from erlvectordb_tpu.core.search import exact_topk_int4r

        x = _clusters(11, 6000, 64, 40, spread=1.0, noise=0.4)
        q = x[:200] + 0.05 * np.random.default_rng(12).standard_normal(
            (200, 64)).astype(np.float32)
        sims = (q @ x.T) / np.linalg.norm(x, axis=1)[None, :]
        truth = np.argsort(-sims, axis=1)[:, :10]
        kw = dict(n=len(x), dim=64, cell_rows=48, cell_cap=64,
                  train_rows=4096, k_block=8)

        def recall(res):
            qp = np.zeros((len(q), 128), np.float32)
            qp[:, :64] = q
            _, rows = exact_topk_int4r(
                jnp.asarray(np.asarray(res.codes)), jnp.asarray(np.asarray(res.scales)),
                jnp.asarray(np.asarray(res.norms)), jnp.asarray(np.asarray(res.valid)),
                jnp.asarray(np.asarray(res.centroids)), jnp.asarray(qp),
                metric="cosine", k=10, cell_cap=res.cell_cap)
            ids = np.asarray(res.perm)[np.asarray(rows)]
            return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, truth)])

        r_jax = recall(jcb.build_cells_streaming(_chunks(x, 1000), **kw))
        r_port = recall(cb.build_cells_streaming(_chunks(x, 1000), device="cpu",
                                                 **kw))
        assert abs(r_port - r_jax) <= 0.03, (r_port, r_jax)
        assert r_port >= 0.6


# ------------------------------------------- 8-bit cells and spill copies


def test_encode_slots_8bit_bit_identical():
    """With the same slots and centroids, the 8-bit encode gives the JAX
    package's codes, scales and norms bit for bit (the residual scale is
    absmax * f32(1/127), as XLA compiles the JAX encode's ``am / 127.0``)."""
    rng = np.random.default_rng(13)
    cap, blk, n_cells, w = 16, 4, 8, 128
    s_total = n_cells * cap
    slot8 = rng.integers(-127, 128, (s_total, w)).astype(np.int8)
    slot_sc = rng.uniform(0.005, 0.05, s_total).astype(np.float32)
    slot_pm = np.arange(s_total, dtype=np.int32)
    slot_pm[rng.random(s_total) < 0.2] = -1
    cents = (0.5 * rng.standard_normal((n_cells, w))).astype(np.float32)
    jc, js, jn, jv = map(np.asarray, jcb._encode_slots(
        jnp.asarray(slot8), jnp.asarray(slot_sc), jnp.asarray(slot_pm),
        jnp.asarray(cents), bits=8, cap=cap, blk=blk))
    tc, ts, tn, tv = cb._encode_slots(_t(slot8), _t(slot_sc), _t(slot_pm),
                                      _t(cents), bits=8, cap=cap, blk=blk)
    assert tc.dtype == torch.int8
    for got, want in ((tc, jc), (ts, js), (tv, jv)):
        np.testing.assert_array_equal(got.numpy(), want)
    # the norms are f32 sums of squares in another order: one or two ulps
    np.testing.assert_allclose(tn.numpy(), jn, rtol=3e-7)
    # the inputs expose the rounding: scales differ from a true division
    live = slot_pm >= 0
    x = slot8.astype(np.float32) * slot_sc[:, None]
    res = np.where(live[:, None], x - cents.repeat(cap, 0), 0)
    am = np.abs(res).max(1)
    assert (am[live] / np.float32(127) != ts.numpy()[live]).any()


def test_spill_proposals_match_jax():
    """With the same choice lists, the same secondary cells, distances and
    eligibility."""
    rng = np.random.default_rng(17)
    n, j, k = 3000, 8, 40
    ch_i = np.stack([rng.permutation(k)[:j] for _ in range(n)]).astype(np.int32)
    ch_d = np.sort(rng.uniform(-3, 1, (n, j)).astype(np.float32), axis=1)
    owner = ch_i[np.arange(n), rng.integers(0, 3, n)].astype(np.int32)
    owner[::50] = k                                       # unplaced rows
    off = rng.random(n) < 0.1
    owner[off] = (ch_i[off, 0] + 1 + rng.integers(0, 2, off.sum())) % k
    xn2 = rng.uniform(2, 6, n).astype(np.float32)
    want = jcb._spill_proposals(jnp.asarray(ch_d), jnp.asarray(ch_i),
                                jnp.asarray(owner), k=k,
                                spill_mult=jnp.float32(1.3),
                                xn2=jnp.asarray(xn2))
    got = cb._spill_proposals(_t(ch_d), _t(ch_i), _t(owner), k=k,
                              spill_mult=1.3, xn2=_t(xn2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < got[2].numpy().mean() < 1


def test_positions_with_base_match_jax(module_rng):
    owner = module_rng.integers(0, 21, 2000).astype(np.int32)
    base = module_rng.integers(0, 40, 20).astype(np.int64)
    np.testing.assert_array_equal(
        cb._positions(_t(owner), k=20, cap=128, base=_t(base)).numpy(),
        np.asarray(jcb._positions(jnp.asarray(owner), k=20, cap=128,
                                  base=jnp.asarray(base))))


def test_spill_round_fills_match_jax(module_rng):
    """The spill round: one acceptance round from the primary fill, no dump
    pass; the same owners as the JAX package's."""
    n, k, cap = 4000, 30, 160
    d = module_rng.uniform(0, 1, (n, 1)).astype(np.float32)
    d[module_rng.random(n) < 0.3] = np.inf
    i = module_rng.integers(0, k, (n, 1)).astype(np.int32)
    ok = np.isfinite(d[:, 0])
    fill0 = module_rng.integers(100, 160, k)
    want, _ = jcb._assign_capacity(jnp.asarray(d), jnp.asarray(i),
                                   jnp.asarray(ok), k=k, cap=cap, j=1,
                                   fill0=jnp.asarray(fill0), dump=False)
    got, _ = cb._assign_capacity(_t(d), _t(i), _t(ok), k=k, cap=cap, j=1,
                                 fill0=_t(fill0), dump=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    placed = got.numpy() < k
    assert placed.any() and not placed.all()
    assert (np.bincount(got.numpy()[placed], minlength=k) + fill0 <= cap).all()


def _decode8(res):
    slots = np.where(res.valid.numpy())[0]
    recon = (res.centroids.numpy()[slots // res.cell_cap]
             + res.codes.numpy()[slots].astype(np.float32)
             * res.scales.numpy()[slots][:, None])
    return slots, recon, res.perm.numpy()[slots]


class TestEightBitAndSpill:
    """tests/test_cell_build.py's 8-bit and spill cases, re-pointed."""

    @pytest.fixture(scope="class")
    def clustered(self):
        rng = np.random.default_rng(21)
        centers = rng.standard_normal((30, 48)).astype(np.float32) * 2
        assign = rng.integers(0, 30, 4000)
        return (centers[assign]
                + 0.8 * rng.standard_normal((4000, 48))).astype(np.float32)

    def test_8bit_build_roundtrip(self, corpus):
        n, d = corpus.shape
        res = cb.build_cells_streaming(
            _chunks(corpus, 512), n=n, dim=d, cell_rows=24, cell_cap=32,
            residual_bits=8, train_rows=1024, k_block=8, device="cpu")
        assert res.codes.dtype == torch.int8 and res.codes.shape[1] == 128
        slots, recon, orig_rows = _decode8(res)
        assert sorted(orig_rows.tolist()) == list(range(n))
        orig = np.zeros_like(recon)
        orig[:, :d] = corpus[orig_rows]
        # int8 residuals: reconstruction error far below int4's
        err = np.linalg.norm(recon - orig, axis=1)
        assert np.median(err / np.linalg.norm(orig, axis=1)) < 0.02
        np.testing.assert_allclose(res.norms.numpy()[slots],
                                   np.linalg.norm(recon, axis=1), rtol=1e-5)

    def test_assignment_quality_vs_host_greedy(self, corpus):
        n, d = corpus.shape
        res = cb.build_cells_streaming(
            _chunks(corpus, 512), n=n, dim=d, cell_rows=24, cell_cap=32,
            residual_bits=8, train_rows=1024, k_block=8, refits=0,
            device="cpu")
        cents = res.centroids.numpy()[:res.stats["n_cells_real"], :d]
        slots, _, orig_rows = _decode8(res)
        d_dev = np.linalg.norm(corpus[orig_rows]
                               - cents[slots // res.cell_cap], axis=1).mean()
        owner_host = tivf._balanced_assign(corpus, cents, 32, j=16,
                                          device="cpu")
        d_host = np.linalg.norm(corpus - cents[owner_host], axis=1).mean()
        assert d_dev <= d_host * 1.10

    def test_refit_reduces_residuals(self, corpus):
        n, d = corpus.shape
        kw = dict(n=n, dim=d, cell_rows=24, cell_cap=32, residual_bits=8,
                  train_rows=512, kmeans_iters=2, k_block=8, device="cpu")

        def mean_res(res):
            slots, _, orig_rows = _decode8(res)
            orig = np.zeros((len(slots), res.centroids.shape[1]), np.float32)
            orig[:, :d] = corpus[orig_rows]
            return np.linalg.norm(
                orig - res.centroids.numpy()[slots // res.cell_cap],
                axis=1).mean()

        r0 = cb.build_cells_streaming(_chunks(corpus, 512), refits=0, **kw)
        r2 = cb.build_cells_streaming(_chunks(corpus, 512), refits=2, **kw)
        assert mean_res(r2) <= mean_res(r0) * 1.01

    def test_contended_build_dumps_bounded(self):
        x = _clusters(7, 32_768, 32, 6)
        res = cb.build_cells_streaming(
            _chunks(x, 4096), n=len(x), dim=32, cell_rows=24, cell_cap=32,
            residual_bits=8, train_rows=2048, k_block=8, refits=1,
            device="cpu")
        assert res.stats["dumped_rows"] <= len(x) * 0.15, res.stats
        assert res.counts.sum() == len(x) and res.counts.max() <= res.cell_cap

    def test_half_round_odd_subchunk_count(self):
        x = np.random.default_rng(5).standard_normal((5 * 1024, 32)).astype(np.float32)
        res = cb.build_cells_streaming(
            _chunks(x, 1024), n=len(x), dim=32, cell_rows=24, cell_cap=32,
            residual_bits=8, train_rows=1024, k_block=8, refits=1,
            route_sub=1024, device="cpu")
        assert res.counts.sum() == len(x)

    def test_spill_places_second_copies(self, clustered):
        """Spilled-build invariants: every row present at least once, the
        copies counted, capacity held, each copy in a cell other than its
        row's primary."""
        n, d = clustered.shape
        res = cb.build_cells_streaming(
            _chunks(clustered, 1024), n=n, dim=d, cell_rows=48, cell_cap=96,
            residual_bits=8, train_rows=2048, k_block=8, spill_mult=1.3,
            device="cpu")
        assert res.stats["spilled_rows"] > 0
        valid = res.valid.numpy()
        perm = res.perm.numpy()
        assert valid.sum() == n + res.stats["spilled_rows"]
        assert set(perm[valid].tolist()) == set(range(n))
        assert res.counts.max() <= res.cell_cap
        assert res.counts.sum() == valid.sum()
        np.testing.assert_array_equal(
            np.bincount(np.where(valid)[0] // res.cell_cap,
                        minlength=res.n_cells), res.counts)
        slots = np.where(valid)[0]
        cells_of = {}
        for s in slots:
            cells_of.setdefault(int(perm[s]), []).append(int(s) // res.cell_cap)
        assert all(len(c) <= 2 and len(set(c)) == len(c)
                   for c in cells_of.values())

    def test_spill_improves_low_nprobe_recall(self, clustered):
        from erlvectordb_tpu_torch.core.cell_probe import CellProbeIndex

        n, d = clustered.shape
        q = clustered[:256]
        sims = (q @ clustered.T) / (
            np.linalg.norm(q, axis=1)[:, None]
            * np.linalg.norm(clustered, axis=1)[None, :])
        truth = np.argsort(-sims, axis=1)[:, :10]

        def recall(idx):
            _, rows = idx.search(q, k=10, nprobe=2)
            return np.mean([len(set(rows[i].tolist()) & set(truth[i].tolist()))
                            / 10 for i in range(len(q))])

        kw = dict(n=n, dim=d, cell_rows=48, cell_cap=96, train_rows=2048,
                  k_block=8, device="cpu")
        r_plain = recall(CellProbeIndex.build_streaming(
            _chunks(clustered, 1024), **kw))
        r_spill = recall(CellProbeIndex.build_streaming(
            _chunks(clustered, 1024), spill_mult=1.4, **kw))
        assert r_spill >= r_plain

    def test_spilled_store_roundtrip_and_mutation_guard(self, clustered):
        from erlvectordb_tpu_torch.core.store import VectorStore

        n, d = clustered.shape
        store = VectorStore.from_chunks(
            "spill1", _chunks(clustered, 1024), n=n, dim=d, cell_rows=48,
            cell_cap=96, train_rows=2048, spill_mult=1.3, device="cpu")
        assert store._spilled and store.count == n
        ids = [h[0] for h in store.search(clustered[5], k=10)]
        assert ids[0] == "5" and len(set(ids)) == len(ids)
        with pytest.raises(ValueError, match="spill"):
            store.delete("5")
        s2 = VectorStore.from_state(store.export_state(), device="cpu")
        assert s2.search(clustered[5], k=3)[0][0] == "5"

    def test_cellprobe_streaming_search_and_roundtrip(self):
        from erlvectordb_tpu_torch.core.cell_probe import CellProbeIndex

        rng = np.random.default_rng(4)
        n, d = 800, 48
        data = rng.standard_normal((n, d)).astype(np.float32)
        idx = CellProbeIndex.build_streaming(
            _chunks(data, 256), n=n, dim=d, cell_rows=48, cell_cap=64,
            train_rows=512, k_block=8, device="cpu")
        assert idx.row_map_dev is not None
        _d, rows = idx.search(data[:16], k=3, nprobe=6)
        assert (rows[:, 0] == np.arange(16)).mean() > 0.9
        idx2 = CellProbeIndex.from_arrays(idx.to_arrays(), device="cpu")
        _, r2 = idx2.search(data[:8], k=1, nprobe=6)
        assert (r2[:, 0] == np.arange(8)).all()
        assert idx.build_stats["vec_per_sec"] > 0

    def test_spilled_recall_close_to_jax_build(self, clustered):
        """Each package's spilled 8-bit build of the same corpus, searched
        by its own index at nprobe 2: recall@10 within 0.03 (the builds
        draw different random numbers)."""
        from erlvectordb_tpu.core.cell_probe import CellProbeIndex as JIndex
        from erlvectordb_tpu_torch.core.cell_probe import CellProbeIndex

        n, d = clustered.shape
        q = clustered[1000:1256]
        sims = (q @ clustered.T) / (
            np.linalg.norm(q, axis=1)[:, None]
            * np.linalg.norm(clustered, axis=1)[None, :])
        truth = np.argsort(-sims, axis=1)[:, :10]

        def recall(idx):
            _, rows = idx.search(q, k=10, nprobe=2)
            return np.mean([len(set(rows[i].tolist()) & set(truth[i].tolist()))
                            / 10 for i in range(len(q))])

        kw = dict(n=n, dim=d, cell_rows=48, cell_cap=96, train_rows=2048,
                  k_block=8, spill_mult=1.3)
        r_jax = recall(JIndex.build_streaming(_chunks(clustered, 1024), **kw))
        r_port = recall(CellProbeIndex.build_streaming(
            _chunks(clustered, 1024), device="cpu", **kw))
        assert abs(r_port - r_jax) <= 0.03, (r_port, r_jax)
