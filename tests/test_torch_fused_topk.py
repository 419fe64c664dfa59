"""The port's fused top-k (erlvectordb_tpu_torch/ops/fused_topk.py) against
the JAX package's, on the CPU.

The JAX scans run as the JAX package's own tests run them here: Pallas in
interpret mode.  The port runs its plain PyTorch versions (the CUDA kernels'
twins; tests/test_torch_cuda.py holds the kernels against them on a card).
Inputs are made from a seed with numpy and handed to both as arrays.

Scan-level tests call the JAX ``_intkey_scan``/``_l2key_scan``/``_pos_scan``
/``_fused_scan`` directly: that keeps the POS_MIN_TILES gate and the JAX
jit cache out of the comparison.  The JAX scans need the batch to be a
multiple of their query tile (32 here; 64 for the 2-tile corpus), and they
may emit extra key columns when they round the tile count up to a sub-tile
group; the port scans exactly ``n_tiles`` tiles, so only the first
``4 * n_tiles`` (or ``T * n_tiles``) columns are compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erlvectordb_tpu.ops.fused_topk as jft
import erlvectordb_tpu_torch.ops.fused_topk as tft
from erlvectordb_tpu.core.search import exact_topk, exact_topk_int8

torch.set_num_threads(2)

TILE_N = jft.TILE_N


def _quantize(data):
    absmax = np.abs(data).max(axis=1)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    codes = np.clip(np.round(data / scale[:, None]), -127, 127).astype(np.int8)
    return codes, scale


def _unit_quantize(data):
    n2 = np.linalg.norm(data, axis=1)
    f = np.where(n2 > 0, 127.0 / np.where(n2 > 0, n2, 1.0), 0.0)
    return np.clip(np.round(data * f[:, None]), -127, 127).astype(np.int8)


def _mag_quantize(data):
    s = float(np.linalg.norm(data, axis=1).max())
    return (np.clip(np.round(data * (127.0 / s)), -127, 127).astype(np.int8),
            s)


@pytest.fixture(scope="module")
def corpus():
    """2-tile corpus (tests/test_fused_topk.py's recipe), 64 queries."""
    rng = np.random.default_rng(0)
    n_cap, n, d = 2 * TILE_N, TILE_N + 1234, 128
    data = np.zeros((n_cap, d), np.float32)
    data[:n] = rng.standard_normal((n, d)).astype(np.float32)
    valid = np.zeros(n_cap, bool)
    valid[:n] = True
    valid[17] = False
    valid[4000] = False
    norms = np.linalg.norm(data, axis=1).astype(np.float32)
    queries = rng.standard_normal((64, d)).astype(np.float32)
    return data, norms, valid, queries, n


@pytest.fixture(scope="module")
def spiked_corpus():
    """3-tile corpus with 6 dominant matches of query 0 spaced >1024 rows
    apart (tests/test_fused_topk.py's recipe), 32 queries."""
    rng = np.random.default_rng(3)
    n_cap = 3 * TILE_N
    n, d = n_cap - 500, 128
    data = np.zeros((n_cap, d), np.float32)
    data[:n] = rng.standard_normal((n, d)).astype(np.float32)
    valid = np.zeros(n_cap, bool)
    valid[:n] = True
    queries = rng.standard_normal((32, d)).astype(np.float32)
    targets = [100, 2100, 4200, 6300, 8400, 10500]
    for i, t in enumerate(targets):
        data[t] = queries[0] * (1.0 + 0.02 * (i + 1))
    norms = np.linalg.norm(data, axis=1).astype(np.float32)
    return data, norms, valid, queries, targets


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _factors(metric, data, norms, valid, queries, int8):
    """The port's affine factors (tensors) for one store layout."""
    if int8:
        codes, scales = _quantize(data)
        return (_t(codes), _t(scales)) + tft._affine_factors(
            metric, _t(scales), _t(norms), _t(valid), _t(queries))[:4]
    return (_t(data), None) + tft._affine_factors(
        metric, None, _t(norms), _t(valid), _t(queries))[:4]


# ----------------------------------------------------------------- scans


@pytest.mark.parametrize("plane", ["unit", "mag"])
def test_intkey_scan_bit_identical(spiked_corpus, plane):
    data, norms, valid, queries, _ = spiked_corpus
    codes = _unit_quantize(data) if plane == "unit" else _mag_quantize(data)[0]
    codes[~valid] = 0
    q8 = tft._affine_factors("dot", _t(np.ones(len(data), np.float32)),
                             _t(norms), _t(valid), _t(queries))[0].numpy()
    nt = 3
    kj = np.asarray(jft._intkey_scan(jnp.asarray(codes), jnp.asarray(q8),
                                     n_tiles=nt))
    kt = tft.intkey_scan(_t(codes), _t(q8), nt).numpy()
    assert kt.shape == (32, 4 * nt) and kt.dtype == np.int32
    np.testing.assert_array_equal(kt, kj[:, :4 * nt])


@pytest.mark.parametrize("bias_kind", ["l2", "wide"])
def test_l2key_scan_bit_identical(spiked_corpus, bias_kind):
    data, norms, valid, queries, _ = spiked_corpus
    mag, s = _mag_quantize(data)
    mag[~valid] = 0
    if bias_kind == "l2":
        # the store's own bias: 127 |x|^2 / (2 S s_b), clamped below 2^20
        s_b = max(float(np.abs(queries).max()), 1e-30) / 127.0
        bias = np.minimum(norms * norms * (127.0 / 2.0) / (s * s_b),
                          float(1 << 20)).astype(np.int32)
    else:  # the full clamp range, so (D - bias) spans negative keys
        bias = np.random.default_rng(5).integers(
            0, 1 << 20, len(data)).astype(np.int32)
    s_b = np.float32(max(float(np.abs(queries).max()), 1e-30) / 127.0)
    q8b = np.clip(np.round(queries / s_b), -127, 127).astype(np.int8)
    nt = 3
    kj = np.asarray(jft._l2key_scan(jnp.asarray(mag), jnp.asarray(q8b),
                                    jnp.asarray(bias), n_tiles=nt))
    kt = tft.l2key_scan(_t(mag), _t(q8b), _t(bias), nt).numpy()
    np.testing.assert_array_equal(kt, kj[:, :4 * nt])


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_pos_scan_keys(spiked_corpus, metric, int8):
    """B3 keys with the store's own window (f, g) and row terms.  The JAX
    kernel's ``s * m (* qm) + b`` compiles to one fused multiply-add under
    XLA; the port takes it as one too, so the keys are bit-identical.  A
    one-step (1024) difference on <= 0.1% of entries is the bar, for f32
    codes whose dots sum in another order."""
    data, norms, valid, queries, _ = spiked_corpus
    codes, scales, q_in, qmult, rowmult, rowbias = _factors(
        metric, data, norms, valid, queries, int8)
    f, g, m, b = tft._pos_window(codes, scales, _t(norms), _t(valid), q_in,
                                 qmult, rowmult, rowbias, metric)
    use_qm = metric == "euclidean"
    nt = 3
    kj = np.asarray(jft._pos_scan(
        jnp.asarray(codes.numpy()), jnp.asarray(q_in.numpy()),
        jnp.asarray(qmult.numpy()), jnp.asarray(f.numpy()),
        jnp.asarray(g.numpy()), jnp.asarray(m.numpy()[None]),
        jnp.asarray(b.numpy()[None]), n_tiles=nt, use_qm=use_qm))[:, :4 * nt]
    kt = tft.pos_scan(codes, q_in, qmult, f, g, m, b, nt, use_qm).numpy()
    diff = kt != kj
    if int8:
        np.testing.assert_array_equal(kt, kj)
    else:
        assert diff.mean() <= 1e-3
        assert np.all(np.abs(kt[diff].astype(np.int64) - kj[diff]) == 1024)


@pytest.mark.parametrize("t_per_tile", [2, 8])
@pytest.mark.parametrize("int8", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_fused_scan_matches(corpus, metric, int8, t_per_tile):
    data, norms, valid, queries, _ = corpus
    codes, _, q_in, qmult, rowmult, rowbias = _factors(
        metric, data, norms, valid, queries, int8)
    nt = 2
    vj, rj = map(np.asarray, jft._fused_scan(
        jnp.asarray(codes.numpy()), jnp.asarray(q_in.numpy()),
        jnp.asarray(qmult.numpy()), jnp.asarray(rowmult.numpy()[None]),
        jnp.asarray(rowbias.numpy()[None]), n_tiles=nt,
        t_per_tile=t_per_tile))
    cols = t_per_tile * nt
    vt, rt = tft.fused_scan(codes, q_in, qmult, rowmult, rowbias, nt,
                            t_per_tile)
    assert vt.shape == rt.shape == (64, cols)
    np.testing.assert_array_equal(rt.numpy(), rj[:, :cols])
    np.testing.assert_allclose(vt.numpy(), vj[:, :cols], rtol=2.5e-4)


def test_requantize_planes_bit_identical(spiked_corpus):
    data, norms, valid, _, _ = spiked_corpus
    codes, scales = _quantize(data)
    valid = valid.copy()
    valid[[5, 2100]] = False
    uj = np.asarray(jft.requantize_unit(jnp.asarray(codes), jnp.asarray(scales),
                                        jnp.asarray(norms), jnp.asarray(valid)))
    ut = tft.requantize_unit(_t(codes), _t(scales), _t(norms), _t(valid),
                             chunk=5000).numpy()
    np.testing.assert_array_equal(ut, uj)
    s = 1.25 * float(norms[valid].max())
    mj = np.asarray(jft.requantize_mag(jnp.asarray(codes), jnp.asarray(scales),
                                       jnp.asarray(valid), s))
    mt = tft.requantize_mag(_t(codes), _t(scales), _t(valid), s).numpy()
    np.testing.assert_array_equal(mt, mj)
    assert np.all(mt[~valid] == 0) and np.all(ut[~valid] == 0)


# ------------------------------------------------------------ end to end


def _exact(metric, data, norms, valid, queries, k, int8):
    if int8:
        codes, scales = _quantize(data)
        d, r = exact_topk_int8(jnp.asarray(codes), jnp.asarray(scales),
                               jnp.asarray(norms), jnp.asarray(valid),
                               jnp.asarray(queries), metric=metric, k=k)
    else:
        d, r = exact_topk(jnp.asarray(data), jnp.asarray(norms),
                          jnp.asarray(valid), jnp.asarray(queries),
                          metric=metric, k=k)
    return np.asarray(d), np.asarray(r)


def _port(metric, data, norms, valid, queries, k, n_tiles, int8,
          codes_unit=None, plane_scale=None):
    if int8:
        codes, scales = _quantize(data)
        codes, scales = _t(codes), _t(scales)
    else:
        codes, scales = _t(data), None
    d, r = tft.fused_topk(codes, scales, _t(norms), _t(valid), _t(queries),
                          metric=metric, k=k, n_tiles=n_tiles,
                          codes_unit=codes_unit, plane_scale=plane_scale)
    assert d.dtype == torch.float32 and r.dtype == torch.int32
    return d.numpy(), r.numpy()


@pytest.fixture
def pos_gate(monkeypatch):
    monkeypatch.setattr(tft, "POS_MIN_TILES", 1)


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_masked_path_matches_exact(corpus, metric, int8):
    data, norms, valid, queries, n = corpus
    k = 8
    nt = tft.n_tiles_for(n, data.shape[0])
    d_f, r_f = _port(metric, data, norms, valid, queries, k, nt, int8)
    d_x, r_x = _exact(metric, data, norms, valid, queries, k, int8)
    assert d_f.shape == (len(queries), k)
    for b in range(len(queries)):
        assert len(set(r_f[b]) & set(r_x[b])) >= k - 1, (metric, b)
    np.testing.assert_allclose(d_f[:, 0], d_x[:, 0], rtol=1e-4, atol=1e-4)


def _spiked_check(r_f, d_f, r_x, d_x, r_wide, targets):
    # query 0's top-6 are the planted spikes, in distinct slices -> exact;
    # random queries at this tiny size lose same-slice collisions, so every
    # returned row must be a genuine near neighbour and the top-1 exact
    assert set(r_f[0]) == set(r_x[0]) == set(targets)
    np.testing.assert_allclose(np.sort(d_f[0]), np.sort(d_x[0]),
                               rtol=1e-4, atol=1e-4)
    for b in range(1, r_f.shape[0]):
        assert set(r_f[b]) <= set(r_wide[b]), b


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_pos_path_matches_exact(spiked_corpus, pos_gate, metric, int8):
    data, norms, valid, queries, targets = spiked_corpus
    k, nt = 6, 3
    d_f, r_f = _port(metric, data, norms, valid, queries, k, nt, int8)
    d_x, r_x = _exact(metric, data, norms, valid, queries, k, int8)
    _, r_wide = _exact(metric, data, norms, valid, queries, 24, int8)
    _spiked_check(r_f, d_f, r_x, d_x, r_wide, targets)
    np.testing.assert_allclose(d_f[:, 0], d_x[:, 0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_intkey_path_matches_exact(spiked_corpus, pos_gate, metric):
    data, norms, valid, queries, targets = spiked_corpus
    k, nt = 6, 3
    if metric == "cosine":
        plane, s = _unit_quantize(data), None
    else:
        plane, s = _mag_quantize(data)
    plane[~valid] = 0
    d_f, r_f = _port(metric, data, norms, valid, queries, k, nt, True,
                     codes_unit=_t(plane),
                     plane_scale=s if metric == "euclidean" else None)
    d_x, r_x = _exact(metric, data, norms, valid, queries, k, True)
    _, r_wide = _exact(metric, data, norms, valid, queries, 24, True)
    _spiked_check(r_f, d_f, r_x, d_x, r_wide, targets)
    # the 8-bit key plane is selection-grade: the top-1 may swap with a
    # near-tie neighbour (the JAX test's own bar)
    np.testing.assert_allclose(d_f[:, 0], d_x[:, 0], rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("path", ["masked", "pos", "intkey"])
def test_deleted_rows_never_returned(spiked_corpus, monkeypatch, path):
    data, norms, valid, queries, targets = spiked_corpus
    valid = valid.copy()
    valid[targets[1]] = False
    plane = None
    if path != "masked":
        monkeypatch.setattr(tft, "POS_MIN_TILES", 1)
    if path == "intkey":
        plane = _unit_quantize(data)
        plane[~valid] = 0
        plane = _t(plane)
    _, r_f = _port("cosine", data, norms, valid, queries, 6, 3, True,
                   codes_unit=plane)
    assert targets[1] not in r_f[0]
    assert set(targets) - {targets[1]} <= set(r_f[0])
    assert r_f.max() < len(data) - 500  # never a padding row


def test_single_query_batch(corpus):
    """A 1-query batch answers like the same query inside a full batch."""
    data, norms, valid, queries, n = corpus
    nt = tft.n_tiles_for(n, data.shape[0])
    d1, r1 = _port("cosine", data, norms, valid, queries[:1], 4, nt, True)
    assert d1.shape == (1, 4)
    _, r64 = _port("cosine", data, norms, valid, queries, 4, nt, True)
    np.testing.assert_array_equal(r1[0], r64[0])


def test_gates_and_constants_match():
    for name in ("TILE_N", "MAX_T_PER_TILE", "POS_SLICE", "POS_MIN_TILES",
                 "POS_MAX_K", "INTKEY_SHIFT", "L2KEY_BIAS_MAX"):
        assert getattr(tft, name) == getattr(jft, name), name
    for metric in ("cosine", "euclidean", "dot", "manhattan"):
        for nt in (1, jft.POS_MIN_TILES - 1, jft.POS_MIN_TILES, 400):
            for k in (1, 10, 16, 17):
                assert (tft.intkey_applies(metric, nt, k)
                        == jft.intkey_applies(metric, nt, k))
                assert (tft.pos_path_applies(metric, nt, k)
                        == jft.pos_path_applies(metric, nt, k))
    for count, cap in ((1, 1024), (4096, 4096), (4097, 8192), (10 ** 6, 1 << 20)):
        assert tft.n_tiles_for(count, cap) == jft.n_tiles_for(count, cap)
        for metric in ("cosine", "manhattan"):
            assert (tft.fused_topk_available(count, cap, metric,
                                             torch.device("cuda"), 10)
                    == jft.fused_topk_available(count, cap, metric, "tpu", 10))
            assert not tft.fused_topk_available(count, cap, metric,
                                                torch.device("cpu"), 10)


def test_opt_out_disables_key_paths(monkeypatch):
    assert tft.pos_path_applies("cosine", tft.POS_MIN_TILES, 10)
    monkeypatch.setattr(tft, "POS_PATH_ENABLED", False)
    assert not tft.pos_path_applies("cosine", tft.POS_MIN_TILES, 10)
    assert not tft.intkey_applies("cosine", tft.POS_MIN_TILES, 10)


def test_wrappers_refuse_non_cuda_accelerators():
    """A wrapper takes its plain version only for CPU tensors; anything
    else must reach the kernel's checks, which refuse non-CUDA tensors."""
    q = torch.zeros((2, 128), dtype=torch.int8, device="meta")
    c = torch.zeros((TILE_N, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        tft.intkey_scan(c, q, 1)
    assert tft.intkey_scan.launches == 0
