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


# -------------------------------------------- packed int4 (B3/B4) and int4r


def _quantize4(data):
    """The int4 store's codes: absmax/7 scales, packed nibbles."""
    absmax = np.abs(data).max(axis=1)
    scale = np.where(absmax > 0, absmax / 7.0, 1.0).astype(np.float32)
    q4 = np.clip(np.round(data / scale[:, None]), -7, 7).astype(np.int8)
    u = q4.astype(np.uint8)
    return (((u[:, 0::2] & 0xF) << 4) | (u[:, 1::2] & 0xF)).astype(np.uint8), scale


def _jax_rows(b, x):
    """A JAX scan's batch must fill its query tiles: pad to 64 rows with
    zero queries (the port runs the ragged batch as it is)."""
    pad = np.zeros((-(-b // 64) * 64 - b,) + x.shape[1:], x.dtype)
    return jnp.asarray(np.concatenate([x, pad]))


def test_unpack_int4_matches_jax():
    from erlvectordb_tpu.core.search import unpack_int4 as junpack

    packed = np.random.default_rng(1).integers(0, 256, (37, 64)).astype(np.uint8)
    np.testing.assert_array_equal(tft.unpack_int4(_t(packed)).numpy(),
                                  np.asarray(junpack(jnp.asarray(packed))))


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_pos_scan_keys_int4(spiked_corpus, metric):
    """B3 over packed int4 codes, ragged batch of 29: bit-identical keys."""
    data, norms, valid, queries, _ = spiked_corpus
    packed, scales = _quantize4(data)
    q_in, qmult, rowmult, rowbias, _ = tft._affine_factors(
        metric, _t(scales), _t(norms), _t(valid), _t(queries[:29]))
    f, g, m, b = tft._pos_window(_t(packed), _t(scales), _t(norms), _t(valid),
                                 q_in, qmult, rowmult, rowbias, metric)
    use_qm = metric == "euclidean"
    nt = 3
    kj = np.asarray(jft._pos_scan(
        jnp.asarray(packed), _jax_rows(29, q_in.numpy()),
        _jax_rows(29, qmult.numpy()), _jax_rows(29, f.numpy()),
        _jax_rows(29, g.numpy()), jnp.asarray(m.numpy()[None]),
        jnp.asarray(b.numpy()[None]), n_tiles=nt, use_qm=use_qm))[:29, :4 * nt]
    kt = tft.pos_scan(_t(packed), q_in, qmult, f, g, m, b, nt, use_qm).numpy()
    assert kt.shape == (29, 4 * nt)
    np.testing.assert_array_equal(kt, kj)


@pytest.mark.parametrize("t_per_tile", [2, 8])
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_fused_scan_int4_matches(corpus, metric, t_per_tile):
    """B4 over packed int4 codes: rows identical, values bit-identical."""
    data, norms, valid, queries, _ = corpus
    packed, scales = _quantize4(data)
    q_in, qmult, rowmult, rowbias, _ = tft._affine_factors(
        metric, _t(scales), _t(norms), _t(valid), _t(queries[:45]))
    nt = 2
    vj, rj = map(np.asarray, jft._fused_scan(
        jnp.asarray(packed), _jax_rows(45, q_in.numpy()),
        _jax_rows(45, qmult.numpy()), jnp.asarray(rowmult.numpy()[None]),
        jnp.asarray(rowbias.numpy()[None]), n_tiles=nt,
        t_per_tile=t_per_tile))
    cols = t_per_tile * nt
    vt, rt = tft.fused_scan(_t(packed), q_in, qmult, rowmult, rowbias, nt,
                            t_per_tile)
    np.testing.assert_array_equal(rt.numpy(), rj[:45, :cols])
    np.testing.assert_array_equal(vt.numpy(), vj[:45, :cols])


def _residual_inputs(seed, cell_cap, n_tiles=2, b=45, w=128):
    """A cell-major int4r layout (packed residual codes, scales, reconstruction
    norms, centroids [K, W]) and queries near its rows."""
    rng = np.random.default_rng(seed)
    n = n_tiles * TILE_N
    k = n // cell_cap
    cents = rng.standard_normal((k, w)).astype(np.float32)
    resid = 0.3 * rng.standard_normal((n, w)).astype(np.float32)
    packed, scales = _quantize4(resid)
    q4 = tft.unpack_int4(_t(packed)).numpy().astype(np.float32)
    recon = cents.repeat(cell_cap, axis=0) + q4 * scales[:, None]
    norms = np.linalg.norm(recon, axis=1).astype(np.float32)
    valid = np.ones(n, bool)
    valid[[3, 700, n - 1]] = False
    queries = (recon[rng.integers(0, n, b)]
               + 0.2 * rng.standard_normal((b, w))).astype(np.float32)
    return packed, scales, norms, valid, cents, queries


def _residual_factors(metric, packed, scales, norms, valid, cents, queries,
                      cell_cap, n_tiles):
    """Both residual scans' inputs, as fused_topk_residual computes them."""
    (q_in, qmult, rowmult, rowbias, _, qmult2, rowmult2, table,
     qa) = tft.residual_factors(metric, _t(scales), _t(norms), _t(valid),
                                _t(cents), _t(queries), n_tiles, cell_cap)
    ma, mb, bb, f, g = tft._residual_window(
        metric, _t(norms), _t(valid), q_in, qa, rowmult, rowmult2, table,
        cell_cap, tft.max_code_norm(_t(packed)))
    return dict(q_in=q_in, qmult=qmult, rowmult=rowmult, rowbias=rowbias,
                qmult2=qmult2, rowmult2=rowmult2, table=table, qa=qa, ma=ma,
                mb=mb, bb=bb, f=f, g=g)


@pytest.mark.parametrize("t_top", [2, 8])
@pytest.mark.parametrize("cell_cap", [128, 512])
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_pos_residual_scan_bit_identical(metric, cell_cap, t_top):
    """B5 keys, ragged batch of 45: bit-identical with the interpret-mode
    kernel.  XLA fuses ``(dots*qa)*ma + tdot*mb`` into one multiply-add
    (the residual product is the one folded in); the port does the same."""
    packed, scales, norms, valid, cents, queries = _residual_inputs(
        11, cell_cap)
    nt = 2
    a = _residual_factors(metric, packed, scales, norms, valid, cents,
                          queries, cell_cap, nt)
    n = lambda x: x.numpy()
    kj = np.asarray(jft._pos_residual_scan(
        jnp.asarray(packed), _jax_rows(45, n(a["q_in"])),
        _jax_rows(45, n(a["qa"])), _jax_rows(45, n(a["f"])),
        _jax_rows(45, n(a["g"])), jnp.asarray(n(a["ma"])[None]),
        jnp.asarray(n(a["mb"])[None]), jnp.asarray(n(a["bb"])[None]),
        _jax_rows(45, n(a["table"])).T, n_tiles=nt, cell_cap=cell_cap,
        slice_w=1024, t_top=t_top))[:45]
    kt = tft.pos_residual_scan(_t(packed), a["q_in"], a["qa"], a["f"], a["g"],
                               a["ma"], a["mb"], a["bb"], a["table"], nt,
                               cell_cap, 1024, t_top).numpy()
    assert kt.shape == (45, t_top * nt * TILE_N // 1024)
    np.testing.assert_array_equal(kt, kj[:, :kt.shape[1]])


@pytest.mark.parametrize("t_per_tile", [2, 8])
@pytest.mark.parametrize("cell_cap", [128, 512])
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_cell_scan_matches(metric, cell_cap, t_per_tile):
    """B6, ragged batch of 45: rows identical, values bit-identical.  XLA
    fuses the cell term ``trep*qmult2*rowmult2`` into a multiply-add onto
    B4's sims; the port does the same."""
    packed, scales, norms, valid, cents, queries = _residual_inputs(
        13, cell_cap)
    nt = 2
    a = _residual_factors(metric, packed, scales, norms, valid, cents,
                          queries, cell_cap, nt)
    n = lambda x: x.numpy()
    vj, rj = map(np.asarray, jft._fused_scan(
        jnp.asarray(packed), _jax_rows(45, n(a["q_in"])),
        _jax_rows(45, n(a["qmult"])), jnp.asarray(n(a["rowmult"])[None]),
        jnp.asarray(n(a["rowbias"])[None]), _jax_rows(45, n(a["qmult2"])),
        jnp.asarray(n(a["rowmult2"])[None]), _jax_rows(45, n(a["table"])).T,
        n_tiles=nt, t_per_tile=t_per_tile, cell_cap=cell_cap))
    cols = t_per_tile * nt
    vt, rt = tft.cell_scan(_t(packed), a["q_in"], a["qmult"], a["rowmult"],
                           a["rowbias"], a["qmult2"], a["rowmult2"], a["table"],
                           nt, t_per_tile, cell_cap)
    np.testing.assert_array_equal(rt.numpy(), rj[:45, :cols])
    np.testing.assert_array_equal(vt.numpy(), vj[:45, :cols])


def test_max_code_norm_matches_jax():
    packed = np.random.default_rng(4).integers(0, 256, (8192, 64)).astype(np.uint8)
    packed[5000] = 0x77            # one all-sevens row: the max
    assert tft.max_code_norm(_t(packed), chunk=3000) == pytest.approx(
        float(jft.max_code_norm(jnp.asarray(packed))), rel=1e-6)


@pytest.mark.parametrize("path", ["masked", "pos"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_fused_topk_residual_matches_jax(monkeypatch, metric, path):
    """fused_topk_residual end to end on the same inputs: identical ids,
    distances to 1e-5 (the pool rescore's f32 sums run in another order)."""
    packed, scales, norms, valid, cents, queries = _residual_inputs(17, 128,
                                                                    b=32)
    if path == "pos":
        monkeypatch.setattr(jft, "POS_MIN_TILES", 1)
        monkeypatch.setattr(tft, "POS_MIN_TILES", 1)
    cnb = tft.max_code_norm(_t(packed))
    # a k of its own per path: JAX caches the traced function by its static
    # arguments, and the path is chosen while tracing (POS_MIN_TILES)
    kw = dict(metric=metric, k=8 if path == "masked" else 7, n_tiles=2,
              cell_cap=128, t_top=8)
    dj, rj = map(np.asarray, jft.fused_topk_residual(
        jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(norms),
        jnp.asarray(valid), jnp.asarray(cents), jnp.asarray(queries),
        code_norm_bound=jnp.float32(cnb), **kw))
    dt, rt = tft.fused_topk_residual(
        _t(packed), _t(scales), _t(norms), _t(valid), _t(cents), _t(queries),
        code_norm_bound=cnb, **kw)
    np.testing.assert_array_equal(rt.numpy(), rj)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-5, atol=1e-5)


def test_residual_gate_matches():
    for cap, cc in ((4096, 128), (8192, 128), (4096 * 3, 512), (4096, 3000),
                    (6000, 128), (2048, 128)):
        for k in (10, 100):
            want = (cap >= TILE_N and cap % TILE_N == 0 and TILE_N % cc == 0
                    and k <= jft.MAX_T_PER_TILE * jft.n_tiles_for(cap, cap))
            assert tft.residual_scan_applies(cap, cc, "cosine",
                                             torch.device("cuda"), k) == want
            assert not tft.residual_scan_applies(cap, cc, "cosine",
                                                 torch.device("cpu"), k)
    assert not tft.residual_scan_applies(8192, 128, "manhattan",
                                         torch.device("cuda"))
    assert (tft.POS_RES_W, tft.POS_RES_T) == (jft.POS_RES_W, jft.POS_RES_T)


# ------------------------------------------------ B5's launch layout


@pytest.mark.parametrize("bq", [1, 7, 65, 128, 1024, 1025])
@pytest.mark.parametrize("n_slices", [4, 20, 548, 1568])
def test_residual_layout_covers_each_pair_once(bq, n_slices):
    """The blocks of residual_scan_layout's 1-D grid (block b: query tile b
    % q_tiles of MMA_Q_TILE queries, slices ``run`` x (b // q_tiles) on,
    the last of each ragged, as the kernel masks them) cover every (query,
    slice) pair exactly once."""
    lay = tft.residual_scan_layout(bq, n_slices, 128, 128, 132)
    seen = np.zeros((bq, n_slices), np.int64)
    for b in range(lay["blocks"]):
        q0 = (b % lay["q_tiles"]) * tft.MMA_Q_TILE
        s0 = (b // lay["q_tiles"]) * lay["run"]
        assert q0 < bq and s0 < n_slices      # no block is empty
        seen[q0:q0 + tft.MMA_Q_TILE, s0:s0 + lay["run"]] += 1
    assert np.all(seen == 1)
    assert 1 <= lay["run"] <= 8


@pytest.mark.parametrize("w", [128, 256, 384, 512, 640, 1536, 2048, 4224])
@pytest.mark.parametrize("cell_cap", [1, 2, 3, 5, 8, 63, 64, 100, 128, 512, 4096])
def test_residual_layout_cells_bound_every_stage(cell_cap, w):
    """``cells`` bounds the cells each 64-row stage of a slice spans, and the
    shared memory stays within the 227 KB a block may use at every row
    width and cell_cap."""
    lay = tft.residual_scan_layout(1024, 1568, w, cell_cap, 132)
    starts = np.arange(0, 64 * 4096, tft.MMA_ROWS)
    span = (starts + tft.MMA_ROWS - 1) // cell_cap - starts // cell_cap + 1
    assert span.max() <= lay["cells"] <= tft.MMA_ROWS
    assert lay["smem"] <= 232_448


def test_residual_layout_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):          # rows of a partial k stage
        tft.residual_scan_layout(1024, 1568, 200, 128, 132)
    with pytest.raises(ValueError):
        tft.residual_scan_layout(1024, 1568, 128, 0, 132)
    # the store's shape at config 3: 8 query tiles, runs of 8 slices, the
    # query tile resident (one k stage) beside a ring of 4 pieces' factors
    lay = tft.residual_scan_layout(1024, 1568, 128, 128, 132)
    assert (lay["q_tiles"], lay["run"], lay["blocks"]) == (8, 8, 8 * 196)
    assert lay["cells"] == 2
    assert lay["smem"] == (2 * 64 * 144 + 4 * 64 * 64 + 128 * 144
                           + 4 * (64 * 16 + 128 * 2 * 4))
    # 1536-dim rows: 12 k stages, the query streamed through a ring of 4
    wide = tft.residual_scan_layout(1024, 1568, 1536, 128, 132)
    assert wide["smem"] == (2 * 64 * 144 + 4 * 64 * 64 + 4 * 128 * 144
                            + 2 * (64 * 16 + 128 * 2 * 4))


@pytest.mark.parametrize("sm_count", [78, 132])
def test_residual_layout_grid_has_no_y_limit(sm_count):
    """A store of 2^30 rows (1M slices): the grid is 1-D, so its block
    count only has to stay below 2^31 (grid.y would stop at 65,535); the
    run scales with the device's SM count."""
    lay = tft.residual_scan_layout(1, 1 << 20, 128, 128, sm_count)
    assert lay["run"] == 8 and lay["blocks"] == (1 << 20) // 8 < 2 ** 31 - 1
    small = tft.residual_scan_layout(1024, 548, 128, 128, sm_count)
    assert small["run"] == max(1, min(8, 548 * 8 // (4 * sm_count)))


# ------------------------------------ the tensor-core scans' launch layout

SEGS = [(4, 1024), (20, 1024), (1172, 1024), (1, 4096), (5, 4096),
        (293, 4096)]


@pytest.mark.parametrize("bq", [1, 7, 17, 128, 130, 1024, 1025])
@pytest.mark.parametrize("n_segs, seg_rows", SEGS)
def test_mma_layout_covers_each_pair_once(bq, n_segs, seg_rows):
    """The blocks of mma_scan_layout's 1-D grid (block b: query tile b %
    q_tiles, segments ``run`` x (b // q_tiles) on, the last run ragged, as
    the kernels mask them) cover every (query, 1024-row slice or 4096-row
    tile) pair exactly once; a block spans at most 8192 rows."""
    for packed in (False, True):
        lay = tft.mma_scan_layout(bq, n_segs, seg_rows, 128, packed, 0, 132)
        seen = np.zeros((bq, n_segs), np.int64)
        for b in range(lay["blocks"]):
            q0 = (b % lay["q_tiles"]) * tft.MMA_Q_TILE
            s0 = (b // lay["q_tiles"]) * lay["run"]
            assert q0 < bq and s0 < n_segs      # no block is empty
            seen[q0:q0 + tft.MMA_Q_TILE, s0:s0 + lay["run"]] += 1
        assert np.all(seen == 1)
        assert 1 <= lay["run"] * seg_rows <= 8192


@pytest.mark.parametrize("w", list(range(128, 4224 + 1, 128)))
def test_mma_layout_shared_memory_fits_every_width(w):
    """Shared memory within the 227 KB a block may use for every row width
    from 128 to 4224, int8 and packed codes, with no table (B1-B4) or B6's
    at cell_cap 1 (64 cells a stage, the largest blocks), 128 and 512; the
    int8 scans fit two blocks an SM (<= 113 KB each)."""
    for packed in (False, True):
        for cell_cap in (0, 1, 128, 512):
            for seg_rows in (1024, 4096):
                lay = tft.mma_scan_layout(1024, 12, seg_rows, w, packed,
                                          cell_cap, 132)
                assert lay["smem"] <= tft.MMA_SMEM_MAX
                assert lay["cells"] == (0 if cell_cap == 0 else
                                        min(64, 63 // cell_cap + 2))
        lay = tft.mma_scan_layout(1024, 12, 1024, w, packed, 0, 132)
        assert lay["smem"] <= 112_640


def test_mma_layout_sizes_the_stages():
    """The byte counts the kernels carve: int8 rows a ring of 4 stages of
    64 x 144 B, packed rows two unpacked stages and 4 packed ones, the
    query tile resident up to 4 k stages, then a ring of 4 of them; B5's
    layout is the packed one with its table."""
    lay = tft.mma_scan_layout(1024, 1172, 1024, 128, False, 0, 132)
    assert (lay["q_tiles"], lay["run"], lay["blocks"]) == (8, 8, 8 * 147)
    assert lay["smem"] == 4 * 64 * 144 + 128 * 144 + 4 * 64 * 16
    tile = tft.mma_scan_layout(1024, 293, 4096, 128, True, 0, 132)
    assert (tile["run"], tile["blocks"]) == (2, 8 * 147)
    assert tile["smem"] == (2 * 64 * 144 + 4 * 64 * 64 + 128 * 144
                            + 4 * 64 * 16)
    wide = tft.mma_scan_layout(130, 12, 1024, 768, False, 0, 132)
    assert wide["smem"] == 4 * 64 * 144 + 4 * 128 * 144 + 2 * 64 * 16
    assert (tft.mma_scan_layout(1024, 1568, 1024, 256, True, 7, 132)
            == tft.residual_scan_layout(1024, 1568, 256, 7, 132))


@pytest.mark.parametrize("w", [0, 64, 100, 200, 4100])
def test_mma_layout_refuses_bad_widths(w):
    with pytest.raises(ValueError):
        tft.mma_scan_layout(1024, 12, 1024, w, False, 0, 132)
    with pytest.raises(ValueError):
        tft.mma_scan_layout(1024, 12, 4096, w, True, 128, 132)


def test_mma_layout_refuses_a_negative_cell_cap():
    with pytest.raises(ValueError):
        tft.mma_scan_layout(1024, 12, 4096, 128, True, -1, 132)


@pytest.mark.parametrize("seg_rows", [1024, 4096])
@pytest.mark.parametrize("sm_count", [78, 132])
def test_mma_layout_grid_has_no_y_limit(sm_count, seg_rows):
    """2^30 rows in one scan: the grid is 1-D, so the block count only has
    to stay below 2^31 (grid.y would stop at 65,535); the run scales with
    the device's SM count."""
    n_segs = (1 << 30) // seg_rows
    lay = tft.mma_scan_layout(1, n_segs, seg_rows, 128, False, 0, sm_count)
    assert lay["run"] == 8192 // seg_rows
    assert lay["blocks"] == n_segs // lay["run"] > 65_535
    assert lay["blocks"] < 2 ** 31 - 1
    big = tft.mma_scan_layout(1 << 20, n_segs, seg_rows, 128, False, 0,
                              sm_count)
    assert big["blocks"] == 8192 * n_segs // big["run"] < 2 ** 31 - 1
    small = tft.mma_scan_layout(1024, 548, seg_rows, 128, False, 0, sm_count)
    assert small["run"] == max(1, min(8192 // seg_rows,
                                      548 * 8 // (4 * sm_count)))
