"""The port's ADC search (ops/adc.py) and the plain versions of its ADC
kernels B8-B10 (ops/adc_pallas.py) against the JAX package's, on the CPU.

The JAX kernels run in Pallas interpret mode, as tests/test_adc_pallas.py
runs them; the fixtures are that file's, re-pointed.  Given the same int8
LUT (made by the JAX package, carried as numpy) the integer distances are
exact, so the per-tile / per-slice picks and their rows are bit-identical,
and the exactly reranked values agree to float tolerance (the port sums
q . x in another order).  From queries, each package makes its own LUT (an
f32 product whose sums may land one level apart at a .5 boundary), so the
function-level answers are held by overlap@k >= 0.99.  Ties and padding rows
follow the JAX kernels: B8 keeps the higher row among equal distances, B9
and B10 the lower, and a padding row competes in its slice until the final
``rows < n_valid`` mask.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import jax
from erlvectordb_tpu.ops import adc as jadc
from erlvectordb_tpu.ops import adc_pallas as jap
from erlvectordb_tpu.quant.pq import PQCodebook as JaxPQ
from erlvectordb_tpu.quant.pq import _adc_l2_tables as jax_l2_tables
from erlvectordb_tpu_torch.ops import adc as tadc
from erlvectordb_tpu_torch.ops import adc_pallas as tap

torch.set_num_threads(2)
TILE = jap.ADC_TILE_N


def _t(a):
    return torch.from_numpy(np.array(a))


def _i8_rows(data):
    absmax = np.abs(data).max(axis=1)
    scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    i8 = np.clip(np.round(data / scales[:, None]), -127, 127).astype(np.int8)
    norms2 = (scales.astype(np.float64) ** 2
              * (i8.astype(np.float64) ** 2).sum(axis=1)).astype(np.float32)
    return i8, scales, norms2


def _corpus(seed, n, nq, d=64):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n + nq, 8)).astype(np.float32)
    proj = rng.standard_normal((8, d)).astype(np.float32) / np.sqrt(8)
    pts = (z @ proj + 0.05 * rng.standard_normal((n + nq, d))).astype(np.float32)
    return pts[:n], pts[n:]


@pytest.fixture(scope="module")
def pq_setup():
    """tests/test_adc_pallas.py's corpus: 2 tiles, M=8, K=64, 24 queries."""
    data, queries = _corpus(0, 2 * TILE, 24)
    cb = JaxPQ.fit(data, m=8, k=64, iters=10)
    codes = np.asarray(cb.encode(data))
    return data, np.asarray(cb.codebooks), codes, _i8_rows(data), queries


@pytest.fixture(scope="module")
def pos_setup():
    """test_exact_pos_matches_reference's corpus, ragged: 8192 + 900 rows
    padded to two 8192-row big tiles, so the last slices hold padding."""
    n = 8192 + 900
    data, queries = _corpus(5, n, 16)
    cb = JaxPQ.fit(data, m=8, k=64, iters=8)
    codes = np.asarray(cb.encode(data))
    pad = (-n) % (8 * TILE)
    i8, scales, norms2 = _i8_rows(data)
    return dict(data=data, queries=queries, books=np.asarray(cb.codebooks),
                n=n, codes=np.pad(codes, ((0, pad), (0, 0))),
                i8=np.pad(i8, ((0, pad), (0, 0))),
                scales=np.pad(scales, (0, pad), constant_values=1.0),
                norms2=np.pad(norms2, (0, pad)))


def _jax_lut_q(queries, books, shift):
    """The JAX package's int8 LUT (its glue's expressions, under jit)."""
    @jax.jit
    def f(q, cb):
        lut3 = jax_l2_tables(q, cb)
        if shift:
            lut3 = lut3 - jnp.min(lut3, axis=2, keepdims=True)
        lut = lut3.reshape(q.shape[0], -1)
        row_max = jnp.max(lut, axis=1, keepdims=True)
        return jnp.clip(jnp.round(lut / jnp.maximum(row_max, 1e-20) * 127.0),
                        0, 127).astype(jnp.int8)
    return np.asarray(f(jnp.asarray(queries), jnp.asarray(books)))


def _jax_raw(kernel, grid, rows_blk, out_cols, codes, lut_q, q, i8, scales,
             norms2):
    """A JAX rerank kernel's raw [B, picks] outputs, interpret mode, one
    query tile (B a multiple of 8)."""
    b, d = q.shape
    m = codes.shape[1]
    n_out = grid[1]
    iaux = jnp.stack([jnp.asarray(scales), jnp.asarray(norms2)], axis=0)
    vals, rows = pl.pallas_call(
        kernel, grid=grid,
        in_specs=[pl.BlockSpec((rows_blk, m), lambda i, j: (j, 0)),
                  pl.BlockSpec((b, lut_q.shape[1]), lambda i, j: (i, 0)),
                  pl.BlockSpec((b, d), lambda i, j: (i, 0)),
                  pl.BlockSpec((rows_blk, d), lambda i, j: (j, 0)),
                  pl.BlockSpec((2, rows_blk), lambda i, j: (0, j))],
        out_specs=[pl.BlockSpec((1, b, out_cols), lambda i, j: (j, i, 0))] * 2,
        out_shape=[jax.ShapeDtypeStruct((n_out, b, out_cols), jnp.float32),
                   jax.ShapeDtypeStruct((n_out, b, out_cols), jnp.int32)],
        interpret=True,
    )(jnp.asarray(codes), jnp.asarray(lut_q), jnp.asarray(q),
      jnp.asarray(i8), iaux)
    return (np.asarray(vals).transpose(1, 0, 2).reshape(b, -1),
            np.asarray(rows).transpose(1, 0, 2).reshape(b, -1))


def _overlap(a, b, k):
    return np.mean([len(set(x[:k]) & set(y[:k])) / k for x, y in zip(a, b)])


# ------------------------------------------------------------- ops/adc.py


def test_gather_adc_matches_jax(pq_setup):
    """adc_search / adc_search_exact_topk / adc_search_rerank from the same
    codebooks: the same rows (exact top-k, the same subspace-order sums of
    near-equal LUTs), distances to float tolerance."""
    data, books, codes, (i8, scales, _), queries = pq_setup
    jb, q = jnp.asarray(books), jnp.asarray(queries)
    for jf, tf in ((jadc.adc_search, tadc.adc_search),
                   (jadc.adc_search_exact_topk, tadc.adc_search_exact_topk)):
        dj, rj = jf(jnp.asarray(codes), jb, q, k=10)
        dt, rt = tf(_t(codes), _t(books), _t(queries), k=10)
        assert _overlap(np.asarray(rj), rt.numpy(), 10) >= 0.99
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4,
                                   atol=1e-4)
    dj, rj = jadc.adc_search_rerank(jnp.asarray(codes), jb, jnp.asarray(i8),
                                    jnp.asarray(scales), q, k=10, c=64)
    dt, rt = tadc.adc_search_rerank(_t(codes), _t(books), _t(i8), _t(scales),
                                    _t(queries), k=10, c=64)
    assert _overlap(np.asarray(rj), rt.numpy(), 10) >= 0.99
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------------------------ B10


def test_b10_int8_lut_bit_identical(pq_setup):
    _, books, codes, _, queries = pq_setup
    lut_q = _jax_lut_q(queries, books, shift=False)
    nt = jap.adc_n_tiles(codes.shape[0])
    for t in (4, 8):
        vj, rj = jap.adc_pallas_scan(jnp.asarray(codes), jnp.asarray(lut_q),
                                     n_tiles=nt, t_per_tile=t)
        vt, rt = tap.adc_pallas_scan(_t(codes), _t(lut_q), n_tiles=nt,
                                     t_per_tile=t)
        assert vt.dtype == torch.float32 and rt.dtype == torch.int32
        np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_b10_bf16_lut(pq_setup):
    """The f32 LUT rounded to bf16, the 8 values summed in f32: the same
    picks, values to the rounding of a different order of 8 sums."""
    _, books, codes, _, queries = pq_setup
    lut = np.asarray(jax_l2_tables(jnp.asarray(queries), jnp.asarray(books)))
    lut = lut.reshape(len(queries), -1)
    nt = jap.adc_n_tiles(codes.shape[0])
    vj, rj = jap.adc_pallas_scan(jnp.asarray(codes), jnp.asarray(lut),
                                 n_tiles=nt, t_per_tile=4)
    vt, rt = tap.adc_pallas_scan(_t(codes), _t(lut), n_tiles=nt, t_per_tile=4)
    assert (rt.numpy() == np.asarray(rj)).mean() >= 0.99
    same = rt.numpy() == np.asarray(rj)
    np.testing.assert_allclose(vt.numpy()[same], np.asarray(vj)[same],
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- B9, B8


def test_b9_picks_bit_identical(pq_setup):
    _, books, codes, (i8, scales, norms2), queries = pq_setup
    q = queries[:16]
    lut_q = _jax_lut_q(q, books, shift=True)
    nt = jap.adc_n_tiles(codes.shape[0])
    t = tap.exact_t(nt)
    assert t == 8
    vj, rj = _jax_raw(jap._make_adc_exact_kernel(8, 64, t, TILE), (1, nt),
                      TILE, t, codes, lut_q, q, i8, scales, norms2)
    vt, rt = tap.adc_exact_scan(_t(codes), _t(lut_q), _t(q), _t(i8),
                                _t(scales), _t(norms2), nt, t)
    np.testing.assert_array_equal(rt.numpy(), rj)
    np.testing.assert_allclose(vt.numpy(), vj, rtol=1e-5, atol=1e-4)


def test_b8_picks_bit_identical_with_padding(pos_setup):
    """Both 8-slice big tiles: the last slices hold padding rows (code 0,
    int8 zeros), which compete inside their slice as in the JAX kernel."""
    s = pos_setup
    q = s["queries"]
    lut_q = _jax_lut_q(q, s["books"], shift=True)
    n_big = s["codes"].shape[0] // (8 * TILE)
    vj, rj = _jax_raw(jap._make_adc_pos_kernel(8, 64, 8, TILE), (1, n_big),
                      8 * TILE, 16, s["codes"], lut_q, q, s["i8"],
                      s["scales"], s["norms2"])
    vt, rt = tap.adc_pos_scan(_t(s["codes"]), _t(lut_q), _t(q), _t(s["i8"]),
                              _t(s["scales"]), _t(s["norms2"]), n_big * 8)
    np.testing.assert_array_equal(rt.numpy(), rj)
    np.testing.assert_allclose(vt.numpy(), vj, rtol=1e-5, atol=1e-4)
    assert (rj >= s["n"]).any()   # padding rows did win slots


@pytest.mark.parametrize("kind", ["b8", "b9", "b10"])
def test_tie_rules(kind):
    """One tile of identical codes: every row ties.  B8 keeps the higher
    lanes (1023, 1022), B9/B10 the lower (0, 1, ...), as the JAX kernels."""
    rng = np.random.default_rng(3)
    codes = np.tile(rng.integers(0, 16, (1, 8)), (8 * TILE, 1)).astype(np.uint8)
    codes[TILE:] = rng.integers(0, 16, (7 * TILE, 8))
    lut_q = rng.integers(0, 128, (8, 8 * 16)).astype(np.int8)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    i8, scales, norms2 = _i8_rows(rng.standard_normal((8 * TILE, 16))
                                  .astype(np.float32))
    args = (codes, lut_q, q, i8, scales, norms2)
    if kind == "b8":
        vj, rj = _jax_raw(jap._make_adc_pos_kernel(8, 16, 8, TILE), (1, 1),
                          8 * TILE, 16, *args)
        vt, rt = tap.adc_pos_scan(*map(_t, args), 8)
        assert (rt.numpy()[:, :2] == [TILE - 1, TILE - 2]).all()
    elif kind == "b9":
        vj, rj = _jax_raw(jap._make_adc_exact_kernel(8, 16, 4, TILE), (1, 8),
                          TILE, 4, *args)
        vt, rt = tap.adc_exact_scan(*map(_t, args), 8, 4)
        assert (rt.numpy()[:, :4] == [0, 1, 2, 3]).all()
    else:
        vj, rj = jap.adc_pallas_scan(jnp.asarray(codes), jnp.asarray(lut_q),
                                     n_tiles=8, t_per_tile=4)
        vt, rt = tap.adc_pallas_scan(_t(codes), _t(lut_q), n_tiles=8,
                                     t_per_tile=4)
        assert (rt.numpy()[:, :4] == [0, 1, 2, 3]).all()
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-4)


# ------------------------------------------------------ the searches


def _patch_lut(monkeypatch, queries, books):
    """Hand the port's glue the JAX package's f32 LUT (so both quantize the
    same table)."""
    lut = np.asarray(jax_l2_tables(jnp.asarray(queries), jnp.asarray(books)))
    monkeypatch.setattr(tap, "_adc_l2_tables", lambda q, cb: _t(lut))


def test_exact_fused_matches_jax(pq_setup, monkeypatch):
    _, books, codes, (i8, scales, norms2), queries = pq_setup
    n, nt = codes.shape[0], jap.adc_n_tiles(codes.shape[0])
    args_j = (jnp.asarray(codes), jnp.asarray(books), jnp.asarray(i8),
              jnp.asarray(scales), jnp.asarray(norms2), jnp.asarray(queries))
    args_t = tuple(map(_t, (codes, books, i8, scales, norms2, queries)))
    dj, rj = jap.adc_search_exact_fused(*args_j, n, k=10, n_tiles=nt)
    dt, rt = tap.adc_search_exact_fused(*args_t, n, k=10, n_tiles=nt)
    assert _overlap(np.asarray(rj), rt.numpy(), 10) >= 0.99
    _patch_lut(monkeypatch, queries, books)
    dt, rt = tap.adc_search_exact_fused(*args_t, n, k=10, n_tiles=nt)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)


def test_exact_pos_matches_jax(pos_setup, monkeypatch):
    """The ragged corpus: n_valid masks the padding rows' candidates before
    the merge; no padding row is returned."""
    s = pos_setup
    nt = jap.adc_n_tiles(s["n"])
    names = ("codes", "books", "i8", "scales", "norms2", "queries")
    dj, rj = jap.adc_search_exact_pos(*(jnp.asarray(s[k]) for k in names),
                                      s["n"], k=10, n_tiles=nt)
    dt, rt = tap.adc_search_exact_pos(*(_t(s[k]) for k in names), s["n"],
                                      k=10, n_tiles=nt)
    assert _overlap(np.asarray(rj), rt.numpy(), 10) >= 0.99
    _patch_lut(monkeypatch, s["queries"], s["books"])
    dt, rt = tap.adc_search_exact_pos(*(_t(s[k]) for k in names), s["n"],
                                      k=10, n_tiles=nt)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)
    assert (rt.numpy() < s["n"]).all()
    with pytest.raises(ValueError, match="padded"):
        tap.adc_search_exact_pos(*(_t(s[k][:9000]) if k == "codes" else
                                   _t(s[k]) for k in names), s["n"], k=10,
                                 n_tiles=nt)


def test_fused_matches_jax(pq_setup, monkeypatch):
    """adc_search_fused: B10 over the int8 LUT, a pool of c, the XLA rerank;
    odd batches need no padding."""
    _, books, codes, (i8, scales, _), queries = pq_setup
    n, nt = codes.shape[0], jap.adc_n_tiles(codes.shape[0])
    args_j = (jnp.asarray(codes), jnp.asarray(books), jnp.asarray(i8),
              jnp.asarray(scales), jnp.asarray(queries))
    args_t = tuple(map(_t, (codes, books, i8, scales, queries)))
    dj, rj = jap.adc_search_fused(*args_j, n, k=5, c=64, n_tiles=nt)
    dt, rt = tap.adc_search_fused(*args_t, n, k=5, c=64, n_tiles=nt)
    assert _overlap(np.asarray(rj), rt.numpy(), 5) >= 0.99
    d3, r3 = tap.adc_search_fused(*args_t[:4], args_t[4][:3], n, k=5, c=64,
                                  n_tiles=nt)
    assert d3.shape == (3, 5)
    np.testing.assert_array_equal(r3.numpy(), rt.numpy()[:3])
    _patch_lut(monkeypatch, queries, books)
    dt, rt = tap.adc_search_fused(*args_t, n, k=5, c=64, n_tiles=nt)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)


def test_recall_vs_exact(pos_setup):
    """The port's three searches from queries against exact f32 ground
    truth, at the JAX tests' bars."""
    s = pos_setup
    n = s["n"]
    data, q = s["data"], s["queries"]
    d2 = ((q[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1)[:, :2]
    nt = jap.adc_n_tiles(n)
    names = ("codes", "books", "i8", "scales", "norms2", "queries")
    _, rows = tap.adc_search_exact_pos(*(_t(s[k]) for k in names), n, k=2,
                                       n_tiles=nt)
    assert _overlap(gt, rows.numpy(), 2) >= 0.5
    _, rows = tap.adc_search_exact_fused(*(_t(s[k]) for k in names), n, k=2,
                                         n_tiles=nt)
    assert _overlap(gt, rows.numpy(), 2) >= 0.8
    _, rows = tap.adc_search_fused(*(_t(s[k]) for k in names[:4]),
                                   _t(s["queries"]), n, k=2, c=256,
                                   n_tiles=nt)
    assert _overlap(gt, rows.numpy(), 2) >= 0.8


def test_kernel_wrappers_refuse_bad_cuda_input():
    """A CUDA tensor launches the kernel or raises; the checks run before
    any launch (here: a CPU LUT beside a meta-device code table)."""
    codes = torch.empty((TILE, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        tap.adc_pallas_scan(codes, torch.zeros((1, 64), dtype=torch.int8),
                            n_tiles=1)
