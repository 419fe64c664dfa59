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


# ------------------------------ the packed LUT of the int8 kernels (B8-B10)


def _largest_m(b=9, k=16, t=2):
    """The largest M the int8 wrappers' layout accepts (shared memory
    decides it at small K; the 16-bit sums hold to M 256)."""
    def fits(m):
        try:
            tap.adc_layout(b, m, k, t)
            return True
        except ValueError:
            return False
    return max(m for m in range(4, tap.ADC_MAX_M + 1, 4) if fits(m))


@pytest.mark.parametrize("b", [1, 9, 64, 513])
@pytest.mark.parametrize("m,k", [(8, 256), (4, 16), (16, 64), ("largest", 16)])
def test_packed_lut_matches_jax_distances(m, k, b):
    """pack_lut + packed_lut_dists — the int8 kernels' arithmetic: 4
    queries' biased entries a word, even and odd bytes summed as 16-bit
    lanes, 128 M taken off — give the JAX package's ADC distances
    (erlvectordb_tpu/ops/adc.py, every row ranked) for an integer LUT, at
    M 8 and at the largest M the wrappers accept, for each subspace
    phase count the layout may pick."""
    if m == "largest":
        m = _largest_m(k=k)
    rng = np.random.default_rng(m * 1000 + k + b)
    n = 700
    books = rng.integers(-5, 6, (m, k, 1)).astype(np.float32)
    q = rng.integers(-5, 6, (b, m)).astype(np.float32)
    codes = rng.integers(0, k, (n, m)).astype(np.uint8)
    codes[10:30] = codes[9]
    d_sorted, rows = jadc.adc_search_exact_topk(
        jnp.asarray(codes), jnp.asarray(books), jnp.asarray(q), k=n)
    want = np.empty((b, n), np.float32)
    np.put_along_axis(want, np.asarray(rows), np.asarray(d_sorted), axis=1)
    lut = ((q[:, :, None] - books[None, :, :, 0]) ** 2).astype(np.int8)
    lut = torch.from_numpy(lut.reshape(b, m * k))
    for s in (2, 4, 8):
        if m % s:
            continue
        packed = tap.pack_lut(lut, m, s)
        assert packed.shape == (-(-b // (128 // s)), m // s, k, 32)
        got = tap.packed_lut_dists(torch.from_numpy(codes), packed, m, s, b)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("m", [8, 256])
def test_packed_lut_signed_entries_at_the_16_bit_limit(m):
    """Signed LUT entries (-128..127, biased to 0..255) at M 8 and at M 256,
    where a lane's biased sum reaches 255 * 256 = 65,280 < 65,536: the
    packed arithmetic gives the plain version's int32 distances exactly,
    and the layout refuses M past 256."""
    rng = np.random.default_rng(m)
    k, b = 16, 37
    codes = torch.from_numpy(rng.integers(0, k, (500, m)).astype(np.uint8))
    lut = torch.from_numpy(rng.integers(-128, 128, (b, m * k)).astype(np.int8))
    lut[0] = 127                  # every lookup of query 0 at the top
    lut[1] = -128
    want = tap._lut_dists(codes, lut)
    for s in (2, 4, 8):
        got = tap.packed_lut_dists(codes, tap.pack_lut(lut, m, s), m, s, b)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(want[0, 0]) == 127 * m
    with pytest.raises(ValueError):
        tap.adc_layout(b, tap.ADC_MAX_M + 4, 1, 2)


@pytest.mark.parametrize("t", [1, 2, 4, 8, 32])
def test_adc_layout_fits_and_covers(t):
    """The int8 kernels' launch over B 1-1024 and the shapes the wrappers
    take: shared memory within the 232,448 B a block may use (mirroring the
    kernel's carve-up), the subspace phases dividing M, the query groups
    covering the batch, small batches on narrow groups."""
    for m, k in ((4, 16), (8, 256), (16, 256), (32, 64), (_largest_m(), 16)):
        for b in (1, 2, 9, 16, 17, 32, 33, 64, 65, 512, 513, 1024):
            try:
                lay = tap.adc_layout(b, m, k, t)
            except ValueError:
                assert m > 8 and all(
                    tap.adc_packed_smem(m, k, s, tap.adc_t_max(t))
                    > tap.ADC_SMEM_MAX for s in (2, 4, 8) if m % s == 0)
                continue
            s = lay["s"]
            assert m % s == 0
            assert lay["qg"] == 4 * lay["g"] == 128 // s
            assert lay["groups"] * lay["qg"] >= b > (lay["groups"] - 1) * lay["qg"]
            assert lay["tmax"] >= t and lay["smem"] <= tap.ADC_SMEM_MAX
            assert lay["threads"] == (256 if lay["tmax"] > 8 else 512)
            assert lay["smem"] == (lay["qg"] * m * k + 2 * 1024 * m
                                   + 4 * (lay["threads"] // 32)
                                   * (lay["qg"] * (lay["tmax"] + 1) + 1)
                                   + 4 * lay["qg"] * lay["tmax"]
                                   + 4 * lay["qg"])
            def fits(x):
                return m % x == 0 and tap.adc_packed_smem(
                    m, k, x, lay["tmax"]) <= tap.ADC_SMEM_MAX
            if b <= 16 and fits(8):
                assert s == 8
            if b > 32 and fits(2):
                assert s == 2


# ------------------------------------ the packed bf16 LUT of B10-bf16


def _bf16_bits(x):
    """Round-to-nearest-even f32 -> bf16 bits, in numpy (finite values)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint32)


def _bf16_lut(rng, b, m, k):
    """An f32 LUT whose entries are not bf16-exact, with a run of repeated
    values (equal distances from distinct codes) and some -0."""
    lut = (rng.standard_normal((b, m * k)) ** 2).astype(np.float32)
    lut[:, ::7] = 0.5
    lut[:, 5::11] = -0.0
    return lut


_PACK_CASES = [(s, m) for s in (2, 4, 8) for m in (4, 8, 12, 16) if m % s == 0]


@pytest.mark.parametrize("k", [1, 64, 256])
@pytest.mark.parametrize("s,m", _PACK_CASES)
def test_pack_lut_bf16_words(s, m, k):
    """pack_lut_bf16 read back word by word: word (p, c, i*h + j) of group
    gr holds the bf16-rounded entries of queries 2j and 2j + 1 of the group
    (low, high half) for subspace p*s + i and code c, zeros past B and -0
    stored as +0; for h = 32 / s and for a narrower group (h = 1)."""
    b = 37
    lut = _bf16_lut(np.random.default_rng(s * 100 + m + k), b, m, k)
    bits = _bf16_bits(lut)
    bits[bits == 0x8000] = 0
    for h in (32 // s, 1):
        got = tap.pack_lut_bf16(torch.from_numpy(lut), m, s, h).numpy()
        groups = -(-b // (2 * h))
        assert got.shape == (groups, m // s, k, s * h) and got.dtype == np.int32
        gr, p, c, w = np.indices(got.shape)
        i, j = w // h, w % h
        col = (p * s + i) * k + c

        def entry(q):
            return np.where(q < b, bits[np.minimum(q, b - 1), col], 0)

        q0 = gr * 2 * h + 2 * j
        words = got.view(np.uint32)
        np.testing.assert_array_equal(words & 0xFFFF, entry(q0))
        np.testing.assert_array_equal(words >> 16, entry(q0 + 1))


def _lane_model(codes, packed, m, s, h, b):
    """B10-bf16's arithmetic in numpy, lane by lane: lane (phase i, pair j)
    adds word p of each row into chain p % (S0/s) of its two queries (a
    chain starts at its first term, as the kernel's does), runs
    the in-register levels of the halving tree (strides S0/2 .. s), and the
    s lanes of a pair reduce-scatter (strides s/2 .. 1): slot u of lane i
    holds row u ^ i of each run of s rows, and at stride d a lane keeps its
    slots u < d, adding its partner's (lane i ^ d) slot d + u.  Returns the
    f32 distances [b, R]."""
    s0 = tap.bf16_chains(m)
    nc, n_p = s0 // s, m // s
    words = packed.numpy().view(np.uint32)
    r = codes.shape[0]
    run = codes.reshape(r // s, s, m)           # runs of s rows
    out = np.empty((words.shape[0] * 2 * h, r), np.float32)
    for gr in range(words.shape[0]):
        for j in range(h):
            # slots[i][u]: lane i's partial (class i) of row u ^ i, [2, runs]
            slots = []
            for i in range(s):
                lane = []
                for u in range(s):
                    ch = np.empty((nc, 2, r // s), np.float32)
                    for p in range(n_p):
                        w = words[gr, p, run[:, u ^ i, p * s + i], i * h + j]
                        v = np.stack([(w << 16).view(np.float32),
                                      (w & 0xFFFF0000).view(np.float32)])
                        ch[p % nc] = v if p < nc else ch[p % nc] + v
                    d = nc // 2
                    while d:
                        ch[:d] = ch[:d] + ch[d:2 * d]
                        d //= 2
                    lane.append(ch[0])
                slots.append(lane)
            d = s // 2
            while d:
                slots = [[slots[i][u] + slots[i ^ d][d + u] if u < d
                          else slots[i][u] for u in range(s)]
                         for i in range(s)]
                d //= 2
            q = gr * 2 * h + 2 * j
            for i in range(s):                  # lane i: row i of each run
                out[q:q + 2, i::s] = slots[i][0]
    return out[:b]


_MODEL_CASES = [(m, s) for m in (4, 8, 12, 16, 20, 24, 36) for s in (2, 4, 8)
                if tap.bf16_chains(m) % s == 0]


@pytest.mark.parametrize("narrow", [False, True], ids=["h_full", "h_1"])
@pytest.mark.parametrize("m,s", _MODEL_CASES)
def test_bf16_lane_model_matches_plain_bit_for_bit(m, s, narrow):
    """The kernel's lane decomposition (chains, in-lane levels, xor levels)
    on pack_lut_bf16's words gives canonical_lut_dists' sums bit for bit,
    for every subspace phase count S dividing S0 (the layout's choices) and
    for narrow groups; and those lie within bf16_sum_bound of the plain
    version's sums in subspace order."""
    rng = np.random.default_rng(m * 10 + s)
    k, b = 16, 5
    codes = rng.integers(0, k, (1000, m)).astype(np.uint8)
    lut = _bf16_lut(rng, b, m, k)
    lut[:, 3] = -lut[:, 3]                      # mixed signs, and -0
    h = 1 if narrow else 32 // s
    packed = tap.pack_lut_bf16(torch.from_numpy(lut), m, s, h)
    want = tap.canonical_lut_dists(torch.from_numpy(codes),
                                   torch.from_numpy(lut))
    got = _lane_model(codes, packed, m, s, h, b)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  want.numpy().view(np.uint32))
    plain = tap._lut_dists(torch.from_numpy(codes), torch.from_numpy(lut))
    bound = tap.bf16_sum_bound(torch.from_numpy(lut), m).numpy()[:, None]
    assert (np.abs(got.astype(np.float64) - plain.numpy()) <= bound).all()


@pytest.mark.parametrize("b", [1, 3, 20])
@pytest.mark.parametrize("t", [1, 4, 8])
@pytest.mark.parametrize("k", [64, 256])
@pytest.mark.parametrize("m", [4, 8, 12])
def test_b10_bf16_plain_matches_jax(m, k, t, b):
    """The port's plain B10-bf16 (canonical order of the f32 sum) against
    the JAX kernel in interpret mode on one tile of random codes: >= 99%
    equal picks, their values within rtol 1e-5 (the bar of
    test_b10_bf16_lut: the same bf16 entries summed in another order)."""
    rng = np.random.default_rng(m * 1000 + k * 10 + t + b)
    codes = rng.integers(0, k, (TILE, m)).astype(np.uint8)
    lut = (rng.standard_normal((b, m * k)) ** 2).astype(np.float32)
    vj, rj = jap.adc_pallas_scan(jnp.asarray(codes), jnp.asarray(lut),
                                 n_tiles=1, t_per_tile=t)
    vt, rt = tap.adc_pallas_scan(_t(codes), _t(lut), n_tiles=1, t_per_tile=t)
    same = rt.numpy() == np.asarray(rj)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(vt.numpy()[same], np.asarray(vj)[same],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t", [1, 2, 4, 8, 32])
def test_adc_bf16_layout_refuses_as_the_first_design(t):
    """adc_bf16_layout over M 4-240 and K 1-256: it refuses exactly the
    shapes the first design's wrapper refused (8 queries' bf16 LUTs and one
    code tile past 232,448 B), and every other gets a layout that fits,
    mirrors the kernel's carve-up, divides S0 and covers the batch; a
    layout holds whole 32 / s pairs wherever those fit."""
    for m in range(4, 244, 4):
        for k in (1, 2, 3, 15, 16, 64, 100, 128, 200, 255, 256):
            for b in (1, 9, 17, 512):
                refused = 16 * m * k + 1024 * m > tap.ADC_SMEM_MAX
                try:
                    lay = tap.adc_bf16_layout(b, m, k, t)
                except ValueError:
                    assert refused, (m, k, b)
                    continue
                assert not refused, (m, k, b)
                s, h = lay["s"], lay["h"]
                assert lay["s0"] == tap.bf16_chains(m) and lay["s0"] % s == 0
                assert lay["g"] == 32 // s and h & (h - 1) == 0 and h <= lay["g"]
                assert lay["qg"] == 2 * h
                assert lay["groups"] * lay["qg"] >= b > (lay["groups"] - 1) * lay["qg"]
                assert lay["tmax"] == tap.adc_t_max(t) and lay["nbuf"] in (1, 2)
                assert lay["threads"] == (256 if lay["tmax"] > 8 else 512)
                assert lay["smem"] == (4 * m * k * h + lay["nbuf"] * 1024 * m
                                       + 8 * (lay["threads"] // 32)
                                       * (2 * h * (lay["tmax"] + 1) + 1))
                assert lay["smem"] <= tap.ADC_SMEM_MAX
                full = [x for x in (2, 4, 8) if lay["s0"] % x == 0
                        and tap.adc_bf16_smem(m, k, x, 32 // x, 2,
                                              lay["tmax"]) <= tap.ADC_SMEM_MAX]
                assert (h == lay["g"] and lay["nbuf"] == 2) == bool(full)
                if b > 16 and 2 in full:
                    assert s == 2
                if b <= 8 and 8 in full:
                    assert s == 8
    for bad in ((1, 6, 16, t), (1, 8, 0, t), (1, 8, 257, t), (0, 8, 16, t),
                (1, 8, 16, 0), (1, 8, 16, 33)):
        with pytest.raises(ValueError):
            tap.adc_bf16_layout(*bad)


def test_adc_bf16_layout_at_the_largest_shapes():
    """M % 8 != 0 at K 256 (S0 = 4): M 36 keeps double-buffered tiles with
    4 of 8 pairs a phase at work; M 44 (the largest the first design took)
    keeps 4 pairs on one tile buffer, or 2 on two beside T 32's lists; M
    220 at K 1 fills shared memory with its codes."""
    lay = tap.adc_bf16_layout(512, 36, 256, 4)
    assert (lay["s"], lay["h"], lay["nbuf"]) == (4, 4, 2) and lay["s0"] == 4
    lay = tap.adc_bf16_layout(512, 44, 256, 4)
    assert (lay["s"], lay["h"], lay["nbuf"]) == (4, 4, 1)
    lay = tap.adc_bf16_layout(512, 44, 256, 32)
    assert (lay["s"], lay["h"], lay["nbuf"]) == (4, 2, 2)
    lay = tap.adc_bf16_layout(3, 220, 1, 32)
    assert lay["nbuf"] == 1 and lay["smem"] <= tap.ADC_SMEM_MAX
    with pytest.raises(ValueError):
        tap.adc_bf16_layout(1, 48, 256, 4)


def _stage_model(lut, b, m, k, s, h, q0, nw):
    """csrc/adc_scan.cu::stage_bf16_lut's loop in numpy: every (warp, chunk,
    lane) it runs, the word it writes and the two f32 entries it reads.
    Returns (the words [M/s, K, s*h] as uint32, how often each was
    written)."""
    sh = s * h
    lw = min(sh, 4)
    cw = 32 // lw
    ncb, nlb = -(-k // cw), sh // lw
    n = (m // s) * ncb * nlb
    ch = np.concatenate([np.arange(w, n, nw) for w in range(nw)])[:, None]
    lane = np.arange(32)[None, :]
    lb, cb, p = ch % nlb, (ch // nlb) % ncb, ch // (nlb * ncb)
    l, c = lb * lw + lane % lw, cb * cw + lane // lw
    live = np.broadcast_to(c < k, (ch.shape[0], 32))
    q = q0 + 2 * (l % h)
    col = (p * s + l // h) * k + c
    bits = _bf16_bits(lut)
    bits[(bits & 0x7FFF) == 0] = 0

    def entry(qq):
        return np.where(qq < b, bits[np.minimum(qq, b - 1), np.minimum(col, m * k - 1)], 0)

    word = (entry(q) | (entry(q + 1) << 16)).astype(np.uint32)
    dst = (p * k + c) * sh + l
    out = np.zeros(m // s * k * sh, np.uint32)
    hits = np.zeros(m // s * k * sh, np.int64)
    out[dst[live]] = word[live]
    np.add.at(hits, dst[live], 1)
    return out.reshape(m // s, k, sh), hits


_STAGE_CASES = [(s, h) for s in (2, 4, 8) for h in (1, 2, 4, 8, 16)
                if h <= 32 // s]


@pytest.mark.parametrize("k", [1, 3, 64, 100, 256])
@pytest.mark.parametrize("s,h", _STAGE_CASES)
def test_stage_bf16_lut_writes_pack_lut_bf16s_words(s, h, k):
    """The kernel's in-block staging of the f32 LUT (chunks of 32 / LW
    codes x LW words a warp, 8 or 16 warps) writes every word of a query
    group exactly once, and the words are pack_lut_bf16's: the first group,
    a middle one, and the last one, partly past B."""
    m, b = 8, 4 * h + 1
    lut = _bf16_lut(np.random.default_rng(s * 1000 + h * 10 + k), b, m, k)
    lut[:, 2::9] *= -1
    want = tap.pack_lut_bf16(torch.from_numpy(lut), m, s, h).numpy()
    for nw in (8, 16):
        for gr in range(want.shape[0]):
            got, hits = _stage_model(lut, b, m, k, s, h, gr * 2 * h, nw)
            assert (hits == 1).all()
            np.testing.assert_array_equal(got, want[gr].view(np.uint32))


@pytest.mark.parametrize("t", [1, 4, 32])
@pytest.mark.parametrize("m,k", [(4, 256), (8, 16), (12, 64), (16, 256),
                                 (36, 16)])
def test_bf16_agreement_holds_the_kernel_order_to_plain(m, k, t):
    """adc_bf16_model (the kernel's order of the f32 sums) against the
    plain version (subspace order) on 2 tiles with duplicated code rows and
    repeated entries: every value within bf16_sum_bound, every pick the
    plain one or a near tie; and the orders really differ somewhere."""
    rng = np.random.default_rng(m * 100 + k + t)
    codes = rng.integers(0, k, (2 * TILE, m)).astype(np.uint8)
    codes[TILE // 2:TILE // 2 + 64] = codes[:64]
    lut = _bf16_lut(rng, 5, m, k)
    lut[:, 1::5] *= -1
    c, l = torch.from_numpy(codes), torch.from_numpy(lut)
    vals, rows = tap.adc_bf16_model(c, l, 2, t)
    agree = tap.bf16_agreement(vals, rows, c, l, 2, t)
    assert agree["bad_values"] == 0 and agree["bad_picks"] == 0, agree
    assert agree["max_err_over_bound"] <= 1
    diff = tap.canonical_lut_dists(c, l) != tap._lut_dists(c, l)
    assert bool(diff.any())


@pytest.mark.parametrize("fault", ["value", "far_row", "order", "repeat",
                                   "other_tile"])
def test_bf16_agreement_fails_a_wrong_result(fault):
    """bf16_agreement refuses a result a wrong kernel could give: a value
    moved past the bound, a pick swapped for the tile's farthest row, two
    picks out of order, a row picked twice, a row of another tile."""
    m, k, t = 8, 64, 4
    rng = np.random.default_rng(7)
    codes = torch.from_numpy(rng.integers(0, k, (2 * TILE, m)).astype(np.uint8))
    lut = torch.from_numpy(_bf16_lut(rng, 3, m, k))
    vals, rows = tap.adc_bf16_model(codes, lut, 2, t)
    vals, rows = vals.clone(), rows.clone()
    bound = tap.bf16_sum_bound(lut, m)
    if fault == "value":
        vals[1, 2] += 4 * float(bound[1])
    elif fault == "far_row":
        d = tap._lut_dists(codes[:TILE], lut)[0]
        rows[0, 1] = int(torch.argmax(d))
    elif fault == "order":
        rows[2, [0, t - 1]] = rows[2, [t - 1, 0]]
    elif fault == "repeat":
        rows[0, t + 1] = rows[0, t]
    else:
        rows[1, 0] = rows[1, t]
    agree = tap.bf16_agreement(vals, rows, codes, lut, 2, t)
    assert agree["bad_values"] + agree["bad_picks"] > 0, agree
