"""The port's product quantizers against the JAX package's, on the CPU.

Subspace k-means, PQ encode/decode/tables and the OPQ alternation of
erlvectordb_tpu_torch (ops/kmeans.py, quant/pq.py, quant/opq.py) are held
to erlvectordb_tpu on the same numpy-seeded inputs:

  * what is deterministic given its inputs (refine from shared codebooks,
    encode/decode/tables of shared codebooks, the OPQ alternation from
    shared first-round codebooks) agrees to float tolerance, codes on
    >= 99.9% of rows (a near-tie may flip where the two sum the subspace
    products in another order);
  * a fit from a seed draws other random numbers than JAX does, so it is
    held by reconstruction MSE within 5% of JAX's at the same size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erlvectordb_tpu.ops import kmeans as jkm
from erlvectordb_tpu.quant import pq as jpq
from erlvectordb_tpu.quant.opq import OPQCodebook as JaxOPQ
from erlvectordb_tpu.quant.pq import PQCodebook as JaxPQ
from erlvectordb_tpu_torch.ops import kmeans as tkm
from erlvectordb_tpu_torch.quant import OPQCodebook, PQCodebook
from erlvectordb_tpu_torch.quant import pq as tpq

CPU = torch.device("cpu")
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data():
    """Anisotropic clustered rows (the variance OPQ's rotation balances)."""
    rng = np.random.default_rng(7)
    n, d = 3000, 32
    centers = rng.standard_normal((40, d)).astype(np.float32)
    x = centers[rng.integers(0, 40, n)] + 0.3 * rng.standard_normal((n, d))
    x = x * np.linspace(3.0, 0.2, d)[None, :]
    q = rng.standard_normal((24, d)).astype(np.float32) * np.linspace(
        3.0, 0.2, d)[None, :]
    return x.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope="module")
def shared_books(data):
    """JAX-trained codebooks, the shared input of the deterministic cases."""
    x, _ = data
    return np.asarray(JaxPQ.fit(x, m=8, k=32, iters=8).codebooks)


def _t(a):
    return torch.from_numpy(np.array(a))


def _mse(x, recon):
    return float(np.mean((np.asarray(recon) - x) ** 2))


def test_refine_subspaces_matches_jax(data, shared_books):
    """Lloyd steps from the same codebooks: the same centroids (means of the
    same members; sums in another order, atol 1e-4)."""
    x, _ = data
    want = np.asarray(jkm.kmeans_refine_subspaces(
        jnp.asarray(x), jnp.asarray(shared_books), m=8, k=32, iters=5))
    got = tkm.kmeans_refine_subspaces(_t(x), _t(shared_books), m=8, k=32,
                                      iters=5).numpy()
    assert got.shape == want.shape == (8, 32, 4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_fit_subspaces_mse_within_5pct(data):
    """From a seed: other draws than JAX, the same quality (reconstruction
    MSE of the trained codebooks within 5% of JAX's)."""
    x, _ = data
    jcb = np.asarray(jkm.kmeans_fit_subspaces(jnp.asarray(x), jnp.uint32(3),
                                              m=8, k=32, iters=12))
    tcb = tkm.kmeans_fit_subspaces(_t(x), 3, m=8, k=32, iters=12)
    assert tcb.shape == (8, 32, 4)
    mse_j = _mse(x, jpq._decode(jpq._encode(jnp.asarray(x), jnp.asarray(jcb)),
                                jnp.asarray(jcb)))
    mse_t = _mse(x, tpq._decode(tpq._encode(_t(x), tcb), tcb).numpy())
    assert mse_t <= 1.05 * mse_j, (mse_t, mse_j)


def test_encode_decode_tables_match_jax(data, shared_books):
    x, q = data
    jcb, tcb = JaxPQ(jnp.asarray(shared_books)), PQCodebook(shared_books,
                                                             device=CPU)
    jc, tc = np.asarray(jcb.encode(x)), tcb.encode(x).numpy()
    assert tc.dtype == np.uint8 and tc.shape == (3000, 8)
    assert (tc == jc).all(axis=1).mean() >= 0.999
    np.testing.assert_array_equal(tcb.decode(jc).numpy(),
                                  np.asarray(jcb.decode(jc)))
    for metric in ("euclidean", "dot"):
        np.testing.assert_allclose(tcb.adc_tables(q, metric).numpy(),
                                   np.asarray(jcb.adc_tables(q, metric)),
                                   rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError):
        tcb.adc_tables(q, "manhattan")


def test_pq_fit_refine_and_arrays(data, shared_books):
    """fit(init_codebooks=) is the refine; the training subsample is numpy's
    (the same rows as JAX's); to_arrays/from_arrays carry codebooks across
    the two packages."""
    x, _ = data
    want = np.asarray(JaxPQ.fit(x, m=8, k=32, iters=3, max_train=2000,
                                seed=5, init_codebooks=shared_books).codebooks)
    got = PQCodebook.fit(x, m=8, k=32, iters=3, max_train=2000, seed=5,
                         init_codebooks=shared_books, device=CPU)
    np.testing.assert_allclose(got.codebooks.numpy(), want, rtol=1e-4,
                               atol=1e-4)
    assert (got.m, got.k, got.dim) == (8, 32, 32)
    back = PQCodebook.from_arrays(JaxPQ(jnp.asarray(want)).to_arrays(),
                                  device=CPU)
    np.testing.assert_array_equal(back.codebooks.numpy(), want)
    again = JaxPQ.from_arrays(back.to_arrays())
    np.testing.assert_array_equal(np.asarray(again.codebooks), want)
    with pytest.raises(ValueError):
        PQCodebook.fit(x[:, :30], m=8, device=CPU)
    with pytest.raises(ValueError):
        PQCodebook.fit(x, k=300, device=CPU)


def test_pq_fit_from_seed_mse_within_5pct(data):
    x, _ = data
    mse_j = _mse(x, JaxPQ.fit(x, m=8, k=32, iters=10).decode(
        JaxPQ.fit(x, m=8, k=32, iters=10).encode(x)))
    cb = PQCodebook.fit(x, m=8, k=32, iters=10, device=CPU)
    mse_t = _mse(x, cb.decode(cb.encode(x)).numpy())
    assert mse_t <= 1.05 * mse_j, (mse_t, mse_j)


def test_opq_alternation_matches_jax_from_shared_first_round(data,
                                                             monkeypatch):
    """The port's first-round subspace fit returns JAX's codebooks; every
    later step (refines, Procrustes SVDs) is deterministic, so the rotation
    agrees to float tolerance and the codes on >= 99.9% of rows."""
    x, q = data
    first = np.asarray(jkm.kmeans_fit_subspaces(
        jnp.asarray(x), jnp.uint32(0), m=8, k=32, iters=6))
    monkeypatch.setattr(tpq, "kmeans_fit_subspaces",
                        lambda x_, seed, m, k, iters: _t(first))
    kw = dict(m=8, k=32, iters=6, opq_iters=3, refine_iters=3)
    jo = JaxOPQ.fit(x, **kw)
    to = OPQCodebook.fit(x, device=CPU, **kw)
    np.testing.assert_allclose(to.rotation.numpy(), np.asarray(jo.rotation),
                               atol=2e-4)
    np.testing.assert_allclose(to.codebooks.numpy(), np.asarray(jo.codebooks),
                               rtol=1e-3, atol=1e-3)
    r = to.rotation.numpy().astype(np.float64)
    np.testing.assert_allclose(r @ r.T, np.eye(32), atol=1e-5)
    jc, tc = np.asarray(jo.encode(x)), to.encode(x).numpy()
    assert (tc == jc).all(axis=1).mean() >= 0.999
    np.testing.assert_allclose(to.reconstruction_mse(x),
                               jo.reconstruction_mse(x), rtol=1e-3)
    np.testing.assert_allclose(to.adc_tables(q).numpy(),
                               np.asarray(jo.adc_tables(q)), rtol=1e-3,
                               atol=1e-3)
    back = OPQCodebook.from_arrays(jo.to_arrays(), device=CPU)
    np.testing.assert_array_equal(back.encode(x).numpy().shape, (3000, 8))
    np.testing.assert_array_equal(back.rotation.numpy(),
                                  np.asarray(jo.rotation))


def test_opq_fit_from_seed_beats_pq(data):
    """On anisotropic data the learned rotation lowers the reconstruction
    error below plain PQ's, as in the JAX package (same subsample rows)."""
    x, _ = data
    pq = PQCodebook.fit(x, m=8, k=32, iters=10, device=CPU)
    opq = OPQCodebook.fit(x, m=8, k=32, iters=10, opq_iters=3, device=CPU)
    mse_pq = _mse(x, pq.decode(pq.encode(x)).numpy())
    assert opq.reconstruction_mse(x) < mse_pq
    jo = JaxOPQ.fit(x, m=8, k=32, iters=10, opq_iters=3)
    assert opq.reconstruction_mse(x) <= 1.05 * jo.reconstruction_mse(x)
