"""The port's vector math and exact scans (erlvectordb_tpu_torch/utils/
vector_math.py, core/search.py) against the JAX package's, on the CPU.

The cases of tests/test_vector_math.py run against the port, and every
function is fed the same seeded numpy inputs as its JAX counterpart.
Tolerances: f32 sums run in another order in the two frameworks, so values
agree to ~1e-6 relative; int8 dots are exact in both, so int8 rankings and
ids agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erlvectordb_tpu.core.search as jsearch
import erlvectordb_tpu.utils.vector_math as jvm
import erlvectordb_tpu_torch.core.search as tsearch
import erlvectordb_tpu_torch.utils.vector_math as vm

torch.set_num_threads(2)


# --------------------------------------- tests/test_vector_math.py, re-pointed


def test_cosine_similarity():
    assert float(vm.cosine_similarity([1, 0], [1, 0])) == pytest.approx(1.0)
    assert float(vm.cosine_similarity([1, 0], [0, 1])) == pytest.approx(0.0, abs=1e-7)
    assert float(vm.cosine_similarity([1, 0], [-1, 0])) == pytest.approx(-1.0)


def test_cosine_zero_norm_is_zero_similarity():
    assert float(vm.cosine_similarity([0, 0], [1, 0])) == 0.0
    assert float(vm.cosine_distance([0, 0], [1, 0])) == 1.0


def test_euclidean_manhattan_dot():
    assert float(vm.euclidean_distance([0, 0], [3, 4])) == pytest.approx(5.0)
    assert float(vm.manhattan_distance([0, 0], [3, 4])) == pytest.approx(7.0)
    assert float(vm.dot_product([1, 2, 3], [4, 5, 6])) == pytest.approx(32.0)


def test_normalize():
    np.testing.assert_allclose(vm.normalize([3.0, 4.0]).numpy(), [0.6, 0.8],
                               atol=1e-6)
    np.testing.assert_allclose(vm.normalize([0.0, 0.0]).numpy(), [0.0, 0.0])
    sq = np.array([[2.0, 0.0], [0.0, 8.0]], np.float32)
    np.testing.assert_allclose(vm.normalize(sq).numpy(),
                               [[1.0, 0.0], [0.0, 1.0]], atol=1e-6)


def test_norm_and_arithmetic():
    assert float(vm.vector_norm([3, 4])) == pytest.approx(5.0)
    np.testing.assert_allclose(vm.vector_add([1, 2], [3, 4]).numpy(), [4, 6])
    np.testing.assert_allclose(vm.vector_subtract([3, 4], [1, 2]).numpy(), [2, 2])
    np.testing.assert_allclose(vm.vector_multiply([1, 2], 2.5).numpy(), [2.5, 5.0])


def test_batched_forms():
    a = np.random.default_rng(0).standard_normal((5, 8)).astype(np.float32)
    b = np.random.default_rng(1).standard_normal((5, 8)).astype(np.float32)
    d = vm.euclidean_distance(a, b).numpy()
    assert d.shape == (5,)
    np.testing.assert_allclose(d, np.linalg.norm(a - b, axis=1), rtol=1e-5)


@pytest.mark.parametrize("fn", ["cosine_similarity", "cosine_distance",
                                "euclidean_distance", "manhattan_distance",
                                "dot_product", "vector_add",
                                "vector_subtract"])
def test_binary_ops_match_jax(fn):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((6, 16)).astype(np.float32)
    b = rng.standard_normal((6, 16)).astype(np.float32)
    a[2] = 0.0  # zero-norm semantics
    np.testing.assert_allclose(getattr(vm, fn)(a, b).numpy(),
                               np.asarray(getattr(jvm, fn)(a, b)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fn", ["normalize", "vector_norm"])
def test_unary_ops_match_jax(fn):
    a = np.random.default_rng(3).standard_normal((6, 16)).astype(np.float32)
    a[1] = 0.0
    np.testing.assert_allclose(getattr(vm, fn)(a).numpy(),
                               np.asarray(getattr(jvm, fn)(a)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(vm.vector_multiply(a, 0.3).numpy(),
                               np.asarray(jvm.vector_multiply(a, 0.3)))


# -------------------------------------------------------------- exact scans


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(4)
    n, d = 700, 128
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[3] = 0.0  # zero-norm row
    valid = np.ones(n, bool)
    valid[[10, 20, 650]] = False
    q = rng.standard_normal((9, d)).astype(np.float32)
    q[2] = 0.0  # zero-norm query
    absmax = np.abs(x).max(axis=1)
    scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    codes = np.clip(np.round(x / scales[:, None]), -127, 127).astype(np.int8)
    norms = np.linalg.norm(x, axis=1).astype(np.float32)
    return x, norms, valid, q, codes, scales


def test_k_bucket_matches():
    for k in (1, 2, 3, 10, 16, 17, 1000, 5000):
        for cap in (1024, 4096):
            assert tsearch.k_bucket(k, cap) == jsearch.k_bucket(k, cap)


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "manhattan", "dot"])
def test_pairwise_distances_match(data, metric):
    x, norms, _, q, _, _ = data
    got = tsearch.pairwise_distances(torch.from_numpy(x),
                                     torch.from_numpy(norms),
                                     torch.from_numpy(q), metric).numpy()
    want = np.asarray(jsearch.pairwise_distances(
        jnp.asarray(x), jnp.asarray(norms), jnp.asarray(q), metric))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "manhattan", "dot"])
def test_int8_distances_match(data, metric):
    _, norms, _, q, codes, scales = data
    got = tsearch.int8_distances(torch.from_numpy(codes),
                                 torch.from_numpy(scales),
                                 torch.from_numpy(norms),
                                 torch.from_numpy(q), metric).numpy()
    want = np.asarray(jsearch.int8_distances(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(norms),
        jnp.asarray(q), metric))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "manhattan", "dot"])
def test_exact_topk_matches(data, metric, int8):
    x, norms, valid, q, codes, scales = data
    k = 16
    if int8:
        d_t, r_t = tsearch.exact_topk_int8(
            torch.from_numpy(codes), torch.from_numpy(scales),
            torch.from_numpy(norms), torch.from_numpy(valid),
            torch.from_numpy(q), metric=metric, k=k)
        d_j, r_j = jsearch.exact_topk_int8(
            jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(norms),
            jnp.asarray(valid), jnp.asarray(q), metric=metric, k=k)
    else:
        d_t, r_t = tsearch.exact_topk(
            torch.from_numpy(x), torch.from_numpy(norms),
            torch.from_numpy(valid), torch.from_numpy(q), metric=metric, k=k)
        d_j, r_j = jsearch.exact_topk(
            jnp.asarray(x), jnp.asarray(norms), jnp.asarray(valid),
            jnp.asarray(q), metric=metric, k=k)
    d_j, r_j = np.asarray(d_j), np.asarray(r_j)
    assert r_t.dtype == torch.int32
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=1e-5, atol=1e-4)
    # the zero query ties every row (cosine 1, dot 0): those ids may differ
    rows = [b for b in range(len(q))
            if not (metric in ("cosine", "dot") and b == 2)]
    np.testing.assert_array_equal(r_t.numpy()[rows], r_j[rows])
    assert not np.isin(r_t.numpy(), [10, 20, 650]).any()
