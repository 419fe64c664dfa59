"""tests/test_compression.py re-pointed at the port's compression
(erlvectordb_tpu_torch/quant/): round-trip error bounds per algorithm,
ratio > 1 on compressible input, batch ops, the benchmark's output, PCA and
PQ/OPQ quality — on the CPU (``device=CPU``) — and then the port against the
JAX package on the same seeded inputs: equal 8-bit/4-bit codes, minima and
scales, equal zlib bytes, PCA reconstructions within a stated tolerance,
equal product codes under one codebook, and blobs that decompress across the
packages."""

import numpy as np
import pytest
import torch

from erlvectordb_tpu_torch.quant import (
    CompressedVector,
    PCAModel,
    PQCodebook,
    benchmark_compression,
    compress_batch,
    compress_vector,
    decompress_batch,
    decompress_vector,
    get_compression_ratio,
    get_supported_algorithms,
)

CPU = torch.device("cpu")


@pytest.fixture
def vec(rng):
    return rng.standard_normal(128).astype(np.float32)


class TestRoundTrips:
    def test_8bit_bound(self, vec):
        cv = compress_vector(vec, "8bit", device=CPU)
        recon = decompress_vector(cv, device=CPU)
        # reference bound: per-element error < 0.1 on unit-scale data;
        # the tight bound is range/255.
        bound = (vec.max() - vec.min()) / 255 + 1e-6
        assert np.max(np.abs(recon - vec)) <= bound

    def test_4bit_bound(self, vec):
        cv = compress_vector(vec, "4bit", device=CPU)
        recon = decompress_vector(cv, device=CPU)
        bound = (vec.max() - vec.min()) / 15 + 1e-6
        assert np.max(np.abs(recon - vec)) <= bound

    def test_4bit_odd_dimension(self, rng):
        v = rng.standard_normal(7).astype(np.float32)
        recon = decompress_vector(compress_vector(v, "4bit", device=CPU), device=CPU)
        assert recon.shape == (7,)
        assert np.max(np.abs(recon - v)) <= (v.max() - v.min()) / 15 + 1e-6

    def test_zlib_lossless(self, vec):
        recon = decompress_vector(compress_vector(vec, "zlib", device=CPU), device=CPU)
        np.testing.assert_array_equal(recon, vec)

    def test_lz4_lossless(self, vec):
        recon = decompress_vector(compress_vector(vec, "lz4", device=CPU), device=CPU)
        np.testing.assert_array_equal(recon, vec)

    def test_pca_single_vector_truncation(self, vec):
        cv = compress_vector(vec, "pca", device=CPU)
        assert cv.meta["mode"] == "truncate"
        recon = decompress_vector(cv, device=CPU)
        np.testing.assert_allclose(recon[:64], vec[:64], atol=1e-6)
        np.testing.assert_array_equal(recon[64:], 0)

    def test_product_single_vector(self, vec):
        cv = compress_vector(vec, "product", device=CPU)
        assert cv.meta["mode"] == "single"
        recon = decompress_vector(cv, device=CPU)
        assert recon.shape == (128,)
        # micro-codebook: reconstruction correlates strongly with the input
        corr = np.corrcoef(recon, vec)[0, 1]
        assert corr > 0.5


class TestModelBased:
    def test_pca_model_quality(self, rng):
        # low-rank data: PCA to the true rank is near-lossless
        basis = rng.standard_normal((8, 64)).astype(np.float32)
        coeffs = rng.standard_normal((200, 8)).astype(np.float32)
        data = coeffs @ basis
        model = PCAModel.fit(data, n_components=8, device=CPU)
        cvs = compress_batch(data, "pca", pca_model=model, device=CPU)
        recon = np.stack(decompress_batch(cvs, device=CPU))
        rel = np.linalg.norm(recon - data) / np.linalg.norm(data)
        assert rel < 1e-3

    def test_pca_autotrains_on_batch(self, rng):
        data = rng.standard_normal((100, 32)).astype(np.float32)
        cvs = compress_batch(data, "pca", device=CPU)
        assert cvs[0].meta["mode"] == "model"
        recon = np.stack(decompress_batch(cvs, device=CPU))
        assert recon.shape == data.shape

    def test_pq_codebook_roundtrip_quality(self, rng):
        # clustered data: PQ reconstruction error far below data scale
        centers = rng.standard_normal((32, 64)).astype(np.float32) * 5
        assign = rng.integers(0, 32, size=2000)
        data = centers[assign] + 0.1 * rng.standard_normal((2000, 64)).astype(np.float32)
        cb = PQCodebook.fit(data, m=8, k=64, iters=15, device=CPU)
        codes = np.asarray(cb.encode(data))
        assert codes.shape == (2000, 8)
        assert codes.dtype == np.uint8
        recon = np.asarray(cb.decode(codes))
        mse = np.mean((recon - data) ** 2)
        var = np.var(data)
        assert mse < 0.05 * var

    def test_pq_batch_api(self, rng):
        data = rng.standard_normal((600, 32)).astype(np.float32)
        cvs = compress_batch(data, "product", device=CPU)
        assert cvs[0].meta["mode"] == "codebook"
        recon = np.stack(decompress_batch(cvs, device=CPU))
        assert recon.shape == data.shape
        # codes are 1 byte per subvector
        assert len(cvs[0].payload) == cvs[0].meta["m"]

    def test_adc_tables_shapes(self, rng):
        data = rng.standard_normal((512, 32)).astype(np.float32)
        cb = PQCodebook.fit(data, m=4, k=16, iters=5, device=CPU)
        lut = np.asarray(cb.adc_tables(data[:3], metric="euclidean"))
        assert lut.shape == (3, 4, 16)
        # ADC distance == exact distance to reconstruction
        codes = cb.encode(data[:10])
        recon = np.asarray(cb.decode(codes))
        adc = lut[0].reshape(4, 16)
        codes0 = np.asarray(codes)
        d_adc = sum(adc[m, codes0[0, m]] for m in range(4))
        d_exact = np.sum((data[0] - recon[0]) ** 2)
        np.testing.assert_allclose(d_adc, d_exact, rtol=1e-3, atol=1e-3)


class TestApiSurface:
    def test_supported_algorithms(self):
        algs = get_supported_algorithms()
        assert set(algs) == {"8bit", "4bit", "pca", "zlib", "lz4", "product"}

    def test_ratio_gt_one_on_compressible(self):
        v = np.zeros(256, np.float32)  # maximally compressible
        for alg in ("8bit", "4bit", "zlib", "lz4"):
            cv = compress_vector(v, alg, device=CPU)
            assert get_compression_ratio(v, cv) > 1.0, alg

    def test_8bit_ratio_is_4x(self, vec):
        cv = compress_vector(vec, "8bit", device=CPU)
        assert get_compression_ratio(vec, cv) == pytest.approx(4.0)

    def test_4bit_ratio_is_8x(self, vec):
        cv = compress_vector(vec, "4bit", device=CPU)
        assert get_compression_ratio(vec, cv) == pytest.approx(8.0)

    def test_batch_roundtrip(self, rng):
        data = rng.standard_normal((16, 64)).astype(np.float32)
        cvs = compress_batch(data, "8bit", device=CPU)
        assert len(cvs) == 16
        recon = np.stack(decompress_batch(cvs, device=CPU))
        assert np.max(np.abs(recon - data)) < 0.05

    def test_serialization_roundtrip(self, vec):
        for alg in ("8bit", "4bit", "zlib", "lz4", "pca", "product"):
            cv = compress_vector(vec, alg, device=CPU)
            blob = cv.to_bytes()
            back = CompressedVector.from_bytes(blob)
            r1 = decompress_vector(cv, device=CPU)
            r2 = decompress_vector(back, device=CPU)
            np.testing.assert_array_equal(r1, r2)

    def test_unknown_algorithm(self, vec):
        with pytest.raises(ValueError):
            compress_vector(vec, "quantum", device=CPU)

    def test_benchmark_shape(self, vec):
        out = benchmark_compression(vec, "8bit", iterations=2, device=CPU)
        assert set(out) >= {
            "algorithm",
            "compress_time_us",
            "decompress_time_us",
            "compression_ratio",
            "mse",
        }
        assert out["mse"] >= 0


class TestOPQ:
    def test_opq_beats_pq_on_anisotropic_data(self, rng):
        from erlvectordb_tpu_torch.quant.opq import OPQCodebook

        # anisotropic: a few dominant directions NOT axis-aligned
        basis = rng.standard_normal((32, 32)).astype(np.float32)
        scales = np.logspace(0, -2, 32).astype(np.float32)
        data = (rng.standard_normal((3000, 32)).astype(np.float32) * scales) @ basis
        pq = PQCodebook.fit(data, m=8, k=64, iters=10, device=CPU)
        opq = OPQCodebook.fit(data, m=8, k=64, iters=10, opq_iters=4, device=CPU)
        mse_pq = float(np.mean((np.asarray(pq.decode(pq.encode(data))) - data) ** 2))
        mse_opq = opq.reconstruction_mse(data)
        assert mse_opq < mse_pq * 0.9, (mse_opq, mse_pq)

    def test_opq_rotation_is_orthogonal(self, rng):
        from erlvectordb_tpu_torch.quant.opq import OPQCodebook

        data = rng.standard_normal((1000, 16)).astype(np.float32)
        opq = OPQCodebook.fit(data, m=4, k=16, iters=5, opq_iters=2, device=CPU)
        r = np.asarray(opq.rotation)
        np.testing.assert_allclose(r @ r.T, np.eye(16), atol=1e-4)

    def test_opq_serialization(self, rng):
        from erlvectordb_tpu_torch.quant.opq import OPQCodebook

        data = rng.standard_normal((500, 16)).astype(np.float32)
        opq = OPQCodebook.fit(data, m=4, k=16, iters=5, opq_iters=2, device=CPU)
        clone = OPQCodebook.from_arrays(opq.to_arrays(), device=CPU)
        np.testing.assert_array_equal(
            np.asarray(opq.encode(data[:10])), np.asarray(clone.encode(data[:10]))
        )


# ------------------------------------------------- parity with the JAX package


def _jax():
    from erlvectordb_tpu.quant import compression as jc

    return jc


def _clustered(seed, n, d):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((32, d)).astype(np.float32) * 3
    return (centres[rng.integers(0, 32, n)]
            + 0.3 * rng.standard_normal((n, d))).astype(np.float32)


class TestJaxParity:
    @pytest.mark.parametrize("alg", ["8bit", "4bit"])
    @pytest.mark.parametrize("d", [7, 64, 100])
    def test_affine_codes_min_scale_equal(self, alg, d):
        """The same codes, minima and scales as the JAX package's, and the
        same decompressed rows (the host formula of both packages)."""
        jc = _jax()
        x = (np.random.default_rng(d).standard_normal((500, d)) * 3
             ).astype(np.float32)
        x[3] = 1.5  # a constant row: range 0, scale 1
        want = jc.compress_batch(x, alg)
        got = compress_batch(x, alg, device=CPU)
        for g, w in zip(got, want):
            assert g.payload == w.payload and g.meta == w.meta
        np.testing.assert_array_equal(
            np.stack(decompress_batch(got, device=CPU)),
            np.stack(jc.decompress_batch(want)))

    def test_affine_device_dequantizers_match_jit(self):
        """quant/affine.py's dequantizers are the JAX package's jitted ones
        bit for bit (XLA's codes * (scale * f32(1/L)) + mn fused
        multiply-add)."""
        from erlvectordb_tpu.quant import affine as ja

        from erlvectordb_tpu_torch.quant import affine as ta

        x = (np.random.default_rng(1).standard_normal((800, 99)) * 4
             ).astype(np.float32)
        xt = torch.from_numpy(x)
        for q, dq, kw in ((ja.quantize_u8, ja.dequantize_u8, {}),
                          (ja.quantize_u4, ja.dequantize_u4, {"dim": 99})):
            jq = q(x)
            tq = (ta.quantize_u8 if q is ja.quantize_u8 else ta.quantize_u4)(xt)
            for a, b in zip(jq, tq):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
            td = (ta.dequantize_u8 if dq is ja.dequantize_u8
                  else ta.dequantize_u4)(*tq, **kw)
            np.testing.assert_array_equal(np.asarray(dq(*jq, **kw)), td.numpy())

    def test_zlib_bytes_equal(self):
        jc = _jax()
        x = _clustered(2, 40, 48)
        for g, w in zip(compress_batch(x, "zlib"), jc.compress_batch(x, "zlib")):
            assert g.payload == w.payload and g.meta == w.meta

    def test_pca_reconstruction_matches(self):
        """Eigenvector signs are free, so the reconstructions are compared:
        within 1e-4 of the JAX package's (rows of scale ~3; f32 covariance
        and eigh in another order)."""
        jc = _jax()
        x = _clustered(4, 400, 64)
        want = np.stack(jc.decompress_batch(jc.compress_batch(x, "pca")))
        got = np.stack(decompress_batch(compress_batch(x, "pca", device=CPU),
                                        device=CPU))
        np.testing.assert_allclose(got, want, atol=1e-4)
        assert np.mean((got - x) ** 2) < 0.5 * np.var(x)

    def test_product_codes_equal_under_one_codebook(self):
        from erlvectordb_tpu.quant.pq import PQCodebook as JaxPQCodebook

        jc = _jax()
        x = _clustered(5, 600, 64)
        books = JaxPQCodebook.fit(x, m=8, k=64, iters=5).to_arrays()
        want = jc.compress_batch(x, "product",
                                 pq_codebook=JaxPQCodebook.from_arrays(books))
        got = compress_batch(x, "product", device=CPU,
                             pq_codebook=PQCodebook.from_arrays(books,
                                                                device=CPU))
        for g, w in zip(got, want):
            assert g.payload == w.payload and g.meta == w.meta

    def test_product_fit_mse_within_ten_percent(self):
        """The fit path draws other k-means seeds than the JAX package's
        (ops/kmeans.py): reconstruction MSE within 10% of the JAX
        package's, for a batch fit and for single-vector micro-codebooks."""
        jc = _jax()
        x = _clustered(6, 1200, 64)
        want = np.stack(jc.decompress_batch(jc.compress_batch(x, "product")))
        got = np.stack(decompress_batch(
            compress_batch(x, "product", device=CPU), device=CPU))
        mse_j, mse_t = (float(np.mean((r - x) ** 2)) for r in (want, got))
        assert abs(mse_t - mse_j) <= 0.1 * mse_j, (mse_t, mse_j)
        single = _clustered(7, 40, 128)
        mse = np.array([[np.mean((jc.decompress_vector(
            jc.compress_vector(v, "product")) - v) ** 2), np.mean(
            (decompress_vector(compress_vector(v, "product", device=CPU),
                               device=CPU) - v) ** 2)] for v in single])
        mse_j, mse_t = mse.mean(axis=0)
        assert abs(mse_t - mse_j) <= 0.1 * mse_j, (mse_t, mse_j)

    @pytest.mark.parametrize("alg", ["8bit", "4bit", "pca", "zlib", "lz4",
                                     "product"])
    def test_blobs_cross_the_packages(self, alg):
        """A blob from to_bytes in one package decompresses in the other to
        the vector its own package gives: bit for bit, except a PCA model's
        inverse transform, an f32 product summed in another order (within
        1e-5 on rows of scale ~3)."""
        jc = _jax()
        x = _clustered(8, 300, 64)
        same = (np.testing.assert_array_equal if alg != "pca" else
                lambda a, b: np.testing.assert_allclose(a, b, atol=1e-5))
        for jcv, tcv in ((jc.compress_vector(x[3], alg),
                          compress_vector(x[3], alg, device=CPU)),
                         (jc.compress_batch(x, alg)[3],
                          compress_batch(x, alg, device=CPU)[3])):
            j_blob, t_blob = jcv.to_bytes(), tcv.to_bytes()
            same(decompress_vector(j_blob, device=CPU),
                 jc.decompress_vector(j_blob))
            same(jc.decompress_vector(t_blob),
                 decompress_vector(t_blob, device=CPU))
