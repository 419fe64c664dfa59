"""int8 scales of the port against the JAX package's, bit for bit, on the CPU.

Inside ``jit`` XLA compiles a division by a constant, ``x / 127.0``, as a
multiply by the f32 reciprocal; a true division differs from that in the
last bit on ~4.6% of f32 values.  The inputs here are rows whose absmax (in
column 3) is a value where the two roundings differ, so every one of them
shows which rounding a site takes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erlvectordb_tpu.core.search as jsearch
import erlvectordb_tpu.core.store as jstore
import erlvectordb_tpu.ops.cell_build as jcb
import erlvectordb_tpu.ops.fused_topk as jft
import erlvectordb_tpu_torch.core.search as tsearch
import erlvectordb_tpu_torch.ops.cell_build as tcb
import erlvectordb_tpu_torch.ops.fused_topk as tft
from erlvectordb_tpu_torch.core import VectorStore

torch.set_num_threads(2)

N, DIM, W = 4096, 100, 128


@pytest.fixture(scope="module")
def rows():
    """[N, DIM] rows, each with an absmax where a / 127 (true division) and
    a * f32(1/127) round apart."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0.5, 4.0, 200_000).astype(np.float32)
    a = a[a / np.float32(127.0) != a * np.float32(1.0 / 127.0)][:N]
    assert len(a) == N
    x = rng.uniform(-0.4, 0.4, (N, DIM)).astype(np.float32)
    x[:, 3] = a
    return x


def _padded(x):
    return np.pad(x, ((0, 0), (0, W - x.shape[1])))


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    bad = int((got != want).sum())
    assert bad == 0, f"{bad} of {got.size} entries differ"


def test_from_matrix_scales_and_codes(rows):
    j = jstore.VectorStore.from_matrix("q", rows, dtype="int8").export_state()
    t = VectorStore.from_matrix("q", rows, dtype="int8",
                                device="cpu").export_state()
    _same(t["scales"][:N], j["scales"][:N])
    _same(t["vectors"][:N], j["vectors"][:N])


def test_insert_scales_and_codes(rows):
    ids = [str(i) for i in range(N)]
    js = jstore.VectorStore("q", dtype="int8")
    js.insert_batch(ids, rows)
    ts = VectorStore("q", dtype="int8", device="cpu")
    ts.insert_batch(ids, rows)
    j, t = js.export_state(), ts.export_state()
    assert t["id_to_row"] == j["id_to_row"]
    _same(t["scales"][:N], j["scales"][:N])
    _same(t["vectors"][:N], j["vectors"][:N])


def test_affine_factors_query_scales(rows):
    """The int8 query scale of the fused scans' affine factors (for dot the
    per-query multiplier is the scale itself)."""
    q = _padded(rows)
    s = np.ones(8, np.float32)
    want = jax.jit(lambda qq: jft._affine_factors(
        "dot", jnp.asarray(s), jnp.asarray(s), jnp.ones(8, bool), qq)[1])(
        jnp.asarray(q))
    got = tft._affine_factors("dot", torch.ones(8), torch.ones(8),
                              torch.ones(8, dtype=torch.bool),
                              torch.from_numpy(q))[1]
    _same(got.numpy(), np.asarray(want))


def test_exact_int8_query_scales(rows):
    """core/search.py's int8 query quantizer, read through exact_topk_int8:
    with one code row e_3 and the dot metric, the distance is -127 * the
    query's scale."""
    q = _padded(rows)
    codes = np.zeros((8, W), np.int8)
    codes[0, 3] = 1
    ones = np.ones(8, np.float32)
    want, _ = jsearch.exact_topk_int8(
        jnp.asarray(codes), jnp.asarray(ones), jnp.asarray(ones),
        jnp.ones(8, bool), jnp.asarray(q), metric="dot", k=1)
    got, _ = tsearch.exact_topk_int8(
        torch.from_numpy(codes), torch.from_numpy(ones), torch.from_numpy(ones),
        torch.ones(8, dtype=torch.bool), torch.from_numpy(q), metric="dot", k=1)
    _same(got.numpy(), np.asarray(want))


def test_l2key_batch_scale(rows):
    """The euclidean key scan's batch-shared s_b (ops/fused_topk.py:635, a
    line of _intkey_topk that no JAX function returns alone), one row per
    batch so each row's absmax sets it."""
    q = _padded(rows)
    want = jax.vmap(jax.jit(
        lambda b: jnp.maximum(jnp.max(jnp.abs(b)), 1e-30) / 127.0))(
        jnp.asarray(q)[:, None, :])
    got = torch.stack([tft.l2key_batch_scale(torch.from_numpy(q[i:i + 1]))
                       for i in range(N)])
    _same(got.numpy(), np.asarray(want))


def test_cell_build_staging_scales(rows):
    """The streaming cell build's int8 staging (_stage_chunk) and its int8
    routing copy of the centroids (_quant_cents_int8)."""
    x = _padded(rows)
    c8, s8, nn = jcb._stage_chunk(jnp.zeros((N, W), jnp.int8), jnp.ones(N),
                                  jnp.zeros(N), jnp.asarray(rows),
                                  jnp.int32(0), w=W)
    codes8 = torch.zeros((N, W), dtype=torch.int8)
    scales = torch.ones(N)
    norms = torch.zeros(N)
    tcb._stage_chunk(codes8, scales, norms, torch.from_numpy(rows), 0, w=W)
    _same(scales.numpy(), np.asarray(s8))
    _same(codes8.numpy(), np.asarray(c8))
    qc, sc = jcb._quant_cents_int8(jnp.asarray(x))
    tq, ts = tcb._quantize_rows_int8(torch.from_numpy(x))
    _same(ts.numpy(), np.asarray(sc))
    _same(tq.numpy(), np.asarray(qc))
