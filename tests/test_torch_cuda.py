"""The hand-written CUDA kernels against their plain PyTorch versions, on a
CUDA card.  Marked ``cuda``: without a card every test here skips.  On a
machine with a card (and no JAX), run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX for the rest of the
suite).  Shapes are small but ragged — a query count that is not a multiple
of the kernels' query groups, rows two staged pieces wide — so the edges of
the kernels' tiling are exercised; chip_smoke.py checks the same bars at the
full config-3 shapes.
"""

import numpy as np
import pytest
import torch

import erlvectordb_tpu_torch.ops.fused_topk as ft
from erlvectordb_tpu_torch.core.store import _encode_unit

pytestmark = pytest.mark.cuda

B, W, N_TILES = 45, 256, 3
ROWS = N_TILES * ft.TILE_N


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def inputs(dev):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((ROWS + 100, W)).astype(np.float32)
    x[:, 200:] = 0.0            # a padded tail, as stores pad to 128 columns
    valid = np.ones(len(x), bool)
    valid[[5, 4097, ROWS - 1]] = False
    q = rng.standard_normal((B, W)).astype(np.float32)
    q[:, 200:] = 0.0
    t = lambda a: torch.from_numpy(a).to(dev)
    x, q, valid = t(x), t(q), t(valid)
    absmax = x.abs().amax(dim=1)
    scales = torch.where(absmax > 0, ft.div_scalar(absmax, 127.0),
                         torch.ones_like(absmax))
    codes = torch.clamp(torch.round(x / scales[:, None]), -127, 127).to(torch.int8)
    return x, q, valid, codes, scales, x.norm(dim=1)


def _factors(inputs, metric, int8):
    x, q, valid, codes, scales, norms = inputs
    q_in, qmult, rowmult, rowbias, _ = ft._affine_factors(
        metric, scales if int8 else None, norms, valid, q)
    return (codes if int8 else x), q_in, qmult, rowmult, rowbias


def test_intkey_kernel_bit_identical(inputs):
    codes, q_in, *_ = _factors(inputs, "cosine", True)
    ft.reset_launches()
    kern = ft.intkey_scan(codes, q_in, N_TILES)
    assert ft.intkey_scan.launches == 1
    torch.testing.assert_close(kern, ft.intkey_scan_ref(codes, q_in, N_TILES),
                               rtol=0, atol=0)


def test_l2key_kernel_bit_identical(inputs):
    x, q, valid, codes, scales, norms = inputs
    q8b, bias = ft.l2key_inputs(q, norms, 1.25 * float(norms.max()))
    bias[::7] = (1 << 20)   # the clamp: negative (D - bias) keys
    kern = ft.l2key_scan(codes, q8b, bias, N_TILES)
    torch.testing.assert_close(kern, ft.l2key_scan_ref(codes, q8b, bias, N_TILES),
                               rtol=0, atol=0)


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_pos_kernel_keys(inputs, metric, int8):
    """Bit-identical, or one key step (1024) on <= 0.1% of entries where f32
    dots sum in another order than cuBLAS's."""
    x, q, valid, codes, scales, norms = inputs
    c, q_in, qmult, rowmult, rowbias = _factors(inputs, metric, int8)
    f, g, m, b = ft._pos_window(c, scales if int8 else None, norms, valid,
                                q_in, qmult, rowmult, rowbias, metric)
    use_qm = metric == "euclidean"
    kern = ft.pos_scan(c, q_in, qmult, f, g, m, b, N_TILES, use_qm).long()
    ref = ft.pos_scan_ref(c, q_in, qmult, f, g, m, b, N_TILES, use_qm).long()
    diff = (kern - ref)[kern != ref]
    assert diff.numel() <= 1e-3 * kern.numel()
    assert torch.all(diff.abs() == 1024)


@pytest.mark.parametrize("t_per_tile", [2, 4, 8])
@pytest.mark.parametrize("int8", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_fused_kernel_top_t(inputs, metric, int8, t_per_tile):
    c, q_in, qmult, rowmult, rowbias = _factors(inputs, metric, int8)
    vk, rk = ft.fused_scan(c, q_in, qmult, rowmult, rowbias, N_TILES, t_per_tile)
    vr, rr = ft.fused_scan_ref(c, q_in, qmult, rowmult, rowbias, N_TILES,
                               t_per_tile)
    same = rk == rr
    assert int((~same).sum()) <= (0 if int8 else 1e-3 * same.numel())
    torch.testing.assert_close(vk[same], vr[same], rtol=2.5e-4, atol=0)


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_fused_topk_cuda_matches_cpu(inputs, metric, monkeypatch):
    """The whole fused path on the card (kernels) against the same call on
    the CPU (plain versions), through the key, pos and masked paths."""
    x, q, valid, codes, scales, norms = inputs
    monkeypatch.setattr(ft, "POS_MIN_TILES", 1)
    plane = _encode_unit(x)
    plane[~valid] = 0
    for kw in ({}, {"k_big": True}, {"codes_unit": plane}):
        k = 24 if kw.pop("k_big", False) else 10
        if "codes_unit" in kw and metric != "cosine":
            continue
        args = (codes, scales, norms, valid, q)
        dk, rk = ft.fused_topk(*args, metric=metric, k=k, n_tiles=N_TILES, **kw)
        dc, rc = ft.fused_topk(*[a.cpu() for a in args], metric=metric, k=k,
                               n_tiles=N_TILES,
                               **{n: v.cpu() for n, v in kw.items()})
        overlap = np.mean([len(set(a) & set(b)) / k for a, b in
                           zip(rk.cpu().tolist(), rc.tolist())])
        assert overlap >= 0.99
        torch.testing.assert_close(dk[:, 0].cpu(), dc[:, 0], rtol=1e-4, atol=1e-4)


def test_wrappers_validate(inputs):
    codes, q_in, *_ = _factors(inputs, "cosine", True)
    with pytest.raises(ValueError):
        ft.intkey_scan(codes[:, :100].contiguous(), q_in[:, :100].contiguous(), 1)
    with pytest.raises(ValueError):
        ft.intkey_scan(codes, q_in, N_TILES + 1)
    with pytest.raises(ValueError):
        ft.intkey_scan(codes, q_in.float(), N_TILES)
