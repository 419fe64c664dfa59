"""The hand-written CUDA kernels against their plain PyTorch versions, on a
CUDA card.  Marked ``cuda``: without a card every test here skips.  On a
machine with a card (and no JAX), run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX for the rest of the
suite).  Besides the kernels, the int4 and int4r stores run insert, delete
and search through the store's kernel dispatch on the card, and an int4r
store and a cell-probe index run multiprobe searches through B7.  Shapes are small but ragged — a query count that is not a multiple
of the kernels' query groups, rows two staged pieces wide — so the edges of
the kernels' tiling are exercised; chip_smoke.py checks the same bars at the
full config-3 shapes.
"""

import numpy as np
import pytest
import torch

import erlvectordb_tpu_torch.ops.fused_topk as ft
from erlvectordb_tpu_torch.core.store import _encode_unit, _pack_int4

pytestmark = pytest.mark.cuda

B, W, N_TILES = 45, 256, 3
ROWS = N_TILES * ft.TILE_N


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _quantize8(x):
    """Absmax int8 codes and scales of rows x (the int8 store's encoding)."""
    absmax = x.abs().amax(dim=1)
    scales = torch.where(absmax > 0, ft.div_scalar(absmax, 127.0),
                         torch.ones_like(absmax))
    return (torch.clamp(torch.round(x / scales[:, None]), -127, 127)
            .to(torch.int8), scales)


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
    codes, scales = _quantize8(x)
    return x, q, valid, codes, scales, x.norm(dim=1)


def _factors(inputs, metric, int8):
    x, q, valid, codes, scales, norms = inputs
    q_in, qmult, rowmult, rowbias, _ = ft._affine_factors(
        metric, scales if int8 else None, norms, valid, q)
    return (codes if int8 else x), q_in, qmult, rowmult, rowbias


@pytest.mark.parametrize("nq", [1, B])
def test_intkey_kernel_bit_identical(inputs, nq):
    codes, q_in, *_ = _factors(inputs, "cosine", True)
    q_in = q_in[:nq].contiguous()
    ft.reset_launches()
    kern = ft.intkey_scan(codes, q_in, N_TILES)
    assert ft.intkey_scan.launches == 1
    torch.testing.assert_close(kern, ft.intkey_scan_ref(codes, q_in, N_TILES),
                               rtol=0, atol=0)


@pytest.mark.parametrize("nq", [1, B])
def test_l2key_kernel_bit_identical(inputs, nq):
    x, q, valid, codes, scales, norms = inputs
    q8b, bias = ft.l2key_inputs(q[:nq], norms, 1.25 * float(norms.max()))
    bias[::7] = (1 << 20)   # the clamp: negative (D - bias) keys
    kern = ft.l2key_scan(codes, q8b, bias, N_TILES)
    torch.testing.assert_close(kern, ft.l2key_scan_ref(codes, q8b, bias, N_TILES),
                               rtol=0, atol=0)


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_pos_kernel_keys(inputs, metric, int8):
    """int8 codes: bit-identical (integer dots are exact in any order).  f32
    codes: one key step (1024) on <= 0.1% of entries, where f32 dots sum in
    another order than cuBLAS's."""
    x, q, valid, codes, scales, norms = inputs
    c, q_in, qmult, rowmult, rowbias = _factors(inputs, metric, int8)
    f, g, m, b = ft._pos_window(c, scales if int8 else None, norms, valid,
                                q_in, qmult, rowmult, rowbias, metric)
    use_qm = metric == "euclidean"
    kern = ft.pos_scan(c, q_in, qmult, f, g, m, b, N_TILES, use_qm).long()
    ref = ft.pos_scan_ref(c, q_in, qmult, f, g, m, b, N_TILES, use_qm).long()
    diff = (kern - ref)[kern != ref]
    assert diff.numel() <= (0 if int8 else 1e-3 * kern.numel())
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
    torch.testing.assert_close(vk[same], vr[same], rtol=0 if int8 else 2.5e-4,
                               atol=0)


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


# ------------------------------------------------ packed int4, B5 and B6


def _pack4(x):
    """Packed int4 codes and scales of rows x (the int4 store's encoding)."""
    absmax = x.abs().amax(dim=1)
    scales = torch.where(absmax > 0, ft.div_scalar(absmax, 7.0),
                         torch.ones_like(absmax))
    q = torch.clamp(torch.round(x / scales[:, None]), -7, 7).to(torch.int8)
    return _pack_int4(q), scales


@pytest.fixture(scope="module")
def int4_inputs(inputs):
    x, q, valid, codes, scales, norms = inputs
    packed, s4 = _pack4(x)
    return x, q, valid, packed, s4, norms


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_pos_kernel_keys_int4(int4_inputs, metric):
    x, q, valid, packed, s4, norms = int4_inputs
    q_in, qmult, rowmult, rowbias, _ = ft._affine_factors(metric, s4, norms,
                                                          valid, q)
    f, g, m, b = ft._pos_window(packed, s4, norms, valid, q_in, qmult, rowmult,
                                rowbias, metric)
    use_qm = metric == "euclidean"
    ft.reset_launches()
    kern = ft.pos_scan(packed, q_in, qmult, f, g, m, b, N_TILES, use_qm)
    assert ft.pos_scan.launches_by == {"int4": 1}
    torch.testing.assert_close(
        kern, ft.pos_scan_ref(packed, q_in, qmult, f, g, m, b, N_TILES, use_qm),
        rtol=0, atol=0)


@pytest.mark.parametrize("t_per_tile", [2, 4, 8])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_fused_kernel_int4(int4_inputs, metric, t_per_tile):
    x, q, valid, packed, s4, norms = int4_inputs
    q_in, qmult, rowmult, rowbias, _ = ft._affine_factors(metric, s4, norms,
                                                          valid, q)
    vk, rk = ft.fused_scan(packed, q_in, qmult, rowmult, rowbias, N_TILES,
                           t_per_tile)
    vr, rr = ft.fused_scan_ref(packed, q_in, qmult, rowmult, rowbias, N_TILES,
                               t_per_tile)
    torch.testing.assert_close(rk, rr, rtol=0, atol=0)
    torch.testing.assert_close(vk, vr, rtol=0, atol=0)


def _residual_args(inputs, metric, cell_cap, n_tiles=N_TILES):
    """A cell layout over the fixture rows: centroid of each cell's rows,
    packed residuals, reconstruction norms, and both scans' factors."""
    x, q, valid, *_ = inputs
    n = n_tiles * ft.TILE_N
    cents = x[:n].reshape(n // cell_cap, cell_cap, -1).mean(dim=1)
    packed, s4 = _pack4(x[:n] - cents.repeat_interleave(cell_cap, dim=0))
    recon = (cents.repeat_interleave(cell_cap, dim=0)
             + ft.unpack_int4(packed).float() * s4[:, None])
    norms, vld = recon.norm(dim=1), valid[:n]
    (q_in, qmult, rowmult, rowbias, _, qmult2, rowmult2, table,
     qa) = ft.residual_factors(metric, s4, norms, vld, cents, q, n_tiles,
                               cell_cap)
    ma, mb, bb, f, g = ft._residual_window(
        metric, norms, vld, q_in, qa, rowmult, rowmult2, table, cell_cap,
        ft.max_code_norm(packed))
    return packed, dict(q_in=q_in, qmult=qmult, rowmult=rowmult,
                        rowbias=rowbias, qmult2=qmult2, rowmult2=rowmult2,
                        table=table, qa=qa, f=f, g=g, ma=ma, mb=mb, bb=bb)


@pytest.mark.parametrize("t_top", [2, 8])
@pytest.mark.parametrize("cell_cap", [128, 512])
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_pos_residual_kernel_bit_identical(inputs, metric, cell_cap, t_top):
    packed, a = _residual_args(inputs, metric, cell_cap)
    args = (packed, a["q_in"], a["qa"], a["f"], a["g"], a["ma"], a["mb"],
            a["bb"], a["table"], N_TILES, cell_cap, 1024, t_top)
    ft.reset_launches()
    kern = ft.pos_residual_scan(*args)
    assert ft.pos_residual_scan.launches == 1
    torch.testing.assert_close(kern, ft.pos_residual_scan_ref(*args),
                               rtol=0, atol=0)


@pytest.mark.parametrize("t_per_tile", [2, 4, 8])
@pytest.mark.parametrize("cell_cap", [128, 512])
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_cell_kernel_bit_identical(inputs, metric, cell_cap, t_per_tile):
    packed, a = _residual_args(inputs, metric, cell_cap)
    args = (packed, a["q_in"], a["qmult"], a["rowmult"], a["rowbias"],
            a["qmult2"], a["rowmult2"], a["table"], N_TILES, t_per_tile,
            cell_cap)
    ft.reset_launches()
    vk, rk = ft.cell_scan(*args)
    assert ft.cell_scan.launches == 1
    vr, rr = ft.cell_scan_ref(*args)
    torch.testing.assert_close(rk, rr, rtol=0, atol=0)
    torch.testing.assert_close(vk, vr, rtol=0, atol=0)


def test_residual_wrappers_validate(inputs):
    packed, a = _residual_args(inputs, "cosine", 128)
    with pytest.raises(ValueError):   # table too narrow for the scanned rows
        ft.pos_residual_scan(packed, a["q_in"], a["qa"], a["f"], a["g"],
                             a["ma"], a["mb"], a["bb"], a["table"][:, :5],
                             N_TILES, 128, 1024, 8)
    with pytest.raises(ValueError):   # t_top the kernel has no variant for
        ft.pos_residual_scan(packed, a["q_in"], a["qa"], a["f"], a["g"],
                             a["ma"], a["mb"], a["bb"], a["table"], N_TILES,
                             128, 1024, 3)
    with pytest.raises(ValueError):   # a slice width the kernel has not
        ft.pos_residual_scan(packed, a["q_in"], a["qa"], a["f"], a["g"],
                             a["ma"], a["mb"], a["bb"], a["table"], N_TILES,
                             128, 512, 8)
    with pytest.raises(ValueError):   # B6 takes packed codes only
        ft.cell_scan(inputs[3], a["q_in"], a["qmult"], a["rowmult"],
                     a["rowbias"], a["qmult2"], a["rowmult2"], a["table"],
                     N_TILES, 2, 128)


# ------------------------------- the tile edges of B5 and B3-f32's blocks


def _edge_inputs(dev, nq, w, n_tiles, seed, dup=False):
    """Rows and queries for the edge cases: ``nq`` queries (ragged against
    the 128-query blocks), invalid rows, and with ``dup`` runs of identical
    rows whose keys differ only in their lane."""
    rng = np.random.default_rng(seed)
    n = n_tiles * ft.TILE_N
    x = rng.standard_normal((n + 64, w)).astype(np.float32)
    x[:, w - 28:] = 0.0
    if dup:
        x[1:n:3] = x[0:n - 1:3]
        x[2:n:3] = x[0:n - 2:3]
    valid = np.ones(len(x), bool)
    valid[rng.integers(0, n, 40)] = False
    q = rng.standard_normal((nq, w)).astype(np.float32)
    q[:, w - 28:] = 0.0
    t = lambda a: torch.from_numpy(a).to(dev)
    x, q, valid = t(x), t(q), t(valid)
    return x, q, valid, None, None, x.norm(dim=1)


@pytest.mark.parametrize("case", ["plain", "dup", "clamp"])
@pytest.mark.parametrize("t_top", [2, 8])
@pytest.mark.parametrize("cell_cap", [64, 128, 512])
@pytest.mark.parametrize("nq", [1, 7, 65, 1024])
def test_pos_residual_kernel_edges(dev, nq, cell_cap, t_top, case):
    """B5 at query counts ragged against its 128-query blocks (and one
    exact multiple), cell_cap 64 / 128 / 512, duplicated rows (ties broken
    by the lane), invalid rows, and a g that drives scores into the +-2e9
    clamp: bit-identical with the plain version."""
    inp = _edge_inputs(dev, nq, 128, 3, nq + cell_cap, dup=case == "dup")
    packed, a = _residual_args(inp, "cosine", cell_cap)
    g = a["g"] * 1e4 if case == "clamp" else a["g"]
    args = (packed, a["q_in"], a["qa"], a["f"], g, a["ma"], a["mb"],
            a["bb"], a["table"], N_TILES, cell_cap, 1024, t_top)
    ft.reset_launches()
    kern = ft.pos_residual_scan(*args)
    assert ft.pos_residual_scan.launches == 1
    ref = ft.pos_residual_scan_ref(*args)
    if case == "clamp":
        assert int((ref >> 10 == (2_000_000_000 >> 10)).sum()) > 0
    torch.testing.assert_close(kern, ref, rtol=0, atol=0)


@pytest.mark.parametrize("run", [3, 5])
@pytest.mark.parametrize("w", [128, 256, 640])
def test_pos_residual_kernel_ragged_run(dev, monkeypatch, w, run):
    """Blocks of ``run`` slices where the slice count (20) is no multiple of
    the run, and rows of one, two and five 128-element k stages (at five the
    query streams through the copy ring)."""
    real = ft.residual_scan_layout
    monkeypatch.setattr(ft, "residual_scan_layout",
                        lambda *a: {**real(*a), "run": run})
    inp = _edge_inputs(dev, 200, w, 5, 11)
    packed, a = _residual_args(inp, "euclidean", 128, n_tiles=5)
    args = (packed, a["q_in"], a["qa"], a["f"], a["g"], a["ma"], a["mb"],
            a["bb"], a["table"], 5, 128, 1024, 8)
    torch.testing.assert_close(ft.pos_residual_scan(*args),
                               ft.pos_residual_scan_ref(*args), rtol=0, atol=0)


@pytest.mark.parametrize("nq", [7, 130])
@pytest.mark.parametrize("w, cell_cap", [(512, 1), (640, 128), (1536, 128),
                                         (2048, 64), (4224, 512)])
def test_pos_residual_kernel_wide_rows(dev, w, cell_cap, nq):
    """B5 on rows of 4 to 33 k stages: the query tile resident (W 512, with
    cell_cap 1's 64 cells a stage, the largest table blocks) or streamed
    through the copy ring (W >= 640, 1536-dim embeddings among them), the
    factor ring at its shallowest, and W 4224, whose dots take the int ->
    f32 conversion: bit-identical with the plain version, so shared memory
    no longer bounds the row width."""
    inp = _edge_inputs(dev, nq, w, 2, w + cell_cap)
    packed, a = _residual_args(inp, "cosine", cell_cap, n_tiles=2)
    args = (packed, a["q_in"], a["qa"], a["f"], a["g"], a["ma"], a["mb"],
            a["bb"], a["table"], 2, cell_cap, 1024, 8)
    torch.testing.assert_close(ft.pos_residual_scan(*args),
                               ft.pos_residual_scan_ref(*args), rtol=0, atol=0)


@pytest.mark.parametrize("n_tiles", [1, 3])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("w", [128, 256])
def test_pos_kernel_keys_f32_edges(dev, w, metric, n_tiles):
    """B3-f32 at W 128 and 256 (8 and 16 k chunks), with and without the
    per-query multiplier (euclidean, cosine).  1024 queries (eight whole
    128-query blocks) against the plain version: one key step (1024) on <=
    0.1% of entries, where the kernel's f32 dots sum in another order than
    cuBLAS's.  Then the first 1 and 33 queries alone (one ragged block, 127
    and 95 of its queries masked): bit-identical with the same queries' rows
    of the full batch, since each dot is one fmaf chain over k whatever
    block it lands in."""
    x, q, valid, _, _, norms = _edge_inputs(dev, 1024, w, n_tiles, w + n_tiles)
    q_in, qmult, rowmult, rowbias, _ = ft._affine_factors(metric, None, norms,
                                                          valid, q)
    f, g, m, b = ft._pos_window(x, None, norms, valid, q_in, qmult, rowmult,
                                rowbias, metric)
    use_qm = metric == "euclidean"
    ft.reset_launches()
    kern = ft.pos_scan(x, q_in, qmult, f, g, m, b, n_tiles, use_qm)
    assert ft.pos_scan.launches_by == {"f32": 1}
    ref = ft.pos_scan_ref(x, q_in, qmult, f, g, m, b, n_tiles, use_qm)
    diff = (kern.long() - ref.long())[kern != ref]
    assert diff.numel() <= 1e-3 * kern.numel()
    assert torch.all(diff.abs() == 1024)
    for nq in (1, 33):
        part = ft.pos_scan(x, q_in[:nq].contiguous(), qmult[:nq], f[:nq],
                           g[:nq], m, b, n_tiles, use_qm)
        torch.testing.assert_close(part, kern[:nq], rtol=0, atol=0)


# ------------------------------- B1-B4 and B6 on the int8 tensor cores


def _int_inputs(dev, nq, w, n_tiles, seed, dup=False, extreme=False):
    """_edge_inputs plus the rows' absmax int8 codes and scales.  With
    ``extreme`` every other row and every other query is +-1 on one sign
    pattern, so its int8 codes and the queries are all +-127 and dots reach
    127^2 (W - 28): past 2^22 from W 384, where the dots must take the
    int -> f32 conversion, and past 2^21, where B1's << 10 wraps."""
    x, q, valid, _, _, norms = _edge_inputs(dev, nq, w, n_tiles, seed, dup)
    if extreme:
        rng = np.random.default_rng(seed + 1)
        s = torch.from_numpy(np.sign(rng.standard_normal(w)).astype(np.float32))
        s[w - 28:] = 0.0
        s = s.to(dev)
        flip = torch.from_numpy(np.sign(rng.standard_normal(
            (x.shape[0] + 1) // 2)).astype(np.float32)).to(dev)
        x[::2] = flip[:, None] * s
        q[::2] = s
        norms = x.norm(dim=1)
    codes, scales = _quantize8(x)
    return x, q, valid, codes, scales, norms


def _slice_case(kind, inp, n_tiles, clamp=False):
    """(wrapper, plain version, arguments) of a key scan over ``inp``:
    B1 (intkey), B2 (l2key, every fifth bias just under 2^20) or B3 on int8
    or packed int4 codes, cosine or euclidean (the per-query multiplier)."""
    x, q, valid, codes, scales, norms = inp
    if kind == "intkey":
        q8, *_ = ft._affine_factors("cosine", scales, norms, valid, q)
        return ft.intkey_scan, ft.intkey_scan_ref, (codes, q8, n_tiles)
    if kind == "l2key":
        q8b, bias = ft.l2key_inputs(q, norms, 1.25 * float(norms.max()))
        bias[::5] = (1 << 20) - torch.arange(0, bias[::5].numel(),
                                             device=bias.device,
                                             dtype=torch.int32) % 64
        return ft.l2key_scan, ft.l2key_scan_ref, (codes, q8b, bias, n_tiles)
    _, fmt, metric = kind.split("_")
    c, s = _pack4(x) if fmt == "i4" else (codes, scales)
    q_in, qmult, rowmult, rowbias, _ = ft._affine_factors(metric, s, norms,
                                                          valid, q)
    f, g, m, b = ft._pos_window(c, s, norms, valid, q_in, qmult, rowmult,
                                rowbias, metric)
    if clamp:
        g = g * 1e4
    return ft.pos_scan, ft.pos_scan_ref, (c, q_in, qmult, f, g, m, b, n_tiles,
                                          metric == "euclidean")


SLICE_KINDS = ["intkey", "l2key", "pos_i8_cosine", "pos_i8_euclidean",
               "pos_i4_cosine", "pos_i4_euclidean"]


@pytest.mark.parametrize("n_tiles", [1, 3])
@pytest.mark.parametrize("w", [128, 256, 384, 768])
@pytest.mark.parametrize("nq", [1, 7, 17, 130, 1024])
@pytest.mark.parametrize("kind", SLICE_KINDS)
def test_slice_kernels_bit_identical(dev, kind, nq, w, n_tiles):
    """B1, B2 and B3 (int8 and packed int4, with and without the per-query
    multiplier) at query counts ragged against the 128-query blocks, 1 and 3
    tiles (4 and 12 slices) and rows of 1 to 6 k stages, half of the rows
    +-127 throughout (B1's << 10 wraps; int8 dots pass 2^22 from W 384):
    bit-identical with the plain versions."""
    inp = _int_inputs(dev, nq, w, n_tiles, nq + w + n_tiles, extreme=True)
    kern, ref, args = _slice_case(kind, inp, n_tiles)
    ft.reset_launches()
    got = kern(*args)
    assert kern.launches == 1
    want = ref(*args)
    if kind == "intkey" and w >= 256:    # some keys wrapped past int32
        dots = (args[1].double() @ args[0][:n_tiles * ft.TILE_N].double().T)
        assert bool((dots.abs() >= 2 ** 21).any())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["pos_i8_cosine", "pos_i8_euclidean",
                                  "pos_i4_cosine"])
@pytest.mark.parametrize("nq", [7, 130])
def test_pos_kernel_clamped_keys(dev, kind, nq):
    """B3 with a g that drives scores into the +-2e9 clamp: bit-identical."""
    inp = _int_inputs(dev, nq, 128, 3, nq)
    kern, ref, args = _slice_case(kind, inp, 3, clamp=True)
    want = ref(*args)
    assert int((want >> 10 == (2_000_000_000 >> 10)).sum()) > 0
    torch.testing.assert_close(kern(*args), want, rtol=0, atol=0)


def _tile_case(kind, inp, n_tiles, t, cell_cap=128, metric="cosine"):
    """(wrapper, plain version, arguments) of a masked extraction over
    ``inp``: B4 on int8 or packed int4 codes, or B6 (``cell``)."""
    x, q, valid, codes, scales, norms = inp
    if kind == "cell":
        packed, a = _residual_args(inp, metric, cell_cap, n_tiles=n_tiles)
        return ft.cell_scan, ft.cell_scan_ref, (
            packed, a["q_in"], a["qmult"], a["rowmult"], a["rowbias"],
            a["qmult2"], a["rowmult2"], a["table"], n_tiles, t, cell_cap)
    c, s = _pack4(x) if kind == "i4" else (codes, scales)
    q_in, qmult, rowmult, rowbias, _ = ft._affine_factors(metric, s, norms,
                                                          valid, q)
    return ft.fused_scan, ft.fused_scan_ref, (c, q_in, qmult, rowmult, rowbias,
                                              n_tiles, t)


def _check_tile(kern, ref, args):
    ft.reset_launches()
    vk, rk = kern(*args)
    assert kern.launches == 1
    vr, rr = ref(*args)
    torch.testing.assert_close(rk, rr, rtol=0, atol=0)
    torch.testing.assert_close(vk, vr, rtol=0, atol=0)


@pytest.mark.parametrize("t", [2, 4, 8])
@pytest.mark.parametrize("w", [128, 256, 384, 768])
@pytest.mark.parametrize("nq", [1, 7, 17, 130, 1024])
@pytest.mark.parametrize("kind", ["i8", "i4"])
def test_fused_kernel_tensor_core_edges(dev, kind, nq, w, t):
    """B4 on int8 and packed int4 codes over 2 tiles at ragged query counts
    and rows of 1 to 6 k stages, each row repeated three times (values tie
    within a tile, broken by the lane) and, int8, every other row +-127
    (dots past 2^22 from W 384): rows and values bit-identical with the
    plain version, order included."""
    inp = _int_inputs(dev, nq, w, 2, 7 * nq + w, dup=True,
                      extreme=kind == "i8")
    _check_tile(*_tile_case(kind, inp, 2, t, metric="euclidean" if nq % 2
                            else "cosine"))


@pytest.mark.parametrize("t", [2, 4, 8])
@pytest.mark.parametrize("cell_cap", [1, 64, 128, 512])
@pytest.mark.parametrize("nq", [1, 7, 17, 130, 1024])
def test_cell_kernel_tensor_core_edges(dev, nq, cell_cap, t):
    """B6 at cell_cap 1 (64 cells a 64-row stage: the largest table blocks),
    64, 128 and 512, ragged query counts, duplicated rows: bit-identical."""
    inp = _int_inputs(dev, nq, 128, 2, nq + cell_cap + t, dup=True)
    _check_tile(*_tile_case("cell", inp, 2, t, cell_cap))


@pytest.mark.parametrize("w", [4096, 4224])
@pytest.mark.parametrize("kind", ["pos_i4_cosine", "pos_i4_euclidean", "i4",
                                  "cell"])
def test_int4_kernels_at_the_conversion_limit(dev, kind, w):
    """Packed int4 rows on both sides of the conversion limit (dots within
    8 * 128 * 4096 = 2^22 take the mantissa add, W 4224 the conversion):
    B3, B4 and B6 bit-identical with the plain versions."""
    inp = _int_inputs(dev, 130, w, 1, w)
    if kind.startswith("pos"):
        kern, ref, args = _slice_case(kind, inp, 1)
        torch.testing.assert_close(kern(*args), ref(*args), rtol=0, atol=0)
    else:
        _check_tile(*_tile_case(kind, inp, 1, 8))


@pytest.mark.parametrize("run", [3, 7])
@pytest.mark.parametrize("kind", SLICE_KINDS + ["i8", "i4", "cell"])
def test_tensor_core_kernels_ragged_run(dev, monkeypatch, kind, run):
    """Blocks of ``run`` segments where the segment count (20 slices, 5
    tiles) is no multiple of the run, rows of 5 k stages (the query streams
    through the copy ring): bit-identical with the plain versions."""
    real = ft.mma_scan_layout
    monkeypatch.setattr(ft, "mma_scan_layout", lambda *a: {**real(*a), "run": run})
    inp = _int_inputs(dev, 200, 640, 5, 13 + run)
    if kind in SLICE_KINDS:
        kern, ref, args = _slice_case(kind, inp, 5)
        torch.testing.assert_close(kern(*args), ref(*args), rtol=0, atol=0)
    else:
        _check_tile(*_tile_case(kind, inp, 5, 4))


# ------------------------------------------- stores through the kernels


def _clustered(rng, n, d=100, centres=64, noise=0.35):
    c = rng.standard_normal((centres, d)).astype(np.float32)
    return (c[rng.integers(0, centres, n)]
            + noise * rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("pos", [False, True], ids=["B6", "B5"])
def test_int4r_store_through_kernels(dev, monkeypatch, pos):
    """An int4r store on the card: insert, delete and search go through the
    store's kernel dispatch (B6 below the pos gate, B5 above it), and agree
    with the same store's exact scan on the CPU."""
    from erlvectordb_tpu_torch.core.store import VectorStore

    if pos:
        monkeypatch.setattr(ft, "POS_MIN_TILES", 1)
    rng = np.random.default_rng(3)
    data = _clustered(rng, 20_000)
    st = VectorStore.from_matrix("r", data, dtype="int4r", device=dev)
    new = _clustered(np.random.default_rng(4), 300)
    st.insert_batch([f"n{i}" for i in range(300)], new)
    assert st.delete("17") and st.delete("n5")
    ft.reset_launches()
    qs = np.concatenate([data[:40], new[:40]])
    got = st.search_batch(qs, k=10)
    kern = ft.pos_residual_scan if pos else ft.cell_scan
    assert kern.launches >= 1
    cpu = VectorStore.from_state(st.export_state(), device=torch.device("cpu"))
    want = cpu.search_batch(qs, k=10)
    overlap = np.mean([len({h[0] for h in a} & {h[0] for h in b}) / 10
                       for a, b in zip(got, want)])
    assert overlap >= 0.95
    top1 = [h[0][0] for h in got]
    assert all(t == str(i) for i, t in enumerate(top1[:40]) if i != 17)
    assert "17" not in {h[0] for hits in got for h in hits}
    assert "n5" not in {h[0] for hits in got for h in hits}
    assert sum(t == f"n{i}" for i, t in enumerate(top1[40:])) >= 38


def test_int4_store_through_kernels(dev, monkeypatch):
    """An int4 store on the card through the masked (B4) and pos (B3) scans,
    against the same store on the CPU sent down the same path (the plain
    versions): the same rows, distances to 1e-4."""
    from erlvectordb_tpu_torch.core.store import VectorStore

    rng = np.random.default_rng(5)
    data = _clustered(rng, 20_000)
    st = VectorStore.from_matrix("i4", data, dtype="int4", device=dev)
    cpu = VectorStore.from_state(st.export_state(), device=torch.device("cpu"))
    real = ft.fused_topk_available
    for pos in (False, True):
        if pos:
            monkeypatch.setattr(ft, "POS_MIN_TILES", 1)
        ft.reset_launches()
        got = st.search_batch(data[:64], k=10)
        kern = ft.pos_scan if pos else ft.fused_scan
        assert kern.launches_by.get("int4", 0) >= 1
        monkeypatch.setattr(ft, "fused_topk_available",
                            lambda c, cap, m, d, k=10: real(
                                c, cap, m, torch.device("cuda"), k))
        want = cpu.search_batch(data[:64], k=10)
        monkeypatch.setattr(ft, "fused_topk_available", real)
        overlap = np.mean([len({h[0] for h in a} & {h[0] for h in b}) / 10
                           for a, b in zip(got, want)])
        assert overlap >= 0.99
        np.testing.assert_allclose([h[0][2] for h in got],
                                   [h[0][2] for h in want], rtol=1e-4,
                                   atol=1e-4)


# ------------------------------------------------ B7, multiprobe gather+dot


def _gather_case(dev, packed, k_cells, cap, w, b, nprobe, seed=0):
    """Random codes [K, cap, Wc], probe ids and bf16-exact queries."""
    rng = np.random.default_rng(seed)
    if packed:
        q4 = rng.integers(-7, 8, (k_cells * cap, w)).astype(np.int8)
        codes3 = _pack_int4(torch.from_numpy(q4)).reshape(k_cells, cap, w // 2)
    else:
        codes3 = torch.from_numpy(
            rng.integers(-127, 128, (k_cells, cap, w)).astype(np.int8))
    probe = torch.from_numpy(
        rng.integers(0, k_cells, (b, nprobe)).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((b, w)).astype(np.float32))
    q = q.to(torch.bfloat16).float()
    return codes3.to(dev), probe.to(dev), q.to(dev)


@pytest.mark.parametrize("packed,k_cells,cap,w,b,nprobe", [
    (False, 37, 13, 48, 45, 7),        # ragged: rows of 3 pieces, odd cap
    (True, 37, 13, 64, 45, 1),         # ragged packed, nprobe 1
    (False, 9, 40, 16, 3, 9),          # one 16-byte piece a row
    (True, 300, 128, 128, 64, 16),     # the int4r store's cells
    (False, 64, 512, 768, 16, 8),      # the cell-probe index's cells
], ids=["int8-ragged", "int4-ragged", "int8-narrow", "int4-cap128",
        "int8-cap512"])
def test_gather_dots_kernel_matches_plain(dev, packed, k_cells, cap, w, b,
                                          nprobe):
    """B7 against its plain version: within 1e-5 of sum |q| |c| (the f32
    sums are taken in another order than the plain version's float64)."""
    from erlvectordb_tpu_torch.ops import cell_probe as cp

    codes3, probe, q = _gather_case(dev, packed, k_cells, cap, w, b, nprobe)
    cp.reset_launches()
    kern = cp.gather_dots(codes3, probe, q)
    torch.cuda.synchronize()
    assert cp.gather_dots.launches_by == {"int4" if packed else "int8": 1}
    ref = cp.gather_dots_ref(codes3, probe, q)
    full = ft.unpack_int4(codes3) if packed else codes3
    mag = cp.gather_dots_ref(full.abs(), probe, q.abs())
    assert kern.shape == (b, nprobe, cap)
    assert torch.all((kern - ref).abs() <= 1e-5 * mag + 1e-30)


def test_gather_dots_wrapper_validates(dev):
    from erlvectordb_tpu_torch.ops import cell_probe as cp

    codes3, probe, q = _gather_case(dev, False, 8, 16, 32, 4, 2)
    with pytest.raises(ValueError):       # int64 probe ids
        cp.gather_dots(codes3, probe.long(), q)
    with pytest.raises(ValueError):       # query width off the rows
        cp.gather_dots(codes3, probe, q[:, :16].contiguous())
    with pytest.raises(ValueError):       # rows not a 16-byte multiple
        cp.gather_dots(codes3[:, :, :24].contiguous(), probe,
                       q[:, :24].contiguous())
    with pytest.raises(ValueError):       # f32 codes
        cp.gather_dots(codes3.float(), probe, q)


def _gather_err(codes3, probe, q, kern):
    """max |kernel - plain| / sum |q| |c| over the outputs (the plain
    version on the clamped ids)."""
    from erlvectordb_tpu_torch.ops import cell_probe as cp

    probe = probe.clamp(0, codes3.shape[0] - 1)
    ref = cp.gather_dots_ref(codes3, probe, q)
    mag = cp.gather_dots_ref(ft.unpack_int4(codes3).abs(), probe, q.abs())
    return float(((kern - ref).abs() / (mag + 1e-30)).max())


@pytest.mark.parametrize("b", [1, 3, 16, 1024])
@pytest.mark.parametrize("w", [32, 128, 768, 1536])
@pytest.mark.parametrize("cap", [1, 13, 128, 512])
def test_gather_dots_int4_mma_matches_plain(dev, cap, w, b):
    """B7-int4 (bf16 mma.sync on windows of pairs sorted by cell) within
    1e-5 of sum |q| |c| of the plain version: products are exact, only the
    order and rounding of the f32 sums differ."""
    from erlvectordb_tpu_torch.ops import cell_probe as cp

    nprobe = 8 if cap * w <= 128 * 768 else 2
    codes3, probe, q = _gather_case(dev, True, 61, cap, w, b, nprobe, seed=cap + w)
    cp.reset_launches()
    kern = cp.gather_dots(codes3, probe, q)
    torch.cuda.synchronize()
    assert cp.gather_dots.launches_by == {"int4": 1}
    assert kern.shape == (b, nprobe, cap)
    assert _gather_err(codes3, probe, q, kern) <= 1e-5


@pytest.mark.parametrize("b", [64, 1024])
@pytest.mark.parametrize("case", ["one-cell", "distinct", "clamped"])
def test_gather_dots_int4_duplication(dev, case, b):
    """Every query probing one cell (runs that fill whole windows and cross
    them), every pair its own cell, and ids past the table, clamped."""
    from erlvectordb_tpu_torch.ops import cell_probe as cp

    nprobe = 8
    k_cells = b * nprobe if case == "distinct" else 97
    codes3, probe, q = _gather_case(dev, True, k_cells, 128, 128, b, nprobe)
    if case == "one-cell":
        probe[:, 3] = 5
    elif case == "distinct":
        probe = torch.randperm(k_cells, generator=torch.Generator().manual_seed(0)
                               ).to(dev, torch.int32).reshape(b, nprobe)
    else:
        probe[:, ::3] += k_cells
        probe[:, 1] -= 2 * k_cells
    kern = cp.gather_dots(codes3, probe, q)
    torch.cuda.synchronize()
    assert _gather_err(codes3, probe, q, kern) <= 1e-5


@pytest.mark.parametrize("shape", [(1024, 64, 128, 128), (64, 64, 128, 768),
                                   (300, 16, 13, 1536)],
                         ids=["fmp", "w768", "cap13"])
def test_gather_dots_int4_same_for_every_window(dev, shape):
    """Each output's k sequence does not depend on its window or its column
    in the mma, so every plan the wrapper can pick (windows of 1 to
    B7_PIPELINE pairs in pair order, of B7_WINDOW sorted) and any other
    gives the same bits."""
    from erlvectordb_tpu_torch.ops import cell_probe as cp

    b, nprobe, cap, w = shape
    codes3, probe, q = _gather_case(dev, True, 200, cap, w, b, nprobe)
    outs = [cp.gather_dots(codes3, probe, q, plan=(s, sort, 1))
            for s, sort in ((1, False), (cp.B7_PIPELINE, False), (2, True),
                            (8, True), (17, True), (cp.B7_WINDOW, True))]
    outs.append(cp.gather_dots(codes3, probe, q))
    torch.cuda.synchronize()
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_gather_dots_int4_window_validates(dev):
    """Both layouts take a plan and refuse windows outside [1, B7_WINDOW]
    and splits outside [1, the row tiles of a cell]."""
    from erlvectordb_tpu_torch.ops import cell_probe as cp

    codes3, probe, q = _gather_case(dev, True, 8, 16, 64, 4, 2)
    for s in (0, cp.B7_WINDOW + 1):
        with pytest.raises(ValueError):
            cp.gather_dots(codes3, probe, q, plan=(s, True, 1))
    c8, p8, q8 = _gather_case(dev, False, 8, 300, 32, 4, 2)
    for plan in ((0, False, 1), (cp.B7_WINDOW + 1, True, 1), (1, False, 0),
                 (1, False, 4)):
        with pytest.raises(ValueError):
            cp.gather_dots(c8, p8, q8, plan=plan)
    want = cp.gather_dots(c8, p8, q8)
    for plan in ((1, False, 3), (3, True, 2), (cp.B7_WINDOW, True, 1)):
        assert torch.equal(cp.gather_dots(c8, p8, q8, plan=plan), want)


def _gather_err8(codes3, probe, q, kern):
    """max |kernel - plain| / sum |q| |c| over the outputs of int8 codes
    (the plain version on the clamped ids)."""
    from erlvectordb_tpu_torch.ops import cell_probe as cp

    probe = probe.clamp(0, codes3.shape[0] - 1)
    ref = cp.gather_dots_ref(codes3, probe, q)
    mag = cp.gather_dots_ref(codes3.abs(), probe, q.abs())
    return float(((kern - ref).abs() / (mag + 1e-30)).max())


@pytest.mark.parametrize("b", [1, 3, 16, 1024])
@pytest.mark.parametrize("w", [16, 128, 768, 1536])
@pytest.mark.parametrize("cap", [1, 13, 128, 512])
def test_gather_dots_int8_mma_matches_plain(dev, cap, w, b):
    """B7-int8 (bf16 mma.sync on the plan the wrapper picks) within 1e-5 of
    sum |q| |c| of the plain version: products are exact, only the order and
    rounding of the f32 sums differ."""
    from erlvectordb_tpu_torch.ops import cell_probe as cp

    nprobe = 8 if cap * w <= 128 * 768 else 2
    codes3, probe, q = _gather_case(dev, False, 61, cap, w, b, nprobe,
                                    seed=cap + w + 1)
    cp.reset_launches()
    kern = cp.gather_dots(codes3, probe, q)
    torch.cuda.synchronize()
    assert cp.gather_dots.launches_by == {"int8": 1}
    assert kern.shape == (b, nprobe, cap)
    assert _gather_err8(codes3, probe, q, kern) <= 1e-5


def test_gather_dots_int8_wide_rows(dev):
    """Rows of 12,800 codes: the query is staged a chunk of 128 at a time,
    so no shared-memory size bounds W."""
    from erlvectordb_tpu_torch.ops import cell_probe as cp

    codes3, probe, q = _gather_case(dev, False, 9, 40, 12_800, 5, 3, seed=5)
    kern = cp.gather_dots(codes3, probe, q)
    torch.cuda.synchronize()
    assert _gather_err8(codes3, probe, q, kern) <= 1e-5


@pytest.mark.parametrize("b", [64, 1024])
@pytest.mark.parametrize("case", ["one-cell", "distinct", "clamped"])
def test_gather_dots_int8_duplication(dev, case, b):
    """Every query probing one cell (runs that fill whole windows and cross
    them), every pair its own cell, and ids past the table, clamped; cells
    of 300 rows (three row tiles, the last ragged), each plan kind."""
    from erlvectordb_tpu_torch.ops import cell_probe as cp

    nprobe = 8
    k_cells = b * nprobe if case == "distinct" else 97
    codes3, probe, q = _gather_case(dev, False, k_cells, 300, 128, b, nprobe)
    if case == "one-cell":
        probe[:, 3] = 5
    elif case == "distinct":
        probe = torch.randperm(k_cells, generator=torch.Generator().manual_seed(0)
                               ).to(dev, torch.int32).reshape(b, nprobe)
    else:
        probe[:, ::3] += k_cells
        probe[:, 1] -= 2 * k_cells
    for plan in (None, (1, False, 3), (cp.B7_PIPELINE, False, 1),
                 (cp.B7_WINDOW, True, 2)):
        kern = cp.gather_dots(codes3, probe, q, plan=plan)
        torch.cuda.synchronize()
        assert _gather_err8(codes3, probe, q, kern) <= 1e-5


@pytest.mark.parametrize("shape", [(256, 64, 512, 768), (1024, 32, 128, 128),
                                   (8, 64, 512, 768), (300, 16, 13, 1536)],
                         ids=["i", "q", "ep", "cap13"])
def test_gather_dots_int8_same_for_every_plan(dev, shape):
    """Each output's k sequence does not depend on its window, its column
    in the mma or the block its row tile went to: every plan gives the same
    bits, and so does a second call."""
    from erlvectordb_tpu_torch.ops import cell_probe as cp

    b, nprobe, cap, w = shape
    codes3, probe, q = _gather_case(dev, False, 600, cap, w, b, nprobe)
    tiles = -(-cap // 128)
    plans = [(1, False, 1), (1, False, tiles), (cp.B7_PIPELINE, False, 1),
             (2, True, 1), (8, True, tiles), (17, True, 1),
             (cp.B7_WINDOW, True, tiles), None]
    outs = [cp.gather_dots(codes3, probe, q, plan=p) for p in plans]
    outs.append(cp.gather_dots(codes3, probe, q))
    torch.cuda.synchronize()
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    assert _gather_err8(codes3, probe, q, outs[0]) <= 1e-5


def test_fixed_order_segment_sums_on_the_card(dev):
    """The build's segment sums on CUDA: equal to a float64 sum, and the
    same bits from call to call (index_add_'s float atomics are not)."""
    from erlvectordb_tpu_torch.ops.kmeans import segment_sums_

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((300_000, 96)).astype(np.float32)
                         ).to(dev)
    seg = torch.from_numpy(rng.integers(0, 700, 300_000)).to(dev)
    runs = []
    for _ in range(3):
        sums = torch.zeros((700, 96), dtype=torch.float64, device=dev)
        counts = torch.zeros((700,), device=dev)
        segment_sums_(sums, counts, seg, x)
        runs.append((sums, counts))
    for sums, counts in runs[1:]:
        assert torch.equal(sums, runs[0][0]) and torch.equal(counts, runs[0][1])
    want = torch.zeros((700, 96), dtype=torch.float64).index_add_(
        0, seg.cpu(), x.cpu().double())
    assert torch.allclose(runs[0][0].cpu(), want, rtol=1e-12, atol=1e-9)
    assert torch.equal(runs[0][1].cpu(),
                       torch.bincount(seg.cpu(), minlength=700).float())


@pytest.mark.parametrize("bits", [8, 4])
def test_streaming_build_is_deterministic_on_the_card(dev, bits):
    """Two build_cells_streaming builds of one seeded stream on the card
    give the same codes, scales, centroids and slot -> row map."""
    from erlvectordb_tpu_torch.ops.cell_build import build_cells_streaming

    data = _clustered(np.random.default_rng(12), 262_144, d=128, centres=256)
    chunks = lambda: (data[i:i + 65_536] for i in range(0, len(data), 65_536))
    builds = [build_cells_streaming(
        chunks(), n=len(data), dim=128, cell_rows=96, cell_cap=128,
        residual_bits=bits, train_rows=65_536, refits=2, spill_mult=1.2,
        device=dev) for _ in range(2)]
    a, b = builds
    for name in ("codes", "scales", "centroids", "perm", "norms", "valid"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert (a.counts == b.counts).all()


def test_int4r_store_multiprobe_through_kernel(dev):
    """nprobe searches of an int4r store on the card launch B7 (packed) and
    agree with the same state searched on the CPU by the plain version."""
    from erlvectordb_tpu_torch.core.store import VectorStore
    from erlvectordb_tpu_torch.ops import cell_probe as cp

    data = _clustered(np.random.default_rng(7), 20_000)
    st = VectorStore.from_matrix("mp", data, dtype="int4r", device=dev)
    cpu = VectorStore.from_state(st.export_state(), device=torch.device("cpu"))
    qs = np.concatenate([data[:32], _clustered(np.random.default_rng(8), 32)])
    for nprobe in (1, 8, 64):
        cp.reset_launches()
        got = st.search_batch(qs, k=10, nprobe=nprobe)
        assert cp.gather_dots.launches_by.get("int4", 0) >= 1
        want = cpu.search_batch(qs, k=10, nprobe=nprobe)
        # one probed cell may hold fewer than k rows: compare hit counts,
        # then ids entry by entry
        assert [len(x) for x in got] == [len(y) for y in want]
        same = np.mean([a[0] == b[0] for x, y in zip(got, want)
                        for a, b in zip(x, y)])
        assert same >= 0.99
        np.testing.assert_allclose([h[0][2] for h in got],
                                   [h[0][2] for h in want], rtol=1e-5,
                                   atol=1e-5)
    top1 = [h[0][0] for h in st.search_batch(data[:32], k=1, nprobe=8)]
    assert top1 == [str(i) for i in range(32)]


def test_cellprobe_index_through_kernel(dev):
    """A CellProbeIndex built on the card searches through B7 (int8) and
    agrees with its arrays searched on the CPU."""
    from erlvectordb_tpu_torch.core.cell_probe import CellProbeIndex
    from erlvectordb_tpu_torch.ops import cell_probe as cp

    data = _clustered(np.random.default_rng(9), 20_000, d=96)
    chunks = [data[i:i + 4096] for i in range(0, len(data), 4096)]
    idx = CellProbeIndex.build_streaming(
        iter(chunks), n=len(data), dim=96, cell_rows=48, cell_cap=64,
        spill_mult=1.3, device=dev)
    assert idx.spilled
    cpu = CellProbeIndex.from_arrays(idx.to_arrays(), device="cpu")
    qs = data[::500]
    cp.reset_launches()
    d_k, r_k = idx.search(qs, k=10, nprobe=16)
    assert cp.gather_dots.launches_by.get("int8", 0) >= 1
    d_c, r_c = cpu.search(qs, k=10, nprobe=16)
    assert np.mean(r_k == r_c) >= 0.99
    np.testing.assert_allclose(d_k[:, 0], d_c[:, 0], rtol=1e-5, atol=1e-5)
    assert (r_k[:, 0] == np.arange(0, len(data), 500)).all()


# ----------------------------------------------------------- B8, B9, B10


def _adc_case(dev, k=256, n_tiles=3, b=45, d=64, seed=11):
    """Random PQ codes over n_tiles 1024-row tiles (plus a ragged tail of
    rows the scans never reach), int8 rerank rows and an int8 LUT."""
    rng = np.random.default_rng(seed)
    n = n_tiles * 1024 + 100
    codes = rng.integers(0, k, (n, 8)).astype(np.uint8)
    codes[5:40] = codes[4]           # ties inside the first tile
    x = rng.standard_normal((n, d)).astype(np.float32)
    absmax = np.abs(x).max(axis=1)
    scales = (absmax / 127.0).astype(np.float32)
    i8 = np.clip(np.round(x / scales[:, None]), -127, 127).astype(np.int8)
    n2 = (scales.astype(np.float64) ** 2
          * (i8.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    lut_f = rng.standard_normal((b, 8 * k)).astype(np.float32) ** 2
    lut_q = rng.integers(0, 128, (b, 8 * k)).astype(np.int8)
    t = lambda a: torch.from_numpy(a).to(dev)
    return dict(codes=t(codes), i8=t(i8), scales=t(scales), n2=t(n2), q=t(q),
                lut_f=t(lut_f), lut_q=t(lut_q), n_tiles=n_tiles)


def _on_cpu(*ts):
    return [x.cpu() for x in ts]


@pytest.mark.parametrize("k", [64, 256])
@pytest.mark.parametrize("t", [2, 4, 8])
def test_adc_pallas_scan_matches_plain(dev, k, t):
    """B10: the int8 LUT gives the plain version's picks and values bit
    for bit (integer sums).  The bf16 LUT gives, bit for bit, those of the
    kernel's order of the f32 sums (adc_bf16_model, on the CPU), and
    agrees with the plain version (subspace order, on the CPU) within the
    bound of that reordering (adc_pallas.bf16_agreement)."""
    from erlvectordb_tpu_torch.ops import adc_pallas as ap

    c = _adc_case(dev, k=k)
    for lut, variant in ((c["lut_q"], "int8"), (c["lut_f"], "bf16")):
        ap.reset_launches()
        vk, rk = ap.adc_pallas_scan(c["codes"], lut, n_tiles=c["n_tiles"],
                                    t_per_tile=t)
        torch.cuda.synchronize()
        assert ap.adc_pallas_scan.launches_by == {variant: 1}
        codes_c, lut_c = _on_cpu(c["codes"], lut)
        vr, rr = ap.adc_pallas_scan(codes_c, lut_c, n_tiles=c["n_tiles"],
                                    t_per_tile=t)
        if variant == "bf16":
            agree = ap.bf16_agreement(vk.cpu(), rk.cpu(), codes_c, lut_c,
                                      c["n_tiles"], t, ref=(vr, rr))
            assert agree["bad_values"] == 0 and agree["bad_picks"] == 0, agree
            vr, rr = ap.adc_bf16_model(codes_c, lut_c, c["n_tiles"], t)
        np.testing.assert_array_equal(rk.cpu().numpy(), rr.numpy())
        np.testing.assert_array_equal(vk.cpu().numpy(), vr.numpy())


@pytest.mark.parametrize("scan", ["exact", "pos"])
def test_adc_rerank_scans_match_plain(dev, scan):
    """B9 and B8: the same picks as the plain version (B8 ties to the
    higher row), reranked values within 1e-5 of the magnitude of their
    terms (|q|^2 + 2|q.x| + |x|^2; the kernel sums q.x in another order)."""
    from erlvectordb_tpu_torch.ops import adc_pallas as ap

    c = _adc_case(dev)
    args = (c["codes"], c["lut_q"], c["q"], c["i8"], c["scales"], c["n2"])
    ap.reset_launches()
    if scan == "exact":
        vk, rk = ap.adc_exact_scan(*args, c["n_tiles"], 4)
        vr, rr = ap.adc_exact_scan(*_on_cpu(*args), c["n_tiles"], 4)
        assert ap.adc_exact_scan.launches == 1
    else:
        vk, rk = ap.adc_pos_scan(*args, c["n_tiles"])
        vr, rr = ap.adc_pos_scan(*_on_cpu(*args), c["n_tiles"])
        assert ap.adc_pos_scan.launches == 1
        assert (rr.numpy()[:, 0] >= 0).all()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(rk.cpu().numpy(), rr.numpy())
    q = c["q"].cpu()
    rows = rr.long()
    x = c["i8"].cpu()[rows].float() * c["scales"].cpu()[rows][:, :, None]
    mag = ((q * q).sum(1, keepdim=True) + 2 * (q[:, None, :] * x).sum(-1).abs()
           + c["n2"].cpu()[rows])
    assert ((vk.cpu() - vr).abs() <= 1e-5 * mag).all()


def test_adc_searches_on_the_card_match_the_cpu(dev):
    """The three searches end to end on the card (B8, B9, B10-int8) against
    the same inputs on the CPU: the same rows on >= 99% of entries (equal
    LUTs give equal picks; a rerank near-tie may swap neighbours)."""
    from erlvectordb_tpu_torch.ops import adc_pallas as ap
    from erlvectordb_tpu_torch.quant.pq import PQCodebook

    rng = np.random.default_rng(4)
    n, d = 8192 + 3000, 64
    data = (rng.standard_normal((n, 8)) @ rng.standard_normal((8, d))
            ).astype(np.float32)
    cb = PQCodebook.fit(data, m=8, k=256, iters=6, device=dev)
    codes = cb.encode(data)
    pad = (-n) % 8192
    absmax = np.abs(data).max(axis=1)
    scales = (absmax / 127.0).astype(np.float32)
    i8 = np.clip(np.round(data / scales[:, None]), -127, 127).astype(np.int8)
    n2 = (scales.astype(np.float64) ** 2
          * (i8.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)
    codes_p = torch.nn.functional.pad(codes, (0, 0, 0, pad))
    i8_p = t(np.pad(i8, ((0, pad), (0, 0))))
    sc_p = t(np.pad(scales, (0, pad), constant_values=1.0))
    n2_p = t(np.pad(n2, (0, pad)))
    q = t(data[:37] + 0.1)
    nt = ap.adc_n_tiles(n)
    books = cb.codebooks
    runs = {
        "pos": lambda *a: ap.adc_search_exact_pos(*a[:6], n, k=10, n_tiles=nt),
        "exact": lambda *a: ap.adc_search_exact_fused(*a[:6], n, k=10,
                                                      n_tiles=nt),
        "fused": lambda *a: ap.adc_search_fused(a[0], a[1], a[2], a[3], a[5],
                                                n, k=10, c=256, n_tiles=nt),
    }
    for name, fn in runs.items():
        ap.reset_launches()
        dk, rk = fn(codes_p, books, i8_p, sc_p, n2_p, q)
        torch.cuda.synchronize()
        assert sum(k.launches for k in ap.KERNELS) == 1
        dc, rc = fn(*_on_cpu(codes_p, books, i8_p, sc_p, n2_p, q))
        assert (rk.cpu().numpy() == rc.numpy()).mean() >= 0.99, name
        assert (rk.cpu().numpy() < n).all()
        assert (rk.cpu().numpy()[:, 0] == np.arange(37)).mean() >= 0.9
        # squared distances within 1e-5 of (|q| + |x|)^2 ~ 4|q|^2: the card
        # and the CPU sum |q|^2 - 2 q.x + |x|^2 in other orders
        qsq = (q.cpu() ** 2).sum(1).numpy()
        err = np.abs(dk.cpu().numpy()[:, 0] ** 2 - dc.numpy()[:, 0] ** 2)
        assert (err <= 4e-5 * qsq).all(), (name, err.max())


def test_adc_scan_wrappers_refuse_bad_input(dev):
    from erlvectordb_tpu_torch.ops import adc_pallas as ap

    c = _adc_case(dev)
    with pytest.raises(ValueError):       # codes short of the tiles
        ap.adc_pallas_scan(c["codes"], c["lut_q"], n_tiles=9)
    with pytest.raises(ValueError):       # M not a multiple of 4
        ap.adc_pallas_scan(c["codes"][:, :6].contiguous(),
                           c["lut_q"][:, :6 * 256].contiguous(), n_tiles=3)
    with pytest.raises(ValueError):       # f32 LUT to a rerank scan
        ap.adc_exact_scan(c["codes"], c["lut_f"], c["q"], c["i8"],
                          c["scales"], c["n2"], 3, 4)
    with pytest.raises(ValueError):       # a CPU LUT beside CUDA codes
        ap.adc_pallas_scan(c["codes"], c["lut_q"].cpu(), n_tiles=3)


# ------------------------- B4-f32 on the register-tiled mainloop of B3-f32


def _f32_tile_case(dev, nq, w, n_tiles, seed, metric="cosine"):
    """f32 rows (every row repeated three times: ties within a tile, broken
    by the lane) and the masked extraction's factors."""
    x, q, valid, _, _, norms = _edge_inputs(dev, nq, w, n_tiles, seed, dup=True)
    q_in, qmult, rowmult, rowbias, _ = ft._affine_factors(metric, None, norms,
                                                          valid, q)
    return x, q_in, qmult, rowmult, rowbias


def _check_f32_tile(kern, ref):
    """The f32 bar: rows identical on >= 99.9% of entries (the rest
    near-ties whose keys straddle a step, the kernel's dots summed in
    another order than cuBLAS's), vals to rtol 2.5e-4 where rows agree."""
    (vk, rk), (vr, rr) = kern, ref
    same = rk == rr
    assert int((~same).sum()) <= 1e-3 * same.numel()
    torch.testing.assert_close(vk[same], vr[same], rtol=2.5e-4, atol=0)


@pytest.mark.parametrize("t", [2, 4, 8])
@pytest.mark.parametrize("w", [128, 384, 768])
@pytest.mark.parametrize("n_tiles", [1, 5, 7])
@pytest.mark.parametrize("nq", [1, 16, 129, 1024])
def test_fused_f32_kernel_edges(dev, nq, n_tiles, w, t):
    """B4-f32 at 1, 16 (one narrow micro-tile), 129 (a ragged second query
    tile) and 1024 queries, over 1, 5 and 7 tiles (pieces a tile from the
    launch layout, waves that do not fill the card) and rows of 2, 6 and
    12 k chunks, with duplicated rows: against the plain version; then the
    first 3 queries alone give their rows of the full batch bit for bit
    (each dot is one fmaf chain over k, whatever block it lands in)."""
    args = _f32_tile_case(dev, nq, w, n_tiles, nq + w + t,
                          "euclidean" if nq % 2 else "cosine")
    x, q_in, qmult, rowmult, rowbias = args
    ft.reset_launches()
    vk, rk = ft.fused_scan(*args, n_tiles, t)
    assert ft.fused_scan.launches_by == {"f32": 1}
    _check_f32_tile((vk, rk), ft.fused_scan_ref(*args, n_tiles, t))
    v3, r3 = ft.fused_scan(x, q_in[:3].contiguous(), qmult[:3], rowmult,
                           rowbias, n_tiles, t)
    torch.testing.assert_close(r3, rk[:3], rtol=0, atol=0)
    torch.testing.assert_close(v3, vk[:3], rtol=0, atol=0)


@pytest.mark.parametrize("split", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("nq", [7, 200])
def test_fused_f32_kernel_every_split(dev, monkeypatch, nq, split):
    """Every split of a tile across blocks (pieces of 4096 down to 256 rows,
    merged by the second launch) gives the same rows and vals as one piece
    a tile, bit for bit, and meets the f32 bar against the plain version."""
    args = _f32_tile_case(dev, nq, 256, 3, 31 + nq)
    real = ft.f32_tile_layout
    whole = ft.fused_scan(*args, 3, 8)
    monkeypatch.setattr(ft, "f32_tile_layout", lambda *a: {
        **real(*a), "split": split,
        "part": a[0] * a[1] * split * a[2] if split > 1 else 0})
    got = ft.fused_scan(*args, 3, 8)
    for a, b in zip(got, whole):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _check_f32_tile(got, ft.fused_scan_ref(*args, 3, 8))


def test_fused_f32_wrapper_refuses_other_widths(dev):
    """Rows that are no multiple of 128 floats are refused with an error,
    not scanned."""
    x, q_in, qmult, rowmult, rowbias = _f32_tile_case(dev, 5, 256, 1, 3)
    with pytest.raises(ValueError):
        ft.fused_scan(x[:, :200].contiguous(), q_in[:, :200].contiguous(),
                      qmult, rowmult, rowbias, 1, 4)


# ------------------------- B8-B10 on the packed, bank-interleaved LUT


def _adc_dup_case(dev, b, m, k, seed):
    """Random PQ codes over 3 tiles with runs of duplicated codes (inside a
    warp's rows, across the boundary of two warps' rows and across two
    tiles), int8 rerank rows of 64 dims, an int8 LUT of -128..127."""
    rng = np.random.default_rng(seed)
    n = 3 * 1024 + 100
    codes = rng.integers(0, k, (n, m)).astype(np.uint8)
    codes[5:40] = codes[4]
    codes[50:140] = codes[49]
    codes[1000:1100] = codes[999]
    x = rng.standard_normal((n, 64)).astype(np.float32)
    scales = (np.abs(x).max(axis=1) / 127.0).astype(np.float32)
    i8 = np.clip(np.round(x / scales[:, None]), -127, 127).astype(np.int8)
    n2 = (scales.astype(np.float64) ** 2
          * (i8.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    q = rng.standard_normal((b, 64)).astype(np.float32)
    lut = rng.integers(-128, 128, (b, m * k)).astype(np.int8)
    t = lambda a: torch.from_numpy(a).to(dev)
    return t(codes), t(lut), t(q), t(i8), t(scales), t(n2)


def _check_adc(kern, ref, rerank, q, i8, scales, n2):
    """Rows identical; B10's values identical, B8/B9's reranked values
    within 1e-5 of the magnitude of their terms (the bar of
    test_adc_rerank_scans_match_plain)."""
    (vk, rk), (vr, rr) = kern, ref
    np.testing.assert_array_equal(rk.cpu().numpy(), rr.cpu().numpy())
    if not rerank:
        np.testing.assert_array_equal(vk.cpu().numpy(), vr.cpu().numpy())
        return
    rows = rr.long()
    xs = i8[rows].float() * scales[rows][:, :, None]
    mag = ((q * q).sum(1, keepdim=True) + 2 * (q[:, None, :] * xs).sum(-1).abs()
           + n2[rows])
    assert ((vk - vr).abs() <= 1e-5 * mag).all()


@pytest.mark.parametrize("t", [1, 2, 4, 8, 13, 32])
@pytest.mark.parametrize("k", [16, 256])
@pytest.mark.parametrize("m", [4, 8, 16])
@pytest.mark.parametrize("b", [1, 9, 513])
@pytest.mark.parametrize("scan", ["pallas", "exact"])
def test_adc_packed_kernels_match_plain(dev, scan, b, m, k, t):
    """B10-int8 and B9 on the packed LUT at 1, 9 and 513 queries (the
    layout's 8-, 4- and 2-phase warps), M 4, 8, 16, K 16 and 256, every
    list depth (T 1 to 32), ties inside a warp's rows, across warps and
    across tiles: the plain version's picks, bit for bit."""
    from erlvectordb_tpu_torch.ops import adc_pallas as ap

    codes, lut, q, i8, sc, n2 = _adc_dup_case(dev, b, m, k, b + m + k + t)
    ap.reset_launches()
    if scan == "pallas":
        kern = ap.adc_pallas_scan(codes, lut, n_tiles=3, t_per_tile=t)
        ref = ap.adc_pallas_scan_ref(codes, lut, 3, t)
    else:
        kern = ap.adc_exact_scan(codes, lut, q, i8, sc, n2, 3, t)
        ref = ap.adc_exact_scan_ref(codes, lut, q, i8, sc, n2, 3, t)
    torch.cuda.synchronize()
    assert sum(f.launches for f in ap.KERNELS) == 1
    _check_adc(kern, ref, scan == "exact", q, i8, sc, n2)


@pytest.mark.parametrize("k", [16, 256])
@pytest.mark.parametrize("m", [4, 8, 16])
@pytest.mark.parametrize("b", [1, 9, 513])
def test_adc_pos_packed_kernel_matches_plain(dev, b, m, k):
    """B8 (top-2 a slice, ties to the higher row) on the packed LUT: the
    plain version's picks bit for bit, reranked values to the rerank bar."""
    from erlvectordb_tpu_torch.ops import adc_pallas as ap

    codes, lut, q, i8, sc, n2 = _adc_dup_case(dev, b, m, k, 7 * b + m + k)
    kern = ap.adc_pos_scan(codes, lut, q, i8, sc, n2, 3)
    ref = ap.adc_pos_scan_ref(codes, lut, q, i8, sc, n2, 3)
    torch.cuda.synchronize()
    _check_adc(kern, ref, True, q, i8, sc, n2)


def test_adc_packed_kernel_at_the_largest_m(dev):
    """The largest M the int8 wrappers accept (at K 16, the layout's
    shared memory decides it; the 16-bit sums hold to M 256): B10-int8 and
    B8 with every entry at an extreme of the LUT's range, against the plain
    versions, and one M more is refused."""
    from erlvectordb_tpu_torch.ops import adc_pallas as ap

    def fits(m):
        try:
            ap.adc_layout(9, m, 16, 2)
            return True
        except ValueError:
            return False

    m = max(x for x in range(4, ap.ADC_MAX_M + 1, 4) if fits(x))
    codes, lut, q, i8, sc, n2 = _adc_dup_case(dev, 9, m, 16, m)
    lut = torch.where(lut >= 0, 127, -128).to(torch.int8)
    _check_adc(ap.adc_pallas_scan(codes, lut, n_tiles=3, t_per_tile=2),
               ap.adc_pallas_scan_ref(codes, lut, 3, 2), False, q, i8, sc, n2)
    _check_adc(ap.adc_pos_scan(codes, lut, q, i8, sc, n2, 3),
               ap.adc_pos_scan_ref(codes, lut, q, i8, sc, n2, 3), True, q, i8,
               sc, n2)
    big = torch.zeros((9, (m + 4) * 16), dtype=torch.int8, device=dev)
    wide = torch.zeros((codes.shape[0], m + 4), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        ap.adc_pallas_scan(wide, big, n_tiles=3, t_per_tile=2)


# --------------------- B10-bf16 on the packed two-queries-a-word LUT


def _bf16_lut(dev, b, m, k, seed):
    """An f32 LUT that is not bf16-exact, every 7th entry 0.5 (equal
    distances from distinct codes besides those of duplicated rows), some
    entries -0 and some negative."""
    rng = np.random.default_rng(seed)
    lut = (rng.standard_normal((b, m * k)) ** 2).astype(np.float32)
    lut[:, ::7] = 0.5
    lut[:, 5::11] = -0.0
    lut[:, 3::13] *= -1
    return torch.from_numpy(lut).to(dev)


def _check_bf16(kern, codes, lut, t):
    """B10-bf16 on 3 tiles: the picks and values of its arithmetic in plain
    PyTorch (adc_bf16_model: the kernel's order of the f32 sums) bit for
    bit, and the plain version's (sums in subspace order) within the bound
    of a reordered f32 sum: values within it, picks the plain ones or near
    ties (adc_pallas.bf16_agreement)."""
    from erlvectordb_tpu_torch.ops import adc_pallas as ap

    _check_adc(kern, ap.adc_bf16_model(codes, lut, 3, t), False, None, None,
               None, None)
    agree = ap.bf16_agreement(*kern, codes, lut, 3, t)
    assert agree["bad_values"] == 0 and agree["bad_picks"] == 0, agree


@pytest.mark.parametrize("t", [1, 2, 4, 8, 32])
@pytest.mark.parametrize("k", [64, 256])
@pytest.mark.parametrize("m", [4, 8, 12, 16])
@pytest.mark.parametrize("b", [1, 3, 8, 9, 16, 17, 33, 512])
def test_adc_bf16_kernel_matches_plain(dev, b, m, k, t):
    """B10-bf16 at 1-512 queries (the layout's 8-, 4- and 2-phase warps,
    S0 4 and 8), K 64 and 256, every list depth, ties from duplicated code
    rows inside a warp's rows, across warps and across tiles, in one
    launch: its order of sums bit for bit, the plain version within the
    bound of that order (_check_bf16)."""
    from erlvectordb_tpu_torch.ops import adc_pallas as ap

    codes = _adc_dup_case(dev, 1, m, k, b + m + k + t)[0]
    lut = _bf16_lut(dev, b, m, k, 3 * b + m + k + t)
    ap.reset_launches()
    kern = ap.adc_pallas_scan(codes, lut, n_tiles=3, t_per_tile=t)
    torch.cuda.synchronize()
    assert ap.adc_pallas_scan.launches_by == {"bf16": 1}
    _check_bf16(kern, codes, lut, t)


@pytest.mark.parametrize("t", [1, 4, 13, 32])
@pytest.mark.parametrize("m,k", [(36, 256), (44, 256), (220, 1), (24, 100)])
def test_adc_bf16_kernel_at_the_largest_shapes(dev, m, k, t):
    """The layouts past a full group of pairs or two code buffers: M 36 and
    44 at K 256 (S0 4; 4 or 2 of 8 pairs a phase at work; one tile buffer
    where two do not fit), M 220 at K 1 (one buffer), M 24 at K 100
    (S0 8: chains of 3 subspaces): as _check_bf16."""
    from erlvectordb_tpu_torch.ops import adc_pallas as ap

    codes = _adc_dup_case(dev, 1, m, k, m + k + t)[0]
    lut = _bf16_lut(dev, 37, m, k, m * k + t)
    _check_bf16(ap.adc_pallas_scan(codes, lut, n_tiles=3, t_per_tile=t),
                codes, lut, t)


# --------------------------------------------- the cell-probe build's passes


def _kpp_case(dev, n, d, kind, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((48, d))[rng.integers(0, 48, n)]
         + 0.2 * rng.standard_normal((n, d))).astype(np.float32)
    if kind == "dup":
        x = x[rng.integers(0, min(40, n), n)]
    if kind == "scaled":
        x *= rng.uniform(1e-3, 1e3, (n, 1)).astype(np.float32)
    return torch.from_numpy(x).to(dev)


def _kpp_rows(x, offset):
    """x's values in a contiguous tensor whose storage starts ``offset``
    floats into its allocation (off 16 bytes where offset % 4)."""
    n, d = x.shape
    buf = torch.empty(n * d + offset, dtype=x.dtype, device=x.device)
    out = buf[offset:].view(n, d)
    out.copy_(x)
    return out


@pytest.mark.parametrize("kind", ["plain", "dup", "scaled"])
@pytest.mark.parametrize("n,d,offset", [
    (20_000, 768, 0), (9_999, 130, 0), (5_000, 128, 0), (5_000, 127, 0),
    (5_000, 100, 0), (5_000, 24, 0), (777, 1, 0), (16, 768, 0),
    (10, 768, 0),       # fewer rows than a warp
    (3_000, 768, 1),    # rows off 16 bytes: scalar loads, the same sums
    (2_000, 9_000, 0),  # wider than any one pass of a lane
])
def test_kpp_update_kernel_is_the_whole_pass(dev, n, d, offset, kind):
    """kpp_update_ over 40 draws from the first seed's pass: mind2 and
    owners bit for bit those of the plain whole-sample pass on the card,
    reading fewer rows once the seeds spread."""
    from erlvectordb_tpu_torch.ops import index_build as ib

    x = _kpp_rows(_kpp_case(dev, n, d, kind, n + d), offset)
    cents = x[torch.from_numpy(np.random.default_rng(d).choice(
        n, min(n, 40), replace=False)).to(dev)].contiguous()
    state = []
    ib.reset_launches()
    for whole in (False, True):
        mind2 = torch.full((n,), float("inf"), device=dev)
        owner = torch.zeros(n, dtype=torch.int32, device=dev)
        scanned = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(cents.shape[0]):
            if whole:
                ib.kpp_update_ref_(x, cents, i, mind2, owner, scanned, False)
            else:
                ib.kpp_update_(x, cents, i, mind2, owner, scanned)
        state.append((mind2, owner, int(scanned)))
    assert ib.kpp_update_.launches_by == {"pruned": cents.shape[0]}
    assert torch.equal(state[0][0], state[1][0])
    assert torch.equal(state[0][1], state[1][1])
    assert state[0][2] <= state[1][2] == n * cents.shape[0]


def test_kpp_update_refuses_what_it_cannot_sum(dev):
    """On the card the update takes f32 contiguous rows and nothing else:
    no other path takes over."""
    from erlvectordb_tpu_torch.ops import index_build as ib

    x = _kpp_case(dev, 64, 32, "plain", 1)
    cents = x[:4].contiguous()
    mind2 = torch.full((64,), float("inf"), device=dev)
    owner = torch.zeros(64, dtype=torch.int32, device=dev)
    scanned = torch.zeros((), dtype=torch.int64, device=dev)
    for bad in (x.double(), x.t().contiguous().t(), x.half()):
        with pytest.raises(ValueError, match="kpp_update_"):
            ib.kpp_update_(bad, cents.to(bad.dtype), 1, mind2, owner,
                           scanned)


@pytest.mark.parametrize("n,k,d", [(6_000, 300, 768), (4_000, 250, 100),
                                   (3_000, 200, 24), (300, 300, 768),
                                   (12, 8, 768)])
def test_kpp_seeding_on_the_card_is_the_whole_pass_seeding(dev, n, k, d):
    """_kpp_init with the kernel gives the centroids of the seeding by
    plain whole-sample passes, from the same generator."""
    import erlvectordb_tpu_torch.ops.kmeans as km
    from erlvectordb_tpu_torch.ops import index_build as ib

    x = _kpp_case(dev, n, d, "plain", k + d)
    g_old = torch.Generator(device=dev)
    g_new = torch.Generator(device=dev)
    g_old.manual_seed(9)
    g_new.manual_seed(9)
    stats = {}
    got = km._kpp_init(x, g_new, k, stats)
    first = int(torch.randint(0, n, (1,), generator=g_old, device=dev))
    want = torch.zeros((k, d), device=dev)
    want[0] = x[first]
    mind2 = ib.row_d2(x, x[first])
    for i in range(1, k):
        w = torch.clamp(mind2, min=1e-20)
        p = w / w.sum()
        e = torch.empty_like(p).exponential_(1.0, generator=g_old)
        pick = x.index_select(0, torch.argmax(p / e, dim=0, keepdim=True))
        want[i:i + 1] = pick
        mind2 = torch.minimum(mind2, ib.row_d2(x, pick[0]))
    assert torch.equal(got, want)
    assert stats["kpp_rows_scanned"] <= stats["kpp_rows_total"] == (k - 1) * n


@pytest.mark.parametrize("d", [1, 3, 7, 8, 9, 24, 100, 127, 128, 129, 130,
                               256, 300, 768, 1000, 4096, 8192, 8193, 12287,
                               12288, 20000])
def test_pairwise_norms_kernel_is_numpys(dev, d):
    from erlvectordb_tpu_torch.ops import index_build as ib

    rng = np.random.default_rng(d)
    x = (rng.standard_normal((301, d))
         * rng.uniform(1e-3, 1e3, (301, 1))).astype(np.float32)
    x[3] = 0.0
    ib.reset_launches()
    got = ib.pairwise_norms(torch.from_numpy(x).to(dev)).cpu().numpy()
    assert ib.pairwise_norms.launches == 1
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.linalg.norm(x, axis=1).view(np.int32))


@pytest.mark.parametrize("d", [24, 100, 130, 768])
def test_encode_on_the_card_is_the_numpy_encode(dev, d, monkeypatch):
    """encode_cells on the card in chunks of 37 rows: codes, scales, norms,
    valid and row map of the numpy encode of the whole array, an all-zero
    row and a cell of zero residuals among them."""
    from erlvectordb_tpu_torch.ops import index_build as ib

    monkeypatch.setattr(ib, "_ENCODE_ELEMS", 37 * d)
    rng = np.random.default_rng(d)
    n, n_cells, cap = 900, 40, 32
    data = (rng.standard_normal((n, d))
            * rng.uniform(0.01, 30.0, (n, 1))).astype(np.float32)
    cents = data[rng.choice(n, n_cells, replace=False)] + np.float32(0.01)
    owner = np.repeat(np.arange(n_cells), cap)[rng.permutation(
        n_cells * cap)[:n]]
    data[owner == 2] = cents[2]
    data[5] = 0.0
    rows = rng.permutation(10 * n)[:n].astype(np.int64)
    t = lambda a: torch.from_numpy(a).to(dev)
    got = [a.cpu().numpy() for a in ib.encode_cells(
        t(data), t(rows), t(owner), t(cents), cap)]
    order = np.argsort(owner, kind="stable")
    oc = owner[order]
    dest = oc * cap + (np.arange(n) - np.searchsorted(oc, np.arange(n_cells))[oc])
    res = data[order] - cents[oc]
    absmax = np.abs(res).max(axis=1)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    codes = np.clip(np.round(res / scale[:, None]), -127, 127).astype(np.int8)
    recon = cents[oc] + codes.astype(np.float32) * scale[:, None]
    np.testing.assert_array_equal(got[0][dest], codes)
    np.testing.assert_array_equal(got[1][dest], scale)
    np.testing.assert_array_equal(got[2][dest], np.linalg.norm(recon, axis=1))
    np.testing.assert_array_equal(got[4][dest], rows[order])
    empty = np.setdiff1d(np.arange(n_cells * cap), dest)
    assert (got[4][empty] == -1).all() and not got[3][empty].any()
    assert got[3][dest].all() and (got[0][empty] == 0).all()
    assert (got[1][empty] == 1).all() and (got[2][empty] == 0).all()


def test_cell_probe_build_on_the_card_is_the_host_build(dev):
    """CellProbeIndex.build from a card tensor and from a numpy array give
    the same arrays."""
    from erlvectordb_tpu_torch.core.cell_probe import CellProbeIndex

    x = _kpp_case(dev, 6_000, 256, "plain", 4)
    rows = np.arange(6_000, dtype=np.int64) * 3
    kw = dict(cell_rows=24, cell_cap=32, iters=4, max_train=4_000, device=dev)
    a = CellProbeIndex.build(x, rows, **kw)
    b = CellProbeIndex.build(x.cpu().numpy(), rows, **kw)
    for name in ("centroids", "codes", "scales", "norms", "valid"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    np.testing.assert_array_equal(a.row_map, b.row_map)
    assert a.build_stats["kpp_rows_scanned"] < a.build_stats["kpp_rows_total"]
