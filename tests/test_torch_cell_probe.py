"""The port's multiprobe search (erlvectordb_tpu_torch/ops/cell_probe.py,
kernel B7's plain version) and CellProbeIndex (core/cell_probe.py) against
the JAX package's, on the CPU, plus the cases of tests/test_cell_probe.py
re-pointed at the port.

The JAX side runs as its own tests run it: ``_dma_gather_dots`` in Pallas
interpret mode, ``multiprobe_topk`` and the index through their CPU paths.
Builds draw random numbers (k-means seeding), which torch does not draw as
jax.random does, so search parity runs on JAX-built state carried across
with ``to_arrays`` -> ``from_arrays``; the port's own builds are held to the
re-pointed recall bars.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import erlvectordb_tpu.ops.cell_probe as jcp
import erlvectordb_tpu_torch.ops.cell_probe as tcp
from erlvectordb_tpu.core.cell_probe import CellProbeIndex as JIndex
from erlvectordb_tpu_torch.core.cell_probe import CellProbeIndex
from erlvectordb_tpu_torch.core.store import VectorStore

torch.set_num_threads(2)

CPU = "cpu"


def make_clustered(n, d, n_centers=32, noise=0.25, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    assign = rng.integers(0, n_centers, n)
    return (centers[assign]
            + noise * rng.standard_normal((n, d)).astype(np.float32))


def _pack(vals):
    nib = (vals & 0xF).astype(np.uint8)
    return (nib[..., 0::2] << 4) | nib[..., 1::2]


# ------------------------------------------------------------ B7 plain version


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("shape", [(16, 16, 128, 8, 4), (12, 8, 256, 5, 1),
                                   (7, 24, 128, 3, 7)],
                         ids=["k16-b8-np4", "np1", "ragged-b3"])
def test_gather_dots_ref_matches_jax_interpret(packed, shape):
    """gather_dots_ref against the Pallas kernel in interpret mode.  Bar:
    |got - want| <= 1e-5 * sum_w |q_w| |c_w| (f32 sums in two orders; the
    reference rounds its float64 sum once)."""
    k, cap, w, b, npr = shape
    rng = np.random.default_rng(sum(shape) + packed)
    vals = (rng.integers(-8, 8, (k, cap, w)) if packed
            else rng.integers(-127, 128, (k, cap, w))).astype(np.int8)
    codes = _pack(vals) if packed else vals
    probe = rng.integers(0, k, (b, npr)).astype(np.int32)
    q = rng.standard_normal((b, w)).astype(np.float32)
    want = np.asarray(jcp._dma_gather_dots(
        jnp.asarray(codes), jnp.asarray(probe), jnp.asarray(q), cell_cap=cap))
    got = tcp.gather_dots(torch.from_numpy(codes), torch.from_numpy(probe),
                          torch.from_numpy(q)).numpy()
    mag = np.einsum("bpcw,bw->bpc", np.abs(vals[probe]).astype(np.float64),
                    np.abs(q).astype(np.float64))
    assert got.shape == want.shape == (b, npr, cap)
    assert np.all(np.abs(got - want) <= 1e-5 * mag + 1e-30)
    # and against exact arithmetic
    exact = np.einsum("bpcw,bw->bpc", vals[probe].astype(np.float64),
                      q.astype(np.float64))
    assert np.all(np.abs(got - exact) <= 1e-6 * mag + 1e-30)


def test_gather_dots_ref_chunks_the_batch(monkeypatch):
    """The plain version works through the batch in query chunks (the
    gathered blocks of a whole batch would not fit at the index's shapes);
    chunked and whole give the same answer."""
    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(-127, 128, (9, 8, 128)).astype(np.int8))
    probe = torch.from_numpy(rng.integers(0, 9, (11, 3)).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((11, 128)).astype(np.float32))
    whole = tcp.gather_dots_ref(codes, probe, q)
    monkeypatch.setattr(tcp, "_REF_BUDGET", 8 * 3 * 8 * 128 * 2)  # 2 queries
    np.testing.assert_array_equal(tcp.gather_dots_ref(codes, probe, q).numpy(),
                                  whole.numpy())


def test_gather_dots_counts_no_launch_on_cpu():
    tcp.reset_launches()
    codes = torch.zeros((2, 8, 128), dtype=torch.int8)
    tcp.gather_dots(codes, torch.zeros((1, 1), dtype=torch.int32),
                    torch.zeros((1, 128)))
    assert tcp.gather_dots.launches == 0 and tcp.gather_dots.launches_by == {}


# ------------------------------------- B7-int4's k order and plan (the kernel)


def _nibble_pair(byte):
    """A packed byte as the kernel's bf16 pair: (high nibble, low nibble),
    signed, the high nibble in the register's low half (the lower k)."""
    return ((int(byte) >> 4) ^ 8) - 8, ((int(byte) & 15) ^ 8) - 8


@pytest.mark.parametrize("w", [32, 128, 768, 1536])
def test_b7_fragment_order_gives_the_plain_dot(w):
    """A model of mma.sync m16n8k16's bf16 fragments (the PTX ISA's thread
    mapping: a0/a1 rows g/g+8 at k 2t, 2t+1, a2/a3 at k 2t+8, 2t+9; b0/b1
    column g at the same k) filled as csrc/cell_probe.cu fills them: A from
    bytes 16t + 4c + 2s + j of the packed chunk, B from the 16 bytes at
    64c + 16t of the query row staged in ``b7_query_order``.  Summed over the
    k steps, the fragments give the plain dot exactly (integer inputs)."""
    rng = np.random.default_rng(w)
    vals = rng.integers(-8, 8, (16, w)).astype(np.int8)
    q = rng.integers(-50, 51, (8, w)).astype(np.float64)
    order = tcp.b7_query_order(w)
    assert len(order) % 128 == 0 and len(order) - w < 128
    assert sorted(order[order >= 0]) == list(range(w))
    staged = np.where(order >= 0, q[:, np.maximum(order, 0)], 0.0)
    nk = len(order) // 128
    chunks = np.zeros((16, nk * 64), np.uint8)
    chunks[:, :w // 2] = _pack(vals)
    acc = np.zeros((16, 8))
    for kc in range(nk):
        for ks in range(8):
            c, s = divmod(ks, 2)
            a = np.full((16, 16), np.nan)
            b = np.full((16, 8), np.nan)
            for lane in range(32):
                g, t = divmod(lane, 4)
                for j in (0, 1):
                    k = 2 * t + 8 * j
                    for row in (g, g + 8):
                        a[row, k:k + 2] = _nibble_pair(
                            chunks[row, kc * 64 + 16 * t + 4 * c + 2 * s + j])
                    pos = kc * 128 + 32 * c + 8 * t + 4 * s + 2 * j
                    b[k:k + 2, g] = staged[g, pos:pos + 2]
            assert not np.isnan(a).any() and not np.isnan(b).any()
            acc += a @ b
    np.testing.assert_array_equal(acc, vals.astype(np.float64) @ q.T)


def _bytes_bf16(word):
    """mma_scan.cuh's bytes_bf16 on one 32-bit word, by its bits: the four
    signed bytes as the values of the two bf16 pairs it forms (low byte the
    lower k)."""
    def bf16(bits):
        return float(np.array([bits << 16], np.uint32).view(np.float32)[0])
    out = []
    for i in range(4):
        byte = (int(word) >> (8 * i)) & 0xFF
        out.append(bf16(0x4300 | (byte & 0x7F)) + bf16(0xC300 | (byte & 0x80)))
    return out


def test_b7_int8_conversion_is_exact():
    """Every byte's bf16 pair sums to its signed value, and each summand is
    an exact bf16 (the fma.rn.bf16x2 that adds them does not round)."""
    words = np.arange(256, dtype=np.uint32) * 0x01010101
    for word in words:
        got = _bytes_bf16(word)
        want = np.array([int(word) & 0xFF] * 4, np.uint8).view(np.int8)
        assert got == [float(v) for v in want]


@pytest.mark.parametrize("w", [16, 128, 768, 1536])
def test_b7_int8_fragment_order_gives_the_plain_dot(w):
    """The int8 layout's k order in the model of mma.sync m16n8k16's bf16
    fragments: the tile stored as cp.async stores it (piece p of row r at
    slot p ^ 4 (r & 1)), A from word c % 4 of piece t + 4 (c // 4) (read
    back through the swizzle) converted by ``_bytes_bf16``, B from the 16
    bytes at 32t + 128 (c // 4) + 8 (c % 4) of the query row staged in
    ``b7_query_order(w, "int8")``.  Summed over the k steps, the fragments
    give the plain dot exactly (integer inputs, codes over all of -128..127)."""
    rng = np.random.default_rng(w + 1)
    vals = rng.integers(-128, 128, (16, w)).astype(np.int8)
    vals[0, :8] = [-128, 127, -1, 0, 1, -127, 64, -64]
    q = rng.integers(-50, 51, (8, w)).astype(np.float64)
    order = tcp.b7_query_order(w, "int8")
    assert len(order) % 128 == 0 and len(order) - w < 128
    assert sorted(order[order >= 0]) == list(range(w))
    staged = np.where(order >= 0, q[:, np.maximum(order, 0)], 0.0)
    nk = len(order) // 128
    rows = np.zeros((16, nk * 128), np.int8)
    rows[:, :w] = vals
    words = rows.view(np.uint8)
    acc = np.zeros((16, 8))
    for kc in range(nk):
        tile = np.zeros((16, 128), np.uint8)
        for r in range(16):
            for p in range(8):
                s = p ^ (4 * (r & 1))
                tile[r, 16 * s:16 * s + 16] = words[r, kc * 128 + 16 * p:
                                                    kc * 128 + 16 * p + 16]
        for c in range(8):
            a = np.full((16, 16), np.nan)
            b = np.full((16, 8), np.nan)
            for lane in range(32):
                g, t = divmod(lane, 4)
                for row in (g, g + 8):
                    s = 16 * ((t + 4 * (c // 4)) ^ (4 * (row & 1))) + 4 * (c % 4)
                    word = int(tile[row, s:s + 4].view(np.uint32)[0])
                    conv = _bytes_bf16(word)
                    for j in (0, 1):
                        a[row, 2 * t + 8 * j:2 * t + 8 * j + 2] = conv[2 * j:2 * j + 2]
                pos = kc * 128 + (32 * t + 128 * (c // 4) + 8 * (c % 4)) // 2
                for j in (0, 1):
                    b[2 * t + 8 * j:2 * t + 8 * j + 2, g] = staged[g, pos + 2 * j:
                                                                   pos + 2 * j + 2]
            assert not np.isnan(a).any() and not np.isnan(b).any()
            acc += a @ b
    np.testing.assert_array_equal(acc, vals.astype(np.float64) @ q.T)


def _emulate_b7_plan(codes3, probe, q, window, sort, split=1):
    """The kernel's plan in plain torch: b7_plan's pairs (sorted by cell, or
    in pair order) cut into windows of ``window``, each window walked as
    runs of equal (clamped) cells, each run's queries dotted with its cell,
    its 128-row tiles dealt to ``split`` blocks (block y: tiles y, y +
    split, ...).  Every output row is written exactly once.  Returns the
    output and the number of runs (cell reads)."""
    b, nprobe = probe.shape
    k_cells, cap, _ = codes3.shape
    cells, order = tcp.b7_plan(probe, sort)
    if order is None:
        order = torch.arange(b * nprobe)
    cells = cells.clamp(0, k_cells - 1)
    assert torch.all(cells[1:] >= cells[:-1]) or not sort
    out = torch.full((b * nprobe, cap), float("nan"))
    tiles = -(-cap // tcp.B7_TILE_ROWS)
    runs = 0
    for w0 in range(0, b * nprobe, window):
        w1 = min(b * nprobe, w0 + window)
        starts = [i for i in range(w0, w1) if i == w0 or cells[i] != cells[i - 1]]
        for r0, r1 in zip(starts, starts[1:] + [w1]):
            pairs = order[r0:r1]
            cell = torch.full((r1 - r0, 1), int(cells[r0]), dtype=torch.int32)
            dots = tcp.gather_dots_ref(codes3, cell, q[pairs // nprobe])[:, 0]
            for y in range(split):
                for tile in range(y, tiles, split):
                    rows = slice(tile * tcp.B7_TILE_ROWS,
                                 min(cap, (tile + 1) * tcp.B7_TILE_ROWS))
                    assert torch.isnan(out[pairs, rows]).all()
                    out[pairs, rows] = dots[:, rows]
            runs += 1
    assert not torch.isnan(out).any()
    return out.reshape(b, nprobe, cap), runs


def _plan_case(case, int8=False):
    rng = np.random.default_rng(len(case))
    k_cells, b, nprobe = 40, 13, 5
    if case == "run-across-windows":     # one cell in every query's list
        probe = rng.integers(0, k_cells, (b, nprobe))
        probe[:, 2] = 7
    elif case == "ragged":               # P = 35, no multiple of 8 or 32
        b, nprobe = 5, 7
        probe = rng.integers(0, k_cells, (b, nprobe))
    elif case == "same-cells":           # every query probes the same list
        probe = np.tile(rng.permutation(k_cells)[:nprobe], (b, 1))
    elif case == "distinct":             # every pair its own cell
        k_cells = b * nprobe
        probe = rng.permutation(k_cells).reshape(b, nprobe)
    else:                                # ids below 0 and past K, clamped
        probe = rng.integers(-4, k_cells + 4, (b, nprobe))
    if int8:    # cells of three row tiles, the last one ragged
        vals = rng.integers(-128, 128, (k_cells, 300, 48)).astype(np.int8)
        q = rng.integers(-20, 21, (b, 48)).astype(np.float32)
        return (torch.from_numpy(vals), torch.from_numpy(probe.astype(np.int32)),
                torch.from_numpy(q))
    vals = rng.integers(-8, 8, (k_cells, 3, 64)).astype(np.int8)
    q = rng.integers(-20, 21, (b, 64)).astype(np.float32)
    return (torch.from_numpy(_pack(vals)), torch.from_numpy(probe.astype(np.int32)),
            torch.from_numpy(q))


@pytest.mark.parametrize("window,sort", [(1, False), (8, False), (8, True),
                                         (32, True)],
                         ids=["s1", "s8-pair-order", "s8", "s32"])
@pytest.mark.parametrize("case", ["run-across-windows", "ragged", "same-cells",
                                  "distinct", "clamped"])
def test_b7_plan_emulation_matches_plain(case, window, sort):
    """Sorting the pairs, cutting windows and walking runs, as the kernel
    does, gives gather_dots_ref's output (on the clamped ids) exactly;
    sorted, with at most (distinct cells + windows) cell reads; in pair
    order, at most one a pair."""
    codes3, probe, q = _plan_case(case)
    got, runs = _emulate_b7_plan(codes3, probe, q, window, sort)
    clamped = probe.clamp(0, codes3.shape[0] - 1)
    assert torch.equal(got, tcp.gather_dots_ref(codes3, clamped, q))
    p = probe.numel()
    distinct = int(torch.unique(clamped).numel())
    assert runs <= distinct + -(-p // window) if sort else runs <= p
    if window == 1:
        assert runs == p
    if case == "same-cells" and window == 32:
        assert runs < p // 4


@pytest.mark.parametrize("plan", [(1, False, 1), (1, False, 3), (8, False, 2),
                                  (8, True, 1), (32, True, 3)],
                         ids=["s1", "s1-split3", "s8-pair-order-split2", "s8",
                              "s32-split3"])
@pytest.mark.parametrize("case", ["run-across-windows", "ragged", "same-cells",
                                  "distinct", "clamped"])
def test_b7_plan_emulation_matches_plain_int8(case, plan):
    """The same walk over int8 cells of 300 rows (three row tiles, the last
    ragged), with the row tiles split across blocks: gather_dots_ref's output
    exactly, each row written once, and sorted at most (distinct cells +
    windows) cell reads."""
    window, sort, split = plan
    codes3, probe, q = _plan_case(case, int8=True)
    got, runs = _emulate_b7_plan(codes3, probe, q, window, sort, split)
    clamped = probe.clamp(0, codes3.shape[0] - 1)
    assert torch.equal(got, tcp.gather_dots_ref(codes3, clamped, q))
    p = probe.numel()
    distinct = int(torch.unique(clamped).numel())
    assert runs <= distinct + -(-p // window) if sort else runs <= p


def test_b7_plan_from_the_pair_count():
    """One query: one pair a window, no sort; few pairs: windows in pair
    order, as few as fill B7_BLOCKS blocks; many: the widest sorted window.
    The int4r store's cells are one row tile: never split."""
    assert tcp.b7_plan_for(64, 1) == (1, False, 1)
    assert tcp.b7_plan_for(100_000, 1) == (1, False, 1)
    assert tcp.b7_plan_for(tcp.B7_BLOCKS, 8) == (1, False, 1)
    assert tcp.b7_plan_for(16 * 64, 16) == (2, False, 1)
    assert tcp.b7_plan_for(4 * tcp.B7_BLOCKS, 64) == (4, False, 1)
    assert tcp.b7_plan_for(tcp.B7_SORT_MIN_PAIRS - 1, 1024) == (tcp.B7_PIPELINE, False, 1)
    assert tcp.b7_plan_for(tcp.B7_SORT_MIN_PAIRS, 1024) == (tcp.B7_WINDOW, True, 1)
    assert tcp.b7_plan_for(1024 * 512, 1024) == (tcp.B7_WINDOW, True, 1)
    cells, order = tcp.b7_plan(torch.tensor([[3, 1], [1, 0]], dtype=torch.int32), True)
    assert cells.tolist() == [0, 1, 1, 3] and order.tolist() == [3, 1, 2, 0]


I8_SHAPES = {"i": (256, 64, 512, 768), "q": (1024, 32, 128, 128),
             "ep": (8, 64, 512, 768), "k": (256, 32, 128, 128)}


@pytest.mark.parametrize("shape", sorted(I8_SHAPES))
def test_b7_plan_for_int8(shape):
    """int8 cells sort from B7_SORT_MIN_BYTES of probed blocks (pairs x a
    cell's bytes), not from B7_SORT_MIN_PAIRS, in windows of B7_PIPELINE:
    the cell-probe index's (i) sorts, (q)'s and (k)'s 16 KB cells and
    (ep_shard)'s 512 pairs do not; unsorted, windows fill B7_BLOCKS blocks;
    either way a 512-row cell's 4 row tiles split across blocks while there
    are fewer."""
    b, nprobe, cap, w = I8_SHAPES[shape]
    p = b * nprobe
    window, sort, split = tcp.b7_plan_for(p, b, "int8", cap, cap * w)
    assert sort == (p * cap * w >= tcp.B7_SORT_MIN_BYTES)
    assert sort == (shape == "i")
    if sort:
        assert window == tcp.B7_PIPELINE
    else:
        assert window == max(1, min(tcp.B7_PIPELINE, -(-p // tcp.B7_BLOCKS)))
    blocks = -(-p // window)
    assert 1 <= split <= -(-cap // tcp.B7_TILE_ROWS)
    assert split == max(1, min(-(-cap // tcp.B7_TILE_ROWS),
                               tcp.B7_BLOCKS // blocks))


@pytest.mark.parametrize("b,cap,plan", [
    (1, 512, (1, False, 4)), (2, 512, (1, False, 4)), (1, 300, (1, False, 3)),
    (3, 128, (1, False, 1)), (1, 13, (1, False, 1))])
def test_b7_plan_for_int8_few_pairs(b, cap, plan):
    """A query's 64 probes of wide cells: every row tile a block of its own
    while the blocks are fewer than B7_BLOCKS; a one-tile cell is never
    split."""
    assert tcp.b7_plan_for(b * 64, b, "int8", cap, cap * 768) == plan
    assert tcp.b7_plan_for(10 ** 6, 1, "int8", cap, cap * 768)[:2] == (1, False)


# ---------------------------------------------------------- multiprobe_topk


def _layout(seed, *, n_cells=48, cap=16, w=128, d=40, packed=False):
    """A synthetic cell layout: clustered centroids, residual codes with
    per-row scales, reconstruction norms, some invalid slots and one empty
    cell.  Rows are exactly what the codes encode, so any difference below
    is the search's, not the data's."""
    rng = np.random.default_rng(seed)
    cents = np.zeros((n_cells, w), np.float32)
    cents[:, :d] = rng.standard_normal((n_cells, d))
    lim = 8 if packed else 128
    vals = rng.integers(1 - lim, lim, (n_cells * cap, w)).astype(np.int8)
    vals[:, d:] = 0
    codes = _pack(vals) if packed else vals
    scales = rng.uniform(0.002, 0.05, n_cells * cap).astype(np.float32)
    if packed:
        scales *= 16
    recon = cents.repeat(cap, 0) + vals.astype(np.float32) * scales[:, None]
    norms = np.linalg.norm(recon, axis=1).astype(np.float32)
    valid = rng.random(n_cells * cap) > 0.1
    valid[3 * cap:4 * cap] = False             # an empty cell
    return cents, codes, scales, norms, valid, recon


def _queries(seed, cents, b=12, d=40):
    rng = np.random.default_rng(seed + 100)
    q = cents[rng.integers(0, len(cents), b)].copy()
    q[:, :d] += 0.3 * rng.standard_normal((b, d))
    return q.astype(np.float32)


def _both(arrs, q, **kw):
    cents, codes, scales, norms, valid = arrs
    jd, jr = jcp.multiprobe_topk(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(norms),
        jnp.asarray(valid), jnp.asarray(cents), jnp.asarray(q),
        **{k: (jnp.asarray(v).astype(jnp.bfloat16)
               if k == "super_route" else v) for k, v in kw.items()})
    td, tr = tcp.multiprobe_topk(
        torch.from_numpy(codes), torch.from_numpy(scales),
        torch.from_numpy(norms), torch.from_numpy(valid),
        torch.from_numpy(cents), torch.from_numpy(q),
        **{k: (torch.from_numpy(v).to(torch.bfloat16)
               if k == "super_route" else v) for k, v in kw.items()})
    return (np.asarray(jd), np.asarray(jr)), (td.numpy(), tr.numpy())


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
@pytest.mark.parametrize("route", ["flat", "hier"])
def test_multiprobe_matches_jax(packed, metric, route):
    """Probe sets identical (every valid slot of the probed cells comes back
    at k = nprobe * cap); at k=10 ids identical on >= 99.9% of entries and
    distances within rtol 1e-5 (the residual dots are summed in another
    order; both sides multiply the bf16-rounded query with the exact
    codes)."""
    cap, npr = 16, 6
    cents, codes, scales, norms, valid, _ = _layout(
        7 + packed, cap=cap, packed=packed)
    q = _queries(7, cents)
    kw = dict(metric=metric, nprobe=npr, cell_cap=cap)
    if route == "hier":
        # 6 supercells of 8 children (cells grouped in order); sprobe 2
        kw.update(super_route=cents.reshape(6, 8, -1).mean(1), child_cap=8,
                  sprobe=2)
    arrs = (cents, codes, scales, norms, valid)
    (jd, jr), (td, tr) = _both(arrs, q, k=npr * cap, **kw)
    for b in range(len(q)):
        jcells = set((jr[b][np.isfinite(jd[b])] // cap).tolist())
        tcells = set((tr[b][np.isfinite(td[b])] // cap).tolist())
        assert jcells == tcells, b
    (jd, jr), (td, tr) = _both(arrs, q, k=10, **kw)
    assert np.mean(jr == tr) >= 0.999
    same = jr == tr
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-5, atol=1e-6)
    assert same.any()


def test_multiprobe_persistent_route_buffers_match():
    """The caller's persistent bf16 routing copy and |c|^2 buffer give the
    answers the derived ones give."""
    cents, codes, scales, norms, valid, _ = _layout(11)
    q = torch.from_numpy(_queries(11, cents))
    args = [torch.from_numpy(a) for a in (codes, scales, norms, valid, cents)]
    c = args[-1]
    a = tcp.multiprobe_topk(*args, q, metric="cosine", k=10, nprobe=5,
                            cell_cap=16)
    b = tcp.multiprobe_topk(*args, q, metric="cosine", k=10, nprobe=5,
                            cell_cap=16, centroids_route=c.to(torch.bfloat16),
                            cn2=(c * c).sum(-1))
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())


def test_multiprobe_refuses_rq_stage_and_manhattan():
    cents, codes, scales, norms, valid, _ = _layout(12)
    args = [torch.from_numpy(a) for a in (codes, scales, norms, valid, cents)]
    q = torch.from_numpy(_queries(12, cents))
    # the rq stage is ported: with zero error codes and tables the pooled
    # rescore re-ranks the stage-1 pool by its own scores
    plain = tcp.multiprobe_topk(*args, q, metric="cosine", k=5, nprobe=2,
                                cell_cap=16)
    rq = tcp.multiprobe_topk(
        *args, q, metric="cosine", k=5, nprobe=2, cell_cap=16,
        rq_codes=torch.zeros((codes.shape[0], 3), dtype=torch.uint8),
        rq_lut=torch.zeros((q.shape[0], 3, 256)), rq_pool=16)
    for a, b in zip(plain, rq):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="manhattan"):
        tcp.multiprobe_topk(*args, q, metric="manhattan", k=5, nprobe=2,
                            cell_cap=16)


def test_dedup_rows_topk_matches_jax():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 14, (64, 24))
    dists = np.sort(rng.random((64, 24)).astype(np.float32), axis=1)
    dists[:, 20:] = np.inf
    rows[:, 20:] = -1
    want = jcp.dedup_rows_topk(dists, rows, 10)
    got = tcp.dedup_rows_topk(dists, rows, 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1] >= 0).sum() < got[1].size  # duplicates were dropped


# ------------------------------------------ CellProbeIndex on carried state


@pytest.fixture(scope="module")
def jax_index():
    data = make_clustered(6000, 32)
    dp = np.pad(data, ((0, 0), (0, 96)))
    idx = JIndex.build(dp, np.arange(6000, dtype=np.int64), cell_rows=48,
                       cell_cap=64, iters=8)
    return idx, data


def _carry(jidx):
    return CellProbeIndex.from_arrays(
        {k: np.asarray(v) for k, v in jidx.to_arrays().items()}, device=CPU)


def _assert_same_search(jidx, tidx, qs, **kw):
    """Ids identical on >= 99.9% of entries; distances within rtol 1e-5,
    euclidean ones as squares to 1e-5 |q|^2 (sqrt(|q|^2 - 2 q.x + |x|^2)
    cancels near a match, so a summation-order difference in q.x moves a
    small distance by more than rtol)."""
    jd, jr = jidx.search(qs, **kw)
    td, tr = tidx.search(qs, **kw)
    assert np.mean(jr == tr) >= 0.999, (jr, tr)
    same = (jr == tr) & np.isfinite(jd)
    if kw.get("metric") == "euclidean":
        q2 = np.broadcast_to((qs * qs).sum(1, keepdims=True), jd.shape)
        np.testing.assert_array_less(
            np.abs(td[same] ** 2 - jd[same] ** 2), 1e-5 * q2[same] + 1e-9)
    else:
        np.testing.assert_allclose(td[same], jd[same], rtol=1e-5, atol=1e-6)
    return tr


@pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
def test_index_carried_from_jax_searches_alike(jax_index, metric):
    jidx, data = jax_index
    tidx = _carry(jidx)
    qs = data[np.random.default_rng(1).integers(0, len(data), 24)]
    for nprobe in (1, 4, 16):
        _assert_same_search(jidx, tidx, qs, k=10, nprobe=nprobe, metric=metric)


def test_hierarchical_index_carried_from_jax(jax_index):
    jidx, data = jax_index
    jh = jidx._with_hierarchy(child_target=16)
    th = _carry(jh)
    assert th.super_route is not None and th.child_cap == jh.child_cap
    qs = data[np.random.default_rng(2).integers(0, len(data), 24)]
    _assert_same_search(jh, th, qs, k=10, nprobe=8, metric="cosine")
    _assert_same_search(jh, th, qs, k=10, nprobe=8, metric="cosine", sprobe=2)


def test_spilled_index_carried_from_jax():
    """A spilled streaming build (SOAR copies) of the JAX package, carried
    across: the port over-fetches and dedups exactly as JAX does."""
    data = make_clustered(4096, 32, seed=4)

    def chunks():
        for i in range(0, len(data), 1024):
            yield data[i:i + 1024]

    jidx = JIndex.build_streaming(chunks(), n=len(data), dim=32, cell_rows=48,
                                  cell_cap=64, spill_mult=1.3,
                                  train_rows=2048)
    assert jidx.spilled
    tidx = _carry(jidx)
    assert tidx.spilled
    qs = data[:32]
    rows = _assert_same_search(jidx, tidx, qs, k=10, nprobe=6, metric="cosine")
    for r in rows:
        live = r[r >= 0]
        assert len(set(live.tolist())) == len(live)


def test_calibration_travels_with_arrays(jax_index):
    """A curve calibrated by the JAX index loads in the port and the port's
    lazy recall_target search picks the nprobe the curve names."""
    jidx, data = jax_index
    jidx.calibrate_nprobe(n_sample=32, k=5)
    tidx = _carry(jidx)
    assert tidx._calib.get(5, "cosine").curve == jidx._calib.get(5, "cosine").curve
    assert tidx.nprobe_for(0.9, k=5) == jidx.nprobe_for(0.9, k=5)
    back = JIndex.from_arrays(tidx.to_arrays())
    assert back._calib.get(5, "cosine").curve == jidx._calib.get(5, "cosine").curve


# ------------------------------------- tests/test_cell_probe.py, re-pointed


class TestMultiprobeOp:
    @pytest.fixture(scope="class")
    def built(self):
        data = make_clustered(6000, 32)
        rows = np.arange(6000, dtype=np.int64)
        dp = np.pad(data, ((0, 0), (0, 96)))  # pad dims to 128
        idx = CellProbeIndex.build(dp, rows, cell_rows=48, cell_cap=64,
                                   iters=8, device=CPU)
        return idx, data

    @pytest.mark.parametrize("metric", ["cosine", "euclidean", "dot"])
    def test_recall_vs_exact(self, built, metric):
        idx, data = built
        rng = np.random.default_rng(1)
        queries = data[rng.integers(0, len(data), 24)]
        if metric == "cosine":
            a = queries / np.linalg.norm(queries, axis=1, keepdims=True)
            b = data / np.linalg.norm(data, axis=1, keepdims=True)
            gt = np.argsort(-(a @ b.T), axis=1)[:, :10]
        elif metric == "dot":
            gt = np.argsort(-(queries @ data.T), axis=1)[:, :10]
        else:
            d2 = ((queries[:, None, :] - data[None, :, :]) ** 2).sum(-1)
            gt = np.argsort(d2, axis=1)[:, :10]
        _, rows = idx.search(queries, k=10, nprobe=16, metric=metric)
        rec = np.mean([len(set(gt[i]) & set(rows[i])) / 10
                       for i in range(len(queries))])
        assert rec >= 0.9, (metric, rec)

    def test_distances_are_exact_scale(self, built):
        idx, data = built
        dists, rows = idx.search(data[5], k=3, nprobe=16, metric="euclidean")
        assert rows[0][0] == 5
        assert dists[0][0] < 0.05

    def test_low_nprobe_degrades_gracefully(self, built):
        idx, data = built
        dists, rows = idx.search(data[7], k=5, nprobe=1, metric="cosine")
        assert rows.shape == (1, 5)
        assert np.isfinite(dists[0][0])

    def test_persistence_roundtrip(self, built):
        idx, data = built
        idx2 = CellProbeIndex.from_arrays(
            {k: np.asarray(v) for k, v in idx.to_arrays().items()}, device=CPU)
        d1, r1 = idx.search(data[11], k=5, nprobe=8, metric="cosine")
        d2, r2 = idx2.search(data[11], k=5, nprobe=8, metric="cosine")
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_allclose(d1, d2, rtol=1e-6)

    def test_stats(self, built):
        idx, _ = built
        s = idx.stats()
        assert s["kind"] == "cell_probe"
        assert s["rows"] == 6000
        assert s["max_cell"] <= s["cell_cap"]


class TestStoreNprobe:
    @pytest.fixture(scope="class")
    def store(self):
        data = make_clustered(4096, 24, seed=3)
        st = VectorStore.from_matrix("np4r", data, dtype="int4r", device=CPU)
        return st, data

    def test_nprobe_search_finds_self(self, store):
        st, data = store
        assert st.search(data[17], k=3, nprobe=8)[0][0] == "17"

    def test_nprobe_batch(self, store):
        st, data = store
        out = st.search_batch(data[:6], k=4, nprobe=8)
        assert [r[0][0] for r in out] == [str(i) for i in range(6)]

    def test_nprobe_recall_vs_exact_path(self, store):
        st, data = store
        qs = data[np.random.default_rng(2).integers(0, len(data), 16)]
        full = st.search_batch(qs, k=10)
        probed = st.search_batch(qs, k=10, nprobe=12)
        rec = np.mean([
            len({h[0] for h in probed[i]} & {h[0] for h in full[i]}) / 10
            for i in range(len(qs))])
        assert rec >= 0.85, rec

    def test_nprobe_rejects_non_int4r(self):
        st = VectorStore("plain_np", device=CPU)
        st.insert("a", np.ones(8, np.float32))
        with pytest.raises(ValueError, match="int4r"):
            st.search(np.ones(8, np.float32), k=1, nprobe=4)

    def test_nprobe_rejects_manhattan(self, store):
        st, data = store
        with pytest.raises(ValueError, match="manhattan"):
            st.search(data[0], k=1, metric="manhattan", nprobe=4)


class TestHierarchicalRouting:
    @pytest.fixture(scope="class")
    def hier(self):
        data = make_clustered(6000, 32, seed=9)
        dp = np.pad(data, ((0, 0), (0, 96)))
        flat = CellProbeIndex.build(dp, np.arange(6000, dtype=np.int64),
                                    cell_rows=24, cell_cap=32, iters=6,
                                    device=CPU)
        assert flat.super_route is None  # under the threshold
        hier = flat._with_hierarchy(child_target=32)
        assert hier.super_route is not None and hier.child_cap >= 32
        return flat, hier, data

    @pytest.mark.parametrize("metric", ["cosine", "euclidean"])
    def test_recall_parity_with_flat_route(self, hier, metric):
        flat, h, data = hier
        qs = data[np.random.default_rng(4).integers(0, len(data), 24)]
        _d_f, r_f = flat.search(qs, k=10, nprobe=16, metric=metric)
        _d_h, r_h = h.search(qs, k=10, nprobe=16, metric=metric)
        overlap = np.mean([
            len(set(r_h[b][r_h[b] >= 0]) & set(r_f[b][r_f[b] >= 0]))
            / max(1, (r_f[b] >= 0).sum()) for b in range(len(qs))])
        assert overlap >= 0.85, (metric, overlap)

    def test_narrow_l1_keeps_children_with_their_supercell(self, hier):
        """Each supercell holds the cells the balanced assignment gave it,
        so a narrow L1 (2 of 8 supercells) still finds the flat route's
        answers.  (The JAX package's _with_hierarchy scatters the cells in
        unsorted order, core/cell_probe.py:219-221, so its children are not
        its supercell's: the port sorts them.)"""
        flat, h, data = hier
        qs = data[np.random.default_rng(6).integers(0, len(data), 24)]
        _d_f, r_f = flat.search(qs, k=10, nprobe=8, metric="cosine")
        _d_h, r_h = h.search(qs, k=10, nprobe=8, metric="cosine", sprobe=2)
        overlap = np.mean([len(set(r_h[b]) & set(r_f[b])) / 10
                           for b in range(len(qs))])
        assert overlap >= 0.85, overlap

    def test_self_row_top1(self, hier):
        _flat, h, data = hier
        _d, r = h.search(data[11], k=3, nprobe=8, metric="cosine")
        assert r[0][0] == 11

    def test_padding_cells_never_surface(self, hier):
        _flat, h, data = hier
        d, r = h.search(data[:8], k=10, nprobe=h.n_cells, metric="cosine")
        for b in range(8):
            got = r[b][np.isfinite(d[b])]
            assert (got >= 0).all()
            assert len(set(got.tolist())) == len(got)

    def test_persistence_roundtrip_with_hierarchy(self, hier):
        _flat, h, data = hier
        arrays = {k: np.asarray(v) for k, v in h.to_arrays().items()}
        assert "super_cents" in arrays
        h2 = CellProbeIndex.from_arrays(arrays, device=CPU)
        assert h2.super_route is not None
        _d1, r1 = h.search(data[5], k=5, nprobe=8, metric="cosine")
        _d2, r2 = h2.search(data[5], k=5, nprobe=8, metric="cosine")
        np.testing.assert_array_equal(r1, r2)

    def test_stats_reports_hierarchy(self, hier):
        _flat, h, _ = hier
        s = h.stats()
        assert s["hierarchical"] and s["supercells"] >= 2
        assert s["rows"] == 6000


class TestGatherKernelPlainVersion:
    """tests/test_cell_probe.py::TestDmaGatherKernel's cases against the
    port's plain version of B7."""

    def test_int8_kernel_matches_einsum(self):
        rng = np.random.default_rng(0)
        k, cap, w, b, npr = 16, 16, 128, 8, 4
        codes3 = rng.integers(-127, 128, (k, cap, w), dtype=np.int8)
        probe = rng.integers(0, k, (b, npr), dtype=np.int32)
        q = rng.standard_normal((b, w)).astype(np.float32)
        got = tcp.gather_dots(torch.from_numpy(codes3),
                              torch.from_numpy(probe), torch.from_numpy(q))
        ref = np.einsum("bpcw,bw->bpc", codes3[probe].astype(np.float32), q)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-2)

    def test_packed_kernel_matches_unpacked(self):
        rng = np.random.default_rng(1)
        k, cap, w, b, npr = 16, 16, 128, 8, 4
        vals = rng.integers(-7, 8, (k, cap, w)).astype(np.int8)
        probe = rng.integers(0, k, (b, npr), dtype=np.int32)
        q = rng.standard_normal((b, w)).astype(np.float32)
        got = tcp.gather_dots(torch.from_numpy(_pack(vals)),
                              torch.from_numpy(probe), torch.from_numpy(q))
        ref = np.einsum("bpcw,bw->bpc", vals[probe].astype(np.float32), q)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-2)


def test_cellprobe_recall_target_calibration():
    """calibrate_nprobe: deep probe == 1.0, a monotone-ish curve, and
    search(recall_target=) equals search(nprobe=chosen)."""
    rng = np.random.default_rng(9)
    n, d = 4000, 16
    centers = rng.standard_normal((30, d)).astype(np.float32)
    data = (centers[rng.integers(0, 30, n)]
            + 0.3 * rng.standard_normal((n, d)).astype(np.float32))
    dp = np.pad(data, ((0, 0), (0, 128 - d)))
    idx = CellProbeIndex.build(dp, np.arange(n, dtype=np.int64), cell_rows=40,
                               device=CPU)
    curve = idx.calibrate_nprobe(n_sample=48, k=5)
    assert curve[max(curve)] == 1.0
    vals = [curve[p] for p in sorted(curve)]
    for a, b in zip(vals, vals[1:]):
        assert b >= a - 0.05, curve
    q = np.pad(data[:3], ((0, 0), (0, 128 - d)))
    want = idx.nprobe_for(0.9, k=5)
    _, r1 = idx.search(q, k=5, recall_target=0.9)
    _, r2 = idx.search(q, k=5, nprobe=want)
    np.testing.assert_array_equal(r1, r2)


def test_spilled_streaming_index_dedups():
    """The port's own spilled streaming build: every row is present, some
    twice, and answers carry no duplicate row."""
    data = make_clustered(4096, 24, seed=8)

    def chunks():
        for i in range(0, len(data), 1024):
            yield data[i:i + 1024]

    idx = CellProbeIndex.build_streaming(
        chunks(), n=len(data), dim=24, cell_rows=48, cell_cap=64,
        spill_mult=1.3, train_rows=2048, device=CPU)
    assert idx.spilled and idx.build_stats["spilled_rows"] > 0
    rm = idx.row_map
    assert set(rm[rm >= 0].tolist()) == set(range(len(data)))
    assert (rm >= 0).sum() == len(data) + idx.build_stats["spilled_rows"]
    _d, rows = idx.search(data[:16], k=10, nprobe=8)
    assert [r[0] for r in rows] == list(range(16))
    for r in rows:
        assert len(set(r.tolist())) == len(r)


def test_nprobe_on_distributed_store_is_clean_error():
    """tests/test_cell_probe.py's case on the port's Database: nprobe
    against a distributed store raises the domain error, not a TypeError."""
    from erlvectordb_tpu_torch.api import Database
    from erlvectordb_tpu_torch.infra.config import load_config

    db = Database(load_config(overrides={"persistence_enabled": False},
                              env={}), device=CPU)
    db.create_distributed_store("dshard", dim=8)
    db.insert("dshard", "a", np.ones(8, np.float32))
    with pytest.raises(ValueError, match="distributed"):
        db.search("dshard", np.ones(8, np.float32), k=1, nprobe=4)
