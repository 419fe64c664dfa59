"""The cell-probe build's row passes on their device (ops/index_build.py), on
the CPU, against the forms they replace, kept here as oracles: k-means++
seeding by whole-sample passes (summed in row_d2's order, itself held to a
scalar model of the kernel's sum), the numpy residual encode, and the build
from a host matrix.  Each is held bit for bit on seeded inputs; the CUDA
kernels are held to the same plain versions on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import erlvectordb_tpu_torch.ops.index_build as ib
import erlvectordb_tpu_torch.ops.kmeans as tkm
from erlvectordb_tpu_torch.api import Database
from erlvectordb_tpu_torch.core.cell_probe import CellProbeIndex
from erlvectordb_tpu_torch.core.index_manager import IndexManager
from erlvectordb_tpu_torch.core.ivf import _balanced_assign
from erlvectordb_tpu_torch.core.store import VectorStore
from erlvectordb_tpu_torch.infra.config import load_config
from erlvectordb_tpu_torch.utils.metrics import metrics

torch.set_num_threads(2)

CPU = torch.device("cpu")


def clustered(n, d, seed, n_centers=32, noise=0.2):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    return (centers[rng.integers(0, n_centers, n)]
            + noise * rng.standard_normal((n, d)).astype(np.float32))


# ------------------------------------------------------------ k-means++


def _kpp_whole_passes(x, gen, k):
    """k-means++ seeding by whole-sample passes: every draw's distances over
    every row."""
    n = x.shape[0]
    first = int(torch.randint(0, n, (1,), generator=gen, device=gen.device))
    cents = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    cents[0] = x[first]
    mind2 = ib.row_d2(x, x[first])
    for i in range(1, k):
        w = torch.clamp(mind2, min=1e-20)
        p = w / w.sum()
        e = torch.empty_like(p).exponential_(1.0, generator=gen)
        pick = x.index_select(0, torch.argmax(p / e, dim=0, keepdim=True))
        cents[i:i + 1] = pick
        mind2 = torch.minimum(mind2, ib.row_d2(x, pick[0]))
    return cents


def _kpp_data(kind, n, d):
    x = clustered(n, d, seed=n + d)
    if kind == "dup":   # 60 distinct rows, each many times
        x = x[np.random.default_rng(d).integers(0, 60, n)]
    if kind == "zeros":
        x[::7] = 0.0
    return torch.from_numpy(x)


@pytest.mark.parametrize("kind,n,k,d", [
    ("clustered", 3000, 200, 24),
    ("clustered", 2000, 160, 100),
    ("clustered", 1200, 96, 768),
    ("dup", 900, 120, 24),           # more seeds than distinct rows
    ("zeros", 1000, 80, 130),
    ("clustered", 257, 257, 24),     # k = n
    ("clustered", 10, 6, 100),       # fewer rows than a warp
    ("clustered", 300, 40, 9000),    # wider than numpy's buffer
])
def test_kpp_pruned_draws_the_whole_pass_centroids(kind, n, k, d):
    x = _kpp_data(kind, n, d)
    g_old, g_new = torch.Generator(), torch.Generator()
    g_old.manual_seed(11)
    g_new.manual_seed(11)
    stats = {}
    got = tkm._kpp_init(x, g_new, k, stats)
    assert torch.equal(got, _kpp_whole_passes(x, g_old, k))
    assert stats["kpp_rows_total"] == (k - 1) * n
    assert 0 <= stats["kpp_rows_scanned"] <= stats["kpp_rows_total"]


def test_kpp_pruning_skips_most_rows_once_seeds_cover_the_clusters():
    x = _kpp_data("clustered", 4000, 64)
    stats = {}
    tkm.kmeans_seeds(x, 3, k=400, init="kpp", stats=stats)
    assert stats["kpp_rows_scanned"] < 0.25 * stats["kpp_rows_total"]


def test_kpp_update_ref_whole_and_pruned_agree():
    """The whole-sample form and the pruned one give the same distances and
    owners, and count what they read."""
    x = _kpp_data("clustered", 500, 24)
    cents = x[torch.tensor([3, 40, 77, 300])].clone()
    state = []
    for prune in (True, False):
        mind2 = ib.row_d2(x, cents[0])
        owner = torch.zeros(500, dtype=torch.int32)
        scanned = torch.zeros((), dtype=torch.int64)
        for i in range(1, 4):
            ib.kpp_update_ref_(x, cents, i, mind2, owner, scanned, prune)
        state.append((mind2, owner, int(scanned)))
    assert torch.equal(state[0][0], state[1][0])
    assert torch.equal(state[0][1], state[1][1])
    assert state[1][2] == 3 * 500 and state[0][2] < state[1][2]


def _row_d2_scalar(x, c):
    """The kernel's sum, one f32 operation at a time: element e into lane
    e // 4 % 32's accumulator e % 4, a lane's four accumulators in turn,
    then lane l += lane l + h for h = 16, 8, 4, 2, 1."""
    n, d = x.shape
    f = np.float32
    out = np.empty(n, np.float32)
    for r in range(n):
        acc = np.zeros((32, 4), np.float32)
        for e in range(d):
            t = f(x[r, e] - c[e])
            lane, q = e // 4 % 32, e % 4
            acc[lane, q] = f(acc[lane, q] + f(t * t))
        v = [f(f(f(a[0] + a[1]) + a[2]) + a[3]) for a in acc]
        h = 16
        while h:
            v = [f(v[j] + v[j + h]) for j in range(h)]
            h //= 2
        out[r] = v[0]
    return out


@pytest.mark.parametrize("d", [1, 3, 4, 5, 24, 100, 127, 128, 129, 130, 255,
                               256, 257, 768, 1000])
def test_row_d2_is_the_kernels_order(d):
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((6, d))
         * rng.uniform(1e-3, 1e3, (6, 1))).astype(np.float32)
    x[2] = 0.0
    c = rng.standard_normal(d).astype(np.float32)
    got = ib.row_d2(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  _row_d2_scalar(x, c).view(np.int32))


# ---------------------------------------------------------------- encode


def _encode_numpy(data, rows, owner, cents, cell_cap):
    """The host encode as it was (numpy, the whole array at once)."""
    n, d = data.shape
    n_cells = cents.shape[0]
    order = np.argsort(owner, kind="stable")
    oc = owner[order]
    starts = np.searchsorted(oc, np.arange(n_cells))
    dest = oc * cell_cap + (np.arange(n) - starts[oc])
    total = n_cells * cell_cap
    codes = np.zeros((total, d), np.int8)
    scales = np.ones((total,), np.float32)
    norms = np.zeros((total,), np.float32)
    row_map = np.full((total,), -1, np.int64)
    res = data[order] - cents[oc]
    absmax = np.abs(res).max(axis=1)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    codes_rows = np.clip(np.round(res / scale[:, None]), -127,
                         127).astype(np.int8)
    codes[dest] = codes_rows
    scales[dest] = scale
    recon = cents[oc] + codes_rows.astype(np.float32) * scale[:, None]
    norms[dest] = np.linalg.norm(recon, axis=1)
    row_map[dest] = np.asarray(rows)[order]
    return codes, scales, norms, row_map >= 0, row_map


def _encode_inputs(n, d, n_cells, cap, seed):
    rng = np.random.default_rng(seed)
    data = clustered(n, d, seed) * rng.uniform(0.01, 30.0, (n, 1)).astype(
        np.float32)
    cents = data[rng.choice(n, n_cells, replace=False)] + np.float32(0.01)
    owner = np.repeat(np.arange(n_cells), cap)[rng.permutation(
        n_cells * cap)[:n]]
    data[owner == 2] = cents[2]      # a cell whose residuals are all zero
    data[5] = 0.0                    # an all-zero row
    rows = rng.permutation(10 * n)[:n].astype(np.int64)
    return data, rows, owner, cents


@pytest.mark.parametrize("d", [24, 100, 130, 768])
def test_tensor_encode_is_the_numpy_encode(monkeypatch, d):
    monkeypatch.setattr(ib, "_ENCODE_ELEMS", 37 * d)   # chunks of 37 rows
    data, rows, owner, cents, = _encode_inputs(700, d, 30, 32, seed=d)
    t = torch.from_numpy
    got = ib.encode_cells(t(data), t(rows), t(owner), t(cents), 32)
    want = _encode_numpy(data, rows, owner, cents, 32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("d", [1, 3, 7, 8, 9, 24, 100, 127, 128, 129, 130,
                               256, 300, 768, 1000, 4096, 8192, 8193, 12288,
                               16385, 20000])
def test_pairwise_norms_are_numpys(d):
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((64, d))
         * rng.uniform(1e-3, 1e3, (64, 1))).astype(np.float32)
    x[3] = 0.0
    got = ib.pairwise_norms(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.linalg.norm(x, axis=1).view(np.int32))


def test_pairwise_program_follows_numpys_halving():
    assert ib.pairwise_program(768) == [
        (0, 96), (96, 96), (-1, 0), (192, 96), (288, 96), (-1, 0), (-1, 0),
        (384, 96), (480, 96), (-1, 0), (576, 96), (672, 96), (-1, 0),
        (-1, 0), (-1, 0)]
    assert ib.pairwise_program(100) == [(0, 100)]
    # past numpy 2.0's buffer, chunks of 8,192 added in turn, or the whole
    # row as numpy 2.3 sums it; the installed numpy's choice is read once
    whole = ib.pairwise_program(8192)
    assert ib.pairwise_program(8192 + 100, 8192) == whole + [
        (8192, 100), (-1, 0)]
    unchunked = ib.pairwise_program(8192 + 100, 0)
    assert unchunked != ib.pairwise_program(8192 + 100, 8192)
    assert sum(c for s, c in unchunked if s >= 0) == 8192 + 100
    assert unchunked.count((-1, 0)) == sum(s >= 0 for s, _ in unchunked) - 1
    assert ib.pairwise_program(8192 + 100) == ib.pairwise_program(
        8192 + 100, ib.numpy_chunk())
    with pytest.raises(ValueError, match="width"):
        ib.pairwise_norms(torch.zeros((2, 0)))


def test_numpys_order_for_wide_rows_is_read_from_a_row_it_decides():
    """The probe's rows sum to other bits in the two orders, so the order
    it reads is numpy's."""
    sq = torch.from_numpy(np.random.default_rng(0).random(
        (8, 3 * ib.PW_CHUNK + 11), dtype=np.float32))
    assert not torch.equal(ib._pairwise_sum(sq, ib.PW_CHUNK),
                           ib._pairwise_sum(sq, 0))
    assert ib.numpy_chunk() in (ib.PW_CHUNK, 0)


# ----------------------------------------------------------------- build


def _arrays(idx):
    return (idx.centroids.numpy(), idx.codes.numpy(), idx.scales.numpy(),
            idx.norms.numpy(), idx.valid.numpy(), idx.row_map)


def test_build_from_a_tensor_is_the_build_from_numpy():
    data = np.pad(clustered(3000, 100, seed=4), ((0, 0), (0, 28)))
    rows = np.random.default_rng(4).permutation(9000)[:3000].astype(np.int64)
    kw = dict(cell_rows=24, cell_cap=32, iters=4, max_train=2000, device=CPU)
    a = CellProbeIndex.build(data, rows, **kw)
    b = CellProbeIndex.build(torch.from_numpy(data), rows, **kw)
    for x, y in zip(_arrays(a), _arrays(b)):
        np.testing.assert_array_equal(x, y)
    assert a.build_stats["kpp_rows_total"] == (a.n_cells - 1) * 2000
    assert 0 < b.build_stats["kpp_rows_scanned"] <= b.build_stats[
        "kpp_rows_total"]
    # the rows the index's encode saw are the build's
    want = _encode_numpy(data, rows,
                         _balanced_assign(data, a.centroids.numpy(), 32,
                                          device=CPU),
                         a.centroids.numpy(), 32)
    for x, y in zip(_arrays(a)[1:], want):
        np.testing.assert_array_equal(x, y)


def test_balanced_assign_takes_tensors():
    data = clustered(1500, 40, seed=9)
    cents = clustered(60, 40, seed=10)
    want = _balanced_assign(data, cents, 30, device=CPU)
    got = _balanced_assign(torch.from_numpy(data), torch.from_numpy(cents),
                           30, device=CPU)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_store_matrix_on_the_device_is_the_host_matrix(dtype):
    """The builders' matrix is a tensor on the store's device with the
    rows and values of get_all_vectors, padded with zero columns."""
    data = clustered(700, 72, seed=2)
    store = VectorStore.from_matrix("m", data, metric="cosine", dtype=dtype,
                                    device=CPU)
    store.delete_batch(["3", "400"])
    live = store.get_all_vectors()
    want = np.stack([vec for _, vec, _ in live]).astype(np.float32)
    for pad in (False, True):
        tmat, trows = IndexManager._store_matrix(store, pad128=pad)
        assert isinstance(tmat, torch.Tensor) and tmat.device == CPU
        assert tmat.shape == (698, 128 if pad else 72)
        np.testing.assert_array_equal(tmat[:, :72].numpy(), want)
        assert not tmat[:, 72:].any()
        np.testing.assert_array_equal(
            trows, [r for r in range(700) if r not in (3, 400)])


def test_manager_counts_the_seedings_rows():
    db = Database(load_config(overrides={"persistence_enabled": False},
                              env={}), device=CPU)
    db.registry.adopt(VectorStore.from_matrix(
        "c", clustered(4000, 48, seed=7), metric="cosine", device=CPU))
    before = metrics.snapshot()["counters"]
    db.create_index("cp", "c", "cellprobe", {})
    info = db.build_index("cp")
    assert info["built"]
    build = info["stats"]["build"]
    after = metrics.snapshot()["counters"]
    for key in ("kpp_rows_scanned", "kpp_rows_total"):
        assert (after.get(f"index.{key}", 0) - before.get(f"index.{key}", 0)
                == build[key])
    assert build["kpp_rows_total"] == (build["cells"] - 1) * 4000
    assert build["kpp_rows_scanned"] < build["kpp_rows_total"]
