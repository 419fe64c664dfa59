"""tests/test_properties.py re-pointed at the port (hypothesis): the
compression round-trip bounds, search ordering, int4 pack/unpack
bijectivity, multiprobe at full nprobe, int4r nprobe results, window-key
monotonicity and the pos path's top-1 — on the CPU, where the fused
wrappers run their plain versions."""

import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from erlvectordb_tpu_torch.quant import compress_vector, decompress_vector

CPU = torch.device("cpu")

_finite = st.floats(min_value=-1e4, max_value=1e4, allow_nan=False,
                    allow_infinity=False, width=32)


def _vec(min_size=2, max_size=64):
    return st.lists(_finite, min_size=min_size, max_size=max_size).map(
        lambda xs: np.asarray(xs, np.float32)
    )


@settings(max_examples=25, deadline=None)
@given(_vec())
def test_8bit_roundtrip_bound(v):
    recon = decompress_vector(compress_vector(v, "8bit", device=CPU),
                              device=CPU)
    bound = (float(v.max()) - float(v.min())) / 255 + 1e-3
    assert np.max(np.abs(recon - v)) <= bound


@settings(max_examples=25, deadline=None)
@given(_vec())
def test_4bit_roundtrip_bound(v):
    recon = decompress_vector(compress_vector(v, "4bit", device=CPU),
                              device=CPU)
    bound = (float(v.max()) - float(v.min())) / 15 + 1e-3
    assert np.max(np.abs(recon - v)) <= bound


@settings(max_examples=25, deadline=None)
@given(_vec())
def test_zlib_exact(v):
    recon = decompress_vector(compress_vector(v, "zlib"))
    np.testing.assert_array_equal(recon, v)


@settings(max_examples=10, deadline=None)
@given(
    st.integers(min_value=2, max_value=40),   # corpus size
    st.integers(min_value=2, max_value=16),   # dim
    st.integers(min_value=1, max_value=8),    # k
    st.integers(min_value=0, max_value=2**31 - 1),
)
def test_search_invariants(n, d, k, seed):
    """For any corpus: results sorted ascending, no duplicates, <= min(k, n),
    and the query vector itself (when present) ranks first for euclidean."""
    from erlvectordb_tpu_torch.core.store import VectorStore

    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, d)).astype(np.float32)
    store = VectorStore(f"prop{seed}", metric="euclidean", device=CPU)
    store.insert_batch([f"v{i}" for i in range(n)], data)
    res = store.search(data[0], k=k)
    assert len(res) <= min(k, n)
    ids = [r[0] for r in res]
    assert len(set(ids)) == len(ids)
    dists = [r[2] for r in res]
    assert dists == sorted(dists)
    # the query itself ranks (near-)first; the matmul expansion
    # |q|^2 - 2q.x + |x|^2 loses ~sqrt(eps)*|x| to cancellation in f32
    norm = float(np.linalg.norm(data[0]))
    assert res[0][2] <= max(1e-2, 2e-3 * norm)


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(min_value=-7, max_value=7), min_size=2,
                max_size=64).filter(lambda xs: len(xs) % 2 == 0))
def test_int4_pack_unpack_bijective(codes):
    from erlvectordb_tpu_torch.core.store import _pack_int4
    from erlvectordb_tpu_torch.ops.fused_topk import unpack_int4

    q = np.asarray(codes, np.int8)[None, :]
    packed = _pack_int4(torch.from_numpy(q))
    back = unpack_int4(packed).numpy()
    np.testing.assert_array_equal(back, q)


@settings(max_examples=10, deadline=None)
@given(st.integers(min_value=0, max_value=2**31 - 1),
       st.integers(min_value=60, max_value=200),
       st.sampled_from(["cosine", "euclidean", "dot"]))
def test_multiprobe_exhaustive_equals_exact(seed, n, metric):
    """Probing EVERY cell makes the cell-probe index an exact search over
    the int8-residual reconstructions: the returned self-row must be the
    true top-1 and distances must be finite, sorted, and duplicate-free."""
    from erlvectordb_tpu_torch.core.cell_probe import CellProbeIndex

    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, 16)).astype(np.float32)
    dp = np.pad(data, ((0, 0), (0, 112)))
    idx = CellProbeIndex.build(dp, np.arange(n, dtype=np.int64),
                               cell_rows=16, cell_cap=24, iters=3,
                               device=CPU)
    k = min(5, n)
    dists, rows = idx.search(data[:3], k=k, nprobe=idx.n_cells,
                             metric=metric)
    for b in range(3):
        got = rows[b][rows[b] >= 0]
        assert len(set(got.tolist())) == len(got)
        if metric != "dot":  # dot favors large norms, not the self-row
            assert rows[b][0] == b
        d = dists[b][np.isfinite(dists[b])]
        assert list(d) == sorted(d)


@settings(max_examples=10, deadline=None)
@given(st.integers(min_value=0, max_value=2**31 - 1))
def test_int4r_store_nprobe_subset_of_reconstruction_space(seed):
    """Multiprobe results on an int4r store are always valid store rows
    with finite distances — never padding slots or deleted rows."""
    from erlvectordb_tpu_torch.core.store import VectorStore

    rng = np.random.default_rng(seed)
    data = rng.standard_normal((600, 12)).astype(np.float32)
    store = VectorStore.from_matrix(f"np4r{seed}", data, dtype="int4r",
                                    device=CPU)
    store.delete("7")
    res = store.search(data[3], k=5, nprobe=4)
    ids = [r[0] for r in res]
    assert "7" not in ids
    assert len(set(ids)) == len(ids)
    assert all(np.isfinite(r[2]) for r in res)


@settings(max_examples=100, deadline=None)
@given(
    st.lists(st.floats(min_value=0.0, max_value=1e6, allow_nan=False,
                       width=32), min_size=2, max_size=32),
    st.floats(min_value=0.0, max_value=1e5, allow_nan=False, width=32),
    st.floats(min_value=0.0009765625, max_value=1e4, allow_nan=False,
              width=32),
)
def test_window_key_monotone(scores, f, g):
    """The pos paths' scaled-int window key round((s-f)*g) (value bits,
    lane bits stripped) is monotone non-decreasing in the score for ANY
    window offset/gain — a wrong f/g may waste resolution but can never
    invert an ordering beyond one quantization level."""
    s = np.sort(np.asarray(scores, np.float32))
    keys = np.clip(np.round((s - np.float32(f)) * np.float32(g)),
                   -2.0e9, 2.0e9).astype(np.int64) & ~1023
    assert (np.diff(keys) >= 0).all()


@settings(max_examples=5, deadline=None)
@given(
    st.integers(min_value=0, max_value=2**31 - 1),
    st.sampled_from(["cosine", "euclidean", "dot"]),
)
def test_pos_path_window_keys_keep_global_top1(seed, metric):
    """Window-keyed pos scan (its plain version on the CPU): the global best row is some
    slice's top-1, so it must survive selection and rank first after the
    exact rescore — for any corpus and any metric, including a deleted-row
    variant."""
    import erlvectordb_tpu_torch.ops.fused_topk as ft
    from erlvectordb_tpu_torch.core.search import exact_topk_int8

    old_gate = ft.POS_MIN_TILES
    ft.POS_MIN_TILES = 1
    try:
        rng = np.random.default_rng(seed)
        n_cap, d, k = 2 * ft.TILE_N, 16, 4
        data = rng.standard_normal((n_cap, d)).astype(np.float32)
        absmax = np.abs(data).max(axis=1)
        scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
        codes = np.clip(np.round(data / scales[:, None]), -127,
                        127).astype(np.int8)
        norms = np.linalg.norm(codes.astype(np.float32) * scales[:, None],
                               axis=1).astype(np.float32)
        valid = np.ones(n_cap, bool)
        valid[rng.integers(0, n_cap, 64)] = False
        q = rng.standard_normal((2, d)).astype(np.float32)
        args = [torch.from_numpy(a) for a in (codes, scales, norms, valid, q)]
        d_f, r_f = ft.fused_topk(*args, metric=metric, k=k, n_tiles=2)
        d_x, r_x = exact_topk_int8(*args, metric=metric, k=k)
        r_f, r_x = r_f.numpy(), r_x.numpy()
        d_f = d_f.numpy()
        for b in range(q.shape[0]):
            assert r_f[b][0] == r_x[b][0], (metric, seed, b)
            assert valid[r_f[b][np.isfinite(d_f[b])]].all()
            fin = r_f[b][np.isfinite(d_f[b])]
            assert len(set(fin.tolist())) == len(fin)
            assert (np.diff(d_f[b][np.isfinite(d_f[b])]) >= -1e-5).all()
    finally:
        ft.POS_MIN_TILES = old_gate
