"""The int4r second stage (``rq_m``) of the port's store, on the CPU.

tests/test_store.py::TestRQStore re-pointed at erlvectordb_tpu_torch (recall
no worse than stage 1, +rq_m bytes a row, insert encodes the second stage,
state round trip, full-reconstruction norms), then the port held to the JAX
package on shared state:

  * a JAX-written ``rq_m`` state imported by ``from_state`` answers
    multiprobe searches with the same top-10 ids as the JAX store;
  * the stage-2 encode of the same rows and codebooks gives the same codes
    on >= 99.9% of rows and norms to 1e-5 (the OPQ products summed in
    another order);
  * the pooled rescore of ``multiprobe_topk`` gives the JAX op's rows;
  * a row inserted into both stores lands in the same slot with the same
    second-stage codes.

An rq build draws its own random numbers (k-means seeding), so the port's
from_matrix is held by recall, not by codes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erlvectordb_tpu.core.store import VectorStore as JaxStore
from erlvectordb_tpu.core.store import _rq_encode_chunk as jax_rq_encode
from erlvectordb_tpu.ops.cell_probe import multiprobe_topk as jax_multiprobe
from erlvectordb_tpu.quant.pq import _adc_ip_tables as jax_ip_tables
from erlvectordb_tpu_torch.core.store import VectorStore, _rq_encode_chunk
from erlvectordb_tpu_torch.ops.cell_probe import multiprobe_topk
from erlvectordb_tpu_torch.quant.pq import _adc_ip_tables

CPU = torch.device("cpu")
torch.set_num_threads(2)


def _corpus(rng, n=6000, d=20, centers=64, noise=0.3):
    c = rng.standard_normal((centers, d)).astype(np.float32)
    a = rng.integers(0, centers, n)
    return (c[a] + noise * rng.standard_normal((n, d))).astype(np.float32)


def _ids(store, q, k=10, nprobe=32):
    return store.search_batch_complete_raw(
        store.search_batch_submit(q, k=k, nprobe=nprobe))[2]


def _recall(store, q, gt, k=10, nprobe=32):
    got = [[int(v) if v is not None else -1 for v in row]
           for row in _ids(store, q, k, nprobe).tolist()]
    return np.mean([len(set(gt[i]) & set(got[i])) / k for i in range(len(q))])


def _t(a):
    return torch.from_numpy(np.array(a))


class TestRQStore:
    """The JAX package's TestRQStore on the port."""

    def test_rq_recall_not_worse_and_memory(self, rng):
        x = _corpus(rng)
        plain = VectorStore.from_matrix("rqp", x, dtype="int4r", device=CPU)
        rq = VectorStore.from_matrix("rqr", x, dtype="int4r", rq_m=5,
                                     device=CPU)
        q = x[:64]
        xn = np.linalg.norm(x, axis=1)
        sims = (q @ x.T) / (np.linalg.norm(q, axis=1)[:, None] * xn[None, :])
        gt = np.argsort(-sims, axis=1)[:, :10]
        rp = _recall(plain, q, gt)
        rr = _recall(rq, q, gt)
        assert rr >= rp - 0.01, (rp, rr)
        # +rq_m bytes/row (plus small codebook/rotation overheads)
        extra = rq.device_memory_bytes() - plain.device_memory_bytes()
        assert extra >= rq._capacity * 5
        assert extra <= rq._capacity * 5 + 4 * (5 * 256 * 4 + 20 * 20) + 4096

    def test_rq_insert_encodes_second_stage(self, rng):
        x = _corpus(rng, n=4000)
        rq = VectorStore.from_matrix("rqi", x, dtype="int4r", rq_m=5,
                                     device=CPU)
        v = x[0] + 0.01
        rq.insert("fresh", v)
        row = rq._id_to_row["fresh"]
        assert rq._rq_codes[row].numpy().any()  # the error stage wrote codes
        res = rq.search(v, k=2, nprobe=32)
        assert "fresh" in [r[0] for r in res]

    def test_rq_snapshot_roundtrip(self, rng):
        x = _corpus(rng, n=3000)
        rq = VectorStore.from_matrix("rqs", x, dtype="int4r", rq_m=5,
                                     device=CPU)
        back = VectorStore.from_state(rq.export_state(), device=CPU)
        assert back._rq_m == 5 and back._rq_codes is not None
        q = x[:16]
        assert (_ids(rq, q) == _ids(back, q)).all()

    def test_rq_norms_are_full_reconstruction(self, rng):
        # stored norms describe centroid + stage 1 + stage 2, not stage 1
        x = _corpus(rng, n=3000)
        plain = VectorStore.from_matrix("rqn1", x, dtype="int4r", device=CPU)
        rq = VectorStore.from_matrix("rqn2", x, dtype="int4r", rq_m=5,
                                     device=CPU)

        def err(st):
            rows = [st._id_to_row[str(i)] for i in range(200)]
            nrm = st._norms.numpy()[rows]
            return np.mean(np.abs(nrm - np.linalg.norm(x[:200], axis=1)))
        assert err(rq) <= err(plain) + 1e-6

    def test_rq_needs_int4r(self, rng):
        with pytest.raises(ValueError, match="int4r"):
            VectorStore.from_matrix("bad", _corpus(rng, n=200), dtype="int8",
                                    rq_m=5, device=CPU)

    def test_rebuild_cells_keeps_the_second_stage(self, rng):
        x = _corpus(rng, n=3000)
        rq = VectorStore.from_matrix("rqb", x, dtype="int4r", rq_m=5,
                                     device=CPU)
        rq.insert("fresh", x[3] + 0.02)
        rq.rebuild_cells()
        assert rq._rq_m == 5 and rq._rq_codes.shape[0] == rq.capacity
        assert rq.search(x[3] + 0.02, k=2, nprobe=32)[0][0] in ("fresh", "3")
        assert rq.search(x[11], k=1, nprobe=32)[0][0] == "11"


# ---------------------------------------------- against the JAX package


@pytest.fixture(scope="module")
def jax_rq():
    rng = np.random.default_rng(17)
    x = _corpus(rng, n=5000)
    js = JaxStore.from_matrix("jrq", x, dtype="int4r", rq_m=5)
    q = (x[rng.integers(0, len(x), 32)]
         + 0.2 * rng.standard_normal((32, x.shape[1]))).astype(np.float32)
    return x, js, q


@pytest.mark.parametrize("nprobe", [4, 32])
def test_from_jax_state_same_top10(jax_rq, nprobe):
    x, js, q = jax_rq
    ts = VectorStore.from_state(js.export_state(), device=CPU)
    assert ts._rq_m == 5 and ts.device_memory_bytes() == js.device_memory_bytes()
    assert (_ids(ts, q, nprobe=nprobe) == _ids(js, q, nprobe=nprobe)).all()
    ts.rq_pool = js.rq_pool = 128
    assert (_ids(ts, q, nprobe=nprobe) == _ids(js, q, nprobe=nprobe)).all()
    js.rq_pool = 64


def test_rq_encode_matches_jax(jax_rq):
    x, js, _ = jax_rq
    rows = np.asarray(sorted(js._id_to_row.values()))[:2000]
    ids = [js._row_to_id[r] for r in rows]
    orig = x[np.asarray([int(i) for i in ids])]
    cents = np.asarray(js._centroids)[rows // js._cell_cap]
    width = cents.shape[1]
    xp = np.pad(orig, ((0, 0), (0, width - orig.shape[1])))
    packed = np.asarray(js._vectors)[rows]
    scales = np.asarray(js._scales)[rows]
    rot, books = np.asarray(js._rq_rot), np.asarray(js._rq_books)
    d, dp2 = x.shape[1], rot.shape[0]
    cj, nj = jax_rq_encode(jnp.asarray(packed), jnp.asarray(scales),
                           jnp.asarray(cents), jnp.asarray(xp),
                           jnp.asarray(rot), jnp.asarray(books), d=d, dp2=dp2)
    ct, nt = _rq_encode_chunk(_t(packed), _t(scales), _t(cents), _t(xp),
                              _t(rot), _t(books), d=d, dp2=dp2)
    assert (ct.numpy() == np.asarray(cj)).all(axis=1).mean() >= 0.999
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=1e-5)
    # the imported store's codes are the JAX encode's
    assert (np.asarray(js._rq_codes)[rows] == np.asarray(cj)).all()


def test_pooled_rescore_matches_jax(jax_rq):
    x, js, q = jax_rq
    st = js.export_state()
    w = st["centroids"].shape[1]
    qp = np.zeros((len(q), w), np.float32)
    qp[:, : q.shape[1]] = q
    dp2 = st["rq_rot"].shape[0]
    qr = np.pad(q, ((0, 0), (0, dp2 - q.shape[1]))) @ st["rq_rot"]
    common = dict(metric="cosine", k=16, nprobe=8, cell_cap=st["cell_cap"],
                  rq_pool=64)
    names = ("vectors", "scales", "norms", "valid", "centroids")
    dj, rj = jax_multiprobe(*(jnp.asarray(st[n]) for n in names),
                            jnp.asarray(qp), rq_codes=jnp.asarray(st["rq_codes"]),
                            rq_lut=jax_ip_tables(jnp.asarray(qr),
                                                 jnp.asarray(st["rq_books"])),
                            **common)
    dt, rt = multiprobe_topk(*(_t(st[n]) for n in names), _t(qp),
                             rq_codes=_t(st["rq_codes"]),
                             rq_lut=_adc_ip_tables(_t(qr), _t(st["rq_books"])),
                             **common)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)


def test_insert_same_slot_and_codes_as_jax(jax_rq):
    x, js, _ = jax_rq
    st = js.export_state()
    a = JaxStore.from_state(st)
    b = VectorStore.from_state(st, device=CPU)
    v = (x[7] + 0.05).astype(np.float32)
    for s in (a, b):
        s.insert("fresh", v)
    row = a._id_to_row["fresh"]
    assert b._id_to_row["fresh"] == row
    np.testing.assert_array_equal(b._rq_codes[row].numpy(),
                                  np.asarray(a._rq_codes)[row])
    np.testing.assert_allclose(float(b._norms[row]),
                               float(np.asarray(a._norms)[row]), rtol=1e-5)
    assert b.search(v, k=1, nprobe=16)[0][0] == "fresh"
