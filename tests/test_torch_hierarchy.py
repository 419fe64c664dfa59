"""The hierarchical cell-probe route through the port's entry points, on the
CPU, and the build's repaired functions against their earlier forms.

``CellProbeIndex.build`` adds the routing hierarchy from ``HIER_MIN_CELLS``
cells on (131,072: ~12.6M rows at the index manager's defaults).  Here the
threshold is patched down to 64 cells, so the manager's default
``cellprobe`` over a 12,000-row store (125 cells of 96 rows) builds the
hierarchy, and the route is driven over MCP: build, ``search_index``,
``calibrate_index`` with ``recall_target``, ``save_all``/``load_indexes``.
The same hierarchical arrays loaded into the JAX package's
``CellProbeIndex.from_arrays`` hold the port's route to the reference's.

The repaired build functions (k-means++ seeding without a host sync per
centroid, the choice lists by a top-k selection, the straggler pass on the
device with the greedy, the encode on the device in row chunks, the
hierarchy's cell moves on the device, the row norms only where a layout
scores with them)
are each held bit for bit to the form they replace, kept here as the
reference, on seeded inputs.
"""

import json
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from erlvectordb_tpu.core.cell_probe import CellProbeIndex as JIndex
import erlvectordb_tpu_torch.api as tapi
import erlvectordb_tpu_torch.core.ivf as tivf
import erlvectordb_tpu_torch.ops.index_build as tib
import erlvectordb_tpu_torch.ops.kmeans as tkm
from erlvectordb_tpu_torch.api import Database
from erlvectordb_tpu_torch.core.cell_probe import CellProbeIndex
from erlvectordb_tpu_torch.core.index_manager import IndexManager
from erlvectordb_tpu_torch.core.store import VectorStore
from erlvectordb_tpu_torch.infra.config import load_config
from erlvectordb_tpu_torch.ops.fused_topk import full_f32_matmul
from erlvectordb_tpu_torch.serve.mcp_server import MCPServer

torch.set_num_threads(2)

CPU = torch.device("cpu")
ROWS, DIM, HELD = 12_000, 32, 48
HIER_CELLS = 64        # the patched threshold; the build makes 125 cells


def clustered(n, d, seed, n_centers=64, noise=0.25):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    return (centers[rng.integers(0, n_centers, n)]
            + noise * rng.standard_normal((n, d)).astype(np.float32))


class Client:
    def __init__(self, port, token):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=60)
        self.buf = b""
        self.token = token
        self.next_id = 0

    def tool(self, tool_name, **args):
        self.next_id += 1
        req = {"jsonrpc": "2.0", "id": self.next_id, "method": "tools/call",
               "params": {"name": tool_name, "arguments": args},
               "auth": {"token": self.token}}
        self.sock.sendall((json.dumps(req) + "\n").encode())
        while b"\n" not in self.buf:
            chunk = self.sock.recv(1 << 16)
            if not chunk:
                raise ConnectionError("server closed")
            self.buf += chunk
        line, self.buf = self.buf.split(b"\n", 1)
        resp = json.loads(line)
        if "error" in resp:
            raise RuntimeError(resp["error"])
        return json.loads(resp["result"]["content"][0]["text"])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A CPU Database (persistence in a temp directory) serving a 12,000 x
    32 euclidean f32 store over MCP, with the manager's default cellprobe
    index built past the patched threshold."""
    root = tmp_path_factory.mktemp("hier")
    cfg = load_config(overrides={"persistence_dir": str(root / "data"),
                                 "backup_dir": str(root / "backups"),
                                 "sync_interval": 3600}, env={})
    data = clustered(ROWS, DIM, seed=0)
    held = clustered(HELD, DIM, seed=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CellProbeIndex, "HIER_MIN_CELLS", HIER_CELLS)
        db = Database(cfg, device=CPU).start()
        server = None
        try:
            db.registry.adopt(VectorStore.from_matrix(
                "h", data, metric="euclidean", dtype="float32", device=CPU))
            server = MCPServer(db, host="127.0.0.1", port=0).start()
            token = db.oauth.grant_client_credentials(
                "erlvectordb_client", "erlvectordb_secret")["access_token"]
            cl = Client(server._sock.getsockname()[1], token)
            cl.tool("create_index", name="hier", store="h", type="cellprobe")
            info = cl.tool("build_index", name="hier")
            yield db, cl, info, held, root
            cl.sock.close()
        finally:
            if server is not None:
                server.stop()
            db.stop()


def _mcp_answers(cl, qs, **probe):
    out = []
    for q in qs:
        r = cl.tool("search_index", name="hier", vector=q.tolist(), k=10,
                    **probe)
        out.append([(h["id"], h["distance"]) for h in r["results"]])
    return out


def _direct(indexes, qs, **probe):
    return [[(vid, d) for vid, _meta, d in
             indexes.search("hier", q, k=10, **probe)] for q in qs]


def test_default_build_over_mcp_is_hierarchical(served):
    _db, _cl, info, _held, _root = served
    st = info["stats"]
    assert info["built"] and st["hierarchical"]
    assert st["build"]["cells"] == -(-ROWS // 96) >= HIER_CELLS
    # 125 cells in 2 supercells of child_cap 240 (the reference's rule)
    assert st["supercells"] == 2 and st["n_cells"] == 2 * 240
    assert st["rows"] == ROWS
    for phase in ("kpp_s", "lloyd_s", "choices_s", "greedy_s",
                  "stragglers_s", "encode_s", "upload_s", "hierarchy_s"):
        assert st["build"][phase] >= 0.0, phase


@pytest.mark.parametrize("probe", [{}, {"nprobe": 8}, {"nprobe": 64}],
                         ids=["default", "np8", "np64"])
def test_search_index_equals_direct_search(served, probe):
    db, cl, _info, held, _root = served
    got = _mcp_answers(cl, held, **probe)
    want = _direct(db.indexes, held, **probe)
    assert [[i for i, _ in g] for g in got] == [[i for i, _ in w] for w in want]
    np.testing.assert_allclose([[d for _, d in g] for g in got],
                               [[d for _, d in w] for w in want], rtol=1e-6)


def test_calibrate_then_recall_target(served):
    db, cl, _info, held, _root = served
    out = cl.tool("calibrate_index", name="hier")
    assert out["mode"] == "exact"
    curve = {int(p): r for p, r in out["curve"].items()}
    target = curve[16]
    idx = db.indexes._indexes["hier"].probe_artifact()
    picked = idx.nprobe_for(target, k=10, metric="euclidean")
    assert picked <= 16 and curve[picked] >= target
    got = _mcp_answers(cl, held[:16], recall_target=target)
    want = _direct(db.indexes, held[:16], nprobe=picked)
    assert [[i for i, _ in g] for g in got] == [[i for i, _ in w] for w in want]
    with pytest.raises(RuntimeError, match="ceiling"):
        cl.tool("search_index", name="hier", vector=held[0].tolist(), k=10,
                recall_target=min(1.0, out["ceiling"] + 0.01))


def test_save_and_load_keep_the_hierarchy(served, tmp_path):
    db, _cl, _info, held, _root = served
    before = _direct(db.indexes, held)
    assert db.indexes.save_all(tmp_path) >= 1
    fresh = IndexManager(db.registry)
    assert "hier" in fresh.load_indexes(tmp_path)
    idx = fresh._indexes["hier"].probe_artifact()
    assert idx.super_route is not None and idx.child_cap == 240
    assert fresh.get_index_info("hier")["stats"]["hierarchical"]
    assert _direct(fresh, held) == before


@pytest.mark.parametrize("nprobe", [8, 16])
def test_jax_route_on_the_same_arrays(served, nprobe):
    """The port's hierarchical arrays in the JAX package's from_arrays
    (its CPU path): the same ids on >= 99% of entries, overlap@10 >= 0.99,
    distances within 1e-5 relative where the ids agree."""
    db, _cl, _info, held, _root = served
    tidx = db.indexes._indexes["hier"].probe_artifact()
    jidx = JIndex.from_arrays({k: np.asarray(v)
                               for k, v in tidx.to_arrays().items()})
    assert jidx.super_route is not None and jidx.child_cap == tidx.child_cap
    qs = np.pad(held, ((0, 0), (0, 128 - DIM)))
    jd, jr = jidx.search(qs, k=10, nprobe=nprobe, metric="euclidean")
    td, tr = tidx.search(qs, k=10, nprobe=nprobe, metric="euclidean")
    jd, jr = np.asarray(jd), np.asarray(jr)
    assert np.mean(jr == tr) >= 0.99
    assert np.mean([len(set(a) & set(b)) / 10 for a, b in zip(jr, tr)]) >= 0.99
    same = (jr == tr) & np.isfinite(jd)
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-5)


# ---------------------------------------------------------------- repairs


def _kpp_multinomial(x, gen, k):
    """k-means++ seeding as it was: one torch.multinomial draw, read back
    to the host, per centroid (the distances summed in the seeding's own
    order, ops/index_build.py::row_d2)."""
    n = x.shape[0]
    first = int(torch.randint(0, n, (1,), generator=gen, device=gen.device))
    cents = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    cents[0] = x[first]
    mind2 = tib.row_d2(x, x[first])
    for i in range(1, k):
        w = torch.clamp(mind2, min=1e-20)
        idx = int(torch.multinomial(w / w.sum(), 1, generator=gen))
        cents[i] = x[idx]
        mind2 = torch.minimum(mind2, tib.row_d2(x, x[idx]))
    return cents


@pytest.mark.parametrize("n,k", [(3000, 200), (257, 257)])
def test_kpp_draws_the_centroids_multinomial_drew(n, k):
    x = torch.from_numpy(clustered(n, 24, seed=n))
    g_old, g_new = torch.Generator(), torch.Generator()
    g_old.manual_seed(5)
    g_new.manual_seed(5)
    assert torch.equal(tkm._kpp_init(x, g_new, k), _kpp_multinomial(x, g_old, k))


@pytest.mark.parametrize("shape,j,levels", [
    ((64, 300), 32, 7),      # many ties, across the cut and inside the j
    ((40, 120), 5, 1000),    # few ties
    ((9, 16), 16, 3),        # j = every column: the stable sort itself
    ((30, 50), 49, 4),
])
def test_nearest_is_the_stable_sorts_first_j(shape, j, levels):
    rng = np.random.default_rng(sum(shape) + j)
    d2 = torch.from_numpy(rng.integers(0, levels, shape).astype(np.float32)
                          - levels / 2)
    vals, ids = tivf._nearest(d2, j)
    sv, si = torch.sort(d2, dim=1, stable=True)
    assert torch.equal(vals, sv[:, :j]) and torch.equal(ids, si[:, :j])


def _assign_whole_pass(data, centroids, cap, j):
    """_balanced_assign as it was: the greedy in numpy on the host, then
    the stragglers against one [stragglers, open cells] product brought to
    the host, a full argsort of each straggler's row."""
    n, c = data.shape[0], centroids.shape[0]
    j = min(j, c)
    cj = torch.as_tensor(centroids)
    xj = torch.as_tensor(data)
    d_all, i_all = tivf._top_choices_all(xj, cj, j=j, chunk=4096)
    ch_d, ch_i = d_all.numpy(), i_all.numpy().astype(np.int32)
    owner = np.full(n, -1, np.int64)
    fill = np.zeros(c, np.int64)
    remaining = np.arange(n)
    for round_j in range(j):
        if remaining.size == 0:
            break
        cells = ch_i[remaining, round_j].astype(np.int64)
        by_dist = np.argsort(ch_d[remaining, round_j], kind="stable")
        rr, cc = remaining[by_dist], cells[by_dist]
        by_cell = np.argsort(cc, kind="stable")
        rr, cc = rr[by_cell], cc[by_cell]
        rank = np.arange(rr.size) - np.searchsorted(cc, np.arange(c))[cc]
        accept = rank < (cap - fill[cc])
        owner[rr[accept]] = cc[accept]
        fill += np.bincount(cc[accept], minlength=c)
        remaining = rr[~accept]
    stragglers = remaining.size
    if remaining.size:
        open_cells = np.where(fill < cap)[0]
        with full_f32_matmul():
            dists_all = (xj[torch.as_tensor(remaining)]
                         @ cj[torch.as_tensor(open_cells)].T).numpy()
        cn = (centroids[open_cells] ** 2).sum(axis=1)
        d2 = cn[None, :] - 2.0 * dists_all
        for ri in np.argsort(d2.min(axis=1), kind="stable"):
            for oc in np.argsort(d2[ri], kind="stable"):
                cell = open_cells[oc]
                if fill[cell] < cap:
                    owner[remaining[ri]] = cell
                    fill[cell] += 1
                    break
    return owner, stragglers


@pytest.mark.parametrize("prefs,elems", [(64, 1 << 28), (1, 700), (3, 97)],
                         ids=["one-chunk", "fallback-chunks", "short-lists"])
@pytest.mark.parametrize("kind", ["clustered", "ties"])
def test_greedy_and_stragglers_place_rows_as_before(monkeypatch, prefs,
                                                    elems, kind):
    """Two choices a row and cells of 20 slots over 1,000 rows in 64 cells
    leave stragglers; patched preference depths and chunk sizes drive the
    chunked pass and its full-row fallback.  ``ties``: rows and centroids
    on an integer grid, so distances tie (zeros among them) in the greedy's
    sorts and the stragglers' lists."""
    monkeypatch.setattr(tivf, "_STRAGGLER_PREFS", prefs)
    monkeypatch.setattr(tivf, "_STRAGGLER_ELEMS", elems)
    if kind == "ties":
        rng = np.random.default_rng(3)
        data = rng.integers(-2, 3, (1000, 16)).astype(np.float32)
        cents = rng.integers(-2, 3, (64, 16)).astype(np.float32)
        cents[1] = cents[0]
    else:
        data = clustered(1000, 16, seed=3, n_centers=6)
        cents = clustered(64, 16, seed=4, n_centers=6)
    stats = {}
    got = tivf._balanced_assign(data, cents, 20, j=2, device=CPU, stats=stats)
    want, stragglers = _assign_whole_pass(data, cents, 20, 2)
    assert stats["stragglers"] == stragglers > 20
    np.testing.assert_array_equal(got, want)
    assert np.bincount(got, minlength=64).max() <= 20


def test_encode_tasks_give_the_whole_array_encode(monkeypatch):
    """The encode in row chunks (of 37 rows here) on tensors, against the
    numpy encode of the whole array."""
    monkeypatch.setattr(tib, "_ENCODE_ELEMS", 37 * 128)
    rng = np.random.default_rng(8)
    data = clustered(900, 128, seed=8)
    cents = data[rng.choice(900, 40, replace=False)] + 0.01
    owner = np.repeat(np.arange(40), 30)[rng.permutation(1200)[:900]]
    rows = rng.permutation(5000)[:900].astype(np.int64)
    cap = 32
    t = torch.from_numpy
    codes, scales, norms, valid, row_map = (a.numpy() for a in tib.encode_cells(
        t(data), t(rows), t(owner), t(cents), cap))
    # the encode as it was, on whole arrays
    order = np.argsort(owner, kind="stable")
    oc = owner[order]
    slot = np.arange(900) - np.searchsorted(oc, np.arange(40))[oc]
    res = data[order] - cents[oc]
    absmax = np.abs(res).max(axis=1)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    codes_rows = np.clip(np.round(res / scale[:, None]), -127, 127).astype(np.int8)
    dest = oc * cap + slot
    recon = cents[oc] + codes_rows.astype(np.float32) * scale[:, None]
    np.testing.assert_array_equal(codes[dest], codes_rows)
    np.testing.assert_array_equal(scales[dest], scale)
    np.testing.assert_array_equal(norms[dest], np.linalg.norm(recon, axis=1))
    np.testing.assert_array_equal(row_map[dest], rows[order])
    empty = np.setdiff1d(np.arange(40 * cap), dest)
    assert (row_map[empty] == -1).all() and not valid[empty].any()
    assert (scales[empty] == 1.0).all() and (codes[empty] == 0).all()


def test_hierarchy_moves_the_cells_as_the_host_scatter():
    data = clustered(4000, 32, seed=6)
    dp = np.pad(data, ((0, 0), (0, 96)))
    flat = CellProbeIndex.build(dp, np.arange(4000, dtype=np.int64),
                                cell_rows=24, cell_cap=32, iters=4,
                                device=CPU)
    h = flat._with_hierarchy(seed=2, iters=4, child_target=24)
    # the cells moved on the host, as they were
    cents = flat.centroids.numpy()
    k0, cap = flat.n_cells, flat.cell_cap
    sc, _ = tkm.kmeans_fit(flat.centroids, 3, k=max(2, -(-k0 // 24)),
                           iters=4, init="kpp")
    owner = tivf._balanced_assign(cents, sc.numpy(), h.child_cap, device=CPU)
    order = np.argsort(owner, kind="stable")
    oc = owner[order]
    dest = oc * h.child_cap + (np.arange(k0)
                               - np.searchsorted(oc, np.arange(len(sc)))[oc])
    k_new = len(sc) * h.child_cap

    def scatter(arr, fill):
        out = np.full((k_new,) + arr.shape[1:], fill, arr.dtype)
        out[dest] = arr[order]
        return out

    np.testing.assert_array_equal(h.centroids.numpy(), scatter(cents, 1e6))
    np.testing.assert_array_equal(
        h.codes.numpy(),
        scatter(flat.codes.numpy().reshape(k0, cap, -1), 0).reshape(k_new * cap, -1))
    for name, fill in (("scales", 1.0), ("norms", 0.0)):
        np.testing.assert_array_equal(
            getattr(h, name).numpy(),
            scatter(getattr(flat, name).numpy().reshape(k0, cap), fill).reshape(-1))
    np.testing.assert_array_equal(
        h.row_map, scatter(flat.row_map.reshape(k0, cap), -1).reshape(-1))
    np.testing.assert_array_equal(h.valid.numpy(), h.row_map >= 0)
    np.testing.assert_array_equal(h.super_route.float().numpy(),
                                  sc.to(torch.bfloat16).float().numpy())


def test_ivf_scores_with_the_rows_norms():
    """The row norms are computed for the IVF layouts alone; an ivf build's
    cell norms are its rows' norms."""
    db = Database(load_config(overrides={"persistence_enabled": False},
                              env={}), device=CPU)
    data = clustered(2000, 24, seed=12)
    db.registry.adopt(VectorStore.from_matrix("n", data, metric="euclidean",
                                              device=CPU))
    mat, rows = IndexManager._store_matrix(db.registry.get("n"))
    np.testing.assert_array_equal(mat.numpy(), data)
    db.create_index("iv", "n", "ivf", {"n_cells": 16})
    assert db.build_index("iv")["built"]
    ivf = db.indexes._indexes["iv"].artifact["ivf"]
    cell_rows = ivf.cell_rows.numpy()
    ok = cell_rows >= 0
    np.testing.assert_array_equal(
        ivf.cell_norms.numpy()[ok],
        IndexManager._row_norms(data)[cell_rows[ok]])
    np.testing.assert_array_equal(IndexManager._row_norms(data),
                                  np.linalg.norm(data, axis=1).astype(np.float32))


# ------------------------------------------------------------- module gaps


def test_default_database_is_one_started_instance(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)          # the default persistence_dir: ./data
    monkeypatch.setattr(tapi, "_default_db", None)
    db = tapi.default_database(device="cpu")
    try:
        assert db._started and db.device == CPU
        assert tapi.default_database() is db
        assert tapi.default_database(device="cpu") is db
        with pytest.raises(ValueError, match="runs on cpu"):
            tapi.default_database(device="cuda")
        db.create_store("s", dim=4)
    finally:
        db.stop()
    assert (tmp_path / "data").is_dir()


def test_application_is_exported_lazily():
    code = ("import sys, erlvectordb_tpu_torch as p; "
            "assert 'erlvectordb_tpu_torch.app' not in sys.modules; "
            "from erlvectordb_tpu_torch.app import Application; "
            "assert p.Application is Application; "
            "from erlvectordb_tpu_torch.infra.config import load_config; "
            "app = p.Application(load_config(overrides={"
            "'persistence_enabled': False}, env={}), device='cpu'); "
            "assert app.db.device.type == 'cpu'; app.db.stop(); print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
