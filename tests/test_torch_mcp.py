"""The slice as a whole: the port's MCP server (erlvectordb_tpu_torch/serve/
mcp_server.py) against the JAX package's, over real sockets.

Both Databases run with ``persistence_enabled=False`` and serve on
127.0.0.1:0.  One script drives both: initialize -> create_store (int8,
cosine) -> 300 pipelined insert_vector -> search_vectors ->
search_vectors_batch (vectors_b64, compact and b64 answers) ->
delete_vector -> search again, plus the error probes of the verify recipe
(bad base64, b64 length not a multiple of dim, missing vector, unknown
store, a garbage line mid-stream).  Answers must be equal: the same ids in
the same order, distances to 1e-5, the same error codes and messages.
"""

import base64
import json
import socket

import numpy as np
import pytest
import torch

from erlvectordb_tpu.api import Database as JaxDatabase
from erlvectordb_tpu.infra.config import load_config as jax_load_config
from erlvectordb_tpu.serve.mcp_server import MCPServer as JaxMCPServer
from erlvectordb_tpu_torch.api import Database
from erlvectordb_tpu_torch.infra.config import load_config
from erlvectordb_tpu_torch.serve.mcp_server import MCPServer

torch.set_num_threads(2)

DIM = 48
INDEX_TOOLS = ["create_index", "build_index", "list_indexes", "search_index",
               "calibrate_index", "drop_index"]
PERSIST_TOOLS = ["sync_store", "backup_store", "restore_store", "list_backups",
                 "delete_store"]


class Client:
    def __init__(self, port, token):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        self.buf = b""
        self.token = token
        self._id = 0

    def _line(self):
        while b"\n" not in self.buf:
            chunk = self.sock.recv(1 << 16)
            if not chunk:
                raise ConnectionError("server closed")
            self.buf += chunk
        line, self.buf = self.buf.split(b"\n", 1)
        return json.loads(line)

    def send_raw(self, data: bytes):
        self.sock.sendall(data)
        return self._line()

    def pipeline(self, calls):
        """Send every request before reading; answers may come back out of
        order (batcher callbacks), so match them by id."""
        ids = []
        out = b""
        for method, params in calls:
            self._id += 1
            ids.append(self._id)
            req = {"jsonrpc": "2.0", "id": self._id, "method": method,
                   "params": params, "auth": {"token": self.token}}
            out += (json.dumps(req) + "\n").encode()
        self.sock.sendall(out)
        got = {}
        while len(got) < len(ids):
            resp = self._line()
            got[resp["id"]] = resp
        return [got[i] for i in ids]

    def call(self, method, params=None):
        return self.pipeline([(method, params or {})])[0]

    def tool(self, tool_name, **args):
        resp = self.call("tools/call", {"name": tool_name, "arguments": args})
        if "error" in resp:
            return resp["error"]
        return json.loads(resp["result"]["content"][0]["text"])

    def close(self):
        self.sock.close()


def _serve(db_cls, server_cls, cfg, **db_kw):
    db = db_cls(cfg, **db_kw).start()
    server = server_cls(db, host="127.0.0.1", port=0).start()
    port = server._sock.getsockname()[1]
    token = db.oauth.grant_client_credentials(
        "erlvectordb_client", "erlvectordb_secret")["access_token"]
    return db, server, Client(port, token)


@pytest.fixture(scope="module")
def pair():
    overrides = {"persistence_enabled": False}
    jax_side = _serve(JaxDatabase, JaxMCPServer,
                      jax_load_config(overrides=overrides, env={}))
    port_side = _serve(Database, MCPServer,
                       load_config(overrides=overrides, env={}),
                       device=torch.device("cpu"))
    yield port_side[2], jax_side[2]
    for db, server, client in (jax_side, port_side):
        client.close()
        server.stop()
        db.stop()


def _both(pair, fn):
    return fn(pair[0]), fn(pair[1])


def _b64(a):
    return base64.b64encode(np.ascontiguousarray(a, "<f4").tobytes()).decode()


def _same_results(got, want):
    assert [h["id"] for h in got["results"]] == [h["id"] for h in want["results"]]
    assert ([h["metadata"] for h in got["results"]]
            == [h["metadata"] for h in want["results"]])
    np.testing.assert_allclose([h["distance"] for h in got["results"]],
                               [h["distance"] for h in want["results"]],
                               atol=1e-5)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    centers = rng.standard_normal((12, DIM)).astype(np.float32)
    x = (centers[rng.integers(0, 12, 300)]
         + 0.35 * rng.standard_normal((300, DIM))).astype(np.float32)
    q = (centers[rng.integers(0, 12, 40)]
         + 0.35 * rng.standard_normal((40, DIM))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def filled(pair, data):
    x, _ = data

    def run(c):
        init = c.call("initialize", {"protocolVersion": "2024-11-05"})
        created = c.tool("create_store", name="s", dimension=DIM,
                         metric="cosine", dtype="int8")
        acks = c.pipeline([
            ("tools/call", {"name": "insert_vector", "arguments": {
                "store": "s", "id": f"v{i}", "vector": x[i].tolist(),
                "metadata": {"g": i % 5}}})
            for i in range(len(x))])
        return init, created, acks

    return _both(pair, run)


def test_initialize_create_insert(filled):
    (init_t, created_t, acks_t), (init_j, created_j, acks_j) = filled
    assert init_t["result"] == init_j["result"]
    assert created_t == created_j
    assert [a["result"] for a in acks_t] == [a["result"] for a in acks_j]
    assert acks_t[-1]["result"]["content"][0]["text"] == json.dumps(
        {"status": "ok", "store": "s", "id": "v299"})


def test_search_vectors(pair, filled, data):
    _, q = data
    for i in range(6):
        args = dict(store="s", vector=q[i].tolist(), k=10)
        if i % 2:
            args = dict(store="s", vector_b64=_b64(q[i]), k=7)
        if i == 5:
            args["filter"] = {"g": 2}
        got, want = _both(pair, lambda c: c.tool("search_vectors", **args))
        assert len(want["results"]) == args["k"]
        _same_results(got, want)


def test_search_vectors_batch(pair, filled, data):
    _, q = data
    common = dict(store="s", vectors_b64=_b64(q), dim=DIM, k=10)
    got, want = _both(pair, lambda c: c.tool("search_vectors_batch", compact=True,
                                             **common))
    assert got["ids"] == want["ids"] and len(got["ids"]) == len(q)
    np.testing.assert_allclose(got["distances"], want["distances"], atol=1e-5)
    got, want = _both(pair, lambda c: c.tool("search_vectors_batch",
                                             encoding="b64", **common))
    assert (got["count"], got["k"]) == (want["count"], want["k"]) == (40, 10)
    rows = [np.frombuffer(base64.b64decode(r["rows_b64"]), "<i4")
            for r in (got, want)]
    dists = [np.frombuffer(base64.b64decode(r["distances_b64"]), "<f4")
             for r in (got, want)]
    np.testing.assert_array_equal(rows[0], rows[1])
    np.testing.assert_allclose(dists[0], dists[1], atol=1e-5)
    got, want = _both(pair, lambda c: c.tool(
        "search_vectors_batch", store="s", vectors=q[:3].tolist(), k=4))
    for g, w in zip(got["results"], want["results"]):
        _same_results({"results": g}, {"results": w})


def test_delete_then_search(pair, filled, data):
    x, _ = data
    first = _both(pair, lambda c: c.tool("search_vectors", store="s",
                                         vector=x[17].tolist(), k=3))
    assert [r["results"][0]["id"] for r in first] == ["v17", "v17"]
    acks = _both(pair, lambda c: c.tool("delete_vector", store="s", id="v17"))
    assert acks[0] == acks[1] == {"status": "ok"}
    got, want = _both(pair, lambda c: c.tool("search_vectors", store="s",
                                             vector=x[17].tolist(), k=3))
    assert "v17" not in [h["id"] for h in got["results"]]
    _same_results(got, want)
    again = _both(pair, lambda c: c.tool("delete_vector", store="s", id="v17"))
    assert again[0] == again[1]
    stats = _both(pair, lambda c: c.tool("get_store_stats", store="s"))
    assert stats[0] == stats[1] and stats[0]["count"] == 299
    lists = _both(pair, lambda c: c.tool("list_stores"))
    assert lists[0] == lists[1] == {"stores": ["s"]}


@pytest.mark.parametrize("probe", ["bad_b64", "ragged_b64", "missing_vector",
                                   "unknown_store", "unknown_tool"])
def test_error_probes(pair, filled, probe):
    args = {
        "bad_b64": ("search_vectors", dict(store="s", vector_b64="@@not b64@@")),
        "ragged_b64": ("search_vectors_batch",
                       dict(store="s", vectors_b64=_b64(np.ones(DIM + 1)),
                            dim=DIM)),
        "missing_vector": ("search_vectors", dict(store="s")),
        "unknown_store": ("search_vectors", dict(store="nope",
                                                 vector=[0.0] * DIM)),
        "unknown_tool": ("no_such_tool", {}),
    }[probe]
    got, want = _both(pair, lambda c: c.tool(args[0], **args[1]))
    assert got == want and "code" in got, (got, want)


def test_garbage_line_keeps_connection(pair, filled):
    bad = _both(pair, lambda c: c.send_raw(b"{this is not json\n"))
    assert bad[0] == bad[1] and bad[0]["error"]["code"] == -32700
    after = _both(pair, lambda c: c.call("ping"))
    assert after[0]["result"] == after[1]["result"] == {}


def test_tools_list_is_the_ported_subset(pair):
    """The port lists the JAX server's 19 tools, each with the JAX package's
    schema (create_store adds the port's intkey flag); multiprobe on a store
    without cells is the JAX package's error."""
    tools = pair[0].call("tools/list")["result"]["tools"]
    jax_tools = {t["name"]: t for t in pair[1].call("tools/list")["result"]["tools"]}
    assert len(tools) == 19
    assert sorted(t["name"] for t in tools) == sorted(jax_tools)
    assert set(INDEX_TOOLS + PERSIST_TOOLS) <= set(jax_tools)
    for t in tools:
        if t["name"] == "create_store":
            props = dict(t["inputSchema"]["properties"])
            assert props.pop("intkey")["type"] == "boolean"
            assert props == jax_tools[t["name"]]["inputSchema"]["properties"]
        else:
            assert t == jax_tools[t["name"]], t["name"]
    got, want = _both(pair, lambda c: c.tool(
        "search_vectors", store="s", vector=[0.0] * DIM, nprobe=4))
    # the JAX message goes on to name its index types, not ported yet
    assert got["code"] == want["code"] and "int4r" in got["message"]
    assert got["message"] == want["message"].split(";")[0]


def test_persistence_is_refused(tmp_path):
    """Persistence runs with the default configuration, and a snapshot of a
    store sharded over a device mesh (the JAX package's format) is no
    longer refused: the port's Database starts with it as a distributed
    store on its cluster mesh and answers as the JAX store did."""
    from erlvectordb_tpu.parallel import ShardedVectorStore as JSharded
    from erlvectordb_tpu.parallel import make_mesh as jmake_mesh
    from erlvectordb_tpu.persist.snapshot import save_store
    from erlvectordb_tpu_torch.parallel import ShardedVectorStore

    cfg = load_config(overrides={"persistence_dir": str(tmp_path / "data"),
                                 "backup_dir": str(tmp_path / "backups"),
                                 "sync_interval": 9999}, env={})
    Database(cfg, device=torch.device("cpu")).start().stop()
    x = np.random.default_rng(5).standard_normal((60, DIM)).astype(np.float32)
    j = JSharded("sh", jmake_mesh(n_data=1, n_replica=1))
    j.insert_batch([f"r{i}" for i in range(60)], x)
    save_store(j, tmp_path / "data")
    db = Database(cfg, device=torch.device("cpu")).start()
    try:
        got = db.any_store("sh")
        assert isinstance(got, ShardedVectorStore) and got.count == 60
        assert "sh" in db.list_stores()
        assert ([h[0] for h in db.search("sh", x[7], k=3)]
                == [h[0] for h in j.search(x[7], k=3)])
    finally:
        db.stop()


def test_int4_store_over_mcp(pair, data):
    """create_store dtype=int4 on both servers, the same rows, the same
    answers (both exact scans on the CPU)."""
    x, _ = data
    port, jax_ = pair
    for c in (port, jax_):
        made = c.tool("create_store", name="i4", dimension=DIM,
                      metric="cosine", dtype="int4")
        assert made["dtype"] == "int4"
        c.pipeline([("tools/call", {"name": "insert_vector", "arguments": {
            "store": "i4", "id": f"r{i}", "vector": x[i].tolist()}})
            for i in range(120)])
    got, want = _both(pair, lambda c: c.tool(
        "search_vectors", store="i4", vector=x[7].tolist(), k=5))
    _same_results(got, want)
    assert got["results"][0]["id"] == "r7"
    schema = {t["name"]: t for t in port.call("tools/list")["result"]["tools"]}
    assert "int4" in schema["create_store"]["inputSchema"]["properties"][
        "dtype"]["enum"]


# ------------------------------------------------- multiprobe over MCP


@pytest.fixture(scope="module")
def mp_pair():
    """Both servers holding the same int4r store: JAX-built, carried into
    the port by export_state -> from_state."""
    from erlvectordb_tpu.core.store import VectorStore as JaxStore
    from erlvectordb_tpu_torch.core.store import VectorStore

    rng = np.random.default_rng(41)
    centers = rng.standard_normal((40, DIM)).astype(np.float32)
    x = (centers[rng.integers(0, 40, 5000)]
         + 0.25 * rng.standard_normal((5000, DIM)).astype(np.float32))
    q = (centers[rng.integers(0, 40, 16)]
         + 0.25 * rng.standard_normal((16, DIM)).astype(np.float32))
    overrides = {"persistence_enabled": False}
    jax_side = _serve(JaxDatabase, JaxMCPServer,
                      jax_load_config(overrides=overrides, env={}))
    port_side = _serve(Database, MCPServer,
                       load_config(overrides=overrides, env={}),
                       device=torch.device("cpu"))
    js = JaxStore.from_matrix("r", x, dtype="int4r")
    port_side[0].registry.adopt(
        VectorStore.from_state(js.export_state(), device=torch.device("cpu")))
    jax_side[0].registry.adopt(js)
    yield (port_side[2], jax_side[2]), x, q
    for db, server, client in (jax_side, port_side):
        client.close()
        server.stop()
        db.stop()


@pytest.mark.parametrize("probe", [{"nprobe": 1}, {"nprobe": 6},
                                   {"recall_target": 0.9}])
def test_multiprobe_search_over_mcp(mp_pair, probe):
    """search_vectors and search_vectors_batch (json, compact, b64) with
    nprobe or recall_target: the same answers from both servers."""
    pair, x, q = mp_pair
    got, want = _both(pair, lambda c: c.tool(
        "search_vectors", store="r", vector=q[0].tolist(), k=5, **probe))
    _same_results(got, want)
    got, want = _both(pair, lambda c: c.tool(
        "search_vectors_batch", store="r", vectors=q.tolist(), k=5, **probe))
    for g, w in zip(got["results"], want["results"]):
        _same_results({"results": g}, {"results": w})
    got, want = _both(pair, lambda c: c.tool(
        "search_vectors_batch", store="r", vectors_b64=_b64(q), dim=DIM, k=5,
        compact=True, **probe))
    assert got["ids"] == want["ids"]
    np.testing.assert_allclose(got["distances"], want["distances"],
                               rtol=1e-5, atol=1e-5)
    got, want = _both(pair, lambda c: c.tool(
        "search_vectors_batch", store="r", vectors_b64=_b64(q), dim=DIM, k=5,
        encoding="b64", **probe))
    assert got["rows_b64"] == want["rows_b64"]


@pytest.mark.parametrize("bad", [{"nprobe": 4, "recall_target": 0.9},
                                 {"nprobe": 0}, {"recall_target": 1.5}])
def test_multiprobe_bad_arguments_are_clean_errors(mp_pair, bad):
    pair, _, q = mp_pair
    for tool, args in (("search_vectors", {"vector": q[0].tolist()}),
                       ("search_vectors_batch", {"vectors": q[:2].tolist()})):
        got, want = _both(pair, lambda c: c.tool(tool, store="r", k=5,
                                                 **args, **bad))
        assert got == want and "code" in got, (got, want)


def test_calibrate_store_and_stats_over_mcp(mp_pair):
    """calibrate_store (ceiling mode) answers the same curve on both
    servers; get_store_stats then carries the calibration summary."""
    pair, _, _ = mp_pair
    got, want = _both(pair, lambda c: c.tool("calibrate_store", store="r",
                                             n_sample=64, k=7))
    assert got == want and got["mode"] == "ceiling"
    assert got["curve"][max(got["curve"], key=int)] == 1.0
    got, want = _both(pair, lambda c: c.tool("get_store_stats", store="r"))
    assert got["calibration"] == want["calibration"]
    assert {"mode": "ceiling", "ceiling": 1.0, "k": 7, "metric": "cosine",
            "n_queries": 64} in got["calibration"]


# ------------------------------------------------------ indexes over MCP

# build-time fields that differ between any two builds
_TIMES = ("built_at", "build_seconds")


def _info(d):
    return {k: v for k, v in d.items() if k not in _TIMES}


@pytest.fixture(scope="module")
def indexed(pair):
    """A float32 euclidean store filled over MCP on both servers, with a
    flat and an int8 index created and built through the index tools."""
    rng = np.random.default_rng(33)
    centers = rng.standard_normal((16, DIM)).astype(np.float32)
    x = (centers[rng.integers(0, 16, 600)]
         + 0.3 * rng.standard_normal((600, DIM))).astype(np.float32)
    q = (centers[rng.integers(0, 16, 12)]
         + 0.3 * rng.standard_normal((12, DIM))).astype(np.float32)
    for c in pair:
        c.tool("create_store", name="fx", dimension=DIM, metric="euclidean",
               dtype="float32")
        c.pipeline([("tools/call", {"name": "insert_vector", "arguments": {
            "store": "fx", "id": f"x{i}", "vector": x[i].tolist()}})
            for i in range(len(x))])
    made = _both(pair, lambda c: [
        c.tool("create_index", name=n, store="fx", type=t)
        for n, t in (("fx_flat", "flat"), ("fx_i8", "int8"))])
    built = _both(pair, lambda c: c.tool("build_index", name="fx_i8"))
    return x, q, made, built


def test_create_build_list_indexes_over_mcp(pair, indexed):
    _, _, made, built = indexed
    assert [_info(d) for d in made[0]] == [_info(d) for d in made[1]]
    assert _info(built[0]) == _info(built[1])
    assert built[0]["built"] and built[0]["stats"]["kind"] == "int8"
    got, want = _both(pair, lambda c: c.tool("list_indexes"))
    assert ([_info(d) for d in got["indexes"]]
            == [_info(d) for d in want["indexes"]])


def test_search_index_deterministic_types_over_mcp(pair, indexed):
    """flat and int8 indexes build the same thing on both servers: the same
    answers."""
    _, q, _, _ = indexed
    for name in ("fx_flat", "fx_i8"):
        for i in range(4):
            got, want = _both(pair, lambda c: c.tool(
                "search_index", name=name, vector=q[i].tolist(), k=7))
            _same_results(got, want)


@pytest.mark.parametrize("itype,params", [
    ("pq", {"m": 8, "iters": 6}),
    ("opq", {"m": 8, "iters": 6, "opq_iters": 2}),
    ("ivf", {"n_cells": 8, "nprobe": 4}),
    ("cellprobe", {"cell_rows": 32, "cell_cap": 48, "nprobe": 8}),
])
def test_build_and_search_trained_types_over_mcp(pair, indexed, itype, params):
    """Types whose build draws random numbers: built on both servers with
    the same stats kind, and each finds a stored row first."""
    x, _, _, _ = indexed
    name = f"fx_{itype}"
    built = _both(pair, lambda c: (
        c.tool("create_index", name=name, store="fx", type=itype,
               parameters=params),
        c.tool("build_index", name=name))[1])
    assert built[0]["built"] and built[1]["built"], built
    assert built[0]["stats"]["kind"] == built[1]["stats"]["kind"]
    hits = pair[0].tool("search_index", name=name, vector=x[21].tolist(), k=5)
    assert hits["results"][0]["id"] == "x21"


def test_calibrate_and_probe_knobs_over_mcp(pair, indexed):
    x, q, _, _ = indexed
    for c in pair:
        c.tool("create_index", name="fx_cal", store="fx", type="cellprobe",
               parameters={"cell_rows": 32, "cell_cap": 48})
        c.tool("build_index", name="fx_cal")
    got, want = _both(pair, lambda c: c.tool("calibrate_index", name="fx_cal",
                                             n_sample=32, k=5))
    assert got["mode"] == want["mode"] == "exact"
    assert set(got) == set(want) and got["curve"]
    hit = pair[0].tool("search_index", name="fx_cal", vector=x[3].tolist(),
                       k=3, recall_target=0.9)
    assert hit["results"][0]["id"] == "x3"
    hit = pair[0].tool("search_index", name="fx_cal", vector=x[3].tolist(),
                       k=3, nprobe=16)
    assert hit["results"][0]["id"] == "x3"


@pytest.mark.parametrize("probe", [
    "unknown_index", "unbuilt", "bad_type", "calibrate_flat", "knob_on_int8",
    "both_knobs", "drop_twice"])
def test_index_error_probes(pair, indexed, probe):
    _, q, _, _ = indexed
    v = q[0].tolist()
    if probe == "unbuilt":
        _both(pair, lambda c: c.tool("create_index", name="fx_unbuilt",
                                     store="fx", type="int8"))
    if probe == "drop_twice":
        _both(pair, lambda c: c.tool("create_index", name="fx_drop",
                                     store="fx", type="flat"))
        first = _both(pair, lambda c: c.tool("drop_index", name="fx_drop"))
        assert first[0] == first[1] == {"status": "ok"}
    name, args = {
        "unknown_index": ("search_index", dict(name="nope", vector=v)),
        "unbuilt": ("search_index", dict(name="fx_unbuilt", vector=v)),
        "bad_type": ("create_index", dict(name="b", store="fx", type="btree")),
        "calibrate_flat": ("calibrate_index", dict(name="fx_flat")),
        "knob_on_int8": ("search_index", dict(name="fx_i8", vector=v,
                                              nprobe=4)),
        "both_knobs": ("search_index", dict(name="fx_i8", vector=v, nprobe=4,
                                            recall_target=0.9)),
        "drop_twice": ("drop_index", dict(name="fx_drop")),
    }[probe]
    got, want = _both(pair, lambda c: c.tool(name, **args))
    assert got == want and "code" in got, (got, want)
