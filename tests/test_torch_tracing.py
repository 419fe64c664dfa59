"""Request-scoped spans of the port (erlvectordb_tpu_torch/utils/metrics.py)
on the CPU: the ring itself (bounded, counting what it overwrites, losing
nothing under concurrent appends), and the chain of spans one served
request leaves, under one request id, from its first byte to its reply:
an MCP ``search_vectors`` through the batcher, a gRPC ``SearchBatch`` and
an MCP ``search_index``.  Also the two repairs the spans brought: the raw
completion counted by ``store.search``, and ``mcp.<method>`` of an answer
the batcher delivers ending at its ``sendall``."""

import base64
import json
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

from erlvectordb_tpu_torch.api import Database
from erlvectordb_tpu_torch.core.store import VectorStore
from erlvectordb_tpu_torch.infra.config import load_config
from erlvectordb_tpu_torch.serve.mcp_server import MCPServer
from erlvectordb_tpu_torch.utils.metrics import MetricsRegistry, metrics, now_ns

DIM = 16
ROWS = 400


# --------------------------------------------------------------- the ring


def test_ring_is_bounded_and_counts_drops():
    r = MetricsRegistry(span_capacity=8)
    for i in range(20):
        r.record("s", i + 1, 0, 1000 * i, 1000 * i + 10)
    assert r.snapshot()["counters"]["trace.dropped"] == 12
    assert "evdb_trace_dropped 12" in r.prometheus()
    # the 8 newest remain; a window that overwritten records may have met
    # (the oldest left, 12,000-12,010 ns, ends inside it) reads None
    assert r.spans_between(12.5e-6, 1) == [
        ("s", i + 1, 0, 1000 * i, 1000 * i + 10, 1) for i in range(13, 20)]
    assert r.spans_between(12e-6, 1) is None
    assert r.spans_between(0, 1) is None
    assert len(r._ring._buf) == 8 * 48


def test_ring_capacity_must_be_a_power_of_two():
    with pytest.raises(ValueError):
        MetricsRegistry(span_capacity=12)


def test_no_drops_reports_no_counter_and_reset_empties_the_ring():
    r = MetricsRegistry(span_capacity=16)
    with r.span("a", rid=7, n=3):
        pass
    assert "trace.dropped" not in r.snapshot()["counters"]
    [(name, rid, parent, s, e, n)] = r.spans_between(0, time.perf_counter())
    assert (name, rid, parent, n) == ("a", 7, 0, 3) and s <= e
    r.reset()
    assert r.spans_between(0, time.perf_counter()) == []


def test_begin_end_across_threads_and_bound_ids():
    r = MetricsRegistry(span_capacity=16)
    t0 = now_ns()
    ends = []
    th = threading.Thread(target=lambda: ends.append(
        r.end("x", 5, t0, n=2, parent=9)))
    th.start()
    th.join(10)
    assert not th.is_alive()
    assert r.spans_between(0, time.perf_counter()) == [
        ("x", 5, 9, t0, ends[0], 2)]
    assert r.current() == (0, 0)
    with r.bound(11, 4):
        assert r.current() == (11, 4)
        with r.span("y"):
            pass
    assert r.current() == (0, 0)
    assert r.spans_between(0, time.perf_counter())[-1][1:3] == (11, 4)
    assert r.new_id() != r.new_id()


def test_concurrent_appends_below_capacity_lose_nothing():
    r = MetricsRegistry(span_capacity=1 << 16)
    per, n_threads = 5000, 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for i in range(per):
                r.record("c", t, i, i, i + 1)
        ths = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(60)
        assert not any(th.is_alive() for th in ths)
    finally:
        sys.setswitchinterval(old)
    got = r.spans_between(0, 1)
    assert "trace.dropped" not in r.snapshot()["counters"]
    assert sorted((s[1], s[2]) for s in got) == [
        (t, i) for t in range(n_threads) for i in range(per)]


def test_reads_beside_overwriting_appends_see_no_half_written_record():
    """A ring far smaller than what 4 threads write, read all the while:
    every record read is whole (its fields all from one append)."""
    r = MetricsRegistry(span_capacity=64)
    stop = threading.Event()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(t):
        i = 0
        while not stop.is_set():
            v = t * 10_000_000 + i
            r.record(f"w{t}", v, v + 1, 3 * v, 3 * v + 2, t + 1)
            i += 1

    ths = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    reads = 0
    try:
        for th in ths:
            th.start()
        deadline = time.perf_counter() + 2.0
        while time.perf_counter() < deadline:
            recs = r._ring.records()
            rid, parent, s, e, n = (recs[f] for f in (
                "rid", "parent", "start", "end", "n"))
            t = rid // 10_000_000
            names = np.array(r._ring._names)[recs["code"]]
            assert (names == np.char.add("w", t.astype(str))).all()
            assert (parent == rid + 1).all() and (s == 3 * rid).all()
            assert (e == 3 * rid + 2).all() and (n == t + 1).all()
            reads += len(rid)
    finally:
        stop.set()
        for th in ths:
            th.join(10)
        sys.setswitchinterval(old)
    assert reads > 0
    assert r.snapshot()["counters"]["trace.dropped"] > 0


# ------------------------------------------------------- served requests


def _chain(rid, since):
    """The spans of request ``rid`` recorded since ``since``: its own, and
    those of the device batch its spans name as parent."""
    spans = metrics.spans_between(since, time.perf_counter() + 1)
    own = [s for s in spans if s[1] == rid]
    batches = {s[2] for s in own if s[2]}
    return own + [s for s in spans if s[1] in batches and s[1] != rid]


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s[0], []).append(s)
    return out


def _inside(child, parent):
    assert parent[3] <= child[3] <= child[4] <= parent[4], (child, parent)


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tracing")
    cfg = load_config(overrides={
        "persistence_enabled": False, "oauth_enabled": False,
        "persistence_dir": str(tmp / "data"),
        "backup_dir": str(tmp / "backups"), "sync_interval": 9999}, env={})
    d = Database(cfg, device=torch.device("cpu")).start()
    rng = np.random.default_rng(0)
    data = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    d.create_store("t", DIM, metric="cosine", dtype="int8")
    d.insert_batch("t", [f"v{i}" for i in range(ROWS)], data)
    d.create_index("cp", "t", "cellprobe", {"cell_rows": 32, "cell_cap": 48,
                                            "nprobe": 4})
    assert d.build_index("cp")["built"]
    d.test_data = data
    yield d
    d.stop()


def _mcp_port(srv):
    return srv._sock.getsockname()[1]


def _mcp_call(port, name, args, rid=1):
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        req = {"jsonrpc": "2.0", "id": rid, "method": "tools/call",
               "params": {"name": name, "arguments": args}}
        s.sendall((json.dumps(req) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(1 << 16)
            assert chunk, "server closed"
            buf += chunk
    resp = json.loads(buf)
    assert "result" in resp, resp
    return json.loads(resp["result"]["content"][0]["text"])


@pytest.fixture(scope="module")
def mcp_port(db):
    srv = MCPServer(db, "127.0.0.1", 0).start()
    yield _mcp_port(srv)
    srv.stop()


def _last_request(name, since):
    reqs = [s for s in metrics.spans_between(since, time.perf_counter() + 1)
            if s[0] == name]
    assert reqs, f"no {name} span"
    return reqs[-1]


def _wait_for(name, since, timeout=10.0):
    """The reply's span closes just after its sendall: wait for it."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        spans = metrics.spans_between(since, time.perf_counter() + 1)
        if any(s[0] == name for s in spans):
            return
        time.sleep(0.01)
    raise AssertionError(f"no {name} span within {timeout} s")


def test_mcp_search_vectors_chain(db, mcp_port):
    since = time.perf_counter()
    q = db.test_data[5]
    out = _mcp_call(mcp_port, "search_vectors", {
        "store": "t", "k": 3,
        "vector_b64": base64.b64encode(q.astype("<f4").tobytes()).decode()})
    assert out["results"][0]["id"] == "v5"
    _wait_for("mcp.request", since)
    req = _last_request("mcp.request", since)
    rid, bid = req[1], req[2]
    assert bid, "an answer the batcher delivered names its batch"
    spans = _by_name(_chain(rid, since))
    for name in ("mcp.parse", "batcher.queue_wait", "batcher.inflight_wait",
                 "store.submit", "batcher.completion_wait", "store.readback",
                 "store.map", "batcher.delivery_wait", "mcp.encode"):
        assert name in spans, (name, sorted(spans))
        for s in spans[name]:
            _inside(s, req)
    assert spans["mcp.parse"][0][1] == rid
    [qw] = spans["batcher.queue_wait"]
    assert (qw[1], qw[2]) == (rid, bid)
    for name in ("store.submit", "store.readback", "store.map",
                 "batcher.inflight_wait", "batcher.completion_wait",
                 "batcher.delivery_wait"):
        assert spans[name][0][1] == bid
    # in order along the request
    order = ["mcp.parse", "batcher.queue_wait", "batcher.inflight_wait",
             "store.submit", "batcher.completion_wait", "store.readback",
             "store.map", "batcher.delivery_wait", "mcp.encode"]
    ends = [spans[n][0][4] for n in order]
    assert ends == sorted(ends)


def test_mcp_search_index_chain(db, mcp_port):
    since = time.perf_counter()
    out = _mcp_call(mcp_port, "search_index", {
        "name": "cp", "k": 3, "vector": db.test_data[9].tolist()})
    assert out["results"][0]["id"] == "v9"
    _wait_for("mcp.request", since)
    req = _last_request("mcp.request", since)
    rid = req[1]
    spans = _by_name(_chain(rid, since))
    [search] = spans["index.search"]
    _inside(search, req)
    _inside(spans["mcp.parse"][0], req)
    _inside(spans["mcp.encode"][0], req)
    assert spans["mcp.parse"][0][4] <= search[3] <= search[4] \
        <= spans["mcp.encode"][0][3]
    for name in ("index.probe", "index.readback"):
        [s] = spans[name]
        _inside(s, search)
    assert len(spans["index.map"]) == 2   # row map + dedup, then the hits
    for s in spans["index.map"]:
        _inside(s, search)
    probe, rb = spans["index.probe"][0], spans["index.readback"][0]
    assert probe[4] == rb[3]
    assert all(s[1] == rid for v in spans.values() for s in v)


def test_grpc_search_batch_chain(db, monkeypatch):
    grpc = pytest.importorskip("grpc")
    from erlvectordb_tpu_torch.serve import evdb_pb2 as pb
    from erlvectordb_tpu_torch.serve.grpc_server import GrpcServer

    # grpc-python parses a request on its polling thread, then runs the
    # handler and the serializer on one pool thread: the id rides the
    # parsed request to that thread, which carries it on
    threads = {}
    opening, closing = GrpcServer._opening, GrpcServer._closing
    handler = GrpcServer.SearchBatch

    def spy(key, fn):
        def wrapped(*a):
            threads.setdefault(key, threading.get_ident())
            return fn(*a)
        return wrapped

    monkeypatch.setattr(GrpcServer, "_opening",
                        staticmethod(lambda f: spy("de", opening(f))))
    monkeypatch.setattr(GrpcServer, "_closing",
                        lambda self, f: spy("ser", closing(self, f)))
    monkeypatch.setattr(GrpcServer, "SearchBatch",
                        lambda self, r, c: spy("handler", handler)(self, r, c))
    srv = GrpcServer(db, "127.0.0.1", 0).start()
    chan = grpc.insecure_channel(f"127.0.0.1:{srv.port}")
    try:
        call = chan.unary_unary(
            "/evdb.ErlVectorDB/SearchBatch",
            request_serializer=pb.SearchBatchRequest.SerializeToString,
            response_deserializer=pb.SearchBatchReply.FromString)
        since = time.perf_counter()
        qs = db.test_data[:6].astype("<f4")
        rep = call(pb.SearchBatchRequest(store="t", vectors_f32=qs.tobytes(),
                                         dim=DIM, k=3), timeout=30)
        assert rep.count == 6 and list(rep.ids[::3]) == [
            f"v{i}" for i in range(6)]
        _wait_for("grpc.request", since)
    finally:
        chan.close()
        srv.stop()
    assert threads["handler"] == threads["ser"] and "de" in threads
    req = _last_request("grpc.request", since)
    rid = req[1]
    assert req[5] == 6
    spans = _by_name(_chain(rid, since))
    parse, rows = spans["grpc.decode"]     # the protobuf parse, the rows
    assert parse[3] == req[3] and parse[4] <= rows[3]
    for name in ("grpc.decode", "batcher.inflight_wait", "store.submit",
                 "batcher.completion_wait", "store.readback", "store.map",
                 "batcher.delivery_wait", "grpc.encode"):
        assert len(spans[name]) == (2 if name == "grpc.decode" else 1)
        for s in spans[name]:
            assert s[1] == rid and s[5] == 6, s
            _inside(s, req)
    assert spans["grpc.encode"][0][4] == req[4]   # to the serializer
    order = ["grpc.decode", "batcher.inflight_wait", "store.submit",
             "batcher.completion_wait", "store.readback", "store.map",
             "batcher.delivery_wait", "grpc.encode"]
    ends = [spans[n][-1][4] for n in order]
    assert ends == sorted(ends)


# ---------------------------------------------------------------- repairs


def test_raw_completion_counts_as_a_store_search():
    store = VectorStore("raw", device=torch.device("cpu"))
    rng = np.random.default_rng(1)
    store.insert_batch(["a", "b", "c"],
                       rng.standard_normal((3, 4)).astype(np.float32))
    before = metrics.snapshot()
    t = store.search_batch_submit(np.ones((2, 4), np.float32), k=2)
    store.search_batch_complete_raw(t)
    after = metrics.snapshot()

    def delta(kind, name, key=None):
        a, b = after[kind].get(name, 0), before[kind].get(name, 0)
        if key is not None:
            a, b = (a or {}).get(key, 0), (b or {}).get(key, 0)
        return a - b

    assert delta("counters", "store.search_total") == 1
    assert delta("counters", "store.queries_total") == 2
    assert delta("latencies", "store.search", "count") == 1


def test_async_mcp_latency_ends_at_the_reply(db, mcp_port, monkeypatch):
    """``mcp.tools_call`` of a search the batcher answers runs to the
    reply's sendall: a completion held back 0.2 s shows in it (it stopped
    at the dispatch before, reading well under that)."""
    orig = VectorStore.search_batch_complete

    def slow(self, t):
        time.sleep(0.2)
        return orig(self, t)

    monkeypatch.setattr(VectorStore, "search_batch_complete", slow)
    since = time.perf_counter()
    before = metrics.snapshot()["latencies"].get(
        "mcp.tools_call", {"count": 0, "sum_seconds": 0.0})
    q = db.test_data[3]
    out = _mcp_call(mcp_port, "search_vectors", {
        "store": "t", "k": 2,
        "vector_b64": base64.b64encode(q.astype("<f4").tobytes()).decode()})
    assert out["results"][0]["id"] == "v3"
    _wait_for("mcp.request", since)
    after = metrics.snapshot()["latencies"]["mcp.tools_call"]
    assert after["count"] == before["count"] + 1
    took = after["sum_seconds"] - before["sum_seconds"]
    req = _last_request("mcp.request", since)
    assert took >= 0.2
    assert abs(took - (req[4] - req[3]) / 1e9) < 1e-5
