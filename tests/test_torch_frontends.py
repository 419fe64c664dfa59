"""The port's frontends against the JAX package's, over real sockets.

One seeded corpus (config 3's recipe: Gaussian centres, noise 0.35; 4,096
rows x 100) fills an int8 cosine store and a float32 euclidean store in the
JAX package's ``Application`` and in the port's (``device="cpu"``), both on
the CPU.  The same queries then go through REST ``/search``, gRPC
``Search``, ``SearchBatch`` and ``StreamSearch`` and MCP ``search_vectors``
and ``search_vectors_batch`` (b64).  Between the packages the ids are equal and the distances agree to
the tolerance of the store parity tests (tests/test_torch_store.py
``_assert_same_hits``: atol 1e-5, rtol 1e-6 cosine and 1e-5 euclidean; the
packages sum the f32 rescoring in another order, so the distances are not
bit for bit).  Within the port, the MCP and gRPC batches equal the
in-process ``Database.search_batch`` bit for bit, and the single-query
frontends equal its rows to rtol 1e-6.  Also: either package's client and
stdio bridge against the other package's server, the port's health check
naming the CPU, the cluster verbs (status, a distributed store over
gRPC, join refused), a graceful stop that frees every
port and a restart that answers the same batch, and ``cli serve`` as a
process.
"""

import base64
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from erlvectordb_tpu.app import Application as JaxApplication
from erlvectordb_tpu.infra.config import load_config as jax_load_config
from erlvectordb_tpu.serve import client as jax_client
from erlvectordb_tpu.serve import stdio_bridge as jax_bridge
from erlvectordb_tpu_torch.app import Application
from erlvectordb_tpu_torch.infra.config import load_config
from erlvectordb_tpu_torch.infra.ports import probe_port
from erlvectordb_tpu_torch.serve import client as torch_client
from erlvectordb_tpu_torch.serve import stdio_bridge as torch_bridge

grpc = pytest.importorskip("grpc")

from erlvectordb_tpu.serve import evdb_pb2 as jax_pb  # noqa: E402
from erlvectordb_tpu_torch.serve import evdb_pb2 as pb  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N_ROWS, DIM, N_CENTRES, NOISE, K = 4096, 100, 1024, 0.35, 10
STORES = {"s8": dict(dtype="int8", metric="cosine"),
          "s32": dict(dtype="float32", metric="euclidean")}
# ports: JAX app, port app, restart app, cli serve process
JAX_BASE, PORT_BASE, RESTART_BASE, CLI_BASE = 27000, 27100, 27200, 27300
SERVICES = ("mcp_server", "oauth_server", "rest_api", "grpc_server",
            "health_check")
CREDS = ("erlvectordb_client", "erlvectordb_secret")


def make_corpus(seed, n):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((N_CENTRES, DIM), dtype=np.float32)
    z = centres[rng.integers(0, N_CENTRES, n)]
    z += NOISE * rng.standard_normal((n, DIM), dtype=np.float32)
    return z


def overrides(base, tmp):
    return {
        "services": {name: {"preferred_port": base + 10 * i,
                            "range": (base + 10 * i, base + 10 * i + 9)}
                     for i, name in enumerate(SERVICES)},
        "persistence_dir": str(tmp / "data"),
        "backup_dir": str(tmp / "backups"),
        "sync_interval": 9999,
    }


def fill(app, corpus):
    for name, kw in STORES.items():
        app.db.create_store(name, dim=DIM, **kw)
        app.db.insert_batch(name, [str(i) for i in range(len(corpus))], corpus)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(0, N_ROWS)


@pytest.fixture(scope="module")
def queries():
    return make_corpus(1, 64)


@pytest.fixture(scope="module")
def apps(tmp_path_factory, corpus):
    """{"jax": JAX Application, "torch": the port's}, each serving both
    stores over MCP, OAuth, REST and gRPC."""
    tmp = tmp_path_factory.mktemp("frontends")
    out = {
        "jax": JaxApplication(jax_load_config(
            overrides=overrides(JAX_BASE, tmp / "jax"), env={})).start(),
        "torch": Application(load_config(
            overrides=overrides(PORT_BASE, tmp / "torch"), env={}),
            device="cpu").start(),
    }
    for app in out.values():
        fill(app, corpus)
    yield out
    for app in out.values():
        app.stop()


def token(app):
    return app.db.oauth.grant_client_credentials(*CREDS)["access_token"]


def http(method, url, body=None, tok=None, timeout=60):
    headers = {"Content-Type": "application/json"}
    if tok:
        headers["Authorization"] = f"Bearer {tok}"
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers=headers, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def rest(app, path):
    return f"http://127.0.0.1:{app.service_port('rest_api')}{path}"


def mcp_client(app, mod=torch_client):
    return mod.VectorDBClient(
        mcp_port=app.service_port("mcp_server"),
        oauth_url=f"http://127.0.0.1:{app.service_port('oauth_server')}/oauth/token")


def b64(a):
    return base64.b64encode(np.ascontiguousarray(a, "<f4").tobytes()).decode()


def mcp_batch(app, store, qs):
    """(ids [n, K], distances [n, K] f32) of one b64 search_vectors_batch;
    the stores were filled in order, so a row is its id."""
    client = mcp_client(app)
    try:
        r = client.tool("search_vectors_batch", store=store,
                        vectors_b64=b64(qs), dim=DIM, k=K, encoding="b64")
    finally:
        client.close()
    rows = np.frombuffer(base64.b64decode(r["rows_b64"]), "<i4").reshape(-1, K)
    dists = np.frombuffer(base64.b64decode(r["distances_b64"]),
                          "<f4").reshape(-1, K)
    return rows.astype(str), dists


def channel(app):
    return grpc.insecure_channel(f"127.0.0.1:{app.service_port('grpc_server')}")


def grpc_batch(app, store, qs, pbm=pb):
    with channel(app) as ch:
        call = ch.unary_unary("/evdb.ErlVectorDB/SearchBatch",
                              request_serializer=pbm.SearchBatchRequest.SerializeToString,
                              response_deserializer=pbm.SearchBatchReply.FromString)
        r = call(pbm.SearchBatchRequest(store=store, vectors_f32=qs.astype("<f4").tobytes(),
                                        dim=DIM, k=K), timeout=120,
                 metadata=[("authorization", f"Bearer {token(app)}")])
    return (np.array(r.ids).reshape(r.count, r.k),
            np.frombuffer(r.distances_f32, "<f4").reshape(r.count, r.k))


def grpc_stream(app, store, qs, pbm=pb):
    with channel(app) as ch:
        call = ch.stream_stream("/evdb.ErlVectorDB/StreamSearch",
                                request_serializer=pbm.SearchRequest.SerializeToString,
                                response_deserializer=pbm.SearchReply.FromString)
        reqs = [pbm.SearchRequest(store=store, vector=q.tolist(), k=K, seq=i)
                for i, q in enumerate(qs)]
        got = {}
        for r in call(iter(reqs), timeout=120,
                      metadata=[("authorization", f"Bearer {token(app)}")]):
            assert not r.error, r.error
            got[r.seq] = ([h.id for h in r.hits], [h.distance for h in r.hits])
    assert sorted(got) == list(range(len(qs)))
    return (np.array([got[i][0] for i in range(len(qs))]),
            np.array([got[i][1] for i in range(len(qs))], np.float32))


def singles(qs, ask):
    """``ask(i)`` -> (ids, distances) of query i, one call per query from 4
    client threads, so the batcher coalesces them."""
    out = [None] * len(qs)

    def run(lo):
        for i in range(lo, len(qs), 4):
            out[i] = ask(i)

    threads = [threading.Thread(target=run, args=(lo,)) for lo in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    return (np.array([r[0] for r in out]),
            np.array([r[1] for r in out], np.float32))


def rest_singles(app, store, qs):
    tok = token(app)

    def ask(i):
        status, body = http("POST", rest(app, f"/api/v1/stores/{store}/search"),
                            {"vector": qs[i].tolist(), "k": K}, tok)
        assert status == 200, body
        return ([h["id"] for h in body["results"]],
                [h["distance"] for h in body["results"]])
    return singles(qs, ask)


def grpc_singles(app, store, qs):
    """Unary gRPC ``Search``, one query a call."""
    auth = [("authorization", f"Bearer {token(app)}")]
    with channel(app) as ch:
        call = ch.unary_unary("/evdb.ErlVectorDB/Search",
                              request_serializer=pb.SearchRequest.SerializeToString,
                              response_deserializer=pb.SearchReply.FromString)

        def ask(i):
            r = call(pb.SearchRequest(store=store, vector=qs[i].tolist(), k=K),
                     timeout=120, metadata=auth)
            return [h.id for h in r.hits], [h.distance for h in r.hits]
        return singles(qs, ask)


def mcp_singles(app, store, qs):
    """MCP ``search_vectors`` with ``vector_b64``, one query a call (the
    route of the single-query benchmark cell); a client a thread."""
    mine, clients = threading.local(), []

    def ask(i):
        if not hasattr(mine, "client"):
            mine.client = mcp_client(app)
            clients.append(mine.client)
        r = mine.client.tool("search_vectors", store=store,
                             vector_b64=b64(qs[i]), k=K)
        return ([h["id"] for h in r["results"]],
                [h["distance"] for h in r["results"]])
    try:
        return singles(qs, ask)
    finally:
        for client in clients:
            client.close()


def in_process(app, store, qs):
    hits = app.db.search_batch(store, qs, k=K)
    return (np.array([[h[0] for h in row] for row in hits]),
            np.array([[h[2] for h in row] for row in hits], np.float32))


def assert_cross_package(store, got, want):
    """The port's answer against the JAX package's: equal ids, distances to
    the store parity tests' tolerance."""
    rtol = 1e-5 if STORES[store]["metric"] == "euclidean" else 1e-6
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=rtol)


FRONTENDS = {"rest_search": rest_singles, "grpc_search": grpc_singles,
             "grpc_search_batch": grpc_batch,
             "grpc_stream_search": grpc_stream, "mcp_search": mcp_singles,
             "mcp_batch_b64": mcp_batch}
# frontends whose answer is one batch of the whole query set: the port's
# equals its in-process batch bit for bit
WHOLE_BATCH = ("grpc_search_batch", "mcp_batch_b64")


@pytest.mark.parametrize("store", sorted(STORES))
@pytest.mark.parametrize("frontend", sorted(FRONTENDS))
def test_frontends_answer_alike(apps, queries, frontend, store):
    qs = queries if frontend in WHOLE_BATCH else queries[:32]
    fn = FRONTENDS[frontend]
    got = fn(apps["torch"], store, qs)
    want = fn(apps["jax"], store, qs)
    assert got[0].shape == (len(qs), K) and np.all(np.isfinite(got[1]))
    assert_cross_package(store, got, want)
    ids, dists = in_process(apps["torch"], store, qs)
    np.testing.assert_array_equal(got[0], ids)
    if frontend in WHOLE_BATCH:
        np.testing.assert_array_equal(got[1], dists)
    else:
        np.testing.assert_allclose(got[1], dists, rtol=1e-6, atol=0)


def session(client, store):
    """create, insert, search through a VectorDBClient."""
    client.create_store(store, metric="euclidean")
    client.insert_vector(store, "x1", [1.0, 0.0, 0.5], {"n": 1})
    client.insert_vector(store, "x2", [0.0, 1.0, 0.5])
    hits = client.search_vectors(store, [1.0, 0.1, 0.5], k=2)
    assert [h["id"] for h in hits] == ["x1", "x2"]
    assert hits[0]["metadata"] == {"n": 1}


def bridge_session(bridge_mod, app, store):
    cfg = bridge_mod.BridgeConfig(
        host="127.0.0.1", mcp_port=app.service_port("mcp_server"),
        oauth_url=f"http://127.0.0.1:{app.service_port('oauth_server')}/oauth/token")
    calls = [("initialize", {}),
             ("tools/call", {"name": "create_store", "arguments": {"name": store}}),
             ("tools/call", {"name": "insert_vector", "arguments": {
                 "store": store, "id": "a", "vector": [1.0, 2.0]}}),
             ("tools/call", {"name": "search_vectors", "arguments": {
                 "store": store, "vector": [1.0, 2.0], "k": 1}})]
    stdin = io.StringIO("".join(
        json.dumps({"jsonrpc": "2.0", "id": i, "method": m, "params": p}) + "\n"
        for i, (m, p) in enumerate(calls, 1)))
    stdout = io.StringIO()
    bridge_mod.StdioBridge(cfg, stdin=stdin, stdout=stdout).run()
    lines = [json.loads(ln) for ln in stdout.getvalue().splitlines()]
    assert [ln["id"] for ln in lines] == [1, 2, 3, 4]
    assert lines[0]["result"]["serverInfo"]["name"] == "erlvectordb-tpu"
    hits = json.loads(lines[3]["result"]["content"][0]["text"])["results"]
    assert hits[0]["id"] == "a"


@pytest.mark.parametrize("who,server", [
    ("jax_client", "torch"), ("torch_client", "jax"),
    ("torch_bridge", "jax"), ("jax_bridge", "torch")])
def test_either_client_against_either_server(apps, who, server):
    app = apps[server]
    store = f"session_{who}"
    if who.endswith("bridge"):
        bridge_session(torch_bridge if who.startswith("torch") else jax_bridge,
                       app, store)
        return
    client = mcp_client(app, torch_client if who.startswith("torch") else jax_client)
    try:
        session(client, store)
    finally:
        client.close()


def test_jax_messages_decode_as_the_ports(apps, queries):
    """The two generated modules share one evdb.proto: a request built from
    the JAX package's classes is served by the port's gRPC server."""
    ids, _ = grpc_batch(apps["torch"], "s8", queries[:4], pbm=jax_pb)
    np.testing.assert_array_equal(ids, in_process(apps["torch"], "s8", queries[:4])[0])


def test_health_reports_the_cpu(apps):
    status, body = http("GET", rest(apps["torch"], "/health/detailed"))
    assert status == 200 and body["status"] == "healthy"
    dev = body["checks"]["devices"]
    assert dev["status"] == "healthy"
    assert dev["details"]["platform"] == "cpu"
    assert dev["details"]["device"] == "cpu"


@pytest.mark.parametrize("frontend", ["rest", "grpc", "mcp"])
def test_nprobe_on_a_distributed_store_is_a_clean_error(apps, corpus, frontend):
    """``nprobe`` on a distributed store: each frontend's invalid-argument
    answer with the store's message, not a crash."""
    app = apps["torch"]
    name = f"dist_np_{frontend}"
    app.db.create_distributed_store(name, dim=DIM, dtype="int8")
    try:
        app.db.insert_batch(name, [str(i) for i in range(64)], corpus[:64])
        q = corpus[0].tolist()
        if frontend == "rest":
            status, body = http("POST", rest(app, f"/api/v1/stores/{name}/search"),
                                {"vector": q, "k": K, "nprobe": 4}, token(app))
            assert status == 400
            message = body["error"]
        elif frontend == "grpc":
            with channel(app) as ch:
                call = ch.unary_unary("/evdb.ErlVectorDB/Search",
                                      request_serializer=pb.SearchRequest.SerializeToString,
                                      response_deserializer=pb.SearchReply.FromString)
                with pytest.raises(grpc.RpcError) as ei:
                    call(pb.SearchRequest(store=name, vector=q, k=K, nprobe=4),
                         timeout=60,
                         metadata=[("authorization", f"Bearer {token(app)}")])
            assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
            message = ei.value.details()
        else:
            client = mcp_client(app)
            try:
                with pytest.raises(torch_client.ClientError) as ei:
                    client.tool("search_vectors", store=name, vector=q, k=K,
                                nprobe=4)
            finally:
                client.close()
            message = str(ei.value)
            assert message.startswith("-32602: ")
        assert "distributed stores do not support multiprobe" in message
    finally:
        app.db.delete_store(name)


def test_cluster_verbs_and_rest_join_over_the_frontends(apps, corpus, queries):
    """The cluster verbs over the frontends.  REST cluster status answers
    200 with the JAX server's keys; gRPC CreateStore(distributed=true)
    creates a sharded store on either server, InsertBatch fills it, and its
    SearchBatch answers as the JAX server's does.  REST join: a coordinator
    that cannot be reached answers an error within the request's timeout;
    a 1-process group (a free coordinator port) answers 200 with the JAX
    route's stats keys (those of the cluster status)."""
    app, japp = apps["torch"], apps["jax"]
    tok = token(app)
    status, body = http("GET", rest(app, "/api/v1/cluster/status"), tok=tok)
    jstatus, jbody = http("GET", rest(japp, "/api/v1/cluster/status"),
                          tok=token(japp))
    assert status == 200 == jstatus and set(body) == set(jbody)
    assert body["total_devices"] == 1 and body["data_shards"] == 1
    rows = corpus[:1024]
    for a, pbm in ((app, pb), (japp, jax_pb)):
        auth = [("authorization", f"Bearer {token(a)}")]
        with channel(a) as ch:
            create = ch.unary_unary(
                "/evdb.ErlVectorDB/CreateStore",
                request_serializer=pbm.CreateStoreRequest.SerializeToString,
                response_deserializer=pbm.StatusReply.FromString)
            r = create(pbm.CreateStoreRequest(name="dist", dimension=DIM,
                                              dtype="int8", distributed=True),
                       timeout=30, metadata=auth)
            assert r.ok, r
            insert = ch.unary_unary(
                "/evdb.ErlVectorDB/InsertBatch",
                request_serializer=pbm.InsertBatchRequest.SerializeToString,
                response_deserializer=pbm.StatusReply.FromString)
            r = insert(pbm.InsertBatchRequest(
                store="dist", ids=[str(i) for i in range(len(rows))],
                vectors_f32=rows.astype("<f4").tobytes(), dim=DIM),
                timeout=60, metadata=auth)
            assert r.ok, r
    assert type(app.db.any_store("dist")).__name__ == "ShardedVectorStore"
    assert "dist" in app.db.list_stores()
    assert_cross_package("s8", grpc_batch(app, "dist", queries),
                         grpc_batch(japp, "dist", queries, jax_pb))

    t0 = time.time()
    status, body = http("POST", rest(app, "/api/v1/cluster/join"),
                        {"coordinator_address": f"127.0.0.1:{free_port()}",
                         "num_processes": 2, "process_id": 1, "timeout_s": 2},
                        tok)
    assert status == 503 and "could not form a group" in body["error"]
    assert time.time() - t0 < 30
    try:
        status, body = http("POST", rest(app, "/api/v1/cluster/join"),
                            {"coordinator_address": f"127.0.0.1:{free_port()}",
                             "num_processes": 1, "process_id": 0,
                             "timeout_s": 30}, tok)
        assert status == 200 and set(body) == set(jbody)
        assert body["total_devices"] == 1 and body["stores"]["dist"] == len(rows)
    finally:
        app.db.leave_cluster()


def test_graceful_stop_frees_ports_and_restart_answers_alike(tmp_path, corpus,
                                                             queries):
    cfg = load_config(overrides=overrides(RESTART_BASE, tmp_path), env={})
    app = Application(cfg, device="cpu").start()
    held = {}
    try:
        app.db.create_store("s8", dim=DIM, **STORES["s8"])
        app.db.insert_batch("s8", [str(i) for i in range(len(corpus))], corpus)
        held = {n: app.service_port(n) for n in SERVICES if app.service_port(n)}
        before = mcp_batch(app, "s8", queries)
    finally:
        app.stop()
    assert {"mcp_server", "oauth_server", "rest_api", "grpc_server"} <= set(held)
    assert all(probe_port(p) for p in held.values()), held
    again = Application(load_config(overrides=overrides(RESTART_BASE, tmp_path),
                                    env={}), device="cpu").start()
    try:
        after = mcp_batch(again, "s8", queries)
    finally:
        again.stop()
    np.testing.assert_array_equal(after[0], before[0])
    np.testing.assert_array_equal(after[1], before[1])


def cli_serve(tmp_path, *args):
    doc = overrides(CLI_BASE, tmp_path)
    for svc in doc["services"].values():   # a config file names it port_range
        svc["port_range"] = svc.pop("range")
    cfg = tmp_path / "evdb.json"
    cfg.write_text(json.dumps(doc))
    env = dict(os.environ, EVDB_CONFIG_FILE=str(cfg),
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(
        [sys.executable, "-m", "erlvectordb_tpu_torch.cli", "serve", *args],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def test_cli_serve_on_the_cpu_and_sigterm(tmp_path):
    """``cli serve --device cpu`` prints its one status line, serves, and
    exits 0 on SIGTERM with every port free."""
    proc = cli_serve(tmp_path, "--device", "cpu")
    try:
        line = json.loads(proc.stdout.readline())
        assert line["status"] == "running"
        ports = {n: p for n, p in line["ports"].items() if p}
        assert {"mcp_server", "oauth_server", "rest_api"} <= set(ports)
        assert all(CLI_BASE <= p < CLI_BASE + 50 for p in ports.values()), ports
        with urllib.request.urlopen(
                f"http://127.0.0.1:{ports['rest_api']}/health/detailed",
                timeout=30) as resp:
            body = json.loads(resp.read())
        assert body["checks"]["devices"]["details"]["platform"] == "cpu"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        proc.stdout.close()
        proc.stderr.close()
    assert all(probe_port(p) for p in ports.values()), ports


def test_cli_serve_without_a_card_fails(tmp_path):
    """Without a card and without ``--device cpu``, serve fails with the
    Database's error and serves nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: serve would run on it")
    proc = cli_serve(tmp_path)
    try:
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    assert proc.returncode != 0
    assert "no CUDA device" in err
    assert out == ""


def test_cli_bench_runs_a_config(capsys):
    """The reference's bench runs bench.py's config N; the port's runs its
    own bench module's in this process: one JSON line with every key of the
    config's row in BENCH_ALL.json."""
    from erlvectordb_tpu_torch import cli

    assert cli.main(["bench", "--bench-config", "1", "--quick",
                     "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    want = json.loads((Path(__file__).resolve().parent.parent
                       / "BENCH_ALL.json").read_text().splitlines()[0])
    assert set(want) <= set(json.loads(lines[0]))
