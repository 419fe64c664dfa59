"""The port's gRPC frontend on the CPU, held to the JAX package's
tests/test_grpc.py case for case.

gRPC frontend tests — hand-built stubs against the generic-handler service.

Drives the full verb surface over a real insecure channel: store CRUD,
binary batch insert/search, filters, streaming pipelined search with
out-of-order seq correlation, OAuth scope gating, and error codes.
"""

import json
import queue
import threading

import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

from erlvectordb_tpu_torch.api import Database
from erlvectordb_tpu_torch.infra.config import load_config
from erlvectordb_tpu_torch.serve import evdb_pb2 as pb
from erlvectordb_tpu_torch.serve.grpc_server import GrpcServer

_SVC = "/evdb.ErlVectorDB/"


class Stub:
    """Minimal typed client over a channel (what generated stubs would be)."""

    _METHODS = {
        "Health": (pb.Empty, pb.HealthReply),
        "ListStores": (pb.Empty, pb.ListStoresReply),
        "Search": (pb.SearchRequest, pb.SearchReply),
        "SearchBatch": (pb.SearchBatchRequest, pb.SearchBatchReply),
        "Stats": (pb.StoreRef, pb.StatsReply),
        "CreateStore": (pb.CreateStoreRequest, pb.StatusReply),
        "DeleteStore": (pb.StoreRef, pb.StatusReply),
        "Insert": (pb.InsertRequest, pb.StatusReply),
        "InsertBatch": (pb.InsertBatchRequest, pb.StatusReply),
        "Delete": (pb.DeleteRequest, pb.StatusReply),
        "Sync": (pb.StoreRef, pb.StatusReply),
        "Backup": (pb.BackupRequest, pb.BackupReply),
        "Restore": (pb.RestoreRequest, pb.StatusReply),
        "ListBackups": (pb.Empty, pb.ListBackupsReply),
    }

    def __init__(self, channel, token=None):
        self._md = [("authorization", f"Bearer {token}")] if token else []
        for name, (req_cls, rep_cls) in self._METHODS.items():
            fn = channel.unary_unary(
                _SVC + name,
                request_serializer=req_cls.SerializeToString,
                response_deserializer=rep_cls.FromString,
            )
            setattr(self, name, self._bind(fn))
        self._stream = channel.stream_stream(
            _SVC + "StreamSearch",
            request_serializer=pb.SearchRequest.SerializeToString,
            response_deserializer=pb.SearchReply.FromString,
        )

    def _bind(self, fn):
        def call(req, timeout=30):
            return fn(req, timeout=timeout, metadata=self._md)
        return call

    def stream_search(self, requests, timeout=30):
        return self._stream(iter(requests), timeout=timeout,
                            metadata=self._md)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grpc")
    cfg = load_config(overrides={
        "persistence_dir": str(tmp / "data"),
        "backup_dir": str(tmp / "backups"),
        "sync_interval": 9999,
    }, env={})
    db = Database(cfg, device="cpu").start()
    srv = GrpcServer(db, "127.0.0.1", 0).start()   # ephemeral port
    chan = grpc.insecure_channel(f"127.0.0.1:{srv.port}")
    tok = db.oauth.grant_client_credentials(
        "erlvectordb_client", "erlvectordb_secret")["access_token"]
    yield db, srv, chan, tok
    chan.close()
    srv.stop()
    db.stop()


@pytest.fixture
def stub(server):
    db, srv, chan, tok = server
    return Stub(chan, token=tok)


@pytest.fixture
def seeded(server, stub):
    db, *_ = server
    if "g1" not in db.list_stores():
        stub.CreateStore(pb.CreateStoreRequest(name="g1", dimension=8,
                                               metric="cosine"))
        rng = np.random.default_rng(0)
        vecs = rng.standard_normal((32, 8)).astype("<f4")
        stub.InsertBatch(pb.InsertBatchRequest(
            store="g1", ids=[f"v{i}" for i in range(32)],
            vectors_f32=vecs.tobytes(), dim=8,
            metadata_json=[json.dumps({"cat": i % 2}) for i in range(32)]))
        seeded.vecs = vecs
    return seeded.vecs


def test_health_unauthenticated(server):
    _, _, chan, _ = server
    stub = Stub(chan)  # no token
    r = stub.Health(pb.Empty())
    assert r.status in ("healthy", "degraded", "unhealthy")


def test_store_crud_and_stats(stub, seeded):
    names = stub.ListStores(pb.Empty()).names
    assert "g1" in names
    stats = json.loads(stub.Stats(pb.StoreRef(name="g1")).stats_json)
    assert stats["count"] == 32
    assert stats["dimension"] == 8


def test_single_search_with_metadata(stub, seeded):
    vecs = seeded
    r = stub.Search(pb.SearchRequest(store="g1", vector=vecs[7].tolist(),
                                     k=3, seq=42))
    assert r.seq == 42
    assert r.hits[0].id == "v7"
    assert r.hits[0].distance == pytest.approx(0.0, abs=1e-5)
    assert json.loads(r.hits[0].metadata_json) == {"cat": 1}


def test_filtered_search(stub, seeded):
    vecs = seeded
    r = stub.Search(pb.SearchRequest(store="g1", vector=vecs[7].tolist(),
                                     k=5, filter_json='{"cat": 0}'))
    ids = [h.id for h in r.hits]
    assert "v7" not in ids  # cat 1 filtered out
    assert all(int(i[1:]) % 2 == 0 for i in ids)


def test_batch_binary_search(stub, seeded):
    vecs = seeded
    r = stub.SearchBatch(pb.SearchBatchRequest(
        store="g1", vectors_f32=vecs[:6].tobytes(), dim=8, k=2))
    assert r.count == 6 and r.k == 2
    ids = np.array(r.ids).reshape(6, 2)
    assert list(ids[:, 0]) == [f"v{i}" for i in range(6)]
    d = np.frombuffer(r.distances_f32, "<f4").reshape(6, 2)
    np.testing.assert_allclose(d[:, 0], 0.0, atol=1e-5)


def test_stream_search_out_of_order_seq(stub, seeded):
    vecs = seeded
    reqs = [pb.SearchRequest(store="g1", vector=vecs[i].tolist(), k=1, seq=i)
            for i in range(10)]
    got = {}
    for reply in stub.stream_search(reqs):
        assert not reply.error
        got[reply.seq] = reply.hits[0].id
    assert got == {i: f"v{i}" for i in range(10)}


def test_stream_search_reports_per_request_error(stub, seeded):
    vecs = seeded
    reqs = [
        pb.SearchRequest(store="g1", vector=vecs[0].tolist(), k=1, seq=1),
        pb.SearchRequest(store="missing", vector=vecs[0].tolist(), k=1,
                         seq=2),
    ]
    replies = {r.seq: r for r in stub.stream_search(reqs)}
    assert replies[1].hits[0].id == "v0"
    assert replies[2].error


def test_delete_and_sync(stub, seeded):
    stub.Insert(pb.InsertRequest(store="g1", id="tmp",
                                 vector=[1.0] * 8))
    assert stub.Delete(pb.DeleteRequest(store="g1", id="tmp")).ok
    assert stub.Sync(pb.StoreRef(name="g1")).ok


def test_backup_roundtrip(stub, seeded):
    path = stub.Backup(pb.BackupRequest(store="g1",
                                        backup_name="snap")).path
    assert path
    backups = json.loads(stub.ListBackups(pb.Empty()).backups_json)
    assert any("g1" in json.dumps(b) for b in backups)
    r = stub.Restore(pb.RestoreRequest(backup_file=path,
                                       new_name="g1restored"))
    assert r.ok
    assert "g1restored" in stub.ListStores(pb.Empty()).names


def test_unknown_store_is_not_found(stub):
    with pytest.raises(grpc.RpcError) as e:
        stub.Search(pb.SearchRequest(store="nope", vector=[0.0] * 8, k=1))
    assert e.value.code() == grpc.StatusCode.NOT_FOUND


def test_bad_batch_payload_is_invalid_argument(stub, seeded):
    with pytest.raises(grpc.RpcError) as e:
        stub.SearchBatch(pb.SearchBatchRequest(
            store="g1", vectors_f32=b"123", dim=8, k=1))
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_missing_token_unauthenticated(server):
    _, _, chan, _ = server
    anon = Stub(chan)
    with pytest.raises(grpc.RpcError) as e:
        anon.ListStores(pb.Empty())
    assert e.value.code() == grpc.StatusCode.UNAUTHENTICATED


def test_scope_gating(server):
    db, _, chan, _ = server
    db.oauth.register_client("reader", "sekret", ["read"])
    rtok = db.oauth.grant_client_credentials("reader", "sekret")["access_token"]
    r_stub = Stub(chan, token=rtok)
    assert "g1" in r_stub.ListStores(pb.Empty()).names  # read ok
    with pytest.raises(grpc.RpcError) as e:
        r_stub.CreateStore(pb.CreateStoreRequest(name="x", dimension=4))
    assert e.value.code() == grpc.StatusCode.PERMISSION_DENIED
    with pytest.raises(grpc.RpcError) as e:
        r_stub.ListBackups(pb.Empty())
    assert e.value.code() == grpc.StatusCode.PERMISSION_DENIED


def test_concurrent_searches_coalesce_through_batcher(server, stub, seeded):
    db, *_ = server
    vecs = seeded
    results = queue.Queue()

    def one(i):
        r = stub.Search(pb.SearchRequest(store="g1",
                                         vector=vecs[i].tolist(), k=1))
        results.put((i, r.hits[0].id))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    got = dict(results.queue)
    assert got == {i: f"v{i}" for i in range(16)}


def test_application_starts_grpc_service(tmp_path):
    from erlvectordb_tpu_torch.app import Application

    base = 26400
    overrides = {"services": {}, "persistence_dir": str(tmp_path / "d"),
                 "backup_dir": str(tmp_path / "b"), "sync_interval": 9999}
    for i, name in enumerate(("mcp_server", "oauth_server", "rest_api",
                              "grpc_server", "health_check")):
        overrides["services"][name] = {
            "preferred_port": base + i * 20,
            "range": (base + i * 20, base + i * 20 + 19),
        }
    cfg = load_config(overrides=overrides, env={})
    app = Application(cfg, device="cpu").start()
    try:
        port = app.service_port("grpc_server")
        assert port is not None
        chan = grpc.insecure_channel(f"127.0.0.1:{port}")
        tok = app.db.oauth.grant_client_credentials(
            "erlvectordb_client", "erlvectordb_secret")["access_token"]
        s = Stub(chan, token=tok)
        s.CreateStore(pb.CreateStoreRequest(name="appstore", dimension=4))
        s.Insert(pb.InsertRequest(store="appstore", id="a",
                                  vector=[1, 2, 3, 4]))
        r = s.Search(pb.SearchRequest(store="appstore",
                                      vector=[1, 2, 3, 4], k=1))
        assert r.hits[0].id == "a"
        chan.close()
    finally:
        app.stop()


def test_nprobe_multiprobe_over_grpc(server, stub, seeded):
    """nprobe requests take the direct sub-linear dispatch (int4r layout)."""
    db, *_ = server
    stub.CreateStore(pb.CreateStoreRequest(name="g4r", dimension=16,
                                           metric="cosine", dtype="int4r"))
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((8, 16)).astype("<f4")
    vecs = (centers[rng.integers(0, 8, 400)]
            + 0.2 * rng.standard_normal((400, 16))).astype("<f4")
    stub.InsertBatch(pb.InsertBatchRequest(
        store="g4r", ids=[f"r{i}" for i in range(400)],
        vectors_f32=vecs.tobytes(), dim=16))
    # unary with nprobe
    r = stub.Search(pb.SearchRequest(store="g4r", vector=vecs[42].tolist(),
                                     k=3, nprobe=4))
    assert r.hits[0].id == "r42"
    # batch with nprobe
    rb = stub.SearchBatch(pb.SearchBatchRequest(
        store="g4r", vectors_f32=vecs[:4].tobytes(), dim=16, k=2, nprobe=4))
    assert rb.count == 4 and rb.ids[0] == "r0" and rb.ids[3 * rb.k] == "r3"
    # nprobe on a non-int4r store -> INVALID_ARGUMENT, not a crash
    with pytest.raises(grpc.RpcError) as ei:
        stub.Search(pb.SearchRequest(store="g1", vector=[0.0] * 8,
                                     k=1, nprobe=4))
    assert "int4r" in ei.value.details()


def test_recall_target_over_grpc(server, stub, seeded):
    """recall_target maps to the smallest calibrated nprobe (auto-nprobe)
    on the same direct sub-linear dispatch as an explicit nprobe."""
    stub.CreateStore(pb.CreateStoreRequest(name="g4t", dimension=16,
                                           metric="cosine", dtype="int4r"))
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((8, 16)).astype("<f4")
    vecs = (centers[rng.integers(0, 8, 400)]
            + 0.2 * rng.standard_normal((400, 16))).astype("<f4")
    stub.InsertBatch(pb.InsertBatchRequest(
        store="g4t", ids=[f"t{i}" for i in range(400)],
        vectors_f32=vecs.tobytes(), dim=16))
    # unary: lazily calibrates on first use, then answers correctly
    r = stub.Search(pb.SearchRequest(store="g4t", vector=vecs[42].tolist(),
                                     k=3, recall_target=0.9))
    assert r.hits[0].id == "t42"
    # batch takes the same direct path
    rb = stub.SearchBatch(pb.SearchBatchRequest(
        store="g4t", vectors_f32=vecs[:4].tobytes(), dim=16, k=2,
        recall_target=0.9))
    assert rb.count == 4 and rb.ids[0] == "t0" and rb.ids[3 * rb.k] == "t3"
    # on a non-int4r store -> INVALID_ARGUMENT, not a crash
    with pytest.raises(grpc.RpcError) as ei:
        stub.Search(pb.SearchRequest(store="g1", vector=[0.0] * 8,
                                     k=1, recall_target=0.9))
    assert "int4r" in ei.value.details()
