"""The port's Application on the CPU (device="cpu"), held to the JAX
package's tests/test_serving.py case for case.

End-to-end serving tests: full Application over real sockets — the
analogue of the reference's integration tests (test_server.sh curl flow +
examples/test_integration_basic.py: token, MCP initialize/tools-list/
tools-call, REST health + CRUD, scope rejection, graceful shutdown)."""

import json
import socket
import urllib.request
import urllib.error
import urllib.parse

import pytest

from erlvectordb_tpu_torch.app import Application
from erlvectordb_tpu_torch.infra.config import load_config

BASE = 26200


@pytest.fixture(scope="module")
def app(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serving")
    cfg = load_config(overrides={
        "services": {
            "mcp_server": {"preferred_port": BASE, "range": (BASE, BASE + 9)},
            "oauth_server": {"preferred_port": BASE + 10, "range": (BASE + 10, BASE + 19)},
            "rest_api": {"preferred_port": BASE + 20, "range": (BASE + 20, BASE + 29)},
            "health_check": {"preferred_port": BASE + 30, "range": (BASE + 30, BASE + 39)},
            # a range of its own, not the default 8083-8099 the JAX package's
            # test files share
            "grpc_server": {"preferred_port": BASE + 40, "range": (BASE + 40, BASE + 49)},
        },
        "persistence_dir": str(tmp / "data"),
        "backup_dir": str(tmp / "backups"),
        "sync_interval": 9999,
    }, env={})
    application = Application(cfg, device="cpu").start()
    yield application
    application.stop()


def _http(method, url, body=None, token=None, form=False, timeout=5):
    headers = {}
    data = None
    if body is not None:
        if form:
            data = urllib.parse.urlencode(body).encode()
            headers["Content-Type"] = "application/x-www-form-urlencoded"
        else:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(url, data=data, headers=headers, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


class MCPClient:
    def __init__(self, port, token=None):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=5)
        self.buf = b""
        self.token = token
        self._id = 0

    def call(self, method, params=None, auth=True):
        self._id += 1
        req = {"jsonrpc": "2.0", "id": self._id, "method": method,
               "params": params or {}}
        if auth and self.token:
            req["auth"] = {"token": self.token}
        self.sock.sendall((json.dumps(req) + "\n").encode())
        while b"\n" not in self.buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("server closed")
            self.buf += chunk
        line, self.buf = self.buf.split(b"\n", 1)
        return json.loads(line)

    def close(self):
        self.sock.close()


@pytest.fixture(scope="module")
def token(app):
    port = app.service_port("oauth_server")
    status, tok = _http("POST", f"http://127.0.0.1:{port}/oauth/token", {
        "grant_type": "client_credentials",
        "client_id": "erlvectordb_client",
        "client_secret": "erlvectordb_secret",
    }, form=True)
    assert status == 200, tok
    return tok


class TestOAuthHTTP:
    def test_token_flow(self, token):
        assert token["token_type"] == "Bearer"
        assert "access_token" in token and "refresh_token" in token

    def test_bad_credentials(self, app):
        port = app.service_port("oauth_server")
        status, err = _http("POST", f"http://127.0.0.1:{port}/oauth/token", {
            "grant_type": "client_credentials",
            "client_id": "erlvectordb_client",
            "client_secret": "wrong",
        }, form=True)
        assert status == 401
        assert err["error"] == "invalid_client"

    def test_plus_in_form_value_decodes_as_space(self, app):
        # the reference's form parser bug ("Bug #1"): '+' must decode to space
        port = app.service_port("oauth_server")
        status, err = _http("POST", f"http://127.0.0.1:{port}/oauth/token", {
            "grant_type": "client_credentials",
            "client_id": "erlvectordb_client",
            "client_secret": "erlvectordb_secret",
            "scope": "read write",  # urlencode turns the space into '+'
        }, form=True)
        assert status == 200
        assert set(err["scope"].split()) == {"read", "write"}

    def test_client_info(self, app, token):
        port = app.service_port("oauth_server")
        status, info = _http(
            "GET", f"http://127.0.0.1:{port}/oauth/client_info",
            token=token["access_token"],
        )
        assert status == 200
        assert info["client_id"] == "erlvectordb_client"

    def test_refresh_rotation(self, app, token):
        port = app.service_port("oauth_server")
        status, t2 = _http("POST", f"http://127.0.0.1:{port}/oauth/token", {
            "grant_type": "refresh_token",
            "refresh_token": token["refresh_token"],
        }, form=True)
        assert status == 200
        status, _ = _http("POST", f"http://127.0.0.1:{port}/oauth/token", {
            "grant_type": "refresh_token",
            "refresh_token": token["refresh_token"],
        }, form=True)
        assert status == 401  # rotated away
        token["access_token"] = t2["access_token"]  # keep later tests working
        token["refresh_token"] = t2["refresh_token"]


class TestMCP:
    def test_initialize_and_tools(self, app, token):
        c = MCPClient(app.service_port("mcp_server"), token["access_token"])
        try:
            r = c.call("initialize")
            assert r["result"]["protocolVersion"] == "2024-11-05"
            assert r["result"]["serverInfo"]["name"] == "erlvectordb-tpu"
            r = c.call("tools/list")
            names = {t["name"] for t in r["result"]["tools"]}
            assert {"create_store", "insert_vector", "search_vectors",
                    "backup_store"} <= names
        finally:
            c.close()

    def test_tool_call_crud_flow(self, app, token):
        c = MCPClient(app.service_port("mcp_server"), token["access_token"])
        try:
            r = c.call("tools/call", {"name": "create_store",
                                      "arguments": {"name": "mcp_store"}})
            assert not r["result"]["isError"]
            # the reference's bug: create_store inserted instead; verify ours
            # actually created an empty store
            stats = json.loads(r["result"]["content"][0]["text"])
            assert stats["count"] == 0

            r = c.call("tools/call", {"name": "insert_vector", "arguments": {
                "store": "mcp_store", "id": "a", "vector": [1.0, 0.0],
                "metadata": {"tag": "x"}}})
            assert not r["result"]["isError"]

            r = c.call("tools/call", {"name": "search_vectors", "arguments": {
                "store": "mcp_store", "vector": [1.0, 0.0], "k": 1}})
            hits = json.loads(r["result"]["content"][0]["text"])["results"]
            assert hits[0]["id"] == "a"
            assert hits[0]["metadata"] == {"tag": "x"}

            r = c.call("tools/call", {"name": "sync_store",
                                      "arguments": {"store": "mcp_store"}})
            assert not r["result"]["isError"]

            r = c.call("tools/call", {"name": "backup_store", "arguments": {
                "store": "mcp_store", "backup_name": "t1"}})
            backup_file = json.loads(r["result"]["content"][0]["text"])["backup_file"]

            r = c.call("tools/call", {"name": "list_backups", "arguments": {}})
            files = [b["file"] for b in
                     json.loads(r["result"]["content"][0]["text"])["backups"]]
            assert backup_file in files

            r = c.call("tools/call", {"name": "restore_store", "arguments": {
                "backup_file": backup_file, "new_name": "mcp_restored"}})
            stats = json.loads(r["result"]["content"][0]["text"])
            assert stats["count"] == 1
        finally:
            c.close()

    def test_unauthenticated_rejected(self, app):
        c = MCPClient(app.service_port("mcp_server"), token=None)
        try:
            r = c.call("tools/list", auth=False)
            assert r["error"]["code"] == -32001
        finally:
            c.close()

    def test_scope_enforcement(self, app):
        # read-only client cannot call write tools
        app.db.oauth.register_client("ro_client", "s3", ["read"])
        tok = app.db.oauth.grant_client_credentials("ro_client", "s3")
        c = MCPClient(app.service_port("mcp_server"), tok["access_token"])
        try:
            r = c.call("tools/call", {"name": "create_store",
                                      "arguments": {"name": "nope"}})
            assert r["error"]["code"] == -32002
            r = c.call("tools/list")
            names = {t["name"] for t in r["result"]["tools"]}
            assert "create_store" not in names
            assert "search_vectors" in names
        finally:
            c.close()

    def test_unknown_tool_and_method(self, app, token):
        c = MCPClient(app.service_port("mcp_server"), token["access_token"])
        try:
            r = c.call("tools/call", {"name": "explode", "arguments": {}})
            assert r["error"]["code"] == -32601
            r = c.call("no/such/method")
            assert r["error"]["code"] == -32601
        finally:
            c.close()

    def test_parse_error(self, app):
        s = socket.create_connection(("127.0.0.1", app.service_port("mcp_server")),
                                     timeout=5)
        try:
            s.sendall(b"this is not json\n")
            data = s.recv(65536)
            assert json.loads(data)["error"]["code"] == -32700
        finally:
            s.close()


class TestREST:
    def test_health_unauthenticated(self, app):
        port = app.service_port("rest_api")
        status, body = _http("GET", f"http://127.0.0.1:{port}/health")
        assert status == 200
        assert body["status"] in ("healthy", "degraded")
        status, body = _http("GET", f"http://127.0.0.1:{port}/health/detailed")
        assert "checks" in body
        status, body = _http("GET", f"http://127.0.0.1:{port}/ready")
        assert body["ready"] is True

    def test_store_crud_flow(self, app, token):
        port = app.service_port("rest_api")
        tok = token["access_token"]
        status, body = _http("POST", f"http://127.0.0.1:{port}/api/v1/stores",
                             {"name": "rest_store", "metric": "euclidean"}, tok)
        assert status == 201, body
        status, body = _http(
            "POST", f"http://127.0.0.1:{port}/api/v1/stores/rest_store/vectors",
            {"id": "v1", "vector": [1.0, 2.0], "metadata": {"k": 1}}, tok)
        assert status == 201
        status, body = _http(
            "POST", f"http://127.0.0.1:{port}/api/v1/stores/rest_store/vectors",
            {"vectors": [{"id": "v2", "vector": [3.0, 4.0]},
                         {"id": "v3", "vector": [5.0, 6.0]}]}, tok)
        assert body["inserted"] == 2
        status, body = _http(
            "POST", f"http://127.0.0.1:{port}/api/v1/stores/rest_store/search",
            {"vector": [1.0, 2.0], "k": 2}, tok)
        assert status == 200
        assert body["results"][0]["id"] == "v1"
        status, body = _http(
            "GET", f"http://127.0.0.1:{port}/api/v1/stores/rest_store/stats",
            token=tok)
        assert body["count"] == 3
        status, body = _http(
            "DELETE", f"http://127.0.0.1:{port}/api/v1/stores/rest_store/vectors/v2",
            token=tok)
        assert status == 200
        status, body = _http("GET", f"http://127.0.0.1:{port}/api/v1/stores",
                             token=tok)
        assert "rest_store" in body["stores"]
        status, body = _http(
            "DELETE", f"http://127.0.0.1:{port}/api/v1/stores/rest_store",
            token=tok)
        assert status == 200

    def test_auth_required(self, app):
        port = app.service_port("rest_api")
        status, _ = _http("GET", f"http://127.0.0.1:{port}/api/v1/stores")
        assert status == 401

    def test_int4r_search_knobs(self, app, token):
        """nprobe / recall_target ride the direct sub-linear dispatch over
        REST (parity with the MCP search_vectors tool and gRPC Search)."""
        import numpy as np
        port = app.service_port("rest_api")
        tok = token["access_token"]
        status, _ = _http("POST", f"http://127.0.0.1:{port}/api/v1/stores",
                          {"name": "rest4r", "metric": "cosine",
                           "dtype": "int4r"}, tok)
        assert status == 201
        rng = np.random.default_rng(11)
        centers = rng.standard_normal((8, 16)).astype(np.float32)
        vecs = (centers[rng.integers(0, 8, 400)]
                + 0.2 * rng.standard_normal((400, 16))).astype(np.float32)
        status, body = _http(
            "POST", f"http://127.0.0.1:{port}/api/v1/stores/rest4r/vectors",
            {"vectors": [{"id": f"x{i}", "vector": vecs[i].tolist()}
                         for i in range(400)]}, tok, timeout=120)
        assert body["inserted"] == 400
        status, body = _http(
            "POST", f"http://127.0.0.1:{port}/api/v1/stores/rest4r/search",
            {"vector": vecs[42].tolist(), "k": 3, "nprobe": 4}, tok, timeout=120)
        assert status == 200 and body["results"][0]["id"] == "x42"
        # explicit calibration endpoint (otherwise lazily run on the first
        # recall_target search): returns the {nprobe: recall} curve
        status, body = _http(
            "POST", f"http://127.0.0.1:{port}/api/v1/stores/rest4r/calibrate",
            {"n_sample": 64, "k": 5}, tok, timeout=120)
        assert status == 200
        assert all(0.0 <= v <= 1.0 for v in body["curve"].values())
        assert max(body["curve"].values()) == 1.0  # deep probe == ceiling
        status, body = _http(
            "POST", f"http://127.0.0.1:{port}/api/v1/stores/rest4r/search",
            {"vector": vecs[7].tolist(), "k": 3, "recall_target": 0.9}, tok, timeout=120)
        assert status == 200 and body["results"][0]["id"] == "x7"
        # either knob on a non-int4r store -> 400, not a crash
        status, _ = _http("POST", f"http://127.0.0.1:{port}/api/v1/stores",
                          {"name": "restf32", "dimension": 8}, tok)
        status, body = _http(
            "POST", f"http://127.0.0.1:{port}/api/v1/stores/restf32/search",
            {"vector": [0.0] * 8, "k": 1, "recall_target": 0.9}, tok)
        assert status == 400
        _http("DELETE", f"http://127.0.0.1:{port}/api/v1/stores/rest4r",
              token=tok)
        _http("DELETE", f"http://127.0.0.1:{port}/api/v1/stores/restf32",
              token=tok)

    def test_ports_status(self, app, token):
        port = app.service_port("rest_api")
        status, body = _http("GET", f"http://127.0.0.1:{port}/api/v1/ports/status",
                             token=token["access_token"])
        assert status == 200
        assert body["mcp_server"]["status"] == "allocated"

    def test_errors(self, app, token):
        port = app.service_port("rest_api")
        tok = token["access_token"]
        status, _ = _http("GET", f"http://127.0.0.1:{port}/api/v1/stores/ghost/stats",
                          token=tok)
        assert status == 404
        status, _ = _http("POST", f"http://127.0.0.1:{port}/api/v1/stores",
                          {"name": "dup1"}, tok)
        status, _ = _http("POST", f"http://127.0.0.1:{port}/api/v1/stores",
                          {"name": "dup1"}, tok)
        assert status == 409

    def test_app_status(self, app):
        st = app.status()
        assert st["running"]
        assert st["services"]["mcp_server"]["running"]


class TestIndexTools:
    def test_index_lifecycle_over_mcp(self, app, token):
        import numpy as np

        c = MCPClient(app.service_port("mcp_server"), token["access_token"])
        try:
            c.call("tools/call", {"name": "create_store",
                                  "arguments": {"name": "idx_store"}})
            rng = np.random.default_rng(0)
            data = rng.standard_normal((300, 16)).astype(np.float32)
            app.db.insert_batch("idx_store",
                                [f"v{i}" for i in range(300)], data)
            r = c.call("tools/call", {"name": "create_index", "arguments": {
                "name": "i8", "store": "idx_store", "type": "int8"}})
            assert not r["result"]["isError"]
            r = c.call("tools/call", {"name": "build_index",
                                      "arguments": {"name": "i8"}})
            info = json.loads(r["result"]["content"][0]["text"])
            assert info["built"], info
            r = c.call("tools/call", {"name": "search_index", "arguments": {
                "name": "i8", "vector": data[7].tolist(), "k": 1}})
            hits = json.loads(r["result"]["content"][0]["text"])["results"]
            assert hits[0]["id"] == "v7"
            r = c.call("tools/call", {"name": "list_indexes", "arguments": {}})
            names = [i["name"] for i in
                     json.loads(r["result"]["content"][0]["text"])["indexes"]]
            assert "i8" in names
            r = c.call("tools/call", {"name": "drop_index",
                                      "arguments": {"name": "i8"}})
            assert not r["result"]["isError"]
        finally:
            c.close()

    def test_bad_index_type_is_invalid_params(self, app, token):
        c = MCPClient(app.service_port("mcp_server"), token["access_token"])
        try:
            c.call("tools/call", {"name": "create_store",
                                  "arguments": {"name": "idx_store2"}})
            r = c.call("tools/call", {"name": "create_index", "arguments": {
                "name": "bad", "store": "idx_store2", "type": "btree"}})
            assert r["error"]["code"] == -32602
        finally:
            c.close()


class TestRobustness:
    def test_oversized_rest_body_rejected(self, app, token):
        import http.client

        port = app.service_port("rest_api")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        try:
            conn.putrequest("POST", "/api/v1/stores")
            conn.putheader("Authorization", f"Bearer {token['access_token']}")
            conn.putheader("Content-Type", "application/json")
            conn.putheader("Content-Length", str(10**12))  # 1 TB claim
            conn.endheaders()
            resp = conn.getresponse()
            assert resp.status == 400
        finally:
            conn.close()

    def test_mcp_buffer_cap_closes_connection(self, app):
        import erlvectordb_tpu_torch.serve.mcp_server as mcp_mod

        old = mcp_mod.MAX_BUFFER_BYTES
        mcp_mod.MAX_BUFFER_BYTES = 4096  # shrink for the test
        try:
            s = socket.create_connection(
                ("127.0.0.1", app.service_port("mcp_server")), timeout=5)
            s.sendall(b"{" * 10000)  # unterminated garbage past the cap
            data = s.recv(65536)
            assert b"too large" in data
            assert s.recv(65536) == b""  # server closed the connection
            s.close()
        finally:
            mcp_mod.MAX_BUFFER_BYTES = old


class TestConcurrentLoad:
    def test_parallel_mcp_clients_searching(self, app, token):
        """16 concurrent socket clients; the micro-batcher should coalesce
        their searches and every client must get its own correct result."""
        import threading

        import numpy as np

        rng = np.random.default_rng(0)
        data = rng.standard_normal((200, 16)).astype(np.float32)
        app.db.create_store("load_store")
        app.db.insert_batch("load_store",
                            [f"v{i}" for i in range(200)], data)
        port = app.service_port("mcp_server")
        results, errors = {}, []

        def client(i):
            c = MCPClient(port, token["access_token"])
            try:
                for rep in range(4):
                    idx = (i * 4 + rep) % 200
                    r = c.call("tools/call", {
                        "name": "search_vectors",
                        "arguments": {"store": "load_store",
                                      "vector": data[idx].tolist(), "k": 1}})
                    hits = json.loads(r["result"]["content"][0]["text"])["results"]
                    results[(i, rep)] = (hits[0]["id"], f"v{idx}")
            except Exception as e:  # noqa: BLE001
                errors.append(e)
            finally:
                c.close()

        threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors[:2]
        assert len(results) == 64
        for got, want in results.values():
            assert got == want


class TestOAuthRevokeAndCors:
    def test_revoke_over_http(self, app):
        port = app.service_port("oauth_server")
        _, tok = _http("POST", f"http://127.0.0.1:{port}/oauth/token", {
            "grant_type": "client_credentials",
            "client_id": "erlvectordb_client",
            "client_secret": "erlvectordb_secret",
        }, form=True)
        status, body = _http("POST", f"http://127.0.0.1:{port}/oauth/revoke",
                             {"token": tok["access_token"]}, form=True)
        assert status == 200 and body["revoked"] is True
        # revoked token no longer validates
        status, _ = _http("GET", f"http://127.0.0.1:{port}/oauth/client_info",
                          token=tok["access_token"])
        assert status == 401
        # RFC 7009: revoking an unknown token still returns 200
        status, _ = _http("POST", f"http://127.0.0.1:{port}/oauth/revoke",
                          {"token": "bogus"}, form=True)
        assert status == 200

    def test_cors_preflight(self, app):
        import http.client

        port = app.service_port("rest_api")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        try:
            conn.request("OPTIONS", "/api/v1/stores")
            resp = conn.getresponse()
            assert resp.status == 204
            assert resp.getheader("Access-Control-Allow-Origin") == "*"
            assert "POST" in resp.getheader("Access-Control-Allow-Methods")
        finally:
            conn.close()

    def test_unknown_oauth_route_404(self, app):
        port = app.service_port("oauth_server")
        status, _ = _http("POST", f"http://127.0.0.1:{port}/oauth/zap", {}, form=True)
        assert status == 404


class TestPipelinedSearch:
    """Round-2 serving fast paths: base64 queries, the batched search tool,
    and out-of-order pipelined responses over one connection."""

    def _setup_store(self, c):
        c.call("tools/call", {"name": "create_store",
                              "arguments": {"name": "pipe_store"}})
        import numpy as np
        rng = np.random.default_rng(0)
        vecs = rng.standard_normal((32, 8)).astype(np.float32)
        for i in range(32):
            c.call("tools/call", {"name": "insert_vector", "arguments": {
                "store": "pipe_store", "id": f"v{i}",
                "vector": vecs[i].tolist()}})
        return vecs

    def test_vector_b64_search(self, app, token):
        import base64
        c = MCPClient(app.service_port("mcp_server"), token["access_token"])
        try:
            vecs = self._setup_store(c)
            b64 = base64.b64encode(vecs[3].tobytes()).decode()
            r = c.call("tools/call", {"name": "search_vectors", "arguments": {
                "store": "pipe_store", "vector_b64": b64, "k": 1}})
            hits = json.loads(r["result"]["content"][0]["text"])["results"]
            assert hits[0]["id"] == "v3"
        finally:
            c.close()

    def test_batch_tool_json_and_b64(self, app, token):
        import base64
        import numpy as np
        c = MCPClient(app.service_port("mcp_server"), token["access_token"])
        try:
            vecs = self._setup_store(c)
            qs = vecs[:4]
            r = c.call("tools/call", {"name": "search_vectors_batch",
                                      "arguments": {
                "store": "pipe_store", "vectors": qs.tolist(), "k": 1}})
            out = json.loads(r["result"]["content"][0]["text"])["results"]
            assert [h[0]["id"] for h in out] == ["v0", "v1", "v2", "v3"]

            b64 = base64.b64encode(np.ascontiguousarray(qs).tobytes()).decode()
            r = c.call("tools/call", {"name": "search_vectors_batch",
                                      "arguments": {
                "store": "pipe_store", "vectors_b64": b64, "dim": 8,
                "k": 2, "compact": True}})
            out = json.loads(r["result"]["content"][0]["text"])
            assert [row[0] for row in out["ids"]] == ["v0", "v1", "v2", "v3"]
            assert len(out["distances"]) == 4 and len(out["distances"][0]) == 2
        finally:
            c.close()

    def test_pipelined_out_of_order_responses(self, app, token):
        """Send many search requests WITHOUT reading between sends; responses
        may arrive in any order and are matched by JSON-RPC id."""
        c = MCPClient(app.service_port("mcp_server"), token["access_token"])
        try:
            vecs = self._setup_store(c)
            reqs = []
            for i in range(24):
                qi = int(i % 32)
                req = {"jsonrpc": "2.0", "id": 1000 + i,
                       "method": "tools/call",
                       "params": {"name": "search_vectors", "arguments": {
                           "store": "pipe_store",
                           "vector": vecs[qi].tolist(), "k": 1}},
                       "auth": {"token": c.token}}
                reqs.append((1000 + i, f"v{qi}"))
                c.sock.sendall((json.dumps(req) + "\n").encode())
            got = {}
            while len(got) < 24:
                while b"\n" not in c.buf:
                    chunk = c.sock.recv(65536)
                    assert chunk, "server closed mid-pipeline"
                    c.buf += chunk
                line, c.buf = c.buf.split(b"\n", 1)
                resp = json.loads(line)
                hits = json.loads(resp["result"]["content"][0]["text"])["results"]
                got[resp["id"]] = hits[0]["id"]
            for rid, expect in reqs:
                assert got[rid] == expect
        finally:
            c.close()

    def test_async_search_error_delivered(self, app, token):
        c = MCPClient(app.service_port("mcp_server"), token["access_token"])
        try:
            r = c.call("tools/call", {"name": "search_vectors", "arguments": {
                "store": "no_such_store", "vector": [1.0, 0.0]}})
            assert "error" in r
            r = c.call("tools/call", {"name": "search_vectors", "arguments": {
                "store": "pipe_store"}})  # neither vector nor vector_b64
            assert "error" in r
        finally:
            c.close()

    def test_batch_b64_binary_response(self, app, token):
        import base64
        import numpy as np
        c = MCPClient(app.service_port("mcp_server"), token["access_token"])
        try:
            self._setup_store(c)
            r = c.call("tools/call", {"name": "create_store",
                                      "arguments": {"name": "binstore"}})
            qs = np.eye(4, 6, dtype=np.float32)
            for i in range(4):
                c.call("tools/call", {"name": "insert_vector", "arguments": {
                    "store": "binstore", "id": f"b{i}",
                    "vector": qs[i].tolist()}})
            r = c.call("tools/call", {"name": "search_vectors_batch",
                                      "arguments": {
                "store": "binstore",
                "vectors_b64": base64.b64encode(qs.tobytes()).decode(),
                "dim": 6, "k": 1, "encoding": "b64"}})
            out = json.loads(r["result"]["content"][0]["text"])
            assert out["count"] == 4 and out["k"] == 1
            import numpy as np2
            rows = np2.frombuffer(base64.b64decode(out["rows_b64"]),
                                  dtype="<i4").reshape(4, 1)
            dists = np2.frombuffer(base64.b64decode(out["distances_b64"]),
                                   dtype="<f4").reshape(4, 1)
            # rows are store row indices; b0..b3 inserted in order -> rows 0..3
            assert rows[:, 0].tolist() == [0, 1, 2, 3]
            assert np2.all(dists < 1e-3)
        finally:
            c.close()
