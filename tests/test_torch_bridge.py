"""The port's stdio bridge and client library against the port's
Application on the CPU, held to the JAX package's tests/test_bridge.py case
for case.

stdio bridge + client library tests — analogue of the reference's bridge
test suite (examples/test_socket_handler.py, test_oauth_manager.py,
test_request_router.py, test_stdio_handler.py, test_integration_basic.py):
initialize / tools-list / tools-call through the bridge, id preservation,
reconnect resilience, token refresh on 401, parse-error mapping."""

import io
import json

import pytest

from erlvectordb_tpu_torch.app import Application
from erlvectordb_tpu_torch.infra.config import load_config
from erlvectordb_tpu_torch.serve.client import ClientError, SocketHandler, VectorDBClient
from erlvectordb_tpu_torch.serve.stdio_bridge import BridgeConfig, RequestRouter, StdioBridge

BASE = 26300


@pytest.fixture(scope="module")
def app(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bridge")
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
        "rest_api_enabled": False,
    }, env={})
    application = Application(cfg, device="cpu").start()
    yield application
    application.stop()


@pytest.fixture
def bridge_config(app):
    return BridgeConfig(
        host="127.0.0.1",
        mcp_port=app.service_port("mcp_server"),
        oauth_url=f"http://127.0.0.1:{app.service_port('oauth_server')}/oauth/token",
    )


class TestConfigFromEnv:
    def test_defaults_and_aliases(self, monkeypatch):
        monkeypatch.setenv("ERLVECTORDB_HOST", "10.1.2.3")
        monkeypatch.setenv("EVDB_MCP_PORT", "9999")
        cfg = BridgeConfig.from_environment()
        assert cfg.host == "10.1.2.3"
        assert cfg.mcp_port == 9999
        assert cfg.oauth_url == "http://10.1.2.3:8081/oauth/token"

    def test_invalid_port(self, monkeypatch):
        monkeypatch.setenv("EVDB_MCP_PORT", "nope")
        with pytest.raises(ValueError):
            BridgeConfig.from_environment()

    def test_port_out_of_range(self, monkeypatch):
        monkeypatch.setenv("EVDB_MCP_PORT", "99999")
        with pytest.raises(ValueError):
            BridgeConfig.from_environment()

    def test_auth_disabled_skips_oauth_url(self, monkeypatch):
        monkeypatch.setenv("EVDB_AUTH_ENABLED", "false")
        cfg = BridgeConfig.from_environment()
        assert cfg.oauth_url is None


class TestRouter:
    def test_initialize_and_id_preservation(self, bridge_config):
        r = RequestRouter(bridge_config)
        resp = r.route({"jsonrpc": "2.0", "id": 777, "method": "initialize",
                        "params": {}})
        assert resp["id"] == 777
        assert resp["result"]["protocolVersion"] == "2024-11-05"
        r.socket.close()

    def test_tools_roundtrip(self, bridge_config):
        r = RequestRouter(bridge_config)
        resp = r.route({"jsonrpc": "2.0", "id": 1, "method": "tools/list",
                        "params": {}})
        names = {t["name"] for t in resp["result"]["tools"]}
        assert "search_vectors" in names
        r.socket.close()

    def test_unreachable_server_maps_to_jsonrpc_error(self):
        cfg = BridgeConfig(host="127.0.0.1", mcp_port=1, auth_enabled=False)
        r = RequestRouter(cfg)
        r.socket.max_reconnects = 1
        resp = r.route({"jsonrpc": "2.0", "id": 5, "method": "tools/list"})
        assert resp["error"]["code"] == -32000
        assert resp["id"] == 5


class TestStdioLoop:
    def test_full_session_over_stdio(self, bridge_config):
        requests = [
            {"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
            {"jsonrpc": "2.0", "id": 2, "method": "tools/call", "params": {
                "name": "create_store", "arguments": {"name": "bridge_store"}}},
            {"jsonrpc": "2.0", "id": 3, "method": "tools/call", "params": {
                "name": "insert_vector", "arguments": {
                    "store": "bridge_store", "id": "a", "vector": [1.0, 2.0]}}},
            {"jsonrpc": "2.0", "id": 4, "method": "tools/call", "params": {
                "name": "search_vectors", "arguments": {
                    "store": "bridge_store", "vector": [1.0, 2.0], "k": 1}}},
        ]
        stdin = io.StringIO("".join(json.dumps(r) + "\n" for r in requests))
        stdout = io.StringIO()
        bridge = StdioBridge(bridge_config, stdin=stdin, stdout=stdout)
        bridge.run()
        lines = [json.loads(l) for l in stdout.getvalue().splitlines()]
        assert [l["id"] for l in lines] == [1, 2, 3, 4]
        hits = json.loads(lines[3]["result"]["content"][0]["text"])["results"]
        assert hits[0]["id"] == "a"

    def test_parse_error_line(self, bridge_config):
        bridge = StdioBridge(bridge_config, stdin=io.StringIO(),
                             stdout=io.StringIO())
        resp = bridge.handle_line("{broken json")
        assert resp["error"]["code"] == -32700
        assert bridge.handle_line("   ") is None


class TestClientLibrary:
    def test_high_level_flow(self, app):
        client = VectorDBClient(
            mcp_port=app.service_port("mcp_server"),
            oauth_url=f"http://127.0.0.1:{app.service_port('oauth_server')}/oauth/token",
        )
        try:
            init = client.initialize()
            assert init["serverInfo"]["name"] == "erlvectordb-tpu"
            client.create_store("cli_store", metric="euclidean")
            client.insert_vector("cli_store", "x1", [1.0, 0.0], {"n": 1})
            client.insert_vector("cli_store", "x2", [0.0, 1.0])
            res = client.search_vectors("cli_store", [1.0, 0.1], k=1)
            assert res[0]["id"] == "x1"
            stats = client.get_store_stats("cli_store")
            assert stats["count"] == 2
            client.delete_vector("cli_store", "x2")
            assert client.get_store_stats("cli_store")["count"] == 1
            client.backup_store("cli_store", "cb")
            assert any(b["store_name"] == "cli_store" for b in client.list_backups())
        finally:
            client.close()

    def test_expired_token_refetch(self, app):
        # grant a token, revoke it behind the client's back; the client must
        # force-refresh and retry (the bridge's 401 path)
        client = VectorDBClient(
            mcp_port=app.service_port("mcp_server"),
            oauth_url=f"http://127.0.0.1:{app.service_port('oauth_server')}/oauth/token",
        )
        try:
            client.list_tools()
            # kill the cached token server-side
            tok = client.oauth._token["access_token"]
            app.db.oauth.revoke_token(tok)
            tools = client.list_tools()  # must transparently recover
            assert len(tools) > 0
        finally:
            client.close()

    def test_socket_reconnect(self, app):
        sh = SocketHandler("127.0.0.1", app.service_port("mcp_server"))
        sh.connect()
        sh._sock.close()  # simulate a dropped connection
        resp = sh.request({"jsonrpc": "2.0", "id": 1, "method": "ping",
                           "params": {}})
        assert resp["id"] == 1
        sh.close()

    def test_connect_failure(self):
        sh = SocketHandler("127.0.0.1", 1, max_reconnects=1)
        with pytest.raises(ClientError):
            sh.connect()
