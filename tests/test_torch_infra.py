"""The port's infrastructure (erlvectordb_tpu_torch/infra/), held to the
JAX package's tests/test_infra.py case for case.

Infrastructure tests — analogue of the reference port_management_SUITE
(conflict detection, automatic fallback, range validation, config loading
precedence, pre-allocation + rollback, dev-mode port selection, container
detection, graceful shutdown ordering/timeouts; test/port_management_SUITE.erl
:18-35) plus health checks and the startup coordinator."""

import json
import socket
import time

import pytest

from erlvectordb_tpu_torch.infra.config import (
    ConfigError,
    is_container_mode,
    is_development_mode,
    load_config,
    startup_sequence,
)
from erlvectordb_tpu_torch.infra.health import HealthCheckServer
from erlvectordb_tpu_torch.infra.ports import (
    PortAllocationError,
    PortManager,
    PortRegistry,
    probe_port,
)
from erlvectordb_tpu_torch.infra.signals import SignalHandler
from erlvectordb_tpu_torch.infra.startup import StartupCoordinator, StartupError, verify_tcp


BASE = 26000  # test port range, away from real services and other tests


def _make_config(**service_ports):
    overrides = {"services": {}, "persistence_enabled": False}
    for i, name in enumerate(("mcp_server", "oauth_server", "rest_api",
                              "grpc_server", "health_check")):
        base = service_ports.get(name, BASE + i * 20)
        overrides["services"][name] = {
            "preferred_port": base, "range": (base, base + 19),
        }
    return load_config(overrides=overrides, env={})


class TestConfigLoading:
    def test_defaults(self):
        cfg = load_config(env={})
        assert cfg.service("mcp_server").preferred_port == 8080
        assert cfg.service("oauth_server").preferred_port == 8081
        assert cfg.service("rest_api").preferred_port == 8082
        assert not cfg.development_mode

    def test_dev_mode_shifts_ports(self):
        cfg = load_config(env={"EVDB_DEV_MODE": "true"})
        assert cfg.development_mode
        assert cfg.service("mcp_server").preferred_port == 9080

    def test_legacy_dev_var_and_node_env(self):
        assert is_development_mode({"ERLVECTORDB_DEV_MODE": "1"})
        assert is_development_mode({"NODE_ENV": "development"})
        assert not is_development_mode({"NODE_ENV": "production"})

    def test_env_overrides_beat_file(self, tmp_path):
        f = tmp_path / "evdb.json"
        f.write_text(json.dumps({"services": {"mcp_server": {"preferred_port": 7000}}}))
        cfg = load_config(config_file=str(f), env={})
        assert cfg.service("mcp_server").preferred_port == 7000
        cfg2 = load_config(config_file=str(f), env={"MCP_SERVER_PORT": "7100"})
        assert cfg2.service("mcp_server").preferred_port == 7100

    def test_file_top_level_keys(self, tmp_path):
        f = tmp_path / "evdb.json"
        f.write_text(json.dumps({"sync_interval": 5, "oauth_enabled": False}))
        cfg = load_config(config_file=str(f), env={})
        assert cfg.sync_interval == 5
        assert not cfg.oauth_enabled

    def test_container_detection(self):
        assert is_container_mode({"KUBERNETES_SERVICE_HOST": "10.0.0.1"})
        assert is_container_mode({"DOCKER": "1"})

    def test_container_port_override_and_bind_all(self):
        cfg = load_config(env={"CONTAINER": "1", "PORT": "5000"})
        assert cfg.container_mode
        assert cfg.service("mcp_server").preferred_port == 5000
        assert cfg.service("mcp_server").bind_interface == "0.0.0.0"

    def test_range_env_vars(self):
        cfg = load_config(env={
            "MCP_SERVER_PORT_RANGE_START": "15000",
            "MCP_SERVER_PORT_RANGE_END": "15010",
            "MCP_SERVER_PORT": "15000",
        })
        assert cfg.service("mcp_server").port_range == (15000, 15010)

    def test_invalid_env_int(self):
        with pytest.raises(ConfigError):
            load_config(env={"MCP_SERVER_PORT": "zap"})

    def test_duplicate_preferred_ports_rejected(self):
        with pytest.raises(ConfigError):
            load_config(overrides={"services": {
                "mcp_server": {"preferred_port": 9000, "range": (9000, 9010)},
                "oauth_server": {"preferred_port": 9000, "range": (9000, 9010)},
            }}, env={})

    def test_startup_sequence_order(self):
        cfg = load_config(env={})
        seq = startup_sequence(cfg)
        assert seq.index("mcp_server") < seq.index("oauth_server") < seq.index("rest_api")

    def test_shutdown_timeout_env(self):
        cfg = load_config(env={"GRACEFUL_SHUTDOWN_TIMEOUT": "7"})
        assert cfg.graceful_shutdown_timeout == 7.0


class TestPortAllocation:
    def test_allocate_preferred(self):
        cfg = _make_config()
        pm = PortManager(cfg)
        port = pm.allocate("mcp_server")
        assert port == cfg.service("mcp_server").preferred_port
        assert pm.get_service_port("mcp_server") == port
        pm.release("mcp_server")
        assert pm.get_service_port("mcp_server") is None

    def test_conflict_fallback(self):
        cfg = _make_config()
        pref = cfg.service("mcp_server").preferred_port
        blocker = socket.socket()
        blocker.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        blocker.bind(("127.0.0.1", pref))
        blocker.listen(1)
        try:
            pm = PortManager(cfg)
            port = pm.allocate("mcp_server")
            assert port != pref
            assert cfg.service("mcp_server").port_range[0] <= port
        finally:
            blocker.close()

    def test_registry_no_double_bind(self):
        reg = PortRegistry()
        reg.register(BASE + 500, "a", "127.0.0.1")
        with pytest.raises(PortAllocationError):
            reg.register(BASE + 500, "b", "127.0.0.1")

    def test_batch_all_or_nothing(self):
        cfg = _make_config()
        pm = PortManager(cfg)
        ports = pm.allocate_all()
        assert set(ports) == {"mcp_server", "oauth_server", "rest_api",
                              "grpc_server", "health_check"}
        pm.release_all()

    def test_batch_rollback_on_failure(self):
        # exhaust the oauth range so batch allocation must fail + roll back
        cfg = _make_config()
        rng = cfg.service("oauth_server").port_range
        blockers = []
        try:
            for p in range(rng[0], rng[1] + 1):
                s = socket.socket()
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                try:
                    s.bind(("127.0.0.1", p))
                    s.listen(1)
                    blockers.append(s)
                except OSError:
                    s.close()
            pm = PortManager(cfg)
            with pytest.raises(PortAllocationError):
                pm.allocate_all(["mcp_server", "oauth_server"])
            # rollback released mcp too
            assert pm.get_service_port("mcp_server") is None
        finally:
            for s in blockers:
                s.close()

    def test_cleanup_dead_services(self):
        reg = PortRegistry()
        alive = {"v": True}
        reg.register(BASE + 600, "svc", "127.0.0.1", alive=lambda: alive["v"])
        assert reg.cleanup_dead_services() == []
        alive["v"] = False
        assert reg.cleanup_dead_services() == ["svc"]
        assert reg.port_of("svc") is None

    def test_status_shape(self):
        cfg = _make_config()
        pm = PortManager(cfg)
        pm.allocate("mcp_server")
        st = pm.status()
        assert st["mcp_server"]["status"] == "allocated"
        assert st["oauth_server"]["status"] == "unallocated"
        pm.release_all()

    def test_probe(self):
        assert probe_port(BASE + 700)
        s = socket.socket()
        s.bind(("127.0.0.1", BASE + 700))
        s.listen(1)
        try:
            assert not probe_port(BASE + 700)
        finally:
            s.close()


class TestHealth:
    def test_worst_of_aggregation(self):
        h = HealthCheckServer()
        h.register_check("a", lambda: ("healthy", {}))
        h.register_check("b", lambda: ("degraded", {"reason": "slow"}))
        out = h.run_all()
        assert out["status"] == "degraded"
        h.register_check("c", lambda: ("unhealthy", {}))
        assert h.overall() == "unhealthy"
        assert not h.ready()

    def test_crashing_check_is_unhealthy(self):
        h = HealthCheckServer()
        h.register_check("boom", lambda: 1 / 0)
        out = h.run_all()
        assert out["status"] == "unhealthy"
        assert "ZeroDivisionError" in out["checks"]["boom"]["details"]["error"]

    def test_unregister(self):
        h = HealthCheckServer()
        h.register_check("x", lambda: ("healthy", {}))
        assert h.unregister_check("x")
        assert not h.unregister_check("x")

    def test_durations_recorded(self):
        h = HealthCheckServer()
        h.register_check("t", lambda: ("healthy", {}))
        r = h.run_check("t")
        assert r["duration_us"] >= 0


class TestSignalHandler:
    def test_priority_ordering(self):
        sh = SignalHandler(total_timeout=5)
        order = []
        sh.register_callback("late", lambda: order.append("late"), priority=100)
        sh.register_callback("early", lambda: order.append("early"), priority=10)
        sh.register_callback("mid", lambda: order.append("mid"), priority=50)
        results = sh.shutdown()
        assert order == ["early", "mid", "late"]
        assert all(r["ok"] for r in results)

    def test_timeout_and_errors_do_not_block(self):
        sh = SignalHandler(total_timeout=2)
        done = []
        sh.register_callback("hang", lambda: time.sleep(10), priority=1)
        sh.register_callback("boom", lambda: 1 / 0, priority=2)
        sh.register_callback("fine", lambda: done.append(1), priority=3)
        results = sh.shutdown()
        assert results[0]["timed_out"]
        assert results[1]["error"] and "ZeroDivisionError" in results[1]["error"]
        assert results[2]["ok"] and done == [1]

    def test_shutdown_idempotent(self):
        sh = SignalHandler()
        sh.register_callback("once", lambda: None)
        assert len(sh.shutdown()) == 1
        assert sh.shutdown() == []

    def test_reregister_replaces(self):
        sh = SignalHandler()
        sh.register_callback("x", lambda: None, priority=5)
        sh.register_callback("x", lambda: None, priority=7)
        assert sh.callbacks() == ["x"]


class _FakeService:
    def __init__(self, host, port, fail=False):
        self.stopped = False
        if fail:
            raise RuntimeError("boot failure")
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(1)

    def stop(self):
        self.stopped = True
        self._sock.close()

    def is_alive(self):
        return not self.stopped


class TestStartupCoordinator:
    def test_ordered_startup_and_verify(self):
        cfg = _make_config()
        pm = PortManager(cfg)
        sc = StartupCoordinator(cfg, pm)
        ports = sc.coordinate_startup({
            "mcp_server": lambda h, p: _FakeService(h, p),
            "oauth_server": lambda h, p: _FakeService(h, p),
        })
        try:
            assert verify_tcp("127.0.0.1", ports["mcp_server"])
            status = sc.service_status()
            assert status["mcp_server"]["running"]
        finally:
            sc.shutdown_services()
        assert pm.get_service_port("mcp_server") is None

    def test_failure_rolls_back(self):
        cfg = _make_config()
        pm = PortManager(cfg)
        sc = StartupCoordinator(cfg, pm)
        started = []

        def good(h, p):
            s = _FakeService(h, p)
            started.append(s)
            return s

        with pytest.raises(StartupError):
            sc.coordinate_startup({
                "mcp_server": good,
                "oauth_server": lambda h, p: _FakeService(h, p, fail=True),
            })
        assert started[0].stopped  # rollback stopped the good one
        assert pm.get_service_port("mcp_server") is None

    def test_idempotent(self):
        cfg = _make_config()
        pm = PortManager(cfg)
        sc = StartupCoordinator(cfg, pm)
        f = {"mcp_server": lambda h, p: _FakeService(h, p)}
        p1 = sc.coordinate_startup(f)
        p2 = sc.coordinate_startup(f)
        try:
            assert p1["mcp_server"] == p2["mcp_server"]
        finally:
            sc.shutdown_services()
