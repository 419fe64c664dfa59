"""Health check engine — pluggable named checks with worst-of aggregation.

Capability parity with the reference's health_check_server
(src/health_check_server.erl): register/unregister named check functions
returning (healthy|degraded|unhealthy, details) (:30-40, :116-135); overall
status = worst of parts (:305-315); per-check duration timing (:280-303);
default checks for the port manager (:394-424) and application liveness
(:426-455); in container mode a standalone HTTP endpoint with /health,
/health/detailed, /ready (:208-267) — here the REST server serves those
routes, and ``HealthHTTPServer`` provides the standalone container endpoint.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

import torch

logger = logging.getLogger("evdb.health")

Status = str  # "healthy" | "degraded" | "unhealthy"
_RANK = {"healthy": 0, "degraded": 1, "unhealthy": 2}

CheckFn = Callable[[], Tuple[Status, dict]]


class HealthCheckServer:
    def __init__(self):
        self._checks: Dict[str, CheckFn] = {}
        self._lock = threading.RLock()

    def register_check(self, name: str, fn: CheckFn) -> None:
        with self._lock:
            self._checks[name] = fn

    def unregister_check(self, name: str) -> bool:
        with self._lock:
            return self._checks.pop(name, None) is not None

    def run_check(self, name: str) -> dict:
        with self._lock:
            fn = self._checks.get(name)
        if fn is None:
            return {"name": name, "status": "unhealthy",
                    "details": {"error": "unknown check"}, "duration_us": 0}
        t0 = time.perf_counter()
        try:
            status, details = fn()
            if status not in _RANK:
                status, details = "unhealthy", {"error": f"bad status {status!r}"}
        except Exception as e:  # a crashing check is an unhealthy check
            status, details = "unhealthy", {"error": f"{type(e).__name__}: {e}"}
        return {
            "name": name,
            "status": status,
            "details": details,
            "duration_us": int((time.perf_counter() - t0) * 1e6),
        }

    def run_all(self) -> dict:
        with self._lock:
            names = list(self._checks)
        results = [self.run_check(n) for n in names]
        overall = "healthy"
        for r in results:
            if _RANK[r["status"]] > _RANK[overall]:
                overall = r["status"]
        return {
            "status": overall,
            "timestamp": time.time(),
            "checks": {r["name"]: r for r in results},
        }

    def overall(self) -> Status:
        return self.run_all()["status"]

    def ready(self) -> bool:
        return self.overall() != "unhealthy"


def default_checks(health: HealthCheckServer, db=None, port_manager=None,
                   services=None) -> None:
    """Install the reference's default checks: required ports bound
    (:394-424) and core components alive (:426-455), plus a probe of the
    Database's device the reference has no analogue for."""
    if port_manager is not None:
        def ports_check():
            missing = [
                name for name, svc in port_manager.config.services.items()
                if svc.required and port_manager.get_service_port(name) is None
            ]
            if missing:
                return "unhealthy", {"unbound_required_services": missing}
            return "healthy", {"allocations": {
                n: port_manager.get_service_port(n)
                for n in port_manager.config.services
            }}
        health.register_check("port_manager", ports_check)

    if db is not None:
        def stores_check():
            try:
                stores = db.list_stores()
                return "healthy", {"stores": len(stores)}
            except Exception as e:
                return "unhealthy", {"error": str(e)}
        health.register_check("stores", stores_check)

        def device_check():
            """The Database's own device: a Database on the card is
            unhealthy when no card is visible; one on the CPU reports the
            CPU even where a card is present."""
            if db.device.type == "cpu":
                return "healthy", {"devices": 1, "platform": "cpu",
                                   "device": "cpu"}
            if not torch.cuda.is_available():
                return "unhealthy", {
                    "platform": "gpu",
                    "error": f"database on {db.device} but no CUDA device "
                             "is visible"}
            index = db.device.index if db.device.index is not None else 0
            return "healthy", {
                "devices": torch.cuda.device_count(),
                "platform": "gpu",
                "device": torch.cuda.get_device_name(index),
            }
        health.register_check("devices", device_check)

    if services is not None:
        def services_check():
            dead = [n for n, s in services.items()
                    if s is not None and not s.is_alive()]
            if dead:
                return "degraded", {"dead_services": dead}
            return "healthy", {"services": sorted(services)}
        health.register_check("services", services_check)


class HealthHTTPServer:
    """Standalone container-mode health endpoint (reference :208-267)."""

    def __init__(self, health: HealthCheckServer, host: str = "0.0.0.0",
                 port: int = 8090):
        self.health = health
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HealthHTTPServer":
        health = self.health

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                logger.debug(fmt, *args)

            def _reply(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    st = health.overall()
                    self._reply(200 if st != "unhealthy" else 503, {"status": st})
                elif self.path == "/health/detailed":
                    full = health.run_all()
                    self._reply(200 if full["status"] != "unhealthy" else 503, full)
                elif self.path == "/ready":
                    ok = health.ready()
                    self._reply(200 if ok else 503, {"ready": ok})
                else:
                    self._reply(404, {"error": "not_found"})

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="evdb-health-http", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def is_alive(self) -> bool:
        return self._httpd is not None
