"""REST API server — the /api/v1 frontend.

Capability parity with the reference's rest_api_server
(src/rest_api_server.erl), gated by ``rest_api_enabled`` (:17-36):

  GET  /health, /health/detailed, /ready                     (:113-204)
  POST /api/v1/stores            create store                (:207-296)
  GET  /api/v1/stores            list stores
  DELETE /api/v1/stores/:name    delete store
  GET  /api/v1/stores/:name/stats                            (:339-340,544-556)
  POST /api/v1/stores/:name/vectors   insert                 (:317-328,419-439)
  POST /api/v1/stores/:name/search    top-k search           (:441-467)
       (optional nprobe / recall_target: direct sub-linear dispatch)
  POST /api/v1/stores/:name/calibrate recall-vs-nprobe curve (ours)
  DELETE /api/v1/stores/:name/vectors/:id   delete vector
  GET  /api/v1/ports/status, /api/v1/ports/service/:name     (:299-314,469-497)
  GET  /api/v1/cluster/status                                (:362-380)
  POST /api/v1/cluster/join                                  (:382-410)
       (join: 501 until multi-process is ported: ROADMAP Queue A item 3)
  CORS on every response + OPTIONS preflight                 (:412-413,599-605)

Bearer auth per request, scope-checked (read for GET/search, write for
insert/create, admin for delete/cluster) — reference :558-578.  The
reference's unreachable second POST search clause (:348-359, shadowed by the
generic POST route, with GET returning 501) is fixed: POST search is routed
properly here.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from erlvectordb_tpu_torch.api import Database
from erlvectordb_tpu_torch.core.registry import StoreExists, StoreNotFound
from erlvectordb_tpu_torch.core.store import DimensionMismatch, InvalidVector
from erlvectordb_tpu_torch.infra.health import HealthCheckServer
from erlvectordb_tpu_torch.serve import tools as tools_mod

logger = logging.getLogger("evdb.rest")

MAX_BODY_BYTES = 256 * 1024 * 1024  # request body cap


class RestServer:
    def __init__(
        self,
        db: Database,
        host: str = "127.0.0.1",
        port: int = 8082,
        health: Optional[HealthCheckServer] = None,
        port_manager=None,
    ):
        self.db = db
        self.host = host
        self.port = port
        self.health = health
        self.port_manager = port_manager
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "RestServer":
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                logger.debug(fmt, *args)

            # ------------------------------------------------------ helpers

            def _reply(self, code: int, payload) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self._cors()
                self.end_headers()
                self.wfile.write(body)

            def _cors(self):
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Access-Control-Allow-Methods",
                                 "GET, POST, DELETE, OPTIONS")
                self.send_header("Access-Control-Allow-Headers",
                                 "Authorization, Content-Type")

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length", 0))
                if not length:
                    return {}
                if length > MAX_BODY_BYTES:
                    raise ValueError(f"request body too large ({length} bytes)")
                raw = self.rfile.read(length)
                try:
                    return json.loads(raw)
                except json.JSONDecodeError:
                    raise ValueError("invalid JSON body")

            def _scopes(self):
                if not outer.db.oauth.enabled:
                    return {"read", "write", "admin"}
                auth = self.headers.get("Authorization", "")
                if not auth.startswith("Bearer "):
                    return None
                info = outer.db.oauth.validate_token(auth[7:])
                return None if info is None else info["scopes"]

            def _require(self, scope: str):
                scopes = self._scopes()
                if scopes is None:
                    self._reply(401, {"error": "authentication required"})
                    return None
                if scope not in scopes:
                    self._reply(403, {"error": f"scope {scope!r} required"})
                    return None
                return scopes

            # ------------------------------------------------------- routes

            def do_OPTIONS(self):
                self.send_response(204)
                self._cors()
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_GET(self):
                parts = [p for p in self.path.split("?")[0].split("/") if p]
                try:
                    # health endpoints are unauthenticated (reference :113)
                    if self.path == "/health":
                        st = outer.health.overall() if outer.health else "healthy"
                        return self._reply(200 if st != "unhealthy" else 503,
                                           {"status": st})
                    if self.path == "/health/detailed":
                        full = (outer.health.run_all() if outer.health
                                else {"status": "healthy", "checks": {}})
                        return self._reply(
                            200 if full["status"] != "unhealthy" else 503, full)
                    if self.path == "/ready":
                        ok = outer.health.ready() if outer.health else True
                        return self._reply(200 if ok else 503, {"ready": ok})
                    if self.path == "/metrics":
                        from erlvectordb_tpu_torch.utils.metrics import metrics

                        body = metrics.prometheus().encode()
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "text/plain; version=0.0.4")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return

                    if self._require("read") is None:
                        return
                    if parts == ["api", "v1", "metrics"]:
                        from erlvectordb_tpu_torch.utils.metrics import metrics

                        return self._reply(200, metrics.snapshot())
                    if parts == ["api", "v1", "stores"]:
                        return self._reply(200, {"stores": outer.db.list_stores()})
                    if (len(parts) == 5 and parts[:3] == ["api", "v1", "stores"]
                            and parts[4] == "stats"):
                        return self._reply(200, outer.db.any_store(parts[3]).get_stats())
                    if parts == ["api", "v1", "ports", "status"]:
                        pm = outer.port_manager
                        return self._reply(200, pm.status() if pm else {})
                    if (len(parts) == 5 and parts[:4] == ["api", "v1", "ports", "service"]):
                        pm = outer.port_manager
                        if pm is None:
                            return self._reply(404, {"error": "no port manager"})
                        port = pm.get_service_port(parts[4])
                        if port is None:
                            return self._reply(404, {"error": "service not found"})
                        return self._reply(200, {"service": parts[4], "port": port})
                    if parts == ["api", "v1", "cluster", "status"]:
                        return self._reply(200, outer.db.get_cluster_stats())
                    if parts == ["api", "v1", "backups"]:
                        return self._reply(200, {"backups": outer.db.list_backups()})
                    return self._reply(404, {"error": "not found"})
                except StoreNotFound as e:
                    return self._reply(404, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — per-request barrier
                    logger.exception("GET %s failed", self.path)
                    return self._reply(500, {"error": f"{type(e).__name__}: {e}"})

            def do_POST(self):
                parts = [p for p in self.path.split("?")[0].split("/") if p]
                try:
                    body = self._body()
                    if parts == ["api", "v1", "stores"]:
                        if self._require("write") is None:
                            return
                        name = body.get("name")
                        if not name:
                            return self._reply(400, {"error": "missing 'name'"})
                        stats = outer.db.create_store(
                            name,
                            dim=body.get("dimension"),
                            metric=body.get("metric", "cosine"),
                            dtype=body.get("dtype", "float32"),
                        )
                        return self._reply(201, stats)
                    if (len(parts) == 5 and parts[:3] == ["api", "v1", "stores"]
                            and parts[4] == "vectors"):
                        if self._require("write") is None:
                            return
                        store = outer.db.any_store(parts[3])
                        if "vectors" in body:  # batched insert
                            entries = body["vectors"]
                            store.insert_batch(
                                [e["id"] for e in entries],
                                [e["vector"] for e in entries],
                                [e.get("metadata") or {} for e in entries],
                            )
                            return self._reply(201, {"inserted": len(entries)})
                        store.insert(body["id"], body["vector"],
                                     body.get("metadata") or {})
                        return self._reply(201, {"inserted": 1, "id": body["id"]})
                    if (len(parts) == 5 and parts[:3] == ["api", "v1", "stores"]
                            and parts[4] == "search"):
                        if self._require("read") is None:
                            return
                        store = outer.db.any_store(parts[3])  # 404 first
                        kw = tools_mod.probe_kwargs(body)  # validated 400s
                        if kw:
                            # sub-linear latency path: direct dispatch IS
                            # the point (no batching window) — mirrors the
                            # MCP search_vectors tool (serve/tools.py)
                            outer.db._check_nprobe(store)
                            hits = store.search(
                                body["vector"], k=int(body.get("k", 10)),
                                metric=body.get("metric"),
                                where=body.get("filter"), **kw)
                        else:
                            hits = outer.db.batcher.search(
                                parts[3], body["vector"],
                                k=int(body.get("k", 10)),
                                metric=body.get("metric"),
                                where=body.get("filter"),
                            )
                        return self._reply(200, {"results": [
                            {"id": vid, "metadata": meta, "distance": dist}
                            for vid, meta, dist in hits
                        ]})
                    if (len(parts) == 5 and parts[:3] == ["api", "v1", "stores"]
                            and parts[4] == "calibrate"):
                        if self._require("write") is None:
                            return
                        curve = outer.db.calibrate_store(
                            parts[3],
                            n_sample=int(body.get("n_sample", 256)),
                            k=int(body.get("k", 10)),
                            metric=body.get("metric"))
                        # self-calibration is ceiling mode: recall relative
                        # to the store's own deep probe (quantization loss
                        # not counted) — exact mode needs external ground
                        # truth (Database.calibrate_store / calibrate_index)
                        return self._reply(200, {
                            "store": parts[3], "mode": "ceiling",
                            "curve": {str(p): r
                                      for p, r in sorted(curve.items())}})
                    if parts == ["api", "v1", "cluster", "join"]:
                        if self._require("admin") is None:
                            return
                        try:
                            stats = outer.db.join_cluster(
                                body.get("coordinator_address"),
                                body.get("num_processes"),
                                body.get("process_id"))
                        except NotImplementedError as e:
                            return self._reply(501, {"error": str(e)})
                        return self._reply(200, stats)
                    if (len(parts) == 5 and parts[:3] == ["api", "v1", "stores"]
                            and parts[4] == "backup"):
                        if self._require("admin") is None:
                            return
                        path = outer.db.backup_store(
                            parts[3], body.get("backup_name", "backup"))
                        return self._reply(201, {"backup_file": path.rsplit("/", 1)[-1]})
                    return self._reply(404, {"error": "not found"})
                except (KeyError,) as e:
                    return self._reply(400, {"error": f"missing field {e}"})
                except StoreExists as e:  # before ValueError: it subclasses it
                    return self._reply(409, {"error": str(e)})
                except StoreNotFound as e:
                    return self._reply(404, {"error": str(e)})
                except (ValueError, InvalidVector, DimensionMismatch) as e:
                    return self._reply(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001
                    logger.exception("POST %s failed", self.path)
                    return self._reply(500, {"error": f"{type(e).__name__}: {e}"})

            def do_DELETE(self):
                parts = [p for p in self.path.split("?")[0].split("/") if p]
                try:
                    if self._require("admin") is None:
                        return
                    if len(parts) == 4 and parts[:3] == ["api", "v1", "stores"]:
                        if outer.db.delete_store(parts[3]):
                            return self._reply(200, {"deleted": parts[3]})
                        return self._reply(404, {"error": "store not found"})
                    if (len(parts) == 6 and parts[:3] == ["api", "v1", "stores"]
                            and parts[4] == "vectors"):
                        store = outer.db.any_store(parts[3])
                        if store.delete(parts[5]):
                            return self._reply(200, {"deleted": parts[5]})
                        return self._reply(404, {"error": "vector not found"})
                    return self._reply(404, {"error": "not found"})
                except StoreNotFound as e:
                    return self._reply(404, {"error": str(e)})
                except Exception as e:  # noqa: BLE001
                    logger.exception("DELETE %s failed", self.path)
                    return self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="evdb-rest", daemon=True
        )
        self._thread.start()
        logger.info("REST API on %s:%d", self.host, self.port)
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
