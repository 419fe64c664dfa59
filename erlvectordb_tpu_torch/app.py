"""Application assembly — the supervision-tree analogue.

The reference's root supervisor starts port management, coordination, health,
signal handling, cluster, oauth, and the store supervisor, then the startup
coordinator boots the network servers post-hoc (src/erlvectordb_sup.erl:25-95,
src/startup_coordinator.erl:87).  :class:`Application` wires the same
components:

    Database (registry + persistence + oauth + cluster facade)
      ├─ PortManager / PortRegistry          (infra/ports.py)
      ├─ StartupCoordinator                  (infra/startup.py)
      │    ├─ MCP server     (serve/mcp_server.py)   startup_order 1
      │    ├─ OAuth HTTP     (serve/oauth_http.py)   startup_order 2
      │    ├─ REST API       (serve/rest_server.py)  startup_order 3
      │    └─ gRPC           (serve/grpc_server.py)  startup_order 4,
      │                      when grpcio is installed
      ├─ HealthCheckServer (+ container HTTP endpoint)
      └─ SignalHandler (graceful shutdown callbacks:
           10 release ports, 20 stop health endpoint, 30 stop services,
           100 stop database — reference signal_handler.erl:235-252)

The Database, and so every store it serves, lives on the CUDA card unless
the caller names another device (``device="cpu"``); without a card and
without that, building the Application raises the Database's error.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import torch

from erlvectordb_tpu_torch.api import Database
from erlvectordb_tpu_torch.infra.config import Config, load_config
from erlvectordb_tpu_torch.infra.health import (
    HealthCheckServer,
    HealthHTTPServer,
    default_checks,
)
from erlvectordb_tpu_torch.infra.ports import PortManager
from erlvectordb_tpu_torch.infra.signals import SignalHandler
from erlvectordb_tpu_torch.infra.startup import StartupCoordinator
from erlvectordb_tpu_torch.serve.mcp_server import MCPServer
from erlvectordb_tpu_torch.serve.oauth_http import OAuthHTTPServer
from erlvectordb_tpu_torch.serve.rest_server import RestServer

logger = logging.getLogger("evdb.app")


class Application:
    def __init__(self, config: Optional[Config] = None,
                 install_signals: bool = False,
                 device: Optional[torch.device] = None):
        self.config = config or load_config()
        self.db = Database(self.config, device=device)
        self.port_manager = PortManager(self.config)
        self.coordinator = StartupCoordinator(self.config, self.port_manager)
        self.health = HealthCheckServer()
        self.signals = SignalHandler(
            total_timeout=self.config.graceful_shutdown_timeout,
            install_signals=install_signals,
        )
        self.health_endpoint: Optional[HealthHTTPServer] = None
        self._running = False

    # ------------------------------------------------------------ lifecycle

    def start(self, disable_startup_coordination: bool = False) -> "Application":
        """Boot everything (the app-start analogue).  With
        ``disable_startup_coordination`` no network services start — the flag
        the reference's test suites rely on (src/erlvectordb_app.erl:21-24)."""
        if self._running:
            return self
        self.db.start()

        if not disable_startup_coordination:
            factories = {
                "mcp_server": lambda host, port: MCPServer(
                    self.db, host, port).start(),
                "oauth_server": lambda host, port: OAuthHTTPServer(
                    self.db.oauth, host, port).start(),
            }
            if self.config.rest_api_enabled:
                factories["rest_api"] = lambda host, port: RestServer(
                    self.db, host, port, health=self.health,
                    port_manager=self.port_manager,
                ).start()
            if self.config.grpc_enabled:
                from erlvectordb_tpu_torch.serve.grpc_server import GRPC_AVAILABLE

                if GRPC_AVAILABLE:
                    from erlvectordb_tpu_torch.serve.grpc_server import GrpcServer

                    factories["grpc_server"] = lambda host, port: GrpcServer(
                        self.db, host, port).start()
                else:
                    logger.warning("grpc_enabled but grpcio missing; skipping")
            self.coordinator.coordinate_startup(factories)

            if self.config.container_mode:
                svc = self.config.service("health_check")
                port = self.port_manager.allocate("health_check")
                self.health_endpoint = HealthHTTPServer(
                    self.health, svc.bind_interface, port
                ).start()

        default_checks(
            self.health, db=self.db, port_manager=self.port_manager,
            services=self.coordinator.services,
        )

        # graceful-shutdown callbacks, reference priorities (:235-252)
        self.signals.register_callback(
            "stop_services", self.coordinator.shutdown_services, priority=30
        )
        if self.health_endpoint is not None:
            self.signals.register_callback(
                "stop_health_endpoint", self.health_endpoint.stop, priority=20
            )
        self.signals.register_callback(
            "release_ports", self.port_manager.release_all, priority=10
        )
        self.signals.register_callback("stop_database", self.db.stop, priority=100)

        self._running = True
        return self

    def stop(self) -> None:
        if not self._running:
            return
        self.signals.shutdown()
        self._running = False

    # -------------------------------------------------------------- status

    def status(self) -> Dict[str, object]:
        return {
            "running": self._running,
            "development_mode": self.config.development_mode,
            "container_mode": self.config.container_mode,
            "ports": self.port_manager.status(),
            "services": self.coordinator.service_status(),
            "stores": self.db.list_stores(),
            "oauth": self.db.oauth.stats(),
            "health": self.health.run_all() if self._running else None,
        }

    def service_port(self, name: str) -> Optional[int]:
        return self.port_manager.get_service_port(name)
