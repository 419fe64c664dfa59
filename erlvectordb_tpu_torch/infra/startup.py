"""Startup coordinator — idempotent, ordered service boot with verification.

Capability parity with the reference's startup_coordinator
(src/startup_coordinator.erl): step 1 pre-allocate every service port, step 2
start services in startup order (:75-112); per-service "already running?"
check (:128-178); post-start verification by TCP connect with one retry
(:199-241); failure -> release ports + stop already-started services
(:243-259).
"""

from __future__ import annotations

import logging
import socket
import time
from typing import Callable, Dict

from erlvectordb_tpu_torch.infra.config import Config, startup_sequence
from erlvectordb_tpu_torch.infra.ports import PortAllocationError, PortManager

logger = logging.getLogger("evdb.startup")


class StartupError(RuntimeError):
    pass


def verify_tcp(host: str, port: int, timeout: float = 2.0, retries: int = 1) -> bool:
    """Post-start verification: can we connect? (reference :199-241)."""
    host = "127.0.0.1" if host == "0.0.0.0" else host
    for attempt in range(retries + 1):
        try:
            with socket.create_connection((host, port), timeout=timeout):
                return True
        except OSError:
            if attempt < retries:
                time.sleep(0.2)
    return False


class StartupCoordinator:
    """Boots services through their factories in config startup order.

    A factory is ``(host, port) -> service`` where the service has
    ``stop()`` and ``is_alive()``.
    """

    def __init__(self, config: Config, port_manager: PortManager):
        self.config = config
        self.port_manager = port_manager
        self.services: Dict[str, object] = {}
        self._started = False

    def coordinate_startup(
        self, factories: Dict[str, Callable[[str, int], object]]
    ) -> Dict[str, int]:
        """Pre-allocate all ports, then start + verify each service in
        order.  All-or-nothing: any failure rolls everything back."""
        if self._started:
            return {
                name: self.port_manager.get_service_port(name)
                for name in self.services
            }
        wanted = [s for s in startup_sequence(self.config) if s in factories]

        try:
            ports = self.port_manager.allocate_all(wanted)
        except PortAllocationError as e:
            raise StartupError(f"port pre-allocation failed: {e}")

        started: Dict[str, object] = {}
        try:
            for name in wanted:
                svc_cfg = self.config.service(name)
                port = ports[name]
                existing = self.services.get(name)
                if existing is not None and getattr(existing, "is_alive", lambda: False)():
                    started[name] = existing  # idempotent re-coordinate
                    continue
                service = factories[name](svc_cfg.bind_interface, port)
                started[name] = service
                if not verify_tcp(svc_cfg.bind_interface, port, retries=1):
                    raise StartupError(
                        f"service {name} did not accept connections on "
                        f"{svc_cfg.bind_interface}:{port}"
                    )
                logger.info("started %s on %s:%d", name, svc_cfg.bind_interface, port)
        except Exception as e:
            # rollback: stop started services, release every port (:243-259)
            for name, svc in started.items():
                try:
                    svc.stop()
                except Exception:  # noqa: BLE001
                    pass
            for name in wanted:
                self.port_manager.release(name)
            if isinstance(e, StartupError):
                raise
            raise StartupError(f"startup failed: {type(e).__name__}: {e}")

        self.services = started
        self._started = True
        return ports

    def shutdown_services(self) -> None:
        for name, svc in list(self.services.items()):
            try:
                svc.stop()
            except Exception:  # noqa: BLE001
                pass
            self.port_manager.release(name)
        self.services.clear()
        self._started = False

    def service_status(self) -> Dict[str, dict]:
        out = {}
        for name, svc in self.services.items():
            out[name] = {
                "running": bool(getattr(svc, "is_alive", lambda: False)()),
                "port": self.port_manager.get_service_port(name),
            }
        return out
