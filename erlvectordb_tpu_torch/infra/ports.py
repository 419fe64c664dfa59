"""Port registry and allocator — the reference's L7 port-management layer.

Capabilities mirrored (reference src/port_manager.erl, src/port_registry.erl):
  * bind-probe availability check (listen then close, an acknowledged TOCTOU
    race mitigated by retry on EADDRINUSE — reference port_manager.erl:336-351,
    :301-322);
  * preferred-port-then-range allocation with retry (:258-334);
  * all-or-nothing batch allocation with rollback (:229-256);
  * pre-allocation of every service's port before startup (:509-524);
  * a port->service binding table with a reserved-port blacklist and
    owner-liveness cleanup (registry :314-391, :397-441 — ownership here is
    a Python object + optional liveness callback instead of an Erlang pid
    monitor);
  * container-aware port-mapping logging (:839-916).
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from erlvectordb_tpu_torch.infra.config import Config, startup_sequence

logger = logging.getLogger("evdb.ports")

# well-known ports never to hand out (reference reserved list :389-391)
RESERVED_PORTS = {22, 25, 53, 80, 110, 143, 443, 993, 995}


class PortAllocationError(RuntimeError):
    pass


def probe_port(port: int, interface: str = "127.0.0.1") -> bool:
    """Bind-probe: can we listen on this port right now?"""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((interface, port))
            s.listen(1)
        return True
    except OSError:
        return False


@dataclass
class Binding:
    port: int
    service: str
    interface: str
    allocated_at: float = field(default_factory=time.time)
    alive: Optional[Callable[[], bool]] = None  # liveness probe for cleanup


class PortRegistry:
    """Thread-safe port->service binding table."""

    def __init__(self):
        self._bindings: Dict[int, Binding] = {}
        self._by_service: Dict[str, int] = {}
        self._lock = threading.RLock()

    def register(self, port: int, service: str, interface: str,
                 alive: Optional[Callable[[], bool]] = None) -> None:
        with self._lock:
            if port in self._bindings and self._bindings[port].service != service:
                raise PortAllocationError(
                    f"port {port} already bound to {self._bindings[port].service}"
                )
            old = self._by_service.get(service)
            if old is not None and old != port:
                self._bindings.pop(old, None)
            self._bindings[port] = Binding(port, service, interface, alive=alive)
            self._by_service[service] = port

    def release(self, service: str) -> Optional[int]:
        with self._lock:
            port = self._by_service.pop(service, None)
            if port is not None:
                self._bindings.pop(port, None)
            return port

    def port_of(self, service: str) -> Optional[int]:
        with self._lock:
            return self._by_service.get(service)

    def service_of(self, port: int) -> Optional[str]:
        with self._lock:
            b = self._bindings.get(port)
            return b.service if b else None

    def bindings(self) -> List[Binding]:
        with self._lock:
            return list(self._bindings.values())

    def cleanup_dead_services(self) -> List[str]:
        """Drop bindings whose owner reports dead (reference 'DOWN' sweep,
        port_registry.erl:249-287, :397-441)."""
        removed = []
        with self._lock:
            for b in list(self._bindings.values()):
                if b.alive is not None:
                    try:
                        ok = b.alive()
                    except Exception:
                        ok = False
                    if not ok:
                        self._bindings.pop(b.port, None)
                        self._by_service.pop(b.service, None)
                        removed.append(b.service)
        return removed

    def find_available_port(
        self, preferred: int, port_range: Tuple[int, int], interface: str
    ) -> Optional[int]:
        """Preferred port first, then linear scan of the range
        (reference :325-382)."""
        with self._lock:
            candidates = [preferred] + [
                p for p in range(port_range[0], port_range[1] + 1) if p != preferred
            ]
            for p in candidates:
                if p in RESERVED_PORTS or p in self._bindings:
                    continue
                if probe_port(p, interface):
                    return p
            return None


class PortManager:
    """Service port allocation + ordered startup bookkeeping."""

    def __init__(self, config: Config, registry: Optional[PortRegistry] = None):
        self.config = config
        self.registry = registry or PortRegistry()
        self._lock = threading.RLock()

    # -- single allocation ---------------------------------------------------

    def allocate(self, service: str, retries: int = 3) -> int:
        """Allocate a port for a service with bind-probe + retry
        (reference allocate_with_retry :280-334)."""
        svc = self.config.service(service)
        last_err: Optional[str] = None
        for _ in range(retries):
            port = self.registry.find_available_port(
                svc.preferred_port, svc.port_range, svc.bind_interface
            )
            if port is None:
                last_err = f"no free port in {svc.port_range}"
                time.sleep(0.02)
                continue
            try:
                self.registry.register(port, service, svc.bind_interface)
                return port
            except PortAllocationError as e:  # raced another allocator
                last_err = str(e)
        raise PortAllocationError(f"{service}: {last_err}")

    def release(self, service: str) -> Optional[int]:
        return self.registry.release(service)

    def get_service_port(self, service: str) -> Optional[int]:
        return self.registry.port_of(service)

    # -- batch ----------------------------------------------------------------

    def allocate_all(self, services: Optional[List[str]] = None) -> Dict[str, int]:
        """All-or-nothing batch allocation with rollback
        (reference :229-256, pre_allocate_all_ports :509-524)."""
        services = services or startup_sequence(self.config)
        got: Dict[str, int] = {}
        try:
            for name in services:
                got[name] = self.allocate(name)
        except PortAllocationError:
            for name in got:
                self.release(name)
            raise
        if self.config.log_port_mappings or self.config.container_mode:
            self.log_port_mappings()
        return got

    def release_all(self) -> None:
        for name in list(self.config.services):
            self.release(name)

    # -- status ----------------------------------------------------------------

    def status(self) -> dict:
        """Port status API payload (reference rest /api/v1/ports/status)."""
        out = {}
        for name, svc in self.config.services.items():
            port = self.registry.port_of(name)
            out[name] = {
                "service": name,
                "allocated_port": port,
                "preferred_port": svc.preferred_port,
                "port_range": list(svc.port_range),
                "bind_interface": svc.bind_interface,
                "required": svc.required,
                "startup_order": svc.startup_order,
                "status": "allocated" if port is not None else "unallocated",
            }
        return out

    def log_port_mappings(self) -> None:
        """Container-style port mapping log (reference :839-916)."""
        for b in self.registry.bindings():
            logger.info(
                "port mapping: %s -> %s:%d", b.service, b.interface, b.port
            )

    # -- dev mode ---------------------------------------------------------------

    def kill_existing_instances(self, services: Optional[List[str]] = None) -> List[int]:
        """Dev-mode capability (reference :758-833): report ports in our
        ranges that are currently occupied by *something else*.  We never
        kill foreign processes — we return the occupied ports so the dev CLI
        can surface them (safer than the reference's pkill approach)."""
        if not self.config.development_mode:
            raise PortAllocationError("kill_existing_instances requires dev mode")
        services = services or list(self.config.services)
        occupied = []
        for name in services:
            svc = self.config.service(name)
            for p in range(svc.port_range[0], svc.port_range[1] + 1):
                if self.registry.service_of(p) is None and not probe_port(
                    p, svc.bind_interface
                ):
                    occupied.append(p)
        return occupied
