"""Layered configuration — capability parity with the reference's config stack.

The reference loads config with precedence env-vars > config file > app env >
defaults (src/port_config.erl:62-84), keeps a per-service schema
{preferred_port, port_range, bind_interface, required, startup_order,
health_check_path} (:39-56,169-204), and autodetects development mode
(:573-589) and container mode (:752-793) with their port/interface overrides.
This module reproduces those capabilities:

  precedence:  env vars  >  programmatic overrides  >  config file (JSON) >
               mode defaults (dev/container)     >  built-in defaults
  (overrides beat the file: they are the embedding application's explicit
  wiring — e.g. test harnesses and the bench rig pin ports/dirs that a
  stray config file must not silently hijack)

Env vars (EVDB_* replaces the reference's ERLVECTORDB_*; legacy names also
accepted):
  EVDB_CONFIG_FILE                   path to JSON config
  EVDB_DEV_MODE / NODE_ENV=development    dev mode (base ports 908x)
  CONTAINER / DOCKER / KUBERNETES_SERVICE_HOST   container mode
  PORT                               container port override for the MCP service
  BIND_ALL_INTERFACES=1              bind 0.0.0.0 everywhere
  GRACEFUL_SHUTDOWN_TIMEOUT          seconds
  LOG_PORT_MAPPINGS=1
  <SERVICE>_PORT, <SERVICE>_PORT_RANGE_START/END, <SERVICE>_BIND_INTERFACE,
  <SERVICE>_REQUIRED   with SERVICE in MCP_SERVER, OAUTH_SERVER, REST_API,
                       HEALTH_CHECK (reference :361-439 naming)
"""

from __future__ import annotations

import json
import os
import socket
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

SERVICES = ("mcp_server", "oauth_server", "rest_api", "grpc_server",
            "health_check")

_ENV_SERVICE_NAMES = {
    "mcp_server": "MCP_SERVER",
    "oauth_server": "OAUTH_SERVER",
    "rest_api": "REST_API",
    "grpc_server": "GRPC_SERVER",
    "health_check": "HEALTH_CHECK",
}

# Built-in defaults (prod ports mirror the reference: mcp 8080, oauth 8081,
# rest 8082, health 8090; dev mode shifts to 908x — src/port_config.erl:206-229).
_DEFAULTS = {
    "mcp_server": dict(preferred_port=8080, range=(8080, 8099), startup_order=1,
                       required=True, health_check_path="/health"),
    "oauth_server": dict(preferred_port=8081, range=(8081, 8099), startup_order=2,
                         required=True, health_check_path="/oauth/client_info"),
    "rest_api": dict(preferred_port=8082, range=(8082, 8099), startup_order=3,
                     required=False, health_check_path="/health"),
    "grpc_server": dict(preferred_port=8083, range=(8083, 8099), startup_order=4,
                        required=False, health_check_path="/"),
    "health_check": dict(preferred_port=8090, range=(8090, 8099), startup_order=5,
                         required=False, health_check_path="/health"),
}
_DEV_BASE = {"mcp_server": 9080, "oauth_server": 9081, "rest_api": 9082,
             "grpc_server": 9083, "health_check": 9090}
_DEV_RANGE_SIZE = 20


class ConfigError(ValueError):
    pass


@dataclass(frozen=True)
class ServiceConfig:
    name: str
    preferred_port: int
    port_range: Tuple[int, int]
    bind_interface: str = "127.0.0.1"
    required: bool = True
    startup_order: int = 99
    health_check_path: str = "/health"

    def validate(self) -> None:
        lo, hi = self.port_range
        if not (0 < lo <= hi < 65536):
            raise ConfigError(f"{self.name}: invalid port range {self.port_range}")
        if not (0 < self.preferred_port < 65536):
            raise ConfigError(f"{self.name}: invalid port {self.preferred_port}")


@dataclass(frozen=True)
class Config:
    services: Dict[str, ServiceConfig] = field(default_factory=dict)
    development_mode: bool = False
    container_mode: bool = False
    bind_all_interfaces: bool = False
    graceful_shutdown_timeout: float = 30.0
    log_port_mappings: bool = False
    # persistence (reference sys.config keys)
    persistence_enabled: bool = True
    persistence_dir: str = "data"
    backup_dir: str = "backups"
    sync_interval: float = 30.0
    compression_enabled: bool = False
    compression_algorithm: str = "zlib"
    # staleness-driven cell refit: int4r stores whose churn fraction
    # (inserts+deletes since build / built rows) exceeds this are refit by
    # the maintenance loop; 0 disables
    refit_threshold: float = 0.5
    # oauth
    oauth_enabled: bool = True
    access_token_lifetime: float = 3600.0
    refresh_token_lifetime: float = 86400.0
    default_client_id: Optional[str] = "erlvectordb_client"
    default_client_secret: Optional[str] = "erlvectordb_secret"
    # cluster
    cluster_enabled: bool = False
    replication_factor: int = 1
    # rest
    rest_api_enabled: bool = True
    # grpc (parity-plus frontend; needs grpcio — degrades to disabled without)
    grpc_enabled: bool = True
    # serving: pre-compile search programs for loaded stores at startup
    warmup_on_start: bool = False

    def service(self, name: str) -> ServiceConfig:
        return self.services[name]

    def validate(self) -> None:
        used: Dict[int, str] = {}
        for svc in self.services.values():
            svc.validate()
            if svc.preferred_port in used:
                raise ConfigError(
                    f"port {svc.preferred_port} claimed by both "
                    f"{used[svc.preferred_port]} and {svc.name}"
                )
            used[svc.preferred_port] = svc.name


def is_development_mode(env=os.environ) -> bool:
    """Reference detection: app env / ERLVECTORDB_DEV_MODE / NODE_ENV
    (src/port_config.erl:573-589)."""
    if env.get("EVDB_DEV_MODE", env.get("ERLVECTORDB_DEV_MODE", "")).lower() in ("1", "true", "yes"):
        return True
    return env.get("NODE_ENV", "").lower() == "development"


def is_container_mode(env=os.environ) -> bool:
    """Reference detection: CONTAINER/DOCKER/KUBERNETES_SERVICE_HOST env or
    container-ish hostname / cgroup (src/port_config.erl:752-793)."""
    for var in ("CONTAINER", "DOCKER", "KUBERNETES_SERVICE_HOST"):
        if env.get(var):
            return True
    if Path("/.dockerenv").exists():
        return True
    try:
        host = socket.gethostname()
        if len(host) == 12 and all(c in "0123456789abcdef" for c in host):
            return True  # docker default hostnames
    except Exception:
        pass
    return False


def _env_bool(env, *names, default=None):
    for n in names:
        v = env.get(n)
        if v is not None:
            return v.lower() in ("1", "true", "yes")
    return default


def _env_int(env, *names, default=None):
    for n in names:
        v = env.get(n)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                raise ConfigError(f"env {n}={v!r} is not an integer")
    return default


def load_config(
    config_file: Optional[str] = None,
    overrides: Optional[dict] = None,
    env=None,
) -> Config:
    """Build the effective Config with the reference's precedence chain."""
    env = os.environ if env is None else env
    overrides = overrides or {}

    dev = overrides.get("development_mode")
    if dev is None:
        dev = is_development_mode(env)
    container = overrides.get("container_mode")
    if container is None:
        container = is_container_mode(env)

    # layer 1: defaults (mode-adjusted)
    svc_cfg: Dict[str, dict] = {}
    for name in SERVICES:
        d = dict(_DEFAULTS[name])
        if dev:
            base = _DEV_BASE[name]
            d["preferred_port"] = base
            d["range"] = (base, base + _DEV_RANGE_SIZE - 1)
        svc_cfg[name] = d

    top: dict = {}

    # layer 2: config file
    path = config_file or env.get("EVDB_CONFIG_FILE") or env.get("ERLVECTORDB_CONFIG_FILE")
    if path is None:
        # search path like the reference (:285-313)
        for cand in ("evdb.json", "config/evdb.json",
                     os.path.expanduser("~/.config/evdb/config.json")):
            if Path(cand).exists():
                path = cand
                break
    if path:
        try:
            doc = json.loads(Path(path).read_text())
        except (OSError, json.JSONDecodeError) as e:
            raise ConfigError(f"config file {path}: {e}")
        for name, svc in (doc.get("services") or {}).items():
            if name not in svc_cfg:
                raise ConfigError(f"config file: unknown service {name!r}")
            if "preferred_port" in svc:
                svc_cfg[name]["preferred_port"] = int(svc["preferred_port"])
            if "port_range" in svc:
                svc_cfg[name]["range"] = tuple(svc["port_range"])
            for key in ("bind_interface", "required", "startup_order",
                        "health_check_path"):
                if key in svc:
                    svc_cfg[name][key] = svc[key]
        for key in ("persistence_enabled", "persistence_dir", "backup_dir",
                    "sync_interval", "refit_threshold",
                    "compression_enabled", "compression_algorithm",
                    "oauth_enabled", "access_token_lifetime", "refresh_token_lifetime",
                    "default_client_id", "default_client_secret",
                    "cluster_enabled", "replication_factor", "rest_api_enabled",
                    "grpc_enabled", "warmup_on_start",
                    "bind_all_interfaces", "graceful_shutdown_timeout",
                    "log_port_mappings"):
            if key in doc:
                top[key] = doc[key]

    # layer 3: programmatic overrides
    for name, svc in (overrides.get("services") or {}).items():
        if name not in svc_cfg:
            raise ConfigError(f"overrides: unknown service {name!r}")
        svc_cfg[name].update(svc)
    for k, v in overrides.items():
        if k not in ("services", "development_mode", "container_mode"):
            top[k] = v

    # layer 4: env vars (highest precedence; reference :361-439)
    for name in SERVICES:
        e = _ENV_SERVICE_NAMES[name]
        port = _env_int(env, f"{e}_PORT")
        if port is not None:
            svc_cfg[name]["preferred_port"] = port
        lo = _env_int(env, f"{e}_PORT_RANGE_START")
        hi = _env_int(env, f"{e}_PORT_RANGE_END")
        if lo is not None or hi is not None:
            cur = svc_cfg[name]["range"]
            svc_cfg[name]["range"] = (lo or cur[0], hi or cur[1])
        iface = env.get(f"{e}_BIND_INTERFACE")
        if iface:
            svc_cfg[name]["bind_interface"] = iface
        req = _env_bool(env, f"{e}_REQUIRED")
        if req is not None:
            svc_cfg[name]["required"] = req

    # container-mode adjustments (reference :820-905)
    bind_all = _env_bool(env, "BIND_ALL_INTERFACES", default=None)
    if bind_all is None:
        bind_all = bool(container) or bool(top.get("bind_all_interfaces", False))
    port_override = _env_int(env, "PORT")
    if container and port_override is not None:
        svc_cfg["mcp_server"]["preferred_port"] = port_override

    shutdown_timeout = env.get("GRACEFUL_SHUTDOWN_TIMEOUT")
    if shutdown_timeout is not None:
        try:
            top["graceful_shutdown_timeout"] = float(shutdown_timeout)
        except ValueError:
            raise ConfigError("GRACEFUL_SHUTDOWN_TIMEOUT must be a number")
    lpm = _env_bool(env, "LOG_PORT_MAPPINGS")
    if lpm is not None:
        top["log_port_mappings"] = lpm

    services = {}
    for name, d in svc_cfg.items():
        iface = d.get("bind_interface", "0.0.0.0" if bind_all else "127.0.0.1")
        if bind_all and iface == "127.0.0.1":
            iface = "0.0.0.0"
        services[name] = ServiceConfig(
            name=name,
            preferred_port=d["preferred_port"],
            port_range=tuple(d["range"]),
            bind_interface=iface,
            required=bool(d.get("required", True)),
            startup_order=int(d.get("startup_order", 99)),
            health_check_path=d.get("health_check_path", "/health"),
        )

    cfg = Config(
        services=services,
        development_mode=bool(dev),
        container_mode=bool(container),
        bind_all_interfaces=bool(bind_all),
        **{k: v for k, v in top.items() if k in Config.__dataclass_fields__},
    )
    cfg.validate()
    return cfg


def startup_sequence(cfg: Config) -> List[str]:
    """Service names in startup order (reference :455-471)."""
    return [s.name for s in sorted(cfg.services.values(), key=lambda s: s.startup_order)]
