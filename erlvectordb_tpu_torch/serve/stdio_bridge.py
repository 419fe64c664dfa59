"""stdio <-> TCP MCP bridge — connect an MCP desktop client to the server.

Capability parity with the reference's production bridge
(examples/gemini_mcp_server.py): line-delimited JSON-RPC on stdio
(StdioHandler :830-949), a resilient TCP connection with reconnect/backoff
(SocketHandler :50-477), OAuth token management with refresh and 401 retry
(OAuthManager :609-828), request routing with JSON-RPC error mapping
(RequestRouter :961-1294), and an env-var config matrix (ServerConfig
:479-601).

Env vars (EVDB_* with the reference's ERLVECTORDB_* accepted as aliases):
  EVDB_HOST (default 127.0.0.1)       EVDB_MCP_PORT (default 8080)
  EVDB_OAUTH_URL (default http://<host>:8081/oauth/token)
  EVDB_CLIENT_ID / EVDB_CLIENT_SECRET
  EVDB_AUTH_ENABLED (default true)    EVDB_TIMEOUT (seconds)

Run: ``python -m erlvectordb_tpu_torch.serve.stdio_bridge``
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys
from dataclasses import dataclass
from typing import Optional, TextIO

from erlvectordb_tpu_torch.serve.client import ClientError, OAuthManager, SocketHandler

logger = logging.getLogger("evdb.bridge")


def _env(*names: str, default: Optional[str] = None) -> Optional[str]:
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return v
    return default


@dataclass
class BridgeConfig:
    host: str = "127.0.0.1"
    mcp_port: int = 8080
    oauth_url: Optional[str] = None
    client_id: str = "erlvectordb_client"
    client_secret: str = "erlvectordb_secret"
    auth_enabled: bool = True
    timeout: float = 240.0

    @classmethod
    def from_environment(cls) -> "BridgeConfig":
        """Env-var config with validation (reference ServerConfig :479-601)."""
        host = _env("EVDB_HOST", "ERLVECTORDB_HOST", default="127.0.0.1")
        port_s = _env("EVDB_MCP_PORT", "ERLVECTORDB_MCP_PORT", default="8080")
        try:
            port = int(port_s)
        except ValueError:
            raise ValueError(f"EVDB_MCP_PORT={port_s!r} is not an integer")
        if not (0 < port < 65536):
            raise ValueError(f"EVDB_MCP_PORT={port} out of range")
        auth = _env("EVDB_AUTH_ENABLED", "ERLVECTORDB_AUTH_ENABLED",
                    default="true").lower() in ("1", "true", "yes")
        oauth_url = _env("EVDB_OAUTH_URL", "ERLVECTORDB_OAUTH_URL")
        if auth and not oauth_url:
            oauth_port = _env("EVDB_OAUTH_PORT", default="8081")
            oauth_url = f"http://{host}:{oauth_port}/oauth/token"
        timeout_s = _env("EVDB_TIMEOUT", default="240")
        try:
            timeout = float(timeout_s)
        except ValueError:
            raise ValueError(f"EVDB_TIMEOUT={timeout_s!r} is not a number")
        return cls(
            host=host,
            mcp_port=port,
            oauth_url=oauth_url,
            client_id=_env("EVDB_CLIENT_ID", "ERLVECTORDB_CLIENT_ID",
                           default="erlvectordb_client"),
            client_secret=_env("EVDB_CLIENT_SECRET", "ERLVECTORDB_CLIENT_SECRET",
                               default="erlvectordb_secret"),
            auth_enabled=auth,
            timeout=timeout,
        )


class RequestRouter:
    """Forwards stdio JSON-RPC requests to the TCP server, injecting auth and
    mapping transport failures to JSON-RPC errors (reference :961-1294)."""

    def __init__(self, config: BridgeConfig):
        self.config = config
        self.socket = SocketHandler(config.host, config.mcp_port,
                                    timeout=config.timeout)
        self.oauth = (
            OAuthManager(config.oauth_url, config.client_id,
                         config.client_secret)
            if config.auth_enabled and config.oauth_url
            else None
        )

    def route(self, req: dict) -> Optional[dict]:
        req_id = req.get("id")
        if req.get("method", "").startswith("notifications/"):
            return None  # notifications are not forwarded upstream responses
        try:
            if self.oauth is not None:
                req = dict(req)
                req["auth"] = {"token": self.oauth.get_token()}
            resp = self.socket.request(req)
            if (
                isinstance(resp.get("error"), dict)
                and resp["error"].get("code") == -32001
                and self.oauth is not None
            ):
                req["auth"] = {"token": self.oauth.get_token(force=True)}
                resp = self.socket.request(req)
            # id preservation (reference test: id must round-trip)
            resp["id"] = req_id
            return resp
        except ClientError as e:
            return {"jsonrpc": "2.0", "id": req_id,
                    "error": {"code": -32000, "message": f"bridge: {e}"}}
        except Exception as e:  # noqa: BLE001 — bridge must never crash
            logger.exception("routing failed")
            return {"jsonrpc": "2.0", "id": req_id,
                    "error": {"code": -32603, "message": f"{type(e).__name__}: {e}"}}


class StdioBridge:
    """Line-delimited JSON-RPC loop on stdio (reference StdioHandler +
    MCPServer run loop :830-949, :1296-1450)."""

    def __init__(self, config: Optional[BridgeConfig] = None,
                 stdin: Optional[TextIO] = None,
                 stdout: Optional[TextIO] = None):
        self.config = config or BridgeConfig.from_environment()
        self.router = RequestRouter(self.config)
        self.stdin = stdin or sys.stdin
        self.stdout = stdout or sys.stdout
        self._running = False

    def _write(self, obj: dict) -> None:
        self.stdout.write(json.dumps(obj) + "\n")
        self.stdout.flush()

    def handle_line(self, line: str) -> Optional[dict]:
        line = line.strip()
        if not line:
            return None
        try:
            req = json.loads(line)
        except json.JSONDecodeError:
            return {"jsonrpc": "2.0", "id": None,
                    "error": {"code": -32700, "message": "Parse error"}}
        return self.router.route(req)

    def run(self) -> None:
        self._running = True

        def stop(*_):
            self._running = False
            try:
                self.router.socket.close()
            except Exception:  # noqa: BLE001
                pass

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, stop)
            except ValueError:
                pass
        logger.info("bridge: stdio <-> %s:%d", self.config.host,
                    self.config.mcp_port)
        while self._running:
            line = self.stdin.readline()
            if not line:  # EOF: client closed stdin
                break
            resp = self.handle_line(line)
            if resp is not None:
                self._write(resp)
        self.router.socket.close()


def main() -> None:
    logging.basicConfig(level=os.environ.get("EVDB_LOG_LEVEL", "WARNING"),
                        stream=sys.stderr)
    StdioBridge().run()


if __name__ == "__main__":
    main()
