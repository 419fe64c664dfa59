"""Client library — OAuth token management + MCP-over-TCP calls.

Capability parity with the reference's client side: oauth_client.erl
(get_access_token / refresh_access_token / make_authenticated_request,
src/oauth_client.erl:31-156) and the OAuthManager of the stdio bridge
(token fetch/cache/refresh with backoff and 401 retry,
examples/gemini_mcp_server.py:609-828).
"""

from __future__ import annotations

import json
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, Optional


class ClientError(Exception):
    pass


class OAuthManager:
    """Fetches, caches, and refreshes access tokens."""

    def __init__(self, token_url: str, client_id: str, client_secret: str,
                 scopes: Optional[list] = None, timeout: float = 5.0,
                 max_retries: int = 3):
        self.token_url = token_url
        self.client_id = client_id
        self.client_secret = client_secret
        self.scopes = scopes
        self.timeout = timeout
        self.max_retries = max_retries
        self._token: Optional[dict] = None
        self._expires_at = 0.0
        self._lock = threading.Lock()

    def _post_form(self, form: dict) -> dict:
        data = urllib.parse.urlencode(form).encode()
        req = urllib.request.Request(
            self.token_url, data=data,
            headers={"Content-Type": "application/x-www-form-urlencoded"},
            method="POST",
        )
        delay = 0.25
        last: Optional[Exception] = None
        for _ in range(self.max_retries):
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    return json.loads(resp.read())
            except urllib.error.HTTPError as e:
                body = e.read()
                try:
                    doc = json.loads(body)
                except json.JSONDecodeError:
                    doc = {"error": body.decode(errors="replace")}
                raise ClientError(f"token endpoint {e.code}: {doc.get('error')}")
            except (urllib.error.URLError, OSError) as e:  # transient
                last = e
                time.sleep(delay)
                delay *= 2  # exponential backoff (bridge :609-828 behavior)
        raise ClientError(f"token endpoint unreachable: {last}")

    def get_token(self, force: bool = False) -> str:
        with self._lock:
            now = time.time()
            if not force and self._token and now < self._expires_at - 30:
                return self._token["access_token"]
            if self._token and self._token.get("refresh_token") and not force:
                try:
                    tok = self._post_form({
                        "grant_type": "refresh_token",
                        "refresh_token": self._token["refresh_token"],
                    })
                    self._token = tok
                    self._expires_at = now + tok.get("expires_in", 3600)
                    return tok["access_token"]
                except ClientError:
                    pass  # fall through to a fresh grant
            form = {
                "grant_type": "client_credentials",
                "client_id": self.client_id,
                "client_secret": self.client_secret,
            }
            if self.scopes:
                form["scope"] = " ".join(self.scopes)
            tok = self._post_form(form)
            self._token = tok
            self._expires_at = now + tok.get("expires_in", 3600)
            return tok["access_token"]

    def invalidate(self) -> None:
        with self._lock:
            self._token = None
            self._expires_at = 0.0


class SocketHandler:
    """Framed JSON over TCP with reconnect + backoff and PROACTIVE health
    checks (bridge SocketHandler, examples/gemini_mcp_server.py:50-477 —
    connect/reconnect :76-360, check_connection_health :261-300).

    Resilience model:
      * ``check_health()`` probes the socket WITHOUT consuming protocol
        data (non-blocking MSG_PEEK): a remote FIN is visible as an empty
        read long before the next send would fail with a broken pipe.
      * ``request()`` runs that probe up front whenever the connection has
        been idle longer than ``idle_check_s`` — a bridge that sat idle
        behind a chat client for minutes reconnects BEFORE writing the
        user's request into a dead socket, instead of burning the request
        on an ECONNRESET and retrying.
      * On any transport error the request is retried once on a fresh
        connection (``connect`` itself retries ``max_reconnects`` times
        with exponential backoff).
    ``reconnects`` counts re-established connections for observability.

    The default timeout is generous because a server's FIRST search on
    the card pays the nvcc build of its CUDA kernels when the build
    directory is cold.  Servers should call ``Database.warmup()``
    after loading stores to hide this.
    """

    def __init__(self, host: str, port: int, timeout: float = 240.0,
                 max_reconnects: int = 5, idle_check_s: float = 30.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.max_reconnects = max_reconnects
        self.idle_check_s = idle_check_s
        self.reconnects = 0          # connections re-established after loss
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._last_io = 0.0
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        """'connected' | 'disconnected' (reference ConnectionState)."""
        return "connected" if self._sock is not None else "disconnected"

    def connect(self) -> None:
        delay = 0.2
        last: Optional[Exception] = None
        for _ in range(self.max_reconnects):
            try:
                self._sock = socket.create_connection(
                    (self.host, self.port), timeout=self.timeout
                )
                self._buf = b""
                self._last_io = time.monotonic()
                return
            except OSError as e:
                last = e
                time.sleep(delay)
                delay *= 2
        raise ClientError(f"cannot connect to {self.host}:{self.port}: {last}")

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def check_health(self) -> bool:
        """Liveness probe that consumes no protocol data.

        A non-blocking ``recv(1, MSG_PEEK)``: an empty read means the peer
        closed (FIN queued); ``BlockingIOError`` means no data pending but
        the connection is alive; any socket error means dead.  The socket
        is returned to blocking-with-timeout mode afterwards."""
        if self._sock is None:
            return False
        try:
            self._sock.setblocking(False)
            try:
                if self._sock.recv(1, socket.MSG_PEEK) == b"":
                    self.close()
                    return False
            except (BlockingIOError, InterruptedError):
                pass                        # nothing pending — alive
            finally:
                if self._sock is not None:
                    self._sock.settimeout(self.timeout)
            return True
        except OSError:
            self.close()
            return False

    def request(self, obj: dict) -> dict:
        """Send one JSON object, read one newline-terminated JSON reply.

        Proactively health-checks (and transparently reconnects) when the
        connection has been idle > ``idle_check_s``; reconnects once more
        on a transport error mid-request."""
        with self._lock:
            if (self._sock is not None and self.idle_check_s
                    and time.monotonic() - self._last_io > self.idle_check_s
                    and not self.check_health()):
                # dead idle connection detected BEFORE spending the request
                self.connect()
                self.reconnects += 1
            for attempt in range(2):
                if self._sock is None:
                    self.connect()
                try:
                    self._sock.sendall((json.dumps(obj) + "\n").encode())
                    while b"\n" not in self._buf:
                        chunk = self._sock.recv(65536)
                        if not chunk:
                            raise OSError("connection closed")
                        self._buf += chunk
                    line, self._buf = self._buf.split(b"\n", 1)
                    self._last_io = time.monotonic()
                    return json.loads(line)
                except OSError:
                    self.close()
                    if attempt == 1:
                        raise ClientError("connection lost and reconnect failed")
                    self.reconnects += 1
            raise ClientError("unreachable")


class VectorDBClient:
    """High-level client: tool wrappers over authenticated MCP calls
    (the mcp_client.py analogue: create_store/insert_vector/search_vectors/
    sync_store/backup/list_backups)."""

    def __init__(self, host: str = "127.0.0.1", mcp_port: int = 8080,
                 oauth_url: Optional[str] = None,
                 client_id: str = "erlvectordb_client",
                 client_secret: str = "erlvectordb_secret",
                 auth_enabled: bool = True):
        self.socket = SocketHandler(host, mcp_port)
        self.oauth = (
            OAuthManager(oauth_url, client_id, client_secret)
            if auth_enabled and oauth_url
            else None
        )
        self._id = 0

    def call(self, method: str, params: Optional[dict] = None) -> Any:
        self._id += 1
        req: Dict[str, Any] = {"jsonrpc": "2.0", "id": self._id,
                               "method": method, "params": params or {}}
        if self.oauth is not None:
            req["auth"] = {"token": self.oauth.get_token()}
        resp = self.socket.request(req)
        if "error" in resp:
            if resp["error"].get("code") == -32001 and self.oauth is not None:
                # expired token: force-refresh once and retry (bridge 401 path)
                req["auth"] = {"token": self.oauth.get_token(force=True)}
                resp = self.socket.request(req)
                if "error" not in resp:
                    return resp["result"]
            raise ClientError(f"{resp['error']['code']}: {resp['error']['message']}")
        return resp["result"]

    def tool(self, _tool: str, **arguments) -> Any:
        result = self.call("tools/call", {"name": _tool, "arguments": arguments})
        if result.get("isError"):
            raise ClientError(result)
        return json.loads(result["content"][0]["text"])

    # ---------------------------------------------------------------- sugar

    def initialize(self) -> dict:
        return self.call("initialize")

    def list_tools(self) -> list:
        return self.call("tools/list")["tools"]

    def create_store(self, name: str, **kw) -> dict:
        return self.tool("create_store", name=name, **kw)

    def insert_vector(self, store: str, vector_id: str, vector,
                      metadata: Optional[dict] = None) -> dict:
        return self.tool("insert_vector", store=store, id=vector_id,
                         vector=list(map(float, vector)),
                         metadata=metadata or {})

    def search_vectors(self, store: str, vector, k: int = 10) -> list:
        return self.tool("search_vectors", store=store,
                         vector=list(map(float, vector)), k=k)["results"]

    def delete_vector(self, store: str, vector_id: str) -> dict:
        return self.tool("delete_vector", store=store, id=vector_id)

    def sync_store(self, store: str) -> dict:
        return self.tool("sync_store", store=store)

    def backup_store(self, store: str, backup_name: str) -> dict:
        return self.tool("backup_store", store=store, backup_name=backup_name)

    def list_backups(self) -> list:
        return self.tool("list_backups")["backups"]

    def get_store_stats(self, store: str) -> dict:
        return self.tool("get_store_stats", store=store)

    def close(self) -> None:
        self.socket.close()
