"""MCP server — JSON-RPC 2.0 over raw TCP, one handler thread per client.

Capability parity with the reference's mcp_server (src/mcp_server.erl):
  * listens on the port-manager-assigned MCP port (:36-58), accept loop
    spawning a handler per connection (:79-89) — thread-per-connection here;
  * request loop: recv -> JSON decode -> auth -> dispatch -> respond (:91-133);
  * methods: ``initialize`` (protocolVersion 2024-11-05, advertises
    oauth2.1; :135-155), ``tools/list`` filtered by client scopes
    (:157-165), ``tools/call`` with scope enforcement (:167-188), plus
    ``ping`` and ``notifications/initialized`` accepted per MCP spec;
  * auth: bearer token in the nonstandard top-level ``"auth"`` field the
    reference uses (:201-218) AND standard ``params.auth`` /
    ``Authorization``-style fallbacks; ``oauth_enabled=false`` grants all
    scopes;
  * framing: newline-delimited JSON, plus tolerant incremental decode of
    concatenated JSON objects (what the reference's raw recv+jsx amounts to).

The reference's create_store/insert_vector dispatch bug is fixed in
serve/tools.py (see its module docstring).
"""

from __future__ import annotations

import json
import logging
import socket
import threading
from typing import Optional, Set

from erlvectordb_tpu_torch.api import Database
from erlvectordb_tpu_torch.serve import tools as tools_mod
from erlvectordb_tpu_torch.utils.metrics import metrics

logger = logging.getLogger("evdb.mcp")

PROTOCOL_VERSION = "2024-11-05"
MAX_BUFFER_BYTES = 64 * 1024 * 1024  # per-connection framing buffer cap
SERVER_NAME = "erlvectordb-tpu"
SERVER_VERSION = "0.1.0"

# JSON-RPC error codes
PARSE_ERROR = -32700
INVALID_REQUEST = -32600
METHOD_NOT_FOUND = -32601
INVALID_PARAMS = -32602
INTERNAL_ERROR = -32603
AUTH_ERROR = -32001
PERMISSION_ERROR = -32002


def _error(req_id, code, message):
    return {"jsonrpc": "2.0", "id": req_id, "error": {"code": code, "message": message}}


def _result(req_id, result):
    return {"jsonrpc": "2.0", "id": req_id, "result": result}


def _tool_result(req_id, out) -> dict:
    return _result(req_id, {
        "content": [{"type": "text", "text": json.dumps(out)}],
        "isError": False,
    })


# Sentinel: request accepted, response will be delivered asynchronously by a
# batcher completion callback (JSON-RPC ids make out-of-order replies legal,
# so one connection can pipeline thousands of in-flight searches).
_ASYNC = object()

# metric-label allowlist (see _handle_client)
_KNOWN_METHODS = frozenset({
    "initialize", "notifications/initialized", "ping", "tools/list",
    "tools/call",
})


class MCPServer:
    def __init__(self, db: Database, host: str = "127.0.0.1", port: int = 8080):
        self.db = db
        self.host = host
        self.port = port
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._clients: Set[socket.socket] = set()
        self._lock = threading.Lock()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "MCPServer":
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self.host, self.port))
        sock.listen(64)
        self._sock = sock
        self._stop.clear()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="evdb-mcp-accept", daemon=True
        )
        self._accept_thread.start()
        logger.info("MCP server listening on %s:%d", self.host, self.port)
        return self

    def stop(self) -> None:
        self._stop.set()
        # shutdown before close: closing a socket under a thread blocked in
        # accept() or recv() on it wakes nothing, and the kernel keeps the
        # port listening until that call returns
        with self._lock:
            socks = list(self._clients)
            self._clients.clear()
        if self._sock is not None:
            socks.append(self._sock)
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2)
            self._accept_thread = None

    def is_alive(self) -> bool:
        return self._sock is not None and not self._stop.is_set()

    # -------------------------------------------------------------- accept

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return
            with self._lock:
                self._clients.add(conn)
            threading.Thread(
                target=self._handle_client, args=(conn, addr), daemon=True
            ).start()

    def _handle_client(self, conn: socket.socket, addr) -> None:
        decoder = json.JSONDecoder()
        buf = ""
        # incremental decoder: recv() can split a multi-byte UTF-8 sequence
        # across chunks — per-chunk .decode(errors="replace") would silently
        # corrupt the split character (U+FFFD inside valid JSON)
        import codecs

        utf8 = codecs.getincrementaldecoder("utf-8")("replace")
        send_lock = threading.Lock()

        def send(obj: dict) -> None:
            # thread-safe: async search callbacks send from the batcher's
            # completion thread while this thread keeps reading requests
            data = (json.dumps(obj) + "\n").encode()
            try:
                with send_lock:
                    conn.sendall(data)
            except OSError:
                pass

        try:
            while not self._stop.is_set():
                try:
                    chunk = conn.recv(65536)
                except OSError:
                    break
                if not chunk:
                    break
                buf += utf8.decode(chunk)
                if len(buf) > MAX_BUFFER_BYTES:
                    # a client streaming garbage without message boundaries
                    # must not grow the buffer unboundedly
                    self._send(conn, _error(None, PARSE_ERROR,
                                            "message too large"))
                    break
                while buf:
                    stripped = buf.lstrip()
                    if not stripped:
                        buf = ""
                        break
                    try:
                        obj, end = decoder.raw_decode(stripped)
                    except json.JSONDecodeError:
                        if "\n" in stripped:
                            # garbage line: report parse error, drop the line
                            self._send(conn, _error(None, PARSE_ERROR, "Parse error"))
                            buf = stripped.split("\n", 1)[1]
                            continue
                        buf = stripped  # incomplete: wait for more bytes
                        break
                    buf = stripped[end:]
                    method = obj.get("method", "?") if isinstance(obj, dict) else "?"
                    # fixed label set: the method string is client-supplied
                    # and runs pre-auth — unique strings would each allocate
                    # a histogram in the process-wide registry forever
                    label = (f"mcp.{method.replace('/', '_')}"
                             if method in _KNOWN_METHODS else "mcp.other")
                    with metrics.timed(label):
                        resp = self._process(obj, send)
                    if resp is _ASYNC:
                        continue  # response will be sent by a batcher callback
                    if resp is not None:
                        send(resp)
        finally:
            with self._lock:
                self._clients.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _send(conn: socket.socket, obj: dict) -> None:
        try:
            conn.sendall((json.dumps(obj) + "\n").encode())
        except OSError:
            pass

    # ------------------------------------------------------------- requests

    def _auth_scopes(self, req: dict) -> Optional[Set[str]]:
        """Bearer token from the reference's top-level "auth" field (or
        params.auth); None means rejected."""
        token = None
        auth = req.get("auth")
        if isinstance(auth, dict):
            token = auth.get("token") or auth.get("access_token")
        elif isinstance(auth, str):
            token = auth[7:] if auth.lower().startswith("bearer ") else auth
        if token is None:
            params = req.get("params") or {}
            pauth = params.get("auth")
            if isinstance(pauth, dict):
                token = pauth.get("token") or pauth.get("access_token")
            elif isinstance(pauth, str):
                token = pauth
        if not self.db.oauth.enabled:
            return {"read", "write", "admin"}
        if token is None:
            return None
        info = self.db.oauth.validate_token(token)
        return None if info is None else info["scopes"]

    def _process(self, req: dict, send=None) -> Optional[dict]:
        if not isinstance(req, dict) or req.get("jsonrpc") != "2.0":
            return _error(None, INVALID_REQUEST, "Invalid Request")
        req_id = req.get("id")
        method = req.get("method")
        params = req.get("params") or {}

        if method == "notifications/initialized":
            return None  # notification: no response
        if method == "ping":
            return _result(req_id, {})

        if method == "initialize":
            return _result(req_id, {
                "protocolVersion": PROTOCOL_VERSION,
                "capabilities": {
                    "tools": {"listChanged": False},
                    "authentication": {"type": "oauth2.1"} if self.db.oauth.enabled else {},
                },
                "serverInfo": {"name": SERVER_NAME, "version": SERVER_VERSION},
            })

        # everything below requires auth (reference :157-188)
        scopes = self._auth_scopes(req)
        if scopes is None:
            return _error(req_id, AUTH_ERROR, "Authentication required")

        if method == "tools/list":
            return _result(req_id, {"tools": tools_mod.list_tools(scopes)})

        if method == "tools/call":
            name = params.get("name")
            args = params.get("arguments") or {}
            if not name:
                return _error(req_id, INVALID_PARAMS, "Missing tool name")
            if name not in tools_mod.TOOLS:
                return _error(req_id, METHOD_NOT_FOUND, f"Unknown tool: {name}")
            if not tools_mod.check_permission(name, scopes):
                return _error(
                    req_id, PERMISSION_ERROR,
                    f"Insufficient scope for tool {name!r} "
                    f"(requires {tools_mod.tool_scope(name)})",
                )
            if (
                send is not None
                and name in ("search_vectors", "search_vectors_batch")
                and args.get("nprobe") is None  # sub-linear path: direct
                and args.get("recall_target") is None
                and self.db.batcher.is_alive()
                and self._search_async(req_id, name, args, send)
            ):
                return _ASYNC
            try:
                out = tools_mod.call_tool(self.db, name, args)
            except (tools_mod.ToolError, KeyError, ValueError) as e:
                # ValueError covers domain errors (bad index type, dimension
                # mismatch, duplicate names) — caller errors, not crashes
                return _error(req_id, INVALID_PARAMS, str(e))
            except Exception as e:  # noqa: BLE001 — fault barrier per request
                logger.exception("tool %s failed", name)
                return _error(req_id, INTERNAL_ERROR, f"{type(e).__name__}: {e}")
            return _result(req_id, {
                "content": [{"type": "text", "text": json.dumps(out)}],
                "isError": False,
            })

        return _error(req_id, METHOD_NOT_FOUND, f"Method not found: {method}")

    def _search_async(self, req_id, name: str, args: dict, send) -> bool:
        """Pipeline a search through the batcher: the response is sent by the
        completion callback while this connection's reader thread moves on to
        the next request.  Returns False to fall back to the sync path (the
        sync path then reports any argument errors)."""

        def on_error(e: Exception):
            code = (INVALID_PARAMS
                    if isinstance(e, (tools_mod.ToolError, KeyError, ValueError))
                    else INTERNAL_ERROR)
            send(_error(req_id, code, str(e)))

        try:
            store = args["store"]
            k = int(args.get("k", 10))
            metric = args.get("metric")
            where = args.get("filter")
            if name == "search_vectors":
                q = tools_mod.decode_query(args)

                def cb(hits, err):
                    if err is not None:
                        on_error(err)
                    else:
                        send(_tool_result(req_id, tools_mod.format_hits(hits)))

                self.db.batcher.submit(store, q, k=k, metric=metric,
                                       where=where, callback=cb)
            else:
                qs = tools_mod.decode_queries(args)
                if args.get("encoding") == "b64":
                    fmt, raw = tools_mod.format_batch_b64, True
                elif args.get("compact"):
                    fmt, raw = tools_mod.format_batch_columns, True
                else:
                    fmt, raw = tools_mod.format_batch, False

                def cb2(results, err):
                    if err is not None:
                        on_error(err)
                    else:
                        send(_tool_result(req_id, fmt(results)))

                self.db.batcher.submit_group(store, qs, k=k, metric=metric,
                                             where=where, callback=cb2,
                                             raw=raw)
            return True
        except (tools_mod.ToolError, KeyError, ValueError) as e:
            send(_error(req_id, INVALID_PARAMS, str(e)))
            return True
        except Exception:  # noqa: BLE001 — unexpected: let the sync path report
            logger.exception("async search dispatch failed")
            return False
