"""OAuth HTTP frontend — token / revoke / client_info endpoints.

Capability parity with the reference's oauth_http_handler
(src/oauth_http_handler.erl): ``POST /oauth/token`` with grant_type
client_credentials | refresh_token (:96-103, :138-178), ``POST
/oauth/revoke`` (:105-119), ``GET /oauth/client_info`` (:121-130), client
auth via Basic header or form fields (:180-200).

Bug NOT reproduced: the reference's hand-rolled form parser percent-decodes
but does not treat ``+`` as space (:202-215 — "Bug #1" in its
INTEGRATION_TEST_RESULTS.md); we use a correct urlencoded parser.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs

from erlvectordb_tpu_torch.serve.oauth import OAuthError, OAuthServer

logger = logging.getLogger("evdb.oauth_http")


class OAuthHTTPServer:
    def __init__(self, oauth: OAuthServer, host: str = "127.0.0.1", port: int = 8081):
        self.oauth = oauth
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "OAuthHTTPServer":
        oauth = self.oauth

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route through logging
                logger.debug("%s - " + fmt, self.address_string(), *args)

            def _reply(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def _form(self) -> dict:
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length).decode() if length else ""
                return {k: v[0] for k, v in parse_qs(raw).items()}

            def _basic_creds(self):
                auth = self.headers.get("Authorization", "")
                if auth.startswith("Basic "):
                    try:
                        dec = base64.b64decode(auth[6:]).decode()
                        cid, _, secret = dec.partition(":")
                        return cid, secret
                    except Exception:
                        return None
                return None

            def _bearer(self):
                auth = self.headers.get("Authorization", "")
                if auth.startswith("Bearer "):
                    return auth[7:]
                return None

            # ---------------------------------------------------------- POST

            def do_POST(self):
                if self.path == "/oauth/token":
                    return self._token()
                if self.path == "/oauth/revoke":
                    return self._revoke()
                self._reply(404, {"error": "not_found"})

            def _token(self):
                form = self._form()
                grant = form.get("grant_type")
                try:
                    if grant == "client_credentials":
                        creds = self._basic_creds() or (
                            form.get("client_id"), form.get("client_secret")
                        )
                        cid, secret = creds
                        if not cid or not secret:
                            raise OAuthError("invalid_client", "missing credentials")
                        scopes = form.get("scope", "").split() or None
                        tok = oauth.grant_client_credentials(cid, secret, scopes)
                        return self._reply(200, tok)
                    if grant == "refresh_token":
                        refresh = form.get("refresh_token")
                        if not refresh:
                            raise OAuthError("invalid_request", "missing refresh_token")
                        return self._reply(200, oauth.refresh_token(refresh))
                    raise OAuthError(
                        "unsupported_grant_type",
                        f"grant_type {grant!r} not supported",
                    )
                except OAuthError as e:
                    code = 401 if e.error in ("invalid_client", "invalid_grant") else 400
                    return self._reply(code, {
                        "error": e.error, "error_description": e.description,
                    })

            def _revoke(self):
                form = self._form()
                token = form.get("token") or self._bearer()
                if not token:
                    return self._reply(400, {"error": "invalid_request",
                                             "error_description": "missing token"})
                oauth.revoke_token(token)  # RFC 7009: 200 even if unknown
                return self._reply(200, {"revoked": True})

            # ----------------------------------------------------------- GET

            def do_GET(self):
                if self.path.startswith("/oauth/client_info"):
                    token = self._bearer()
                    if token is None:
                        return self._reply(401, {"error": "invalid_token"})
                    info = oauth.validate_token(token)
                    if info is None:
                        return self._reply(401, {"error": "invalid_token"})
                    client = oauth.client_info(info["client_id"]) or {
                        "client_id": info["client_id"]
                    }
                    client["scopes"] = sorted(info["scopes"])
                    return self._reply(200, client)
                self._reply(404, {"error": "not_found"})

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="evdb-oauth-http", daemon=True
        )
        self._thread.start()
        logger.info("OAuth HTTP on %s:%d", self.host, self.port)
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
