"""OAuth 2.1 core — client-credentials + rotating refresh tokens with scopes.

Capability parity with the reference's oauth_server (src/oauth_server.erl):
  * client registry with sha256-hashed secrets (:115-135, :344-348);
  * client-credentials grant with scope validation; 1 h access / 24 h
    refresh lifetimes, configurable (:150-201);
  * validate_token with lazy expiry (:203-216);
  * revocation (:218-225);
  * refresh rotation that invalidates the old refresh token (:227-289);
  * periodic expired-token sweep (:110-112, :313-326);
  * optional default admin client from config (:87-108).

Scopes: ``read`` (search/list), ``write`` (create/insert/sync),
``admin`` (backup/restore/cluster) — the tool<->scope matrix lives in
serve/tools.py.
"""

from __future__ import annotations

import hashlib
import secrets as pysecrets
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

VALID_SCOPES = ("read", "write", "admin")

DEFAULT_ACCESS_LIFETIME = 3600.0
DEFAULT_REFRESH_LIFETIME = 86400.0
SWEEP_INTERVAL = 300.0


class OAuthError(Exception):
    def __init__(self, error: str, description: str = ""):
        super().__init__(description or error)
        self.error = error
        self.description = description


def _hash_secret(secret: str) -> str:
    return hashlib.sha256(secret.encode()).hexdigest()


@dataclass
class Client:
    client_id: str
    secret_hash: str
    scopes: Set[str]
    created_at: float = field(default_factory=time.time)


@dataclass
class Token:
    token: str
    client_id: str
    scopes: Set[str]
    expires_at: float
    kind: str  # "access" | "refresh"
    refresh_of: Optional[str] = None  # access token this refresh belongs to


class OAuthServer:
    """In-process OAuth authority. Thread-safe."""

    def __init__(
        self,
        enabled: bool = True,
        access_lifetime: float = DEFAULT_ACCESS_LIFETIME,
        refresh_lifetime: float = DEFAULT_REFRESH_LIFETIME,
        default_client: Optional[tuple] = None,  # (id, secret, scopes)
        clock=time.time,
    ):
        self.enabled = enabled
        self.access_lifetime = access_lifetime
        self.refresh_lifetime = refresh_lifetime
        self._clock = clock
        self._clients: Dict[str, Client] = {}
        self._access: Dict[str, Token] = {}
        self._refresh: Dict[str, Token] = {}
        self._lock = threading.RLock()
        self._last_sweep = self._clock()
        if default_client:
            cid, secret, scopes = default_client
            if cid and secret:
                self.register_client(cid, secret, scopes)

    # ------------------------------------------------------------- clients

    def register_client(self, client_id: str, secret: str,
                        scopes: Optional[List[str]] = None) -> dict:
        scopes = list(scopes or VALID_SCOPES)
        bad = [s for s in scopes if s not in VALID_SCOPES]
        if bad:
            raise OAuthError("invalid_scope", f"unknown scopes {bad}")
        with self._lock:
            if client_id in self._clients:
                raise OAuthError("invalid_client", f"client {client_id!r} exists")
            self._clients[client_id] = Client(client_id, _hash_secret(secret), set(scopes))
            return {"client_id": client_id, "scopes": sorted(scopes)}

    def client_info(self, client_id: str) -> Optional[dict]:
        with self._lock:
            c = self._clients.get(client_id)
            if c is None:
                return None
            return {
                "client_id": c.client_id,
                "scopes": sorted(c.scopes),
                "created_at": c.created_at,
            }

    def authenticate_client(self, client_id: str, secret: str) -> Client:
        with self._lock:
            c = self._clients.get(client_id)
        if c is None or c.secret_hash != _hash_secret(secret):
            raise OAuthError("invalid_client", "unknown client or bad secret")
        return c

    # -------------------------------------------------------------- tokens

    def _maybe_sweep(self) -> None:
        now = self._clock()
        if now - self._last_sweep < SWEEP_INTERVAL:
            return
        self._last_sweep = now
        self._access = {t: tok for t, tok in self._access.items() if tok.expires_at > now}
        self._refresh = {t: tok for t, tok in self._refresh.items() if tok.expires_at > now}

    def grant_client_credentials(self, client_id: str, secret: str,
                                 scopes: Optional[List[str]] = None) -> dict:
        """The token grant (reference generate_access_token :150-201)."""
        client = self.authenticate_client(client_id, secret)
        req_scopes = set(scopes) if scopes else set(client.scopes)
        if not req_scopes <= client.scopes:
            raise OAuthError(
                "invalid_scope",
                f"client lacks scopes {sorted(req_scopes - client.scopes)}",
            )
        now = self._clock()
        access = pysecrets.token_urlsafe(32)
        refresh = pysecrets.token_urlsafe(32)
        with self._lock:
            self._maybe_sweep()
            self._access[access] = Token(access, client_id, req_scopes,
                                         now + self.access_lifetime, "access")
            self._refresh[refresh] = Token(refresh, client_id, req_scopes,
                                           now + self.refresh_lifetime, "refresh",
                                           refresh_of=access)
        return {
            "access_token": access,
            "token_type": "Bearer",
            "expires_in": int(self.access_lifetime),
            "refresh_token": refresh,
            "scope": " ".join(sorted(req_scopes)),
        }

    def validate_token(self, token: str) -> Optional[dict]:
        """Lazy-expiry validation (reference :203-216). None if invalid.
        When OAuth is disabled, every token is valid with all scopes
        (reference mcp_server.erl:201-218 behavior)."""
        if not self.enabled:
            return {"client_id": "anonymous", "scopes": set(VALID_SCOPES)}
        with self._lock:
            tok = self._access.get(token)
            if tok is None:
                return None
            if tok.expires_at <= self._clock():
                del self._access[token]
                return None
            return {"client_id": tok.client_id, "scopes": set(tok.scopes)}

    def refresh_token(self, refresh: str) -> dict:
        """Rotating refresh: old refresh AND its access token are
        invalidated (reference :227-289)."""
        with self._lock:
            tok = self._refresh.get(refresh)
            if tok is None or tok.expires_at <= self._clock():
                self._refresh.pop(refresh, None)
                raise OAuthError("invalid_grant", "unknown or expired refresh token")
            del self._refresh[refresh]
            if tok.refresh_of:
                self._access.pop(tok.refresh_of, None)
            client_id, scopes = tok.client_id, tok.scopes
        now = self._clock()
        access = pysecrets.token_urlsafe(32)
        new_refresh = pysecrets.token_urlsafe(32)
        with self._lock:
            self._access[access] = Token(access, client_id, scopes,
                                         now + self.access_lifetime, "access")
            self._refresh[new_refresh] = Token(new_refresh, client_id, scopes,
                                               now + self.refresh_lifetime, "refresh",
                                               refresh_of=access)
        return {
            "access_token": access,
            "token_type": "Bearer",
            "expires_in": int(self.access_lifetime),
            "refresh_token": new_refresh,
            "scope": " ".join(sorted(scopes)),
        }

    def revoke_token(self, token: str) -> bool:
        """Revoke an access or refresh token (reference :218-225)."""
        with self._lock:
            if token in self._access:
                del self._access[token]
                return True
            if token in self._refresh:
                del self._refresh[token]
                return True
        return False

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "clients": len(self._clients),
                "active_access_tokens": len(self._access),
                "active_refresh_tokens": len(self._refresh),
            }
