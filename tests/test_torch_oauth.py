"""tests/test_oauth.py re-pointed at the port: the OAuth server
(erlvectordb_tpu_torch/serve/oauth.py) — register/dup-register,
authenticate failures, token gen/validate/expire, refresh rotation and
old-token invalidation, request-auth acceptance/rejection — and the tool
scope matrix of erlvectordb_tpu_torch/serve/tools.py."""

import pytest

from erlvectordb_tpu_torch.serve.oauth import OAuthError, OAuthServer
from erlvectordb_tpu_torch.serve import tools as tools_mod


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock():
    return FakeClock()


@pytest.fixture
def oauth(clock):
    srv = OAuthServer(clock=clock)
    srv.register_client("cid", "secret", ["read", "write", "admin"])
    return srv


class TestClients:
    def test_register_and_info(self, oauth):
        info = oauth.client_info("cid")
        assert info["client_id"] == "cid"
        assert info["scopes"] == ["admin", "read", "write"]

    def test_duplicate_register_rejected(self, oauth):
        with pytest.raises(OAuthError) as e:
            oauth.register_client("cid", "x")
        assert e.value.error == "invalid_client"

    def test_wrong_secret(self, oauth):
        with pytest.raises(OAuthError):
            oauth.authenticate_client("cid", "wrong")

    def test_unknown_client(self, oauth):
        with pytest.raises(OAuthError):
            oauth.authenticate_client("ghost", "secret")

    def test_invalid_scope_registration(self, oauth):
        with pytest.raises(OAuthError) as e:
            oauth.register_client("c2", "s", ["read", "superuser"])
        assert e.value.error == "invalid_scope"


class TestTokens:
    def test_grant_and_validate(self, oauth):
        tok = oauth.grant_client_credentials("cid", "secret")
        assert tok["token_type"] == "Bearer"
        assert tok["expires_in"] == 3600
        info = oauth.validate_token(tok["access_token"])
        assert info["client_id"] == "cid"
        assert info["scopes"] == {"read", "write", "admin"}

    def test_scope_narrowing(self, oauth):
        tok = oauth.grant_client_credentials("cid", "secret", ["read"])
        info = oauth.validate_token(tok["access_token"])
        assert info["scopes"] == {"read"}

    def test_scope_escalation_rejected(self, oauth):
        oauth.register_client("ro", "s", ["read"])
        with pytest.raises(OAuthError) as e:
            oauth.grant_client_credentials("ro", "s", ["admin"])
        assert e.value.error == "invalid_scope"

    def test_expiry(self, oauth, clock):
        tok = oauth.grant_client_credentials("cid", "secret")
        clock.t += 3601
        assert oauth.validate_token(tok["access_token"]) is None

    def test_unknown_token(self, oauth):
        assert oauth.validate_token("bogus") is None

    def test_revoke(self, oauth):
        tok = oauth.grant_client_credentials("cid", "secret")
        assert oauth.revoke_token(tok["access_token"])
        assert oauth.validate_token(tok["access_token"]) is None
        assert not oauth.revoke_token(tok["access_token"])


class TestRefresh:
    def test_rotation_invalidates_old(self, oauth):
        tok = oauth.grant_client_credentials("cid", "secret")
        new = oauth.refresh_token(tok["refresh_token"])
        assert new["access_token"] != tok["access_token"]
        # old refresh token is dead (rotation, reference :112-136)
        with pytest.raises(OAuthError):
            oauth.refresh_token(tok["refresh_token"])
        # old access token is dead too
        assert oauth.validate_token(tok["access_token"]) is None
        assert oauth.validate_token(new["access_token"]) is not None

    def test_refresh_expiry(self, oauth, clock):
        tok = oauth.grant_client_credentials("cid", "secret")
        clock.t += 86401
        with pytest.raises(OAuthError):
            oauth.refresh_token(tok["refresh_token"])


class TestDisabledMode:
    def test_disabled_grants_all_scopes(self):
        srv = OAuthServer(enabled=False)
        info = srv.validate_token("anything")
        assert info["scopes"] == {"read", "write", "admin"}


class TestToolScopeMatrix:
    def test_matrix(self):
        assert tools_mod.tool_scope("search_vectors") == "read"
        assert tools_mod.tool_scope("insert_vector") == "write"
        assert tools_mod.tool_scope("create_store") == "write"
        assert tools_mod.tool_scope("backup_store") == "admin"
        assert tools_mod.tool_scope("restore_store") == "admin"
        assert tools_mod.tool_scope("list_backups") == "admin"

    def test_list_tools_filtered(self):
        read_only = tools_mod.list_tools({"read"})
        names = {t["name"] for t in read_only}
        assert "search_vectors" in names
        assert "insert_vector" not in names
        assert "backup_store" not in names
        # internal keys are stripped
        assert all(not any(k.startswith("x-") for k in t) for t in read_only)

    def test_check_permission(self):
        assert tools_mod.check_permission("search_vectors", {"read"})
        assert not tools_mod.check_permission("insert_vector", {"read"})
        assert not tools_mod.check_permission("nonexistent", {"admin"})
