"""The port's CLI (python -m erlvectordb_tpu_torch.cli), held to the JAX
package's tests/test_cli.py case for case.

Dev CLI tests (dev_cli.erl analogue: status / kill-existing / help)."""

import json

import pytest

from erlvectordb_tpu_torch import cli


def test_status_outputs_json(capsys, monkeypatch):
    monkeypatch.setenv("EVDB_DEV_MODE", "1")
    # reload config through the CLI path
    assert cli.main(["status"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["development_mode"] is True
    assert out["services"]["mcp_server"]["preferred_port"] == 9080
    assert out["services"]["mcp_server"]["port_state"] in ("free", "occupied")


def test_help(capsys):
    assert cli.main(["help"]) == 0
    text = capsys.readouterr().out
    assert "EVDB_DEV_MODE" in text
    assert "stdio bridge" in text


def test_no_command_prints_help(capsys):
    assert cli.main([]) == 0
    assert "EVDB_CONFIG_FILE" in capsys.readouterr().out


def test_kill_existing_requires_dev_mode(capsys, monkeypatch):
    monkeypatch.delenv("EVDB_DEV_MODE", raising=False)
    monkeypatch.delenv("NODE_ENV", raising=False)
    assert cli.main(["kill-existing"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert "dev mode" in out["error"]


def test_kill_existing_dev_mode(capsys, monkeypatch):
    monkeypatch.setenv("EVDB_DEV_MODE", "1")
    assert cli.main(["kill-existing"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert "occupied_ports" in out


def test_check_reports_down_when_no_server(capsys, monkeypatch):
    # point at a port range where nothing listens
    monkeypatch.setenv("EVDB_DEV_MODE", "1")
    monkeypatch.setenv("MCP_SERVER_PORT", "26990")
    monkeypatch.setenv("OAUTH_SERVER_PORT", "26991")
    monkeypatch.setenv("REST_API_PORT", "26992")
    monkeypatch.setenv("HEALTH_CHECK_PORT", "26993")
    assert cli.main(["check"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] is False
    assert out["checks"]["mcp_server"]["tcp"] == "down"
