"""The unedited example clients (examples/mcp_client.py, examples/
ai_demo_client.py) against the port's Application on the CPU, held to the
JAX package's tests/test_examples.py case for case.  The examples import the
JAX package's client; each flow runs with it and again with the port's
VectorDBClient in its place."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from erlvectordb_tpu.serve import client as jax_client  # noqa: E402
from erlvectordb_tpu_torch.app import Application  # noqa: E402
from erlvectordb_tpu_torch.infra.config import load_config  # noqa: E402
from erlvectordb_tpu_torch.serve import client as torch_client  # noqa: E402
from examples.ai_demo_client import DEMO_DOCS, HashingEmbedder, SmartClient  # noqa: E402

BASE = 26800
CLIENTS = {"jax_client": jax_client, "torch_client": torch_client}


@pytest.fixture(scope="module")
def app(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")
    cfg = load_config(overrides={
        "services": {
            "mcp_server": {"preferred_port": BASE, "range": (BASE, BASE + 9)},
            "oauth_server": {"preferred_port": BASE + 10, "range": (BASE + 10, BASE + 19)},
            "rest_api": {"preferred_port": BASE + 20, "range": (BASE + 20, BASE + 29)},
            "health_check": {"preferred_port": BASE + 30, "range": (BASE + 30, BASE + 39)},
            # a range of its own, not the default 8083-8099 the JAX package's
            # test files share
            "grpc_server": {"preferred_port": BASE + 40, "range": (BASE + 40, BASE + 49)},
        },
        "persistence_dir": str(tmp / "data"),
        "backup_dir": str(tmp / "backups"),
        "sync_interval": 9999,
        "rest_api_enabled": False,
    }, env={})
    application = Application(cfg, device="cpu").start()
    yield application
    application.stop()


def test_hashing_embedder_properties():
    e = HashingEmbedder(dim=64)
    v1 = e.embed("tensor processing units multiply matrices")
    v2 = e.embed("tensor processing units multiply matrices")
    assert v1 == v2  # deterministic
    assert len(v1) == 64
    assert abs(sum(x * x for x in v1) - 1.0) < 1e-6  # unit norm
    # related text is closer than unrelated text
    sim_related = sum(a * b for a, b in zip(
        v1, e.embed("units that multiply matrices: tensor processors")))
    sim_unrelated = sum(a * b for a, b in zip(
        v1, e.embed("baking sourdough requires patient fermentation")))
    assert sim_related > sim_unrelated


@pytest.mark.parametrize("client_mod", sorted(CLIENTS))
def test_mcp_client_example_end_to_end(app, monkeypatch, capsys, client_mod):
    """The standalone example script passes every step against the port's
    server and exits 0, with either package's client library."""
    from examples import mcp_client as example

    mod = CLIENTS[client_mod]
    monkeypatch.setattr(example, "VectorDBClient", mod.VectorDBClient)
    monkeypatch.setattr(example, "ClientError", mod.ClientError)
    monkeypatch.setattr(sys, "argv", [
        "mcp_client.py",
        "--port", str(app.service_port("mcp_server")),
        "--oauth-url",
        f"http://127.0.0.1:{app.service_port('oauth_server')}/oauth/token",
        "--count", "40", "--searches", "3", "--dim", "16",
        "--store", f"mcp_example_{client_mod}",
    ])
    assert example.main() == 0
    out = capsys.readouterr().out
    assert "all steps passed." in out
    assert "self-hit check: 3/3" in out


@pytest.mark.parametrize("client_mod", sorted(CLIENTS))
def test_smart_insert_and_search(app, client_mod):
    client = CLIENTS[client_mod].VectorDBClient(
        mcp_port=app.service_port("mcp_server"),
        oauth_url=f"http://127.0.0.1:{app.service_port('oauth_server')}/oauth/token",
    )
    smart = SmartClient(client, store=f"demo_docs_{client_mod}")
    try:
        smart.ensure_store()
        for doc_id, text in DEMO_DOCS.items():
            smart.smart_insert(doc_id, text)
        hits = smart.smart_search("how do TPUs multiply matrices fast?", k=2)
        assert hits[0]["id"] == "doc_tpu"
        assert "explanation" in hits[0]
        hits = smart.smart_search("compressing embeddings into codes", k=2)
        assert hits[0]["id"] == "doc_pq"
    finally:
        client.close()
