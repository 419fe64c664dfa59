"""erlvectordb_tpu_torch imports torch and never jax: every module loads in a
fresh interpreter where importing jax fails."""

import pathlib
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "erlvectordb_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(PKG.parent).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def test_every_module_loads_with_jax_blocked():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None  # any 'import jax' now raises ImportError\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'erlvectordb_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "import erlvectordb_tpu_torch as p\n"
        "print(p.Database.__name__, p.VectorStore.__name__)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["Database", "VectorStore"]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: p.name)
def test_no_jax_import_in_source(path):
    for line in path.read_text().splitlines():
        words = line.split()
        if len(words) > 1 and words[0] in ("import", "from"):
            assert words[1].split(".")[0] not in ("jax", "erlvectordb_tpu"), line


def test_walk_covers_the_durability_modules():
    """The compression and persistence modules are among those loaded with
    jax blocked and scanned for jax imports above."""
    for name in ("quant.codecs", "quant.affine", "quant.pca",
                 "quant.compression", "persist", "persist.snapshot",
                 "persist.backup"):
        assert f"erlvectordb_tpu_torch.{name}" in MODULES, name


def test_walk_covers_the_serving_modules():
    """The frontends, the infrastructure, the app and the CLI are among
    those loaded with jax blocked and scanned for jax imports above."""
    for name in ("app", "cli", "infra", "infra.ports", "infra.startup",
                 "infra.signals", "infra.health", "serve.rest_server",
                 "serve.oauth_http", "serve.grpc_server", "serve.evdb_pb2",
                 "serve.client", "serve.stdio_bridge"):
        assert f"erlvectordb_tpu_torch.{name}" in MODULES, name


def test_app_and_cli_import_and_serve_without_grpc():
    """With neither grpcio nor protobuf importable, the app and the CLI
    import, and an Application starts without its gRPC frontend."""
    code = (
        "import sys\n"
        "sys.modules['grpc'] = None\n"
        "sys.modules['google.protobuf'] = None\n"
        "import erlvectordb_tpu_torch.cli\n"
        "from erlvectordb_tpu_torch.app import Application\n"
        "from erlvectordb_tpu_torch.infra.config import load_config\n"
        "from erlvectordb_tpu_torch.serve.grpc_server import GRPC_AVAILABLE\n"
        "assert not GRPC_AVAILABLE\n"
        "names = ('mcp_server', 'oauth_server', 'rest_api', 'grpc_server',\n"
        "         'health_check')\n"
        "services = {n: {'preferred_port': 27400 + 10 * i,\n"
        "                'range': (27400 + 10 * i, 27409 + 10 * i)}\n"
        "            for i, n in enumerate(names)}\n"
        "cfg = load_config(overrides={'services': services,\n"
        "                             'persistence_enabled': False}, env={})\n"
        "app = Application(cfg, device='cpu').start()\n"
        "try:\n"
        "    print(app.service_port('grpc_server'),\n"
        "          app.service_port('mcp_server') is not None)\n"
        "finally:\n"
        "    app.stop()\n"
        "assert not any(m.startswith(('grpc', 'google.protobuf'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["None", "True"]


def test_walk_covers_the_distribution_modules():
    """The mesh, the sharded and dim-sharded stores, the cluster manager,
    the EP indexes and the dry run are among the modules loaded with jax
    blocked and scanned for jax imports above."""
    for name in ("parallel", "parallel.mesh", "parallel.sharded_store",
                 "parallel.cluster", "parallel.dim_sharded", "parallel.ep_ivf",
                 "parallel.ep_cell_probe", "parallel.dryrun"):
        assert f"erlvectordb_tpu_torch.{name}" in MODULES, name
