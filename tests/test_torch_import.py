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
