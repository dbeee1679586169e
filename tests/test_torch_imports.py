"""The port stands alone: nothing under ``src/repro_torch/``, not
``chip_smoke.py``, not the port's card scripts under ``scripts/`` and not
its examples (``examples/torch_*.py``) imports JAX or the reference
package, and importing the
port builds no kernel (kernels build at their first CUDA launch)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("*.py")) + \
    sorted((ROOT / "examples").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_sees_the_forms_it_forbids(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.models import lm\n"
                 "import importlib\nm = importlib.import_module('jaxlib')\n"
                 "from . import repro_torch_sibling\nimport repro_torch\n")
    assert [m for _, m in _imported_roots(f) if m in FORBIDDEN] == [
        "jax", "repro", "jaxlib"]


def test_importing_the_port_builds_nothing_and_loads_no_jax(tmp_path):
    """Every module of the port imports in a fresh interpreter with no
    ``nvcc`` on PATH, without pulling in JAX and without creating the
    kernel build directory."""
    code = (
        "import pkgutil, sys, repro_torch\n"
        "from repro_torch.kernels import _build\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'repro' not in sys.modules, 'repro was imported'\n"
        "assert not _build._libs\n"
        "print(_build.BUILD_ROOT.exists())\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PATH=str(tmp_path))  # an empty PATH: no nvcc to find
    existed = (ROOT / "build" / "repro_torch").exists()
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(existed)
