"""Static checks on the port package: it must run where jax is absent, so no
module under loc_lib_tpu_torch/ (nor chip_smoke.py, nor chip_kernel_study.py)
may import jax or the JAX package, and every module must import with torch alone."""
import ast
import importlib
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "loc_lib_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "loc_lib_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "chip_kernel_study.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_package_imports_without_jax():
    """Import every port module in a fresh interpreter where importing jax
    raises: nothing may pull it in indirectly."""
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import sys\n"
        "class _Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib'):\n"
        "            raise ImportError('jax is blocked')\n"
        "sys.meta_path.insert(0, _Block())\n"
        "for k in [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib')]:\n"
        "    del sys.modules[k]\n"
        f"import importlib\nfor m in {mods!r}: importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] == 'loc_lib_tpu' for k in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_refuses_to_run_without_cuda():
    """`python chip_smoke.py` on a machine without a card must fail and
    print no result line."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
