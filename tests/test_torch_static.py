"""Static checks on the port package: it must run where jax is absent, so no
module under loc_lib_tpu_torch/ (nor chip_smoke.py, nor chip_kernel_study.py)
may import jax or the JAX package, and every module must import with torch
alone. The modules of every slice are covered, 3D SLAM's graph/ included, and
none sums floats with a scatter-add (CUDA adds those with atomics, so one
input could give different bits on different runs)."""
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


def test_every_slice_is_covered():
    """The checks above walk the whole package; the modules of the 3D SLAM
    slice are among them."""
    paths = {str(p.relative_to(PKG)) for p in _sources() if PKG in p.parents}
    for mod in ("graph/pose_graph.py", "graph/scan_context.py", "pipeline/slam3d.py",
                "pipeline/lio.py", "models/eskf.py", "utils/lie.py"):
        assert mod in paths, mod


SCATTER_ADDS = ("index_add", "index_add_", "scatter_add", "scatter_add_")


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(REPO)))
def test_no_scatter_add_sums(path):
    """Node and voxel sums go through voxel.segment_sum over sorted rows."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
           and n.attr in SCATTER_ADDS]
    assert not bad, f"{path.relative_to(REPO)} calls {bad}"


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
