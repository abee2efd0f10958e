"""Static checks on the port package: it must run where jax is absent, so no
module under loc_lib_tpu_torch/ (nor chip_smoke.py, nor chip_kernel_study.py,
nor tests/test_torch_dist_workers.py, the rank functions the distributed
tests spawn) may import jax or the JAX package, and every module must import
with torch alone. Every module of the JAX package has its counterpart, with
every public name (the check that the port does everything the JAX package
does), and no port module sums floats with a scatter-add (CUDA adds those
with atomics, so one input could give different bits on different runs)."""
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


WORKERS = REPO / "tests" / "test_torch_dist_workers.py"


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "chip_kernel_study.py",
                                        WORKERS]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


JAX_PKG = REPO / "loc_lib_tpu"
# JAX module -> its counterpart, where the path differs
COUNTERPART = {"ops/pallas_kernels.py": "ops/kernels.py"}   # + the kernels in csrc/
# public names of the JAX package with no counterpart, each with its reason
NOT_PORTED = {
    ("ops/pallas_kernels.py", "on_tpu"): "a TPU probe: the kernels run on the card, or "
                                         "their plain versions on the CPU",
    ("ops/voxel.py", "NEARBY6"): "stencils are device-parametrised functions "
                                 "(voxel.nearby6 / center1 / nearby27), cached per device",
    ("ops/voxel.py", "CENTER1"): "as NEARBY6",
    ("ops/voxel.py", "NEARBY27"): "as NEARBY6",
}


def _defined(path) -> set:
    """Public names a module defines at top level (def, class, assignment)."""
    out = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out |= {t.id for t in n.targets if isinstance(t, ast.Name)}
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
    return {x for x in out if not x.startswith("_")}


def _bound(path) -> set:
    """Names a module binds at top level: its definitions and imports."""
    out = _defined(path)
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in n.names}
    return out


def _jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def test_every_slice_is_covered():
    """The port does everything the JAX package does: every module of it
    has a counterpart at the same path (ops/pallas_kernels.py: ops/kernels.py
    and the kernels in csrc/), so the checks above walk the modules of
    every slice."""
    missing = [rel for rel in _jax_modules() if not (PKG / COUNTERPART.get(rel, rel)).exists()]
    assert not missing, f"no counterpart in loc_lib_tpu_torch/ for {missing}"
    assert {p.name for p in (PKG / "csrc").glob("*.cu")} >= {
        "p2plane_fused_terms.cu", "p2plane_pick_fused_terms.cu", "ndt_fused_terms.cu"}
    paths = {str(p.relative_to(PKG)) for p in _sources() if PKG in p.parents}
    assert {COUNTERPART.get(rel, rel) for rel in _jax_modules()} <= paths


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_public_name_has_its_counterpart(rel):
    """Every public top-level name of a JAX module exists in its
    counterpart, but for NOT_PORTED's names, each with its reason."""
    port = PKG / COUNTERPART.get(rel, rel)
    missing = {n for n in _defined(JAX_PKG / rel) - _bound(port) if (rel, n) not in NOT_PORTED}
    assert not missing, f"{rel}: {sorted(missing)} missing from {port.relative_to(REPO)}"


def test_the_entry_points_and_the_exceptions_are_current():
    """__graft_entry__.py's analog is loc_lib_tpu_torch/entry.py; every
    NOT_PORTED entry still names a JAX name the port lacks."""
    assert {"entry", "dryrun_multichip"} <= _defined(PKG / "entry.py")
    for (rel, name), reason in NOT_PORTED.items():
        assert name in _defined(JAX_PKG / rel) and reason
        assert name not in _bound(PKG / COUNTERPART.get(rel, rel)), (rel, name)


SCATTER_ADDS = ("index_add", "index_add_", "scatter_add", "scatter_add_")
# these add (with atomics on CUDA) when called with accumulate=True
ACCUMULATING_PUTS = ("index_put", "index_put_", "put", "put_")


def _accumulating_put(node) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in ACCUMULATING_PUTS
            and any(kw.arg == "accumulate" and not (isinstance(kw.value, ast.Constant)
                                                    and kw.value.value is False)
                    for kw in node.keywords))


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [WORKERS],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_scatter_add_sums(path):
    """Node, voxel and dense-matrix sums go through voxel.segment_sum over
    sorted rows: no scatter-add, and no index_put / put with accumulate."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
           and n.attr in SCATTER_ADDS]
    bad += [n.func.attr + "(accumulate=...)" for n in ast.walk(tree) if _accumulating_put(n)]
    assert not bad, f"{path.relative_to(REPO)} calls {bad}"


def test_accumulating_puts_are_caught():
    """The check above sees the accumulating forms and passes the plain ones."""
    calls = {"H.index_put_((i, j), v, accumulate=True)": True,
             "torch.index_put(H, (i,), v, accumulate=flag)": True,
             "H.put_(idx, v, accumulate=True)": True,
             "H.index_put_((i, j), v)": False,
             "H.index_put_((i, j), v, accumulate=False)": False}
    for src, caught in calls.items():
        assert _accumulating_put(ast.parse(src).body[0].value) == caught, src


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
