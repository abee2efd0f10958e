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
import math
import pathlib
import subprocess
import sys
import types

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
    ("utils/timing.py", "trace"): "no call site, and without a log_dir it entered a "
                                  "record_function on every call; the program's spans "
                                  "(timing.span) open a profiler range only while a "
                                  "profiler records",
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


# trailing optional parameters the port may add to a JAX signature: where
# tensors go (device), the batch-independent 3x3 product (matmul), and the
# distributed layer's hooks (reduce, group, match, tile)
SIGNATURE_EXTRAS = ("device", "matmul", "reduce", "group", "match", "tile")
# public functions whose parameters deliberately differ from the JAX
# package's, each with its reason
SIGNATURE_EXCEPTIONS = {
    ("apps/mapping.py", "run_mapping"): "no use_orbax: the port checkpoints to npz only (README "
                                        "'Deliberate differences'), so mp_shards moves up one",
    ("io/checkpoint.py", "Checkpointer.__init__"): "no use_orbax, as run_mapping",
    ("parallel/multihost.py", "init"): "torch.distributed's init_method / world_size / rank / "
                                       "device / backend in place of jax.distributed's "
                                       "coordinator, process count and local devices",
    ("parallel/multihost.py", "host_local_to_global"): "no PartitionSpec: a rank's tensor is "
                                                       "its shard of a torch.distributed mesh",
    ("graph/pose_graph.py", "block_matvec"): "axis_name -> group (a torch.distributed group); "
                                             "seg, the edge segments computed once per solve",
    ("graph/pose_graph.py", "solve_pcg"): "as block_matvec",
    ("models/ndt.py", "scan_match"): "n_points, the source count over all ranks that the "
                                     "sharded direct mode gates on, beside reduce",
    ("ops/pallas_kernels.py", "p2plane_fused_terms"): "no interpret: Pallas's interpreter is "
                                                      "the TPU's; CPU tensors take the plain "
                                                      "version",
    ("ops/pallas_kernels.py", "p2plane_pick_fused_terms"): "as p2plane_fused_terms",
    ("ops/pallas_kernels.py", "ndt_fused_terms"): "as p2plane_fused_terms",
    ("ops/voxel.py", "knn"): "stencil None is voxel.nearby27 on the queries' device (see "
                             "NOT_PORTED's NEARBY27)",
    ("ops/voxel.py", "nn1"): "as knn",
}
REQUIRED = type("Required", (), {"__repr__": lambda self: "<required>"})()
# what a default means, whichever package wrote it
_DEFAULT_NAMES = {"pi": math.pi, "inf": math.inf, "float32": "float32"}
_DEFAULT_SCOPE = {m: types.SimpleNamespace(**_DEFAULT_NAMES) for m in ("jnp", "np", "torch")}
_DEFAULT_SCOPE["math"] = math


def _default(node):
    """A default's value where it is a constant expression of numbers, pi,
    inf and float32 (in any package's spelling), else its source."""
    if node is None:
        return REQUIRED
    try:
        return eval(compile(ast.Expression(node), "<default>", "eval"),
                    {"__builtins__": {}}, dict(_DEFAULT_SCOPE))
    except Exception:
        return ast.unparse(node)


def _params(fn):
    """[(name, kind, default)] of a FunctionDef; kind "pos" or "kw"."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + a.defaults
    out = [(p.arg, "pos", _default(d)) for p, d in zip(pos, defaults)]
    out += [("*" + a.vararg.arg, "var", REQUIRED)] if a.vararg else []
    out += [(p.arg, "kw", _default(d)) for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    out += [("**" + a.kwarg.arg, "var", REQUIRED)] if a.kwarg else []
    return out


def _functions(path) -> dict:
    """Public top-level functions and the public methods (and __init__) of
    public classes: {qualified name: FunctionDef}."""
    out = {}
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, ast.FunctionDef) and not n.name.startswith("_"):
            out[n.name] = n
        elif isinstance(n, ast.ClassDef) and not n.name.startswith("_"):
            out.update({f"{n.name}.{m.name}": m for m in n.body
                        if isinstance(m, ast.FunctionDef)
                        and (m.name == "__init__" or not m.name.startswith("_"))})
    return out


def _signature_gap(jax_fn, port_fn):
    """Why the port's parameters do not take the JAX function's calls, or
    None: JAX's parameters must come first in the port, in the same order,
    of the same kind, with the same defaults; the port may add trailing
    SIGNATURE_EXTRAS that have a default."""
    want, got = _params(jax_fn), _params(port_fn)
    if got[:len(want)] != want:
        return f"JAX {want} against the port's {got}"
    extra = [p for p in got[len(want):] if p[0] not in SIGNATURE_EXTRAS or p[2] is REQUIRED]
    return f"extra parameters {extra}" if extra else None


@pytest.mark.parametrize("rel", _jax_modules())
def test_public_signatures_take_the_jax_calls(rel):
    """Every public function and method of a JAX module has, in its
    counterpart, JAX's parameters in JAX's order with JAX's defaults, so
    a call written for the JAX package runs on the port; but for
    SIGNATURE_EXCEPTIONS, each with its reason."""
    port = PKG / COUNTERPART.get(rel, rel)
    theirs, ours = _functions(JAX_PKG / rel), _functions(port)
    gaps = {name: _signature_gap(fn, ours[name]) for name, fn in theirs.items()
            if name in ours and (rel, name) not in SIGNATURE_EXCEPTIONS}
    gaps = {k: v for k, v in gaps.items() if v}
    assert not gaps, f"{rel}: {gaps}"


def test_signature_exceptions_are_current():
    """Every SIGNATURE_EXCEPTIONS entry names a function of both packages
    whose parameters still differ, with a reason; the check catches a
    required device, a renamed keyword and a keyword-only argument."""
    for (rel, name), reason in SIGNATURE_EXCEPTIONS.items():
        theirs = _functions(JAX_PKG / rel)[name]
        ours = _functions(PKG / COUNTERPART.get(rel, rel))[name]
        assert reason and _signature_gap(theirs, ours), (rel, name)
    fn = lambda src: ast.parse(src).body[0]
    ref = fn("def f(opts, R_il=None, pipelined=False, dim=-2, r=jnp.pi / 180.0): pass")
    for src, ok in (("def f(opts, R_il=None, pipelined=False, dim=-2, r=math.pi / 180.0, "
                     "*, device=None): pass", True),
                    ("def f(opts, R_il=None, pipelined=False, dim=-2, r=math.pi / 180.0, "
                     "*, device): pass", False),
                    ("def f(opts, R_il=None, *, pipelined=False, dim=-2, r=math.pi / 180.0)"
                     ": pass", False),
                    ("def f(opts, R_il=None, pipelined=False, axis=-2, r=math.pi / 180.0)"
                     ": pass", False),
                    ("def f(opts, R_il=None, pipelined=False, dim=-2, r=0.0): pass", False),
                    ("def f(opts, R_il=None, pipelined=False, dim=-2, r=math.pi / 180.0, "
                     "Q=None): pass", False)):
        assert (_signature_gap(ref, fn(src)) is None) == ok, src


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
