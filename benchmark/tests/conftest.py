"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
repository's root. Tests marked `card` need an NVIDIA card and skip without
one (decided in the `card` fixture, never at import); on the card run them
with `python -m pytest benchmark/tests -q -m card`."""

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
TOY = Path(__file__).resolve().parent / "toy_slam"
TOY_CELL = "toy_slam.revisit"
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the check runs at the cell's own size there")
    return torch.device("cuda", 0)


def tiny(cell):
    """The cell at a size the CPU runs in seconds and the engines still
    track at: a world of 400,000 points, scans of 16,384 raw points filtered
    to 2,048, four sampled checks."""
    cfg = copy.deepcopy(cell.config)
    cfg["world"]["points"] = 400000
    cfg["sensor"]["raw_points"] = 16384
    cfg["engine_options"]["scan_capacity"] = 2048
    cfg["checks"] = 4
    return cell._replace(config=cfg)


def toy_checkout(root: Path) -> dict:
    """A checkout at `root` of the benchmark as it is, with the test engine
    of `toy_slam/` added by new files and manifest entries only: its
    configuration, a mix that renders the lap twice, the engine, its
    reference and its faults. Returns the benchmark's files as they were
    before the additions, by path."""
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    for src, dst in (("engine.py", "engines/toy_slam.py"),
                     ("reference.py", "references/toy_slam.py"),
                     ("faults.py", "faults/toy_slam.py"),
                     ("toy_slam.json", "configs/toy_slam.json"),
                     ("revisit.json", "traffic/revisit.json")):
        path = root / "benchmark" / dst
        assert not path.exists(), f"{dst} is already there"
        path.parent.mkdir(exist_ok=True)
        shutil.copy(TOY / src, path)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "toy_slam", "source": "x", "reduced": [], "why": "x",
                                "file": "benchmark/configs/toy_slam.json"})
    manifest["workloads"].append({"name": TOY_CELL, "config": "toy_slam", "traffic": "revisit",
                                  "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return before
