"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
repository's root. Tests marked `card` need an NVIDIA card and skip without
one (decided in the `card` fixture, never at import); on the card run them
with `python -m pytest benchmark/tests -q -m card`."""

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
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
