"""The check has to refuse what is wrong: the reference computed in TF32 in
the program's place (the control), and the program with its timed path
broken underneath in each way its cell can break (`yardstick.faults` for
every engine: a step that returns its state unchanged, half of the scan
left out, a pose altered where it is produced, the filter's velocity left
out of the update; and `faults/<engine>.py` where the engine has its own).
Every cell of the manifest, and every fault of its engine. On the CPU at a
small size; the card-marked test reads the control at the cell's own
size."""

import json

import pytest
from conftest import BENCH, tiny

import run as runmod
from yardstick import cell as cellmod, faults, replay

CELLS = [w["name"] for w in json.loads((BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]
CELL_FAULTS = [pytest.param(name, fault, id=f"{name}-{fault}") for name in CELLS
               for fault in sorted(faults.for_engine(cellmod.load_cell(name).config["engine"]))]


def _line(cell, fault=None, seed=41):
    res = replay.run_cell(cell, seed, 2.0, False, "cpu", 0.0, fault=fault)
    return runmod.result_line(cell, res, "cpu", 1)


@pytest.mark.parametrize(("name", "fault"), CELL_FAULTS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    cell = tiny(cellmod.load_cell(name))
    line = _line(cell, faults.for_engine(cell.config["engine"])[fault])
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_unbroken_program_is_correct_at_this_size(name):
    line = _line(tiny(cellmod.load_cell(name)))
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_in_tf32_is_not_correct(name):
    import calibrate

    cell = tiny(cellmod.load_cell(name))
    r = calibrate.readings(cell, 43, 2.0, "cpu")
    limits = cell.config["limits"]
    over = [k for k, v in r["control"].items() if v > limits[k]]
    assert over, r["control"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_at_the_cells_own_size_is_not_correct(name, card):
    import calibrate

    cell = cellmod.load_cell(name)
    limits = cell.config["limits"]
    for seed in (101, 102, 103):
        r = calibrate.readings(cell, seed, 3.0, card)
        assert any(v > limits[k] for k, v in r["control"].items()), r
        assert all(v <= limits[k] for k, v in r["program"].items()), r
