"""The check has to refuse what is wrong: the reference computed in TF32 in
the program's place (the control), and the program with its timed path
broken underneath in each way these cells can break (`yardstick.faults`: a
step that returns its state unchanged, half of the scan left out, a pose
altered where it is produced, the filter's velocity left out of the
update). On the CPU at a small size; the card-marked test reads the control
at the cell's own size."""

import pytest
from conftest import tiny

import run as runmod
from yardstick import cell as cellmod, faults, replay, stepcheck

CELLS = ["lio_hdl64.drive", "loc_hdl64.drive", "lio_hdl64.walk"]


def _line(cell, fault=None, seed=41):
    res = replay.run_cell(cell, seed, 2.0, False, "cpu", 0.0, fault=fault)
    return runmod.result_line(cell, res, "cpu", 1)


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    cell = tiny(cellmod.load_cell(name))
    line = _line(cell, faults.FAULTS[fault])
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
    over = [k for k in stepcheck.NUMBERS if r["control"][k] > limits[k]]
    assert over, r["control"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_at_the_cells_own_size_is_not_correct(name, card):
    import calibrate

    cell = cellmod.load_cell(name)
    limits = cell.config["limits"]
    for seed in (101, 102, 103):
        r = calibrate.readings(cell, seed, 3.0, card)
        assert any(r["control"][k] > limits[k] for k in stepcheck.NUMBERS), r
        assert all(v <= limits[k] for k, v in r["program"].items()), r
