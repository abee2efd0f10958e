"""The hooks that let an engine with a back end join by new files: its
events re-done by the reference, every correction it applied followed by
the reference, and the front end's own GN count. The test engine of
`toy_slam/` (the LIO engine with a registration, a solve and a correction
every fifth scan) is installed in a temporary copy of the benchmark; its
unbroken run reads correct, and each of its back end's faults does not."""

import copy
import importlib.util
import time

import numpy as np
import pytest
import torch
from conftest import TOY, TOY_CELL, toy_checkout

import run as runmod
from yardstick import cell as cellmod, faults, reference as ref, replay, stepcheck

SEED = 41


def _toy_faults() -> list:
    spec = importlib.util.spec_from_file_location("_toy_faults", TOY / "faults.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return sorted(mod.FAULTS)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    toy_checkout(root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cellmod, "BENCH_DIR", root / "benchmark")
        yield cellmod.load_cell(TOY_CELL, root / "BENCHMARK.json")


@pytest.fixture(scope="module")
def unbroken(toy):
    seen = {}

    def after(run, refmod):
        seen.update(run=run, refmod=refmod,
                    control=stepcheck.compare(run, refmod, "cpu", tf32=True),
                    without=stepcheck.compare(run._replace(corrections=stepcheck.Corrections()),
                                              refmod, "cpu"))
    res = replay.run_cell(toy, SEED, 3.0, False, "cpu", 0.0, after_check=after)
    return runmod.result_line(toy, res, "cpu", 1), seen


def test_the_unbroken_back_end_is_correct(toy, unbroken):
    line, seen = unbroken
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == set(toy.config["limits"])
    run = seen["run"]
    assert len(run.corrections) >= 4
    assert {e["kind"] for e in run.events} == {"registration", "solve", "correction"}
    assert all(e["scan"] in run.window and e["scan"] in run.sample for e in run.events)
    # the engine hands its events over as device tensors; the check reads them on the host
    assert not any(isinstance(v, torch.Tensor) for e in run.events for v in e.values())


def test_the_back_ends_records_count_in_the_scans_latency(toy):
    def slow_events(engine):
        events = engine.events

        def slow():
            time.sleep(0.05)
            return events()
        engine.events = slow
    res = replay.run_cell(toy, SEED, 1.0, False, "cpu", 0.0, fault=slow_events)
    assert res["attempted"] > 0 and res["latencies_ms"].min() >= 50.0


def test_the_check_follows_every_correction(toy, unbroken):
    _, seen = unbroken
    limits = toy.config["limits"]
    # the same run judged as if the back end had corrected nothing
    assert any(v > limits[k] for k, v in seen["without"].items()), seen["without"]


def test_the_control_reads_the_back_end_numbers_too(toy, unbroken):
    _, seen = unbroken
    limits, control = toy.config["limits"], seen["control"]
    backend = set(limits) - set(stepcheck.NUMBERS)
    assert backend <= set(control)
    assert any(control[k] > limits[k] for k in backend), control


def test_a_back_end_number_without_a_limit_is_an_error(unbroken):
    _, seen = unbroken
    run = seen["run"]
    cfg = copy.deepcopy(run.cfg)
    del cfg["limits"]["solve_gap_m"]
    with pytest.raises(KeyError, match="solve_gap_m"):
        stepcheck.compare(run._replace(cfg=cfg), seen["refmod"], "cpu")


@pytest.mark.parametrize("fault", _toy_faults())
def test_a_broken_back_end_is_not_correct(toy, fault):
    planted = faults.for_engine(toy.config["engine"])
    assert set(faults.FAULTS) < set(planted)
    res = replay.run_cell(toy, SEED, 3.0, False, "cpu", 0.0, fault=planted[fault])
    line = runmod.result_line(toy, res, "cpu", 1)
    assert not line["correct"], line["checks"]


def test_an_engines_fault_may_not_take_a_shared_name(toy, monkeypatch):
    mod = cellmod.load_module("faults", toy.config["engine"])
    monkeypatch.setitem(mod.FAULTS, "half_scan", faults.half_scan)
    with pytest.raises(ValueError, match="half_scan"):
        faults.for_engine(toy.config["engine"])
    assert set(faults.for_engine("lio")) == set(faults.FAULTS)


def test_the_event_sampler_draws_from_the_seed_and_holds_the_slowest_scans_events():
    def draw(seed):
        s = stepcheck.EventSampler(3, seed)
        for i in range(60):
            events = [{"kind": "a"}, {"kind": "b"}] if i % 2 else []
            s.offer_events(i, 99.0 if i == 17 else 1.0 + i % 5, events)
        return [(e["kind"], e["scan"]) for e in s.chosen()]
    a = draw(2 ** 31 + 5)
    assert a == draw(2 ** 31 + 5) and a != draw(6)
    assert {("a", 17), ("b", 17)} <= set(a) and len(a) <= 5
    assert a == sorted(a, key=lambda e: e[1])


def test_corrections_handed_over_on_the_device_are_read_after_the_window():
    c = stepcheck.Corrections()
    c.append(2, torch.eye(3), torch.tensor([0.5, 0.0, 0.0]))
    assert len(c) == 1 and c._new
    assert np.array_equal(c.between(0, 3)[:3, 3], [0.5, 0.0, 0.0]) and not c._new
    assert c.scan.tolist() == [2]


def test_corrections_compose_in_the_order_they_came():
    c = stepcheck.Corrections()
    Rz = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    c.append(3, Rz, [1.0, 0.0, 0.0])
    c.append(5, np.eye(3), [0.0, 2.0, 0.0])
    C1, C2 = c.T
    assert np.array_equal(c.between(3, 6), C2 @ C1)
    assert np.array_equal(c.between(4, 5), np.eye(4)) and np.array_equal(c.between(0, 3), np.eye(4))
    assert np.array_equal(c.between(5, 9), C2) and np.array_equal(c.between(0, 4), C1)


def test_a_corrected_filter_state_is_taken_back_exactly():
    g = torch.Generator().manual_seed(4)
    r = lambda *shape: torch.randn(shape, generator=g, dtype=torch.float64)
    s = ref.Eskf(r(3), r(3), ref.so3_exp(r(3)), r(3), r(3), r(3), r(18, 18), r(1)[0])
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = ref.so3_exp(r(3)).numpy(), r(3).numpy()
    dR, dt = torch.from_numpy(T[:3, :3]), torch.from_numpy(T[:3, 3])
    moved = s._replace(R=dR @ s.R, p=dR @ s.p + dt, v=dR @ s.v)    # as Lio.apply_correction
    back = stepcheck.uncorrected(moved, T)
    for f in ("R", "p", "v"):
        assert torch.allclose(getattr(back, f), getattr(s, f), rtol=0, atol=1e-12)
    for f in ("bg", "ba", "g", "cov", "time"):
        assert getattr(back, f) is getattr(s, f)
