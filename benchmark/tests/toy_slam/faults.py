"""The test engine's own faults (installed as `faults/<engine>.py` beside
it): each breaks its back end in place before the window."""

from __future__ import annotations

import torch


def correction_recorded_wrong(engine):
    """The correction the solve gives is applied, but the event that hands
    it to the harness says it moved the front end 5 cm further along x."""
    events = engine.events

    def broken():
        out = []
        for e in events():
            if e["kind"] == "correction":
                e = {**e, "dt": e["dt"] + torch.tensor([0.05, 0.0, 0.0], device=e["dt"].device)}
            out.append(e)
        return out
    engine.events = broken


def solve_output_altered(engine):
    """The solve's pose is moved by 2 cm along y where it is produced (the
    correction follows it, applied and recorded alike)."""
    solve = engine.solve

    def broken(poses, weights):
        T = solve(poses, weights).clone()
        T[1, 3] += 0.02
        return T
    engine.solve = broken


def gn_count_over_the_call(engine):
    """The step's result counts the GN iterations of the whole call, the
    back end's registration included, as launch counts over the call would
    give them. Caught because the test engine's registration runs a fixed
    20 iterations, so the count leaves [1, max_iteration]: the check reads
    no linearization there. A count inside that range is not caught."""
    step = engine.step

    def broken(scan, packet):
        out, rebuilt = step(scan, packet)
        extra = sum(e["iterations"] for e in engine.events() if e["kind"] == "registration")
        return out._replace(iterations=out.iterations + extra), rebuilt
    engine.step = broken


FAULTS = {f.__name__: f for f in (correction_recorded_wrong, solve_output_altered,
                                  gn_count_over_the_call)}
