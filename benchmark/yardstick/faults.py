"""Faults planted in the timed path, underneath the harness, to show that
the check refuses them: each takes the engine's wrapper (`engines/*.py`'s
`Engine`) before the window and breaks it in place. These hold for every
engine; an engine's own faults (of its back end, say) sit in
`faults/<engine>.py` as a dict `FAULTS` of the same kind, and `for_engine`
gives both. The cells run on one card, so there is no exchange between
cards to leave out."""

from __future__ import annotations

import torch

from . import cell as cellmod


def state_unchanged(engine):
    """The engine's step leaves its state as it was and reports the last pose again."""
    step = engine.step

    def broken(scan, packet):
        before = engine.eng.state
        out, rebuilt = step(scan, packet)
        engine.eng.state = before
        engine.eng.poses[-1] = engine.eng.poses[-2].copy()
        return out, rebuilt
    engine.step = broken


def half_scan(engine):
    """The filter hands over the scan with half its rows masked out (the
    match then takes the mean over the rest)."""
    filt = engine.filter

    def broken(xyz, mask):
        cloud = filt(xyz, mask)
        keep = torch.arange(cloud.mask.shape[0], device=cloud.mask.device) % 2 == 0
        return cloud._replace(mask=cloud.mask & keep)
    engine.filter = broken


def pose_altered(engine):
    """The reported pose is moved by 5 cm where the engine produces it."""
    step = engine.step

    def broken(scan, packet):
        out = step(scan, packet)
        engine.eng.poses[-1] = engine.eng.poses[-1].copy()
        engine.eng.poses[-1][0, 3] += 0.05
        return out
    engine.step = broken


def velocity_not_updated(engine):
    """The filter's pose update leaves the velocity as the propagation left
    it (the update's correction of v is dropped; the rest is injected)."""
    from loc_lib_tpu_torch.models import eskf

    step, observe = engine.step, eskf.observe_se3

    def held(s, *args, **kwargs):
        return observe(s, *args, **kwargs)._replace(v=s.v)

    def broken(scan, packet):
        eskf.observe_se3 = held
        try:
            return step(scan, packet)
        finally:
            eskf.observe_se3 = observe
    engine.step = broken


FAULTS = {f.__name__: f for f in (state_unchanged, half_scan, pose_altered, velocity_not_updated)}


def for_engine(engine: str) -> dict:
    """The faults a cell of `engine` has to refuse, by name: those above,
    and `FAULTS` of `faults/<engine>.py` where there is one."""
    own = {}
    if (cellmod.BENCH_DIR / "faults" / f"{engine}.py").is_file():
        own = cellmod.load_module("faults", engine).FAULTS
    clash = set(own) & set(FAULTS)
    if clash:
        raise ValueError(f"faults/{engine}.py names {sorted(clash)}, which yardstick/faults.py has")
    return {**FAULTS, **own}
