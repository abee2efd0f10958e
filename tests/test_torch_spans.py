"""The program's spans and counters (`utils.timing`): one counter store
shared with the kernels' launch counts, spans that nest and add their host
nanoseconds and calls, a profiler range only while a profiler records, and
the spans of a LIO and a Loc scan: `step`, `predict`, `match`, `update`,
`record` once each, `map_build` on a keyframe or a re-crop, and `sync` at
each blocking read of the card.

The tests marked `card` count the host's syncs of LIO and Loc scans at a
64-beam LiDAR's density on an NVIDIA card and skip without one. Run them on
the card with `python -m pytest --noconftest tests/test_torch_spans.py -m
card -q` (this file imports no jax; `tests/conftest.py` does)."""

import collections
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from loc_lib_tpu_torch.io import logdir, synthetic
from loc_lib_tpu_torch.models import icp
from loc_lib_tpu_torch.ops import kernels
from loc_lib_tpu_torch.pipeline import lio, loc
from loc_lib_tpu_torch.utils import timing

torch.set_num_threads(2)

ENGINE_SPANS = ("step", "predict", "match", "update", "record")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the syncs are counted at a 64-beam LiDAR's density")
    return torch.device("cuda", 0)


def _calls(before: dict) -> dict:
    """Calls of each span since `before` (a copy of the counters)."""
    return {k[:-len(".calls")]: v - before.get(k, 0) for k, v in timing.COUNTERS.items()
            if k.endswith(".calls") and v != before.get(k, 0)}


def test_spans_nest_and_add_their_nanoseconds_and_calls():
    before = dict(timing.COUNTERS)
    for _ in range(3):
        with timing.span("t_outer"):
            with timing.span("t_inner"):
                sum(range(1000))
            with timing.span("t_inner"):
                pass
    assert _calls(before) == {"t_outer": 3, "t_inner": 6}
    outer = timing.COUNTERS["t_outer.ns"] - before.get("t_outer.ns", 0)
    inner = timing.COUNTERS["t_inner.ns"] - before.get("t_inner.ns", 0)
    assert 0 < inner <= outer
    # a span that raises still counts, and the exception goes on
    with pytest.raises(ValueError):
        with timing.span("t_outer"):
            raise ValueError("x")
    assert timing.COUNTERS["t_outer.calls"] - before.get("t_outer.calls", 0) == 4


def test_the_launch_counts_are_the_counter_store():
    assert kernels.LAUNCHES is timing.COUNTERS
    assert set(kernels.KERNELS) <= set(kernels.LAUNCHES)
    with timing.span("t_kept"):
        pass
    kernels.reset_launch_counts()
    assert all(kernels.LAUNCHES[k] == 0 for k in kernels.KERNELS)
    assert timing.COUNTERS["t_kept.calls"] >= 1        # a reset leaves the spans' totals


def test_no_profiler_range_is_entered_unless_a_profiler_records(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, args=None):
        entered.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with timing.span("t_quiet"):
        pass
    timing.host_bool(torch.tensor(True))
    assert entered == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("t_loud", 7):
            with timing.span("t_nested"):
                torch.ones(4).sum()
    assert entered == [("t_loud", "7"), ("t_nested", None)]
    names = [e.name for e in prof.events()]
    assert "t_loud" in names and "t_nested" in names
    loud = next(e for e in prof.events() if e.name == "t_loud")
    nested = next(e for e in prof.events() if e.name == "t_nested")
    assert loud.time_range.start <= nested.time_range.start <= nested.time_range.end \
        <= loud.time_range.end


def test_the_stage_timer_reports_the_programs_spans_since_it_was_made():
    with timing.span("t_before"):
        pass
    st = timing.StageTimer()
    for _ in range(2):
        with st.stage("t_stage", block_on=torch.ones(2)):
            with timing.span("t_program"):
                pass
    rep = st.report()
    assert set(rep) == {"t_stage", "t_program"} and st.counts == {"t_stage": 2, "t_program": 2}
    assert rep["t_stage"] >= rep["t_program"] >= 0.0 and st.mean_ms("t_before") == 0.0


def _demo(frames, **kw):
    return logdir.make_demo_log(num_frames=frames, capacity=2048, world_points=20000,
                                extent=60.0, max_range=35.0, **kw)


def test_a_lio_scan_opens_each_span_once_and_syncs_at_its_reads():
    log = _demo(8)
    opts = lio.LioOptions(icp=icp.IcpOptions(method="p2plane_vox"), scan_capacity=1024,
                          kf_distance=0.3)
    eng = lio.Lio(opts, device="cpu")
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150], log.imu.acce[:150]):
        eng.init_imu(g, a, t)
    keyframes = 0
    for k, mg in enumerate(log.measures(imu_capacity=64)):
        raw = log.frame(mg.scan_index, "cpu")
        before = dict(timing.COUNTERS)
        scan = lio.preprocess_scan(opts, raw.xyz, raw.mask)
        out = eng.add_measure(scan, mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid)
        calls = _calls(before)
        keyframes += out.is_keyframe
        assert all(calls[s] == 1 for s in ENGINE_SPANS + ("filter",)), (k, calls)
        assert calls.get("map_build", 0) == int(out.is_keyframe), (k, calls)
        # the GN flag an iteration, the keyframe test (none on the first
        # scan: no keyframe yet) and the pose's pull; the IMU ring's wait
        # is the card's only
        assert calls["sync"] == out.iterations + (k > 0) + 1, (k, calls)
    assert 1 <= keyframes < len(eng.poses)


def _loc_run(log, box_size, emit=None):
    """Poses, re-crops and each scan's (span calls, box-edge flag, GN
    iterations) of a Loc run on the demo log's world; `emit`, when given,
    replaces `Loc._emit`."""
    world = synthetic.make_world(num_points=20000, extent=60.0, seed=0)
    eng = loc.Loc(world, loc.LocOptions(local_map_capacity=32768, box_size=box_size,
                                        recrop_margin=box_size / 2 - 1.0), device="cpu")
    if emit is not None:
        eng._emit = emit.__get__(eng)
    eng.set_init_pose(log.gt_poses[0][:3, :3], log.gt_poses[0][:3, 3])
    iters, match = [], icp.scan_match

    def counted(*args):
        res = match(*args)
        iters.append(res.iterations)
        return res

    per_scan = []
    loc.icp.scan_match = counted
    try:
        for mg in log.measures(imu_capacity=64):
            before = dict(timing.COUNTERS)
            out = eng.update_measure(log.frame(mg.scan_index, "cpu"), mg.imu_gyro, mg.imu_acce,
                                     mg.imu_stamp, mg.imu_valid)
            per_scan.append((_calls(before), bool(out.need_recrop), iters[-1]))
    finally:
        loc.icp.scan_match = match
    return np.stack(eng.poses), eng.num_recrops, per_scan


def _emit_inside_the_record(self, out):
    """The re-crop where it was before it left `_record`: inside the pull's
    span, right after the health update."""
    vals = torch.cat([out.R.reshape(9), out.t.reshape(3),
                      torch.stack([out.need_recrop.to(torch.float32),
                                   out.converged.to(torch.float32),
                                   out.num_effective.to(torch.float32),
                                   out.chi2.to(torch.float32)])]).cpu().numpy()
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = vals[:9].reshape(3, 3)
    T[:3, 3] = vals[9:12]
    self.poses.append(T)
    self.health.update(bool(vals[13]), int(vals[14]), float(vals[15]))
    if vals[12] > 0.5:
        self._recrop()
        self.num_recrops += 1


def test_a_loc_scan_opens_each_span_once_and_recrops_after_the_record():
    log = _demo(12, yaw_rate=0.0)
    poses, recrops, per_scan = _loc_run(log, 40.0)
    assert recrops >= 2
    for k, (calls, edge, iterations) in enumerate(per_scan):
        assert all(calls[s] == 1 for s in ENGINE_SPANS), (k, calls)
        assert calls.get("map_build", 0) == int(edge), (k, calls)
        # the GN flag an iteration and the pose's pull
        assert calls["sync"] == iterations + 1, (k, calls)
    # the moved re-crop: the same poses and re-crops as the re-crop inside the record
    old_poses, old_recrops, _ = _loc_run(log, 40.0, _emit_inside_the_record)
    assert recrops == old_recrops
    np.testing.assert_array_equal(poses, old_poses)


def test_the_loc_map_build_range_follows_the_record_range():
    from torch.profiler import ProfilerActivity, profile

    log = _demo(12, yaw_rate=0.0)
    world = synthetic.make_world(num_points=20000, extent=60.0, seed=0)
    eng = loc.Loc(world, loc.LocOptions(local_map_capacity=32768, box_size=40.0,
                                        recrop_margin=19.0), device="cpu")
    eng.set_init_pose(log.gt_poses[0][:3, :3], log.gt_poses[0][:3, 3])
    mgs = list(log.measures(imu_capacity=64))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for mg in mgs:
            eng.update_measure(log.frame(mg.scan_index, "cpu"), mg.imu_gyro, mg.imu_acce,
                               mg.imu_stamp, mg.imu_valid)
    ranges = collections.defaultdict(list)
    for e in prof.events():
        if e.name in ("step", "record", "map_build", "sync"):
            ranges[e.name].append((e.time_range.start, e.time_range.end))
    assert len(ranges["step"]) == len(mgs) and len(ranges["record"]) == len(mgs)
    assert 1 <= len(ranges["map_build"]) == eng.num_recrops
    for s, e in ranges["map_build"]:
        assert any(a <= s and e <= b for a, b in ranges["step"])
        assert not any(a < e and s < b for a, b in ranges["record"])


def _program_site(stack) -> str:
    """The innermost frame of the program that is not `utils/timing.py`."""
    for fr in reversed(stack):
        path = Path(fr.filename)
        if "loc_lib_tpu_torch" in path.parts and path.name != "timing.py":
            return f"{path.parent.name}/{path.name}:{fr.lineno} {fr.name}"
    return "outside the program"


def _syncs(scans) -> tuple:
    """Over `scans()`: the host syncs `torch.cuda.set_sync_debug_mode("warn")`
    reports, as {(program site, counted: the innermost program frame is a
    timing helper): warnings}, the program's `sync` calls, and the IMU
    packets read in place through the ring (one event wait each, which that
    mode cannot see)."""
    import traceback

    seen = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            stack = traceback.extract_stack()[:-1]
            ours = [f for f in stack if "loc_lib_tpu_torch" in Path(f.filename).parts]
            counted = bool(ours) and Path(ours[-1].filename).name == "timing.py"
            seen[(_program_site(stack), counted)] += 1

    torch.cuda.synchronize()
    before = dict(timing.COUNTERS)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            scans()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    calls = timing.COUNTERS.get("sync.calls", 0) - before.get("sync.calls", 0)
    waits = timing.COUNTERS["eskf_predict_scan"] - before["eskf_predict_scan"]
    return dict(seen), calls, waits


def _hdl64_log(frames):
    """A 64-beam LiDAR's density: 131,072 raw points a scan in a 240,000-point
    world, 0.2 m a scan, the demo log's IMU."""
    return logdir.make_demo_log(num_frames=frames, capacity=131072, world_points=240000,
                                yaw_rate=0.0)


@pytest.mark.card
@pytest.mark.parametrize("engine", ["lio", "loc"])
def test_every_host_sync_of_a_scan_at_the_cells_size_is_counted(card, engine):
    """`sync.calls` over 12 scans (filter and engine step) equals the syncs
    set_sync_debug_mode reports plus the IMU ring's event waits, and each
    reported sync comes through a timing helper. LIO: keyframes every ~3rd
    scan; Loc: a 102 m box, re-cropped every ~5 scans."""
    log = _hdl64_log(16)
    mgs = list(log.measures(imu_capacity=64))
    raws = [log.frame(mg.scan_index, card) for mg in mgs]
    if engine == "lio":
        opts = lio.LioOptions(icp=icp.IcpOptions(method="p2plane_vox"))
        eng = lio.Lio(opts, device=card)
        for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150], log.imu.acce[:150]):
            eng.init_imu(g, a, t)
        feed = eng.add_measure
    else:
        opts = loc.LocOptions(box_size=102.0)
        world = synthetic.make_world(num_points=240000, extent=80.0, seed=0)
        eng = loc.Loc(world, opts, device=card)
        eng.set_init_pose(log.gt_poses[0][:3, :3], log.gt_poses[0][:3, 3])
        feed = eng.update_measure

    def scan(k):
        mg = mgs[k]
        feed(lio.preprocess_scan(opts, raws[k].xyz, raws[k].mask), mg.imu_gyro, mg.imu_acce,
             mg.imu_stamp, mg.imu_valid)

    for k in range(4):
        scan(k)
    rebuilt = len(getattr(eng, "kf_poses", ())) + getattr(eng, "num_recrops", 0)
    seen, calls, waits = _syncs(lambda: [scan(k) for k in range(4, len(mgs))])
    rebuilt = len(getattr(eng, "kf_poses", ())) + getattr(eng, "num_recrops", 0) - rebuilt
    print(f"{engine}: {len(mgs) - 4} scans, {rebuilt} target rebuilds; sync calls {calls}, "
          f"ring waits {waits}; reported: {seen}")
    assert rebuilt >= 2 and waits == len(mgs) - 4
    assert all(counted for _, counted in seen), seen
    assert calls == sum(seen.values()) + waits
