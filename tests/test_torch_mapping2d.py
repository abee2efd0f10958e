"""Port parity: loc_lib_tpu_torch.pipeline.mapping2d (the host-driven 2D
submap SLAM) against the JAX package, and mapping2d_device (the device-
resident engine) against the port's host-driven one, on tests/
test_mapping2d.py's workloads at its small grid (500 x 500 at 10 px/m).

Stated tolerances:
  * Mapping2D against JAX, 12 frames (test_mapping2d.py:92's run): every
    pose within twice JAX's own change under a 1-ulp nudge of every scan
    point, floored at two float32 ulps; the same submap count;
  * Mapping2DDevice against the port's Mapping2D: test_mapping2d.py:301's
    0.02 m, the same submap count, valid loops within 1;
  * one step of the device engine from a state carried across from JAX:
    the pose within twice JAX's 1-ulp sensitivity;
  * pipelined against sequential: bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loc_lib_tpu.models import grid2d as jg
from loc_lib_tpu.pipeline import mapping2d as jm
from loc_lib_tpu.pipeline import mapping2d_device as jmd
from loc_lib_tpu_torch.io import convert, synthetic
from loc_lib_tpu_torch.models import grid2d
from loc_lib_tpu_torch.pipeline import mapping2d, mapping2d_device as m2dd

torch.set_num_threads(2)

GARGS = dict(image_size=500, resolution=10.0, ray_steps=128, max_beam_range=14.0)
GOPTS, JGOPTS = grid2d.Grid2dOptions(**GARGS), jg.Grid2dOptions(**GARGS)


def _line_scans(n=12):
    """test_mapping2d.py:92's run: a straight drive with a slow turn."""
    world = synthetic.make_world_2d(seed=2)
    out = []
    for i in range(n):
        t_gt = np.array([0.25 * i, 0.1 * i], np.float32)
        out.append(synthetic.render_scan_2d(world, 0.04 * i, t_gt, seed=i) + (t_gt,))
    return out


def _circle_scans(frames=32):
    """test_mapping2d.py:142's circle of radius 4 m in the 10 m world: it
    revisits its start, so loops close."""
    world = synthetic.make_world_2d(extent=10.0, seed=2)
    out = []
    for k in range(frames):
        a = 2.0 * np.pi * k / frames
        t = np.array([4 * np.cos(a) - 4, 4 * np.sin(a)], np.float32)
        out.append(synthetic.render_scan_2d(world, a, t, seed=k) + (t,))
    return out


LINE_OPTS = mapping2d.Mapping2dOptions(grid=GOPTS, keyframe_dist=0.2, max_keyframes_in_submap=6)
CIRCLE_OPTS = mapping2d.Mapping2dOptions(grid=GOPTS, max_keyframes_in_submap=6, seed_frames=5)


def _drive(eng, scans, flush=False):
    for xy, valid, _ in scans:
        eng.process_scan(xy, valid)
    if flush:
        eng.flush()
    return np.stack([np.r_[th, t] for th, t in eng.frame_poses])


@pytest.fixture(scope="module")
def circle_runs():
    """The 32-frame circle through the host engine, the device engine and
    the pipelined device engine (6 submaps, loops on every submap pair)."""
    scans = _circle_scans()
    runs = {}
    for name, eng in (("host", mapping2d.Mapping2D(CIRCLE_OPTS, device="cpu")),
                      ("device", m2dd.Mapping2DDevice(CIRCLE_OPTS, device="cpu")),
                      ("pipelined", m2dd.Mapping2DDevice(CIRCLE_OPTS, device="cpu",
                                                         pipelined=True))):
        runs[name] = (eng, _drive(eng, scans, flush=name == "pipelined"))
    return scans, runs


def test_mapping2d_matches_jax_pose_by_pose():
    scans = _line_scans()
    jopts = jm.Mapping2dOptions(grid=JGOPTS, keyframe_dist=0.2, max_keyframes_in_submap=6)
    ref_eng = jm.Mapping2D(jopts)
    ref = _drive(ref_eng, scans)
    nudged = _drive(jm.Mapping2D(jopts), [(np.nextafter(xy, np.float32(99)), v, t)
                                          for xy, v, t in scans])
    eng = mapping2d.Mapping2D(LINE_OPTS, device="cpu")
    got = _drive(eng, scans)
    gap = np.abs(got - ref).max(axis=0)
    self_gap = np.abs(nudged - ref).max(axis=0)
    floor = 2 * np.spacing(np.abs(ref).max(axis=0))
    assert np.all(gap <= 2 * np.maximum(self_gap, floor)), (gap, self_gap)
    assert len(eng.submaps) == len(ref_eng.submaps) == 2
    errs = np.linalg.norm(got[:, 1:] - np.stack([t for *_, t in scans]), axis=1)
    assert errs.max() < 0.25          # test_mapping2d.py:107's drift bound
    assert eng.frame_count == 12


def test_device_engine_tracks_host_engine_on_the_line():
    scans = _line_scans()
    host = _drive(mapping2d.Mapping2D(LINE_OPTS, device="cpu"), scans)
    dev = m2dd.Mapping2DDevice(LINE_OPTS, device="cpu")
    got = _drive(dev, scans)
    assert np.linalg.norm(got[:, 1:] - host[:, 1:], axis=1).max() < 0.02
    assert len(dev.submaps) == 2
    assert len(dev.global_occupancy()) == len(dev.submaps)


def test_device_engine_tracks_host_engine_through_loop_closures(circle_runs):
    """test_mapping2d.py:269 on the port: through expansions and loop
    closures (optimize() and its write-back into the device state)."""
    _, runs = circle_runs
    (host, ph), (dev, pd) = runs["host"], runs["device"]
    assert np.linalg.norm(ph[:, 1:] - pd[:, 1:], axis=1).max() < 0.02
    assert len(dev.submaps) == len(host.submaps) >= 4
    n_valid = lambda e: sum(1 for l in e.loops if l.valid)
    assert n_valid(dev) >= 1 and abs(n_valid(dev) - n_valid(host)) <= 1
    assert len(dev.global_occupancy()) == len(dev.submaps)


def test_pipelined_equals_sequential_bit_for_bit(circle_runs):
    """test_mapping2d.py:412 on the port: lag-1 pipelining with replay on
    every expansion and loop write-back gives the sequential poses bit for
    bit; the run replays."""
    _, runs = circle_runs
    (seq, ps), (pip, pp) = runs["device"], runs["pipelined"]
    np.testing.assert_array_equal(pp, ps)
    assert len(pip.submaps) == len(seq.submaps)
    assert [l.valid for l in pip.loops] == [l.valid for l in seq.loops]
    assert pip.replays >= 1


def test_pipelined_returns_the_previous_pose_and_flush_the_last():
    scans = _line_scans(4)
    pip = m2dd.Mapping2DDevice(LINE_OPTS, device="cpu", pipelined=True)
    outs = [pip.process_scan(xy, v) for xy, v, _ in scans]
    assert outs[0] is None
    last = pip.flush()
    poses = [np.r_[th, t] for th, t in pip.frame_poses]
    for k in range(1, 4):
        np.testing.assert_array_equal(np.r_[outs[k][0], outs[k][1]], poses[k - 1])
    np.testing.assert_array_equal(np.r_[last[0], last[1]], poses[3])
    assert pip.flush()[0] == last[0]


def test_archived_grid_does_not_change_when_the_live_grid_does():
    """The archive holds the live tensors themselves (no copy): expansion
    and every later step build new state tensors, so the archived grid and
    field keep their bits while the live submap changes."""
    scans = _line_scans()
    eng = m2dd.Mapping2DDevice(LINE_OPTS, device="cpu")
    k = 0
    while len(eng.submaps) < 2:
        eng.process_scan(*scans[k][:2])
        k += 1
    arch = eng.submaps[0]
    assert arch.field is not eng.dstate.field
    saved = (arch.grid.counts.clone(), arch.grid.touched.clone(), arch.field.clone())
    live = eng.dstate.counts.clone()
    for xy, valid, _ in scans[k:]:
        eng.process_scan(xy, valid)
    assert not torch.equal(eng.dstate.counts, live)
    for a, b in zip((arch.grid.counts, arch.grid.touched, arch.field), saved):
        assert torch.equal(a, b)


def test_spilled_archives_go_back_to_the_engine_device_before_matching(monkeypatch,
                                                                       circle_runs):
    """archived_device_submaps = 1: older archives spill to host numpy; every
    field the multires matcher receives is a tensor on the engine's device,
    spilled archives are matched, and loops still close."""
    scans, _ = circle_runs
    seen = {"fields": [], "spilled_matches": 0}
    match, match_multires = mapping2d._match_multires, mapping2d.Submap.match_multires

    def spy_match(field, *args):
        seen["fields"].append((type(field), getattr(field, "device", None)))
        return match(field, *args)

    def spy_submap(self, *args):
        seen["spilled_matches"] += isinstance(self.field, np.ndarray)
        return match_multires(self, *args)

    monkeypatch.setattr(mapping2d, "_match_multires", spy_match)
    monkeypatch.setattr(mapping2d.Submap, "match_multires", spy_submap)
    eng = m2dd.Mapping2DDevice(dataclasses.replace(CIRCLE_OPTS, archived_device_submaps=1),
                               device="cpu")
    _drive(eng, scans)
    spilled = [s for s in eng.submaps[:-1] if isinstance(s.field, np.ndarray)]
    assert len(spilled) >= 2
    assert seen["fields"] and all(t is torch.Tensor and d == eng.device
                                  for t, d in seen["fields"])
    assert seen["spilled_matches"] >= 1
    assert sum(1 for l in eng.loops if l.valid) >= 1


def test_lm_fallback_accepts_a_good_init_and_rejects_junk():
    """test_mapping2d.py:388 on the port, default options (1000 x 1000)."""
    opts = mapping2d.Mapping2dOptions()
    assert opts.lm_fallback and opts.pgo.solver == "dense"
    eng = mapping2d.Mapping2D(opts, device="cpu")
    world = synthetic.make_world_2d(extent=10.0, seed=2)
    xy, valid = synthetic.render_scan_2d(world, 0.0, np.zeros(2, np.float32), seed=0)
    eng.process_scan(xy, valid)
    sm = eng.submaps[-1]
    _, ok = sm.match_multires(xy, valid, 0.02, np.array([0.05, 0.02]))
    assert ok
    junk = np.random.default_rng(0).uniform(-12, 12, xy.shape).astype(np.float32)
    _, ok2 = sm.match_multires(junk, valid, 0.0, np.zeros(2))
    assert not ok2


def test_device_step_from_a_state_carried_across_from_jax():
    """Six line frames through JAX's device engine, its state carried across
    (convert.mapping2d_device_state_from_numpy), then one step of each: the
    same keyframe decision and submap count, the pose within twice JAX's
    change under a 1-ulp nudge of the scan."""
    scans = _line_scans(7)
    jopts = jm.Mapping2dOptions(grid=JGOPTS, keyframe_dist=0.2, max_keyframes_in_submap=6)
    jeng = jmd.Mapping2DDevice(jopts, warm_start=False)
    for xy, valid, _ in scans[:6]:
        jeng.process_scan(xy, valid)
    state = convert.mapping2d_device_state_from_numpy(
        {k: np.asarray(v) for k, v in jeng.dstate._asdict().items()}, "cpu")
    np.testing.assert_array_equal(state.field.numpy(), np.asarray(jeng.dstate.field))
    xy, valid, _ = scans[6]
    js, jo = jmd.step_scan(jeng.dstate, jnp.asarray(xy), jnp.asarray(valid), jopts)
    _, jn = jmd.step_scan(jeng.dstate, jnp.asarray(np.nextafter(xy, np.float32(99))),
                          jnp.asarray(valid), jopts)
    st, out = m2dd.step_scan(state, torch.from_numpy(xy), torch.from_numpy(valid), LINE_OPTS)
    assert out.is_keyframe == bool(jo.is_keyframe) and out.num_frames == int(jo.num_frames)
    for name in ("theta", "t"):
        r = np.asarray(getattr(jo, name))
        floor = 2 * np.spacing(np.abs(r).max())
        bound = 2 * max(np.abs(np.asarray(getattr(jn, name)) - r).max(), floor)
        assert np.abs(getattr(out, name).numpy() - r).max() <= bound, name
    np.testing.assert_array_equal(st.counts.numpy() > 127, np.asarray(js.counts) > 127)
    assert st.recent_count == int(js.recent_count) and st.frame_count == int(js.frame_count)


def test_device_engine_takes_scans_narrower_than_its_ring_like_jax():
    """360-beam scans into a device engine built for 720 beams (the line
    run, 12 frames): each keyframe's scan goes to the front of its slot of
    the seed ring and the rest of the slot is kept, as JAX's
    dynamic_update_index_in_dim does. The poses stay within twice JAX's own
    change under a 1-ulp nudge of every scan point (floored at two float32
    ulps), the same submaps, and the ring equals JAX's."""
    world = synthetic.make_world_2d(seed=2)
    scans = []
    for i in range(12):
        t_gt = np.array([0.25 * i, 0.1 * i], np.float32)
        scans.append(synthetic.render_scan_2d(world, 0.04 * i, t_gt, max_points=360, seed=i)
                     + (t_gt,))
    assert scans[0][0].shape == (360, 2)
    jopts = jm.Mapping2dOptions(grid=JGOPTS, keyframe_dist=0.2, max_keyframes_in_submap=6)
    ref_eng = jmd.Mapping2DDevice(jopts, num_beams=720)
    ref = _drive(ref_eng, scans)
    nudged = _drive(jmd.Mapping2DDevice(jopts, num_beams=720),
                    [(np.nextafter(xy, np.float32(99)), v, t) for xy, v, t in scans])
    eng = m2dd.Mapping2DDevice(LINE_OPTS, num_beams=720, device="cpu")
    got = _drive(eng, scans)
    gap = np.abs(got - ref).max(axis=0)
    self_gap = np.abs(nudged - ref).max(axis=0)
    floor = 2 * np.spacing(np.abs(ref).max(axis=0))
    assert np.all(gap <= 2 * np.maximum(self_gap, floor)), (gap, self_gap)
    assert len(eng.submaps) == len(ref_eng.submaps) == 2
    for name in ("recent_xy", "recent_valid"):
        np.testing.assert_array_equal(getattr(eng.dstate, name).numpy(),
                                      np.asarray(getattr(ref_eng.dstate, name)), name)
    assert eng.dstate.recent_xy.shape[1] == 720 and bool(eng.dstate.recent_valid[:, :360].any())
