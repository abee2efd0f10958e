"""Port parity for the apps (slice 10): the four CLI drivers, their engines'
card defaults, the option dataclasses of both packages, the entry points.

  * Each `run_*` gives the bits of driving the port's engine directly: the
    app adds no arithmetic.
  * The port's `run_mapping` and `run_mapping2d` against the JAX package's,
    at tests/test_tools.py:97-101's and tests/test_mapping2d.py:247-258's
    sizes; `run_matching` against JAX's too. Free-running float32 engines
    are held as test_torch_mapping2d.py holds them: the same frames,
    keyframes and submaps, each pose within twice the gap that a one-ulp
    nudge of the input makes in JAX's own run.
  * A checkpointed run resumed at frame k equals the uninterrupted run's
    tail bit for bit (JAX's app behaves the same way on the same log).
  * --mp-shards in a 2-rank gloo world: only rank 0 writes, the poses
    within tests/test_map_shard.py's 0.02 m of the single-device run.
  * `entry()` runs one LIO step; `dryrun_multichip(2, device="cpu")` runs.

Inputs are made from seeds with numpy; JAX runs on the CPU."""
import copy
import dataclasses
import importlib
import os
import pathlib
import pkgutil

import numpy as np
import pytest
import torch

import loc_lib_tpu
import loc_lib_tpu_torch
from loc_lib_tpu.apps import (mapping as jmapping_app, mapping2d as jmapping2d_app,
                              matching as jmatching_app)
from loc_lib_tpu.io import logdir as jlogdir, synthetic as jsynthetic
from loc_lib_tpu.models import grid2d as jgrid2d, icp as jicp
from loc_lib_tpu.pipeline import lio as jlio, loc as jloc, mapping2d as jmapping2d
from loc_lib_tpu_torch import entry
from loc_lib_tpu_torch.apps import mapping as mapping_app, mapping2d as mapping2d_app
from loc_lib_tpu_torch.apps import matching as matching_app, slam as slam_app
from loc_lib_tpu_torch.io import logdir, synthetic, trajectory
from loc_lib_tpu_torch.models import grid2d, icp
from loc_lib_tpu_torch.parallel import multihost
from loc_lib_tpu_torch.pipeline import (lio, lio_sharded, loc, loc_sharded, mapping2d,
                                        mapping2d_device, slam3d)
from loc_lib_tpu_torch.graph import scan_context as sc

torch.set_num_threads(2)
TESTS = pathlib.Path(__file__).resolve().parent
MAP_FRAMES, CAP = 6, 1024          # tests/test_tools.py:97-101


# ---------------------------------------------------------------------------
# Options and card defaults
# ---------------------------------------------------------------------------

def _option_classes(pkg) -> dict:
    out = {}
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if m.name.endswith(("pallas_kernels", "__main__")):
            continue
        mod = importlib.import_module(m.name)
        for name, c in vars(mod).items():
            if (isinstance(c, type) and dataclasses.is_dataclass(c)
                    and c.__module__ == mod.__name__ and name.endswith(("Options", "Option"))):
                out[(m.name.split(".", 1)[1], name)] = c
    return out


def _same_defaults(a, b, path):
    names = [f.name for f in dataclasses.fields(a)]
    assert sorted(names) == sorted(f.name for f in dataclasses.fields(b)), path
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        if dataclasses.is_dataclass(x):
            _same_defaults(x, y, f"{path}.{name}")
        else:
            assert x == y, (f"{path}.{name}", x, y)


def test_every_options_dataclass_matches_jax():
    """Every *Options dataclass of the JAX package has its counterpart at
    the same module path, with the same field names and defaults, nested
    options walked recursively (the fields nothing reads included:
    LocOptions.scan_filter_leaf / scan_capacity, LioOptions.imu_capacity,
    LoamOption.min_edge_pts / min_surf_pts, the GNSS / lidar noise of
    EskfOptions)."""
    ref, port = _option_classes(loc_lib_tpu), _option_classes(loc_lib_tpu_torch)
    assert len(ref) >= 15 and set(ref) <= set(port), sorted(set(ref) - set(port))
    for key, cls in ref.items():
        _same_defaults(cls(), port[key](), ".".join(key))


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", ["Lio", "Loc", "LioSharded", "LocSharded"])
def test_engines_default_to_the_card(monkeypatch, name):
    """Lio, Loc, LioSharded and LocSharded go to the card unless the caller
    names a device (through pointcloud.card_device, as Slam3d does);
    without a card they raise instead of using the CPU."""
    world = np.random.default_rng(0).uniform(-20, 20, (2000, 3)).astype(np.float32)
    make = {"Lio": lambda **kw: lio.Lio(lio.LioOptions(scan_capacity=256), **kw),
            "Loc": lambda **kw: loc.Loc(world, loc.LocOptions(local_map_capacity=4096), **kw),
            "LioSharded": lambda **kw: lio_sharded.LioSharded(None, lio.LioOptions(), **kw),
            "LocSharded": lambda **kw: loc_sharded.LocSharded(None, world, loc.LocOptions(),
                                                              **kw)}[name]
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    if name in ("Lio", "Loc"):
        assert make(device="cpu").state.R.device.type == "cpu"


def test_apps_fail_clearly_without_a_card(monkeypatch, tmp_path):
    """The CLIs have no device flag: they run on the card and, without
    one, stop with the card error (nothing falls back to the CPU)."""
    _no_card(monkeypatch)
    for main, argv in ((mapping_app.main, ["--demo", "--demo-frames", "2"]),
                       (matching_app.main, ["--demo", "--demo-frames", "2"]),
                       (slam_app.main, ["--demo", "--demo-frames", "2"]),
                       (mapping2d_app.main, ["--demo", "--demo-frames", "2"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv + ["--out", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="needs a torch.distributed process group"):
        mapping_app.sharded_mesh(2)


# ---------------------------------------------------------------------------
# The mapping app
# ---------------------------------------------------------------------------

def _map_opts(L, I):
    """tests/test_tools.py:97-101's options."""
    return L.LioOptions(matcher="icp",
                        icp=I.IcpOptions(method="p2plane", max_iteration=5, bucket_size=4),
                        scan_capacity=CAP, num_kfs_in_local_map=3, with_eskf=True)


@pytest.fixture(scope="module")
def map_log():
    return logdir.make_demo_log(num_frames=MAP_FRAMES, capacity=CAP)


class _Capture:
    """Records the engines an app builds (the class the app calls is
    replaced by a subclass for the test's duration)."""

    def __init__(self, monkeypatch, module, name):
        base = getattr(module, name)
        self.engines = []
        engines = self.engines

        class Spy(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                engines.append(self)

        monkeypatch.setattr(module, name, Spy)


def _drive_lio(log, opts):
    """The mapping app's loop written out against the engine."""
    eng = lio.Lio(opts, device="cpu")
    for mg in log.measures(imu_capacity=64):
        if not eng.imu_inited and not mapping_app.init_imu_gate(eng, log, mg.scan_stamp):
            continue
        eng.add_measure(log.frame(mg.scan_index, "cpu"), mg.imu_gyro, mg.imu_acce,
                        mg.imu_stamp, mg.imu_valid)
    return np.stack(eng.poses)


def test_run_mapping_is_its_engine(monkeypatch, tmp_path, map_log):
    """run_mapping's poses are those of driving Lio directly, bit for bit;
    every artifact is written and the report counts what the engine did."""
    cap = _Capture(monkeypatch, mapping_app.lio_mod, "Lio")
    out = tmp_path / "out"
    rep = mapping_app.run_mapping(map_log, _map_opts(lio, icp), str(out), device="cpu")
    want = _drive_lio(map_log, _map_opts(lio, icp))
    np.testing.assert_array_equal(np.stack(cap.engines[0].poses), want)
    assert rep["frames"] == MAP_FRAMES and rep["keyframes"] == len(cap.engines[0].kf_poses)
    for f in ("trajectory_kitti.txt", "trajectory_tum.txt", "global_map.npz",
              "map_topdown.png", "report.json", "key_frames/manifest.json"):
        assert (out / f).exists(), f
    assert (out / "map_topdown.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_allclose(trajectory.load_kitti(str(out / "trajectory_kitti.txt")), want,
                               rtol=1e-7, atol=1e-7)
    assert np.load(out / "global_map.npz")["xyz"].shape == (rep["map_points"], 3)


def _nudged(log):
    out = copy.copy(log)
    xyz = log.scan_xyz.copy()
    m = log.scan_mask.astype(bool)
    xyz[m] = np.nextafter(xyz[m], np.float32(np.inf))
    out.scan_xyz = xyz
    return out


def test_run_mapping_matches_jax(tmp_path, map_log):
    """The port's app against JAX's at tests/test_tools.py:97-101's sizes:
    the same frames and keyframes, every pose within twice the gap a
    one-ulp nudge of the scans makes in JAX's own run (measured: port 0.110
    m, nudge 0.110 m at the last frame; this short log's velocity cold
    start amplifies rounding), and both ATEs within 0.02 m."""
    jlog = jlogdir.make_demo_log(num_frames=MAP_FRAMES, capacity=CAP)
    reps, trajs = {}, {}
    for name, run, log, opts, kw in (
            ("jax", jmapping_app.run_mapping, jlog, _map_opts(jlio, jicp), {"use_orbax": False}),
            ("nudged", jmapping_app.run_mapping, _nudged(jlog), _map_opts(jlio, jicp),
             {"use_orbax": False}),
            ("port", mapping_app.run_mapping, map_log, _map_opts(lio, icp), {"device": "cpu"})):
        reps[name] = run(log, opts, str(tmp_path / name), **kw)
        trajs[name] = trajectory.load_kitti(str(tmp_path / name / "trajectory_kitti.txt"))
    assert reps["port"]["frames"] == reps["jax"]["frames"] == MAP_FRAMES
    assert reps["port"]["keyframes"] == reps["jax"]["keyframes"] >= 2
    gap = np.linalg.norm(trajs["port"][:, :3, 3] - trajs["jax"][:, :3, 3], axis=1)
    self_gap = np.linalg.norm(trajs["nudged"][:, :3, 3] - trajs["jax"][:, :3, 3], axis=1)
    assert np.all(gap <= 2 * np.maximum(self_gap, 1e-5)), (gap, self_gap)
    assert abs(reps["port"]["ate_rmse_m"] - reps["jax"]["ate_rmse_m"]) < 0.02


def test_resumed_mapping_equals_the_uninterrupted_tail(monkeypatch, tmp_path, map_log):
    """--ckpt-every 2, then --resume from the checkpoint of frame 3: the
    resumed run's poses (frames 4-5) are the uninterrupted run's bits; the
    keyframe store continues its manifest, as the JAX app's does."""
    cap = _Capture(monkeypatch, mapping_app.lio_mod, "Lio")
    out = tmp_path / "out"
    opts = _map_opts(lio, icp)
    full = mapping_app.run_mapping(map_log, opts, str(out), ckpt_every=2, device="cpu")
    assert sorted(os.listdir(out / "ckpt")) == [f"ckpt_0000000{k}.npz" for k in (1, 3, 5)]
    os.unlink(out / "ckpt" / "ckpt_00000005.npz")
    tail = mapping_app.run_mapping(map_log, opts, str(out), ckpt_every=2, resume=True,
                                   device="cpu")
    whole, resumed = np.stack(cap.engines[0].poses), np.stack(cap.engines[1].poses)
    assert tail["frames"] == 2 and len(resumed) == 2
    np.testing.assert_array_equal(resumed, whole[4:])
    assert tail["keyframes"] >= full["keyframes"]


# ---------------------------------------------------------------------------
# Matching, SLAM, 2D
# ---------------------------------------------------------------------------

def test_run_matching_is_its_engine_and_matches_jax(monkeypatch, tmp_path):
    """tests/test_tools.py:121-131's run (4 frames, a 60,000-point world,
    the initial pose from the ground truth): the poses of driving Loc
    directly, bit for bit; against JAX's app within 1e-5 m (measured
    1.8e-7 m), ATE within 1e-5 m. Without an initial pose a GNSS log seeds
    it from its first fix, the ENU origin: the identity."""
    log = logdir.make_demo_log(num_frames=4, capacity=CAP, with_imu=False)
    world = synthetic.make_world(num_points=60000, extent=80.0, seed=0)
    cap = _Capture(monkeypatch, matching_app.loc_mod, "Loc")
    rep = matching_app.run_matching(log, world, loc.LocOptions(scan_capacity=CAP),
                                    str(tmp_path / "port"), init_pose=log.gt_poses[0],
                                    device="cpu")
    eng = loc.Loc(world, loc.LocOptions(scan_capacity=CAP), device="cpu")
    eng.set_init_pose(log.gt_poses[0][:3, :3], log.gt_poses[0][:3, 3])
    for mg in log.measures(imu_capacity=64):
        eng.update_measure(log.frame(mg.scan_index, "cpu"), mg.imu_gyro, mg.imu_acce,
                           mg.imu_stamp, mg.imu_valid)
    np.testing.assert_array_equal(np.stack(cap.engines[0].poses), np.stack(eng.poses))
    jlog = jlogdir.make_demo_log(num_frames=4, capacity=CAP, with_imu=False)
    jrep = jmatching_app.run_matching(jlog, world, jloc.LocOptions(scan_capacity=CAP),
                                      str(tmp_path / "jax"), init_pose=jlog.gt_poses[0])
    assert rep["frames"] == jrep["frames"] == 4
    assert abs(rep["ate_rmse_m"] - jrep["ate_rmse_m"]) < 1e-5
    a, b = (trajectory.load_kitti(str(tmp_path / d / "trajectory_kitti.txt"))
            for d in ("port", "jax"))
    assert np.abs(a - b).max() < 1e-5
    g = copy.copy(log)
    from loc_lib_tpu_torch.io import replay
    g.gnss = replay.GnssLog(stamps=log.scan_stamps[:2],
                            lla=np.array([[31.2, 121.5, 10.0], [31.2001, 121.5, 10.0]]))
    matching_app.run_matching(g, world, loc.LocOptions(scan_capacity=CAP),
                              str(tmp_path / "gnss"), device="cpu")
    eng = loc.Loc(world, loc.LocOptions(scan_capacity=CAP), device="cpu")
    eng.set_init_pose(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    for mg in g.measures(imu_capacity=64):
        eng.update_measure(g.frame(mg.scan_index, "cpu"), mg.imu_gyro, mg.imu_acce,
                           mg.imu_stamp, mg.imu_valid)
    np.testing.assert_array_equal(np.stack(cap.engines[-1].poses), np.stack(eng.poses))


def _slam_opts():
    """test_torch_slam3d.py's small options."""
    return slam3d.Slam3dOptions(
        lio=lio.LioOptions(matcher="icp", icp=icp.IcpOptions(method="p2plane", max_iteration=8,
                                                             bucket_size=4),
                           scan_capacity=512, num_kfs_in_local_map=3, with_eskf=True,
                           kf_distance=0.4),
        sc=sc.ScanContextOptions(exclude_recent=8, dist_threshold=0.33),
        loop=slam3d.LoopOptions(min_keyframe_gap=8, max_candidate_dist=10.0,
                                min_effective_pts=60, max_chi2_per_pt=0.1, optimize_every=100,
                                sc_topk=3),
        loop_icp=icp.IcpOptions(method="p2plane_vox", max_iteration=20, max_plane_distance=0.5,
                                grid_leaf=2.0, bucket_size=8, plane_min_pts=4,
                                dense_dims=(64, 64, 32)))


def test_run_slam_is_its_engine(monkeypatch, tmp_path):
    """run_slam on test_torch_slam3d.py's closed circle (46 frames): the
    odometry and the optimized keyframes of driving Slam3d directly, bit
    for bit; loops found; every artifact written, scan_context.png from
    the last keyframe's descriptor."""
    log = logdir.make_demo_log(num_frames=46, capacity=512, dt=0.2, speed=1.4,
                               yaw_rate=0.72, world_points=40000, with_imu=True,
                               extent=16.0, max_range=14.0)
    cap = _Capture(monkeypatch, slam_app.slam3d, "Slam3d")
    out = tmp_path / "out"
    rep = slam_app.run_slam(log, _slam_opts(), str(out), device="cpu")
    eng = slam3d.Slam3d(_slam_opts(), device="cpu")
    odom = []
    for mg in log.measures(imu_capacity=64):
        if not eng.imu_inited and not mapping_app.init_imu_gate(eng, log, mg.scan_stamp):
            continue
        out_k = eng.add_measure(log.frame(mg.scan_index, "cpu"), mg.imu_gyro, mg.imu_acce,
                                mg.imu_stamp, mg.imu_valid)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = out_k.R.numpy(), out_k.t.numpy()
        odom.append(T)
    eng.optimize()
    np.testing.assert_array_equal(cap.engines[0].keyframe_poses(), eng.keyframe_poses())
    np.testing.assert_array_equal(np.stack(cap.engines[0].lio.poses), np.stack(odom))
    assert rep["frames"] == len(odom) and rep["keyframes"] == len(eng.kf_R)
    assert rep["loops"] == len(eng.loops) >= 1
    for f in ("odometry_kitti.txt", "keyframes_optimized_kitti.txt", "global_map.npz",
              "map_topdown.png", "scan_context.png", "report.json"):
        assert (out / f).exists(), f
    assert (out / "scan_context.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


GARGS = dict(image_size=500, resolution=10.0)     # tests/test_mapping2d.py:247-258


def _scans2d(mod, frames=8):
    world = mod.make_world_2d(seed=2)
    xy = np.zeros((frames, 720, 2), np.float32)
    valid = np.zeros((frames, 720), bool)
    for k in range(frames):
        th, t = 0.04 * k, np.array([0.25 * k, 0.0], np.float32)
        xy[k], valid[k] = mod.render_scan_2d(world, th, t, seed=k)
    return xy, valid


@pytest.mark.parametrize("device_resident", [True, False])
def test_run_mapping2d_is_its_engine_and_matches_jax(monkeypatch, tmp_path, device_resident):
    """tests/test_mapping2d.py:247-258's run through both engines: the
    port's poses are those of driving its engine directly, bit for bit;
    against JAX's app the same frames, submaps and loops, TUM rows within
    twice the gap a one-ulp nudge makes in JAX's own run (TUM prints 6
    decimals: floor 2e-6; measured: equal up to that rounding), and every
    artifact written."""
    xy, valid = _scans2d(synthetic)
    jxy, jvalid = _scans2d(jsynthetic)
    np.testing.assert_array_equal(xy, jxy)
    stamps = np.arange(len(xy), dtype=np.float64)
    opts = mapping2d.Mapping2dOptions(grid=grid2d.Grid2dOptions(**GARGS), keyframe_dist=0.2,
                                      max_keyframes_in_submap=6)
    jopts = jmapping2d.Mapping2dOptions(grid=jgrid2d.Grid2dOptions(**GARGS), keyframe_dist=0.2,
                                        max_keyframes_in_submap=6)
    cls = "Mapping2DDevice" if device_resident else "Mapping2D"
    cap = _Capture(monkeypatch, mapping2d_device if device_resident else mapping2d_app.m2d, cls)
    rep = mapping2d_app.run_mapping2d(xy, valid, stamps, opts, str(tmp_path / "port"),
                                      device_resident=device_resident, device="cpu")
    eng = (mapping2d_device.Mapping2DDevice(opts, device="cpu") if device_resident
           else mapping2d.Mapping2D(opts, device="cpu"))
    direct = [eng.process_scan(xy[k], valid[k]) for k in range(len(xy))]
    assert cap.engines[0].frame_count == eng.frame_count == len(xy)
    for (c, th, t), (dc, dth, dt) in zip(cap.engines[0].global_occupancy(),
                                         eng.global_occupancy()):
        np.testing.assert_array_equal(c, dc)
        assert th == dth
        np.testing.assert_array_equal(t, dt)
    reps = {"port": rep}
    for name, pts in (("jax", xy), ("nudged", np.nextafter(xy, np.float32(99)))):
        reps[name] = jmapping2d_app.run_mapping2d(pts, valid, stamps, jopts,
                                                  str(tmp_path / name),
                                                  device_resident=device_resident,
                                                  warm_start=False)
    rows = {k: np.loadtxt(tmp_path / k / "trajectory_tum.txt") for k in reps}
    assert rep == reps["jax"] and rep["submaps"] == 2
    gap = np.abs(rows["port"] - rows["jax"]).max(axis=0)
    self_gap = np.abs(rows["nudged"] - rows["jax"]).max(axis=0)
    assert np.all(gap <= 2 * np.maximum(self_gap, 2e-6)), (gap, self_gap)
    ours = np.loadtxt(tmp_path / "port" / "trajectory_tum.txt")
    np.testing.assert_allclose(ours[:, 1:3], np.stack([t for _, t in direct]), atol=1e-6)
    for f in ("trajectory_tum.txt", "submaps.npz", "report.json", "occupancy_global.png"):
        assert (tmp_path / "port" / f).exists(), f
    assert (tmp_path / "port" / "occupancy_global.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


# ---------------------------------------------------------------------------
# --mp-shards in two ranks; the entry points
# ---------------------------------------------------------------------------

def test_sharded_apps_in_two_ranks(tmp_path):
    """run_mapping(mp_shards=2) and run_matching(mp_shards=2) in a 2-rank
    gloo world (one launch): rank 0 writes its out dirs, rank 1 none; both
    ranks report the same frames; rank 0's poses within
    tests/test_map_shard.py's 0.02 m of the single-device apps."""
    map_log = logdir.make_demo_log(num_frames=MAP_FRAMES, capacity=CAP)
    loc_log = logdir.make_demo_log(num_frames=4, capacity=CAP, with_imu=False)
    world = synthetic.make_world(num_points=60000, extent=80.0, seed=0)
    lio_kw = {"matcher": "ndt_inc", "scan_capacity": CAP, "ndt": {}}
    loc_kw = {"scan_capacity": CAP, "icp": {"method": "p2plane_vox"}}
    case = {"map_log": map_log, "loc_log": loc_log, "world": world, "lio_opts": lio_kw,
            "loc_opts": loc_kw, "out": str(tmp_path)}
    ranks = multihost.launch("test_torch_dist_workers:sharded_apps_case", 2, (case,),
                             device="cpu", threads=2, extra_paths=[TESTS])
    r0, r1 = ranks
    assert r0["mapping_dir_exists"] and r0["matching_dir_exists"]
    assert not r1["mapping_dir_exists"] and not r1["matching_dir_exists"]
    assert r1["mapping_poses"] is None and "map_points" not in r1["mapping"]
    assert r0["mapping"]["frames"] == r1["mapping"]["frames"] == MAP_FRAMES
    assert r0["mapping"]["keyframes"] == r1["mapping"]["keyframes"]
    assert r0["mapping"]["mp_shards"] == 2 and len(r0["mapping"]["live_voxels_per_shard"]) == 2
    single = mapping_app.run_mapping(
        map_log, lio.LioOptions(matcher="ndt_inc", scan_capacity=CAP), str(tmp_path / "m1"),
        device="cpu")
    single_loc = matching_app.run_matching(
        loc_log, world, loc.LocOptions(scan_capacity=CAP), str(tmp_path / "l1"),
        init_pose=loc_log.gt_poses[0], device="cpu")
    assert single["frames"] == r0["mapping"]["frames"]
    assert single_loc["frames"] == r0["matching"]["frames"] == 4
    for app, d in (("mapping", "m1"), ("matching", "l1")):
        ref = trajectory.load_kitti(str(tmp_path / d / "trajectory_kitti.txt"))
        err = np.linalg.norm(r0[app + "_poses"][:, :3, 3] - ref[:, :3, 3], axis=1)
        assert err.max() < 0.02, (app, err)


def test_entry_and_dryrun_multichip():
    """entry() gives one LIO step (here on the CPU); the multi-rank dry
    run's compositions pass in two CPU ranks."""
    fn, args = entry.entry("cpu")
    state, out = fn(*args)
    assert torch.isfinite(out.t).all() and state.frame_idx == 1
    state, out = fn(state, args[1], args[2])
    assert torch.isfinite(out.t).all()
    summaries = entry.dryrun_multichip(2, device="cpu")
    assert len(summaries) == 2 and all("edge-sharded two-phase PGO" in s for s in summaries)
