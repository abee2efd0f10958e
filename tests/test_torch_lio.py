"""Port parity for the slice as a whole: the LIO mapping step (matcher="icp",
p2plane_vox, ESKF on) on the synthetic demo log, through the JAX package's
Lio and the port's Lio -- step by step on a carried-across state, and free
running, with a witness of how far float32 rounding alone moves the
reference's own free run (tolerances stated in each test). The NDT family
(matchers ndt_inc, ndt, icp_vox_inc) step by step on a carried-across
state, and the matcher-aware health gate through Lio.add_cloud.

Also pins the port's numpy copies of the log generators
(io/synthetic, io/logdir, io/replay) bit-identical to the JAX package's."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loc_lib_tpu.io import logdir as jlogdir, replay as jreplay, synthetic as jsyn
from loc_lib_tpu.io import synthetic as jsynth
from loc_lib_tpu.models import icp as jicp, ndt as jndt
from loc_lib_tpu.ops.pointcloud import PointCloud as JPointCloud
from loc_lib_tpu.pipeline import lio as jlio
from loc_lib_tpu_torch.eval import metrics
from loc_lib_tpu_torch.io import convert, logdir, replay, synthetic
from loc_lib_tpu_torch.models import icp, ndt
from loc_lib_tpu_torch.utils import health
from loc_lib_tpu_torch.pipeline import lio
import oracles

torch.set_num_threads(2)

FRAMES, CAP = 10, 4096


@pytest.fixture(scope="module")
def log():
    return logdir.make_demo_log(num_frames=FRAMES, capacity=CAP, yaw_rate=0.0)


def test_numpy_generators_are_bit_identical(log):
    jlog = jlogdir.make_demo_log(num_frames=FRAMES, capacity=CAP, yaw_rate=0.0)
    for name in ("scan_stamps", "scan_xyz", "scan_mask", "gt_poses"):
        np.testing.assert_array_equal(getattr(log, name), getattr(jlog, name), name)
    for name in ("stamps", "gyro", "acce"):
        np.testing.assert_array_equal(getattr(log.imu, name), getattr(jlog.imu, name), name)
    ours = list(log.measures(imu_capacity=64))
    ref = list(jreplay.sync_measures(jlog.scan_stamps, jlog.imu, imu_capacity=64))
    assert len(ours) == len(ref) == FRAMES
    for a, b in zip(ours, ref):
        for f in replay.MeasureGroup._fields:
            if f != "gnss":
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    world = synthetic.make_world(num_points=3000, extent=30.0, seed=4)
    np.testing.assert_array_equal(world, jsyn.make_world(num_points=3000, extent=30.0, seed=4))
    traj = synthetic.make_trajectory(num_frames=5)
    for a, b in zip(traj, jsyn.make_trajectory(num_frames=5)):
        np.testing.assert_array_equal(a, b)
    pc = synthetic.render_scan(world, traj.R[2], traj.t[2], max_points=512, seed=2,
                               device="cpu")
    jpc = jsyn.render_scan(world, traj.R[2], traj.t[2], max_points=512, seed=2)
    np.testing.assert_array_equal(pc.xyz.numpy(), np.asarray(jpc.xyz))
    np.testing.assert_array_equal(pc.mask.numpy(), np.asarray(jpc.mask))


def _jax_engine():
    opts = jlio.LioOptions(matcher="icp", icp=jicp.IcpOptions(method="p2plane_vox"),
                           scan_capacity=CAP, with_eskf=True)
    return jlio.Lio(opts)


def _port_engine():
    opts = lio.LioOptions(matcher="icp", icp=icp.IcpOptions(method="p2plane_vox"),
                          scan_capacity=CAP, with_eskf=True)
    return lio.Lio(opts, device="cpu")


def _static_init(eng, log):
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150], log.imu.acce[:150]):
        eng.init_imu(g, a, t)
    assert eng.imu_inited


def _jax_scan(log, mg):
    return (JPointCloud(xyz=jnp.asarray(log.scan_xyz[mg.scan_index]),
                        mask=jnp.asarray(log.scan_mask[mg.scan_index])),
            jnp.asarray(mg.imu_gyro), jnp.asarray(mg.imu_acce),
            jnp.asarray(mg.imu_stamp), jnp.asarray(mg.imu_valid))


def _pose_gap(Ra, ta, Rb, tb):
    rot = np.linalg.norm(oracles.so3_log(np.asarray(Ra, np.float64).T
                                         @ np.asarray(Rb, np.float64)))
    return float(np.linalg.norm(np.asarray(ta) - np.asarray(tb))), rot


def test_lio_step_matches_jax_on_carried_state(log):
    """Every frame of the run: the JAX engine's state before the frame is
    carried across (io/convert) and the port's step_measure is held to the
    JAX step's output. Keyframe flags equal; poses within 5e-3 m / 5e-3 rad
    (measured ~1e-6: same target, same state, float32 rounding only)."""
    jeng = _jax_engine()
    _static_init(jeng, log)
    kfs = []
    for mg in jreplay.sync_measures(log.scan_stamps, log.imu, imu_capacity=64):
        state = convert.lio_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jeng.state)._asdict(), "cpu")
        _, tout = lio.step_measure(state, log.frame(mg.scan_index, "cpu"), mg.imu_gyro,
                                   mg.imu_acce, mg.imu_stamp, mg.imu_valid,
                                   _port_engine().opts)
        jout = jeng.add_measure(*_jax_scan(log, mg))
        assert tout.is_keyframe == bool(jout.is_keyframe)
        assert tout.iterations == int(jout.iterations)
        dt, rot = _pose_gap(jout.R, jout.t, tout.R.numpy(), tout.t.numpy())
        assert dt < 5e-3 and rot < 5e-3, (mg.scan_index, dt, rot)
        kfs.append(tout.is_keyframe)
    assert sum(kfs) >= 2


def _nudged(log):
    """The same log with every real scan coordinate moved by one float32
    ulp (np.nextafter towards +inf): a change at the size of one rounding."""
    out = copy.copy(log)
    xyz = log.scan_xyz.copy()
    m = log.scan_mask.astype(bool)
    xyz[m] = np.nextafter(xyz[m], np.float32(np.inf))
    out.scan_xyz = xyz
    return out


def _run_jax(log):
    eng = _jax_engine()
    _static_init(eng, log)
    kf = [bool(eng.add_measure(*_jax_scan(log, mg)).is_keyframe)
          for mg in jreplay.sync_measures(log.scan_stamps, log.imu, imu_capacity=64)]
    return np.stack(eng.poses), kf


def _max_gaps(A, B):
    g = np.array([_pose_gap(A[i, :3, :3], A[i, :3, 3], B[i, :3, :3], B[i, :3, 3])
                  for i in range(len(A))])
    return g[:, 0].max(), g[:, 1].max()


@pytest.fixture(scope="module")
def free_runs(log):
    """Free-running engines on the same log: JAX, JAX on the 1-ulp nudged
    log, and the port."""
    jposes, jkf = _run_jax(log)
    nposes, nkf = _run_jax(_nudged(log))
    eng = _port_engine()
    _static_init(eng, log)
    tkf = [eng.add_measure(log.frame(mg.scan_index, "cpu"), mg.imu_gyro, mg.imu_acce,
                           mg.imu_stamp, mg.imu_valid).is_keyframe
           for mg in log.measures(imu_capacity=64)]
    return {"jax": (jposes, jkf), "jax_nudged": (nposes, nkf),
            "port": (np.stack(eng.poses), tkf), "engine": eng}


def test_lio_free_run_is_rounding_sensitive_in_the_reference(log, free_runs):
    """Witness for the free-running bound below: moving every scan point by
    one float32 ulp moves the JAX engine's OWN trajectory on this log by up
    to 18.8 cm (ATE 0.234 -> 0.275 m; measured), more than the port's gap
    to JAX (7.1 cm). Plane tables are rebuilt from raw second moments about
    the map origin out to 70 m, whose float32 rounding moves the normals of
    thin voxels (test_torch_icp.py); during the ESKF velocity cold start the
    run amplifies that. So no float32 implementation can be held to 5e-3 m
    free running here; single steps are (test above)."""
    jposes, jkf = free_runs["jax"]
    nposes, nkf = free_runs["jax_nudged"]
    tposes, _ = free_runs["port"]
    self_dt, _ = _max_gaps(jposes, nposes)
    port_dt, _ = _max_gaps(jposes, tposes)
    assert nkf == jkf
    assert self_dt > 5e-3
    assert port_dt <= self_dt, (port_dt, self_dt)


def test_lio_run_tracks_like_jax(log, free_runs):
    """Free-running engines on the same log (see the witness above).
    Stated bounds, just above the measured gaps (7.1 cm, 6.9e-4 rad, ATE
    0.234 vs 0.249 m): equal keyframe flags, poses within 0.08 m /
    1e-3 rad, ATE within 0.02 m of JAX's."""
    jposes, jkf = free_runs["jax"]
    tposes, tkf = free_runs["port"]
    eng = free_runs["engine"]
    assert tkf == jkf and sum(tkf) >= 2
    for i in range(FRAMES):
        dt, rot = _pose_gap(jposes[i, :3, :3], jposes[i, :3, 3],
                            tposes[i, :3, :3], tposes[i, :3, 3])
        assert dt < 0.08 and rot < 1e-3, (i, dt, rot)
    ate_j = metrics.ate(jposes, log.gt_poses).rmse
    ate_t = metrics.ate(tposes, log.gt_poses).rmse
    assert abs(ate_t - ate_j) < 0.02, (ate_t, ate_j)
    assert eng.keyframe_poses().shape == (sum(tkf), 4, 4)
    assert eng.local_map().shape[1] == 3 and len(eng.local_map()) > CAP


def _ndt_family_opts(mod, imod, nmod, matcher):
    return mod.LioOptions(
        matcher=matcher, icp=imod.IcpOptions(method="p2plane_vox"),
        ndt=nmod.NdtOptions(method="incremental" if matcher == "ndt_inc" else "direct",
                            voxel_size=1.0),
        scan_capacity=CAP, with_eskf=True, vox_inc_reanchor=2)


@pytest.mark.parametrize("matcher", ["ndt_inc", "ndt", "icp_vox_inc"])
def test_ndt_family_step_matches_jax_on_carried_state(log, matcher):
    """Every frame: the JAX engine's state before the frame (with its NDT map
    or moment table) is carried across and the port's step_measure is held
    to the JAX step. Keyframe flags, iterations and effective counts equal;
    poses within 1e-5 m / 1e-5 rad (measured up to 2.2e-6 m); chi2 within
    rtol 1e-4 (measured 1.3e-5: icp_vox_inc's chi2 sums a few hundred
    squared plane distances of millimetres). icp_vox_inc re-anchors every
    2nd keyframe here, so both of its branches run."""
    jeng = jlio.Lio(_ndt_family_opts(jlio, jicp, jndt, matcher))
    _static_init(jeng, log)
    opts = _ndt_family_opts(lio, icp, ndt, matcher)
    kfs = 0
    for mg in jreplay.sync_measures(log.scan_stamps, log.imu, imu_capacity=64):
        state = convert.lio_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jeng.state)._asdict(), "cpu")
        _, tout = lio.step_measure(state, log.frame(mg.scan_index, "cpu"), mg.imu_gyro,
                                   mg.imu_acce, mg.imu_stamp, mg.imu_valid, opts)
        jout = jeng.add_measure(*_jax_scan(log, mg))
        assert tout.is_keyframe == bool(jout.is_keyframe)
        assert tout.iterations == int(jout.iterations)
        assert int(tout.num_effective) == int(jout.num_effective)
        dt, rot = _pose_gap(jout.R, jout.t, tout.R.numpy(), tout.t.numpy())
        assert dt < 1e-5 and rot < 1e-5, (mg.scan_index, dt, rot)
        np.testing.assert_allclose(float(tout.chi2), float(jout.chi2), rtol=1e-4)
        kfs += tout.is_keyframe
    assert kfs >= 2                  # the 2nd keyframe re-anchors icp_vox_inc


def test_health_gate_is_matcher_aware():
    """test_pipeline.py:243 in the port, through Lio.add_cloud: NDT reports
    an information-weighted chi2 (Mahalanobis^2 per residual, outlier gate
    20), so a clean ndt_inc run must stay 'ok' under the NDT threshold
    (10 per residual); the metric default (1.0 m^2) would flag every
    matched frame bad.

    Free running, the port's add_cloud poses follow JAX's no further than
    1.5 times the distance a 1-ulp nudge of every scan point moves JAX's own
    run (measured: port gap 3.4e-3 m, JAX 1-ulp drift 3.7e-3 m): the maps'
    information matrices amplify float32 rounding on near-planar voxels
    (test_torch_ndt.py), so no tighter free-run bound holds. Both stay
    within 0.05 m of the ground truth (measured 4.6e-3 m)."""
    world = jsynth.make_world(num_points=20000, extent=60.0, seed=0)
    traj = jsynth.make_trajectory(num_frames=12, dt=0.1, speed=2.0)
    scans = [synthetic.render_scan(world, traj.R[i], traj.t[i], max_range=35.0,
                                   max_points=2048, noise=0.005, seed=i, capacity=2048,
                                   device="cpu")
             for i in range(8)]
    args = dict(matcher="ndt_inc", scan_capacity=2048, with_eskf=False, kf_distance=0.4)
    eng = lio.Lio(lio.LioOptions(ndt=ndt.NdtOptions(method="incremental", voxel_size=1.0),
                                 **args), device="cpu")
    jeng = jlio.Lio(jlio.LioOptions(ndt=jndt.NdtOptions(method="incremental", voxel_size=1.0),
                                    **args))
    nudged = jlio.Lio(jlio.LioOptions(ndt=jndt.NdtOptions(method="incremental",
                                                          voxel_size=1.0), **args))
    metric = health.TrackingHealth(health.HealthOptions())
    assert eng.health.opts.max_chi2_per_point == 10.0
    port_gap, self_gap = [], []
    for k, sc in enumerate(scans):
        out = eng.add_cloud(sc)
        xyz, mask = sc.xyz.numpy(), sc.mask.numpy()
        jout = jeng.add_cloud(JPointCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask)))
        xyz = xyz.copy()
        xyz[mask] = np.nextafter(xyz[mask], np.float32(np.inf))
        nout = nudged.add_cloud(JPointCloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask)))
        if k:
            metric.update(bool(out.converged), int(out.num_effective), float(out.chi2))
        port_gap.append(np.linalg.norm(out.t.numpy() - np.asarray(jout.t)))
        self_gap.append(np.linalg.norm(np.asarray(nout.t) - np.asarray(jout.t)))
        gt = traj.R[0].T @ (traj.t[k] - traj.t[0])
        assert np.linalg.norm(out.t.numpy() - gt) < 0.05
        assert np.linalg.norm(np.asarray(jout.t) - gt) < 0.05
    assert max(self_gap) > 1e-3
    assert max(port_gap) <= 1.5 * max(self_gap), (max(port_gap), max(self_gap))
    assert eng.health.status == eng.health.OK, (eng.health.status, eng.health.total_bad)
    assert eng.health.total_bad <= 1
    assert eng.health.total_bad == jeng.health.total_bad
    assert metric.total_bad == len(scans) - 1


def test_unported_lio_paths_name_their_slice():
    """Every LIO path is ported: matcher="loam" and p2line_vox (slice 4),
    and since the rest of LIO came in, the lag-1 loop and the pose-graph
    write-back, which used to raise NotImplementedError naming slices 3 and
    6, construct and run (their parity is held by the tests below)."""
    assert lio.Lio(lio.LioOptions(matcher="loam"), device="cpu").state.loam_target is not None
    eng = lio.Lio(lio.LioOptions(icp=icp.IcpOptions(method="p2line_vox")), device="cpu")
    assert eng.state.icp_target.line_packed is not None
    eng.apply_correction(torch.eye(3), torch.zeros(3))
    assert torch.equal(eng.state.R, torch.eye(3)) and torch.equal(eng.state.t, torch.zeros(3))
    pip = lio.Lio(lio.LioOptions(icp=icp.IcpOptions(method="p2plane_vox")), device="cpu",
                  pipelined=True)
    assert pip.pipelined and pip.flush() is None


def _pipelined_scans():
    """tests/test_pipeline.py:263's workload: 8 scans of 2,048 points along
    the synthetic trajectory."""
    world = jsynth.make_world(num_points=20000, extent=60.0, seed=0)
    traj = jsynth.make_trajectory(num_frames=12, dt=0.1, speed=2.0)
    return [synthetic.render_scan(world, traj.R[i], traj.t[i], max_range=35.0,
                                  max_points=2048, noise=0.005, seed=i, capacity=2048,
                                  device="cpu")
            for i in range(8)]


def test_lio_pipelined_lag1_matches_sequential():
    """test_pipeline.py:263 in the port: Lio(pipelined=True) returns the
    previous scan's StepResult (None first), flush() drains the last one, and
    the recorded poses, keyframe poses and health equal sequential mode's
    bit for bit (the step writes nothing in place that a returned
    StepResult holds)."""
    opts = lio.LioOptions(matcher="icp", icp=icp.IcpOptions(method="p2plane_vox"),
                          scan_capacity=2048, with_eskf=False, kf_distance=0.4)
    seq = lio.Lio(opts, device="cpu")
    pip = lio.Lio(opts, device="cpu", pipelined=True)
    outs = []
    for k, scan in enumerate(_pipelined_scans()):
        outs.append(seq.add_cloud(scan))
        prev = pip.add_cloud(scan)
        assert (prev is None) == (k == 0)
        if prev is not None:
            assert torch.equal(prev.R, outs[-2].R) and torch.equal(prev.t, outs[-2].t)
        assert len(pip.poses) == k
    last = pip.flush()
    assert torch.equal(last.R, outs[-1].R) and pip.flush() is None
    np.testing.assert_array_equal(np.stack(seq.poses), np.stack(pip.poses))
    np.testing.assert_array_equal(seq.keyframe_poses(), pip.keyframe_poses())
    assert len(seq.kf_poses) >= 2
    assert (seq.health.status, seq.health.total_bad) == (pip.health.status, pip.health.total_bad)


def test_lio_pipelined_add_measure_matches_sequential(log):
    """The same through add_measure with the ESKF on (its state is updated
    out of place too), on the demo log's first 6 frames: bit-equal poses."""
    seq, pip = _port_engine(), _port_engine()
    pip.pipelined = True
    _static_init(seq, log)
    _static_init(pip, log)
    for mg in list(log.measures(imu_capacity=64))[:6]:
        args = (log.frame(mg.scan_index, "cpu"), mg.imu_gyro, mg.imu_acce, mg.imu_stamp,
                mg.imu_valid)
        seq.add_measure(*args)
        pip.add_measure(*args)
    pip.flush()
    np.testing.assert_array_equal(np.stack(seq.poses), np.stack(pip.poses))


def test_apply_correction_matches_jax(log):
    """test_slam3d.py:60 in the port, on a live state: the JAX engine runs 4
    frames, its state is carried across, and both packages apply the same
    correction. Every corrected field (R, t, last_*, last_kf_*, every
    keyframe pose of the window, the ESKF R, p, v) within atol 2e-6 of
    JAX's (float32 compositions of poses tens of metres out; measured
    ~5e-7); the untouched fields keep their bits; a fresh engine moves
    exactly like the JAX test's."""
    jeng = _jax_engine()
    _static_init(jeng, log)
    for mg in jreplay.sync_measures(log.scan_stamps, log.imu, imu_capacity=64):
        jeng.add_measure(*_jax_scan(log, mg))
    eng = _port_engine()
    eng.state = convert.lio_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jeng.state)._asdict(), "cpu")
    before = eng.state
    dR = oracles.so3_exp(np.array([0.01, -0.02, 0.3])).astype(np.float32)
    dt = np.array([1.0, -2.0, 0.5], np.float32)
    jeng.apply_correction(dR, dt)
    eng.apply_correction(dR, dt)
    js, ts = jeng.state, eng.state
    for name in ("R", "t", "last_R", "last_t", "last_kf_R", "last_kf_t", "kf_R", "kf_t"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   atol=2e-6, err_msg=name)
    for name in ("R", "p", "v", "g", "cov"):
        np.testing.assert_allclose(getattr(ts.eskf, name).numpy(),
                                   np.asarray(getattr(js.eskf, name)), atol=2e-6, err_msg=name)
    assert torch.equal(ts.eskf.g, before.eskf.g) and torch.equal(ts.kf_xyz, before.kf_xyz)
    assert ts.icp_target is before.icp_target and ts.num_kfs == before.num_kfs >= 2
    fresh = lio.Lio(lio.LioOptions(scan_capacity=64, num_kfs_in_local_map=2), device="cpu")
    fresh.apply_correction(dR, dt)
    np.testing.assert_allclose(fresh.state.R.numpy(), dR, atol=1e-6)
    np.testing.assert_allclose(fresh.state.t.numpy(), dt, atol=1e-6)
    np.testing.assert_allclose(fresh.state.eskf.p.numpy(), dt, atol=1e-6)


def test_lio_icp_health_stays_ok_like_jax_on_the_40_frame_log():
    """The 40-frame demo log at scan capacity 8192 (the log every LIO phase
    of chip_smoke.py drives) through matcher "icp" (p2plane_vox + ESKF) in
    both packages, free running: tracking health is "ok" after every frame
    with no bad frame in either, so the card run holds this matcher to
    "never LOST" like every other. ATE within 0.005 m of JAX's (measured
    0.0434 against 0.0437 m)."""
    big = logdir.make_demo_log(num_frames=40, capacity=8192, yaw_rate=0.0, speed=2.0)
    jeng = jlio.Lio(jlio.LioOptions(matcher="icp", icp=jicp.IcpOptions(method="p2plane_vox"),
                                    scan_capacity=8192, with_eskf=True))
    eng = lio.Lio(lio.LioOptions(matcher="icp", icp=icp.IcpOptions(method="p2plane_vox"),
                                 scan_capacity=8192, with_eskf=True), device="cpu")
    _static_init(jeng, big)
    _static_init(eng, big)
    for mg in big.measures(imu_capacity=64):
        eng.add_measure(big.frame(mg.scan_index, "cpu"), mg.imu_gyro, mg.imu_acce,
                        mg.imu_stamp, mg.imu_valid)
        jeng.add_measure(*_jax_scan(big, mg))
        assert eng.health.status == eng.health.OK, (mg.scan_index, eng.health.total_bad)
        assert jeng.health.status == jeng.health.OK, (mg.scan_index, jeng.health.total_bad)
    assert eng.health.total_bad == jeng.health.total_bad == 0
    ate_t = metrics.ate(np.stack(eng.poses), big.gt_poses).rmse
    ate_j = metrics.ate(np.stack(jeng.poses), big.gt_poses).rmse
    assert ate_t < 0.10 and abs(ate_t - ate_j) < 0.005, (ate_t, ate_j)


def _corridor_scans(frames):
    """The reference's exploring corridor (tests/test_pipeline.py:215-236):
    the pillar corridor world and 6,144-row scans every 0.45 m, each as the
    JAX package's cloud and the same rows for the port."""
    from tests.test_pipeline import _corridor_scan, _pillar_corridor

    rng = np.random.default_rng(0)
    world = _pillar_corridor(rng)
    out = []
    for k in range(frames):
        t = np.array([0.45 * k, 0.0, 0.0], np.float32)
        jpc = _corridor_scan(world, t, rng)
        out.append((t, jpc, lio.PointCloud(xyz=torch.from_numpy(np.array(jpc.xyz)),
                                           mask=torch.from_numpy(np.array(jpc.mask)))))
    return out


def test_lio_corridor_scans_narrower_than_the_ring_track_like_jax():
    """Scans of 6,144 rows into keyframe rings 8,192 wide (the default
    scan_capacity), the reference's exploring odometry (45 frames, ndt_inc,
    no ESKF): the port writes each keyframe at the front of its slot and
    keeps the rows past it, as JAX's dynamic_update_index_in_dim does. The
    port's ring equals JAX's, its rotation stays on the manifold and its
    per-frame position errors stay under 0.1 m, within 0.01 m of JAX's (on
    the CPU: 0.0124 m against 0.0124 m)."""
    scans = _corridor_scans(45)
    opts = dict(with_eskf=False, kf_distance=0.4, matcher="ndt_inc")
    jeng, eng = jlio.Lio(jlio.LioOptions(**opts)), lio.Lio(lio.LioOptions(**opts), device="cpu")
    assert eng.opts.scan_capacity == 8192 > scans[0][2].capacity == 6144
    z, s, v = np.zeros((4, 3), np.float32), np.zeros(4), np.zeros(4, bool)
    errs, jerrs = [], []
    for t, jpc, pc in scans:
        errs.append(np.linalg.norm(eng.add_measure(pc, z, z, s, v).t.numpy() - t))
        jerrs.append(np.linalg.norm(np.asarray(jeng.add_measure(jpc, z, z, s, v).t) - t))
    R = eng.state.R.numpy()
    assert np.abs(R.T @ R - np.eye(3)).max() < 1e-5
    assert max(errs) < 0.1, max(errs)
    assert abs(max(errs) - max(jerrs)) < 0.01, (max(errs), max(jerrs))
    assert eng.state.num_kfs == int(jeng.state.num_kfs) > eng.opts.num_kfs_in_local_map
    np.testing.assert_array_equal(eng.state.kf_mask.numpy(), np.asarray(jeng.state.kf_mask))
    np.testing.assert_array_equal(eng.state.kf_xyz[:, 6144:].numpy(),
                                  np.asarray(jeng.state.kf_xyz)[:, 6144:])
    # a scan wider than the ring raises, as in JAX
    with pytest.raises(ValueError, match="does not fit"):
        lio._push_keyframe(eng.opts, eng.state, torch.zeros((8193, 3)),
                           torch.zeros(8193, dtype=torch.bool), eng.state.R, eng.state.t)


def _same_bits(a, b) -> bool:
    """Two tensors, or (nested) NamedTuples of them, hold the same bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same_bits(x, y) for x, y in zip(a, b))
    return a == b


def _keyframe_scans(frames, points=512):
    """`frames` scans of `points` rows 0.2 m apart along the synthetic
    trajectory: each one a keyframe at kf_distance 0.1."""
    world = jsynth.make_world(num_points=20000, extent=60.0, seed=3)
    traj = jsynth.make_trajectory(num_frames=frames, dt=0.1, speed=2.0)
    return [synthetic.render_scan(world, traj.R[i], traj.t[i], max_range=35.0,
                                  max_points=points, noise=0.005, seed=i, capacity=points,
                                  device="cpu")
            for i in range(frames)]


def test_icp_map_build_equals_a_direct_build_at_every_keyframe(tmp_path):
    """matcher "icp" builds its target through `_MapBuild` (staging copies of
    the ring, the build, clones out; on a card a CUDA graph replay). Over 25
    keyframes (the ring's 10 slots filled and wrapped twice), with a pose
    correction at the 12th and the state replaced by a checkpoint's restore
    at the 18th, every build's target (its grid's origin among it) and
    overflow equal bit for bit a direct `_assemble_local_map` + `set_target`
    on the state's own ring. A state kept from the 5th build still holds its
    own target at the end (states are updated out of place), and on the CPU
    no graph is captured or replayed."""
    from loc_lib_tpu_torch.io import checkpoint
    from loc_lib_tpu_torch.utils import timing

    opts = lio.LioOptions(matcher="icp", icp=icp.IcpOptions(method="p2plane_vox"),
                          scan_capacity=512, with_eskf=False, kf_distance=0.1)
    eng = lio.Lio(opts, device="cpu")
    dR = oracles.so3_exp(np.array([0.002, -0.001, 0.05])).astype(np.float32)
    held = None
    for k, scan in enumerate(_keyframe_scans(25)):
        if k == 12:
            eng.apply_correction(dR, np.array([0.3, -0.2, 0.05], np.float32))
        if k == 18:
            path = checkpoint.save_state(str(tmp_path / "ckpt"), eng.state)
            restored, _ = checkpoint.load_state(path, eng.state)
            assert restored.kf_xyz is not eng.state.kf_xyz
            assert _same_bits(restored.kf_xyz, eng.state.kf_xyz)
            eng.state = restored
        assert eng.add_cloud(scan).is_keyframe
        s = eng.state
        local_map, origin, ovf = lio._assemble_local_map(opts, s.kf_xyz, s.kf_mask, s.kf_R,
                                                         s.kf_t)
        assert _same_bits(s.icp_target, icp.set_target(local_map, opts.icp, origin)), k
        assert _same_bits(s.icp_target.grid.origin, origin), k
        assert _same_bits(s.map_overflow, ovf), k
        if k == 5:
            held, kept = s, icp.tree_map(torch.clone, s.icp_target)
    assert eng.state.num_kfs == 25 and int(eng.state.icp_target.plane_valid.sum()) > 0
    assert _same_bits(held.icp_target, kept)
    assert not _same_bits(held.icp_target.packed, eng.state.icp_target.packed)
    assert timing.COUNTERS.get("map_build.replays", 0) == 0
    assert timing.COUNTERS.get("map_build.captures", 0) == 0


@pytest.mark.parametrize("matcher", ["icp", "ndt", "ndt_inc", "loam", "icp_vox_inc"])
def test_only_the_icp_matcher_builds_through_the_map_build_runner(monkeypatch, matcher):
    """The other matchers keep their eager build: ndt and loam build other
    targets over the local map, ndt_inc absorbs a keyframe, icp_vox_inc
    branches on the host's keyframe count. Only "icp" goes through
    `_map_build`, once a keyframe."""
    calls = []
    build = lio._map_build
    monkeypatch.setattr(lio, "_map_build", lambda *a: calls.append(1) or build(*a))
    opts = lio.LioOptions(matcher=matcher, icp=icp.IcpOptions(method="p2plane_vox"),
                          scan_capacity=512, num_kfs_in_local_map=3, with_eskf=False,
                          kf_distance=0.1, vox_inc_reanchor=2)
    state = lio.init_state(opts, device="cpu")
    keyframes = 0
    for scan in _keyframe_scans(4):
        state, out = lio.step(state, scan, opts,
                              edge_scan=scan if matcher == "loam" else None)
        keyframes += out.is_keyframe
    assert keyframes == state.num_kfs >= 2
    assert len(calls) == (keyframes if matcher == "icp" else 0)
