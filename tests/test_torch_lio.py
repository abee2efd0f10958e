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
    """matcher="loam" and p2line_vox are ported (slice 4); the lag-1 loop
    (slice 3) and the pose-graph write-back (slice 6) still wait."""
    assert lio.Lio(lio.LioOptions(matcher="loam"), device="cpu").state.loam_target is not None
    eng = lio.Lio(lio.LioOptions(icp=icp.IcpOptions(method="p2line_vox")), device="cpu")
    assert eng.state.icp_target.line_packed is not None
    with pytest.raises(NotImplementedError, match="slice 6"):
        eng.apply_correction(torch.eye(3), torch.zeros(3))
    with pytest.raises(NotImplementedError, match="slice 3"):
        lio.Lio(lio.LioOptions(icp=icp.IcpOptions(method="p2plane_vox")), device="cpu",
                pipelined=True)
