"""Port parity for the slice as a whole: the LIO mapping step (matcher="icp",
p2plane_vox, ESKF on) on the synthetic demo log, through the JAX package's
Lio and the port's Lio -- step by step on a carried-across state, and free
running, with a witness of how far float32 rounding alone moves the
reference's own free run (tolerances stated in each test).

Also pins the port's numpy copies of the log generators
(io/synthetic, io/logdir, io/replay) bit-identical to the JAX package's."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loc_lib_tpu.io import logdir as jlogdir, replay as jreplay, synthetic as jsyn
from loc_lib_tpu.models import icp as jicp
from loc_lib_tpu.ops.pointcloud import PointCloud as JPointCloud
from loc_lib_tpu.pipeline import lio as jlio
from loc_lib_tpu_torch.eval import metrics
from loc_lib_tpu_torch.io import convert, logdir, replay, synthetic
from loc_lib_tpu_torch.models import icp
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
    pc = synthetic.render_scan(world, traj.R[2], traj.t[2], max_points=512, seed=2)
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


def test_unported_lio_paths_name_their_slice():
    with pytest.raises(NotImplementedError, match="slice 4"):
        lio.Lio(lio.LioOptions(matcher="ndt_inc"), device="cpu")
    with pytest.raises(NotImplementedError, match="slice 3"):
        lio.Lio(lio.LioOptions(icp=icp.IcpOptions(method="p2plane_vox")), device="cpu",
                pipelined=True)
