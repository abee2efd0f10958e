"""Port parity: localization against a prior map (loc_lib_tpu_torch.pipeline.loc)
against the JAX package, on a small demo log (world 20,000 points, extent
60 m, 35 m range, scan capacity 2048).

Stated tolerances:
  * crop_local_map: bit-identical (a box mask and a stable compaction);
  * the snapped crop origin and the voxel keys of the target built over a
    re-crop: bit-identical;
  * one step / step_measure per frame on a state carried across from the
    JAX engine (io/convert): need_recrop, converged and counts equal, poses
    within 1e-5 m / 1e-5 rad, chi2 within rtol 1e-4 (the p2plane_vox and
    NDT matches agree to ~1e-6 m on a carried-across target,
    test_torch_icp.py / test_torch_ndt.py; the ESKF update adds float32
    rounding of its own);
  * the free-running Loc wrapper on the port's own crops: poses within 1e-3 m
    of the JAX wrapper's (the map is fixed, so unlike LIO no keyframe
    rebuild feeds rounding back into the target).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loc_lib_tpu.io import synthetic as jsyn
from loc_lib_tpu.models import icp as jicp, ndt as jndt
from loc_lib_tpu.ops import pointcloud as jpc
from loc_lib_tpu.pipeline import loc as jloc
from loc_lib_tpu_torch.io import convert, logdir
from loc_lib_tpu_torch.models import icp, ndt
from loc_lib_tpu_torch.ops import pointcloud as pcm
from loc_lib_tpu_torch.pipeline import loc
import oracles

torch.set_num_threads(2)

CAP = 2048
WORLD_KW = dict(world_points=20000, extent=60.0, max_range=35.0)


def _log(frames):
    return logdir.make_demo_log(num_frames=frames, capacity=CAP, yaw_rate=0.0, **WORLD_KW)


def _world():
    return jsyn.make_world(num_points=WORLD_KW["world_points"], extent=WORLD_KW["extent"],
                           seed=0)


def _opts(mod, icp_mod, ndt_mod, method, **kw):
    """Loc options of each package: voxel-plane ICP (method) or direct NDT
    on 2 m voxels (the sparse world needs > 3 points per voxel)."""
    matcher = "ndt" if method == "ndt" else "icp"
    base = dict(local_map_capacity=32768, box_size=120.0)
    base.update(kw)
    return mod.LocOptions(matcher=matcher,
                          icp=icp_mod.IcpOptions(method="p2plane_vox" if method == "ndt"
                                                 else method),
                          ndt=ndt_mod.NdtOptions(voxel_size=2.0, map_capacity=16384), **base)


def _jscan(log, k):
    return jpc.PointCloud(xyz=jnp.asarray(log.scan_xyz[k]), mask=jnp.asarray(log.scan_mask[k]))


def _carried(jstate):
    return convert.loc_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate)._asdict(),
                                        "cpu")


def _pose_gap(Ra, ta, Rb, tb):
    rot = np.linalg.norm(oracles.so3_log(np.asarray(Ra, np.float64).T
                                         @ np.asarray(Rb, np.float64)))
    return float(np.linalg.norm(np.asarray(ta) - np.asarray(tb))), rot


def _assert_step_matches(tout, jout, what):
    assert bool(tout.need_recrop) == bool(jout.need_recrop), what
    assert bool(tout.converged) == bool(jout.converged), what
    assert int(tout.num_effective) == int(jout.num_effective), what
    dt, rot = _pose_gap(jout.R, jout.t, tout.R.numpy(), tout.t.numpy())
    assert dt < 1e-5 and rot < 1e-5, (what, dt, rot)
    np.testing.assert_allclose(float(tout.chi2), float(jout.chi2), rtol=1e-4)


@pytest.mark.parametrize("method,entry", [("p2plane_vox", "step_measure"),
                                          ("p2plane_vox_oct", "step_measure"),
                                          ("ndt", "step_measure"),
                                          ("p2plane_vox", "step")])
def test_loc_step_matches_jax_on_carried_state(method, entry):
    """Every frame: the JAX engine's state before the frame carried across,
    the port's step (ESKF off) or step_measure (ESKF on) held to the JAX
    step on the same scan and IMU packet."""
    frames = 6
    log = _log(frames)
    with_eskf = entry == "step_measure"
    jopts = _opts(jloc, jicp, jndt, method, with_eskf=with_eskf)
    topts = _opts(loc, icp, ndt, method, with_eskf=with_eskf)
    jeng = jloc.Loc(_world(), jopts)
    jeng.set_init_pose(log.gt_poses[0][:3, :3], log.gt_poses[0][:3, 3] + 0.1)
    for mg in log.measures(imu_capacity=64):
        k = mg.scan_index
        state = _carried(jeng.state)
        assert state.initialized
        scan = log.frame(k, "cpu")
        if with_eskf:
            _, tout = loc.step_measure(state, scan, mg.imu_gyro, mg.imu_acce, mg.imu_stamp,
                                       mg.imu_valid, topts)
            jout = jeng.update_measure(_jscan(log, k), mg.imu_gyro, mg.imu_acce, mg.imu_stamp,
                                       mg.imu_valid)
        else:
            _, tout = loc.step(state, scan, topts)
            jout = jeng.update_cloud(_jscan(log, k))
        _assert_step_matches(tout, jout, (method, entry, k))
        # the ESKF starts at rest while the log moves at 2 m/s: a bounded
        # transient, as in test_pipeline.py's ESKF run (< 0.8 m)
        gt = log.gt_poses[k][:3, 3]
        assert np.linalg.norm(tout.t.numpy() - gt) < (0.8 if with_eskf else 0.3), (k, tout.t)


@pytest.mark.parametrize("capacity", [4096, 65536])
def test_crop_local_map_matches_jax(capacity):
    """Box crop: inside points first, in map order, padded to the capacity;
    a capacity above the map's padded size keeps the map's size, as in JAX."""
    world = _world()
    gm_j, gm_t = jpc.from_numpy(world), pcm.from_numpy(world)
    center = np.array([3.25, -1.5, 1.5], np.float32)
    jc = jloc.crop_local_map(gm_j.xyz, gm_j.mask, jnp.asarray(center), 20.0, capacity)
    tc = loc.crop_local_map(gm_t.xyz, gm_t.mask, torch.from_numpy(center), 20.0, capacity)
    assert tc.capacity == min(capacity, gm_t.capacity) == jc.xyz.shape[0]
    np.testing.assert_array_equal(tc.xyz.numpy(), np.asarray(jc.xyz))
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    assert 0 < int(tc.mask.sum()) <= capacity


def test_loc_recrop_matches_jax():
    """A 40 m box re-crops once the pose is 1 m from the crop centre. Both
    wrappers run free on their own crops: each re-crop has the same centre,
    snapped origin and voxel keys, and the poses agree within 1e-3 m."""
    frames = 12
    log = _log(frames)
    kw = dict(box_size=40.0, recrop_margin=19.0, with_eskf=True)
    jopts, topts = _opts(jloc, jicp, jndt, "p2plane_vox", **kw), _opts(loc, icp, ndt,
                                                                      "p2plane_vox", **kw)
    jeng = jloc.Loc(_world(), jopts)
    teng = loc.Loc(_world(), topts, device="cpu")
    R0, t0 = log.gt_poses[0][:3, :3], log.gt_poses[0][:3, 3]
    jeng.set_init_pose(R0, t0)
    teng.set_init_pose(R0, t0)
    recrops = 0
    for mg in log.measures(imu_capacity=64):
        k = mg.scan_index
        jout = jeng.update_measure(_jscan(log, k), mg.imu_gyro, mg.imu_acce, mg.imu_stamp,
                                   mg.imu_valid)
        tout = teng.update_measure(log.frame(k, "cpu"), mg.imu_gyro, mg.imu_acce,
                                   mg.imu_stamp, mg.imu_valid)
        assert bool(tout.need_recrop) == bool(jout.need_recrop), k
        recrops += bool(jout.need_recrop)
        dt, rot = _pose_gap(jout.R, jout.t, tout.R.numpy(), tout.t.numpy())
        assert dt < 1e-3 and rot < 1e-3, (k, dt, rot)
        jt, tt = jeng.state.icp_target, teng.state.icp_target
        # the crop centre is the pose at the re-crop; the origin its floor
        # snap: equal up to the pose gap above, equal bits while it stays
        # inside one voxel
        np.testing.assert_allclose(teng.state.map_center.numpy(),
                                   np.asarray(jeng.state.map_center), atol=1e-3)
        np.testing.assert_array_equal(tt.grid.origin.numpy(), np.asarray(jt.grid.origin))
        np.testing.assert_array_equal(tt.grid.voxel_keys.numpy(), np.asarray(jt.grid.voxel_keys))
    assert recrops >= 1 and teng.num_recrops == recrops
    # the snap: origin = floor(centre / leaf) * leaf, on whole leaves
    o = teng.state.icp_target.grid.origin.numpy()
    np.testing.assert_array_equal(o, np.floor(teng.state.map_center.numpy() / 1.0) * 1.0)
    assert len(teng.poses) == frames


def test_loc_tracks_with_the_port_matchers():
    """test_pipeline.py:84's localization on the port's fused methods:
    init 0.1 m off the truth on each axis, ESKF off, every frame within
    5 cm (JAX's own run: within 4 mm; 0.2 m off, both packages lose the
    weakly constrained x axis of this sparse world); current_pose is the
    last recorded pose."""
    log = _log(8)
    for method in ("p2plane_vox", "p2plane_vox_oct"):
        eng = loc.Loc(_world(), _opts(loc, icp, ndt, method, with_eskf=False), device="cpu")
        eng.set_init_pose(log.gt_poses[0][:3, :3], log.gt_poses[0][:3, 3] + 0.1)
        for k in range(8):
            out = eng.update_cloud(log.frame(k, "cpu"))
            err = np.linalg.norm(out.t.numpy() - log.gt_poses[k][:3, 3])
            assert err < 0.05, (method, k, err)
        np.testing.assert_array_equal(eng.current_pose(), eng.poses[-1])
        assert eng.health.status == eng.health.OK


def test_predict_imu_and_set_init_pose_match_jax():
    """Loc::Update(imu) as a single-sample ESKF predict, and SetInitPose's
    seeding of the pose and the ESKF nominal, on carried-across states."""
    log = _log(2)
    jopts, topts = _opts(jloc, jicp, jndt, "p2plane_vox"), _opts(loc, icp, ndt, "p2plane_vox")
    jst = jloc.set_init_pose(jloc.init_state(jopts), log.gt_poses[1][:3, :3],
                             log.gt_poses[1][:3, 3])
    tst = loc.set_init_pose(loc.init_state(topts, device="cpu"),
                            torch.from_numpy(log.gt_poses[1][:3, :3]),
                            torch.from_numpy(log.gt_poses[1][:3, 3]))
    assert tst.initialized and bool(jst.initialized)
    for name in ("R", "t", "last_R", "last_t"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(), np.asarray(getattr(jst, name)))
    for name in ("R", "p"):
        np.testing.assert_allclose(getattr(tst.eskf, name).numpy(),
                                   np.asarray(getattr(jst.eskf, name)), atol=1e-6)
    jstate = jst
    for i in range(5):
        g, a, s = log.imu.gyro[i], log.imu.acce[i], log.imu.stamps[i]
        tst = loc.predict_imu(_carried(jstate), g, a, s)
        jstate = jloc.predict_imu(jstate, jnp.asarray(g, jnp.float32),
                                  jnp.asarray(a, jnp.float32), jnp.float32(s))
        for name in ("R", "p", "v", "cov"):
            np.testing.assert_allclose(getattr(tst.eskf, name).numpy(),
                                       np.asarray(getattr(jstate.eskf, name)),
                                       rtol=1e-5, atol=1e-6)


def test_loc_health_flags_lost_on_empty_map():
    """test_pipeline.py:169: localizing against an empty map must flag LOST,
    not silently emit poses (health counts every frame, the first too)."""
    rng = np.random.default_rng(0)
    eng = loc.Loc(np.zeros((0, 3), np.float32),
                  loc.LocOptions(local_map_capacity=1024), device="cpu")
    eng.set_init_pose(np.eye(3), np.zeros(3))
    scan = pcm.PointCloud(xyz=torch.from_numpy(rng.uniform(-5, 5, (256, 3)).astype(np.float32)),
                          mask=torch.ones((256,), dtype=torch.bool))
    for k in range(12):
        eng.update_cloud(scan)
        if k == 3:
            assert eng.health.total_bad == 4        # frame 0 counted
    assert eng.health.needs_reinit
    assert len(eng.poses) == 12 and np.isfinite(np.stack(eng.poses)).all()
