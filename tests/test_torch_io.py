"""Port parity for the io glue and the host helpers (slice 10): the
quaternion / roll-pitch-yaw helpers, RPE and the ENU converter, the native
host runtime against its numpy oracle and against the JAX package's
packets, logs saved by one package and loaded by the other, the writers
byte for byte against the JAX package's (PCD, KITTI velodyne / vendor PCD
logs, KITTI trajectories, PNGs; TUM rows parsed back within 1e-6),
checkpoint / resume, the timing instruments and the YAML config. Inputs
are made from seeds with numpy; JAX runs on the CPU."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loc_lib_tpu.eval import metrics as jmetrics
from loc_lib_tpu.io import (config as jconfig, kitti as jkitti, logdir as jlogdir,
                            native as jnative, pcd as jpcd, replay as jreplay,
                            trajectory as jtrajectory, viz as jviz)
from loc_lib_tpu.utils import lie as jlie, mathx as jmathx
from loc_lib_tpu_torch.eval import metrics
from loc_lib_tpu_torch.io import (checkpoint, config, kitti, logdir, native, pcd, replay,
                                  trajectory, viz)
from loc_lib_tpu_torch.models import eskf, icp
from loc_lib_tpu_torch.pipeline import lio
from loc_lib_tpu_torch.utils import lie, mathx, timing

torch.set_num_threads(2)


def _random_rotations(rng, n):
    w = rng.normal(0, 1, (n, 3))
    w *= (rng.uniform(0, np.pi, n) / np.linalg.norm(w, axis=1))[:, None]
    return lie.so3_exp(torch.from_numpy(w.astype(np.float32))).numpy()


def _test_rotations():
    """Random rotations, rotations within 1e-3 rad of pi (the symmetric
    part carries the axis), and rotations whose Shepperd scores tie
    exactly: 90 deg about z (trace == m22 - m00 - m11 == 1), pi about
    (1, 1, 0) / sqrt 2 (the x and y scores equal), pi about x, the
    identity."""
    rng = np.random.default_rng(0)
    Rs = [_random_rotations(rng, 64)]
    axes = rng.normal(0, 1, (16, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    near_pi = axes * (np.pi - rng.uniform(0, 1e-3, 16))[:, None]
    Rs.append(lie.so3_exp(torch.from_numpy(near_pi.astype(np.float32))).numpy())
    ties = np.array([
        [[0, -1, 0], [1, 0, 0], [0, 0, 1]],
        [[0, 1, 0], [1, 0, 0], [0, 0, -1]],
        [[1, 0, 0], [0, -1, 0], [0, 0, -1]],
        np.eye(3)], np.float32)
    Rs.append(ties)
    return np.concatenate(Rs).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_quaternion_helpers_match_jax(dtype):
    """quat_from_rotm (Shepperd's four candidates, the first of equal
    scores), rotm_from_quat and quat_slerp against JAX within 1e-6, on
    float32 and float64 input (JAX runs float32 either way, x64 off)."""
    R = _test_rotations().astype(dtype)
    q = lie.quat_from_rotm(torch.from_numpy(R))
    jq = np.asarray(jlie.quat_from_rotm(jnp.asarray(R)))
    np.testing.assert_allclose(q.numpy(), jq, atol=1e-6)
    # the tie rows pick the first candidate: q0 for 90 deg about z, q1 for
    # pi about (1, 1, 0)
    assert abs(q[-4, 0] - np.sqrt(0.5)) < 1e-6 and abs(q[-3, 1] - np.sqrt(0.5)) < 1e-6
    np.testing.assert_allclose(lie.rotm_from_quat(q).numpy(),
                               np.asarray(jlie.rotm_from_quat(jnp.asarray(jq))), atol=1e-6)
    np.testing.assert_allclose(lie.rotm_from_quat(q).numpy(), R, atol=2e-6)
    qb = torch.roll(q, 1, dims=0)
    for alpha in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(
            lie.quat_slerp(q, qb, alpha).numpy(),
            np.asarray(jlie.quat_slerp(jnp.asarray(jq), jnp.asarray(qb.numpy()), alpha)),
            atol=1e-6)


def test_rpy_se3_and_regularized_inverse_match_jax():
    rng = np.random.default_rng(1)
    rpy = rng.uniform(-np.pi, np.pi, (3, 5))
    np.testing.assert_allclose(lie.rotm_from_rpy(*rpy).numpy(),
                               np.asarray(jlie.rotm_from_rpy(*rpy)), atol=1e-6)
    assert lie.rotm_from_rpy(0.1, 0.2, 0.3).dtype == torch.float32
    R = _random_rotations(rng, 1)[0]
    t = rng.normal(0, 1, 3).astype(np.float32)
    pts = rng.normal(0, 10, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        lie.se3_apply(torch.from_numpy(R), torch.from_numpy(t), torch.from_numpy(pts)).numpy(),
        np.asarray(jlie.se3_apply(jnp.asarray(R), jnp.asarray(t), jnp.asarray(pts))),
        atol=1e-5)
    for a, b in zip(lie.se3_identity(), jlie.se3_identity()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    A = rng.normal(0, 1, (8, 3, 3)).astype(np.float32)
    cov = A @ A.transpose(0, 2, 1) * 0.01
    np.testing.assert_allclose(
        mathx.regularized_inverse_3x3(torch.from_numpy(cov)).numpy(),
        np.asarray(jmathx.regularized_inverse_3x3(jnp.asarray(cov))), rtol=1e-4, atol=1e-3)
    assert mathx.G_M_S2 == jmathx.G_M_S2 and eskf.DEG2RAD == pytest.approx(np.pi / 180)


def test_rpe_and_enu_match_jax():
    rng = np.random.default_rng(2)
    T = np.tile(np.eye(4), (12, 1, 1))
    T[:, :3, :3] = _random_rotations(rng, 12)
    T[:, :3, 3] = np.cumsum(rng.normal(0, 1, (12, 3)), axis=0)
    G = T.copy()
    G[:, :3, 3] += rng.normal(0, 0.05, (12, 3))
    for delta in (1, 3):
        a, b = metrics.rpe(T, G, delta), jmetrics.rpe(T, G, delta)
        assert a.trans_rmse == b.trans_rmse and a.rot_rmse_deg == b.rot_rmse_deg
        np.testing.assert_array_equal(a.trans_errors, b.trans_errors)
    lla0 = (31.2, 121.5, 12.0)
    enu, jenu = replay.EnuConverter(*lla0), jreplay.EnuConverter(*lla0)
    for lla in ((31.2001, 121.5002, 13.0), (31.19, 121.49, 5.0)):
        np.testing.assert_array_equal(enu.to_enu(*lla), jenu.to_enu(*lla))
    np.testing.assert_array_equal(replay._lla_to_ecef(*lla0), jreplay._lla_to_ecef(*lla0))


def _random_imu(rng, m=300, dt=0.01):
    stamps = np.sort(np.arange(m) * dt + rng.uniform(-dt / 4, dt / 4, m))
    return (stamps, rng.normal(0, 1, (m, 3)).astype(np.float32),
            rng.normal(0, 5, (m, 3)).astype(np.float32))


def test_native_runtime_matches_numpy_and_jax():
    """The native build (csrc/loc_runtime.cpp, built into csrc/build/)
    against its numpy oracle, at test_native.py's tolerances, and bit for
    bit against the JAX package's native module on the same inputs."""
    assert native.available(), "g++ is on this machine: the runtime must build"
    assert native.library_path().parent.parent.name == "build"
    rng = np.random.default_rng(3)
    imu_stamps, gyro, acce = _random_imu(rng)
    scan_stamps = np.concatenate([[imu_stamps[0] - 0.5, imu_stamps[17]],
                                  np.sort(rng.uniform(0.3, 2.8, 12)), [imu_stamps[-1] + 1.0]])
    for cap in (8, 32):
        got = native.sync_measures_batch(scan_stamps, imu_stamps, gyro, acce, cap)
        want = native._sync_measures_np(scan_stamps, imu_stamps, gyro, acce, cap)
        np.testing.assert_array_equal(got[3], want[3])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)
        for a, b in zip(got, jnative.sync_measures_batch(scan_stamps, imu_stamps, gyro, acce,
                                                          cap)):
            np.testing.assert_array_equal(a, b)
    n = 2000
    xyz = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    xyz[rng.choice(n, 50, replace=False)] = np.nan
    tst = 100.0 + np.sort(rng.uniform(0, 0.1, n))
    ring = rng.integers(0, 16, n).astype(np.int32)
    got = native.convert_cloud(xyz, 4096, tst, ring, min_range=4.0, max_range=60.0)
    want = native._convert_cloud_np(xyz, 4096, tst, ring, 4.0, 60.0, 1e6)
    for g, w, j in zip(got, want, jnative.convert_cloud(xyz, 4096, tst, ring, min_range=4.0,
                                                         max_range=60.0)):
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(g, j)
    assert 0 < got[4] < n and got[3].sum() == got[4]
    assert native.convert_cloud(xyz[:500], 64)[4] == 64


@pytest.fixture(scope="module")
def demo_logs():
    return (logdir.make_demo_log(num_frames=4, capacity=512),
            jlogdir.make_demo_log(num_frames=4, capacity=512))


def test_measures_equal_jax_packets(demo_logs):
    """SensorLog.measures (native sync) gives the JAX package's packets bit
    for bit; frame() carries ring / time / intensity when the log has them."""
    log, jlog = demo_logs
    ours, ref = list(log.measures(imu_capacity=64)), list(jlog.measures(imu_capacity=64))
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        for f in replay.MeasureGroup._fields:
            if f != "gnss":
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    ring = np.tile(np.arange(512, dtype=np.int32) % 16, (4, 1))
    log2 = logdir.SensorLog(log.scan_stamps, log.scan_xyz, log.scan_mask, scan_ring=ring)
    pc = log2.frame(2, "cpu")
    np.testing.assert_array_equal(pc.ring.numpy(), ring[2])
    assert pc.time is None and pc.xyz.device.type == "cpu"


def _full_log(log):
    rng = np.random.default_rng(4)
    f, c = log.scan_mask.shape
    gnss = replay.GnssLog(stamps=log.scan_stamps.copy(),
                          lla=np.array([31.2, 121.5, 10.0]) + rng.normal(0, 1e-5, (f, 3)))
    return logdir.SensorLog(
        log.scan_stamps, log.scan_xyz, log.scan_mask, log.imu, gnss, log.gt_poses,
        scan_ring=rng.integers(-1, 16, (f, c)).astype(np.int32),
        scan_time=rng.uniform(0, 1, (f, c)).astype(np.float32),
        scan_intensity=rng.uniform(0, 255, (f, c)).astype(np.float32))


def test_logs_load_across_packages(tmp_path, demo_logs):
    """A log saved by the JAX package loads in the port and the reverse,
    every array equal (ring / time / intensity, IMU, GNSS, ground truth)."""
    log = _full_log(demo_logs[0])
    jlog = jlogdir.SensorLog(log.scan_stamps, log.scan_xyz, log.scan_mask,
                             jreplay.ImuLog(log.imu.stamps, log.imu.gyro, log.imu.acce),
                             jreplay.GnssLog(log.gnss.stamps, log.gnss.lla), log.gt_poses,
                             scan_ring=log.scan_ring, scan_time=log.scan_time,
                             scan_intensity=log.scan_intensity)
    logdir.save_log(str(tmp_path / "port"), log)
    jlogdir.save_log(str(tmp_path / "jax"), jlog)
    for a, b in ((jlogdir.load_log(str(tmp_path / "port")), log),
                 (logdir.load_log(str(tmp_path / "jax")), log)):
        for name in ("scan_stamps", "scan_xyz", "scan_mask", "gt_poses", "scan_ring",
                     "scan_time", "scan_intensity"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), name)
        for name in ("stamps", "gyro", "acce"):
            np.testing.assert_array_equal(getattr(a.imu, name), getattr(b.imu, name))
        np.testing.assert_array_equal(a.gnss.lla, b.gnss.lla)
    for name in ("scans", "imu", "gnss", "gt"):
        assert ((tmp_path / "port" / f"{name}.npz").stat().st_size
                == (tmp_path / "jax" / f"{name}.npz").stat().st_size)


def test_pcd_bytes_equal_jax(tmp_path):
    """Binary and ASCII PCDs (xyz, and the vendor layout with intensity /
    ring / timestamp) byte for byte as the JAX package writes them, and
    read back the same by both readers."""
    rng = np.random.default_rng(5)
    xyz = rng.normal(0, 20, (300, 3)).astype(np.float32)
    extra = {"intensity": rng.uniform(0, 1, 300).astype(np.float32),
             "ring": rng.integers(0, 32, 300).astype(np.uint16),
             "timestamp": 1e9 + np.sort(rng.uniform(0, 0.1, 300))}
    for binary in (True, False):
        for ex in (None, extra):
            p, q = tmp_path / f"p{binary}{ex is None}.pcd", tmp_path / f"j{binary}{ex is None}.pcd"
            pcd.save_pcd(str(p), xyz, binary=binary, extra_fields=ex)
            jpcd.save_pcd(str(q), xyz, binary=binary, extra_fields=ex)
            assert p.read_bytes() == q.read_bytes()
            np.testing.assert_array_equal(pcd.load_pcd(str(q)), jpcd.load_pcd(str(p)))
            full, jfull = pcd.load_pcd_full(str(p)), jpcd.load_pcd_full(str(p))
            assert full.keys() == jfull.keys()
            for k in full:
                np.testing.assert_array_equal(full[k], jfull[k])


def test_kitti_logs_equal_jax(tmp_path):
    """A KITTI velodyne sequence (`.bin` rows, times.txt) and vendor-layout
    PCDs load into the same SensorLog arrays in both packages."""
    rng = np.random.default_rng(6)
    vel = tmp_path / "seq" / "velodyne"
    os.makedirs(vel)
    paths = []
    for k in range(3):
        xyz = rng.uniform(-30, 30, (700, 3)).astype(np.float32)
        xyz[::50] = np.nan
        rows = np.concatenate([xyz, rng.uniform(0, 1, (700, 1)).astype(np.float32)], axis=1)
        rows.tofile(vel / f"{k:06d}.bin")
        p = str(tmp_path / f"v{k}.pcd")
        pcd.save_pcd(p, xyz, extra_fields={
            "intensity": rows[:, 3], "ring": rng.integers(0, 16, 700).astype(np.uint16),
            "timestamp": 50.0 + k * 0.1 + np.sort(rng.uniform(0, 0.1, 700))})
        paths.append(p)
    (tmp_path / "seq" / "times.txt").write_text("".join(f"{0.1 * k:.6f}\n" for k in range(3)))
    (tmp_path / "ts.txt").write_text("2011-09-26 13:02:25.594360375\n"
                                     "2011-09-26 13:02:25.697\n")
    np.testing.assert_array_equal(kitti.load_timestamps(str(tmp_path / "ts.txt")),
                                  jkitti.load_timestamps(str(tmp_path / "ts.txt")))
    for a, b in ((kitti.load_kitti_log(str(vel), capacity=1024, num_rings=16),
                  jkitti.load_kitti_log(str(vel), capacity=1024, num_rings=16)),
                 (kitti.from_vendor_pcd(paths, capacity=1024),
                  jkitti.from_vendor_pcd(paths, capacity=1024))):
        for name in ("scan_stamps", "scan_xyz", "scan_mask", "scan_ring", "scan_time",
                     "scan_intensity"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), name)
        assert a.points_dropped == b.points_dropped
        assert isinstance(a, logdir.SensorLog)


def _poses(rng, n=9, dtype=np.float32):
    T = np.tile(np.eye(4, dtype=dtype), (n, 1, 1))
    T[:, :3, :3] = _random_rotations(rng, n)
    T[:, :3, 3] = rng.normal(0, 30, (n, 3))
    return T


@pytest.mark.parametrize("native_on", [True, False])
def test_kitti_trajectory_bytes_equal_jax(tmp_path, monkeypatch, native_on):
    """KITTI trajectories byte for byte: through the native formatter, and
    through numpy's `%.9g` where there is no toolchain."""
    if not native_on:
        monkeypatch.setattr(native, "format_kitti", lambda poses: None)
        monkeypatch.setattr(jnative, "format_kitti", lambda poses: None)
    T = _poses(np.random.default_rng(7))
    trajectory.save_kitti(str(tmp_path / "p.txt"), T)
    jtrajectory.save_kitti(str(tmp_path / "j.txt"), T)
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    np.testing.assert_array_equal(trajectory.load_kitti(str(tmp_path / "p.txt")),
                                  jtrajectory.load_kitti(str(tmp_path / "j.txt")))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tum_rows_and_interpolation_match_jax(tmp_path, dtype):
    """TUM rows (the port's quaternions on CPU tensors against JAX's)
    parse back within 1e-6 of JAX's rows; load_tum and interp_pose agree
    within 1e-6."""
    rng = np.random.default_rng(8)
    T = _poses(rng, dtype=dtype)
    stamps = np.cumsum(rng.uniform(0.05, 0.15, len(T)))
    trajectory.save_tum(str(tmp_path / "p.txt"), stamps, T)
    jtrajectory.save_tum(str(tmp_path / "j.txt"), stamps, T)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "p.txt"), np.loadtxt(tmp_path / "j.txt"),
                               atol=1.01e-6, rtol=0)
    s, P = trajectory.load_tum(str(tmp_path / "j.txt"))
    js, jP = jtrajectory.load_tum(str(tmp_path / "j.txt"))
    np.testing.assert_array_equal(s, js)
    np.testing.assert_allclose(P, jP, atol=1e-6)
    for q in (stamps[0] - 1.0, stamps[0], 0.5 * (stamps[2] + stamps[3]), stamps[-1] + 0.3):
        a, b = trajectory.interp_pose(stamps, T, q), jtrajectory.interp_pose(stamps, T, q)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, atol=1e-6)
            assert a.dtype == b.dtype


def test_png_bytes_equal_jax(tmp_path):
    """The rendered artifacts byte for byte: the top-down map with a
    trajectory and a reference, the stitched occupancy grid, the
    ScanContext image."""
    rng = np.random.default_rng(9)
    gmap = rng.uniform(-40, 40, (5000, 3)).astype(np.float32)
    traj = np.cumsum(rng.normal(0, 1, (20, 3)), axis=0)
    subs = [(rng.integers(117, 138, (60, 60)), 0.3 * i, np.array([2.0 * i, -1.0 * i]))
            for i in range(3)]
    desc = rng.uniform(0, 3, (20, 60)).astype(np.float32)
    imgs = [(viz.render_map_topdown(gmap, traj, traj + 0.5, image_size=256),
             jviz.render_map_topdown(gmap, traj, traj + 0.5, image_size=256)),
            (viz.render_occupancy_global(subs, resolution=10.0, traj_xy=traj[:, :2]),
             jviz.render_occupancy_global(subs, resolution=10.0, traj_xy=traj[:, :2])),
            (viz.render_scan_context(desc), jviz.render_scan_context(desc))]
    for k, (a, b) in enumerate(imgs):
        np.testing.assert_array_equal(a, b)
        viz.write_png(str(tmp_path / f"p{k}.png"), a)
        jviz.write_png(str(tmp_path / f"j{k}.png"), b)
        data = (tmp_path / f"p{k}.png").read_bytes()
        assert data == (tmp_path / f"j{k}.png").read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(ValueError, match="uint8"):
        viz.write_png(str(tmp_path / "x.png"), np.zeros((4, 4), np.float32))


def _lio_state():
    opts = lio.LioOptions(icp=icp.IcpOptions(method="p2plane_vox"), scan_capacity=256,
                          num_kfs_in_local_map=2)
    return lio.init_state(opts, device="cpu"), opts


def test_state_checkpoint_round_trip(tmp_path):
    """A LioState (nested NamedTuples, None leaves, host ints) round-trips
    through one npz keyed by dotted field paths, onto `like`'s device with
    its dtypes; the step rides along."""
    state, _ = _lio_state()
    rng = np.random.default_rng(10)
    state = state._replace(t=torch.from_numpy(rng.normal(0, 1, 3).astype(np.float32)),
                           num_kfs=5, frame_idx=17)
    path = checkpoint.save_state(str(tmp_path / "lio"), state, step=7)
    with np.load(path) as z:
        assert {"eskf.cov", "icp_target.grid.voxel_keys", "num_kfs", "__step__"} <= set(z.files)
        assert not any(k.startswith("ndt_map") for k in z.files)
    like, _ = _lio_state()
    got, step = checkpoint.load_state(path, like)
    assert step == 7 and got.num_kfs == 5 and got.frame_idx == 17
    assert got.ndt_map is None and got.loam_target is None
    flat, want = {}, {}
    checkpoint._flatten(got, "", flat)
    checkpoint._flatten(state, "", want)
    assert flat.keys() == want.keys()
    for k in flat:
        np.testing.assert_array_equal(flat[k], want[k], k)
        assert flat[k].dtype == want[k].dtype
    assert isinstance(got.eskf, eskf.EskfState) and got.eskf.cov.device.type == "cpu"


def test_checkpoint_shape_mismatch_raises(tmp_path):
    state, opts = _lio_state()
    path = checkpoint.save_state(str(tmp_path / "lio"), state)
    bigger = lio.init_state(dataclasses.replace(opts, scan_capacity=512), device="cpu")
    with pytest.raises(ValueError, match="options/capacities differ from the saving run"):
        checkpoint.load_state(path, bigger)


def test_checkpointer_rolling_gc(tmp_path):
    ck = checkpoint.Checkpointer(str(tmp_path), max_to_keep=2)
    assert ck.latest() is None
    s = eskf.init_state(device="cpu")
    for step in (1, 2, 3):
        ck.save(step, s._replace(time=torch.tensor(float(step))))
    assert ck.latest() == 3
    got, step = ck.restore(s)
    assert step == 3 and float(got.time) == 3.0
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000002.npz", "ckpt_00000003.npz"]
    got, step = ck.restore(s, step=2)
    assert float(got.time) == 2.0
    with pytest.raises(FileNotFoundError):
        checkpoint.Checkpointer(str(tmp_path / "empty")).restore(s)


@pytest.mark.parametrize("fmt", ["npz", "pcd"])
def test_keyframe_store_resume_matches_jax(tmp_path, fmt):
    """A store reopened over its directory continues; the assembled map
    equals the JAX store's on the same keyframes."""
    from loc_lib_tpu.io import checkpoint as jckpt
    rng = np.random.default_rng(11)
    clouds = [rng.uniform(-5, 5, (200, 3)).astype(np.float32) for _ in range(3)]
    poses = _poses(rng, 3)
    st = checkpoint.KeyframeStore(str(tmp_path / "p"), fresh=True, fmt=fmt)
    js = jckpt.KeyframeStore(str(tmp_path / "j"), fresh=True, fmt=fmt)
    for c, T in zip(clouds[:2], poses[:2]):
        st.append(c, T)
        js.append(c, T)
    st = checkpoint.KeyframeStore(str(tmp_path / "p"), fmt=fmt)
    assert len(st) == 2
    st.append(clouds[2], poses[2])
    js.append(clouds[2], poses[2])
    for vs in (0.0, 0.5):
        np.testing.assert_array_equal(st.assemble_global_map(vs), js.assemble_global_map(vs))
    assert json.loads((tmp_path / "p" / "manifest.json").read_text())["count"] == 3
    assert len(checkpoint.KeyframeStore(str(tmp_path / "p"), fresh=True, fmt=fmt)) == 0


def test_timing_instruments(tmp_path):
    tt = timing.TicToc()
    assert tt.toc() >= 0.0
    assert tt.toc(block_on=torch.zeros(3)) >= 0.0
    calls = []
    mean = timing.evaluate_and_call(lambda: calls.append(1) or torch.zeros(3), "noop",
                                    times=3, warmup=1)
    assert mean >= 0.0 and len(calls) == 4
    st = timing.StageTimer()
    for _ in range(2):
        with st.stage("a", block_on=(torch.ones(2), [torch.zeros(1)])):
            pass
    assert st.counts["a"] == 2 and set(st.report()) == {"a"} and st.mean_ms("b") == 0.0
    tree = (torch.ones(2), {"x": torch.zeros(1)})
    assert timing.block_until_ready(tree) is tree
    with timing.trace(str(tmp_path), name="probe"):
        torch.ones(8).sum()
    assert (tmp_path / "probe.json").stat().st_size > 0
    with timing.trace():
        torch.ones(8).sum()


SLAM_YAML = """
# slam.yaml-style
lio_mapping:
  matching_method: 2        # ndt
  icp_option:
    method: 1
    max_iteration: 15
    max_nn_distance: 0.8
    eps: 0.005
  ndt_option:
    method: 1               # incremental
    voxel_size: 0.8
    nearby_type: 0
    res_outlier_th: 15.0
  lio_option:
    kf_distance: 0.7
    kf_angle_deg: 20
    num_kfs_in_local_map: 6
    cur_scan_filter_size: 0.6
    with_eskf: false
  imu_lidar:
    roll: 1.5
    pitch: -2.0
    yaw: 90
    x: 0.1
    y: -0.2
    z: 0.3
lio_matching:
  matching_method: 0
  box_filter_size: [120.0, 120.0, 60.0]
  scan_filter_size: 0.4
  name: 'demo'
"""


def _same_options(a, b, path=""):
    """Field by field over nested option dataclasses of the two packages."""
    fa = [f.name for f in dataclasses.fields(a)]
    assert fa == [f.name for f in dataclasses.fields(b)], path
    for name in fa:
        x, y = getattr(a, name), getattr(b, name)
        if dataclasses.is_dataclass(x):
            _same_options(x, y, f"{path}{name}.")
        else:
            assert x == y and type(x) is type(y), (f"{path}{name}", x, y)


def test_config_parsers_and_options_match_jax(tmp_path):
    """The fallback parser gives PyYAML's tree on a slam.yaml-style text;
    lio_options / loc_options / extrinsic_from_config equal JAX's field by
    field (the extrinsic within 1e-6)."""
    import yaml
    assert config._mini_yaml(SLAM_YAML) == yaml.safe_load(SLAM_YAML)
    assert config._mini_yaml(SLAM_YAML) == jconfig._mini_yaml(SLAM_YAML)
    p = tmp_path / "slam.yaml"
    p.write_text(SLAM_YAML)
    cfg, jcfg = config.Config.from_file(str(p)), jconfig.Config.from_file(str(p))
    assert cfg.get("lio_matching/name") == "demo" and cfg.get("a/b", 3) == 3
    for c in (cfg, config.Config(config._mini_yaml(SLAM_YAML)), config.Config({})):
        j = jconfig.Config(c.tree)
        _same_options(config.lio_options(c), jconfig.lio_options(j))
        _same_options(config.loc_options(c), jconfig.loc_options(j))
        R, t = config.extrinsic_from_config(c)
        jR, jt = jconfig.extrinsic_from_config(j)
        assert isinstance(R, np.ndarray) and R.dtype == np.float32
        np.testing.assert_allclose(R, np.asarray(jR), atol=1e-6)
        np.testing.assert_array_equal(t, jt)
    assert config.lio_options(cfg).matcher == "ndt_inc"
    assert config.loc_options(cfg).box_size == 120.0
