"""Port parity: loc_lib_tpu_torch.pipeline.slam3d (3D SLAM: LIO, ScanContext
loop detection, batched loop registration, the two-phase pose graph and the
write-back) against the JAX package, on tests/test_slam3d.py's workloads.

A free run through both packages can accept different loops: a 1-ulp nudge
moves JAX's own LIO run by centimetres (test_torch_lio.py). So the parity
tests come in two kinds:
  * strict, on a keyframe archive carried across from JAX: JAX's keyframe
    clouds and poses are fed to both packages' loop machinery keyframe by
    keyframe. Candidates per keyframe and the accepted loop pairs equal
    JAX's; loop measurements within 1e-4 m / 1e-4 rad with equal effective
    counts (the targets are built by each package from the same cloud:
    test_torch_icp_batch.py's rule); optimize() on JAX's loop edges: poses
    within twice the change a 1-ulp nudge of the archive poses makes in
    JAX's own optimize() (test_torch_pose_graph.py's method), the same
    inlier mask;
  * loose, one free run: the same keyframe count, at least one inlier loop
    in both, ATE after the pose graph within 1 cm of JAX's (measured 2 mm).
"""
import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loc_lib_tpu.eval import metrics as jmetrics
from loc_lib_tpu.graph import pose_graph as jpg, scan_context as jsc
from loc_lib_tpu.models import icp as jicp
from loc_lib_tpu.ops.pointcloud import PointCloud as JPointCloud
from loc_lib_tpu.pipeline import lio as jlio, slam3d as jslam
from loc_lib_tpu.utils import lie as jlie
from loc_lib_tpu_torch.eval import metrics
from loc_lib_tpu_torch.graph import pose_graph as pg, scan_context as sc
from loc_lib_tpu_torch.io import logdir
from loc_lib_tpu_torch.models import icp
from loc_lib_tpu_torch.ops.pointcloud import PointCloud
from loc_lib_tpu_torch.pipeline import lio, slam3d

torch.set_num_threads(2)


def _loop_log(num_frames=46):
    """test_slam3d.py's closed circle (yaw_rate * dt * frames > 2 pi)."""
    return logdir.make_demo_log(num_frames=num_frames, capacity=512, dt=0.2, speed=1.4,
                                yaw_rate=0.72, world_points=40000, with_imu=True,
                                extent=16.0, max_range=14.0)


def _opts(L, I, S, mod):
    """test_slam3d.py's _small_opts with its batched-registration changes
    (:200): sc_topk 3, a 0.33 retrieval gate, p2plane_vox loop
    registration on (64, 64, 32) dense tables."""
    return mod.Slam3dOptions(
        lio=L.LioOptions(matcher="icp", icp=I.IcpOptions(method="p2plane", max_iteration=8,
                                                         bucket_size=4),
                         scan_capacity=512, num_kfs_in_local_map=3, with_eskf=True,
                         kf_distance=0.4),
        sc=S.ScanContextOptions(exclude_recent=8, dist_threshold=0.33),
        loop=mod.LoopOptions(min_keyframe_gap=8, max_candidate_dist=10.0, min_effective_pts=60,
                             max_chi2_per_pt=0.1, optimize_every=100, sc_topk=3),
        loop_icp=I.IcpOptions(method="p2plane_vox", max_iteration=20, max_plane_distance=0.5,
                              grid_leaf=2.0, bucket_size=8, plane_min_pts=4,
                              dense_dims=(64, 64, 32)))


def _jax_opts():
    return dataclasses.replace(_opts(jlio, jicp, jsc, jslam), warm_start=False)


def _port_opts():
    return _opts(lio, icp, sc, slam3d)


def _kf_ate(eng, log, m):
    return m.ate(eng.keyframe_poses(), log.gt_poses[np.asarray(eng.kf_frame)]).rmse


@pytest.fixture(scope="module")
def log():
    return _loop_log()


@pytest.fixture(scope="module")
def jax_run(log):
    """JAX's free run, its keyframe archive as the loop machinery saw it
    (before the final optimize), and its ATE before / after."""
    eng = jslam.Slam3d(_jax_opts())
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150], log.imu.acce[:150]):
        eng.init_imu(g, a, t)
    for mg in log.measures(imu_capacity=64):
        eng.add_measure(JPointCloud(xyz=jnp.asarray(log.scan_xyz[mg.scan_index]),
                                    mask=jnp.asarray(log.scan_mask[mg.scan_index])),
                        jnp.asarray(mg.imu_gyro), jnp.asarray(mg.imu_acce),
                        jnp.asarray(mg.imu_stamp), jnp.asarray(mg.imu_valid))
    archive = dict(xyz=list(eng.kf_xyz), mask=list(eng.kf_mask),
                   R=[r.copy() for r in eng.kf_R], t=[t.copy() for t in eng.kf_t])
    before = _kf_ate(eng, log, jmetrics)
    assert eng.optimize()
    return {"engine": eng, "archive": archive, "before": before,
            "after": _kf_ate(eng, log, jmetrics)}


class _Keyframe:
    """The StepResult fields Slam3d._after_step reads, for a keyframe."""

    def __init__(self, R, t, as_array):
        self.R, self.t, self.is_keyframe = as_array(R), as_array(t), True


def _replay(eng, archive, cloud, as_array):
    """Feed the archive to `eng` keyframe by keyframe through its own
    _after_step (descriptor insert, detection, registration), recording
    each keyframe's gated candidates."""
    cands = []
    detect = eng._detect

    def spy(scan, kf_id):
        cands.append(detect(scan, kf_id))
        return cands[-1]

    eng._detect = spy
    for xyz, mask, R, t in zip(archive["xyz"], archive["mask"], archive["R"], archive["t"]):
        eng._after_step(cloud(xyz, mask), _Keyframe(R, t, as_array))
    return cands


def test_slam3d_defaults_to_the_card():
    """Slam3d (and its descriptor DB) go to the card unless the caller names
    a device; without a card they raise instead of using the CPU."""
    if torch.cuda.is_available():
        assert slam3d.Slam3d().device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            slam3d.Slam3d()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sc.ScanContextDb(capacity=4)
    eng = slam3d.Slam3d(_port_opts(), device="cpu")
    assert eng.scdb.desc.device.type == "cpu" and eng.lio.state.R.device.type == "cpu"


def test_loop_registration_and_optimize_match_jax_on_a_carried_archive(jax_run):
    """The strict test (module docstring): both packages' loop machinery on
    JAX's keyframe archive. At least one keyframe takes the batched
    registration (several candidates)."""
    archive = jax_run["archive"]
    jeng = jslam.Slam3d(_jax_opts())
    jcands = _replay(jeng, archive, lambda x, m: JPointCloud(xyz=jnp.asarray(x),
                                                             mask=jnp.asarray(m)), jnp.asarray)
    teng = slam3d.Slam3d(_port_opts(), device="cpu")
    tcands = _replay(teng, archive, lambda x, m: PointCloud(xyz=torch.tensor(x),
                                                            mask=torch.tensor(m)),
                     lambda a: torch.tensor(np.asarray(a)))
    assert tcands == jcands
    assert max(len(c) for c in tcands) > 1
    assert [(l.i, l.j) for l in teng.loops] == [(l.i, l.j) for l in jeng.loops]
    assert len(teng.loops) >= 1
    for a, b in zip(teng.loops, jeng.loops):
        assert a.num_effective == b.num_effective
        np.testing.assert_allclose(a.t, b.t, atol=1e-4)
        np.testing.assert_allclose(a.R, b.R, atol=1e-4)
        np.testing.assert_allclose(a.chi2_per_pt, b.chi2_per_pt, rtol=1e-3)
    # the pose graph on JAX's loop edges (the measurements differ by the
    # registrations' rounding, held above); JAX's own sensitivity from a copy
    # whose archive poses moved by one ulp
    teng.loops = [slam3d.LoopEdge(*edge) for edge in jeng.loops]
    nudged = copy.copy(jeng)
    nudged.kf_R = [np.nextafter(r, np.float32(np.inf)) for r in jeng.kf_R]
    nudged.kf_t = [np.nextafter(t, np.float32(np.inf)) for t in jeng.kf_t]
    nudged.lio = copy.copy(jeng.lio)
    assert teng.optimize() and jeng.optimize() and nudged.optimize()
    np.testing.assert_array_equal(teng.loop_inliers, jeng.loop_inliers)
    self_gap = np.abs(np.stack(nudged.kf_t) - np.stack(jeng.kf_t)).max()
    port_gap = np.abs(np.stack(teng.kf_t) - np.stack(jeng.kf_t)).max()
    assert 0 < self_gap and port_gap <= 2 * self_gap, (port_gap, self_gap)
    self_rot = np.abs(np.stack(nudged.kf_R) - np.stack(jeng.kf_R)).max()
    port_rot = np.abs(np.stack(teng.kf_R) - np.stack(jeng.kf_R)).max()
    assert port_rot <= 2 * self_rot, (port_rot, self_rot)
    assert teng.cg_iterations > 0


def test_slam3d_free_run_closes_the_loop_like_jax(log, jax_run):
    """The loose test (module docstring): the port's free run on the same
    log keeps JAX's keyframe count, accepts at least one inlier loop,
    lowers the keyframe ATE with the pose graph, and ends within 1 cm of
    JAX's ATE; the corrected front end and the global map follow."""
    jeng = jax_run["engine"]
    eng = slam3d.Slam3d(_port_opts(), device="cpu")
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150], log.imu.acce[:150]):
        eng.init_imu(g, a, t)
    assert eng.imu_inited
    for mg in log.measures(imu_capacity=64):
        eng.add_measure(log.frame(mg.scan_index, "cpu"), mg.imu_gyro, mg.imu_acce,
                        mg.imu_stamp, mg.imu_valid)
    assert len(eng.kf_R) == len(jeng.kf_R)
    before = _kf_ate(eng, log, metrics)
    last_R, last_t = eng.kf_R[-1].copy(), eng.kf_t[-1].copy()
    assert eng.optimize()
    after = _kf_ate(eng, log, metrics)
    assert int(eng.loop_inliers.sum()) >= 1 and int(jeng.loop_inliers.sum()) >= 1
    assert after < before and jax_run["after"] < jax_run["before"]
    assert abs(after - jax_run["after"]) < 0.01, (after, jax_run["after"])
    # the live front end moved with its last keyframe
    dR = eng.kf_R[-1] @ last_R.T
    np.testing.assert_allclose(eng.lio.state.last_kf_R.numpy(), dR @ last_R, atol=1e-5)
    np.testing.assert_allclose(eng.lio.state.last_kf_t.numpy(),
                               dR @ last_t + (eng.kf_t[-1] - dR @ last_t), atol=1e-4)
    gmap = eng.assemble_global_map(voxel_size=0.3)
    assert gmap.shape[1] == 3 and 1000 < len(gmap) < 512 * len(eng.kf_R)
    assert eng.keyframe_poses().shape == (len(eng.kf_R), 4, 4)


def test_pose_graph_closes_synthetic_drift():
    """test_slam3d.py:78 in the port: a drifted circle plus one perfect loop
    edge snaps closed (the good loop survives the gates); the loop end lands
    within 0.1 m of the measured relative pose, as in JAX."""
    m = 24
    ang = np.linspace(0, 2 * np.pi, m, endpoint=False)
    gt_t = np.stack([5.0 * np.cos(ang), 5.0 * np.sin(ang), np.zeros(m)], 1).astype(np.float32)
    drift = np.linspace(0, 0.25, m).astype(np.float32)
    gt_R = np.stack([np.asarray(jlie.so3_exp(jnp.array([0, 0, a], jnp.float32))) for a in ang])
    est_R = np.stack([np.asarray(jlie.so3_exp(jnp.array([0, 0, a + d], jnp.float32)))
                      for a, d in zip(ang, drift)])
    est_t = gt_t + np.stack([drift * 3.0, drift * 2.0, 0 * drift], 1)
    Rl = gt_R[0].T @ gt_R[-1]
    tl = gt_R[0].T @ (gt_t[-1] - gt_t[0])
    loop = pg.Se3Edges(i=np.array([0], np.int32), j=np.array([m - 1], np.int32),
                       R=Rl[None].astype(np.float32), t=tl[None].astype(np.float32),
                       info=np.eye(6, dtype=np.float32)[None] * 1e4,
                       is_loop=np.array([True]), valid=np.array([True]))
    edges = pg.concat_edges_np(pg.odometry_edges_np(est_R, est_t), loop)
    R, t, inl = pg.optimize_two_phase(torch.from_numpy(est_R), torch.from_numpy(est_t), edges)
    _, jt, jinl = jpg.optimize_two_phase(jnp.asarray(est_R), jnp.asarray(est_t),
                                         jpg.Se3Edges(*map(jnp.asarray, edges)))
    assert bool(inl[-1]) and bool(jinl[-1])
    R, t = R.numpy(), t.numpy()
    np.testing.assert_allclose(R[0].T @ (t[-1] - t[0]), tl, atol=0.1)
    np.testing.assert_allclose(t, np.asarray(jt), atol=1e-3)


def test_loop_edge_info_quality_weighting():
    """test_slam3d.py:118 in the port: cleaner / larger fits earn more
    weight, clipped to the cap; the constant mode; equal to JAX's."""
    lo, jlo = slam3d.LoopOptions(), jslam.LoopOptions()
    clean = slam3d.loop_edge_info(2000, 0.005, lo)
    sloppy = slam3d.loop_edge_info(250, 0.05, lo)
    assert clean > sloppy and clean <= lo.loop_info_scale and sloppy >= lo.loop_info_min
    assert slam3d.loop_edge_info(5000, 1e-12, lo) == lo.loop_info_scale
    const = dataclasses.replace(lo, use_quality_info=False)
    assert slam3d.loop_edge_info(10, 1.0, const) == const.loop_info_scale
    for n, c in ((2000, 0.005), (250, 0.05), (5000, 1e-12), (10, 1.0), (300, 2.0)):
        assert slam3d.loop_edge_info(n, c, lo) == jslam.loop_edge_info(n, c, jlo)


def _drifted_circle(mod, eng):
    """test_slam3d.py:136's hand-filled archive: a drifted circle plus one
    PERFECT loop edge, put into `eng` (either package)."""
    m = 24
    ang = np.linspace(0, 2 * np.pi, m, endpoint=False)
    gt_t = np.stack([5.0 * np.cos(ang), 5.0 * np.sin(ang), np.zeros(m)], 1).astype(np.float32)
    gt_R = np.stack([np.asarray(jlie.so3_exp(jnp.array([0, 0, a], jnp.float32))) for a in ang])
    drift = np.linspace(0, 0.25, m).astype(np.float32)
    est_R = np.stack([np.asarray(jlie.so3_exp(jnp.array([0, 0, a + d], jnp.float32)))
                      for a, d in zip(ang, drift)])
    est_t = gt_t + np.stack([drift * 3.0, drift * 2.0, 0 * drift], 1)
    eng.kf_R = [est_R[i] for i in range(m)]
    eng.kf_t = [est_t[i].copy() for i in range(m)]
    Rl = gt_R[0].T @ gt_R[-1]
    tl = (gt_R[0].T @ (gt_t[-1] - gt_t[0])).astype(np.float32)
    eng.loops.append(mod.LoopEdge(i=0, j=m - 1, R=Rl, t=tl, chi2_per_pt=1e-3,
                                  num_effective=500))
    return tl


def test_slam3d_optimize_bucketed_layout():
    """test_slam3d.py:163 in the port: Slam3d.optimize's fixed layout (nodes
    padded to the 32-bucket, odometry to 31 rows, loops at rows [31, 32)
    padded to 512) closes the drifted circle like the raw solve, the inlier
    slice indexes the real loop edge, and the poses equal JAX's Slam3d's
    within 1e-3 m / 1e-4 (the raw-solve bound above)."""
    eng = slam3d.Slam3d(_port_opts(), device="cpu")
    tl = _drifted_circle(slam3d, eng)
    jeng = jslam.Slam3d(_jax_opts())
    _drifted_circle(jslam, jeng)
    assert eng._solver_shape(len(eng.kf_R)) == jeng._solver_shape(len(jeng.kf_R), 1) == (32, 512)
    edges = eng._build_edges(32, 512)
    assert len(edges.i) == 31 + 512 and edges.is_loop[31] and not edges.is_loop[32:].any()
    assert eng.optimize() and jeng.optimize()
    assert eng.loop_inliers.shape == (1,) and bool(eng.loop_inliers[0])
    R0, t0 = eng.kf_R[0], eng.kf_t[0]
    np.testing.assert_allclose(R0.T @ (eng.kf_t[-1] - t0), tl, atol=0.1)
    np.testing.assert_allclose(np.stack(eng.kf_t), np.stack(jeng.kf_t), atol=1e-3)
    np.testing.assert_allclose(np.stack(eng.kf_R), np.stack(jeng.kf_R), atol=1e-4)
    # nothing to optimize: no loops, or under two keyframes
    empty = slam3d.Slam3d(_port_opts(), device="cpu")
    assert not empty.optimize() and empty.keyframe_poses().shape == (0, 4, 4)
    assert empty.assemble_global_map().shape == (0, 3)
    assert [slam3d.Slam3d._bucketed(n) for n in (0, 16, 17, 45, 512)] == [16, 16, 32, 64, 512]
