"""Port parity: LOAM (loc_lib_tpu_torch.models.loam, io/synthetic.annotate_rings
and the LIO matcher "loam") against the JAX package.

Stated tolerances:
  * annotate_rings: bit-identical (the same numpy program);
  * extract_features: edge and surf masks equal, except where a mismatch is
    explained by a decision within 8 float32 ulp (a curvature against the
    0.1 threshold, against another curvature of its +-5 ring window, or
    against another candidate of its (ring, sector)), or lies within +-5
    ring neighbours of such an edge (the suppression that follows from it).
    XLA:CPU may fuse the stencil's -2 r xyz + sum of shifts into FMAs, so
    the two curvatures can differ by an ulp. Measured: 0 mismatches on both
    workloads;
  * loam.scan_match on a target carried across from JAX: poses within
    2e-6 m / 2e-6 rad (measured 6e-7 m), equal iterations and counts;
  * one LIO "loam" step per frame on a carried-across state: keyframe
    flags, iterations and counts equal, poses within 1e-5 m / 1e-5 rad,
    chi2 within rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loc_lib_tpu.io import logdir as jlogdir, replay as jreplay, synthetic as jsyn
from loc_lib_tpu.models import loam as jloam
from loc_lib_tpu.ops import pointcloud as jpc
from loc_lib_tpu.pipeline import lio as jlio
from loc_lib_tpu_torch.io import convert, logdir, synthetic
from loc_lib_tpu_torch.models import loam
from loc_lib_tpu_torch.ops import pointcloud as pcm
from loc_lib_tpu_torch.pipeline import lio
import oracles

torch.set_num_threads(2)


def _from_numpy(*args, **kwargs):
    """pointcloud.from_numpy on the CPU (its default device is the card)."""
    return pcm.from_numpy(*args, device="cpu", **kwargs)

ULP = 2.0 ** -23


def _l_shaped_rings(n_rings=8, n_per=400, noise=0.002, seed=0):
    """tests/test_loam.py's L-shaped wall profile per ring."""
    rng = np.random.default_rng(seed)
    xyz, ring = [], []
    half = n_per // 2
    for r in range(n_rings):
        z = 0.2 * r
        leg1 = np.stack([np.linspace(0, 10, half), np.zeros(half), np.full(half, z)], 1)
        leg2 = np.stack([np.full(half, 10.0), np.linspace(0, 10, half), np.full(half, z)], 1)
        pts = np.concatenate([leg1, leg2])
        pts += rng.normal(0, noise, pts.shape)
        xyz.append(pts)
        ring.append(np.full(n_per, r, np.int32))
    return np.concatenate(xyz).astype(np.float32), np.concatenate(ring).astype(np.int32)


def _rendered(k, capacity=8192):
    """tests/test_loam.py:83's scene: a rendered 8192-point scan, rings
    annotated by each package."""
    world = jsyn.make_world(num_points=120000, extent=40.0, seed=3)
    traj = jsyn.make_trajectory(num_frames=2, dt=0.1, speed=2.0)
    pc = synthetic.render_scan(world, traj.R[k], traj.t[k], max_points=capacity, noise=0.01,
                               seed=k, capacity=capacity, device="cpu")
    jp = jsyn.render_scan(world, traj.R[k], traj.t[k], max_points=capacity, noise=0.01,
                          seed=k, capacity=capacity)
    return jsyn.annotate_rings(jp, num_rings=16), synthetic.annotate_rings(pc, num_rings=16,
                                                                          device="cpu")


@pytest.mark.parametrize("k", [0, 1])
def test_annotate_rings_is_bit_identical(k):
    jr, tr = _rendered(k)
    assert tr.ring is not None and tr.device.type == "cpu"
    np.testing.assert_array_equal(tr.xyz.numpy(), np.asarray(jr.xyz))
    np.testing.assert_array_equal(tr.mask.numpy(), np.asarray(jr.mask))
    np.testing.assert_array_equal(tr.ring.numpy(), np.asarray(jr.ring))
    assert tr.mask.sum() > 4000 and int(tr.ring.max()) == 15


def _sorted_view(pc, opts):
    """The port's curvature and decision quantities in ring-sorted order."""
    ring_key = torch.where(pc.mask, pc.ring, 1 << 20)
    order = torch.argsort(ring_key, stable=True)
    xyz = pc.xyz[order].double().numpy()
    ring = ring_key[order].numpy()
    r = opts.suppress_radius
    acc = -2.0 * r * xyz
    for s in range(-r, r + 1):
        if s:
            acc = acc + np.roll(xyz, -s, axis=0)
    return order.numpy(), ring, np.sum(acc * acc, axis=1)


def _unexplained(pc, opts, j_edge, j_surf, t_edge, t_surf):
    """Mask mismatches not explained by a near-tie decision (module
    docstring). Returns (count of mismatches, count unexplained)."""
    order, ring, curv = _sorted_view(pc, opts)
    n, r = len(order), opts.suppress_radius
    je, js, te, ts = (np.asarray(m)[order] for m in (j_edge, j_surf, t_edge, t_surf))
    tol = 8 * ULP * np.maximum(curv, opts.edge_curvature_th)
    near = np.abs(curv - opts.edge_curvature_th) <= tol
    for s in range(-r, r + 1):
        if s:
            same = np.roll(ring, -s) == ring
            near |= same & (np.abs(curv - np.roll(curv, -s)) <= tol)
    cand = (te | je)
    for i in np.flatnonzero(je != te):
        peers = cand & (ring == ring[i])
        near[i] |= bool(np.any(np.abs(curv[peers] - curv[i]) <= tol[i]) and peers.sum() > 1)
    edge_bad = (je != te)
    explained_edge = edge_bad & near
    spread = explained_edge.copy()
    for s in range(-r, r + 1):
        if s:
            spread |= np.roll(explained_edge, s) & (np.roll(ring, s) == ring)
    surf_bad = (js != ts)
    unexplained = (edge_bad & ~near).sum() + (surf_bad & ~spread).sum()
    return int(edge_bad.sum() + surf_bad.sum()), int(unexplained)


@pytest.mark.parametrize("scene", ["l_shaped", "rendered"])
def test_extract_features_matches_jax(scene):
    if scene == "l_shaped":
        xyz, ring = _l_shaped_rings()
        jr = jpc.from_numpy(xyz, capacity=4096, ring=ring)
        tr = _from_numpy(xyz, capacity=4096, ring=ring)
        jo, to = jloam.LoamFeatureOptions(num_scan=8), loam.LoamFeatureOptions(num_scan=8)
    else:
        jr, tr = _rendered(0)
        jo = jloam.LoamFeatureOptions(num_scan=16, min_ring_pts=64)
        to = loam.LoamFeatureOptions(num_scan=16, min_ring_pts=64)
    jf = jloam.extract_features(jr, jo)
    tf = loam.extract_features(tr, to)
    te, ts = tf.edge.mask.numpy(), tf.surf.mask.numpy()
    # the L-shaped rings have one corner each (test_loam.py: edges there)
    assert te.sum() >= (8 if scene == "l_shaped" else 20)
    assert ts.sum() > 1000 and not (te & ts).any()
    np.testing.assert_array_equal(tf.edge.xyz.numpy(), np.asarray(jf.edge.xyz))
    total, bad = _unexplained(tr, to, jf.edge.mask, jf.surf.mask, te, ts)
    assert bad == 0, (total, bad)
    assert total <= 0.01 * int(tr.mask.sum()), total


def _line_scene(seed=2):
    """Poles, rails and a floor: lines along z, x and y, plus a plane."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(12):
        c = rng.uniform(-12, 12, 2)
        parts.append(np.stack([np.full(150, c[0]), np.full(150, c[1]),
                               rng.uniform(0, 4, 150)], 1))
    for y in (-6.0, 0.0, 6.0):
        parts.append(np.stack([rng.uniform(-12, 12, 400), np.full(400, y), np.full(400, 2.5)], 1))
    parts.append(np.stack([np.full(400, 3.0), rng.uniform(-12, 12, 400), np.full(400, 1.0)], 1))
    parts.append(np.stack([rng.uniform(-12, 12, 600), rng.uniform(-12, 12, 600),
                           np.zeros(600)], 1))
    pts = np.concatenate(parts)
    return (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)


def test_line_table_matches_jax():
    """p2line_vox target tables: keys and mu as the plane tables are held
    (test_torch_icp.py); validity equal except where the line_ratio gate is
    within 1e-4 relative; where the principal eigen-gap is large, |d . d_jax|
    >= 1 - 1e-6; the projector W W^T equals I - d d^T within 1e-4 on every
    valid voxel (the float32 closed-form eigenvectors are orthonormal only
    to that order: measured max 3.7e-5 in JAX's own table, 3.2e-5 in the
    port's), and the two packages' projectors agree within 1e-3 (the
    cross-section basis v0, v1 is free up to a rotation)."""
    from loc_lib_tpu.models import icp as jicp
    from loc_lib_tpu_torch.models import icp

    pts = _line_scene()
    jo = jicp.IcpOptions(method="p2line_vox", dense_dims=(64, 64, 32))
    to = icp.IcpOptions(method="p2line_vox", dense_dims=(64, 64, 32))
    jt = jicp.set_target(jpc.from_numpy(pts, capacity=8192), jo)
    tt = icp.set_target(_from_numpy(pts, capacity=8192), to)
    np.testing.assert_array_equal(tt.grid.voxel_keys.numpy(), np.asarray(jt.grid.voxel_keys))
    jp, tp = np.asarray(jt.line_packed), tt.line_packed.numpy()
    np.testing.assert_allclose(tp[:, 0:3], jp[:, 0:3], atol=1e-5)
    jv, tv = jp[:, 12] > 0.5, tp[:, 12] > 0.5
    assert jv.sum() >= 30
    # the gate margin, from the port's merged moments in float64
    n, mu, cov, _ = icp._merged_moments(to, tt.dense, _stats(pts, to))
    vals = np.linalg.eigvalsh(cov.numpy().astype(np.float64))
    margin = np.abs(vals[:, 2] - 3.0 * (vals[:, 0] + vals[:, 1])) / np.maximum(vals[:, 2], 1e-30)
    assert ((jv != tv) <= (margin < 1e-4)).all()
    both = jv & tv
    jd, td = np.asarray(jt.line_dir)[both], tt.line_dir.numpy()[both]
    gap = (vals[:, 2] - vals[:, 1])[both] / np.maximum(vals[both, 2], 1e-30)
    big = gap > 0.5
    assert big.sum() >= 20
    assert (np.abs(np.sum(jd * td, axis=1))[big] >= 1 - 1e-6).all()
    W = tp[:, 3:12].reshape(-1, 3, 3)[both].astype(np.float64)
    P = W @ np.swapaxes(W, 1, 2)
    np.testing.assert_allclose(P, np.eye(3) - td[:, :, None] * td[:, None, :], atol=1e-4)
    Wj = jp[:, 3:12].reshape(-1, 3, 3)[both].astype(np.float64)
    np.testing.assert_allclose(P[big], (Wj @ np.swapaxes(Wj, 1, 2))[big], atol=1e-3)
    assert not tp[~tv, 3:13].any()


def _stats(pts, to):
    from loc_lib_tpu_torch.ops import voxel
    _, st = voxel.build_hash_grid_with_stats(_from_numpy(pts, capacity=8192), to.grid_leaf,
                                             to.bucket_size)
    return st


def _pose_gap(Ra, ta, Rb, tb):
    rot = np.linalg.norm(oracles.so3_log(np.asarray(Ra, np.float64).T
                                         @ np.asarray(Rb, np.float64)))
    return float(np.linalg.norm(np.asarray(ta) - np.asarray(tb))), rot


def test_loam_scan_match_matches_jax_on_carried_target():
    """test_loam.py:83's pair: JAX builds the edge (line) and surf (plane)
    targets; both packages run the joint Gauss-Newton loop on them."""
    fo_j = jloam.LoamFeatureOptions(num_scan=16, min_ring_pts=64)
    fo_t = loam.LoamFeatureOptions(num_scan=16, min_ring_pts=64)
    jf, tf = [], []
    for k in range(2):
        jr, tr = _rendered(k)
        jf.append(jloam.extract_features(jr, fo_j))
        tf.append(loam.extract_features(tr, fo_t))
    jo, to = jloam.LoamOption(), loam.LoamOption()
    jt = jloam.set_target(jf[0].edge, jf[0].surf, jo)
    tt = convert.loam_target_from_numpy(jax.tree_util.tree_map(np.asarray, jt)._asdict(), "cpu")
    assert tt.edge.line_packed is not None and tt.surf.packed is not None
    jres = jloam.scan_match(jt, jo, jf[1].edge, jf[1].surf, jnp.eye(3), jnp.zeros(3))
    tres = loam.scan_match(tt, to, tf[1].edge, tf[1].surf, torch.eye(3), torch.zeros(3))
    assert tres.iterations == int(jres.iterations)
    assert int(tres.num_effective) == int(jres.num_effective)
    dt, rot = _pose_gap(jres.R, jres.t, tres.R.numpy(), tres.t.numpy())
    assert dt < 2e-6 and rot < 2e-6, (dt, rot)
    # the port's own targets recover the motion too (test_loam.py bound)
    own = loam.scan_match(loam.set_target(tf[0].edge, tf[0].surf, to), to, tf[1].edge,
                          tf[1].surf, torch.eye(3), torch.zeros(3))
    traj = jsyn.make_trajectory(num_frames=2, dt=0.1, speed=2.0)
    rel = traj.R[0].T @ (traj.t[1] - traj.t[0])
    assert np.linalg.norm(own.t.numpy() - rel) < 0.1


FRAMES, CAP = 8, 4096


def _loam_opts(mod, lmod):
    fo = lmod.LoamFeatureOptions(num_scan=16, min_ring_pts=64)
    return mod.LioOptions(matcher="loam", loam=lmod.LoamOption(feature=fo), scan_capacity=CAP,
                          with_eskf=True)


def test_lio_loam_step_matches_jax_on_carried_state():
    """Every frame of a demo log: rings and features from each package (held
    equal), the JAX engine's state before the frame carried across
    (io/convert, twin ring buffers and the LOAM target included), and the
    port's step_measure(edge_scan=...) held to the JAX step."""
    log = logdir.make_demo_log(num_frames=FRAMES, capacity=CAP, yaw_rate=0.0)
    jopts, topts = _loam_opts(jlio, jloam), _loam_opts(lio, loam)
    jeng = jlio.Lio(jopts)
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150], log.imu.acce[:150]):
        jeng.init_imu(g, a, t)
    assert jeng.imu_inited
    kfs = 0
    for mg in jreplay.sync_measures(log.scan_stamps, log.imu, imu_capacity=64):
        k = mg.scan_index
        jr = jsyn.annotate_rings(jpc.PointCloud(xyz=jnp.asarray(log.scan_xyz[k]),
                                                mask=jnp.asarray(log.scan_mask[k])), 16)
        tr = synthetic.annotate_rings(log.frame(k, "cpu"), 16, device="cpu")
        jf = jloam.extract_features(jr, jopts.loam.feature)
        tf = loam.extract_features(tr, topts.loam.feature)
        np.testing.assert_array_equal(tf.edge.mask.numpy(), np.asarray(jf.edge.mask))
        np.testing.assert_array_equal(tf.surf.mask.numpy(), np.asarray(jf.surf.mask))
        state = convert.lio_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jeng.state)._asdict(), "cpu")
        _, tout = lio.step_measure(state, tf.surf, mg.imu_gyro, mg.imu_acce, mg.imu_stamp,
                                   mg.imu_valid, topts, edge_scan=tf.edge)
        jout = jeng.add_measure(jf.surf, jnp.asarray(mg.imu_gyro), jnp.asarray(mg.imu_acce),
                                jnp.asarray(mg.imu_stamp), jnp.asarray(mg.imu_valid),
                                edge_scan=jf.edge)
        assert tout.is_keyframe == bool(jout.is_keyframe)
        assert tout.iterations == int(jout.iterations)
        assert int(tout.num_effective) == int(jout.num_effective)
        dt, rot = _pose_gap(jout.R, jout.t, tout.R.numpy(), tout.t.numpy())
        assert dt < 1e-5 and rot < 1e-5, (k, dt, rot)
        np.testing.assert_allclose(float(tout.chi2), float(jout.chi2), rtol=1e-4)
        kfs += tout.is_keyframe
    assert kfs >= 2


def test_lio_loam_runs_and_keeps_twin_buffers():
    """The port's own free run: loam needs edge_scan, keyframes fill both
    ring buffers, and the run tracks the demo log (ATE < 0.3 m on 8 frames,
    the JAX engine's own run gives the same order)."""
    from loc_lib_tpu_torch.eval import metrics

    log = logdir.make_demo_log(num_frames=FRAMES, capacity=CAP, yaw_rate=0.0)
    opts = _loam_opts(lio, loam)
    eng = lio.Lio(opts, device="cpu")
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150], log.imu.acce[:150]):
        eng.init_imu(g, a, t)
    with pytest.raises(ValueError, match="edge_scan"):
        eng.add_cloud(log.frame(0, "cpu"))
    for mg in log.measures(imu_capacity=64):
        f = loam.extract_features(synthetic.annotate_rings(log.frame(mg.scan_index, "cpu"), 16,
                                                           device="cpu"), opts.loam.feature)
        eng.add_measure(f.surf, mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid,
                        edge_scan=f.edge)
    s = eng.state
    assert s.num_kfs >= 2
    assert s.kf_edge_mask[: s.num_kfs].any(dim=1).all()
    assert int(s.loam_target.edge.line_packed[:, 12].sum()) > 0
    assert metrics.ate(np.stack(eng.poses), log.gt_poses).rmse < 0.3
