"""Port parity: loc_lib_tpu_torch.models.icp (p2plane_vox, p2plane_vox_oct,
p2line_vox) against the JAX package, on the tests/test_icp.py workloads.

Stated tolerances:
  * target tables: plane validity may differ on <= 0.5 % of voxels and
    oct_table on <= 0.5 % of cells (covariances are raw second moments
    about the window origin, s2 - n mu mu^T, whose float32 cancellation
    rounds differently under XLA's fused arithmetic); where both are valid
    on the structured scene, normals agree within 1e-4 (up to the plane's
    sign) and the offset d = -n.mu within 1e-4 * max(1, |mu|) (it inherits
    the normal's error times the distance to the window origin); on the
    35 m LiDAR scan, per voxel within 3 u s / gap of each other, the
    float32 conditioning of the raw-moment covariance (see
    test_lidar_normals_are_float32_roundings_of_the_float64_moments);
  * linearizations on a JAX-built target carried across by io/convert:
    counts exact, H/b/chi2 within rtol 1e-5, atol 1e-4 * max(1, max |H|);
    the port's one qs (op by op, the kernels' order) and JAX's (XLA's
    product) may put a point within an ulp of a voxel face into different
    voxels: counted in test_voxel_of_each_point_matches_jax_transform
    (0 of 4,096 on a 35 m scan at a rotated pose; at most 2 allowed);
  * scan_match: pose within 1e-4 rad / 1e-4 m of JAX, equal iterations;
    p2line_vox on a carried-across line table: within 2e-6 m / 2e-6 rad;
  * the knn methods (p2p, p2line, p2plane: plain torch ops on the hash
    grid, which is bit-equal to JAX's): effective counts exact; H, b, chi2
    within rtol 1e-4, atol 1e-4 * max(1, max |H|) (a 5-NN fit per probe in
    float32: the closed-form eigenvectors round differently under XLA);
    scan_match within 1e-4 rad / 1e-4 m with equal iterations; the fitness
    score within rtol 1e-5; the frozen election within 1e-4 rad / 1e-4 m of
    JAX's frozen run with equal iterations.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loc_lib_tpu.io import synthetic as jsyn
from loc_lib_tpu.models import icp as jicp
from loc_lib_tpu.ops import pointcloud as jpc
from loc_lib_tpu.utils import lie as jlie
from loc_lib_tpu_torch.io import convert
from loc_lib_tpu_torch.models import icp
from loc_lib_tpu_torch.ops import pointcloud as pcm, voxel
import oracles

torch.set_num_threads(2)


def _from_numpy(*args, **kwargs):
    """pointcloud.from_numpy on the CPU (its default device is the card)."""
    return pcm.from_numpy(*args, device="cpu", **kwargs)

DIMS = (64, 64, 32)
METHODS = ("p2plane_vox", "p2plane_vox_oct")


def _structured_scene(rng, n=600):
    a = np.stack([rng.uniform(-10, 10, n), rng.uniform(-10, 10, n), np.zeros(n)], 1)
    b = np.stack([rng.uniform(-10, 10, n), np.full(n, -10.0), rng.uniform(0, 5, n)], 1)
    c = np.stack([np.full(n, -10.0), rng.uniform(-10, 10, n), rng.uniform(0, 5, n)], 1)
    return np.concatenate([a, b, c]).astype(np.float32)


def _pair(seed):
    rng = np.random.default_rng(seed)
    scene = _structured_scene(rng)
    R_true = oracles.so3_exp(np.array([0.02, -0.03, 0.04]))
    t_true = np.array([0.3, -0.2, 0.15])
    src = ((scene - t_true) @ R_true).astype(np.float32)
    return scene, src, R_true, t_true


def _lidar_scan(capacity=4096):
    world = jsyn.make_world(num_points=20000, extent=40.0, seed=3)
    traj = jsyn.make_trajectory(num_frames=1)
    pc = jsyn.render_scan(world, traj.R[0], traj.t[0], max_range=35.0,
                          max_points=capacity, seed=0, capacity=capacity)
    return jpc.to_numpy(pc)


def _float64_planes(pts, cap, target, opts):
    """The plane normals the raw-moment formula gives in exact arithmetic,
    on the same voxels: the port's moment code run in float64 on the
    float32 points, keyed by the float32 voxel assignment, then a float64
    eigh. Returns (n64 (V, 3), cond (V,)) with cond = u s / gap, u = 2^-24,
    s = |mu|^2 + tr(cov) the magnitude of the raw second moments, and gap
    = lambda_1 - lambda_0: the size of the normal's float32 rounding."""
    pc = _from_numpy(pts, capacity=cap)
    grid = target.grid
    keys = voxel.coords_to_key(voxel.voxel_coords(pc.xyz, grid.inv_leaf, grid.origin, "floor"),
                               pc.mask)
    seg = voxel._segment_by_key(keys)
    pc64 = pcm.PointCloud(xyz=pc.xyz.double(), mask=pc.mask)
    st = voxel._stats_from_segments(pc64, seg, grid.inv_leaf, grid.origin)
    assert torch.equal(st.keys, grid.voxel_keys)
    _, mu, cov = icp._merge_neighbor_moments(st.keys, st.count, st.mean, st.cov,
                                             target.dense, opts.dense_dims)
    vals, vecs = np.linalg.eigh(cov.numpy())
    s = np.sum(mu.numpy() ** 2, axis=1) + np.trace(cov.numpy(), axis1=1, axis2=2)
    gap = np.maximum(vals[:, 1] - vals[:, 0], 1e-300)
    return vecs[:, :, 0], 2.0 ** -24 * s / gap


def _normal_gap(a, b):
    """Per row max |a - b| over the normal's components, up to sign."""
    sign = np.where(np.sum(a * b, axis=1) < 0, -1.0, 1.0)[:, None]
    return np.abs(a * sign - b).max(axis=1)


def _opts(method):
    return (jicp.IcpOptions(method=method, dense_dims=DIMS),
            icp.IcpOptions(method=method, dense_dims=DIMS))


def _carried(jtarget):
    return convert.icp_target_from_numpy(
        jax.tree_util.tree_map(np.asarray, jtarget)._asdict(), "cpu")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("cloud", ["structured", "lidar"])
def test_set_target_tables_match_jax(method, cloud):
    pts = _pair(8)[0] if cloud == "structured" else _lidar_scan()
    cap = 2048 if cloud == "structured" else 4096
    jo, to = _opts(method)
    jt = jicp.set_target(jpc.from_numpy(pts, capacity=cap), jo)
    tt = icp.set_target(_from_numpy(pts, capacity=cap), to)
    np.testing.assert_array_equal(tt.grid.voxel_keys.numpy(), np.asarray(jt.grid.voxel_keys))
    np.testing.assert_array_equal(tt.dense.table.numpy(), np.asarray(jt.dense.table))
    jv, tv = np.asarray(jt.plane_valid), tt.plane_valid.numpy()
    assert jv.sum() > 50
    assert (jv != tv).sum() <= 0.005 * len(jv)
    both = jv & tv
    jp, tp = np.asarray(jt.plane)[both], tt.plane.numpy()[both]
    sign = np.where(np.sum(jp[:, :3] * tp[:, :3], axis=1) < 0, -1.0, 1.0)[:, None]
    tp = tp * sign
    mu_norm = np.linalg.norm(np.asarray(jt.plane_mu)[both], axis=1)
    if cloud == "structured":
        np.testing.assert_allclose(tp[:, :3], jp[:, :3], atol=1e-4)
        assert (np.abs(tp[:, 3] - jp[:, 3]) <= 1e-4 * np.maximum(1.0, mu_norm)).all()
    else:
        # Out to 35 m the raw-moment covariance carries ~|mu|^2 u of
        # rounding, which a normal turns into an error of ~u s / gap: the
        # float32 conditioning of the reference formula. Measured: median
        # 2.7e-5; per voxel at most 2.44 u s / gap (max 2.6e-2 on a voxel
        # with gap 6.6e-4 m^2 at 34 m).
        _, cond = _float64_planes(pts, cap, tt, to)
        dn = np.abs(tp[:, :3] - jp[:, :3]).max(axis=1)
        assert np.median(dn) <= 1e-4
        assert (dn <= 3.0 * cond[both]).all(), (dn / cond[both]).max()
        dd = np.abs(tp[:, 3] - jp[:, 3])
        assert (dd <= 3.0 * cond[both] * mu_norm
                + 1e-4 * np.maximum(1.0, mu_norm)).all()
    if method == "p2plane_vox_oct":
        np.testing.assert_array_equal(tt.dense_oct.table.numpy(), np.asarray(jt.dense_oct.table))
        jo_t, to_t = np.asarray(jt.oct_table), tt.oct_table.numpy()
        assert jo_t.shape == to_t.shape
        assert (jo_t != to_t).sum() <= 0.005 * jo_t.size


def test_lidar_normals_are_float32_roundings_of_the_float64_moments():
    """Witness for the LiDAR bound above: against the float64 normals of the
    same raw-moment formula on the same voxels, JAX's and the port's float32
    normals each err by at most 3 u s / gap per voxel (measured max 2.04
    for JAX, 2.02 for the port; medians 4.0e-5 and 4.3e-5), so their gap
    is the reference formula's float32 rounding, which neither package
    resolves better than the other. Where that conditioning is below 3e-5,
    they agree within 1e-4."""
    pts, cap = _lidar_scan(), 4096
    jo, to = _opts("p2plane_vox")
    jt = jicp.set_target(jpc.from_numpy(pts, capacity=cap), jo)
    tt = icp.set_target(_from_numpy(pts, capacity=cap), to)
    n64, cond = _float64_planes(pts, cap, tt, to)
    both = np.asarray(jt.plane_valid) & tt.plane_valid.numpy()
    jn = np.asarray(jt.plane)[both, :3].astype(np.float64)
    tn = tt.plane.numpy()[both, :3].astype(np.float64)
    c = cond[both]
    for name, nv in (("jax", jn), ("port", tn)):
        err = _normal_gap(nv, n64[both])
        assert (err <= 3.0 * c).all(), (name, (err / c).max())
        assert np.median(err) <= 1e-4, name
    well = c <= 3e-5
    assert well.sum() >= 20
    assert _normal_gap(tn[well], jn[well]).max() <= 1e-4


@pytest.mark.parametrize("method", METHODS)
def test_linearization_on_carried_target_matches_jax(method):
    scene, src, _, _ = _pair(11)
    jo, to = _opts(method)
    jt = jicp.set_target(jpc.from_numpy(scene, capacity=2048), jo)
    tt = _carried(jt)
    jsrc = jpc.from_numpy(src, capacity=2048)
    tsrc = _from_numpy(src, capacity=2048)
    jfn = jicp._TERM_FNS[method]
    for w, trans in (([0.0, 0.0, 0.0], [0.0, 0.0, 0.0]),
                     ([0.01, -0.02, 0.03], [0.1, -0.05, 0.2])):
        R = np.array(jlie.so3_exp(jnp.asarray(w, jnp.float32)))
        t = np.asarray(trans, np.float32)
        Hj, bj, nj, cj = (np.asarray(a) for a in jfn(jt, jo, jsrc, jnp.asarray(R), jnp.asarray(t)))
        Ht, bt, nt, ct = icp.compute_h_and_b(tt, to, tsrc, torch.from_numpy(R), torch.from_numpy(t))
        assert int(nt) == int(nj) and int(nj) > 0
        atol = 1e-4 * max(1.0, np.abs(Hj).max())
        np.testing.assert_allclose(Ht.numpy(), Hj, rtol=1e-5, atol=atol)
        np.testing.assert_allclose(bt.numpy(), bj, rtol=1e-5, atol=atol)
        np.testing.assert_allclose(float(ct), float(cj), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("method", METHODS)
def test_voxel_of_each_point_matches_jax_transform(method):
    """The fused kernels decide a point's voxel (and octant) from the same
    qs = R q + t they measure distances with, evaluated op by op; JAX looks
    the voxel up from XLA's product `xyz @ R.T + t`. The two qs differ in
    the last bit, so a point within an ulp of a voxel face (or, for the
    octant path, of a voxel's mid-plane) may change cell. On a 35 m LiDAR
    scan at a rotated pose no point of 4,096 does, for either method, and
    the test holds that count at 0; so the linearization on a JAX target
    carried across agrees with JAX's `compute_h_and_b` in its
    effective-point count exactly and in its entries within the module's
    rule (1e-4 of max |H|)."""
    from loc_lib_tpu_torch.ops import kernels

    pts = _lidar_scan()
    jo, to = _opts(method)
    jt = jicp.set_target(jpc.from_numpy(pts, capacity=4096), jo)
    tt = _carried(jt)
    R = np.array(jlie.so3_exp(jnp.asarray([0.011, -0.023, 0.31], jnp.float32)))
    t = np.asarray([0.41, -0.27, 0.13], np.float32)
    src = ((pts - t) @ R).astype(np.float32)          # R^T (p - t): lands back on the map
    jsrc, tsrc = jpc.from_numpy(src, capacity=4096), _from_numpy(src, capacity=4096)
    qs_j = np.asarray(jsrc.xyz @ jnp.asarray(R).T + jnp.asarray(t))   # icp.py's own expression
    qs_t = kernels.transform_plain(tsrc.xyz, torch.from_numpy(R), torch.from_numpy(t)).numpy()
    valid = tsrc.mask.numpy()
    assert np.abs(qs_j - qs_t)[valid].max() < 1e-5
    u_j = (qs_j - np.asarray(jt.grid.origin)) * np.float32(jt.grid.inv_leaf)
    u_t = (qs_t - tt.grid.origin.numpy()) * np.float32(tt.grid.inv_leaf)
    cell_j, cell_t = np.floor(u_j), np.floor(u_t)
    differs = (cell_j != cell_t).any(axis=1)
    if method == "p2plane_vox_oct":
        differs |= ((u_j - cell_j > 0.5) != (u_t - cell_t > 0.5)).any(axis=1)
    n_diff = int((differs & valid).sum())
    assert n_diff == 0, n_diff
    Hj, bj, nj, cj = (np.asarray(a) for a in jicp.compute_h_and_b(
        jt, jo, jsrc, jnp.asarray(R), jnp.asarray(t)))
    Ht, bt, nt, ct = icp.compute_h_and_b(tt, to, tsrc, torch.from_numpy(R), torch.from_numpy(t))
    assert int(nt) == int(nj) and int(nj) > 1000
    atol = 1e-4 * max(1.0, np.abs(Hj).max())
    np.testing.assert_allclose(Ht.numpy(), Hj, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(bt.numpy(), bj, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("target_from", ["port", "jax"])
def test_scan_match_matches_jax(method, target_from):
    """test_icp.py:141 (p2plane_vox) and :500 (p2plane_vox_oct) workloads."""
    scene, src, R_true, t_true = _pair(7)
    jo, to = _opts(method)
    jt = jicp.set_target(jpc.from_numpy(scene, capacity=2048), jo)
    jr = jicp.scan_match(jt, jo, jpc.from_numpy(src, capacity=2048), jnp.eye(3), jnp.zeros(3))
    tt = icp.set_target(_from_numpy(scene, capacity=2048), to) \
        if target_from == "port" else _carried(jt)
    tr = icp.scan_match(tt, to, _from_numpy(src, capacity=2048), torch.eye(3), torch.zeros(3))
    assert tr.iterations == int(jr.iterations)
    assert bool(tr.converged) and bool(jr.converged)
    rot = np.linalg.norm(oracles.so3_log(np.asarray(jr.R, np.float64).T
                                         @ tr.R.numpy().astype(np.float64)))
    assert rot < 1e-4
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-4)
    # and both recovered the true pose (test_icp.py bounds)
    assert np.linalg.norm(tr.t.numpy() - t_true) < 5e-2
    assert int(tr.num_effective) == int(jr.num_effective)


@pytest.mark.parametrize("method", METHODS)
def test_empty_target_and_out_of_window_source_leave_pose_unmoved(method):
    _, to = _opts(method)
    empty = pcm.PointCloud(xyz=torch.full((1024, 3), pcm.PAD_COORD),
                           mask=torch.zeros(1024, dtype=torch.bool))
    tgt = icp.set_target(empty, to)
    assert not tgt.plane_valid.any()
    scene, src, _, _ = _pair(7)
    far = src + np.float32(5000.0)          # outside the +-512-cell key window
    R0, t0 = torch.eye(3), torch.tensor([0.5, -0.5, 0.25])
    for t_, s_ in ((tgt, src), (icp.set_target(_from_numpy(scene, capacity=2048), to), far)):
        res = icp.scan_match(t_, to, _from_numpy(s_, capacity=2048), R0, t0)
        assert not bool(res.converged) and int(res.num_effective) == 0
        assert res.iterations == to.max_iteration
        assert torch.equal(res.t, t0) and torch.allclose(res.R, R0, atol=1e-7)
        assert torch.isfinite(res.chi2)


def test_unported_methods_name_their_slice():
    """Slice 2 is ported: no ICP method or option raises NotImplementedError
    any more. The knn oracle methods build a hash-grid target (no voxel
    tables), the frozen election runs, p2line_vox builds its line table; an
    unknown method is a ValueError. Since the rest of LIO and 3D SLAM came
    in, nothing of the port raises NotImplementedError, and the helper that
    named a missing slice is gone."""
    scene = _from_numpy(_pair(7)[0])
    for method in ("p2p", "p2line", "p2plane"):
        tgt = icp.set_target(scene, icp.IcpOptions(method=method))
        assert tgt.packed is None and tgt.dense is None and tgt.centroid is not None
        assert tgt.grid.bucket_xyz.shape == (scene.capacity, 3 * 8)
    opts = icp.IcpOptions(method="p2plane_vox", freeze_election_after=2, dense_dims=DIMS)
    res = icp.scan_match(icp.set_target(scene, opts), opts, scene, torch.eye(3), torch.zeros(3))
    assert bool(res.converged) and torch.isfinite(res.t).all()
    tgt = icp.set_target(scene, icp.IcpOptions(method="p2line_vox", dense_dims=DIMS))
    assert tgt.line_packed.shape == (scene.capacity, 13) and tgt.packed is None
    with pytest.raises(ValueError, match="unknown ICP method"):
        icp.set_target(scene, icp.IcpOptions(method="p2plane_kd"))
    assert not hasattr(icp, "not_ported")


def _line_pair():
    """Poles, rails and a floor (test_torch_loam.py's line scene), and the
    scene seen from a pose 2.6 deg / 19 cm away."""
    from test_torch_loam import _line_scene

    scene = _line_scene()
    R_true = oracles.so3_exp(np.array([0.01, -0.015, 0.02]))
    t_true = np.array([0.15, -0.1, 0.05])
    return scene, ((scene - t_true) @ R_true).astype(np.float32), R_true, t_true


@pytest.mark.parametrize("warmup", [0, 2])
def test_p2line_vox_matches_jax_on_carried_target(warmup):
    """p2line_vox (K3 at S = 1, weighted, gated at max_line_distance^2) on a
    line table carried across from JAX: the Gram G is invariant under the
    free rotation of the cross-section basis, so linearizations agree with
    counts exact and entries within the K3 rule of test_torch_kernels.py;
    scan_match agrees within 2e-6 m / 2e-6 rad with equal iterations, the
    gate warm-up included (its wide gate is max_line_distance * scale). On
    the port's own line table the match recovers the true pose."""
    scene, src, R_true, t_true = _line_pair()
    jo = jicp.IcpOptions(method="p2line_vox", dense_dims=DIMS, gate_warmup_iters=warmup)
    to = icp.IcpOptions(method="p2line_vox", dense_dims=DIMS, gate_warmup_iters=warmup)
    jt = jicp.set_target(jpc.from_numpy(scene, capacity=8192), jo)
    tt = _carried(jt)
    jsrc, tsrc = jpc.from_numpy(src, capacity=8192), _from_numpy(src, capacity=8192)
    for w, trans in (([0.0, 0.0, 0.0], [0.0, 0.0, 0.0]),
                     ([0.01, -0.015, 0.02], [0.15, -0.1, 0.05])):
        R = np.array(jlie.so3_exp(jnp.asarray(w, jnp.float32)))
        t = np.asarray(trans, np.float32)
        Hj, bj, nj, cj = (np.asarray(a) for a in jicp._p2line_vox_terms(
            jt, jo, jsrc, jnp.asarray(R), jnp.asarray(t)))
        out = icp.compute_h_and_b(tt, to, tsrc, torch.from_numpy(R), torch.from_numpy(t))
        from loc_lib_tpu_torch.ops import kernels
        A = kernels.p2line_from_target_rows_plain(
            tsrc.xyz, tsrc.mask, torch.from_numpy(R), torch.from_numpy(t), to.max_line_distance,
            tt.line_packed, icp._index(tt, to, tt.dense)).double()
        sab = (A.abs().T @ A.abs()).numpy()
        assert int(out[2]) == int(nj) > 200
        for got, want, s in ((out[0].numpy(), Hj, sab[:6, :6]), (out[1].numpy(), bj, sab[:6, 6]),
                             (float(out[3]), cj, sab[6, 6])):
            tol = 1e-4 + 1e-5 * np.abs(want) + 64 * 2.0 ** -24 * s
            assert (np.abs(got - want) <= tol).all(), np.max(np.abs(got - want) / tol)
    jr = jicp.scan_match(jt, jo, jsrc, jnp.eye(3), jnp.zeros(3))
    tr = icp.scan_match(tt, to, tsrc, torch.eye(3), torch.zeros(3))
    assert tr.iterations == int(jr.iterations) and bool(tr.converged) == bool(jr.converged)
    assert int(tr.num_effective) == int(jr.num_effective)
    rot = np.linalg.norm(oracles.so3_log(np.asarray(jr.R, np.float64).T
                                         @ tr.R.numpy().astype(np.float64)))
    assert rot < 2e-6 and np.linalg.norm(tr.t.numpy() - np.asarray(jr.t)) < 2e-6
    own = icp.scan_match(icp.set_target(_from_numpy(scene, capacity=8192), to), to, tsrc,
                         torch.eye(3), torch.zeros(3))
    # (voxel lines through merged centroids: 1.3 cm off on this scene)
    assert np.linalg.norm(own.t.numpy() - t_true) < 5e-2
    assert np.linalg.norm(oracles.so3_log(R_true.T @ own.R.numpy().astype(np.float64))) < 5e-3


def test_p2line_vox_tie_goes_to_the_points_own_voxel():
    """A hand-made line target, the same tables for both packages: every
    1 m cell of a 12^3 block holds a line through its centre along the axis
    (cx + cy + cz) mod 3, so face neighbours carry different lines. A point
    on a voxel corner is exactly equidistant from its own centroid and those
    of its -x, -y and -z neighbours: the election (JAX: argmin; the port: a
    running strict minimum) must give the point's own voxel, the first
    stencil entry. Held against JAX's _p2line_vox_terms and against K3 with
    only the point's own voxel gathered (bit for bit)."""
    from loc_lib_tpu.ops import voxel as jvoxel
    from loc_lib_tpu_torch.ops import kernels

    side, dims = 12, (16, 16, 16)
    r = np.arange(side) - side // 2
    c = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1).reshape(-1, 3).astype(np.int32)
    keys = voxel.coords_to_key(torch.from_numpy(c), torch.ones(len(c), dtype=torch.bool))
    assert bool(torch.all(keys[1:] > keys[:-1]))
    v = len(c)
    mu = c.astype(np.float32) + 0.5
    axis = np.eye(3, dtype=np.float32)[c.sum(1) % 3]
    W = np.stack([np.roll(axis, 1, axis=1), np.roll(axis, 2, axis=1), np.zeros_like(axis)],
                 axis=2).reshape(v, 9)
    line_packed = np.concatenate([mu, W, np.ones((v, 1), np.float32)], axis=1)
    dense = voxel.build_dense_index(keys, dims=dims)
    grid = dict(voxel_keys=keys.numpy(), bucket_xyz=np.zeros((v, 3), np.float32),
                bucket_idx=np.full((v, 1), -1, np.int32), bucket_cnt=np.zeros(v, np.int32),
                num_voxels=np.int32(v), overflow=np.int32(0), inv_leaf=np.float32(1.0),
                origin=np.zeros(3, np.float32))
    as_dict = dict(grid=grid, dense=dict(table=dense.table.numpy(), lo=dense.lo.numpy()),
                   line_packed=line_packed)
    tt = convert.icp_target_from_numpy(as_dict, "cpu")
    jt = jicp.IcpTarget(
        grid=jvoxel.HashGrid(**{k: jnp.asarray(a) for k, a in grid.items()}),
        dense=jvoxel.DenseIndex(table=jnp.asarray(as_dict["dense"]["table"]),
                                lo=jnp.asarray(as_dict["dense"]["lo"])),
        line_packed=jnp.asarray(line_packed))
    jo = jicp.IcpOptions(method="p2line_vox", dense_dims=dims, max_line_distance=1.0)
    to = icp.IcpOptions(method="p2line_vox", dense_dims=dims, max_line_distance=1.0)
    corners = np.random.default_rng(4).integers(-5, 5, size=(1024, 3)).astype(np.float32)
    jsrc, tsrc = jpc.from_numpy(corners, capacity=1024), _from_numpy(corners, capacity=1024)
    eye, zero = torch.eye(3), torch.zeros(3)
    index = icp._index(tt, to, tt.dense)
    qs, mu7, _, valid7 = kernels.ndt_stencil_rows_plain(tsrc.xyz, tsrc.mask, eye, zero,
                                                        tt.line_packed, index, 7, "floor")
    d2 = torch.sum((mu7 - qs[:, None, :]) ** 2, dim=-1)
    assert bool(valid7.all()) and int((d2 == d2[:, :1]).sum(1).min()) == 4      # 4-way ties
    got = icp.compute_h_and_b(tt, to, tsrc, eye, zero)
    own = kernels.ndt_fused_terms(tsrc.xyz, *kernels.ndt_stencil_rows_plain(
        tsrc.xyz, tsrc.mask, eye, zero, tt.line_packed, index, 1, "floor"), eye, zero, 1.0, True)
    assert int(got[2]) == 1024
    for a, b_ in zip(got, own):
        assert torch.equal(a, b_)
    Hj, bj, nj, cj = (np.asarray(a) for a in jicp._p2line_vox_terms(
        jt, jo, jsrc, jnp.eye(3), jnp.zeros(3)))
    assert int(nj) == 1024
    np.testing.assert_allclose(got[0].numpy(), Hj, rtol=1e-5, atol=1e-4 * np.abs(Hj).max())
    np.testing.assert_allclose(got[1].numpy(), bj, rtol=1e-5, atol=1e-4 * np.abs(Hj).max())
    np.testing.assert_allclose(float(got[3]), float(cj), rtol=1e-5)


# ---------------------------------------------------------------------------
# The knn oracle methods, the fitness score and the frozen election
# ---------------------------------------------------------------------------

def _line_rich_scene():
    """test_icp.py:59's scene: a grid of straight edges along x and y."""
    rng = np.random.default_rng(2)
    lines = []
    for z in range(5):
        ts = rng.uniform(-10, 10, 150)
        lines.append(np.stack([ts, np.full_like(ts, z * 2.0 - 5), np.full_like(ts, z * 1.0)], 1))
        lines.append(np.stack([np.full_like(ts, z * 2.0 - 5), ts, np.full_like(ts, z * 0.7)], 1))
    scene = np.concatenate(lines).astype(np.float32)
    R_true = oracles.so3_exp(np.array([0.01, -0.01, 0.02]))
    t_true = np.array([0.1, 0.05, -0.05])
    return scene, ((scene - t_true) @ R_true).astype(np.float32), R_true, t_true


def _knn_pair(method):
    """The pose-recovery workloads of test_icp.py:37 (p2plane), :48 (p2p)
    and :59 (p2line), with their bounds (rot rad, trans m)."""
    if method == "p2line":
        return (*_line_rich_scene(), 2e-2, 5e-2)
    rng = np.random.default_rng(0 if method == "p2plane" else 1)
    scene = _structured_scene(rng)
    w, trans = (([0.02, -0.03, 0.04], [0.3, -0.2, 0.15]) if method == "p2plane"
                else ([0.01, 0.02, -0.02], [0.15, 0.1, -0.1]))
    R_true, t_true = oracles.so3_exp(np.asarray(w)), np.asarray(trans, np.float64)
    src = ((scene - t_true) @ R_true).astype(np.float32)
    return (scene, src, R_true, t_true) + ((5e-3, 5e-2) if method == "p2plane" else (2e-2, 1e-1))


@pytest.mark.parametrize("method", ["p2plane", "p2p", "p2line"])
def test_knn_methods_recover_pose_and_match_jax(method):
    scene, src, R_true, t_true, rot_bound, t_bound = _knn_pair(method)
    jo, to = jicp.IcpOptions(method=method), icp.IcpOptions(method=method)
    jt = jicp.set_target(jpc.from_numpy(scene, capacity=2048), jo)
    tt = icp.set_target(_from_numpy(scene, capacity=2048), to)
    for name in voxel.HashGrid._fields:       # the search structure is bit-equal
        np.testing.assert_array_equal(getattr(tt.grid, name).numpy(),
                                      np.asarray(getattr(jt.grid, name)), name)
    jsrc, tsrc = jpc.from_numpy(src, capacity=2048), _from_numpy(src, capacity=2048)
    for w, trans in (([0.0, 0.0, 0.0], [0.0, 0.0, 0.0]), ([0.01, -0.02, 0.03], [0.1, -0.05, 0.2])):
        R = np.array(jlie.so3_exp(jnp.asarray(w, jnp.float32)))
        t = np.asarray(trans, np.float32)
        Hj, bj, nj, cj = (np.asarray(a) for a in jicp.compute_h_and_b(
            jt, jo, jsrc, jnp.asarray(R), jnp.asarray(t)))
        Ht, bt, nt, ct = icp.compute_h_and_b(tt, to, tsrc, torch.from_numpy(R), torch.from_numpy(t))
        assert int(nt) == int(nj) and int(nj) > 100
        atol = 1e-4 * max(1.0, np.abs(Hj).max())
        np.testing.assert_allclose(Ht.numpy(), Hj, rtol=1e-4, atol=atol)
        np.testing.assert_allclose(bt.numpy(), bj, rtol=1e-4, atol=atol)
        np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4, atol=atol)
    jr = jicp.scan_match(jt, jo, jsrc, jnp.eye(3), jnp.zeros(3))
    tr = icp.scan_match(tt, to, tsrc, torch.eye(3), torch.zeros(3))
    assert tr.iterations == int(jr.iterations) and bool(tr.converged) == bool(jr.converged)
    assert int(tr.num_effective) == int(jr.num_effective)
    rot = np.linalg.norm(oracles.so3_log(np.asarray(jr.R, np.float64).T
                                         @ tr.R.numpy().astype(np.float64)))
    assert rot < 1e-4 and np.linalg.norm(tr.t.numpy() - np.asarray(jr.t)) < 1e-4
    rot_err = np.linalg.norm(oracles.so3_log(tr.R.numpy().astype(np.float64).T @ R_true))
    assert rot_err < rot_bound and np.linalg.norm(tr.t.numpy() - t_true) < t_bound


def test_h_b_matches_oracle_p2plane():
    """test_icp.py:78 in the port: one p2plane linearization against the
    float64 reference math on the same correspondences (the 5 nearest among
    the 3x3x3 cells around the probe), with that test's bounds."""
    rng = np.random.default_rng(3)
    scene = _structured_scene(rng, n=400)
    Rw, tw = oracles.so3_exp(np.array([0.01, -0.008, 0.015])), np.array([0.04, -0.03, 0.02])
    src = ((scene[::7] - tw) @ Rw).astype(np.float32)
    opts = icp.IcpOptions(method="p2plane", grid_leaf=1.0, bucket_size=32)
    tgt = icp.set_target(_from_numpy(scene, capacity=2048), opts)
    H, b, eff, _ = icp.compute_h_and_b(tgt, opts, _from_numpy(src, capacity=256), torch.eye(3),
                                       torch.zeros(3))

    def nn_fn(qs):
        cand = scene[np.all(np.abs(np.floor(scene) - np.floor(qs)) <= 1, axis=1)]
        if len(cand) == 0:
            return None
        return cand[np.argsort(np.sum((cand - qs) ** 2, axis=1))[:5]]

    H_ref, b_ref, eff_ref = oracles.icp_p2plane_h_b(src.astype(np.float64), nn_fn, np.eye(3),
                                                    np.zeros(3))
    assert abs(int(eff) - eff_ref) <= 2
    np.testing.assert_allclose(H.numpy(), H_ref, atol=np.abs(H_ref).max() * 0.12)
    np.testing.assert_allclose(b.numpy(), b_ref, atol=np.abs(b_ref).max() * 0.15 + 1e-3)
    dx = np.linalg.solve(H.numpy().astype(np.float64), b.numpy().astype(np.float64))
    dx_ref = np.linalg.solve(H_ref, b_ref)
    np.testing.assert_allclose(dx, dx_ref, atol=np.abs(dx_ref).max() * 0.2 + 2e-4)


def test_fitness_score_matches_jax():
    """test_icp.py:389: ~0 at the true pose, large at a wrong one, +inf
    against an empty target; each value within rtol 1e-5 of JAX's."""
    rng = np.random.default_rng(11)
    scene = _structured_scene(rng)
    R_true, t_true = oracles.so3_exp(np.array([0.0, 0.0, 0.05])), np.array([0.4, 0.1, 0.0])
    src = ((scene - t_true) @ R_true).astype(np.float32)
    jo, to = jicp.IcpOptions(method="p2plane"), icp.IcpOptions(method="p2plane")
    jt = jicp.set_target(jpc.from_numpy(scene, capacity=2048), jo)
    tt = icp.set_target(_from_numpy(scene, capacity=2048), to)
    jsrc, tsrc = jpc.from_numpy(src, capacity=2048), _from_numpy(src, capacity=2048)
    scores = {}
    for name, R, t in (("good", R_true, t_true), ("bad", np.eye(3), np.array([3.0, 0.0, 0.0]))):
        R32, t32 = R.astype(np.float32), t.astype(np.float32)
        got = float(icp.get_fitness_score(tt, to, tsrc, torch.from_numpy(R32),
                                          torch.from_numpy(t32)))
        want = float(jicp.get_fitness_score(jt, jo, jsrc, jnp.asarray(R32), jnp.asarray(t32)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        scores[name] = got
    assert scores["good"] < 0.01 and scores["bad"] > 5 * scores["good"]
    empty = pcm.PointCloud(xyz=torch.full((64, 3), pcm.PAD_COORD),
                           mask=torch.zeros(64, dtype=torch.bool))
    assert np.isinf(float(icp.get_fitness_score(icp.set_target(empty, to), to, tsrc,
                                                torch.eye(3), torch.zeros(3))))
    # every method's target carries the grid the score reads
    vo = icp.IcpOptions(method="p2plane_vox", dense_dims=DIMS)
    vox = icp.get_fitness_score(icp.set_target(_from_numpy(scene, capacity=2048), vo), vo, tsrc,
                                torch.from_numpy(R_true.astype(np.float32)),
                                torch.from_numpy(t_true.astype(np.float32)))
    assert float(vox) == scores["good"]


def test_use_initial_translation_false_centroid_init():
    """test_icp.py:426: a pair 3 m apart with a zero init converges through
    the centroid init where the plain init cannot; both runs follow JAX's
    (1e-4 m)."""
    rng = np.random.default_rng(21)
    scene = _structured_scene(rng)
    R_true, t_true = oracles.so3_exp(np.array([0.0, 0.0, 0.02])), np.array([3.0, -2.0, 0.4])
    src = ((scene - t_true) @ R_true).astype(np.float32)
    errs = {}
    for flag in (True, False):
        jo = jicp.IcpOptions(method="p2p", max_nn_distance=25.0, use_initial_translation=flag)
        to = icp.IcpOptions(method="p2p", max_nn_distance=25.0, use_initial_translation=flag)
        jr = jicp.scan_match(jicp.set_target(jpc.from_numpy(scene, capacity=2048), jo), jo,
                             jpc.from_numpy(src, capacity=2048), jnp.eye(3), jnp.zeros(3))
        tr = icp.scan_match(icp.set_target(_from_numpy(scene, capacity=2048), to), to,
                            _from_numpy(src, capacity=2048), torch.eye(3), torch.zeros(3))
        assert tr.iterations == int(jr.iterations)
        assert np.linalg.norm(tr.t.numpy() - np.asarray(jr.t)) < 1e-4
        errs[flag] = np.linalg.norm(tr.t.numpy() - t_true)
    assert errs[False] < 0.1 and errs[False] <= errs[True] + 1e-6


@pytest.mark.parametrize("target_from", ["port", "jax"])
def test_p2plane_vox_frozen_election_matches_full_and_jax(target_from):
    """test_icp.py:449: freeze_election_after = 2 lands on the pose of the
    re-elect-every-iteration path (1e-2 m) and converges; and the frozen run
    follows JAX's frozen run (equal iterations, 1e-4 rad / 1e-4 m). Its
    elections linearize through K1 with the plane given."""
    rng = np.random.default_rng(31)
    scene = _structured_scene(rng)
    R_true, t_true = oracles.so3_exp(np.array([0.02, -0.03, 0.04])), np.array([0.3, -0.2, 0.15])
    src = ((scene - t_true) @ R_true).astype(np.float32)
    jsrc, tsrc = jpc.from_numpy(src, capacity=2048), _from_numpy(src, capacity=2048)
    runs = {}
    for name, k in (("full", 0), ("frozen", 2)):
        jo = jicp.IcpOptions(method="p2plane_vox", freeze_election_after=k)
        to = icp.IcpOptions(method="p2plane_vox", freeze_election_after=k)
        jt = jicp.set_target(jpc.from_numpy(scene, capacity=2048), jo)
        tt = icp.set_target(_from_numpy(scene, capacity=2048), to) \
            if target_from == "port" else _carried(jt)
        jr = jicp.scan_match(jt, jo, jsrc, jnp.eye(3), jnp.zeros(3))
        tr = icp.scan_match(tt, to, tsrc, torch.eye(3), torch.zeros(3))
        assert tr.iterations == int(jr.iterations) and bool(tr.converged) and bool(jr.converged)
        rot = np.linalg.norm(oracles.so3_log(np.asarray(jr.R, np.float64).T
                                             @ tr.R.numpy().astype(np.float64)))
        assert rot < 1e-4 and np.linalg.norm(tr.t.numpy() - np.asarray(jr.t)) < 1e-4
        rot_err = np.linalg.norm(oracles.so3_log(tr.R.numpy().astype(np.float64).T @ R_true))
        assert rot_err < 1e-2 and np.linalg.norm(tr.t.numpy() - t_true) < 5e-2
        runs[name] = tr
    assert np.linalg.norm(runs["full"].t.numpy() - runs["frozen"].t.numpy()) < 1e-2


def test_frozen_election_reelects_only_when_the_pose_moves(monkeypatch):
    """The election runs in the first freeze_election_after iterations and
    again only after the pose has moved past elect_dx_threshold: with a huge
    threshold it runs exactly k times, with threshold 0 on every iteration
    (and then gives the bits of the unfused-pick oracle loop)."""
    scene, src, _, _ = _pair(7)
    tsrc = _from_numpy(src, capacity=2048)
    calls = []
    real = icp._p2plane_vox_elect
    monkeypatch.setattr(icp, "_p2plane_vox_elect",
                        lambda *a: (calls.append(1), real(*a))[1])
    base = dict(method="p2plane_vox", dense_dims=DIMS, freeze_election_after=2)
    never = icp.IcpOptions(**base, elect_dx_threshold=1e9)
    tt = icp.set_target(_from_numpy(scene, capacity=2048), never)
    res = icp.scan_match(tt, never, tsrc, torch.eye(3), torch.zeros(3))
    assert len(calls) == 2 < res.iterations
    calls.clear()
    always = icp.IcpOptions(**base, elect_dx_threshold=0.0, eps=0.0, max_iteration=5)
    res = icp.scan_match(tt, always, tsrc, torch.eye(3), torch.zeros(3))
    assert len(calls) == res.iterations == 5
    plain = dataclasses.replace(always, freeze_election_after=0)
    ref = icp._gauss_newton(icp._p2plane_vox_terms_unfused_pick, tt, plain, tsrc, torch.eye(3),
                            torch.zeros(3))
    assert torch.equal(res.R, ref.R) and torch.equal(res.t, ref.t)
