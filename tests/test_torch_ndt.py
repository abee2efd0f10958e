"""Port parity: loc_lib_tpu_torch.models.ndt (direct and incremental NDT),
its mathx helpers and icp.target_from_moment_table, against the JAX package
on the tests/test_ndt.py workloads.

Stated tolerances:
  * mathx: merge_gaussian within atol 1e-5 (mean) / 1e-4 (cov) of JAX and
    the float64 oracle (test_mathx.py's bounds); clamped_inverse_3x3 within
    rtol 1e-4 of JAX on well-conditioned covariances and within
    test_mathx.py's bound of the oracle on a planar one; cholesky_3x3
    within 1e-5 relative of JAX, exact zero for a zero input;
  * maps built by both packages from the same cloud: integer fields
    (keys, counts, age, estimated) exact on live rows; means within
    1e-6 * max(1, |mu|); covariances within 4 u s per voxel (u = 2^-24,
    s = |mu|^2 + tr cov: the float32 rounding of the raw-moment formula
    s2 - n mu mu^T, measured up to 1.78 u s). Information matrices are not
    held entry by entry on these maps: the eigenvalue floor at 1e-3
    lambda_max amplifies that rounding up to ~70% on near-planar voxels
    (measured), as ROADMAP section 3 records;
  * linearizations and matches on a map carried across from JAX (io/convert):
    counts exact, H/b/chi2 within rtol 1e-5, atol 1e-4 * max(1, max |H|);
    equal iterations, pose within 1e-5 m / 1e-5 rad (measured 5e-8 m);
  * port fused path against the port oracle: test_ndt.py:44's bounds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loc_lib_tpu.io import synthetic as jsyn
from loc_lib_tpu.models import icp as jicp, ndt as jndt
from loc_lib_tpu.ops import pointcloud as jpc, voxel as jvoxel
from loc_lib_tpu.utils import mathx as jmathx
from loc_lib_tpu_torch.io import convert
from loc_lib_tpu_torch.models import icp, ndt
from loc_lib_tpu_torch.ops import pointcloud as pcm, voxel
from loc_lib_tpu_torch.utils import mathx
import oracles

torch.set_num_threads(2)


def _from_numpy(*args, **kwargs):
    """pointcloud.from_numpy on the CPU (its default device is the card)."""
    return pcm.from_numpy(*args, device="cpu", **kwargs)

U = 2.0 ** -24


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def scene():
    """test_ndt.py's scene: target and source scans 0.2 m apart."""
    world = jsyn.make_world(num_points=20000, extent=40.0, seed=3)
    traj = jsyn.make_trajectory(num_frames=2, dt=0.1, speed=2.0)
    tgt = jsyn.render_scan(world, traj.R[0], traj.t[0], max_points=2048, noise=0.005,
                           seed=0, capacity=2048)
    src = jsyn.render_scan(world, traj.R[1], traj.t[1], max_points=2048, noise=0.005,
                           seed=1, capacity=2048)
    t_rel = traj.R[0].T @ (traj.t[1] - traj.t[0])
    return jpc.to_numpy(tgt), jpc.to_numpy(src), t_rel


def _opts(method, **kw):
    return (jndt.NdtOptions(voxel_size=2.0, method=method, **kw),
            ndt.NdtOptions(voxel_size=2.0, method=method, **kw))


def _build(method, jo, to, pts):
    jc, tc = jpc.from_numpy(pts, capacity=2048), _from_numpy(pts, capacity=2048)
    if method == "direct":
        return jndt.build_direct(jc, jo), ndt.build_direct(tc, to)
    return (jndt.update_incremental(jndt.empty_incremental(jo), jc, jo),
            ndt.update_incremental(ndt.empty_incremental(to), tc, to))


def _carried(jm):
    return convert.ndt_map_from_numpy(jax.tree_util.tree_map(np.asarray, jm)._asdict(), "cpu")


def _assert_maps_agree(jm, tm):
    """Integer fields exact on live rows, dead rows dead; moments within
    their float32 bounds (module docstring)."""
    jk, tk = np.asarray(jm.keys), tm.keys.numpy()
    np.testing.assert_array_equal(tk, jk)
    live = jk != voxel.INVALID_KEY
    assert live.sum() > 50
    for f in ("count", "age", "estimated"):
        np.testing.assert_array_equal(getattr(tm, f).numpy()[live],
                                      np.asarray(getattr(jm, f))[live], f)
    assert not tm.estimated.numpy()[~live].any()
    assert tm.epoch == int(jm.epoch)
    mu = np.asarray(jm.mean)[live]
    np.testing.assert_allclose(tm.mean.numpy()[live], mu,
                               atol=1e-6 * max(1.0, np.abs(mu).max()))
    s = np.sum(mu * mu, axis=1) + np.trace(np.asarray(jm.cov)[live], axis1=1, axis2=2)
    dc = np.abs(tm.cov.numpy()[live] - np.asarray(jm.cov)[live]).max(axis=(1, 2))
    assert (dc <= 4.0 * U * s).all(), (dc / (U * s)).max()
    assert torch.isfinite(tm.info).all() and torch.isfinite(tm.packed).all()


# ---------------------------------------------------------------------------
# mathx
# ---------------------------------------------------------------------------

def test_merge_gaussian_matches_jax_and_oracle():
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(20, 3)), rng.normal(size=(7, 3)) + 1.0
    ma, ca = oracles.mean_and_cov(a)
    mb, cb = oracles.mean_and_cov(b)
    args = (np.float32(20), ma, ca, np.float32(7), mb, cb)
    ours = mathx.merge_gaussian(*(_t(x) for x in args))
    ref = jmathx.merge_gaussian(*(jnp.asarray(x, jnp.float32) for x in args))
    orc = oracles.merge_gaussian(20, ma, ca, 7, mb, cb)
    for o, r, c, tol in zip(ours, ref, orc, (1e-5, 1e-4)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=tol)
        np.testing.assert_allclose(o.numpy(), c, atol=tol)


def test_clamped_inverse_matches_jax_and_ndt_oracle():
    rng = np.random.default_rng(5)
    B = rng.normal(size=(64, 3, 3))
    cov = (B @ np.swapaxes(B, 1, 2) + 0.3 * np.eye(3)).astype(np.float32)
    np.testing.assert_allclose(mathx.clamped_inverse_3x3(_t(cov)).numpy(),
                               np.asarray(jmathx.clamped_inverse_3x3(jnp.asarray(cov))),
                               rtol=1e-4, atol=1e-5)
    d = rng.normal(size=(30, 3))
    d[:, 2] *= 1e-5                               # planar voxel: the floor binds
    _, planar = oracles.mean_and_cov(d)
    info = mathx.clamped_inverse_3x3(_t(planar)).numpy()
    ref = oracles.ndt_clamped_info(planar)
    np.testing.assert_allclose(info, ref, rtol=2e-2, atol=1e-3 * np.abs(ref).max())


def test_cholesky_3x3_matches_jax_roundtrips_and_keeps_zero():
    rng = np.random.default_rng(3)
    B = rng.normal(size=(32, 3, 3)).astype(np.float32)
    A = B @ B.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    A[:4] = 0.0                                   # non-estimated voxels
    A[4:8] = np.eye(3) - np.outer([0.6, 0.8, 0.0], [0.6, 0.8, 0.0])  # rank 2
    packed = mathx.cholesky_3x3(_t(A))
    ref = np.asarray(jmathx.cholesky_3x3(jnp.asarray(A)))
    np.testing.assert_allclose(packed.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(packed.numpy()[:4], 0.0)
    L = mathx.cholesky_3x3_unpack(packed).numpy()
    np.testing.assert_array_equal(
        L, np.asarray(jmathx.cholesky_3x3_unpack(jnp.asarray(packed.numpy()))))
    np.testing.assert_allclose(L[8:] @ L[8:].transpose(0, 2, 1), A[8:], rtol=2e-3, atol=2e-3)
    assert (packed.numpy()[8:, [0, 2, 5]] > 0).all()


# ---------------------------------------------------------------------------
# Map builds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["direct", "incremental"])
def test_map_build_matches_jax(scene, method):
    tgt, _, _ = scene
    jo, to = _opts(method)
    jm, tm = _build(method, jo, to, tgt)
    _assert_maps_agree(jm, tm)
    # the fused rows: W W^T = info on estimated voxels (test_ndt.py:30)
    est = tm.estimated.numpy()
    W = tm.packed.numpy()[:, 3:12].reshape(-1, 3, 3)
    np.testing.assert_allclose((W @ W.transpose(0, 2, 1))[est], tm.info.numpy()[est],
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(tm.packed.numpy()[:, 12] > 0.5, est)
    np.testing.assert_array_equal(tm.dense_table.numpy(), np.asarray(jm.dense_table))


def test_incremental_epochs_with_eviction_match_jax():
    """Three update_incremental epochs on scans along a trajectory at a
    capacity that forces eviction: which voxels survive is decided by age
    and, among equal ages, by key order (stable sorts)."""
    world = jsyn.make_world(num_points=20000, extent=40.0, seed=5)
    traj = jsyn.make_trajectory(num_frames=3, dt=0.5, speed=4.0)
    jo, to = (m.NdtOptions(voxel_size=1.0, method="incremental", map_capacity=1024,
                           dense_dims=(128, 128, 32)) for m in (jndt, ndt))
    jm, tm = jndt.empty_incremental(jo), ndt.empty_incremental(to)
    for i in range(3):
        pts = jpc.to_numpy(jsyn.render_scan(world, traj.R[i], traj.t[i], max_points=1024,
                                            noise=0.005, seed=i, capacity=1024))
        pts = (pts @ traj.R[i].T + traj.t[i]).astype(np.float32)
        jm = jndt.update_incremental(jm, jpc.from_numpy(pts, capacity=1024), jo)
        tm = ndt.update_incremental(tm, _from_numpy(pts, capacity=1024), to)
        _assert_maps_agree(jm, tm)
    live = tm.keys != voxel.INVALID_KEY
    assert int(live.sum()) == 1024                      # at capacity: eviction fired
    ages = tm.age[live]
    assert int(ages.min()) < int(ages.max()) == 3       # older voxels survive too


def test_rebuild_from_moments_matches_update_and_jax():
    """test_ndt.py:87: the same points split into three groups, with keys
    repeating across groups, rebuild to the same Gaussians as one
    update_incremental; and the port's rebuild equals JAX's."""
    rng = np.random.default_rng(0)
    jo, to = (m.NdtOptions(method="incremental", voxel_size=1.0, map_capacity=512)
              for m in (jndt, ndt))
    pts = rng.uniform(-4, 4, (600, 3)).astype(np.float32)
    ref = ndt.update_incremental(ndt.empty_incremental(to), _from_numpy(pts, capacity=1024), to)
    parts = [voxel.voxel_stats(_from_numpy(pts[lo:hi], capacity=1024), to.voxel_size,
                               torch.zeros(3), mode=to.bin_mode)
             for lo, hi in ((0, 150), (150, 400), (400, 600))]
    keys, cnt, mean, cov = (torch.cat([getattr(p, f) for p in parts])
                            for f in ("keys", "count", "mean", "cov"))
    est = torch.zeros(keys.shape, dtype=torch.bool)
    age = torch.ones(keys.shape, dtype=torch.int32)
    m2 = ndt.rebuild_from_moments(keys, cnt, mean, cov, est, age, 1, torch.zeros(3), to)
    live = ref.keys != voxel.INVALID_KEY
    assert torch.equal(ref.keys, m2.keys) and torch.equal(ref.count[live], m2.count[live])
    np.testing.assert_allclose(m2.mean.numpy()[live], ref.mean.numpy()[live], atol=1e-4)
    np.testing.assert_allclose(m2.cov.numpy()[live], ref.cov.numpy()[live], atol=1e-4)
    jm2 = jndt.rebuild_from_moments(*(jnp.asarray(x.numpy()) for x in (keys, cnt, mean, cov,
                                                                       est, age)),
                                    jnp.int32(1), jnp.zeros(3), jo)
    _assert_maps_agree(jm2, m2)


# ---------------------------------------------------------------------------
# Alignment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["direct", "incremental"])
@pytest.mark.parametrize("use_fused", [True, False])
def test_terms_on_carried_map_match_jax(scene, method, use_fused):
    tgt, src, _ = scene
    jo, to = _opts(method, use_fused=use_fused)
    jm, _ = _build(method, jo, to, tgt)
    cm = _carried(jm)
    weighted = method == "incremental"
    R = np.eye(3, dtype=np.float32)
    t = np.array([0.05, -0.02, 0.01], np.float32)
    Hj, bj, nj, cj = (np.asarray(a) for a in jndt._ndt_terms(
        jm, jo, jpc.from_numpy(src, capacity=2048), jnp.asarray(R), jnp.asarray(t), weighted))
    Ht, bt, nt, ct = ndt._ndt_terms(cm, to, _from_numpy(src, capacity=2048), _t(R), _t(t),
                                    weighted)
    assert int(nt) == int(nj) > 100
    atol = 1e-4 * max(1.0, np.abs(Hj).max())
    np.testing.assert_allclose(Ht.numpy(), Hj, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(bt.numpy(), bj, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("method", ["direct", "incremental"])
def test_port_fused_terms_match_port_oracle(scene, method):
    """test_ndt.py:44 in the port: K3 on the packed rows gives the same
    normal equations as the searchsorted + einsum oracle."""
    tgt, src, _ = scene
    _, to_f = _opts(method)
    to_o = dataclasses.replace(to_f, use_fused=False)
    tc = _from_numpy(tgt, capacity=2048)
    m = ndt.build_direct(tc, to_f) if method == "direct" else \
        ndt.update_incremental(ndt.empty_incremental(to_f), tc, to_f)
    sc = _from_numpy(src, capacity=2048)
    weighted = method == "incremental"
    R, t = torch.eye(3), torch.tensor([0.05, -0.02, 0.01])
    Hf, bf, nf, cf = ndt._ndt_terms(m, to_f, sc, R, t, weighted)
    Ho, bo, no, co = ndt._ndt_terms(m, to_o, sc, R, t, weighted)
    assert int(nf) == int(no) > 100
    np.testing.assert_allclose(float(cf), float(co), rtol=2e-3, atol=1e-2)
    scale = max(1.0, float(torch.max(torch.abs(bo))))
    np.testing.assert_allclose(bf.numpy(), bo.numpy(), rtol=2e-3, atol=2e-2 * scale)
    scale = max(1.0, float(torch.max(torch.abs(Ho))))
    np.testing.assert_allclose(Hf.numpy(), Ho.numpy(), rtol=2e-3, atol=2e-2 * scale)


@pytest.mark.parametrize("method", ["direct", "incremental"])
def test_scan_match_on_carried_map_matches_jax(scene, method):
    tgt, src, t_rel = scene
    jo, to = _opts(method)
    jm, tm = _build(method, jo, to, tgt)
    jr = jndt.scan_match(jm, jo, jpc.from_numpy(src, capacity=2048), jnp.eye(3), jnp.zeros(3))
    sc = _from_numpy(src, capacity=2048)
    tr = ndt.scan_match(_carried(jm), to, sc, torch.eye(3), torch.zeros(3))
    assert tr.iterations == int(jr.iterations)
    assert bool(tr.converged) == bool(jr.converged)
    assert int(tr.num_effective) == int(jr.num_effective)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-5)
    rot = np.linalg.norm(oracles.so3_log(np.asarray(jr.R, np.float64).T
                                         @ tr.R.numpy().astype(np.float64)))
    assert rot < 1e-5
    np.testing.assert_allclose(tr.R.numpy().T @ tr.R.numpy(), np.eye(3), atol=1e-6)
    if method == "incremental":
        # test_ndt.py:67's pose recovery, on the port's own map too
        own = ndt.scan_match(tm, to, sc, torch.eye(3), torch.zeros(3))
        assert np.linalg.norm(own.t.numpy() - t_rel) < 0.1 and int(own.num_effective) > 100
    jf = jndt.get_fitness_score(jm, jo, jpc.from_numpy(src, capacity=2048), jr.R, jr.t)
    tf = ndt.get_fitness_score(_carried(jm), to, sc, _t(np.asarray(jr.R)), _t(np.asarray(jr.t)))
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-5)


@pytest.mark.parametrize("method", ["direct", "incremental"])
def test_empty_map_is_inert(scene, method):
    """test_ndt.py:77: nothing to match leaves the pose where it was."""
    _, src, _ = scene
    to = ndt.NdtOptions(method=method, map_capacity=1024)
    empty = pcm.PointCloud(xyz=torch.full((1024, 3), pcm.PAD_COORD),
                           mask=torch.zeros(1024, dtype=torch.bool))
    m = ndt.build_direct(empty, to) if method == "direct" else ndt.empty_incremental(to)
    t0 = torch.tensor([0.5, -0.5, 0.25])
    res = ndt.scan_match(m, to, _from_numpy(src, capacity=2048), torch.eye(3), t0)
    assert torch.isfinite(res.t).all() and torch.equal(res.t, t0)
    assert int(res.num_effective) == 0 and float(res.chi2) == 0.0
    assert float(ndt.get_fitness_score(m, to, _from_numpy(src, capacity=2048),
                                       torch.eye(3), t0)) == float("inf")


def test_target_from_moment_table_matches_jax(scene):
    """The icp_vox_inc target: planes derived from a floor-binned moment
    table carried across from JAX are JAX's planes; the derived target
    matches like JAX's."""
    tgt, src, _ = scene
    dims = (64, 64, 32)
    jio = jicp.IcpOptions(method="p2plane_vox", dense_dims=dims)
    tio = icp.IcpOptions(method="p2plane_vox", dense_dims=dims)
    jno = jndt.NdtOptions(method="incremental", voxel_size=1.0, bin_mode="floor",
                          dense_dims=dims, map_capacity=2048)
    jm = jndt.update_incremental(jndt.empty_incremental(jno), jpc.from_numpy(tgt, capacity=2048),
                                 jno)
    m = _carried(jm)
    jt = jicp.target_from_moment_table(jm.keys, jm.count, jm.mean, jm.cov, jm.dense_table,
                                       jm.dense_lo, jm.origin, jio, dims)
    tt = icp.target_from_moment_table(m.keys, m.count, m.mean, m.cov, m.dense_table,
                                      m.dense_lo, m.origin, tio, dims)
    jv, tv = np.asarray(jt.plane_valid), tt.plane_valid.numpy()
    assert jv.sum() > 20 and (jv != tv).sum() <= 0.005 * len(jv)
    both = jv & tv
    jp, tp = np.asarray(jt.plane)[both], tt.plane.numpy()[both]
    sign = np.where(np.sum(jp[:, :3] * tp[:, :3], axis=1) < 0, -1.0, 1.0)[:, None]
    # normals within 3 u s / gap per voxel, the float32 conditioning of the
    # raw-moment neighbor merge (test_torch_icp.py's LiDAR bound), here
    # from the float64 merge of the same table (measured: at most 1.88)
    _, mu64, cov64 = icp._merge_neighbor_moments(m.keys, m.count.double(), m.mean.double(),
                                                 m.cov.double(), tt.dense, dims)
    vals = np.linalg.eigvalsh(cov64.numpy())
    s = np.sum(mu64.numpy() ** 2, axis=1) + np.trace(cov64.numpy(), axis1=1, axis2=2)
    cond = (U * s / np.maximum(vals[:, 1] - vals[:, 0], 1e-300))[both]
    dn = np.abs(tp[:, :3] * sign - jp[:, :3]).max(axis=1)
    assert (dn <= 3.0 * cond + 1e-5).all(), (dn / cond).max()
    np.testing.assert_array_equal(tt.grid.voxel_keys.numpy(), np.asarray(jt.grid.voxel_keys))
    assert int(tt.grid.num_voxels) == int(jt.grid.num_voxels)
    jr = jicp.scan_match(jt, jio, jpc.from_numpy(src, capacity=2048), jnp.eye(3), jnp.zeros(3))
    tr = icp.scan_match(tt, tio, _from_numpy(src, capacity=2048), torch.eye(3), torch.zeros(3))
    assert tr.iterations == int(jr.iterations)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-3)
    assert jvoxel.INVALID_KEY == voxel.INVALID_KEY
