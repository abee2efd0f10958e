"""Port parity: the leaves (loc_lib_tpu_torch.ops.filters, ops.bfnn,
ops.ring_search, models.reflector) against the JAX package on the CPU, on
the workloads of tests/test_small_ops.py and tests/test_voxel.py.

Stated tolerances:
  * filters: masks equal;
  * bfnn: indices equal to JAX's, ties included (the lower target index
    first), distances within the float32 expansion's rounding,
    4 u (|q|^2 + max |t|^2) with u = 2^-24, of JAX's (the two packages'
    matrix products differ in the last bit) and of a float64 numpy oracle;
  * organize_rings: image and validity bit-equal to JAX's (a collision of
    equal ranges included: the higher point index wins, as XLA's
    sequential scatter gives on the CPU); ring_window_nn bit-equal;
  * scan_match_rings: within 1e-4 m / 1e-4 rad of JAX's pose, the same
    effective count within 0.5%, and within 3 cm of the true motion;
  * reflector: detections bit-equal, the same matches, the pose fix within
    1e-5 of JAX's and within 2e-2 rad / 5 cm of the truth.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loc_lib_tpu.models import reflector as jrefl
from loc_lib_tpu.ops import bfnn as jbfnn, filters as jfilters, pointcloud as jpc
from loc_lib_tpu.ops import ring_search as jrs, voxel as jvoxel
from loc_lib_tpu.utils import lie as jlie
from loc_lib_tpu_torch.models import reflector
from loc_lib_tpu_torch.ops import bfnn, filters, pointcloud as pcm, ring_search, voxel

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _pc(xyz, mask):
    return pcm.PointCloud(xyz=_t(np.asarray(xyz, np.float32)), mask=_t(np.asarray(mask)))


def _jpc(xyz, mask):
    return jpc.PointCloud(xyz=jnp.asarray(np.asarray(xyz, np.float32)), mask=jnp.asarray(mask))


# ---------------------------------------------------------------------------
# Filters
# ---------------------------------------------------------------------------

_FILTER_XYZ = np.array([[0.0, 0, 0], [1, 1, 1], [5, 5, 5], [1e6, 0, 0], [0.5, 0.5, 0.5]],
                       np.float32)


def _filter_cases():
    rng = np.random.default_rng(3)
    cloud = rng.uniform(-6, 6, (400, 3)).astype(np.float32)
    mask = rng.random(400) > 0.2
    return {"test_small_ops": (_FILTER_XYZ, np.ones(5, bool)), "random": (cloud, mask)}


@pytest.mark.parametrize("case", ["test_small_ops", "random"])
def test_filters_match_jax(case):
    xyz, mask = _filter_cases()[case]
    pc, jp = _pc(xyz, mask), _jpc(xyz, mask)
    for port, ref in (
            (filters.box_filter(pc, [0.5, 0.5, 0.5], [2, 2, 2]),
             jfilters.box_filter(jp, [0.5, 0.5, 0.5], [2, 2, 2])),
            (filters.box_filter(pc, [1.0, -2.0, 0.0], [6, 5, 4]),
             jfilters.box_filter(jp, [1.0, -2.0, 0.0], [6, 5, 4])),
            (filters.range_filter(pc, 0.5, 3.0), jfilters.range_filter(jp, 0.5, 3.0)),
            (filters.range_filter(pc, 2.0), jfilters.range_filter(jp, 2.0))):
        np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
    assert filters.no_filter(pc) is pc
    assert filters.voxel_downsample is voxel.voxel_downsample


def test_remove_nonfinite_matches_jax():
    xyz = _FILTER_XYZ.copy()
    xyz[3, 0] = np.nan
    xyz[1, 2] = np.inf
    got = filters.remove_nonfinite(_pc(xyz, np.ones(5, bool))).mask.numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jfilters.remove_nonfinite(_jpc(xyz, np.ones(5, bool))).mask))
    np.testing.assert_array_equal(got, [True, False, True, False, True])


# ---------------------------------------------------------------------------
# bfnn
# ---------------------------------------------------------------------------

def _bfnn_case(name):
    """(target, target mask, queries): test_voxel.py:158's workload, and an
    integer lattice whose float32 distances are exact, so every tie is
    real (each query sits at equal distance from several targets)."""
    rng = np.random.default_rng(5)
    if name == "test_voxel":
        tgt = rng.uniform(-8, 8, (300, 3)).astype(np.float32)
        tgt = np.concatenate([tgt, np.full((212, 3), 1e6, np.float32)])
        return tgt, np.arange(512) < 300, rng.uniform(-8, 8, (64, 3)).astype(np.float32)
    g = np.arange(-3, 4, dtype=np.float32)
    tgt = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    tgt = np.concatenate([tgt, tgt[:40]])                  # duplicated points: exact ties
    mask = np.ones(len(tgt), bool)
    mask[::7] = False
    q = rng.integers(-3, 4, (48, 3)).astype(np.float32) + 0.5 * rng.integers(0, 2, (48, 3))
    return tgt, mask, q.astype(np.float32)


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("case", ["test_voxel", "lattice_ties"])
def test_bfnn_knn_matches_jax_and_float64(case, k):
    tgt, tmask, q = _bfnn_case(case)
    qmask = np.ones(len(q), bool)
    qmask[-3:] = False
    pts, idx, d2, valid = bfnn.knn(_pc(tgt, tmask), _t(q), _t(qmask), k=k, tile=16)
    jpts, jidx, jd2, jvalid = jbfnn.knn(_jpc(tgt, tmask), jnp.asarray(q), jnp.asarray(qmask), k=k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
    t64, q64 = tgt.astype(np.float64), q.astype(np.float64)
    tol = 4 * 2.0 ** -24 * (np.sum(q64 ** 2, 1)[:, None] + np.max(np.sum(t64[tmask] ** 2, 1)))
    v = valid.numpy()
    tol = tol.repeat(k, 1)[v]
    assert np.all(np.abs(d2.numpy()[v] - np.asarray(jd2)[v]) <= tol)
    # float64 oracle: the returned distances are the k smallest
    ref = np.sum((t64[None] - q64[:, None]) ** 2, -1)
    want = np.sort(np.where(tmask[None], ref, np.inf), axis=1)[:, :k]
    assert np.all(np.abs(d2.numpy()[v] - want[v]) <= tol)
    assert not v[-3:].any()
    p, i, dd, vv = bfnn.nn1(_pc(tgt, tmask), _t(q), _t(qmask))
    np.testing.assert_array_equal(i.numpy(), idx.numpy()[:, 0])


def test_bfnn_lower_index_wins_ties():
    tgt = np.array([[1.0, 0, 0], [-1.0, 0, 0], [0, 1.0, 0], [1.0, 0, 0]], np.float32)
    _, idx, d2, _ = bfnn.knn(_pc(tgt, np.ones(4, bool)), torch.zeros((1, 3)),
                             torch.ones((1,), dtype=torch.bool), k=4)
    assert idx.tolist() == [[0, 1, 2, 3]]
    assert d2.tolist() == [[1.0, 1.0, 1.0, 1.0]]


def test_bfnn_upper_bounds_the_grid_knn():
    """The grid knn (exact within its 3x3x3 stencil) never finds a nearer
    neighbour than the oracle."""
    tgt, tmask, q = _bfnn_case("test_voxel")
    pc = _pc(tgt, tmask)
    qm = torch.ones((len(q),), dtype=torch.bool)
    _, _, d2, _ = bfnn.knn(pc, _t(q), qm, k=3)
    _, _, gd2, gvalid = voxel.knn(voxel.build_hash_grid(pc, 1.0, bucket_size=8), _t(q), qm, 3)
    g = gvalid.numpy()
    assert g.any()
    assert (gd2.numpy()[g] >= d2.numpy()[g] - 1e-4).all()


# ---------------------------------------------------------------------------
# Ring search
# ---------------------------------------------------------------------------

def _ring_scan(R_w=None, t_w=None, num_rings=8, ring_len=256, seed=0):
    """tests/test_small_ops.py's cylindrical room scan."""
    rng = np.random.default_rng(seed)
    az = (np.arange(ring_len) + 0.5) / ring_len * 2 * np.pi - np.pi
    pts, ring = [], []
    for r in range(num_rings):
        el = -0.2 + 0.05 * r
        radius = 8.0 + 0.5 * np.sin(3 * az) + rng.normal(0, 0.01, ring_len)
        p = np.stack([radius * np.cos(az), radius * np.sin(az), radius * el], 1)
        if R_w is not None:
            p = (p - t_w) @ R_w
        pts.append(p)
        ring.append(np.full(ring_len, r, np.int32))
    return np.concatenate(pts).astype(np.float32), np.concatenate(ring).astype(np.int32)


def _images(xyz, ring, mask, R, C):
    port = ring_search.organize_rings(_t(xyz), _t(ring), _t(mask), R, C)
    ref = jrs.organize_rings(jnp.asarray(xyz), jnp.asarray(ring), jnp.asarray(mask), R, C)
    return port, ref


@pytest.mark.parametrize("ring_len", [256, 1024])
def test_organize_rings_matches_jax(ring_len):
    xyz, ring = _ring_scan(ring_len=256)
    rng = np.random.default_rng(1)
    # collisions: jittered copies of some points (nearer or farther), two
    # exact duplicates (equal ranges), rings out of range, masked points
    extra = xyz[:64] * rng.uniform(0.98, 1.02, (64, 1)).astype(np.float32)
    xyz2 = np.concatenate([xyz, extra, xyz[100:102]])
    ring2 = np.concatenate([ring, ring[:64], ring[100:102]])
    ring2[5] = -1
    ring2[6] = 8
    mask = np.ones(len(xyz2), bool)
    mask[7] = False
    port, ref = _images(xyz2, ring2, mask, 8, ring_len)
    np.testing.assert_array_equal(port.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(port.xyz.numpy(), np.asarray(ref.xyz))
    if ring_len == 256:
        assert int(port.valid.sum()) > 0.9 * len(xyz)


def test_organize_rings_equal_ranges_higher_index_wins():
    """Two points of one cell with the same range: the higher point index
    takes the cell (pinned; XLA's sequential scatter on the CPU agrees)."""
    a = np.array([1.0, 2.0, 2.0], np.float32)     # range 3, one 90-degree column
    b = np.array([2.0, 1.0, 2.0], np.float32)
    xyz = np.stack([a, b, a * 2])
    ring = np.zeros(3, np.int32)
    port, ref = _images(xyz, ring, np.ones(3, bool), 1, 4)
    np.testing.assert_array_equal(port.xyz.numpy()[0, 2], b)
    np.testing.assert_array_equal(port.xyz.numpy(), np.asarray(ref.xyz))


def test_ring_window_nn_matches_jax():
    xyz0, ring = _ring_scan()
    R_w = np.asarray(jlie.so3_exp(jnp.array([0.0, 0.0, 0.01], jnp.float32)))
    xyz1, _ = _ring_scan(R_w=R_w, t_w=np.array([0.05, 0.02, 0.0], np.float32))
    mask = np.ones(len(xyz0), bool)
    p0, j0 = _images(xyz0, ring, mask, 8, 256)
    p1, j1 = _images(xyz1, ring, mask, 8, 256)
    nn, d2, found = ring_search.ring_window_nn(p0, p1)
    jnn, jd2, jfound = jrs.ring_window_nn(j0, j1)
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jd2))
    np.testing.assert_array_equal(nn.numpy(), np.asarray(jnn))
    # self-NN at zero offset: every valid cell finds itself at distance 0
    _, d2s, fs = ring_search.ring_window_nn(p0, p0, 1, 2)
    v = p0.valid.numpy()
    assert fs.numpy()[v].all() and float(d2s.numpy()[v].max()) == 0.0


def test_scan_match_rings_matches_jax_and_recovers_pose():
    xyz0, ring = _ring_scan()
    R_w = np.asarray(jlie.so3_exp(jnp.array([0.0, 0.0, 0.01], jnp.float32)))
    t_w = np.array([0.05, 0.02, 0.0], np.float32)
    xyz1, _ = _ring_scan(R_w=R_w, t_w=t_w)
    mask = np.ones(len(xyz0), bool)
    p0, j0 = _images(xyz0, ring, mask, 8, 256)
    p1, j1 = _images(xyz1, ring, mask, 8, 256)
    kw = dict(num_rings=8, ring_len=256, eps=1e-4, max_iteration=40)
    res = ring_search.scan_match_rings(p0, p1, ring_search.RingOptions(**kw))
    ref = jrs.scan_match_rings(j0, j1, jrs.RingOptions(**kw))
    assert np.linalg.norm(res.t.numpy() - t_w) < 0.03
    np.testing.assert_allclose(res.t.numpy(), np.asarray(ref.t), atol=1e-4)
    np.testing.assert_allclose(res.R.numpy(), np.asarray(ref.R), atol=1e-4)
    assert abs(int(res.num_effective) - int(ref.num_effective)) <= 0.005 * int(ref.num_effective)
    assert int(res.num_effective) > 500
    assert bool(res.converged) == bool(ref.converged)


# ---------------------------------------------------------------------------
# Reflector
# ---------------------------------------------------------------------------

def _reflector_scan(theta=0.3, tx=0.4, ty=-0.2):
    """tests/test_small_ops.py:91's scene: four markers, robot at
    (theta, tx, ty), 720 beams."""
    map_xy = np.array([[2.0, 0.0], [0.0, 3.0], [-2.5, -1.0], [3.0, 2.5]], np.float32)
    c, s = np.cos(theta), np.sin(theta)
    m_r = (map_xy - [tx, ty]) @ np.array([[c, -s], [s, c]])
    B = 720
    angles = ((np.arange(B) + 0.5) / B * 2 * np.pi - np.pi).astype(np.float32)
    ranges = np.full(B, 5.5, np.float32)
    intensity = np.full(B, 5.0, np.float32)
    for mx, my in m_r:
        a, r = np.arctan2(my, mx), np.hypot(mx, my)
        half = max(int(round(0.03 / r / (2 * np.pi / B))), 1)
        i0 = int(np.round((a + np.pi) / (2 * np.pi) * B))
        for k in range(i0 - half, i0 + half + 1):
            ranges[k % B] = r
            intensity[k % B] = 200.0
    return map_xy, ranges, angles, intensity


@pytest.mark.parametrize("pose", [(0.3, 0.4, -0.2), (-0.8, -0.3, 0.25)])
def test_reflector_matches_jax_and_recovers_pose(pose):
    map_xy, ranges, angles, intensity = _reflector_scan(*pose)
    valid = np.ones(len(ranges), bool)
    args = [_t(x) for x in (ranges, angles, intensity, valid)]
    jargs = [jnp.asarray(x) for x in (ranges, angles, intensity, valid)]
    det = reflector.detect_markers(*args)
    jdet = jrefl.detect_markers(*jargs)
    np.testing.assert_array_equal(det.valid.numpy(), np.asarray(jdet.valid))
    np.testing.assert_array_equal(det.weight.numpy(), np.asarray(jdet.weight))
    np.testing.assert_array_equal(det.xy.numpy(), np.asarray(jdet.xy))
    assert int(det.valid.sum()) >= 3
    mv = torch.ones((4,), dtype=torch.bool)
    m = reflector.match_markers(det, _t(map_xy), mv)
    jm = jrefl.match_markers(jdet, jnp.asarray(map_xy), jnp.ones((4,), bool))
    np.testing.assert_array_equal(m.pairs.numpy(), np.asarray(jm.pairs))
    np.testing.assert_array_equal(m.votes.numpy(), np.asarray(jm.votes))
    assert int(m.num_matched) == int(jm.num_matched) >= 3
    fix = reflector.process_scan(*args, _t(map_xy), mv)
    jfix = jrefl.estimate_pose(jdet, jnp.asarray(map_xy), jm)
    np.testing.assert_allclose(float(fix.theta), float(jfix.theta), atol=1e-5)
    np.testing.assert_allclose(fix.t.numpy(), np.asarray(jfix.t), atol=1e-5)
    assert bool(fix.ok) and int(fix.num_inliers) == int(jfix.num_inliers)
    assert abs(float(fix.theta) - pose[0]) < 0.02
    np.testing.assert_allclose(fix.t.numpy(), pose[1:], atol=0.05)


def test_reflector_top_markers_keep_the_lower_cluster_on_ties():
    """More equal-width clusters than max_markers: the first clusters of the
    scan are kept, as jax.lax.top_k keeps the lower index."""
    B = 400
    angles = np.linspace(-1.0, 1.0, B).astype(np.float32)
    ranges = np.full(B, 2.0, np.float32)
    intensity = np.zeros(B, np.float32)
    for c in range(10):
        intensity[20 + 30 * c: 23 + 30 * c] = 200.0        # ten 3-beam clusters
    opts = reflector.ReflectorOptions(max_markers=4, width_min=0.0, width_max=1.0)
    jopts = jrefl.ReflectorOptions(max_markers=4, width_min=0.0, width_max=1.0)
    args = [_t(x) for x in (ranges, angles, intensity, np.ones(B, bool))]
    det = reflector.detect_markers(*args, opts)
    jdet = jrefl.detect_markers(*[jnp.asarray(a.numpy()) for a in args], jopts)
    np.testing.assert_array_equal(det.xy.numpy(), np.asarray(jdet.xy))
    assert det.valid.all()
    np.testing.assert_allclose(det.xy.numpy()[:, 1], 2.0 * np.sin(angles[[21, 51, 81, 111]]),
                               atol=1e-4)
