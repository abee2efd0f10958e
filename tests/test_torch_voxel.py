"""Port parity: loc_lib_tpu_torch.ops.voxel / pointcloud against the JAX
package on the tests/test_voxel.py cases. Integers (keys, sort order, slots,
counts, bucket contents) must match exactly; floats within atol 1e-5
(both sides add each voxel's points sequentially in sorted order)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from loc_lib_tpu.ops import pointcloud as jpc, voxel as jvox
from loc_lib_tpu_torch.ops import pointcloud as pcm, voxel

torch.set_num_threads(2)


def _from_numpy(*args, **kwargs):
    """pointcloud.from_numpy on the CPU (its default device is the card)."""
    return pcm.from_numpy(*args, device="cpu", **kwargs)

ATOL = 1e-5


def _clouds(pts, capacity):
    return jpc.from_numpy(pts, capacity=capacity), _from_numpy(pts, capacity=capacity)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_pointcloud_round_trip_and_padding():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-10, 10, size=(300, 3)).astype(np.float32)
    pts[5] = np.nan                                 # dropped, like the reference
    j, t = _clouds(pts, 512)
    np.testing.assert_array_equal(t.xyz.numpy(), np.asarray(j.xyz))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_array_equal(pcm.to_numpy(t), jpc.to_numpy(j))
    assert int(t.count()) == 299 and t.capacity == 512
    with pytest.raises(ValueError):
        _from_numpy(pts, capacity=16)


def test_keys_coords_and_segments_match_jax():
    rng = np.random.default_rng(5)
    coords = rng.integers(-600, 600, size=(500, 3)).astype(np.int32)
    valid = rng.uniform(size=500) < 0.9
    k_t = voxel.coords_to_key(torch.from_numpy(coords), torch.from_numpy(valid))
    k_j = jvox.coords_to_key(jnp.asarray(coords), jnp.asarray(valid))
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    live = k_t != voxel.INVALID_KEY
    np.testing.assert_array_equal(voxel.key_to_coords(k_t)[live].numpy(), coords[live.numpy()])
    # stable sort: duplicated keys keep point order, like jnp.argsort
    dup = torch.cat([k_t, k_t[:100]])
    seg = voxel._segment_by_key(dup)
    jseg = jvox._segment_by_key(jnp.asarray(dup.numpy()))
    for a, b in zip(seg, jseg):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


@pytest.mark.parametrize("origin", [None, (0.3, -0.2, 0.1)])
def test_voxel_downsample_matches_jax(origin):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-10, 10, size=(300, 3)).astype(np.float32)
    j, t = _clouds(pts, 512)
    jo = None if origin is None else jnp.asarray(origin, jnp.float32)
    to = None if origin is None else torch.tensor(origin, dtype=torch.float32)
    jd = jvox.voxel_downsample(j, 1.0, origin=jo)
    td = voxel.voxel_downsample(t, 1.0, origin=to)
    np.testing.assert_array_equal(td.mask.numpy(), np.asarray(jd.mask))
    np.testing.assert_allclose(td.xyz.numpy(), np.asarray(jd.xyz), atol=ATOL)


def test_hash_grid_and_stats_match_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-3, 3, size=(400, 3)).astype(np.float32)
    pts[:40] = pts[0] + rng.uniform(0, 0.05, size=(40, 3))   # overflowing bucket
    j, t = _clouds(pts, 512)
    jg, js = jvox.build_hash_grid_with_stats(j, 1.0, 8)
    tg, ts = voxel.build_hash_grid_with_stats(t, 1.0, 8)
    for name in ("voxel_keys", "bucket_idx", "bucket_cnt", "num_voxels", "overflow"):
        np.testing.assert_array_equal(_np(getattr(tg, name)), np.asarray(getattr(jg, name)), name)
    assert int(tg.overflow) > 0
    np.testing.assert_array_equal(tg.bucket_xyz.numpy(), np.asarray(jg.bucket_xyz))
    np.testing.assert_array_equal(ts.keys.numpy(), np.asarray(js.keys))
    for name in ("count", "mean", "cov"):
        np.testing.assert_allclose(_np(getattr(ts, name)), np.asarray(getattr(js, name)),
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("mode", ["trunc", "floor"])
def test_voxel_stats_match_jax(mode):
    rng = np.random.default_rng(3)
    pts = rng.uniform(-2, 3, size=(200, 3)).astype(np.float32)
    j, t = _clouds(pts, 256)
    js = jvox.voxel_stats(j, 1.0, mode=mode)
    ts = voxel.voxel_stats(t, 1.0, mode=mode)
    np.testing.assert_array_equal(ts.keys.numpy(), np.asarray(js.keys))
    for name in ("count", "mean", "cov"):
        np.testing.assert_allclose(_np(getattr(ts, name)), np.asarray(getattr(js, name)),
                                   atol=ATOL, err_msg=name)


def test_dense_index_and_lookup_match_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-20, 20, size=(500, 3)).astype(np.float32)
    pts[0] = (100.5, 0.5, 0.5)                      # outside the dense window
    j, t = _clouds(pts, 512)
    jg = jvox.build_hash_grid(j, 1.0, bucket_size=8)
    tg, _ = voxel.build_hash_grid_with_stats(t, 1.0, bucket_size=8)
    jd = jvox.build_dense_index(jg.voxel_keys, dims=(64, 64, 64))
    td = voxel.build_dense_index(tg.voxel_keys, dims=(64, 64, 64))
    np.testing.assert_array_equal(td.table.numpy(), np.asarray(jd.table))
    np.testing.assert_array_equal(td.lo.numpy(), np.asarray(jd.lo))
    queries = rng.uniform(-25, 25, size=(300, 3)).astype(np.float32)
    queries[:10] = pts[:10]
    keys_t = voxel.coords_to_key(voxel.voxel_coords(torch.from_numpy(queries), tg.inv_leaf,
                                                    tg.origin), torch.ones(300, dtype=torch.bool))
    keys_j = jvox.coords_to_key(jvox.voxel_coords(jnp.asarray(queries), jg.inv_leaf, jg.origin),
                                jnp.ones((300,), bool))
    np.testing.assert_array_equal(keys_t.numpy(), np.asarray(keys_j))
    for a, b in zip(voxel.lookup_dense(td, (64, 64, 64), keys_t),
                    jvox.lookup_dense(jd, (64, 64, 64), keys_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # empty key set: everything INVALID, nothing found, no error
    empty = torch.full((16,), voxel.INVALID_KEY, dtype=torch.int32)
    ed = voxel.build_dense_index(empty, dims=(8, 8, 8))
    assert torch.all(ed.table == -1)
    assert not voxel.lookup_dense(ed, (8, 8, 8), keys_t)[1].any()


def _index_add_sum(values, seg_id, n):
    """The segment sum the port used before: a float index_add_ in row
    order (sequential on the CPU)."""
    return torch.zeros((n,) + values.shape[1:], dtype=values.dtype).index_add_(0, seg_id, values)


@pytest.mark.parametrize("what", ["downsample", "stats", "grid_count", "rebuild"])
def test_segment_sums_are_bit_equal_to_index_add(what):
    """On the CPU the run-wise segment sum (voxel.segment_sum, which is
    serial per run on CUDA too and so gives the same bits on every run
    there) equals the float index_add_ it replaced bit for bit, trailing
    padding rows (INVALID_KEY) included: every moment a map is built from
    is unchanged."""
    rng = np.random.default_rng(12)
    pts = (rng.uniform(-8, 8, size=(1500, 3)) * [1, 1, 0.1]).astype(np.float32)
    t = _from_numpy(pts, capacity=2048)
    inv = torch.tensor(1.0)
    origin = torch.tensor([0.25, -0.5, 0.0])
    keys = voxel.coords_to_key(voxel.voxel_coords(t.xyz, inv, origin), t.mask)
    seg = voxel._segment_by_key(keys)
    n = t.capacity
    pts_s = t.xyz[seg.order]
    w = (seg.sorted_keys != voxel.INVALID_KEY).to(torch.float32)
    if what == "downsample":
        ds = voxel.voxel_downsample(t, 1.0, origin=origin)
        sums = _index_add_sum(pts_s * w[:, None], seg.seg_id, n)
        cnts = _index_add_sum(w, seg.seg_id, n)
        ref = torch.where((cnts > 0)[:, None], sums / torch.clamp(cnts, min=1.0)[:, None],
                          pcm.PAD_COORD)
        assert torch.equal(ds.xyz, ref) and torch.equal(ds.mask, cnts > 0)
    elif what == "stats":
        st = voxel.voxel_stats(t, 1.0, origin, mode="floor")
        pw = pts_s * w[:, None]
        cnt = _index_add_sum(w, seg.seg_id, n)
        s1 = _index_add_sum(pw, seg.seg_id, n)
        s2 = _index_add_sum(pw[:, :, None] * pts_s[:, None, :], seg.seg_id, n)
        mean = s1 / torch.clamp(cnt, min=1.0)[:, None]
        cov = (s2 - cnt[:, None, None] * mean[:, :, None] * mean[:, None, :]) \
            / torch.clamp(cnt - 1.0, min=1.0)[:, None, None]
        assert int((cnt > 1).sum()) > 100
        for got, want in ((st.count, cnt), (st.mean, mean), (st.cov, cov)):
            assert torch.equal(got, want)
    elif what == "grid_count":
        grid, _ = voxel.build_hash_grid_with_stats(t, 1.0, 4, origin)
        want = _index_add_sum((seg.sorted_keys != voxel.INVALID_KEY).to(torch.int32),
                              seg.seg_id, n)
        assert int(grid.overflow) > 0
        assert torch.equal(grid.bucket_cnt, torch.clamp(want, max=4))
    else:
        from loc_lib_tpu_torch.models import ndt
        st = voxel.voxel_stats(t, 1.0, origin, mode="floor")
        keys2 = torch.cat([st.keys, st.keys[:300]])
        cnt = torch.cat([st.count, st.count[:300]])
        mean = torch.cat([st.mean, st.mean[:300] + 0.01])
        cov = torch.cat([st.cov, st.cov[:300]])
        m = ndt.rebuild_from_moments(keys2, cnt, mean, cov, torch.zeros_like(cnt, dtype=torch.bool),
                                     torch.zeros_like(keys2), 1, origin,
                                     ndt.NdtOptions(map_capacity=4096, use_fused=False))
        order = torch.argsort(keys2, stable=True)
        k, c, mu, cv = keys2[order], cnt[order], mean[order], cov[order]
        c = torch.where(k != voxel.INVALID_KEY, c, 0.0)
        sid = torch.cumsum(torch.cat([torch.ones(1, dtype=torch.bool), k[1:] != k[:-1]]).long(),
                           0) - 1
        c_sum = _index_add_sum(c, sid, k.shape[0])
        s1 = _index_add_sum(c[:, None] * mu, sid, k.shape[0])
        live = c_sum > 0                   # INVALID_KEY rows carry c = 0
        assert int(live.sum()) == int((m.keys != voxel.INVALID_KEY).sum()) > 100
        # the surviving rows come out key-sorted, as the live segments are
        assert torch.equal(m.count[:int(live.sum())], c_sum[live])
        assert torch.equal(m.mean[:int(live.sum())],
                           (s1 / torch.clamp(c_sum, min=1.0)[:, None])[live])


def test_nearby6_and_center1_are_made_once_per_device():
    """The stencils are cached per device: the hot loop gets the same tensor
    back and copies nothing from the host."""
    dev = torch.device("cpu")
    a, b = voxel.nearby6(dev), voxel.nearby6(torch.zeros(1).device)
    assert a is b and a.dtype == torch.int32
    assert a.tolist() == [[0, 0, 0], [-1, 0, 0], [1, 0, 0], [0, 1, 0], [0, -1, 0],
                          [0, 0, -1], [0, 0, 1]]
    assert voxel.center1(dev) is voxel.center1(dev)


def test_from_numpy_and_render_scan_default_to_the_card():
    """Without a device argument the cloud goes to the first CUDA card;
    where there is none that raises: no silent fall back to the CPU.
    device="cpu" is how the CPU is asked for."""
    from loc_lib_tpu_torch.io import synthetic

    pts = np.random.default_rng(0).uniform(-1, 1, (50, 3)).astype(np.float32)
    world = synthetic.make_world(num_points=2000, extent=20.0, seed=1)
    traj = synthetic.make_trajectory(num_frames=1)
    render = lambda **kw: synthetic.render_scan(world, traj.R[0], traj.t[0], max_points=256, **kw)
    if torch.cuda.is_available():
        assert pcm.from_numpy(pts).device == torch.device("cuda", 0)
        assert render().device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pcm.from_numpy(pts)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            render()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pcm.card_device()
    assert pcm.from_numpy(pts, device="cpu").device.type == "cpu"
    assert render(device="cpu").device.type == "cpu"
    assert pcm.card_device("cpu") == torch.device("cpu")
