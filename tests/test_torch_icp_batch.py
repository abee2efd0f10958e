"""Port parity: batched matching (icp.set_target_batch, scan_match_batch,
scan_match_batch_chunked) against the port's own scalar scan_match and
against the JAX package's batch, on the tests/test_icp.py workloads.

Stated tolerances:
  * port batch against port scalar: BIT-IDENTICAL lane by lane (R, t,
    converged, num_effective, chi2, iterations), the reference's contract
    (tests/test_icp.py:470 asserts it for JAX). On the CPU a lane's
    linearization is the kernel's plain version; the 6x6 solve, and the
    plain versions of the pose update and the final projection
    (kernels.gn_step_plain, so3_renormalize_plain, on lie.matmul3) are
    written so that a lane's bits do not depend on B;
  * port batch against JAX's batch on stacked targets carried across with
    io/convert: equal iterations and effective counts, pose within 1e-4 rad
    / 1e-4 m, the scalar parity rule of test_torch_icp.py;
  * the converged tail at keyframe density (test_icp.py:596, cut from B = 64
    to B = 8 lanes to keep the suite quick; B = 64 runs on the card): every
    lane under 3 cm of the ground truth, median num_effective > 700.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loc_lib_tpu.models import icp as jicp
from loc_lib_tpu.ops import pointcloud as jpc
from loc_lib_tpu_torch.io import convert, synthetic
from loc_lib_tpu_torch.models import icp
from loc_lib_tpu_torch.ops import kernels, pointcloud as pcm
import oracles

torch.set_num_threads(2)

DIMS = (64, 64, 32)


def _structured_scene(rng, n=600):
    a = np.stack([rng.uniform(-10, 10, n), rng.uniform(-10, 10, n), np.zeros(n)], 1)
    b = np.stack([rng.uniform(-10, 10, n), np.full(n, -10.0), rng.uniform(0, 5, n)], 1)
    c = np.stack([np.full(n, -10.0), rng.uniform(-10, 10, n), rng.uniform(0, 5, n)], 1)
    return np.concatenate([a, b, c]).astype(np.float32)


def _pairs(B=3, seed=11, rot=0.02, trans=0.2):
    """test_icp.py:470's workload: B scenes, each seen from its own pose."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        scene = _structured_scene(rng)
        R_true = oracles.so3_exp(rot * rng.standard_normal(3))
        t_true = trans * rng.standard_normal(3)
        out.append((scene, ((scene - t_true) @ R_true).astype(np.float32), R_true, t_true))
    return out


def _cloud(pts, capacity=2048):
    return pcm.from_numpy(pts, capacity=capacity, device="cpu")._replace(stamp=None)


def _stacked(pairs, capacity=2048):
    tgts = [_cloud(p[0], capacity) for p in pairs]
    srcs = [_cloud(p[1], capacity) for p in pairs]
    return tgts, srcs, icp.stack_lanes(tgts), icp.stack_lanes(srcs)


def _identity(B):
    return torch.eye(3).expand(B, 3, 3).contiguous(), torch.zeros(B, 3)


def _assert_lane_equals_scalar(res_b, b, res_s):
    assert torch.equal(res_s.R, res_b.R[b]) and torch.equal(res_s.t, res_b.t[b]), b
    assert res_s.iterations == int(res_b.iterations[b]), b
    assert bool(res_s.converged) == bool(res_b.converged[b]), b
    assert int(res_s.num_effective) == int(res_b.num_effective[b]), b
    assert torch.equal(res_s.chi2, res_b.chi2[b]), b


def _assert_batch_equals_scalar(opts, targets, srcs, R0, t0, res):
    B = R0.shape[0]
    assert res.iterations.shape == (B,) and res.iterations.dtype == torch.int32
    assert res.R.shape == (B, 3, 3) and res.t.shape == (B, 3)
    assert res.converged.shape == res.num_effective.shape == res.chi2.shape == (B,)
    for b in range(B):
        _assert_lane_equals_scalar(res, b, icp.scan_match(
            icp.take_lane(targets, b), opts, icp.take_lane(srcs, b), R0[b], t0[b]))


@pytest.mark.parametrize("method", ["p2plane_vox", "p2plane_vox_oct", "p2line_vox", "p2plane",
                                    "p2p"])
def test_scan_match_batch_is_bit_identical_to_scalar(method):
    """test_icp.py:470 (B = 3, dense_dims (64, 64, 32)) for every method the
    batch loop runs: the two with a batched kernel, and p2line_vox and the
    knn methods lane by lane through their scalar linearization. Lane b of
    set_target_batch equals set_target of lane b, leaf by leaf."""
    opts = icp.IcpOptions(method=method, dense_dims=DIMS)
    tgts, srcs, bt, bs = _stacked(_pairs())
    targets = icp.set_target_batch(bt, opts)
    for b in range(3):
        own = icp.set_target(tgts[b], opts)
        icp.tree_map(lambda x, y: np.testing.assert_array_equal(x.numpy(), y.numpy()),
                     icp.take_lane(targets, b), own)
    R0, t0 = _identity(3)
    res = icp.scan_match_batch(targets, opts, bs, R0, t0)
    _assert_batch_equals_scalar(opts, targets, bs, R0, t0, res)
    assert bool(res.converged.all())


@pytest.mark.parametrize("method", ["p2plane_vox", "p2plane_vox_oct"])
def test_scan_match_batch_matches_jax_batch_on_carried_targets(method):
    """JAX builds the stacked targets (set_target_batch under vmap);
    io/convert carries them across with their leading B axis; both packages
    run their batched match on the same tables."""
    jo = jicp.IcpOptions(method=method, dense_dims=DIMS)
    to = icp.IcpOptions(method=method, dense_dims=DIMS)
    pairs = _pairs()
    stack = lambda xs: jax.tree_util.tree_map(lambda *a: jnp.stack(a), *xs)
    jt = jicp.set_target_batch(stack([jpc.from_numpy(p[0], capacity=2048) for p in pairs]), jo)
    jres = jicp.scan_match_batch(jt, jo, stack([jpc.from_numpy(p[1], capacity=2048)
                                                for p in pairs]),
                                 jnp.stack([jnp.eye(3)] * 3), jnp.zeros((3, 3)))
    tt = convert.icp_target_from_numpy(jax.tree_util.tree_map(np.asarray, jt)._asdict(), "cpu")
    assert tt.packed.shape == (3, 2048, 8) and tt.dense.table.shape == (3, 64 * 64 * 32)
    assert tt.grid.origin.shape == (3, 3) and tt.grid.inv_leaf.shape == (3,)
    if method == "p2plane_vox_oct":
        assert tt.oct_table.shape == (3, 7 * 2048, 8) and tt.packed_ext.shape == (3, 2049, 8)
    _, _, _, bs = _stacked(pairs)
    R0, t0 = _identity(3)
    tres = icp.scan_match_batch(tt, to, bs, R0, t0)
    np.testing.assert_array_equal(tres.iterations.numpy(), np.asarray(jres.iterations))
    np.testing.assert_array_equal(tres.num_effective.numpy(), np.asarray(jres.num_effective))
    np.testing.assert_array_equal(tres.converged.numpy(), np.asarray(jres.converged))
    for b, (_, _, R_true, t_true) in enumerate(pairs):
        rot = np.linalg.norm(oracles.so3_log(np.asarray(jres.R[b], np.float64).T
                                             @ tres.R[b].numpy().astype(np.float64)))
        assert rot < 1e-4
        np.testing.assert_allclose(tres.t[b].numpy(), np.asarray(jres.t[b]), atol=1e-4)
        assert np.linalg.norm(tres.t[b].numpy() - t_true) < 5e-2
    # and on the carried tables the port's batch still equals its scalar
    _assert_batch_equals_scalar(to, tt, bs, R0, t0, tres)


def _keyframe_workload(B, world_points, extent, n_tgt, n_src, max_range, init_sigma, seed):
    """The loop-registration workload of test_icp.py:596 / :677: B
    consecutive poses of one trajectory, lane b matching the scan of pose
    b + 1 to the scan of pose b from the true relative pose off by
    N(0, init_sigma). Returns (targets cloud, sources cloud, R0, t0, gt)."""
    world = synthetic.make_world(num_points=world_points, extent=extent, seed=seed)
    traj = synthetic.make_trajectory(num_frames=B + 1, dt=0.1, speed=2.0)
    rng = np.random.default_rng(3 if seed == 7 else 4)
    tgts, srcs, R0s, t0s, gts = [], [], [], [], []
    for b in range(B):
        tgts.append(synthetic.render_scan(world, traj.R[b], traj.t[b], max_range=max_range,
                                          max_points=n_tgt, noise=0.01, seed=2 * b,
                                          capacity=n_tgt, device="cpu")._replace(stamp=None))
        srcs.append(synthetic.render_scan(world, traj.R[b + 1], traj.t[b + 1],
                                          max_range=max_range, max_points=n_src, noise=0.01,
                                          seed=2 * b + 1, capacity=n_src,
                                          device="cpu")._replace(stamp=None))
        R0s.append(traj.R[b].T @ traj.R[b + 1])
        gt = traj.R[b].T @ (traj.t[b + 1] - traj.t[b])
        t0s.append(gt + rng.normal(0.0, init_sigma, 3))
        gts.append(gt)
    return (icp.stack_lanes(tgts), icp.stack_lanes(srcs),
            torch.tensor(np.stack(R0s), dtype=torch.float32),
            torch.tensor(np.stack(t0s), dtype=torch.float32), np.stack(gts))


def test_batched_converged_tail_at_keyframe_density():
    """test_icp.py:596 at B = 8 (8,192-point targets, 2,048-point sources,
    5 cm inits, density-matched options, default dense_dims): every lane
    under 3 cm, median num_effective > 700, every lane bit-equal to its
    scalar match."""
    bt, bs, R0, t0, gts = _keyframe_workload(8, 200000, 80.0, 8192, 2048, 70.0, 0.05, seed=7)
    o = icp.IcpOptions(method="p2plane_vox", grid_leaf=2.0, plane_min_pts=4)
    targets = icp.set_target_batch(bt, o)
    res = icp.scan_match_batch(targets, o, bs, R0, t0)
    err = np.linalg.norm(res.t.numpy() - gts, axis=1)
    assert float(err.max()) < 0.03, err
    assert int(np.median(res.num_effective.numpy())) > 700
    _assert_batch_equals_scalar(o, targets, bs, R0, t0, res)


def test_scan_match_batch_chunked_matches_direct():
    """test_icp.py:677: B = 6 in chunks of 4 (the last chunk padded by
    wrap-around, the padding dropped) equals the direct call, here bit for
    bit; B <= chunk falls through."""
    bt, bs, R0, t0, _ = _keyframe_workload(6, 60000, 40.0, 2048, 1024, 35.0, 0.03, seed=5)
    o = icp.IcpOptions(method="p2plane_vox", grid_leaf=2.0, plane_min_pts=4, dense_dims=DIMS)
    targets = icp.set_target_batch(bt, o)
    direct = icp.scan_match_batch(targets, o, bs, R0, t0)
    for chunk in (4, 8):
        chunked = icp.scan_match_batch_chunked(targets, o, bs, R0, t0, chunk=chunk)
        icp.tree_map(lambda x, y: np.testing.assert_array_equal(x.numpy(), y.numpy()),
                     direct, chunked)
    assert direct.iterations.shape == (6,)


def test_lanes_stop_at_different_iterations_and_keep_their_state(monkeypatch):
    """Lanes of one call converge after different numbers of iterations; one
    lane has an empty source and never converges (it runs to max_iteration
    with 0 effective points and its pose unmoved). Each lane reports its own
    iteration count and equals its scalar match; the loop runs as many
    iterations as the slowest lane, calls the batched linearization once per
    iteration, and a lane that has stopped is switched off in later calls."""
    pairs = _pairs(B=4, seed=5, rot=0.03, trans=0.25)
    tgts, srcs, bt, bs = _stacked(pairs)
    empty = pcm.PointCloud(xyz=torch.full((2048, 3), pcm.PAD_COORD),
                           mask=torch.zeros(2048, dtype=torch.bool))
    bs = icp.stack_lanes(srcs[:3] + [empty])
    opts = icp.IcpOptions(method="p2plane_vox_oct", dense_dims=DIMS, max_iteration=12)
    targets = icp.set_target_batch(bt, opts)
    R0, t0 = _identity(4)
    t0[3] = torch.tensor([0.5, -0.5, 0.25])
    actives = []
    real = kernels.p2plane_fused_terms_from_target_batch
    monkeypatch.setattr(kernels, "p2plane_fused_terms_from_target_batch",
                        lambda *a: (actives.append(a[-1].clone()), real(*a))[1])
    res = icp.scan_match_batch(targets, opts, bs, R0, t0)
    its = res.iterations.tolist()
    assert len(set(its[:3])) > 1 and its[3] == 12, its
    assert res.converged[:3].sum() >= 2 and not bool(res.converged[3])
    assert int(res.num_effective[3]) == 0 and torch.equal(res.t[3], t0[3])
    assert len(actives) == max(its)
    for k, a in enumerate(actives):
        assert a.tolist() == [k < n for n in its], (k, a)
    monkeypatch.undo()
    _assert_batch_equals_scalar(opts, targets, bs, R0, t0, res)


@pytest.mark.parametrize("case", ["centroid_init", "gate_warmup", "frozen_election"])
def test_scan_match_batch_options_are_per_lane(case):
    """use_initial_translation=False takes each lane's own centroid
    difference; the gate warm-up (wide gate, damped step, no stop during
    warm-up) is shared by iteration number; a frozen election runs lane by
    lane. Each equals the scalar call bit for bit."""
    method = {"centroid_init": "p2plane_vox", "gate_warmup": "p2plane_vox_oct",
              "frozen_election": "p2plane_vox"}[case]
    extra = {"centroid_init": dict(use_initial_translation=False),
             "gate_warmup": dict(gate_warmup_iters=3),
             "frozen_election": dict(freeze_election_after=2)}[case]
    opts = icp.IcpOptions(method=method, dense_dims=DIMS, **extra)
    _, _, bt, bs = _stacked(_pairs(seed=9))
    targets = icp.set_target_batch(bt, opts)
    R0, _ = _identity(3)
    t0 = torch.tensor([[5.0, 5.0, 5.0]] * 3) if case == "centroid_init" else torch.zeros(3, 3)
    res = icp.scan_match_batch(targets, opts, bs, R0, t0)
    _assert_batch_equals_scalar(opts, targets, bs, R0, t0, res)
    assert bool(res.converged.all())
    if case == "gate_warmup":
        assert int(res.iterations.min()) > 3


def test_set_target_batch_takes_per_lane_origins():
    """origins (B, 3): lane b is set_target(pcs[b], opts, origins[b])."""
    opts = icp.IcpOptions(method="p2plane_vox", dense_dims=DIMS)
    tgts, _, bt, _ = _stacked(_pairs())
    origins = torch.tensor([[0.3, -0.2, 0.1], [0.0, 0.0, 0.0], [-1.5, 2.0, 0.25]])
    targets = icp.set_target_batch(bt, opts, origins)
    assert torch.equal(targets.grid.origin, origins)
    for b in range(3):
        icp.tree_map(lambda x, y: np.testing.assert_array_equal(x.numpy(), y.numpy()),
                     icp.take_lane(targets, b), icp.set_target(tgts[b], opts, origins[b]))
