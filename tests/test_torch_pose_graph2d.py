"""Port parity: loc_lib_tpu_torch.graph.pose_graph2d against the JAX package
on the tests/test_mapping2d.py graphs.

Stated tolerances:
  * residuals and the closed-form Jacobians against jax.jacfwd of JAX's
    residual: atol 1e-5 (JAX's forward mode gives cos^2 + sin^2 where the
    closed form has 1);
  * whole solves against JAX: within twice the largest pose change a 1-ulp
    nudge of every input pose makes in JAX's own result, floored at two
    ulps of the largest value (the gauge prior, 1e8, against odometry
    information, 1e4, makes the solve sensitive to summation order); inlier
    masks exactly;
  * PCG against the dense solve: test_mapping2d.py:111's 2e-3;
  * padding: test_mapping2d.py:167's 1e-4; the numpy assembly bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loc_lib_tpu.graph import pose_graph2d as jpg2
from loc_lib_tpu.graph.pose_graph import PgoOptions as JPgoOptions
from loc_lib_tpu_torch.graph import pose_graph2d as pg2
from loc_lib_tpu_torch.graph.pose_graph import PgoOptions

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _nudged(a):
    return np.nextafter(a, np.float32(np.inf)).astype(np.float32)


def _bound(ref, nudged):
    """Twice JAX's own change under a 1-ulp nudge of the input poses,
    floored at two float32 ulps of the largest value (the float32 solve's
    own rounding)."""
    ref, nudged = np.asarray(ref), np.asarray(nudged)
    return 2 * max(np.abs(nudged - ref).max(), 2 * np.spacing(np.abs(ref).max()))


def _jax_edges(edges):
    return jpg2.Se2Edges(*[jnp.asarray(np.asarray(x)) for x in edges])


def _arc(m=30, seed=0, turns=1.5):
    """test_mapping2d.py:111's arc: ground truth on a 5 m circle, estimates
    drifted by N(0, 0.02) rad and N(0, 0.05) m."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, turns * np.pi, m).astype(np.float32)
    t_gt = np.stack([np.cos(ang) * 5, np.sin(ang) * 5], 1).astype(np.float32)
    th = (ang + rng.normal(0, 0.02, m)).astype(np.float32)
    t = (t_gt + rng.normal(0, 0.05, (m, 2))).astype(np.float32)
    return ang, t_gt, th, t


def _loop(ang, t_gt, i, j, dth=0.0, dt=(0.0, 0.0)):
    """The true relative pose i -> j (plus an error), as a build_graph_np loop."""
    c, s = np.cos(ang[i]), np.sin(ang[i])
    d = t_gt[j] - t_gt[i]
    rel = np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1]], np.float32) + np.float32(dt)
    return (i, j, float(ang[j] - ang[i] + dth), rel, True)


def _looped_graph(m=20, seed=1, bad=False):
    """An arc of m submap poses with a true loop 0 -> m-1 and, if `bad`, a
    wrong one 2 -> m-3 (12 m off, past the 10 m pre-gate): numpy, bucketed
    by build_graph_np."""
    ang, t_gt, th, t = _arc(m, seed, turns=1.9)
    loops = [_loop(ang, t_gt, 0, m - 1)]
    if bad:
        loops.append(_loop(ang, t_gt, 2, m - 3, dth=0.2, dt=(12.0, -3.0)))
    return pg2.build_graph_np(th, t, loops)


def test_closed_form_jacobians_match_jax_jacfwd():
    rng = np.random.default_rng(9)
    e = 64
    for drift in (0.0, 0.05, 0.5, 3.0):
        thi, thj = rng.uniform(-3.1, 3.1, (2, e)).astype(np.float32)
        ti, tj = rng.normal(0, 3, (2, e, 2)).astype(np.float32)
        c, s = np.cos(thi), np.sin(thi)
        d = tj - ti
        tm = (np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]], -1)
              + rng.normal(0, drift, (e, 2))).astype(np.float32)
        thm = (thj - thi + rng.normal(0, drift, e)).astype(np.float32)
        args = (thi, ti, thj, tj, thm, tm)
        r, Ji, Jj = pg2._linearize(*map(_t, args))
        jr, jJi, jJj = jax.jit(jpg2._linearize)(*map(jnp.asarray, args))
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-5)
        np.testing.assert_allclose(Ji.numpy(), np.asarray(jJi), atol=1e-5)
        np.testing.assert_allclose(Jj.numpy(), np.asarray(jJj), atol=1e-5)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_optimize_matches_jax_within_its_own_one_ulp_sensitivity(solver):
    """The bucketed looped graph (32 nodes, 64 edge rows, 20 real nodes):
    poses against JAX's within twice JAX's own 1-ulp sensitivity; per-edge
    chi2 and the chi2 history at rtol 1e-3."""
    th, t, edges, m = _looped_graph()
    jo = dataclasses.replace(JPgoOptions(), solver=solver)
    jr = jpg2.optimize(jnp.asarray(th), jnp.asarray(t), _jax_edges(edges), jo)
    jn = jpg2.optimize(jnp.asarray(_nudged(th)), jnp.asarray(_nudged(t)), _jax_edges(edges), jo)
    tr = pg2.optimize(_t(th), _t(t), edges, dataclasses.replace(PgoOptions(), solver=solver))
    for name in ("theta", "t"):
        ref = np.asarray(getattr(jr, name))
        port_gap = np.abs(getattr(tr, name).numpy() - ref).max()
        assert port_gap <= _bound(ref, getattr(jn, name)), (name, port_gap)
    np.testing.assert_allclose(tr.chi2.numpy(), np.asarray(jr.chi2), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tr.chi2_hist.numpy(), np.asarray(jr.chi2_hist), rtol=1e-3)
    assert (int(tr.cg_iterations) > 0) == (solver == "pcg")


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_two_phase_inlier_masks_equal_jax(solver):
    """A true loop and a 12 m-wrong one: the same inlier mask as JAX (the
    wrong loop gated out, the true one kept), poses within twice JAX's
    1-ulp sensitivity."""
    th, t, edges, m = _looped_graph(bad=True)
    jo = dataclasses.replace(JPgoOptions(), solver=solver)
    jth, jt, jinl = jpg2.optimize_two_phase(jnp.asarray(th), jnp.asarray(t),
                                            _jax_edges(edges), jo)
    _, njt, _ = jpg2.optimize_two_phase(jnp.asarray(_nudged(th)), jnp.asarray(_nudged(t)),
                                        _jax_edges(edges), jo)
    pth, pt, inl = pg2.optimize_two_phase(_t(th), _t(t), edges,
                                          dataclasses.replace(PgoOptions(), solver=solver))
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    n_odo = m - 1
    assert inl[n_odo].item() and not inl[n_odo + 1].item()
    assert np.abs(pt.numpy() - np.asarray(jt)).max() <= _bound(jt, njt)


def test_pcg_matches_dense():
    """test_mapping2d.py:111 in the port: odometry-only arc, 10 iterations,
    PCG within 2e-3 of the dense solve."""
    ang, t_gt, th, t = _arc()
    edges = pg2.odometry_edges(_t(ang), _t(t_gt))
    opts_p = dataclasses.replace(PgoOptions(), max_iterations=10)
    rp = pg2.optimize(_t(th), _t(t), edges, opts_p)
    rd = pg2.optimize(_t(th), _t(t), edges, dataclasses.replace(opts_p, solver="dense"))
    np.testing.assert_allclose(rp.t.numpy(), rd.t.numpy(), atol=2e-3)
    np.testing.assert_allclose(rp.theta.numpy(), rd.theta.numpy(), atol=2e-3)


def test_pad_graph_and_graph_assembly_match_jax():
    """test_mapping2d.py:167 in the port (8-bucket padding keeps the real
    nodes' two-phase solution within 1e-4); pad_graph and odometry_edges
    against JAX's; build_graph_np bit for bit."""
    rng = np.random.default_rng(4)
    m = 6
    th_gt = np.linspace(0, np.pi, m).astype(np.float32)
    t_gt = np.stack([np.cos(th_gt) * 4, np.sin(th_gt) * 4], 1).astype(np.float32)
    th = (th_gt + rng.normal(0, 0.03, m)).astype(np.float32)
    t = (t_gt + rng.normal(0, 0.1, (m, 2))).astype(np.float32)
    edges = pg2.odometry_edges(_t(th_gt), _t(t_gt))
    jedges = jpg2.odometry_edges(jnp.asarray(th_gt), jnp.asarray(t_gt))
    for name, x, y in zip(pg2.Se2Edges._fields, edges, jedges):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6, err_msg=name)
    thu, tu, inl_u = pg2.optimize_two_phase(_t(th), _t(t), edges)
    thp_, tp_, edges_p, mm = pg2.pad_graph(_t(th), _t(t), edges, bucket=8)
    jthp, _, jedges_p, jmm = jpg2.pad_graph(jnp.asarray(th), jnp.asarray(t), jedges, bucket=8)
    assert thp_.shape == jthp.shape == (8,) and edges_p.i.shape == jedges_p.i.shape == (8,)
    assert mm == jmm == m
    np.testing.assert_array_equal(edges_p.valid.numpy(), np.asarray(jedges_p.valid))
    thp, tp, inl_p = pg2.optimize_two_phase(thp_, tp_, edges_p)
    np.testing.assert_allclose(tp[:mm].numpy(), tu.numpy(), atol=1e-4)
    np.testing.assert_allclose(thp[:mm].numpy(), thu.numpy(), atol=1e-4)
    np.testing.assert_array_equal(inl_p[: edges.i.shape[0]].numpy(), inl_u.numpy())

    ang, t_gt, th, t = _arc(40, seed=2, turns=1.9)
    loops = [_loop(ang, t_gt, 0, 39), _loop(ang, t_gt, 3, 36)[:4] + (False,)]
    ours, ref = pg2.build_graph_np(th, t, loops), jpg2.build_graph_np(th, t, loops)
    for a, b in zip(ours[:2], ref[:2]):
        np.testing.assert_array_equal(a, b)
    assert ours[3] == ref[3] == 40 and ours[0].shape == (64,) and ours[2].i.shape == (64,)
    for name, a, b in zip(pg2.Se2Edges._fields, ours[2], ref[2]):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


def test_edge_chi2_and_residual_norms_match_jax():
    th, t, edges, m = _looped_graph(bad=True)
    e = pg2.edges_to(edges, "cpu")
    np.testing.assert_allclose(pg2.edge_chi2(_t(th), _t(t), e).numpy(),
                               np.asarray(jpg2.edge_chi2(jnp.asarray(th), jnp.asarray(t),
                                                         _jax_edges(edges))),
                               rtol=1e-4, atol=1e-4)
    for a, b in zip(pg2.edge_residual_norms(_t(th), _t(t), e),
                    jpg2.edge_residual_norms(jnp.asarray(th), jnp.asarray(t),
                                             _jax_edges(edges))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


def test_two_optimize_calls_give_the_same_bits():
    th, t, edges, m = _looped_graph(bad=True)
    a = pg2.optimize_two_phase(_t(th), _t(t), edges)
    b = pg2.optimize_two_phase(_t(th), _t(t), edges)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
