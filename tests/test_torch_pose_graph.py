"""Port parity: loc_lib_tpu_torch.graph.pose_graph against the JAX package on
the tests/test_graph.py workloads.

Stated tolerances:
  * the closed-form edge Jacobians against JAX's forward-mode oracle
    (`_linearize_autodiff`) with test_graph.py:219's bounds (r atol 1e-5,
    J atol 5e-4 / rtol 2e-3), and against JAX's closed form at atol 1e-5;
  * whole solves against JAX: the gauge prior (1e8) against odometry
    information (1e4) makes the result depend on the summation order, so
    the bound is JAX's OWN sensitivity on the same graph: the largest pose
    change a 1-ulp nudge of every input pose makes in JAX's result, times 2
    (measured: the port's gap is 0.67-0.86 of it on the 16-node chain);
  * PCG against the dense oracle: test_graph.py:116's bounds (2e-3);
  * the PCG stop test read every k iterations: bit-equal for k = 1, 3, 8.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loc_lib_tpu.graph import pose_graph as jpg
from loc_lib_tpu.utils import lie as jlie
from loc_lib_tpu_torch.graph import pose_graph as pg
from loc_lib_tpu_torch.utils import lie

torch.set_num_threads(2)


def _noisy_chain(m=12, seed=0, drift=0.05):
    """test_graph.py's circle of ground-truth poses and drifted odometry
    estimates (float32)."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 1.5 * np.pi, m)
    t_gt = np.stack([np.cos(ang) * 5, np.sin(ang) * 5, np.zeros(m)], axis=1)
    R_gt = np.stack([np.asarray(jlie.so3_exp(jnp.array([0, 0, a], jnp.float32))) for a in ang])
    R_est, t_est = [R_gt[0]], [t_gt[0]]
    for i in range(1, m):
        Rrel = R_gt[i - 1].T @ R_gt[i]
        trel = R_gt[i - 1].T @ (t_gt[i] - t_gt[i - 1]) + rng.normal(0, drift, 3)
        R_est.append(R_est[-1] @ Rrel)
        t_est.append(t_est[-1] + R_est[-1] @ trel)
    return (np.stack(R_gt).astype(np.float32), t_gt.astype(np.float32),
            np.stack(R_est).astype(np.float32), np.stack(t_est).astype(np.float32))


def _loop(R_gt, t_gt, i, j, R=None, t=None):
    """One loop edge i -> j (the ground-truth relative pose unless R, t)."""
    R = R_gt[i].T @ R_gt[j] if R is None else R
    t = R_gt[i].T @ (t_gt[j] - t_gt[i]) if t is None else t
    return pg.Se3Edges(i=np.array([i], np.int32), j=np.array([j], np.int32),
                       R=np.asarray(R, np.float32)[None], t=np.asarray(t, np.float32)[None],
                       info=np.eye(6, dtype=np.float32)[None] * 1e4,
                       is_loop=np.array([True]), valid=np.array([True]))


def _graph(R_gt, t_gt, R_est, t_est, loop):
    """Odometry chain (the numpy builder) + the loop edge, as numpy."""
    return pg.concat_edges_np(pg.odometry_edges_np(R_est, t_est), loop)


def _jax_edges(edges):
    return jpg.Se3Edges(*[jnp.asarray(x) for x in edges])


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _nudged(a):
    return np.nextafter(a, np.float32(np.inf)).astype(np.float32)


def test_closed_form_edge_jacobians_match_jax_and_its_autodiff_oracle():
    """test_graph.py:219 in the port, across residual magnitudes including
    the zero residual every converged graph sits at."""
    rng = np.random.default_rng(9)
    autodiff, closed = jax.jit(jpg._linearize_autodiff), jax.jit(jpg._linearize)
    for drift in (0.0, 0.05, 0.5, 2.0):
        Ri = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.6, 3), jnp.float32)))
        ti = rng.normal(0, 3, 3).astype(np.float32)
        Rj = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.6, 3), jnp.float32)))
        tj = rng.normal(0, 3, 3).astype(np.float32)
        dR, dt = (np.asarray(x) for x in jlie.se3_exp(
            jnp.asarray(rng.normal(0, drift, 6), jnp.float32)))
        Rm, tm = Ri.T @ Rj @ dR, Ri.T @ (tj - ti) + dt
        args = [np.asarray(x[None], np.float32) for x in (Ri, ti, Rj, tj, Rm, tm)]
        r, Ji, Jj = pg._linearize(*map(_t, args))
        r_ad, Ji_ad, Jj_ad = autodiff(*map(jnp.asarray, args))
        r_cf, Ji_cf, Jj_cf = closed(*map(jnp.asarray, args))
        np.testing.assert_allclose(r.numpy(), np.asarray(r_ad), atol=1e-5)
        for ours, ad, cf in ((Ji, Ji_ad, Ji_cf), (Jj, Jj_ad, Jj_cf)):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ad), atol=5e-4, rtol=2e-3)
            np.testing.assert_allclose(ours.numpy(), np.asarray(cf), atol=1e-5)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_optimize_matches_jax_within_its_own_one_ulp_sensitivity(solver):
    """test_graph.py:116's graph (16 nodes, one loop edge), one solver at a
    time: poses, per-edge chi2 and the chi2 history against JAX's, within
    twice the change a 1-ulp nudge of the input poses makes in JAX's own
    result (see the module docstring)."""
    R_gt, t_gt, R_est, t_est = _noisy_chain(m=16, seed=3)
    edges = _graph(R_gt, t_gt, R_est, t_est, _loop(R_gt, t_gt, 0, 15))
    jo = dataclasses.replace(jpg.PgoOptions(), solver=solver)
    jr = jpg.optimize(jnp.asarray(R_est), jnp.asarray(t_est), _jax_edges(edges), jo)
    jn = jpg.optimize(jnp.asarray(_nudged(R_est)), jnp.asarray(_nudged(t_est)),
                      _jax_edges(edges), jo)
    tr = pg.optimize(_t(R_est), _t(t_est), edges, dataclasses.replace(pg.PgoOptions(),
                                                                     solver=solver))
    for name in ("t", "R"):
        self_gap = np.abs(np.asarray(getattr(jn, name)) - np.asarray(getattr(jr, name))).max()
        port_gap = np.abs(getattr(tr, name).numpy() - np.asarray(getattr(jr, name))).max()
        assert 0 < self_gap and port_gap <= 2 * self_gap, (name, port_gap, self_gap)
    np.testing.assert_allclose(tr.chi2.numpy(), np.asarray(jr.chi2), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tr.chi2_hist.numpy(), np.asarray(jr.chi2_hist), rtol=1e-4)
    assert tr.chi2_hist.shape == (jo.iteration_bound,)
    assert (int(tr.cg_iterations) > 0) == (solver == "pcg")


def test_pcg_matches_dense_solver():
    """test_graph.py:116 in the port: PCG within 2e-3 of the dense oracle,
    total chi2 within 1%."""
    R_gt, t_gt, R_est, t_est = _noisy_chain(m=16, seed=3)
    edges = _graph(R_gt, t_gt, R_est, t_est, _loop(R_gt, t_gt, 0, 15))
    rd = pg.optimize(_t(R_est), _t(t_est), edges, dataclasses.replace(pg.PgoOptions(),
                                                                     solver="dense"))
    rp = pg.optimize(_t(R_est), _t(t_est), edges, pg.PgoOptions())
    np.testing.assert_allclose(rp.t.numpy(), rd.t.numpy(), atol=2e-3)
    np.testing.assert_allclose(rp.R.numpy(), rd.R.numpy(), atol=2e-3)
    np.testing.assert_allclose(float(rp.chi2.sum()), float(rd.chi2.sum()), rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_pcg_stop_read_every_k_iterations_gives_the_same_bits(k, monkeypatch):
    """The PCG done flag read by the host every k iterations: once the test
    fails the iterate stops changing, so k = 1, 3 and 8 give the bits of
    stopping exactly, and the same CG iteration count, through optimize()
    and through one solve_pcg call."""
    R_gt, t_gt, R_est, t_est = _noisy_chain(m=16, seed=3)
    edges = _graph(R_gt, t_gt, R_est, t_est, _loop(R_gt, t_gt, 0, 15))
    e = pg.edges_to(edges, "cpu")
    H, Hij, b, _ = pg._assemble_blocks(_t(R_est), _t(t_est), e, pg.PgoOptions(), 16)

    def run(every):
        monkeypatch.setattr(pg, "CG_CHECK_EVERY", every)
        return (pg.optimize(_t(R_est), _t(t_est), edges),
                pg.solve_pcg(H, Hij, e.i, e.j, b, 16, 250, 1e-7))
    (ref, (x1, n1)), (got, (xk, nk)) = run(1), run(k)
    for a, b_ in zip(ref, got):
        assert torch.equal(a, b_)
    assert torch.equal(x1, xk) and int(n1) == int(nk) < 250


def test_block_matvec_is_the_dense_product():
    """block_matvec against H @ x with H densified by the dense oracle's
    scatter (repeated pairs, padding self-edges and an edge j < i
    included), atol 1e-3 relative to |H| |x|."""
    rng = np.random.default_rng(2)
    m = 7
    e_i = torch.tensor([0, 1, 2, 0, 5, 0, 3, 6, 6])
    e_j = torch.tensor([1, 2, 3, 6, 2, 0, 4, 0, 0])
    Hij = _t(rng.normal(size=(9, 6, 6)))
    Hij[5] = 0                                     # a padding self-edge carries 0
    A = rng.normal(size=(m, 6, 6))
    Hdiag = _t(A @ A.transpose(0, 2, 1) + 6 * np.eye(6))
    x = _t(rng.normal(size=(m, 6)))
    y = pg.block_matvec(Hdiag, Hij, e_i, e_j, x, m)
    H = np.zeros((m, 6, m, 6))
    for k in range(m):
        H[k, :, k, :] = Hdiag[k].numpy()
    for e in range(9):
        H[e_i[e], :, e_j[e], :] += Hij[e].numpy()
        H[e_j[e], :, e_i[e], :] += Hij[e].numpy().T
    want = (H.reshape(6 * m, 6 * m) @ x.numpy().reshape(-1)).reshape(m, 6)
    np.testing.assert_allclose(y.numpy(), want, atol=1e-3 * np.abs(H).max() * np.abs(
        x.numpy()).max())
    edges = pg.Se3Edges(e_i, e_j, *([None] * 5))
    dense = pg._solve_dense(Hdiag, Hij, torch.zeros(m, 6), edges, m)
    assert torch.equal(dense, torch.zeros(m, 6))


@pytest.mark.parametrize("k", [3, 6])
def test_dense_solve_sums_repeated_pairs_like_float64(k):
    """The dense solve's scatter-free assembly (k = 3: the SE(2) graph, 6:
    SE(3)): four edges on the node pair (1, 2), two of them as (2, 1), and
    a padding self-edge carrying 0, against numpy's float64 assembly and
    solve (rtol 1e-4 of the largest |dx|); two calls give the same bits."""
    rng = np.random.default_rng(5)
    m = 5
    e_i = torch.tensor([0, 1, 1, 2, 2, 3, 1, 0])
    e_j = torch.tensor([1, 2, 2, 1, 1, 4, 2, 0])
    Hij = _t(rng.normal(size=(8, k, k)))
    Hij[7] = 0
    A = rng.normal(size=(m, k, k))
    Hdiag = _t(A @ A.transpose(0, 2, 1) + 40 * k * np.eye(k))
    b = _t(rng.normal(size=(m, k)))
    edges = pg.Se3Edges(e_i, e_j, *([None] * 5))
    dx = pg._solve_dense(Hdiag, Hij, b, edges, m)
    H = np.zeros((m, k, m, k))
    for n in range(m):
        H[n, :, n, :] = Hdiag[n].numpy()
    np.add.at(H, (e_i.numpy(), slice(None), e_j.numpy()), Hij.numpy().astype(np.float64))
    np.add.at(H, (e_j.numpy(), slice(None), e_i.numpy()),
              Hij.numpy().transpose(0, 2, 1).astype(np.float64))
    want = np.linalg.solve(H.reshape(k * m, k * m), b.numpy().reshape(-1).astype(np.float64))
    np.testing.assert_allclose(dx.numpy().reshape(-1), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert torch.equal(dx, pg._solve_dense(Hdiag, Hij, b, edges, m))


def test_pose_graph_corrects_drift_like_jax():
    """test_graph.py:34 in the port: the true loop survives the chi2 gates
    and ~90% of the end-point error goes; the inlier mask equals JAX's and
    the poses are within twice JAX's own 1-ulp sensitivity."""
    R_gt, t_gt, R_est, t_est = _noisy_chain()
    m = len(R_gt)
    edges = _graph(R_gt, t_gt, R_est, t_est, _loop(R_gt, t_gt, 0, m - 1))
    R, t, inl = pg.optimize_two_phase(_t(R_est), _t(t_est), edges)
    jR, jt, jinl = jpg.optimize_two_phase(jnp.asarray(R_est), jnp.asarray(t_est),
                                          _jax_edges(edges))
    _, njt, _ = jpg.optimize_two_phase(jnp.asarray(_nudged(R_est)), jnp.asarray(_nudged(t_est)),
                                       _jax_edges(edges))
    assert bool(inl[-1])
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    err_before = np.linalg.norm(t_est[-1] - t_gt[-1])
    err_after = np.linalg.norm(t[-1].numpy() - t_gt[-1])
    assert err_after < err_before * 0.15 and err_after < 0.4, (err_before, err_after)
    self_gap = np.abs(np.asarray(njt) - np.asarray(jt)).max()
    assert np.abs(t.numpy() - np.asarray(jt)).max() <= 2 * self_gap


def test_pose_graph_rejects_false_loop_like_jax():
    """test_graph.py:60 in the port: a wildly wrong loop is gated out and the
    trajectory stays on the odometry solution; the same verdict as JAX."""
    R_gt, t_gt, R_est, t_est = _noisy_chain(drift=0.01)
    m = len(R_gt)
    bad = _loop(R_gt, t_gt, 0, m - 1, R=np.eye(3), t=[30.0, -20.0, 5.0])
    edges = _graph(R_gt, t_gt, R_est, t_est, bad)
    R, t, inl = pg.optimize_two_phase(_t(R_est), _t(t_est), edges)
    _, _, jinl = jpg.optimize_two_phase(jnp.asarray(R_est), jnp.asarray(t_est),
                                        _jax_edges(edges))
    assert not bool(inl[-1]) and not bool(jinl[-1])
    assert np.linalg.norm(t[-1].numpy() - t_est[-1]) < 1.0


def test_pad_graph_parity():
    """test_graph.py:247 in the port: padding to the 16-bucket leaves the
    real nodes' solution (1e-4) and the inlier mask unchanged, padded nodes
    at identity; JAX's pad_graph makes the same shapes."""
    R_gt, t_gt, R_est, t_est = _noisy_chain(m=13, seed=7)
    edges = pg.edges_to(_graph(R_gt, t_gt, R_est, t_est, _loop(R_gt, t_gt, 0, 12)), "cpu")
    Ru, tu, inl_u = pg.optimize_two_phase(_t(R_est), _t(t_est), edges)
    Rp_, tp_, edges_p, m = pg.pad_graph(_t(R_est), _t(t_est), edges, bucket=16)
    jRp, _, jedges_p, jm = jpg.pad_graph(jnp.asarray(R_est), jnp.asarray(t_est),
                                         _jax_edges(edges), bucket=16)
    assert Rp_.shape == jRp.shape == (16, 3, 3) and m == jm == 13
    assert edges_p.i.shape == jedges_p.i.shape == (16,)
    np.testing.assert_array_equal(edges_p.valid.numpy(), np.asarray(jedges_p.valid))
    Rp, tp, inl_p = pg.optimize_two_phase(Rp_, tp_, edges_p)
    np.testing.assert_allclose(tp[:m].numpy(), tu.numpy(), atol=1e-4)
    np.testing.assert_allclose(Rp[:m].numpy(), Ru.numpy(), atol=1e-4)
    np.testing.assert_array_equal(inl_p[:edges.i.shape[0]].numpy(), inl_u.numpy())
    np.testing.assert_allclose(Rp[m:].numpy(), np.tile(np.eye(3), (16 - m, 1, 1)), atol=1e-5)


def test_graph_builders_match_jax():
    """test_graph.py:308 in the port: odometry_edges (torch) and the numpy
    builders equal JAX's odometry_edges within 1e-6; make_pad_edges and its
    numpy twin equal JAX's exactly; concat keeps the row order."""
    rng = np.random.default_rng(4)
    m = 9
    R = np.stack([np.asarray(jlie.so3_exp(jnp.asarray(0.3 * rng.standard_normal(3),
                                                       jnp.float32))) for _ in range(m)])
    t = rng.standard_normal((m, 3)).astype(np.float32)
    ref = jpg.odometry_edges(jnp.asarray(R), jnp.asarray(t))
    for ours in (pg.odometry_edges_np(R, t), pg.odometry_edges(_t(R), _t(t))):
        for name, x, y in zip(pg.Se3Edges._fields, ours, ref):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=1e-6, err_msg=name)
    for ours in (pg.make_pad_edges_np(5), pg.make_pad_edges(5, "cpu")):
        for name, x, y in zip(pg.Se3Edges._fields, ours, jpg.make_pad_edges(5)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)
    both = pg.concat_edges(pg.odometry_edges(_t(R), _t(t)), pg.make_pad_edges(3, "cpu"))
    assert both.i.shape == (m + 2,) and not both.valid[m - 1:].any()
    np.testing.assert_array_equal(pg.concat_edges_np(pg.make_pad_edges_np(2),
                                                     pg.odometry_edges_np(R, t)).j[2:],
                                  np.arange(1, m))


def test_edge_chi2_and_residual_norms_match_jax():
    """edge_chi2 and edge_residual_norms at the drifted estimate, rtol 1e-4
    against JAX's (atol 1e-6 for norms near 0)."""
    R_gt, t_gt, R_est, t_est = _noisy_chain()
    edges = _graph(R_gt, t_gt, R_est, t_est, _loop(R_gt, t_gt, 0, 11))
    e = pg.edges_to(edges, "cpu")
    np.testing.assert_allclose(pg.edge_chi2(_t(R_est), _t(t_est), e).numpy(),
                               np.asarray(jpg.edge_chi2(jnp.asarray(R_est), jnp.asarray(t_est),
                                                        _jax_edges(edges))), rtol=1e-4, atol=1e-6)
    for a, b in zip(pg.edge_residual_norms(_t(R_est), _t(t_est), e),
                    jpg.edge_residual_norms(jnp.asarray(R_est), jnp.asarray(t_est),
                                            _jax_edges(edges))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kernel", ["cauchy", "huber", "none"])
def test_robust_weights_match_jax(kernel):
    chi2 = np.array([0.0, 1e-14, 1.0, 899.0, 900.0, 901.0, 1e4, 1e8], np.float32)
    o, jo = (dataclasses.replace(mod.PgoOptions(), kernel=kernel) for mod in (pg, jpg))
    np.testing.assert_allclose(pg._robust_weight(o, _t(chi2)).numpy(),
                               np.asarray(jpg._robust_weight(jo, jnp.asarray(chi2))), rtol=1e-6)


def test_pcg_large_graph_reduces_chi2():
    """test_graph.py:140 in the port: 4,096 nodes (the default sc_capacity)
    and 512 loop edges (max_loops) one revolution apart, 3 GN iterations of
    at most 100 CG iterations: finite, chi2 below 5% of its start, in
    O(M + E) memory (the dense system would be 24,576^2)."""
    rng = np.random.default_rng(11)
    m = 4096
    ang = np.linspace(0, 8 * np.pi, m)
    t_gt = np.stack([np.cos(ang) * 30, np.sin(ang) * 30, np.zeros(m)], axis=1)
    w = np.zeros((m, 3), np.float32)
    w[:, 2] = ang % (2 * np.pi)
    R_gt = lie.so3_exp(_t(w)).numpy()
    R_est, t_est = [R_gt[0]], [t_gt[0].astype(np.float32)]
    for i in range(1, m):
        trel = R_gt[i - 1].T @ (t_gt[i] - t_gt[i - 1]) + rng.normal(0, 0.01, 3)
        R_est.append((R_est[-1] @ (R_gt[i - 1].T @ R_gt[i])).astype(np.float32))
        t_est.append((t_est[-1] + R_est[-1] @ trel).astype(np.float32))
    R_est, t_est = np.stack(R_est), np.stack(t_est).astype(np.float32)
    li = rng.integers(0, m - 600, 512).astype(np.int32)
    lj = li + 512
    loops = pg.Se3Edges(
        i=li, j=lj, R=np.einsum("eab,eac->ebc", R_gt[li], R_gt[lj]).astype(np.float32),
        t=np.einsum("eab,ea->eb", R_gt[li], t_gt[lj] - t_gt[li]).astype(np.float32),
        info=np.tile(np.eye(6, dtype=np.float32) * 1e4, (512, 1, 1)),
        is_loop=np.ones(512, bool), valid=np.ones(512, bool))
    edges = pg.edges_to(pg.concat_edges_np(pg.odometry_edges_np(R_est, t_est), loops), "cpu")
    opts = dataclasses.replace(pg.PgoOptions(), max_iterations=3, max_cg_iterations=100)
    before = float(pg.edge_chi2(_t(R_est), _t(t_est), edges).sum())
    res = pg.optimize(_t(R_est), _t(t_est), edges, opts)
    after = float(res.chi2.sum())
    assert np.isfinite(after) and after < 0.05 * before, (before, after)
    assert 0 < int(res.cg_iterations) <= 300
