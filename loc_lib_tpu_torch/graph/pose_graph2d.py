"""SE(2) pose-graph optimization, the 2D stack's loop-closing backend (port
of loc_lib_tpu/graph/pose_graph2d.py).

The SE(3) module's machinery with a 3-dim tangent (x, y, theta): every
edge linearized in closed form at once, the normal equations assembled in
block-sparse form through `pose_graph.normal_equations` (node sums by
`voxel.segment_sum` over edges sorted by node), solved densely
(`pose_graph._solve_dense`, scatter-free) or by the block-size generic
`pose_graph.solve_pcg`; Huber / Cauchy reweighting and two-phase gating of
the loop edges. The residual (EdgeSE2::computeError) is

  r = [R(-th_i) (t_j - t_i) - t_z ; wrap(th_j - th_i - th_z)]

under right perturbations T <- T Exp(xi), xi = (dx, dy, dtheta). The numpy
graph assembly `build_graph_np` is a copy of the JAX package's; `edges_to` and
`concat_edges` are the SE(3) module's (they take either edge type).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import lie
from .pose_graph import (PgoOptions, _chi2, _solve_dense, concat_edges, edge_segments,
                         edges_to, normal_equations, solve_pcg)


class Pgo2dResult(NamedTuple):
    """optimize() result; rot/trans_norm are the per-edge residual norms at
    the RETURNED poses, over all edges (ignoring `valid`)."""

    theta: torch.Tensor
    t: torch.Tensor
    chi2: torch.Tensor          # (E,) per-edge chi2 at the returned poses
    chi2_hist: torch.Tensor     # (iteration_bound,) total chi2 per iteration
    rot_norm: torch.Tensor      # (E,) [rad]
    trans_norm: torch.Tensor    # (E,) [m]
    # port only: CG iterations run over the call (0 for the dense solver)
    cg_iterations: torch.Tensor


class Se2Edges(NamedTuple):
    """Relative-pose constraints i -> j (tensors, or numpy arrays from
    `build_graph_np`)."""

    i: torch.Tensor        # (E,) int
    j: torch.Tensor        # (E,) int
    theta: torch.Tensor    # (E,)   measured relative yaw
    t: torch.Tensor        # (E, 2) measured relative translation
    info: torch.Tensor     # (E, 3, 3)
    is_loop: torch.Tensor  # (E,) bool
    valid: torch.Tensor    # (E,) bool


def _linearize(thi, ti, thj, tj, thm, tm):
    """Residual and closed-form Jacobians of every edge with respect to the
    right perturbations of T_i and T_j (what the JAX package gets from
    jax.jacfwd). With c, s = cos / sin(th_i), d = t_j - t_i and
    rel = R(-th_i) d:
      J_i = [[-1, 0, -s d0 + c d1], [0, -1, -c d0 - s d1], [0, 0, -1]]
            (the last column is d rel / d th_i = (rel_1, -rel_0));
      J_j = [[R(-th_i) R(th_j), 0], [0, 0, 1]].
    Returns (r (E, 3), J_i (E, 3, 3), J_j (E, 3, 3))."""
    ci, si = torch.cos(thi), torch.sin(thi)
    cj, sj = torch.cos(thj), torch.sin(thj)
    d0, d1 = tj[:, 0] - ti[:, 0], tj[:, 1] - ti[:, 1]
    rel_t = torch.stack([ci * d0 + si * d1, -si * d0 + ci * d1], dim=-1)
    r = torch.cat([rel_t - tm, lie.wrap_angle(thj - thi - thm)[:, None]], dim=-1)
    zero, one = torch.zeros_like(thi), torch.ones_like(thi)
    Ji = torch.stack([torch.stack([-one, zero, -si * d0 + ci * d1], -1),
                      torch.stack([zero, -one, -ci * d0 - si * d1], -1),
                      torch.stack([zero, zero, -one], -1)], dim=-2)
    Jj = torch.stack([torch.stack([ci * cj + si * sj, -ci * sj + si * cj, zero], -1),
                      torch.stack([-si * cj + ci * sj, si * sj + ci * cj, zero], -1),
                      torch.stack([zero, zero, one], -1)], dim=-2)
    return r, Ji, Jj


def _edge_linearization(theta, t, edges: Se2Edges):
    return _linearize(theta[edges.i], t[edges.i], theta[edges.j], t[edges.j],
                      edges.theta, edges.t)


def edge_chi2(theta, t, edges: Se2Edges) -> torch.Tensor:
    """Per-edge chi2 = r^T info r at the current estimate."""
    return _chi2(_edge_linearization(theta, t, edges)[0], edges.info)


def edge_residual_norms(theta, t, edges: Se2Edges):
    """Per-edge residual split into (rot_norm [rad], trans_norm [m])."""
    r = _edge_linearization(theta, t, edges)[0]
    return torch.abs(r[:, 2]), torch.linalg.vector_norm(r[:, :2], dim=-1)


def optimize(theta, t, edges: Se2Edges, opts: PgoOptions = PgoOptions(),
             num_nodes: Optional[int] = None, num_iterations: Optional[int] = None
             ) -> Pgo2dResult:
    """Robust GN over the whole graph. `num_iterations` (default
    opts.max_iterations) is clamped to opts.iteration_bound; chi2_hist
    entries past the executed count repeat the last value. Tensors in, on
    one device; `edges` may be numpy (converted to theta's device)."""
    dev = theta.device
    edges = edges_to(edges, dev)
    m = num_nodes or theta.shape[0]
    n_it = min(opts.max_iterations if num_iterations is None else int(num_iterations),
               opts.iteration_bound)
    seg = edge_segments(edges.i, edges.j, m)
    th = theta.to(torch.float32)
    tt = t.to(torch.float32)
    hist = torch.zeros((opts.iteration_bound,), dtype=torch.float32, device=dev)
    steps = torch.arange(opts.iteration_bound, device=dev)
    cg = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(n_it):
        r, Ji, Jj = _edge_linearization(th, tt, edges)
        Hdiag, Hij, b, chi2 = normal_equations(r, Ji, Jj, edges, opts, m, seg)
        if opts.solver == "dense":
            dx = _solve_dense(Hdiag, Hij, b, edges, m)
        else:
            dx, n = solve_pcg(Hdiag, Hij, edges.i, edges.j, b, m, opts.max_cg_iterations,
                              opts.cg_tol, seg)
            cg = cg + n
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        # the body-frame perturbation (the residual's convention)
        c, s = torch.cos(th), torch.sin(th)
        tt = tt + torch.stack([c * dx[:, 0] - s * dx[:, 1], s * dx[:, 0] + c * dx[:, 1]], dim=-1)
        th = lie.wrap_angle(th + dx[:, 2])
        hist = torch.where(steps >= k, torch.sum(chi2 * edges.valid), hist)
    r = _edge_linearization(th, tt, edges)[0]
    return Pgo2dResult(theta=th, t=tt, chi2=_chi2(r, edges.info), chi2_hist=hist,
                       rot_norm=torch.abs(r[:, 2]),
                       trans_norm=torch.linalg.vector_norm(r[:, :2], dim=-1),
                       cg_iterations=cg)


def optimize_two_phase(theta, t, edges: Se2Edges, opts: PgoOptions = PgoOptions()):
    """Residual-gated loop validation (loop_closing.cpp:219-246): residuals
    at the start pre-gate the loop edges, phase 1 optimizes, loop edges
    whose residual then exceeds the (trans, rot) gates are dropped, phase 2
    optimizes without them. Returns (theta, t, loop-edge inlier mask over
    all edges)."""
    edges = edges_to(edges, theta.device)
    res0 = optimize(theta, t, edges, opts, num_iterations=0)
    plausible = (~edges.is_loop) | ((res0.trans_norm <= opts.loop_pregate_trans)
                                    & (res0.rot_norm <= opts.loop_pregate_rot))
    res1 = optimize(theta, t, edges._replace(valid=edges.valid & plausible), opts,
                    num_iterations=opts.max_iterations)
    inlier = plausible & ((~edges.is_loop) | ((res1.trans_norm <= opts.loop_gate_trans)
                                              & (res1.rot_norm <= opts.loop_gate_rot)))
    res2 = optimize(res1.theta, res1.t, edges._replace(valid=edges.valid & inlier), opts,
                    num_iterations=opts.second_phase_iterations)
    return res2.theta, res2.t, inlier & edges.is_loop


def odometry_edges(theta, t, info_scale: float = 1e4) -> Se2Edges:
    """Sequential edges of a pose chain with info = info_scale * I."""
    m = theta.shape[0]
    dev = theta.device
    i = torch.arange(m - 1, dtype=torch.int64, device=dev)
    j = i + 1
    c, s = torch.cos(theta[i]), torch.sin(theta[i])
    d = t[j] - t[i]
    rel_t = torch.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]], dim=-1)
    info = (torch.eye(3, dtype=torch.float32, device=dev) * info_scale).expand(m - 1, 3, 3)
    return Se2Edges(i=i, j=j, theta=lie.wrap_angle(theta[j] - theta[i]), t=rel_t,
                    info=info.contiguous(),
                    is_loop=torch.zeros((m - 1,), dtype=torch.bool, device=dev),
                    valid=torch.ones((m - 1,), dtype=torch.bool, device=dev))


def pad_graph(theta, t, edges: Se2Edges, bucket: int = 8):
    """Pad nodes and edges up to the next multiple of `bucket`: padded nodes
    are identity with no incident edges, padded edges are invalid; the
    solution of the real nodes does not change. Returns (theta_pad, t_pad,
    edges_pad, m_real)."""
    m, e = theta.shape[0], edges.i.shape[0]
    mp = -(-m // bucket) * bucket
    ep = -(-e // bucket) * bucket
    if mp == m and ep == e:
        return theta, t, edges, m
    dev = theta.device
    k = ep - e
    pad = Se2Edges(
        i=torch.zeros((k,), dtype=torch.int64, device=dev),
        j=torch.zeros((k,), dtype=torch.int64, device=dev),
        theta=torch.zeros((k,), dtype=torch.float32, device=dev),
        t=torch.zeros((k, 2), dtype=torch.float32, device=dev),
        info=torch.eye(3, dtype=torch.float32, device=dev).expand(k, 3, 3).contiguous(),
        is_loop=torch.zeros((k,), dtype=torch.bool, device=dev),
        valid=torch.zeros((k,), dtype=torch.bool, device=dev))
    theta_pad = torch.cat([theta, torch.zeros((mp - m,), dtype=torch.float32, device=dev)])
    t_pad = torch.cat([t, torch.zeros((mp - m, 2), dtype=torch.float32, device=dev)])
    return theta_pad, t_pad, concat_edges(edges_to(edges, dev), pad), m


def build_graph_np(theta, t, loops, info_scale: float = 1e4, loop_info_scale: float = 1e4):
    """The whole SE(2) graph (odometry chain + `loops`) in host numpy, padded
    to coarse buckets (nodes >= 32, edges >= 64, then doubling). `loops`:
    iterable of (i, j, theta_ij, t_ij, valid). Returns (theta_pad, t_pad,
    Se2Edges of numpy, m_real)."""
    theta = np.asarray(theta, np.float32)
    t = np.asarray(t, np.float32)
    m = len(theta)
    i = np.arange(m - 1, dtype=np.int32)
    j = i + 1
    c, s = np.cos(theta[i]), np.sin(theta[i])
    d = t[j] - t[i]
    rel_t = np.stack([c * d[:, 0] + s * d[:, 1],
                      -s * d[:, 0] + c * d[:, 1]], axis=-1)
    rel_th = ((theta[j] - theta[i] + np.pi) % (2 * np.pi) - np.pi)
    n_loop = len(loops)
    e = (m - 1) + n_loop
    mp, ep = 32, 64
    while mp < m:
        mp *= 2
    while ep < e:
        ep *= 2
    k = ep - e

    ei = np.concatenate([i, np.array([l[0] for l in loops], np.int32),
                         np.zeros((k,), np.int32)])
    ej = np.concatenate([j, np.array([l[1] for l in loops], np.int32),
                         np.zeros((k,), np.int32)])
    eth = np.concatenate([rel_th.astype(np.float32),
                          np.array([l[2] for l in loops], np.float32),
                          np.zeros((k,), np.float32)])
    et = np.concatenate([rel_t.astype(np.float32),
                         (np.stack([l[3] for l in loops]).astype(np.float32)
                          if n_loop else np.zeros((0, 2), np.float32)),
                         np.zeros((k, 2), np.float32)])
    info = np.concatenate([
        np.broadcast_to(np.eye(3, dtype=np.float32) * info_scale,
                        (m - 1, 3, 3)),
        np.broadcast_to(np.eye(3, dtype=np.float32) * loop_info_scale,
                        (n_loop, 3, 3)),
        np.broadcast_to(np.eye(3, dtype=np.float32), (k, 3, 3))])
    is_loop = np.concatenate([np.zeros((m - 1,), bool),
                              np.ones((n_loop,), bool),
                              np.zeros((k,), bool)])
    valid = np.concatenate([np.ones((m - 1,), bool),
                            np.array([bool(l[4]) for l in loops], bool),
                            np.zeros((k,), bool)])
    theta_pad = np.concatenate([theta, np.zeros((mp - m,), np.float32)])
    t_pad = np.concatenate([t, np.zeros((mp - m, 2), np.float32)])
    edges = Se2Edges(i=ei, j=ej, theta=eth, t=np.ascontiguousarray(et),
                     info=np.ascontiguousarray(info), is_loop=is_loop,
                     valid=valid)
    return theta_pad, t_pad, edges, m
