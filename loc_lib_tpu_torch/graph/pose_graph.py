"""SE(3) pose-graph optimization: robust Gauss-Newton over all edges at once
(port of loc_lib_tpu/graph/pose_graph.py; its `axis_name` reductions are
the `group=` arguments here, which parallel/graph.py passes).

  * every edge is linearized in closed form in one batched pass (the SE(3)
    inverse Jacobians, utils/lie.py);
  * the normal equations assemble into block-sparse form: (M, 6, 6)
    diagonal blocks and (E, 6, 6) off-diagonal blocks, summed per node by
    `voxel.segment_sum` over the edges sorted (stably) by node, so the sums
    have the same bits on every run (a float `index_add_` adds with atomics
    on CUDA) and, on the CPU, the edge order of JAX's segment_sum;
  * block-Jacobi preconditioned CG (`solve_pcg`) never forms the (6M, 6M)
    system; the dense direct solve is kept as the oracle, and is the 2D
    graph's default (its H is summed by `voxel.segment_sum` too, never by an
    accumulating scatter);
  * Cauchy / Huber reweighting, and `optimize_two_phase`: pre-gate, solve,
    chi2-gate the loop edges, solve again without the outliers.

With `group` (a torch.distributed process group), the edges are this
rank's shard: the node-indexed sums (Hdiag before its damping and gauge,
b) and the off-diagonal half of every matvec are all-reduced over the
group, so they come out replicated, while the edge-indexed outputs stay
local; the PCG's dot products run on replicated (M, 6) vectors and need no
reduction. With group=None nothing is reduced and the bits are those of
the single-device solve.

The gauge is fixed by a strong prior on node 0. The GN loop runs a host
count of iterations and reads nothing back. The PCG loop is the one place
that needs a stop decision: its state stops changing once the residual test
fails (a done flag on the device, `torch.where`), and the host reads the
flag every CG_CHECK_EVERY iterations, so the result has the bits of
stopping exactly at the test, at a host read per CG_CHECK_EVERY iterations.

The numpy graph builders (`odometry_edges_np`, `make_pad_edges_np`,
`concat_edges_np`) are copies of the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import voxel
from ..ops.pointcloud import card_device
from ..utils import lie

# PCG iterations between two host reads of the stop flag: any value gives the
# same result; fewer reads cost up to this many - 1 masked iterations
CG_CHECK_EVERY = 8


@dataclasses.dataclass(frozen=True)
class PgoOptions:
    """Mirror of the JAX package's PgoOptions (same names and defaults)."""

    # "pcg": block-sparse preconditioned CG, O(M + E) memory; "dense": the
    # direct solve of the densified system, the oracle for small graphs
    solver: str = "pcg"
    max_cg_iterations: int = 250
    cg_tol: float = 1e-7            # relative residual-norm-squared stop
    max_iterations: int = 25
    kernel: str = "huber"           # cauchy | huber | none
    kernel_delta: float = 30.0      # kernel width in sqrt-chi2 units
    # loop-edge gates on the tangent residual after phase 1 ...
    loop_gate_trans: float = 1.0    # [m]
    loop_gate_rot: float = 0.35     # [rad]
    # ... and before any solve (a loop farther off than odometry can drift
    # is wrong and must not bend the trajectory)
    loop_pregate_trans: float = 10.0  # [m]
    loop_pregate_rot: float = 1.0     # [rad]
    second_phase_iterations: int = 5
    damping: float = 1e-6           # LM-style diagonal damping
    gauge_weight: float = 1e8       # prior weight pinning node 0

    @property
    def iteration_bound(self) -> int:
        """`optimize` clamps num_iterations to this (and sizes chi2_hist)."""
        return max(self.max_iterations, self.second_phase_iterations)


class PgoResult(NamedTuple):
    """optimize() result. rot/trans_norm are the per-edge tangent residual
    norms at the RETURNED poses, over all edges (ignoring `valid`)."""

    R: torch.Tensor
    t: torch.Tensor
    chi2: torch.Tensor          # (E,) per-edge chi2 at the returned poses
    chi2_hist: torch.Tensor     # (iteration_bound,) total chi2 per iteration
    rot_norm: torch.Tensor      # (E,) [rad]
    trans_norm: torch.Tensor    # (E,) [m]
    # port only: CG iterations run over the call, () int64 on the device
    # (0 for the dense solver)
    cg_iterations: torch.Tensor


class Se3Edges(NamedTuple):
    """Relative-pose constraints i -> j with per-edge information (tensors,
    or numpy arrays from the *_np builders)."""

    i: torch.Tensor        # (E,) int
    j: torch.Tensor        # (E,) int
    R: torch.Tensor        # (E, 3, 3) measured R_i_j
    t: torch.Tensor        # (E, 3)    measured t_i_j
    info: torch.Tensor     # (E, 6, 6) information matrix
    is_loop: torch.Tensor  # (E,) bool, subject to the loop gates
    valid: torch.Tensor    # (E,) bool


def edges_to(edges, device):
    """`edges` (Se3Edges or pose_graph2d.Se2Edges, of numpy or tensors) as
    tensors on `device`: indices int64, flags bool, the rest float32."""
    dtypes = {"i": torch.int64, "j": torch.int64, "is_loop": torch.bool, "valid": torch.bool}

    def conv(x, dtype):
        return torch.as_tensor(np.array(x) if not isinstance(x, torch.Tensor) else x,
                               device=device).to(dtype)
    return type(edges)(**{k: conv(v, dtypes.get(k, torch.float32))
                          for k, v in edges._asdict().items()})


def _residuals(Ri, ti, Rj, tj, Rm, tm):
    """r = Log(T_i^-1 T_j Z^-1) per edge, (E, 6)."""
    Rij, tij = lie.se3_compose(*lie.se3_inverse(Ri, ti), Rj, tj)
    Re, te = lie.se3_compose(Rij, tij, *lie.se3_inverse(Rm, tm))
    return lie.se3_log(Re, te)


def _linearize(Ri, ti, Rj, tj, Rm, tm):
    """Closed-form linearization of r = Log(T_i^-1 T_j Z^-1) with respect
    to the right perturbations of T_i and T_j, for all edges at once (the
    JAX package's `_linearize_one` over a leading edge axis).

    With A = T_i^-1 T_j and r = Log(A Z^-1):
      * T_i side: (T_i Exp(xi))^-1 T_j Z^-1 = Exp(-xi) Exp(r), so
        J_i = -Jl^-1(r);
      * T_j side: A Exp(xi) Z^-1 = Exp(r) Exp(Ad(Z) xi), so
        J_j = Jr^-1(r) Ad(Z).
    Returns (r (E, 6), J_i (E, 6, 6), J_j (E, 6, 6))."""
    r = _residuals(Ri, ti, Rj, tj, Rm, tm)
    Ji = -lie.se3_jl_inv(r)
    Jj = lie.se3_jr_inv(r) @ lie.se3_adjoint(Rm, tm)
    return r, Ji, Jj


def _robust_weight(opts: PgoOptions, chi2: torch.Tensor) -> torch.Tensor:
    """g2o-style rho'(s) weights."""
    d2 = opts.kernel_delta ** 2
    if opts.kernel == "cauchy":
        return 1.0 / (1.0 + chi2 / d2)
    if opts.kernel == "huber":
        s = torch.sqrt(torch.clamp(chi2, min=1e-12))
        return torch.where(s <= opts.kernel_delta, 1.0, opts.kernel_delta / s)
    return torch.ones_like(chi2)


def _chi2(r, info):
    return torch.einsum("ei,eij,ej->e", r, info, r)


def _edge_residuals(R, t, edges: Se3Edges):
    return _residuals(R[edges.i], t[edges.i], R[edges.j], t[edges.j], edges.R, edges.t)


def edge_chi2(nodes_R, nodes_t, edges: Se3Edges) -> torch.Tensor:
    """Per-edge chi2 = r^T info r at the current estimate."""
    return _chi2(_edge_residuals(nodes_R, nodes_t, edges), edges.info)


def edge_residual_norms(nodes_R, nodes_t, edges: Se3Edges):
    """Per-edge tangent residual split into (rot_norm [rad], trans_norm [m])."""
    r = _edge_residuals(nodes_R, nodes_t, edges)
    return torch.linalg.vector_norm(r[:, :3], dim=-1), torch.linalg.vector_norm(r[:, 3:], dim=-1)


class EdgeSegments(NamedTuple):
    """The edges sorted (stably) by i and by j, with the run boundaries of
    each node: what the node-indexed sums of the normal equations and of the
    block matvec read. Built once per `optimize` call (i and j do not change
    across its iterations)."""

    by_i: torch.Tensor     # (E,) permutation sorting the edges by i
    off_i: torch.Tensor    # (M + 1,) run boundaries of each node among them
    by_j: torch.Tensor
    off_j: torch.Tensor


def edge_segments(e_i: torch.Tensor, e_j: torch.Tensor, m: int) -> EdgeSegments:
    by_i = torch.argsort(e_i, stable=True)
    by_j = torch.argsort(e_j, stable=True)
    return EdgeSegments(by_i, voxel.segment_offsets(e_i[by_i], m),
                        by_j, voxel.segment_offsets(e_j[by_j], m))


def _node_sum(values_i, values_j, seg: EdgeSegments):
    """sum over edges of values_i into node i plus values_j into node j."""
    return (voxel.segment_sum(values_i[seg.by_i], seg.off_i)
            + voxel.segment_sum(values_j[seg.by_j], seg.off_j))


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone()
    torch.distributed.all_reduce(out, group=group)
    return out


def normal_equations(r, Ji, Jj, edges, opts: PgoOptions, m: int, seg: EdgeSegments,
                     group=None):
    """Block-sparse normal equations of linearized edges (r (E, k), Ji / Jj
    (E, k, k); any tangent size k): Hdiag (M, k, k) with damping and the
    gauge prior on node 0, Hij (E, k, k) off-diagonal blocks (zero for
    invalid edges), b (M, k), per-edge chi2. Shared by the SE(2) graph.
    With `group`, the node sums are all-reduced (one call) before the
    damping and the gauge are added."""
    chi2 = _chi2(r, edges.info)
    w = _robust_weight(opts, chi2) * edges.valid.to(r.dtype)
    info_w = edges.info * w[:, None, None]

    Hii = torch.einsum("eki,ekl,elj->eij", Ji, info_w, Ji)
    Hjj = torch.einsum("eki,ekl,elj->eij", Jj, info_w, Jj)
    Hij = torch.einsum("eki,ekl,elj->eij", Ji, info_w, Jj)
    bi = -torch.einsum("eki,ekl,el->ei", Ji, info_w, r)
    bj = -torch.einsum("eki,ekl,el->ei", Jj, info_w, r)

    k = r.shape[-1]
    eye = torch.eye(k, dtype=torch.float32, device=r.device)
    node_H = _node_sum(Hii, Hjj, seg)
    b = _node_sum(bi, bj, seg)
    if group is not None:
        sums = _all_reduce(torch.cat([node_H.reshape(m, k * k), b], dim=1), group)
        node_H, b = sums[:, :k * k].reshape(m, k, k), sums[:, k * k:]
    Hdiag = node_H + opts.damping * eye
    gauge = torch.zeros((m, 1, 1), dtype=torch.float32, device=r.device)
    gauge[0] = opts.gauge_weight
    Hdiag = Hdiag + gauge * eye
    return Hdiag, Hij * edges.valid[:, None, None], b, chi2


def _assemble_blocks(R, t, edges: Se3Edges, opts: PgoOptions, m: int,
                     seg: Optional[EdgeSegments] = None, group=None):
    """Linearize all edges and assemble the block-sparse normal equations
    (`normal_equations`)."""
    seg = seg if seg is not None else edge_segments(edges.i, edges.j, m)
    r, Ji, Jj = _linearize(R[edges.i], t[edges.i], R[edges.j], t[edges.j], edges.R, edges.t)
    return normal_equations(r, Ji, Jj, edges, opts, m, seg, group)


def _solve_dense(Hdiag, Hij, b, edges, m: int):
    """Densify the (kM, kM) system and direct-solve: the SE(3) graph's
    oracle, the SE(2) graph's default (small graphs; any block size k).
    Scatter-free: the diagonal blocks, Hij at
    (i, j) and Hij^T at (j, i) are sorted (stably) by their cell i * M + j
    and repeated cells summed by `voxel.segment_sum` over all M^2 cells, in
    the order diagonal, then edges in edge order: the same bits on every
    run (an accumulating index_put_ adds with atomics on CUDA)."""
    k = Hdiag.shape[-1]
    idx = torch.arange(m, device=Hdiag.device)
    e_i, e_j = edges.i.long(), edges.j.long()
    cell = torch.cat([idx * m + idx, e_i * m + e_j, e_j * m + e_i])
    blocks = torch.cat([Hdiag, Hij, Hij.transpose(-1, -2)])
    order = torch.argsort(cell, stable=True)
    H = voxel.segment_sum(blocks[order], voxel.segment_offsets(cell[order], m * m))
    H = H.reshape(m, m, k, k).transpose(1, 2).reshape(k * m, k * m)
    return torch.linalg.solve(H, b.reshape(k * m)).reshape(m, k)


class _Operator(NamedTuple):
    """H in block-sparse form with the off-diagonal blocks pre-sorted for
    the two node sums of a matvec (gathered once per solve)."""

    Hdiag: torch.Tensor    # (M, 6, 6)
    H_by_i: torch.Tensor   # (E, 6, 6) Hij sorted by i
    j_by_i: torch.Tensor   # (E,) j in that order
    Ht_by_j: torch.Tensor  # (E, 6, 6) Hij^T sorted by j
    i_by_j: torch.Tensor   # (E,) i in that order
    seg: EdgeSegments


def _operator(Hdiag, Hij, e_i, e_j, seg: EdgeSegments) -> _Operator:
    return _Operator(Hdiag, Hij[seg.by_i], e_j[seg.by_i],
                     Hij.transpose(-1, -2)[seg.by_j], e_i[seg.by_j], seg)


def _apply(op: _Operator, x, group=None):
    y = (voxel.segment_sum(torch.einsum("eij,ej->ei", op.H_by_i, x[op.j_by_i]), op.seg.off_i)
         + voxel.segment_sum(torch.einsum("eij,ej->ei", op.Ht_by_j, x[op.i_by_j]),
                             op.seg.off_j))
    if group is not None:
        y = _all_reduce(y, group)       # the off-diagonal half; Hdiag x after it
    return y + torch.einsum("mij,mj->mi", op.Hdiag, x)


def block_matvec(Hdiag, Hij, e_i, e_j, x, m: int, seg: Optional[EdgeSegments] = None,
                 group=None):
    """y = H x with H in block-sparse form; x, y are (M, 6). With `group`
    the edge arrays are this rank's shard and Hdiag is replicated."""
    seg = seg if seg is not None else edge_segments(e_i, e_j, m)
    return _apply(_operator(Hdiag, Hij, e_i, e_j, seg), x, group)


def solve_pcg(Hdiag, Hij, e_i, e_j, b, m: int, max_iterations: int, tol: float,
              seg: Optional[EdgeSegments] = None, group=None):
    """Block-Jacobi preconditioned CG on the block-sparse normal equations;
    never forms H. Stops when |r|^2 <= tol |b|^2 or after max_iterations.

    The stop test is a device flag: once it is false the iterate (x, r, p,
    rz) stops changing, and the host reads the flag every CG_CHECK_EVERY
    iterations, so x has the bits of stopping exactly at the test. Returns (x (M, 6), CG iterations run: () int64 on the
    device)."""
    seg = seg if seg is not None else edge_segments(e_i, e_j, m)
    op = _operator(Hdiag, Hij, e_i, e_j, seg)
    eps = 1e-20
    Minv = torch.linalg.inv_ex(Hdiag, check_errors=False).inverse
    dot = lambda a, bb: torch.sum(a * bb)
    precond = lambda r: torch.einsum("mij,mj->mi", Minv, r)

    stop = tol * dot(b, b)
    x = torch.zeros_like(b)
    r = b
    p = precond(r)
    rz = dot(r, p)
    active = dot(r, r) > stop
    count = torch.zeros((), dtype=torch.int64, device=b.device)
    for k in range(max_iterations):
        if k and k % CG_CHECK_EVERY == 0 and not bool(active):   # the host read
            break
        Ap = _apply(op, p, group)
        alpha = rz / torch.clamp(dot(p, Ap), min=eps)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = precond(r_new)
        rz_new = dot(r_new, z)
        p_new = z + rz_new / torch.clamp(rz, min=eps) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rz = torch.where(active, rz_new, rz)
        count = count + active.to(torch.int64)
        active = active & (dot(r, r) > stop)
    return x, count


def optimize(nodes_R, nodes_t, edges: Se3Edges, opts: PgoOptions = PgoOptions(),
             num_nodes: Optional[int] = None, num_iterations: Optional[int] = None
             ) -> PgoResult:
    """Robust GN over the whole graph. `num_iterations` (default
    opts.max_iterations) is clamped to opts.iteration_bound; chi2_hist
    entries past the executed count repeat the last value. Tensors in, on
    one device; `edges` may be numpy (converted to nodes_R's device)."""
    dev = nodes_R.device
    edges = edges_to(edges, dev)
    m = num_nodes or nodes_R.shape[0]
    n_it = min(opts.max_iterations if num_iterations is None else int(num_iterations),
               opts.iteration_bound)
    seg = edge_segments(edges.i, edges.j, m)
    R = nodes_R.to(torch.float32)
    t = nodes_t.to(torch.float32)
    hist = torch.zeros((opts.iteration_bound,), dtype=torch.float32, device=dev)
    steps = torch.arange(opts.iteration_bound, device=dev)
    cg = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(n_it):
        Hdiag, Hij, b, chi2 = _assemble_blocks(R, t, edges, opts, m, seg)
        if opts.solver == "dense":
            dx = _solve_dense(Hdiag, Hij, b, edges, m)
        else:
            dx, n = solve_pcg(Hdiag, Hij, edges.i, edges.j, b, m, opts.max_cg_iterations,
                              opts.cg_tol, seg)
            cg = cg + n
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        R, t = lie.se3_retract_full(R, t, dx)
        total = torch.sum(chi2 * edges.valid)
        hist = torch.where(steps >= k, total, hist)
    r = _edge_residuals(R, t, edges)
    return PgoResult(R=R, t=t, chi2=_chi2(r, edges.info), chi2_hist=hist,
                     rot_norm=torch.linalg.vector_norm(r[:, :3], dim=-1),
                     trans_norm=torch.linalg.vector_norm(r[:, 3:], dim=-1),
                     cg_iterations=cg)


def two_phase(nodes_R, nodes_t, edges: Se3Edges, opts: PgoOptions = PgoOptions()):
    """`optimize_two_phase` with the phases' results: (phase-1 result,
    phase-2 result, loop-edge inlier mask)."""
    edges = edges_to(edges, nodes_R.device)
    res0 = optimize(nodes_R, nodes_t, edges, opts, num_iterations=0)
    plausible = (~edges.is_loop) | ((res0.trans_norm <= opts.loop_pregate_trans)
                                    & (res0.rot_norm <= opts.loop_pregate_rot))
    res1 = optimize(nodes_R, nodes_t, edges._replace(valid=edges.valid & plausible), opts,
                    num_iterations=opts.max_iterations)
    inlier = plausible & ((~edges.is_loop) | ((res1.trans_norm <= opts.loop_gate_trans)
                                              & (res1.rot_norm <= opts.loop_gate_rot)))
    res2 = optimize(res1.R, res1.t, edges._replace(valid=edges.valid & inlier), opts,
                    num_iterations=opts.second_phase_iterations)
    return res1, res2, inlier & edges.is_loop


def optimize_two_phase(nodes_R, nodes_t, edges: Se3Edges, opts: PgoOptions = PgoOptions()):
    """Validate, then re-optimize: residuals at the start pre-gate the loop
    edges, phase 1 optimizes, loop edges whose tangent residual then exceeds
    the (trans, rot) gates are dropped, and phase 2 optimizes without them.
    Returns (R, t, loop-edge inlier mask)."""
    _, res2, inlier = two_phase(nodes_R, nodes_t, edges, opts)
    return res2.R, res2.t, inlier


def odometry_edges(poses_R, poses_t, info_scale: float = 1e4) -> Se3Edges:
    """Sequential edges of a pose chain with info = info_scale * I."""
    m = poses_R.shape[0]
    dev = poses_R.device
    i = torch.arange(m - 1, dtype=torch.int64, device=dev)
    j = i + 1
    Rrel, trel = lie.se3_compose(*lie.se3_inverse(poses_R[i], poses_t[i]), poses_R[j],
                                 poses_t[j])
    info = (torch.eye(6, dtype=torch.float32, device=dev) * info_scale).expand(m - 1, 6, 6)
    return Se3Edges(i=i, j=j, R=Rrel, t=trel, info=info.contiguous(),
                    is_loop=torch.zeros((m - 1,), dtype=torch.bool, device=dev),
                    valid=torch.ones((m - 1,), dtype=torch.bool, device=dev))


def concat_edges(a, b):
    """Rows of b after those of a (Se3Edges or Se2Edges of tensors)."""
    return type(a)(*[torch.cat([x, y]) for x, y in zip(a, b)])


def make_pad_edges(k: int, device=None) -> Se3Edges:
    """k invalid identity self-edges (node 0 -> node 0, valid=False) on
    `device` (default: the card): their contribution to the normal equations
    is exactly zero."""
    device = card_device(device)
    return Se3Edges(
        i=torch.zeros((k,), dtype=torch.int64, device=device),
        j=torch.zeros((k,), dtype=torch.int64, device=device),
        R=torch.eye(3, dtype=torch.float32, device=device).expand(k, 3, 3).contiguous(),
        t=torch.zeros((k, 3), dtype=torch.float32, device=device),
        info=torch.eye(6, dtype=torch.float32, device=device).expand(k, 6, 6).contiguous(),
        is_loop=torch.zeros((k,), dtype=torch.bool, device=device),
        valid=torch.zeros((k,), dtype=torch.bool, device=device))


def pad_graph(nodes_R, nodes_t, edges: Se3Edges, bucket: int = 16):
    """Pad nodes and edges up to the next multiple of `bucket`: padded nodes
    are identity with no incident edges (their step is 0), padded edges are
    invalid; the solution of the real nodes does not change. Returns
    (R_pad, t_pad, edges_pad, m_real)."""
    m, e = nodes_R.shape[0], edges.i.shape[0]
    mp = -(-m // bucket) * bucket
    ep = -(-e // bucket) * bucket
    if mp == m and ep == e:
        return nodes_R, nodes_t, edges, m
    dev = nodes_R.device
    eye = torch.eye(3, dtype=torch.float32, device=dev).expand(mp - m, 3, 3)
    R_pad = torch.cat([nodes_R, eye])
    t_pad = torch.cat([nodes_t, torch.zeros((mp - m, 3), dtype=torch.float32, device=dev)])
    return R_pad, t_pad, concat_edges(edges_to(edges, dev), make_pad_edges(ep - e, dev)), m


# ---------------------------------------------------------------------------
# Host numpy graph builders (copies of the JAX package's): a graph is built
# on the host once per optimize, and only the solver touches the device
# ---------------------------------------------------------------------------

def odometry_edges_np(poses_R, poses_t, info_scale: float = 1e4) -> Se3Edges:
    """`odometry_edges` computed in host numpy."""
    R = np.asarray(poses_R, np.float32)
    t = np.asarray(poses_t, np.float32)
    m = len(R)
    Ri, Rj = R[:-1], R[1:]
    Rrel = np.einsum("nki,nkj->nij", Ri, Rj)          # R_i^T R_j
    trel = np.einsum("nji,nj->ni", Ri, t[1:] - t[:-1])
    info = np.broadcast_to(np.eye(6, dtype=np.float32) * info_scale, (m - 1, 6, 6))
    return Se3Edges(
        i=np.arange(m - 1, dtype=np.int32), j=np.arange(1, m, dtype=np.int32),
        R=Rrel, t=trel, info=np.ascontiguousarray(info),
        is_loop=np.zeros((m - 1,), bool), valid=np.ones((m - 1,), bool))


def make_pad_edges_np(k: int) -> Se3Edges:
    """Numpy twin of make_pad_edges."""
    return Se3Edges(
        i=np.zeros((k,), np.int32), j=np.zeros((k,), np.int32),
        R=np.ascontiguousarray(np.broadcast_to(np.eye(3, dtype=np.float32), (k, 3, 3))),
        t=np.zeros((k, 3), np.float32),
        info=np.ascontiguousarray(np.broadcast_to(np.eye(6, dtype=np.float32), (k, 6, 6))),
        is_loop=np.zeros((k,), bool), valid=np.zeros((k,), bool))


def concat_edges_np(a: Se3Edges, b: Se3Edges) -> Se3Edges:
    return Se3Edges(*[np.concatenate([x, y]) for x, y in zip(a, b)])
