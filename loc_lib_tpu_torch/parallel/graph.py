"""Distributed pose-graph optimization: the edges split over the mesh (port
of loc_lib_tpu/parallel/graph.py).

Node states are small (M x (3,3) + (3,)) and stay replicated; the EDGE SET
(linearization, robust weights, block products, and the off-diagonal half
of every matvec) is split over the ranks in contiguous blocks. The normal
equations never form: the block-Jacobi PCG of graph/pose_graph.py runs
with `group=`, so the node sums are all-reduced once per GN iteration and
the off-diagonal matvec once per CG iteration (6 M floats, independent of
the edge count), Hdiag x added after the reduction, and the CG dot
products run on replicated vectors. `optimize_two_phase` gates the loop
edges on their owning rank (the gates are per edge). The edge count is
padded to a multiple of the world size with invalid rows (`pad_edges`).

Per-edge outputs (chi2, the loop inlier mask) come back whole on every
rank, in the padded edge order (`mesh.gather_slots`).
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..graph import pose_graph as pg
from ..utils import lie
from . import mesh as mesh_mod


def pad_edges(edges: pg.Se3Edges, multiple: int) -> pg.Se3Edges:
    """Pad with invalid rows (node 0 -> node 0, identity) to a multiple of
    `multiple`: their contribution to the normal equations is exactly 0."""
    pad = (-edges.i.shape[0]) % multiple
    if pad == 0:
        return edges
    return pg.concat_edges(edges, pg.make_pad_edges(pad, edges.i.device))


def _shard(edges: pg.Se3Edges, mesh: DeviceMesh) -> pg.Se3Edges:
    """This rank's contiguous block of the (padded) edges."""
    n, r = mesh.size(), mesh.get_rank()
    k = edges.i.shape[0] // n
    return pg.Se3Edges(*(x[r * k:(r + 1) * k] for x in edges))


def _gather(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's per-edge block, concatenated in rank order."""
    if mesh.size() == 1:
        return x
    bits = x.to(torch.int32) if x.dtype == torch.bool else x
    out = mesh_mod.gather_slots(bits, mesh, mesh.mesh_dim_names)
    return out.reshape((-1,) + tuple(x.shape[1:])).to(x.dtype)


def _gn_phase(R, t, shard: pg.Se3Edges, opts: pg.PgoOptions, m: int, iterations: int,
              group):
    """`iterations` robust GN sweeps with the distributed block-sparse
    solve; every rank holds the same node states throughout."""
    seg = pg.edge_segments(shard.i, shard.j, m)
    for _ in range(iterations):
        Hdiag, Hij, b, _ = pg._assemble_blocks(R, t, shard, opts, m, seg, group=group)
        dx, _ = pg.solve_pcg(Hdiag, Hij, shard.i, shard.j, b, m, opts.max_cg_iterations,
                             opts.cg_tol, seg, group=group)
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        R, t = lie.se3_retract_full(R, t, dx)
    return R, t


def _local_residual_norms(R, t, shard: pg.Se3Edges):
    r = pg._edge_residuals(R, t, shard)
    return torch.linalg.vector_norm(r[:, :3], dim=-1), torch.linalg.vector_norm(r[:, 3:], dim=-1)


def _setup(mesh: DeviceMesh, nodes_R, edges):
    edges = pad_edges(pg.edges_to(edges, nodes_R.device), mesh.size())
    return _shard(edges, mesh), mesh_mod.group(mesh, mesh.mesh_dim_names)


def optimize(mesh: DeviceMesh, nodes_R, nodes_t, edges: pg.Se3Edges,
             opts: pg.PgoOptions = pg.PgoOptions()):
    """Distributed robust GN (the PCG solver). Returns (R, t, per-edge chi2
    at the optimum over the padded edges)."""
    m = nodes_R.shape[0]
    shard, group = _setup(mesh, nodes_R, edges)
    R, t = _gn_phase(nodes_R.to(torch.float32), nodes_t.to(torch.float32), shard, opts, m,
                     opts.max_iterations, group)
    chi2 = pg._chi2(pg._edge_residuals(R, t, shard), shard.info)
    return R, t, _gather(chi2, mesh)


def optimize_two_phase(mesh: DeviceMesh, nodes_R, nodes_t, edges: pg.Se3Edges,
                       opts: pg.PgoOptions = pg.PgoOptions()):
    """Distributed validate-then-reoptimize: pre-gate implausible loops,
    optimize, drop the loop edges whose residual then exceeds the gates,
    optimize again. Returns (R, t, loop-edge inlier mask over the padded
    edges)."""
    m = nodes_R.shape[0]
    R0, t0 = nodes_R.to(torch.float32), nodes_t.to(torch.float32)
    shard, group = _setup(mesh, nodes_R, edges)
    rot0, trans0 = _local_residual_norms(R0, t0, shard)
    plausible = (~shard.is_loop) | ((trans0 <= opts.loop_pregate_trans)
                                    & (rot0 <= opts.loop_pregate_rot))
    R, t = _gn_phase(R0, t0, shard._replace(valid=shard.valid & plausible), opts, m,
                     opts.max_iterations, group)
    rot_n, trans_n = _local_residual_norms(R, t, shard)
    inlier = plausible & ((~shard.is_loop) | ((trans_n <= opts.loop_gate_trans)
                                              & (rot_n <= opts.loop_gate_rot)))
    R, t = _gn_phase(R, t, shard._replace(valid=shard.valid & inlier), opts, m,
                     opts.second_phase_iterations, group)
    return R, t, _gather(inlier & shard.is_loop, mesh)
