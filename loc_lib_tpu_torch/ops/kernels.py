"""Fused scan-matching linearization kernels: Hopper CUDA kernels + plain
versions.

Port of the three Pallas TPU kernels (loc_lib_tpu/ops/pallas_kernels.py):

  K1 `p2plane_fused_terms`       (pallas_kernels.py:75)  -> csrc/p2plane_fused_terms.cu
  K2 `p2plane_pick_fused_terms`  (pallas_kernels.py:185) -> csrc/p2plane_pick_fused_terms.cu
  K3 `ndt_fused_terms`           (pallas_kernels.py:314) -> csrc/ndt_fused_terms.cu

All return (H (6,6), b (6,), count () int32, chi2 ()) from one symmetric
8x8 G = sum A A^T over rows A = [J(6) | r | flag] * w: one row per point for
the P2Plane kernels K1 and K2, three rows per (point, stencil voxel) for the
generalized-Gaussian NDT kernel K3.

Every kernel has two kinds of mode. With the plane (K1), the candidate rows
(K2) or the gathered voxel rows (K3) given they take the TPU kernels'
interface. *From the target* (`p2plane_fused_terms_from_target`,
`p2plane_pick_fused_terms_from_target`) and *from the map*
(`ndt_fused_terms_from_map`, and `p2line_fused_terms_from_target` with the
nearest-line election) they take the target's tables and do the
correspondence gather themselves: the voxel lookup and row reads that the
TPU kernels left to XLA, because Pallas on the TPU could not express a
data-dependent row read. Those are the modes the matchers run: no (N, 7, 8),
(N, 8) or (N, S, 13) row tensor is made. All modes of a kernel count as
launches of that kernel.

The seam replaces the JAX package's `on_tpu()` switch with the tensor's
device: CPU tensors go to the plain PyTorch version beside each kernel; CUDA
tensors go to the hand-written kernel, which raises if it cannot be built or
launched (there is no fallback). The kernels are compiled with nvcc on first
use into `csrc/build/<hash of sources and flags>/` and loaded with ctypes;
nothing here touches nvcc or ctypes at import time.

*Batched* (`p2plane_pick_fused_terms_from_target_batch`,
`p2plane_fused_terms_from_target_batch`): the from-target modes of K2 and K1
over B independent matches (every argument with a leading B axis) in ONE
launch, the form the reference runs under `jax.vmap`. Lane b of the results
has the bits of the scalar call on lane b's inputs.

*A Gauss-Newton iteration after its linearization* (`gn_step`, and
`GnLoop` around it, csrc/gn_update.cu): the linearization (or LOAM's two)
in, then the warm-up damping, the 6x6 solve (LU with partial pivoting in
registers), the filters, retraction, stop test, the projection of R onto
SO(3) and, for a batched loop, the freeze of the lanes that have stopped, in
ONE launch, one thread a match, for the scalar and the batched loop alike;
and a byte the host reads once per iteration. In the reference this is the
while_loop's fused program (loc_lib_tpu/models/icp.py, the body of
scan_match); as torch ops it was ~20 launches an iteration. `so3_renormalize`
stays for a loop that takes no step.

*The ESKF* (csrc/eskf_predict.cu): `eskf_predict_scan`, the propagation
through one IMU packet (two warps: the nominal state, and the covariance a
lane a column over F's nonzeros), and `eskf_update`, an observation's Kalman
update (a pose or a wheel speed; one warp, a lane a column of P), one launch
each; in the reference a `lax.scan` and a jitted update program. A packet of
host arrays is read by the kernel in place, from a page-locked buffer.

`LAUNCHES` counts kernel launches per kernel (never plain-version calls),
so a run can show that its main path went through the kernels. It is the
program's one counter store, `utils.timing.COUNTERS`, which holds the
spans' totals beside the launch counts. Each call is
ONE launch, a batched call too: the last block of a lane to finish reduces
that lane's per-block partial sums.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import lie, mathx, timing
from . import voxel

KERNELS = ("p2plane_fused_terms", "p2plane_pick_fused_terms", "ndt_fused_terms", "gn_step",
           "so3_renormalize", "eskf_predict_scan", "eskf_update")
LAUNCHES = timing.COUNTERS
LAUNCHES.update(dict.fromkeys(KERNELS, 0))


def reset_launch_counts() -> None:
    """Zero the launch counts (the spans' totals are left as they are)."""
    for k in KERNELS:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the comparison on the card)
# ---------------------------------------------------------------------------

def _pose_terms(q, R, t):
    """qs = R q + t, evaluated op by op in the kernels' order."""
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    qsx = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + t[0]
    qsy = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + t[1]
    qsz = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + t[2]
    return x, y, z, qsx, qsy, qsz


def transform_plain(q, R, t):
    """qs = R q + t as (N, 3), op by op in the kernels' order: the one qs
    that decides both a point's voxel and its distances."""
    return torch.stack(_pose_terms(q, R, t)[3:], dim=1)


class TargetIndex(NamedTuple):
    """What a from-target kernel needs to find a point's voxel: the dense
    slot table over `dims` cells anchored at `lo`, and the grid's origin and
    1 / leaf (IcpTarget.dense / dense_oct and IcpTarget.grid). For the
    batched kernels every tensor carries a leading B axis."""

    table: torch.Tensor      # (dims[0] * dims[1] * dims[2],) int32, -1 empty
    lo: torch.Tensor         # (3,) int32
    origin: torch.Tensor     # (3,) float32
    inv_leaf: torch.Tensor   # () float32
    dims: tuple

    def lane(self, b: int) -> "TargetIndex":
        """Lane b of a batched index."""
        return TargetIndex(self.table[b], self.lo[b], self.origin[b], self.inv_leaf[b],
                           self.dims)


def stencil_rows_plain(q, mask, R, t, packed, index: TargetIndex):
    """K2's gather at the pose (R, t): the rows of `packed` (V, 8) for each
    point's voxel and its 6 face neighbours (the point's own voxel first),
    with the lookup hit folded into the validity column. Returns (N, 7, 8)."""
    qcoords = voxel.voxel_coords(transform_plain(q, R, t), index.inv_leaf, index.origin)
    keys7 = voxel.coords_to_key(qcoords[:, None, :] + voxel.nearby6(q.device)[None],
                                mask[:, None])
    slot7, found7 = voxel.lookup_dense(voxel.DenseIndex(index.table, index.lo), index.dims,
                                       keys7)
    rows7 = packed[slot7.to(torch.int64)]
    rows7[..., 7] = (found7 & (rows7[..., 7] > 0.5)).to(rows7.dtype)
    return rows7


def oct_rows_plain(q, mask, R, t, packed_ext, oct_table, index: TargetIndex):
    """K1's gather at the pose (R, t): per point one dense lookup of its
    voxel in the dilated table, the pre-elected row of its octant (bit k set
    where the point lies in the upper half of the voxel along axis k), and
    that row of `packed_ext`. Returns (rows (N, 8), w (N,) float32)."""
    u = (transform_plain(q, R, t) - index.origin) * index.inv_leaf
    fl = torch.floor(u)
    frac = u - fl
    octant = ((frac[:, 0] > 0.5).to(torch.int64)
              + 2 * (frac[:, 1] > 0.5).to(torch.int64)
              + 4 * (frac[:, 2] > 0.5).to(torch.int64))
    key = voxel.coords_to_key(fl.to(torch.int32), mask)
    slot, found = voxel.lookup_dense(voxel.DenseIndex(index.table, index.lo), index.dims, key)
    row_slot = torch.gather(oct_table[slot.to(torch.int64)], 1, octant[:, None])[:, 0]
    rows = packed_ext[row_slot.to(torch.int64)]
    w = (found & (rows[:, 7] > 0.5) & mask).to(q.dtype)
    return rows, w


def ndt_stencil_rows_plain(q, mask, R, t, packed, index: TargetIndex, S: int, bin_mode: str):
    """K3's gather at the pose (R, t): the rows of `packed` (V, 13) for each
    point's voxel alone (S = 1) or with its 6 face neighbours (S = 7, the
    point's own voxel first), the voxel taken by `bin_mode` ("trunc" or
    "floor") from the one qs that also gives the residuals. Returns
    (qs (N, 3), mu (N, S, 3), W (N, S, 9), valid (N, S) float32): the inputs
    of K3 with the rows given, mu and W as views of the gathered rows, the
    lookup hit folded into valid."""
    qs = transform_plain(q, R, t)
    qcoords = voxel.voxel_coords(qs, index.inv_leaf, index.origin, mode=bin_mode)
    stencil = voxel.nearby6(q.device) if S == STENCIL else voxel.center1(q.device)
    keys = voxel.coords_to_key(qcoords[:, None, :] + stencil[None], mask[:, None])
    slot, found = voxel.lookup_dense(voxel.DenseIndex(index.table, index.lo), index.dims, keys)
    rows = packed[slot.to(torch.int64)]                            # (N, S, 13)
    valid = (found & (rows[..., 12] > 0.5)).to(torch.float32)
    return qs, rows[..., 0:3], rows[..., 3:12], valid


def _rows(q, R, nx, ny, nz, dis, w):
    """A = [-(R^T n x q), n, dis, 1] * w as (N, 8), op by op in the kernels'
    order, so the kernels reproduce these rows bit for bit."""
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    rnx = R[0, 0] * nx + R[1, 0] * ny + R[2, 0] * nz
    rny = R[0, 1] * nx + R[1, 1] * ny + R[2, 1] * nz
    rnz = R[0, 2] * nx + R[1, 2] * ny + R[2, 2] * nz
    j0 = -(rny * z - rnz * y)
    j1 = -(rnz * x - rnx * z)
    j2 = -(rnx * y - rny * x)
    return torch.stack([j0, j1, j2, nx, ny, nz, dis, torch.ones_like(dis)], dim=1) * w[:, None]


def _split(G):
    return G[:6, :6], -G[:6, 6], G[7, 7].to(torch.int32), G[6, 6]


def p2plane_rows_plain(q, plane, w, R, t, gate):
    """K1's per-point rows A (N, 8); the results are sums over A A^T."""
    _, _, _, qsx, qsy, qsz = _pose_terms(q, R, t)
    nx, ny, nz, d = plane[:, 0], plane[:, 1], plane[:, 2], plane[:, 3]
    dis = nx * qsx + ny * qsy + nz * qsz + d
    wg = w * (torch.abs(dis) <= gate).to(w.dtype)
    return _rows(q, R, nx, ny, nz, dis, wg)


def p2plane_pick_rows_plain(q, rows, w, R, t, gate):
    """K2's per-point rows A (N, 8). The election is the kernel's running
    strict minimum over the S candidates (first entry wins ties)."""
    _, _, _, qsx, qsy, qsz = _pose_terms(q, R, t)
    inf = torch.full_like(qsx, float("inf"))
    best_d2 = inf
    best = [torch.zeros_like(qsx) for _ in range(4)]           # n, d
    any_valid = torch.zeros_like(qsx)
    for s in range(rows.shape[1]):
        r = rows[:, s]
        valid = r[:, 7]
        dx, dy, dz = r[:, 4] - qsx, r[:, 5] - qsy, r[:, 6] - qsz
        d2 = torch.where(valid > 0.5, dx * dx + dy * dy + dz * dz, inf)
        take = d2 < best_d2
        best_d2 = torch.where(take, d2, best_d2)
        best = [torch.where(take, r[:, k], best[k]) for k in range(4)]
        any_valid = torch.maximum(any_valid, valid)
    nx, ny, nz, d = best
    dis = nx * qsx + ny * qsy + nz * qsz + d
    wg = w * any_valid * (torch.abs(dis) <= gate).to(w.dtype)
    return _rows(q, R, nx, ny, nz, dis, wg)


def p2plane_fused_terms_plain(q, plane, w, R, t, gate):
    """Plain PyTorch K1: same arguments and results as `p2plane_fused_terms`,
    G = A^T A as a float32 matmul."""
    A = p2plane_rows_plain(q, plane, w, R, t, gate)
    return _split(A.T @ A)


def p2plane_pick_fused_terms_plain(q, rows, w, R, t, gate):
    """Plain PyTorch K2: same arguments and results as
    `p2plane_pick_fused_terms`."""
    A = p2plane_pick_rows_plain(q, rows, w, R, t, gate)
    return _split(A.T @ A)


def p2plane_from_target_rows_plain(q, mask, R, t, gate, packed_ext, oct_table,
                                   index: TargetIndex):
    """K1 from the target, per-point rows A (N, 8): the octant gather, then
    K1's rows on the plane columns."""
    rows, w = oct_rows_plain(q, mask, R, t, packed_ext, oct_table, index)
    return p2plane_rows_plain(q, rows[:, 0:4], w, R, t, gate)


def p2plane_from_target_terms_plain(q, mask, R, t, gate, packed_ext, oct_table,
                                    index: TargetIndex):
    """Plain PyTorch K1 from the target: same arguments and results as
    `p2plane_fused_terms_from_target`."""
    A = p2plane_from_target_rows_plain(q, mask, R, t, gate, packed_ext, oct_table, index)
    return _split(A.T @ A)


def p2plane_pick_from_target_rows_plain(q, mask, R, t, gate, packed, index: TargetIndex):
    """K2 from the target, per-point rows A (N, 8): the 7-voxel gather, then
    K2's election and rows."""
    rows7 = stencil_rows_plain(q, mask, R, t, packed, index)
    return p2plane_pick_rows_plain(q, rows7, mask.to(q.dtype), R, t, gate)


def p2plane_pick_from_target_terms_plain(q, mask, R, t, gate, packed, index: TargetIndex):
    """Plain PyTorch K2 from the target: same arguments and results as
    `p2plane_pick_fused_terms_from_target`."""
    A = p2plane_pick_from_target_rows_plain(q, mask, R, t, gate, packed, index)
    return _split(A.T @ A)


def _stack_lanes(outs):
    """[(H, b, count, chi2) per lane] -> ((B, 6, 6), (B, 6), (B,), (B,))."""
    return tuple(torch.stack(x) for x in zip(*outs))


def p2plane_pick_from_target_rows_plain_batch(q, mask, R, t, gate, packed,
                                              index: TargetIndex):
    """K2 from the target over B lanes, per-point rows A (B, N, 8): lane b is
    `p2plane_pick_from_target_rows_plain` on lane b's inputs."""
    return torch.stack([p2plane_pick_from_target_rows_plain(
        q[b], mask[b], R[b], t[b], gate, packed[b], index.lane(b)) for b in range(q.shape[0])])


def p2plane_pick_from_target_terms_plain_batch(q, mask, R, t, gate, packed,
                                               index: TargetIndex):
    """Plain PyTorch K2-batch: same arguments and results as
    `p2plane_pick_fused_terms_from_target_batch` (every lane computed), lane
    b bit-equal to the plain scalar call on lane b's inputs."""
    return _stack_lanes([p2plane_pick_from_target_terms_plain(
        q[b], mask[b], R[b], t[b], gate, packed[b], index.lane(b)) for b in range(q.shape[0])])


def p2plane_from_target_rows_plain_batch(q, mask, R, t, gate, packed_ext, oct_table,
                                         index: TargetIndex):
    """K1 from the target over B lanes, per-point rows A (B, N, 8)."""
    return torch.stack([p2plane_from_target_rows_plain(
        q[b], mask[b], R[b], t[b], gate, packed_ext[b], oct_table[b], index.lane(b))
        for b in range(q.shape[0])])


def p2plane_from_target_terms_plain_batch(q, mask, R, t, gate, packed_ext, oct_table,
                                          index: TargetIndex):
    """Plain PyTorch K1-batch: same arguments and results as
    `p2plane_fused_terms_from_target_batch` (every lane computed), lane b
    bit-equal to the plain scalar call on lane b's inputs."""
    return _stack_lanes([p2plane_from_target_terms_plain(
        q[b], mask[b], R[b], t[b], gate, packed_ext[b], oct_table[b], index.lane(b))
        for b in range(q.shape[0])])


def ndt_rows_plain(q, qs, mu, W, valid, R, t, outlier_th, weighted: bool):
    """K3's rows A (N * S * 3, 8) in the kernel's order (point, then stencil
    voxel s, then residual row i), op by op as the kernel evaluates them.

    Per (point, s): e = qs - mu, z = W^T e, res = |z|^2 and the weight
    w = valid * [res <= outlier_th]. Row i is
        weighted   w * [B_rot,i(M = W^T R) | (W^T)_i | z_i | flag_i]
        direct     w * [B_rot,i(M = R)     |  I_i    | e_i | flag_i]
    with B_rot row i = [m2 y - m1 z, m0 z - m2 x, m1 x - m0 y] from row i of
    M (J = [-R hat(q) | I]) and flag_i = 1 on row 0 only, so the count
    counts residuals. `t` is unused: qs arrives computed."""
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    ones = torch.ones_like(x)
    zeros = torch.zeros_like(x)
    per_s = []
    for s in range(valid.shape[1]):
        e = [qs[:, k] - mu[:, s, k] for k in range(3)]
        Wm = [[W[:, s, 3 * k + j] for j in range(3)] for k in range(3)]
        zr = [Wm[0][i] * e[0] + Wm[1][i] * e[1] + Wm[2][i] * e[2] for i in range(3)]
        res = zr[0] * zr[0] + zr[1] * zr[1] + zr[2] * zr[2]
        w = valid[:, s] * (res <= outlier_th).to(q.dtype)
        if weighted:
            M = [[Wm[0][i] * R[0, j] + Wm[1][i] * R[1, j] + Wm[2][i] * R[2, j]
                  for j in range(3)] for i in range(3)]
            Bt = [[Wm[j][i] for j in range(3)] for i in range(3)]
            r = zr
        else:
            M = [[R[i, j] for j in range(3)] for i in range(3)]
            Bt = [[ones if i == j else zeros for j in range(3)] for i in range(3)]
            r = e
        rows = []
        for i in range(3):
            m0, m1, m2 = M[i]
            rows.append(torch.stack(
                [m2 * y - m1 * z, m0 * z - m2 * x, m1 * x - m0 * y,
                 Bt[i][0], Bt[i][1], Bt[i][2], r[i], ones if i == 0 else zeros],
                dim=1) * w[:, None])
        per_s.append(torch.stack(rows, dim=1))                 # (N, 3, 8)
    return torch.stack(per_s, dim=1).reshape(-1, 8)            # (N * S * 3, 8)


def ndt_fused_terms_plain(q, qs, mu, W, valid, R, t, outlier_th, weighted: bool):
    """Plain PyTorch K3: same arguments and results as `ndt_fused_terms`."""
    A = ndt_rows_plain(q, qs, mu, W, valid, R, t, outlier_th, weighted)
    return _split(A.T @ A)


def ndt_from_map_rows_plain(q, mask, R, t, outlier_th, weighted: bool, packed,
                            index: TargetIndex, S: int, bin_mode: str):
    """K3 from the map, rows A (N * S * 3, 8): the stencil gather, then K3's
    rows."""
    qs, mu, W, valid = ndt_stencil_rows_plain(q, mask, R, t, packed, index, S, bin_mode)
    return ndt_rows_plain(q, qs, mu, W, valid, R, t, outlier_th, weighted)


def ndt_from_map_terms_plain(q, mask, R, t, outlier_th, weighted: bool, packed,
                             index: TargetIndex, S: int, bin_mode: str):
    """Plain PyTorch K3 from the map: same arguments and results as
    `ndt_fused_terms_from_map`."""
    A = ndt_from_map_rows_plain(q, mask, R, t, outlier_th, weighted, packed, index, S, bin_mode)
    return _split(A.T @ A)


def p2line_elect_plain(q, mask, R, t, line_packed, index: TargetIndex):
    """p2line_vox's correspondence at the pose (R, t): the 7-voxel gather on
    the line table (floor binning), then the kernel's election, a running
    strict minimum of |mu_s - qs|^2 over the valid candidates (the point's
    own voxel first, so it wins ties; no valid candidate keeps candidate 0).
    Returns (qs (N, 3), mu (N, 1, 3), W (N, 1, 9), w (N, 1) float32): the
    inputs of K3 with the rows given at S = 1, w = any_valid & mask."""
    qs, mu7, W7, valid7 = ndt_stencil_rows_plain(q, mask, R, t, line_packed, index, STENCIL,
                                                 "floor")
    best_d2 = torch.full_like(qs[:, 0], float("inf"))
    pick = torch.zeros(qs.shape[0], dtype=torch.int64, device=qs.device)
    for s in range(STENCIL):
        dx, dy, dz = (mu7[:, s, k] - qs[:, k] for k in range(3))
        d2 = torch.where(valid7[:, s] > 0.5, dx * dx + dy * dy + dz * dz, float("inf"))
        take = d2 < best_d2
        best_d2 = torch.where(take, d2, best_d2)
        pick = torch.where(take, s, pick)
    w = (torch.any(valid7 > 0.5, dim=1) & mask).to(torch.float32)
    at = pick[:, None, None]
    return qs, torch.take_along_dim(mu7, at, dim=1), torch.take_along_dim(W7, at, dim=1), w[:, None]


def p2line_from_target_rows_plain(q, mask, R, t, gate, line_packed, index: TargetIndex):
    """K3's p2line mode, rows A (N * 3, 8): the election, then K3's weighted
    rows of the elected voxel gated at gate^2."""
    qs, mu, W, w = p2line_elect_plain(q, mask, R, t, line_packed, index)
    g = float(gate)
    return ndt_rows_plain(q, qs, mu, W, w, R, t, g * g, True)


def p2line_from_target_terms_plain(q, mask, R, t, gate, line_packed, index: TargetIndex):
    """Plain PyTorch K3 in p2line mode: same arguments and results as
    `p2line_fused_terms_from_target`."""
    A = p2line_from_target_rows_plain(q, mask, R, t, gate, line_packed, index)
    return _split(A.T @ A)


class GnState(NamedTuple):
    """A Gauss-Newton loop's carried state over its lanes: leading axes ()
    for one match, (B,) for a batched loop. Before the loop's first
    iteration all but R and t are None (every lane active, counters at 0)."""

    R: torch.Tensor                       # (..., 3, 3) the rotation the loop carries
    t: torch.Tensor                       # (..., 3)
    R_out: Optional[torch.Tensor] = None  # (..., 3, 3) R projected onto SO(3)
    converged: Optional[torch.Tensor] = None    # (...,) bool
    n_eff: Optional[torch.Tensor] = None        # (...,) int32
    chi2: Optional[torch.Tensor] = None         # (...,) float32
    iterations: Optional[torch.Tensor] = None   # (...,) int32
    active: Optional[torch.Tensor] = None       # (...,) bool


def gn_step_plain(lin, state: GnState, min_effective: int, warm: bool, eps: float,
                  lin2=None, gate_count=None):
    """One Gauss-Newton iteration after its linearization, over any leading
    lane axes: `lin` = (H (..., 6, 6), b (..., 6), count (...,) int32,
    chi2 (...,)) as the fused-terms kernels return it, plus `lin2`, a second
    one summed into it (LOAM's surface + edge terms: the reference's
    0 + Hs + He, whose first add is exact). A lane takes a step when
    `gate_count` (default: the count) reaches `min_effective`. While `warm`
    (the gate warm-up) H is Marquardt-damped, H + (1e-2 max diag H + 1e-6) I,
    and no lane converges. The step dx = H^-1 b (mathx.solve_gn_6x6), zeroed
    where not ok and entry by entry where not finite; R <- R exp(dx[:3]),
    t <- t + dx[3:]; converged = ok and |dx| < eps; R_out is R after two
    Newton-Schulz steps (what the loop returns). A lane that is not active
    keeps its whole state. The 3x3 products are lie.matmul3, so a lane's
    bits do not depend on the batch it is in.
    Returns (GnState, flag): flag () bool, is any lane still active."""
    H, b, count, chi2 = lin
    if lin2 is not None:
        H, b, count, chi2 = H + lin2[0], b + lin2[1], count + lin2[2], chi2 + lin2[3]
    ok = (count if gate_count is None else gate_count) >= min_effective
    if warm:
        lam = 1e-2 * torch.amax(torch.diagonal(H, dim1=-2, dim2=-1), dim=-1) + 1e-6
        H = H + lam[..., None, None] * torch.eye(6, dtype=H.dtype, device=H.device)
    dx = mathx.solve_gn_6x6(H, b)
    dx = torch.where(ok[..., None], dx, 0.0)
    dx = torch.where(torch.isfinite(dx), dx, 0.0)
    R_new, t_new = lie.se3_retract(state.R, state.t, dx, matmul=lie.matmul3)
    converged = (torch.zeros_like(ok) if warm
                 else ok & (torch.sqrt(torch.sum(dx * dx, dim=-1)) < eps))
    iterations = (torch.ones_like(count, dtype=torch.int32) if state.iterations is None
                  else state.iterations + 1)
    new = GnState(R_new, t_new, so3_renormalize_plain(R_new), converged,
                  count.to(torch.int32), chi2, iterations, ~converged)
    if state.active is not None:
        a = state.active
        new = GnState(*(torch.where(a.reshape(a.shape + (1,) * (n.dim() - a.dim())), n, o)
                        for n, o in zip(new, state)))
    return new, torch.any(new.active)


def so3_renormalize_plain(R):
    """lie.so3_renormalize with the batch-independent 3x3 product."""
    return lie.so3_renormalize(R, matmul=lie.matmul3)


def eskf_predict_plain(p, v, R, bg, ba, g, cov, time, gyro, acce, stamp, Q, imu_dt: float):
    """One IMU propagation step, any float dtype: the ESKF's nominal state
    (p, v, R, bg, ba, g) and error covariance `cov` (18, 18) at `time`, one
    sample (gyro, acce, stamp), the process noise Q. A sample that fails the
    dt gate (dt > 5 imu_dt or dt < 0) keeps p, v, R and cov and moves time
    to `stamp`. F is assembled from the NEW rotation, as in the reference.
    Returns (p, v, R, cov, time); bg, ba and g do not change. It is
    models.eskf.predict's math, kept here as the kernel's plain version."""
    dt = stamp - time
    ok = (dt <= 5.0 * imu_dt) & (dt >= 0)
    dt = torch.where(ok, dt, 0.0)

    acc_w = R @ (acce - ba)
    new_p = p + v * dt + 0.5 * acc_w * dt * dt + 0.5 * g * dt * dt
    new_v = v + acc_w * dt + g * dt
    new_R = R @ lie.so3_exp((gyro - bg) * dt)

    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    F = torch.eye(18, dtype=cov.dtype, device=cov.device)
    F[0:3, 3:6] = eye * dt
    F[3:6, 6:9] = -new_R @ lie.hat(acce - ba) * dt
    F[3:6, 12:15] = -new_R * dt
    F[3:6, 15:18] = eye * dt
    F[6:9, 6:9] = lie.so3_exp(-(gyro - bg) * dt)
    F[6:9, 9:12] = -eye * dt
    new_cov = F @ cov @ F.T + Q
    return (torch.where(ok, new_p, p), torch.where(ok, new_v, v), torch.where(ok, new_R, R),
            torch.where(ok, new_cov, cov), stamp)


def eskf_predict_scan_plain(p, v, R, bg, ba, g, cov, time, gyros, acces, stamps, valid, Q,
                            imu_dt: float):
    """`eskf_predict_scan` op by op: `eskf_predict_plain` over every sample of
    the padded packet in order, each result kept where `valid` (a padded
    sample leaves p, v, R, cov and time as they were), in p's dtype and on
    its device. The host never reads `valid`. Returns (p, v, R, cov, time)."""
    dev, dtype = p.device, p.dtype
    gs, acs, ts = (torch.as_tensor(x, dtype=dtype, device=dev) for x in (gyros, acces, stamps))
    keep = torch.as_tensor(valid, device=dev).to(torch.bool)
    out = (p, v, R, cov, time)
    for k in range(ts.shape[0]):
        nxt = eskf_predict_plain(*out[:3], bg, ba, g, *out[3:], gs[k], acs[k], ts[k], Q, imu_dt)
        out = tuple(torch.where(keep[k], n, o) for n, o in zip(nxt, out))
    return out


ESKF_KINDS = ("se3", "wheel")     # the observations eskf_update takes


def eskf_observation_plain(p, v, R, kind: str, obs, noise):
    """The observation build of the ESKF's update, in p's dtype and on its
    device: (H (m, 18), V (m, m), innov (m,)). `kind` "se3": obs = (R_obs,
    t_obs), noise = (trans_noise, ang_noise); H selects p and theta, V holds
    the noise values and not their squares (the reference's quirk), innov =
    [t_obs - p, so3_log(R^T R_obs)]. `kind` "wheel": obs = (left_pulse,
    right_pulse, metres per pulse per second), noise = (odom_var,); the mean
    wheel speed is the body-x velocity, innov = R (speed, 0, 0) - v, H selects
    v, V = odom_var^2 I."""
    dev, dtype = p.device, p.dtype
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    if kind == "se3":
        R_obs, t_obs = obs
        H = torch.zeros((6, 18), dtype=dtype, device=dev)
        H[0:3, 0:3] = eye3
        H[3:6, 6:9] = eye3
        V = torch.diag(torch.tensor((noise[0],) * 3 + (noise[1],) * 3, dtype=dtype, device=dev))
        return H, V, torch.cat([t_obs - p, lie.so3_log(R.T @ R_obs)])
    if kind != "wheel":
        raise ValueError(f"kind: expected one of {ESKF_KINDS}, got {kind!r}")
    left, right, wheel = obs
    pulse = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    speed = 0.5 * (wheel * pulse(left) + wheel * pulse(right))
    v_body = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev) * speed
    H = torch.zeros((3, 18), dtype=dtype, device=dev)
    H[0:3, 3:6] = eye3
    return H, eye3 * (noise[0] * noise[0]), R @ v_body - v


def eskf_update_plain(p, v, R, bg, ba, g, cov, kind: str, obs, noise,
                      update_bias_gyro: bool, update_bias_acce: bool):
    """The ESKF's update by one observation (see `eskf_observation_plain`
    for `kind`, `obs` and `noise`), any float dtype: the Kalman gain K =
    P H^T (H P H^T + V)^-1, dx = K innov, cov = (I - K H) P; the injection
    (bg and ba only where their flags say), R = so3_renormalize(R
    so3_exp(dtheta)); the tangent projection cov = J cov J^T with J = I but
    J[6:9, 6:9] = I - 0.5 hat(dtheta). No symmetrization, as the reference.
    Returns (p, v, R, bg, ba, g, cov). It is models.eskf's update math, kept
    here as the kernel's plain version."""
    H, V, innov = eskf_observation_plain(p, v, R, kind, obs, noise)
    dev, dtype = p.device, p.dtype
    eye18 = torch.eye(18, dtype=dtype, device=dev)
    PHt = cov @ H.T
    K = PHt @ torch.linalg.inv_ex(H @ PHt + V, check_errors=False).inverse
    dx = K @ innov
    new_cov = (eye18 - K @ H) @ cov
    dtheta = dx[6:9]
    J = eye18.clone()
    J[6:9, 6:9] = torch.eye(3, dtype=dtype, device=dev) - 0.5 * lie.hat(dtheta)
    return (p + dx[0:3], v + dx[3:6], lie.so3_renormalize(R @ lie.so3_exp(dtheta)),
            bg + dx[9:12] * (1.0 if update_bias_gyro else 0.0),
            ba + dx[12:15] * (1.0 if update_bias_acce else 0.0),
            g + dx[15:18], J @ new_cov @ J.T)


# ---------------------------------------------------------------------------
# Build and load (first use only)
# ---------------------------------------------------------------------------

CSRC = Path(__file__).resolve().parent.parent / "csrc"
HEADER = "fused_terms.cuh"
UNITS = ("p2plane_fused_terms.cu", "p2plane_pick_fused_terms.cu", "ndt_fused_terms.cu",
         "gn_update.cu", "eskf_predict.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v", "-lineinfo")

THREADS = 128          # kThreads in fused_terms.cuh
STENCIL = 7            # kStencil in fused_terms.cuh: a point's voxel and 6 face neighbours
NDT_STENCILS = (1, STENCIL)      # the S that K3 from the map is built for
BIN_MODES = ("trunc", "floor")   # and its binnings
MAX_BLOCKS = 1024
MAX_LANES = 65535      # gridDim.y
ENTRIES = 36
OUT_WORDS = 44         # kOutWords: H (36) | b (6) | chi2 | count (int32 bits)


class Library(NamedTuple):
    cdll: ctypes.CDLL
    path: Path
    log: str           # nvcc / ptxas output of the build (registers, spills)
    built_now: bool


_lock = threading.Lock()
_library: Optional[Library] = None
# (device index, stream) -> (partials, tickets): the reduction's scratch
_scratch: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _compile(out_dir: Path) -> str:
    """One nvcc per source, all started together, then one link. Returns
    the compilers' output; raises with it if any step fails."""
    nvcc = _nvcc()
    objs = [out_dir / (Path(u).stem + f".{os.getpid()}.o") for u in UNITS]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(CSRC / u), "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for u, o in zip(UNITS, objs)]
    logs = [p.communicate()[0] for p in procs]
    tmp = out_dir / f"libloc_fused.so.{os.getpid()}.tmp"
    try:
        for u, p, log in zip(UNITS, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {u} ({p.returncode}):\n{log}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(tmp, out_dir / "libloc_fused.so")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return "".join(logs) + link.stdout + link.stderr


def _bind(cdll: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    pose = [vp, vp, vp, cf]                   # R, t, gate_ptr, gate_value
    tail = [ci, ci, vp, vp, vp, vp]           # n, num_blocks, partials, ticket, out, stream
    index = [vp, vp, vp, vp, ci, ci, ci]      # table, lo, origin, inv_leaf, dims
    cdll.p2plane_fused_terms_launch.argtypes = [vp, vp, ci, vp, *pose, *tail]
    cdll.p2plane_pick_fused_terms_launch.argtypes = [vp, vp, vp, *pose, *tail]
    cdll.p2plane_from_target_launch.argtypes = [vp, vp, vp, vp, *index, *pose, *tail]
    cdll.p2plane_pick_from_target_launch.argtypes = [vp, vp, vp, *index, *pose, *tail]
    # ..., pose, active, lanes, then the tail
    cdll.p2plane_from_target_batch_launch.argtypes = [vp, vp, vp, ci, vp, ci, *index, *pose,
                                                      vp, ci, *tail]
    cdll.p2plane_pick_from_target_batch_launch.argtypes = [vp, vp, vp, ci, *index, *pose,
                                                           vp, ci, *tail]
    cdll.ndt_fused_terms_launch.argtypes = [vp, vp, vp, ci, ci, vp, ci, ci, vp, ci, ci, ci,
                                            vp, cf, ci, *tail]
    # R, t, th, weighted, S, trunc / R, t, th
    cdll.ndt_from_map_launch.argtypes = [vp, vp, vp, *index, vp, vp, cf, ci, ci, ci, *tail]
    cdll.p2line_from_target_launch.argtypes = [vp, vp, vp, *index, vp, vp, cf, *tail]
    cdll.gn_step_launch.argtypes = [ctypes.POINTER(_GnStepArgsC), vp]     # args, stream
    cdll.so3_renormalize_launch.argtypes = [vp, ci, vp, vp]      # R, lanes, R_out, stream
    cdll.eskf_predict_scan_launch.argtypes = [ctypes.POINTER(_EskfPredictArgsC), vp]
    cdll.eskf_update_launch.argtypes = [ctypes.POINTER(_EskfUpdateArgsC), vp]
    cdll.loc_event_create.argtypes = [ctypes.POINTER(vp)]
    cdll.loc_event_wait.argtypes = [vp]
    cdll.loc_host_alloc.argtypes = [ctypes.c_longlong, ctypes.POINTER(vp)]   # bytes, host out
    cdll.loc_host_free.argtypes = [vp]
    cdll.loc_host_device_pointer.argtypes = [vp, ctypes.POINTER(vp)]     # host, device out
    for fn in (cdll.loc_event_create, cdll.loc_event_wait, cdll.loc_host_alloc,
               cdll.loc_host_free, cdll.loc_host_device_pointer):
        fn.restype = ci
    for fn in (cdll.gn_step_launch, cdll.so3_renormalize_launch, cdll.eskf_predict_scan_launch,
               cdll.eskf_update_launch,
               cdll.p2plane_fused_terms_launch, cdll.p2plane_pick_fused_terms_launch,
               cdll.p2plane_from_target_launch, cdll.p2plane_pick_from_target_launch,
               cdll.p2plane_from_target_batch_launch,
               cdll.p2plane_pick_from_target_batch_launch, cdll.ndt_fused_terms_launch,
               cdll.ndt_from_map_launch, cdll.p2line_from_target_launch):
        fn.restype = ci
    cdll.loc_fused_error_string.argtypes = [ci]
    cdll.loc_fused_error_string.restype = ctypes.c_char_p


def build() -> Library:
    """Compile csrc/*.cu into one shared library (once per hash of sources
    and flags), load it (once per process) and return it."""
    global _library
    with _lock:
        if _library is not None:
            return _library
        h = hashlib.sha256()
        for name in (HEADER, *UNITS):
            h.update((CSRC / name).read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        out_dir = CSRC / "build" / h.hexdigest()[:16]
        lib_path = out_dir / "libloc_fused.so"
        log_path = out_dir / "build.log"
        built_now = False
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            log_path.write_text(_compile(out_dir))
            built_now = True
        cdll = ctypes.CDLL(str(lib_path))
        _bind(cdll)
        _library = Library(cdll, lib_path, log_path.read_text() if log_path.exists() else "",
                           built_now)
        return _library


def num_blocks(n: int) -> int:
    """Grid size as a function of N alone: the summation order, and so the
    result bits, depend only on N."""
    return max(1, min(MAX_BLOCKS, -(-n // THREADS)))


def reduction_depth(n: int, rows_per_point: int = 1) -> int:
    """The most float32 additions any one product passes through in the
    kernels' sum over N points with `rows_per_point` rows each (1 for K1
    and K2, 3 S for K3): the per-thread serial sum over its points' rows,
    the 5-level warp shuffle, the serial sum over a block's warps, and the
    serial sum over the blocks' partials, in block order, by the last block
    to finish."""
    nb = num_blocks(n)
    return -(-max(n, 1) // (nb * THREADS)) * rows_per_point + 5 + THREADS // 32 + nb


class GramCheck(NamedTuple):
    ratio: float         # max over H, b, chi2 of |G - G_exact| / tol
    max_abs_err: float   # max over H, b, chi2 of |G - G_exact|
    count: int           # the exact count, G_exact[7, 7]


def check_against_rows(out, A: torch.Tensor, rows_per_point: int = 1) -> GramCheck:
    """Hold a fused-terms result `out` = (H, b, count, chi2) against the
    rows A (N * rows_per_point, 8) it should sum (the plain version's rows,
    which the kernels reproduce bit for bit).

    G_exact = A^T A is summed in float64. Entry by entry the tolerance is
    tol_ij = 2 gamma_{h+1} (|A|^T |A|)_ij, with h = reduction_depth(N, rows_per_point),
    gamma_k = k u / (1 - k u) and u = 2^-24: twice the worst-case rounding
    of a float32 sum of these products over any tree of depth h. So chi2
    and each entry of b are held to their own scale, not to max |H|."""
    H, b, _, chi2 = out
    A64 = A.to(torch.float64)
    G = A64.T @ A64
    S = A64.abs().T @ A64.abs()
    k = reduction_depth(A.shape[0] // rows_per_point, rows_per_point) + 1
    gamma = k * 2.0 ** -24 / (1.0 - k * 2.0 ** -24)
    ratio, err = 0.0, 0.0
    for got, ref, scale in ((H, G[:6, :6], S[:6, :6]), (b, -G[:6, 6], S[:6, 6]),
                            (chi2, G[6, 6], S[6, 6])):
        diff = (got.to(torch.float64) - ref).abs()
        tol = 2.0 * gamma * scale
        ratio = max(ratio, float(torch.max(torch.where(tol > 0, diff / tol,
                                                      torch.where(diff > 0, torch.inf, 0.0)))))
        err = max(err, float(torch.max(diff)))
    return GramCheck(ratio, err, int(round(float(G[7, 7]))))


# ---------------------------------------------------------------------------
# The wrappers (the seam)
# ---------------------------------------------------------------------------

def _check(name, x, shape, device, contiguous=True, dtype=torch.float32):
    if (x.dtype == dtype and x.device == device and x.shape == shape
            and (not contiguous or x.is_contiguous())):
        return
    if x.device != device or x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {device}, got {x.dtype} on {x.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    raise ValueError(f"{name}: must be contiguous")


def _f32_on(x, device):
    """x as a contiguous float32 tensor on `device`; x itself when it
    already is one (nothing is called, nothing is copied)."""
    if x.dtype == torch.float32 and x.device == device and x.is_contiguous():
        return x
    return x.to(device=device, dtype=torch.float32).contiguous()


def _pose(R, t, gate, device, lanes=()):
    """Pointers to R (3, 3) and t (3,) as contiguous float32 tensors on
    `device` (for a batched call `lanes` = (B,): R (B, 3, 3) and t (B, 3)),
    the gate's pointer (a 1-element device tensor) or None, and
    the gate's value where it is a number; then the tensors themselves, for
    the caller to keep alive until the launch is enqueued. R, t and a tensor
    gate come from the previous GN iteration and are already in this form,
    so nothing is copied and nothing waits for the host."""
    R, t = _f32_on(R, device), _f32_on(t, device)
    if R.shape != (*lanes, 3, 3) or t.shape != (*lanes, 3):
        raise ValueError(f"R, t: expected shapes {(*lanes, 3, 3)} and {(*lanes, 3)}, got "
                         f"{tuple(R.shape)} and {tuple(t.shape)}")
    if isinstance(gate, torch.Tensor):
        g = _f32_on(gate, device)
        if g.numel() != 1:
            raise ValueError(f"gate: expected one element, got shape {tuple(g.shape)}")
        return (R.data_ptr(), t.data_ptr(), g.data_ptr(), 0.0), (R, t, g)
    return (R.data_ptr(), t.data_ptr(), None, float(gate)), (R, t)


def _index_args(index: TargetIndex, device, lanes=()):
    """The kernels' view of a TargetIndex, checked: pointers and dims. For a
    batched call `lanes` = (B,) and every tensor has that leading axis."""
    d0, d1, d2 = (int(d) for d in index.dims)
    if not 0 < d0 * d1 * d2 < 2 ** 31:
        raise ValueError(f"index.dims: {index.dims} does not fit an int32 cell index")
    _check("index.table", index.table, (*lanes, d0 * d1 * d2), device, dtype=torch.int32)
    _check("index.lo", index.lo, (*lanes, 3), device, dtype=torch.int32)
    _check("index.origin", index.origin, (*lanes, 3), device)
    if index.inv_leaf.numel() != (lanes[0] if lanes else 1):
        raise ValueError("index.inv_leaf: expected one element per lane")
    _check("index.inv_leaf", index.inv_leaf, index.inv_leaf.shape, device)
    return (index.table.data_ptr(), index.lo.data_ptr(), index.origin.data_ptr(),
            index.inv_leaf.data_ptr(), d0, d1, d2)


def _check_points(q, mask, device):
    n = q.shape[0]
    _check("q", q, (n, 3), device)
    _check("mask", mask, (n,), device, dtype=torch.bool)
    return n


def _check_rows8(name, x, device):
    _check(name, x, (x.shape[0], 8), device)
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def _launch(fn_name, args, n, device, lanes=None):
    """One launch of `fn_name` on the current stream of `device`: a scalar
    call (`lanes` None), or `lanes` matches on a (num_blocks(n), lanes) grid.

    The reduction's scratch (per-block partial sums and the ticket the
    blocks draw, one ticket and num_blocks(n) x 36 sums a lane) is kept per
    device AND stream and reused: calls on one stream are ordered, so one
    buffer serves them all, and two streams get two buffers. It starts at
    the most a scalar call can need and grows to lanes x num_blocks(n) (not
    lanes x MAX_BLOCKS: 64 lanes of 2,048 points need 144 KB, not 9 MB) when
    a batched call needs more; the buffer it replaces stays alive until the
    stream's earlier launches are done with it (the allocator reuses memory
    in stream order). The kernel leaves every ticket at 0; a scratch whose
    launch failed is dropped, so the next call starts from a fresh one. The
    four results are views of one allocation."""
    lib = build()
    nb = num_blocks(n)
    B = 1 if lanes is None else lanes
    # the current stream's handle without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    key = (device.index, stream)
    scratch = _scratch.get(key)
    if scratch is None or scratch[0].numel() < B * nb * ENTRIES or scratch[1].numel() < B:
        scratch = _scratch[key] = (
            torch.empty((max(MAX_BLOCKS, B * nb) * ENTRIES,), dtype=torch.float32,
                        device=device),
            torch.zeros((B,), dtype=torch.int32, device=device))
    out = torch.empty((B, OUT_WORDS), dtype=torch.float32, device=device)
    err = getattr(lib.cdll, fn_name)(*args, n, nb, scratch[0].data_ptr(),
                                     scratch[1].data_ptr(), out.data_ptr(), stream)
    if err != 0:
        _scratch.pop(key, None)
        raise RuntimeError(f"{fn_name}: CUDA error {err}: "
                           f"{lib.cdll.loc_fused_error_string(err).decode()}")
    if lanes is None:
        return (out.as_strided((6, 6), (6, 1)), out.as_strided((6,), (1,), 36),
                out.view(torch.int32).as_strided((), (), 43), out.as_strided((), (), 42))
    return (out[:, :36].unflatten(1, (6, 6)), out[:, 36:42], out.view(torch.int32)[:, 43],
            out[:, 42])


def _device_of(q: torch.Tensor) -> torch.device:
    if q.device.type != "cuda":
        raise ValueError(f"fused terms take CPU or CUDA tensors, got {q.device}")
    return q.device


def p2plane_fused_terms(q, plane, w, R, t, gate):
    """K1, plane given: fused voxel-plane P2Plane linearization.

    q (N, 3) source points, plane (N, 4) per-point plane [n, d] (rows may be
    strided), w (N,) float32 0/1 validity, R (3, 3) and t (3,) float32
    contiguous, gate: the accumulation threshold |n.qs + d| <= gate (a
    number, or a 1-element float32 tensor on the same device).
    Returns (H (6,6), b (6,), count () int32, chi2 ())."""
    if q.device.type == "cpu":
        return p2plane_fused_terms_plain(q, plane, w, R, t, gate)
    dev = _device_of(q)
    n = q.shape[0]
    _check("q", q, (n, 3), dev)
    _check("plane", plane, (n, 4), dev, contiguous=False)
    if plane.stride(1) != 1:
        raise ValueError("plane: columns must be contiguous")
    _check("w", w, (n,), dev)
    pose, _alive = _pose(R, t, gate, dev)
    out = _launch("p2plane_fused_terms_launch",
                  (q.data_ptr(), plane.data_ptr(), plane.stride(0), w.data_ptr(), *pose),
                  n, dev)
    LAUNCHES["p2plane_fused_terms"] += 1
    return out


def p2plane_fused_terms_from_target(q, mask, R, t, gate, packed_ext, oct_table,
                                    index: TargetIndex):
    """K1 from the target: the (voxel, octant) gather and the linearization
    in one launch.

    q (N, 3) body points, mask (N,) bool, R, t, gate as for
    `p2plane_fused_terms`; packed_ext (V + 1, 8) rows [n, d, mu, valid] (the
    last row invalid), oct_table (V7, 8) int32 row of packed_ext pre-elected
    per (dilated voxel, octant), index: the dilated dense table with the
    grid's origin and 1 / leaf. Returns (H, b, count, chi2)."""
    if q.device.type == "cpu":
        return p2plane_from_target_terms_plain(q, mask, R, t, gate, packed_ext, oct_table,
                                               index)
    dev = _device_of(q)
    n = _check_points(q, mask, dev)
    _check_rows8("packed_ext", packed_ext, dev)
    _check("oct_table", oct_table, (oct_table.shape[0], 8), dev, dtype=torch.int32)
    pose, _alive = _pose(R, t, gate, dev)
    out = _launch("p2plane_from_target_launch",
                  (q.data_ptr(), mask.data_ptr(), packed_ext.data_ptr(), oct_table.data_ptr(),
                   *_index_args(index, dev), *pose), n, dev)
    LAUNCHES["p2plane_fused_terms"] += 1
    return out


def p2plane_pick_fused_terms(q, rows, w, R, t, gate):
    """K2, rows given: fused nearest-valid-centroid election + linearization.

    q (N, 3) body points, rows (N, S, 8) candidate voxel rows
    [n(3), d, mu(3), valid] (valid already ANDed with the dense-lookup
    `found`), w (N,) float32 0/1 source mask, R (3, 3), t (3,), gate.
    The CUDA kernel is built for the stencil's S = 7, the one shape its
    callers have, and raises for another; the plain version takes any S.
    Returns (H (6,6), b (6,), count () int32, chi2 ())."""
    if q.device.type == "cpu":
        return p2plane_pick_fused_terms_plain(q, rows, w, R, t, gate)
    dev = _device_of(q)
    n = q.shape[0]
    _check("q", q, (n, 3), dev)
    _check("rows", rows, (n, STENCIL, 8), dev)
    if rows.data_ptr() % 16:
        raise ValueError("rows: must be 16-byte aligned")
    _check("w", w, (n,), dev)
    pose, _alive = _pose(R, t, gate, dev)
    out = _launch("p2plane_pick_fused_terms_launch",
                  (q.data_ptr(), rows.data_ptr(), w.data_ptr(), *pose), n, dev)
    LAUNCHES["p2plane_pick_fused_terms"] += 1
    return out


def p2plane_pick_fused_terms_from_target(q, mask, R, t, gate, packed, index: TargetIndex):
    """K2 from the target: the 7-voxel gather, the election and the
    linearization in one launch.

    q (N, 3) body points, mask (N,) bool, R, t, gate as for
    `p2plane_pick_fused_terms`; packed (V, 8) rows [n, d, mu, valid] per
    grid slot, index: the target's dense table with the grid's origin and
    1 / leaf. The candidates are the point's own voxel and its 6 face
    neighbours, the point's own first. Returns (H, b, count, chi2)."""
    if q.device.type == "cpu":
        return p2plane_pick_from_target_terms_plain(q, mask, R, t, gate, packed, index)
    dev = _device_of(q)
    n = _check_points(q, mask, dev)
    _check_rows8("packed", packed, dev)
    pose, _alive = _pose(R, t, gate, dev)
    out = _launch("p2plane_pick_from_target_launch",
                  (q.data_ptr(), mask.data_ptr(), packed.data_ptr(),
                   *_index_args(index, dev), *pose), n, dev)
    LAUNCHES["p2plane_pick_fused_terms"] += 1
    return out


def _check_batch(q, mask, active, device):
    """Shapes of a batched call's points: q (B, N, 3), mask (B, N), active
    (B,) bool or None. Returns (B, N, active's pointer or None)."""
    if q.dim() != 3:
        raise ValueError(f"q: expected (B, N, 3), got {tuple(q.shape)}")
    B, n = q.shape[0], q.shape[1]
    if not 0 < B <= MAX_LANES:
        raise ValueError(f"q: a batched launch takes 1 to {MAX_LANES} lanes, got {B}")
    _check("q", q, (B, n, 3), device)
    _check("mask", mask, (B, n), device, dtype=torch.bool)
    if active is None:
        return B, n, None
    _check("active", active, (B,), device, dtype=torch.bool)
    return B, n, active.data_ptr()


def _check_rows8_batch(name, x, B, device):
    if x.dim() != 3:
        raise ValueError(f"{name}: expected (B, rows, 8), got {tuple(x.shape)}")
    _check(name, x, (B, x.shape[1], 8), device)
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def p2plane_pick_fused_terms_from_target_batch(q, mask, R, t, gate, packed,
                                               index: TargetIndex, active=None):
    """K2-batch: `p2plane_pick_fused_terms_from_target` for B independent
    matches in ONE launch.

    q (B, N, 3), mask (B, N) bool, R (B, 3, 3), t (B, 3), gate one number or
    1-element tensor for all lanes, packed (B, V, 8), index: a TargetIndex
    whose tensors carry the B axis (table (B, cells), lo (B, 3), origin
    (B, 3), inv_leaf (B,)). `active` (B,) bool switches lanes off: an
    inactive lane does no work and its results are zeros; None runs every
    lane. Returns (H (B, 6, 6), b (B, 6), count (B,) int32, chi2 (B,)), views
    of one allocation; lane b has the bits of the scalar call on lane b's
    inputs. On the CPU: the plain version lane by lane (inactive lanes
    zeroed)."""
    if q.device.type == "cpu":
        return _zero_inactive(p2plane_pick_from_target_terms_plain_batch(
            q, mask, R, t, gate, packed, index), active)
    dev = _device_of(q)
    B, n, active_ptr = _check_batch(q, mask, active, dev)
    _check_rows8_batch("packed", packed, B, dev)
    pose, _alive = _pose(R, t, gate, dev, (B,))
    out = _launch("p2plane_pick_from_target_batch_launch",
                  (q.data_ptr(), mask.data_ptr(), packed.data_ptr(), packed.shape[1],
                   *_index_args(index, dev, (B,)), *pose, active_ptr, B), n, dev, lanes=B)
    LAUNCHES["p2plane_pick_fused_terms"] += 1
    return out


def p2plane_fused_terms_from_target_batch(q, mask, R, t, gate, packed_ext, oct_table,
                                          index: TargetIndex, active=None):
    """K1-batch: `p2plane_fused_terms_from_target` for B independent matches
    in ONE launch.

    q (B, N, 3), mask (B, N) bool, R (B, 3, 3), t (B, 3), gate one number or
    1-element tensor for all lanes, packed_ext (B, V + 1, 8), oct_table
    (B, V7, 8) int32, index: the dilated tables with the B axis; `active` as
    for `p2plane_pick_fused_terms_from_target_batch`. Returns (H (B, 6, 6),
    b (B, 6), count (B,) int32, chi2 (B,)); lane b has the bits of the scalar
    call on lane b's inputs."""
    if q.device.type == "cpu":
        return _zero_inactive(p2plane_from_target_terms_plain_batch(
            q, mask, R, t, gate, packed_ext, oct_table, index), active)
    dev = _device_of(q)
    B, n, active_ptr = _check_batch(q, mask, active, dev)
    _check_rows8_batch("packed_ext", packed_ext, B, dev)
    if oct_table.dim() != 3:
        raise ValueError(f"oct_table: expected (B, rows, 8), got {tuple(oct_table.shape)}")
    _check("oct_table", oct_table, (B, oct_table.shape[1], 8), dev, dtype=torch.int32)
    pose, _alive = _pose(R, t, gate, dev, (B,))
    out = _launch("p2plane_from_target_batch_launch",
                  (q.data_ptr(), mask.data_ptr(), packed_ext.data_ptr(), packed_ext.shape[1],
                   oct_table.data_ptr(), oct_table.shape[1], *_index_args(index, dev, (B,)),
                   *pose, active_ptr, B), n, dev, lanes=B)
    LAUNCHES["p2plane_fused_terms"] += 1
    return out


def _raise_on(fn_name, err):
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err}: "
                           f"{build().cdll.loc_fused_error_string(err).decode()}")


class _GnLinC(ctypes.Structure):
    """GnLin in gn_update.cu: one linearization read through lane strides."""
    _fields_ = [("H", ctypes.c_void_p), ("b", ctypes.c_void_p), ("count", ctypes.c_void_p),
                ("chi2", ctypes.c_void_p), ("sH", ctypes.c_longlong), ("sb", ctypes.c_longlong),
                ("sc", ctypes.c_longlong), ("sx", ctypes.c_longlong)]


class _GnStateC(ctypes.Structure):
    """GnState in gn_update.cu: pointers to a loop's carried state."""
    _fields_ = [(name, ctypes.c_void_p) for name in GnState._fields]


class _GnStepArgsC(ctypes.Structure):
    """GnStepArgs in gn_update.cu: the whole launch, passed by pointer."""
    _fields_ = [("lin", _GnLinC * 2), ("gate_count", ctypes.c_void_p),
                ("s_gate", ctypes.c_longlong), ("inp", _GnStateC), ("out", _GnStateC),
                ("flag", ctypes.c_void_p), ("lanes", ctypes.c_int),
                ("min_effective", ctypes.c_int), ("warm", ctypes.c_int), ("eps", ctypes.c_float)]


def _lin_on(c: _GnLinC, lin, lanes, device):
    """Point `c` at the linearization (H, b, count, chi2) over `lanes`; returns
    the tensors it points at (the caller keeps them alive until the launch is
    enqueued). The fused-terms kernels' outputs, views of one (L, 44)
    allocation, go as they are; a tensor in another layout or type is made
    contiguous float32 / int32 first."""
    H, b, count, chi2 = lin
    batched = len(lanes) == 1
    if H.shape != (*lanes, 6, 6) or b.shape != (*lanes, 6) or count.shape != lanes \
            or chi2.shape != lanes:
        raise ValueError(f"gn_step: expected H {(*lanes, 6, 6)}, b {(*lanes, 6)}, count and chi2 "
                         f"{lanes}, got {tuple(H.shape)}, {tuple(b.shape)}, "
                         f"{tuple(count.shape)}, {tuple(chi2.shape)}")
    for x in (H, b, count, chi2):
        if x.device != device:
            raise ValueError(f"gn_step: expected tensors on {device}, got {x.device}")
    if H.dtype != torch.float32 or H.stride()[-2:] != (6, 1):
        H = H.to(torch.float32).contiguous()
    if b.dtype != torch.float32 or b.stride(-1) != 1:
        b = b.to(torch.float32).contiguous()
    if count.dtype != torch.int32:
        count = count.to(torch.int32)
    if chi2.dtype != torch.float32:
        chi2 = chi2.to(torch.float32)
    c.H, c.b, c.count, c.chi2 = H.data_ptr(), b.data_ptr(), count.data_ptr(), chi2.data_ptr()
    if batched:
        c.sH, c.sb, c.sc, c.sx = H.stride(0), b.stride(0), count.stride(0), chi2.stride(0)
    return H, b, count, chi2


def _gn_state_buffers(lanes, device) -> tuple:
    """A GN loop's carried state over `lanes`, and the flag byte: (GnState,
    flag). One allocation a field: on the host a view costs as much as an
    allocation."""
    empty = lambda shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=device)
    state = GnState(R=empty((*lanes, 3, 3)), t=empty((*lanes, 3)), R_out=empty((*lanes, 3, 3)),
                    converged=empty(lanes, torch.bool), n_eff=empty(lanes, torch.int32),
                    chi2=empty(lanes), iterations=empty(lanes, torch.int32),
                    active=empty(lanes, torch.bool))
    return state, empty((), torch.bool)


def _point_state(c: _GnStateC, state: GnState):
    for name, x in zip(GnState._fields, state):
        setattr(c, name, None if x is None else x.data_ptr())


def _gn_launch(args: _GnStepArgsC, lin, lin2, gate_count, warm, lanes, device):
    """Fill the per-iteration fields of `args` and launch gn_step once."""
    _alive = [_lin_on(args.lin[0], lin, lanes, device)]
    if lin2 is None:
        args.lin[1].H = None
    else:
        _alive.append(_lin_on(args.lin[1], lin2, lanes, device))
    if gate_count is None:
        args.gate_count = None
    else:
        if gate_count.shape != lanes or gate_count.device != device:
            raise ValueError(f"gate_count: expected shape {lanes} on {device}, got "
                             f"{tuple(gate_count.shape)} on {gate_count.device}")
        gate_count = gate_count.to(torch.int32)
        args.gate_count = gate_count.data_ptr()
        args.s_gate = gate_count.stride(0) if lanes else 0
    args.warm = 1 if warm else 0
    _raise_on("gn_step_launch", build().cdll.gn_step_launch(
        ctypes.byref(args), torch._C._cuda_getCurrentRawStream(device.index)))
    LAUNCHES["gn_step"] += 1


def _gn_args(state: GnState, out: GnState, flag, min_effective: int, eps: float):
    R = state.R
    lanes = R.shape[:-2]
    if len(lanes) > 1 or (lanes and not 0 < lanes[0] <= MAX_LANES):
        raise ValueError(f"gn_step: expected no lane axis or one of 1..{MAX_LANES} lanes, got "
                         f"{tuple(lanes)}")
    dev = _device_of(R)
    # a loop's start may come strided or in another type: copied once
    state = state._replace(R=_f32_on(R, dev), t=_f32_on(state.t, dev))
    _check("R", state.R, (*lanes, 3, 3), dev)
    _check("t", state.t, (*lanes, 3), dev)
    if state.active is not None:
        for name, x, dtype in (("R_out", state.R_out, torch.float32),
                               ("converged", state.converged, torch.bool),
                               ("n_eff", state.n_eff, torch.int32),
                               ("chi2", state.chi2, torch.float32),
                               ("iterations", state.iterations, torch.int32),
                               ("active", state.active, torch.bool)):
            _check(name, x, (*lanes, 3, 3) if name == "R_out" else lanes, dev, dtype=dtype)
    elif any(x is not None for x in state[2:]):
        raise ValueError("gn_step: a carried state needs every field, `active` included")
    args = _GnStepArgsC()
    _point_state(args.inp, state)
    _point_state(args.out, out)
    args.flag = flag.data_ptr()
    args.lanes = lanes[0] if lanes else 1
    args.min_effective, args.eps = int(min_effective), float(eps)
    return args, lanes, dev, state


def gn_step(lin, state: GnState, min_effective: int, warm: bool, eps: float, lin2=None,
            gate_count=None):
    """One Gauss-Newton iteration after its linearization in ONE launch
    (csrc/gn_update.cu), for one match or B (a leading B axis on every
    tensor): see `gn_step_plain`, which CPU tensors take. Returns (GnState,
    flag) as new tensors; the inputs are never written. A loop that steps
    many times should use `GnLoop`, which checks and allocates once."""
    if state.R.device.type == "cpu":
        return gn_step_plain(lin, state, min_effective, warm, eps, lin2, gate_count)
    out, flag = _gn_state_buffers(state.R.shape[:-2], state.R.device)
    args, lanes, dev, _alive = _gn_args(state, out, flag, min_effective, eps)
    _gn_launch(args, lin, lin2, gate_count, warm, lanes, dev)
    return out, flag


class GnLoop:
    """One Gauss-Newton loop over its lanes (R0 (3, 3), t0 (3,) for one match;
    (B, 3, 3), (B, 3) for a batched loop): the pose to linearize at (`R`,
    `t`), the lanes still running (`active`, None before the first step:
    all), and `step`, the iteration after the linearization.

    On the card the state is allocated and checked once, at the first step,
    and every step updates it in place: ONE launch of `gn_step`, no
    allocation. So a tensor read from `R` or `t` inside the loop is
    overwritten by the next step (clone what must outlive it); `result`, read
    after the last step, is never written again. CPU tensors take
    `gn_step_plain`, functionally."""

    def __init__(self, R0, t0, min_effective: int, eps: float):
        self.state = GnState(R0, t0)
        self.min_effective, self.eps = int(min_effective), float(eps)
        self._args = None

    @property
    def R(self):
        return self.state.R

    @property
    def t(self):
        return self.state.t

    @property
    def active(self):
        return self.state.active

    def step(self, lin, warm: bool = False, lin2=None, gate_count=None) -> torch.Tensor:
        """One iteration: see `gn_step_plain`. Returns the flag, () bool: is
        any lane still running (for one match: not converged). The host's
        one read per iteration is of this flag."""
        if self.state.R.device.type == "cpu":
            self.state, flag = gn_step_plain(lin, self.state, self.min_effective, warm, self.eps,
                                             lin2, gate_count)
            return flag
        if self._args is None:
            out, self._flag = _gn_state_buffers(self.state.R.shape[:-2], self.state.R.device)
            self._args, self._lanes, self._dev, _alive = _gn_args(
                self.state, out, self._flag, self.min_effective, self.eps)
            _gn_launch(self._args, lin, lin2, gate_count, warm, self._lanes, self._dev)
            self.state = out
            self._args.inp = self._args.out          # in place from here on
            return self._flag
        _gn_launch(self._args, lin, lin2, gate_count, warm, self._lanes, self._dev)
        return self._flag

    def result(self) -> tuple:
        """(R, t, converged, n_eff, chi2, iterations) after the last step: R
        projected onto SO(3). A loop that took no step returns its start,
        projected (one `so3_renormalize` launch on the card), and zeros."""
        s = self.state
        if s.R_out is None:
            lanes, dev = s.R.shape[:-2], s.R.device
            z = lambda dtype: torch.zeros(lanes, dtype=dtype, device=dev)
            return (so3_renormalize(s.R), s.t, z(torch.bool), z(torch.int32), z(torch.float32),
                    z(torch.int32))
        return s.R_out, s.t, s.converged, s.n_eff, s.chi2, s.iterations


def so3_renormalize(R):
    """lie.so3_renormalize (two Newton-Schulz iterations) in ONE launch, for
    R (3, 3) or (B, 3, 3); CPU tensors take `so3_renormalize_plain`."""
    if R.device.type == "cpu":
        return so3_renormalize_plain(R)
    dev = _device_of(R)
    R = _f32_on(R, dev)
    _check("R", R, (*R.shape[:-2], 3, 3), dev)
    out = torch.empty_like(R)
    _raise_on("so3_renormalize_launch", build().cdll.so3_renormalize_launch(
        R.data_ptr(), R.numel() // 9, out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index)))
    LAUNCHES["so3_renormalize"] += 1
    return out


ESKF_PACKET_WORDS = 8      # kPacketWords in eskf_predict.cu: gyro | acce | stamp | valid
PINNED_SLOTS = 4           # page-locked packet buffers a card cycles through


class _EskfPredictArgsC(ctypes.Structure):
    """EskfPredictArgs in eskf_predict.cu: the whole launch, passed by pointer."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "p", "v", "R", "bg", "ba", "g", "cov", "time", "packet", "Q",
        "p_out", "v_out", "R_out", "cov_out", "time_out", "event")] \
        + [("K", ctypes.c_int), ("max_dt", ctypes.c_float)]


class _EskfUpdateArgsC(ctypes.Structure):
    """EskfUpdateArgs in eskf_predict.cu: the whole launch, passed by pointer."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "p", "v", "R", "bg", "ba", "g", "cov", "R_obs", "t_obs", "pulses",
        "p_out", "v_out", "R_out", "bg_out", "ba_out", "g_out", "cov_out")] \
        + [(name, ctypes.c_float) for name in ("noise0", "noise1", "wheel", "left", "right")] \
        + [(name, ctypes.c_int) for name in ("kind", "update_bg", "update_ba", "R_obs_s0",
                                             "R_obs_s1", "t_obs_s")]


class _PinnedRing:
    """Page-locked, mapped host buffers for the IMU packets of one card,
    used in turn. A packet is packed into the next buffer and the kernel
    reads it there, over PCIe, at the buffer's device address: no device
    copy of the packet and no copy call. The launch records the buffer's
    event behind the kernel (csrc/eskf_predict.cu), and a buffer is written
    again only after that event has completed, so no packet is overwritten
    before its kernel has read it; with PINNED_SLOTS buffers it has long
    completed."""

    def __init__(self, device):
        self.lib = lib = build().cdll
        self.host = [None] * PINNED_SLOTS      # (rows, 8) float32 numpy views
        self.dev = [0] * PINNED_SLOTS          # their device addresses
        self.events = [ctypes.c_void_p() for _ in range(PINNED_SLOTS)]
        with torch.cuda.device(device):
            for e in self.events:
                _raise_on("loc_event_create", lib.loc_event_create(ctypes.byref(e)))
        self.next = 0
        self.lock = threading.Lock()

    def _buffer(self, k: int, rows: int) -> np.ndarray:
        """Buffer k with room for `rows` rows (its event has completed)."""
        if self.host[k] is None or self.host[k].shape[0] < rows:
            lib = self.lib
            if self.host[k] is not None:
                _raise_on("loc_host_free", lib.loc_host_free(self.host[k].ctypes.data))
                self.host[k] = None
            rows = max(rows, 64)
            host, dev = ctypes.c_void_p(), ctypes.c_void_p()
            _raise_on("loc_host_alloc", lib.loc_host_alloc(rows * ESKF_PACKET_WORDS * 4,
                                                            ctypes.byref(host)))
            _raise_on("loc_host_device_pointer",
                      lib.loc_host_device_pointer(host, ctypes.byref(dev)))
            words = (ctypes.c_float * (rows * ESKF_PACKET_WORDS)).from_address(host.value)
            self.host[k] = np.ctypeslib.as_array(words).reshape(rows, ESKF_PACKET_WORDS)
            self.dev[k] = dev.value
        return self.host[k]

    def launch(self, args: "_EskfPredictArgsC", gyros, acces, stamps, valid, stream) -> None:
        """Pack the packet into the next buffer, point `args` at it and
        launch eskf_predict_scan on `stream`."""
        K, lib = len(stamps), self.lib
        with self.lock:
            k = self.next
            self.next = (k + 1) % PINNED_SLOTS
            with timing.span(timing.SYNC):
                _raise_on("loc_event_wait", lib.loc_event_wait(self.events[k]))
            buf = self._buffer(k, K)
            buf[:K, 0:3] = gyros
            buf[:K, 3:6] = acces
            buf[:K, 6] = stamps
            buf[:K, 7] = valid
            args.packet, args.K, args.event = self.dev[k], K, self.events[k]
            _raise_on("eskf_predict_scan_launch",
                      lib.eskf_predict_scan_launch(ctypes.byref(args), stream))


_pinned: dict = {}     # device index -> _PinnedRing


def _pinned_ring(device) -> _PinnedRing:
    ring = _pinned.get(device.index)
    if ring is None:
        ring = _PinnedRing(device)
        with _lock:
            ring = _pinned.setdefault(device.index, ring)
    return ring


def _host_packet(parts) -> bool:
    """True where the packet comes as host arrays (no tensor among them)."""
    return not any(isinstance(x, torch.Tensor) for x in parts)


def imu_packet(gyros, acces, stamps, valid, device) -> torch.Tensor:
    """The packet as the kernel reads it: (K, 8) float32 rows [gyro (3) |
    acce (3) | stamp | valid (0 / 1)] on `device`, as a new tensor. Host
    arrays are packed into one buffer and copied once; tensors are packed
    where they are (the host reads none of them). `eskf_predict_scan` reads
    a packet of host arrays in place instead (`_PinnedRing`)."""
    parts = (gyros, acces, stamps, valid)
    if _host_packet(parts):
        buf = np.empty((len(stamps), ESKF_PACKET_WORDS), np.float32)
        buf[:, 0:3] = gyros
        buf[:, 3:6] = acces
        buf[:, 6] = stamps
        buf[:, 7] = valid
        return torch.from_numpy(buf).to(device)
    g, a, ts, v = (torch.as_tensor(x, device=device).to(torch.float32) for x in parts)
    return torch.cat([g, a, ts[:, None], v[:, None]], dim=1)


def _checked(name, x, shape, device, strided=False):
    """x as a float32 tensor of `shape` on `device`, contiguous unless
    `strided` (the kernel then reads it through its strides): x itself when
    it is one, else converted (`_f32_on`); ValueError on another shape."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    if not (x.dtype == torch.float32 and x.shape == shape and x.device == device
            and (strided or x.is_contiguous())):
        x = _f32_on(x, device)
        _check(name, x, shape, device)
    return x


_ESKF_PREDICT_IN = ("p", "v", "R", "bg", "ba", "g", "cov", "time", "Q")
_ESKF_PREDICT_SHAPES = ((3,), (3,), (3, 3), (3,), (3,), (3,), (18, 18), (), (18, 18))


def eskf_predict_scan(p, v, R, bg, ba, g, cov, time, gyros, acces, stamps, valid, Q,
                      imu_dt: float):
    """The ESKF's propagation through one padded IMU packet in ONE launch
    (csrc/eskf_predict.cu): the nominal state p, v (3,), R (3, 3), bg, ba,
    g (3,), the covariance cov (18, 18) and time () as float32 tensors;
    gyros / acces (K, 3), stamps (K,), valid (K,) as host arrays (read by
    the kernel in place, from a page-locked buffer of `_PinnedRing`) or
    tensors (packed on the card by `imu_packet`); Q (18, 18) the process
    noise; imu_dt the filter's sample period (the dt gate is 5 imu_dt). CPU
    tensors take `eskf_predict_scan_plain`. Returns new tensors (p, v, R,
    cov, time): the inputs are never written (pipelined steps and
    checkpoints keep them); bg, ba and g do not change."""
    if p.device.type == "cpu":
        return eskf_predict_scan_plain(p, v, R, bg, ba, g, cov, time, gyros, acces, stamps,
                                       valid, Q, imu_dt)
    dev = _device_of(p)
    parts = (gyros, acces, stamps, valid)
    if not _host_packet(parts):
        return _eskf_predict_scan_launch(p, v, R, bg, ba, g, cov, time,
                                         imu_packet(*parts, dev), Q, imu_dt)
    args, out, _alive = _eskf_predict_args((p, v, R, bg, ba, g, cov, time, Q), imu_dt, dev)
    _pinned_ring(dev).launch(args, *parts, torch._C._cuda_getCurrentRawStream(dev.index))
    LAUNCHES["eskf_predict_scan"] += 1
    return out


def _eskf_predict_args(state, imu_dt: float, dev):
    """The launch's arguments but the packet, its outputs (p, v, R, cov,
    time), new tensors, and the inputs it points at (the caller keeps them
    alive until the launch is enqueued)."""
    args = _EskfPredictArgsC()
    state = [_checked(name, x, shape, dev)
             for name, x, shape in zip(_ESKF_PREDICT_IN, state, _ESKF_PREDICT_SHAPES)]
    for name, x in zip(_ESKF_PREDICT_IN, state):
        setattr(args, name, x.data_ptr())
    # new_empty: p's device and type, no device argument to parse
    out = tuple(state[0].new_empty(shape)
                for shape in _ESKF_PREDICT_SHAPES[:3] + _ESKF_PREDICT_SHAPES[6:8])
    args.p_out, args.v_out, args.R_out, args.cov_out, args.time_out = (
        x.data_ptr() for x in out)
    args.max_dt = 5.0 * imu_dt
    return args, out, state


def _eskf_predict_scan_launch(p, v, R, bg, ba, g, cov, time, packet, Q, imu_dt: float):
    """The launch of `eskf_predict_scan` on a packet tensor already on the
    state's device: (K, 8) float32 rows, contiguous (`imu_packet`)."""
    dev = p.device
    if (packet.ndim != 2 or packet.shape[1] != ESKF_PACKET_WORDS or packet.device != dev
            or packet.dtype != torch.float32 or not packet.is_contiguous()
            or packet.data_ptr() % 16):
        raise ValueError(f"IMU packet: expected contiguous, 16-byte aligned (K, "
                         f"{ESKF_PACKET_WORDS}) float32 rows on {dev}, got "
                         f"{tuple(packet.shape)} {packet.dtype} on {packet.device}")
    args, out, _alive = _eskf_predict_args((p, v, R, bg, ba, g, cov, time, Q), imu_dt, dev)
    args.packet, args.K, args.event = packet.data_ptr(), packet.shape[0], None
    _raise_on("eskf_predict_scan_launch", build().cdll.eskf_predict_scan_launch(
        ctypes.byref(args), torch._C._cuda_getCurrentRawStream(dev.index)))
    LAUNCHES["eskf_predict_scan"] += 1
    return out


_ESKF_FIELDS = ("p", "v", "R", "bg", "ba", "g", "cov")     # what eskf_update takes and returns
_ESKF_SHAPES = ((3,), (3,), (3, 3), (3,), (3,), (3,), (18, 18))


def _pulse(x, device):
    """A wheel pulse count: (value, None), or (None, a device tensor) where
    it is on the card already (the host reads nothing back)."""
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        return None, x.to(device=device, dtype=torch.float32).reshape(())
    return float(x), None


def eskf_update(p, v, R, bg, ba, g, cov, kind: str, obs, noise, update_bias_gyro: bool,
                update_bias_acce: bool):
    """The ESKF's update by one observation in ONE launch
    (csrc/eskf_predict.cu): the state p, v (3,), R (3, 3), bg, ba, g (3,),
    cov (18, 18) as float32 tensors; `kind`, `obs` and `noise` as for
    `eskf_observation_plain` ("se3": (R_obs, t_obs) and (trans_noise,
    ang_noise); "wheel": (left_pulse, right_pulse, metres per pulse per
    second) and (odom_var,)). CPU tensors take `eskf_update_plain`. Returns
    new tensors (p, v, R, bg, ba, g, cov); the inputs are never written."""
    if kind not in ESKF_KINDS:
        raise ValueError(f"kind: expected one of {ESKF_KINDS}, got {kind!r}")
    if p.device.type == "cpu":
        return eskf_update_plain(p, v, R, bg, ba, g, cov, kind, obs, noise, update_bias_gyro,
                                 update_bias_acce)
    dev = _device_of(p)
    args = _EskfUpdateArgsC()
    # every tensor the launch points at stays referenced until it is enqueued
    alive = [_checked(name, x, shape, dev)
             for name, x, shape in zip(_ESKF_FIELDS, (p, v, R, bg, ba, g, cov), _ESKF_SHAPES)]
    for name, x in zip(_ESKF_FIELDS, alive):
        setattr(args, name, x.data_ptr())
    if kind == "se3":
        # read through their strides: a pose's R = T[:3, :3], t = T[:3, 3] need no copy
        R_obs, t_obs = (_checked(name, x, shape, dev, strided=True)
                        for name, x, shape in zip(("R_obs", "t_obs"), obs, ((3, 3), (3,))))
        alive += [R_obs, t_obs]
        args.R_obs, args.t_obs = R_obs.data_ptr(), t_obs.data_ptr()
        (args.R_obs_s0, args.R_obs_s1), (args.t_obs_s,) = R_obs.stride(), t_obs.stride()
        args.noise0, args.noise1 = float(noise[0]), float(noise[1])
    else:
        (left, lt), (right, rt) = _pulse(obs[0], dev), _pulse(obs[1], dev)
        if lt is not None or rt is not None:
            pulses = torch.stack([torch.full((), x, dtype=torch.float32, device=dev)
                                  if t is None else t for x, t in ((left, lt), (right, rt))])
            alive.append(pulses)
            args.pulses = pulses.data_ptr()
        else:
            args.left, args.right = left, right
        args.noise0, args.wheel = float(noise[0]) * float(noise[0]), float(obs[2])
        args.kind = 1
    args.update_bg, args.update_ba = bool(update_bias_gyro), bool(update_bias_acce)
    out = tuple(alive[0].new_empty(shape) for shape in _ESKF_SHAPES)
    args.p_out, args.v_out, args.R_out, args.bg_out, args.ba_out, args.g_out, args.cov_out = (
        x.data_ptr() for x in out)
    _raise_on("eskf_update_launch", build().cdll.eskf_update_launch(
        ctypes.byref(args), torch._C._cuda_getCurrentRawStream(dev.index)))
    LAUNCHES["eskf_update"] += 1
    return out


def _zero_inactive(out, active):
    """The batched kernels' results for switched-off lanes: zeros."""
    if active is None:
        return out
    H, b, count, chi2 = out
    return (torch.where(active[:, None, None], H, 0.0), torch.where(active[:, None], b, 0.0),
            torch.where(active, count, 0), torch.where(active, chi2, 0.0))


def ndt_fused_terms(q, qs, mu, W, valid, R, t, outlier_th, weighted: bool):
    """K3: fused generalized-Gaussian (NDT) linearization over S stencil
    voxels per point.

    q (N, 3) body points and qs (N, 3) world points (contiguous), mu
    (N, S, 3) gathered voxel means, W (N, S, 9) row-major square-root
    factors of the voxel information (info = W W^T), valid (N, S) float32
    0/1; mu, W and valid may be strided views (e.g. columns of the gathered
    (N, S, 13) packed rows) whose last dimension is contiguous. R (3, 3),
    t (3,) (unused by the kernel: qs arrives computed), outlier_th the chi2
    gate (a number), `weighted` selects the information-weighted system.
    Returns (H (6,6), b (6,), count () int32 residuals, chi2 ())."""
    if q.device.type == "cpu":
        return ndt_fused_terms_plain(q, qs, mu, W, valid, R, t, outlier_th, weighted)
    dev = _device_of(q)
    n, S = valid.shape
    _check("q", q, (n, 3), dev)
    _check("qs", qs, (n, 3), dev)
    _check("mu", mu, (n, S, 3), dev, contiguous=False)
    _check("W", W, (n, S, 9), dev, contiguous=False)
    _check("valid", valid, (n, S), dev, contiguous=False)
    if mu.stride(2) != 1 or W.stride(2) != 1:
        raise ValueError("mu, W: the last dimension must be contiguous")
    (R_ptr, _, _, th), _alive = _pose(R, t, float(outlier_th), dev)
    out = _launch("ndt_fused_terms_launch",
                  (q.data_ptr(), qs.data_ptr(), mu.data_ptr(), mu.stride(0), mu.stride(1),
                   W.data_ptr(), W.stride(0), W.stride(1),
                   valid.data_ptr(), valid.stride(0), valid.stride(1), S,
                   R_ptr, th, int(bool(weighted))), n, dev)
    LAUNCHES["ndt_fused_terms"] += 1
    return out


def ndt_fused_terms_from_map(q, mask, R, t, outlier_th, weighted: bool, packed,
                             index: TargetIndex, S: int, bin_mode: str):
    """K3 from the map: the stencil gather and the NDT linearization in one
    launch.

    q (N, 3) body points, mask (N,) bool, R (3, 3), t (3,), outlier_th the
    chi2 gate (a number), `weighted` as for `ndt_fused_terms`; packed (V, 13)
    rows [mu, W, est] per map slot (ndt.NdtMap.packed), index: the map's
    dense table with its origin and 1 / voxel_size; S = 7 (the point's voxel
    and its 6 face neighbours, the point's own first) or 1 (that voxel
    alone); bin_mode "trunc" or "floor": how a point's voxel is taken from
    qs = R q + t. The kernel is built for these S and binnings; any other
    raises. Returns (H, b, count () int32 residuals, chi2)."""
    if S not in NDT_STENCILS:
        raise ValueError(f"S: K3 from the map is built for S in {NDT_STENCILS}, got {S}")
    if bin_mode not in BIN_MODES:
        raise ValueError(f"bin_mode: expected one of {BIN_MODES}, got {bin_mode!r}")
    if q.device.type == "cpu":
        return ndt_from_map_terms_plain(q, mask, R, t, outlier_th, weighted, packed, index, S,
                                        bin_mode)
    dev = _device_of(q)
    n = _check_points(q, mask, dev)
    _check("packed", packed, (packed.shape[0], 13), dev)
    (R_ptr, t_ptr, _, th), _alive = _pose(R, t, float(outlier_th), dev)
    out = _launch("ndt_from_map_launch",
                  (q.data_ptr(), mask.data_ptr(), packed.data_ptr(),
                   *_index_args(index, dev), R_ptr, t_ptr, th, int(bool(weighted)), S,
                   int(bin_mode == "trunc")), n, dev)
    LAUNCHES["ndt_fused_terms"] += 1
    return out


def p2line_fused_terms_from_target(q, mask, R, t, gate, line_packed, index: TargetIndex):
    """K3 in p2line mode: the 7-voxel gather on a line table, the
    nearest-valid-centroid election and the linearization in one launch.

    q (N, 3) body points, mask (N,) bool, R (3, 3), t (3,); gate: the line
    distance threshold, a number (the elected voxel's residual |W^T e|^2 is
    gated at gate^2); line_packed (V, 13) rows [mu, W, valid] with
    W W^T = I - d d^T (icp.IcpTarget.line_packed), index: the target's dense
    table with the grid's origin and 1 / leaf (floor binning). The
    candidates are the point's own voxel and its 6 face neighbours, the
    point's own first. Returns (H, b, count () int32 residuals, chi2)."""
    if q.device.type == "cpu":
        return p2line_from_target_terms_plain(q, mask, R, t, gate, line_packed, index)
    dev = _device_of(q)
    n = _check_points(q, mask, dev)
    _check("line_packed", line_packed, (line_packed.shape[0], 13), dev)
    g = float(gate)
    (R_ptr, t_ptr, _, th), _alive = _pose(R, t, g * g, dev)
    out = _launch("p2line_from_target_launch",
                  (q.data_ptr(), mask.data_ptr(), line_packed.data_ptr(),
                   *_index_args(index, dev), R_ptr, t_ptr, th), n, dev)
    LAUNCHES["ndt_fused_terms"] += 1
    return out
