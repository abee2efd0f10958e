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

K1 and K2 each have two modes. With the plane (K1) or the candidate rows
(K2) given they take the TPU kernels' interface. *From the target*
(`p2plane_fused_terms_from_target`, `p2plane_pick_fused_terms_from_target`)
they take the target's tables and do the correspondence gather themselves:
the voxel lookup and row reads that the TPU kernels left to XLA, because
Pallas on the TPU could not express a data-dependent row read. That is the
mode the matchers run: no (N, 7, 8) or (N, 8) row tensor is made. Both modes
of a kernel count as launches of that kernel.

The seam replaces the JAX package's `on_tpu()` switch with the tensor's
device: CPU tensors go to the plain PyTorch version beside each kernel; CUDA
tensors go to the hand-written kernel, which raises if it cannot be built or
launched (there is no fallback). The kernels are compiled with nvcc on first
use into `csrc/build/<hash of sources and flags>/` and loaded with ctypes;
nothing here touches nvcc or ctypes at import time.

`LAUNCHES` counts kernel launches per kernel (never plain-version calls),
so a run can show that its main path went through the kernels. Each call is
ONE launch: the last block to finish reduces the per-block partial sums.
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

import torch

from . import voxel

LAUNCHES = {"p2plane_fused_terms": 0, "p2plane_pick_fused_terms": 0, "ndt_fused_terms": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
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
    1 / leaf (IcpTarget.dense / dense_oct and IcpTarget.grid)."""

    table: torch.Tensor      # (dims[0] * dims[1] * dims[2],) int32, -1 empty
    lo: torch.Tensor         # (3,) int32
    origin: torch.Tensor     # (3,) float32
    inv_leaf: torch.Tensor   # () float32
    dims: tuple


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


# ---------------------------------------------------------------------------
# Build and load (first use only)
# ---------------------------------------------------------------------------

CSRC = Path(__file__).resolve().parent.parent / "csrc"
HEADER = "fused_terms.cuh"
UNITS = ("p2plane_fused_terms.cu", "p2plane_pick_fused_terms.cu", "ndt_fused_terms.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v", "-lineinfo")

THREADS = 128          # kThreads in fused_terms.cuh
STENCIL = 7            # kStencil in p2plane_pick_fused_terms.cu: K2's candidates a point
MAX_BLOCKS = 1024
ENTRIES = 36
OUT_WORDS = 44         # kOutWords: H (36) | b (6) | chi2 | count (int32 bits)


class Library(NamedTuple):
    cdll: ctypes.CDLL
    path: Path
    log: str           # nvcc / ptxas output of the build (registers, spills)
    built_now: bool


_lock = threading.Lock()
_library: Optional[Library] = None
# (device index, stream) -> (partials, ticket): the reduction's scratch
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
    cdll.ndt_fused_terms_launch.argtypes = [vp, vp, vp, ci, ci, vp, ci, ci, vp, ci, ci, ci,
                                            vp, cf, ci, *tail]
    for fn in (cdll.p2plane_fused_terms_launch, cdll.p2plane_pick_fused_terms_launch,
               cdll.p2plane_from_target_launch, cdll.p2plane_pick_from_target_launch,
               cdll.ndt_fused_terms_launch):
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


def _pose(R, t, gate, device):
    """Pointers to R (3, 3) and t (3,) as contiguous float32 tensors on
    `device`, the gate's pointer (a 1-element device tensor) or None, and
    the gate's value where it is a number; then the tensors themselves, for
    the caller to keep alive until the launch is enqueued. R, t and a tensor
    gate come from the previous GN iteration and are already in this form,
    so nothing is copied and nothing waits for the host."""
    R, t = _f32_on(R, device), _f32_on(t, device)
    if R.shape != (3, 3) or t.shape != (3,):
        raise ValueError(f"R, t: expected shapes (3, 3) and (3,), got {tuple(R.shape)} "
                         f"and {tuple(t.shape)}")
    if isinstance(gate, torch.Tensor):
        g = _f32_on(gate, device)
        if g.numel() != 1:
            raise ValueError(f"gate: expected one element, got shape {tuple(g.shape)}")
        return (R.data_ptr(), t.data_ptr(), g.data_ptr(), 0.0), (R, t, g)
    return (R.data_ptr(), t.data_ptr(), None, float(gate)), (R, t)


def _index_args(index: TargetIndex, device):
    """The kernels' view of a TargetIndex, checked: pointers and dims."""
    d0, d1, d2 = (int(d) for d in index.dims)
    if not 0 < d0 * d1 * d2 < 2 ** 31:
        raise ValueError(f"index.dims: {index.dims} does not fit an int32 cell index")
    _check("index.table", index.table, (d0 * d1 * d2,), device, dtype=torch.int32)
    _check("index.lo", index.lo, (3,), device, dtype=torch.int32)
    _check("index.origin", index.origin, (3,), device)
    if index.inv_leaf.numel() != 1:
        raise ValueError("index.inv_leaf: expected one element")
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


def _launch(fn_name, args, n, device):
    """One launch of `fn_name` on the current stream of `device`.

    The reduction's scratch (per-block partial sums and the ticket the
    blocks draw) is kept per device AND stream and reused: calls on one
    stream are ordered, so one buffer serves them all, and two streams get
    two buffers. The kernel leaves the ticket at 0; a scratch whose launch
    failed is dropped, so the next call starts from a fresh one. The four
    results are views of one allocation."""
    lib = build()
    nb = num_blocks(n)
    # the current stream's handle without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    key = (device.index, stream)
    scratch = _scratch.get(key)
    if scratch is None:
        scratch = _scratch[key] = (
            torch.empty((MAX_BLOCKS * ENTRIES,), dtype=torch.float32, device=device),
            torch.zeros((1,), dtype=torch.int32, device=device))
    out = torch.empty((OUT_WORDS,), dtype=torch.float32, device=device)
    err = getattr(lib.cdll, fn_name)(*args, n, nb, scratch[0].data_ptr(),
                                     scratch[1].data_ptr(), out.data_ptr(), stream)
    if err != 0:
        _scratch.pop(key, None)
        raise RuntimeError(f"{fn_name}: CUDA error {err}: "
                           f"{lib.cdll.loc_fused_error_string(err).decode()}")
    return (out.as_strided((6, 6), (6, 1)), out.as_strided((6,), (1,), 36),
            out.view(torch.int32).as_strided((), (), 43), out.as_strided((), (), 42))


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
