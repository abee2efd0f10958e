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

The seam replaces the JAX package's `on_tpu()` switch with the tensor's
device: CPU tensors go to the plain PyTorch version beside each kernel; CUDA
tensors go to the hand-written kernel, which raises if it cannot be built or
launched (there is no fallback). The kernels are compiled with nvcc on first
use into `csrc/build/<hash of sources and flags>/` and loaded with ctypes;
nothing here touches nvcc or ctypes at import time.

`LAUNCHES` counts kernel launches per wrapper (never plain-version calls),
so a run can show that its main path went through the kernels.
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
SOURCES = ("fused_terms.cuh", "p2plane_fused_terms.cu", "p2plane_pick_fused_terms.cu",
           "ndt_fused_terms.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
              "-lineinfo")

THREADS = 256          # kThreads in fused_terms.cuh
MAX_BLOCKS = 1024
ENTRIES = 36


class BuildInfo(NamedTuple):
    library: Path
    log: str           # nvcc / ptxas output of the build (registers, spills)
    built_now: bool


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_info: Optional[BuildInfo] = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> BuildInfo:
    """Compile csrc/*.cu into one shared library (once per source hash) and
    load it. Returns where it lives and the compiler's report."""
    global _lib, _build_info
    with _lock:
        if _build_info is not None:
            return _build_info
        h = hashlib.sha256()
        for name in SOURCES:
            h.update((CSRC / name).read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        out_dir = CSRC / "build" / h.hexdigest()[:16]
        lib_path = out_dir / "libloc_fused.so"
        log_path = out_dir / "build.log"
        built_now = False
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f"libloc_fused.so.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *[str(CSRC / s) for s in SOURCES if s.endswith(".cu")]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib_path)
            built_now = True
        lib = ctypes.CDLL(str(lib_path))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn in (lib.p2plane_fused_terms_launch, lib.p2plane_pick_fused_terms_launch):
            fn.argtypes = [vp, vp, ci, vp, vp, vp, vp, cf, ci, vp, ci, vp, vp, vp, vp]
            fn.restype = ci
        lib.ndt_fused_terms_launch.argtypes = [vp, vp, vp, ci, ci, vp, ci, ci, vp, ci, ci, ci,
                                               vp, cf, ci, ci, vp, ci, vp, vp, vp, vp]
        lib.ndt_fused_terms_launch.restype = ci
        lib.loc_fused_error_string.argtypes = [ci]
        lib.loc_fused_error_string.restype = ctypes.c_char_p
        _lib = lib
        _build_info = BuildInfo(lib_path, log_path.read_text() if log_path.exists() else "",
                                built_now)
        return _build_info


def num_blocks(n: int) -> int:
    """Grid size as a function of N alone: the summation order, and so the
    result bits, depend only on N."""
    return max(1, min(MAX_BLOCKS, -(-n // THREADS)))


def reduction_depth(n: int, rows_per_point: int = 1) -> int:
    """The most float32 additions any one product passes through in the
    kernels' sum over N points with `rows_per_point` rows each (1 for K1
    and K2, 3 S for K3): the per-thread serial sum over its points' rows,
    the 5-level warp shuffle, the serial sum over a block's warps, and the
    serial sum over the blocks' partials in finalize_kernel."""
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

def _check(name, x, shape, device, contiguous=True):
    if x.device != device or x.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32 on {device}, got {x.dtype} on {x.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if contiguous and not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _pose(R, t, gate, device):
    """R (3, 3) and t (3,) as contiguous float32 tensors on `device`, and
    the gate as a 1-element device tensor (or None) plus a value. R, t and
    a tensor gate come from the previous GN iteration and are already in
    this form, so nothing is copied and nothing waits for the host. The
    caller keeps the returned tensors alive until the launch is enqueued."""
    R = R.to(device=device, dtype=torch.float32).contiguous()
    t = t.to(device=device, dtype=torch.float32).contiguous()
    _check("R", R, (3, 3), device)
    _check("t", t, (3,), device)
    if isinstance(gate, torch.Tensor):
        g = gate.to(device=device, dtype=torch.float32).reshape(-1).contiguous()
        _check("gate", g, (1,), device)
        return R, t, g, 0.0
    return R, t, None, float(gate)


def _pose_ptrs(R, t, g, gate_value):
    return R.data_ptr(), t.data_ptr(), None if g is None else g.data_ptr(), gate_value


def _launch(fn_name, args, n, device):
    build()
    nb = num_blocks(n)
    partials = torch.empty((nb, ENTRIES), dtype=torch.float32, device=device)
    G = torch.empty((8, 8), dtype=torch.float32, device=device)
    b = torch.empty((6,), dtype=torch.float32, device=device)
    count = torch.empty((), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(_lib, fn_name)(*args, n, partials.data_ptr(), nb, G.data_ptr(),
                                 b.data_ptr(), count.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err}: "
                           f"{_lib.loc_fused_error_string(err).decode()}")
    return G[:6, :6], b, count, G[6, 6]


def _device_of(q: torch.Tensor) -> torch.device:
    if q.device.type != "cuda":
        raise ValueError(f"fused terms take CPU or CUDA tensors, got {q.device}")
    return q.device


def p2plane_fused_terms(q, plane, w, R, t, gate):
    """K1: fused voxel-plane P2Plane linearization.

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
    pose = _pose(R, t, gate, dev)
    out = _launch("p2plane_fused_terms_launch",
                  (q.data_ptr(), plane.data_ptr(), plane.stride(0), w.data_ptr(),
                   *_pose_ptrs(*pose)), n, dev)
    LAUNCHES["p2plane_fused_terms"] += 1
    return out


def p2plane_pick_fused_terms(q, rows, w, R, t, gate):
    """K2: fused nearest-valid-centroid election + linearization.

    q (N, 3) body points, rows (N, S, 8) candidate voxel rows
    [n(3), d, mu(3), valid] (valid already ANDed with the dense-lookup
    `found`), w (N,) float32 0/1 source mask, R (3, 3), t (3,), gate.
    Returns (H (6,6), b (6,), count () int32, chi2 ())."""
    if q.device.type == "cpu":
        return p2plane_pick_fused_terms_plain(q, rows, w, R, t, gate)
    dev = _device_of(q)
    n, S = q.shape[0], rows.shape[1]
    _check("q", q, (n, 3), dev)
    _check("rows", rows, (n, S, 8), dev)
    if rows.data_ptr() % 16:
        raise ValueError("rows: must be 16-byte aligned")
    _check("w", w, (n,), dev)
    pose = _pose(R, t, gate, dev)
    out = _launch("p2plane_pick_fused_terms_launch",
                  (q.data_ptr(), rows.data_ptr(), S, w.data_ptr(), *_pose_ptrs(*pose)),
                  n, dev)
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
    R, t, _, th = _pose(R, t, float(outlier_th), dev)
    out = _launch("ndt_fused_terms_launch",
                  (q.data_ptr(), qs.data_ptr(), mu.data_ptr(), mu.stride(0), mu.stride(1),
                   W.data_ptr(), W.stride(0), W.stride(1),
                   valid.data_ptr(), valid.stride(0), valid.stride(1), S,
                   R.data_ptr(), th, int(bool(weighted))), n, dev)
    LAUNCHES["ndt_fused_terms"] += 1
    return out
