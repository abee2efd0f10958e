"""2D occupancy grid + likelihood field + SE(2) field matching (port of
loc_lib_tpu/models/grid2d.py).

  * `add_scan`: the dense polar free-space carve. A (polar_bins,) table of
    the closest in-range hit per angle bin (one order-free scatter-min),
    then every cell tests its own (range, bin) against the table: a handful
    of elementwise images and one gather. Endpoints occupy exactly (a
    boolean set with a drop slot, never a float add); each cell moves at
    most one count per scan. `add_scan_sampled` is the per-beam sampled-ray
    oracle beside it.
  * `likelihood_field`: a separable squared EDT, the reference's 41 x 41
    template as a min over 2r + 1 wrapped shifts along each axis. Every
    value is an integer-valued float32 until the final sqrt, so the field
    has the bits of the JAX package's whenever the occupancy is equal. The
    shifts wrap around the grid edge like `jnp.roll` (kept: it is the
    reference's behaviour).
  * `align_gauss_newton` / `align_lm`: SE(2) GN / Levenberg-Marquardt on
    bilinear field samples with Huber weights; a host loop with one read of
    the stop flag per iteration, like icp.scan_match.

The JAX package divides by constants that XLA:CPU folds into one product
with a float32 constant (x / 2pi * nb becomes x * f32(nb / 2pi), x / res
becomes x * f32(1 / res)); the carve writes those products out, so its bins
and cell coordinates are JAX's on the CPU. atan2 and sin / cos differ from
XLA's in the last bit for some inputs, so a cell on a bin edge may bin
differently (the tests state how many).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.pointcloud import card_device


@dataclasses.dataclass(frozen=True)
class Grid2dOptions:
    """Mirror of the JAX package's Grid2dOptions (same names and defaults:
    1000 x 1000 cells at 40 px/m, a 41 x 41 field template)."""

    image_size: int = 1000          # cells per side
    resolution: float = 40.0        # px per meter (the reference's 20: see the JAX package)
    occupied_step: int = 1
    min_occ: int = 117
    max_occ: int = 137
    unknown: int = 127
    field_radius: int = 20          # template half-width (41x41)
    max_beam_range: float = 15.0    # meters rasterized along a ray
    ray_steps: int = 256            # samples per beam in add_scan_sampled (oracle)
    polar_bins: int = 720           # angle bins of the dense free-space carve

    @property
    def center(self) -> float:
        return self.image_size / 2.0


def _f32(x) -> float:
    """x rounded to float32, as a Python float."""
    return float(np.float32(x))


def world_to_px(opts: Grid2dOptions, xy: torch.Tensor) -> torch.Tensor:
    """(..., 2) meters in the submap frame -> float pixel coords."""
    return xy * opts.resolution + opts.center


class OccupancyGrid(NamedTuple):
    counts: torch.Tensor   # (H, W) int32 occupancy counters around `unknown`
    touched: torch.Tensor  # (H, W) bool, ever updated (for export)


def empty_grid(opts: Grid2dOptions, device=None) -> OccupancyGrid:
    """An all-unknown grid on `device` (default: the card)."""
    dev = card_device(device)
    n = opts.image_size
    return OccupancyGrid(counts=torch.full((n, n), opts.unknown, dtype=torch.int32, device=dev),
                         touched=torch.zeros((n, n), dtype=torch.bool, device=dev))


def _in_bounds(cell: torch.Tensor, n: int) -> torch.Tensor:
    return (cell[..., 0] >= 0) & (cell[..., 0] < n) & (cell[..., 1] >= 0) & (cell[..., 1] < n)


def _cell_flags(cells: torch.Tensor, ok: torch.Tensor, n: int) -> torch.Tensor:
    """(n, n) bool: True at every (x, y) cell of `cells` where `ok` (a set,
    so repeated cells are harmless; rows not ok go to a dropped slot)."""
    flat = torch.where(ok, cells[..., 1].long() * n + cells[..., 0].long(), n * n).reshape(-1)
    flags = torch.zeros((n * n + 1,), dtype=torch.bool, device=cells.device)
    flags.index_fill_(0, flat, True)
    return flags[: n * n].reshape(n, n)


def _apply_delta(grid: OccupancyGrid, opts: Grid2dOptions, occ, free) -> OccupancyGrid:
    """+step on occupied cells, -step on freed ones (occupied wins), clipped
    to [min_occ, max_occ]."""
    free = free & ~occ
    delta = occ.to(torch.int32) - free.to(torch.int32)
    counts = torch.clamp(grid.counts + delta * opts.occupied_step, opts.min_occ, opts.max_occ)
    return OccupancyGrid(counts=counts, touched=grid.touched | (delta != 0))


def add_scan(grid: OccupancyGrid, opts: Grid2dOptions, points: torch.Tensor,
             valid: torch.Tensor, origin_xy: torch.Tensor) -> OccupancyGrid:
    """AddLidarFrame: endpoints occupy, rays free (the dense polar carve).

    points: (B, 2) scan endpoints in the SUBMAP frame (already posed);
    origin_xy: (2,) sensor position in the submap frame. Cells are freed
    strictly before their bin's closest hit (less half a cell diagonal);
    directions with no in-range beam free nothing. Returns a new grid."""
    n = opts.image_size
    nb = opts.polar_bins
    dev = grid.counts.device
    bin_scale = _f32(np.float32(nb) / np.float32(2.0 * math.pi))

    d = points - origin_xy
    rng = torch.linalg.vector_norm(d, dim=-1)                  # (B,)
    ang = torch.atan2(d[:, 1], d[:, 0])
    bi = torch.clamp(((ang + math.pi) * bin_scale).to(torch.int32), 0, nb - 1)
    beam_ok = valid & (rng <= opts.max_beam_range)
    rv = torch.where(beam_ok, rng, math.inf)
    # closest hit per bin: an order-free scatter-min
    bin_range = torch.full((nb,), math.inf, dtype=torch.float32, device=dev).scatter_reduce(
        0, bi.long(), rv, "amin")

    # dense per-cell polar test (cell centres in the submap frame)
    coords = (torch.arange(n, dtype=torch.float32, device=dev) - opts.center) * _f32(
        1.0 / np.float32(opts.resolution))
    dx = coords[None, :] - origin_xy[0]                        # columns = x
    dy = coords[:, None] - origin_xy[1]                        # rows = y
    crng = torch.sqrt(dx * dx + dy * dy)
    cbi = torch.clamp(((torch.atan2(dy, dx) + math.pi) * bin_scale).to(torch.int32), 0, nb - 1)
    br = bin_range[cbi.long()]                                 # (n, n)
    half = 0.7071 / opts.resolution                            # half cell diagonal
    free = torch.isfinite(br) & (crng < br - half)

    # exact endpoint occupancy
    end_cell = torch.round(world_to_px(opts, points)).to(torch.int32)
    occ = _cell_flags(end_cell, beam_ok & _in_bounds(end_cell, n), n)
    return _apply_delta(grid, opts, occ, free)


def add_scan_sampled(grid: OccupancyGrid, opts: Grid2dOptions, points: torch.Tensor,
                     valid: torch.Tensor, origin_xy: torch.Tensor) -> OccupancyGrid:
    """ORACLE rasterizer: `ray_steps` samples along each beam free the cells
    strictly before the endpoint cell, endpoints occupy (the reference's
    per-beam walk). Its endpoint occupancy is `add_scan`'s by construction;
    its freed cells agree up to the wedge edges. No pipeline uses it."""
    n = opts.image_size
    dev = grid.counts.device
    end_px = world_to_px(opts, points)                         # (B, 2)
    org_px = world_to_px(opts, origin_xy)                      # (2,)
    # jnp.linspace(0, 1, S) as XLA:CPU computes it: i * f32(1 / (S - 1))
    s = (torch.arange(opts.ray_steps, dtype=torch.float32, device=dev)
         * _f32(1.0 / np.float32(opts.ray_steps - 1)))[None, :, None]
    ray = org_px[None, None, :] + (end_px[:, None, :] - org_px[None, None, :]) * s
    ray_cell = torch.round(ray).to(torch.int32)                # (B, S, 2)
    end_cell = torch.round(end_px).to(torch.int32)             # (B, 2)

    at_end = torch.all(ray_cell == end_cell[:, None, :], dim=-1)
    beam_len = torch.linalg.vector_norm(points - origin_xy, dim=-1)
    beam_ok = valid & (beam_len <= opts.max_beam_range)
    free = _cell_flags(ray_cell, beam_ok[:, None] & ~at_end & _in_bounds(ray_cell, n), n)
    occ = _cell_flags(end_cell, beam_ok & _in_bounds(end_cell, n), n)
    return _apply_delta(grid, opts, occ, free)


def add_scan_and_field(grid: OccupancyGrid, opts: Grid2dOptions, points, valid, origin_xy):
    """Occupancy update, then the field of the new grid: (grid, field)."""
    g = add_scan(grid, opts, points, valid, origin_xy)
    return g, likelihood_field(g, opts)


def add_scans_and_field(grid: OccupancyGrid, opts: Grid2dOptions, points, valid, origins,
                        count):
    """Rasterize the first `count` scans of a stack ((K, B, 2) points, (K, B)
    valid, (K, 2) origins) in order, then regenerate the field once (the
    submap seeding path). `count` is a host int (or a 0-d tensor, read once)."""
    for k in range(min(int(count), points.shape[0])):
        grid = add_scan(grid, opts, points[k], valid[k], origins[k])
    return grid, likelihood_field(grid, opts)


def out_of_bounds_fraction(opts: Grid2dOptions, points: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """Fraction of valid endpoints falling outside the grid: the submap
    expansion trigger."""
    px = world_to_px(opts, points)
    n = opts.image_size
    outside = (px[..., 0] < 0) | (px[..., 0] >= n) | (px[..., 1] < 0) | (px[..., 1] >= n)
    num = torch.sum((outside & valid).to(torch.float32))
    return num / torch.clamp(torch.sum(valid.to(torch.float32)), min=1.0)


# ---------------------------------------------------------------------------
# Likelihood field
# ---------------------------------------------------------------------------

def _min_plus_pass(f: torch.Tensor, dim: int, r: int) -> torch.Tensor:
    """out[i] = min over |d| <= r of f[i - d] + d^2 along `dim`, indices
    wrapping around (jnp.roll's shifts). Exact: integer-valued float32."""
    n = f.shape[dim]
    padded = torch.cat([f.narrow(dim, n - r, r), f, f.narrow(dim, 0, r)], dim=dim)
    window = padded.unfold(dim, 2 * r + 1, 1)                  # (..., 2r + 1) f[i - r .. i + r]
    d2 = (torch.arange(-r, r + 1, device=f.device, dtype=torch.float32)) ** 2
    return torch.amin(window + d2, dim=-1)


def likelihood_field(grid: OccupancyGrid, opts: Grid2dOptions) -> torch.Tensor:
    """(H, W) float32 distance to the nearest occupied cell (count >
    unknown) in PIXELS, capped at field_radius. Beyond the radius every
    value is the cap 4r^2 before the sqrt."""
    r = opts.field_radius
    g = torch.where(grid.counts > opts.unknown, 0.0, float(r * r * 4.0))
    d2 = _min_plus_pass(_min_plus_pass(g, 1, r), 0, r)
    # sqrt in float64 then rounded: the correctly rounded float32 sqrt on
    # every device (the CPU's vectorized float32 sqrt is not)
    return torch.clamp(torch.sqrt(d2.double()).float(), max=float(r))


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Bilinear sample + analytic gradient of a (H, W) image at float
    (x, y) = (col, row): (value, d/dx, d/dy). The integer cell indices are
    clamped into [0, W-2] x [0, H-2] (a NaN coordinate gives an undefined
    integer; JAX clamps the gather, torch would fault), so a NaN pose or
    beam gives a NaN sample, never an out-of-range read."""
    h, w = img.shape
    x = torch.clamp(x, 1.0, w - 2.0)
    y = torch.clamp(y, 1.0, h - 2.0)
    xf = torch.floor(x)
    yf = torch.floor(y)
    x0 = torch.clamp(xf.long(), 0, w - 2)
    y0 = torch.clamp(yf.long(), 0, h - 2)
    fx = x - xf
    fy = y - yf
    flat = img.reshape(-1)
    base = y0 * w + x0
    v00 = flat[base]
    v01 = flat[base + 1]
    v10 = flat[base + w]
    v11 = flat[base + w + 1]
    val = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    dx = (v01 - v00) * (1 - fy) + (v11 - v10) * fy
    dy = (v10 - v00) * (1 - fx) + (v11 - v01) * fx
    return val, dx, dy


@dataclasses.dataclass(frozen=True)
class Align2dOptions:
    """Mirror of the JAX package's Align2dOptions. method "gn" is plain
    Gauss-Newton, "lm" Levenberg-Marquardt (damped steps, accepted only
    when the mean residual per effective beam falls)."""

    max_iterations: int = 10
    max_residual_px: float = 20.0    # outlier gate on |field| value
    eps: float = 1e-4
    min_effective: int = 20
    huber_delta_px: float = 5.0
    method: str = "gn"               # gn | lm
    lm_lambda0: float = 1e-3
    lm_up: float = 10.0
    lm_down: float = 0.2
    lm_lambda_max: float = 1e4


class Align2dResult(NamedTuple):
    theta: torch.Tensor
    t: torch.Tensor          # (2,)
    converged: torch.Tensor
    num_effective: torch.Tensor
    chi2: torch.Tensor
    inlier_ratio: torch.Tensor


def _field_terms(field, gopts: Grid2dOptions, aopts: Align2dOptions, scan_xy, scan_valid,
                 theta, t):
    """The SE(2) field linearization: bilinear residual / gradient lookup,
    outlier gate, Huber weights, 3x3 H and b. Returns (H, b, n_eff, chi2,
    inlier_ratio)."""
    res_scale = gopts.resolution  # field gradient is in px; J in px/m
    c, s = torch.cos(theta), torch.sin(theta)
    wx = c * scan_xy[:, 0] - s * scan_xy[:, 1] + t[0]
    wy = s * scan_xy[:, 0] + c * scan_xy[:, 1] + t[1]
    px = wx * gopts.resolution + gopts.center
    py = wy * gopts.resolution + gopts.center
    e, gx, gy = _bilinear(field, px, py)
    ok = scan_valid & (e < aopts.max_residual_px) & torch.isfinite(e)
    w = torch.where(e <= aopts.huber_delta_px, 1.0,
                    aopts.huber_delta_px / torch.clamp(e, min=1e-9))
    w = w * ok.to(field.dtype)
    dwx_dth = -s * scan_xy[:, 0] - c * scan_xy[:, 1]
    dwy_dth = c * scan_xy[:, 0] - s * scan_xy[:, 1]
    J = torch.stack([res_scale * (gx * dwx_dth + gy * dwy_dth),   # d e / d theta
                     res_scale * gx,                               # d e / d tx
                     res_scale * gy], dim=-1)                      # d e / d ty
    Jw = J * w[:, None]
    H = Jw.T @ J
    b = -(Jw.T @ e)
    chi2 = torch.sum(e * e * w)
    n_eff = torch.sum(ok.to(torch.int32))
    inl = (torch.sum((ok & (e < 3.0)).to(torch.int32))
           / torch.clamp(torch.sum(scan_valid.to(torch.int32)), min=1)).to(torch.float32)
    return H, b, n_eff, chi2, inl


def _solve3(H, b):
    return torch.linalg.solve_ex(H, b, check_errors=False).result


def _start(field, theta0, t0):
    dev = field.device
    return (torch.as_tensor(theta0, dtype=torch.float32, device=dev).reshape(()),
            torch.as_tensor(t0, dtype=torch.float32, device=dev).reshape(2))


def align_gauss_newton(field: torch.Tensor, gopts: Grid2dOptions, scan_xy: torch.Tensor,
                       scan_valid: torch.Tensor, theta0, t0,
                       aopts: Align2dOptions = Align2dOptions()) -> Align2dResult:
    """SE(2) GN on bilinear field residuals with Huber weights, all beams at
    once, a 3x3 solve per iteration; `aopts.method == "lm"` dispatches to
    `align_lm`. scan_xy: (B, 2) beam endpoints in the SENSOR frame. As in
    the JAX package, num_effective / chi2 / inlier_ratio are those of the
    LAST LINEARIZATION (one step behind the returned pose)."""
    if aopts.method == "lm":
        return align_lm(field, gopts, scan_xy, scan_valid, theta0, t0, aopts)
    dev = field.device
    th, t = _start(field, theta0, t0)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    n_eff = torch.zeros((), dtype=torch.int32, device=dev)
    chi2 = torch.zeros((), dtype=torch.float32, device=dev)
    inl = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(aopts.max_iterations):
        H, b, n_eff, chi2, inl = _field_terms(field, gopts, aopts, scan_xy, scan_valid, th, t)
        ok = n_eff >= aopts.min_effective
        dx = torch.where(ok, _solve3(H + eye3 * 1e-6, b), 0.0)
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        th = th + dx[0]
        t = t + dx[1:]
        done = ok & (torch.linalg.vector_norm(dx) < aopts.eps)
        if bool(done):          # the one host read per iteration
            break
    return Align2dResult(theta=th, t=t, converged=done, num_effective=n_eff, chi2=chi2,
                         inlier_ratio=inl)


def align_lm(field: torch.Tensor, gopts: Grid2dOptions, scan_xy: torch.Tensor,
             scan_valid: torch.Tensor, theta0, t0,
             aopts: Align2dOptions = Align2dOptions()) -> Align2dResult:
    """Levenberg-Marquardt field alignment with Huber weights (the
    reference's g2o-LM path): each iteration solves (H + lambda diag(H)) dx
    = b and accepts the step only if the mean residual per effective beam
    falls (lambda * lm_down on accept, * lm_up on reject). Reports the
    metrics at the final pose. Kept from the reference: `converged` is also
    True when lambda saturates at lm_lambda_max (stuck, not converged)."""
    dev = field.device
    th, t = _start(field, theta0, t0)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    lam = torch.full((), aopts.lm_lambda0, dtype=torch.float32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(aopts.max_iterations):
        H, b, n_eff, chi2, _ = _field_terms(field, gopts, aopts, scan_xy, scan_valid, th, t)
        ok = n_eff >= aopts.min_effective
        Hd = H + lam * torch.diag(torch.diagonal(H)) + eye3 * 1e-6
        dx = torch.where(ok, _solve3(Hd, b), 0.0)
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        th2, t2 = th + dx[0], t + dx[1:]
        _, _, n_eff2, chi2_new, _ = _field_terms(field, gopts, aopts, scan_xy, scan_valid,
                                                 th2, t2)
        # acceptance on the MEAN residual per effective beam (the raw chi2
        # sums over a pose-gated beam set)
        mean_old = chi2 / torch.clamp(n_eff, min=1).to(chi2.dtype)
        mean_new = chi2_new / torch.clamp(n_eff2, min=1).to(chi2.dtype)
        accept = (ok & torch.isfinite(mean_new) & (mean_new < mean_old)
                  & (n_eff2 >= aopts.min_effective))
        th = torch.where(accept, th2, th)
        t = torch.where(accept, t2, t)
        lam = torch.clamp(torch.where(accept, lam * aopts.lm_down, lam * aopts.lm_up),
                          1e-9, aopts.lm_lambda_max)
        done = (ok & accept & (torch.linalg.vector_norm(dx) < aopts.eps)) | (
            lam >= aopts.lm_lambda_max)
        if bool(done):          # the one host read per iteration
            break
    _, _, n_eff, chi2, inl = _field_terms(field, gopts, aopts, scan_xy, scan_valid, th, t)
    return Align2dResult(theta=th, t=t, converged=done, num_effective=n_eff, chi2=chi2,
                         inlier_ratio=inl)


def scan_to_points(ranges: torch.Tensor, angle_min: float, angle_inc: float,
                   range_min: float = 0.1, range_max: float = 30.0):
    """LaserScan -> (B, 2) sensor-frame endpoints + validity."""
    b = ranges.shape[0]
    ang = angle_min + torch.arange(b, dtype=torch.float32, device=ranges.device) * angle_inc
    valid = (ranges > range_min) & (ranges < range_max) & torch.isfinite(ranges)
    xy = torch.stack([ranges * torch.cos(ang), ranges * torch.sin(ang)], dim=-1)
    return torch.where(valid[:, None], xy, 0.0), valid
