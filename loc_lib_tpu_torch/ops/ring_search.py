"""Ring-structured correspondence search, the range-image nearest neighbour
(port of loc_lib_tpu/ops/ring_search.py).

A scan organized as a (rings, cols) range image turns the +-2-ring x
+-5-column window search into a stencil: shifted subtracts and a running
minimum over an (R, C, 3) tensor, no gather and no sort. `scan_match_rings`
runs frame-to-frame point-to-point Gauss-Newton odometry over those
correspondences, with the port's GN loop idiom: after the linearization
an iteration is one `kernels.gn_step` (the 6x6 solve, the pose update and
the output rotation's projection), and the host reads the stop flag once
per iteration.

Differences from the JAX package, semantics kept:
  * the scatters of `organize_rings` are `scatter_reduce` amin / amax,
    which do not depend on order. Where two points of one cell have the
    same (smallest) range, the point with the HIGHER index wins the cell,
    which is what XLA's sequential scatter on the CPU gives and what
    `tests/test_torch_small_ops.py` pins; JAX leaves that order unspecified
    on other backends;
  * the azimuth column is (az + pi) * f32(ring_len / 2pi), the product
    XLA:CPU folds `(az + pi) / (2 pi) * ring_len` into.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils import lie
from . import kernels
from .pointcloud import PAD_COORD


@dataclasses.dataclass(frozen=True)
class RingOptions:
    """Mirror of the JAX package's RingOptions (same names and defaults)."""

    num_rings: int = 16
    ring_len: int = 1024       # azimuth columns
    ring_window: int = 2       # +- rings searched
    col_window: int = 5        # +- columns searched
    max_distance: float = 1.0  # correspondence gate (m)
    max_iteration: int = 20
    eps: float = 1e-2
    min_effective_pts: int = 10


class RingImage(NamedTuple):
    """Ring-organized scan: xyz (R, C, 3), valid (R, C)."""

    xyz: torch.Tensor
    valid: torch.Tensor


def _sq3(d: torch.Tensor) -> torch.Tensor:
    """|d|^2 over the last axis of 3, summed x + y + z in that order."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def organize_rings(xyz: torch.Tensor, ring: torch.Tensor, mask: torch.Tensor,
                   num_rings: int = 16, ring_len: int = 1024) -> RingImage:
    """Scatter an unorganized scan into a (rings, cols) range image: column =
    azimuth bin over [0, 2pi); on collisions the nearest point (smallest
    range) wins, as lidar drivers keep the strongest return per cell."""
    dev = xyz.device
    n_cells = num_rings * ring_len
    az = torch.atan2(xyz[:, 1], xyz[:, 0])                     # (-pi, pi]
    scale = float(np.float32(ring_len) / np.float32(2.0 * math.pi))
    col = torch.floor((az + math.pi) * scale).to(torch.int32)
    col = torch.clamp(col, 0, ring_len - 1)
    r = torch.clamp(ring.to(torch.int32), 0, num_rings - 1)
    ok = mask & (ring >= 0) & (ring < num_rings)
    flat = torch.where(ok, r * ring_len + col, n_cells).to(torch.int64)

    rng2 = _sq3(xyz)
    best = torch.full((n_cells + 1,), torch.inf, dtype=torch.float32, device=dev)
    best = best.scatter_reduce(0, flat, torch.where(ok, rng2, torch.inf), "amin")
    is_winner = ok & (rng2 <= best[flat])
    winner = torch.full((n_cells + 1,), -1, dtype=torch.int64, device=dev)
    winner = winner.scatter_reduce(0, torch.where(is_winner, flat, n_cells),
                                   torch.arange(xyz.shape[0], device=dev), "amax")[:-1]
    img = torch.where((winner >= 0)[:, None], xyz[torch.clamp(winner, min=0)], PAD_COORD)
    valid = torch.isfinite(best[:-1])
    return RingImage(xyz=img.reshape(num_rings, ring_len, 3),
                     valid=valid.reshape(num_rings, ring_len))


def ring_window_nn(prev: RingImage, cur: RingImage, ring_window: int = 2,
                   col_window: int = 5):
    """Per-cell nearest neighbour of `cur` in `prev` within the
    +-ring_window x +-col_window stencil: for each (dr, dc) offset, shift
    `prev` and keep a running minimum of the squared distance (strict <, so
    the first offset wins ties). Columns wrap (azimuth is periodic); rings
    do not. Returns (nn_xyz (R, C, 3), d2 (R, C), found (R, C))."""
    R, C, _ = prev.xyz.shape
    dev = prev.xyz.device
    best_d2 = torch.full((R, C), torch.inf, dtype=torch.float32, device=dev)
    best_xyz = torch.full((R, C, 3), PAD_COORD, dtype=prev.xyz.dtype, device=dev)
    for dr in range(-ring_window, ring_window + 1):
        # rows shifted past the image are invalid
        shifted = torch.full_like(prev.xyz, PAD_COORD)
        svalid = torch.zeros_like(prev.valid)
        if dr >= 0:
            shifted[:R - dr] = prev.xyz[dr:]
            svalid[:R - dr] = prev.valid[dr:]
        else:
            shifted[-dr:] = prev.xyz[:dr]
            svalid[-dr:] = prev.valid[:dr]
        for dc in range(-col_window, col_window + 1):
            cand = torch.roll(shifted, -dc, dims=1)
            cvalid = torch.roll(svalid, -dc, dims=1)
            d2 = torch.where(cvalid & cur.valid, _sq3(cand - cur.xyz), torch.inf)
            take = d2 < best_d2
            best_d2 = torch.where(take, d2, best_d2)
            best_xyz = torch.where(take[..., None], cand, best_xyz)
    return best_xyz, best_d2, torch.isfinite(best_d2)


class RingMatchResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    converged: torch.Tensor
    num_effective: torch.Tensor
    iterations: int              # GN iterations run (known on the host)
    chi2: torch.Tensor


def scan_match_rings(prev: RingImage, cur: RingImage, opts: RingOptions, R0=None,
                     t0=None) -> RingMatchResult:
    """Frame-to-frame point-to-point GN over ring-window correspondences:
    J = [R hat(q), -I], H = sum J^T J, b = -sum J^T e with e = nn - qs, the
    6x6 solve, a right retraction."""
    dev = cur.xyz.device
    q = cur.xyz.reshape(-1, 3)
    qvalid = cur.valid.reshape(-1)
    R = (torch.eye(3, dtype=torch.float32, device=dev) if R0 is None
         else torch.as_tensor(R0, dtype=torch.float32, device=dev))
    t = (torch.zeros(3, dtype=torch.float32, device=dev) if t0 is None
         else torch.as_tensor(t0, dtype=torch.float32, device=dev))
    minus_eye = -torch.eye(3, dtype=torch.float32, device=dev)
    loop = kernels.GnLoop(R, t, opts.min_effective_pts, opts.eps)
    it = 0
    while it < opts.max_iteration:
        R, t = loop.R, loop.t
        qs = q @ R.T + t
        nn, d2, found = ring_window_nn(prev, RingImage(xyz=qs.reshape(cur.xyz.shape),
                                                       valid=cur.valid),
                                       opts.ring_window, opts.col_window)
        nn, d2 = nn.reshape(-1, 3), d2.reshape(-1)
        eff = found.reshape(-1) & qvalid & (d2 <= opts.max_distance ** 2)
        e = nn - qs
        Rhatq = torch.einsum("ij,njk->nik", R, lie.hat(q))
        J = torch.cat([Rhatq, minus_eye.expand(Rhatq.shape)], dim=-1)   # (N, 3, 6)
        w = eff.to(torch.float32)
        Jw = (J * w[:, None, None]).reshape(-1, 6)
        H = Jw.T @ Jw
        b = -(Jw.T @ (e * w[:, None]).reshape(-1))
        n_eff = eff.to(torch.int32).sum()
        chi2 = torch.sum(_sq3(e) * w)
        it += 1
        if not bool(loop.step((H, b, n_eff, chi2))):     # the one host read per iteration
            break
    R, t, converged, n_eff, chi2, _ = loop.result()
    return RingMatchResult(R=R, t=t, converged=converged, num_effective=n_eff, iterations=it,
                           chi2=chi2)
