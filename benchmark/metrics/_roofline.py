"""The yardstick's roofline arithmetic: the card's published peaks and the
bytes and operations that a kernel's inputs need (not what its layout
reads). Copied from the smoke run's bounds so that the program can change
and the yardstick cannot; it calls nothing of the program.

Published peaks of the H100 SXM (NVIDIA's data sheet, 700 W): 3.35 TB/s of
HBM, 67 TFLOP/s of float32 outside the tensor cores.
"""

from __future__ import annotations

import torch

H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12

# K2 (p2plane_pick_fused_terms from the target), counted from the kernel's
# source: per point qs 18, the row 42, its 36 products and sums 72, the voxel
# coordinates 9, and 10 per stencil candidate.
FLOPS_K2_TARGET = 132 + 9 + 7 * 10
OUT_BYTES = 44 * 4           # H, b, chi2, count
POSE_BYTES = 13 * 4          # R, t, gate
INDEX_BYTES = 7 * 4          # dense lo, origin, 1 / leaf
STENCIL = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, -1), (0, 0, 1))
WINDOW, HALF = 1024, 512


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(n_bytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS)


def k2_bytes(q, mask, R, t, origin, leaf, lo, dims, table) -> int:
    """Bytes K2 from the target must move for these inputs: 13 B a point
    (xyz and the mask byte), each distinct dense-table cell (4 B) and plane
    row (32 B) that the points' 7-voxel stencils reach at the pose (R, t), the
    pose and index scalars and the output. `table` is the flat dense slot
    table of `dims` cells from the corner `lo` (-1 empty) over voxels of
    `leaf` binned by floor about `origin`."""
    dev = table.device
    q = torch.as_tensor(q, dtype=torch.float64, device=dev)
    R = torch.as_tensor(R, dtype=torch.float64, device=dev)
    t = torch.as_tensor(t, dtype=torch.float64, device=dev)
    origin = torch.as_tensor(origin, dtype=torch.float64, device=dev)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    c = torch.floor((q @ R.T + t - origin) / leaf).to(torch.int64)
    c7 = c[:, None, :] + torch.tensor(STENCIL, device=dev)[None]
    rel = c7 - torch.as_tensor(lo, device=dev)
    ok = (mask[:, None] & torch.all((c7 >= -HALF) & (c7 < WINDOW - HALF), dim=-1)
          & torch.all((rel >= 0) & (rel < torch.tensor(dims, device=dev)), dim=-1))
    flat = torch.where(ok, (rel[..., 0] * dims[1] + rel[..., 1]) * dims[2] + rel[..., 2], 0)
    cells = torch.unique(flat)
    slots = torch.unique(torch.clamp(table[cells], min=0))
    return int(q.shape[0] * 13 + cells.numel() * 4 + slots.numel() * 32
               + POSE_BYTES + INDEX_BYTES + OUT_BYTES)


def k2_flops(n_points: int) -> int:
    return FLOPS_K2_TARGET * n_points
