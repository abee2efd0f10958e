"""Visual observability: PNG dumps of maps and trajectories (numpy; a copy
of loc_lib_tpu/io/viz.py, kept here because the JAX package cannot be
imported without jax).

The reference ships LIVE dashboards: rviz topics for the current scan /
local map / odometry, OpenCV `imshow` windows for 2D mapping (with a
stitched global-map renderer) and for ScanContext descriptors. The offline
apps replace them with rendered ARTIFACTS: every app run dumps PNG images
next to its trajectory/report files, so a mapping run is inspectable
without any GUI stack.

Pure numpy + zlib/struct: the PNG encoder is ~30 lines and introduces no
imaging dependency.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, img: np.ndarray) -> None:
    """Minimal PNG writer: img is (H, W) uint8 grayscale or (H, W, 3) uint8
    RGB. Row 0 renders at the TOP (image convention)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png wants uint8, got {img.dtype}")
    if img.ndim == 2:
        color_type = 0
        raw = img[:, :, None]
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
        raw = img
    else:
        raise ValueError(f"write_png wants (H,W) or (H,W,3), got {img.shape}")
    h, w = raw.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    # each scanline prefixed with filter byte 0
    scanlines = b"".join(b"\x00" + raw[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(scanlines, 6)))
        f.write(chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# 2D occupancy (the ShowGlobalMap renderer, mapping_2d.cpp:186-324)
# ---------------------------------------------------------------------------

def render_occupancy_global(submaps, resolution: float,
                            unknown: int = 127,
                            px_per_m: float | None = None,
                            traj_xy: np.ndarray | None = None) -> np.ndarray:
    """Stitch per-submap occupancy grids into one world-frame uint8 image.

    `submaps`: iterable of (counts (N, N) int array, theta_ws, t_ws (2,)) —
    exactly what `Mapping2D.global_occupancy()` returns. Rendering follows
    the reference's global renderer (mapping_2d.cpp:186-324): each output
    cell is looked up in every submap that covers it (later submaps win,
    like the reference's sequential overdraw), occupied dark / free light /
    unknown mid-gray.

    Returns (H, W, 3) uint8, world +x to the right, +y UP (row 0 = top)."""
    subs = [(np.asarray(c), float(th), np.asarray(t, np.float64))
            for c, th, t in submaps]
    if not subs:
        return np.full((8, 8, 3), 200, np.uint8)
    res = px_per_m if px_per_m is not None else resolution
    n = subs[0][0].shape[0]
    # world bounds: a submap rotated by theta_ws reaches up to half*sqrt(2)
    # from t_ws along its diagonals — bound by the rotated corner extent so
    # no rotated submap content is cropped
    half = n / 2.0 / resolution * np.sqrt(2.0)
    lo = np.min([t - half for _, _, t in subs], axis=0)
    hi = np.max([t + half for _, _, t in subs], axis=0)
    w = max(int(np.ceil((hi[0] - lo[0]) * res)) + 1, 8)
    h = max(int(np.ceil((hi[1] - lo[1]) * res)) + 1, 8)
    # cap output size (long runs): drop px_per_m proportionally
    cap = 4096
    if max(w, h) > cap:
        scale = cap / max(w, h)
        res *= scale
        w = max(int(np.ceil((hi[0] - lo[0]) * res)) + 1, 8)
        h = max(int(np.ceil((hi[1] - lo[1]) * res)) + 1, 8)

    xs = lo[0] + (np.arange(w) + 0.5) / res          # world x per column
    ys = lo[1] + (np.arange(h) + 0.5) / res          # world y per row
    wx = np.broadcast_to(xs[None, :], (h, w))
    wy = np.broadcast_to(ys[:, None], (h, w))

    out = np.full((h, w), np.float32(unknown))
    known = np.zeros((h, w), bool)
    for counts, th, t in subs:
        c, s = np.cos(th), np.sin(th)
        # world -> submap frame
        dx, dy = wx - t[0], wy - t[1]
        sx = c * dx + s * dy
        sy = -s * dx + c * dy
        px = np.round(sx * resolution + n / 2.0).astype(np.int64)
        py = np.round(sy * resolution + n / 2.0).astype(np.int64)
        inside = (px >= 0) & (px < n) & (py >= 0) & (py < n)
        val = counts[np.clip(py, 0, n - 1), np.clip(px, 0, n - 1)]
        touched = inside & (val != unknown)
        out = np.where(touched, val, out)
        known |= touched
    # occupancy -> gray: occupied (counts > unknown) dark, free light
    # (counts clamp to [unknown-10, unknown+10] in the grid, grid2d.py)
    g = np.clip((np.float32(unknown) + 10.0 - out) / 20.0, 0.0, 1.0)
    gray = np.where(known, (55.0 + 200.0 * g), 200.0).astype(np.uint8)
    img = np.ascontiguousarray(np.stack([gray] * 3, axis=-1)[::-1])  # +y up
    if traj_xy is not None and len(traj_xy) > 1:
        txy = np.asarray(traj_xy, np.float64)
        col = (txy[:, 0] - lo[0]) * res - 0.5
        row = (h - 1) - ((txy[:, 1] - lo[1]) * res - 0.5)
        draw_polyline(img, np.stack([col, row], axis=-1), (220, 50, 50),
                      thickness=2)
    return img


def draw_polyline(img: np.ndarray, pts_px: np.ndarray, color,
                  thickness: int = 1) -> None:
    """Rasterize a polyline IN PLACE on an (H, W, 3) uint8 image.
    pts_px: (K, 2) float (col, row) pixel coordinates."""
    h, w = img.shape[:2]
    color = np.asarray(color, np.uint8)
    pts = np.asarray(pts_px, np.float64)
    for a, b in zip(pts[:-1], pts[1:]):
        n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1])) * 2) + 2
        s = np.linspace(0.0, 1.0, n)
        xs = np.round(a[0] + (b[0] - a[0]) * s).astype(np.int64)
        ys = np.round(a[1] + (b[1] - a[1]) * s).astype(np.int64)
        for ddx in range(-(thickness // 2), thickness // 2 + 1):
            for ddy in range(-(thickness // 2), thickness // 2 + 1):
                x = np.clip(xs + ddx, 0, w - 1)
                y = np.clip(ys + ddy, 0, h - 1)
                img[y, x] = color


def draw_marker(img: np.ndarray, xy_px, color, size: int = 3) -> None:
    """Square marker IN PLACE at (col, row)."""
    h, w = img.shape[:2]
    x0, y0 = int(round(xy_px[0])), int(round(xy_px[1]))
    img[max(y0 - size, 0): min(y0 + size + 1, h),
        max(x0 - size, 0): min(x0 + size + 1, w)] = np.asarray(color, np.uint8)


def render_map_topdown(map_xyz: np.ndarray, traj_t: np.ndarray | None = None,
                       ref_t: np.ndarray | None = None,
                       image_size: int = 1024,
                       margin: float = 2.0) -> np.ndarray:
    """Top-down (x, y) view of a 3D point map with the trajectory overlaid —
    the artifact analog of the reference's rviz global-map + odometry topics
    (lio_mapping_flow.cpp:150-155, 378-418).

    map_xyz: (N, 3); traj_t: (K, 3) primary trajectory positions (red);
    ref_t: optional (K, 3) reference trajectory (blue) — ground truth, or
    the pre-optimization odometry when comparing against the PGO output.
    Map density renders as grayscale (log-scaled histogram); +y is UP.
    Returns (image_size, image_size, 3) uint8."""
    pts = np.asarray(map_xyz, np.float64).reshape(-1, 3)
    anchors = [pts[:, :2]] if len(pts) else []
    if traj_t is not None and len(traj_t):
        anchors.append(np.asarray(traj_t, np.float64)[:, :2])
    if ref_t is not None and len(ref_t):
        anchors.append(np.asarray(ref_t, np.float64)[:, :2])
    if not anchors:
        return np.full((image_size, image_size, 3), 245, np.uint8)
    allxy = np.concatenate(anchors, axis=0)
    lo = allxy.min(axis=0) - margin
    hi = allxy.max(axis=0) + margin
    span = max(float((hi - lo).max()), 1e-3)
    res = (image_size - 1) / span                      # px per meter

    def to_px(xy):
        xy = np.asarray(xy, np.float64)
        col = (xy[..., 0] - lo[0]) * res
        row = (image_size - 1) - (xy[..., 1] - lo[1]) * res   # +y up
        return np.stack([col, row], axis=-1)

    img = np.full((image_size, image_size, 3), 245, np.uint8)
    if len(pts):
        px = to_px(pts[:, :2]).astype(np.int64)
        px = px[(px[:, 0] >= 0) & (px[:, 0] < image_size)
                & (px[:, 1] >= 0) & (px[:, 1] < image_size)]
        dens = np.zeros((image_size, image_size), np.int64)
        np.add.at(dens, (px[:, 1], px[:, 0]), 1)
        hit = dens > 0
        shade = np.zeros_like(dens, np.float64)
        shade[hit] = np.log1p(dens[hit]) / max(np.log1p(dens.max()), 1e-9)
        gray = (235.0 - 195.0 * shade).astype(np.uint8)
        img[hit] = gray[hit][:, None]
    if ref_t is not None and len(ref_t) > 1:
        draw_polyline(img, to_px(np.asarray(ref_t)[:, :2]), (90, 130, 235),
                      thickness=1)
    if traj_t is not None and len(traj_t) > 1:
        tp = to_px(np.asarray(traj_t)[:, :2])
        draw_polyline(img, tp, (220, 50, 50), thickness=2)
        draw_marker(img, tp[0], (30, 160, 30), size=4)    # start: green
        draw_marker(img, tp[-1], (220, 50, 50), size=4)   # end: red
    return img


def render_scan_context(desc: np.ndarray) -> np.ndarray:
    """ScanContext descriptor heat image (the reference's OpenCV dashboard,
    scan_context.cpp:25-50): (R, S) descriptor -> (R*8, S*8, 3) uint8."""
    d = np.asarray(desc, np.float64)
    dmax = max(float(d.max()), 1e-9)
    g = (d / dmax * 255.0).astype(np.uint8)
    g = np.kron(g, np.ones((8, 8), np.uint8))
    return np.stack([g, (0.6 * g).astype(np.uint8),
                     255 - g], axis=-1)
