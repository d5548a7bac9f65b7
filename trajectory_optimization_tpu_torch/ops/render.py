"""Point-splat renderer: z-nearest perspective splatting with scatters.

Twin of ``trajectory_optimization_tpu/ops/render.py``: camera-frame points
are splatted as discs of world radius 0.03 m, one point per pixel (the
nearest wins), with znear/zfar clipping, a white background and RGB =
min-max-normalized xyz.

Two passes over a static footprint window of ±``max_radius_px``:
  1. ``scatter_reduce("amin")`` of each point's depth into a z-buffer;
  2. every point whose depth equals its pixel's z-buffer entry is a winner;
     among the winners of a pixel the lowest point index takes it (a second
     ``amin`` scatter, of point indices).

XLA leaves the winner among equal depths unspecified; this port breaks such
ties deterministically, toward the lowest point index. The module is the
tests' independent yardstick for the tile renderer (``ops/tile_render.py``),
which breaks them by its scan order instead, so the two may differ on
equal-depth pixels only.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _default_colors(cam_points: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Min-max-normalized xyz; padding rows (valid == 0) do not enter the
    min and max."""
    if valid is not None:
        vm = (valid > 0)[:, None]
        lo = torch.amin(torch.where(vm, cam_points, torch.inf))
        hi = torch.amax(torch.where(vm, cam_points, -torch.inf))
    else:
        lo, hi = torch.amin(cam_points), torch.amax(cam_points)
    return (cam_points - lo) / torch.clamp(hi - lo, min=1e-12)


def render_point_cloud(
    cam_points: torch.Tensor,
    K: torch.Tensor,
    img_height: int,
    img_width: int,
    *,
    colors: Optional[torch.Tensor] = None,
    point_radius: float = 0.03,
    znear: float = 1.0,
    zfar: float = 10.0,
    bg_color: float = 1.0,
    max_radius_px: int = 4,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Render camera-frame points (N, 3) to an (H, W, 3) image.

    K (3, 3) intrinsics; colors optional (N, 3), default normalized xyz;
    valid optional (N,) mask of real points.
    """
    H, W = int(img_height), int(img_width)
    x, y, z = cam_points[:, 0], cam_points[:, 1], cam_points[:, 2]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    if colors is None:
        colors = _default_colors(cam_points, valid)

    zs = torch.clamp(z, min=1e-6)
    u = fx * x / zs + cx
    v = fy * y / zs + cy
    r_px = point_radius * fx / zs

    ok = (z > znear) & (z < zfar)
    ok = ok & (u > -r_px) & (u < W + r_px) & (v > -r_px) & (v < H + r_px)
    if valid is not None:
        ok = ok & (valid > 0)

    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    big = float(np.finfo(np.float32).max)
    r2 = torch.square(torch.clamp(torch.clamp(r_px, max=float(max_radius_px)), min=0.5))
    window = [
        (dy, dx)
        for dy in range(-max_radius_px, max_radius_px + 1)
        for dx in range(-max_radius_px, max_radius_px + 1)
    ]

    def footprint(dy, dx):
        yy, xx = vi + dy, ui + dx
        inside = ok & (float(dy * dy + dx * dx) <= r2) & (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        return inside, torch.where(inside, yy * W + xx, 0)

    # pass 1: depth into the z-buffer over each point's disc footprint
    zbuf = torch.full((H * W,), big, dtype=torch.float32, device=cam_points.device)
    for dy, dx in window:
        inside, flat = footprint(dy, dx)
        zbuf.scatter_reduce_(0, flat, torch.where(inside, z, big), "amin")

    # pass 2: the lowest index among the points at their pixel's depth
    n = cam_points.shape[0]
    idx = torch.arange(n, device=cam_points.device)
    winner = torch.full((H * W,), n, dtype=torch.int64, device=cam_points.device)
    for dy, dx in window:
        inside, flat = footprint(dy, dx)
        win = inside & (z <= zbuf[flat])
        winner.scatter_reduce_(0, flat, torch.where(win, idx, n), "amin")

    bg = torch.full((H * W, 3), bg_color, dtype=torch.float32, device=cam_points.device)
    if n == 0:
        return bg.reshape(H, W, 3)
    hit = (winner < n)[:, None]
    img = torch.where(hit, colors[torch.clamp(winner, max=n - 1)].to(torch.float32), bg)
    return img.reshape(H, W, 3)


def normalized_xyz_colors(points: torch.Tensor) -> torch.Tensor:
    """The reference's point coloring: global min-max-normalized coordinates."""
    return _default_colors(points, None)


def denormalize_image(img, eps: float = 1e-6) -> np.ndarray:
    """Percentile contrast-stretch to [0, 1] for display (host numpy)."""
    x = img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
    x_max = np.percentile(x, 98)
    x_min = np.percentile(x, 2)
    x = (x - x_min) / max(x_max - x_min, eps)
    return x.clip(0, 1)
