"""Voxel-grid operations: downsampling (PCL VoxelGrid equivalent) and dense
occupancy grids.

Twin of ``trajectory_optimization_tpu/ops/voxel.py``:

  * :func:`voxel_downsample` — centroid per occupied voxel, PCL VoxelGrid
    semantics, host-side numpy (copied); ``native/`` holds a C++ version
    with this as its fallback.
  * :func:`voxel_downsample_jit` — fixed-shape variant on device tensors:
    scatter-mean into a bounded hash table, padded centroids + occupied mask.
  * :func:`occupancy_grid` — dense 0/1 grid, `pc_to_voxel` parity (copied);
    :func:`occupancy_grid_jit` its device-tensor variant.

The ``_jit`` functions keep the JAX names so that a reader finds the twin;
here they are eager PyTorch on the tensors' device. Their hash and cell
indices are integer arithmetic on the same f32 inputs on every device; the
divisions are by a 0-dim tensor on the points' device, since dividing a
CUDA tensor by a Python scalar multiplies by its reciprocal instead.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

_U32 = 0xFFFFFFFF


def voxel_downsample(
    points: np.ndarray,
    leaf_size: float = 0.15,
    *,
    z_limits: Optional[Tuple[float, float]] = None,
) -> np.ndarray:
    """Centroid voxel-grid downsample (PCL VoxelGrid semantics).

    Args:
      points: (N, 3+) — extra columns (intensity, ...) are averaged too.
      leaf_size: voxel edge length in meters.
      z_limits: optional (zmin, zmax) pass-through filter, as the reference's
        `voxels_filtering.launch` configures on PCL.
    """
    pts = np.asarray(points, dtype=np.float64)
    if z_limits is not None:
        keep = (pts[:, 2] >= z_limits[0]) & (pts[:, 2] <= z_limits[1])
        pts = pts[keep]
    if len(pts) == 0:
        return pts.astype(np.float32)

    ijk = np.floor(pts[:, :3] / leaf_size).astype(np.int64)
    ijk -= ijk.min(axis=0)
    dims = ijk.max(axis=0) + 1
    key = (ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]
    order = np.argsort(key)
    key_s = key[order]
    pts_s = pts[order]
    boundaries = np.flatnonzero(np.diff(key_s)) + 1
    groups = np.split(np.arange(len(pts_s)), boundaries)
    out = np.stack([pts_s[g].mean(axis=0) for g in groups])
    return out.astype(np.float32)


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a · c) mod 2³² for int64 ``a`` in [0, 2³²) and a 32-bit constant,
    in 16-bit halves of ``c`` so that no int64 product overflows."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def voxel_downsample_jit(
    points: torch.Tensor,
    leaf_size: float,
    *,
    valid: Optional[torch.Tensor] = None,
    table_size: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape voxel downsample on the points' device.

    Hashes voxel ids into a bounded table and scatter-means the points; hash
    collisions merge distinct voxels (rare for table_size ≫ occupied voxels).
    Returns (centroids (table_size, 3), occupied (table_size,) f32). The
    sums are ``index_add_``, atomic on a card: their last bits may depend on
    the order of the adds there.
    """
    pts = points[:, :3]
    leaf = torch.full((), leaf_size, dtype=pts.dtype, device=pts.device)
    # the JAX twin's int32 → uint32 cast: negative voxel indices wrap
    ijk = torch.floor(pts / leaf).to(torch.int32).to(torch.int64) & _U32
    # murmur-style avalanche mix, in uint32 arithmetic
    h = _mul_u32(ijk[:, 0], 0x9E3779B1)
    h = h ^ (h >> 16)
    h = (h + _mul_u32(ijk[:, 1], 0x85EBCA6B)) & _U32
    h = h ^ (h >> 13)
    h = (h + _mul_u32(ijk[:, 2], 0xC2B2AE35)) & _U32
    h = h ^ (h >> 16)
    h = h % table_size
    w = (torch.ones(pts.shape[0], dtype=torch.float32, device=pts.device) if valid is None
         else valid.to(torch.float32))

    sums = torch.zeros((table_size, 3), dtype=torch.float32, device=pts.device)
    sums.index_add_(0, h, pts * w[:, None])
    cnts = torch.zeros((table_size,), dtype=torch.float32, device=pts.device)
    cnts.index_add_(0, h, w)
    occupied = cnts > 0
    centroids = sums / torch.clamp(cnts, min=1.0)[:, None]
    return centroids, occupied.to(torch.float32)


def _grid_dims(resolution, x, y, z) -> Tuple[int, int, int]:
    return (
        int((x[1] - x[0]) / resolution),
        int((y[1] - y[0]) / resolution),
        int(round((z[1] - z[0]) / resolution)),
    )


def occupancy_grid(
    points: np.ndarray,
    resolution: float = 0.15,
    x=(0.0, 90.0),
    y=(-50.0, 50.0),
    z=(-4.5, 5.5),
) -> np.ndarray:
    """Dense 0/1 occupancy grid — parity with the reference `pc_to_voxel`
    (`src/pointcloud_utils.py:279-288`): crop to the bounds, quantize at
    ``resolution``, mark occupied cells."""
    pc = np.asarray(points, dtype=np.float64)
    keep = (
        (pc[:, 0] >= x[0]) & (pc[:, 0] < x[1])
        & (pc[:, 1] >= y[0]) & (pc[:, 1] < y[1])
        & (pc[:, 2] >= z[0]) & (pc[:, 2] < z[1])
    )
    pc = pc[keep, :3]
    idx = ((pc - np.array([x[0], y[0], z[0]])) / resolution).astype(np.int32)
    grid = np.zeros(_grid_dims(resolution, x, y, z))
    # int()-truncated dims can be one cell short of the bounds filter (e.g.
    # y=49.95 → iy = dims[1] with the defaults): drop edge points like the
    # native twin does instead of raising IndexError
    inb = (idx[:, 0] < grid.shape[0]) & (idx[:, 1] < grid.shape[1]) & (idx[:, 2] < grid.shape[2])
    idx = idx[inb]
    grid[idx[:, 0], idx[:, 1], idx[:, 2]] = 1
    return grid


def occupancy_grid_jit(
    points: torch.Tensor,
    resolution: float = 0.15,
    x=(0.0, 90.0),
    y=(-50.0, 50.0),
    z=(-4.5, 5.5),
) -> torch.Tensor:
    """Occupancy grid on the points' device: (dims) f32, dims from the bounds."""
    dims = _grid_dims(resolution, x, y, z)
    pc = points[:, :3]
    keep = (
        (pc[:, 0] >= x[0]) & (pc[:, 0] < x[1])
        & (pc[:, 1] >= y[0]) & (pc[:, 1] < y[1])
        & (pc[:, 2] >= z[0]) & (pc[:, 2] < z[1])
    )
    origin = torch.tensor([x[0], y[0], z[0]], dtype=pc.dtype, device=pc.device)
    res = torch.full((), resolution, dtype=pc.dtype, device=pc.device)
    idx = ((pc - origin) / res).to(torch.int32).to(torch.int64)
    # per-axis guard BEFORE flattening: an index == dims[k] (possible at the
    # upper bound with truncated dims) would otherwise alias into the next
    # row via the flat arithmetic and mark the wrong voxel
    keep = keep & (idx[:, 0] < dims[0]) & (idx[:, 1] < dims[1]) & (idx[:, 2] < dims[2])
    flat = ((idx[:, 0] * dims[1] + idx[:, 1]) * dims[2] + idx[:, 2])[keep]
    grid = torch.zeros((dims[0] * dims[1] * dims[2],), dtype=torch.float32, device=pc.device)
    grid.index_put_((flat,), torch.ones((), dtype=torch.float32, device=pc.device))
    return grid.reshape(dims)
