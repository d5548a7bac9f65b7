"""Data loading, padding, and shape-bucketing utilities (numpy only).

Twin of ``trajectory_optimization_tpu/utils/data.py``, re-written rather than
imported: importing anything from the JAX package imports ``jax``. Clouds
are padded to bucketed sizes with far-away (1e6) points and a ``valid``
mask, exactly as the JAX facade pads them, so both packages see the same
shapes.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def load_point_cloud(path: str, key: str = "pts", dtype=np.float32) -> np.ndarray:
    """Load an (N, 3) point cloud from an .npz file (transposes a (3, N) one)."""
    pts = np.load(path)[key]
    orig_shape = pts.shape
    if pts.ndim != 2:
        raise ValueError(f"expected 2D point array, got shape {orig_shape}")
    if pts.shape[0] < pts.shape[1]:
        pts = pts.T
    if pts.shape[1] != 3:
        raise ValueError(f"expected Nx3 (or 3xN) points, got shape {orig_shape}")
    return np.ascontiguousarray(pts, dtype=dtype)


def load_path(path: str, key: str = "poses", dtype=np.float32) -> np.ndarray:
    """Load a (W, 3) waypoint path from an .npz file."""
    poses = np.load(path)[key]
    if poses.ndim != 2 or poses.shape[1] != 3:
        raise ValueError(f"expected Wx3 poses, got shape {poses.shape}")
    return np.ascontiguousarray(poses, dtype=dtype)


def identity_quaternions(n: int, dtype=np.float32) -> np.ndarray:
    """(n, 4) identity wxyz quaternions."""
    q = np.zeros((n, 4), dtype=dtype)
    q[:, 0] = 1.0
    return q


def bucket_size(n: int, *, multiple: int = 1024, min_size: int = 1024) -> int:
    """Round a cloud size up to a power-of-two-ish bucket (1/4 steps between
    powers of two, so padding waste stays under ~25%)."""
    n = max(int(n), 1)
    if n <= min_size:
        return min_size
    b = min_size
    while b < n:
        b *= 2
    for frac in (b // 2 + b // 8, b // 2 + b // 4, b // 2 + 3 * b // 8, b // 2 + b // 2):
        cand = (frac // multiple) * multiple
        if cand >= n:
            return max(cand, min_size)
    return b


def pad_points(
    pts: np.ndarray, target: int | None = None, *, multiple: int = 1024
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad an (N, 3) cloud to a bucketed size.

    Returns (padded_points (M, 3), valid_mask (M,) float32). Padded entries
    sit at 1e6, so every smooth mask underflows to 0 for them; reductions
    must still respect ``valid``.
    """
    n = pts.shape[0]
    m = bucket_size(n, multiple=multiple) if target is None else int(target)
    if m < n:
        raise ValueError(f"target {m} < cloud size {n}")
    out = np.full((m, 3), 1.0e6, dtype=pts.dtype)
    out[:n] = pts
    valid = np.zeros((m,), dtype=np.float32)
    valid[:n] = 1.0
    return out, valid


def reference_data_dir() -> str:
    """Directory with the bundled sample data (cloud/path index 10)."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "data")
