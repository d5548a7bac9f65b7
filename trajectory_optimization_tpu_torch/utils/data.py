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


def in_view_case(n: int, n_wps: int, seed: int = 3, lo=(0.5, 0.5, 2.5)):
    """A cloud that every waypoint sees, so no score underflows: n points
    uniform in the box from ``lo`` to (2, 2, 4) m (seeded) ahead of n_wps
    close waypoints on (0.6t, 0.2 sin 3t, 0), every other one turned
    slightly. Returns (points (n, 3), quats (n_wps, 4) wxyz, trans
    (n_wps, 3)), f32."""
    t = np.linspace(0, 1, n_wps, dtype=np.float32)
    trans = np.stack([0.6 * t, 0.2 * np.sin(3 * t), np.zeros_like(t)], axis=1)
    quats = identity_quaternions(n_wps)
    quats[::2] = [0.99, 0.03, -0.05, 0.02]
    pts = np.random.default_rng(seed).uniform(lo, [2, 2, 4], size=(n, 3))
    return pts.astype(np.float32), quats, trans.astype(np.float32)


def splat_cases(K, img_height: int, img_width: int, *, cap: int = 2048, seed: int = 0):
    """Seeded camera-frame clouds that press on the splat kernels' edge
    cases, for an img_height × img_width image with intrinsics K (3, 3), on
    the 32×128 tiles and 32-column bands of ``ops.tile_render``. Returns
    {name: (points (n, 3) f32, renderer keyword arguments)}:

    * ``ties``: equal depths (z = 3, r = 1.5 px) on the pixels at and next
      to every other tile-row border and every band border, each pixel three
      times and its diagonal neighbour twice, so that scan order decides
      across K6's two runs of bins and K7's duplicated copies;
    * ``edges_r05``, ``edges_r4``: footprints of r = 0.5 and r = 4 px
      centred on, and one pixel outside, the four edges of the image;
    * ``over_cap``: cap + cap // 4 points (seeded, uniform) in every tile's
      part of the image, so that every tile of the dense path holds more
      than ``cap`` entries and the cap drops some.
    """
    K = np.asarray(K, np.float64)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    H, W = int(img_height), int(img_width)

    def at(px, py, z):
        px, py, z = (np.asarray(a, np.float64) for a in np.broadcast_arrays(px, py, z))
        return np.stack([(px - cx) * z / fx, (py - cy) * z / fy, z], axis=1).astype(np.float32)

    rows = [r for i in range(1, -(-H // 32), 2) for r in range(32 * i - 1, 32 * i + 3) if r < H]
    cols = [c for j in range(1, -(-W // 32)) for c in range(32 * j - 1, 32 * j + 3) if c < W]
    px, py = (a.ravel() for a in np.meshgrid(cols, rows))
    one, near = at(px, py, 3.0), at(px + 1, py + 1, 3.0)
    ties = np.concatenate([one, near, one, one[::-1], near])

    ex, ey = np.arange(-2, W + 2, 5), np.arange(-2, H + 2, 5)
    edge_px = np.concatenate([np.tile(ex, 6), np.repeat([-1, 0, 1, W - 2, W - 1, W], len(ey))])
    edge_py = np.concatenate([np.repeat([-1, 0, 1, H - 2, H - 1, H], len(ex)), np.tile(ey, 6)])
    edges = at(edge_px, edge_py, 2.0)

    rng = np.random.default_rng(seed)
    per_tile = cap + cap // 4
    blocks = []
    for y0 in range(0, H, 32):
        for x0 in range(0, W, 128):
            u = rng.uniform(x0, min(x0 + 128, W) - 0.5, per_tile)
            v = rng.uniform(y0, min(y0 + 32, H) - 0.5, per_tile)
            blocks.append(at(u, v, rng.uniform(2.0, 9.0, per_tile)))
    return {
        "ties": (ties, {"point_radius": 1.5 * 3.0 / fx}),
        "edges_r05": (edges, {"point_radius": 0.0}),
        "edges_r4": (edges, {"point_radius": 1.0}),
        "over_cap": (np.concatenate(blocks), {"max_entries_per_tile": cap}),
    }


TRAJ_CASES = ("initial", "moved", "coincident", "collinear", "w1", "w2", "step1", "step3",
              "padded", "blind")


def traj_case(name: str, cloud: np.ndarray, path: np.ndarray, *, n_points: int = 8000,
              target: int = 8192, every: int = 5):
    """A trajectory problem on the reference cloud and path that presses on
    one edge of the trajectory loss (``TRAJ_CASES``). Returns (points (M, 3),
    valid (M,), poses (W, 3), quats (W, 4), poses0, quats0, wps_step): every
    ``every``-th point, the first ``n_points`` of them padded to ``target``,
    stride 2 unless the case says otherwise, the path moved (seeded) off its
    initial positions and some orientations turned, except where named:

    * ``initial``: the initial path, where the anchor and length terms are 0;
    * ``coincident``: waypoints 4, 5 and 6 at one place (zero-length
      segments and a zero cosine);
    * ``collinear``: a straight triple (cosine −1) and a triple folded back
      (+1) with 2 m sides, outside the angle gradient's clamp window;
    * ``w1``, ``w2``: one and two waypoints (no interior angle);
    * ``step1``, ``step3``: every waypoint and every third one scored;
    * ``padded``: a quarter of the points padding, ``valid`` 0;
    * ``blind``: scored waypoint 4 moved 1 km away: it sees nothing, so its
      span is floored and its gate closed.
    """
    sub = cloud[::every][: (6 * n_points) // 8 if name == "padded" else n_points]
    pts, valid = pad_points(sub, target=target)
    path = np.asarray(path, np.float32).copy()
    poses, quats, step = path.copy(), identity_quaternions(len(path)), 2
    if name != "initial":
        rng = np.random.default_rng(7)
        poses = path + rng.normal(scale=0.2, size=path.shape).astype(np.float32)
        quats[::3] = [0.9, 0.1, -0.3, 0.2]
    if name == "coincident":
        poses[5] = poses[6] = poses[4]
    elif name == "collinear":
        poses[10] = poses[9] + [2.0, 0.0, 0.0]
        poses[11] = poses[9] + [4.0, 0.0, 0.0]
        poses[13] = poses[15] = poses[14] + [0.0, 2.0, 0.0]
    elif name in ("w1", "w2"):
        n = 1 if name == "w1" else 2
        path, poses, quats = path[:n], poses[:n], quats[:n]
    elif name in ("step1", "step3"):
        step = int(name[-1])
    elif name == "blind":
        poses[8] = poses[8] + [1000.0, 0.0, 0.0]
    return pts, valid, poses, quats, path, identity_quaternions(len(path)), step


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
