"""Waypoint visibility scores in SoA layout.

Twin of ``trajectory_optimization_tpu/ops/scores.py``: the (W, N) smooth
visibility scores dist·fov for W camera poses over N points, as (W, N)
camera-frame planes. Same formulas, term for term: the scalar-centre
distance Gaussian exp(−½ Σ_c (cam_c − c₀)²/σ²), the sigmoid(z) factor, the
sign-preserving 1e-12 floor on z + eps, and the ±20 clamp on the normalized
pixel coordinates. These are the autodiff path of ``models.traj`` (backend
"torch") and the building blocks of the fused kernels' plain versions.
"""
from __future__ import annotations

from typing import Tuple

import torch

from trajectory_optimization_tpu_torch.ops import quat as quat_ops


def camera_frames(quats: torch.Tensor, trans: torch.Tensor):
    """(W,4),(W,3) → rotation matrices (W,3,3) and t·R (W,3)."""
    R = quat_ops.to_matrix(quat_ops.normalize(quats))
    tR = torch.einsum("wj,wjc->wc", trans, R)
    return R, tR


def camera_planes(
    points: torch.Tensor, quats: torch.Tensor, trans: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Camera-frame coordinates cam = (p − t) @ R of N points under W poses,
    as three (W, N) planes."""
    px, py, pz = points[:, 0], points[:, 1], points[:, 2]
    R, tR = camera_frames(quats, trans)
    cx = (
        px[None, :] * R[:, 0, 0, None]
        + py[None, :] * R[:, 1, 0, None]
        + pz[None, :] * R[:, 2, 0, None]
        - tR[:, 0, None]
    )
    cy = (
        px[None, :] * R[:, 0, 1, None]
        + py[None, :] * R[:, 1, 1, None]
        + pz[None, :] * R[:, 2, 1, None]
        - tR[:, 1, None]
    )
    cz = (
        px[None, :] * R[:, 0, 2, None]
        + py[None, :] * R[:, 1, 2, None]
        + pz[None, :] * R[:, 2, 2, None]
        - tR[:, 2, None]
    )
    return cx, cy, cz


def waypoint_scores(
    points: torch.Tensor,
    quats: torch.Tensor,
    trans: torch.Tensor,
    K: torch.Tensor,
    img_width: float,
    img_height: float,
    *,
    min_dist: float = 1.0,
    max_dist: float = 5.0,
    eps: float = 1e-6,
) -> torch.Tensor:
    """(W, N) smooth visibility scores (dist mask × FOV mask).

    points (N, 3) world points; quats (W, 4) wxyz; trans (W, 3); K (3, 3)
    intrinsics (only fx, fy, cx, cy are read).
    """
    cx, cy, cz = camera_planes(points, quats, trans)
    return scores_from_planes(
        cx, cy, cz, K, img_width, img_height, min_dist=min_dist, max_dist=max_dist, eps=eps
    )


def scores_from_planes(
    cx: torch.Tensor,
    cy: torch.Tensor,
    cz: torch.Tensor,
    K: torch.Tensor,
    img_width: float,
    img_height: float,
    *,
    min_dist: float = 1.0,
    max_dist: float = 5.0,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Scores from precomputed (W, N) camera-frame planes."""
    c0 = (min_dist + max_dist) / 2.0
    inv_var = 1.0 / ((max_dist - min_dist) / 2.0) ** 2
    d2 = torch.square(cx - c0) + torch.square(cy - c0) + torch.square(cz - c0)
    dm = torch.exp(-0.5 * d2 * inv_var)

    fx, fy = K[0, 0], K[1, 1]
    cx0, cy0 = K[0, 2], K[1, 2]
    u = fx * cx + cx0 * cz
    v = fy * cy + cy0 * cz
    zd = cz + eps
    zd = torch.where(zd >= 0, torch.clamp(zd, min=1e-12), torch.clamp(zd, max=-1e-12))
    xu = torch.clamp((u / zd - img_width / 2.0) / img_width, -20.0, 20.0)
    xv = torch.clamp((v / zd - img_height / 2.0) / img_height, -20.0, 20.0)
    fm = torch.sigmoid(cz) * torch.exp(-0.5 * (torch.square(xu) + torch.square(xv)))
    return dm * fm
