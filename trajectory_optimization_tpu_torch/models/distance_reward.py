"""Distance-reward trajectory model (notebook parity).

Twin of ``trajectory_optimization_tpu/models/distance_reward.py``, the
reference notebook's ModelTraj variant: the per-waypoint observation
probability is a Gaussian of the world-space distance to the waypoint,
exp(−½((‖p−t‖−μ)/σ)²) with μ=3, σ=2, gated by *binary* frustum membership;
camera orientations are 3×3 rotation matrices (not quaternions); smoothness
is available both as mean angle and Menger curvature; the criterion weights
differ from the main model (vis = N/Σrewards, smooth 0.05, length 0.0005).
Batched over waypoints like ``models.traj``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from trajectory_optimization_tpu_torch.ops.hpr import _full_f32_matmul
from trajectory_optimization_tpu_torch.ops.numerics import safe_norm
from trajectory_optimization_tpu_torch.ops.trajectory import (
    mean_segment_angle,
    menger_curvature,
    polyline_length,
)

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DistanceRewardProblem:
    img_width: float
    img_height: float
    min_dist: float = 1.0
    max_dist: float = 10.0
    dist_rewards_mean: float = 3.0
    dist_rewards_sigma: float = 2.0
    smoothness_weight: float = 0.05
    length_weight: float = 0.0005
    eps: float = 1e-6


def init_distance_reward_params(traj0, device="cpu") -> Params:
    """traj (W, 3) and identity rotation matrices (W, 3, 3), the notebook's
    parametrization, as f32 leaf tensors on ``device``."""
    traj = torch.as_tensor(np.asarray(traj0), dtype=torch.float32, device=device).clone()
    rots = torch.eye(3, dtype=torch.float32, device=device).repeat(traj.shape[0], 1, 1)
    return {"traj": traj, "rots": rots}


def gaussian(x, mu: float = 3.0, sigma: float = 100.0, normalize: bool = False):
    """Unnormalized (or normalized) Gaussian bump (notebook ``gaussian``)."""
    g = torch.exp(-0.5 * torch.square((x - mu) / sigma))
    if normalize:
        g = g / (sigma * math.sqrt(2.0 * math.pi))
    return g


def distance_reward_forward(
    params: Params,
    points: torch.Tensor,
    K: torch.Tensor,
    traj0: torch.Tensor,
    problem: DistanceRewardProblem,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss and rewards for the distance-reward variant.

    Per waypoint (batched): cam = Rᵀ(p − t); binary z-range AND pixel-border
    frustum test (strict inequalities, so the products run in full f32,
    TF32 off on the card); observation p = gaussian(‖p_world − t‖) · mask;
    clip to [0.5, 1−eps]; log-odds sum; σ; composite criterion.
    """
    traj, rots = params["traj"], params["rots"]  # (W, 3), (W, 3, 3)
    with _full_f32_matmul(points):
        # cam = Rᵀ (p − t): the columns of R are the camera axes
        cam = (torch.einsum("nj,wjk->wnk", points, rots)
               - torch.einsum("wj,wjk->wk", traj, rots)[:, None, :])
        ph = torch.matmul(cam, K.T)
    zc = cam[..., 2]
    dist_mask = (zc > problem.min_dist) & (zc < problem.max_dist)
    u = ph[..., 0] / ph[..., 2]
    v = ph[..., 1] / ph[..., 2]
    fov_mask = ((ph[..., 2] > 0) & (u > 1) & (u < problem.img_width - 1)
                & (v > 1) & (v < problem.img_height - 1))
    mask = dist_mask & fov_mask  # (W, N)

    dists = safe_norm(points[None, :, :] - traj[:, None, :], dim=-1)  # world space
    p = gaussian(dists, problem.dist_rewards_mean, problem.dist_rewards_sigma) * mask
    p = torch.clamp(p, 0.5, 1.0 - problem.eps)
    lo_sum = torch.sum(torch.log(p / (1.0 - p)), dim=0)
    rewards = 1.0 / (1.0 + torch.exp(-lo_sum))

    loss_vis = points.shape[0] / (torch.sum(rewards) + problem.eps)
    loss_l2 = safe_norm(traj[0] - traj0[0])
    loss_smooth = problem.smoothness_weight / (
        mean_segment_angle(traj, problem.eps) + problem.eps)
    # |·| with derivative 1 at 0, as jnp.abs has (torch.abs has 0): on the
    # initial path the difference is exactly 0
    dlen = polyline_length(traj) - polyline_length(traj0)
    loss_length = problem.length_weight * torch.where(dlen >= 0, dlen, -dlen)
    loss = loss_vis + loss_l2 + loss_length + loss_smooth
    return loss, {
        "rewards": rewards,
        "loss_vis": loss_vis,
        "loss_l2": loss_l2,
        "loss_smooth": loss_smooth,
        "loss_length": loss_length,
        "mean_curvature": torch.mean(menger_curvature(traj, problem.eps)),
        "mean_reward": torch.mean(rewards),
    }
