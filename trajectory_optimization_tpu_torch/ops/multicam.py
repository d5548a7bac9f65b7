"""Batched multi-camera visibility processing.

Twin of ``trajectory_optimization_tpu/ops/multicam.py``: the camera axis of
a rig is the leading batch axis of the scorer and of the frustum cull, so C
cameras are one batched evaluation. Used by ``PointsProcessorNode``'s rig
path and available directly.
"""
from __future__ import annotations

from typing import Tuple

import torch

from trajectory_optimization_tpu_torch.ops.geometry import frustum_cull, to_camera_frame
from trajectory_optimization_tpu_torch.ops.scores import waypoint_scores


def multicam_scores(
    points: torch.Tensor,
    cam_quats: torch.Tensor,
    cam_trans: torch.Tensor,
    K: torch.Tensor,
    img_width: float,
    img_height: float,
    *,
    min_dist: float = 1.0,
    max_dist: float = 5.0,
    eps: float = 1e-6,
) -> torch.Tensor:
    """(C, N) smooth visibility scores for C cameras (shared intrinsics):
    cameras are waypoints to the scorer."""
    return waypoint_scores(
        points, cam_quats, cam_trans, K, img_width, img_height,
        min_dist=min_dist, max_dist=max_dist, eps=eps,
    )


def multicam_frustum_masks(
    points: torch.Tensor,
    cam_quats: torch.Tensor,
    cam_trans: torch.Tensor,
    K: torch.Tensor,
    img_width: float,
    img_height: float,
    *,
    min_dist: float = 1.0,
    max_dist: float = 15.0,
) -> torch.Tensor:
    """(C, N) boolean hard-frustum masks for C cameras in one batched pass,
    through the same ``frustum_cull`` as the per-camera path."""
    cam = to_camera_frame(points, cam_quats, cam_trans)  # (C, N, 3)
    return frustum_cull(
        cam, K, img_width, img_height, min_dist=min_dist, max_dist=max_dist
    )[0]


def combined_coverage(
    points: torch.Tensor,
    cam_quats: torch.Tensor,
    cam_trans: torch.Tensor,
    K: torch.Tensor,
    img_width: float,
    img_height: float,
    *,
    min_dist: float = 1.0,
    max_dist: float = 5.0,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-point coverage (N,), per-camera mean score (C,)): the log-odds
    fusion of the per-camera smooth scores across the rig."""
    s = multicam_scores(
        points, cam_quats, cam_trans, K, img_width, img_height,
        min_dist=min_dist, max_dist=max_dist, eps=eps,
    )
    p = torch.clamp(s, 0.5, 1.0 - eps)
    lo = torch.log(p / (1.0 - p))
    coverage = 1.0 / (1.0 + torch.exp(-torch.sum(lo, dim=0)))
    return coverage, torch.mean(s, dim=1)
