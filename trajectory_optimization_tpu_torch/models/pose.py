"""Single-pose visibility optimization model.

Twin of ``trajectory_optimization_tpu/models/pose.py``: a pure function of
the parameters {'trans': (1,3), 'quat': (1,4) wxyz}; the loss is
1/(Σ observations + eps). The score is ``ops.scores.waypoint_scores`` at a
single waypoint, plain PyTorch: the JAX pose path is XLA and reaches no
Pallas kernel, so this model has no kernel of its own.

Occlusion gating takes a precomputed per-point ``occlusion_mask`` (the
reference recomputes Katz HPR on detached world-frame points every step, a
constant). ``soft_hpr=True`` instead gates the score with the differentiable
soft HPR on the camera-frame points, inside the loss: ``ops.hpr.hpr_mask_soft``
up to ``soft_hpr_dense_max`` points, ``hpr_mask_soft_binned`` above it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from trajectory_optimization_tpu_torch.models.traj import gated_waypoint_scores
from trajectory_optimization_tpu_torch.ops.scores import waypoint_scores

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PoseProblem:
    """Static (hashable) problem description for a single-pose optimization.
    The fields, their order and their defaults are the JAX twin's; the three
    knobs after ``soft_hpr`` are read with ``soft_hpr=True`` only:
    ``soft_hpr_dense_max`` picks the tier, ``hpr_cap`` and ``hpr_safety``
    are the binned tier's."""

    img_width: float
    img_height: float
    min_dist: float = 1.0
    max_dist: float = 5.0
    eps: float = 1e-6
    soft_hpr: bool = False
    soft_hpr_dense_max: int = 32768
    hpr_cap: int = 1024
    hpr_safety: float = 3.0


def init_pose_params(trans0, quat0, device="cpu") -> Params:
    """Parameters from an initial (1,3) translation and (1,4) wxyz quaternion,
    as f32 leaf tensors on ``device``."""
    return {
        "trans": torch.as_tensor(np.asarray(trans0), dtype=torch.float32,
                                 device=device).reshape(1, 3).clone(),
        "quat": torch.as_tensor(np.asarray(quat0), dtype=torch.float32,
                                device=device).reshape(1, 4).clone(),
    }


def pose_forward(
    params: Params,
    points: torch.Tensor,
    K: torch.Tensor,
    problem: PoseProblem,
    *,
    valid: Optional[torch.Tensor] = None,
    occlusion_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss and observations for one camera pose.

    Args:
      params: {'trans': (1,3), 'quat': (1,4) wxyz}.
      points: (N, 3) world points (padded entries allowed).
      K: (3, 3) intrinsics.
      valid: optional (N,) 0/1 mask of real (non-padding) points.
      occlusion_mask: optional (N,) visibility gate from HPR.

    Returns:
      (loss, aux) with aux['observations'] the (N,) per-point scores (the
      reference's rewards-cloud intensity channel).
    """
    if problem.soft_hpr:
        mask = gated_waypoint_scores(params["quat"][0], params["trans"][0], points, K, problem,
                                     valid)
    else:
        mask = waypoint_scores(
            points, params["quat"], params["trans"], K, problem.img_width, problem.img_height,
            min_dist=problem.min_dist, max_dist=problem.max_dist, eps=problem.eps,
        )[0]
    if occlusion_mask is not None:
        mask = occlusion_mask * mask
    if valid is not None:
        mask = mask * valid
    loss = 1.0 / (torch.sum(mask) + problem.eps)
    return loss, {"observations": mask}
