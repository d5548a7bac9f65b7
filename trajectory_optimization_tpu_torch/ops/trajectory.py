"""Trajectory geometry metrics, vectorized.

Twin of ``trajectory_optimization_tpu/ops/trajectory.py``: polyline length,
mean inter-segment angle and Menger curvature as shifted differences and
reductions over the (W, 3) waypoints.
"""
from __future__ import annotations

import math

import torch

from trajectory_optimization_tpu_torch.ops.numerics import acos_clipped, safe_norm


def polyline_length(traj: torch.Tensor) -> torch.Tensor:
    """Total length of the polyline through waypoints (W, 3); zero
    subgradient for coincident consecutive waypoints."""
    seg = traj[1:] - traj[:-1]
    return torch.sum(safe_norm(seg, dim=-1))


def mean_segment_angle(traj: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Mean angle at interior waypoints: arccos(AB·AC/(‖AB‖‖AC‖+eps)), with
    AB = pᵢ₋₁ − pᵢ, AC = pᵢ₊₁ − pᵢ; π for a straight line. A path of fewer
    than 3 waypoints has no interior angle and reports π."""
    if traj.shape[0] < 3:
        return torch.full((), math.pi, dtype=traj.dtype, device=traj.device)  # no host copy
    ab = traj[:-2] - traj[1:-1]
    ac = traj[2:] - traj[1:-1]
    cos = torch.sum(ab * ac, dim=-1) / (safe_norm(ab, dim=-1) * safe_norm(ac, dim=-1) + eps)
    phi = acos_clipped(cos)
    return torch.sum(phi) / (traj.shape[0] - 2)


def menger_curvature(traj: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(W-2,) Menger curvatures 4·Area/(abc) at the interior waypoints."""
    p1, p2, p3 = traj[:-2], traj[1:-1], traj[2:]
    a = torch.linalg.norm(p2 - p1, dim=-1)
    b = torch.linalg.norm(p3 - p2, dim=-1)
    c = torch.linalg.norm(p3 - p1, dim=-1)
    cross = torch.linalg.cross(p2 - p1, p3 - p1, dim=-1)
    area = 0.5 * torch.linalg.norm(cross, dim=-1)
    return 4.0 * area / (a * b * c + eps)
