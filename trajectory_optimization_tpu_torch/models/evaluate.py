"""Trajectory Evaluation: visibility scoring of a FIXED camera trajectory.

Twin of ``trajectory_optimization_tpu/models/evaluate.py``. Evaluation is one
forward of the trajectory model without gradients (``traj_forward``, on the
backend ``TrajProblem.backend`` picks: the fused kernels on CUDA tensors),
plus the observed-point census: with the [0.5, 1−eps] observation clip a
point that no waypoint sees sums zero log-odds and lands at exactly
σ(0) = 0.5, so "observed" is the strict test reward > 0.5 on real points.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from trajectory_optimization_tpu_torch.models.traj import TrajProblem, traj_forward
from trajectory_optimization_tpu_torch.ops.trajectory import mean_segment_angle, polyline_length


@dataclasses.dataclass
class TrajEvalResult:
    """Host-side evaluation summary of one trajectory against one cloud."""

    rewards: np.ndarray  # (N,) fused per-point observation probability
    n_observed: int  # points with reward > 0.5 (the README's voxel count)
    frac_observed: float  # n_observed / n_real_points
    mean_reward: float  # mean fused probability over real points
    length: float  # polyline length of the trajectory
    mean_angle: float  # mean inter-segment angle (higher = straighter)
    loss_vis: float  # 1/(mean_reward + eps), the optimizer's visibility term
    loss_smooth: float  # smoothness term at the problem's weight


def evaluate_trajectory(
    points,
    poses,
    quats,
    K,
    problem: TrajProblem,
    *,
    valid=None,
    device="cuda",
) -> TrajEvalResult:
    """Score a fixed (W, 3)/(W, 4 wxyz) trajectory against an (N, 3) cloud
    on ``device``: one no-grad forward and one device-to-host copy of its
    eight results. ``problem.wps_step`` selects the evaluated waypoints as
    optimization would; ``valid`` marks the real points of a padded cloud."""
    dev = torch.device(device)

    def on_dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    P, p0, q0, Kt = on_dev(points), on_dev(poses), on_dev(quats), on_dev(K)
    V = None if valid is None else on_dev(valid)
    with torch.no_grad():
        # poses0/quats0 = the evaluated path itself: the anchor and length
        # terms vanish and aux carries the pure visibility/smoothness numbers
        _, aux = traj_forward({"poses": p0, "quats": q0}, P, Kt, p0, q0, problem, valid=V)
        rewards = aux["rewards"]
        observed = rewards > 0.5
        if V is None:
            n_real = torch.tensor(float(P.shape[0]), device=dev)
        else:
            observed = observed & (V > 0)
            n_real = torch.clamp(torch.sum(V), min=1.0)
        n_observed = torch.sum(observed)  # int64: exact in the float64 copy below
        scalars = torch.stack([
            n_observed.double(), *(x.double() for x in (
                n_observed / n_real, aux["mean_reward"], polyline_length(p0),
                mean_segment_angle(p0, problem.eps), aux["loss_vis"], aux["loss_smooth"])),
        ])
        # one device-to-host copy: the rewards and the seven scalars together
        host = torch.cat([rewards.double(), scalars]).cpu().numpy()
    n = rewards.shape[0]
    n_obs, frac, mean_reward, length, mean_angle, loss_vis, loss_smooth = host[n:]
    return TrajEvalResult(
        rewards=host[:n].astype(np.float32),
        n_observed=int(n_obs),
        frac_observed=float(frac),
        mean_reward=float(mean_reward),
        length=float(length),
        mean_angle=float(mean_angle),
        loss_vis=float(loss_vis),
        loss_smooth=float(loss_smooth),
    )
