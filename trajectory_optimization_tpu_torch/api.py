"""High-level facade: one-call trajectory optimization.

Twin of ``trajectory_optimization_tpu/api.py`` (``TrajResult``,
``TrajectoryOptimizer.optimize``): automatic padding and shape bucketing
(one cached runner per bucket), warm start from a previous solution, and a
structured result. ``evaluate`` and ``PoseOptimizer`` come in later work.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from trajectory_optimization_tpu_torch.models.traj import (
    TrajProblem,
    init_traj_params,
    waypoint_stride,
)
from trajectory_optimization_tpu_torch.opt.engine import NEVER, EarlyStop, OptimizerConfig
from trajectory_optimization_tpu_torch.opt.runners import traj_runner
from trajectory_optimization_tpu_torch.utils.convert import params_from_numpy
from trajectory_optimization_tpu_torch.utils.data import identity_quaternions, pad_points
from trajectory_optimization_tpu_torch.utils.intrinsics import CameraIntrinsics, default_intrinsics


@dataclasses.dataclass
class TrajResult:
    poses: np.ndarray  # (W, 3) optimized waypoint positions
    quats_wxyz: np.ndarray  # (W, 4) optimized (normalized) orientations
    rewards: np.ndarray  # (N,) per-point observation probability
    n_iters: int
    loss: float
    visibility_gain: float
    smoothness_gain: float


class TrajectoryOptimizer:
    """Reusable trajectory optimizer; runs on ``device`` (the card by default)."""

    def __init__(
        self,
        intrinsics: Optional[CameraIntrinsics] = None,
        *,
        min_dist: float = 1.0,
        max_dist: float = 5.0,
        smoothness_weight: float = 14.0,
        length_weight: float = 0.02,
        lr_pose: float = 0.1,
        lr_quat: float = 0.0,
        vis_wps_dist: float = 0.5,
        backend: str = "auto",
        soft_hpr: bool = False,
        device="cuda",
    ):
        self.intr = intrinsics or default_intrinsics()
        self.min_dist, self.max_dist = min_dist, max_dist
        self.smoothness_weight, self.length_weight = smoothness_weight, length_weight
        self.opt_cfg = OptimizerConfig(lr_pose=lr_pose, lr_quat=lr_quat)
        self.vis_wps_dist = vis_wps_dist
        self.backend = backend
        self.soft_hpr = soft_hpr
        self.device = torch.device(device)

    def optimize(
        self,
        points: np.ndarray,
        path: np.ndarray,
        quats_wxyz: Optional[np.ndarray] = None,
        *,
        n_steps: int = 400,
        early_stop: Optional[EarlyStop] = None,
        warm_start: Optional[Mapping[str, np.ndarray]] = None,
    ) -> TrajResult:
        """Optimize a (W, 3) path against an (N, 3) cloud. ``warm_start`` is a
        {"poses", "quats"} dict of arrays (see ``utils.convert``)."""
        points = np.asarray(points, np.float32)
        path = np.asarray(path, np.float32)
        if quats_wxyz is None:
            quats_wxyz = identity_quaternions(len(path))
        padded, valid = pad_points(points)

        dev = self.device
        problem = self._traj_problem(path)
        P = torch.as_tensor(padded, device=dev)
        V = torch.as_tensor(valid, device=dev)
        K = self.intr.matrix(device=dev)
        p0 = torch.as_tensor(path, device=dev)
        q0 = torch.as_tensor(np.asarray(quats_wxyz, np.float32), device=dev)

        run = traj_runner(problem, self.opt_cfg, early_stop or NEVER, int(n_steps))
        if warm_start is not None:
            params = params_from_numpy(warm_start, dev)
        else:
            params = init_traj_params(path, quats_wxyz, dev)
        params, n_iters, loss, aux = run(params, P, V, K, p0, q0)
        scalars = torch.stack([
            loss, aux["mean_reward"], aux["reward0"], aux["loss_smooth"], aux["smooth0"]
        ]).double().cpu().numpy()
        loss_f, mean_reward, reward0, loss_smooth, smooth0 = (float(x) for x in scalars)

        quats = params["quats"].double().cpu().numpy()
        quats = quats / np.linalg.norm(quats, axis=1, keepdims=True)
        return TrajResult(
            poses=params["poses"].double().cpu().numpy(),
            quats_wxyz=quats,
            rewards=aux["rewards"].cpu().numpy()[: len(points)],
            n_iters=int(n_iters),
            loss=loss_f,
            visibility_gain=mean_reward / max(reward0, 1e-9),
            smoothness_gain=smooth0 / max(loss_smooth, 1e-9),
        )

    def _traj_problem(self, path) -> TrajProblem:
        return TrajProblem(
            img_width=self.intr.width,
            img_height=self.intr.height,
            min_dist=self.min_dist,
            max_dist=self.max_dist,
            smoothness_weight=self.smoothness_weight,
            length_weight=self.length_weight,
            wps_step=waypoint_stride(path, self.vis_wps_dist),
            soft_hpr=self.soft_hpr,
            backend=self.backend,
        )
