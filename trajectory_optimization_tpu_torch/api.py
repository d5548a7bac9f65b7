"""High-level facade: one-call trajectory and pose optimization.

Twin of ``trajectory_optimization_tpu/api.py``: ``TrajectoryOptimizer``
(``optimize``, ``evaluate`` of a fixed path through ``models.evaluate``) and
``PoseOptimizer``, with automatic padding and shape bucketing (one cached
runner per bucket), warm start from a previous solution and structured
results. Both run on the card unless the caller passes ``device="cpu"``.
The HPR options (``soft_hpr``, ``PoseOptimizer(use_hpr=True)``) run through
``ops/hpr.py``; soft HPR takes the dense tier up to ``soft_hpr_dense_max``
points and the direction-binned tier above it. Each ``optimize`` call is the
span ``utils.profiling.FACADE_OPTIMIZE``, its host work before and after
the runner ``FACADE_PREPARE`` and ``FACADE_FETCH``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from trajectory_optimization_tpu_torch.models.evaluate import TrajEvalResult, evaluate_trajectory
from trajectory_optimization_tpu_torch.models.pose import PoseProblem, init_pose_params
from trajectory_optimization_tpu_torch.models.traj import (
    TrajProblem,
    init_traj_params,
    waypoint_stride,
)
from trajectory_optimization_tpu_torch.ops.hpr import hpr_mask_approx
from trajectory_optimization_tpu_torch.opt.engine import NEVER, EarlyStop, OptimizerConfig
from trajectory_optimization_tpu_torch.opt.runners import pose_runner, traj_runner
from trajectory_optimization_tpu_torch.utils.convert import params_from_numpy
from trajectory_optimization_tpu_torch.utils.data import identity_quaternions, pad_points
from trajectory_optimization_tpu_torch.utils.intrinsics import CameraIntrinsics, default_intrinsics
from trajectory_optimization_tpu_torch.utils.profiling import (
    FACADE_FETCH,
    FACADE_OPTIMIZE,
    FACADE_PREPARE,
    span,
)


@dataclasses.dataclass
class TrajResult:
    poses: np.ndarray  # (W, 3) optimized waypoint positions
    quats_wxyz: np.ndarray  # (W, 4) optimized (normalized) orientations
    rewards: np.ndarray  # (N,) per-point observation probability
    n_iters: int
    loss: float
    visibility_gain: float
    smoothness_gain: float


@dataclasses.dataclass
class PoseResult:
    position: np.ndarray  # (3,)
    quat_wxyz: np.ndarray  # (4,) normalized
    observations: np.ndarray  # (N,)
    n_iters: int
    loss: float


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
        with span(FACADE_OPTIMIZE):
            with span(FACADE_PREPARE):
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
            with span(FACADE_FETCH):
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

    def _traj_problem(self, path, wps_step=None) -> TrajProblem:
        """The one place the facade builds its TrajProblem, so that optimize
        and evaluate build identical problems. ``wps_step`` overrides the
        stride computed from ``path`` (pass the initial path's stride when
        evaluating an optimized path, so that both censuses select the same
        waypoints)."""
        return TrajProblem(
            img_width=self.intr.width,
            img_height=self.intr.height,
            min_dist=self.min_dist,
            max_dist=self.max_dist,
            smoothness_weight=self.smoothness_weight,
            length_weight=self.length_weight,
            wps_step=int(wps_step) if wps_step is not None
            else waypoint_stride(path, self.vis_wps_dist),
            soft_hpr=self.soft_hpr,
            backend=self.backend,
        )

    def evaluate(self, points, path, quats_wxyz=None, *, wps_step=None) -> TrajEvalResult:
        """Score a fixed path (the reference README's "Trajectory
        Evaluation"): one no-grad forward on ``device`` returning the
        observed-point census and the fused rewards, with the padding of
        ``optimize``. When comparing an optimized path with its initial one,
        pass the initial path's ``wps_step`` (``models.traj.waypoint_stride``)
        to both calls."""
        points = np.asarray(points, np.float32)
        path = np.asarray(path, np.float32)
        if quats_wxyz is None:
            quats_wxyz = identity_quaternions(len(path))
        padded, valid = pad_points(points)
        res = evaluate_trajectory(
            padded, path, np.asarray(quats_wxyz, np.float32), self.intr.matrix_np(),
            self._traj_problem(path, wps_step), valid=valid, device=self.device,
        )
        res.rewards = res.rewards[: len(points)]
        return res


class PoseOptimizer:
    """Reusable single-pose optimizer; runs on ``device`` (the card by default)."""

    def __init__(
        self,
        intrinsics: Optional[CameraIntrinsics] = None,
        *,
        min_dist: float = 1.0,
        max_dist: float = 5.0,
        lr_pose: float = 0.1,
        lr_quat: float = 0.0,
        use_hpr: bool = False,
        soft_hpr: bool = False,
        device="cuda",
    ):
        """``use_hpr`` gates the loss with a hard occlusion mask computed
        once, by ``hpr_mask_approx`` on the world-frame cloud (the
        reference's behaviour, its quirk included). ``soft_hpr`` instead
        differentiates through Katz occlusion of the camera-frame cloud,
        recomputed every step (dense up to ``soft_hpr_dense_max`` points,
        direction-binned above)."""
        self.intr = intrinsics or default_intrinsics()
        self.problem_kw = dict(min_dist=min_dist, max_dist=max_dist, soft_hpr=soft_hpr)
        self.opt_cfg = OptimizerConfig(lr_pose=lr_pose, lr_quat=lr_quat)
        self.use_hpr = use_hpr
        self.device = torch.device(device)

    def optimize(
        self,
        points: np.ndarray,
        position: np.ndarray,
        quat_wxyz: np.ndarray = (1.0, 0.0, 0.0, 0.0),
        *,
        n_steps: int = 200,
    ) -> PoseResult:
        """Optimize one camera pose against an (N, 3) cloud for ``n_steps``
        Adam steps. ``loss`` and ``observations`` are those of the last
        step's forward, before its update."""
        with span(FACADE_OPTIMIZE):
            with span(FACADE_PREPARE):
                points = np.asarray(points, np.float32)
                padded, valid = pad_points(points)
                problem = PoseProblem(
                    img_width=self.intr.width, img_height=self.intr.height, **self.problem_kw
                )
                dev = self.device
                P = torch.as_tensor(padded, device=dev)
                V = torch.as_tensor(valid, device=dev)
                K = self.intr.matrix(device=dev)
                # on the bucket-padded cloud, valid-masked, as the JAX twin runs it
                occlusion = hpr_mask_approx(P, valid=V) if self.use_hpr else None

                init_opt, advance = pose_runner(problem, self.opt_cfg, int(n_steps))
                params = init_pose_params(np.asarray(position, np.float32)[None],
                                          np.asarray(quat_wxyz, np.float32)[None], dev)
                opt_state = init_opt(params)
            params, _, loss, aux = advance(params, opt_state, P, V, K, occlusion)
            with span(FACADE_FETCH):
                # one device-to-host copy for all results
                f = torch.cat([
                    params["trans"].reshape(3), params["quat"].reshape(4), loss.reshape(1),
                    aux["observations"],
                ]).cpu().numpy()
                q = f[3:7].astype(np.float64)
                return PoseResult(
                    position=f[:3].astype(np.float64),
                    quat_wxyz=q / np.linalg.norm(q),
                    observations=f[8:8 + len(points)],
                    n_iters=int(n_steps),
                    loss=float(f[7]),
                )
