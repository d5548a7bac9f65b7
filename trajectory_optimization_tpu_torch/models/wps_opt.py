"""Waypoints Optimization: per-waypoint X/Y/yaw camera-pose refinement.

Twin of ``trajectory_optimization_tpu/models/wps_opt.py`` (the reference
README's "Waypoints Optimization" demo): the single-pose visibility
objective run once per waypoint of an initial path, with the pose
restricted to planar translation and a rotation about the world vertical.

The problems share no parameters and no loss terms, and Adam's update is
elementwise, so all W waypoints optimize in one batched program, the loss
summed over waypoints: the gradient of the sum with respect to waypoint w's
parameters is that of waypoint w's own loss, and the optimum of each
waypoint is the one a loop of single-pose problems would reach.

Yaw is one angle per waypoint, applied about the world z axis on top of the
waypoint's frozen base orientation, ``q_w = qz(yaw_w) ⊗ q0_w``; roll, pitch
and the z coordinate stay at their initial values.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from trajectory_optimization_tpu_torch.models.traj import capture_route, gated_waypoint_scores
from trajectory_optimization_tpu_torch.ops import quat as quat_ops
from trajectory_optimization_tpu_torch.ops.scores import waypoint_scores
from trajectory_optimization_tpu_torch.opt.engine import EarlyStop, OptimizerConfig, _optimize
from trajectory_optimization_tpu_torch.opt.graphs import device_route

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class WpsOptProblem:
    """Static problem description for per-waypoint X/Y/yaw pose refinement.

    The visibility knobs mirror ``PoseProblem``; ``soft_hpr`` gates each
    waypoint's scores with the differentiable Katz HPR on that waypoint's
    camera-frame cloud (the binned tier above ``soft_hpr_dense_max`` points,
    with ``hpr_cap`` and ``hpr_safety``)."""

    img_width: float
    img_height: float
    min_dist: float = 1.0
    max_dist: float = 5.0
    eps: float = 1e-6
    soft_hpr: bool = False
    soft_hpr_dense_max: int = 32768
    hpr_cap: int = 1024
    hpr_safety: float = 3.0


def init_wps_params(poses0, quats0, device="cpu") -> Tuple[Params, Params]:
    """Split an initial (W, 3) path and its (W, 4) wxyz orientations into
    optimizable and frozen f32 tensors on ``device``: params {'xy': (W, 2),
    'yaw': (W,) zeros, an offset from the base orientation}, frozen {'z':
    (W,), 'quats0': (W, 4)}."""
    poses0 = torch.as_tensor(np.asarray(poses0), dtype=torch.float32, device=device).reshape(-1, 3)
    quats0 = torch.as_tensor(np.asarray(quats0), dtype=torch.float32, device=device).reshape(-1, 4)
    params = {"xy": poses0[:, :2].clone(),
              "yaw": torch.zeros(poses0.shape[0], dtype=torch.float32, device=device)}
    frozen = {"z": poses0[:, 2].clone(), "quats0": quats0.clone()}
    return params, frozen


def wps_path(params: Params, frozen: Params) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full (W, 3) positions and (W, 4) wxyz quaternions from X/Y/yaw and
    the frozen z and base orientations: the refined path callers publish."""
    trans = torch.cat([params["xy"], frozen["z"][:, None]], dim=-1)
    half = 0.5 * params["yaw"]
    zero = torch.zeros_like(half)
    qz = torch.stack([torch.cos(half), zero, zero, torch.sin(half)], dim=-1)  # about world z
    return trans, quat_ops.multiply(qz, frozen["quats0"])


def wps_forward(
    params: Params,
    frozen: Params,
    points: torch.Tensor,
    K: torch.Tensor,
    problem: WpsOptProblem,
    *,
    valid: Optional[torch.Tensor] = None,
    occlusion_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Summed per-waypoint single-pose visibility loss.

    Returns (loss, aux): loss = Σ_w 1/(Σ_n mask_wn + eps); aux carries
    'losses' (W,), 'observations' (W, N) and 'mean_reward' (the mean over
    waypoints of each waypoint's summed observations). With ``soft_hpr``
    each waypoint's gate is one ``torch.utils.checkpoint``: the backward
    recomputes it, so the live set stays O(N) whatever W is.
    """
    trans, quats = wps_path(params, frozen)
    if problem.soft_hpr:
        mask = torch.stack([
            checkpoint(gated_waypoint_scores, q, t, points, K, problem, valid,
                       use_reentrant=False, preserve_rng_state=False)
            for q, t in zip(quats, trans)
        ])
    else:
        mask = waypoint_scores(
            points, quats, trans, K, problem.img_width, problem.img_height,
            min_dist=problem.min_dist, max_dist=problem.max_dist, eps=problem.eps,
        )  # (W, N)
    if occlusion_mask is not None:
        mask = mask * occlusion_mask[None, :]
    if valid is not None:
        mask = mask * valid[None, :]
    per_wp_obs = torch.sum(mask, dim=-1)
    losses = 1.0 / (per_wp_obs + problem.eps)
    aux = {"losses": losses, "observations": mask, "mean_reward": torch.mean(per_wp_obs)}
    return torch.sum(losses), aux


def optimize_waypoints(
    points,
    poses0,
    quats0,
    K,
    problem: WpsOptProblem,
    *,
    n_steps: int = 100,
    lr_xy: float = 0.02,
    lr_yaw: float = 0.02,
    valid=None,
    occlusion_mask=None,
    device="cuda",
):
    """One-call waypoint refinement on ``device`` (the card unless the
    caller passes ``"cpu"``): returns (poses (W, 3), quats (W, 4) wxyz,
    aux) as tensors on the device.

    ``n_steps`` steps of the two-group Adam engine (``lr_xy`` on positions,
    ``lr_yaw`` on headings), a fixed-length run, captured on the card unless
    the binned soft tier routes it eagerly (``capture_route``); aux is the
    final forward's plus 'losses0', the initial per-waypoint losses, for
    per-waypoint visibility gains (losses0 / losses).
    """
    as_dev = lambda x: None if x is None else torch.as_tensor(  # noqa: E731
        np.asarray(x) if not torch.is_tensor(x) else x, dtype=torch.float32, device=device)
    points, K = as_dev(points), as_dev(K)
    valid, occlusion_mask = as_dev(valid), as_dev(occlusion_mask)
    params, frozen = init_wps_params(poses0, quats0, device)

    def loss_fn(p):
        return wps_forward(p, frozen, points, K, problem, valid=valid,
                           occlusion_mask=occlusion_mask)

    with torch.no_grad():
        _, aux0 = loss_fn(params)
    # fixed length: the engine's gain tracker needs aux keys, so both point
    # at mean_reward, with thresholds that never trigger
    stop = EarlyStop(rewards_th=float("inf"), smoothness_th=float("inf"),
                     reward_key="mean_reward", smooth_key="mean_reward")
    route = device_route(points.device, capture_route(problem, points.shape[0]))
    params, _, _ = _optimize(loss_fn, params, OptimizerConfig(lr_pose=lr_xy, lr_quat=lr_yaw),
                             n_steps, route=route, early_stop=stop, pose_key="xy",
                             quat_key="yaw")
    trans, quats = wps_path(params, frozen)
    with torch.no_grad():
        _, aux = loss_fn(params)
    aux = dict(aux)
    aux["losses0"] = aux0["losses"]
    return trans, quats, aux
