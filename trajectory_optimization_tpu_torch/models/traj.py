"""Trajectory visibility optimization model.

Twin of ``trajectory_optimization_tpu/models/traj.py``. The selected
waypoints are a leading batch axis of one visibility evaluation and the
log-odds fusion is a sum over it:

  1. waypoint subsampling by stride ⌊vis_wps_dist / mean Δwp of the initial
     path⌋ + 1 (static);
  2. per-waypoint observation probability = dist·fov score, min-max
     normalized over the valid points (span floored at 1e-8), clipped to
     [0.5, 1−eps];
  3. log-odds summed over waypoints; rewards = σ(Σ log-odds);
  4. loss = 1/(mean reward + eps) + ‖p₀ − p₀⁰‖ + w_s/(mean angle + eps)
     + w_l·|len − len⁰|.

Backends of ``traj_forward``: ``"kernel"`` runs the whole loss as one
autograd function, ``ops.fused_traj.fused_traj``: six kernels of its own
(``csrc/fused_traj.cu``: the quaternion prologue, the criterion over the
points and over the waypoints, and their hand-derived backward) around the
fused visibility kernels (``ops.fused_vis``): K1–K4 while the (W_s, N) score
cache fits its budget, K1′, K2′ and K5 above it, decided from W_s × N alone
(``fused_vis.uses_score_cache``); the scored stride, W < 3 (no interior
angle) and padded points (``valid``) are read from the inputs. CUDA tensors
launch the kernels, CPU tensors run their plain versions. A step of it is
ten launches (nine above the budget, K5's sum included) where
``fused_lo_sum`` and ``traj_criterion`` under autograd were some three
hundred; only the loss is differentiable there, not the aux scalars or the
rewards. ``"torch"`` is the plain autodiff path, the twin of the JAX
package's XLA path (like it, it rematerialises its (W, N) intermediates in
the backward pass instead of saving them); ``"auto"`` picks ``"kernel"`` for
CUDA tensors and ``"torch"`` for CPU tensors. ``traj_criterion`` and
``traj_criterion_from_mean`` stay the criterion of the plain, soft-HPR,
frozen and sharded paths. The JAX package's names ``"pallas"`` and ``"xla"`` are
accepted for ``"kernel"`` and ``"torch"``. ``soft_hpr=True`` takes the
occlusion-aware path whatever the backend (the fused kernels have no
occlusion input): each selected waypoint's scores are gated by the dense
soft HPR (dense or binned by the cloud's size) on its own camera-frame
cloud, one checkpointed waypoint at a time.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from trajectory_optimization_tpu_torch.ops.fused_traj import fused_traj
from trajectory_optimization_tpu_torch.ops.hpr import soft_hpr_gate
from trajectory_optimization_tpu_torch.ops.numerics import safe_norm
from trajectory_optimization_tpu_torch.ops.scores import (
    camera_planes,
    scores_from_planes,
    waypoint_scores,
)
from trajectory_optimization_tpu_torch.ops.trajectory import mean_segment_angle, polyline_length

Params = Dict[str, torch.Tensor]

BACKENDS = ("auto", "kernel", "torch")
BACKEND_ALIASES = {"pallas": "kernel", "xla": "torch"}  # the JAX package's names


@dataclasses.dataclass(frozen=True)
class TrajProblem:
    """Static (hashable) problem description for trajectory optimization."""

    img_width: float
    img_height: float
    min_dist: float = 1.0
    max_dist: float = 5.0
    smoothness_weight: float = 14.0
    length_weight: float = 0.02
    eps: float = 1e-6
    wps_step: int = 1  # evaluate visibility at every wps_step-th waypoint
    backend: str = "auto"  # one of BACKENDS, or a key of BACKEND_ALIASES
    # Differentiable Katz occlusion inside the loss, per selected waypoint on
    # its camera-frame cloud: the dense soft HPR up to soft_hpr_dense_max
    # points, the direction-binned tier above it with its knobs hpr_cap and
    # hpr_safety.
    soft_hpr: bool = False
    soft_hpr_dense_max: int = 32768
    hpr_cap: int = 512
    hpr_safety: float = 3.0


def waypoint_stride(poses0: np.ndarray, vis_wps_dist: float = 0.5) -> int:
    """Stride between visibility waypoints, from the initial path's mean
    inter-waypoint distance (1 for a single or stationary waypoint)."""
    poses0 = np.asarray(poses0)
    if len(poses0) < 2:
        return 1
    mean_d = float(np.mean(np.linalg.norm(poses0[1:] - poses0[:-1], axis=-1)))
    if not np.isfinite(mean_d) or mean_d <= 0.0:
        return 1
    return int(vis_wps_dist / mean_d) + 1


def init_traj_params(poses0, quats0, device="cpu") -> Params:
    """Parameters {'poses': (W,3), 'quats': (W,4) wxyz} as f32 leaf tensors."""
    return {
        "poses": torch.as_tensor(np.asarray(poses0), dtype=torch.float32, device=device).clone(),
        "quats": torch.as_tensor(np.asarray(quats0), dtype=torch.float32, device=device).clone(),
    }


def _masked_minmax(p: torch.Tensor, valid: Optional[torch.Tensor]):
    """Per-waypoint min/max of (W, N) scores over real points only.
    ``amin``/``amax`` split the cotangent equally over ties, as
    ``jnp.min``/``jnp.max`` do."""
    if valid is None:
        return torch.amin(p, dim=-1, keepdim=True), torch.amax(p, dim=-1, keepdim=True)
    big = torch.finfo(p.dtype).max
    ok = valid > 0
    pmin = torch.amin(torch.where(ok, p, torch.full_like(p, big)), dim=-1, keepdim=True)
    pmax = torch.amax(torch.where(ok, p, torch.full_like(p, -big)), dim=-1, keepdim=True)
    return pmin, pmax


def observation_logodds(
    p: torch.Tensor, eps: float, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(W, N) raw visibility scores → (W, N) per-waypoint log-odds."""
    pmin, pmax = _masked_minmax(p, valid)
    return logodds_from_minmax(p, pmin, pmax, eps)


def logodds_from_minmax(p, pmin, pmax, eps: float) -> torch.Tensor:
    """Normalize → clip → log-odds with the min/max precomputed. The span is
    floored at 1e-8, so a waypoint that sees nothing contributes nothing."""
    span = torch.clamp(pmax - pmin, min=1e-8)
    p = (p - pmin) / span
    p = torch.clamp(p, 0.5, 1.0 - eps)
    return torch.log(p / (1.0 - p))


def _resolve_backend(problem: TrajProblem, points: torch.Tensor) -> str:
    """The path ``traj_forward`` takes: "kernel", "torch" or, with
    ``soft_hpr``, "torch_hpr" (the twin of the JAX package's "xla_hpr")."""
    backend = BACKEND_ALIASES.get(problem.backend, problem.backend)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS + tuple(BACKEND_ALIASES)}, "
                         f"got {problem.backend!r}")
    if problem.soft_hpr:
        if backend == "kernel":
            warnings.warn(
                f"TrajProblem(backend={problem.backend!r}, soft_hpr=True): soft HPR needs the "
                "plain scores path (the fused kernels have no occlusion input); the explicit "
                "kernel backend request is ignored.",
                stacklevel=3,
            )
        return "torch_hpr"
    if backend == "auto":
        return "kernel" if points.is_cuda else "torch"
    return backend


def plain_lo_sum(points, quats_sel, poses_sel, K, problem: TrajProblem, valid=None):
    """The plain path's score → log-odds → sum over waypoints, (N,)."""
    p = waypoint_scores(
        points, quats_sel, poses_sel, K, problem.img_width, problem.img_height,
        min_dist=problem.min_dist, max_dist=problem.max_dist, eps=problem.eps,
    )  # (W_sel, N)
    return torch.sum(observation_logodds(p, problem.eps, valid), dim=0)


def gated_waypoint_scores(quat, pose, points, K, problem, valid=None) -> torch.Tensor:
    """One waypoint's occlusion-gated raw scores, (N,) hpr × score: one
    world-to-camera transform feeds both the score and the soft HPR of the
    waypoint's camera-frame cloud (the binned tier above
    ``problem.soft_hpr_dense_max`` points). ``problem`` is duck-typed
    (img_width, img_height, min_dist, max_dist, eps, soft_hpr_dense_max and
    optionally hpr_cap, hpr_safety): the trajectory, pose and waypoint
    losses all gate through here."""
    cx, cy, cz = camera_planes(points, quat[None], pose[None])
    p = scores_from_planes(
        cx, cy, cz, K, problem.img_width, problem.img_height,
        min_dist=problem.min_dist, max_dist=problem.max_dist, eps=problem.eps,
    )[0]
    cam = torch.stack([cx[0], cy[0], cz[0]], dim=-1)
    return soft_hpr_gate(cam, valid, problem) * p


def soft_hpr_wp_logodds(quat, pose, points, K, problem: TrajProblem, valid=None):
    """One waypoint's occlusion-gated (N,) log-odds: ``gated_waypoint_scores``
    min-max normalized over the valid points and clipped. Occluded points
    fall below the 0.5 clip and add nothing."""
    gated = gated_waypoint_scores(quat, pose, points, K, problem, valid)
    return observation_logodds(gated[None], problem.eps, valid)[0]


def traj_forward(
    params: Params,
    points: torch.Tensor,
    K: torch.Tensor,
    poses0: torch.Tensor,
    quats0: torch.Tensor,
    problem: TrajProblem,
    *,
    valid: Optional[torch.Tensor] = None,
    points_t: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Composite trajectory loss + per-point rewards.

    Args:
      params: {'poses': (W,3), 'quats': (W,4) wxyz}.
      points: (N, 3) world points (padded entries allowed).
      K: (3, 3) intrinsics.
      poses0/quats0: frozen initial trajectory (anchor/length targets).
      valid: optional (N,) 0/1 mask of real points.
      points_t: optional contiguous (3, N) transpose of ``points`` for the
        kernel backend (pass it to transpose once per problem).

    Returns:
      (loss, aux); aux = {'rewards': (N,), 'loss_vis', 'loss_l2',
      'loss_smooth', 'loss_length', 'mean_reward'}.
    """
    poses, quats = params["poses"], params["quats"]
    sel = slice(None, None, problem.wps_step)
    backend = _resolve_backend(problem, points)
    if backend == "torch_hpr":
        # One checkpointed waypoint at a time, summed as the JAX twin's scan
        # sums: the backward recomputes each waypoint's gate, so the live set
        # stays O(N) whatever the number of waypoints.
        lo_sum = torch.zeros(points.shape[0], dtype=points.dtype, device=points.device)
        for quat, pose in zip(quats[sel], poses[sel]):
            lo_sum = lo_sum + checkpoint(soft_hpr_wp_logodds, quat, pose, points, K, problem,
                                         valid, use_reentrant=False, preserve_rng_state=False)
    elif backend == "kernel":
        return fused_traj(params, points, K, poses0, problem, valid=valid, points_t=points_t)
    else:
        # Checkpointed as the JAX twin's XLA path is: the dozens of (W, N)
        # intermediates are recomputed in the backward pass, not kept from the
        # forward. The same operations run either way, so loss and gradients
        # keep their bits.
        lo_sum = checkpoint(plain_lo_sum, points, quats[sel], poses[sel], K, problem, valid,
                            use_reentrant=False, preserve_rng_state=False)  # no randomness
    return traj_criterion(lo_sum, params, poses0, problem, valid=valid)


def traj_criterion(
    lo_sum: torch.Tensor,
    params: Params,
    poses0: torch.Tensor,
    problem: TrajProblem,
    *,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Composite loss from the (N,) accumulated log-odds: rewards = σ(Σ lo),
    then visibility + first-waypoint anchor + smoothness + length."""
    rewards = 1.0 / (1.0 + torch.exp(-lo_sum))
    if valid is None:
        mean_reward = torch.mean(rewards)
    else:
        mean_reward = torch.sum(rewards * valid) / torch.clamp(torch.sum(valid), min=1.0)
    loss, aux = traj_criterion_from_mean(mean_reward, params, poses0, problem)
    aux["rewards"] = rewards
    return loss, aux


def traj_criterion_from_mean(
    mean_reward: torch.Tensor,
    params: Params,
    poses0: torch.Tensor,
    problem: TrajProblem,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The criterion tail given the mean reward; aux carries the scalar terms."""
    poses = params["poses"]
    loss_vis = 1.0 / (mean_reward + problem.eps)
    loss_l2 = safe_norm(poses[0] - poses0[0])  # zero subgradient at init
    loss_smooth = problem.smoothness_weight / (
        mean_segment_angle(poses, problem.eps) + problem.eps
    )
    # |·| with derivative 1 at 0, as jnp.abs has (torch.abs has 0): on the
    # initial path the difference is exactly 0, and the first step must
    # match the JAX twin's.
    dlen = polyline_length(poses) - polyline_length(poses0)
    loss_length = problem.length_weight * torch.where(dlen >= 0, dlen, -dlen)
    loss = loss_vis + loss_l2 + loss_length + loss_smooth
    aux = {
        "mean_reward": mean_reward,
        "loss_vis": loss_vis,
        "loss_l2": loss_l2,
        "loss_smooth": loss_smooth,
        "loss_length": loss_length,
    }
    return loss, aux
