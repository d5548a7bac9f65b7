"""Sharded training step and explicit-collective visibility evaluation.

Twin of ``trajectory_optimization_tpu/parallel/sharded.py``. Two paths:

1. :func:`make_sharded_train_step` — the production path: one Adam step of
   the trajectory loss with the cloud sharded over 'pts'. Backends
   (``problem.backend``): ``'pallas'``/``'kernel'``, and ``'auto'`` on the
   card, run :func:`traj_forward_sharded` through the sharded fused passes
   (``parallel.sharded_pallas``: the hand kernels K1–K5 on CUDA tensors,
   their plain versions on CPU tensors); ``'xla'``/``'torch'``, and
   ``'auto'`` on the CPU, run the plain scores with the min/max and the
   mean reward as all_reduces.
2. :func:`shardmap_visibility` — the per-point rewards with explicit
   MIN/MAX all_reduces over 'pts', no gradient.

Tensors are per rank (``parallel.mesh``): points and valid are this rank's
slices (:func:`shard_points`); parameters, Adam state and the initial path
are replicated, and each rank's parameter gradient is the single-device one.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from trajectory_optimization_tpu_torch.models.traj import (
    BACKEND_ALIASES,
    BACKENDS,
    TrajProblem,
    logodds_from_minmax,
    traj_criterion_from_mean,
)
from trajectory_optimization_tpu_torch.opt.engine import (
    OptimizerConfig,
    apply_updates,
    make_optimizer,
    value_and_grad,
)
from trajectory_optimization_tpu_torch.ops.scores import waypoint_scores
from trajectory_optimization_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce,
    points_sharding,
    vary,
)
from trajectory_optimization_tpu_torch.parallel.sharded_pallas import sharded_fused_lo_sum


def shard_points(mesh: Mesh, points, valid=None):
    """This rank's slice of an (N, 3) cloud (and optional (N,) mask) along
    'pts', on the mesh's device. N must divide by the 'pts' size (pad first:
    utils.data.pad_points buckets to multiples of 1024)."""
    pts = points_sharding(mesh, points)
    if valid is None:
        return pts
    return pts, points_sharding(mesh, valid)


def traj_criterion_sharded(mesh: Mesh, lo_sum, params, poses0, problem: TrajProblem, *,
                           valid=None, axis="pts") -> Tuple[torch.Tensor, Dict]:
    """``models.traj.traj_criterion`` on this rank's (n_local,) log-odds: the
    mean reward's two sums are all_reduces over ``axis``; the tail runs on
    the replicated parameters. aux['rewards'] is this rank's slice."""
    rewards = 1.0 / (1.0 + torch.exp(-lo_sum))
    if valid is None:
        valid = torch.ones_like(rewards)
    total = all_reduce(torch.sum(rewards * valid), mesh, axis)
    count = all_reduce(torch.sum(valid).detach(), mesh, axis)
    mean_reward = total / torch.clamp(count, min=1.0)
    loss, aux = traj_criterion_from_mean(mean_reward, params, poses0, problem)
    aux["rewards"] = rewards
    return loss, aux


def _masked_minmax_local(p, valid):
    big = torch.finfo(p.dtype).max
    ok = valid[None, :] > 0
    return (torch.amin(torch.where(ok, p, torch.full_like(p, big)), dim=-1),
            torch.amax(torch.where(ok, p, torch.full_like(p, -big)), dim=-1))


def plain_lo_sum_sharded(mesh: Mesh, points, quats_sel, poses_sel, K, problem: TrajProblem,
                         valid):
    """The plain path's score → log-odds → sum over waypoints on this rank's
    slice, with the per-waypoint min/max all_reduced over 'pts'."""
    q, t = vary(quats_sel, mesh, "pts"), vary(poses_sel, mesh, "pts")
    p = waypoint_scores(points, q, t, K, problem.img_width, problem.img_height,
                        min_dist=problem.min_dist, max_dist=problem.max_dist, eps=problem.eps)
    pmin_l, pmax_l = _masked_minmax_local(p, valid)
    pmin = vary(all_reduce(pmin_l, mesh, "pts", "min"), mesh, "pts")
    pmax = vary(all_reduce(pmax_l, mesh, "pts", "max"), mesh, "pts")
    return torch.sum(logodds_from_minmax(p, pmin[:, None], pmax[:, None], problem.eps), dim=0)


def traj_forward_sharded(
    mesh: Mesh,
    params,
    points,
    K,
    poses0,
    quats0,
    problem: TrajProblem,
    *,
    valid=None,
    points_t: Optional[torch.Tensor] = None,
):
    """``traj_forward`` with the visibility log-odds from the sharded fused
    passes (:func:`~.sharded_pallas.sharded_fused_lo_sum`) on this rank's
    slice and the criterion tail on the replicated waypoint parameters.
    The whole cloud must be a multiple of ``sharded_pallas.pad_multiple``."""
    poses, quats = params["poses"], params["quats"]
    sel = slice(None, None, problem.wps_step)
    lo_sum = sharded_fused_lo_sum(
        mesh, points, quats[sel], poses[sel], K, problem.img_width, problem.img_height,
        min_dist=problem.min_dist, max_dist=problem.max_dist, eps=problem.eps,
        valid=valid, points_t=points_t)
    return traj_criterion_sharded(mesh, lo_sum, params, poses0, problem, valid=valid)


def _resolve_backend(problem: TrajProblem, mesh: Mesh) -> str:
    backend = BACKEND_ALIASES.get(problem.backend, problem.backend)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS + tuple(BACKEND_ALIASES)}, "
                         f"got {problem.backend!r}")
    if backend == "auto":
        backend = "kernel" if mesh.device.type == "cuda" else "torch"
    return backend


def make_sharded_train_step(
    mesh: Mesh,
    problem: TrajProblem,
    cfg: OptimizerConfig,
) -> Tuple[Callable, Callable]:
    """Build (init_fn, step_fn) for the sharded trajectory training step.

    ``step_fn(params, opt_state, points, valid, K, poses0, quats0) ->
    (params, opt_state, loss, scalar_aux)``: points/valid are this rank's
    slices; params, the Adam state and the initial path are replicated.
    Backends as in the module docstring; the kernel backend needs the
    whole cloud to be a multiple of ``sharded_pallas.pad_multiple(mesh)``
    and rejects ``soft_hpr`` (the fused kernels have no occlusion input:
    ``parallel.traj_sharded`` is the occlusion-aware step).
    """
    tx = make_optimizer(cfg)
    backend = _resolve_backend(problem, mesh)
    if backend == "kernel" and problem.soft_hpr:
        raise ValueError(
            "make_sharded_train_step's 'pallas' backend does not support "
            "soft_hpr; use parallel.traj_sharded.make_sharded_traj_step "
            "(occlusion-aware) or backend='xla'.")

    def loss_fn(params, points, valid, K, poses0, points_t):
        if backend == "kernel":
            return traj_forward_sharded(mesh, params, points, K, poses0, None, problem,
                                        valid=valid, points_t=points_t)
        sel = slice(None, None, problem.wps_step)
        lo_sum = plain_lo_sum_sharded(mesh, points, params["quats"][sel], params["poses"][sel],
                                      K, problem, valid)
        return traj_criterion_sharded(mesh, lo_sum, params, poses0, problem, valid=valid)

    def init_fn(params):
        return tx.init(params)

    def step_fn(params, opt_state, points, valid, K, poses0, quats0):
        del quats0  # the criterion anchors on poses0 only (reference parity)
        pts_t = points.t().contiguous() if backend == "kernel" else None
        loss, aux, grads = value_and_grad(
            lambda p: loss_fn(p, points, valid, K, poses0, pts_t), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, loss, {k: v for k, v in aux.items() if v.dim() == 0}

    return init_fn, step_fn


@torch.no_grad()
def shardmap_visibility(
    mesh: Mesh,
    points: torch.Tensor,
    valid: torch.Tensor,
    quats: torch.Tensor,
    poses: torch.Tensor,
    K: torch.Tensor,
    problem: TrajProblem,
) -> torch.Tensor:
    """Per-point trajectory rewards of this rank's slice, (n_local,): the
    per-waypoint normalization takes the global min/max over the cloud as
    MIN/MAX all_reduces over 'pts'. Equals the single-device
    ``traj_forward`` rewards."""
    sel = slice(None, None, problem.wps_step)
    p = waypoint_scores(points, quats[sel], poses[sel], K, problem.img_width,
                        problem.img_height, min_dist=problem.min_dist,
                        max_dist=problem.max_dist, eps=problem.eps)
    pmin_l, pmax_l = _masked_minmax_local(p, valid)
    pmin = all_reduce(pmin_l, mesh, "pts", "min")[:, None]
    pmax = all_reduce(pmax_l, mesh, "pts", "max")[:, None]
    lo = logodds_from_minmax(p, pmin, pmax, problem.eps)
    return 1.0 / (1.0 + torch.exp(-torch.sum(lo, dim=0)))
