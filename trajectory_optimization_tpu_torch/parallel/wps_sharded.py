"""Multi-card Waypoints Optimization: per-waypoint X/Y/yaw over a point mesh.

Twin of ``trajectory_optimization_tpu/parallel/wps_sharded.py``: the loss of
``models.wps_opt.wps_forward`` with the point axis sharded over a mesh axis.
Every rank scores all W waypoints against its own slice ((W, n_local) work;
the per-waypoint parameters are tiny and replicated), and the only
cross-rank step of the forward is one SUM of the (W,) per-waypoint
observation sums. With ``problem.soft_hpr`` each waypoint's scores are gated
by the point-sharded binned HPR of its camera-frame slice
(``parallel.hpr_sharded``), one waypoint at a time. Parameters, frozen path
parts, Adam state and losses are replicated; points, valid and the (W,
n_local) observations are per rank (``parallel.mesh``'s convention).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from trajectory_optimization_tpu_torch.models.wps_opt import WpsOptProblem, wps_path
from trajectory_optimization_tpu_torch.ops.scores import (
    camera_planes,
    scores_from_planes,
    waypoint_scores,
)
from trajectory_optimization_tpu_torch.opt.engine import (
    OptimizerConfig,
    apply_updates,
    make_optimizer,
    value_and_grad,
)
from trajectory_optimization_tpu_torch.parallel.hpr_sharded import (
    resolve_hpr_knobs as _resolve_hpr_knobs,
)
from trajectory_optimization_tpu_torch.parallel.mesh import Mesh, all_reduce, vary
from trajectory_optimization_tpu_torch.parallel.pose_sharded import hpr_gate_sharded

__all__ = ["wps_loss_sharded", "make_sharded_wps_step"]


def wps_loss_sharded(
    mesh: Mesh,
    params,
    frozen,
    points,
    valid,
    K,
    problem: WpsOptProblem,
    *,
    axis: str = "pts",
    occlusion_mask=None,
    hpr_cap=None,
    hpr_safety=None,
):
    """Summed per-waypoint loss on this rank's slice. Returns (loss, aux),
    aux = {'losses' (W,), 'observations' (W, n_local), 'mean_reward'}: the
    single-card ``wps_forward`` contract with this rank's observations.
    ``occlusion_mask`` (this rank's slice) multiplies every waypoint's
    scores and stays out of the soft-HPR coverer set, as on the single
    card."""
    valid = torch.as_tensor(valid, dtype=points.dtype, device=points.device)
    occ = torch.ones_like(valid) if occlusion_mask is None else occlusion_mask.to(valid.dtype)
    hpr_cap, hpr_safety = _resolve_hpr_knobs(problem, hpr_cap, hpr_safety)
    trans, quats = wps_path(params, frozen)  # replicated tiny math
    trans, quats = vary(trans, mesh, axis), vary(quats, mesh, axis)
    if problem.soft_hpr:
        rows = []
        for quat, pose in zip(quats, trans):
            # one world→camera transform feeds the score and the HPR input
            cxp, cyp, czp = camera_planes(points, quat[None], pose[None])
            score = scores_from_planes(
                cxp, cyp, czp, K, problem.img_width, problem.img_height,
                min_dist=problem.min_dist, max_dist=problem.max_dist, eps=problem.eps)[0]
            cam = torch.stack([cxp[0], cyp[0], czp[0]], dim=-1)
            rows.append(hpr_gate_sharded(mesh, cam, valid, axis, hpr_cap, hpr_safety) * score)
        mask = torch.stack(rows)
    else:
        mask = waypoint_scores(
            points, quats, trans, K, problem.img_width, problem.img_height,
            min_dist=problem.min_dist, max_dist=problem.max_dist, eps=problem.eps)
    mask = mask * (occ * valid)[None, :]
    per_wp = all_reduce(torch.sum(mask, dim=-1), mesh, axis)  # (W,) replicated
    losses = 1.0 / (per_wp + problem.eps)
    aux = {"losses": losses, "observations": mask, "mean_reward": torch.mean(per_wp)}
    return torch.sum(losses), aux


def make_sharded_wps_step(
    mesh: Mesh,
    problem: WpsOptProblem,
    cfg: OptimizerConfig,
    *,
    axis: str = "pts",
    hpr_cap=None,
    hpr_safety=None,
    occlusion: bool = False,
) -> Tuple[Callable, Callable]:
    """Build (init_fn, step_fn) for sharded waypoint refinement.

    ``step_fn(params, opt_state, frozen, points, valid, K) -> (params,
    opt_state, losses, observations)``, with ``occlusion=True``
    ``step_fn(params, opt_state, frozen, points, valid, occlusion_mask, K)``.
    Two-group Adam on ('xy', 'yaw'), as the single-card engine path."""
    hpr_cap, hpr_safety = _resolve_hpr_knobs(problem, hpr_cap, hpr_safety)
    tx = make_optimizer(cfg, pose_key="xy", quat_key="yaw")

    def init_fn(params):
        return tx.init(params)

    def _step(params, opt_state, frozen, points, valid, occ, K):
        _, aux, grads = value_and_grad(
            lambda p: wps_loss_sharded(mesh, p, frozen, points, valid, K, problem, axis=axis,
                                       occlusion_mask=occ, hpr_cap=hpr_cap,
                                       hpr_safety=hpr_safety), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, aux["losses"], aux["observations"]

    if occlusion:
        return init_fn, _step

    def step_fn(params, opt_state, frozen, points, valid, K):
        return _step(params, opt_state, frozen, points, valid, None, K)

    return init_fn, step_fn
