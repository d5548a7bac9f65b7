"""Multi-card occlusion-aware trajectory optimization: a 2-D (wps × pts) step.

Twin of ``trajectory_optimization_tpu/parallel/traj_sharded.py``: the loss
of ``models.traj.traj_forward(soft_hpr=True)`` over both axes of a
('wps', 'pts') mesh:

- waypoint axis: the selected waypoints, padded to the axis size with
  weight-0 dummies, are split over the 'wps' ranks, each of which runs its
  own subset one waypoint at a time;
- point axis: each waypoint's occlusion comes from the point-sharded binned
  HPR (``parallel.hpr_sharded._local_mask`` over 'pts'), and its min-max
  score normalization takes the global min/max as an all_gather + min/max;
- one SUM over 'wps' closes the log-odds fusion; the criterion's mean
  reward sums over 'pts'.

The binned tier always (the dense one cannot be point-sharded): compare with
the single-card loss at ``soft_hpr_dense_max=0``. The twin checkpoints each
waypoint; here the binned tiles already recompute in their backward
(``hpr_sharded._ShardedLSE``), so a waypoint keeps O(n_local + tables) for
the backward and nothing is recomputed with its collectives.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from trajectory_optimization_tpu_torch.models.traj import TrajProblem, logodds_from_minmax
from trajectory_optimization_tpu_torch.ops.scores import camera_planes, scores_from_planes
from trajectory_optimization_tpu_torch.opt.engine import (
    OptimizerConfig,
    apply_updates,
    make_optimizer,
    value_and_grad,
)
from trajectory_optimization_tpu_torch.parallel.hpr_sharded import (
    resolve_hpr_knobs as _resolve_hpr_knobs,
)
from trajectory_optimization_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce, vary
from trajectory_optimization_tpu_torch.parallel.pose_sharded import hpr_gate_sharded
from trajectory_optimization_tpu_torch.parallel.sharded import traj_criterion_sharded

__all__ = ["traj_soft_hpr_loss_sharded", "make_sharded_traj_step"]


def _logodds_sharded(mesh: Mesh, raw_l, valid_l, eps, pts_axis):
    """observation_logodds of (..., n_local) scores with the per-row min/max
    over the GLOBAL cloud: an all_gather + min/max over the point axis
    (differentiable), entering the per-rank tail through ``vary``."""
    big = torch.finfo(raw_l.dtype).max
    v = valid_l > 0
    pmin_l = torch.amin(torch.where(v, raw_l, torch.full_like(raw_l, big)), dim=-1)
    pmax_l = torch.amax(torch.where(v, raw_l, torch.full_like(raw_l, -big)), dim=-1)
    pmin = vary(torch.amin(all_gather(pmin_l, mesh, pts_axis), dim=0), mesh, pts_axis)
    pmax = vary(torch.amax(all_gather(pmax_l, mesh, pts_axis), dim=0), mesh, pts_axis)
    return logodds_from_minmax(raw_l, pmin[..., None], pmax[..., None], eps)


def _pad_selected(params, problem: TrajProblem, n_wps_shards: int):
    """Stride-select the visibility waypoints and pad them to the axis size
    with weight-0 dummies (identity quaternion, origin pose: constants, no
    gradient path). Returns (quats_sel, poses_sel, weights), W_pad long."""
    sel = slice(None, None, problem.wps_step)
    q_sel, p_sel = params["quats"][sel], params["poses"][sel]
    w_sel = q_sel.shape[0]
    pad = -(-w_sel // n_wps_shards) * n_wps_shards - w_sel
    if pad:
        q_pad = torch.zeros((pad, 4), dtype=q_sel.dtype, device=q_sel.device)
        q_pad[:, 0] = 1.0
        q_sel = torch.cat([q_sel, q_pad])
        p_sel = torch.cat([p_sel, torch.zeros((pad, 3), dtype=p_sel.dtype, device=p_sel.device)])
    wts = torch.cat([torch.ones(w_sel), torch.zeros(pad)]).to(q_sel.device)
    return q_sel, p_sel, wts


def local_waypoints(mesh: Mesh, x, wps_axis: str = "wps"):
    """This rank's rows of a replicated (W_pad, ...) waypoint tensor, entering
    per-rank work over the whole mesh (its gradient is summed over every
    rank: each holds some waypoints on some points)."""
    x = vary(x, mesh, mesh.axis_names)
    w_loc = x.shape[0] // mesh.shape[wps_axis]
    a = mesh.index(wps_axis)
    return x[a * w_loc:(a + 1) * w_loc]


def traj_soft_hpr_loss_sharded(
    mesh: Mesh,
    params,
    points,
    valid,
    K,
    poses0,
    problem: TrajProblem,
    *,
    wps_axis: str = "wps",
    pts_axis: str = "pts",
    hpr_cap=None,
    hpr_safety=None,
):
    """Occlusion-aware trajectory loss over a ('wps', 'pts') mesh, on this
    rank's slice (``points``, ``valid``). Returns the (loss, aux) of
    ``traj_forward(soft_hpr=True)`` with the binned tier forced, up to
    quantized-key candidate ties (``parallel.hpr_sharded``);
    aux['rewards'] is this rank's slice."""
    valid = torch.as_tensor(valid, dtype=points.dtype, device=points.device)
    hpr_cap, hpr_safety = _resolve_hpr_knobs(problem, hpr_cap, hpr_safety)
    q_sel, p_sel, wts = _pad_selected(params, problem, mesh.shape[wps_axis])
    q_loc, p_loc = local_waypoints(mesh, q_sel, wps_axis), local_waypoints(mesh, p_sel, wps_axis)
    w_loc = q_loc.shape[0]
    wts = wts[mesh.index(wps_axis) * w_loc:(mesh.index(wps_axis) + 1) * w_loc]
    acc = torch.zeros(points.shape[0], dtype=points.dtype, device=points.device)
    for quat, pose, w in zip(q_loc, p_loc, wts):
        # one world→camera transform feeds both score and HPR input
        cxp, cyp, czp = camera_planes(points, quat[None], pose[None])
        score = scores_from_planes(
            cxp, cyp, czp, K, problem.img_width, problem.img_height,
            min_dist=problem.min_dist, max_dist=problem.max_dist, eps=problem.eps)[0]
        cam = torch.stack([cxp[0], cyp[0], czp[0]], dim=-1)
        hpr = hpr_gate_sharded(mesh, cam, valid, pts_axis, hpr_cap, hpr_safety)
        lo = _logodds_sharded(mesh, hpr * score, valid, problem.eps, pts_axis)
        acc = acc + w * lo  # w = 0 on the padded dummies: no value, no gradient
    lo_sum = all_reduce(acc, mesh, wps_axis)  # the log-odds fusion over waypoint shards
    return traj_criterion_sharded(mesh, lo_sum, params, poses0, problem, valid=valid,
                                  axis=pts_axis)


def make_sharded_traj_step(
    mesh: Mesh,
    problem: TrajProblem,
    cfg: OptimizerConfig,
    *,
    wps_axis: str = "wps",
    pts_axis: str = "pts",
    hpr_cap=None,
    hpr_safety=None,
) -> Tuple[Callable, Callable]:
    """Build (init_fn, step_fn) for the sharded occlusion-aware trajectory
    step (the contract of ``parallel.sharded.make_sharded_train_step``):
    ``step_fn(params, opt_state, points, valid, K, poses0, quats0) ->
    (params, opt_state, loss, scalar_aux)`` with this rank's points/valid."""
    if not problem.soft_hpr:
        raise ValueError(
            "make_sharded_traj_step is the occlusion-aware (soft_hpr) step; "
            "for the plain visibility loss use "
            "parallel.sharded.make_sharded_train_step")
    hpr_cap, hpr_safety = _resolve_hpr_knobs(problem, hpr_cap, hpr_safety)
    tx = make_optimizer(cfg)

    def init_fn(params):
        return tx.init(params)

    def step_fn(params, opt_state, points, valid, K, poses0, quats0):
        del quats0  # the criterion anchors on poses0 only (reference parity)
        loss, aux, grads = value_and_grad(
            lambda p: traj_soft_hpr_loss_sharded(
                mesh, p, points, valid, K, poses0, problem, wps_axis=wps_axis,
                pts_axis=pts_axis, hpr_cap=hpr_cap, hpr_safety=hpr_safety), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, loss, {k: v for k, v in aux.items() if v.dim() == 0}

    return init_fn, step_fn
