"""Multi-card frozen-routing occlusion-aware trajectory step.

Twin of ``trajectory_optimization_tpu/parallel/traj_frozen_sharded.py``: the
frozen-routing engine (``models.traj_frozen``: a host-built soft-HPR plan,
refreshed every k steps, one batched dominance computation per step) over a
('wps', 'pts') mesh.

The plan is host numpy, so the point axis is partitioned when it is built:

- queries (the points whose visibility the loss reads) partition by id
  range: point shard s owns ids [s·n/d, (s+1)·n/d), the rows
  ``points_sharding`` gives that rank, so its plan embeds into exactly its
  own slice;
- coverers come from the whole cloud on every shard (occluders ignore shard
  borders); each query consumes each same-bin coverer once, on its owner;
- waypoints are padded to the 'wps' size with weight-0 dummies that get
  all-padding layouts (no queries, no loss, no gradient);
- the collectives: an all_gather + max of the per-waypoint flip radius, an
  all_gather + min/max of the per-waypoint score range, and the SUM over
  'wps' that closes the log-odds fusion; the criterion's mean reward sums
  over 'pts'.

Each rank stages only its own sub-plan. The step runs eagerly (gloo's
collectives go through the host, so it is not captured), with no per-plan
step cache and no prewarm; the plan builds run on the runner's one worker
thread, which ``close()`` joins. Like the twin, the
sharded step embeds the gated scores into the slice and runs the dense
criterion, not the single-card runner's sparse one
(``traj_forward_frozen_mean``); the two agree to rounding.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from trajectory_optimization_tpu_torch.models.traj import TrajProblem, logodds_from_minmax
from trajectory_optimization_tpu_torch.models.traj_frozen import (
    FrozenPlanConfig,
    FrozenTrajOptimizer,
    PlanMeta,
    build_traj_plan,
    frozen_soft_hpr_scores,
    stage_plan,
)
from trajectory_optimization_tpu_torch.opt.engine import (
    OptimizerConfig,
    apply_updates,
    make_optimizer,
    value_and_grad,
)
from trajectory_optimization_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce, vary
from trajectory_optimization_tpu_torch.parallel.sharded import traj_criterion_sharded
from trajectory_optimization_tpu_torch.parallel.traj_sharded import (
    _pad_selected,
    local_waypoints,
)

__all__ = [
    "build_frozen_sharded_plan",
    "traj_frozen_loss_sharded",
    "make_frozen_sharded_traj_step",
    "FrozenShardedTrajOptimizer",
]

# the single-card sparse criterion's arrays: the sharded loss does not read them
_SPARSE_KEYS = {"combine_fwd", "combine_bwd", "seg_head", "n_q"}


def build_frozen_sharded_plan(
    points: np.ndarray,
    valid: Optional[np.ndarray],
    poses_sel: np.ndarray,
    quats_sel: np.ndarray,
    K: np.ndarray,
    problem: TrajProblem,
    cfg: FrozenPlanConfig = FrozenPlanConfig(),
    *,
    d_wps: int,
    d_pts: int,
    min_tiles: int = 1,
    min_t_big: int = 1,
) -> Tuple[Dict[str, np.ndarray], PlanMeta]:
    """Build the mesh-sharded frozen plan (host numpy, the twin's arrays):
    one owner-sliced sub-plan per point shard, stacked along a leading
    (d_pts,) axis, waypoints padded to a multiple of ``d_wps`` with inactive
    dummies. Arrays are (d_pts, W_pad, ...); :func:`shard_plan` cuts a
    rank's sub-plan. The meta is per shard (``n_points`` = n // d_pts,
    tiles unified to the max over shards)."""
    n = len(points)
    if n % d_pts != 0:
        raise ValueError(
            f"cloud size {n} not divisible by point-shard count {d_pts}; "
            "pad with a valid mask first (utils.data.pad_points)")
    n_l = n // d_pts
    w_sel = len(poses_sel)
    w_pad = -(-w_sel // d_wps) * d_wps
    pad = w_pad - w_sel
    poses_p = np.asarray(poses_sel, np.float64)
    quats_p = np.asarray(quats_sel, np.float64)
    if pad:
        poses_p = np.concatenate([poses_p, np.zeros((pad, 3))])
        quats_p = np.concatenate([quats_p, np.tile([[1.0, 0.0, 0.0, 0.0]], (pad, 1))])
    wp_active = np.arange(w_pad) < w_sel

    def _one(s: int, mt: int, mtb: int):
        return build_traj_plan(points, valid, poses_p, quats_p, K, problem, cfg,
                               min_tiles=mt, min_t_big=mtb, owner=(s * n_l, (s + 1) * n_l),
                               wp_active=wp_active)

    built = [_one(s, min_tiles, min_t_big) for s in range(d_pts)]
    T = max(m.tiles for _, m in built)
    TB = max(m.t_big for _, m in built)
    built = [b if (b[1].tiles == T and b[1].t_big == TB) else _one(s, T, TB)
             for s, b in enumerate(built)]
    meta = built[0][1]
    plan = {k: np.stack([p[k] for p, _ in built])
            for k in built[0][0] if not k.startswith("_") and k not in _SPARSE_KEYS}
    return plan, meta


def shard_plan(mesh: Mesh, plan: Dict[str, np.ndarray], meta: PlanMeta, *,
               wps_axis: str = "wps", pts_axis: str = "pts", pin: bool = False):
    """This rank's sub-plan of :func:`build_frozen_sharded_plan`'s arrays:
    its point shard's plan, its waypoint shard's rows, staged as the step
    reads it (``models.traj_frozen.stage_plan``; pinned when ``pin``)."""
    s, a = mesh.index(pts_axis), mesh.index(wps_axis)
    w_loc = meta.n_sel // mesh.shape[wps_axis]
    sub = {k: v[s, a * w_loc:(a + 1) * w_loc] for k, v in plan.items()}
    return stage_plan(sub, dataclasses.replace(meta, n_sel=w_loc), pin=pin)


def traj_frozen_loss_sharded(
    mesh: Mesh,
    params,
    plan,
    meta: PlanMeta,
    points,
    valid,
    K,
    poses0,
    problem: TrajProblem,
    *,
    wps_axis: str = "wps",
    pts_axis: str = "pts",
):
    """Occlusion-aware trajectory loss under a frozen plan on a ('wps',
    'pts') mesh: the (loss, aux) contract of
    ``models.traj_frozen.traj_forward_frozen`` on this rank's slice.
    ``plan`` is this rank's sub-plan on its device (:func:`shard_plan`, then
    ``put_plan``), ``meta`` the whole plan's, built for the CURRENT
    selected waypoints."""
    d_wps, d_pts = mesh.shape[wps_axis], mesh.shape[pts_axis]
    q_sel, p_sel, wts = _pad_selected(params, problem, d_wps)
    if q_sel.shape[0] != meta.n_sel:
        raise ValueError(
            f"plan was built for {meta.n_sel} padded waypoints, params "
            f"select {q_sel.shape[0]} — rebuild the plan (refresh)")
    if points.shape[0] != meta.n_points:
        raise ValueError(
            f"plan was built for {meta.n_points}-point shards x {d_pts}, "
            f"got a {points.shape[0]}-point slice")
    valid = torch.as_tensor(valid, dtype=points.dtype, device=points.device)
    meta_l = dataclasses.replace(meta, n_sel=meta.n_sel // d_wps)
    q_loc, p_loc = local_waypoints(mesh, q_sel, wps_axis), local_waypoints(mesh, p_sel, wps_axis)
    a = mesh.index(wps_axis)
    wts = wts[a * meta_l.n_sel:(a + 1) * meta_l.n_sel]

    def allred(maxnorm):  # this slice's (W_loc,) max norm -> the global one
        return vary(torch.amax(all_gather(maxnorm, mesh, pts_axis), dim=0), mesh, pts_axis)

    gated, _ = frozen_soft_hpr_scores(plan, meta_l, q_loc, p_loc, points, K, problem, valid,
                                      norm_allreduce=allred)  # (W_loc, n_local)
    big = torch.finfo(gated.dtype).max
    vb = (valid > 0)[None]
    pmin_l = torch.amin(torch.where(vb, gated, torch.full_like(gated, big)), dim=1)
    pmax_l = torch.amax(torch.where(vb, gated, torch.full_like(gated, -big)), dim=1)
    pmin = vary(torch.amin(all_gather(pmin_l, mesh, pts_axis), dim=0), mesh, pts_axis)
    pmax = vary(torch.amax(all_gather(pmax_l, mesh, pts_axis), dim=0), mesh, pts_axis)
    lo = logodds_from_minmax(gated, pmin[:, None], pmax[:, None], problem.eps)
    acc = torch.sum(wts[:, None] * lo, dim=0)
    lo_sum = all_reduce(acc, mesh, wps_axis)  # the log-odds fusion over waypoint shards
    return traj_criterion_sharded(mesh, lo_sum, params, poses0, problem, valid=valid,
                                  axis=pts_axis)


def make_frozen_sharded_traj_step(
    mesh: Mesh,
    problem: TrajProblem,
    cfg: OptimizerConfig,
    meta: PlanMeta,
    *,
    wps_axis: str = "wps",
    pts_axis: str = "pts",
) -> Callable:
    """The sharded frozen-plan Adam step for one plan's meta:
    ``step_fn(params, opt_state, plan, points, valid, K, poses0, quats0) ->
    (params, opt_state, loss, scalar_aux)`` with this rank's sub-plan and
    slice (the single-card FrozenTrajOptimizer step contract)."""
    tx = make_optimizer(cfg)

    def step_fn(params, opt_state, plan, points, valid, K, poses0, quats0):
        del quats0  # the criterion anchors on poses0 only (reference parity)
        loss, aux, grads = value_and_grad(
            lambda p: traj_frozen_loss_sharded(mesh, p, plan, meta, points, valid, K, poses0,
                                               problem, wps_axis=wps_axis, pts_axis=pts_axis),
            params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, loss, {k: v for k, v in aux.items() if v.dim() == 0}

    return step_fn


class FrozenShardedTrajOptimizer(FrozenTrajOptimizer):
    """Occlusion-aware trajectory optimization with host-refreshed frozen
    routing over a ('wps', 'pts') mesh: the single-card runner's refresh
    cadence and asynchronous plan builds (``step``/``run``/``close``), with
    each rank holding its slice of the cloud and its own sub-plan on the
    mesh's device. ``points`` (and ``valid``) are the whole cloud: the plan
    builder reads every point as a coverer."""

    _need_embed = True  # the sharded loss embeds per shard

    def __init__(self, mesh: Mesh, points, K, poses0, quats0, problem: TrajProblem,
                 opt_cfg=None, plan_cfg: FrozenPlanConfig = FrozenPlanConfig(), valid=None, *,
                 wps_axis: str = "wps", pts_axis: str = "pts"):
        super().__init__(points, K, poses0, quats0, problem, opt_cfg, plan_cfg, valid,
                         device=mesh.device)
        self.mesh = mesh
        self._route = "eager"  # gloo's collectives go through the host: no capture
        self.wps_axis, self.pts_axis = wps_axis, pts_axis
        self._d_wps, self._d_pts = mesh.shape[wps_axis], mesh.shape[pts_axis]
        n = len(self.points_np)
        if n % self._d_pts:
            raise ValueError(
                f"cloud size {n} not divisible by mesh axis '{pts_axis}'={self._d_pts}; "
                "pad with a valid mask first (utils.data.pad_points)")
        n_l, s = n // self._d_pts, mesh.index(pts_axis)
        self.points = self.points[s * n_l:(s + 1) * n_l].contiguous()
        self.valid = (torch.ones(n_l, dtype=torch.float32, device=self.device) if self.valid is None
                      else self.valid[s * n_l:(s + 1) * n_l].contiguous())

    def _build_staged(self, params_host):
        poses_sel, quats_sel = self._selected(params_host)
        plan, meta = build_frozen_sharded_plan(
            self.points_np, self.valid_np, poses_sel, quats_sel, self.K_np, self.problem,
            self.plan_cfg, d_wps=self._d_wps, d_pts=self._d_pts)
        staged = shard_plan(self.mesh, plan, meta, wps_axis=self.wps_axis,
                            pts_axis=self.pts_axis, pin=self.device.type == "cuda")
        return staged, meta

    def _loss(self, p, plan, meta):
        return traj_frozen_loss_sharded(
            self.mesh, p, plan, meta, self.points, self.valid, self.K, self.poses0,
            self.problem, wps_axis=self.wps_axis, pts_axis=self.pts_axis)
