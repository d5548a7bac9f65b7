"""Multi-card occlusion-aware pose optimization.

Twin of ``trajectory_optimization_tpu/parallel/pose_sharded.py``: the pose
loss of ``models.pose.pose_forward`` with the point axis sharded over a mesh
axis. The world→camera transform and the visibility score are per-point work
on each rank's slice; with ``problem.soft_hpr`` the differentiable binned
HPR gate comes from ``parallel.hpr_sharded._local_mask`` (the binned tier
always: the dense one cannot be point-sharded, so compare with the
single-card loss at ``soft_hpr_dense_max=0``); the scalar loss
1/(Σ mask + eps) closes with one SUM over the axis. The (1,3)+(1,4)
parameters and the Adam state are replicated (``parallel.mesh``'s
convention: each rank's gradient is the single-card one).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from trajectory_optimization_tpu_torch.models.pose import PoseProblem
from trajectory_optimization_tpu_torch.ops.hpr import SOFT_BINNED_DEFAULTS as _HPR_DEF
from trajectory_optimization_tpu_torch.ops.scores import camera_planes, scores_from_planes
from trajectory_optimization_tpu_torch.opt.engine import (
    OptimizerConfig,
    apply_updates,
    make_optimizer,
    value_and_grad,
)
from trajectory_optimization_tpu_torch.parallel.hpr_sharded import (
    _local_mask,
    resolve_hpr_knobs as _resolve_hpr_knobs,
)
from trajectory_optimization_tpu_torch.parallel.mesh import Mesh, all_reduce, vary

__all__ = ["pose_loss_sharded", "make_sharded_pose_step"]


def hpr_gate_sharded(mesh: Mesh, cam, valid, axis: str, hpr_cap: int, hpr_safety: float):
    """The binned soft-HPR gate of this rank's (n_local, 3) camera-frame
    slice, with the single-card tier's r_param, sharpness and tau."""
    n_l = cam.shape[0]
    return _local_mask(
        cam, valid, mesh.index(axis) * n_l, mesh=mesh, axis=axis,
        r_param=_HPR_DEF["r_param"], sharpness=_HPR_DEF["sharpness"], tau=_HPR_DEF["tau"],
        cap=hpr_cap, safety=hpr_safety, n_global=n_l * mesh.size(axis))


def pose_loss_sharded(
    mesh: Mesh,
    params,
    points,
    valid,
    K,
    problem: PoseProblem,
    *,
    axis: str = "pts",
    hpr_cap=None,
    hpr_safety=None,
    occlusion_mask=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pose loss on this rank's slice (``points``, ``valid`` and
    ``occlusion_mask`` from ``parallel.mesh.points_sharding``). Returns
    (the scalar loss, replicated; this rank's (n_local,) observations).

    ``occlusion_mask`` is the single-card static hard-HPR gate
    (``pose_forward(occlusion_mask=...)``): it multiplies the scores only and
    stays out of the soft-HPR coverer set, as on the single card."""
    valid = torch.as_tensor(valid, dtype=points.dtype, device=points.device)
    occ = torch.ones_like(valid) if occlusion_mask is None else occlusion_mask.to(valid.dtype)
    hpr_cap, hpr_safety = _resolve_hpr_knobs(problem, hpr_cap, hpr_safety)
    quat, trans = vary(params["quat"], mesh, axis), vary(params["trans"], mesh, axis)
    # one world→camera transform feeds both the score and the HPR input
    cxp, cyp, czp = camera_planes(points, quat, trans)
    score = scores_from_planes(
        cxp, cyp, czp, K, problem.img_width, problem.img_height,
        min_dist=problem.min_dist, max_dist=problem.max_dist, eps=problem.eps)[0]
    if problem.soft_hpr:
        cam = torch.stack([cxp[0], cyp[0], czp[0]], dim=-1)
        hpr = hpr_gate_sharded(mesh, cam, valid, axis, hpr_cap, hpr_safety)
        mask = hpr * score * occ * valid
    else:
        mask = score * occ * valid
    total = all_reduce(torch.sum(mask), mesh, axis)
    return 1.0 / (total + problem.eps), mask


def make_sharded_pose_step(
    mesh: Mesh,
    problem: PoseProblem,
    cfg: OptimizerConfig,
    *,
    axis: str = "pts",
    hpr_cap=None,
    hpr_safety=None,
    occlusion: bool = False,
) -> Tuple[Callable, Callable]:
    """Build (init_fn, step_fn) for the sharded pose step.

    ``step_fn(params, opt_state, points, valid, K) -> (params, opt_state,
    loss, observations)``, with ``occlusion=True``
    ``step_fn(params, opt_state, points, valid, occlusion_mask, K)``;
    points, valid, the gate and the observations are this rank's slices.
    """
    hpr_cap, hpr_safety = _resolve_hpr_knobs(problem, hpr_cap, hpr_safety)
    tx = make_optimizer(cfg, pose_key="trans", quat_key="quat")

    def init_fn(params):
        return tx.init(params)

    def _step(params, opt_state, points, valid, occ, K):
        loss, aux, grads = value_and_grad(
            lambda p: _with_aux(pose_loss_sharded(
                mesh, p, points, valid, K, problem, axis=axis, hpr_cap=hpr_cap,
                hpr_safety=hpr_safety, occlusion_mask=occ)), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss, aux["observations"]

    if occlusion:
        return init_fn, _step

    def step_fn(params, opt_state, points, valid, K):
        return _step(params, opt_state, points, valid, None, K)

    return init_fn, step_fn


def _with_aux(loss_obs):
    loss, obs = loss_obs
    return loss, {"observations": obs}
