"""Cached problem runners.

Twin of ``trajectory_optimization_tpu/opt/runners.py`` (``traj_runner``,
``pose_runner``). One runner per (problem, config, ...), memoized on the
hashable dataclasses; the data are arguments, so the facade and the nodes
reuse one runner for every cloud of a shape bucket.
"""
from __future__ import annotations

import functools

import torch

from trajectory_optimization_tpu_torch.models.pose import PoseProblem, pose_forward
from trajectory_optimization_tpu_torch.models.traj import TrajProblem, traj_forward
from trajectory_optimization_tpu_torch.opt.engine import (
    EarlyStop,
    OptimizerConfig,
    adam_init,
    adam_update,
    group_lrs,
    run_until_done,
    value_and_grad,
)


@functools.lru_cache(maxsize=64)
def traj_runner(problem: TrajProblem, cfg: OptimizerConfig, stop: EarlyStop, n_steps: int):
    """Full trajectory optimization:
    run(params, points, valid, K, poses0, quats0)
      -> (params, n_iters, final_loss, final_aux)
    with every result a tensor on the points' device. Early stop runs
    without a host sync per step (``opt.engine.run_until_done``); the final
    forward's aux carries ``reward0`` and ``smooth0``, the first step's values.
    """

    def run(params, points, valid, K, poses0, quats0):
        points_t = points.t().contiguous()  # SoA once per problem, not per step

        def loss_fn(p):
            return traj_forward(
                p, points, K, poses0, quats0, problem, valid=valid, points_t=points_t
            )

        out = run_until_done(loss_fn, params, cfg, int(n_steps), stop)
        with torch.no_grad():
            final_loss, final_aux = loss_fn(out["params"])
        final_aux["reward0"] = out["reward0"]
        final_aux["smooth0"] = out["smooth0"]
        return out["params"], out["i"], final_loss, final_aux

    return run


@functools.lru_cache(maxsize=64)
def pose_runner(problem: PoseProblem, cfg: OptimizerConfig, seg_steps: int):
    """Segmented pose optimization, for publishing during the loop:
    init(params) -> opt_state;
    advance(params, opt_state, points, valid, K, occlusion=None)
      -> (params, opt_state, loss, aux), ``seg_steps`` Adam steps on.

    As in the JAX twin, each step's (loss, aux) is that of the parameters
    before its update, so ``advance`` returns the last step's pre-update
    forward, and with ``seg_steps = 0`` the forward of the parameters given.
    The Adam state's ``count`` carries across calls, so a decaying schedule
    continues from one segment to the next.
    """
    lrs = group_lrs(cfg, "trans", "quat")
    seg_steps = int(seg_steps)

    def advance(params, opt_state, points, valid, K, occlusion=None):
        def loss_fn(p):
            return pose_forward(p, points, K, problem, valid=valid, occlusion_mask=occlusion)

        if seg_steps == 0:
            with torch.no_grad():
                loss, aux = loss_fn(params)
        for _ in range(seg_steps):
            loss, aux, grads = value_and_grad(loss_fn, params)
            params, opt_state = adam_update(grads, opt_state, params, cfg, lrs)
        return params, opt_state, loss, aux

    return adam_init, advance
