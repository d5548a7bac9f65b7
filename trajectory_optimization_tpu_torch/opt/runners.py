"""Cached problem runners.

Twin of ``trajectory_optimization_tpu/opt/runners.py`` (``traj_runner``).
One runner per (problem, config, stop, n_steps), memoized on the hashable
dataclasses; the data are arguments, so the facade reuses one runner for
every cloud of a shape bucket. Pose runners come with the pose model, later.
"""
from __future__ import annotations

import functools

import torch

from trajectory_optimization_tpu_torch.models.traj import TrajProblem, traj_forward
from trajectory_optimization_tpu_torch.opt.engine import EarlyStop, OptimizerConfig, run_until_done


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
