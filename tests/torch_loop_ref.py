"""Plain reference loops of the port's optimization engine: fresh tensors
every step, no static buffers and no capture.

The program runs each of its loops as one static-buffer step
(``opt/engine.py``, ``opt/runners.py``), captured on the card and called
directly on the CPU. These are the same loops written as plain Python, the
reference the program is held to ``torch.equal`` on the CPU
(tests/test_torch_captured_step.py) and on the card
(tests/test_torch_captured_cuda.py, chip_smoke.py):

* ``until_done`` — ``run_until_done``'s masked early-stopping loop, which
  reads ``done`` on the host every ``check_every`` steps; ``optimize``
  wraps it as the engine's ``optimize``;
* ``with_history`` — ``optimize_with_history``;
* ``steps`` — ``n`` Adam steps on from a given state, as ``OptimizerLoop``
  and ``pose_runner``'s ``advance`` take them;
* ``traj_run`` and ``pose_advance`` — ``traj_runner``'s and
  ``pose_runner``'s calls on these loops.

From the loop layer they import only ``value_and_grad``, ``adam_update`` and
``group_lrs``; ``until_done`` is held to the JAX twin
(tests/test_torch_captured_step.py). This module imports torch and the port
only, never JAX.
"""
import math
import types

import torch

from trajectory_optimization_tpu_torch.models.pose import pose_forward
from trajectory_optimization_tpu_torch.models.traj import traj_forward
from trajectory_optimization_tpu_torch.opt.engine import adam_update, group_lrs, value_and_grad

# thresholds no run clears: a fixed-length run
NEVER = types.SimpleNamespace(rewards_th=math.inf, smoothness_th=math.inf,
                              reward_key="mean_reward", smooth_key="loss_smooth")


def adam_state(params):
    """Adam's initial state: zero moments, count 0."""
    device = next(iter(params.values())).device
    return {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def until_done(loss_fn, params, cfg, n_steps, stop, *, pose_key="poses", quat_key="quats",
               check_every=16):
    """Up to ``n_steps`` masked Adam steps: once the gains clear ``stop``'s
    thresholds every update is a no-op, and the loop ends at the next
    multiple of ``check_every``. Returns ``run_until_done``'s dict."""
    lrs = group_lrs(cfg, pose_key, quat_key)
    state = adam_state(params)
    device = next(iter(params.values())).device
    done = torch.zeros((), dtype=torch.bool, device=device)
    i = torch.zeros((), dtype=torch.int64, device=device)
    last_loss = torch.full((), float("inf"), device=device)
    reward0 = torch.full((), 1e-6, device=device)
    smooth0 = torch.zeros((), device=device)
    can_stop = math.isfinite(stop.rewards_th) or math.isfinite(stop.smoothness_th)
    for step in range(int(n_steps)):
        loss, aux, grads = value_and_grad(loss_fn, params)
        params, state = adam_update(grads, state, params, cfg, lrs, frozen=done)
        if step == 0:
            reward0, smooth0 = aux[stop.reward_key], aux[stop.smooth_key]
        last_loss = torch.where(done, last_loss, loss)
        i = i + (~done).to(i.dtype)
        done = done | ((aux[stop.reward_key] / reward0 > stop.rewards_th)
                       & (smooth0 / aux[stop.smooth_key] > stop.smoothness_th))
        if can_stop and (step + 1) % check_every == 0 and bool(done):
            break
    return {"params": params, "state": state, "i": i, "loss": last_loss,
            "reward0": reward0, "smooth0": smooth0}


def optimize(loss_fn, params, cfg, n_steps, *, early_stop=None, pose_key="poses",
             quat_key="quats"):
    """The engine's ``optimize`` on :func:`until_done`: (params, n_iters,
    loss); without ``early_stop``, exactly ``n_steps`` steps."""
    out = until_done(loss_fn, params, cfg, n_steps, early_stop or NEVER, pose_key=pose_key,
                     quat_key=quat_key)
    return out["params"], int(out["i"]), float(out["loss"])


def steps(loss_fn, params, state, cfg, n, *, pose_key="poses", quat_key="quats"):
    """``n`` Adam steps on from ``params`` and ``state``: (params, state,
    loss, aux), the last two of the last step's forward (taken before its
    update); with ``n = 0`` the forward of the parameters given."""
    lrs = group_lrs(cfg, pose_key, quat_key)
    if n == 0:
        with torch.no_grad():
            loss, aux = loss_fn(params)
    for _ in range(n):
        loss, aux, grads = value_and_grad(loss_fn, params)
        params, state = adam_update(grads, state, params, cfg, lrs)
    return params, state, loss, aux


def with_history(loss_fn, params, cfg, n_steps, *, pose_key="poses", quat_key="quats"):
    """``n_steps`` Adam steps: (params, {scalar name: numpy array of its
    value at each step}), the loss's under ``"loss"``."""
    lrs = group_lrs(cfg, pose_key, quat_key)
    state, rows = adam_state(params), []
    for _ in range(int(n_steps)):
        loss, aux, grads = value_and_grad(loss_fn, params)
        params, state = adam_update(grads, state, params, cfg, lrs)
        rows.append(dict({k: v for k, v in aux.items() if v.dim() == 0}, loss=loss))
    keys = rows[0].keys() if rows else ()
    return params, {k: torch.stack([r[k] for r in rows]).cpu().numpy() for k in keys}


def traj_run(problem, cfg, stop, n_steps, params, points, valid, K, poses0, quats0):
    """``traj_runner(problem, cfg, stop, n_steps)``'s call: (params, n_iters,
    final loss, final aux with ``reward0`` and ``smooth0``)."""
    device = params["poses"].device
    points, valid, K, poses0, quats0 = (None if t is None else t.to(device)
                                        for t in (points, valid, K, poses0, quats0))
    points_t = points.t().contiguous()

    def loss_fn(p):
        return traj_forward(p, points, K, poses0, quats0, problem, valid=valid,
                            points_t=points_t)

    out = until_done(loss_fn, params, cfg, n_steps, stop)
    with torch.no_grad():
        final_loss, final_aux = loss_fn(out["params"])
    final_aux["reward0"], final_aux["smooth0"] = out["reward0"], out["smooth0"]
    return out["params"], out["i"], final_loss, final_aux


def pose_advance(problem, cfg, seg_steps, params, opt_state, points, valid, K, occlusion=None):
    """``pose_runner(problem, cfg, seg_steps)``'s ``advance``: (params,
    opt_state, loss, aux)."""
    device = params["trans"].device
    points, valid, K, occlusion = (None if t is None else t.to(device)
                                   for t in (points, valid, K, occlusion))

    def loss_fn(p):
        return pose_forward(p, points, K, problem, valid=valid, occlusion_mask=occlusion)

    return steps(loss_fn, params, opt_state, cfg, seg_steps, pose_key="trans", quat_key="quat")
