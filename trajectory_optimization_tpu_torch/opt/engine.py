"""Optimization engine: two-group Adam, exponential LR decay, early stopping.

Twin of ``trajectory_optimization_tpu/opt/engine.py``:

  * two-group Adam (lr_pose / lr_quat) with the update rule of
    ``optax.adam(eps_root=0)``, which is ``torch.optim.Adam``'s: bias-corrected
    moments, eps added outside the sqrt. It is written as a small functional
    Adam on tensors (``adam_init`` / ``adam_update``) so an update can be
    masked;
  * ExponentialLR stepped every k iterations (:func:`exponential_every`);
  * early stop on the visibility / smoothness gains without a host sync per
    step: ``done`` stays a device bool, every update after it is masked to a
    no-op (parameters, moments and step count all frozen), and the host reads
    ``done`` only every ``check_every`` steps to leave the loop early. The
    result equals the JAX ``lax.while_loop``'s: same ``n_iters``, same
    parameters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

LossFn = Callable[[Dict], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
Schedule = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Learning-rate / schedule knobs."""

    lr_pose: float = 0.1
    lr_quat: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    decay_gamma: Optional[float] = None  # ExponentialLR gamma; None = constant LR
    decay_every: Optional[int] = None  # decay period in steps


def exponential_every(base_lr: float, gamma: float, every: int) -> Schedule:
    """LR at update i (0-based) = base·γ^d(i), d(0)=0, d(i)=⌊(i−1)/k⌋+1:
    torch ExponentialLR stepped on iterations {0, k, 2k, ...} after the
    optimizer step."""
    every = max(int(every), 1)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        count = torch.as_tensor(count)
        decays = torch.where(
            count == 0, torch.zeros_like(count), torch.div(count - 1, every, rounding_mode="floor") + 1
        )
        return base_lr * gamma ** decays.to(torch.float32)

    return schedule


def _lr(cfg: OptimizerConfig, base_lr: float):
    if cfg.decay_gamma is not None and cfg.decay_every is not None:
        return exponential_every(base_lr, cfg.decay_gamma, cfg.decay_every)
    return base_lr


def group_lrs(cfg: OptimizerConfig, pose_key: str = "poses", quat_key: str = "quats") -> Dict:
    """{param name: constant LR or schedule} for the two Adam groups."""
    return {pose_key: _lr(cfg, cfg.lr_pose), quat_key: _lr(cfg, cfg.lr_quat)}


def adam_init(params: Dict[str, torch.Tensor]) -> Dict:
    """Adam state: first/second moments per parameter and the step count."""
    device = next(iter(params.values())).device
    return {
        "mu": {k: torch.zeros_like(v) for k, v in params.items()},
        "nu": {k: torch.zeros_like(v) for k, v in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def adam_update(
    grads: Dict[str, torch.Tensor],
    state: Dict,
    params: Dict[str, torch.Tensor],
    cfg: OptimizerConfig,
    lrs: Dict,
    frozen: Optional[torch.Tensor] = None,
):
    """One Adam step; returns (new_params, new_state). Where the device bool
    ``frozen`` is true, parameters and state come back unchanged."""
    count = state["count"]
    count_inc = count + 1
    t = count_inc.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    new_p, mu, nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m = (1.0 - cfg.b1) * g + cfg.b1 * state["mu"][k]
        v = (1.0 - cfg.b2) * (g * g) + cfg.b2 * state["nu"][k]
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        lr = lrs[k]
        step = (-lr(count) if callable(lr) else -lr) * u
        new_p[k], mu[k], nu[k] = p + step, m, v
    if frozen is not None:
        keep = lambda old, new: torch.where(frozen, old, new)  # noqa: E731
        new_p = {k: keep(params[k], new_p[k]) for k in params}
        mu = {k: keep(state["mu"][k], mu[k]) for k in params}
        nu = {k: keep(state["nu"][k], nu[k]) for k in params}
        count_inc = keep(count, count_inc)
    return new_p, {"mu": mu, "nu": nu, "count": count_inc}


def value_and_grad(loss_fn: LossFn, params: Dict[str, torch.Tensor]):
    """(loss, aux, grads) with loss and aux detached."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss, aux = loss_fn(leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {
        k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(leaves.items(), grads)
    }
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


@dataclasses.dataclass(frozen=True)
class EarlyStop:
    """Stop when mean-reward gain and smoothness gain clear thresholds; gains
    are measured against the first forward pass's values."""

    rewards_th: float = 1.2
    smoothness_th: float = 0.9
    reward_key: str = "mean_reward"
    smooth_key: str = "loss_smooth"


NEVER = EarlyStop(rewards_th=float("inf"), smoothness_th=float("inf"))


def run_until_done(
    loss_fn: LossFn,
    params: Dict[str, torch.Tensor],
    cfg: OptimizerConfig,
    n_steps: int,
    stop: EarlyStop,
    *,
    pose_key: str = "poses",
    quat_key: str = "quats",
    check_every: int = 16,
):
    """The masked early-stopping loop shared by :func:`optimize` and
    ``opt.runners.traj_runner``. Returns a dict of device tensors: params,
    state, i (steps taken), loss (of the last step taken), reward0, smooth0."""
    lrs = group_lrs(cfg, pose_key, quat_key)
    state = adam_init(params)
    device = next(iter(params.values())).device
    done = torch.zeros((), dtype=torch.bool, device=device)
    i = torch.zeros((), dtype=torch.int64, device=device)
    last_loss = torch.full((), float("inf"), device=device)
    reward0 = torch.full((), 1e-6, device=device)
    smooth0 = torch.zeros((), device=device)
    can_stop = math.isfinite(stop.rewards_th) or math.isfinite(stop.smoothness_th)
    for step in range(n_steps):
        loss, aux, grads = value_and_grad(loss_fn, params)
        params, state = adam_update(grads, state, params, cfg, lrs, frozen=done)
        if step == 0:
            reward0, smooth0 = aux[stop.reward_key], aux[stop.smooth_key]
        last_loss = torch.where(done, last_loss, loss)
        i = i + (~done).to(i.dtype)
        done = done | (
            (aux[stop.reward_key] / reward0 > stop.rewards_th)
            & (smooth0 / aux[stop.smooth_key] > stop.smoothness_th)
        )
        if can_stop and (step + 1) % check_every == 0 and bool(done):
            break
    return {"params": params, "state": state, "i": i, "loss": last_loss,
            "reward0": reward0, "smooth0": smooth0}


def optimize(
    loss_fn: LossFn,
    params: Dict[str, torch.Tensor],
    cfg: OptimizerConfig,
    n_steps: int,
    *,
    early_stop: Optional[EarlyStop] = None,
    pose_key: str = "poses",
    quat_key: str = "quats",
):
    """Run the optimization; return (params, n_iters, loss). With
    ``early_stop`` the run ends once the gain thresholds clear; without, it
    takes exactly ``n_steps`` steps."""
    out = run_until_done(
        loss_fn, params, cfg, int(n_steps), early_stop or NEVER,
        pose_key=pose_key, quat_key=quat_key,
    )
    return out["params"], int(out["i"]), float(out["loss"])


def optimize_with_history(
    loss_fn: LossFn,
    params: Dict[str, torch.Tensor],
    cfg: OptimizerConfig,
    n_steps: int,
    *,
    pose_key: str = "poses",
    quat_key: str = "quats",
):
    """Fixed-length optimization returning the per-step history of the loss
    and every scalar aux term, as numpy arrays (one host transfer at the end)."""
    lrs = group_lrs(cfg, pose_key, quat_key)
    state = adam_init(params)
    rows = []
    for _ in range(int(n_steps)):
        loss, aux, grads = value_and_grad(loss_fn, params)
        params, state = adam_update(grads, state, params, cfg, lrs)
        scalars = {k: v for k, v in aux.items() if v.dim() == 0}
        scalars["loss"] = loss
        rows.append(scalars)
    keys = rows[0].keys() if rows else ()
    history = {k: torch.stack([r[k] for r in rows]).cpu().numpy() for k in keys}
    return params, history


class OptimizerLoop:
    """Stepwise optimization with persistent state, for callers that
    interleave device steps with host work. ``run(n)`` advances n steps and
    returns the (loss, aux) of the last forward evaluation."""

    def __init__(
        self,
        loss_fn: LossFn,
        params: Dict[str, torch.Tensor],
        cfg: OptimizerConfig,
        *,
        pose_key: str = "poses",
        quat_key: str = "quats",
    ):
        self._loss_fn = loss_fn
        self._cfg = cfg
        self._lrs = group_lrs(cfg, pose_key, quat_key)
        self._params = params
        self._state = adam_init(params)
        self._aux = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self._params

    @property
    def last_aux(self):
        return self._aux

    def run(self, n: int):
        if int(n) == 0:
            with torch.no_grad():
                loss, aux = self._loss_fn(self._params)
        for _ in range(int(n)):
            loss, aux, grads = value_and_grad(self._loss_fn, self._params)
            self._params, self._state = adam_update(
                grads, self._state, self._params, self._cfg, self._lrs
            )
        self._aux = aux
        return loss, aux
