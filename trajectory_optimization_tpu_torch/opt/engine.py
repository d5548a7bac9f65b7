"""Optimization engine: two-group Adam, exponential LR decay, early stopping.

Twin of ``trajectory_optimization_tpu/opt/engine.py``:

  * two-group Adam (lr_pose / lr_quat) with the update rule of
    ``optax.adam(eps_root=0)``, which is ``torch.optim.Adam``'s: bias-corrected
    moments, eps added outside the sqrt. It is written as a small functional
    Adam on tensors (``adam_init`` / ``adam_update``) so an update can be
    masked; ``make_optimizer`` wraps it as the twin's ``init``/``update``
    transformation;
  * ExponentialLR stepped every k iterations (:func:`exponential_every`);
  * early stop on the visibility / smoothness gains without a host sync per
    step: ``done`` stays a device bool, every update after it is masked to a
    no-op (parameters, moments and step count all frozen), and the host reads
    ``done`` only every ``check_every`` steps to leave the loop early. The
    result equals the JAX ``lax.while_loop``'s: same ``n_iters``, same
    parameters;
  * on CUDA tensors the step loops run as the JAX engine's jitted loops run,
    as one program: the step is captured once as a CUDA graph over static
    buffers and replayed (``opt/graphs.py``), the first step of a run eager;
    on CPU tensors they run the eager loop. Both give the same bits. A
    generic ``loss_fn`` is captured as ``jax.jit`` traces it: if it reads
    the host, the capture raises. Callers that know their step reads the
    host call the private loops (``_run_until_done``) with ``route="eager"``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from trajectory_optimization_tpu_torch.opt.graphs import StepGraph, device_route, on_capture_stream

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


def _adam_steps(grads: Dict[str, torch.Tensor], state: Dict, cfg: OptimizerConfig, lrs: Dict):
    """Adam's additive updates -lr·m̂/(√v̂ + eps) per parameter, the new
    moments and the new count."""
    count = state["count"]
    count_inc = count + 1
    t = count_inc.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    steps, mu, nu = {}, {}, {}
    for k, g in grads.items():
        m = (1.0 - cfg.b1) * g + cfg.b1 * state["mu"][k]
        v = (1.0 - cfg.b2) * (g * g) + cfg.b2 * state["nu"][k]
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        lr = lrs[k]
        steps[k], mu[k], nu[k] = (-lr(count) if callable(lr) else -lr) * u, m, v
    return steps, mu, nu, count_inc


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
    steps, mu, nu, count_inc = _adam_steps({k: grads[k] for k in params}, state, cfg, lrs)
    new_p = {k: p + steps[k] for k, p in params.items()}
    if frozen is not None:
        keep = lambda old, new: torch.where(frozen, old, new)  # noqa: E731
        new_p = {k: keep(params[k], new_p[k]) for k in params}
        mu = {k: keep(state["mu"][k], mu[k]) for k in params}
        nu = {k: keep(state["nu"][k], nu[k]) for k in params}
        count_inc = keep(count, count_inc)
    return new_p, {"mu": mu, "nu": nu, "count": count_inc}


class GradientTransformation:
    """Two-group Adam as an ``init``/``update`` pair, the shape of the JAX
    twin's optax transformation: ``update(grads, state, params)`` returns
    the additive updates and the new state, and ``apply_updates`` adds
    them. The updates are :func:`adam_update`'s steps, so ``params +
    updates`` equals its new parameters bit for bit."""

    def __init__(self, cfg: OptimizerConfig, lrs: Dict):
        self.cfg, self.lrs = cfg, lrs

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        return adam_init(params)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: Dict, params=None):
        steps, mu, nu, count = _adam_steps(grads, state, self.cfg, self.lrs)
        return steps, {"mu": mu, "nu": nu, "count": count}


def make_optimizer(
    cfg: OptimizerConfig, pose_key: str = "poses", quat_key: str = "quats"
) -> GradientTransformation:
    """Two-group Adam over a {pose_key: ..., quat_key: ...} parameter dict:
    ``lr_pose`` on the first, ``lr_quat`` on the second, each decayed by
    :func:`exponential_every` when ``decay_gamma`` and ``decay_every`` are
    set."""
    return GradientTransformation(cfg, group_lrs(cfg, pose_key, quat_key))


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor], updates: Dict[str, torch.Tensor]):
    """``params + updates``, key by key."""
    return {k: p + updates[k] for k, p in params.items()}


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



def _params_device(params: Dict[str, torch.Tensor]) -> torch.device:
    return next(iter(params.values())).device


def assign(dst, src) -> None:
    """``dst.copy_(src)`` over matching (nested) dicts of tensors."""
    for k, v in src.items():
        if isinstance(v, dict):
            assign(dst[k], v)
        else:
            dst[k].copy_(v)


def clone_tree(tree):
    """A copy of a (nested) dict of tensors."""
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


class AdamStep:
    """The static buffers of one Adam-driven loop and its step: the
    parameters and the Adam state live in tensors whose addresses never
    change, and ``step()`` computes the new ones exactly as the eager loop
    does, then ``copy_``s them back. Capturing ``step`` as a CUDA graph and
    replaying it iterates in place. ``loss_fn`` must read only tensors that
    outlive the object (static inputs or the caller's data).

    ``keep_output`` keeps the loss and aux of the step's forward (taken
    before its update) in static buffers ``loss`` and ``aux``, made by the
    first step; ``frozen`` (a static bool) masks the update as
    ``adam_update`` does."""

    def __init__(self, loss_fn: LossFn, params, cfg: OptimizerConfig, lrs: Dict, *,
                 state: Optional[Dict] = None, keep_output: bool = False):
        self.loss_fn, self.cfg, self.lrs = loss_fn, cfg, lrs
        self.params = clone_tree({k: v.detach() for k, v in params.items()})
        self.state = clone_tree(state) if state is not None else adam_init(self.params)
        self.keep_output = keep_output
        self.loss, self.aux = None, None

    def update(self, frozen: Optional[torch.Tensor] = None):
        """Forward, gradient and masked Adam step on the static buffers:
        (loss, aux) of the forward, the parameters already updated in place."""
        loss, aux, grads = value_and_grad(self.loss_fn, self.params)
        new_p, new_state = adam_update(grads, self.state, self.params, self.cfg, self.lrs,
                                       frozen=frozen)
        assign(self.params, new_p)
        assign(self.state, new_state)
        if self.keep_output:
            if self.loss is None:
                self.loss, self.aux = loss.clone(), clone_tree(aux)
            else:
                self.loss.copy_(loss)
                assign(self.aux, aux)
        return loss, aux

    def step(self) -> None:
        self.update()


class UntilDoneStep(AdamStep):
    """The masked early-stopping loop's static buffers (``done``, ``i``,
    the last loss taken, ``reward0``, ``smooth0``) beside the Adam step's.
    ``step(first=True)`` also records ``reward0`` and ``smooth0``: the
    first step of a run, run eagerly, outside any capture."""

    def __init__(self, loss_fn: LossFn, params, cfg: OptimizerConfig, lrs: Dict,
                 stop: EarlyStop):
        super().__init__(loss_fn, params, cfg, lrs)
        dev = _params_device(self.params)
        self.stop = stop
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.i = torch.zeros((), dtype=torch.int64, device=dev)
        self.last_loss = torch.full((), float("inf"), device=dev)
        self.reward0 = torch.full((), 1e-6, device=dev)
        self.smooth0 = torch.zeros((), device=dev)

    def reset(self, params) -> None:
        """Start a new run from ``params``, every buffer at its initial
        value (``run_until_done``'s)."""
        assign(self.params, params)
        for k in self.params:
            self.state["mu"][k].zero_()
            self.state["nu"][k].zero_()
        self.state["count"].zero_()
        self.done.zero_()
        self.i.zero_()
        self.last_loss.fill_(float("inf"))
        self.reward0.fill_(1e-6)
        self.smooth0.zero_()

    def step(self, first: bool = False) -> None:
        stop, done = self.stop, self.done
        # the update reads `done` before it changes: new values first, copies last
        loss, aux = self.update(frozen=done)
        if first:
            self.reward0.copy_(aux[stop.reward_key])
            self.smooth0.copy_(aux[stop.smooth_key])
        last_loss = torch.where(done, self.last_loss, loss)
        i = self.i + (~done).to(self.i.dtype)
        new_done = done | (
            (aux[stop.reward_key] / self.reward0 > stop.rewards_th)
            & (self.smooth0 / aux[stop.smooth_key] > stop.smoothness_th)
        )
        self.last_loss.copy_(last_loss)
        self.i.copy_(i)
        self.done.copy_(new_done)

    def result(self) -> Dict:
        """``run_until_done``'s dict, on the static buffers themselves."""
        return {"params": self.params, "state": self.state, "i": self.i, "loss": self.last_loss,
                "reward0": self.reward0, "smooth0": self.smooth0}


def drive_until_done(run: UntilDoneStep, graph: StepGraph, n_steps: int, *,
                     check_every: int = 16) -> None:
    """Take up to ``n_steps`` steps: the first eagerly (it records the gains'
    baselines), the rest through ``graph``; read ``done`` on the host every
    ``check_every`` steps, where the eager loop reads it."""
    stop = run.stop
    can_stop = math.isfinite(stop.rewards_th) or math.isfinite(stop.smoothness_th)
    for step in range(n_steps):
        if step == 0:
            run.step(first=True)
        else:
            graph()
        if can_stop and (step + 1) % check_every == 0 and bool(run.done):
            break


def _eager_until_done(loss_fn, params, cfg, n_steps, stop, *, pose_key, quat_key, check_every):
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


def _run_until_done(
    loss_fn: LossFn,
    params: Dict[str, torch.Tensor],
    cfg: OptimizerConfig,
    n_steps: int,
    stop: EarlyStop,
    *,
    route: str,
    pose_key: str = "poses",
    quat_key: str = "quats",
    check_every: int = 16,
):
    """``run_until_done`` on the given route (see ``opt/graphs.py``)."""
    if route == "eager":
        return _eager_until_done(loss_fn, params, cfg, n_steps, stop, pose_key=pose_key,
                                 quat_key=quat_key, check_every=check_every)
    with on_capture_stream(_params_device(params), route):
        run = UntilDoneStep(loss_fn, params, cfg, group_lrs(cfg, pose_key, quat_key), stop)
        drive_until_done(run, StepGraph(run.step, route), int(n_steps), check_every=check_every)
    return run.result()


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
    state, i (steps taken), loss (of the last step taken), reward0, smooth0.
    On CUDA tensors the steps after the first replay one captured step."""
    return _run_until_done(loss_fn, params, cfg, n_steps, stop,
                           route=device_route(_params_device(params)), pose_key=pose_key,
                           quat_key=quat_key, check_every=check_every)


def _optimize(loss_fn, params, cfg, n_steps, *, route: str, early_stop=None,
              pose_key="poses", quat_key="quats"):
    """:func:`optimize` on the given route."""
    out = _run_until_done(
        loss_fn, params, cfg, int(n_steps), early_stop or NEVER, route=route,
        pose_key=pose_key, quat_key=quat_key,
    )
    return out["params"], int(out["i"]), float(out["loss"])


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
    return _optimize(loss_fn, params, cfg, n_steps, route=device_route(_params_device(params)),
                     early_stop=early_stop, pose_key=pose_key, quat_key=quat_key)


class HistoryStep(AdamStep):
    """:func:`optimize_with_history`'s static buffers: besides the Adam
    step's, one (n_steps,) row per scalar of the forward (made by the first
    step) and the device index of the row the next step writes."""

    def __init__(self, loss_fn: LossFn, params, cfg: OptimizerConfig, lrs: Dict, n_steps: int):
        super().__init__(loss_fn, params, cfg, lrs)
        self.n_steps = n_steps
        self.rows: Optional[Dict[str, torch.Tensor]] = None
        self.idx = torch.zeros((1,), dtype=torch.int64, device=_params_device(self.params))

    def step(self) -> None:
        loss, aux = self.update()
        scalars = {k: v for k, v in aux.items() if v.dim() == 0}
        scalars["loss"] = loss
        if self.rows is None:
            self.rows = {k: torch.empty(self.n_steps, dtype=v.dtype, device=v.device)
                         for k, v in scalars.items()}
        for k, v in scalars.items():
            self.rows[k].index_copy_(0, self.idx, v.reshape(1))
        self.idx.add_(1)


def _optimize_with_history(loss_fn, params, cfg, n_steps, *, route: str, pose_key="poses",
                           quat_key="quats"):
    """:func:`optimize_with_history` on the given route."""
    lrs = group_lrs(cfg, pose_key, quat_key)
    n_steps = int(n_steps)
    if route == "eager":
        state = adam_init(params)
        rows = []
        for _ in range(n_steps):
            loss, aux, grads = value_and_grad(loss_fn, params)
            params, state = adam_update(grads, state, params, cfg, lrs)
            scalars = {k: v for k, v in aux.items() if v.dim() == 0}
            scalars["loss"] = loss
            rows.append(scalars)
        keys = rows[0].keys() if rows else ()
        return params, {k: torch.stack([r[k] for r in rows]).cpu().numpy() for k in keys}
    with on_capture_stream(_params_device(params), route):
        run = HistoryStep(loss_fn, params, cfg, lrs, n_steps)
        graph = StepGraph(run.step, route)
        for step in range(n_steps):
            if step == 0:
                run.step()
            else:
                graph()
    rows = run.rows or {}
    return run.params, {k: v.cpu().numpy() for k, v in rows.items()}


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
    and every scalar aux term, as numpy arrays (one host transfer at the end).
    On CUDA tensors each step after the first replays one captured step,
    which writes its scalars into row i of the history on the device."""
    return _optimize_with_history(loss_fn, params, cfg, n_steps,
                                  route=device_route(_params_device(params)),
                                  pose_key=pose_key, quat_key=quat_key)


class OptimizerLoop:
    """Stepwise optimization with persistent state, for callers that
    interleave device steps with host work. ``run(n)`` advances n steps and
    returns the (loss, aux) of the last forward evaluation. On CUDA tensors
    the loop's first step runs eagerly and every later one replays a step
    captured once for the loop."""

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
        self._route = device_route(_params_device(params))
        self._step: Optional[AdamStep] = None  # the static buffers, from the first step
        self._graph: Optional[StepGraph] = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self._params

    @property
    def last_aux(self):
        return self._aux

    def run(self, n: int):
        n = int(n)
        if n == 0:
            with torch.no_grad():
                loss, aux = self._loss_fn(self._params)
        elif self._route == "eager":
            for _ in range(n):
                loss, aux, grads = value_and_grad(self._loss_fn, self._params)
                self._params, self._state = adam_update(
                    grads, self._state, self._params, self._cfg, self._lrs
                )
        else:
            with on_capture_stream(_params_device(self._params), self._route):
                if self._step is None:
                    self._step = AdamStep(self._loss_fn, self._params, self._cfg, self._lrs,
                                          state=self._state, keep_output=True)
                    self._graph = StepGraph(self._step.step, self._route)
                    self._step.step()  # the loop's first step, eagerly
                    n -= 1
                for _ in range(n):
                    self._graph()
            # results the next run leaves alone, as the eager loop's are
            self._params = clone_tree(self._step.params)
            loss, aux = self._step.loss.clone(), clone_tree(self._step.aux)
        self._aux = aux
        return loss, aux
