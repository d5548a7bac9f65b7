"""Cached problem runners.

Twin of ``trajectory_optimization_tpu/opt/runners.py`` (``traj_runner``,
``pose_runner``). One runner per (problem, config, ...), memoized on the
hashable dataclasses; the data are arguments, so the facade and the nodes
reuse one runner for every cloud of a shape bucket.

On a CUDA device a runner keeps, per shape bucket (what the JAX jit
retraces on: the shapes and dtypes of the parameters and data, the
runner's static configuration being its cache key), static buffers for
the data and the optimizer state and one captured step (``opt/graphs.py``):
each call copies its data into the bucket's buffers and replays the step.
A cached bucket holds its graph's private memory pool (the step's
intermediates) and its static buffers (points, their (3, N) transpose,
valid, K, the initial path, the parameters and Adam state, the last
outputs); ``MAX_BUCKETS`` of them per runner, the least recently used
dropped first. The parameters' device is the run's device: data given on
another device (a node's host arrays) is copied there. Configurations whose
step reads the host (``models.traj.capture_route``) and CPU tensors run
the eager loop.
"""
from __future__ import annotations

import collections
import functools
import threading

import torch

from trajectory_optimization_tpu_torch.models.pose import PoseProblem, pose_forward
from trajectory_optimization_tpu_torch.models.traj import TrajProblem, capture_route, traj_forward
from trajectory_optimization_tpu_torch.opt.engine import (
    AdamStep,
    EarlyStop,
    OptimizerConfig,
    UntilDoneStep,
    _run_until_done,
    adam_init,
    adam_update,
    assign,
    clone_tree,
    drive_until_done,
    group_lrs,
    value_and_grad,
)
from trajectory_optimization_tpu_torch.opt.graphs import StepGraph, device_route, on_capture_stream

MAX_BUCKETS = 8  # captured shape buckets kept per runner


def _signature(*tensors):
    return tuple(None if t is None else (tuple(t.shape), t.dtype) for t in tensors)


def _static(t, device):
    """A static buffer holding a copy of ``t`` on ``device`` (None stays None)."""
    return None if t is None else t.detach().to(device, copy=True).contiguous()


class _Buckets:
    """Per-runner buckets, least recently used dropped past MAX_BUCKETS."""

    def __init__(self):
        self._items = collections.OrderedDict()
        self._lock = threading.Lock()

    def get(self, key, make):
        with self._lock:
            b = self._items.get(key)
            if b is None:
                b = self._items[key] = make()
                while len(self._items) > MAX_BUCKETS:
                    self._items.popitem(last=False)
            self._items.move_to_end(key)
            return b

    def __len__(self):
        return len(self._items)


class _TrajBucket:
    """One shape bucket of ``traj_runner``: the data's static buffers, the
    early-stopping loop's (``UntilDoneStep``) and its captured step."""

    def __init__(self, problem, cfg, stop, route, device, params, points, valid, K, poses0,
                 quats0):
        self.lock = threading.Lock()
        self.points = _static(points, device)
        self.points_t = self.points.t().contiguous()  # SoA once per bucket, refreshed per run
        self.valid, self.K = _static(valid, device), _static(K, device)
        self.poses0, self.quats0 = _static(poses0, device), _static(quats0, device)
        self.problem = problem
        self.run = UntilDoneStep(self.loss_fn, {k: v.to(device) for k, v in params.items()}, cfg,
                                 group_lrs(cfg), stop)
        self.graph = StepGraph(self.run.step, route, "trajectory step")

    def loss_fn(self, p):
        return traj_forward(p, self.points, self.K, self.poses0, self.quats0, self.problem,
                            valid=self.valid, points_t=self.points_t)

    def load(self, points, valid, K, poses0, quats0) -> None:
        self.points.copy_(points)
        self.points_t.copy_(points.t())
        for dst, src in ((self.valid, valid), (self.K, K), (self.poses0, poses0),
                         (self.quats0, quats0)):
            if dst is not None:
                dst.copy_(src)


class TrajRunner:
    """``traj_runner``'s callable: run(params, points, valid, K, poses0,
    quats0) -> (params, n_iters, final_loss, final_aux)."""

    def __init__(self, problem: TrajProblem, cfg: OptimizerConfig, stop: EarlyStop,
                 n_steps: int):
        self.problem, self.cfg, self.stop, self.n_steps = problem, cfg, stop, int(n_steps)
        self.buckets = _Buckets()

    def __call__(self, params, points, valid, K, poses0, quats0):
        device = params["poses"].device
        route = device_route(device, capture_route(self.problem, points.shape[0]))
        return self._run(route, params, points, valid, K, poses0, quats0)

    def _run(self, route, params, points, valid, K, poses0, quats0):
        """``__call__`` on the given route (see ``opt/graphs.py``)."""
        device = params["poses"].device
        if route == "eager":
            return self._run_eager(params, *(None if t is None else t.to(device)
                                             for t in (points, valid, K, poses0, quats0)))
        key = (route, device, _signature(*params.values(), points, valid, K, poses0, quats0))
        b = self.buckets.get(key, lambda: _TrajBucket(
            self.problem, self.cfg, self.stop, route, device, params, points, valid, K, poses0,
            quats0))
        with b.lock:
            with on_capture_stream(device, route):
                b.load(points, valid, K, poses0, quats0)
                b.run.reset(params)
                drive_until_done(b.run, b.graph, self.n_steps)
            # the final forward stays eager, on the caller's stream
            with torch.no_grad():
                final_loss, final_aux = b.loss_fn(b.run.params)
            final_aux["reward0"] = b.run.reward0.clone()
            final_aux["smooth0"] = b.run.smooth0.clone()
            return clone_tree(b.run.params), b.run.i.clone(), final_loss, final_aux

    def _run_eager(self, params, points, valid, K, poses0, quats0):
        points_t = points.t().contiguous()  # SoA once per problem, not per step
        problem = self.problem

        def loss_fn(p):
            return traj_forward(
                p, points, K, poses0, quats0, problem, valid=valid, points_t=points_t
            )

        out = _run_until_done(loss_fn, params, self.cfg, self.n_steps, self.stop, route="eager")
        with torch.no_grad():
            final_loss, final_aux = loss_fn(out["params"])
        final_aux["reward0"] = out["reward0"]
        final_aux["smooth0"] = out["smooth0"]
        return out["params"], out["i"], final_loss, final_aux


@functools.lru_cache(maxsize=64)
def traj_runner(problem: TrajProblem, cfg: OptimizerConfig, stop: EarlyStop, n_steps: int):
    """Full trajectory optimization:
    run(params, points, valid, K, poses0, quats0)
      -> (params, n_iters, final_loss, final_aux)
    with every result a tensor on the parameters' device. Early stop runs
    without a host sync per step (``opt.engine.run_until_done``); the final
    forward's aux carries ``reward0`` and ``smooth0``, the first step's
    values. On the card the steps after each run's first replay the
    bucket's captured step; the final forward runs eagerly.
    """
    return TrajRunner(problem, cfg, stop, n_steps)


class _PoseBucket:
    def __init__(self, problem, cfg, route, device, params, opt_state, points, valid, K,
                 occlusion):
        self.lock = threading.Lock()
        self.points, self.valid = _static(points, device), _static(valid, device)
        self.K, self.occlusion = _static(K, device), _static(occlusion, device)
        self.problem = problem
        self.step = AdamStep(self.loss_fn, params, cfg, group_lrs(cfg, "trans", "quat"),
                             state=opt_state, keep_output=True)
        self.graph = StepGraph(self.step.step, route, "pose step")
        self.warm = False  # the bucket's first step runs eagerly

    def loss_fn(self, p):
        return pose_forward(p, self.points, self.K, self.problem, valid=self.valid,
                            occlusion_mask=self.occlusion)

    def load(self, params, opt_state, points, valid, K, occlusion) -> None:
        assign(self.step.params, params)
        assign(self.step.state, opt_state)
        for dst, src in ((self.points, points), (self.valid, valid), (self.K, K),
                         (self.occlusion, occlusion)):
            if dst is not None:
                dst.copy_(src)


class PoseAdvance:
    """``pose_runner``'s ``advance``: seg_steps Adam steps on from the
    given parameters and state."""

    def __init__(self, problem: PoseProblem, cfg: OptimizerConfig, seg_steps: int):
        self.problem, self.cfg, self.seg_steps = problem, cfg, int(seg_steps)
        self.lrs = group_lrs(cfg, "trans", "quat")
        self.buckets = _Buckets()

    def __call__(self, params, opt_state, points, valid, K, occlusion=None):
        device = params["trans"].device
        route = device_route(device, capture_route(self.problem, points.shape[0]))
        return self._advance(route, params, opt_state, points, valid, K, occlusion)

    def _advance(self, route, params, opt_state, points, valid, K, occlusion=None):
        """``__call__`` on the given route (see ``opt/graphs.py``)."""
        device = params["trans"].device
        if route == "eager" or self.seg_steps == 0:
            data = (None if t is None else t.to(device) for t in (points, valid, K, occlusion))
            return self._advance_eager(params, opt_state, *data)
        key = (route, device, _signature(*params.values(), *opt_state["mu"].values(),
                                         opt_state["count"], points, valid, K, occlusion))
        b = self.buckets.get(key, lambda: _PoseBucket(
            self.problem, self.cfg, route, device, params, opt_state, points, valid, K,
            occlusion))
        with b.lock:
            with on_capture_stream(device, route):
                b.load(params, opt_state, points, valid, K, occlusion)
                for _ in range(self.seg_steps):
                    if b.warm:
                        b.graph()
                    else:
                        b.step.step()
                        b.warm = True
            return (clone_tree(b.step.params), clone_tree(b.step.state), b.step.loss.clone(),
                    clone_tree(b.step.aux))

    def _advance_eager(self, params, opt_state, points, valid, K, occlusion):
        problem = self.problem

        def loss_fn(p):
            return pose_forward(p, points, K, problem, valid=valid, occlusion_mask=occlusion)

        if self.seg_steps == 0:
            with torch.no_grad():
                loss, aux = loss_fn(params)
        for _ in range(self.seg_steps):
            loss, aux, grads = value_and_grad(loss_fn, params)
            params, opt_state = adam_update(grads, opt_state, params, self.cfg, self.lrs)
        return params, opt_state, loss, aux


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
    continues from one segment to the next. On the card a bucket's first
    step runs eagerly and every later one replays its captured step.
    """
    return adam_init, PoseAdvance(problem, cfg, seg_steps)
