"""The port's spans (``utils/profiling.span``) on the CPU.

Held: under a CPU ``torch.profiler`` the facades record their spans in
order, nested in the root span and on the caller's thread; the captured
runners' phases, their steps called uncaptured on the CPU, record theirs; an
occlusion-aware facade call records the soft gate's span once per scored
waypoint in its first step and its final forward, the binned tiles' span
inside it; with no profiler on a span never enters ``record_function``;
a capture on a
stub graph records its seconds and adds no span of its own; a runner past
``MAX_BUCKETS`` shapes drops the least recently used bucket.
"""
import functools
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from trajectory_optimization_tpu_torch import api
from trajectory_optimization_tpu_torch.models import traj_frozen
from trajectory_optimization_tpu_torch.models.pose import PoseProblem, init_pose_params
from trajectory_optimization_tpu_torch.models.traj import TrajProblem, init_traj_params
from trajectory_optimization_tpu_torch.ops import hpr
from trajectory_optimization_tpu_torch.opt import graphs as tg
from trajectory_optimization_tpu_torch.opt import runners as tr
from trajectory_optimization_tpu_torch.opt.engine import NEVER, OptimizerConfig, adam_init
from trajectory_optimization_tpu_torch.utils import profiling as tp
from trajectory_optimization_tpu_torch.utils.data import identity_quaternions, pad_points
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics

INTR = default_intrinsics()
CFG = OptimizerConfig(lr_pose=0.1, lr_quat=0.02)
EVERY = 40  # a 1,012-point cut of cloud 10 keeps each call to a fraction of a second
SOFT_WAYPOINTS = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pts(cloud10):
    return cloud10[::EVERY]


def _spans(prof):
    """[(name, start ns, end ns, thread)] of the trace's program spans, by start."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events() if e.name().startswith(tp.PREFIX)]
    return sorted(out, key=lambda s: s[1])


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof)


def _assert_nested(spans, root):
    (name, t0, t1, thread), children = spans[0], spans[1:]
    assert name == root
    assert all(t0 <= a and b <= t1 and th == thread for _, a, b, th in children), spans
    # siblings follow each other, none overlapping the next
    assert all(b <= a_next for (_, _, b, _), (_, a_next, _, _) in zip(children, children[1:]))


def test_span_names_carry_the_prefix():
    names = [v for k, v in vars(tp).items() if k.startswith(("FACADE_", "RUNNER_"))]
    names += [tp.HPR_GATE, hpr.SOFT_DOMINANCE_RANGE, hpr.SOFT_BINNED_RANGE,
              traj_frozen.FROZEN_TILES_RANGE]
    assert len(names) == 11 and len(set(names)) == 11
    assert all(n.startswith(tp.PREFIX) for n in names)


def test_trajectory_facade_records_its_spans_in_order(pts, path10):
    opt = api.TrajectoryOptimizer(device="cpu", lr_pose=0.1, lr_quat=0.02)
    spans = _traced(lambda: opt.optimize(pts, path10, n_steps=2))
    # the runner's phases, as on the card: its step is called uncaptured here
    assert [s[0] for s in spans] == [tp.FACADE_OPTIMIZE, tp.FACADE_PREPARE, tp.RUNNER_LOAD,
                                     tp.RUNNER_LOAD, tp.RUNNER_FIRST_STEP, tp.RUNNER_REPLAYS,
                                     tp.RUNNER_FINAL_FORWARD, tp.FACADE_FETCH]
    _assert_nested(spans, tp.FACADE_OPTIMIZE)


def test_pose_facade_records_its_spans_in_order(pts):
    opt = api.PoseOptimizer(device="cpu", lr_pose=0.1, lr_quat=0.02, use_hpr=True)
    spans = _traced(lambda: opt.optimize(pts, np.array([0.0, 0.0, 1.0]), n_steps=2))
    # the pose runner's phases (it has no final forward), as on the card
    assert [s[0] for s in spans] == [tp.FACADE_OPTIMIZE, tp.FACADE_PREPARE, tp.RUNNER_LOAD,
                                     tp.RUNNER_LOAD, tp.RUNNER_FIRST_STEP, tp.RUNNER_REPLAYS,
                                     tp.FACADE_FETCH]
    _assert_nested(spans, tp.FACADE_OPTIMIZE)


def _traj_args(pts, path):
    padded, valid = pad_points(pts)
    quats = identity_quaternions(len(path))
    params = init_traj_params(path, quats, "cpu")
    return (params, torch.as_tensor(padded), torch.as_tensor(valid), INTR.matrix(device="cpu"),
            torch.as_tensor(path), torch.as_tensor(quats))


def test_static_trajectory_route_records_the_runner_phases(pts, path10):
    prob = TrajProblem(img_width=INTR.width, img_height=INTR.height, wps_step=2)
    runner = tr.TrajRunner(prob, CFG, NEVER, 3)
    args = _traj_args(pts, path10)
    spans = _traced(lambda: runner(*args))
    assert [s[0] for s in spans] == [tp.RUNNER_LOAD, tp.RUNNER_LOAD, tp.RUNNER_FIRST_STEP,
                                     tp.RUNNER_REPLAYS, tp.RUNNER_FINAL_FORWARD]
    # the second run reuses the bucket: the same phases, no bucket made
    assert [s[0] for s in _traced(lambda: runner(*args))] == [s[0] for s in spans]
    assert len(runner.buckets) == 1


def test_static_pose_route_records_the_first_step_once(pts):
    prob = PoseProblem(img_width=INTR.width, img_height=INTR.height)
    advance = tr.PoseAdvance(prob, CFG, 3)
    padded, valid = pad_points(pts)
    params = init_pose_params(np.zeros((1, 3), np.float32),
                              np.array([[1.0, 0.0, 0.0, 0.0]], np.float32), "cpu")
    args = (params, adam_init(params), torch.as_tensor(padded), torch.as_tensor(valid),
            INTR.matrix(device="cpu"))
    first = [s[0] for s in _traced(lambda: advance(*args))]
    assert first == [tp.RUNNER_LOAD, tp.RUNNER_LOAD, tp.RUNNER_FIRST_STEP, tp.RUNNER_REPLAYS]
    # the bucket is warm: every step of the next call replays
    later = [s[0] for s in _traced(lambda: advance(*args))]
    assert later == [tp.RUNNER_LOAD, tp.RUNNER_LOAD, tp.RUNNER_REPLAYS]


def _soft_call(mp):
    """A 3-step call of the occlusion-aware facade (on the CPU the step the
    card captures, called uncaptured: a first step, the replays and a final
    forward), the binned tier forced at 1,536 points."""
    mp.setattr(api, "TrajProblem",
               functools.partial(TrajProblem, soft_hpr_dense_max=0, hpr_cap=64))
    rng = np.random.default_rng(3)
    points = rng.uniform(-6.0, 6.0, (1536, 3)).astype(np.float32)
    path = np.stack([np.linspace(-2.0, 1.0, SOFT_WAYPOINTS), np.zeros(SOFT_WAYPOINTS),
                     np.zeros(SOFT_WAYPOINTS)], axis=1).astype(np.float32)
    opt = api.TrajectoryOptimizer(soft_hpr=True, lr_quat=0.05, device="cpu")
    return lambda: opt.optimize(points, path, n_steps=3)


@pytest.fixture(scope="module")
def soft_spans():
    tr.traj_runner.cache_clear()
    with pytest.MonkeyPatch.context() as mp:
        spans = _traced(_soft_call(mp))
    tr.traj_runner.cache_clear()
    return spans


def _inside(spans, inner, outer):
    return [s for s in spans if s[0] == inner
            and any(o[0] == outer and o[1] <= s[1] and s[2] <= o[2] for o in spans)]


@pytest.mark.parametrize("phase", [tp.RUNNER_FIRST_STEP, tp.RUNNER_FINAL_FORWARD])
def test_soft_facade_records_the_gate_span_in_each_eager_phase(phase, soft_spans):
    (root, t0, t1, thread), inner = soft_spans[0], soft_spans[1:]
    assert root == tp.FACADE_OPTIMIZE
    assert all(t0 <= a and b <= t1 and th == thread for _, a, b, th in inner)
    gates = _inside(soft_spans, tp.HPR_GATE, phase)
    # the first step's forward and the backward's recomputation of each
    # checkpointed waypoint; the final forward once
    assert len(gates) == SOFT_WAYPOINTS * (2 if phase == tp.RUNNER_FIRST_STEP else 1)
    assert len(_inside(soft_spans, hpr.SOFT_BINNED_RANGE, tp.HPR_GATE)) >= len(gates)


def test_no_profiler_never_enters_record_function(pts, path10, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler on")

    soft = _soft_call(monkeypatch)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tp.span(tp.FACADE_OPTIMIZE) is tp.span(tp.RUNNER_REPLAYS)  # one shared null context
    assert tp.span(tp.HPR_GATE) is tp.span(tp.RUNNER_REPLAYS)
    api.TrajectoryOptimizer(device="cpu").optimize(pts, path10, n_steps=2)
    prob = TrajProblem(img_width=INTR.width, img_height=INTR.height, wps_step=2)
    tr.TrajRunner(prob, CFG, NEVER, 2)(*_traj_args(pts, path10))
    tr.traj_runner.cache_clear()
    soft()
    tr.traj_runner.cache_clear()


class _StubGraph:
    """Stands in for torch.cuda.CUDAGraph: runs nothing."""

    def capture_begin(self, capture_error_mode="global"):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


@pytest.fixture
def stub_cuda(monkeypatch):
    stream = types.SimpleNamespace(device=torch.device("cuda", 0), cuda_stream=7)
    monkeypatch.setattr(tg.torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(tg.torch.cuda, "current_stream", lambda *a: stream)
    return stream


def test_a_capture_counts_once_with_its_seconds(stub_cuda, monkeypatch):
    begun = []
    monkeypatch.setattr(_StubGraph, "capture_begin", lambda self, **kw: begun.append(kw))
    g = tg.StepGraph(lambda: None, torch.device("cuda", 0))
    spans = _traced(lambda: [g() for _ in range(3)])
    assert len(begun) == 1 and g.replays == 3 and g.capture_s > 0
    # the capture runs inside the caller's replays span and adds none of its own
    assert spans == []


def test_a_bucket_past_the_limit_is_evicted_and_counted():
    buckets = tr._Buckets()
    made = []

    def make(key):
        return lambda: made.append(key) or key

    for key in range(tr.MAX_BUCKETS):
        buckets.get(key, make(key))
    buckets.get(0, make(0))  # kept: no bucket made, 0 the most recently used
    buckets.get(tr.MAX_BUCKETS, make(tr.MAX_BUCKETS))
    assert made == list(range(tr.MAX_BUCKETS + 1)) and len(buckets) == tr.MAX_BUCKETS
    buckets.get(0, make(0))  # 1, the least recently used, went; 0 stayed
    buckets.get(1, make(1))
    assert made[tr.MAX_BUCKETS + 1:] == [1] and len(buckets) == tr.MAX_BUCKETS
