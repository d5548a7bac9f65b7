"""The captured optimization step on the card (opt/graphs.py): each step
after a run's first replays one CUDA graph over static buffers, and must
give the bits of the plain loop of tests/torch_loop_ref.py run on the card.

Every test here needs a CUDA card and is marked ``cuda``; without one each
skips (a CUDA graph has no CPU mode; tests/test_torch_captured_step.py
holds the same static-buffer steps uncaptured on the CPU). The file imports
neither JAX nor the JAX package and uses no conftest fixture:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_captured_cuda.py
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_loop_ref as plain  # noqa: E402
from trajectory_optimization_tpu_torch.models import pose as tpose  # noqa: E402
from trajectory_optimization_tpu_torch.models import traj as tt  # noqa: E402
from trajectory_optimization_tpu_torch.ops import _kernels  # noqa: E402
from trajectory_optimization_tpu_torch.ops import fused_vis as fv  # noqa: E402
from trajectory_optimization_tpu_torch.opt import engine as te  # noqa: E402
from trajectory_optimization_tpu_torch.opt import graphs as tg  # noqa: E402
from trajectory_optimization_tpu_torch.opt import runners as tr  # noqa: E402
from trajectory_optimization_tpu_torch.utils.data import (  # noqa: E402
    identity_quaternions,
    load_path,
    load_point_cloud,
    pad_points,
)
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

pytestmark = pytest.mark.cuda

DATA = Path(__file__).resolve().parents[1] / "data"
INTR = default_intrinsics()
CFG = te.OptimizerConfig(lr_pose=0.1, lr_quat=0.02)
# each regime's visibility kernels and the trajectory loss's kernels around them
LOSS = {"traj_head", "make_norm", "traj_loss", "lo_cotangent", "traj_tail"}
CACHED = {"pass_a", "pass_b", "bwd_stats", "bwd_apply", "alpha_beta"} | LOSS
UNCACHED = {"pass_a_minmax", "pass_b_recompute", "bwd_fused_acc"} | LOSS


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _data(dev, pts, path):
    padded, valid = pad_points(pts)
    q = identity_quaternions(len(path))
    prob = tt.TrajProblem(INTR.width, INTR.height, wps_step=tt.waypoint_stride(path))
    return prob, path, q, (torch.as_tensor(padded, device=dev), torch.as_tensor(valid, device=dev),
                           INTR.matrix(device=dev), torch.as_tensor(path, device=dev),
                           torch.as_tensor(q, device=dev))


@pytest.fixture(scope="module")
def ref(dev):
    """Cloud 10 and path 10 as the facade pads them (W = 14 selected)."""
    return _data(dev, load_point_cloud(str(DATA / "points/point_cloud_10.npz")),
                 load_path(str(DATA / "paths/path_poses_10.npz")))


def _wide(dev, n=65_536, w=50):
    """A seeded cloud of n points and a path of w waypoints, stride 1."""
    pts = np.random.default_rng(3).uniform(-20, 20, size=(n, 3)).astype(np.float32)
    t = np.linspace(0, 1, w, dtype=np.float32)
    path = np.stack([30 * t, 10 * np.sin(4 * t), np.zeros_like(t)], axis=1)
    return _data(dev, pts, path.astype(np.float32))


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def _run(runner, case, dev, loop="captured"):
    """``runner``'s call on ``case`` (``loop="plain"``: the same call on the
    plain loop) and the kernel launches it made."""
    _, path, q, data = case
    call = runner if loop == "captured" else (lambda *a: plain.traj_run(
        runner.problem, runner.cfg, runner.stop, runner.n_steps, *a))
    torch.cuda.synchronize()
    before = dict(_kernels.LAUNCHES)
    out = call(tt.init_traj_params(path, q, dev), *data)
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in _kernels.LAUNCHES.items() if v != before[k]}


def _assert_runs_equal(got, want):
    assert int(got[1]) == int(want[1])
    assert _equal(got[0], want[0]) and torch.equal(got[2], want[2]) and _equal(got[3], want[3])


@pytest.mark.parametrize("regime", ["cached", "uncached"])
@pytest.mark.parametrize("stop", ["never", "early"])
def test_captured_run_equals_eager(dev, ref, regime, stop, monkeypatch):
    """Cloud 10 x path 10 through the trajectory runner: the captured run's
    parameters, n_iters, final loss and aux torch.equal to the plain
    loop's, in the score-cache regime (K1-K4) and with the cache forced
    off (K1', K2', K5), the same launches in both; a second captured run
    replays the bucket's graph and is equal again."""
    if regime == "uncached":
        monkeypatch.setattr(fv, "SCORE_CACHE_MAX_BYTES", 0)
    early = te.EarlyStop(rewards_th=1.05, smoothness_th=0.5)
    runner = tr.TrajRunner(ref[0], CFG, te.NEVER if stop == "never" else early, 40)
    (got, lg), (want, le) = _run(runner, ref, dev), _run(runner, ref, dev, "plain")
    _assert_runs_equal(got, want)
    assert lg == le and set(lg) == (CACHED if regime == "cached" else UNCACHED)
    assert (int(got[1]) == 40) == (stop == "never")
    graph = next(iter(runner.buckets._items.values())).graph
    replays = graph.replays
    assert graph.graph is not None and replays > 0
    again, la = _run(runner, ref, dev)
    _assert_runs_equal(again, want)
    assert la == le and graph.replays == 2 * replays


def test_a_graph_keeps_its_scratch_when_a_larger_problem_grows_it(dev, ref):
    """Capture at W = 14 with a fresh K3/K4 scratch, run W = 50 on 65,536
    points (which replaces the stream's scratch with a larger one), then
    replay the first graph: still equal to the plain run."""
    side = tg.capture_stream(dev)
    _kernels._reduction_scratch.pop((dev, side.cuda_stream), None)
    small = tr.TrajRunner(ref[0], CFG, te.NEVER, 12)
    first, _ = _run(small, ref, dev)
    held = next(iter(small.buckets._items.values())).graph.scratch
    wide = _wide(dev)
    _run(tr.TrajRunner(wide[0], CFG, te.NEVER, 3), wide, dev)
    grown = _kernels._reduction_scratch[(dev, side.cuda_stream)]
    assert held is not None and grown[1] is not held[1]
    assert grown[1].numel() > held[1].numel()
    again, _ = _run(small, ref, dev)
    want, _ = _run(small, ref, dev, "plain")
    _assert_runs_equal(first, want)
    _assert_runs_equal(again, want)


def test_a_loss_that_reads_the_host_fails_to_capture(dev, ref):
    """A loss that reads a value on the host cannot be captured: the engine
    raises CaptureError (as a jitted loss raises on a concrete read), and
    the card works after it."""
    prob, path, q, (P, V, K, p0, q0) = ref

    def loss_fn(p):
        loss, aux = tt.traj_forward(p, P, K, p0, q0, prob, valid=V)
        return loss * (1.0 if aux["mean_reward"].item() > 0 else 2.0), aux

    with pytest.raises(tg.CaptureError, match="capturing the optimization step"):
        te.optimize(loss_fn, tt.init_traj_params(path, q, dev), CFG, 3)
    assert float(torch.ones(4, device=dev).sum()) == 4.0
    out, n, _ = te.optimize(loss_fn, tt.init_traj_params(path, q, dev), CFG, 1)  # nothing replays
    assert n == 1


def test_captured_pose_runner_equals_eager(dev):
    """Two segments of 5 steps and a 3-step remainder (a second bucket) on
    cloud 10 with a decaying LR: every segment torch.equal to the plain one."""
    padded, valid = pad_points(load_point_cloud(str(DATA / "points/point_cloud_10.npz")))
    P, V = torch.as_tensor(padded, device=dev), torch.as_tensor(valid, device=dev)
    K = INTR.matrix(device=dev)
    cfg = te.OptimizerConfig(lr_pose=0.1, lr_quat=0.05, decay_gamma=0.5, decay_every=2)
    prob = tpose.PoseProblem(INTR.width, INTR.height)
    segs = {"captured": (tr.PoseAdvance(prob, cfg, 5), tr.PoseAdvance(prob, cfg, 3)),
            "plain": tuple((lambda *a, n=n: plain.pose_advance(prob, cfg, n, *a)) for n in (5, 3))}
    outs = {}
    for loop, (seg, rem) in segs.items():
        params = tpose.init_pose_params(np.array([[6.0, 2.0, 0.0]], np.float32),
                                        np.array([[0.9, 0.1, -0.2, 0.3]], np.float32), dev)
        state, outs[loop] = te.adam_init(params), []
        for adv in (seg, seg, rem):
            params, state, loss, aux = adv(params, state, P, V, K)
            outs[loop].append((params, state, loss, aux))
    for g, e in zip(outs["captured"], outs["plain"]):
        assert _equal(g[0], e[0]) and _equal(g[1], e[1]) and torch.equal(g[2], e[2])
        assert _equal(g[3], e[3])
    assert int(outs["captured"][-1][1]["count"]) == 13


def test_captured_soft_binned_trajectory(dev, ref):
    """Soft HPR on cloud 10 (40,960 points, above ``soft_hpr_dense_max``:
    the binned tier on its static tile slots, cap 512) through the
    trajectory runner: the step captures (no CaptureError) and replays, two
    plain runs agree bit for bit (the backward adds its rows in a fixed
    order), and the captured run is torch.equal to them. Both loops launch
    the binned tiles' two kernels and the layout's seven and no other
    kernel of the port's: per step and scored waypoint, soft_binned_fwd
    once a grid for the forward and once for its checkpointed recompute,
    soft_binned_bwd once a grid; the final forward once a grid; the
    layout's forward kernels once a gate forward, its backward kernels once
    a gate backward (binned_rows once a grid)."""
    prob, path, q, data = ref
    case = (dataclasses.replace(prob, soft_hpr=True), path, q, data)
    runner = tr.TrajRunner(case[0], CFG, te.NEVER, 4)
    (got, lg), (want, le), (again, _) = (_run(runner, case, dev, loop)
                                         for loop in ("captured", "plain", "plain"))
    graph = next(iter(runner.buckets._items.values())).graph
    assert graph.graph is not None and graph.replays == 3 and graph.capture_s > 0
    fwd, bwd = (2 * 4 + 1) * 14, 4 * 14  # gate forwards and backwards of a run
    assert lg == le == {"soft_binned_fwd": fwd * 4, "soft_binned_bwd": bwd * 4,
                        "binned_keys": fwd, "binned_layout": fwd, "binned_tables": fwd,
                        "binned_rowmax": fwd, "binned_rowmax_bwd": bwd, "binned_rows": bwd * 4,
                        "binned_layout_bwd": bwd}
    assert int(got[1]) == int(want[1]) == 4
    _assert_runs_equal(again, want)
    _assert_runs_equal(got, want)


def test_binned_backward_repeats_its_bits(dev):
    """The soft pose step at 262,144 points (the binned tier, cap 1024,
    coverer rows taking many terms): two eager steps and a captured one
    give the same loss and gradient bit for bit."""
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(262_144, 3)).astype(np.float32) * [6, 6, 2] + [5, 0, 1])
    P = torch.as_tensor(pts.astype(np.float32), device=dev)
    K = INTR.matrix(device=dev)
    prob = tpose.PoseProblem(INTR.width, INTR.height, soft_hpr=True)
    params = tpose.init_pose_params(np.zeros((1, 3), np.float32),
                                    np.array([[1.0, 0, 0, 0]], np.float32), dev)

    def step():
        loss, _, g = te.value_and_grad(lambda p: tpose.pose_forward(p, P, K, prob), params)
        return [loss, g["trans"], g["quat"]]

    first, second = step(), step()
    box = []

    def fn():
        out = step()
        if not box:
            box.extend(x.clone() for x in out)
        else:
            for d, x in zip(box, out):
                d.copy_(x)

    with tg.on_capture_stream(dev):
        fn()
        tg.StepGraph(fn, dev, "soft pose loss and gradient")()
    torch.cuda.synchronize()
    for a, b, c in zip(first, second, box):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_captured_frozen_steps_equal_eager(dev):
    """FrozenTrajOptimizer on a 4,096-point scene, 12 steps with a refresh
    every 4, async: the captured route (one graph per plan shape, replayed
    between refreshes) gives every step's loss, parameters and aux of the
    eager route bit for bit."""
    from trajectory_optimization_tpu_torch.models import traj_frozen as tf

    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(4096, 3)) * [6, 6, 2] + [5, 0, 1]).astype(np.float32)
    t = np.linspace(0, 1, 4, dtype=np.float32)
    poses0 = np.stack([t * 4, t * 1.5, 0.5 + 0 * t], axis=1).astype(np.float32)
    q0 = identity_quaternions(4)
    prob = tt.TrajProblem(INTR.width, INTR.height, wps_step=1, soft_hpr=True,
                          soft_hpr_dense_max=0, hpr_cap=256)
    runs = {}
    for route in ("graph", "eager"):
        opt = tf.FrozenTrajOptimizer(pts, INTR.matrix_np(), poses0, q0, prob, CFG,
                                     tf.FrozenPlanConfig(refresh_every=4), device=dev)
        opt._route = route
        p = tt.init_traj_params(poses0, q0, dev)
        st, out = opt.init(p), []
        for _ in range(12):
            p, st, loss, aux = opt.step(p, st)
            out.append((loss, p, aux))
        if route == "graph":
            assert opt._bucket.graph.graph is not None and opt.stats["captures"] >= 1
        opt.close()
        runs[route] = out
    for (lg, pg, ag), (le, pe, ae) in zip(runs["graph"], runs["eager"]):
        assert torch.equal(lg, le) and _equal(pg, pe) and _equal(ag, ae)


def test_captured_two_waypoint_path(dev, ref):
    """A path of two waypoints (no interior angle: the smoothness term's π
    comes from a device fill, not a host copy) captures and equals the
    plain run."""
    prob, path, q, data = ref
    P, V, K, _, _ = data
    case = (prob, path[:2], q[:2], (P, V, K, data[3][:2], data[4][:2]))
    runner = tr.TrajRunner(prob, CFG, te.NEVER, 6)
    (got, _), (want, _) = _run(runner, case, dev), _run(runner, case, dev, "plain")
    assert next(iter(runner.buckets._items.values())).graph.graph is not None
    _assert_runs_equal(got, want)
