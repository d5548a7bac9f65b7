"""The frozen engine's static-buffer step (``models/traj_frozen.py``:
``FrozenTrajOptimizer``, ``FrozenWpsOptimizer``, ``FrozenPoseOptimizer``)
on the CPU, with one torch thread, on the scenes of
tests/test_torch_traj_frozen.py.

On the card each plan shape's step is captured as one CUDA graph over static
buffers; the ``"static"`` route runs that step uncaptured. Held here:

* the static route ``torch.equal`` to the eager route over 12 steps and 3
  refreshes, sync and async, for the three optimizers: losses, parameters,
  Adam state and aux;
* padding the live-tile list (``stage_plan(n_live=)``, the graph and static
  routes' staging; the eager route stages no padding) leaves the loss and
  gradient of ``traj_forward_frozen_mean`` and ``frozen_soft_hpr_scores``
  as they are, bit for bit;
* the runner floors T and TB as the JAX runner does: its builds equal the
  JAX runner's array for array over a sequence of poses that shrinks the
  plan, and its plan shapes over 12 steps on the room equal the JAX
  runner's;
* a refresh into an unchanged shape reuses the shape's bucket, a larger
  shape takes a new one and frees the old;
* a step between refreshes makes no host read (``Tensor.item``, ``tolist``,
  ``__bool__``, ``__int__``, ``__float__``, ``__index__`` patched to
  raise);
* params returned by one step are not changed by the next;
* ``close()`` leaves no thread of the engine alive, and a dropped bucket
  and a closed optimizer are freed without the garbage collector.

Also the binned soft tier's accumulation (``ops.hpr.add_rows``, the rows of
``_BinnedLSE``'s backward) against a float64 sum at several tile counts.
"""
import dataclasses
import gc
import threading
import weakref

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_hpr_binned import room_path, room_scene  # noqa: E402
from test_torch_traj_frozen import OPT, _problem_kw, _t  # noqa: E402
from trajectory_optimization_tpu.models import traj_frozen as jf  # noqa: E402
from trajectory_optimization_tpu.models.traj import (  # noqa: E402
    TrajProblem as JTrajProblem,
    init_traj_params as j_init,
)
from trajectory_optimization_tpu_torch.models import traj_frozen as tf  # noqa: E402
from trajectory_optimization_tpu_torch.models.pose import (  # noqa: E402
    PoseProblem,
    init_pose_params,
)
from trajectory_optimization_tpu_torch.models.traj import (  # noqa: E402
    TrajProblem,
    init_traj_params,
)
from trajectory_optimization_tpu_torch.models.wps_opt import (  # noqa: E402
    WpsOptProblem,
    init_wps_params,
)
from trajectory_optimization_tpu_torch.ops import hpr as thpr  # noqa: E402
from trajectory_optimization_tpu_torch.opt.engine import (  # noqa: E402
    OptimizerConfig,
    value_and_grad,
)
from trajectory_optimization_tpu_torch.utils.data import identity_quaternions  # noqa: E402
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

HOST_READS = ("item", "tolist", "__bool__", "__int__", "__float__", "__index__")
SMALL_K = np.array([[50.0, 0, 32.0], [0, 50.0, 24.0], [0, 0, 1.0]], np.float32)
SMALL = dict(img_width=64.0, img_height=48.0, soft_hpr=True, soft_hpr_dense_max=0,
             hpr_cap=256)
STEPS, EVERY = 12, 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """tests/test_traj_frozen.py's scene: 4,096 points, 4 waypoints, cap 256."""
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(4096, 3)) * [6, 6, 2] + [5, 0, 1]).astype(np.float32)
    t = np.linspace(0, 1, 4, dtype=np.float32)
    poses0 = np.stack([t * 4, t * 1.5, 0.5 + 0 * t], axis=1).astype(np.float32)
    return pts, poses0, identity_quaternions(4), default_intrinsics().matrix_np(), \
        TrajProblem(**_problem_kw())


def _optimizer(kind, scene, async_refresh, **cfg):
    """(optimizer, initial params) of ``kind`` on the scene, on the CPU."""
    pts, poses0, quats0, K, problem = scene
    plan_cfg = tf.FrozenPlanConfig(refresh_every=EVERY, async_refresh=async_refresh, **cfg)
    small_cfg = OptimizerConfig(lr_pose=0.05, lr_quat=0.05)
    if kind == "traj":
        return (tf.FrozenTrajOptimizer(pts, K, poses0, quats0, problem, OPT, plan_cfg,
                                       device="cpu"), init_traj_params(poses0, quats0))
    if kind == "wps":
        params, frozen = init_wps_params(poses0, quats0)
        return (tf.FrozenWpsOptimizer(pts, SMALL_K, frozen, WpsOptProblem(**SMALL), small_cfg,
                                      plan_cfg, device="cpu"), params)
    params = init_pose_params(np.array([[1.0, 0.5, 0.4]], np.float32),
                              np.array([[1.0, 0, 0, 0]], np.float32))
    return (tf.FrozenPoseOptimizer(pts, SMALL_K, PoseProblem(**SMALL), small_cfg, plan_cfg,
                                   device="cpu"), params)


def _run(kind, scene, async_refresh, route, steps=STEPS):
    """Every step's (loss, params, state, aux) and the optimizer's stats."""
    opt, params = _optimizer(kind, scene, async_refresh)
    opt._route = route
    state, out = opt.init(params), []
    try:
        for _ in range(steps):
            params, state, loss, aux = opt.step(params, state)
            out.append((loss, params, state, aux))
    finally:
        opt.close()
    return out, opt.stats


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("async_refresh", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("kind", ["traj", "wps", "pose"])
def test_static_route_equals_eager(scene, kind, async_refresh):
    """12 steps, refreshes at steps 0, 4 and 8: every step's loss,
    parameters, Adam state and aux equal on both routes."""
    eager, e_stats = _run(kind, scene, async_refresh, "eager")
    static, s_stats = _run(kind, scene, async_refresh, "static")
    assert e_stats["refreshes"] == s_stats["refreshes"] == 3
    # the same tiles hold a query; only the static route pads their list
    assert [n for n, _ in e_stats["live_tiles"]] == [n for n, _ in s_stats["live_tiles"]]
    assert all(m == n for n, m in e_stats["live_tiles"])
    assert all(m >= n for n, m in s_stats["live_tiles"])
    assert s_stats["captures"] >= 1 and e_stats["captures"] == 0
    assert s_stats["prewarms"] == e_stats["prewarms"] == 0
    for i, (e, s) in enumerate(zip(eager, static)):
        assert _equal(e, s), f"step {i}"
    assert not _equal(eager[-1][1], eager[0][1])  # the steps move the params


@pytest.mark.parametrize("sparse", [True, False], ids=["mean", "scores"])
def test_padded_live_list_changes_no_bit(scene, sparse):
    """The live list padded to its ladder rung and to every tile gives the
    unpadded loss and gradient (the sparse mean), or gated scores and their
    gradient, bit for bit."""
    pts, poses0, quats0, K, problem = scene
    plan, meta = tf.build_traj_plan(pts, None, poses0, quats0, K, problem, embed=not sparse)
    n_real = len(tf.live_tiles(plan, meta))
    n_all = meta.n_sel * meta.n_grids * meta.tiles
    rung = tf.live_rung(n_real, meta, tf.FrozenPlanConfig())
    assert n_real < rung < n_all
    w = torch.as_tensor(np.random.default_rng(3).normal(size=(4, len(pts))).astype(np.float32))
    args = (_t(pts), _t(K), _t(poses0), _t(quats0), problem)
    out = []
    for n_live in (None, rung, n_all):
        dplan = tf.put_plan(tf.stage_plan(plan, meta, n_live=n_live), meta, "cpu")
        assert dplan["live"].numel() == (n_live or n_real)
        if sparse:
            def loss_fn(p):
                return tf.traj_forward_frozen_mean(p, dplan, meta, *args)
        else:
            def loss_fn(p):
                gated, hpr = tf.frozen_soft_hpr_scores(dplan, meta, p["quats"], p["poses"],
                                                       *args[:2], problem)
                return torch.sum(gated * w) + torch.sum(hpr * w), {}
        out.append(value_and_grad(loss_fn, init_traj_params(poses0, quats0)))
    for o in out[1:]:
        assert torch.equal(o[0], out[0][0])
        assert _equal(o[2], out[0][2])


def _shrinking_poses(poses0):
    """Poses whose plans shrink and grow again: the scene's path, the path
    lifted 6 m (fewer points in view), then the path again."""
    up = poses0 + np.array([0.0, 0.0, 6.0], np.float32)
    return [poses0, up, poses0, up]


def test_runner_floors_build_the_jax_runners_plans(scene):
    """The runners' builds, fed the same params in turn: the port's equal
    the JAX runner's array for array, and the floors keep T from falling
    where a plan built alone would shrink."""
    pts, poses0, quats0, K, problem = scene
    jopt = jf.FrozenTrajOptimizer(pts, K, poses0, quats0, JTrajProblem(**_problem_kw()),
                                  plan_cfg=jf.FrozenPlanConfig(prewarm=False))
    topt = tf.FrozenTrajOptimizer(pts, K, poses0, quats0, problem, device="cpu")
    floored = False
    for poses in _shrinking_poses(poses0):
        host = {"poses": poses, "quats": quats0}
        jp, jm = jopt._build(host)
        tp, tm = topt._build(host)
        assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
        for k in jp:
            np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
        alone = tf.build_traj_plan(pts, None, poses, quats0, K, problem, embed=False)[1]
        floored |= alone.tiles < tm.tiles
    assert floored, "the sequence never shrank a plan"
    assert (topt._t_floor, topt._tb_floor) == (jopt._t_floor, jopt._tb_floor)
    jopt.close()
    topt.close()


def test_runner_plan_shapes_equal_the_jax_runners_on_the_room():
    """12 steps, sync refresh every 4, on the room whose plans isolate no
    query: the PlanMeta in use at every step equals the JAX runner's."""
    path = room_path()[:5]
    pts, quats0, K = room_scene().astype(np.float32), identity_quaternions(5), \
        default_intrinsics().matrix_np()
    cfg = dict(refresh_every=4, async_refresh=False)
    topt = tf.FrozenTrajOptimizer(pts, K, path, quats0, TrajProblem(**_problem_kw()), OPT,
                                  tf.FrozenPlanConfig(**cfg), device="cpu")
    from trajectory_optimization_tpu.opt.engine import OptimizerConfig as JOptimizerConfig

    jopt = jf.FrozenTrajOptimizer(pts, K, path, quats0, JTrajProblem(**_problem_kw()),
                                  JOptimizerConfig(lr_pose=0.1, lr_quat=0.02),
                                  jf.FrozenPlanConfig(prewarm=False, **cfg))
    tp, jp = init_traj_params(path, quats0), j_init(path, quats0)
    ts, js = topt.init(tp), jopt.init(jp)
    for i in range(12):
        tp, ts, _, _ = topt.step(tp, ts)
        jp, js, _, _ = jopt.step(jp, js)
        assert dataclasses.asdict(topt._meta) == dataclasses.asdict(jopt._meta), i
    topt.close()
    jopt.close()


def test_stats_keep_the_last_refreshes_live_counts(scene, monkeypatch):
    """``stats["live_tiles"]`` keeps the counts of the last
    ``LIVE_TILES_KEPT`` refreshes, not one entry per refresh of the run."""
    monkeypatch.setattr(tf, "LIVE_TILES_KEPT", 2)
    opt, params = _optimizer("traj", scene, False)
    state = opt.init(params)
    for _ in range(3 * EVERY):
        params, state, _, _ = opt.step(params, state)
    opt.close()
    assert opt.stats["refreshes"] == 3 and len(opt.stats["live_tiles"]) == 2


def test_an_unchanged_shape_reuses_its_bucket(scene):
    """Refreshes into the same shape keep the bucket (and its capture); a
    larger shape, here forced by raising the tile floor, takes a new bucket
    and the old one is freed."""
    opt, params = _optimizer("traj", scene, False)
    opt._route = "static"
    state = opt.init(params)
    buckets = []
    for i in range(2 * EVERY + 1):
        if i == 2 * EVERY:
            opt._t_floor = opt._meta.tiles + 8
        params, state, _, _ = opt.step(params, state)
        buckets.append(opt._bucket)
    assert all(b is buckets[0] for b in buckets[:2 * EVERY])
    assert buckets[-1] is not buckets[0]
    assert buckets[-1].key[0].tiles == buckets[0].key[0].tiles + 8
    assert opt.stats["captures"] == 2 and opt.stats["refreshes"] == 3
    opt.close()
    assert opt._bucket is None


@pytest.fixture
def no_host_reads(monkeypatch):
    """A context in which every read of a tensor's value on the host raises."""

    def refuse(name):
        def read(self, *args, **kwargs):
            raise AssertionError(f"a host read: Tensor.{name}")
        return read

    def arm():
        for name in HOST_READS:
            monkeypatch.setattr(torch.Tensor, name, refuse(name))

    return arm


@pytest.mark.parametrize("kind", ["traj", "wps", "pose"])
def test_a_step_between_refreshes_reads_nothing_on_the_host(scene, kind, monkeypatch,
                                                              no_host_reads):
    """After the shape's first step, the static steps up to the next
    refresh run with every host read refused."""
    opt, params = _optimizer(kind, scene, True)
    opt._route = "static"
    state = opt.init(params)
    params, state, _, _ = opt.step(params, state)
    no_host_reads()
    for _ in range(EVERY - 1):
        params, state, loss, _ = opt.step(params, state)
    monkeypatch.undo()
    assert opt._steps_since_refresh == EVERY and torch.isfinite(loss).all()
    opt.close()


def test_returned_params_outlive_the_next_step(scene):
    """The params, state and loss of step k stay as they were after step
    k+1 (which starts from them and moves them)."""
    opt, params = _optimizer("traj", scene, False)
    opt._route = "static"
    state = opt.init(params)
    p1, s1, l1, a1 = opt.step(params, state)
    kept = [{k: v.clone() for k, v in p1.items()}, l1.clone(),
            {k: v.clone() for k, v in a1.items()}]
    kept_mu = {k: v.clone() for k, v in s1["mu"].items()}
    p2, s2, _, _ = opt.step(p1, s1)
    assert _equal(p1, kept[0]) and torch.equal(l1, kept[1]) and _equal(a1, kept[2])
    assert _equal(s1["mu"], kept_mu)
    assert not torch.equal(p2["poses"], p1["poses"])
    # the same start given as new tensors: the same step
    p2b, _, _, _ = opt.step({k: v.clone() for k, v in p1.items()},
                            {"mu": {k: v.clone() for k, v in s1["mu"].items()},
                             "nu": {k: v.clone() for k, v in s1["nu"].items()},
                             "count": s1["count"].clone()})
    assert _equal(p2b, p2)
    opt.close()


def test_buckets_and_optimizers_free_without_the_collector(scene):
    """A dropped bucket and a closed optimizer hold no reference cycle, so
    they are freed at once: freed later by the garbage collector, which may
    run inside a capture, their pinned buffers and graph would fail it."""
    gc.collect()
    gc.disable()
    try:
        opt, params = _optimizer("traj", scene, False)
        opt._route = "static"
        state = opt.init(params)
        params, state, _, _ = opt.step(params, state)
        bucket = weakref.ref(opt._bucket)
        opt._t_floor = opt._meta.tiles + 8  # the next refresh takes a new bucket
        for _ in range(EVERY):
            params, state, _, _ = opt.step(params, state)
        assert bucket() is None and opt._bucket is not None
        owner = weakref.ref(opt)
        opt.close()
        del opt
        assert owner() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("route", ["eager", "static"])
def test_close_leaves_no_engine_thread(scene, route):
    opt, params = _optimizer("traj", scene, True)
    opt._route = route
    state = opt.init(params)
    for _ in range(EVERY + 1):  # a build in flight at close
        params, state, _, _ = opt.step(params, state)
    opt.close()
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(("frozenplan", "frozenwarm"))]
    assert not alive, alive


@pytest.mark.parametrize("tiles", [1, 7, 64, 300])
def test_binned_rows_accumulate_to_a_float64_sum(tiles):
    """``add_rows`` over the rows a binned backward adds into (per tile, a
    query window and a coverer window of cap rows, windows of one bin
    overlapping, many tiles sharing coverers): within f32 rounding of the
    float64 sum, and the same bits on a second call. ``index_put_(...,
    accumulate=True)``, the card's branch, too."""
    rng = np.random.default_rng(tiles)
    cap, n = 64, 4096
    qoff = rng.integers(0, n - cap, tiles)
    coff = np.where(np.arange(tiles) % 3 == 0, qoff, np.arange(tiles) % 2 * cap)
    rows = torch.as_tensor(np.concatenate([(qoff[:, None] + np.arange(cap)).ravel(),
                                           (coff[:, None] + np.arange(cap)).ravel()]))
    src = torch.as_tensor(rng.normal(size=(rows.numel(), 3)).astype(np.float32))
    want = torch.zeros(n, 3, dtype=torch.float64).index_add_(0, rows, src.double())
    scale = torch.zeros(n, 3, dtype=torch.float64).index_add_(0, rows, src.double().abs())
    # a sum of k f32 terms, in any order, is within k·2^-24 of their |sum|
    k = torch.bincount(rows, minlength=n).double()[:, None]
    outs = [thpr.add_rows(torch.zeros(n, 3), rows, src) for _ in range(2)]
    outs.append(torch.zeros(n, 3).index_put_((rows,), src, accumulate=True))
    assert torch.equal(outs[0], outs[1])
    assert int(k.max()) >= (2 if tiles < 64 else 8)  # rows that take several terms
    for got in outs:
        err = (got.double() - want).abs()
        assert bool((err <= k * 2.0**-24 * scale).all()), float(err.max())
