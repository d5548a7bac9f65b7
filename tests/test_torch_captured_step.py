"""The captured optimization step (opt/graphs.py, opt/engine.py,
opt/runners.py) on the CPU.

On the card each step loop replays one step captured as a CUDA graph over
static buffers. Here the same static-buffer step functions run uncaptured
(route ``"static"``) and are held ``torch.equal`` to the eager loops they
replace: same parameters, step counts, losses and histories. They are also
held to the JAX twins (``_optimize_while``, ``_optimize_scan``,
``OptimizerLoop``, the jitted runners) at tests/test_torch_engine.py's and
tests/test_torch_pose.py's tolerances. The route predicate is held as a
table, the shape buckets over a round trip, and the per-replay launch
accounting on a stub graph. Torch runs on one thread: multithreaded CPU
reductions can give identical calls different last bits.
"""
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from trajectory_optimization_tpu.models import pose as jpose  # noqa: E402
from trajectory_optimization_tpu.models import traj as jt  # noqa: E402
from trajectory_optimization_tpu.opt import engine as je  # noqa: E402
from trajectory_optimization_tpu.opt import runners as jr  # noqa: E402
from trajectory_optimization_tpu_torch.models import pose as tpose  # noqa: E402
from trajectory_optimization_tpu_torch.models import traj as tt  # noqa: E402
from trajectory_optimization_tpu_torch.models import wps_opt as twps  # noqa: E402
from trajectory_optimization_tpu_torch.ops import _kernels  # noqa: E402
from trajectory_optimization_tpu_torch.opt import engine as te  # noqa: E402
from trajectory_optimization_tpu_torch.opt import graphs as tg  # noqa: E402
from trajectory_optimization_tpu_torch.opt import runners as tr  # noqa: E402
from trajectory_optimization_tpu_torch.utils.data import identity_quaternions, pad_points  # noqa: E402
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

INTR = default_intrinsics()
CFG = te.OptimizerConfig(lr_pose=0.1, lr_quat=0.02)
DECAY = dict(lr_pose=0.1, lr_quat=0.05, decay_gamma=0.5, decay_every=2)
EARLY = te.EarlyStop(rewards_th=1.02, smoothness_th=0.5)  # clears within the first 16 steps
FWD = dict(rtol=1e-4, atol=2e-4)  # the JAX suite's forward bound


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(a, b) -> bool:
    """torch.equal over matching (nested) dicts of tensors."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def _traj_data(pts, path, backend="kernel"):
    """The facade's padded data and problem; the kernel backend takes the
    plain versions of K1-K4 here, the path the card captures."""
    padded, valid = pad_points(pts)
    q = identity_quaternions(len(path))
    prob = tt.TrajProblem(INTR.width, INTR.height, wps_step=tt.waypoint_stride(path),
                          backend=backend)
    data = (torch.as_tensor(padded), torch.as_tensor(valid), INTR.matrix(),
            torch.as_tensor(path), torch.as_tensor(q))
    return prob, q, data


def _loss_fn(prob, data):
    P, V, K, p0, q0 = data
    Pt = P.t().contiguous()
    return lambda p: tt.traj_forward(p, P, K, p0, q0, prob, valid=V, points_t=Pt)


def _seeded_cloud(n=4096, seed=5):
    """n points ahead of the start pose (camera at (6, 2, 0) looking +z)."""
    rng = np.random.default_rng(seed)
    return rng.uniform([3.0, -1.0, 1.0], [9.0, 5.0, 7.0], size=(n, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# the static-buffer steps against the eager loops, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stop", ["never", "early"])
def test_run_until_done_static_equals_eager(cloud10, path10, stop):
    """Cloud 10 x path 10: 20 steps, or early stop (n_iters < 48, read at a
    multiple of 16): the static step's parameters, Adam state, step count,
    last loss and gains' baselines torch.equal to the eager loop's."""
    prob, q, data = _traj_data(cloud10, path10)
    lf = _loss_fn(prob, data)
    stop_at, n = (te.NEVER, 20) if stop == "never" else (EARLY, 48)
    runs = {route: te._run_until_done(lf, tt.init_traj_params(path10, q), CFG, n, stop_at,
                                      route=route) for route in ("eager", "static")}
    if stop == "early":
        assert 0 < int(runs["eager"]["i"]) < 16
    else:
        assert int(runs["eager"]["i"]) == n
    assert _equal(runs["static"], runs["eager"])


def test_optimize_with_history_static_equals_eager(cloud10, path10):
    prob, q, data = _traj_data(cloud10[::2], path10)
    lf = _loss_fn(prob, data)
    out = {route: te._optimize_with_history(lf, tt.init_traj_params(path10, q), CFG, 12,
                                            route=route) for route in ("eager", "static")}
    assert _equal(out["static"][0], out["eager"][0])
    hs, he = out["static"][1], out["eager"][1]
    assert hs.keys() == he.keys() and "loss" in hs and "mean_reward" in hs
    for k in he:
        assert hs[k].dtype == he[k].dtype and hs[k].shape == (12,)
        np.testing.assert_array_equal(hs[k], he[k])


def test_optimize_with_history_zero_steps():
    params = {"poses": torch.ones(2, 3), "quats": torch.ones(2, 4)}

    def lf(p):
        return torch.sum(p["poses"] ** 2), {"mean_reward": torch.ones(())}

    for route in ("eager", "static"):
        out, hist = te._optimize_with_history(lf, params, CFG, 0, route=route)
        assert hist == {} and torch.equal(out["poses"], params["poses"])


@pytest.mark.parametrize("n", [0, 1, 7])
def test_optimizer_loop_static_equals_eager(cloud10, path10, n):
    """``run(n)`` twice, then one step: each call's (loss, aux) and the
    parameters after it torch.equal to the eager loop's."""
    prob, q, data = _traj_data(cloud10[::4], path10)
    lf = _loss_fn(prob, data)
    loops = {}
    for route in ("eager", "static"):
        loops[route] = te.OptimizerLoop(lf, tt.init_traj_params(path10, q), CFG)
        loops[route]._route = route
    for m in (n, n, 1):
        got, want = loops["static"].run(m), loops["eager"].run(m)
        assert torch.equal(got[0], want[0]) and _equal(got[1], want[1])
        assert _equal(loops["static"].params, loops["eager"].params)
        assert _equal(loops["static"].last_aux, loops["eager"].last_aux)


def test_optimizer_loop_results_are_not_overwritten(cloud10, path10):
    """A returned loss and the parameters read after a run keep their
    values when the loop runs on, as the eager loop's fresh tensors do."""
    prob, q, data = _traj_data(cloud10[::4], path10)
    loop = te.OptimizerLoop(_loss_fn(prob, data), tt.init_traj_params(path10, q), CFG)
    loop._route = "static"
    loss, aux = loop.run(2)
    params = loop.params
    kept = (loss.clone(), {k: v.clone() for k, v in aux.items()},
            {k: v.clone() for k, v in params.items()})
    loop.run(3)
    assert torch.equal(loss, kept[0]) and _equal(aux, kept[1]) and _equal(params, kept[2])
    assert not torch.equal(loop.params["poses"], kept[2]["poses"])


def _pose_segments(adv, rem, seg, route):
    pts, valid = pad_points(_seeded_cloud())
    T = (torch.as_tensor(pts), torch.as_tensor(valid), INTR.matrix())
    params = tpose.init_pose_params(np.array([[6.0, 2.0, 0.0]], np.float32),
                                    np.array([[0.9, 0.1, -0.2, 0.3]], np.float32))
    state = te.adam_init(params)
    outs = []
    for a in (adv, adv, rem):
        params, state, loss, aux = a._advance(route, params, state, *T)
        outs.append((params, state, loss, aux))
    return outs


def test_pose_runner_static_equals_eager():
    """Two segments of 3 steps and a 2-step remainder (a second runner, a
    second bucket) with a decaying LR: each segment's parameters, Adam
    state (its count carried across segments), loss and observations
    torch.equal to the eager segments'."""
    tp = tpose.PoseProblem(INTR.width, INTR.height)
    _, adv = tr.pose_runner(tp, te.OptimizerConfig(**DECAY), 3)
    _, rem = tr.pose_runner(tp, te.OptimizerConfig(**DECAY), 2)
    got, want = (_pose_segments(adv, rem, 3, route) for route in ("static", "eager"))
    for (gp, gs, gl, ga), (wp, ws, wl, wa), count in zip(got, want, (3, 6, 8)):
        assert int(gs["count"]) == count
        assert _equal(gp, wp) and _equal(gs, ws) and torch.equal(gl, wl) and _equal(ga, wa)


def test_traj_runner_bucket_round_trip(cloud10, path10):
    """Shape A (cloud 10 x path 10), then B (half the points, 10 waypoints),
    then A again through one runner: each run torch.equal to the eager run
    (parameters, n_iters, final loss and aux), two buckets kept, and A's
    second run reuses A's bucket and step."""
    runner = tr.traj_runner(tt.TrajProblem(INTR.width, INTR.height, wps_step=2,
                                           backend="kernel"), CFG, EARLY, 24)
    cases = {"A": (cloud10, path10), "B": (cloud10[::2], path10[:10])}
    graphs = {}
    for name in ("A", "B", "A"):
        pts, path = cases[name]
        _, q, data = _traj_data(pts, path)
        got = runner._run("static", tt.init_traj_params(path, q), *data)
        want = runner._run("eager", tt.init_traj_params(path, q), *data)
        assert int(got[1]) == int(want[1]) and torch.equal(got[2], want[2])
        assert _equal(got[0], want[0]) and _equal(got[3], want[3])
        graphs.setdefault(name, set()).update(id(b.graph) for b in runner.buckets._items.values())
    assert len(runner.buckets) == 2
    assert graphs["A"] <= graphs["B"]  # no bucket was made again for A


def test_traj_runner_zero_steps(cloud10, path10):
    runner = tr.traj_runner(tt.TrajProblem(INTR.width, INTR.height, backend="kernel"), CFG,
                            te.NEVER, 0)
    _, q, data = _traj_data(cloud10[::8], path10)
    got = runner._run("static", tt.init_traj_params(path10, q), *data)
    want = runner._run("eager", tt.init_traj_params(path10, q), *data)
    assert int(got[1]) == 0 and _equal(got[0], want[0]) and _equal(got[3], want[3])


# ---------------------------------------------------------------------------
# soft HPR above soft_hpr_dense_max: the binned tier's static steps
# ---------------------------------------------------------------------------

SOFT = dict(soft_hpr=True, soft_hpr_dense_max=2048, hpr_cap=64)  # the room is binned


def _room():
    """tests/test_torch_hpr_binned.py's closed room (3,681 points) and its
    path moved by seeded noise."""
    from test_torch_hpr_binned import room_path, room_scene

    path = room_path() + np.random.default_rng(0).normal(scale=0.1, size=(7, 3)).astype(
        np.float32)
    return room_scene(), path


def test_soft_traj_runner_static_equals_eager():
    """The trajectory runner with soft HPR on the binned tier (3 of 7
    waypoints, 3 steps): parameters, n_iters, final loss and aux of the
    static route torch.equal to the eager route's."""
    pts, path = _room()
    q = identity_quaternions(len(path))
    runner = tr.traj_runner(tt.TrajProblem(INTR.width, INTR.height, wps_step=3, **SOFT), CFG,
                            te.NEVER, 3)
    data = (torch.as_tensor(pts), None, INTR.matrix(), torch.as_tensor(path),
            torch.as_tensor(q))
    got = runner._run("static", tt.init_traj_params(path, q), *data)
    want = runner._run("eager", tt.init_traj_params(path, q), *data)
    assert int(got[1]) == int(want[1]) == 3
    assert _equal(got[0], want[0]) and torch.equal(got[2], want[2]) and _equal(got[3], want[3])
    assert not torch.equal(got[0]["poses"], torch.as_tensor(path))


def test_soft_pose_runner_static_equals_eager():
    """The pose runner with soft HPR on the binned tier: two segments of 3
    steps, each torch.equal to the eager segments."""
    pts, _ = _room()
    prob = tpose.PoseProblem(INTR.width, INTR.height, **SOFT)
    _, adv = tr.pose_runner(prob, te.OptimizerConfig(lr_pose=0.1, lr_quat=0.05), 3)
    outs = {}
    for route in ("static", "eager"):
        params = tpose.init_pose_params(np.array([[0.5, 0.3, 0.0]], np.float32),
                                        np.array([[0.9, 0.1, -0.2, 0.3]], np.float32))
        state, outs[route] = te.adam_init(params), []
        for _ in range(2):
            params, state, loss, aux = adv._advance(route, params, state, torch.as_tensor(pts),
                                                    None, INTR.matrix())
            outs[route].append((params, state, loss, aux))
    for g, e in zip(outs["static"], outs["eager"]):
        assert _equal(g[0], e[0]) and _equal(g[1], e[1]) and torch.equal(g[2], e[2])
        assert _equal(g[3], e[3])


def test_soft_optimize_waypoints_static_equals_eager(monkeypatch):
    """``optimize_waypoints`` with soft HPR on the binned tier (4 waypoints,
    3 steps): its static route (the step the card captures) torch.equal to
    its eager route, positions, quaternions and aux."""
    pts, path = _room()
    q = identity_quaternions(4)
    prob = twps.WpsOptProblem(INTR.width, INTR.height, **SOFT)
    want = twps.optimize_waypoints(pts, path[:4], q, INTR.matrix_np(), prob, n_steps=3,
                                   device="cpu")
    monkeypatch.setattr(twps, "device_route", lambda device, route: "static")
    got = twps.optimize_waypoints(pts, path[:4], q, INTR.matrix_np(), prob, n_steps=3,
                                  device="cpu")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _equal(got[2], want[2])


# ---------------------------------------------------------------------------
# the static steps against the JAX twins
# ---------------------------------------------------------------------------


def _twin_loss_fns(pts, path, stride):
    q = identity_quaternions(len(path))
    jp = jt.TrajProblem(INTR.width, INTR.height, wps_step=stride, backend="xla")
    tp = tt.TrajProblem(INTR.width, INTR.height, wps_step=stride, backend="torch")
    P, p0, q0 = jnp.asarray(pts), jnp.asarray(path), jnp.asarray(q)
    Pt, p0t, q0t = torch.as_tensor(pts), torch.as_tensor(path), torch.as_tensor(q)

    def jl(p):
        return jt.traj_forward(p, P, jnp.asarray(INTR.matrix_np()), p0, q0, jp)

    def tl(p):
        return tt.traj_forward(p, Pt, INTR.matrix(), p0t, q0t, tp)

    return jl, tl, q


def test_static_until_done_matches_jax_while(cloud10, path10):
    """``_optimize_while`` with early stop: the same n_iters (as
    tests/test_torch_engine.py holds the eager loop)."""
    jl, tl, q = _twin_loss_fns(cloud10[::8], path10, jt.waypoint_stride(path10))
    stop_kw = dict(rewards_th=1.02, smoothness_th=0.5)
    _, n_j, _ = je.optimize(jl, jt.init_traj_params(path10, q), je.OptimizerConfig(lr_pose=0.1,
                            lr_quat=0.02), 200, early_stop=je.EarlyStop(**stop_kw))
    _, n_t, _ = te._optimize(tl, tt.init_traj_params(path10, q), CFG, 200, route="static",
                             early_stop=te.EarlyStop(**stop_kw))
    assert 0 < n_j < 200 and n_t == n_j


def test_static_history_matches_jax_scan(cloud10, path10):
    """``_optimize_scan``: 12 steps, mean reward rtol 1e-5 and loss rtol 2e-4
    (test_torch_engine.py's bounds)."""
    jl, tl, q = _twin_loss_fns(cloud10[::8], path10, jt.waypoint_stride(path10))
    _, hj = je.optimize_with_history(jl, jt.init_traj_params(path10, q),
                                     je.OptimizerConfig(lr_pose=0.1, lr_quat=0.02), 12)
    _, ht = te._optimize_with_history(tl, tt.init_traj_params(path10, q), CFG, 12, route="static")
    assert set(ht) == set(hj)
    np.testing.assert_allclose(ht["mean_reward"], np.asarray(hj["mean_reward"]), rtol=1e-5)
    np.testing.assert_allclose(ht["loss"], np.asarray(hj["loss"]), rtol=2e-4)


def test_static_optimizer_loop_matches_jax(cloud10, path10):
    """``OptimizerLoop.run(3)`` then ``run(4)``: the last mean reward rtol
    1e-5, loss rtol 2e-4, positions atol 5e-3 (test_torch_engine.py's
    history and facade bounds)."""
    jl, tl, q = _twin_loss_fns(cloud10[::16], path10, 2)
    jloop = je.OptimizerLoop(jl, jt.init_traj_params(path10, q),
                             je.OptimizerConfig(lr_pose=0.1, lr_quat=0.02))
    tloop = te.OptimizerLoop(tl, tt.init_traj_params(path10, q), CFG)
    tloop._route = "static"
    for n in (3, 4):
        jloss, jaux = jloop.run(n)
        tloss, taux = tloop.run(n)
        np.testing.assert_allclose(float(taux["mean_reward"]), float(jaux["mean_reward"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-4)
    np.testing.assert_allclose(tloop.params["poses"].numpy(), np.asarray(jloop.params["poses"]),
                               atol=5e-3)


def test_static_traj_runner_matches_jax(cloud10, path10):
    """The jitted ``traj_runner``, 20 steps on cloud 10 / 5: n_iters equal,
    mean reward and gains rtol 1e-5 / 1e-4, loss rtol 1e-3, positions atol
    5e-3 (test_torch_engine.py's facade bounds)."""
    pts, valid = pad_points(cloud10[::5])
    q = identity_quaternions(len(path10))
    stride = jt.waypoint_stride(path10)
    jcfg = je.OptimizerConfig(lr_pose=0.1, lr_quat=0.02)
    jrun = jr.traj_runner(jt.TrajProblem(INTR.width, INTR.height, wps_step=stride,
                                         backend="xla"), jcfg, je.EarlyStop(float("inf"),
                                                                            float("inf")), 20)
    trun = tr.traj_runner(tt.TrajProblem(INTR.width, INTR.height, wps_step=stride,
                                         backend="torch"), CFG, te.NEVER, 20)
    jp, jn, jloss, jaux = jrun(jt.init_traj_params(path10, q), jnp.asarray(pts),
                               jnp.asarray(valid), jnp.asarray(INTR.matrix_np()),
                               jnp.asarray(path10), jnp.asarray(q))
    tp, tn, tloss, taux = trun._run("static", tt.init_traj_params(path10, q),
                                    torch.as_tensor(pts), torch.as_tensor(valid), INTR.matrix(),
                                    torch.as_tensor(path10), torch.as_tensor(q))
    assert int(tn) == int(jn) == 20
    np.testing.assert_allclose(float(taux["mean_reward"]), float(jaux["mean_reward"]), rtol=1e-5)
    np.testing.assert_allclose(float(taux["mean_reward"]) / float(taux["reward0"]),
                               float(jaux["mean_reward"]) / float(jaux["reward0"]), rtol=1e-5)
    np.testing.assert_allclose(float(taux["smooth0"]) / float(taux["loss_smooth"]),
                               float(jaux["smooth0"]) / float(jaux["loss_smooth"]), rtol=1e-4)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-3)
    np.testing.assert_allclose(tp["poses"].numpy(), np.asarray(jp["poses"]), atol=5e-3)


def test_static_pose_runner_matches_jax():
    """The jitted ``pose_runner``: segments of 3 steps and a 2-step remainder
    with a decaying LR, each against the JAX runner's (parameters rtol and
    atol 1e-5, loss rtol 1e-4, observations at the forward bound:
    tests/test_torch_pose.py's pins)."""
    pts, valid = pad_points(_seeded_cloud())
    jp = jpose.PoseProblem(INTR.width, INTR.height)
    tp = tpose.PoseProblem(INTR.width, INTR.height)
    j_init, j_adv = jr.pose_runner(jp, je.OptimizerConfig(**DECAY), 3)
    _, j_rem = jr.pose_runner(jp, je.OptimizerConfig(**DECAY), 2)
    got = _pose_segments(tr.pose_runner(tp, te.OptimizerConfig(**DECAY), 3)[1],
                         tr.pose_runner(tp, te.OptimizerConfig(**DECAY), 2)[1], 3, "static")
    jparams = jpose.init_pose_params(np.array([[6.0, 2.0, 0.0]], np.float32),
                                     np.array([[0.9, 0.1, -0.2, 0.3]], np.float32))
    jstate = j_init(jparams)
    J = (jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(INTR.matrix_np()))
    for adv, (tparams, _, tl, ta) in zip((j_adv, j_adv, j_rem), got):
        jparams, jstate, jl, ja = adv(jparams, jstate, *J)
        for k in ("trans", "quat"):
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]),
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
        np.testing.assert_allclose(ta["observations"].numpy(), np.asarray(ja["observations"]),
                                   **FWD)


# ---------------------------------------------------------------------------
# the route predicate, as a table
# ---------------------------------------------------------------------------

ROUTE_TABLE = [
    # (model, problem fields, points, route on the card): every configuration
    # captures, soft HPR above soft_hpr_dense_max (the binned tier) included
    ("traj", {}, 40_960, "graph"),
    ("traj", {"backend": "torch"}, 40_960, "graph"),
    ("traj", {"backend": "kernel"}, 8_388_608, "graph"),
    ("traj", {"soft_hpr": True}, 24_576, "graph"),
    ("traj", {"soft_hpr": True}, 32_768, "graph"),
    ("traj", {"soft_hpr": True}, 32_769, "graph"),
    ("traj", {"soft_hpr": True}, 40_960, "graph"),
    ("traj", {"soft_hpr": True, "soft_hpr_dense_max": 2048}, 4096, "graph"),
    ("traj", {"soft_hpr": False, "soft_hpr_dense_max": 2048}, 4096, "graph"),
    ("pose", {}, 1_048_576, "graph"),
    ("pose", {"soft_hpr": True}, 24_576, "graph"),
    ("pose", {"soft_hpr": True}, 262_144, "graph"),
    ("pose", {"soft_hpr": True, "soft_hpr_dense_max": 0}, 1, "graph"),
    ("wps", {}, 40_960, "graph"),
    ("wps", {"soft_hpr": True}, 24_576, "graph"),
    ("wps", {"soft_hpr": True}, 40_960, "graph"),
]
MODELS = {"traj": tt.TrajProblem, "pose": tpose.PoseProblem, "wps": twps.WpsOptProblem}


@pytest.mark.parametrize("model,fields,n,route", ROUTE_TABLE)
def test_capture_route_table(model, fields, n, route):
    """``models.traj.capture_route`` on each model's problem: the trajectory,
    pose and waypoint losses share the soft gate it describes, and both of
    its tiers capture (the binned tier sizes its tiles from shapes alone)."""
    problem = MODELS[model](INTR.width, INTR.height, **fields)
    assert tt.capture_route(problem, n) == route
    assert tg.device_route(torch.device("cuda", 0), tt.capture_route(problem, n)) == route
    assert tg.device_route(torch.device("cpu"), tt.capture_route(problem, n)) == "eager"


def test_public_entry_points_route_cpu_tensors_to_the_eager_loop(cloud10, path10):
    """On CPU tensors no public entry point builds static buffers: the
    runner keeps no bucket and the loop no captured step."""
    prob, q, data = _traj_data(cloud10[::8], path10)
    runner = tr.traj_runner(prob, CFG, te.NEVER, 3)
    runner(tt.init_traj_params(path10, q), *data)
    assert len(runner.buckets) == 0
    loop = te.OptimizerLoop(_loss_fn(prob, data), tt.init_traj_params(path10, q), CFG)
    loop.run(2)
    assert loop._route == "eager" and loop._step is None


# ---------------------------------------------------------------------------
# capture bookkeeping, on a stub graph
# ---------------------------------------------------------------------------


class _StubGraph:
    """Stands in for torch.cuda.CUDAGraph: records calls, runs nothing."""

    made = []

    def __init__(self):
        self.calls = []
        _StubGraph.made.append(self)

    def capture_begin(self, capture_error_mode="global"):
        self.calls.append(("begin", capture_error_mode))

    def capture_end(self):
        self.calls.append("end")

    def replay(self):
        self.calls.append("replay")


@pytest.fixture
def stub_cuda(monkeypatch):
    _StubGraph.made = []
    stream = types.SimpleNamespace(device=torch.device("cuda", 0), cuda_stream=7)
    monkeypatch.setattr(tg.torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(tg.torch.cuda, "current_stream", lambda *a: stream)
    saved = dict(_kernels.LAUNCHES)
    _kernels.reset_launches()
    yield stream
    _kernels.LAUNCHES.update(saved)


def test_replays_add_the_captured_launches(stub_cuda):
    """The counts the wrappers raise while a step is recorded are taken
    back (nothing ran); each replay adds them once."""
    calls = []

    def fn():  # what the wrappers do while their launches are recorded
        calls.append(1)
        _kernels.LAUNCHES["pass_a"] += 1
        _kernels.LAUNCHES["bwd_stats"] += 2

    g = tg.StepGraph(fn, "graph")
    g()
    assert _kernels.LAUNCHES["pass_a"] == 1 and _kernels.LAUNCHES["bwd_stats"] == 2
    g()
    g()
    assert len(calls) == 1  # recorded once, never called again
    assert g.launches == {"pass_a": 1, "bwd_stats": 2}
    assert _kernels.LAUNCHES["pass_a"] == 3 and _kernels.LAUNCHES["bwd_stats"] == 6
    assert sum(v for k, v in _kernels.LAUNCHES.items() if k not in ("pass_a", "bwd_stats")) == 0
    assert _StubGraph.made[0].calls == [("begin", "global"), "end", "replay", "replay", "replay"]
    assert g.replays == 3


def test_static_route_calls_the_step_and_counts_nothing(stub_cuda):
    g = tg.StepGraph(lambda: _kernels.LAUNCHES.__setitem__("pass_b", _kernels.LAUNCHES["pass_b"]
                                                          + 1), "static")
    g()
    g()
    assert _kernels.LAUNCHES["pass_b"] == 2 and g.graph is None and not _StubGraph.made


def test_a_failed_capture_raises_and_counts_nothing(stub_cuda):
    def fn():
        _kernels.LAUNCHES["pass_a"] += 1
        raise RuntimeError("operation not permitted when stream is capturing")

    g = tg.StepGraph(fn, "graph", "test step")
    with pytest.raises(tg.CaptureError, match="capturing the test step"):
        g()
    assert g.graph is None and _kernels.LAUNCHES["pass_a"] == 0
    assert _StubGraph.made[0].calls == [("begin", "global"), "end"]  # the capture was ended


def test_no_garbage_collection_while_capturing(stub_cuda):
    """A graph collected during a capture would reset inside it (a call the
    capture forbids): the collector is off while a step is recorded, on
    again after, a failed capture included; a caller's setting is kept."""
    import gc

    seen = []
    ok = tg.StepGraph(lambda: seen.append(gc.isenabled()), "graph")

    def fail():
        seen.append(gc.isenabled())
        raise RuntimeError("operation not permitted when stream is capturing")

    assert gc.isenabled()
    ok()
    with pytest.raises(tg.CaptureError):
        tg.StepGraph(fail, "graph")()
    assert seen == [False, False] and gc.isenabled()
    gc.disable()
    try:
        tg.StepGraph(lambda: seen.append(gc.isenabled()), "graph")()
        assert seen[-1] is False and not gc.isenabled()
    finally:
        gc.enable()


def test_a_graph_keeps_the_scratch_it_was_captured_with(stub_cuda):
    """A later, larger problem replaces the stream's K3/K4 scratch; the graph
    still holds the pair it recorded."""
    key = (stub_cuda.device, stub_cuda.cuda_stream)
    old = (torch.zeros(4096, dtype=torch.int32), torch.zeros(8, dtype=torch.float64))
    saved = _kernels._reduction_scratch.get(key)
    _kernels._reduction_scratch[key] = old
    try:
        g = tg.StepGraph(lambda: None, "graph")
        g()
        _kernels._reduction_scratch[key] = (torch.zeros(8192, dtype=torch.int32), old[1])
        assert g.scratch is old
    finally:
        if saved is None:
            _kernels._reduction_scratch.pop(key, None)
        else:
            _kernels._reduction_scratch[key] = saved


def test_step_graph_refuses_the_eager_route():
    with pytest.raises(ValueError):
        tg.StepGraph(lambda: None, "eager")
