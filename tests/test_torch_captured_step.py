"""The captured optimization step (opt/graphs.py, opt/engine.py,
opt/runners.py) on the CPU.

On the card each step loop replays one step captured as a CUDA graph over
static buffers. On the CPU the public entry points call the same
static-buffer step directly; here they are held ``torch.equal`` to the plain
loops of tests/torch_loop_ref.py: same parameters, step counts, losses and
histories. They are also held to the JAX twins (``_optimize_while``,
``_optimize_scan``, ``OptimizerLoop``, the jitted runners) at
tests/test_torch_engine.py's and tests/test_torch_pose.py's tolerances, and
the plain loop itself to ``_optimize_while``. Each model configuration's
step runs with every host read refused, the shape buckets are held over a
round trip, and the per-replay launch accounting on a stub graph. Torch
runs on one thread: multithreaded CPU reductions can give identical calls
different last bits.
"""
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import torch_loop_ref as ref  # noqa: E402
from test_torch_binned_slots import no_host_reads  # noqa: E402,F401 (fixture)

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
CUDA = torch.device("cuda", 0)


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
# the public entry points against the plain loops, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stop", ["never", "early"])
def test_run_until_done_equals_the_plain_loop(cloud10, path10, stop):
    """Cloud 10 x path 10: 20 steps, or early stop (n_iters < 48, read at a
    multiple of 16): parameters, Adam state, step count, last loss and
    gains' baselines torch.equal to the plain loop's."""
    prob, q, data = _traj_data(cloud10, path10)
    lf = _loss_fn(prob, data)
    stop_at, n = (te.NEVER, 20) if stop == "never" else (EARLY, 48)
    got = te.run_until_done(lf, tt.init_traj_params(path10, q), CFG, n, stop_at)
    want = ref.until_done(lf, tt.init_traj_params(path10, q), CFG, n, stop_at)
    if stop == "early":
        assert 0 < int(want["i"]) < 16
    else:
        assert int(want["i"]) == n
    assert _equal(got, want)


def test_optimize_with_history_equals_the_plain_loop(cloud10, path10):
    prob, q, data = _traj_data(cloud10[::2], path10)
    lf = _loss_fn(prob, data)
    got = te.optimize_with_history(lf, tt.init_traj_params(path10, q), CFG, 12)
    want = ref.with_history(lf, tt.init_traj_params(path10, q), CFG, 12)
    assert _equal(got[0], want[0])
    hs, he = got[1], want[1]
    assert hs.keys() == he.keys() and "loss" in hs and "mean_reward" in hs
    for k in he:
        assert hs[k].dtype == he[k].dtype and hs[k].shape == (12,)
        np.testing.assert_array_equal(hs[k], he[k])


def test_optimize_with_history_zero_steps():
    params = {"poses": torch.ones(2, 3), "quats": torch.ones(2, 4)}

    def lf(p):
        return torch.sum(p["poses"] ** 2), {"mean_reward": torch.ones(())}

    for run in (te.optimize_with_history, ref.with_history):
        out, hist = run(lf, params, CFG, 0)
        assert hist == {} and torch.equal(out["poses"], params["poses"])


@pytest.mark.parametrize("n", [0, 1, 7])
def test_optimizer_loop_equals_the_plain_loop(cloud10, path10, n):
    """``run(n)`` twice, then one step: each call's (loss, aux) and the
    parameters after it torch.equal to the plain loop's, whose Adam state
    carries across the calls."""
    prob, q, data = _traj_data(cloud10[::4], path10)
    lf = _loss_fn(prob, data)
    loop = te.OptimizerLoop(lf, tt.init_traj_params(path10, q), CFG)
    params = tt.init_traj_params(path10, q)
    state = ref.adam_state(params)
    for m in (n, n, 1):
        got = loop.run(m)
        params, state, loss, aux = ref.steps(lf, params, state, CFG, m)
        assert torch.equal(got[0], loss) and _equal(got[1], aux)
        assert _equal(loop.params, params)
        assert _equal(loop.last_aux, aux)


def test_optimizer_loop_results_are_not_overwritten(cloud10, path10):
    """A returned loss and the parameters read after a run keep their
    values when the loop runs on, as the plain loop's fresh tensors do."""
    prob, q, data = _traj_data(cloud10[::4], path10)
    loop = te.OptimizerLoop(_loss_fn(prob, data), tt.init_traj_params(path10, q), CFG)
    loss, aux = loop.run(2)
    params = loop.params
    kept = (loss.clone(), {k: v.clone() for k, v in aux.items()},
            {k: v.clone() for k, v in params.items()})
    loop.run(3)
    assert torch.equal(loss, kept[0]) and _equal(aux, kept[1]) and _equal(params, kept[2])
    assert not torch.equal(loop.params["poses"], kept[2]["poses"])


def _pose_segments(advances):
    """Two segments of the first advance and one of the second, each from
    where the last left off."""
    pts, valid = pad_points(_seeded_cloud())
    T = (torch.as_tensor(pts), torch.as_tensor(valid), INTR.matrix())
    params = tpose.init_pose_params(np.array([[6.0, 2.0, 0.0]], np.float32),
                                    np.array([[0.9, 0.1, -0.2, 0.3]], np.float32))
    state = te.adam_init(params)
    outs = []
    for a in (advances[0], advances[0], advances[1]):
        params, state, loss, aux = a(params, state, *T)
        outs.append((params, state, loss, aux))
    return outs


def _plain_advance(problem, cfg, seg_steps):
    return lambda *args: ref.pose_advance(problem, cfg, seg_steps, *args)


def test_pose_runner_equals_the_plain_loop():
    """Two segments of 3 steps and a 2-step remainder (a second runner, a
    second bucket) with a decaying LR: each segment's parameters, Adam
    state (its count carried across segments), loss and observations
    torch.equal to the plain segments'."""
    tp = tpose.PoseProblem(INTR.width, INTR.height)
    cfg = te.OptimizerConfig(**DECAY)
    got = _pose_segments((tr.pose_runner(tp, cfg, 3)[1], tr.pose_runner(tp, cfg, 2)[1]))
    want = _pose_segments((_plain_advance(tp, cfg, 3), _plain_advance(tp, cfg, 2)))
    for (gp, gs, gl, ga), (wp, ws, wl, wa), count in zip(got, want, (3, 6, 8)):
        assert int(gs["count"]) == count
        assert _equal(gp, wp) and _equal(gs, ws) and torch.equal(gl, wl) and _equal(ga, wa)


def _plain_run(runner, params, *data):
    """``runner``'s call on the plain loop."""
    return ref.traj_run(runner.problem, runner.cfg, runner.stop, runner.n_steps, params, *data)


def test_traj_runner_bucket_round_trip(cloud10, path10):
    """Shape A (cloud 10 x path 10), then B (half the points, 10 waypoints),
    then A again through one runner: each run torch.equal to the plain run
    (parameters, n_iters, final loss and aux), two buckets kept, and A's
    second run reuses A's bucket and step."""
    runner = tr.traj_runner(tt.TrajProblem(INTR.width, INTR.height, wps_step=2,
                                           backend="kernel"), CFG, EARLY, 24)
    cases = {"A": (cloud10, path10), "B": (cloud10[::2], path10[:10])}
    graphs = {}
    for name in ("A", "B", "A"):
        pts, path = cases[name]
        _, q, data = _traj_data(pts, path)
        got = runner(tt.init_traj_params(path, q), *data)
        want = _plain_run(runner, tt.init_traj_params(path, q), *data)
        assert int(got[1]) == int(want[1]) and torch.equal(got[2], want[2])
        assert _equal(got[0], want[0]) and _equal(got[3], want[3])
        graphs.setdefault(name, set()).update(id(b.graph) for b in runner.buckets._items.values())
    assert len(runner.buckets) == 2
    assert graphs["A"] <= graphs["B"]  # no bucket was made again for A


def test_traj_runner_zero_steps(cloud10, path10):
    runner = tr.traj_runner(tt.TrajProblem(INTR.width, INTR.height, backend="kernel"), CFG,
                            te.NEVER, 0)
    _, q, data = _traj_data(cloud10[::8], path10)
    got = runner(tt.init_traj_params(path10, q), *data)
    want = _plain_run(runner, tt.init_traj_params(path10, q), *data)
    assert int(got[1]) == 0 and _equal(got[0], want[0]) and _equal(got[3], want[3])


# ---------------------------------------------------------------------------
# soft HPR above soft_hpr_dense_max: the binned tier's steps
# ---------------------------------------------------------------------------

SOFT = dict(soft_hpr=True, soft_hpr_dense_max=2048, hpr_cap=64)  # the room is binned


def _room():
    """tests/test_torch_hpr_binned.py's closed room (3,681 points) and its
    path moved by seeded noise."""
    from test_torch_hpr_binned import room_path, room_scene

    path = room_path() + np.random.default_rng(0).normal(scale=0.1, size=(7, 3)).astype(
        np.float32)
    return room_scene(), path


def test_soft_traj_runner_equals_the_plain_loop():
    """The trajectory runner with soft HPR on the binned tier (3 of 7
    waypoints, 3 steps): parameters, n_iters, final loss and aux torch.equal
    to the plain loop's."""
    pts, path = _room()
    q = identity_quaternions(len(path))
    runner = tr.traj_runner(tt.TrajProblem(INTR.width, INTR.height, wps_step=3, **SOFT), CFG,
                            te.NEVER, 3)
    data = (torch.as_tensor(pts), None, INTR.matrix(), torch.as_tensor(path),
            torch.as_tensor(q))
    got = runner(tt.init_traj_params(path, q), *data)
    want = _plain_run(runner, tt.init_traj_params(path, q), *data)
    assert int(got[1]) == int(want[1]) == 3
    assert _equal(got[0], want[0]) and torch.equal(got[2], want[2]) and _equal(got[3], want[3])
    assert not torch.equal(got[0]["poses"], torch.as_tensor(path))


def test_soft_pose_runner_equals_the_plain_loop():
    """The pose runner with soft HPR on the binned tier: two segments of 3
    steps, each torch.equal to the plain segments."""
    pts, _ = _room()
    prob = tpose.PoseProblem(INTR.width, INTR.height, **SOFT)
    cfg = te.OptimizerConfig(lr_pose=0.1, lr_quat=0.05)
    outs = {}
    for name, adv in (("runner", tr.pose_runner(prob, cfg, 3)[1]),
                      ("plain", _plain_advance(prob, cfg, 3))):
        params = tpose.init_pose_params(np.array([[0.5, 0.3, 0.0]], np.float32),
                                        np.array([[0.9, 0.1, -0.2, 0.3]], np.float32))
        state, outs[name] = te.adam_init(params), []
        for _ in range(2):
            params, state, loss, aux = adv(params, state, torch.as_tensor(pts), None,
                                           INTR.matrix())
            outs[name].append((params, state, loss, aux))
    for g, e in zip(outs["runner"], outs["plain"]):
        assert _equal(g[0], e[0]) and _equal(g[1], e[1]) and torch.equal(g[2], e[2])
        assert _equal(g[3], e[3])


def test_soft_optimize_waypoints_equals_the_plain_loop(monkeypatch):
    """``optimize_waypoints`` with soft HPR on the binned tier (4 waypoints,
    3 steps): positions, quaternions and aux torch.equal to the same call
    with the engine's ``optimize`` replaced by the plain loop."""
    pts, path = _room()
    q = identity_quaternions(4)
    prob = twps.WpsOptProblem(INTR.width, INTR.height, **SOFT)
    got = twps.optimize_waypoints(pts, path[:4], q, INTR.matrix_np(), prob, n_steps=3,
                                  device="cpu")
    monkeypatch.setattr(twps, "optimize", ref.optimize)
    want = twps.optimize_waypoints(pts, path[:4], q, INTR.matrix_np(), prob, n_steps=3,
                                   device="cpu")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _equal(got[2], want[2])


# ---------------------------------------------------------------------------
# the public entry points against the JAX twins
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
    tests/test_torch_engine.py holds ``run_until_done``)."""
    jl, tl, q = _twin_loss_fns(cloud10[::8], path10, jt.waypoint_stride(path10))
    stop_kw = dict(rewards_th=1.02, smoothness_th=0.5)
    _, n_j, _ = je.optimize(jl, jt.init_traj_params(path10, q), je.OptimizerConfig(lr_pose=0.1,
                            lr_quat=0.02), 200, early_stop=je.EarlyStop(**stop_kw))
    _, n_t, _ = te.optimize(tl, tt.init_traj_params(path10, q), CFG, 200,
                            early_stop=te.EarlyStop(**stop_kw))
    assert 0 < n_j < 200 and n_t == n_j


def test_static_history_matches_jax_scan(cloud10, path10):
    """``_optimize_scan``: 12 steps, mean reward rtol 1e-5 and loss rtol 2e-4
    (test_torch_engine.py's bounds)."""
    jl, tl, q = _twin_loss_fns(cloud10[::8], path10, jt.waypoint_stride(path10))
    _, hj = je.optimize_with_history(jl, jt.init_traj_params(path10, q),
                                     je.OptimizerConfig(lr_pose=0.1, lr_quat=0.02), 12)
    _, ht = te.optimize_with_history(tl, tt.init_traj_params(path10, q), CFG, 12)
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
    tp, tn, tloss, taux = trun(tt.init_traj_params(path10, q), torch.as_tensor(pts),
                               torch.as_tensor(valid), INTR.matrix(), torch.as_tensor(path10),
                               torch.as_tensor(q))
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
    got = _pose_segments((tr.pose_runner(tp, te.OptimizerConfig(**DECAY), 3)[1],
                          tr.pose_runner(tp, te.OptimizerConfig(**DECAY), 2)[1]))
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


def test_plain_until_done_matches_jax_while(cloud10, path10):
    """The plain loop the program is held to, itself against the JAX twin's
    ``_optimize_while`` on cloud 10 / 8 and path 10: with early stop the
    same n_iters (tests/test_torch_engine.py's pin); 20 fixed steps to loss
    rtol 1e-3 and positions atol 5e-3 (its facade bounds)."""
    jl, tl, q = _twin_loss_fns(cloud10[::8], path10, jt.waypoint_stride(path10))
    jcfg = je.OptimizerConfig(lr_pose=0.1, lr_quat=0.02)
    stop_kw = dict(rewards_th=1.02, smoothness_th=0.5)
    _, n_j, _ = je.optimize(jl, jt.init_traj_params(path10, q), jcfg, 200,
                            early_stop=je.EarlyStop(**stop_kw))
    out = ref.until_done(tl, tt.init_traj_params(path10, q), CFG, 200, te.EarlyStop(**stop_kw))
    assert 0 < n_j < 200 and int(out["i"]) == n_j
    jp, n_j, jloss = je.optimize(jl, jt.init_traj_params(path10, q), jcfg, 20)
    out = ref.until_done(tl, tt.init_traj_params(path10, q), CFG, 20, ref.NEVER)
    assert int(out["i"]) == n_j == 20
    np.testing.assert_allclose(float(out["loss"]), jloss, rtol=1e-3)
    np.testing.assert_allclose(out["params"]["poses"].numpy(), np.asarray(jp["poses"]),
                               atol=5e-3)


# ---------------------------------------------------------------------------
# every configuration's step, with every host read refused
# ---------------------------------------------------------------------------

BINNED = dict(hpr_cap=64, hpr_safety=48.0)  # a few small bins: cheap on the CPU
HOST_READ_TABLE = [
    # (model, problem fields, points, HPR tier): the configurations the card
    # captures, cut to 4,096 points or fewer; each soft row's
    # soft_hpr_dense_max keeps the tier its full size took (dense up to the
    # limit, binned above it), and its binned tier takes BINNED's knobs (the
    # host reads do not depend on them); the full size beside each row
    ("traj", {}, 4096, None),  # 40,960
    ("traj", {"backend": "torch"}, 4096, None),  # 40,960
    ("traj", {"backend": "kernel"}, 4096, None),  # 8,388,608
    ("traj", {"soft_hpr": True}, 768, "dense"),  # 24,576
    ("traj", {"soft_hpr": True, "soft_hpr_dense_max": 1024}, 1024, "dense"),  # 32,768
    ("traj", {"soft_hpr": True, "soft_hpr_dense_max": 1024, **BINNED}, 1025, "binned"),  # 32,769
    ("traj", {"soft_hpr": True, "soft_hpr_dense_max": 1024, **BINNED}, 1280, "binned"),  # 40,960
    ("traj", {"soft_hpr": True, "soft_hpr_dense_max": 2048, **BINNED}, 4096, "binned"),  # 4,096
    ("traj", {"soft_hpr": False, "soft_hpr_dense_max": 2048}, 4096, None),  # 4,096
    ("pose", {}, 4096, None),  # 1,048,576
    ("pose", {"soft_hpr": True}, 768, "dense"),  # 24,576
    ("pose", {"soft_hpr": True, "soft_hpr_dense_max": 512, **BINNED}, 4096, "binned"),  # 262,144
    ("pose", {"soft_hpr": True, "soft_hpr_dense_max": 0}, 1, "binned"),  # 1
    ("wps", {}, 4096, None),  # 40,960
    ("wps", {"soft_hpr": True}, 768, "dense"),  # 24,576
    ("wps", {"soft_hpr": True, "soft_hpr_dense_max": 1024, **BINNED}, 1280, "binned"),  # 40,960
]
MODELS = {"traj": tt.TrajProblem, "pose": tpose.PoseProblem, "wps": twps.WpsOptProblem}


def _two_steps(model, problem, n):
    """Two steps of ``model``'s public runner on n seeded points: the run's
    first step and the static-buffer step the card captures."""
    P, K = torch.as_tensor(_seeded_cloud(n)), INTR.matrix()
    path = np.array([[6.0, 2.0, 0.0], [6.5, 2.0, 0.0], [7.0, 2.2, 0.0]], np.float32)
    q = identity_quaternions(len(path))
    if model == "traj":
        run = tr.traj_runner(problem, CFG, te.NEVER, 2)
        params = tt.init_traj_params(path, q)
        return lambda: run(params, P, None, K, torch.as_tensor(path), torch.as_tensor(q))
    if model == "pose":
        _, advance = tr.pose_runner(problem, CFG, 2)
        params = tpose.init_pose_params(path[:1], q[:1])
        state = te.adam_init(params)
        return lambda: advance(params, state, P, None, K)
    # optimize_waypoints' loop (the call itself reads its results on the host)
    params, frozen = twps.init_wps_params(path, q)
    stop = te.EarlyStop(float("inf"), float("inf"), "mean_reward", "mean_reward")
    return lambda: te.run_until_done(lambda p: twps.wps_forward(p, frozen, P, K, problem),
                                     params, CFG, 2, stop, pose_key="xy", quat_key="yaw")


@pytest.mark.parametrize("model,fields,n,tier", HOST_READ_TABLE)
def test_every_configuration_steps_without_a_host_read(model, fields, n, tier, monkeypatch,
                                                       no_host_reads):
    """Each configuration the card captures (the trajectory, pose and
    waypoint losses, both tiers of the soft gate they share) takes two
    steps on the CPU with every host read refused: the CPU stand-in for a
    capture's check that the step never reads the host. The soft rows run
    the tier they name."""
    from trajectory_optimization_tpu_torch.ops import hpr as thpr

    seen = set()
    for name in ("hpr_mask_soft", "hpr_mask_soft_binned"):
        def gate(*a, _f=getattr(thpr, name), _tier=name, **kw):
            seen.add("binned" if _tier.endswith("binned") else "dense")
            return _f(*a, **kw)
        monkeypatch.setattr(thpr, name, gate)
    step = _two_steps(model, MODELS[model](INTR.width, INTR.height, **fields), n)
    no_host_reads()
    out = step()
    monkeypatch.undo()
    assert seen == ({tier} if tier else set())
    loss = out[2] if model != "wps" else out["loss"]
    assert loss.shape == () and torch.isfinite(loss)


def test_public_entry_points_keep_one_bucket_and_capture_nothing_on_cpu(cloud10, path10):
    """On CPU tensors the runner keeps one bucket for two calls of one
    shape and the loop its static buffers, and ``StepGraph`` calls their
    step directly: no graph is captured, nothing replays."""
    prob, q, data = _traj_data(cloud10[::8], path10)
    runner = tr.traj_runner(prob, CFG, te.NEVER, 3)
    for _ in range(2):
        runner(tt.init_traj_params(path10, q), *data)
    (bucket,) = runner.buckets._items.values()
    assert not bucket.graph.captures and bucket.graph.graph is None
    assert bucket.graph.replays == 0
    loop = te.OptimizerLoop(_loss_fn(prob, data), tt.init_traj_params(path10, q), CFG)
    loop.run(2)
    assert loop._step is not None and loop._graph.graph is None and loop._graph.replays == 0


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

    g = tg.StepGraph(fn, CUDA)
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
    """On the CPU a step is called directly, never captured."""
    g = tg.StepGraph(lambda: _kernels.LAUNCHES.__setitem__("pass_b", _kernels.LAUNCHES["pass_b"]
                                                          + 1), torch.device("cpu"))
    g()
    g()
    assert _kernels.LAUNCHES["pass_b"] == 2 and g.graph is None and not _StubGraph.made


def test_a_failed_capture_raises_and_counts_nothing(stub_cuda):
    def fn():
        _kernels.LAUNCHES["pass_a"] += 1
        raise RuntimeError("operation not permitted when stream is capturing")

    g = tg.StepGraph(fn, CUDA, "test step")
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
    ok = tg.StepGraph(lambda: seen.append(gc.isenabled()), CUDA)

    def fail():
        seen.append(gc.isenabled())
        raise RuntimeError("operation not permitted when stream is capturing")

    assert gc.isenabled()
    ok()
    with pytest.raises(tg.CaptureError):
        tg.StepGraph(fail, CUDA)()
    assert seen == [False, False] and gc.isenabled()
    gc.disable()
    try:
        tg.StepGraph(lambda: seen.append(gc.isenabled()), CUDA)()
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
        g = tg.StepGraph(lambda: None, CUDA)
        g()
        _kernels._reduction_scratch[key] = (torch.zeros(8192, dtype=torch.int32), old[1])
        assert g.scratch is old
    finally:
        if saved is None:
            _kernels._reduction_scratch.pop(key, None)
        else:
            _kernels._reduction_scratch[key] = saved
