"""Parity of the port's optimization engine, runner and facade
(opt/engine.py, opt/runners.py, api.py, utils/convert.py) with the JAX twin.

Adam normalizes every gradient component, so f32 rounding differences
between two correct runs grow along a run (a near-zero component can turn
into a ±lr step of either sign). Single steps are compared tightly; runs are
compared on their loss history and mean reward, with each tolerance's
reason beside it.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from trajectory_optimization_tpu import api as japi  # noqa: E402
from trajectory_optimization_tpu.models import traj as jt  # noqa: E402
from trajectory_optimization_tpu.opt import engine as je  # noqa: E402
from trajectory_optimization_tpu_torch import api as tapi  # noqa: E402
from trajectory_optimization_tpu_torch.models import traj as tt  # noqa: E402
from trajectory_optimization_tpu_torch.opt import engine as te  # noqa: E402
from trajectory_optimization_tpu_torch.utils.convert import (  # noqa: E402
    adam_state_from_numpy,
    params_from_numpy,
    params_to_numpy,
)
from trajectory_optimization_tpu_torch.utils.data import identity_quaternions  # noqa: E402
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

INTR = default_intrinsics()
CFGS = {
    "constant": dict(lr_pose=0.1, lr_quat=0.02),
    "decay": dict(lr_pose=0.1, lr_quat=0.02, decay_gamma=0.9, decay_every=2),
}


@pytest.mark.parametrize("count", [0, 1, 2, 39, 40, 41, 80, 81, 1000])
def test_exponential_every_matches_jax(count):
    got = te.exponential_every(0.1, 0.9, 40)(torch.tensor(count))
    want = je.exponential_every(0.1, 0.9, 40)(jnp.asarray(count))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("cfg_name", sorted(CFGS))
def test_adam_step_from_jax_state_matches_optax(cfg_name):
    """Three optax steps to a mid-run state; carry params and moments across
    (utils.convert); one more step in each engine from the same gradients."""
    rng = np.random.default_rng(7)
    shapes = {"poses": (5, 3), "quats": (5, 4)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(scale=10.0 ** -i, size=s).astype(np.float32) for k, s in shapes.items()}
             for i in range(4)]
    jcfg = je.OptimizerConfig(**CFGS[cfg_name])
    tx = je.make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads[:3]:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
    adam = {grp: state.inner_states[grp].inner_state[0] for grp in ("pose", "quat")}
    key_grp = {"poses": "pose", "quats": "quat"}
    mu = {k: np.asarray(adam[key_grp[k]].mu[k]) for k in shapes}
    nu = {k: np.asarray(adam[key_grp[k]].nu[k]) for k in shapes}
    count = int(adam["pose"].count)

    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    tstate = adam_state_from_numpy(mu, nu, count)
    tcfg = te.OptimizerConfig(**CFGS[cfg_name])
    tp, tstate = te.adam_update({k: torch.as_tensor(v) for k, v in grads[3].items()}, tstate, tp,
                                tcfg, te.group_lrs(tcfg))
    upd, state = tx.update({k: jnp.asarray(v) for k, v in grads[3].items()}, state, jp)
    jp = {k: jp[k] + upd[k] for k in jp}
    adam = {grp: state.inner_states[grp].inner_state[0] for grp in ("pose", "quat")}
    assert int(tstate["count"]) == int(adam["pose"].count) == 4
    for k in shapes:
        # one f32 step: powers and square roots of two libraries, a few ulps
        np.testing.assert_allclose(params_to_numpy(tp)[k], np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tstate["mu"][k].numpy(), np.asarray(adam[key_grp[k]].mu[k]),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(tstate["nu"][k].numpy(), np.asarray(adam[key_grp[k]].nu[k]),
                                   rtol=1e-6, atol=1e-12)


def test_adam_matches_torch_optim_adam():
    w0 = np.array([[1.0, -2.0, 3.0]], dtype=np.float32)
    wt = torch.nn.Parameter(torch.tensor(w0))
    opt = torch.optim.Adam([wt], lr=0.1)
    for _ in range(25):
        opt.zero_grad()
        (wt ** 2).sum().backward()
        opt.step()

    def loss_fn(p):
        one = torch.ones(())
        return torch.sum(p["poses"] ** 2), {"mean_reward": one, "loss_smooth": one}

    params = {"poses": torch.tensor(w0), "quats": torch.zeros((1, 4))}
    out, n, _ = te.optimize(loss_fn, params, te.OptimizerConfig(lr_pose=0.1), 25)
    assert n == 25
    # sqrt(v/bc2) here vs sqrt(v)/sqrt(bc2) in torch.optim: same math, f32
    # rounding over 25 steps (measured 1.4e-5)
    np.testing.assert_allclose(out["poses"].numpy(), wt.detach().numpy(), atol=5e-5)


def _loss_fns(pts, path, stride):
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


def test_optimize_early_stop_matches_jax(cloud10, path10):
    pts = cloud10[::8]
    jl, tl, q = _loss_fns(pts, path10, jt.waypoint_stride(path10))
    stop_kw = dict(rewards_th=1.02, smoothness_th=0.5)
    cfg_kw = dict(lr_pose=0.1, lr_quat=0.02)
    _, n_j, _ = je.optimize(jl, jt.init_traj_params(path10, q), je.OptimizerConfig(**cfg_kw), 200,
                            early_stop=je.EarlyStop(**stop_kw))
    runs = [
        te.run_until_done(tl, tt.init_traj_params(path10, q), te.OptimizerConfig(**cfg_kw), 200,
                          te.EarlyStop(**stop_kw), check_every=every)
        for every in (1, 16)
    ]
    assert 0 < n_j < 200
    assert int(runs[0]["i"]) == int(runs[1]["i"]) == n_j
    # the frozen tail is an exact no-op: reading `done` late changes nothing
    for k in ("poses", "quats"):
        assert torch.equal(runs[0]["params"][k], runs[1]["params"][k])
    assert torch.equal(runs[0]["state"]["count"], torch.tensor(n_j, dtype=torch.int32))


def test_optimize_with_history_matches_jax(cloud10, path10):
    pts = cloud10[::8]
    jl, tl, q = _loss_fns(pts, path10, jt.waypoint_stride(path10))
    cfg_kw = dict(lr_pose=0.1, lr_quat=0.02)
    _, hj = je.optimize_with_history(jl, jt.init_traj_params(path10, q),
                                     je.OptimizerConfig(**cfg_kw), 12)
    _, ht = te.optimize_with_history(tl, tt.init_traj_params(path10, q),
                                     te.OptimizerConfig(**cfg_kw), 12)
    assert set(ht) == set(hj)
    # 12 steps, measured: mean reward 6e-7 and loss 2.2e-5 apart (the
    # smoothness term's arccos is the least well conditioned); bounds ~10x
    np.testing.assert_allclose(ht["mean_reward"], np.asarray(hj["mean_reward"]), rtol=1e-5)
    np.testing.assert_allclose(ht["loss"], np.asarray(hj["loss"]), rtol=2e-4)


def test_optimizer_loop_matches_optimize(cloud10, path10):
    _, tl, q = _loss_fns(cloud10[::16], path10, 2)
    cfg = te.OptimizerConfig(lr_pose=0.1, lr_quat=0.02)
    loop = te.OptimizerLoop(tl, tt.init_traj_params(path10, q), cfg)
    loop.run(3)
    loss, aux = loop.run(4)
    out, n, last = te.optimize(tl, tt.init_traj_params(path10, q), cfg, 7)
    assert n == 7 and float(loss) == last and "mean_reward" in loop.last_aux
    for k in ("poses", "quats"):
        assert torch.equal(loop.params[k], out[k])


@pytest.mark.parametrize("warm", [False, True])
def test_facade_matches_jax(cloud10, path10, warm):
    pts = cloud10[::5]  # 8091 points
    warm_start = None
    if warm:
        rng = np.random.default_rng(3)
        warm_start = {"poses": (path10 + rng.normal(scale=0.1, size=path10.shape)).astype(np.float32),
                      "quats": identity_quaternions(len(path10))}
    kw = dict(lr_pose=0.1, lr_quat=0.02)
    rj = japi.TrajectoryOptimizer(backend="xla", **kw).optimize(
        pts, path10, n_steps=20,
        warm_start=None if warm_start is None else {k: jnp.asarray(v) for k, v in warm_start.items()})
    rt = tapi.TrajectoryOptimizer(device="cpu", **kw).optimize(
        pts, path10, n_steps=20, warm_start=warm_start)
    assert rt.n_iters == rj.n_iters == 20
    assert rt.rewards.shape == rj.rewards.shape == (len(pts),)
    # 20 steps, measured: mean reward 1e-6, loss 6e-5, positions 6e-4 m
    # apart; bounds 10x that (rounding growth, see the header)
    np.testing.assert_allclose(rt.rewards.mean(), rj.rewards.mean(), rtol=1e-5)
    np.testing.assert_allclose(rt.visibility_gain, rj.visibility_gain, rtol=1e-5)
    np.testing.assert_allclose(rt.smoothness_gain, rj.smoothness_gain, rtol=1e-4)
    np.testing.assert_allclose(rt.loss, rj.loss, rtol=1e-3)
    np.testing.assert_allclose(rt.poses, rj.poses, atol=5e-3)
    np.testing.assert_allclose(np.linalg.norm(rt.quats_wxyz, axis=1), 1.0, rtol=1e-6)


def test_traj_runner_is_cached_per_problem():
    from trajectory_optimization_tpu_torch.opt.runners import traj_runner

    prob = tt.TrajProblem(INTR.width, INTR.height)
    cfg = te.OptimizerConfig()
    assert traj_runner(prob, cfg, te.NEVER, 5) is traj_runner(prob, cfg, te.NEVER, 5)
    assert traj_runner(prob, cfg, te.NEVER, 5) is not traj_runner(prob, cfg, te.NEVER, 6)
