"""Parity of the port's pose model, pose runner and ``PoseOptimizer`` with
the JAX twins, on the CPU.

``pose_forward`` is ``waypoint_scores`` at one waypoint, plain PyTorch
against the JAX package's XLA path: forward rtol 1e-4 / atol 2e-4 and
gradients rtol 2e-3, the JAX suite's pins (tests/test_pallas_vis.py:40,67).
The runner and the facade run Adam for some steps; their tolerances are
stated where they are held.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import oracles  # noqa: E402
from trajectory_optimization_tpu import api as japi  # noqa: E402
from trajectory_optimization_tpu.models import pose as jpose  # noqa: E402
from trajectory_optimization_tpu.opt import engine as jengine  # noqa: E402
from trajectory_optimization_tpu.opt import runners as jrunners  # noqa: E402
from trajectory_optimization_tpu_torch import api as tapi  # noqa: E402
from trajectory_optimization_tpu_torch.models import pose as tpose  # noqa: E402
from trajectory_optimization_tpu_torch.ops import hpr as thpr  # noqa: E402
from trajectory_optimization_tpu_torch.opt import engine as tengine  # noqa: E402
from trajectory_optimization_tpu_torch.opt import runners as trunners  # noqa: E402
from trajectory_optimization_tpu_torch.utils.data import pad_points  # noqa: E402
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

INTR = default_intrinsics()
KJ = jnp.asarray(INTR.matrix_np())
FWD = dict(rtol=1e-4, atol=2e-4)
T0 = np.array([[6.0, 2.0, 0.0]], np.float32)
Q0 = np.array([[0.9, 0.1, -0.2, 0.3]], np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread (restored afterwards), as the other bit-comparing
    port tests run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problems(**kw):
    return (jpose.PoseProblem(INTR.width, INTR.height, **kw),
            tpose.PoseProblem(INTR.width, INTR.height, **kw))


def _gates(n, n_pad, rng):
    valid = np.zeros(n_pad, np.float32)
    valid[:n] = 1.0
    occ = (rng.random(n_pad) > 0.3).astype(np.float32)
    return valid, occ


@pytest.mark.parametrize("use_valid", [False, True])
@pytest.mark.parametrize("use_occ", [False, True])
def test_pose_forward_matches_jax(cloud10, use_valid, use_occ):
    pts, valid = pad_points(cloud10)
    _, occ = _gates(len(cloud10), len(pts), np.random.default_rng(1))
    jp, tp = _problems()
    jkw = dict(valid=jnp.asarray(valid) if use_valid else None,
               occlusion_mask=jnp.asarray(occ) if use_occ else None)
    tkw = dict(valid=torch.as_tensor(valid) if use_valid else None,
               occlusion_mask=torch.as_tensor(occ) if use_occ else None)
    jl, ja = jpose.pose_forward(jpose.init_pose_params(T0, Q0), jnp.asarray(pts),
                                KJ, jp, **jkw)
    tl, ta = tpose.pose_forward(tpose.init_pose_params(T0, Q0), torch.as_tensor(pts),
                                INTR.matrix(), tp, **tkw)
    obs = ta["observations"].numpy()
    assert obs.shape == (len(pts),) and float(obs.sum()) > 100.0
    np.testing.assert_allclose(obs, np.asarray(ja["observations"]), **FWD)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    if use_valid:
        assert not obs[len(cloud10):].any()  # the padding observes nothing


def test_pose_gradient_matches_jax_grad(cloud10):
    pts, valid = pad_points(cloud10[::2])
    jp, tp = _problems()

    def jloss(p):
        return jpose.pose_forward(p, jnp.asarray(pts), KJ, jp, valid=jnp.asarray(valid))[0]

    jg = jax.grad(jloss)(jpose.init_pose_params(T0, Q0))
    tparams = {k: v.requires_grad_(True) for k, v in tpose.init_pose_params(T0, Q0).items()}
    tl, _ = tpose.pose_forward(tparams, torch.as_tensor(pts), INTR.matrix(), tp,
                               valid=torch.as_tensor(valid))
    tl.backward()
    for k in ("trans", "quat"):
        want = np.asarray(jg[k])
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(tparams[k].grad.numpy(), want, rtol=2e-3,
                                   atol=2e-3 * np.abs(want).max())


def test_golden_pose_initial_loss(cloud10):
    """tests/test_api_golden.py:92-110 for the port: the float64 oracle's
    Σ observations of the start pose, and the f32 loss within rtol 1e-3."""
    q0, t0 = np.array([1.0, 0.0, 0.0, 0.0]), np.array([6.0, 2.0, 0.0])
    loss, obs = oracles.pose_loss(cloud10.astype(np.float64), q0, t0,
                                  INTR.matrix_np(np.float64), INTR.width, INTR.height)
    np.testing.assert_allclose(obs.sum(), 1857.20, rtol=2e-3)
    _, tp = _problems()
    l32, aux = tpose.pose_forward(tpose.init_pose_params(t0[None], q0[None]),
                                  torch.as_tensor(cloud10), INTR.matrix(), tp)
    np.testing.assert_allclose(float(l32), loss, rtol=1e-3)
    np.testing.assert_allclose(aux["observations"].double().sum().item(), obs.sum(), rtol=1e-3)


def _seeded_cloud(n=4096, seed=5):
    """n points ahead of the start pose (camera at (6, 2, 0) looking +z)."""
    rng = np.random.default_rng(seed)
    return rng.uniform([3.0, -1.0, 1.0], [9.0, 5.0, 7.0], size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("seg", [0, 3])
def test_pose_runner_matches_jax(seg):
    """Segments of ``seg`` steps and a 2-step remainder on a 4,096-point
    cloud with a decaying schedule, so the Adam count must carry across
    segments; each segment's parameters, loss and observations against the
    JAX runner's. 11 steps, measured: parameters 1.2e-7, loss 1e-7 relative
    apart; held to 1e-5 and 1e-4."""
    pts, valid = pad_points(_seeded_cloud())
    kw = dict(lr_pose=0.1, lr_quat=0.05, decay_gamma=0.5, decay_every=2)
    jp, tp = _problems()
    j_init, j_adv = jrunners.pose_runner(jp, jengine.OptimizerConfig(**kw), seg)
    t_init, t_adv = trunners.pose_runner(tp, tengine.OptimizerConfig(**kw), seg)
    _, j_rem = jrunners.pose_runner(jp, jengine.OptimizerConfig(**kw), 2)
    _, t_rem = trunners.pose_runner(tp, tengine.OptimizerConfig(**kw), 2)
    jparams, tparams = jpose.init_pose_params(T0, Q0), tpose.init_pose_params(T0, Q0)
    jstate, tstate = j_init(jparams), t_init(tparams)
    J = (jnp.asarray(pts), jnp.asarray(valid), KJ)
    T = (torch.as_tensor(pts), torch.as_tensor(valid), INTR.matrix())
    steps = 0
    for adv_j, adv_t, n in ((j_adv, t_adv, seg),) * 3 + ((j_rem, t_rem, 2),):
        jparams, jstate, jl, ja = adv_j(jparams, jstate, *J)
        tparams, tstate, tl, ta = adv_t(tparams, tstate, *T)
        steps += n
        assert int(tstate["count"]) == steps
        for k in ("trans", "quat"):
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]),
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
        np.testing.assert_allclose(ta["observations"].numpy(), np.asarray(ja["observations"]),
                                   **FWD)


def test_pose_runner_seg0_returns_the_start_forward():
    pts, valid = pad_points(_seeded_cloud())
    _, tp = _problems()
    init, adv = trunners.pose_runner(tp, tengine.OptimizerConfig(), 0)
    params = tpose.init_pose_params(T0, Q0)
    args = (torch.as_tensor(pts), torch.as_tensor(valid), INTR.matrix())
    out, state, loss, aux = adv(params, init(params), *args)
    l0, a0 = tpose.pose_forward(params, args[0], args[2], tp, valid=args[1])
    assert torch.equal(out["trans"], params["trans"]) and int(state["count"]) == 0
    assert torch.equal(loss, l0) and torch.equal(aux["observations"], a0["observations"])
    assert trunners.pose_runner(tp, tengine.OptimizerConfig(), 0)[1] is adv  # memoised


def test_pose_optimizer_matches_jax(cloud10):
    """tests/test_api_golden.py:46-51's call, 60 steps. Measured: position
    and quaternion 5e-7, loss 3e-7 relative, observations 2e-6 apart; held
    to 1e-4 and the forward pin."""
    kw = dict(lr_pose=0.02, lr_quat=0.02)
    pts = cloud10[::8]
    rj = japi.PoseOptimizer(**kw).optimize(pts, [6.0, 2.0, 0.0], [0.9, 0.1, -0.2, 0.3],
                                           n_steps=60)
    rt = tapi.PoseOptimizer(device="cpu", **kw).optimize(pts, [6.0, 2.0, 0.0],
                                                         [0.9, 0.1, -0.2, 0.3], n_steps=60)
    assert rt.n_iters == rj.n_iters == 60
    assert rt.observations.shape == rj.observations.shape == (len(pts),)
    assert rt.position.dtype == rt.quat_wxyz.dtype == np.float64
    np.testing.assert_allclose(np.linalg.norm(rt.quat_wxyz), 1.0, atol=1e-12)
    np.testing.assert_allclose(rt.position, rj.position, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rt.quat_wxyz, rj.quat_wxyz, atol=1e-4)
    np.testing.assert_allclose(rt.loss, rj.loss, rtol=1e-4)
    np.testing.assert_allclose(rt.observations, rj.observations, **FWD)


def test_pose_problem_fields_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jpose.PoseProblem)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tpose.PoseProblem)]
    assert tf == jf
    assert tpose.PoseProblem(1.0, 2.0).hpr_cap == 1024


@pytest.mark.parametrize("kw, steps", [({"use_hpr": True}, 10), ({"soft_hpr": True}, 3)],
                         ids=["use_hpr", "soft_hpr"])
def test_hpr_options_raise(cloud10, kw, steps):
    """The HPR options, once raising here, run and match the JAX facade on
    cloud 10 cut to 3,372 points (padded to 4,096). ``use_hpr`` gates the
    loss with the approximate mask of the world-frame cloud: a hidden point
    observes exactly nothing. ``soft_hpr`` differentiates through the dense
    soft mask every step; its gradients differ from the JAX ones by ~1e-3
    relative (f32 rounding through the sharp sigmoid, tests/test_torch_hpr.py),
    which Adam carries into the path, so it runs 3 steps."""
    pts = cloud10[::12]
    args = ([6.0, 2.0, 0.0], [0.9, 0.1, -0.2, 0.3])
    opt = dict(lr_pose=0.02, lr_quat=0.02, **kw)
    rj = japi.PoseOptimizer(**opt).optimize(pts, *args, n_steps=steps)
    rt = tapi.PoseOptimizer(device="cpu", **opt).optimize(pts, *args, n_steps=steps)
    if "use_hpr" in kw:
        hidden = thpr.hpr_mask_approx(torch.as_tensor(pts)).numpy() == 0
        assert 0 < hidden.sum() < len(pts) and not rt.observations[hidden].any()
    np.testing.assert_allclose(rt.position, rj.position, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rt.quat_wxyz, rj.quat_wxyz, atol=1e-4)
    np.testing.assert_allclose(rt.loss, rj.loss, rtol=1e-4)
    # an observation is the mask times a score <= 1: the soft mask's f32
    # spread (under 5e-3, tests/test_torch_hpr.py) bounds its difference
    np.testing.assert_allclose(rt.observations, rj.observations,
                               **(dict(rtol=1e-4, atol=5e-3) if "soft_hpr" in kw else FWD))


def test_soft_hpr_loss_and_gradient_match_jax(cloud10):
    """pose_forward(soft_hpr=True) on cloud 10 cut to 3,372 points padded to
    4,096: loss rtol 1e-4, gradients rtol 2e-3 (atol 2e-3 of the largest)."""
    pts, valid = pad_points(cloud10[::12], 4096)
    jp, tp = _problems(soft_hpr=True)

    def jloss(p):
        return jpose.pose_forward(p, jnp.asarray(pts), KJ, jp, valid=jnp.asarray(valid))[0]

    jl, jg = jax.value_and_grad(jloss)(jpose.init_pose_params(T0, Q0))
    tparams = {k: v.requires_grad_(True) for k, v in tpose.init_pose_params(T0, Q0).items()}
    tl, ta = tpose.pose_forward(tparams, torch.as_tensor(pts), INTR.matrix(), tp,
                                valid=torch.as_tensor(valid))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    for k in ("trans", "quat"):
        want = np.asarray(jg[k])
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(tparams[k].grad.numpy(), want, rtol=2e-3,
                                   atol=2e-3 * np.abs(want).max())


def test_soft_hpr_above_the_dense_size_raises():
    """Above soft_hpr_dense_max, where this raised before the binned tier
    was ported, pose_forward runs the direction-binned soft HPR and matches
    the JAX twin: the room of tests/test_torch_hpr_binned.py (3,681 points
    padded to 4,096) from (0.5, 0.3, 0) at Q0, dense size lowered to 2,048,
    cap 64. Loss rtol 1e-4, gradients rtol 2e-3 (atol 2e-3 of the
    largest), observations within the soft mask's spread (atol 5e-3)."""
    from test_torch_hpr_binned import assert_none_isolated, room_scene

    real = room_scene()
    pts, valid = pad_points(real, 4096)
    t0 = np.array([[0.5, 0.3, 0.0]], np.float32)
    assert_none_isolated(real, t0, Q0)
    jp, tp = _problems(soft_hpr=True, soft_hpr_dense_max=2048, hpr_cap=64)

    def jloss(p):
        return jpose.pose_forward(p, jnp.asarray(pts), KJ, jp, valid=jnp.asarray(valid))

    (jl, ja), jg = jax.value_and_grad(jloss, has_aux=True)(jpose.init_pose_params(t0, Q0))
    tparams = {k: v.requires_grad_(True) for k, v in tpose.init_pose_params(t0, Q0).items()}
    tl, ta = tpose.pose_forward(tparams, torch.as_tensor(pts), INTR.matrix(), tp,
                                valid=torch.as_tensor(valid))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_allclose(ta["observations"].detach().numpy(),
                               np.asarray(ja["observations"]), rtol=1e-4, atol=5e-3)
    for k in ("trans", "quat"):
        want = np.asarray(jg[k])
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(tparams[k].grad.numpy(), want, rtol=2e-3,
                                   atol=2e-3 * np.abs(want).max())