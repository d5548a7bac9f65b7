"""Parity of the port's Waypoints Optimization (``models/wps_opt.py``) with
``trajectory_optimization_tpu.models.wps_opt``, on the CPU with one torch
thread.

Inputs as tests/test_wps_eval.py's (a seeded point blob in front of a small
camera), and the room of tests/test_torch_hpr_binned.py for the soft HPR
above a lowered dense size. Held: ``wps_path`` to 1e-6; ``wps_forward``'s
loss and aux rtol 1e-4 / atol 2e-4 (the JAX suite's forward bound) and its
gradients rtol 2e-3 with atol 2e-3 of the largest entry, plain, with
``occlusion_mask`` and ``valid``, and with the binned soft HPR
(observations there within the soft mask's spread, atol 5e-3); the
batched run equal to per-waypoint runs (atol 2e-5, the JAX suite's pin);
``optimize_waypoints`` after 10 steps against JAX's (positions and
quaternions atol 1e-4, losses rtol 1e-4), z and roll/pitch frozen.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from test_torch_hpr_binned import assert_none_isolated, room_path, room_scene  # noqa: E402
from trajectory_optimization_tpu.models import wps_opt as jw  # noqa: E402
from trajectory_optimization_tpu.ops import quat as jquat  # noqa: E402
from trajectory_optimization_tpu_torch import models as tmodels  # noqa: E402
from trajectory_optimization_tpu_torch.models import wps_opt as tw  # noqa: E402
from trajectory_optimization_tpu_torch.utils.data import pad_points  # noqa: E402
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

W, H = 64.0, 48.0
K = np.array([[50.0, 0, 32.0], [0, 50.0, 24.0], [0, 0, 1.0]], np.float32)
FWD = dict(rtol=1e-4, atol=2e-4)
POSES0 = np.array([[0, 0, 0.2], [0.5, -0.5, 0.4], [-0.3, 0.4, 0.1]], np.float32)
QUATS0 = np.tile(np.array([1.0, 0, 0, 0], np.float32), (3, 1))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(n=512, seed=0):
    """tests/test_wps_eval.py's blob around (1, 0.6, 3)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)) * 0.4 + np.array([1.0, 0.6, 3.0])).astype(np.float32)


def test_exported_like_the_jax_package():
    for name in ("WpsOptProblem", "init_wps_params", "optimize_waypoints", "wps_forward",
                 "wps_path"):
        assert getattr(tmodels, name) is getattr(tw, name)


def test_wps_path_at_zero_and_given_yaw():
    poses0 = np.array([[0, 0, 0.5], [1, 2, 0.7]], np.float32)
    quats0 = np.stack([jquat.from_euler_np(0.1, -0.2, 0.3),
                       jquat.from_euler_np(0, 0, 0)]).astype(np.float32)
    tp, tf = tw.init_wps_params(poses0, quats0)
    jp, jf = jw.init_wps_params(poses0, quats0)
    assert not tp["yaw"].any() and tp["xy"].shape == (2, 2) and tf["quats0"].shape == (2, 4)
    trans, quats = tw.wps_path(tp, tf)
    np.testing.assert_allclose(trans.numpy(), poses0, atol=1e-6)
    np.testing.assert_allclose(quats.numpy(), quats0, atol=1e-6)
    yaw = np.array([0.8, -0.3], np.float32)
    trans, quats = tw.wps_path(dict(tp, yaw=torch.as_tensor(yaw)), tf)
    jtrans, jquats = jw.wps_path(dict(jp, yaw=jnp.asarray(yaw)), jf)
    np.testing.assert_allclose(trans.numpy(), np.asarray(jtrans), atol=1e-6)
    np.testing.assert_allclose(quats.numpy(), np.asarray(jquats), atol=1e-6)


def _forward_both(pts, poses0, quats0, Kmat, prob_kw, **masks):
    """Loss, aux and gradients of both packages at a moved start (xy + 0.1,
    yaw 0.2): away from the initial path, so every gradient term is live."""
    jp, jf = jw.init_wps_params(poses0, quats0)
    jp = {"xy": jp["xy"] + 0.1, "yaw": jp["yaw"] + 0.2}
    jm = {k: jnp.asarray(v) for k, v in masks.items()}

    def jloss(p):
        return jw.wps_forward(p, jf, jnp.asarray(pts), jnp.asarray(Kmat),
                              jw.WpsOptProblem(**prob_kw), **jm)

    (jl, ja), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp, tf = tw.init_wps_params(poses0, quats0)
    tp = {"xy": (tp["xy"] + 0.1).requires_grad_(True), "yaw": (tp["yaw"] + 0.2).requires_grad_(True)}
    tl, ta = tw.wps_forward(tp, tf, torch.as_tensor(pts), torch.as_tensor(Kmat),
                            tw.WpsOptProblem(**prob_kw),
                            **{k: torch.as_tensor(v) for k, v in masks.items()})
    tl.backward()
    return (jl, ja, jg), (tl, ta, {k: v.grad for k, v in tp.items()})


def _hold(j, t, obs_atol=FWD["atol"]):
    (jl, ja, jg), (tl, ta, tg) = j, t
    np.testing.assert_allclose(float(tl), float(jl), **FWD)
    np.testing.assert_allclose(ta["losses"].detach().numpy(), np.asarray(ja["losses"]), **FWD)
    np.testing.assert_allclose(float(ta["mean_reward"]), float(ja["mean_reward"]), **FWD)
    np.testing.assert_allclose(ta["observations"].detach().numpy(),
                               np.asarray(ja["observations"]), rtol=1e-4, atol=obs_atol)
    for k in ("xy", "yaw"):
        want = np.asarray(jg[k])
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(tg[k].numpy(), want, rtol=2e-3, atol=2e-3 * np.abs(want).max())


@pytest.mark.parametrize("masks", ["none", "occlusion", "valid"])
def test_wps_forward_matches_jax(masks):
    pts = _scene()
    gate = (np.arange(len(pts)) % 3 != 0).astype(np.float32)
    kw = {"none": {}, "occlusion": {"occlusion_mask": gate}, "valid": {"valid": gate}}[masks]
    j, t = _forward_both(pts, POSES0, QUATS0, K, dict(img_width=W, img_height=H), **kw)
    _hold(j, t)
    if masks != "none":
        assert not t[1]["observations"][:, gate == 0].any()


def test_wps_forward_binned_soft_hpr_matches_jax():
    """The binned tier (dense size lowered to 2,048, cap 64) on the room,
    padded to 4,096 with ``valid``, three of its waypoints."""
    real = room_scene()
    pts, valid = pad_points(real, 4096)
    intr = default_intrinsics()
    poses0 = room_path()[::3]
    quats0 = np.tile(np.array([1.0, 0, 0, 0], np.float32), (len(poses0), 1))
    moved = poses0.copy()
    moved[:, :2] += 0.1
    half = 0.1  # the yaw of 0.2 that _forward_both starts from
    yawq = np.tile(np.array([np.cos(half), 0, 0, np.sin(half)], np.float32), (len(poses0), 1))
    assert_none_isolated(real, moved, yawq)
    kw = dict(img_width=intr.width, img_height=intr.height, soft_hpr=True,
              soft_hpr_dense_max=2048, hpr_cap=64)
    j, t = _forward_both(pts, poses0, quats0, intr.matrix_np(), kw, valid=valid)
    _hold(j, t, obs_atol=5e-3)


def test_batched_equals_sequential():
    pts = _scene()
    prob = tw.WpsOptProblem(img_width=W, img_height=H)
    kw = dict(n_steps=25, lr_xy=0.05, lr_yaw=0.05, device="cpu")
    trans_b, quats_b, _ = tw.optimize_waypoints(pts, POSES0, QUATS0, K, prob, **kw)
    for w in range(3):
        trans_1, quats_1, _ = tw.optimize_waypoints(pts, POSES0[w:w + 1], QUATS0[w:w + 1], K,
                                                    prob, **kw)
        np.testing.assert_allclose(trans_b[w].numpy(), trans_1[0].numpy(), rtol=0, atol=2e-5)
        np.testing.assert_allclose(quats_b[w].numpy(), quats_1[0].numpy(), rtol=0, atol=2e-5)


def test_optimize_waypoints_matches_jax_and_freezes_z():
    pts = _scene()
    kw = dict(n_steps=10, lr_xy=0.05, lr_yaw=0.05)
    jtrans, jquats, jaux = jw.optimize_waypoints(pts, POSES0, QUATS0, K,
                                                 jw.WpsOptProblem(img_width=W, img_height=H),
                                                 **kw)
    trans, quats, aux = tw.optimize_waypoints(pts, POSES0, QUATS0, K,
                                              tw.WpsOptProblem(img_width=W, img_height=H),
                                              device="cpu", **kw)
    assert trans.device.type == "cpu" and set(aux) == set(jaux)
    np.testing.assert_allclose(trans.numpy(), np.asarray(jtrans), rtol=0, atol=1e-4)
    np.testing.assert_allclose(quats.numpy(), np.asarray(jquats), rtol=0, atol=1e-4)
    for k in ("losses", "losses0"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]), rtol=1e-4)
    assert (aux["losses"] < aux["losses0"]).all()
    np.testing.assert_array_equal(trans[:, 2].numpy(), POSES0[:, 2])
    np.testing.assert_allclose(quats[:, 1:3].numpy(), 0.0, atol=1e-6)
