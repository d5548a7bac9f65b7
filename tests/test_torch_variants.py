"""Parity of the port's notebook variants (``models/distance_reward.py``,
``models/frustum_fd.py``) with the JAX twins, on the CPU with one torch
thread: the cases of tests/test_variants.py, each with the JAX twin beside
it. Held: the look-at transform to 1e-6; counts exactly (and against the
float64 oracle); finite-difference gradients exactly (they are count
differences); the distance-reward loss and aux rtol 1e-4 / atol 2e-4 and its
gradients rtol 2e-3 with atol 2e-3 of the largest entry, on the initial
path too, where the length term |len − len⁰| is exactly 0 and its
derivative is JAX's 1; short Adam runs of both against JAX's optax runs
(the FD pose path to 1e-4, the distance-reward mean reward rtol 1e-3 and
its path to 1 cm).
"""
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from trajectory_optimization_tpu.models import distance_reward as jdr  # noqa: E402
from trajectory_optimization_tpu.models import frustum_fd as jfd  # noqa: E402
from trajectory_optimization_tpu_torch.models import distance_reward as tdr  # noqa: E402
from trajectory_optimization_tpu_torch.models import frustum_fd as tfd  # noqa: E402
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

INTR = default_intrinsics()
FWD = dict(rtol=1e-4, atol=2e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def centered_cloud(cloud10):
    """tests/test_variants.py's: cloud 10's first 8,000 points, centred."""
    pts = cloud10[:8000]
    return (pts - pts.mean(axis=0)).astype(np.float32)


def test_look_at_matches_jax():
    for dea in ((5.0, 0.0, 0.0), (8.0, 10.0, 60.0), (10.0, 25.0, 140.0)):
        R, T = tfd.look_at_view_transform(*dea)
        jR, jT = jfd.look_at_view_transform(*dea)
        np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-6)
        np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=1e-5)
    R, T = tfd.look_at_view_transform(5.0, 0.0, 0.0)
    np.testing.assert_allclose(R[:, 2].numpy(), [0, 0, -1], atol=1e-6)
    np.testing.assert_allclose((R @ R.T).numpy(), np.eye(3), atol=1e-6)


def test_binary_visibility_count_matches_jax_and_f64_oracle(centered_cloud):
    """Exact counts: equal to JAX's at three elevations and to an
    independent float64 pipeline at two poses (strict border tests)."""
    P = torch.as_tensor(centered_cloud)
    counts = []
    for e in (0.0, 20.0, 45.0):
        got = float(tfd.binary_visibility_count(torch.tensor([10.0, e, 0.0]), P))
        assert got == float(jfd.binary_visibility_count(jnp.array([10.0, e, 0.0]),
                                                        jnp.asarray(centered_cloud)))
        counts.append(got)
    assert max(counts) > 1000 and all(c == int(c) for c in counts)
    pts64 = centered_cloud.astype(np.float64)
    for dea in ([8.0, 10.0, 60.0], [10.0, 25.0, 140.0]):
        d, e, a = dea
        er, ar = math.radians(e), math.radians(a)
        C = np.array([d * math.cos(er) * math.sin(ar), d * math.sin(er),
                      d * math.cos(er) * math.cos(ar)])
        z = -C / np.linalg.norm(C)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= max(np.linalg.norm(x), 1e-9)
        R = np.stack([x, np.cross(z, x), z], axis=1)
        cam = (pts64 - (-C @ R)) @ R
        ph = cam @ INTR.matrix_np(np.float64).T
        u, v = ph[:, 0] / ph[:, 2], ph[:, 1] / ph[:, 2]
        want = int(((cam[:, 2] > 1.0) & (cam[:, 2] < 10.0) & (ph[:, 2] > 0)
                    & (u > 1) & (u < INTR.width - 1)
                    & (v > 1) & (v < INTR.height - 1)).sum())
        assert int(tfd.binary_visibility_count(torch.tensor(dea), P)) == want, dea


def test_fd_gradients_are_reward_differences(centered_cloud):
    P = torch.as_tensor(centered_cloud)
    x = torch.tensor([10.0, 30.0, 10.0], requires_grad=True)
    r0 = float(tfd.binary_visibility_count(x.detach(), P))
    tfd.frustum_visibility_fd(x, P, 0.1).backward()
    jg = jax.grad(lambda p: jfd.frustum_visibility_fd(p, jnp.asarray(centered_cloud), 0.1))(
        jnp.array([10.0, 30.0, 10.0]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))
    for i in range(3):
        ri = float(tfd.binary_visibility_count(x.detach() + 0.1 * torch.eye(3)[i], P))
        assert float(x.grad[i]) == ri - r0


def test_fd_pose_optimization_matches_jax(centered_cloud):
    """40 Adam steps at the notebook's lr 0.5 (torch.optim.Adam, the update
    rule of optax.adam): the same path as JAX's, and no fewer points seen."""
    P = torch.as_tensor(centered_cloud)
    x = torch.tensor([12.0, 30.0, 20.0], requires_grad=True)
    opt = torch.optim.Adam([x], lr=0.5)
    r_init = float(tfd.binary_visibility_count(x.detach(), P))
    jx = jnp.array([12.0, 30.0, 20.0])
    tx = optax.adam(0.5)
    state = tx.init(jx)
    for _ in range(40):
        opt.zero_grad()
        tfd.fd_pose_loss(x, P).backward()
        opt.step()
        g = jax.grad(lambda p: jfd.fd_pose_loss(p, jnp.asarray(centered_cloud)))(jx)
        updates, state = tx.update(g, state, jx)
        jx = optax.apply_updates(jx, updates)
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx), rtol=1e-5, atol=1e-4)
    assert float(tfd.binary_visibility_count(x.detach(), P)) >= r_init


def test_gaussian_matches_jax():
    x = np.linspace(-5, 12, 50).astype(np.float32)
    for kw in (dict(mu=3.0, sigma=2.0), dict(), dict(mu=1.0, sigma=0.5, normalize=True)):
        np.testing.assert_allclose(tdr.gaussian(torch.as_tensor(x), **kw).numpy(),
                                   np.asarray(jdr.gaussian(jnp.asarray(x), **kw)), rtol=1e-6,
                                   atol=1e-30)  # JAX flushes denormals
    assert float(tdr.gaussian(torch.tensor(3.0), mu=3.0, sigma=2.0)) == 1.0


def _dr_both(pts, path, traj):
    prob_kw = dict(img_width=INTR.width, img_height=INTR.height)
    jp = jdr.init_distance_reward_params(path)
    jp = dict(jp, traj=jnp.asarray(traj))

    def jloss(p):
        return jdr.distance_reward_forward(p, jnp.asarray(pts), INTR.matrix_np(),
                                           jnp.asarray(path), jdr.DistanceRewardProblem(**prob_kw))

    (jl, ja), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = tdr.init_distance_reward_params(path)
    tp = {"traj": torch.as_tensor(traj).clone().requires_grad_(True),
          "rots": tp["rots"].requires_grad_(True)}
    tl, ta = tdr.distance_reward_forward(tp, torch.as_tensor(pts), INTR.matrix(),
                                         torch.as_tensor(path),
                                         tdr.DistanceRewardProblem(**prob_kw))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), **FWD)
    for k in ja:
        np.testing.assert_allclose(ta[k].detach().numpy(), np.asarray(ja[k]), **FWD)
    want = np.asarray(jg["traj"])
    assert np.abs(want).max() > 0 and np.isfinite(tp["traj"].grad.numpy()).all()
    np.testing.assert_allclose(tp["traj"].grad.numpy(), want, rtol=2e-3,
                               atol=2e-3 * np.abs(want).max())
    # the rotations reach the loss only through the binary frustum mask
    assert not np.asarray(jg["rots"]).any() and tp["rots"].grad is None
    return ta


@pytest.mark.parametrize("moved", [False, True])
def test_distance_reward_forward_and_grads_match_jax(cloud10, path10, moved):
    """On the initial path (len − len⁰ exactly 0: the length term's
    derivative is 1, jnp.abs's) and on a path moved by seeded noise."""
    traj = path10 + (np.random.default_rng(0).normal(scale=0.2, size=path10.shape)
                     .astype(np.float32) if moved else 0)
    ta = _dr_both(cloud10[:4000], path10, traj.astype(np.float32))
    r = ta["rewards"].detach().numpy()
    assert r.min() >= 0.49 and r.max() <= 1.0
    if not moved:
        assert float(ta["loss_length"]) == 0.0


def test_distance_reward_optimization_matches_jax(cloud10, path10):
    """25 Adam steps (lr 0.1 on the waypoints, the rotations fixed) as
    tests/test_variants.py: the same mean reward as JAX's run (rtol 1e-3)
    and above the start."""
    pts = cloud10[::8]
    prob_kw = dict(img_width=INTR.width, img_height=INTR.height)
    tp = tdr.init_distance_reward_params(path10)
    tp["traj"].requires_grad_(True)
    opt = torch.optim.Adam([tp["traj"]], lr=0.1)
    P, p0 = torch.as_tensor(pts), torch.as_tensor(path10)
    prob = tdr.DistanceRewardProblem(**prob_kw)
    reward0 = float(tdr.distance_reward_forward(tp, P, INTR.matrix(), p0, prob)[1]["mean_reward"])
    for _ in range(25):
        opt.zero_grad()
        loss, aux = tdr.distance_reward_forward(tp, P, INTR.matrix(), p0, prob)
        loss.backward()
        opt.step()

    jp = jdr.init_distance_reward_params(path10)
    jprob = jdr.DistanceRewardProblem(**prob_kw)

    def jloss(p):
        return jdr.distance_reward_forward(p, jnp.asarray(pts), INTR.matrix_np(),
                                           jnp.asarray(path10), jprob)

    tx = optax.multi_transform({"t": optax.adam(0.1), "r": optax.adam(0.0)},
                               param_labels={"traj": "t", "rots": "r"})
    state = tx.init(jp)
    for _ in range(25):
        (_, jaux), g = jax.value_and_grad(jloss, has_aux=True)(jp)
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
    assert float(aux["mean_reward"]) > reward0
    np.testing.assert_allclose(float(aux["mean_reward"]), float(jaux["mean_reward"]), rtol=1e-3)
    # Adam normalizes each entry's gradient: near-zero ones (z) follow their
    # f32 rounding, so the paths are held to 1 cm
    np.testing.assert_allclose(tp["traj"].detach().numpy(), np.asarray(jp["traj"]), atol=1e-2)
