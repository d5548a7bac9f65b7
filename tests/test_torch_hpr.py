"""Parity of the port's hidden-point removal (``ops/hpr.py``) with
``trajectory_optimization_tpu.ops.hpr``, on the CPU with one torch thread.

Inputs are numpy-seeded: cloud 10 seen from (6, 2, 0) (tests/test_hpr.py's
camera-frame cloud), subsampled, and the four structured scenes of
tests/test_hpr.py. Held:

* the flip and its gradient: rtol 1e-5 (the gradient at the point at the
  origin exactly so, elsewhere with atol 1e-5 of its largest entry);
* the exact mask: equal to the JAX package's;
* the approximate mask: under 1% of points differ from the JAX twin's, no
  point marked that Qhull hides, recall as tests/test_hpr.py asks; padding
  changes under 1% of the points and reports 0; a (C, N) batch equals C
  single calls;
* the soft mask: the sigmoid runs at β = 400/max‖p‖ on flipped radii of
  ~200·max‖p‖, so one f32 rounding of ρ or of the log-sum-exp moves the mask
  by ~2.4e-3 where it is steep, and two f32 evaluations differ by a few of
  them (measured here: JAX's own mask is 3.7e-3 from a float64 evaluation at
  worst, the port's 3.5e-3). Held: 99.8% of points within atol 3e-3 of the
  JAX mask, every point within twice JAX's distance from the float64
  evaluation, the per-point gradient within 1% of the JAX one in L2 norm;
  the port against itself, padded or not: atol 3e-3 (tests/test_hpr.py:132's
  pin);
* the trajectory loss with ``soft_hpr=True`` (the pose loss is held in
  tests/test_torch_pose.py): loss rtol 1e-4, gradients rtol 2e-3 with atol
  2e-3 of the largest entry, rewards within the soft mask's spread; the
  same above a lowered ``soft_hpr_dense_max``, where ``soft_hpr_gate``
  routes to the binned tier (tests/test_torch_hpr_binned.py holds that
  tier itself).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from test_hpr import _ADVERSARIAL_SCENES  # noqa: E402
from trajectory_optimization_tpu.models import traj as jt  # noqa: E402
from trajectory_optimization_tpu.ops import hpr as jhpr  # noqa: E402
from trajectory_optimization_tpu_torch.models import traj as tt  # noqa: E402
from trajectory_optimization_tpu_torch.ops import hpr as thpr  # noqa: E402
from trajectory_optimization_tpu_torch.utils.data import identity_quaternions, pad_points  # noqa: E402
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

VIEW = np.array([6.0, 2.0, 0.0], np.float32)
INTR = default_intrinsics()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread (restored afterwards): the soft mask's exp
    underflows, and threads may split its sums differently."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cam_cloud(cloud10):
    return cloud10 - VIEW


def _approx_vs(got, want_jax, exact):
    """< 1% of the mask differs from the JAX twin's, no false positive
    against Qhull; returns the recall."""
    assert (got != want_jax).mean() < 0.01
    assert (got & ~exact).sum() == 0
    return (got & exact).sum() / exact.sum()


def test_spherical_flip_and_gradient_match_jax(cam_cloud):
    sub = cam_cloud[::20].copy()
    sub[3] = 0.0  # a point at the sensor origin
    w = np.random.default_rng(0).normal(size=sub.shape).astype(np.float32)
    jf = np.asarray(jhpr.spherical_flip(jnp.asarray(sub)))
    jg = np.asarray(jax.grad(lambda p: jnp.sum(jhpr.spherical_flip(p) * w))(jnp.asarray(sub)))
    P = torch.as_tensor(sub).requires_grad_(True)
    tf = thpr.spherical_flip(P)
    torch.sum(tf * torch.as_tensor(w)).backward()
    np.testing.assert_allclose(tf.detach().numpy(), jf, rtol=1e-5)
    g = P.grad.numpy()
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g[3], jg[3], rtol=1e-5)  # at ‖p‖ = 0
    # elsewhere the gradient's terms cancel in some coordinates: atol scaled
    # to the largest entry, as the other port tests hold gradients
    np.testing.assert_allclose(g, jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max())


def test_exact_mask_equals_jax(cam_cloud):
    sub = cam_cloud[::8]
    got = thpr.hpr_mask_exact(sub)
    np.testing.assert_array_equal(got, jhpr.hpr_mask_exact(sub))
    pts, mask = thpr.hpr_points_exact(sub)
    np.testing.assert_array_equal(pts, sub[mask])


def test_approx_matches_jax_and_qhull_on_cloud10(cam_cloud):
    sub = cam_cloud[::8]  # 5,057 points
    exact = jhpr.hpr_mask_exact(sub)
    want = np.asarray(jhpr.hpr_mask_approx(jnp.asarray(sub))) > 0.5
    got = thpr.hpr_mask_approx(torch.as_tensor(sub)).numpy() > 0.5
    assert _approx_vs(got, want, exact) >= 0.99


@pytest.mark.parametrize("name", sorted(_ADVERSARIAL_SCENES))
def test_approx_matches_jax_and_qhull_on_adversarial_scenes(name):
    pts = _ADVERSARIAL_SCENES[name]()
    exact = jhpr.hpr_mask_exact(pts)
    want = np.asarray(jhpr.hpr_mask_approx(jnp.asarray(pts))) > 0.5
    got = thpr.hpr_mask_approx(torch.as_tensor(pts)).numpy() > 0.5
    assert _approx_vs(got, want, exact) >= 0.98


def test_approx_padding_invariance(cam_cloud):
    sub = cam_cloud[:3000]
    plain = thpr.hpr_mask_approx(torch.as_tensor(sub), n_passes=4).numpy()
    padded, valid = pad_points(sub, 4096)
    masked = thpr.hpr_mask_approx(torch.as_tensor(padded), n_passes=4,
                                  valid=torch.as_tensor(valid)).numpy()
    assert (masked[:3000] != plain).mean() < 0.01
    assert masked[3000:].max() == 0.0
    assert ((masked[:3000] > 0.5) & ~thpr.hpr_mask_exact(sub)).sum() == 0


def test_approx_batch_equals_single_calls(cloud10):
    """(C, N) with a valid mask per camera == C calls on (N,), bit for bit."""
    views = np.array([[6.0, 2.0, 0.0], [12.0, -3.0, 1.0], [3.0, 6.0, -1.0]], np.float32)
    sizes = (2500, 1900, 2200)
    P = np.full((3, 2560, 3), 1e6, np.float32)
    V = np.zeros((3, 2560), np.float32)
    for c, (v, n) in enumerate(zip(views, sizes)):
        P[c, :n] = cloud10[c::16][:n] - v
        V[c, :n] = 1.0
    batch = thpr.hpr_mask_approx(torch.as_tensor(P), valid=torch.as_tensor(V))
    for c in range(3):
        one = thpr.hpr_mask_approx(torch.as_tensor(P[c]), valid=torch.as_tensor(V[c]))
        assert torch.equal(batch[c], one)
        assert float(one.sum()) > 100


def _soft_f64(points):
    """hpr_mask_soft's formula in float64 (no padding)."""
    p = points.astype(np.float64)
    norms = np.linalg.norm(p, axis=1)
    rho = 2.0 * norms.max() * 100.0 - norms
    scale = norms.max()
    u = p / np.maximum(norms, 1e-12)[:, None]
    dom = np.clip(u @ u.T, 0.0, 1.0) * rho[None]
    np.fill_diagonal(dom, -1e30)
    beta = 400.0 / scale
    x = beta * dom
    m = x.max(axis=1)
    smax = (m + np.log(np.exp(x - m[:, None]).sum(axis=1))) / beta
    return 1.0 / (1.0 + np.exp(-beta * (rho + 0.02 * scale - smax)))


def test_soft_mask_and_gradient_match_jax(cam_cloud):
    sub = cam_cloud[::16].copy()  # 2,529 points
    sub[5] = 0.0  # a point at the sensor origin
    w = np.random.default_rng(0).normal(size=len(sub)).astype(np.float32)
    jv = np.asarray(jhpr.hpr_mask_soft(jnp.asarray(sub)))
    jg = np.asarray(jax.grad(lambda p: jnp.sum(jhpr.hpr_mask_soft(p) * w))(jnp.asarray(sub)))
    P = torch.as_tensor(sub).requires_grad_(True)
    tv = thpr.hpr_mask_soft(P, block=300)  # several row blocks
    torch.sum(tv * torch.as_tensor(w)).backward()
    tv, tg = tv.detach().numpy(), P.grad.numpy()
    d = np.abs(tv - jv)
    assert (d > 3e-3).mean() <= 2e-3, np.sort(d)[-10:]
    assert d.max() <= 2.0 * np.abs(jv - _soft_f64(sub)).max()
    assert ((tv > 0.5) == (jv > 0.5)).mean() > 0.999
    assert np.isfinite(tg).all() and np.abs(tg).max() > 0
    assert np.linalg.norm(tg - jg) <= 1e-2 * np.linalg.norm(jg)


def test_soft_mask_padding(cam_cloud):
    sub = cam_cloud[:3000]
    plain = thpr.hpr_mask_soft(torch.as_tensor(sub)).numpy()
    padded, valid = pad_points(sub, 4096)
    masked = thpr.hpr_mask_soft(torch.as_tensor(padded), valid=torch.as_tensor(valid)).numpy()
    np.testing.assert_allclose(masked[:3000], plain, atol=3e-3)
    assert masked[3000:].max() < 1e-3


def test_soft_gate_raises_above_the_dense_size(monkeypatch):
    """soft_hpr_gate, which raised above the dense size before the binned
    tier was ported, routes by the problem: the dense mask up to
    ``soft_hpr_dense_max`` points, the binned one with the problem's
    ``hpr_cap``/``hpr_safety`` above it (the JAX defaults for a problem
    without them), and the binned mask matches the JAX twin's on the room
    of tests/test_torch_hpr_binned.py seen from its centre (atol 3e-3 on
    99.8% of points, the 0.5 threshold on 99.9%)."""
    from types import SimpleNamespace

    from test_torch_hpr_binned import assert_none_isolated, room_scene

    cam = torch.as_tensor(room_scene())
    assert_none_isolated(cam.numpy(), [np.zeros(3)], [[1.0, 0, 0, 0]])
    prob = tt.TrajProblem(INTR.width, INTR.height, soft_hpr=True, soft_hpr_dense_max=len(cam),
                          hpr_cap=256, hpr_safety=2.0)
    assert torch.equal(thpr.soft_hpr_gate(cam, None, prob), thpr.hpr_mask_soft(cam))
    low = tt.TrajProblem(INTR.width, INTR.height, soft_hpr=True, soft_hpr_dense_max=2048,
                         hpr_cap=256, hpr_safety=2.0)
    got = thpr.soft_hpr_gate(cam, None, low)
    assert torch.equal(got, thpr.hpr_mask_soft_binned(cam, cap=256, safety=2.0))
    seen = []
    monkeypatch.setattr(thpr, "hpr_mask_soft_binned", lambda c, **kw: seen.append(kw) or c[:, 0])
    thpr.soft_hpr_gate(cam, None, SimpleNamespace(soft_hpr_dense_max=2048))
    assert seen == [dict(valid=None, cap=1024, safety=3.0)]
    monkeypatch.undo()
    want = np.asarray(jhpr.hpr_mask_soft_binned(jnp.asarray(cam.numpy()), cap=256, safety=2.0))
    d = np.abs(got.numpy() - want)
    assert (d > 3e-3).mean() <= 2e-3, np.sort(d)[-10:]
    assert ((got.numpy() > 0.5) == (want > 0.5)).mean() > 0.999


def test_traj_soft_hpr_loss_and_gradient_match_jax(cloud10, path10):
    """traj_forward(soft_hpr=True) on cloud 10 cut to 1,686 points padded to
    2,048 (valid-masked), path 10 moved by seeded noise, every fourth
    waypoint (7)."""
    pts, valid = pad_points(cloud10[::24], 2048)
    rng = np.random.default_rng(0)
    poses = (path10 + rng.normal(scale=0.2, size=path10.shape)).astype(np.float32)
    quats = identity_quaternions(len(path10))
    quats[::3] = [0.9, 0.1, -0.3, 0.2]
    q0 = identity_quaternions(len(path10))
    kw = dict(wps_step=4, soft_hpr=True)
    V = valid

    def jloss(p):
        return jt.traj_forward(p, jnp.asarray(pts), jnp.asarray(INTR.matrix_np()),
                               jnp.asarray(path10), jnp.asarray(q0),
                               jt.TrajProblem(INTR.width, INTR.height, **kw),
                               valid=None if V is None else jnp.asarray(V))

    (jl, ja), jg = jax.value_and_grad(jloss, has_aux=True)(jt.init_traj_params(poses, quats))
    params = {k: v.requires_grad_(True) for k, v in tt.init_traj_params(poses, quats).items()}
    tl, ta = tt.traj_forward(params, torch.as_tensor(pts), INTR.matrix(), torch.as_tensor(path10),
                             torch.as_tensor(q0), tt.TrajProblem(INTR.width, INTR.height, **kw),
                             valid=None if V is None else torch.as_tensor(V))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_allclose(ta["rewards"].detach().numpy(), np.asarray(ja["rewards"]),
                               rtol=1e-4, atol=5e-3)
    for k in ("poses", "quats"):
        want = np.asarray(jg[k])
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(params[k].grad.numpy(), want, rtol=2e-3,
                                   atol=2e-3 * np.abs(want).max())


def test_traj_soft_hpr_above_the_dense_size_raises():
    """traj_forward(soft_hpr=True) above a lowered soft_hpr_dense_max, which
    raised before the binned tier was ported, runs it and matches the JAX
    twin: the room of tests/test_torch_hpr_binned.py (3,681 points padded
    to 4,096, valid-masked), its seven-waypoint path moved by seeded noise,
    every second waypoint (4), the binned tier at cap 64. Held as the
    dense case above: loss rtol 1e-4, rewards atol 5e-3, gradients rtol
    2e-3 with atol 2e-3 of the largest entry."""
    from test_torch_hpr_binned import assert_none_isolated, room_path, room_scene

    real = room_scene()
    pts, valid = pad_points(real, 4096)
    path = room_path()
    rng = np.random.default_rng(0)
    poses = (path + rng.normal(scale=0.1, size=path.shape)).astype(np.float32)
    quats = identity_quaternions(len(path))
    quats[::3] = [0.9, 0.1, -0.3, 0.2]
    assert_none_isolated(real, poses[::2], quats[::2])
    q0 = identity_quaternions(len(path))
    kw = dict(wps_step=2, soft_hpr=True, soft_hpr_dense_max=2048, hpr_cap=64)

    def jloss(p):
        return jt.traj_forward(p, jnp.asarray(pts), jnp.asarray(INTR.matrix_np()),
                               jnp.asarray(path), jnp.asarray(q0),
                               jt.TrajProblem(INTR.width, INTR.height, **kw),
                               valid=jnp.asarray(valid))

    (jl, ja), jg = jax.value_and_grad(jloss, has_aux=True)(jt.init_traj_params(poses, quats))
    params = {k: v.requires_grad_(True) for k, v in tt.init_traj_params(poses, quats).items()}
    tl, ta = tt.traj_forward(params, torch.as_tensor(pts), INTR.matrix(), torch.as_tensor(path),
                             torch.as_tensor(q0), tt.TrajProblem(INTR.width, INTR.height, **kw),
                             valid=torch.as_tensor(valid))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_allclose(ta["rewards"].detach().numpy(), np.asarray(ja["rewards"]),
                               rtol=1e-4, atol=5e-3)
    for k in ("poses", "quats"):
        want = np.asarray(jg[k])
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(params[k].grad.numpy(), want, rtol=2e-3,
                                   atol=2e-3 * np.abs(want).max())
