"""Parity of the PyTorch port's ops (quaternions, numerics, trajectory
metrics, scores, intrinsics, data utilities) with their JAX twins and with
the float64 oracles. Inputs are made with numpy from fixed seeds."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import oracles  # noqa: E402
from trajectory_optimization_tpu.ops import numerics as j_num  # noqa: E402
from trajectory_optimization_tpu.ops import quat as j_quat  # noqa: E402
from trajectory_optimization_tpu.ops import scores as j_scores  # noqa: E402
from trajectory_optimization_tpu.ops import trajectory as j_traj  # noqa: E402
from trajectory_optimization_tpu.utils import data as j_data  # noqa: E402
from trajectory_optimization_tpu.utils import intrinsics as j_intr  # noqa: E402
from trajectory_optimization_tpu_torch.ops import numerics as t_num  # noqa: E402
from trajectory_optimization_tpu_torch.ops import quat as t_quat  # noqa: E402
from trajectory_optimization_tpu_torch.ops import scores as t_scores  # noqa: E402
from trajectory_optimization_tpu_torch.ops import trajectory as t_traj  # noqa: E402
from trajectory_optimization_tpu_torch.utils import data as t_data  # noqa: E402
from trajectory_optimization_tpu_torch.utils import intrinsics as t_intr  # noqa: E402

INTR = t_intr.default_intrinsics()
# f32 elementwise math in two frameworks: a few ulps apart.
F32 = dict(rtol=2e-6, atol=1e-6)


def _rand_quats(rng, n):
    return rng.normal(size=(n, 4)).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize(
    "name", ["normalize", "conjugate", "to_matrix", "from_matrix", "wxyz_to_xyzw", "xyzw_to_wxyz"]
)
def test_quat_unary_matches_jax(name):
    q = _rand_quats(np.random.default_rng(0), 64)
    if name == "from_matrix":
        q = np.asarray(j_quat.to_matrix(j_quat.normalize(jnp.asarray(q))))
    got = getattr(t_quat, name)(_t(q)).numpy()
    want = np.asarray(getattr(j_quat, name)(jnp.asarray(q)))
    np.testing.assert_allclose(got, want, **F32)


def test_quat_binary_matches_jax():
    rng = np.random.default_rng(1)
    a, b = _rand_quats(rng, 32), _rand_quats(rng, 32)
    v = rng.normal(size=(32, 3)).astype(np.float32)
    np.testing.assert_allclose(
        t_quat.multiply(_t(a), _t(b)).numpy(), np.asarray(j_quat.multiply(a, b)), **F32
    )
    np.testing.assert_allclose(
        t_quat.apply(_t(a), _t(v)).numpy(), np.asarray(j_quat.apply(a, v)), rtol=1e-5, atol=1e-5
    )


def test_quat_from_euler_matches_jax():
    rng = np.random.default_rng(2)
    r, p, y = rng.uniform(-3, 3, size=(3, 16)).astype(np.float32)
    np.testing.assert_allclose(
        t_quat.from_euler(_t(r), _t(p), _t(y)).numpy(), np.asarray(j_quat.from_euler(r, p, y)), **F32
    )
    np.testing.assert_allclose(t_quat.from_euler_np(0.1, 0.2, 0.3), j_quat.from_euler_np(0.1, 0.2, 0.3))


def test_quat_to_matrix_matches_f64_oracle():
    q = np.random.default_rng(3).normal(size=(16, 4))
    got = t_quat.to_matrix(t_quat.normalize(torch.as_tensor(q))).numpy()
    want = np.stack([oracles.quat_rotmat(oracles.quat_normalize(x)) for x in q])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_quat_random_is_unit_with_positive_w():
    g = torch.Generator().manual_seed(0)
    q = t_quat.random(g, 1000)
    np.testing.assert_allclose(torch.linalg.norm(q, dim=-1).numpy(), 1.0, rtol=1e-6)
    assert bool((q[:, 0] >= 0).all())
    # Gaussian projection: components are symmetric about 0 (except w)
    assert abs(float(q[:, 1:].mean())) < 0.05


@pytest.mark.parametrize("x", [[0.0, 0.0, 0.0], [3.0, -4.0, 0.0], [1e-3, 2e-3, -2e-3]])
def test_safe_norm_value_and_grad_match_jax(x):
    xt = torch.tensor(x, requires_grad=True)
    v = t_num.safe_norm(xt)
    (g,) = torch.autograd.grad(v, xt)
    v = v.detach()
    jv, jg = jax.value_and_grad(j_num.safe_norm)(jnp.asarray(x, jnp.float32))
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
    assert np.all(np.isfinite(g.numpy()))  # zero subgradient at 0, no NaN


@pytest.mark.parametrize("c", [-1.0, -0.3, 0.999, 1.0, 1.0000001])
def test_acos_clipped_value_and_grad_match_jax(c):
    ct = torch.tensor(c, requires_grad=True)
    v = t_num.acos_clipped(ct)
    (g,) = torch.autograd.grad(v, ct)
    v = v.detach()
    jv, jg = jax.value_and_grad(j_num.acos_clipped)(jnp.float32(c))
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(g), float(jg), rtol=1e-5)


@pytest.mark.parametrize("W", [2, 3, 27])
def test_trajectory_metrics_match_jax(path10, W):
    traj = path10[:W] + np.random.default_rng(W).normal(scale=0.05, size=(W, 3)).astype(np.float32)
    for name in ("polyline_length", "mean_segment_angle"):
        got = getattr(t_traj, name)(_t(traj))
        want = getattr(j_traj, name)(jnp.asarray(traj))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    if W >= 3:
        np.testing.assert_allclose(
            t_traj.menger_curvature(_t(traj)).numpy(),
            np.asarray(j_traj.menger_curvature(jnp.asarray(traj))), rtol=1e-4, atol=1e-6,
        )
    else:
        assert float(t_traj.mean_segment_angle(_t(traj))) == pytest.approx(np.pi)


def test_trajectory_metrics_match_f64_oracle(path10):
    traj = path10.astype(np.float64)
    np.testing.assert_allclose(
        float(t_traj.polyline_length(torch.as_tensor(traj))), oracles.traj_length(traj), rtol=1e-12
    )
    np.testing.assert_allclose(
        float(t_traj.mean_segment_angle(torch.as_tensor(traj))), oracles.traj_mean_angle(traj),
        rtol=1e-12,
    )


@pytest.fixture(scope="module")
def score_inputs(cloud10, path10):
    pts = cloud10[::5][:8192]
    q = np.tile(np.float32([1, 0, 0, 0]), (len(path10), 1))
    q[::3] = [0.9, 0.1, -0.3, 0.2]
    return pts, q, path10


def test_waypoint_scores_match_jax(score_inputs):
    pts, q, t = score_inputs
    got = t_scores.waypoint_scores(_t(pts), _t(q), _t(t), INTR.matrix(), INTR.width, INTR.height)
    want = j_scores.waypoint_scores(
        jnp.asarray(pts), jnp.asarray(q), jnp.asarray(t), jnp.asarray(INTR.matrix_np()),
        INTR.width, INTR.height,
    )
    # f32 transcendental chains (exp, sigmoid, divide) in two frameworks
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-7)


def test_camera_planes_and_scores_match_f64_oracle(score_inputs):
    pts, q, t = (a.astype(np.float64) for a in score_inputs)
    K = INTR.matrix(dtype=torch.float64)
    cx, cy, cz = t_scores.camera_planes(torch.as_tensor(pts), torch.as_tensor(q), torch.as_tensor(t))
    s = t_scores.scores_from_planes(cx, cy, cz, K, INTR.width, INTR.height)
    for w in range(0, len(q), 5):
        cam = oracles.world_to_cam(pts, q[w], t[w])
        np.testing.assert_allclose(
            np.stack([cx[w].numpy(), cy[w].numpy(), cz[w].numpy()], 1), cam, rtol=1e-10, atol=1e-10
        )
        want = oracles.smooth_dist_mask(cam) * oracles.smooth_fov_mask(
            cam, INTR.matrix_np(np.float64), INTR.width, INTR.height
        )
        # the oracle has no ±20 clamp or z floor; both only touch scores < 1e-80
        np.testing.assert_allclose(s[w].numpy(), want, rtol=1e-9, atol=1e-80)


def test_intrinsics_match_jax():
    np.testing.assert_array_equal(
        INTR.matrix().numpy(), np.asarray(j_intr.default_intrinsics().matrix())
    )
    assert INTR.matrix(dtype=torch.float64).dtype == torch.float64


@pytest.mark.parametrize("n", [1, 1000, 1025, 40452, 1_048_576])
def test_data_bucketing_and_padding_match_jax(n):
    assert t_data.bucket_size(n) == j_data.bucket_size(n)
    pts = np.random.default_rng(n).normal(size=(min(n, 5000), 3)).astype(np.float32)
    for a, b in zip(t_data.pad_points(pts), j_data.pad_points(pts)):
        np.testing.assert_array_equal(a, b)


def test_data_loaders_match_jax():
    root = t_data.reference_data_dir()
    cloud = f"{root}/points/point_cloud_10.npz"
    path = f"{root}/paths/path_poses_10.npz"
    np.testing.assert_array_equal(t_data.load_point_cloud(cloud), j_data.load_point_cloud(cloud))
    np.testing.assert_array_equal(t_data.load_path(path), j_data.load_path(path))
    np.testing.assert_array_equal(t_data.identity_quaternions(5), j_data.identity_quaternions(5))
