"""Parity of the port's trajectory model (models/traj.py) with the JAX twin
and with the float64 oracle of the whole criterion."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import oracles  # noqa: E402
from trajectory_optimization_tpu.models import traj as jt  # noqa: E402
from trajectory_optimization_tpu_torch.models import traj as tt  # noqa: E402
from trajectory_optimization_tpu_torch.utils.data import identity_quaternions, pad_points  # noqa: E402
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

INTR = default_intrinsics()
SCALARS = ("mean_reward", "loss_vis", "loss_l2", "loss_smooth", "loss_length")


def _moved_params(path10):
    """Off the initial path, so the anchor and length terms are non-zero."""
    rng = np.random.default_rng(0)
    poses = (path10 + rng.normal(scale=0.2, size=path10.shape)).astype(np.float32)
    quats = identity_quaternions(len(path10))
    quats[::3] = [0.9, 0.1, -0.3, 0.2]
    return poses, quats


@pytest.fixture(scope="module")
def problem_data(cloud10, path10):
    pts, valid = pad_points(cloud10[::5][:7000], target=8192)
    poses, quats = _moved_params(path10)
    return pts, valid, poses, quats, path10, identity_quaternions(len(path10))


def _jax_forward(problem_data, with_valid):
    pts, valid, poses, quats, p0, q0 = problem_data
    prob = jt.TrajProblem(INTR.width, INTR.height, wps_step=2, backend="xla")

    def f(params):
        return jt.traj_forward(params, jnp.asarray(pts), jnp.asarray(INTR.matrix_np()),
                               jnp.asarray(p0), jnp.asarray(q0), prob,
                               valid=jnp.asarray(valid) if with_valid else None)

    (loss, aux), grads = jax.value_and_grad(f, has_aux=True)(jt.init_traj_params(poses, quats))
    return float(loss), {k: np.asarray(v) for k, v in aux.items()}, {
        k: np.asarray(v) for k, v in grads.items()}


def _port_forward(problem_data, with_valid, backend):
    pts, valid, poses, quats, p0, q0 = problem_data
    prob = tt.TrajProblem(INTR.width, INTR.height, wps_step=2, backend=backend)
    params = {k: v.requires_grad_(True) for k, v in tt.init_traj_params(poses, quats).items()}
    loss, aux = tt.traj_forward(params, torch.as_tensor(pts), INTR.matrix(), torch.as_tensor(p0),
                                torch.as_tensor(q0), prob,
                                valid=torch.as_tensor(valid) if with_valid else None)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), {k: v.detach().numpy() for k, v in aux.items()}, {
        k: g.numpy() for k, g in zip(params, grads)}


@pytest.mark.parametrize("with_valid", [True, False])
@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_traj_forward_matches_jax(problem_data, backend, with_valid):
    loss_j, aux_j, grads_j = _jax_forward(problem_data, with_valid)
    loss_t, aux_t, grads_t = _port_forward(problem_data, with_valid, backend)
    # the JAX suite's backend-parity bounds (tests/test_pallas_vis.py)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    np.testing.assert_allclose(aux_t["rewards"], aux_j["rewards"], rtol=1e-5, atol=1e-4)
    for k in SCALARS:
        np.testing.assert_allclose(aux_t[k], aux_j[k], rtol=1e-5, atol=1e-7)
    for k in ("poses", "quats"):
        np.testing.assert_allclose(grads_t[k], grads_j[k], rtol=2e-3, atol=1e-4)


def test_traj_loss_matches_f64_oracle(cloud10, path10):
    pts = cloud10[::5][:8192].astype(np.float64)
    poses, quats = (a.astype(np.float64) for a in _moved_params(path10))
    prob = tt.TrajProblem(INTR.width, INTR.height, wps_step=2, backend="torch")
    params = {"poses": torch.as_tensor(poses), "quats": torch.as_tensor(quats)}
    with torch.no_grad():
        loss, aux = tt.traj_forward(params, torch.as_tensor(pts), INTR.matrix(dtype=torch.float64),
                                    torch.as_tensor(path10.astype(np.float64)),
                                    torch.as_tensor(quats), prob)
    loss_o, terms, rewards_o = oracles.traj_loss(
        pts, poses, quats, path10.astype(np.float64), INTR.matrix_np(np.float64),
        INTR.width, INTR.height, wps_step=2,
    )
    # float64 on both sides: only the clamp/z-floor (inactive here) and
    # summation order differ
    np.testing.assert_allclose(float(loss), loss_o, rtol=1e-9)
    np.testing.assert_allclose(aux["rewards"].numpy(), rewards_o, rtol=1e-9, atol=1e-12)
    for k, o in (("loss_vis", "vis"), ("loss_l2", "l2"), ("loss_smooth", "smooth"),
                 ("loss_length", "length")):
        np.testing.assert_allclose(float(aux[k]), terms[o], rtol=1e-9, atol=1e-12)


def test_observation_logodds_splits_ties_like_jax():
    """amin/amax split the min/max cotangent equally over ties, as jnp.min/max
    do (torch.min(dim) would send it all to one index)."""
    rng = np.random.default_rng(5)
    p = rng.uniform(0.1, 0.9, size=(3, 64)).astype(np.float32)
    p[:, 10:13] = 0.95  # a three-way tie at the max
    p[:, 20:24] = 0.01  # a four-way tie at the min
    valid = (np.arange(64) < 60).astype(np.float32)
    g = rng.normal(size=(3, 64)).astype(np.float32)

    pt = torch.tensor(p, requires_grad=True)
    (gt,) = torch.autograd.grad(
        (tt.observation_logodds(pt, 1e-6, torch.as_tensor(valid)) * torch.as_tensor(g)).sum(), pt)
    gj = jax.grad(lambda x: jnp.sum(jt.observation_logodds(x, 1e-6, jnp.asarray(valid)) * g))(
        jnp.asarray(p))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["path10", "single", "stationary", "dense"])
def test_waypoint_stride_matches_jax(path10, case):
    path = {
        "path10": path10,
        "single": path10[:1],
        "stationary": np.zeros((5, 3), np.float32),
        "dense": np.linspace(0, 1, 50)[:, None] * np.ones((1, 3), np.float32),
    }[case]
    assert tt.waypoint_stride(path) == jt.waypoint_stride(path)
    assert tt.waypoint_stride(path, 2.0) == jt.waypoint_stride(path, 2.0)


def test_criterion_from_mean_matches_jax(path10):
    poses, quats = _moved_params(path10)
    pj = jt.TrajProblem(INTR.width, INTR.height)
    pt = tt.TrajProblem(INTR.width, INTR.height)
    _, aux_j = jt.traj_criterion_from_mean(
        jnp.float32(0.6), jt.init_traj_params(poses, quats), jnp.asarray(path10), pj)
    _, aux_t = tt.traj_criterion_from_mean(
        torch.tensor(0.6), tt.init_traj_params(poses, quats), torch.as_tensor(path10), pt)
    for k in SCALARS:
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]), rtol=1e-6)


def test_backend_resolution(problem_data):
    pts = torch.as_tensor(problem_data[0])
    prob = tt.TrajProblem(INTR.width, INTR.height)
    assert tt._resolve_backend(prob, pts) == "torch"  # auto: plain path for CPU tensors
    assert tt._resolve_backend(dataclasses.replace(prob, backend="kernel"), pts) == "kernel"
    with pytest.raises(ValueError, match="backend"):
        tt._resolve_backend(dataclasses.replace(prob, backend="pallas"), pts)
    with pytest.raises(NotImplementedError, match="soft_hpr"):
        tt._resolve_backend(dataclasses.replace(prob, soft_hpr=True), pts)


def test_init_params_match_jax(path10):
    q = identity_quaternions(len(path10))
    pj, pt = jt.init_traj_params(path10, q), tt.init_traj_params(path10, q)
    for k in ("poses", "quats"):
        assert pt[k].dtype == torch.float32
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]))
