"""Parity of the port's trajectory evaluation (models/evaluate.py and
``TrajectoryOptimizer.evaluate``) with the JAX twin, on the CPU.

The inputs are those of tests/test_torch_traj.py: cloud 10 cut to 7,000
points padded to 8,192, path 10 moved off its initial poses by seeded
noise. The JAX side runs its XLA backend. Held: ``n_observed`` exactly,
rewards and mean reward to rtol 1e-4 / atol 2e-4 (the JAX suite's forward
bound), length and mean angle to 1e-5; with soft HPR as stated there.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from trajectory_optimization_tpu import api as japi  # noqa: E402
from trajectory_optimization_tpu.models import evaluate as jev  # noqa: E402
from trajectory_optimization_tpu.models import traj as jt  # noqa: E402
from trajectory_optimization_tpu_torch import api as tapi  # noqa: E402
from trajectory_optimization_tpu_torch.models import evaluate as tev  # noqa: E402
from trajectory_optimization_tpu_torch.models import traj as tt  # noqa: E402
from trajectory_optimization_tpu_torch.utils.data import identity_quaternions, pad_points  # noqa: E402
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

INTR = default_intrinsics()
FWD = dict(rtol=1e-4, atol=2e-4)
GEOM = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread (restored afterwards), as the other bit-comparing
    port tests run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case(cloud10, path10):
    pts = cloud10[::5][:7000]
    rng = np.random.default_rng(0)
    poses = (path10 + rng.normal(scale=0.2, size=path10.shape)).astype(np.float32)
    quats = identity_quaternions(len(path10))
    quats[::3] = [0.9, 0.1, -0.3, 0.2]
    return pts, poses, quats


def _assert_same(got, want):
    assert got.n_observed == want.n_observed
    assert got.rewards.shape == want.rewards.shape
    np.testing.assert_allclose(got.rewards, want.rewards, **FWD)
    np.testing.assert_allclose(got.mean_reward, want.mean_reward, **FWD)
    np.testing.assert_allclose(got.frac_observed, want.frac_observed, rtol=1e-6)
    np.testing.assert_allclose(got.loss_vis, want.loss_vis, **FWD)
    for k in ("length", "mean_angle", "loss_smooth"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), **GEOM)


@pytest.mark.parametrize("with_valid", [True, False])
@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_evaluate_trajectory_matches_jax(case, backend, with_valid):
    pts, poses, quats = case
    padded, valid = pad_points(pts, target=8192)
    v = valid if with_valid else None
    want = jev.evaluate_trajectory(
        padded, poses, quats, INTR.matrix_np(),
        jt.TrajProblem(INTR.width, INTR.height, wps_step=2, backend="xla"), valid=v)
    got = tev.evaluate_trajectory(
        padded, poses, quats, INTR.matrix_np(),
        tt.TrajProblem(INTR.width, INTR.height, wps_step=2, backend=backend), valid=v,
        device="cpu")
    assert isinstance(got.n_observed, int) and 0 < got.n_observed < len(padded)
    _assert_same(got, want)


@pytest.mark.parametrize("wps_step", [None, 1, 3])
def test_facade_evaluate_matches_jax(case, wps_step):
    pts, poses, quats = case
    kw = dict(min_dist=1.0, max_dist=5.0, backend="xla")
    want = japi.TrajectoryOptimizer(**kw).evaluate(pts, poses, quats, wps_step=wps_step)
    got = tapi.TrajectoryOptimizer(**kw, device="cpu").evaluate(pts, poses, quats,
                                                                wps_step=wps_step)
    assert got.rewards.shape == (len(pts),)
    _assert_same(got, want)


def test_wps_step_reaches_the_problem(case, monkeypatch):
    pts, poses, quats = case
    opt = tapi.TrajectoryOptimizer(device="cpu")
    default = tt.waypoint_stride(poses, opt.vis_wps_dist)
    assert opt._traj_problem(poses).wps_step == default
    assert opt._traj_problem(poses, 5).wps_step == 5
    seen = []
    real = tapi.evaluate_trajectory

    def spy(*args, **kw):
        seen.append(args[4].wps_step)
        return real(*args, **kw)

    monkeypatch.setattr(tapi, "evaluate_trajectory", spy)
    opt.evaluate(pts, poses, quats, wps_step=4)
    opt.evaluate(pts, poses, quats)
    assert seen == [4, default] and default != 4


def test_evaluate_with_soft_hpr_raises(case):
    """``evaluate`` with soft_hpr=True, once raising here, runs and matches
    the JAX facade: every third point of the case (2,334, padded to 3,072),
    every third waypoint. A reward moves with its occlusion-gated scores, so
    rewards are held to the soft mask's f32 spread (atol 5e-3,
    tests/test_torch_hpr.py) and the census to 0.5% of the points."""
    pts, poses, quats = case
    pts = pts[::3]
    kw = dict(min_dist=1.0, max_dist=5.0, soft_hpr=True)
    want = japi.TrajectoryOptimizer(**kw).evaluate(pts, poses, quats, wps_step=3)
    got = tapi.TrajectoryOptimizer(**kw, device="cpu").evaluate(pts, poses, quats, wps_step=3)
    assert got.n_observed > 0
    assert abs(got.n_observed - want.n_observed) <= 0.005 * len(pts)
    np.testing.assert_allclose(got.rewards, want.rewards, rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(got.mean_reward, want.mean_reward, **FWD)
    np.testing.assert_allclose(got.loss_vis, want.loss_vis, **FWD)
    for k in ("length", "mean_angle", "loss_smooth"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), **GEOM)


def test_evaluate_with_soft_hpr_above_the_dense_size_raises():
    """Above a lowered soft_hpr_dense_max, where this raised before the
    binned tier was ported, ``evaluate_trajectory`` runs the binned soft HPR
    and matches the JAX evaluation: the room of tests/test_torch_hpr_binned.py
    (3,681 points padded to 4,096), its path moved by seeded noise, every
    third waypoint, cap 64. Rewards to the soft mask's spread (atol 5e-3),
    the census to 0.5% of the points, as the dense case above."""
    from test_torch_hpr_binned import assert_none_isolated, room_path, room_scene

    real = room_scene()
    pts, valid = pad_points(real, 4096)
    path = room_path()
    rng = np.random.default_rng(0)
    poses = (path + rng.normal(scale=0.1, size=path.shape)).astype(np.float32)
    quats = identity_quaternions(len(path))
    quats[::3] = [0.9, 0.1, -0.3, 0.2]
    assert_none_isolated(real, poses[::3], quats[::3])
    kw = dict(wps_step=3, soft_hpr=True, soft_hpr_dense_max=2048, hpr_cap=64)
    K = INTR.matrix_np()
    want = jev.evaluate_trajectory(pts, poses, quats, K, jt.TrajProblem(INTR.width, INTR.height,
                                                                        **kw), valid=valid)
    got = tev.evaluate_trajectory(pts, poses, quats, K, tt.TrajProblem(INTR.width, INTR.height,
                                                                       **kw),
                                  valid=valid, device="cpu")
    assert got.n_observed > 0
    assert abs(got.n_observed - want.n_observed) <= 0.005 * len(real)
    np.testing.assert_allclose(got.rewards, want.rewards, rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(got.mean_reward, want.mean_reward, **FWD)
    np.testing.assert_allclose(got.loss_vis, want.loss_vis, **FWD)
    for k in ("length", "mean_angle", "loss_smooth"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), **GEOM)