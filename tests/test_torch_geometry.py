"""Parity of the port's ``ops/geometry.py`` with the JAX twin on slices of
cloud 10, seen from a ring of cameras around it. Inputs are numpy arrays
handed to both packages."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from trajectory_optimization_tpu.ops import geometry as jg  # noqa: E402
from trajectory_optimization_tpu_torch.ops import geometry as tg  # noqa: E402
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

INTR = default_intrinsics()
K = INTR.matrix_np()
SMOOTH = dict(rtol=1e-5, atol=1e-6)
# Camera-frame coordinates (metres, up to ~20) from two frameworks' f32
# matmuls: a few ulps apart.
COORDS = dict(rtol=1e-5, atol=1e-5)
# Binary masks may differ only for points within an ulp of a border, where
# the two frameworks' last bits of u/z or z fall on either side. Allowed: at
# most 2 such points per 8,000 (none were seen on these inputs).
BORDER_FLIPS = 2


def _ring(n_cams=6, tilt=False):
    """The six-camera ring of tests/test_nodes.py around cloud 10; with
    ``tilt`` the cameras also turn, so rotations are not the identity."""
    q, t = [], []
    for i in range(n_cams):
        a = 2 * np.pi * i / n_cams
        t.append([6 + 3 * np.cos(a), 2 + 3 * np.sin(a), -2.0])
        half = 0.3 * a if tilt else 0.0
        q.append([np.cos(half), 0.2 * np.sin(half), np.sin(half), 0.0])  # wxyz
    return np.asarray(q, np.float32), np.asarray(t, np.float32)


@pytest.fixture(scope="module")
def scene(cloud10):
    q, t = _ring(tilt=True)
    return cloud10[:8000], q, t


def _cam(pts, q, t):
    return (np.array(jg.to_camera_frame(jnp.asarray(pts), jnp.asarray(q), jnp.asarray(t))),
            tg.to_camera_frame(torch.as_tensor(pts), torch.as_tensor(q), torch.as_tensor(t)).numpy())


@pytest.mark.parametrize("batched", [False, True])
def test_to_camera_frame_matches_jax(scene, batched):
    pts, q, t = scene
    qq, tt = (q, t) if batched else (q[2], t[2])
    want, got = _cam(pts, qq, tt)
    assert got.shape == want.shape == ((6, 8000, 3) if batched else (8000, 3))
    np.testing.assert_allclose(got, want, **COORDS)


def test_project_matches_jax(scene):
    pts, q, t = scene
    cam, _ = _cam(pts, q, t)
    got = tg.project(torch.as_tensor(cam), torch.as_tensor(K)).numpy()
    np.testing.assert_allclose(got, np.asarray(jg.project(jnp.asarray(cam), jnp.asarray(K))),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("fn", ["dist_mask", "fov_mask"])
def test_smooth_masks_match_jax(scene, fn):
    pts, q, t = scene
    cam, _ = _cam(pts, q, t)  # the same camera-frame points on both sides
    if fn == "dist_mask":
        want = jg.dist_mask(jnp.asarray(cam), 1.0, 5.0)
        got = tg.dist_mask(torch.as_tensor(cam), 1.0, 5.0)
    else:
        want = jg.fov_mask(jnp.asarray(cam), jnp.asarray(K), INTR.width, INTR.height)
        got = tg.fov_mask(torch.as_tensor(cam), torch.as_tensor(K), INTR.width, INTR.height)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SMOOTH)


def test_smooth_masks_gradient_safe_points():
    """A point at the scalar distance centre and one on the plane z = −eps:
    values stay equal to JAX's and gradients stay finite."""
    cam = np.array([[3.0, 3.0, 3.0], [1.0, 2.0, -1e-6], [0.5, -0.2, 4.0]], np.float32)
    x = torch.as_tensor(cam).requires_grad_(True)
    v = tg.dist_mask(x, 1.0, 5.0) * tg.fov_mask(x, torch.as_tensor(K), INTR.width, INTR.height)
    want = jg.dist_mask(jnp.asarray(cam), 1.0, 5.0) * jg.fov_mask(
        jnp.asarray(cam), jnp.asarray(K), INTR.width, INTR.height)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(want), **SMOOTH)
    (g,) = torch.autograd.grad(v.sum(), x)
    assert torch.isfinite(g).all()


def test_visibility_matches_jax(scene):
    pts, q, t = scene
    got = tg.visibility(torch.as_tensor(pts), torch.as_tensor(q), torch.as_tensor(t),
                        torch.as_tensor(K), INTR.width, INTR.height)
    want = jg.visibility(jnp.asarray(pts), jnp.asarray(q), jnp.asarray(t), jnp.asarray(K),
                         INTR.width, INTR.height)
    assert got.shape == (6, 8000)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SMOOTH)


def _flips(a, b):
    return int(np.sum(np.asarray(a) != np.asarray(b)))


def test_binary_masks_and_frustum_cull_match_jax(scene):
    pts, q, t = scene
    jcam, tcam = _cam(pts, q, t)  # each package's own camera-frame points
    want = jg.frustum_cull(jnp.asarray(jcam), jnp.asarray(K), INTR.width, INTR.height,
                           min_dist=1.0, max_dist=15.0)
    got = tg.frustum_cull(torch.as_tensor(tcam), torch.as_tensor(K), INTR.width, INTR.height,
                          min_dist=1.0, max_dist=15.0)
    assert got[0].dtype == torch.bool and got[0].shape == (6, 8000)
    for w, g in zip(want, got):
        assert _flips(w, g.numpy()) <= BORDER_FLIPS
    assert 0 < int(got[0].sum()) < got[0].numel()  # the ring sees part of the cloud
    # on identical inputs the binary masks are equal
    same = tg.frustum_cull(torch.as_tensor(jcam), torch.as_tensor(K), INTR.width, INTR.height,
                           min_dist=1.0, max_dist=15.0)
    for w, g in zip(want, same):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_compact_masked_matches_jax(scene):
    pts, q, t = scene
    mask = np.asarray(jg.frustum_cull(jnp.asarray(_cam(pts, q[0], t[0])[0]), jnp.asarray(K),
                                      INTR.width, INTR.height)[0])
    want = jg.compact_masked(pts, mask)
    np.testing.assert_array_equal(tg.compact_masked(pts, mask), want)
    np.testing.assert_array_equal(
        tg.compact_masked(torch.as_tensor(pts), torch.as_tensor(mask)), want)
    assert tg.compact_masked(pts, np.zeros(len(pts), bool)).shape == (0, 3)
