"""Parity of the port's ``ops/multicam.py`` with the JAX twin on a seeded
4-camera rig over cloud 10 (the cases of tests/test_multicam.py:26-61)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from trajectory_optimization_tpu.ops import multicam as jm  # noqa: E402
from trajectory_optimization_tpu_torch.ops import multicam as tm  # noqa: E402
from trajectory_optimization_tpu_torch.ops.geometry import (  # noqa: E402
    frustum_cull,
    to_camera_frame,
)
from trajectory_optimization_tpu_torch.ops.scores import waypoint_scores  # noqa: E402
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

INTR = default_intrinsics()
K = INTR.matrix_np()


def _rig(c=4, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(c, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.uniform(0, 15, size=(c, 3)).astype(np.float32)
    return q, t


def _both(pts, q, t):
    return ((jnp.asarray(pts), jnp.asarray(q), jnp.asarray(t), jnp.asarray(K)),
            (torch.as_tensor(pts), torch.as_tensor(q), torch.as_tensor(t), torch.as_tensor(K)))


def test_multicam_scores_match_jax_and_per_camera(cloud10):
    pts = cloud10[:5000]
    q, t = _rig()
    j, tt = _both(pts, q, t)
    got = tm.multicam_scores(*tt, INTR.width, INTR.height).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.multicam_scores(*j, INTR.width, INTR.height)),
                               atol=1e-6)
    for c in range(4):
        single = waypoint_scores(tt[0], tt[1][c:c + 1], tt[2][c:c + 1], tt[3], INTR.width,
                                 INTR.height)[0]
        np.testing.assert_allclose(got[c], single.numpy(), atol=1e-6)


def test_multicam_frustum_masks_match_jax_and_per_camera(cloud10):
    pts = cloud10[:5000]
    q, t = _rig(seed=1)
    j, tt = _both(pts, q, t)
    got = tm.multicam_frustum_masks(*tt, INTR.width, INTR.height, min_dist=1.0, max_dist=15.0)
    want = jm.multicam_frustum_masks(*j, INTR.width, INTR.height, min_dist=1.0, max_dist=15.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum())
    for c in range(4):
        cam = to_camera_frame(tt[0], tt[1][c], tt[2][c])
        m, _, _ = frustum_cull(cam, tt[3], INTR.width, INTR.height, min_dist=1.0, max_dist=15.0)
        np.testing.assert_array_equal(got[c].numpy(), m.numpy())


def test_combined_coverage_matches_jax_and_is_monotone(cloud10):
    pts = cloud10[:5000]
    q, t = _rig(seed=2)
    j, tt = _both(pts, q, t)
    cov4, per_cam = tm.combined_coverage(*tt, INTR.width, INTR.height)
    jcov4, jper_cam = jm.combined_coverage(*j, INTR.width, INTR.height)
    np.testing.assert_allclose(cov4.numpy(), np.asarray(jcov4), atol=1e-6)
    np.testing.assert_allclose(per_cam.numpy(), np.asarray(jper_cam), atol=1e-6)
    cov2, _ = tm.combined_coverage(tt[0], tt[1][:2], tt[2][:2], tt[3], INTR.width, INTR.height)
    # adding cameras can only add (log-odds >= 0) evidence
    assert float(cov4.mean()) >= float(cov2.mean()) - 1e-6
    assert per_cam.shape == (4,)
    assert float(cov4.min()) >= 0.5 - 1e-6  # clip floor ⇒ coverage >= 0.5
