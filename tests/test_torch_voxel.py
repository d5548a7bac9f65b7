"""Parity of the port's voxel operations (``ops/voxel.py``) and native host
library (``native/``) with the JAX twins, on the CPU.

The numpy functions are copies: ``assert_array_equal``. The device-tensor
functions hash and quantize with integer arithmetic on the same f32 inputs:
their occupied masks and grids equal JAX's exactly; centroids are sums in
another order, held to atol 1e-5. The native library is built from the
port's copy of the C++ source into ``build/torch_native/`` and held against
numpy as the JAX suite holds its own (tests/test_render_voxel.py:131-140).
"""
import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from trajectory_optimization_tpu.ops import voxel as jvoxel  # noqa: E402
from trajectory_optimization_tpu_torch import native  # noqa: E402
from trajectory_optimization_tpu_torch.ops import voxel as tvoxel  # noqa: E402
from trajectory_optimization_tpu_torch.ops.geometry import frustum_cull  # noqa: E402
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "trajectory_optimization_tpu_torch"


def _lexsorted(x):
    return x[np.lexsort((x[:, 2].round(4), x[:, 1].round(4), x[:, 0].round(4)))]


def _grid_cloud():
    """tests/test_render_voxel.py:103's cloud across the default bounds."""
    rng = np.random.default_rng(1)
    return rng.uniform(0, 20, size=(2000, 3)).astype(np.float64) * [4, 1, 0.4] + [0, -10, -4]


EDGE = np.array([[0.0, 49.95, 0.0], [10.01, 0.04, 0.07]])  # test_render_voxel.py:115


@pytest.mark.parametrize("z_limits", [None, (-1.0, 2.5)])
def test_numpy_voxel_downsample_is_the_jax_copy(z_limits):
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-5, 5, size=(3000, 3)), rng.random((3000, 1))], axis=1)
    got = tvoxel.voxel_downsample(pts.astype(np.float32), 0.5, z_limits=z_limits)
    np.testing.assert_array_equal(got, jvoxel.voxel_downsample(pts.astype(np.float32), 0.5,
                                                               z_limits=z_limits))
    assert got.shape[1] == 4 and 100 < len(got) < 3000


@pytest.mark.parametrize("pts", [_grid_cloud(), EDGE], ids=["cloud", "upper_edge"])
def test_numpy_occupancy_grid_is_the_jax_copy(pts):
    got = tvoxel.occupancy_grid(pts)
    np.testing.assert_array_equal(got, jvoxel.occupancy_grid(pts))
    assert got.shape == (600, 666, 67)


def _clouds():
    rng = np.random.default_rng(3)
    neg = rng.uniform(-6, 4, size=(6000, 3)).astype(np.float32)  # negative voxel indices wrap
    return {"negative": (neg, None),
            "valid": (neg, (rng.random(6000) > 0.25).astype(np.float32))}


@pytest.mark.parametrize("name", ["negative", "valid"])
@pytest.mark.parametrize("table_size", [4096, 1 << 16])
def test_voxel_downsample_jit_matches_jax(name, table_size):
    pts, valid = _clouds()[name]
    jc, jo = jvoxel.voxel_downsample_jit(jnp.asarray(pts), 0.5, table_size=table_size,
                                         valid=None if valid is None else jnp.asarray(valid))
    tc, to = tvoxel.voxel_downsample_jit(torch.as_tensor(pts), 0.5, table_size=table_size,
                                         valid=None if valid is None else torch.as_tensor(valid))
    assert tc.shape == (table_size, 3) and to.shape == (table_size,) and to.dtype == torch.float32
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))  # the same hash, bit for bit
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    assert 500 < int(to.sum()) <= table_size


def test_voxel_downsample_jit_hash_wraps_like_uint32():
    """A negative voxel index is the JAX twin's int32 → uint32 wrap: the same
    slot as JAX for indices near ±2³¹ and for every small negative one."""
    pts = np.array([[-0.1, -0.1, -0.1], [-1e6, 3.0, -2e6], [2.1e8, -2.1e8, 0.0],
                    [-2.1e8, 2.1e8, -1.0]], np.float32)
    jo = np.asarray(jvoxel.voxel_downsample_jit(jnp.asarray(pts), 0.5, table_size=1 << 20)[1])
    to = tvoxel.voxel_downsample_jit(torch.as_tensor(pts), 0.5, table_size=1 << 20)[1].numpy()
    np.testing.assert_array_equal(np.flatnonzero(to), np.flatnonzero(jo))
    assert len(np.flatnonzero(to)) == 4


@pytest.mark.parametrize("pts", [_grid_cloud(), EDGE], ids=["cloud", "upper_edge"])
def test_occupancy_grid_jit_matches_jax(pts):
    jg = np.asarray(jvoxel.occupancy_grid_jit(jnp.asarray(pts, jnp.float32)))
    tg = tvoxel.occupancy_grid_jit(torch.as_tensor(pts, dtype=torch.float32))
    assert tg.shape == (600, 666, 67) and tg.dtype == torch.float32
    np.testing.assert_array_equal(np.argwhere(tg.numpy() == 1), np.argwhere(jg == 1))
    assert (tvoxel.occupancy_grid(pts) == tg.numpy()).mean() > 0.999
    if len(pts) == 2:  # the edge point is dropped, not aliased into the next row
        assert tg.sum() == 1


def test_makefile_flags_are_the_loaders():
    text = (PKG / "native" / "Makefile").read_text()
    flags = re.search(r"^CXXFLAGS \?= (.*)$", text, re.M).group(1).split()
    assert tuple(flags) == native.CXXFLAGS
    assert "-shared -fPIC" in text
    for name in ("trajopt_native.cpp", "Makefile"):  # copies of the JAX package's
        assert (PKG / "native" / name).read_bytes() == (
            ROOT / "trajectory_optimization_tpu" / "native" / name).read_bytes()


def test_native_library_builds_under_build_and_matches_numpy():
    before = sorted(p for p in PKG.rglob("*") if "__pycache__" not in p.parts)
    assert native.native_available(), "g++ could not build the native library"
    lib = native.library_path()
    assert lib.exists() and lib.parent == ROOT / "build" / "torch_native"
    rng = np.random.default_rng(2)
    pts = rng.uniform(-10, 10, size=(20000, 3)).astype(np.float32)
    a = native.voxel_downsample_native(pts, 0.5)
    b = tvoxel.voxel_downsample(pts, 0.5)
    assert a.shape == b.shape
    np.testing.assert_allclose(_lexsorted(a), _lexsorted(b), atol=1e-4)
    zl = native.voxel_downsample_native(pts, 0.5, z_limits=(-2.0, 3.0))
    np.testing.assert_allclose(_lexsorted(zl),
                               _lexsorted(tvoxel.voxel_downsample(pts, 0.5, z_limits=(-2.0, 3.0))),
                               atol=1e-4)
    grid = _grid_cloud()
    assert (native.occupancy_grid_native(grid) == tvoxel.occupancy_grid(grid)).mean() > 0.999
    K = default_intrinsics().matrix_np()
    cam = rng.uniform([-4, -4, -1], [4, 4, 12], size=(5000, 3)).astype(np.float32)
    want = frustum_cull(torch.as_tensor(cam), torch.as_tensor(K), 1232.0, 1616.0)[0].numpy()
    got = native.frustum_cull_mask_native(cam, K, 1232.0, 1616.0)
    assert got.dtype == bool and (got == want).mean() > 0.999 and got.sum() > 100
    after = sorted(p for p in PKG.rglob("*") if "__pycache__" not in p.parts)
    assert after == before  # nothing built into the package


def test_native_fallbacks_without_a_toolchain(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-3, 3, size=(2000, 3)).astype(np.float32)
    np.testing.assert_array_equal(native.voxel_downsample_native(pts, 0.5),
                                  tvoxel.voxel_downsample(pts, 0.5))
    K = default_intrinsics().matrix_np()
    cam = (pts + [0, 0, 4]).astype(np.float32)
    np.testing.assert_array_equal(
        native.frustum_cull_mask_native(cam, K, 1232.0, 1616.0),
        frustum_cull(torch.as_tensor(cam), torch.as_tensor(K), 1232.0, 1616.0)[0].numpy())
    np.testing.assert_array_equal(native.occupancy_grid_native(EDGE), tvoxel.occupancy_grid(EDGE))
    with pytest.raises(ValueError):
        native.voxel_downsample_native(pts[:, :2], 0.5)
