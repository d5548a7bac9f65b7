"""Parity of the port's renderers with the JAX twins.

* ``ops/render.py`` (the plain scatter renderer) against JAX's XLA renderer.
* ``ops/tile_render.py`` on CPU tensors (the plain K6/K7 blends) against JAX
  ``render_point_cloud_pallas`` run in interpret mode, as
  tests/test_pallas_render.py runs it, on both backends.

Images are held to the JAX suite's pin, under 0.1% of pixels differing by
more than 1e-3 (tests/test_pallas_render.py:30-31): equal depths may pick
different winners. The tile renderer and the Pallas twin sort and scan
identically, so they are expected to agree bit for bit; each test records
the count of differing pixels in its report's user properties
(``differing_pixels[...]``; 0 on these inputs).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from trajectory_optimization_tpu.ops import render as jr  # noqa: E402
from trajectory_optimization_tpu.ops.pallas_render import render_point_cloud_pallas  # noqa: E402
from trajectory_optimization_tpu_torch.ops import render as tr  # noqa: E402
from trajectory_optimization_tpu_torch.ops import tile_render as tt  # noqa: E402

K = np.array([[100.0, 0.0, 64.0], [0.0, 100.0, 48.0], [0.0, 0.0, 1.0]], np.float32)
PIN = 1e-3  # share of pixels that may differ by more than 1e-3


def _cloud(n=400, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack(
        [rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(1.5, 9, n)], axis=1
    ).astype(np.float32)


def _differing(a, b):
    return int((np.abs(np.asarray(a) - np.asarray(b)).max(axis=2) > 1e-3).sum())


def _assert_pin(a, b, what, request=None):
    n = _differing(a, b)
    if request is not None:
        request.node.user_properties.append((f"differing_pixels[{what}]", n))
    assert n < PIN * a.shape[0] * a.shape[1], f"{what}: {n} pixels differ"


def _jax(pts, H, W, **kw):
    kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    return render_point_cloud_pallas(jnp.asarray(pts), jnp.asarray(K), H, W, znear=1.0,
                                     zfar=10.0, **kw)


def _tiles(pts, H, W, **kw):
    kw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    return tt.render_point_cloud_tiles(torch.as_tensor(pts), torch.as_tensor(K), H, W,
                                       znear=1.0, zfar=10.0, **kw)


@pytest.mark.parametrize("with_valid", [False, True])
def test_scatter_renderer_matches_jax(with_valid, request):
    pts = _cloud()
    kw = {}
    if with_valid:  # padding rows must not move the colour normalization
        pts = np.concatenate([pts, np.full((40, 3), 1e6, np.float32)])
        kw["valid"] = np.r_[np.ones(400), np.zeros(40)].astype(np.float32)
    want = np.asarray(jr.render_point_cloud(jnp.asarray(pts), jnp.asarray(K), 96, 128, znear=1.0,
                                            zfar=10.0, **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = tr.render_point_cloud(torch.as_tensor(pts), torch.as_tensor(K), 96, 128, znear=1.0,
                                zfar=10.0, **{k: torch.as_tensor(v) for k, v in kw.items()})
    assert got.shape == (96, 128, 3)
    _assert_pin(got.numpy(), want, "scatter vs XLA", request)
    assert (got.numpy() < 1).any()


def test_scatter_renderer_breaks_ties_toward_lowest_index():
    pts = np.array([[0.0, 0.0, 2.0], [0.0, 0.0, 2.0], [0.0, 0.0, 3.0]], np.float32)
    colors = np.eye(3, dtype=np.float32)
    img = tr.render_point_cloud(torch.as_tensor(pts), torch.as_tensor(K), 96, 128,
                                colors=torch.as_tensor(colors)).numpy()
    np.testing.assert_array_equal(img[48, 64], [1.0, 0.0, 0.0])


@pytest.mark.parametrize("backend", ["runs", "dense"])
@pytest.mark.parametrize("size", [(96, 128), (100, 130)])
def test_tiles_match_pallas_twin(backend, size, request):
    pts = _cloud(seed=size[0])
    H, W = size
    want = np.asarray(_jax(pts, H, W, backend=backend))
    got = _tiles(pts, H, W, backend=backend).numpy()
    assert got.shape == (H, W, 3) and (got < 1).any()
    _assert_pin(got, want, f"tiles {backend} vs Pallas", request)
    # and against the independent scatter renderer
    plain = tr.render_point_cloud(torch.as_tensor(pts), torch.as_tensor(K), H, W, znear=1.0,
                                  zfar=10.0).numpy()
    _assert_pin(got, plain, f"tiles {backend} vs scatter", request)


@pytest.mark.parametrize("backend", ["runs", "dense"])
def test_tiles_equal_depths_follow_the_stable_sort(backend):
    """Duplicated points (equal depths everywhere): the winner is the first
    in scan order on both sides, so the images are identical."""
    base = _cloud(60, seed=3)
    pts = np.concatenate([base, base[::-1], base])
    colors = np.random.default_rng(4).uniform(size=(len(pts), 3)).astype(np.float32)
    want = np.asarray(_jax(pts, 96, 128, colors=colors, backend=backend))
    got = _tiles(pts, 96, 128, colors=colors, backend=backend).numpy()
    _assert_pin(got, want, f"ties {backend}")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["runs", "dense"])
def test_tiles_empty_and_clipped(backend):
    clipped = np.array([[0.0, 0.0, 0.2], [0.0, 0.0, 50.0]], np.float32)  # outside [znear, zfar]
    for pts in (clipped, np.zeros((0, 3), np.float32)):
        img, dropped = _tiles(pts, 64, 128, backend=backend, return_overflow=True)
        np.testing.assert_array_equal(img.numpy(), 1.0)
        assert int(dropped) == 0
    np.testing.assert_array_equal(_tiles(clipped, 64, 128, backend=backend).numpy(),
                                  np.asarray(_jax(clipped, 64, 128, backend=backend)))


@pytest.mark.parametrize("backend", ["runs", "dense"])
def test_tiles_custom_colors_and_valid_mask(backend):
    pts = np.array([[0.0, 0.0, 2.0], [0.5, 0.0, 2.0]], np.float32)
    colors = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    valid = np.array([1.0, 0.0], np.float32)  # second point masked out
    img = _tiles(pts, 96, 128, colors=colors, valid=valid, backend=backend).numpy()
    np.testing.assert_array_equal(img[48, 64], [1.0, 0.0, 0.0])  # drawn in red
    np.testing.assert_array_equal(img[48, 89], [1.0, 1.0, 1.0])  # masked ⇒ bg
    np.testing.assert_array_equal(
        img, np.asarray(_jax(pts, 96, 128, colors=colors, valid=valid, backend=backend)))


def test_tiles_overflow_counter_matches_jax():
    rng = np.random.default_rng(0)
    n = 64
    pts = np.stack(
        [rng.uniform(-0.02, 0.02, n), rng.uniform(-0.02, 0.02, n), np.full(n, 2.0)], axis=1
    ).astype(np.float32)  # all project into one tile
    for cap in (8, 512):
        img, dropped = _tiles(pts, 64, 128, max_entries_per_tile=cap, return_overflow=True,
                              backend="dense")
        jimg, jdropped = _jax(pts, 64, 128, max_entries_per_tile=cap, return_overflow=True,
                              backend="dense")
        assert int(dropped) == int(jdropped)
        np.testing.assert_array_equal(img.numpy(), np.asarray(jimg))
        assert (int(dropped) > 0) == (cap == 8)
    img3, dropped3 = _tiles(pts, 64, 128, max_entries_per_tile=8, return_overflow=True,
                            backend="runs")
    assert int(dropped3) == 0  # the run path has no per-tile cap
    np.testing.assert_array_equal(
        img3.numpy(), _tiles(pts, 64, 128, max_entries_per_tile=512, backend="dense").numpy())


def test_auto_backend_switches_at_the_run_path_limit():
    """'auto' takes the run path up to 65,536 points (the JAX twin's rule)."""
    far = np.full((tt.RUN_PATH_MAX_ENTRIES + 1, 3), 50.0, np.float32)  # all clipped
    for n, runs in ((tt.RUN_PATH_MAX_ENTRIES, True), (tt.RUN_PATH_MAX_ENTRIES + 1, False)):
        use_runs, offsets, entries, dropped = tt.splat_prologue(
            torch.as_tensor(far[:n]), torch.as_tensor(K), 64, 128)
        assert use_runs is runs
        assert offsets.dtype == torch.int32 and offsets.shape == (3,)
        assert int(offsets[-1]) == 0 and int(dropped) == 0
        assert entries.shape == (n if runs else 4 * n, 8)


def test_plain_blends_reject_unknown_backend_and_size():
    pts = _cloud(10)
    with pytest.raises(ValueError, match="backend"):
        _tiles(pts, 64, 128, backend="scatter")
    with pytest.raises(ValueError, match="positive"):
        _tiles(pts, 0, 128)


def test_normalized_colors_and_denormalize_match_jax():
    pts = _cloud(50, seed=5)
    np.testing.assert_allclose(tr.normalized_xyz_colors(torch.as_tensor(pts)).numpy(),
                               np.asarray(jr.normalized_xyz_colors(jnp.asarray(pts))),
                               rtol=1e-6, atol=1e-7)
    img = np.random.default_rng(6).uniform(size=(8, 9, 3)).astype(np.float32)
    np.testing.assert_allclose(tr.denormalize_image(torch.as_tensor(img)),
                               jr.denormalize_image(img), rtol=1e-6)
