"""The splat kernels' cull drops nothing that counts.

K6 and K7 (csrc/splat_render.cu) give each warp a band of
``tile_render.BAND_W`` columns of the tile; a warp blends only the entries
whose footprint reaches its band, and for each only the box (u, v) ±
floor(sqrt(r²)) clipped to the band. ``tile_render.band_cull`` is that cull,
plain. Here, on seeded clouds through the prologue of both paths, every
covered (entry, pixel) pair of every tile lies in a kept entry's box (and a
kept entry covers a pixel of its band: the cull is exact), and blending
each band with only its kept entries gives images ``torch.equal`` to
``splat_runs_ref``/``splat_dense_ref``. Cases: uniform clouds on one and on
several tiles, and ``utils.data.splat_cases``: equal-depth stacks across
tile, band and bin borders, footprints of r = 0.5 and r = 4 on the image's
edges, and a cloud whose every tile exceeds the dense path's cap. The kernels themselves run on the card only
(tests/test_torch_kernels_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from trajectory_optimization_tpu_torch.ops import tile_render as tr  # noqa: E402
from trajectory_optimization_tpu_torch.utils.data import splat_cases  # noqa: E402

K = np.array([[100.0, 0.0, 64.0], [0.0, 100.0, 48.0], [0.0, 0.0, 1.0]], np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread (restored afterwards): the images are compared bit
    for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _uniform(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(1.5, 9, n)],
                    axis=1).astype(np.float32)


# name: (points, H, W, renderer keywords); the edge cases are those that
# chip_smoke.py and tests/test_torch_kernels_cuda.py give the kernels, at a
# small image and a per-tile cap of 64 (splat_cases' "over_cap": every tile
# of the dense path over its cap)
CASES = {
    "uniform_one_tile": (_uniform(400, 0), 32, 128, {}),
    "uniform": (_uniform(600, 1), 100, 130, {}),
    **{name: (pts, 100, 130, kw) for name, (pts, kw) in splat_cases(K, 100, 130, cap=64).items()},
}


def _prologue(name, backend):
    pts, H, W, kw = CASES[name]
    use_runs, offsets, entries, dropped = tr.splat_prologue(
        torch.as_tensor(pts), torch.as_tensor(K), H, W, znear=1.0, zfar=15.0, backend=backend,
        **kw)
    assert use_runs == (backend == "runs")
    ty, tx = tr.tile_grid(H, W)
    max_e = None if use_runs else kw.get("max_entries_per_tile", 2048)
    return offsets, entries, ty, tx, max_e, dropped


def _covered(cand, ty, tx):
    """(n, TILE_H, TILE_W) bool: which pixels of tile (ty, tx) each entry
    covers, by the blend rule's test."""
    rows = (ty * tr.TILE_H + torch.arange(tr.TILE_H)).to(torch.float32)
    cols = (tx * tr.TILE_W + torch.arange(tr.TILE_W)).to(torch.float32)
    dr = rows[None, :, None] - cand[:, 1, None, None]
    dc = cols[None, None, :] - cand[:, 0, None, None]
    return dr * dr + dc * dc <= cand[:, 3, None, None]


def _tiles(name, backend):
    offsets, entries, tiles_y, tiles_x, max_e, _ = _prologue(name, backend)
    runs = tr.tile_runs(offsets, tiles_y, tiles_x, max_e)
    for t in range(tiles_y * tiles_x):
        ty, tx = divmod(t, tiles_x)
        yield ty, tx, tr.tile_candidates(entries, runs, t)


def _check_cull(cand, ty, tx, keep, box):
    """Every covered pixel of a band lies in a kept entry's box, and a kept
    entry covers a pixel of its band. Returns the count of covered pairs."""
    cov = _covered(cand, ty, tx)
    rows = ty * tr.TILE_H + torch.arange(tr.TILE_H)
    n_pairs = 0
    for b in range(tr.N_BANDS):
        band = cov[:, :, b * tr.BAND_W:(b + 1) * tr.BAND_W]
        cols = tx * tr.TILE_W + b * tr.BAND_W + torch.arange(tr.BAND_W)
        reaches = band.flatten(1).any(dim=1)
        assert torch.equal(keep[b], reaches), f"band {b}: the cull is not exact"
        c_lo, c_hi, r_lo, r_hi = (box[b, :, i, None, None] for i in range(4))
        inside = ((cols[None, None, :] >= c_lo) & (cols[None, None, :] <= c_hi)
                  & (rows[None, :, None] >= r_lo) & (rows[None, :, None] <= r_hi))
        assert not bool((band & ~inside).any()), f"band {b}: a covered pixel is outside its box"
        n_pairs += int(band.sum())
    return n_pairs


@pytest.mark.parametrize("backend", ["runs", "dense"])
@pytest.mark.parametrize("name", list(CASES))
def test_cull_keeps_every_covered_pair(name, backend):
    n_pairs = n_kept = n_cand = 0
    for ty, tx, cand in _tiles(name, backend):
        keep, box = tr.band_cull(cand, ty, tx)
        assert keep.shape == (tr.N_BANDS, len(cand)) and box.shape == (tr.N_BANDS, len(cand), 4)
        n_pairs += _check_cull(cand, ty, tx, keep, box)
        n_kept += int(keep.sum())
        n_cand += len(cand)
    assert n_pairs > 0
    if name == "uniform" and backend == "runs":
        # K6's 2x2 bin neighbourhood: most candidates miss a given band
        assert n_kept < 0.5 * tr.N_BANDS * n_cand


@pytest.mark.parametrize("backend", ["runs", "dense"])
@pytest.mark.parametrize("name", list(CASES))
def test_blending_kept_entries_per_band_equals_the_plain_blend(name, backend):
    offsets, entries, tiles_y, tiles_x, max_e, dropped = _prologue(name, backend)
    if backend == "runs":
        want = tr.splat_runs_ref(offsets, entries, tiles_y, tiles_x, 1.0)
    else:
        want = tr.splat_dense_ref(offsets, entries, max_e, tiles_y, tiles_x, 1.0)
    if name == "over_cap":
        assert (int(dropped) > 0) == (backend == "dense")
        counts = (offsets[1:] - offsets[:-1])[: tiles_y * tiles_x]
        assert backend == "runs" or bool((counts > max_e).all())
    got = torch.empty_like(want)
    for ty, tx, cand in _tiles(name, backend):
        keep, _ = tr.band_cull(cand, ty, tx)
        for b in range(tr.N_BANDS):
            c0 = tx * tr.TILE_W + b * tr.BAND_W
            tile = tr._blend_tile_ref(cand[keep[b]], ty, tx, 1.0)
            got[:, ty * tr.TILE_H:(ty + 1) * tr.TILE_H, c0:c0 + tr.BAND_W] = (
                tile[:, :, b * tr.BAND_W:(b + 1) * tr.BAND_W])
    assert torch.equal(got, want)
    assert bool((want < 1.0).any())


def test_ties_cross_bands_and_runs():
    """The tie case puts equal depths on one pixel from entries of both of
    K6's runs and in more than one band of a tile."""
    offsets, entries, tiles_y, tiles_x, _, _ = _prologue("ties", "runs")
    runs = tr.tile_runs(offsets, tiles_y, tiles_x)
    crossing = multi_band = 0
    for t in range(tiles_y * tiles_x):
        ty, tx = divmod(t, tiles_x)
        if len(runs[t]) < 2:
            continue
        (a_lo, a_hi), (b_lo, b_hi) = runs[t]
        cov = _covered(entries[a_lo:b_hi], ty, tx)
        n_a = a_hi - a_lo
        crossing += int((cov[:n_a].any(0) & cov[n_a:].any(0)).sum())
        keep, _ = tr.band_cull(entries[a_lo:b_hi], ty, tx)
        multi_band += int((keep.sum(0) > 1).sum())
    assert crossing > 0 and multi_band > 0
    assert float(entries[:, 2].min()) == float(entries[:, 2].max()) == 3.0
    assert len(entries) > len(torch.unique(entries[:, :2], dim=0))


def test_mutated_cull_fails():
    """The checks bite: a cull that tests r² one ulp short, or a box one
    column short on each side, fails them on the r = 4 edge case."""
    failed = {"r2_short": 0, "box_short": 0}
    for ty, tx, cand in _tiles("edges_r4", "dense"):
        keep, box = tr.band_cull(cand, ty, tx)
        if not bool(keep.any()):
            continue
        shrunk = cand.clone()
        shrunk[:, 3] = torch.nextafter(cand[:, 3], torch.zeros_like(cand[:, 3]))
        mutants = {"r2_short": (tr.band_cull(shrunk, ty, tx)[0], box),
                   "box_short": (keep, box + torch.tensor([1, -1, 0, 0]))}
        for what, (k, bx) in mutants.items():
            try:
                _check_cull(cand, ty, tx, k, bx)
            except AssertionError:
                failed[what] += 1
    assert all(failed.values()), failed
