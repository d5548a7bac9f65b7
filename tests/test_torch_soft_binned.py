"""The binned soft-HPR gate's tile reduction (``ops/hpr.py``: ``_BinnedLSE``)
on the CPU, with one torch thread.

``_BinnedLSE`` launches ``soft_binned_fwd`` and ``soft_binned_bwd``
(``csrc/soft_binned.cu``) on CUDA tensors and runs its plain version,
``binned_lse_ref`` and ``binned_lse_bwd_ref``, on CPU tensors. Held here:

* CPU tensors take the plain version, forward and backward, and launch
  nothing: ``LAUNCHES`` stays as it was and the kernels' wrappers are never
  called;
* the plain forward and backward against autograd through the unfused tile
  expression (cos, max(cos, 0)·ρ, the mask, β, the row's max and log-sum-exp)
  on the tiles of seeded clouds, ``torch.equal``: the same operations on
  the CPU. Two arrangements make autograd's operations those of the plain
  backward: β = 1 (autograd multiplies the softmax weight by β last, the
  plain backward by β·g/total, so any other β differs in the last bit), and
  cos taken twice, once per operand, so that each operand's gradient is the
  product the plain backward forms (``a @ cu`` and ``aᵀ @ qu``); the tile
  gradients are added into the tables by ``add_rows`` in the plain order;
* the rows that ``binned_rows`` (``csrc/binned_layout.cu``) adds
  ``soft_binned_bwd``'s partial sums into, by its walk of each row's tiles,
  are the rows the plain backward adds them into (``add_rows``);
* CPU tensors reach none of the gate's layout kernels (``binned_keys`` and
  the rest of ``csrc/binned_layout.cu``), forward or backward, on a padded
  cloud: the plain per-grid chain runs;
* the layout plan those kernels take (``_layout_plan``) gives each grid the
  plain chain's slot count and stratified layout, in slots laid end to end;
* the kernels' wrappers refuse CPU tensors and inputs of the wrong dtype or
  shape before they build or launch anything.

The cases: a stratified and an unstratified layout, a ragged ``cap = n``,
and bins so fine that some hold one point (rows with no pair).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from trajectory_optimization_tpu_torch.ops import _kernels  # noqa: E402
from trajectory_optimization_tpu_torch.ops import hpr as thpr  # noqa: E402

CASES = {
    "stratified": (4096, dict(cap=128)),
    "unstratified": (4096, dict(cap=128, stratified_coverers=False)),
    "ragged": (300, dict(cap=1024)),
    "one_member_bins": (1024, dict(cap=64, safety=0.1)),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)) * [6, 6, 2] + [5, 0, 1]).astype(np.float32)


def _grid_calls(name, monkeypatch):
    """The arguments of every ``_BinnedLSE.apply`` of one gate call on the
    case's cloud, one per grid."""
    n, kw = CASES[name]
    calls = []
    real = thpr._BinnedLSE

    def apply(*args):
        calls.append(args)
        return real.apply(*args)

    monkeypatch.setattr(thpr, "_BinnedLSE", types.SimpleNamespace(apply=apply))
    thpr.hpr_mask_soft_binned(torch.as_tensor(_cloud(n)), **kw)
    monkeypatch.setattr(thpr, "_BinnedLSE", real)
    return calls


def _tile_indices(bin_s, cov_pos, tiles, n, cap):
    b, qoff, coff, deep = tiles.unbind(1)
    ar = torch.arange(cap)
    q = qoff[:, None] + ar
    c = coff[:, None] + ar
    if cov_pos is None:
        crow, cself = c, c
    else:
        crow = c + deep[:, None] * n
        cself = torch.where(deep[:, None] > 0, cov_pos[c], c)
    ok = (bin_s[c] == b[:, None])[:, None, :] & (q[:, :, None] != cself[:, None, :])
    return q, crow, ok


def _autograd_lse(U, R, beta, bin_s, cov_pos, tiles, cap, chunk, g):
    """(top, total, dU, dR) by autograd through the unfused tile expression,
    chunk by chunk, each chunk's tile gradients added by ``add_rows`` as
    the plain backward adds its own."""
    n = bin_s.shape[0]
    top = U.new_empty((tiles.shape[0], cap))
    total = U.new_empty((tiles.shape[0], cap))
    dU, dR = torch.zeros_like(U), torch.zeros_like(R)
    zero = torch.zeros((), dtype=U.dtype)
    for t0 in range(0, tiles.shape[0], chunk):
        t1 = t0 + chunk
        q, crow, ok = _tile_indices(bin_s, cov_pos, tiles[t0:t1], n, cap)
        qu, cu, cr = (U[q].requires_grad_(True), U[crow].requires_grad_(True),
                      R[crow].requires_grad_(True))
        # the value of cos is the first product's; each operand's gradient
        # flows through the product laid out as the plain backward forms it
        cos_q = torch.bmm(qu, cu.detach().transpose(1, 2))
        cos_c = torch.bmm(cu, qu.detach().transpose(1, 2)).transpose(1, 2)
        cos = cos_q + (cos_c - cos_c.detach())
        x = (torch.maximum(cos, zero) * cr[:, None, :]).masked_fill(~ok, -thpr._BIG_SOFT) * beta
        m = torch.amax(x.detach(), dim=2)
        s = torch.sum(torch.exp(x - m[:, :, None]), dim=2)
        lse = m + torch.log(s)
        gq, gc, gr = torch.autograd.grad(lse, (qu, cu, cr), g[t0:t1])
        top[t0:t1], total[t0:t1] = m, s.detach()
        thpr.add_rows(dR, crow.reshape(-1), gr.reshape(-1))
        thpr.add_rows(dU, torch.cat([q.reshape(-1), crow.reshape(-1)]),
                      torch.cat([gq.reshape(-1, 3), gc.reshape(-1, 3)]))
    return top, total, dU, dR


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_tensors_take_the_plain_version(name, monkeypatch):
    """A soft gate's forward and backward on CPU tensors: the plain version
    once per grid each way, no kernel wrapper, ``LAUNCHES`` unchanged."""
    n, kw = CASES[name]
    seen = {"fwd": 0, "bwd": 0}

    def counting(key, fn):
        def run(*args):
            seen[key] += 1
            return fn(*args)
        return run

    def refused(*args):
        raise AssertionError("a CPU tensor reached a kernel wrapper")

    monkeypatch.setattr(thpr, "binned_lse_ref", counting("fwd", thpr.binned_lse_ref))
    monkeypatch.setattr(thpr, "binned_lse_bwd_ref", counting("bwd", thpr.binned_lse_bwd_ref))
    monkeypatch.setattr(_kernels, "soft_binned_fwd", refused)
    monkeypatch.setattr(_kernels, "soft_binned_bwd", refused)
    before = dict(_kernels.LAUNCHES)
    P = torch.as_tensor(_cloud(n)).requires_grad_(True)
    vis = thpr.hpr_mask_soft_binned(P, **kw)
    vis.sum().backward()
    assert seen == {"fwd": 4, "bwd": 4}
    assert _kernels.LAUNCHES == before
    assert bool(torch.isfinite(vis).all()) and bool(torch.isfinite(P.grad).all())


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_is_autograd_through_the_tiles(name, monkeypatch):
    """``binned_lse_ref`` and ``binned_lse_bwd_ref`` on every grid's tiles,
    β = 1 and a seeded cotangent on every row: top, total and the gradients
    of U and R ``torch.equal`` to autograd's (module docstring)."""
    rng = np.random.default_rng(1)
    for U, R, _, bin_s, cov_pos, tiles, cap, chunk in _grid_calls(name, monkeypatch):
        beta = torch.ones((), dtype=U.dtype)
        g = torch.as_tensor(rng.normal(size=(tiles.shape[0], cap)), dtype=U.dtype)
        top, total = thpr.binned_lse_ref(U, R, beta, bin_s, cov_pos, tiles, cap, chunk)
        dU, dR = thpr.binned_lse_bwd_ref(U, R, beta, bin_s, cov_pos, tiles, top, total, g, cap,
                                         chunk)
        want = _autograd_lse(U, R, beta, bin_s, cov_pos, tiles, cap, chunk, g)
        for got, ref in zip((top, total, dU, dR), want):
            assert torch.equal(got, ref)
        assert bool(torch.isfinite(dU).all()) and bool(torch.isfinite(dR).all())


LAYOUT_WRAPPERS = ("grid_specs", "binned_keys", "binned_layout", "binned_tables",
                   "binned_rowmax", "binned_rowmax_bwd", "binned_rows", "binned_layout_bwd")


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_tensors_launch_no_layout_kernel(name, monkeypatch):
    """A soft gate's forward and backward on a padded cloud of CPU tensors:
    no layout kernel's wrapper is called, ``LAUNCHES`` unchanged, and
    the plain per-grid layout runs once per grid."""
    n, kw = CASES[name]
    seen = []

    def refused(*args):
        raise AssertionError("a CPU tensor reached a layout kernel's wrapper")

    for fn in LAYOUT_WRAPPERS:
        monkeypatch.setattr(_kernels, fn, refused)
    real = thpr._plain_grid_layout
    monkeypatch.setattr(thpr, "_plain_grid_layout", lambda *a: seen.append(1) or real(*a))
    before = dict(_kernels.LAUNCHES)
    pts = _cloud(n)
    pts[-7:] = 1e6  # padding, as utils.data.pad_points places it
    V = torch.ones(n)
    V[-7:] = 0.0
    P = torch.as_tensor(pts).requires_grad_(True)
    vis = thpr.hpr_mask_soft_binned(P, valid=V, **kw)
    vis.sum().backward()
    assert len(seen) == 4
    assert _kernels.LAUNCHES == before
    assert bool(torch.isfinite(P.grad).all()) and bool((vis[-7:] == 0).all())


def _rows_walk(bin_s, tiles, n, cap, rows):
    """``binned_rows``' walk (``rows_kernel``, csrc/binned_layout.cu), one
    row of the (rows,) table at a time: from the first tile of the row's
    bin, while the tiles are of its bin, its query partials (at t·cap + i;
    not for a stratified row, past n), then its coverer partials (at
    T·cap + t·cap + j, from the deep tiles for a stratified row, from the
    others for a row of the first layout). Returns, per partial, the row
    that takes it (−1 for none); no partial is taken twice."""
    tb, qoff, coff, deep = (tiles[:, k].tolist() for k in range(4))
    bins, T = bin_s.tolist(), tiles.shape[0]
    dest = np.full(2 * T * cap, -1, dtype=np.int64)
    for r in range(rows):
        deep_row = r >= n
        s = r - n if deep_row else r
        b = bins[s]
        t0 = int(np.searchsorted(tb, b, side="left"))
        terms = []
        for t in range(t0, T):
            if tb[t] != b:
                break
            if not deep_row and 0 <= s - qoff[t] < cap:
                terms.append(t * cap + s - qoff[t])
        for t in range(t0, T):
            if tb[t] != b:
                break
            if (deep[t] != 0) == deep_row and 0 <= s - coff[t] < cap:
                terms.append(T * cap + t * cap + s - coff[t])
        assert (dest[terms] == -1).all()
        dest[terms] = r
    return dest


@pytest.mark.parametrize("name", sorted(CASES))
def test_partial_sums_land_on_the_plain_rows(name, monkeypatch):
    """Per grid of a gate call: each partial sum of ``soft_binned_bwd``'s
    (every tile's query rows, then every tile's coverer rows) goes, by
    ``binned_rows``' walk (``_rows_walk``), to the row that
    ``binned_lse_bwd_ref`` adds it into by ``add_rows``. Every partial
    that can be non-zero in the gate is taken: a query row that the row
    maxima read (a real tile's, of its bin) and a coverer of a real tile's
    bin."""
    n, kw = CASES[name]
    layouts, added = [], []
    real_layout, real_add = thpr._plain_grid_layout, thpr.add_rows
    monkeypatch.setattr(thpr, "_plain_grid_layout",
                        lambda *a: layouts.append(real_layout(*a)) or layouts[-1])
    with torch.no_grad():
        thpr.hpr_mask_soft_binned(torch.as_tensor(_cloud(n)), **kw)
    monkeypatch.setattr(thpr, "add_rows", lambda dst, rows, src: added.append(
        (dst.dim(), rows)) or real_add(dst, rows, src))
    assert len(layouts) == 4
    for U, R, bin_s, cov_pos, tiles, tile_ok, _ in layouts:
        cap = min(kw["cap"], n)
        chunk = max(1, thpr.TILE_BUDGET["cpu"] // (cap * cap))
        beta = torch.ones((), dtype=U.dtype)
        g = torch.ones((tiles.shape[0], cap), dtype=U.dtype)
        top, total = thpr.binned_lse_ref(U, R, beta, bin_s, cov_pos, tiles, cap, chunk)
        added.clear()
        thpr.binned_lse_bwd_ref(U, R, beta, bin_s, cov_pos, tiles, top, total, g, cap, chunk)
        u_rows = [rows for dim, rows in added if dim == 2]
        r_rows = [rows for dim, rows in added if dim == 1]
        halves = [rows.view(2, -1) for rows in u_rows]
        q_rows = torch.cat([h[0] for h in halves])
        c_rows = torch.cat([h[1] for h in halves])
        assert torch.equal(torch.cat(r_rows), c_rows)
        want = torch.cat([q_rows, c_rows]).numpy()
        got = _rows_walk(bin_s, tiles, n, cap, U.shape[0])
        taken = got >= 0
        assert (got[taken] == want[taken]).all()
        ar = torch.arange(cap)
        q = tiles[:, 1:2] + ar
        c = tiles[:, 2:3] + ar
        live_q = (bin_s[q] == tiles[:, :1]) & tile_ok[:, None]
        live_c = (bin_s[c] == tiles[:, :1]) & tile_ok[:, None]
        live = torch.cat([live_q.reshape(-1), live_c.reshape(-1)]).numpy()
        assert taken[live].all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_layout_plan_matches_the_plain_tables(name, monkeypatch):
    """``_layout_plan``'s grids (the kernels' layout): each grid's slot
    count and stratified flag those of the plain chain's table, the slots
    laid end to end, and its ring tables the grid's n_az and offsets."""
    n, kw = CASES[name]
    cap = min(kw["cap"], n)
    monkeypatch.setattr(_kernels, "grid_specs", lambda grids: tuple(grids))
    thpr._layout_plan.cache_clear()
    specs, table = thpr._layout_plan(2.0, 0.02, kw.get("safety", 3.0), n, cap,
                                     kw.get("stratified_coverers", True))
    thpr._layout_plan.cache_clear()
    calls = _grid_calls(name, monkeypatch)
    grids = thpr._binned_grids(2.0, 0.02, kw.get("safety", 3.0))[1]
    first = 0
    for (_, _, _, bin_s, cov_pos, tiles, c, _), spec, grid in zip(calls, specs, grids):
        n_rings, n_bins, frac_bits, strat, at, slot0, n_tiles = spec[:7]
        assert c == cap and (n_rings, n_bins) == (grid[0], grid[-1])
        assert (n_tiles, bool(strat)) == (tiles.shape[0], cov_pos is not None)
        assert slot0 == first and frac_bits == thpr._frac_bits(n_bins)
        assert list(table[at:at + 2 * n_rings]) == list(grid[4]) + list(grid[5])
        assert tuple(spec[7:]) == (grid[1], grid[2], grid[3])
        first += n_tiles


def test_layout_wrappers_refuse_cpu_tensors(monkeypatch):
    """The layout kernels' wrappers check before they build or launch: CPU
    tensors are refused, and a plan of other than four grids."""
    def loaded():
        raise AssertionError("the wrapper reached the library")

    monkeypatch.setattr(_kernels, "_load", loaded)
    specs = thpr._layout_plan(2.0, 0.02, 3.0, 512, 128, True)[0]
    x = torch.zeros(512)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        _kernels.binned_keys(torch.zeros(512, 3), x, torch.ones(()), None,
                             torch.zeros(8, dtype=torch.int32), specs)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        _kernels.binned_tables(torch.zeros((4, 200), dtype=torch.int32), specs, 512, 128)
    with pytest.raises(ValueError, match="float32 or float64"):
        _kernels.binned_rows(x.half(), x, x.int(), torch.zeros((1, 4), dtype=torch.long), 128,
                             512)
    with pytest.raises(ValueError, match="takes 4 grids"):
        _kernels.grid_specs(specs[:3])


def test_kernel_wrappers_refuse_bad_inputs(monkeypatch):
    """The wrappers check before they build or launch: CPU tensors, a cap
    over n, a half-precision table."""
    U, R, beta, bin_s, cov_pos, tiles, cap, _ = _grid_calls("stratified", monkeypatch)[0]

    def loaded():
        raise AssertionError("the wrapper reached the library")

    monkeypatch.setattr(_kernels, "_load", loaded)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        _kernels.soft_binned_fwd(U, R, beta, bin_s, cov_pos, tiles, cap)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        g = torch.zeros((tiles.shape[0], cap))
        _kernels.soft_binned_bwd(U, R, beta, bin_s, cov_pos, tiles, g, g, g, cap)
    with pytest.raises(ValueError, match="bad cap"):
        _kernels.soft_binned_fwd(U, R, beta, bin_s, cov_pos, tiles, bin_s.shape[0] + 1)
    with pytest.raises(ValueError, match="float32 or float64"):
        _kernels.soft_binned_fwd(U.half(), R, beta, bin_s, cov_pos, tiles, cap)
