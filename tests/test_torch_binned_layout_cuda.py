"""The binned soft-HPR gate's layout kernels (csrc/binned_layout.cu:
``binned_keys``, ``binned_layout``, ``binned_tables``, ``binned_rowmax``
and their backward, ``binned_rowmax_bwd``, ``binned_rows``,
``binned_layout_bwd``) on the card, against the plain per-grid chain
(ops/hpr.py ``_grid_bin_key``, ``_plain_grid_layout``, ``_plain_smax``)
run on the same CUDA tensors.

Every test here needs a CUDA card and is marked ``cuda``; without one each
skips (the kernels have no CPU mode; tests/test_torch_soft_binned.py holds
that CPU tensors never reach them). The file imports neither JAX nor the
JAX package and uses no conftest fixture:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_binned_layout_cuda.py

The cases are tests/test_torch_soft_binned_cuda.py's: cloud 10 (padded to
40,960) at cap 512, stratified and not; 262,144 points at cap 1024; a
ragged ``cap = n`` (no stratified layout); bins so fine that some hold one
point; each in float32 and float64. Held: the layout (keys, both
permutations, bins, the stratified rows, the tile table and its mask, the
U/R tables) and the gate's forward ``torch.equal`` to the plain chain's; on
a cloud built with exact ties, the plain chain's gradient; the launches of
one gate call, eager and replayed from a CUDA graph; no plain layout
operation on CUDA tensors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_soft_binned_cuda import (  # noqa: E402,F401
    LAYOUT_BACKWARD,
    LAYOUT_FORWARD,
    _case,
    _seeded,
    cloud10_cams,
    dev,
)
from trajectory_optimization_tpu_torch.ops import _kernels  # noqa: E402
from trajectory_optimization_tpu_torch.ops import hpr as thpr  # noqa: E402
from trajectory_optimization_tpu_torch.opt import graphs as tg  # noqa: E402

pytestmark = pytest.mark.cuda

CASES = ("cloud10", "cloud10_unstratified", "pose262k", "ragged", "one_member_bins")
DTYPES = (torch.float32, torch.float64)
# The tiles' kernels, launched once per grid each way (csrc/soft_binned.cu):
# not counted in a gate call's launches below
TILE_KERNELS = ("soft_binned_fwd_kernel", "soft_binned_bwd_kernel")
# Kernels of one gate call on cloud 10 at cap 512 besides the tiles', the
# plain operations around the layout (norms, ρ, u, β, the sigmoid) included:
# at most MAX_FORWARD_KERNELS forward, MAX_GATE_KERNELS forward and backward.
# On an H100 (PyTorch 2.11) the forward ran 46: the layout's four and the
# sort's seven, 35 plain; the backward 53: the layout's six, 47 plain (the
# norms' float64 round trip, the two torch.maximum floors, u's division,
# the radius's amax, the sigmoid and their accumulations)
MAX_FORWARD_KERNELS, MAX_GATE_KERNELS = 50, 100


def _calls(name, dtype, dev, cloud10_cams):
    out = []
    for points, valid, kw in _case(name, dev, cloud10_cams)[:2]:
        out.append((points.to(dtype), None if valid is None else valid.to(dtype), kw))
    return out


def _layout_of(points, valid, kw, monkeypatch):
    """The arguments and results of the one ``_layout_kernels`` call of a
    gate call."""
    seen = []
    real = thpr._layout_kernels

    def recording(*args):
        out = real(*args)
        seen.append((args, out))
        return out

    with monkeypatch.context() as m:
        m.setattr(thpr, "_layout_kernels", recording)
        with torch.no_grad():
            thpr.hpr_mask_soft_binned(points, valid=valid, **kw)
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "f64"))
@pytest.mark.parametrize("name", CASES)
def test_layout_equals_the_plain_chain(dev, cloud10_cams, name, dtype, monkeypatch):
    """Per grid: the keys ``torch.equal`` to ``_grid_bin_key``'s, and
    U, R, ``bin_s``, ``cov_pos`` (None where the plain chain builds no
    stratified layout), the tile table, its mask and the permutation to
    ``_plain_grid_layout``'s; ``pos_a`` and ``pos_b`` its inverses."""
    for points, valid, kw in _calls(name, dtype, dev, cloud10_cams):
        args, out = _layout_of(points, valid, kw, monkeypatch)
        u, rho, norms, scale, v, (specs, table), cap = args
        U, R, bin_s, cov_pos, perm, pos_a, pos_b, tiles, tile_ok = out
        keys = _kernels.binned_keys(u, norms, scale, v, thpr._device_table(table, dev), specs)
        lat, az = thpr._direction_angles(u)
        n = u.shape[0]
        grids = thpr._binned_grids(2.0, 0.02, kw.get("safety", 3.0))[1]
        for g, (grid, s) in enumerate(zip(grids, specs)):
            key, _, _ = thpr._grid_bin_key(grid, lat, az, norms, scale, v)
            assert torch.equal(keys[g * n:(g + 1) * n].long() - (g - 2) * 2**30, key.long())
            pU, pR, pb, pc, pt, pok, pp = thpr._plain_grid_layout(
                grid, u, rho, lat, az, norms, scale, v, cap, kw.get("stratified_coverers", True))
            sl = slice(s.tiles, s.tiles + s.n_tiles)
            assert torch.equal(perm[g].long(), pp), (name, g)
            assert torch.equal(bin_s[g], pb), (name, g)
            assert torch.equal(tiles[sl], pt) and torch.equal(tile_ok[sl], pok), (name, g)
            assert torch.equal(U[g], pU) and torch.equal(R[g], pR), (name, g)
            assert (pc is None) == (not s.strat), (name, g)
            ar = torch.arange(n, device=dev)
            assert torch.equal(pos_a[g].long()[pp], ar), (name, g)
            if pc is not None:
                assert torch.equal(cov_pos[g], pc), (name, g)
                assert torch.equal(pc[pos_b[g].long()], pos_a[g].long()), (name, g)
    if name in ("ragged",):
        assert not any(s.strat for s in specs)  # cap = n: no stratified layout


def _plain_layout(m):
    """Route the card's gate through the plain per-grid chain
    (``_plain_smax``), its tiles still ``soft_binned_fwd``/``_bwd``: the
    gate as it ran before the layout kernels. (``_kernels.on_cpu`` forced
    True would swap the tiles too, for their plain version, whose cuBLAS
    cos rounds otherwise than the kernel's FMAs.)"""
    def plain(u, rho, norms, scale, beta, v, r_param, tau, safety, cap, chunk, stratified):
        grids = thpr._binned_grids(r_param, tau, safety)[1]
        lat, az = thpr._direction_angles(u)
        return thpr._plain_smax(u, rho, lat, az, norms, scale, beta, v, grids, cap, chunk,
                                stratified)

    m.setattr(thpr, "_kernel_smax", plain)


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "f64"))
@pytest.mark.parametrize("name", CASES)
def test_gate_forward_equals_the_plain_chain(dev, cloud10_cams, name, dtype, monkeypatch):
    """The gate's mask by the layout kernels ``torch.equal`` to the plain
    chain's on the same CUDA tensors and the same tiles (``_plain_layout``)."""
    for points, valid, kw in _calls(name, dtype, dev, cloud10_cams):
        with torch.no_grad():
            kern = thpr.hpr_mask_soft_binned(points, valid=valid, **kw)
            with monkeypatch.context() as m:
                _plain_layout(m)
                plain = thpr.hpr_mask_soft_binned(points, valid=valid, **kw)
        assert torch.equal(kern, plain), (name, float((kern - plain).abs().max()))


def _tie_cloud():
    """1,024 points built with exact ties: the cloud on the −x side; a tight
    cluster far from it, whose bin in every grid holds the cluster alone, so
    that its rows' maxima tie across the four grids, ten of its points
    twice over; and 84 points at the +z pole, the last bin, past cap 64,
    whose last tile is clamped onto the one before it: without the
    stratified layout both tiles hold the same coverers, and the rows they
    share tie within the grid."""
    rng = np.random.default_rng(11)
    main = rng.normal(size=(900, 3)) * [2, 6, 2] + [-9, 0, 0]
    d = np.array([0.55, 0.45, 0.70])
    a = d / np.linalg.norm(d) + rng.normal(size=(40, 3)) * 2e-3
    a = a / np.linalg.norm(a, axis=1, keepdims=True) * rng.uniform(4, 6, size=(40, 1))
    a[20:30] = a[:10]
    pole = np.array([0.0, 0.0, 1.0]) + rng.normal(size=(84, 3)) * 2e-2
    pole = pole / np.linalg.norm(pole, axis=1, keepdims=True) * rng.uniform(3, 8, size=(84, 1))
    return np.concatenate([main, a, pole]).astype(np.float32)


def test_exact_ties_take_the_plain_gradient(dev, monkeypatch):
    """On the tie cloud (cap 64, no stratified layout), in float64: the
    gradient of a seeded weighting of the mask within 1e-12 of the largest
    entry of the plain chain's on the same tiles (``_plain_layout``: the two
    add the same terms in another order), the mask equal; the case holds
    rows whose maxima tie across grids and rows that two tiles of one grid
    hold with equal lse. A rule that gave every tied maximum the whole
    cotangent moves it by 2e2."""
    kw = dict(cap=64, stratified_coverers=False)
    P = torch.as_tensor(_tie_cloud(), dtype=torch.float64, device=dev)
    w = torch.as_tensor(np.random.default_rng(3).random(P.shape[0]), device=dev)
    seen = {}
    real = _kernels.binned_rowmax

    def recording(*args):
        out = real(*args)
        seen["args"], seen["up"] = args, out[1]
        return out

    def gate(plain):
        X = P.clone().requires_grad_(True)
        with monkeypatch.context() as m:
            m.setattr(_kernels, "binned_rowmax", recording)
            if plain:
                _plain_layout(m)
            vis = thpr.hpr_mask_soft_binned(X, **kw)
            (grad,) = torch.autograd.grad((vis * w).sum(), X)
        return vis.detach(), grad

    kern, plain = gate(False), gate(True)
    assert torch.equal(kern[0], plain[0])
    err = float((kern[1] - plain[1]).abs().max() / plain[1].abs().max())
    assert err <= 1e-12, err
    up = seen["up"]
    real_max = up > -1e29
    tied = ((up[:, None, :] == up[None, :, :]) & real_max[:, None, :]).sum((0, 1)) - real_max.sum(0)
    assert int((tied >= 12).sum()) >= 40  # the cluster ties in all four grids
    lses, _, bin_s, _, tiles, tile_ok, specs, cap = seen["args"]
    shared = 0
    for g, s in enumerate(specs):
        t = tiles[s.tiles:s.tiles + s.n_tiles]
        q = t[:, 1:2] + torch.arange(cap, device=dev)
        live = (bin_s[g][q] == t[:, :1]) & tile_ok[s.tiles:s.tiles + s.n_tiles, None]
        rows, vals = q[live], lses[g][live]
        order = torch.argsort(rows, stable=True)
        rows, vals = rows[order], vals[order]
        shared += int(((rows[1:] == rows[:-1]) & (vals[1:] == vals[:-1])).sum())
    assert shared > 0  # rows held by two tiles of one grid with equal lse


def _kernels_in(fn):
    """The names of the CUDA kernels ``fn`` runs, from a ``torch.profiler``
    trace (no copy or fill), the tiles' own left out."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    # not a copy, a fill or a program span's range on the device's timeline
    kernels = [k for k in names if not k.startswith(("Memcpy", "Memset", "trajopt."))]
    assert kernels, "the trace holds no device activity"
    return [k for k in kernels if not any(t in k for t in TILE_KERNELS)]


def test_launches_per_gate_call(dev, cloud10_cams):
    """One gate call on a cloud-10 camera at cap 512 and the gradient of a
    weighting of its mask: ``LAUNCHES`` rises by each layout kernel once
    (``binned_rows`` once per grid), and the trace holds at most
    ``MAX_FORWARD_KERNELS`` kernels forward and ``MAX_GATE_KERNELS``
    forward and backward besides the four ``soft_binned_fwd`` and the four
    ``soft_binned_bwd``."""
    cams, valid = cloud10_cams
    w = torch.as_tensor(np.random.default_rng(4).random(cams[3].shape[0]), dtype=torch.float32,
                        device=dev)

    def leaf():
        return cams[3].detach().clone().requires_grad_(True)

    P = leaf()  # the tables' first copy, the library's load
    torch.autograd.grad((thpr.hpr_mask_soft_binned(P, valid=valid, cap=512) * w).sum(), P)
    P, box = leaf(), {}
    before = dict(_kernels.LAUNCHES)
    fwd = _kernels_in(lambda: box.setdefault(
        "loss", (thpr.hpr_mask_soft_binned(P, valid=valid, cap=512) * w).sum()))
    mid = dict(_kernels.LAUNCHES)
    bwd = _kernels_in(lambda: torch.autograd.grad(box["loss"], P))
    after = dict(_kernels.LAUNCHES)
    assert {k: mid[k] - before[k] for k in mid if mid[k] != before[k]} == {
        "soft_binned_fwd": 4, **LAYOUT_FORWARD}
    assert {k: after[k] - mid[k] for k in after if after[k] != mid[k]} == {
        "soft_binned_bwd": 4, **LAYOUT_BACKWARD}
    assert len(fwd) <= MAX_FORWARD_KERNELS, (len(fwd), fwd)
    assert len(fwd) + len(bwd) <= MAX_GATE_KERNELS, (len(fwd), len(bwd), bwd)


def test_replays_count_the_layout_kernels(dev, cloud10_cams):
    """A captured soft gate call and its gradient: the capture records the
    layout's kernels beside the tiles' and takes their counts back (nothing
    ran), and each replay adds them to ``LAUNCHES``, as the eager call does."""
    cams, valid = cloud10_cams
    P = cams[2].detach().clone().requires_grad_(True)

    def fn():
        vis = thpr.hpr_mask_soft_binned(P, valid=valid, cap=512)
        torch.autograd.grad(vis.sum(), P)

    call = {"soft_binned_fwd": 4, "soft_binned_bwd": 4, **LAYOUT_FORWARD, **LAYOUT_BACKWARD}
    with tg.on_capture_stream(dev):
        fn()
        g = tg.StepGraph(fn, dev, "soft gate and gradient")
        before = dict(_kernels.LAUNCHES)
        g.capture()
        assert _kernels.LAUNCHES == before and g.launches == call
        for _ in range(3):
            g()
    torch.cuda.synchronize()
    assert g.replays == 3
    assert {k: v - before[k] for k, v in _kernels.LAUNCHES.items() if v != before[k]} == {
        k: 3 * v for k, v in call.items()}


def test_no_plain_layout_op_on_cuda_tensors(dev, cloud10_cams, monkeypatch):
    """A gate call and its backward on CUDA tensors reach neither
    ``torch.cummax``, ``torch.searchsorted``, ``add_rows`` nor
    ``_grid_bin_key`` (the plain chain's layout and its backward)."""
    def refused(name, fn):
        def run(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                raise AssertionError(f"a CUDA tensor reached {name}")
            return fn(*args, **kwargs)
        return run

    for mod, name in ((torch, "cummax"), (torch, "searchsorted"), (thpr, "add_rows"),
                      (thpr, "_grid_bin_key")):
        monkeypatch.setattr(mod, name, refused(name, getattr(mod, name)))
    cams, valid = cloud10_cams
    for points, kw in ((cams[7], dict(cap=512)), (torch.as_tensor(_seeded(300, 1), device=dev),
                                                  dict(cap=1024))):
        P = points.detach().clone().requires_grad_(True)
        vis = thpr.hpr_mask_soft_binned(P, valid=valid if points is cams[7] else None, **kw)
        vis.sum().backward()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(P.grad).all())
