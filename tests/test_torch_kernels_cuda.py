"""The port's hand-written CUDA kernels (K1–K4 and the uncached regime's K1′,
K2′ and K5, csrc/fused_vis.cu; the splat renderer's K6 and K7,
csrc/splat_render.cu) against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and is marked ``cuda``; without one each
skips (the kernels have no CPU mode). The file imports neither JAX nor the
JAX package and uses no conftest fixture, so it runs on a machine without
JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from trajectory_optimization_tpu_torch.models.traj import observation_logodds  # noqa: E402
from trajectory_optimization_tpu_torch.ops import _kernels  # noqa: E402
from trajectory_optimization_tpu_torch.ops import fused_vis as fv  # noqa: E402
from trajectory_optimization_tpu_torch.ops import quat as quat_ops  # noqa: E402
from trajectory_optimization_tpu_torch.ops import tile_render as tr  # noqa: E402
from trajectory_optimization_tpu_torch.ops.scores import waypoint_scores  # noqa: E402
from trajectory_optimization_tpu_torch.utils.data import (  # noqa: E402
    identity_quaternions,
    in_view_case,
    load_path,
    load_point_cloud,
    pad_points,
    splat_cases,
)
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

pytestmark = pytest.mark.cuda

DATA = Path(__file__).resolve().parents[1] / "data"
INTR = default_intrinsics()
EPS = 1e-6
FWD = dict(rtol=1e-4, atol=2e-4)  # the JAX suite's forward bound
GRAD = dict(rtol=2e-3, atol=2e-3)  # and its gradient bound


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def inputs(dev):
    """Cloud 10 padded as the facade pads it, stride-2 waypoints (W = 14)."""
    padded, valid = pad_points(load_point_cloud(str(DATA / "points/point_cloud_10.npz")))
    path = load_path(str(DATA / "paths/path_poses_10.npz"))
    q = identity_quaternions(len(path))
    q[::3] = [0.9, 0.1, -0.3, 0.2]
    quats = torch.as_tensor(q[::2].copy(), device=dev)
    trans = torch.as_tensor(path[::2].copy(), device=dev)
    W = len(quats)
    R = quat_ops.to_matrix(quat_ops.normalize(quats))
    K = INTR.matrix(device=dev)
    P = torch.as_tensor(padded, device=dev)
    g = np.random.default_rng(0).normal(size=len(padded)).astype(np.float32) * valid
    return dict(
        P=P, Pt=P.t().contiguous(), V=torch.as_tensor(valid, device=dev), K=K,
        quats=quats, trans=trans, g=torch.as_tensor(g, device=dev),
        wp=torch.cat([R.reshape(W, 9), trans], dim=1).contiguous(),
        kp=torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).contiguous(),
        k=fv.make_consts(INTR.width, INTR.height, 1.0, 5.0, EPS),
    )


def _close(got, want, **tol):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **tol)


def test_pass_a_matches_plain(inputs):
    x = inputs
    before = _kernels.LAUNCHES["pass_a"]
    m, mx, cache = _kernels.pass_a(x["wp"], x["kp"], x["Pt"], x["V"], x["k"])
    m_r, mx_r, cache_r = fv.pass_a_ref(x["wp"], x["kp"], x["Pt"], x["V"], x["k"])
    assert _kernels.LAUNCHES["pass_a"] == before + 1
    # the score is built from explicitly rounded operations in the plain
    # version's order: bit-equal on the card
    torch.cuda.synchronize()
    assert torch.equal(m, m_r) and torch.equal(mx, mx_r) and torch.equal(cache, cache_r)
    # the min/max are taken over exactly the cached values
    ok = x["V"] > 0
    assert torch.equal(m, torch.where(ok, cache, torch.full_like(cache, 3e38)).amin(1))
    assert torch.equal(mx, torch.where(ok, cache, torch.full_like(cache, -3e38)).amax(1))


def test_later_stages_match_plain(inputs):
    x = inputs
    m, mx, cache = _kernels.pass_a(x["wp"], x["kp"], x["Pt"], x["V"], x["k"])
    norm = fv.make_norm(m, mx)
    _close(_kernels.pass_b(norm, cache, EPS), fv.pass_b_ref(norm, cache, EPS), **FWD)
    st, need = _kernels.bwd_stats(norm, cache, x["V"], x["g"], EPS)
    st_r, need_r = fv.bwd_stats_ref(norm, cache, x["V"], x["g"], EPS)
    _close(st[:, :2], st_r[:, :2], **GRAD)
    assert torch.equal(st[:, 2:], st_r[:, 2:])  # same cache and norm: exact tie counts
    assert torch.equal(need, need_r)  # and the same need mask, word for word
    norm2 = torch.cat([norm, (st[:, :2] / st[:, 2:].clamp(min=1.0))], dim=1).contiguous()
    args = (x["wp"], x["kp"], norm2, x["Pt"], x["V"], x["g"], cache, need, x["k"])
    _close(_kernels.bwd_apply(*args), fv.bwd_apply_ref(*args), **GRAD)


def test_fused_lo_sum_matches_plain_autodiff(inputs):
    x = inputs
    res = {}
    for backend in ("kernel", "torch"):
        q = x["quats"].clone().requires_grad_(True)
        t = x["trans"].clone().requires_grad_(True)
        if backend == "kernel":
            lo = fv.fused_lo_sum(x["P"], q, t, x["K"], INTR.width, INTR.height, valid=x["V"],
                                 points_t=x["Pt"])
        else:
            s = waypoint_scores(x["P"], q, t, x["K"], INTR.width, INTR.height)
            lo = torch.sum(observation_logodds(s, EPS, x["V"]), dim=0)
        res[backend] = (lo.detach(), *torch.autograd.grad(lo, (q, t), x["g"]))
    for a, b, tol in zip(res["kernel"], res["torch"], (FWD, GRAD, GRAD)):
        _close(a, b, **tol)


def test_uncached_stages_match_plain(inputs):
    x = inputs
    args = (x["wp"], x["kp"], x["Pt"], x["V"], x["k"])
    m, mx, cache = _kernels.pass_a(*args)
    m1, mx1 = _kernels.pass_a_minmax(*args)
    assert torch.equal(m1, m) and torch.equal(mx1, mx)  # the same score bits as K1
    norm = fv.make_norm(m, mx)
    lo2 = _kernels.pass_b_recompute(x["wp"], x["kp"], norm, x["Pt"], x["k"])
    _close(lo2, fv.pass_b_recompute_ref(x["wp"], x["kp"], norm, x["Pt"], x["k"]), **FWD)
    _close(lo2, _kernels.pass_b(norm, cache, EPS), **FWD)
    acc = _kernels.bwd_fused_acc(x["wp"], x["kp"], norm, x["Pt"], x["V"], x["g"], x["k"])
    # the plain K5 tests its ties against the min/max of its own recompute
    norm_r = fv.make_norm(*fv.pass_a_minmax_ref(*args))
    acc_r = fv.bwd_fused_acc_ref(x["wp"], x["kp"], norm_r, x["Pt"], x["V"], x["g"], x["k"])
    _close(acc[:, :38], acc_r[:, :38], **GRAD)
    st, need = _kernels.bwd_stats(norm, cache, x["V"], x["g"], EPS)
    assert torch.equal(acc[:, 38:], st[:, 2:])  # K3's tie counts, exactly
    norm2 = torch.cat([norm, (st[:, :2] / st[:, 2:].clamp(min=1.0))], dim=1).contiguous()
    sums = _kernels.bwd_apply(x["wp"], x["kp"], norm2, x["Pt"], x["V"], x["g"], cache, need,
                              x["k"])
    _close(fv.fused_acc_to_sums(acc, len(norm)), sums, **GRAD)


def _fused(x, budget):
    saved = fv.SCORE_CACHE_MAX_BYTES
    fv.SCORE_CACHE_MAX_BYTES = budget
    try:
        q = x["quats"].clone().requires_grad_(True)
        t = x["trans"].clone().requires_grad_(True)
        _kernels.reset_launches()
        lo = fv.fused_lo_sum(x["P"], q, t, x["K"], INTR.width, INTR.height, valid=x["V"],
                             points_t=x["Pt"])
        out = (lo.detach(), *torch.autograd.grad(lo, (q, t), x["g"]))
        torch.cuda.synchronize()
        return out, dict(_kernels.LAUNCHES)
    finally:
        fv.SCORE_CACHE_MAX_BYTES = saved


def test_uncached_fused_lo_sum_matches_cached(inputs):
    cached, _ = _fused(inputs, 1 << 30)
    uncached, _ = _fused(inputs, 0)
    for a, b, tol in zip(uncached, cached, (FWD, GRAD, GRAD)):
        _close(a, b, **tol)


def test_uncached_regime_launches_only_its_kernels(inputs):
    _, launches = _fused(inputs, 0)
    assert {n for n, c in launches.items() if c} == {
        "pass_a_minmax", "pass_b_recompute", "bwd_fused_acc"}
    _, launches = _fused(inputs, 1 << 30)
    assert {n for n, c in launches.items() if c} == {
        "pass_a", "pass_b", "bwd_stats", "bwd_apply"}


def _skip_case(dev, name, W=50):
    """Inputs of K1′, K2′ and K5 that exercise their skips: "sparse" a seeded
    uniform ±20 m cloud of 262,144 points on the W-waypoint path of the
    8,388,608 × 50 shape (few warps take the gradient chain); "dense" 65,536
    points in view of 50 close waypoints (``in_view_case``: every warp takes
    it); "ties" the dense cloud with two copies of each waypoint's lowest-
    and highest-scoring point first (min and max ties with s ≠ 0); "one" and
    "ragged" the first 1 and 1,025 points of the tie cloud (a partial warp
    and block). Returns (wp, kp, pts_t, valid, g, k)."""
    if name == "sparse":
        pts = np.random.default_rng(8).uniform(-20, 20, size=(262_144, 3)).astype(np.float32)
        t = np.linspace(0, 1, W, dtype=np.float32)
        trans = np.stack([30 * t, 10 * np.sin(4 * t), np.zeros_like(t)], axis=1).astype(np.float32)
        quats = identity_quaternions(W)
        quats[::3] = [0.9, 0.1, -0.3, 0.2]
    else:
        pts, quats, trans = in_view_case(65_536, W)
    R = quat_ops.to_matrix(quat_ops.normalize(torch.as_tensor(quats, device=dev)))
    wp = torch.cat([R.reshape(W, 9), torch.as_tensor(trans, device=dev)], dim=1).contiguous()
    K = INTR.matrix(device=dev)
    kp = torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).contiguous()
    k = fv.make_consts(INTR.width, INTR.height, 1.0, 5.0, EPS)
    pts_t = torch.as_tensor(pts.T.copy(), device=dev)
    if name in ("ties", "one", "ragged"):
        n = {"one": 1, "ragged": 1025}.get(name)
        pts_t = fv.with_extreme_ties(wp, kp, pts_t, k)[:, :n].contiguous()
    N = pts_t.shape[1]
    g = np.random.default_rng(1).normal(size=N).astype(np.float32)
    return wp, kp, pts_t, torch.ones(N, device=dev), torch.as_tensor(g, device=dev), k


@pytest.mark.parametrize("name", ["sparse", "dense", "ties", "one", "ragged"])
def test_skipping_kernels_match_plain(dev, name):
    """K5 and K2′ against their plain versions (K5's sums at the gradient
    bound, its tie counts exactly; lo at the forward bound), each plain
    version on the min/max of its own recompute, as in chip_smoke.py."""
    wp, kp, Pt, V, g, k = _skip_case(dev, name)
    m, mx = _kernels.pass_a_minmax(wp, kp, Pt, V, k)
    norm = fv.make_norm(m, mx)
    norm_r = fv.make_norm(*fv.pass_a_minmax_ref(wp, kp, Pt, V, k))
    acc = _kernels.bwd_fused_acc(wp, kp, norm, Pt, V, g, k)
    acc_r = fv.bwd_fused_acc_ref(wp, kp, norm_r, Pt, V, g, k)
    _close(acc[:, :38], acc_r[:, :38], **GRAD)
    assert torch.equal(acc[:, 38:], acc_r[:, 38:])
    lo = _kernels.pass_b_recompute(wp, kp, norm, Pt, k)
    _close(lo, fv.pass_b_recompute_ref(wp, kp, norm, Pt, k), **FWD)
    # each case exercises what it is named for
    sk = fv.skip_masks(wp, kp, norm, Pt, V, k)
    taken = fv.warp_groups(sk.direct | sk.tie).float().mean().item()
    if name == "sparse":
        assert 0 < taken < 0.1
    elif name == "dense":
        assert taken == 1.0
    elif name == "ties":
        assert bool((m > 0).all()) and bool((acc[:, 38:] >= 2).all())
    else:
        assert bool(sk.tie.any(dim=1).all())  # the first points are the tied ones


@pytest.mark.parametrize("name", ["sparse", "dense", "ties"])
def test_skipping_kernels_are_reproducible(dev, name):
    """No float atomics: two launches on the same inputs agree bit for bit."""
    wp, kp, Pt, V, g, k = _skip_case(dev, name)
    norm = fv.make_norm(*_kernels.pass_a_minmax(wp, kp, Pt, V, k))
    a, b = (_kernels.bwd_fused_acc(wp, kp, norm, Pt, V, g, k) for _ in range(2))
    lo_a, lo_b = (_kernels.pass_b_recompute(wp, kp, norm, Pt, k) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(lo_a, lo_b)


PASS_A_CASES = ["ref", "sparse", "dense", "one", "ragged", "w1", "w130", "all_invalid",
                "some_invalid"]


def _pass_a_case(dev, name, inputs):
    """(wp, kp, pts_t, valid, k) for pass A: "ref" cloud 10 as the facade
    pads it; "sparse", "dense", "one" and "ragged" as in ``_skip_case`` (the
    dense cloud has no zero score: nothing may be pruned); "w1" and "w130"
    the sparse cloud with 1 and 130 waypoints (more than one shared-memory
    stage); "all_invalid" and "some_invalid" the sparse cloud with no valid
    point and with every third point invalid."""
    if name == "ref":
        return tuple(inputs[n] for n in ("wp", "kp", "Pt", "V", "k"))
    base = name if name in ("dense", "one", "ragged") else "sparse"
    wp, kp, pts_t, valid, _, k = _skip_case(dev, base, W={"w1": 1, "w130": 130}.get(name, 50))
    if name == "all_invalid":
        valid = torch.zeros_like(valid)
    elif name == "some_invalid":
        valid = (torch.arange(len(valid), device=dev) % 3 != 0).float()
    return wp, kp, pts_t, valid, k


@pytest.mark.parametrize("name", PASS_A_CASES)
def test_pass_a_kernels_equal_plain(dev, inputs, name):
    """K1's min, max and cache and K1′'s min and max are the plain pass A's
    bit for bit (so K1′'s are K1's), whatever pass A prunes."""
    args = _pass_a_case(dev, name, inputs)
    m, mx, cache = _kernels.pass_a(*args)
    m1, mx1 = _kernels.pass_a_minmax(*args)
    m_r, mx_r, cache_r = fv.pass_a_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(m, m_r) and torch.equal(mx, mx_r) and torch.equal(cache, cache_r)
    assert torch.equal(m1, m_r) and torch.equal(mx1, mx_r)
    wp, kp, pts_t, valid, k = args
    masks = fv.prune_masks(wp, kp, pts_t, k, m_r, mx_r)
    if name in ("sparse", "w130", "some_invalid"):  # each kind of pruning has pairs to take
        assert bool(masks.zero.any()) and bool(masks.under_max.any())
    elif name == "dense":  # every score is positive: neither kind may happen
        assert bool((m_r > 0).all()) and not bool((masks.zero | masks.under_max).any())
    elif name == "all_invalid":
        assert bool((m == _kernels.BIG).all()) and bool((mx == -_kernels.BIG).all())


@pytest.mark.parametrize("name", ["ref", "sparse", "dense"])
def test_pass_a_kernels_are_reproducible(dev, inputs, name):
    """Min and max do not depend on the order of the atomic merges: two
    launches on the same inputs agree bit for bit."""
    args = _pass_a_case(dev, name, inputs)
    a, b = _kernels.pass_a(*args), _kernels.pass_a(*args)
    a1, b1 = _kernels.pass_a_minmax(*args), _kernels.pass_a_minmax(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip((*a, *a1), (*b, *b1)))


def test_pass_a_nan_waypoint_gives_nan_min_and_max(dev, inputs):
    """A NaN waypoint's min and max are NaN, as the plain version's amin and
    amax and the JAX twin's jnp.min and jnp.max give them (pinned on the CPU
    in tests/test_torch_fused_vis_prune.py); the other waypoints are
    untouched, and without a valid point the sentinels come back."""
    wp, kp, pts_t, valid, k = _pass_a_case(dev, "sparse", inputs)
    wp = wp.clone()
    wp[7, 9:] = float("nan")
    m_r, mx_r, cache_r = fv.pass_a_ref(wp, kp, pts_t, valid, k)
    for got in (_kernels.pass_a(wp, kp, pts_t, valid, k)[:2],
                _kernels.pass_a_minmax(wp, kp, pts_t, valid, k)):
        for t, t_r in zip(got, (m_r, mx_r)):
            assert torch.equal(torch.isnan(t), torch.arange(50, device=dev) == 7)
            assert torch.equal(torch.isnan(t_r), torch.isnan(t))
            assert torch.equal(t[~torch.isnan(t)], t_r[~torch.isnan(t_r)])
    cache = _kernels.pass_a(wp, kp, pts_t, valid, k)[2]
    assert bool(torch.isnan(cache[7]).all()) and torch.equal(cache[:7], cache_r[:7])
    m0, mx0 = _kernels.pass_a_minmax(wp, kp, pts_t, torch.zeros_like(valid), k)
    assert bool((m0 == _kernels.BIG).all()) and bool((mx0 == -_kernels.BIG).all())


CACHED_BWD_CASES = ["ref", "sparse", "dense", "ties", "one", "ragged", "ragged4", "w1", "w130",
                    "some_invalid", "unaligned"]


def _cached_bwd_case(dev, name, inputs):
    """(wp, kp, pts_t, valid, g, k, cache, norm) for K3 and K4: the cases of
    ``_pass_a_case`` and ``_skip_case`` ("ragged": N = 1,025, not a multiple
    of 4, so K3 takes its scalar path), "ragged4" the first 1,028 points of
    the tie cloud (the 16-byte path with a partial tile and a ragged last
    mask word) and "unaligned" the sparse cloud with a score cache that
    starts 4 bytes off a 16-byte boundary (the scalar path at N % 4 == 0)."""
    if name == "ref":
        wp, kp, pts_t, valid, k = (inputs[n] for n in ("wp", "kp", "Pt", "V", "k"))
        g = inputs["g"]
    elif name == "ragged4":
        wp, kp, pts_t, valid, g, k = _skip_case(dev, "ties")
        pts_t, valid, g = pts_t[:, :1028].contiguous(), valid[:1028].clone(), g[:1028].clone()
    else:
        base = name if name in ("dense", "ties", "one", "ragged") else "sparse"
        wp, kp, pts_t, valid, g, k = _skip_case(dev, base, W={"w1": 1, "w130": 130}.get(name, 50))
        if name == "some_invalid":
            valid = (torch.arange(len(valid), device=dev) % 3 != 0).float()
    m, mx, cache = _kernels.pass_a(wp, kp, pts_t, valid, k)
    if name == "unaligned":
        flat = torch.empty(cache.numel() + 1, device=dev)
        flat[1:] = cache.reshape(-1)
        cache = flat[1:].view(cache.shape)
        assert cache.is_contiguous() and cache.data_ptr() % 16 == 4
    return wp, kp, pts_t, valid, g, k, cache, fv.make_norm(m, mx)


@pytest.mark.parametrize("name", CACHED_BWD_CASES)
def test_cached_backward_kernels_match_plain(dev, inputs, name):
    """K3's sums at the gradient bound, its tie counts and its need mask
    exactly; K4 on that mask at the gradient bound against the plain K4 that
    computes every pair; a second launch of each bit-equal to the first; the
    arrival counters left at zero."""
    wp, kp, Pt, V, g, k, cache, norm = _cached_bwd_case(dev, name, inputs)
    before = dict(_kernels.LAUNCHES)
    st, need = _kernels.bwd_stats(norm, cache, V, g, EPS)
    st_r, need_r = fv.bwd_stats_ref(norm, cache, V, g, EPS)
    _close(st[:, :2], st_r[:, :2], **GRAD)
    assert torch.equal(st[:, 2:], st_r[:, 2:]) and torch.equal(need, need_r)
    norm2 = torch.cat([norm, st[:, :2] / st[:, 2:].clamp(min=1.0)], dim=1).contiguous()
    args = (wp, kp, norm2, Pt, V, g, cache, need, k)
    sums = _kernels.bwd_apply(*args)
    _close(sums, fv.bwd_apply_ref(*args), **GRAD)
    assert _kernels.LAUNCHES["bwd_stats"] == before["bwd_stats"] + 1
    assert _kernels.LAUNCHES["bwd_apply"] == before["bwd_apply"] + 1
    st2, need2 = _kernels.bwd_stats(norm, cache, V, g, EPS)
    sums2 = _kernels.bwd_apply(*args)
    torch.cuda.synchronize()
    assert torch.equal(st, st2) and torch.equal(need, need2) and torch.equal(sums, sums2)
    assert all(not bool(arrivals.any()) for arrivals, _ in _kernels._reduction_scratch.values())
    groups = fv.warp_groups(fv.unpack_need(need, cache.shape[1])).float().mean().item()
    if name == "sparse":
        assert 0 < groups < 0.1
    elif name == "dense":
        assert groups == 1.0
    elif name in ("ties", "one", "ragged", "ragged4"):  # ties with s != 0: K4 must chain them
        assert bool((norm[:, 0] > 0).all()) and bool((st[:, 2:] >= 1).all())


def test_cached_backward_scalar_path_equals_vector_path(dev, inputs):
    """K3's two load paths see the same pairs: the same mask and counts bit
    for bit, the float sums at the gradient bound (another summation order)."""
    wp, kp, Pt, V, g, k, cache, norm = _cached_bwd_case(dev, "sparse", inputs)
    off = _cached_bwd_case(dev, "unaligned", inputs)[6]
    assert torch.equal(off, cache)
    st, need = _kernels.bwd_stats(norm, cache, V, g, EPS)
    st_s, need_s = _kernels.bwd_stats(norm, off, V, g, EPS)
    assert torch.equal(need, need_s) and torch.equal(st[:, 2:], st_s[:, 2:])
    _close(st_s[:, :2], st[:, :2], **GRAD)


@pytest.mark.parametrize("what", ["alpha_inf", "beta_nan", "nan_score", "g_nan"])
def test_cached_backward_nan_rule(dev, inputs, what):
    """Where the plain K4 gives NaN the kernel does, and nowhere else: a
    waypoint whose α or β is not finite has all 12 sums NaN though its mask
    leaves nearly every pair out; a NaN score is flagged by K3 and a NaN
    cotangent at a flagged pair reaches K4's sums (pinned on the CPU in
    tests/test_torch_fused_vis_cached_bwd.py)."""
    wp, kp, Pt, V, g, k, cache, norm = _cached_bwd_case(dev, "sparse", inputs)
    if what == "nan_score":
        cache = cache.clone()
        cache[3, 12345] = float("nan")
    if what == "g_nan":
        mask = fv.unpack_need(_kernels.bwd_stats(norm, cache, V, g, EPS)[1], cache.shape[1])
        g = g.clone()
        g[int(torch.nonzero(mask[3])[0])] = float("nan")
    st, need = _kernels.bwd_stats(norm, cache, V, g, EPS)
    st_r, need_r = fv.bwd_stats_ref(norm, cache, V, g, EPS)
    assert torch.equal(need, need_r) and torch.equal(torch.isnan(st), torch.isnan(st_r))
    norm2 = torch.cat([norm, st[:, :2] / st[:, 2:].clamp(min=1.0)], dim=1).contiguous()
    if what == "alpha_inf":
        norm2[3, 4] = float("inf")
    elif what == "beta_nan":
        norm2[3, 5] = float("nan")
    args = (wp, kp, norm2, Pt, V, g, cache, need, k)
    sums, sums_r = _kernels.bwd_apply(*args), fv.bwd_apply_ref(*args)
    torch.cuda.synchronize()
    assert bool(torch.isnan(sums_r[3]).all()) and not bool(torch.isnan(sums_r).all())
    assert torch.equal(torch.isnan(sums), torch.isnan(sums_r))
    ok = ~torch.isnan(sums_r)
    _close(sums[ok], sums_r[ok], **GRAD)


def test_cached_backward_wrappers_reject_bad_need(dev, inputs):
    wp, kp, Pt, V, g, k, cache, norm = _cached_bwd_case(dev, "ref", inputs)
    st, need = _kernels.bwd_stats(norm, cache, V, g, EPS)
    norm2 = torch.cat([norm, st[:, :2]], dim=1).contiguous()
    with pytest.raises(ValueError, match="int32"):
        _kernels.bwd_apply(wp, kp, norm2, Pt, V, g, cache, need.long(), k)
    with pytest.raises(ValueError, match="shape"):
        _kernels.bwd_apply(wp, kp, norm2, Pt, V, g, cache, need[:, :-1].contiguous(), k)


def test_wrappers_reject_bad_inputs(inputs):
    x = inputs
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.pass_a(x["wp"], x["kp"], x["P"].t(), x["V"], x["k"])
    with pytest.raises(ValueError, match="float32"):
        _kernels.pass_a(x["wp"].double(), x["kp"], x["Pt"], x["V"], x["k"])


# ---- K6 and K7 ---------------------------------------------------------------

SMALL_K = np.array([[100.0, 0.0, 64.0], [0.0, 100.0, 48.0], [0.0, 0.0, 1.0]], np.float32)


def _splat_both(pts, K, H, W, dev, **kw):
    """Kernel and plain blend on the same prologue output; returns the two
    planar images and n_dropped."""
    P = torch.as_tensor(pts, device=dev)
    use_runs, offsets, entries, dropped = tr.splat_prologue(
        P, torch.as_tensor(K, device=dev), H, W, znear=1.0, zfar=15.0, **kw)
    ty, tx = tr.tile_grid(H, W)
    if use_runs:
        args = (offsets, entries, ty, tx, 1.0)
        got, want = _kernels.splat_runs(*args), tr.splat_runs_ref(*args)
    else:
        args = (offsets, entries, kw.get("max_entries_per_tile", 2048), ty, tx, 1.0)
        got, want = _kernels.splat_dense(*args), tr.splat_dense_ref(*args)
    torch.cuda.synchronize()
    return got, want, dropped, use_runs


@pytest.mark.parametrize("backend", ["runs", "dense"])
def test_splat_kernels_match_plain_at_the_reference_camera(dev, backend):
    """The visible points of cloud 10 from the reference camera, padded as
    the points processor pads them: bit-equal images."""
    from trajectory_optimization_tpu_torch.ops.geometry import compact_masked, frustum_cull

    pts = load_point_cloud(str(DATA / "points/point_cloud_10.npz")) - np.array([9.0, 2.0, -2.0],
                                                                               np.float32)
    mask = frustum_cull(torch.as_tensor(pts), INTR.matrix(), INTR.width, INTR.height,
                        max_dist=15.0)[0]
    padded, valid = pad_points(compact_masked(pts, mask))
    got, want, dropped, use_runs = _splat_both(
        padded, INTR.matrix_np(), int(INTR.height), int(INTR.width), dev,
        valid=torch.as_tensor(valid, device=dev), backend=backend)
    assert use_runs == (backend == "runs") and got.shape == (3, 1632, 1280)
    assert torch.equal(got, want) and int(dropped) == 0
    assert bool((got < 1).any())


@pytest.mark.parametrize("backend", ["runs", "dense"])
def test_splat_kernels_odd_size_and_empty(dev, backend):
    rng = np.random.default_rng(1)
    pts = np.stack([rng.uniform(-3, 3, 400), rng.uniform(-2, 2, 400), rng.uniform(1.5, 9, 400)],
                   axis=1).astype(np.float32)
    got, want, _, _ = _splat_both(pts, SMALL_K, 100, 130, dev, backend=backend)
    assert got.shape == (3, 128, 256) and torch.equal(got, want)
    img = tr.render_point_cloud_tiles(torch.as_tensor(pts, device=dev),
                                      torch.as_tensor(SMALL_K, device=dev), 100, 130,
                                      backend=backend)
    assert img.shape == (100, 130, 3) and img.is_cuda
    got, want, dropped, _ = _splat_both(np.zeros((0, 3), np.float32), SMALL_K, 64, 128, dev,
                                        backend=backend)
    assert torch.equal(got, want) and bool((got == 1.0).all()) and int(dropped) == 0


def test_splat_dense_overflow_cap(dev):
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-0.02, 0.02, 64), rng.uniform(-0.02, 0.02, 64), np.full(64, 2.0)],
                   axis=1).astype(np.float32)  # all in one tile
    got, want, dropped, _ = _splat_both(pts, SMALL_K, 64, 128, dev, backend="dense",
                                        max_entries_per_tile=8)
    assert torch.equal(got, want)
    cpu = tr.splat_prologue(torch.as_tensor(pts), torch.as_tensor(SMALL_K), 64, 128, znear=1.0,
                            zfar=15.0, backend="dense", max_entries_per_tile=8)[3]
    assert int(dropped) == int(cpu) > 0


def test_auto_backend_launches_one_kernel_each_side_of_the_limit(dev):
    rng = np.random.default_rng(2)
    K = torch.as_tensor(SMALL_K, device=dev)
    for n, want in ((tr.RUN_PATH_MAX_ENTRIES, "splat_runs"),
                    (tr.RUN_PATH_MAX_ENTRIES + 1, "splat_dense")):
        z = rng.uniform(2, 14, n)
        pts = np.stack([z * rng.uniform(-0.6, 0.6, n), z * rng.uniform(-0.45, 0.45, n), z], 1)
        _kernels.reset_launches()
        img, dropped = tr.render_point_cloud_tiles(
            torch.as_tensor(pts.astype(np.float32), device=dev), K, 96, 128, zfar=15.0,
            return_overflow=True)
        torch.cuda.synchronize()
        assert {k for k, v in _kernels.LAUNCHES.items() if v} == {want}
        assert _kernels.LAUNCHES[want] == 1
        assert img.shape == (96, 128, 3) and int(dropped) >= 0


def test_splat_wrappers_reject_bad_inputs(dev):
    offsets = torch.zeros(4, dtype=torch.int32, device=dev)
    entries = torch.zeros((5, 8), device=dev)
    with pytest.raises(ValueError, match="int32"):
        _kernels.splat_runs(offsets.long(), entries, 1, 3, 1.0)
    with pytest.raises(ValueError, match="shape"):
        _kernels.splat_runs(offsets, entries, 2, 3, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.splat_dense(offsets, torch.zeros((8, 5), device=dev).t(), 8, 1, 3, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.splat_runs(offsets.cpu(), entries.cpu(), 1, 3, 1.0)


@functools.lru_cache(maxsize=None)
def _edge_cases(size):
    """``utils.data.splat_cases`` on a small image (cap 64) or at the
    reference camera (cap 2048, the renderer's default)."""
    if size == "small":
        return SMALL_K, 100, 130, splat_cases(SMALL_K, 100, 130, cap=64)
    K = INTR.matrix_np()
    H, W = int(INTR.height), int(INTR.width)
    return K, H, W, splat_cases(K, H, W)


@pytest.mark.parametrize("backend", ["runs", "dense"])
@pytest.mark.parametrize("name", ["ties", "edges_r05", "edges_r4", "over_cap"])
@pytest.mark.parametrize("size", ["small", "reference"])
def test_splat_kernels_equal_plain_on_edge_cases(dev, size, name, backend):
    """Equal depths across tile, band and bin borders; r = 0.5 and r = 4 on
    the image's edges; every tile over the dense path's cap: images
    ``torch.equal`` to the plain versions, n_dropped equal to the CPU
    prologue's, and a second launch equal to the first."""
    K, H, W, cases = _edge_cases(size)
    pts, kw = cases[name]
    P, Kt = torch.as_tensor(pts, device=dev), torch.as_tensor(K, device=dev)
    use_runs, offsets, entries, dropped = tr.splat_prologue(P, Kt, H, W, znear=1.0, zfar=15.0,
                                                            backend=backend, **kw)
    ty, tx = tr.tile_grid(H, W)
    if use_runs:
        args = (offsets, entries, ty, tx, 1.0)
        kern, plain = _kernels.splat_runs, tr.splat_runs_ref
    else:
        args = (offsets, entries, kw.get("max_entries_per_tile", 2048), ty, tx, 1.0)
        kern, plain = _kernels.splat_dense, tr.splat_dense_ref
    got, again, want = kern(*args), kern(*args), plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, got)
    assert bool((got < 1.0).any())
    cpu = tr.splat_prologue(torch.as_tensor(pts), torch.as_tensor(K), H, W, znear=1.0, zfar=15.0,
                            backend=backend, **kw)[3]
    assert int(dropped) == int(cpu)
    if name == "over_cap" and backend == "dense":
        counts = (offsets[1:] - offsets[:-1])[: ty * tx]
        assert bool((counts > args[2]).all()) and int(dropped) > 0


def test_pose_optimizer_card_matches_cpu(dev):
    """The pose path has no kernel: 20 steps of ``PoseOptimizer`` at cloud 10
    on the card against the same run on the CPU (rtol 1e-4 / atol 1e-5)."""
    from trajectory_optimization_tpu_torch.api import PoseOptimizer

    pts = load_point_cloud(str(DATA / "points/point_cloud_10.npz"))
    runs = [PoseOptimizer(lr_pose=0.1, lr_quat=0.02, device=d).optimize(
        pts, [6.0, 2.0, 0.0], [0.9, 0.1, -0.2, 0.3], n_steps=20) for d in (dev, "cpu")]
    card, cpu = runs
    np.testing.assert_allclose(card.position, cpu.position, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(card.quat_wxyz, cpu.quat_wxyz, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(card.loss, cpu.loss, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(card.observations, cpu.observations, rtol=1e-4, atol=1e-5)


def test_traj_opt_node_launches_k1_to_k4_per_message(dev):
    """``TrajOptNode`` on the card: 30 steps of cloud 10 per message launch
    K1 and K2 31 times (30 steps and the final forward) and K3 and K4 30
    times, and nothing of the uncached regime; depth 2 publishes depth 1's
    paths."""
    from trajectory_optimization_tpu_torch.bus.core import Bus
    from trajectory_optimization_tpu_torch.bus.messages import CloudMsg, Header, PathMsg
    from trajectory_optimization_tpu_torch.bus.nodes import TrajOptNode
    from trajectory_optimization_tpu_torch.utils.config import TrajOptNodeConfig

    pts = load_point_cloud(str(DATA / "points/point_cloud_10.npz"))
    path = load_path(str(DATA / "paths/path_poses_10.npz"))
    paths = {}
    for depth in (1, 2):
        bus = Bus(error_policy="raise")
        node = TrajOptNode(bus, TrajOptNodeConfig(
            pc_topic="/pc", path_topic="/path", opt_steps=30, lr_pose=0.1, lr_quat=0.02,
            rewards_th=float("inf"), pipeline_depth=depth), device=dev)
        out = []
        bus.subscribe("/path/optimized", out.append)
        _kernels.reset_launches()
        for i in range(2):
            bus.publish("/pc", CloudMsg(Header(stamp=10.0 * i), pts))
            bus.publish("/path", PathMsg.straight(path, stamp=10.0 * i))
        node.flush()
        assert len(out) == 2
        assert {n: v for n, v in _kernels.LAUNCHES.items() if v} == {
            "pass_a": 62, "pass_b": 62, "bwd_stats": 60, "bwd_apply": 60}
        paths[depth] = [m.positions for m in out]
    for a, b in zip(paths[1], paths[2]):
        np.testing.assert_array_equal(a, b)


# ---- hidden-point removal (ops/hpr.py: no hand-written kernel) -------------

def test_hpr_approx_on_the_card_is_stable_and_matches_the_cpu(dev):
    """``hpr_mask_approx`` on the card, cloud 10 seen from (6, 2, 0) and
    padded to 40,960: two runs ``torch.equal``; under 1% of the mask differs
    from the CPU run (the twin bar of tests/test_torch_hpr.py), and neither
    marks a point that Qhull hides."""
    from trajectory_optimization_tpu_torch.ops import hpr

    cam = load_point_cloud(str(DATA / "points/point_cloud_10.npz")) - np.float32([6.0, 2.0, 0.0])
    padded, valid = pad_points(cam)
    P, V = torch.as_tensor(padded), torch.as_tensor(valid)
    a = hpr.hpr_mask_approx(P.to(dev), valid=V.to(dev))
    b = hpr.hpr_mask_approx(P.to(dev), valid=V.to(dev))
    assert torch.equal(a, b)
    card = a.cpu().numpy()[: len(cam)] > 0.5
    cpu = hpr.hpr_mask_approx(P, valid=V).numpy()[: len(cam)] > 0.5
    assert (card != cpu).mean() < 0.01
    exact = hpr.hpr_mask_exact(cam)
    assert not (card & ~exact).any() and not (cpu & ~exact).any()
    assert (card & exact).sum() / exact.sum() >= 0.99


def test_hpr_soft_on_the_card_matches_the_cpu(dev):
    """``hpr_mask_soft`` and its gradient on the card against the CPU, on
    cloud 10 cut to 5,057 points from (6, 2, 0), padded to 6,144. The mask's
    sigmoid amplifies one f32 rounding of its inputs to ~2.4e-3, so the bars
    are tests/test_torch_hpr.py's against the JAX twin: 99.8% of the values
    within 3e-3, all within 1e-2, the per-point gradient within 1% in L2
    norm."""
    from trajectory_optimization_tpu_torch.ops import hpr

    cam = load_point_cloud(str(DATA / "points/point_cloud_10.npz"))[::8] - np.float32(
        [6.0, 2.0, 0.0])
    padded, valid = pad_points(cam)
    w = np.random.default_rng(0).normal(size=len(padded)).astype(np.float32) * valid
    out = {}
    for d in (dev, "cpu"):
        P = torch.as_tensor(padded, device=d).requires_grad_(True)
        v = hpr.hpr_mask_soft(P, valid=torch.as_tensor(valid, device=d))
        torch.sum(v * torch.as_tensor(w, device=d)).backward()
        out[str(d)[:4]] = (v.detach().cpu().numpy(), P.grad.cpu().numpy())
    (vc, gc), (vh, gh) = out["cuda"], out["cpu"]
    dv = np.abs(vc - vh)
    assert (dv > 3e-3).mean() <= 2e-3 and dv.max() <= 1e-2
    assert np.isfinite(gc).all()
    assert np.linalg.norm(gc - gh) <= 1e-2 * np.linalg.norm(gh)


def test_a_cuda_image_records_as_its_host_twin(dev, tmp_path):
    """An ``ImageMsg`` whose data lies on the card (as the points processor
    publishes it) records byte for byte as the same pixels in numpy, in a
    bag and on the cross-process wire: the sinks take the host copy
    (``bus.messages.host_image``)."""
    from trajectory_optimization_tpu_torch.bus import remote, rosbag
    from trajectory_optimization_tpu_torch.bus.messages import Header, ImageMsg

    rng = np.random.default_rng(0)
    imgs = [rng.uniform(size=(48, 64, 3)).astype(np.float32),
            rng.integers(0, 255, size=(48, 64, 3), dtype=np.uint8)]
    encodings = ["rgb32f", "rgb8"]

    def msgs(on_card):
        return [(f"/cam{i}/image", ImageMsg(
            Header(stamp=1.0 + i, frame_id=f"cam{i}", seq=i),
            torch.as_tensor(a, device=dev) if on_card else a, encoding=e,
            wire_format="png" if e == "rgb8" else ""))
            for i, (a, e) in enumerate(zip(imgs, encodings))]

    paths = [str(tmp_path / f"{k}.bag") for k in ("card", "host")]
    rosbag.write_bag(paths[0], msgs(True))
    rosbag.write_bag(paths[1], msgs(False))
    assert Path(paths[0]).read_bytes() == Path(paths[1]).read_bytes()
    for (_, a), (_, b) in zip(msgs(True), msgs(False)):
        assert remote._wire_encode(a) == remote._wire_encode(b)
