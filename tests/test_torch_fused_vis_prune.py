"""What pass A leaves out cannot change a waypoint's min or max.

K1 and K1′ (``pass_a_kernel``) finish a pair after the score's distance term
t0 = d²·inv_var where that already decides the pair: t0 ≥ ``PRUNE_ZERO_T``
makes the score exactly +0, and, for K1′ once the waypoint's min is 0, a t0
above a threshold taken from the max so far puts the score under that max.
The plain helper ``fused_vis.prune_masks`` gives both predicates with the
kernels' constants. Here they are held against the plain pass A on cloud 10 /
path 10, a seeded uniform ±20 m cloud of 65,536 points on the 50-waypoint path
of ``chip_smoke.py``'s 8,388,608 × 50 shape, and a cloud in view of every
waypoint (``in_view_case``: no score underflows, nothing may be pruned); the
pruned plain version is also held against the JAX twin's pass A (interpret
mode), a NaN waypoint included. The CUDA kernels run on the card only
(``tests/test_torch_kernels_cuda.py``).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_fused_vis import FWD, _rot_quats  # noqa: E402
from test_torch_fused_vis_skip import _tensors  # noqa: E402
from test_torch_fused_vis_uncached import _jax_uncached  # noqa: E402
from trajectory_optimization_tpu_torch.ops import _kernels  # noqa: E402
from trajectory_optimization_tpu_torch.ops import fused_vis as fv  # noqa: E402
from trajectory_optimization_tpu_torch.utils.data import in_view_case, pad_points  # noqa: E402

CASES = ["cloud10", "uniform65k", "in_view"]
BLOCK = 1024  # the points a kernel block holds at a time


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread (restored afterwards): the comparisons here are bit
    for bit, as in tests/test_torch_fused_vis_uncached.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _uniform(n):
    """The first n points of the seeded ±20 m cloud and its 50 waypoints."""
    pts = np.random.default_rng(8).uniform(-20, 20, size=(65536, 3)).astype(np.float32)[:n]
    t = np.linspace(0, 1, 50, dtype=np.float32)
    trans = np.stack([30 * t, 10 * np.sin(4 * t), np.zeros_like(t)], axis=1).astype(np.float32)
    return pts, _rot_quats(50), trans


def _case(name, cloud10, path10):
    if name == "cloud10":
        pts, valid = pad_points(cloud10)
        quats, trans = _rot_quats(len(path10))[::2], path10[::2]
    else:
        pts, quats, trans = _uniform(65536) if name == "uniform65k" else in_view_case(8192, 50)
        valid = np.ones(len(pts), np.float32)
    x = _tensors(pts, quats, trans, valid, np.zeros(len(pts), np.float32))
    x["m"], x["M"], x["s"] = fv.pass_a_ref(x["wp"], x["kp"], x["pts_t"], x["valid"], x["k"])
    return x


@pytest.fixture(scope="module")
def cases(cloud10, path10):
    return {name: _case(name, cloud10, path10) for name in CASES}


def _masks(x, m, M, pts_t=None, **mutation):
    return fv.prune_masks(x["wp"], x["kp"], x["pts_t"] if pts_t is None else pts_t, x["k"], m, M,
                          **mutation)


def _pruned_pass_a(s, valid, masks, m_so_far):
    """Plain pass A on scores ``s`` the way the kernels prune it: ``zero``
    pairs take the constant 0 in place of their score, ``under_max`` pairs
    are left out of min and max, and the min starts from ``m_so_far``, the
    min that ``masks`` were made with (pairs are left out only where it is
    0). Returns (m, M, scores as K1 caches them)."""
    s = torch.where(masks.zero, torch.zeros_like(s), s)
    keep = (valid[None, :] > 0) & ~masks.under_max
    m = torch.amin(torch.where(keep, s, torch.full_like(s, _kernels.BIG)), dim=1)
    M = torch.amax(torch.where(keep, s, torch.full_like(s, -_kernels.BIG)), dim=1)
    return torch.minimum(m, m_so_far), M, s


def _running_pass_a(x, **mutation):
    """K1′ as one block runs it: blocks of 1,024 points in order, each pruned
    with the min and max of the blocks before it."""
    W = len(x["wp"])
    m, M = torch.full((W,), _kernels.BIG), torch.full((W,), -_kernels.BIG)
    n_under = 0
    for i0 in range(0, x["pts_t"].shape[1], BLOCK):
        sl = slice(i0, i0 + BLOCK)
        masks = _masks(x, m, M, x["pts_t"][:, sl].contiguous(), **mutation)
        m, bM, _ = _pruned_pass_a(x["s"][:, sl], x["valid"][sl], masks, m)
        M = torch.maximum(M, bM)
        n_under += int(masks.under_max.sum())
    return m, M, n_under


@pytest.mark.parametrize("name", CASES)
def test_zero_pairs_score_exactly_zero(cases, name):
    x = cases[name]
    masks = _masks(x, x["m"], x["M"])
    assert bool((x["s"][masks.zero] == 0).all())
    assert not bool((masks.zero & masks.under_max).any())
    if name == "in_view":  # every score is positive: nothing is pruned, by either test
        assert bool((x["m"] > 0).all()) and not bool((masks.zero | masks.under_max).any())
    else:
        assert 0 < int(masks.zero.sum()) < masks.zero.numel()


@pytest.mark.parametrize("name", CASES)
def test_under_max_pairs_stay_under_the_max_so_far(cases, name):
    """With the max over the first 256 valid points (a running max) and with
    the final max: every ``under_max`` pair scores at most that max, and
    there are none while the min is not 0."""
    x = cases[name]
    first = torch.nonzero(x["valid"] > 0)[:256, 0]
    for M in (x["s"][:, first].amax(1), x["M"]):
        masks = _masks(x, torch.zeros_like(M), M)
        if name != "in_view":  # in view of every waypoint nothing is far enough
            assert 0 < int(masks.under_max.sum())
        assert bool((x["s"] <= M[:, None])[masks.under_max].all())
        assert not bool(_masks(x, torch.full_like(M, 1e-30), M).under_max.any())


@pytest.mark.parametrize("name", CASES)
def test_pruned_pass_a_equals_full(cases, name):
    """Zero pairs set to 0 and under-max pairs left out (final min and max,
    which prune the most): min, max and the cached scores are the full
    ones bit for bit."""
    x = cases[name]
    m, M, s = _pruned_pass_a(x["s"], x["valid"], _masks(x, x["m"], x["M"]), x["m"])
    assert torch.equal(m, x["m"]) and torch.equal(M, x["M"]) and torch.equal(s, x["s"])


@pytest.mark.parametrize("name", CASES)
def test_running_prune_equals_full(cases, name):
    x = cases[name]
    m, M, n_under = _running_pass_a(x)
    assert torch.equal(m, x["m"]) and torch.equal(M, x["M"])
    assert (n_under > 0) == (name != "in_view")


def test_mutated_thresholds_fail(cases):
    """A zero threshold or a margin past what the bound allows is caught: the
    same checks fail on the uniform cloud."""
    x = cases["uniform65k"]
    zero = _masks(x, x["m"], x["M"], zero_t=150.0).zero
    assert bool((x["s"][zero] != 0).any())
    _, M, _ = _running_pass_a(x, max_margin=-8.0)
    assert not torch.equal(M, x["M"])
    first_max = x["s"][:, :256].amax(1)
    under = _masks(x, torch.zeros_like(first_max), first_max, max_margin=-8.0).under_max
    assert bool((x["s"] > first_max[:, None])[under].any())


def test_all_invalid_waypoints_return_the_sentinels(cases):
    x = cases["uniform65k"]
    none = torch.zeros_like(x["valid"])
    big = torch.full_like(x["m"], _kernels.BIG)
    m, M, _ = _pruned_pass_a(x["s"], none, _masks(x, big, -big), big)
    m_r, M_r = fv.pass_a_minmax_ref(x["wp"], x["kp"], x["pts_t"], none, x["k"])
    assert torch.equal(m, m_r) and torch.equal(M, M_r)
    assert bool((m == _kernels.BIG).all()) and bool((M == -_kernels.BIG).all())


@pytest.fixture(scope="module")
def pallas_case():
    """8,192 points of the uniform cloud (whole JAX tiles) × its waypoints
    0, 4, .., 48 through the JAX twin's pass A (no cache), waypoint 7 of
    those NaN."""
    pts, quats, trans = _uniform(8192)
    quats, trans = quats[::4].copy(), trans[::4].copy()
    trans[7] = np.nan
    valid = np.ones(len(pts), np.float32)
    g = np.random.default_rng(1).normal(size=len(pts)).astype(np.float32)
    return _jax_uncached(pts, quats, trans, valid, g, with_lo=False)


def test_pruned_plain_pass_a_matches_pallas(pallas_case):
    """The pruned plain pass A against the JAX twin's: min/max at rtol 1e-5
    (exp and sigmoid of two libraries; atol 1e-30 absorbs denormal minima),
    and the forward log-odds built on them at the forward bound."""
    jx, tt = pallas_case
    fine = np.arange(len(tt["wp"])) != 7
    m_f, M_f, s = fv.pass_a_ref(tt["wp"], tt["kp"], tt["pts_t"], tt["valid"], tt["k"])
    masks = fv.prune_masks(tt["wp"], tt["kp"], tt["pts_t"], tt["k"], m_f, M_f)
    assert 0 < int(masks.zero.sum()) and 0 < int(masks.under_max.sum())
    m, M, _ = _pruned_pass_a(s, tt["valid"], masks, m_f)
    np.testing.assert_allclose(m.numpy()[fine], jx["m"][fine], rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(M.numpy()[fine], jx["mx"][fine], rtol=1e-5, atol=1e-30)
    norm = fv.make_norm(m, M)[fine].contiguous()
    lo = fv.pass_b_recompute_ref(tt["wp"][fine].contiguous(), tt["kp"], norm, tt["pts_t"], tt["k"])
    lo_j = fv.pass_b_recompute_ref(tt["wp"][fine].contiguous(), tt["kp"],
                                   torch.as_tensor(jx["norm"][fine]), tt["pts_t"], tt["k"])
    np.testing.assert_allclose(lo.numpy(), lo_j.numpy(), **FWD)


def test_nan_waypoint_gives_nan_min_and_max_as_pallas(pallas_case):
    """A NaN waypoint with a valid point has min = max = NaN in the JAX twin
    (its jnp.min/jnp.max keep NaN) and in the plain pass A (amin/amax do);
    nothing of it is pruned, so the kernels' full path sees every NaN."""
    jx, tt = pallas_case
    m, M = fv.pass_a_minmax_ref(tt["wp"], tt["kp"], tt["pts_t"], tt["valid"], tt["k"])
    want = np.arange(len(tt["wp"])) == 7
    for got in (m.numpy(), M.numpy(), jx["m"], jx["mx"]):
        np.testing.assert_array_equal(np.isnan(got), want)
    masks = fv.prune_masks(tt["wp"], tt["kp"], tt["pts_t"], tt["k"], torch.zeros_like(M),
                           torch.nan_to_num(M, nan=1.0))
    assert not bool(masks.zero[7].any()) and not bool(masks.under_max[7].any())
    # without a valid point the NaN scores are masked out: the sentinels
    m0, M0 = fv.pass_a_minmax_ref(tt["wp"], tt["kp"], tt["pts_t"], torch.zeros_like(tt["valid"]),
                                  tt["k"])
    assert bool(m0[7] == _kernels.BIG) and bool(M0[7] == -_kernels.BIG)
