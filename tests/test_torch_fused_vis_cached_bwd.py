"""The cached backward's need mask: what K3 leaves for K4, and what K4 may skip.

K3 (``bwd_stats_kernel``) returns, beside its (W, 4) table, one bit per pair
that says whether the pair can add a nonzero term to K4 (``fused_vis.
need_mask``, packed 32 pairs to an int32 word by ``pack_need``). K4
(``bwd_apply_kernel``) reads that mask and computes only the flagged pairs.
Here, in plain PyTorch on the CPU: the plain K4 with every term outside the
mask zeroed (``bwd_apply_masked_ref``) is held ``torch.equal`` to the full
plain K4 on cloud 10 / path 10, a seeded 65,536-point uniform cloud on a
50-waypoint path and a cloud with min and max ties at s ≠ 0; a mask with one
needed bit cleared fails; the word layout round-trips at ragged sizes; a
waypoint whose α or β is not finite gives NaN sums in both versions; and the
plain K3's table is held against the JAX twin's ``run_bwd_stats`` (interpret
mode). The CUDA kernels run on the card only
(``tests/test_torch_kernels_cuda.py``).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_fused_vis import EPS, GRAD, INTR, stages  # noqa: E402, F401
from test_torch_fused_vis_skip import CASES, _case  # noqa: E402
from trajectory_optimization_tpu_torch.ops import _kernels  # noqa: E402
from trajectory_optimization_tpu_torch.ops import fused_vis as fv  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread (restored afterwards): the comparisons here are bit
    for bit, as in tests/test_torch_fused_vis_skip.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cached_backward(x, g=None):
    """The cached regime's backward inputs for a case of
    test_torch_fused_vis_skip.py: the score cache, K3's table and mask, and
    norm2 with α and β."""
    g = x["g"] if g is None else g
    scores, _ = fv._scores(x["wp"], x["kp"], x["pts_t"], x["k"])
    st, need = fv.bwd_stats_ref(x["norm"], scores, x["valid"], g, EPS)
    norm2 = torch.cat([x["norm"], st[:, :2] / st[:, 2:].clamp(min=1.0)], dim=1)
    return scores, st, need, norm2


def _apply_args(x, scores, norm2, need, g=None):
    return (x["wp"], x["kp"], norm2, x["pts_t"], x["valid"], x["g"] if g is None else g, scores,
            need, x["k"])


@pytest.fixture(scope="module")
def cases(cloud10, path10):
    out = {}
    for name in CASES:
        x = _case(name, cloud10, path10)
        x["scores"], x["st"], x["need"], x["norm2"] = _cached_backward(x)
        out[name] = x
    return out


@pytest.mark.parametrize("name", CASES)
def test_masked_k4_equals_full_k4(cases, name):
    """Every pair outside the need mask adds an exact zero: the masked plain
    K4 equals the full one bit for bit, with a mask that is neither empty nor
    full."""
    x = cases[name]
    mask = fv.unpack_need(x["need"], x["scores"].shape[1])
    assert 0 < int(mask.sum()) < mask.numel()
    args = _apply_args(x, x["scores"], x["norm2"], x["need"])
    full = fv.bwd_apply_ref(*args)
    assert bool(torch.isfinite(full).all()) and bool((full != 0).any())
    assert torch.equal(fv.bwd_apply_masked_ref(*args), full)
    if name == "ties":  # min and max ties with s != 0 at every waypoint, all flagged
        eqmin, eqmax = fv._ties(x["norm"], x["scores"], x["valid"])
        assert bool((x["norm"][:, 0] > 0).all()) and bool((x["st"][:, 2:] >= 2).all())
        assert bool(mask[eqmin | eqmax].all())


@pytest.mark.parametrize("name", CASES)
def test_cleared_need_bit_changes_k4(cases, name):
    """The mask is tight where it matters: with the bit of the pair that has
    the largest term cleared, the masked K4 no longer equals the full one."""
    x = cases[name]
    total = fv._apply_total(x["norm2"], x["scores"], x["valid"], x["g"], EPS)
    flat = int(torch.argmax((total * x["scores"]).abs()))
    w, i = divmod(flat, x["scores"].shape[1])
    need = x["need"].clone()
    word = int(need[w, i // 32]) & 0xFFFFFFFF
    assert word >> (i % 32) & 1
    word &= ~(1 << (i % 32))
    need[w, i // 32] = word - (1 << 32) if word >= 1 << 31 else word
    args = _apply_args(x, x["scores"], x["norm2"], need)
    assert not torch.equal(fv.bwd_apply_masked_ref(*args), fv.bwd_apply_ref(*args))


@pytest.mark.parametrize("name", CASES)
def test_need_mask_is_the_skip_predicate_on_the_cache(cases, name):
    """``need`` is ``direct | tie`` of ``skip_masks`` (K5's predicate), taken
    on the cached scores; it does not depend on the cotangent."""
    x = cases[name]
    sk = x["masks"]  # on the plain recompute: the same bits as this cache
    N = x["scores"].shape[1]
    assert torch.equal(fv.unpack_need(x["need"], N), sk.direct | sk.tie)
    other_g = torch.as_tensor(np.random.default_rng(7).normal(size=N).astype(np.float32))
    assert torch.equal(_cached_backward(x, other_g)[2], x["need"])


@pytest.mark.parametrize("n", [31, 32, 33, 40452])
def test_pack_unpack_round_trip(n):
    """Bit l of word j is pair 32 j + l; the last word's spare bits are 0."""
    mask = torch.as_tensor(np.random.default_rng(n).random((3, n)) < 0.3)
    mask[0, -1], mask[1, :] = True, True  # the sign bit of a word, and a full row
    need = fv.pack_need(mask)
    assert need.dtype == torch.int32 and need.shape == (3, _kernels.need_words(n))
    assert torch.equal(fv.unpack_need(need, n), mask)
    for w, i in ((0, n - 1), (2, 0), (2, n // 2)):
        assert bool(int(need[w, i // 32]) >> (i % 32) & 1) == bool(mask[w, i])
    spare = 32 * need.shape[1] - n
    if spare:
        assert int(need[1, -1]) & 0xFFFFFFFF == (1 << (32 - spare)) - 1
    else:
        assert int(need[1, -1]) == -1


def test_invalid_points_are_never_ties_but_may_be_active(cases):
    """A point with valid = 0 is no tie (its bit is clear unless it is active
    or not finite), yet inside the clip window it is flagged: the plain
    version's window ignores ``valid``. A NaN or inf score is always flagged."""
    x = cases["ties"]
    W, N = x["scores"].shape
    valid = x["valid"].clone()
    valid[: 4 * W] = 0  # the duplicated extreme points: the ties with s != 0
    scores = x["scores"].clone()
    scores[0, 100], scores[1, 101] = float("nan"), float("inf")
    _, need = fv.bwd_stats_ref(x["norm"], scores, valid, x["g"], EPS)
    mask = fv.unpack_need(need, N)
    pn_raw = (scores - x["norm"][:, 0:1]) * x["norm"][:, 1:2]
    active = (pn_raw > 0.5) & (pn_raw < 1.0 - EPS)
    eqmin, eqmax = fv._ties(x["norm"], scores, torch.ones_like(valid))
    dropped = (eqmin | eqmax)[:, : 4 * W] & ~active[:, : 4 * W]
    assert bool(dropped.any()) and not bool(mask[:, : 4 * W][dropped].any())
    assert bool(active[:, : 4 * W].any()) and bool(mask[:, : 4 * W][active[:, : 4 * W]].all())
    assert bool(mask[0, 100]) and bool(mask[1, 101])


@pytest.mark.parametrize("what", ["alpha_inf", "alpha_nan", "beta_neg_inf", "g_nan"])
def test_non_finite_alpha_or_beta_gives_nan_sums_in_both(cases, what):
    """α·1[s = m] is α·0 = NaN for every pair of a waypoint whose α is not
    finite (β likewise), flagged or not, so the full K4 returns NaN for all
    12 sums of that waypoint; the masked K4 marks them NaN by rule, and the
    other waypoints stay bit-equal. A NaN cotangent at an active pair reaches
    α through K3 and gives the same pattern."""
    x = cases["cloud10"]
    g, norm2, need = x["g"], x["norm2"].clone(), x["need"]
    if what == "g_nan":
        mask = fv.unpack_need(need, x["scores"].shape[1])
        i = int(torch.nonzero(mask[3] & (x["valid"] > 0))[0])
        g = g.clone()
        g[i] = float("nan")
        _, st, need, norm2 = _cached_backward(x, g)
        assert bool(torch.isnan(st[3, :2]).all())
    else:
        col, value = {"alpha_inf": (4, float("inf")), "alpha_nan": (4, float("nan")),
                      "beta_neg_inf": (5, float("-inf"))}[what]
        norm2[3, col] = value
    args = _apply_args(x, x["scores"], norm2, need, g)
    full, masked = fv.bwd_apply_ref(*args), fv.bwd_apply_masked_ref(*args)
    assert bool(torch.isnan(full[3]).all())
    assert torch.equal(torch.isnan(masked), torch.isnan(full))
    ok = ~torch.isnan(full)
    assert torch.equal(masked[ok], full[ok])
    # one waypoint is hit, or (a point's NaN cotangent) each one that has it in its window
    assert int(ok.sum()) == 12 * (len(full) - 1) if what != "g_nan" else int(ok.sum()) >= 12
    # the rule is needed: without it a waypoint with an empty mask would keep zeros
    empty = torch.zeros_like(need)
    assert bool(torch.isnan(fv.bwd_apply_masked_ref(*args[:7], empty, x["k"])[3]).all())


def test_bwd_stats_table_matches_pallas_stage(stages):
    """The plain K3's table, now returned beside the mask, against the JAX
    twin's ``run_bwd_stats`` in interpret mode: sums rtol 2e-3 / atol 2e-3,
    tie counts exactly."""
    jx, tt = stages
    norm, scores = torch.as_tensor(jx["norm"]), torch.as_tensor(jx["scores"])
    st, need = fv.bwd_stats_ref(norm, scores, tt["valid"], tt["g"], EPS)
    np.testing.assert_allclose(st[:, :2].numpy(), jx["st"][:, :2], **GRAD)
    np.testing.assert_array_equal(st[:, 2:].numpy(), jx["st"][:, 2:])
    # and K4 restricted to that mask still matches the twin's K4
    args = (tt["wp"], tt["kp"], torch.as_tensor(jx["norm2"]), tt["pts_t"], tt["valid"], tt["g"],
            scores, need, tt["k"])
    np.testing.assert_allclose(fv.bwd_apply_masked_ref(*args).numpy(), jx["sums"], **GRAD)


def test_cached_backward_wrappers_take_plain_versions_on_cpu(cases, monkeypatch):
    """On CPU tensors ``bwd_stats`` and ``bwd_apply`` are the plain versions
    (no launch), the kernels' wrappers refuse CPU tensors, and ``need`` is
    checked for type and shape."""
    x = cases["cloud10"]
    _kernels.reset_launches()
    st, need = fv.bwd_stats(x["norm"], x["scores"], x["valid"], x["g"], EPS)
    assert torch.equal(st, x["st"]) and torch.equal(need, x["need"])
    args = _apply_args(x, x["scores"], x["norm2"], need)
    assert torch.equal(fv.bwd_apply(*args), fv.bwd_apply_ref(*args))
    assert all(n == 0 for n in _kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA tensor"):
        _kernels.bwd_stats(x["norm"], x["scores"], x["valid"], x["g"], EPS)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _kernels.bwd_apply(*args)
    for bad in (need[:, :-1], need.long()):
        with pytest.raises(ValueError, match="need"):
            fv.bwd_apply_ref(*args[:7], bad, x["k"])


def test_fused_lo_sum_backward_hands_k3s_mask_to_k4(cases, monkeypatch):
    """``FusedLoSum.backward`` passes K3's ``need`` on to K4 unchanged."""
    x = cases["cloud10"]
    seen = {}
    stats, apply = fv.bwd_stats, fv.bwd_apply

    def spy_stats(*args):
        seen["stats"] = stats(*args)
        return seen["stats"]

    def spy_apply(*args):
        seen["need"] = args[7]
        return apply(*args)

    monkeypatch.setattr(fv, "bwd_stats", spy_stats)
    monkeypatch.setattr(fv, "bwd_apply", spy_apply)
    wp = x["wp"].clone().requires_grad_(True)
    lo = fv.FusedLoSum.apply(wp, x["kp"], x["pts_t"], x["valid"], x["k"])
    (grad,) = torch.autograd.grad(lo, wp, x["g"])
    assert seen["need"] is seen["stats"][1] and torch.equal(seen["need"], x["need"])
    assert bool(torch.isfinite(grad).all()) and bool((grad != 0).any())
