"""The pairs that K5 and K2′ skip add only exact zeros.

K5 (``bwd_fused_kernel``) runs a pair's gradient chain only where its warp
votes that some lane needs it, and K2′ (``pass_b_recompute_kernel``) takes
the divide and the log only above the 0.5 clip floor. The plain helper
``fused_vis.skip_masks`` gives those predicates per pair. Here the plain K5
with every term outside its masks zeroed, and the plain K2′ summing only the
unclipped pairs, are held ``torch.equal`` to the full plain versions on three
inputs: cloud 10 / path 10, a seeded uniform cloud on a 50-waypoint path
(the 8,388,608 × 50 shape of ``chip_smoke.py``, cut to 65,536 points), and a
cloud in view of every waypoint (m_w > 0) with duplicated points at each
waypoint's minimum and maximum (ties with s ≠ 0). The last is also held
against the JAX twin's uncached stages (interpret mode). The CUDA kernels
run on the card only (``tests/test_torch_kernels_cuda.py``).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from test_torch_fused_vis import EPS, FWD, INTR, _rot_quats  # noqa: E402
from test_torch_fused_vis_uncached import _assert_acc_close, _jax_uncached  # noqa: E402
from trajectory_optimization_tpu_torch.ops import fused_vis as fv  # noqa: E402
from trajectory_optimization_tpu_torch.ops import quat as quat_ops  # noqa: E402
from trajectory_optimization_tpu_torch.utils.data import in_view_case, pad_points  # noqa: E402

CASES = ["cloud10", "uniform65k", "ties"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread (restored afterwards): the comparisons here are bit
    for bit, as in tests/test_torch_fused_vis_uncached.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tensors(pts, quats, trans, valid, g):
    q = torch.as_tensor(quats)
    R = quat_ops.to_matrix(quat_ops.normalize(q))
    K = INTR.matrix()
    return dict(
        wp=torch.cat([R.reshape(len(q), 9), torch.as_tensor(trans)], dim=1).contiguous(),
        kp=torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).contiguous(),
        pts_t=torch.as_tensor(np.ascontiguousarray(pts.T)), valid=torch.as_tensor(valid),
        g=torch.as_tensor(g), k=fv.make_consts(INTR.width, INTR.height, 1.0, 5.0, EPS),
    )


def _tie_case_arrays():
    """Points in view of 6 close waypoints (m_w > 0), with two copies of
    each waypoint's lowest- and highest-scoring point put first: 8,192 in
    all, a whole number of the JAX kernels' tiles. The box reaches the
    optical axis (lo = (0, 0, 2)), so fewer pairs lie in the clip window
    than in the default box and the sums held against JAX cancel less."""
    pts, quats, trans = in_view_case(8192 - 4 * 6, 6, lo=(0, 0, 2))
    tt = _tensors(pts, quats, trans, np.ones(len(pts), np.float32), np.zeros(len(pts), np.float32))
    tied = fv.with_extreme_ties(tt["wp"], tt["kp"], tt["pts_t"], tt["k"])
    return np.ascontiguousarray(tied.numpy().T), quats, trans


def _case(name, cloud10, path10):
    if name == "cloud10":
        pts, valid = pad_points(cloud10)
        quats, trans = _rot_quats(len(path10))[::2], path10[::2]
    elif name == "uniform65k":
        pts = np.random.default_rng(8).uniform(-20, 20, size=(65536, 3)).astype(np.float32)
        t = np.linspace(0, 1, 50, dtype=np.float32)
        trans = np.stack([30 * t, 10 * np.sin(4 * t), np.zeros_like(t)], axis=1).astype(np.float32)
        quats, valid = _rot_quats(50), np.ones(len(pts), np.float32)
    else:
        pts, quats, trans = _tie_case_arrays()
        valid = np.ones(len(pts), np.float32)
    g = (np.random.default_rng(1).normal(size=len(pts)) * valid).astype(np.float32)
    tt = _tensors(pts, quats, trans, valid, g)
    m, mx = fv.pass_a_minmax_ref(tt["wp"], tt["kp"], tt["pts_t"], tt["valid"], tt["k"])
    tt["norm"] = fv.make_norm(m, mx)
    tt["masks"] = fv.skip_masks(tt["wp"], tt["kp"], tt["norm"], tt["pts_t"], tt["valid"], tt["k"])
    return tt


@pytest.fixture(scope="module")
def cases(cloud10, path10):
    return {name: _case(name, cloud10, path10) for name in CASES}


def _assert_partial(mask):
    assert 0 < int(mask.sum()) < mask.numel()


@pytest.mark.parametrize("name", CASES)
def test_k5_skips_only_zero_terms(cases, name):
    """The plain K5 with each channel's cotangent zeroed outside its mask
    (the direct channel and slots 36/37 outside ``direct``, the tie channels
    outside ``tie``) equals the full plain K5 bit for bit."""
    x = cases[name]
    wp, kp, norm, pts_t, valid, g, k = (x[n] for n in ("wp", "kp", "norm", "pts_t", "valid", "g", "k"))
    sk = x["masks"]
    _assert_partial(sk.direct | sk.tie)
    s, e = fv._scores(wp, kp, pts_t, k)
    c_pn, dm, dM, eqmin, eqmax = fv._minmax_pathway(norm, s, valid, g, k.eps)

    def keep(mask, t):
        return torch.where(mask, t, torch.zeros_like(t))

    channels = [fv._plane_sums(fv._dcam(cot, s, e, k), pts_t)
                for cot in (keep(sk.direct, c_pn * norm[:, 1:2]), keep(sk.tie, eqmin),
                            keep(sk.tie, eqmax))]
    tail = torch.stack([keep(sk.direct, dm).sum(1), keep(sk.direct, dM).sum(1), eqmin.sum(1),
                        eqmax.sum(1)], dim=1)
    full = fv.bwd_fused_acc_ref(wp, kp, norm, pts_t, valid, g, k)
    assert torch.equal(torch.cat([*channels, tail], dim=1), full)
    if name == "ties":  # min and max ties with s != 0 at every waypoint
        assert not bool(torch.isnan(s).any()) and bool((norm[:, 0] > 0).all())
        assert bool((full[:, 38] >= 2).all()) and bool((full[:, 39] >= 2).all())
        assert bool(sk.tie.any(dim=1).all())


@pytest.mark.parametrize("name", CASES)
def test_k2p_skips_only_zero_terms(cases, name):
    """The plain K2′ summing only the pairs above the 0.5 clip floor equals
    the full plain K2′ bit for bit."""
    x = cases[name]
    sk = x["masks"]
    _assert_partial(sk.unclipped)
    s, _ = fv._scores(x["wp"], x["kp"], x["pts_t"], x["k"])
    pn = torch.clamp((s - x["norm"][:, 0:1]) * x["norm"][:, 1:2], 0.5, 1.0 - EPS)
    terms = torch.log(pn / (1.0 - pn))
    lo = torch.sum(torch.where(sk.unclipped, terms, torch.zeros_like(terms)), dim=0)
    assert torch.equal(lo, fv.pass_b_recompute_ref(x["wp"], x["kp"], x["norm"], x["pts_t"], x["k"]))


def test_tie_case_matches_pallas():
    """Ties with s ≠ 0 through the plain K1′, K2′ and K5 against the JAX
    twin's uncached stages: min/max, lo at the forward bound, K5's sums at the
    gradient bound and its tie counts exactly."""
    pts, quats, trans = _tie_case_arrays()
    valid = np.ones(len(pts), np.float32)
    g = np.random.default_rng(1).normal(size=len(pts)).astype(np.float32)
    jx, tt = _jax_uncached(pts, quats, trans, valid, g)
    m, mx = fv.pass_a_minmax_ref(tt["wp"], tt["kp"], tt["pts_t"], tt["valid"], tt["k"])
    np.testing.assert_allclose(m.numpy(), jx["m"], rtol=1e-5)
    np.testing.assert_allclose(mx.numpy(), jx["mx"], rtol=1e-5)
    norm = fv.make_norm(m, mx)
    lo = fv.pass_b_recompute_ref(tt["wp"], tt["kp"], norm, tt["pts_t"], tt["k"])
    np.testing.assert_allclose(lo.numpy(), jx["lo"], **FWD)
    acc = fv.bwd_fused_acc_ref(tt["wp"], tt["kp"], norm, tt["pts_t"], tt["valid"], tt["g"],
                               tt["k"]).numpy()
    _assert_acc_close(acc, jx["acc"], tt)
    assert (acc[:, 38] >= 2).all() and (jx["acc"][:, 38] >= 2).all()
