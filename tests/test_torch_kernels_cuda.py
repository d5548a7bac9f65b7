"""The port's hand-written CUDA kernels (K1–K4 and the uncached regime's K1′,
K2′ and K5, csrc/fused_vis.cu) against their plain PyTorch versions, on the
card.

Every test here needs a CUDA card and is marked ``cuda``; without one each
skips (the kernels have no CPU mode). The file imports neither JAX nor the
JAX package and uses no conftest fixture, so it runs on a machine without
JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from trajectory_optimization_tpu_torch.models.traj import observation_logodds  # noqa: E402
from trajectory_optimization_tpu_torch.ops import _kernels  # noqa: E402
from trajectory_optimization_tpu_torch.ops import fused_vis as fv  # noqa: E402
from trajectory_optimization_tpu_torch.ops import quat as quat_ops  # noqa: E402
from trajectory_optimization_tpu_torch.ops.scores import waypoint_scores  # noqa: E402
from trajectory_optimization_tpu_torch.utils.data import (  # noqa: E402
    identity_quaternions,
    load_path,
    load_point_cloud,
    pad_points,
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
    # FMA contraction: not bit-equal. atol 1e-30 absorbs denormal minima only.
    _close(m, m_r, rtol=1e-5, atol=1e-30)
    _close(mx, mx_r, rtol=1e-5, atol=1e-30)
    _close(cache, cache_r, rtol=1e-5, atol=1e-7)
    # the min/max are taken over exactly the cached values
    ok = x["V"] > 0
    assert torch.equal(m, torch.where(ok, cache, torch.full_like(cache, 3e38)).amin(1))
    assert torch.equal(mx, torch.where(ok, cache, torch.full_like(cache, -3e38)).amax(1))


def test_later_stages_match_plain(inputs):
    x = inputs
    m, mx, cache = _kernels.pass_a(x["wp"], x["kp"], x["Pt"], x["V"], x["k"])
    norm = fv.make_norm(m, mx)
    _close(_kernels.pass_b(norm, cache, EPS), fv.pass_b_ref(norm, cache, EPS), **FWD)
    st = _kernels.bwd_stats(norm, cache, x["V"], x["g"], EPS)
    st_r = fv.bwd_stats_ref(norm, cache, x["V"], x["g"], EPS)
    _close(st[:, :2], st_r[:, :2], **GRAD)
    assert torch.equal(st[:, 2:], st_r[:, 2:])  # same cache and norm: exact tie counts
    norm2 = torch.cat([norm, (st[:, :2] / st[:, 2:].clamp(min=1.0))], dim=1).contiguous()
    args = (x["wp"], x["kp"], norm2, x["Pt"], x["V"], x["g"], cache, x["k"])
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
    st = _kernels.bwd_stats(norm, cache, x["V"], x["g"], EPS)
    assert torch.equal(acc[:, 38:], st[:, 2:])  # K3's tie counts, exactly
    norm2 = torch.cat([norm, (st[:, :2] / st[:, 2:].clamp(min=1.0))], dim=1).contiguous()
    sums = _kernels.bwd_apply(x["wp"], x["kp"], norm2, x["Pt"], x["V"], x["g"], cache, x["k"])
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


def test_wrappers_reject_bad_inputs(inputs):
    x = inputs
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.pass_a(x["wp"], x["kp"], x["P"].t(), x["V"], x["k"])
    with pytest.raises(ValueError, match="float32"):
        _kernels.pass_a(x["wp"].double(), x["kp"], x["Pt"], x["V"], x["k"])
