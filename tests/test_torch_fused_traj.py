"""The kernel backend's fused trajectory loss (ops/fused_traj.py) on the CPU:
its plain stages, forward and hand-derived backward, against autograd
through the plain path it replaces (``fused_lo_sum``'s stages, then
``models.traj.traj_criterion``), in float64 and float32, on cloud 10 and
its edge cases, in both cache regimes."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from trajectory_optimization_tpu_torch.models import traj as tt  # noqa: E402
from trajectory_optimization_tpu_torch.ops import fused_traj as ft  # noqa: E402
from trajectory_optimization_tpu_torch.ops import fused_vis as fv  # noqa: E402
from trajectory_optimization_tpu_torch.utils.data import TRAJ_CASES, traj_case  # noqa: E402
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

INTR = default_intrinsics()
SCALARS = ("mean_reward", "loss_vis", "loss_l2", "loss_smooth", "loss_length")
# The forward repeats the plain path's operations (equal values here); in
# the backward only the order of a few roundings differs between the chain
# rule written out and autograd's: under 3e-15 (float64) and 8e-7 (float32)
# of the largest entry of each gradient on these cases.
TOL = {torch.float64: dict(rtol=1e-12, grad=1e-12), torch.float32: dict(rtol=1e-6, grad=5e-6)}


def _problem(step):
    return tt.TrajProblem(INTR.width, INTR.height, smoothness_weight=28.0, wps_step=step,
                          backend="kernel")


def _tensors(case, dtype):
    pts, valid, poses, quats, p0, q0, step = case
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    return t(pts), t(valid), t(poses), t(quats), t(p0), INTR.matrix(dtype=dtype), step


def _plain(case, dtype):
    """Autograd through today's plain path: fused_lo_sum's stages (their plain
    versions on the CPU) and traj_criterion."""
    P, V, poses, quats, p0, K, step = _tensors(case, dtype)
    prob = _problem(step)
    params = {"poses": poses.requires_grad_(True), "quats": quats.requires_grad_(True)}
    sel = slice(None, None, step)
    lo = fv.fused_lo_sum(P, params["quats"][sel], params["poses"][sel], K, prob.img_width,
                         prob.img_height, min_dist=prob.min_dist, max_dist=prob.max_dist,
                         eps=prob.eps, valid=V)
    loss, aux = tt.traj_criterion(lo, params, p0, prob, valid=V)
    grads = torch.autograd.grad(loss, [params["poses"], params["quats"]])
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def _fused(case, dtype):
    P, V, poses, quats, p0, K, step = _tensors(case, dtype)
    params = {"poses": poses.requires_grad_(True), "quats": quats.requires_grad_(True)}
    loss, aux = ft.fused_traj(params, P, K, p0, _problem(step), valid=V)
    grads = torch.autograd.grad(loss, [params["poses"], params["quats"]])
    return loss.detach(), aux, grads


@pytest.fixture(params=["cached", "uncached"])
def regime(request, monkeypatch):
    if request.param == "uncached":
        monkeypatch.setattr(fv, "SCORE_CACHE_MAX_BYTES", 0)
    return request.param


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", TRAJ_CASES)
def test_fused_traj_matches_autograd_through_the_plain_path(cloud10, path10, name, dtype,
                                                            regime):
    """Loss, each aux scalar, the rewards and both gradients."""
    case = traj_case(name, cloud10, path10)
    loss_p, aux_p, grads_p = _plain(case, dtype)
    loss_f, aux_f, grads_f = _fused(case, dtype)
    tol = TOL[dtype]
    torch.testing.assert_close(loss_f, loss_p, rtol=tol["rtol"], atol=0)
    torch.testing.assert_close(aux_f["rewards"], aux_p["rewards"], rtol=tol["rtol"], atol=0)
    for k in SCALARS:
        torch.testing.assert_close(aux_f[k], aux_p[k], rtol=tol["rtol"], atol=0)
    for got, want in zip(grads_f, grads_p):
        assert torch.isfinite(want).all()
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=tol["grad"] * scale)
    if name == "initial":  # the anchor and the length difference are exactly 0
        assert float(aux_f["loss_l2"]) == 0.0 and float(aux_f["loss_length"]) == 0.0
    if name == "blind":
        P, V, poses, quats, _, K, step = _tensors(case, dtype)
        wp, kp = ft.traj_head_ref(poses, quats, K, step)
        k = fv.make_consts(INTR.width, INTR.height, 1.0, 5.0, 1e-6)
        m, mx, _ = fv.pass_a_ref(wp, kp, P.t().contiguous(), V, k)
        assert float(fv.make_norm(m, mx)[4, 2]) == 0.0  # the floor's gate is closed


@pytest.mark.parametrize("name", ["moved", "w1", "w2", "step3", "padded"])
def test_traj_forward_kernel_backend_is_the_fused_loss(cloud10, path10, name, regime):
    """``traj_forward`` on the kernel backend runs ``fused_traj``: equal
    outputs and gradients."""
    case = traj_case(name, cloud10, path10)
    P, V, poses, quats, p0, K, step = _tensors(case, torch.float32)
    outs = []
    for fn in (lambda p: tt.traj_forward(p, P, K, p0, None, _problem(step), valid=V),
               lambda p: ft.fused_traj(p, P, K, p0, _problem(step), valid=V)):
        params = {"poses": poses.clone().requires_grad_(True),
                  "quats": quats.clone().requires_grad_(True)}
        loss, aux = fn(params)
        outs.append((loss, aux, torch.autograd.grad(loss, list(params.values()))))
    (la, aa, ga), (lb, ab, gb) = outs
    assert torch.equal(la, lb) and all(torch.equal(aa[k], ab[k]) for k in aa)
    assert aa.keys() == set(SCALARS) | {"rewards"}
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))


def test_aux_and_rewards_are_not_differentiable(cloud10, path10):
    """Only the loss carries a gradient; the aux scalars and the rewards are
    marked non-differentiable."""
    P, V, poses, quats, p0, K, step = _tensors(traj_case("moved", cloud10, path10), torch.float32)
    params = {"poses": poses.requires_grad_(True), "quats": quats.requires_grad_(True)}
    loss, aux = ft.fused_traj(params, P, K, p0, _problem(step), valid=V)
    assert loss.requires_grad
    assert not any(v.requires_grad for v in aux.values())
    with torch.no_grad():
        loss_ng, aux_ng = ft.fused_traj(params, P, K, p0, _problem(step), valid=V)
    assert torch.equal(loss_ng, loss.detach())


@pytest.mark.parametrize("scale", [1.0, -2.5])
def test_backward_scales_with_the_loss_cotangent(cloud10, path10, scale):
    """A cotangent c on the loss gives c times the gradients."""
    P, V, poses, quats, p0, K, step = _tensors(traj_case("moved", cloud10, path10), torch.float64)
    grads = []
    for c in (1.0, scale):
        params = {"poses": poses.clone().requires_grad_(True),
                  "quats": quats.clone().requires_grad_(True)}
        loss, _ = ft.fused_traj(params, P, K, p0, _problem(step), valid=V)
        grads.append(torch.autograd.grad(loss, list(params.values()),
                                         grad_outputs=torch.tensor(c, dtype=torch.float64)))
    for a, b in zip(*grads):
        torch.testing.assert_close(b, scale * a, rtol=1e-12, atol=1e-15)


def test_stage_shapes(cloud10, path10):
    """The stages' shapes: wp (W_s, 12), kp (4,), norm (W_s, 4), aux
    (AUX_SLOTS,), norm2 (W_s, 6); the tail takes K4's sums or K5's
    accumulator and gives the same gradients."""
    P, V, poses, quats, p0, K, step = _tensors(traj_case("moved", cloud10, path10), torch.float64)
    W_s = ft.n_scored(len(poses), step)
    wp, kp = ft.traj_head_ref(poses, quats, K, step)
    assert wp.shape == (W_s, 12) and kp.shape == (4,)
    k = fv.make_consts(INTR.width, INTR.height, 1.0, 5.0, 1e-6)
    Pt = P.t().contiguous()
    m, mx, scores = fv.pass_a_ref(wp, kp, Pt, V, k)
    norm = ft.make_norm_ref(torch.stack([m, mx]))
    assert norm.shape == (W_s, 4)
    c = ft.make_traj_consts(_problem(step))
    loss, aux, rewards = ft.traj_loss_ref(fv.pass_b_ref(norm, scores, k.eps), V, poses, p0, c)
    assert loss.shape == () and aux.shape == (ft.AUX_SLOTS,) and rewards.shape == V.shape
    g_loss = torch.tensor(1.0, dtype=torch.float64)
    g = ft.lo_cotangent_ref(g_loss, fv.pass_b_ref(norm, scores, k.eps), rewards, V, aux)
    stats, need = fv.bwd_stats_ref(norm, scores, V, g, k.eps)
    norm2 = ft.alpha_beta_ref(stats, norm)
    assert norm2.shape == (W_s, 6)
    sums = fv.bwd_apply_ref(wp, kp, norm2, Pt, V, g, scores, need, k)
    acc = fv.bwd_fused_acc_ref(wp, kp, norm, Pt, V, g, k)
    a = ft.traj_tail_ref(sums, wp, quats, poses, p0, aux, g_loss, c)
    b = ft.traj_tail_ref(acc, wp, quats, poses, p0, aux, g_loss, c)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-9, atol=1e-12)
    assert a[0].shape == poses.shape and a[1].shape == quats.shape


def test_cpu_auto_backend_keeps_the_plain_route(cloud10, path10):
    """CPU tensors under ``backend="auto"`` resolve to the plain path, as
    before: the criterion's autograd, not the fused loss."""
    P = torch.as_tensor(cloud10[:64])
    prob = dataclasses.replace(_problem(2), backend="auto")
    assert tt._resolve_backend(prob, P) == "torch"


def test_stages_take_plain_versions_on_cpu(cloud10, path10):
    """On CPU tensors every stage runs its plain version and launches
    nothing; the kernels' wrappers refuse a CPU tensor before any build."""
    from trajectory_optimization_tpu_torch.ops import _kernels

    P, V, poses, quats, p0, K, step = _tensors(traj_case("moved", cloud10, path10),
                                               torch.float32)
    c = ft.make_traj_consts(_problem(step))
    _kernels.reset_launches()
    wp, kp, preset = ft.traj_head(poses, quats, K, step)
    assert preset is None
    assert all(torch.equal(a, b) for a, b in zip((wp, kp), ft.traj_head_ref(poses, quats, K, step)))
    minmax = torch.stack([wp[:, 0], wp[:, 0] + 1.0])
    assert torch.equal(ft.make_norm(minmax), ft.make_norm_ref(minmax))
    lo = torch.linspace(-3.0, 3.0, len(V))
    got, want = ft.traj_loss(lo, V, poses, p0, c), ft.traj_loss_ref(lo, V, poses, p0, c)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    g_loss, aux, rewards = torch.tensor(1.0), got[1], got[2]
    assert torch.equal(ft.lo_cotangent(g_loss, lo, rewards, V, aux),
                       ft.lo_cotangent_ref(g_loss, lo, rewards, V, aux))
    stats = torch.rand(len(wp), 4)
    assert torch.equal(ft.alpha_beta(stats, minmax.t().repeat(1, 2)),
                       ft.alpha_beta_ref(stats, minmax.t().repeat(1, 2)))
    sums = torch.rand(len(wp), 3, 4)
    got = ft.traj_tail(sums, wp, quats, poses, p0, aux, g_loss, c)
    want = ft.traj_tail_ref(sums, wp, quats, poses, p0, aux, g_loss, c)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(n == 0 for n in _kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA tensor"):
        _kernels.traj_head(poses, quats, K, step)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _kernels.traj_loss(lo, V, poses, p0, c)
