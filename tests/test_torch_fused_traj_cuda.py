"""The trajectory loss's hand-written kernels (csrc/fused_traj.cu) on the
card: each against its plain version (ops/fused_traj.py ``*_ref``) on the
same inputs, the whole fused loss against autograd through the plain path
it replaces, and what a captured step launches.

Every test here needs a CUDA card and is marked ``cuda``; without one each
skips (the kernels have no CPU mode; tests/test_torch_fused_traj.py holds
the plain versions on the CPU). The file imports neither JAX nor the JAX
package and uses no conftest fixture:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_traj_cuda.py
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from trajectory_optimization_tpu_torch.models import traj as tt  # noqa: E402
from trajectory_optimization_tpu_torch.ops import _kernels  # noqa: E402
from trajectory_optimization_tpu_torch.ops import fused_traj as ft  # noqa: E402
from trajectory_optimization_tpu_torch.ops import fused_vis as fv  # noqa: E402
from trajectory_optimization_tpu_torch.opt import engine as te  # noqa: E402
from trajectory_optimization_tpu_torch.opt import graphs as tg  # noqa: E402
from trajectory_optimization_tpu_torch.opt import runners as tr  # noqa: E402
from trajectory_optimization_tpu_torch.utils.data import (  # noqa: E402
    TRAJ_CASES,
    identity_quaternions,
    load_path,
    load_point_cloud,
    pad_points,
    traj_case,
)
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

pytestmark = pytest.mark.cuda

DATA = Path(__file__).resolve().parents[1] / "data"
INTR = default_intrinsics()
NEW = ("traj_head", "make_norm", "traj_loss", "lo_cotangent", "alpha_beta", "traj_tail")
UNCACHED_NEW = ("traj_head", "make_norm", "traj_loss", "lo_cotangent", "traj_tail")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def reference():
    return (load_point_cloud(str(DATA / "points/point_cloud_10.npz")),
            load_path(str(DATA / "paths/path_poses_10.npz")))


@pytest.fixture(params=["cached", "uncached"])
def regime(request, monkeypatch):
    if request.param == "uncached":
        monkeypatch.setattr(fv, "SCORE_CACHE_MAX_BYTES", 0)
    return request.param


def _problem(step):
    return tt.TrajProblem(INTR.width, INTR.height, smoothness_weight=28.0, wps_step=step,
                          backend="kernel")


def _inputs(dev, name, reference):
    cloud, path = reference
    if name == "full":  # cloud 10 as the facade pads it, the path as the node moves it
        pts, valid = pad_points(cloud)
        case = traj_case("moved", cloud, path)
        case = (pts, valid, *case[2:])
    else:
        case = traj_case(name, cloud, path)
    pts, valid, poses, quats, p0, _, step = case
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    P = t(pts)
    return dict(P=P, Pt=P.t().contiguous(), V=t(valid), poses=t(poses), quats=t(quats),
                p0=t(p0), K=INTR.matrix(device=dev), step=step)


def _close(got, want, rel, what):
    torch.cuda.synchronize()
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=0, atol=rel * max(scale, 1e-30), msg=what)


@pytest.mark.parametrize("name", ("full",) + TRAJ_CASES)
def test_kernels_match_their_plain_versions(dev, reference, name, regime):
    """Every stage on the card against its plain version on the same inputs:
    bit for bit where the plain version rounds the same operations
    (traj_head, make_norm, alpha_beta, the rewards), the rest within stated
    bounds."""
    x = _inputs(dev, name, reference)
    c = ft.make_traj_consts(_problem(x["step"]))
    k = fv.make_consts(INTR.width, INTR.height, 1.0, 5.0, 1e-6)
    wp, kp, minmax = _kernels.traj_head(x["poses"], x["quats"], x["K"], x["step"])
    wp_r, kp_r = ft.traj_head_ref(x["poses"], x["quats"], x["K"], x["step"])
    assert torch.equal(wp, wp_r)  # R as quat.to_matrix(quat.normalize(q)) rounds it
    assert torch.equal(kp, kp_r)
    assert torch.equal(minmax, torch.tensor([[_kernels.BIG], [-_kernels.BIG]],
                                            device=dev).expand_as(minmax))
    cached = fv.uses_score_cache(wp.shape[0], x["P"].shape[0])
    if cached:
        scores = _kernels.pass_a(wp, kp, x["Pt"], x["V"], k, minmax=minmax)[2]
    else:
        _kernels.pass_a_minmax(wp, kp, x["Pt"], x["V"], k, minmax=minmax)
    norm = _kernels.make_norm(minmax)
    assert torch.equal(norm, ft.make_norm_ref(minmax))
    lo = fv.pass_b(norm, scores, k.eps) if cached else fv.pass_b_recompute(wp, kp, norm,
                                                                         x["Pt"], k)
    loss, aux, rewards = _kernels.traj_loss(lo, x["V"], x["poses"], x["p0"], c)
    loss_r, aux_r, rewards_r = ft.traj_loss_ref(lo, x["V"], x["poses"], x["p0"], c)
    assert torch.equal(rewards, rewards_r)
    # sums in double against PyTorch's f32 reductions: the mean's, the angles'
    # and the lengths' (the length difference keeps the lengths' absolute
    # error: a few ulp of a path of 13 m, of 2 km where a waypoint is 1 km out)
    torch.testing.assert_close(aux[:7], aux_r[:7], rtol=2e-6, atol=1e-7)
    torch.testing.assert_close(aux[7], aux_r[7], rtol=1e-6, atol=2e-5)
    torch.testing.assert_close(loss, loss_r, rtol=2e-6, atol=0)
    g_loss = torch.tensor(1.0, device=dev)
    g = _kernels.lo_cotangent(g_loss, lo, rewards, x["V"], aux)
    torch.testing.assert_close(g, ft.lo_cotangent_ref(g_loss, lo, rewards, x["V"], aux),
                               rtol=1e-6, atol=0)
    if cached:
        stats, need = fv.bwd_stats(norm, scores, x["V"], g, k.eps)
        norm2 = _kernels.alpha_beta(stats, norm)
        assert torch.equal(norm2, ft.alpha_beta_ref(stats, norm))
        sums = fv.bwd_apply(wp, kp, norm2, x["Pt"], x["V"], g, scores, need, k)
    else:
        sums = fv.bwd_fused_acc(wp, kp, norm, x["Pt"], x["V"], g, k)
    got = _kernels.traj_tail(sums, wp, x["quats"], x["poses"], x["p0"], aux, g_loss, c)
    want = ft.traj_tail_ref(sums, wp, x["quats"], x["poses"], x["p0"], aux, g_loss, c)
    for a, b, what in zip(got, want, ("poses", "quats")):
        assert torch.isfinite(a).all()
        _close(a, b, 2e-5, f"traj_tail {what}")


@pytest.mark.parametrize("name", ("full",) + TRAJ_CASES)
def test_tail_criterion_gradients_match_their_plain_version(dev, reference, name):
    """traj_tail on zero camera-plane sums: the anchor, smoothness and length
    gradients alone (beside the visibility gradient they are small, so the
    tail's bound above would not see them), against criterion_grads_ref,
    within 1e-4 of their largest entry (the initial, nearly straight path
    reads 1.8e-5: the angle's gradient there is 1/sqrt(1 - cos^2) at cos
    near -1; leaving out the length term moves it by 6e-3 or more, the
    anchor or smoothness term by 0.1 or more); the quaternions' gradient 0."""
    x = _inputs(dev, name, reference)
    c = ft.make_traj_consts(_problem(x["step"]))
    wp, _, _ = _kernels.traj_head(x["poses"], x["quats"], x["K"], x["step"])
    aux = ft.traj_loss_ref(torch.zeros(8, device=dev), torch.ones(8, device=dev), x["poses"],
                           x["p0"], c)[1]
    zero = torch.zeros((wp.shape[0], 3, 4), device=dev)
    g_loss = torch.tensor(1.0, device=dev)
    g_poses, g_quats = _kernels.traj_tail(zero, wp, x["quats"], x["poses"], x["p0"], aux,
                                          g_loss, c)
    want = ft.criterion_grads_ref(g_loss, x["poses"], x["p0"], aux, c)
    assert torch.isfinite(g_poses).all()
    _close(g_poses, want, 1e-4, "criterion gradients")
    assert torch.equal(g_quats, torch.zeros_like(g_quats))


@pytest.mark.parametrize("name", ("full", "moved", "w1", "w2", "step3", "padded", "blind"))
def test_fused_loss_matches_autograd_through_the_plain_path(dev, reference, name, regime):
    """The whole fused loss on the card against autograd through
    ``fused_lo_sum`` and ``traj_criterion`` on the card (the bounds of
    tests/test_torch_fused_traj.py's float32 cases, the gradients at 20 times
    theirs: K4's and K5's f32 sums come in another order)."""
    x = _inputs(dev, name, reference)
    prob = _problem(x["step"])
    out = []
    for fused in (True, False):
        params = {"poses": x["poses"].clone().requires_grad_(True),
                  "quats": x["quats"].clone().requires_grad_(True)}
        if fused:
            loss, aux = ft.fused_traj(params, x["P"], x["K"], x["p0"], prob, valid=x["V"],
                                      points_t=x["Pt"])
        else:
            sel = slice(None, None, x["step"])
            lo = fv.fused_lo_sum(x["P"], params["quats"][sel], params["poses"][sel], x["K"],
                                 prob.img_width, prob.img_height, valid=x["V"],
                                 points_t=x["Pt"])
            loss, aux = tt.traj_criterion(lo, params, x["p0"], prob, valid=x["V"])
        grads = torch.autograd.grad(loss, list(params.values()))
        out.append((loss.detach(), {k: v.detach() for k, v in aux.items()}, grads))
    (lf, af, gf), (lp, ap, gp) = out
    torch.testing.assert_close(lf, lp, rtol=2e-6, atol=0)
    for key in ft.AUX:
        torch.testing.assert_close(af[key], ap[key], rtol=2e-6, atol=1e-6)
    assert torch.equal(af["rewards"], ap["rewards"])  # the same R, scores and log-odds
    for a, b, what in zip(gf, gp, ("poses", "quats")):
        _close(a, b, 1e-4, what)


def _cloud10_runner(dev, n_steps):
    cloud, path = (load_point_cloud(str(DATA / "points/point_cloud_10.npz")),
                   load_path(str(DATA / "paths/path_poses_10.npz")))
    padded, valid = pad_points(cloud)
    q = identity_quaternions(len(path))
    prob = tt.TrajProblem(INTR.width, INTR.height, wps_step=tt.waypoint_stride(path))
    data = (torch.as_tensor(padded, device=dev), torch.as_tensor(valid, device=dev),
            INTR.matrix(device=dev), torch.as_tensor(path, device=dev),
            torch.as_tensor(q, device=dev))
    runner = tr.TrajRunner(prob, te.OptimizerConfig(lr_pose=0.1, lr_quat=0.02), te.NEVER,
                           n_steps)
    return runner, tt.init_traj_params(path, q, dev), data


def test_a_captured_replay_launches_each_new_kernel_once(dev, regime):
    """A captured trajectory step's replay adds exactly one launch of each
    of the loss's kernels to ``LAUNCHES`` (alpha_beta only where K3 and K4
    run), beside one of each visibility kernel of the regime."""
    runner, params, data = _cloud10_runner(dev, 5)
    runner(params, *data)  # captures
    graph = next(iter(runner.buckets._items.values())).graph
    vis = ("pass_a", "pass_b", "bwd_stats", "bwd_apply") if regime == "cached" else (
        "pass_a_minmax", "pass_b_recompute", "bwd_fused_acc")
    new = NEW if regime == "cached" else UNCACHED_NEW
    assert graph.launches == {n: 1 for n in vis + new}
    torch.cuda.synchronize()
    before = dict(_kernels.LAUNCHES)
    graph.replay()
    torch.cuda.synchronize()
    assert {n: v - before[n] for n, v in _kernels.LAUNCHES.items() if v != before[n]} == {
        n: 1 for n in vis + new}


def test_a_replay_of_the_loss_runs_at_most_12_device_operations(dev, regime):
    """The loss's forward and backward alone, captured and replayed under
    the profiler: at most 12 device operations, the visibility kernels
    included (the plain path took ~315 around them)."""
    from torch.profiler import ProfilerActivity, profile

    runner, params, data = _cloud10_runner(dev, 1)
    P, V, K, p0, q0 = data
    prob = runner.problem
    Pt = P.t().contiguous()
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}

    def loss_and_grads():
        loss, aux = tt.traj_forward(leaves, P, K, p0, q0, prob, valid=V, points_t=Pt)
        return torch.autograd.grad(loss, list(leaves.values()))

    with tg.on_capture_stream(dev, "graph"):
        loss_and_grads()  # the launcher's scratch and sentinels, before the capture
        graph = tg.StepGraph(loss_and_grads, "graph", "trajectory loss")
        graph.capture()
        graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tg.on_capture_stream(dev, "graph"):
            graph.replay()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    names = [e.name for e in ops]
    assert 0 < len(ops) <= 12, names
