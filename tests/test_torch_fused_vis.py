"""Parity of the port's fused visibility family (ops/fused_vis.py) with the
JAX twin (ops/pallas_vis.py).

Stage by stage, the port's plain versions of K1–K4 are held against the
Pallas kernels themselves (interpret mode on the CPU, one call each, shared
by a module fixture), and ``fused_lo_sum`` forward and gradient against the
Pallas ``fused_lo_sum`` once. Every other case is held against the JAX XLA
path, which ``tests/test_pallas_vis.py`` ties to Pallas. The CUDA kernels
themselves run only on the card (``tests/test_torch_kernels_cuda.py``).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from trajectory_optimization_tpu.models.traj import observation_logodds  # noqa: E402
from trajectory_optimization_tpu.ops import pallas_vis as pv  # noqa: E402
from trajectory_optimization_tpu.ops import quat as j_quat  # noqa: E402
from trajectory_optimization_tpu.ops.scores import waypoint_scores  # noqa: E402
from trajectory_optimization_tpu_torch.models import traj as t_traj  # noqa: E402
from trajectory_optimization_tpu_torch.ops import _kernels  # noqa: E402
from trajectory_optimization_tpu_torch.ops import fused_vis as fv  # noqa: E402
from trajectory_optimization_tpu_torch.ops.scores import waypoint_scores as t_scores  # noqa: E402
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

INTR = default_intrinsics()
KJ = jnp.asarray(INTR.matrix_np())
EPS = 1e-6
# The JAX suite's own bounds (tests/test_pallas_vis.py): forward and
# gradient, f32 paths that differ in rounding and summation order.
FWD = dict(rtol=1e-4, atol=2e-4)
GRAD = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch's multithreaded CPU kernels give scores last bits that depend on
    how many threads a call gets, which varies when the machine is loaded;
    one thread (restored afterwards) makes this file's comparisons
    reproducible, as in tests/test_torch_fused_vis_uncached.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rot_quats(W):
    q = np.tile(np.float32([1, 0, 0, 0]), (W, 1))
    q[::3] = [0.9, 0.1, -0.3, 0.2]  # rotate some waypoints so scores differ
    return q


def _path(W):
    t = np.linspace(0, 1, W, dtype=np.float32)
    return np.stack([20 * t, 8 * np.sin(3 * t), t], axis=1).astype(np.float32)


def _xla_lo_sum(pts, quats, trans, valid=None):
    p = waypoint_scores(pts, quats, trans, KJ, INTR.width, INTR.height, eps=EPS)
    return jnp.sum(observation_logodds(p, EPS, valid), axis=0)


def _jax_lo_and_grads(lo_fn, pts, quats, trans, g, valid=None):
    lo, vjp = jax.vjp(lambda q, t: lo_fn(jnp.asarray(pts), q, t, valid), jnp.asarray(quats),
                      jnp.asarray(trans))
    gq, gt = vjp(jnp.asarray(g))
    return np.asarray(lo), np.asarray(gq), np.asarray(gt)


def _port_lo_and_grads(pts, quats, trans, g, valid=None, dtype=torch.float32):
    q = torch.tensor(quats, dtype=dtype, requires_grad=True)
    t = torch.tensor(trans, dtype=dtype, requires_grad=True)
    v = None if valid is None else torch.as_tensor(np.asarray(valid), dtype=dtype)
    lo = fv.fused_lo_sum(torch.as_tensor(pts, dtype=dtype), q, t, INTR.matrix(dtype=dtype),
                         INTR.width, INTR.height, valid=v)
    gq, gt = torch.autograd.grad(lo, (q, t), torch.as_tensor(g, dtype=dtype))
    return lo.detach().numpy(), gq.numpy(), gt.numpy()


# ---------------------------------------------------------------------------
# stage by stage against the Pallas kernels (interpret mode), N = 8192, W = 14
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stages(cloud10, path10):
    N = 8192
    pts = cloud10[::4][:N]
    quats, trans = _rot_quats(len(path10))[::2], path10[::2]  # stride 2: W = 14
    W = len(quats)
    valid = (np.arange(N) < N - 700).astype(np.float32)
    g = (np.random.default_rng(0).normal(size=N) * valid).astype(np.float32)

    R = np.asarray(j_quat.to_matrix(j_quat.normalize(jnp.asarray(quats))))
    wp12 = np.concatenate([R.reshape(W, 9), trans], axis=1).astype(np.float32)
    wp16 = jnp.asarray(np.concatenate([wp12, np.zeros((W, 4), np.float32)], axis=1))
    K = INTR.matrix_np()
    kp = np.float32([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
    planes = jnp.asarray(pts.T.reshape(3, N // 128, 128))
    vp = jnp.asarray(valid.reshape(-1, 128))
    gp = jnp.asarray(g.reshape(-1, 128))
    consts = pv._consts((INTR.width, INTR.height), (1.0, 5.0), EPS)
    tr = pv.TILE_ROWS_CACHE

    m, mx, scores = pv.run_pass_a(wp16, jnp.asarray(kp[None]), planes, vp, consts,
                                  cache_scores=True, tr=tr)
    norm = pv.make_norm(m, mx)
    lo = pv.run_pass_b(wp16, jnp.asarray(kp[None]), norm, planes, scores, consts, EPS, tr=tr)
    st = pv.run_bwd_stats(norm, scores, vp, gp, EPS, tr=tr)
    alpha = st[:, 0] / jnp.maximum(st[:, 2], 1.0)
    beta = st[:, 1] / jnp.maximum(st[:, 3], 1.0)
    norm2 = jnp.concatenate([norm, alpha[:, None], beta[:, None]], axis=1)
    sums = pv.run_bwd_apply(wp16, jnp.asarray(kp[None]), norm2, planes, vp, gp, scores, consts,
                            EPS, tr=tr)
    jx = {k: np.array(v) for k, v in dict(
        m=m, mx=mx, scores=scores.reshape(W, N), norm=norm, lo=lo.reshape(N), st=st,
        norm2=norm2, sums=sums).items()}
    tt = dict(
        wp=torch.as_tensor(wp12), kp=torch.as_tensor(kp),
        pts_t=torch.as_tensor(np.ascontiguousarray(pts.T)), valid=torch.as_tensor(valid),
        g=torch.as_tensor(g), k=fv.make_consts(INTR.width, INTR.height, 1.0, 5.0, EPS),
    )
    return jx, tt


def test_pass_a_matches_pallas_stage(stages):
    jx, tt = stages
    m, mx, s = fv.pass_a_ref(tt["wp"], tt["kp"], tt["pts_t"], tt["valid"], tt["k"])
    # min/max rtol 1e-5 (atol 1e-30 absorbs denormal quantization only);
    # cache rtol 1e-5 / atol 1e-7: exp and sigmoid of two libraries
    np.testing.assert_allclose(m.numpy(), jx["m"], rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(mx.numpy(), jx["mx"], rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(s.numpy(), jx["scores"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(fv.make_norm(m, mx).numpy(), jx["norm"], rtol=1e-5, atol=1e-30)


def test_pass_b_matches_pallas_stage(stages):
    jx, _ = stages
    lo = fv.pass_b_ref(torch.tensor(jx["norm"]), torch.tensor(jx["scores"]), EPS)
    np.testing.assert_allclose(lo.numpy(), jx["lo"], **FWD)


def test_bwd_stats_matches_pallas_stage(stages):
    jx, tt = stages
    st = fv.bwd_stats_ref(torch.as_tensor(jx["norm"]), torch.as_tensor(jx["scores"]),
                          tt["valid"], tt["g"], EPS)[0].numpy()
    np.testing.assert_allclose(st[:, :2], jx["st"][:, :2], **GRAD)
    np.testing.assert_array_equal(st[:, 2:], jx["st"][:, 2:])  # same inputs: exact tie counts
    assert st[:, 2].max() > 1  # zero-score min ties are the common case


def test_bwd_apply_matches_pallas_stage(stages):
    jx, tt = stages
    scores = torch.as_tensor(jx["scores"])
    need = fv.bwd_stats_ref(torch.as_tensor(jx["norm"]), scores, tt["valid"], tt["g"], EPS)[1]
    sums = fv.bwd_apply_ref(tt["wp"], tt["kp"], torch.as_tensor(jx["norm2"]), tt["pts_t"],
                            tt["valid"], tt["g"], scores, need, tt["k"])
    np.testing.assert_allclose(sums.numpy(), jx["sums"], **GRAD)


def test_stage_wrappers_take_plain_versions_on_cpu(stages):
    _, tt = stages
    _kernels.reset_launches()
    args = (tt["wp"], tt["kp"], tt["pts_t"], tt["valid"], tt["k"])
    for got, want in zip(fv.pass_a(*args), fv.pass_a_ref(*args)):
        assert torch.equal(got, want)
    assert all(n == 0 for n in _kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA tensor"):  # checked before any build
        _kernels.pass_a(*args)


def test_fused_acc_to_sums_matches_jax():
    acc = np.random.default_rng(4).normal(size=(7, pv.BWD_SLOTS)).astype(np.float32)
    acc[:, 38:] = np.abs(np.round(acc[:, 38:] * 3))  # tie counts, some zero
    np.testing.assert_allclose(fv.fused_acc_to_sums(torch.as_tensor(acc), 7).numpy(),
                               np.asarray(pv.fused_acc_to_sums(jnp.asarray(acc), 7)), rtol=1e-6)


def test_fused_lo_sum_matches_pallas(cloud10, path10):
    pts = cloud10[::5][:8192]
    quats, trans = _rot_quats(len(path10)), path10
    g = np.random.default_rng(1).normal(size=len(pts)).astype(np.float32)

    def pallas(p, q, t, v):
        return pv.fused_lo_sum(p, q, t, KJ, INTR.width, INTR.height)

    lo_j, gq_j, gt_j = _jax_lo_and_grads(pallas, pts, quats, trans, g)
    lo_t, gq_t, gt_t = _port_lo_and_grads(pts, quats, trans, g)
    np.testing.assert_allclose(lo_t, lo_j, **FWD)
    np.testing.assert_allclose(gt_t, gt_j, **GRAD)
    np.testing.assert_allclose(gq_t, gq_j, **GRAD)


# ---------------------------------------------------------------------------
# against the JAX XLA path
# ---------------------------------------------------------------------------


def _f64_oracle_grads(pts, quats, trans, g):
    """Gradient of Σ lo·g through the JAX XLA path in float64."""
    with jax.enable_x64(True):
        K64 = jnp.asarray(INTR.matrix_np(np.float64))

        def f_oracle(qq, tt):
            s = waypoint_scores(jnp.asarray(pts, jnp.float64), qq, tt, K64, INTR.width,
                                INTR.height, eps=EPS)
            return jnp.sum(jnp.sum(observation_logodds(s, EPS, None), axis=0)
                           * jnp.asarray(g, jnp.float64))

        gq, gt = jax.grad(f_oracle, argnums=(0, 1))(
            jnp.asarray(quats, jnp.float64), jnp.asarray(trans, jnp.float64))
        return np.asarray(gq), np.asarray(gt)


def _relnorm(a, b):
    return np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b)


def _assert_near_oracle(port, xla, oracle):
    """The JAX suite's f64 pin: the hand-derived backward within relnorm 2e-3
    of the oracle and within 3× the f32 error of plain autodiff."""
    rp, rx = _relnorm(port, oracle), _relnorm(xla, oracle)
    assert rp < 2e-3, (rp, rx)
    assert rp <= 3.0 * rx + 1e-4, (rp, rx)


def test_fused_lo_sum_valid_mask_matches_xla(cloud10, path10):
    pts = cloud10[::5][:6000]
    valid = (np.arange(len(pts)) < len(pts) - 1500).astype(np.float32)
    quats, trans = _rot_quats(len(path10)), path10
    g = np.random.default_rng(2).normal(size=len(pts)).astype(np.float32)
    lo_j, gq_j, gt_j = _jax_lo_and_grads(_xla_lo_sum, pts, quats, trans, g, jnp.asarray(valid))
    lo_t, gq_t, gt_t = _port_lo_and_grads(pts, quats, trans, g, valid)
    np.testing.assert_allclose(lo_t, lo_j, **FWD)
    np.testing.assert_allclose(gt_t, gt_j, **GRAD)
    np.testing.assert_allclose(gq_t, gq_j, **GRAD)


def test_fused_lo_sum_tied_points_vs_f64_oracle(cloud10, path10):
    """Every point twice, so every min and max is a tie whose cotangent the
    backward splits by its tie counts. The forward is held to XLA; the
    gradient to the f64 oracle, because here XLA's own f32 autodiff is
    element-wise up to ~1e-2 off the oracle (relnorm 1.8e-3) while the
    hand-derived backward is closer (relnorm 6e-4)."""
    pts = np.concatenate([cloud10[::5][:6000]] * 2)
    quats, trans = _rot_quats(len(path10)), path10
    g = np.random.default_rng(2).normal(size=len(pts)).astype(np.float32)
    lo_j, gq_j, gt_j = _jax_lo_and_grads(_xla_lo_sum, pts, quats, trans, g)
    lo_t, gq_t, gt_t = _port_lo_and_grads(pts, quats, trans, g)
    np.testing.assert_allclose(lo_t, lo_j, **FWD)
    gq_o, gt_o = _f64_oracle_grads(pts, quats, trans, g)
    _assert_near_oracle(gt_t, gt_j, gt_o)
    _assert_near_oracle(gq_t, gq_j, gq_o)


@pytest.mark.parametrize("n", [1000, 4097, 8191])
def test_fused_lo_sum_nondivisible_sizes(cloud10, path10, n):
    pts = cloud10[:n]
    quats = _rot_quats(len(path10))
    lo_t = fv.fused_lo_sum(torch.as_tensor(pts), torch.as_tensor(quats), torch.as_tensor(path10),
                           INTR.matrix(), INTR.width, INTR.height)
    lo_j = _xla_lo_sum(jnp.asarray(pts), jnp.asarray(quats), jnp.asarray(path10))
    assert lo_t.shape == (n,)
    np.testing.assert_allclose(lo_t.numpy(), np.asarray(lo_j), **FWD)


def test_fused_lo_sum_many_waypoints_matches_xla(cloud10):
    """W = 100: one waypoint table, no groups or dummy waypoints (the JAX twin
    pads to 16-wide groups here; the port has no such axis)."""
    pts = cloud10[:8192]
    W = 100
    quats, trans = np.tile(np.float32([1, 0, 0, 0]), (W, 1)), _path(W)
    quats[::4] = [0.9, 0.1, -0.3, 0.2]  # the JAX suite's inputs for this case
    g = np.random.default_rng(1).normal(size=len(pts)).astype(np.float32)
    lo_j, gq_j, gt_j = _jax_lo_and_grads(_xla_lo_sum, pts, quats, trans, g)
    lo_t, gq_t, gt_t = _port_lo_and_grads(pts, quats, trans, g)
    np.testing.assert_allclose(lo_t, lo_j, rtol=2e-4, atol=5e-4)  # W = 100 terms per sum
    np.testing.assert_allclose(gt_t, gt_j, **GRAD)
    np.testing.assert_allclose(gq_t, gq_j, **GRAD)


def test_large_w_grad_vs_f64_oracle(cloud10):
    """W = 128 gradient accuracy against an f64 oracle (the JAX XLA path in
    float64), with the JAX suite's bounds: the hand-derived backward within
    relnorm 2e-3 of the oracle, and within 3× the f32 error of plain autodiff
    (the port's "torch" path). A sign or indexing bug in the backward shows
    up as relnorm ≫ 1e-2."""
    pts = cloud10[:4096]
    W = 128
    quats, trans = np.tile(np.float32([1, 0, 0, 0]), (W, 1)), _path(W)
    quats[::4] = [0.9, 0.1, -0.3, 0.2]  # the JAX suite's inputs for this case
    g = np.random.default_rng(2).normal(size=len(pts)).astype(np.float32)
    _, gq_p, gt_p = _port_lo_and_grads(pts, quats, trans, g)

    q = torch.tensor(quats, requires_grad=True)
    t = torch.tensor(trans, requires_grad=True)
    p = t_scores(torch.as_tensor(pts), q, t, INTR.matrix(), INTR.width, INTR.height)
    lo = torch.sum(t_traj.observation_logodds(p, EPS), dim=0)
    gq_x, gt_x = (a.numpy() for a in torch.autograd.grad(lo, (q, t), torch.as_tensor(g)))

    gq_o, gt_o = _f64_oracle_grads(pts, quats, trans, g)
    _assert_near_oracle(gt_p, gt_x, gt_o)
    _assert_near_oracle(gq_p, gq_x, gq_o)
