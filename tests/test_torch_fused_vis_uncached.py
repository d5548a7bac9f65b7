"""Parity of the port's uncached regime (ops/fused_vis.py: K1′, K2′ and the
single-pass backward K5) with the JAX twin (ops/pallas_vis.py).

Above the score-cache budget neither package holds a (W, N) tensor: pass A
and pass B recompute the scores, and the backward is one pass that keeps 40
sums per waypoint. Here the port's plain versions of those three kernels are
held against the Pallas kernels (interpret mode on the CPU), and the whole
``fused_lo_sum`` forced into the uncached regime against the Pallas wrapper
forced likewise. The CUDA kernels run only on the card
(``tests/test_torch_kernels_cuda.py``).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from test_torch_fused_vis import (  # noqa: E402
    FWD, GRAD, INTR, KJ, EPS, _assert_near_oracle, _f64_oracle_grads, _jax_lo_and_grads,
    _path, _port_lo_and_grads, _rot_quats,
)
from trajectory_optimization_tpu.ops import pallas_vis as pv  # noqa: E402
from trajectory_optimization_tpu.ops import quat as j_quat  # noqa: E402
from trajectory_optimization_tpu_torch.models import traj as t_traj  # noqa: E402
from trajectory_optimization_tpu_torch.ops import _kernels  # noqa: E402
from trajectory_optimization_tpu_torch.ops import fused_vis as fv  # noqa: E402
from trajectory_optimization_tpu_torch.ops.scores import waypoint_scores as t_scores  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Multithreaded elementwise CPU kernels have been seen to give two
    identical calls different scores (by up to 1e-4); this file holds tie
    counts of separate recomputes to be exactly equal, so it runs torch on
    one thread (restored afterwards), where the calls agree."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_uncached(pts, quats, trans, valid, g, with_lo=True):
    """The JAX twin's uncached stages on one problem (interpret mode): pass A
    without cache, pass B recomputing (``with_lo``), and the single-pass
    backward."""
    N, W = len(pts), len(quats)
    R = np.asarray(j_quat.to_matrix(j_quat.normalize(jnp.asarray(quats))))
    wp12 = np.concatenate([R.reshape(W, 9), trans], axis=1).astype(np.float32)
    wp16 = jnp.asarray(np.concatenate([wp12, np.zeros((W, 4), np.float32)], axis=1))
    K = INTR.matrix_np()
    kp = np.float32([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
    planes = jnp.asarray(pts.T.reshape(3, N // 128, 128))
    vp = jnp.asarray(valid.reshape(-1, 128))
    gp = jnp.asarray(g.reshape(-1, 128))
    consts = pv._consts((INTR.width, INTR.height), (1.0, 5.0), EPS)
    tr = pv.TILE_ROWS_CACHE  # 64 × 128 = 8,192 points: whole tiles
    kpj = jnp.asarray(kp[None])
    m, mx, scores = pv.run_pass_a(wp16, kpj, planes, vp, consts, cache_scores=False, tr=tr)
    assert scores is None
    norm = pv.make_norm(m, mx)
    acc = pv.run_bwd_fused_acc(wp16, kpj, norm, planes, vp, gp, consts, EPS, tr=tr)
    jx = {k: np.array(v) for k, v in dict(m=m, mx=mx, norm=norm, acc=acc).items()}
    if with_lo:
        jx["lo"] = np.array(pv.run_pass_b(wp16, kpj, norm, planes, None, consts, EPS, tr=tr))
        jx["lo"] = jx["lo"].reshape(N)
    tt = dict(
        wp=torch.as_tensor(wp12), kp=torch.as_tensor(kp),
        pts_t=torch.as_tensor(np.ascontiguousarray(pts.T)), valid=torch.as_tensor(valid),
        g=torch.as_tensor(g), k=fv.make_consts(INTR.width, INTR.height, 1.0, 5.0, EPS),
    )
    return jx, tt


@pytest.fixture(scope="module")
def stages(cloud10, path10):
    """N = 8,192 points of cloud 10, stride-2 waypoints (W = 14), the last
    700 points invalid."""
    N = 8192
    pts = cloud10[::4][:N]
    quats, trans = _rot_quats(len(path10))[::2], path10[::2]
    valid = (np.arange(N) < N - 700).astype(np.float32)
    g = (np.random.default_rng(0).normal(size=N) * valid).astype(np.float32)
    return _jax_uncached(pts, quats, trans, valid, g)


def _port_acc(tt):
    """The port's plain K5 with the norm of its own plain K1′: in this
    regime each side tests its ties on its own recompute."""
    m, mx = fv.pass_a_minmax_ref(tt["wp"], tt["kp"], tt["pts_t"], tt["valid"], tt["k"])
    return fv.bwd_fused_acc_ref(tt["wp"], tt["kp"], fv.make_norm(m, mx), tt["pts_t"],
                                tt["valid"], tt["g"], tt["k"]).numpy()


def _assert_acc_close(acc, jacc, tt):
    """Slots 0–37 (sums) at the gradient bound; the tie counts exactly.

    XLA's CPU exp flushes denormal results to 0 where torch keeps them, so
    the JAX twin's min ties are the port's ties on its scores with denormals
    flushed; its max ties are the port's own. The port's min-tie count is
    the count on the same scores unflushed, so slot 38 is tied to the
    witness held against JAX."""
    np.testing.assert_allclose(acc[:, :38], jacc[:, :38], **GRAD)
    np.testing.assert_array_equal(acc[:, 39], jacc[:, 39])
    s, _ = fv._scores(tt["wp"], tt["kp"], tt["pts_t"], tt["k"])
    ok = tt["valid"] > 0
    m = torch.where(ok, s, torch.full_like(s, 3e38)).amin(1, keepdim=True)
    np.testing.assert_array_equal(acc[:, 38], ((s == m) & ok).sum(1).numpy())
    s_ftz = torch.where(s < np.finfo(np.float32).tiny, torch.zeros_like(s), s)
    m_ftz = torch.where(ok, s_ftz, torch.full_like(s, 3e38)).amin(1, keepdim=True)
    np.testing.assert_array_equal(((s_ftz == m_ftz) & ok).sum(1).numpy(), jacc[:, 38])


def test_pass_a_minmax_matches_pallas_stage(stages):
    jx, tt = stages
    m, mx = fv.pass_a_minmax_ref(tt["wp"], tt["kp"], tt["pts_t"], tt["valid"], tt["k"])
    # rtol 1e-5: exp and sigmoid of two libraries; atol 1e-30 absorbs
    # denormal quantization of far-point minima only
    np.testing.assert_allclose(m.numpy(), jx["m"], rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(mx.numpy(), jx["mx"], rtol=1e-5, atol=1e-30)


def test_pass_b_recompute_matches_pallas_stage(stages):
    jx, tt = stages
    lo = fv.pass_b_recompute_ref(tt["wp"], tt["kp"], torch.as_tensor(jx["norm"]), tt["pts_t"],
                                 tt["k"])
    np.testing.assert_allclose(lo.numpy(), jx["lo"], **FWD)


def test_bwd_fused_acc_matches_pallas_stage(stages):
    jx, tt = stages
    acc = _port_acc(tt)
    assert acc.shape == (len(tt["wp"]), pv.BWD_SLOTS)
    _assert_acc_close(acc, jx["acc"], tt)
    assert acc[:, 38].max() > 1  # zero-score min ties are the common case


def test_bwd_fused_acc_many_waypoints_matches_pallas(cloud10):
    """W = 100, past ``UNROLL_MAX_W``: the JAX twin pads to 16-wide waypoint
    groups with dummy waypoints; the port has no such axis."""
    N, W = 8192, 100
    pts = cloud10[:N]
    quats, trans = np.tile(np.float32([1, 0, 0, 0]), (W, 1)), _path(W)
    quats[::4] = [0.9, 0.1, -0.3, 0.2]
    valid = np.ones(N, np.float32)
    g = np.random.default_rng(1).normal(size=N).astype(np.float32)
    jx, tt = _jax_uncached(pts, quats, trans, valid, g, with_lo=False)
    _assert_acc_close(_port_acc(tt), jx["acc"], tt)


def test_fused_acc_linearity_with_cached_backward(stages):
    """The single-pass sums, combined by ``fused_acc_to_sums``, equal the
    cached backward's: K4's sums with α and β from K3 (linearity of the dcam
    chain), on the same recomputed scores and norm."""
    _, tt = stages
    args = (tt["wp"], tt["kp"], tt["pts_t"], tt["valid"], tt["k"])
    m, mx, scores = fv.pass_a_ref(*args)
    norm = fv.make_norm(m, mx)
    acc = fv.bwd_fused_acc_ref(tt["wp"], tt["kp"], norm, tt["pts_t"], tt["valid"], tt["g"],
                               tt["k"])
    st, need = fv.bwd_stats_ref(norm, scores, tt["valid"], tt["g"], EPS)
    assert torch.equal(acc[:, 38:], st[:, 2:])  # the same recompute: the same ties
    norm2 = torch.cat([norm, st[:, :2] / st[:, 2:].clamp(min=1.0)], dim=1)
    sums = fv.bwd_apply_ref(tt["wp"], tt["kp"], norm2, tt["pts_t"], tt["valid"], tt["g"], scores,
                            need, tt["k"])
    np.testing.assert_allclose(fv.fused_acc_to_sums(acc, len(norm)).numpy(), sums.numpy(),
                               **GRAD)


@pytest.mark.parametrize("stage", ["pass_a_minmax", "pass_b_recompute", "bwd_fused_acc"])
def test_uncached_stage_wrappers_take_plain_versions_on_cpu(stages, stage, monkeypatch):
    _, tt = stages
    norm = torch.tensor([[0.0, 2.0, 1.0, 0.5]]).repeat(len(tt["wp"]), 1)
    args = {
        "pass_a_minmax": (tt["wp"], tt["kp"], tt["pts_t"], tt["valid"], tt["k"]),
        "pass_b_recompute": (tt["wp"], tt["kp"], norm, tt["pts_t"], tt["k"]),
        "bwd_fused_acc": (tt["wp"], tt["kp"], norm, tt["pts_t"], tt["valid"], tt["g"], tt["k"]),
    }[stage]
    sentinel = object()
    monkeypatch.setattr(fv, stage + "_ref", lambda *a: (sentinel, a))
    _kernels.reset_launches()
    got = getattr(fv, stage)(*args)
    assert got[0] is sentinel and all(a is b for a, b in zip(got[1], args))
    assert all(n == 0 for n in _kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA tensor"):  # checked before any build
        getattr(_kernels, stage)(*args)


# ---------------------------------------------------------------------------
# the regime rule and the whole fused_lo_sum
# ---------------------------------------------------------------------------


def _jax_uses_cache(W, N):
    """``pallas_vis.fused_lo_sum`` pads N to its tile, then ``_fused_fwd_impl``
    caches while W · (M · LANES) · 4 B fits the budget."""
    tile = pv.TILE_ROWS * pv.LANES
    Np = N + (-N) % tile
    return W * (Np // pv.LANES) * pv.LANES * 4 <= pv.SCORE_CACHE_MAX_BYTES


@pytest.mark.parametrize("W", [14, 50, 128])
def test_regime_rule_matches_jax(W):
    tile = pv.TILE_ROWS * pv.LANES
    last = pv.SCORE_CACHE_MAX_BYTES // (4 * W) // tile * tile  # last cached padded count
    ns = [last - 1, last, last + 1, last + tile]
    got = [fv.uses_score_cache(W, n) for n in ns]
    assert got == [_jax_uses_cache(W, n) for n in ns] == [True, True, False, False]
    # the largest count the facade pads to (a multiple of 1,024) whose
    # unpadded scores fit: cached only where it lies on a tile boundary
    raw = pv.SCORE_CACHE_MAX_BYTES // (4 * W) // 1024 * 1024
    assert fv.uses_score_cache(W, raw) == _jax_uses_cache(W, raw) == (raw == last)


@pytest.fixture
def no_cache(monkeypatch):
    """Both packages forced into the uncached regime."""
    monkeypatch.setattr(pv, "SCORE_CACHE_MAX_BYTES", 0)
    monkeypatch.setattr(fv, "SCORE_CACHE_MAX_BYTES", 0)


def test_fused_lo_sum_uncached_matches_pallas(cloud10, path10, no_cache):
    pts = cloud10[::5][:8192]
    quats, trans = _rot_quats(len(path10))[::2], path10[::2]
    assert not fv.uses_score_cache(len(quats), len(pts))
    g = np.random.default_rng(1).normal(size=len(pts)).astype(np.float32)

    def pallas(p, q, t, v):
        return pv.fused_lo_sum(p, q, t, KJ, INTR.width, INTR.height)

    lo_j, gq_j, gt_j = _jax_lo_and_grads(pallas, pts, quats, trans, g)
    lo_t, gq_t, gt_t = _port_lo_and_grads(pts, quats, trans, g)
    np.testing.assert_allclose(lo_t, lo_j, **FWD)
    np.testing.assert_allclose(gt_t, gt_j, **GRAD)
    np.testing.assert_allclose(gq_t, gq_j, **GRAD)


def test_large_w_uncached_grad_vs_f64_oracle(cloud10, no_cache):
    """W = 128 through K1′/K2′/K5's plain versions, with the JAX suite's f64
    pin: relnorm 2e-3 of the oracle, and within 3× plain autodiff's error."""
    pts = cloud10[:4096]
    W = 128
    quats, trans = np.tile(np.float32([1, 0, 0, 0]), (W, 1)), _path(W)
    quats[::4] = [0.9, 0.1, -0.3, 0.2]
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


def _saved_numels(budget, monkeypatch, pts, quats, trans):
    """Element counts of every tensor autograd saves for ``fused_lo_sum``."""
    monkeypatch.setattr(fv, "SCORE_CACHE_MAX_BYTES", budget)
    numels = []

    def pack(t):
        numels.append(t.numel())
        return t

    q = torch.tensor(quats, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        lo = fv.fused_lo_sum(torch.as_tensor(pts), q, torch.as_tensor(trans), INTR.matrix(),
                             INTR.width, INTR.height)
    lo.sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
    return numels


def test_uncached_regime_saves_no_score_sized_tensor(cloud10, path10, monkeypatch):
    pts = cloud10[:3000]
    quats, trans = _rot_quats(len(path10)), path10
    WN = len(quats) * len(pts)
    assert WN in _saved_numels(1 << 30, monkeypatch, pts, quats, trans)  # the cache
    assert WN not in _saved_numels(0, monkeypatch, pts, quats, trans)
