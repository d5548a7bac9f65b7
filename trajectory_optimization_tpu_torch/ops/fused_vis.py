"""Fused visibility log-odds: the four Hopper kernels, their plain versions,
and the autograd function that ties them together.

Twin of ``trajectory_optimization_tpu/ops/pallas_vis.py`` (score-cache
regime). For W waypoints and N points:

    s(w,i)   = σ(cz)·exp(−½(d²/σ² + xu² + xv²))       (ops.scores formulas)
    m_w, M_w = min_i / max_i s(w,i)   over valid points
    pn(w,i)  = clip((s − m_w)/max(M_w − m_w, 1e-8), 0.5, 1−eps)
    lo_i     = Σ_w log(pn/(1−pn))

Stages (kernel ids as in PERF.md; CUDA sources in ``csrc/fused_vis.cu``):

  K1 ``pass_a``     scores → (W, N) cache + per-waypoint masked min/max
  K2 ``pass_b``     cache → (N,) log-odds sum
  K3 ``bwd_stats``  per-waypoint Σ c_pn·∂pn/∂m, Σ c_pn·∂pn/∂M and tie counts
  K4 ``bwd_apply``  combined cotangent chained to 12 camera-plane sums per w

Each stage has a plain PyTorch version beside it (``*_ref``) with the same
inputs and outputs. The stage wrapper runs the plain version for CPU tensors
only; for a CUDA tensor it launches the kernel (``ops._kernels``) or raises.

Layout: points as a contiguous SoA (3, N) f32, transposed once per problem;
``valid`` and the cotangent as (N,) f32; the waypoint table ``wp`` (W, 12) =
[R row-major 9, t 3]; ``kp`` (4,) = [fx, fy, cx, cy]; ``norm`` (W, 4) =
[m, 1/max(M − m, 1e-8), gate, M] and ``norm2`` (W, 6) adds α and β.

The uncached regime of the JAX twin (W·N·4 B > 1 GiB: kernels K1′, K2′ and
the single-pass backward K5) is not ported yet; a CUDA call that needs it
raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from trajectory_optimization_tpu_torch.ops import _kernels
from trajectory_optimization_tpu_torch.ops import quat as quat_ops

SCORE_CACHE_MAX_BYTES = 1 << 30  # the JAX twin's cache budget (pallas_vis.py)
SPAN_FLOOR = 1e-8
_BIG = 3.0e38


class VisConsts(NamedTuple):
    """Scalar constants of the score formula, as Python floats (the kernels
    receive them as f32 arguments, rounded exactly as the JAX twin bakes them)."""

    c0: float
    inv_var: float
    img_w: float
    img_h: float
    eps: float
    inv_w: float
    inv_h: float


def make_consts(img_width, img_height, min_dist, max_dist, eps) -> VisConsts:
    c0 = (min_dist + max_dist) / 2.0
    inv_var = 1.0 / ((max_dist - min_dist) / 2.0) ** 2
    img_w, img_h = float(img_width), float(img_height)
    return VisConsts(c0, inv_var, img_w, img_h, float(eps), 1.0 / img_w, 1.0 / img_h)


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise NotImplementedError(f"fused visibility kernels run on CPU or CUDA, not {t.device}")


# ---------------------------------------------------------------------------
# shared score math (the plain twin of _tile_extras/_tile_scores/_tile_dcam)
# ---------------------------------------------------------------------------


def _extras(wp, kp, pts_t, k: VisConsts):
    """(W, N) transform/projection intermediates; s = sig·exp(arg)."""
    px, py, pz = pts_t[0][None, :], pts_t[1][None, :], pts_t[2][None, :]
    r = [wp[:, j : j + 1] for j in range(12)]
    fx, fy, cx0, cy0 = kp[0], kp[1], kp[2], kp[3]
    dx, dy, dz = px - r[9], py - r[10], pz - r[11]
    cx = dx * r[0] + dy * r[3] + dz * r[6]
    cy = dx * r[1] + dy * r[4] + dz * r[7]
    cz = dx * r[2] + dy * r[5] + dz * r[8]
    ex, ey, ez = cx - k.c0, cy - k.c0, cz - k.c0
    d2 = ex * ex + ey * ey + ez * ez
    u = fx * cx + cx0 * cz
    v = fy * cy + cy0 * cz
    zd = cz + k.eps
    zd = torch.where(zd >= 0, torch.clamp(zd, min=1e-12), torch.clamp(zd, max=-1e-12))
    inv_zd = 1.0 / zd
    xu_raw = (u * inv_zd - k.img_w * 0.5) / k.img_w
    xv_raw = (v * inv_zd - k.img_h * 0.5) / k.img_h
    xu = torch.clamp(xu_raw, -20.0, 20.0)
    xv = torch.clamp(xv_raw, -20.0, 20.0)
    sig = torch.sigmoid(cz)
    arg = -0.5 * (d2 * k.inv_var + xu * xu + xv * xv)
    return arg, dict(ex=ex, ey=ey, ez=ez, u=u, v=v, inv_zd=inv_zd, xu=xu, xv=xv,
                     xu_raw=xu_raw, xv_raw=xv_raw, sig=sig, fx=fx, fy=fy, cx0=cx0, cy0=cy0)


def _dcam(total_cot, s, e, k: VisConsts):
    """Chain a score cotangent to the camera-frame cotangents (dcx, dcy, dcz).
    The ±20 clamp is gated strictly and the 1e-12 z floor is ignored, as in
    the JAX twin's hand-derived backward."""
    g_u = (torch.abs(e["xu_raw"]) < 20.0).to(s.dtype)
    g_v = (torch.abs(e["xv_raw"]) < 20.0).to(s.dtype)
    cs = total_cot * s
    inv_zd, xu, xv = e["inv_zd"], e["xu"], e["xv"]
    dcx = cs * (-(e["ex"] * k.inv_var) - xu * g_u * (e["fx"] * inv_zd * k.inv_w))
    dcy = cs * (-(e["ey"] * k.inv_var) - xv * g_v * (e["fy"] * inv_zd * k.inv_h))
    dcz = cs * (
        -(e["ez"] * k.inv_var)
        + (1.0 - e["sig"])
        - xu * g_u * (e["cx0"] * inv_zd - e["u"] * inv_zd * inv_zd) * k.inv_w
        - xv * g_v * (e["cy0"] * inv_zd - e["v"] * inv_zd * inv_zd) * k.inv_h
    )
    return dcx, dcy, dcz


def _pn_terms(norm, scores, g, eps):
    """Shared backward prologue: (s − m, c_pn) per (w, i), where c_pn is the
    log-odds cotangent inside the strict clip window and 0 outside it."""
    m, inv_d = norm[:, 0:1], norm[:, 1:2]
    sm = scores - m
    pn_raw = sm * inv_d
    active = (pn_raw > 0.5) & (pn_raw < 1.0 - eps)
    pn = torch.clamp(pn_raw, 0.5, 1.0 - eps)
    c_pn = torch.where(active, g[None, :] / (pn * (1.0 - pn)), torch.zeros_like(pn))
    return sm, c_pn


# ---------------------------------------------------------------------------
# K1 — pass A with score cache
# ---------------------------------------------------------------------------


def pass_a_ref(wp, kp, pts_t, valid, k: VisConsts):
    """Plain K1: (W, N) scores and their per-waypoint min/max over valid points.
    Returns (m (W,), M (W,), scores (W, N))."""
    arg, e = _extras(wp, kp, pts_t, k)
    s = e["sig"] * torch.exp(arg)
    ok = valid[None, :] > 0
    m = torch.amin(torch.where(ok, s, torch.full_like(s, _BIG)), dim=1)
    mx = torch.amax(torch.where(ok, s, torch.full_like(s, -_BIG)), dim=1)
    return m, mx, s


def pass_a(wp, kp, pts_t, valid, k: VisConsts):
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    if _on_cpu(pts_t):
        return pass_a_ref(wp, kp, pts_t, valid, k)
    return _kernels.pass_a(wp, kp, pts_t, valid, k)


def make_norm(m, mx):
    """(W,) global min/max → the (W, 4) normalization table
    [m, 1/max(M − m, 1e-8), gate, M]."""
    span_raw = mx - m
    gate = (span_raw > SPAN_FLOOR).to(m.dtype)
    inv_d = 1.0 / torch.clamp(span_raw, min=SPAN_FLOOR)
    return torch.stack([m, inv_d, gate, mx], dim=1)


# ---------------------------------------------------------------------------
# K2 — cached pass B
# ---------------------------------------------------------------------------


def pass_b_ref(norm, scores, eps):
    """Plain K2: normalize → clip → log-odds → Σ over w. Returns (N,)."""
    pn = torch.clamp((scores - norm[:, 0:1]) * norm[:, 1:2], 0.5, 1.0 - eps)
    return torch.sum(torch.log(pn / (1.0 - pn)), dim=0)


def pass_b(norm, scores, eps):
    if _on_cpu(scores):
        return pass_b_ref(norm, scores, eps)
    return _kernels.pass_b(norm, scores, eps)


# ---------------------------------------------------------------------------
# K3 — backward B1: min/max-pathway sums and tie counts
# ---------------------------------------------------------------------------


def bwd_stats_ref(norm, scores, valid, g, eps):
    """Plain K3. Returns (W, 4): [Σ c_pn·∂pn/∂m, Σ c_pn·∂pn/∂M, #(s = m),
    #(s = M)], the counts over valid points only."""
    sm, c_pn = _pn_terms(norm, scores, g, eps)
    m, inv_d, gate, mx = (norm[:, j : j + 1] for j in range(4))
    dm = c_pn * (-inv_d + sm * inv_d * inv_d * gate)
    dM = c_pn * (-(sm * inv_d * inv_d) * gate)
    ok = valid[None, :] > 0
    eqmin = (ok & (scores == m)).to(scores.dtype)
    eqmax = (ok & (scores == mx)).to(scores.dtype)
    return torch.stack([dm.sum(1), dM.sum(1), eqmin.sum(1), eqmax.sum(1)], dim=1)


def bwd_stats(norm, scores, valid, g, eps):
    if _on_cpu(scores):
        return bwd_stats_ref(norm, scores, valid, g, eps)
    return _kernels.bwd_stats(norm, scores, valid, g, eps)


# ---------------------------------------------------------------------------
# K4 — backward B2: combined cotangent → 12 camera-plane sums per waypoint
# ---------------------------------------------------------------------------


def bwd_apply_ref(wp, kp, norm2, pts_t, valid, g, scores, k: VisConsts):
    """Plain K4. The cotangent c_pn·inv_d + α·1[s=m] + β·1[s=M] is chained
    through the camera transform (reading s from the cache, not recomputing
    it). Returns (W, 3, 4): [c, (Σdc_c, Σdc_c·px, Σdc_c·py, Σdc_c·pz)]."""
    sm, c_pn = _pn_terms(norm2, scores, g, k.eps)
    m, inv_d, mx = norm2[:, 0:1], norm2[:, 1:2], norm2[:, 3:4]
    alpha, beta = norm2[:, 4:5], norm2[:, 5:6]
    ok = valid[None, :] > 0
    eqmin = (ok & (scores == m)).to(scores.dtype)
    eqmax = (ok & (scores == mx)).to(scores.dtype)
    total = c_pn * inv_d + alpha * eqmin + beta * eqmax
    _, e = _extras(wp, kp, pts_t, k)
    rows = []
    for dc in _dcam(total, scores, e, k):
        rows.append(torch.stack([dc.sum(1), (dc * pts_t[0]).sum(1),
                                 (dc * pts_t[1]).sum(1), (dc * pts_t[2]).sum(1)], dim=1))
    return torch.stack(rows, dim=1)


def bwd_apply(wp, kp, norm2, pts_t, valid, g, scores, k: VisConsts):
    if _on_cpu(scores):
        return bwd_apply_ref(wp, kp, norm2, pts_t, valid, g, scores, k)
    return _kernels.bwd_apply(wp, kp, norm2, pts_t, valid, g, scores, k)


# ---------------------------------------------------------------------------
# sums → parameter gradients, and the autograd function
# ---------------------------------------------------------------------------


def sums_to_param_grads(wp, sums):
    """(W, 3, 4) camera-plane sums → (W, 12) gradient packed like wp.

    cam_c = Σ_j (p_j − t_j) R_jc  ⇒  dR_jc = Σᵢ dc_c (pⱼ − tⱼ),
    dt_j = −Σ_c R_jc Σᵢ dc_c.
    """
    W = wp.shape[0]
    t = wp[:, 9:12]
    dR = sums[:, :, 1:4].transpose(1, 2) - t[:, :, None] * sums[:, :, 0][:, None, :]
    R = wp[:, 0:9].reshape(W, 3, 3)
    dt = -torch.einsum("wjc,wc->wj", R, sums[:, :, 0])
    return torch.cat([dR.reshape(W, 9), dt], dim=1)


def fused_acc_to_sums(acc, W):
    """(W, 40) single-pass-backward accumulator (the JAX twin's K5 layout:
    direct, min-tie and max-tie channels × 12, then Σ∂m, Σ∂M and the two tie
    counts) → (W, 3, 4) camera-plane sums."""
    direct, min_ch, max_ch = acc[:, 0:12], acc[:, 12:24], acc[:, 24:36]
    cnt_min = torch.clamp(acc[:, 38], min=1.0)
    cnt_max = torch.clamp(acc[:, 39], min=1.0)
    return (
        direct
        + min_ch * (acc[:, 36] / cnt_min)[:, None]
        + max_ch * (acc[:, 37] / cnt_max)[:, None]
    ).reshape(W, 3, 4)


class FusedLoSum(torch.autograd.Function):
    """wp (W, 12) → lo (N,), differentiable w.r.t. wp only.

    Forward: K1 → ``make_norm`` → K2. Backward: K3 → α, β → K4 →
    ``sums_to_param_grads``. The backward reads the ``norm`` and score cache
    saved by the forward, so the tie tests ``s == m`` see the very values the
    min/max were taken over.
    """

    @staticmethod
    def forward(ctx, wp, kp, pts_t, valid, consts: VisConsts):
        m, mx, scores = pass_a(wp, kp, pts_t, valid, consts)
        norm = make_norm(m, mx)
        lo = pass_b(norm, scores, consts.eps)
        ctx.save_for_backward(wp, kp, pts_t, valid, norm, scores)
        ctx.consts = consts
        return lo

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        wp, kp, pts_t, valid, norm, scores = ctx.saved_tensors
        k = ctx.consts
        g = g.contiguous()
        st = bwd_stats(norm, scores, valid, g, k.eps)
        alpha = st[:, 0] / torch.clamp(st[:, 2], min=1.0)
        beta = st[:, 1] / torch.clamp(st[:, 3], min=1.0)
        norm2 = torch.cat([norm, alpha[:, None], beta[:, None]], dim=1).contiguous()
        sums = bwd_apply(wp, kp, norm2, pts_t, valid, g, scores, k)
        return sums_to_param_grads(wp, sums), None, None, None, None


def fused_lo_sum(
    points: torch.Tensor,
    quats: torch.Tensor,
    trans: torch.Tensor,
    K: torch.Tensor,
    img_width: float,
    img_height: float,
    *,
    min_dist: float = 1.0,
    max_dist: float = 5.0,
    eps: float = 1e-6,
    valid: Optional[torch.Tensor] = None,
    points_t: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(N,) accumulated observation log-odds over W waypoints, through K1–K4.

    Drop-in equivalent of the score → normalize → clip → log-odds → sum
    chain of ``models.traj``; differentiable w.r.t. quats/trans. ``points_t``
    is the contiguous (3, N) transpose of ``points``: pass it to transpose
    once per problem instead of once per call.
    """
    N = points.shape[0]
    W = quats.shape[0]
    if points_t is None:
        points_t = points.t().contiguous()
    if valid is None:
        valid = torch.ones(N, dtype=points.dtype, device=points.device)
    if not _on_cpu(points_t) and W * N * 4 > SCORE_CACHE_MAX_BYTES:
        raise NotImplementedError(
            f"W·N·4 = {W * N * 4} B exceeds the 1 GiB score cache: the uncached "
            "regime needs K1′/K2′ and the single-pass backward K5 (pallas_vis.py "
            "_bwd_kernel), which are not ported yet (ROADMAP.md Q2)"
        )
    R = quat_ops.to_matrix(quat_ops.normalize(quats))  # differentiable prologue
    wp = torch.cat([R.reshape(W, 9), trans], dim=1).contiguous()
    kp = torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).contiguous()
    consts = make_consts(img_width, img_height, min_dist, max_dist, eps)
    return FusedLoSum.apply(wp, kp.to(points.dtype), points_t, valid.to(points.dtype), consts)
