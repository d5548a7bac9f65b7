"""The kernel backend's trajectory loss: forward and hand-derived backward as
one autograd function, hand-written kernels around the visibility kernels.

On the plain path (``fused_lo_sum`` then ``models.traj.traj_criterion``)
the quaternion prologue, the criterion and their autograd backward are some
three hundred PyTorch operations on (W, ·) tensors around K1–K4, each one a
launch and, in a captured step, a graph node that costs the card about a
microsecond whatever it computes. Here they are six kernels
(``csrc/fused_traj.cu``). None replaces a Pallas kernel: the JAX twin leaves
this work to XLA, which fuses it. For W waypoints, W_s = ⌈W / wps_step⌉ of
them scored, and N points:

Forward

  traj_head     quats[::step] → normalize → R, and poses[::step], into the
                (W_s, 12) table ``wp``; ``kp`` (4,) from K; pass A's (2, W_s)
                min/max preset to its sentinels                   one block
  K1 or K1′     (``ops.fused_vis``, unchanged) → min/max (and the score cache)
  make_norm     min/max → the (W_s, 4) table ``norm``             one block
  K2 or K2′     (unchanged) → lo (N,)
  traj_loss     rewards = σ(lo), the valid-weighted mean (block partials
                finished by the last block to arrive), then the anchor,
                smoothness and length terms over all W, the loss and the aux
                scalars                                           over N

Backward

  lo_cotangent  ∂loss/∂lo from lo, the rewards, valid and the mean   over N
  K3, alpha_beta, K4   score-cache regime (K3, K4 unchanged; alpha_beta one
                block: the (W_s, 6) ``norm2``), or K5 alone above the cache
                budget (unchanged; its (W_s, 40) sums go to the tail)
  traj_tail     camera-plane sums → ∂wp → ∂q̂ → ∂q through the normalization,
                on the scored waypoints, plus the anchor, smoothness and length
                gradients over all W → (W, 3), (W, 4)              one block

The regime is ``fused_vis.uses_score_cache(W_s, N)``, as ``fused_lo_sum``
decides it. Each stage has a plain PyTorch version here (``*_ref``), which
the stage runs for CPU tensors; for CUDA tensors it launches the kernel
(``ops._kernels``) or raises. The plain versions of the backward are the
chain rule of the plain path written out: ``tests/test_torch_fused_traj.py``
holds them against autograd through ``fused_lo_sum`` and ``traj_criterion``.
The loss and the gradients of ``poses`` and ``quats`` are the only
differentiable outputs: the aux scalars and the rewards are marked
non-differentiable.

``aux`` is one (8,) tensor: the five scalars of ``traj_criterion``'s aux,
then what the backward reads again (the mean's clamped denominator, the
mean segment angle, the length difference).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from trajectory_optimization_tpu_torch.ops import _kernels
from trajectory_optimization_tpu_torch.ops import fused_vis as fv
from trajectory_optimization_tpu_torch.ops import quat as quat_ops
from trajectory_optimization_tpu_torch.ops.numerics import safe_norm
from trajectory_optimization_tpu_torch.ops.trajectory import mean_segment_angle, polyline_length

AUX = ("mean_reward", "loss_vis", "loss_l2", "loss_smooth", "loss_length")
AUX_SLOTS = 8  # AUX, then the denominator, the mean angle and the length difference
QUAT_EPS = 1e-12  # quat.normalize's floor on the norm
ANGLE_MARGIN = 1e-6  # numerics.acos_clipped's gradient margin

_on_cpu = _kernels.on_cpu


class TrajConsts(NamedTuple):
    """The criterion's scalars, as Python floats, and the scoring stride."""

    eps: float
    smoothness_weight: float
    length_weight: float
    wps_step: int
    angle_margin: float = ANGLE_MARGIN


def make_traj_consts(problem) -> TrajConsts:
    """From a ``TrajProblem`` (duck-typed)."""
    return TrajConsts(float(problem.eps), float(problem.smoothness_weight),
                      float(problem.length_weight), int(problem.wps_step))


def n_scored(W: int, step: int) -> int:
    return -(-W // step)


# ---------------------------------------------------------------------------
# forward stages
# ---------------------------------------------------------------------------


def traj_head_ref(poses, quats, K, step: int):
    """Plain traj_head: (wp (W_s, 12), kp (4,)), the prologue of
    ``fused_lo_sum`` on the scored waypoints."""
    q = quats[::step]
    R = quat_ops.to_matrix(quat_ops.normalize(q, QUAT_EPS))
    wp = torch.cat([R.reshape(q.shape[0], 9), poses[::step]], dim=1)
    return wp, torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).to(poses.dtype)


def traj_head(poses, quats, K, step: int):
    """(wp, kp, minmax): on the card ``minmax`` is pass A's (2, W_s) output,
    preset; on the CPU it is None (the plain pass A makes its own)."""
    if _on_cpu(poses):
        return (*traj_head_ref(poses, quats, K, step), None)
    return _kernels.traj_head(poses, quats, K, step)


def make_norm_ref(minmax):
    """Plain make_norm: (2, W_s) min/max → (W_s, 4) ``fused_vis.make_norm``."""
    return fv.make_norm(minmax[0], minmax[1])


def make_norm(minmax):
    if _on_cpu(minmax):
        return make_norm_ref(minmax)
    return _kernels.make_norm(minmax)


def traj_loss_ref(lo, valid, poses, poses0, c: TrajConsts):
    """Plain traj_loss: ``models.traj.traj_criterion`` on lo (``c`` stands in
    for its problem), then the three scalars the backward reads again.
    Returns (loss (), aux (AUX_SLOTS,), rewards (N,))."""
    from trajectory_optimization_tpu_torch.models.traj import traj_criterion  # imports this module

    loss, out = traj_criterion(lo, {"poses": poses}, poses0, c, valid=valid)
    den = torch.clamp(torch.sum(valid), min=1.0)
    phibar = mean_segment_angle(poses, c.eps)
    dlen = polyline_length(poses) - polyline_length(poses0)
    aux = torch.stack([out[name] for name in AUX] + [den, phibar, dlen])
    return loss, aux, out["rewards"]


def traj_loss(lo, valid, poses, poses0, c: TrajConsts):
    if _on_cpu(lo):
        return traj_loss_ref(lo, valid, poses, poses0, c)
    return _kernels.traj_loss(lo, valid, poses, poses0, c)


# ---------------------------------------------------------------------------
# backward stages
# ---------------------------------------------------------------------------


def lo_cotangent_ref(g_loss, lo, rewards, valid, aux):
    """Plain lo_cotangent: ∂loss/∂lo (N,), in autograd's order: through
    loss_vis = 1/(mean + eps), mean = Σ r·valid / den and r = 1/(1 + e^−lo)."""
    loss_vis, den = aux[1], aux[5]
    g_mean = -g_loss * (loss_vis * loss_vis)
    g_r = (g_mean / den) * valid
    g_x = -g_r * (rewards * rewards)
    return -(g_x * torch.exp(-lo))


def lo_cotangent(g_loss, lo, rewards, valid, aux):
    if _on_cpu(lo):
        return lo_cotangent_ref(g_loss, lo, rewards, valid, aux)
    return _kernels.lo_cotangent(g_loss, lo, rewards, valid, aux)


def alpha_beta_ref(stats, norm):
    """Plain alpha_beta: K3's (W_s, 4) table and ``norm`` → the (W_s, 6)
    ``norm2`` of K4 (α, β: the min and max cotangents over their ties)."""
    alpha = stats[:, 0] / torch.clamp(stats[:, 2], min=1.0)
    beta = stats[:, 1] / torch.clamp(stats[:, 3], min=1.0)
    return torch.cat([norm, alpha[:, None], beta[:, None]], dim=1)


def alpha_beta(stats, norm):
    if _on_cpu(stats):
        return alpha_beta_ref(stats, norm)
    return _kernels.alpha_beta(stats, norm)


def _rotation_vjp(q, dR):
    """``quat.to_matrix``'s backward: (W, 4) unit quaternions and (W, 3, 3)
    ∂R → ∂q̂ (W, 4)."""
    w, x, y, z = q.unbind(-1)
    d = dR.reshape(-1, 9).unbind(-1)  # d[3 j + c] = ∂R_jc
    dw = 2.0 * (z * (d[3] - d[1]) + y * (d[2] - d[6]) + x * (d[7] - d[5]))
    dx = (-4.0 * x * (d[4] + d[8]) + 2.0 * y * (d[1] + d[3]) + 2.0 * z * (d[2] + d[6])
          + 2.0 * w * (d[7] - d[5]))
    dy = (-4.0 * y * (d[0] + d[8]) + 2.0 * x * (d[1] + d[3]) + 2.0 * w * (d[2] - d[6])
          + 2.0 * z * (d[5] + d[7]))
    dz = (-4.0 * z * (d[0] + d[4]) + 2.0 * w * (d[3] - d[1]) + 2.0 * x * (d[2] + d[6])
          + 2.0 * y * (d[5] + d[7]))
    return torch.stack([dw, dx, dy, dz], dim=-1)


def _normalize_vjp(q, dqh):
    """``quat.normalize``'s backward: q / max(‖q‖, 1e-12), the floor's
    gradient 0 below it and ‖·‖'s 0 at 0."""
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    d = torch.clamp(n, min=QUAT_EPS)
    dn = torch.where(n >= QUAT_EPS, q / torch.where(n > 0, n, torch.ones_like(n)),
                     torch.zeros_like(q))
    return dqh / d - torch.sum(dqh * q, dim=-1, keepdim=True) / (d * d) * dn


def _norm_vjp(x, n, g_n):
    """``safe_norm``'s backward over the last axis: g·x/‖x‖, 0 where ‖x‖ = 0."""
    scale = torch.where(n != 0, g_n / torch.where(n != 0, n, torch.ones_like(n)),
                        torch.zeros_like(n))
    return scale[..., None] * x


def criterion_grads_ref(g_loss, poses, poses0, aux, c: TrajConsts):
    """∂loss/∂poses (W, 3) of the anchor, smoothness and length terms."""
    W = poses.shape[0]
    g = torch.zeros_like(poses)
    diff = poses[0] - poses0[0]
    g[0] += _norm_vjp(diff[None], safe_norm(diff, dim=-1)[None], g_loss[None])[0]
    if W >= 3:
        ab = poses[:-2] - poses[1:-1]
        ac = poses[2:] - poses[1:-1]
        na, nc = safe_norm(ab, dim=-1), safe_norm(ac, dim=-1)
        dot = torch.sum(ab * ac, dim=-1)
        den = na * nc + c.eps
        cos = dot / den
        rt = 1.0 / (aux[6] + c.eps)
        g_phi = -(g_loss * c.smoothness_weight) * (rt * rt) / (W - 2)
        lo_b, hi_b = -1.0 + c.angle_margin, 1.0 - c.angle_margin
        cg = torch.clamp(cos, lo_b, hi_b)
        g_cos = torch.where((cos >= lo_b) & (cos <= hi_b),
                            -g_phi * torch.rsqrt(1.0 - cg * cg), torch.zeros_like(cos))
        g_dot = g_cos / den
        g_den = -g_cos * dot / (den * den)
        g_ab = g_dot[:, None] * ac + _norm_vjp(ab, na, g_den * nc)
        g_ac = g_dot[:, None] * ab + _norm_vjp(ac, nc, g_den * na)
        g[:-2] += g_ab
        g[2:] += g_ac
        g[1:-1] -= g_ab + g_ac
    if W >= 2:
        seg = poses[1:] - poses[:-1]
        dlen = aux[7]
        g_len = g_loss * c.length_weight * torch.where(dlen >= 0, 1.0, -1.0).to(poses.dtype)
        g_seg = _norm_vjp(seg, safe_norm(seg, dim=-1), g_len.expand(W - 1))
        g[1:] += g_seg
        g[:-1] -= g_seg
    return g


def traj_tail_ref(sums, wp, quats, poses, poses0, aux, g_loss, c: TrajConsts):
    """Plain traj_tail. ``sums`` is K4's (W_s, 3, 4) camera-plane sums or
    K5's (W_s, 40) accumulator. Returns (∂poses (W, 3), ∂quats (W, 4))."""
    W_s, step = wp.shape[0], c.wps_step
    if sums.shape[-1] == _kernels.BWD_SLOTS:
        sums = fv.fused_acc_to_sums(sums, W_s)
    g_wp = fv.sums_to_param_grads(wp, sums)
    q = quats[::step]
    g_quats = torch.zeros_like(quats)
    g_quats[::step] = _normalize_vjp(q, _rotation_vjp(quat_ops.normalize(q, QUAT_EPS),
                                                      g_wp[:, :9]))
    g_poses = criterion_grads_ref(g_loss, poses, poses0, aux, c)
    g_poses[::step] += g_wp[:, 9:]
    return g_poses, g_quats


def traj_tail(sums, wp, quats, poses, poses0, aux, g_loss, c: TrajConsts):
    if _on_cpu(wp):
        return traj_tail_ref(sums, wp, quats, poses, poses0, aux, g_loss, c)
    return _kernels.traj_tail(sums, wp, quats, poses, poses0, aux, g_loss, c)


# ---------------------------------------------------------------------------
# the autograd function
# ---------------------------------------------------------------------------


def _pass_a(wp, kp, pts_t, valid, k, preset, cached: bool):
    """K1 (cached: also the scores) or K1′ into the (2, W_s) min/max."""
    if _on_cpu(pts_t):
        m, mx, scores = fv.pass_a_ref(wp, kp, pts_t, valid, k)
        return torch.stack([m, mx]), scores if cached else None
    if cached:
        _, _, scores = _kernels.pass_a(wp, kp, pts_t, valid, k, minmax=preset)
        return preset, scores
    _kernels.pass_a_minmax(wp, kp, pts_t, valid, k, minmax=preset)
    return preset, None


class FusedTraj(torch.autograd.Function):
    """(poses (W, 3), quats (W, 4)) → (loss (), aux (AUX_SLOTS,), rewards
    (N,)), differentiable in the loss w.r.t. poses and quats only."""

    @staticmethod
    def forward(ctx, poses, quats, poses0, K, pts_t, valid, c: TrajConsts, k: fv.VisConsts):
        cached = fv.uses_score_cache(n_scored(poses.shape[0], c.wps_step), pts_t.shape[1])
        wp, kp, preset = traj_head(poses, quats, K, c.wps_step)
        minmax, scores = _pass_a(wp, kp, pts_t, valid, k, preset, cached)
        norm = make_norm(minmax)
        if cached:
            lo = fv.pass_b(norm, scores, k.eps)
        else:
            lo = fv.pass_b_recompute(wp, kp, norm, pts_t, k)
        loss, aux, rewards = traj_loss(lo, valid, poses, poses0, c)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(aux, rewards)
        ctx.save_for_backward(poses, quats, poses0, wp, kp, pts_t, valid, norm, scores, lo,
                              rewards, aux)
        ctx.consts = (c, k)
        return loss, aux, rewards

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_loss, _g_aux, _g_rewards):
        if g_loss is None:
            return (None,) * 8
        poses, quats, poses0, wp, kp, pts_t, valid, norm, scores, lo, rewards, aux = (
            ctx.saved_tensors)
        c, k = ctx.consts
        g_loss = g_loss.contiguous()
        g = lo_cotangent(g_loss, lo, rewards, valid, aux)
        if scores is None:
            sums = fv.bwd_fused_acc(wp, kp, norm, pts_t, valid, g, k)
        else:
            stats, need = fv.bwd_stats(norm, scores, valid, g, k.eps)
            norm2 = alpha_beta(stats, norm)
            sums = fv.bwd_apply(wp, kp, norm2, pts_t, valid, g, scores, need, k)
        g_poses, g_quats = traj_tail(sums, wp, quats, poses, poses0, aux, g_loss, c)
        return g_poses, g_quats, None, None, None, None, None, None


def fused_traj(params, points, K, poses0, problem, *, valid: Optional[torch.Tensor] = None,
               points_t: Optional[torch.Tensor] = None):
    """``traj_forward``'s (loss, aux) on the kernel backend. ``problem`` is
    duck-typed (a ``TrajProblem``); ``points_t`` is the contiguous (3, N)
    transpose of ``points`` (pass it to transpose once per problem)."""
    poses, quats = params["poses"], params["quats"]
    if points_t is None:
        points_t = points.t().contiguous()
    if valid is None:
        valid = torch.ones(points.shape[0], dtype=points.dtype, device=points.device)
    k = fv.make_consts(problem.img_width, problem.img_height, problem.min_dist,
                       problem.max_dist, problem.eps)
    loss, aux, rewards = FusedTraj.apply(poses, quats, poses0, K.to(points.dtype).contiguous(), points_t,
                                         valid.to(points.dtype), make_traj_consts(problem), k)
    out = {name: aux[i] for i, name in enumerate(AUX)}
    out["rewards"] = rewards
    return loss, out

