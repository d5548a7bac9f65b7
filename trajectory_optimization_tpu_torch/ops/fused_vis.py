"""Fused visibility log-odds: the seven Hopper kernels, their plain versions,
and the autograd function that ties them together.

Twin of ``trajectory_optimization_tpu/ops/pallas_vis.py``. For W waypoints
and N points:

    s(w,i)   = σ(cz)·exp(−½(d²/σ² + xu² + xv²))       (ops.scores formulas)
    m_w, M_w = min_i / max_i s(w,i)   over valid points
    pn(w,i)  = clip((s − m_w)/max(M_w − m_w, 1e-8), 0.5, 1−eps)
    lo_i     = Σ_w log(pn/(1−pn))

Stages (kernel ids as in PERF.md; CUDA sources in ``csrc/fused_vis.cu``).
Score-cache regime, while the (W, N) f32 cache fits ``SCORE_CACHE_MAX_BYTES``
(decided by :func:`uses_score_cache`, the JAX twin's rule):

  K1 ``pass_a``     scores → (W, N) cache + per-waypoint masked min/max
  K2 ``pass_b``     cache → (N,) log-odds sum
  K3 ``bwd_stats``  per-waypoint Σ c_pn·∂pn/∂m, Σ c_pn·∂pn/∂M and tie counts,
                    and the need mask: one bit per pair that K4 must compute
  K4 ``bwd_apply``  combined cotangent chained to 12 camera-plane sums per w,
                    over the pairs the need mask flags

Uncached regime, above the budget; no stage holds a (W, N) tensor:

  K1′ ``pass_a_minmax``     recomputed scores → per-waypoint masked min/max
  K2′ ``pass_b_recompute``  recomputed scores → (N,) log-odds sum
  K5  ``bwd_fused_acc``     single-pass backward → (W, 40) sums per waypoint

Each stage has a plain PyTorch version beside it (``*_ref``) with the same
inputs and outputs. The stage wrapper runs the plain version for CPU tensors
only; for a CUDA tensor it launches the kernel (``ops._kernels``) or raises.
K2′ and K5 skip the pairs whose terms are exactly zero; ``skip_masks`` gives
their predicates in plain PyTorch, and ``warp_groups`` and
``with_extreme_ties`` help count and test them. K4 skips the same pairs, told
by the mask that K3 takes on the cached scores (``need_mask``, packed 32
pairs to an int32 word by ``pack_need``). Pass A (K1, K1′) finishes a
pair after the score's distance term where that already decides that the
pair changes neither min nor max; ``prune_masks`` gives those predicates.

Two callers: ``fused_lo_sum`` (the ``FusedLoSum`` autograd function below,
whose prologue and the criterion after it are plain PyTorch) and the kernel
backend of ``models.traj.traj_forward``, ``ops.fused_traj.FusedTraj``, which
runs the same stages between hand-written kernels of its own: its head
writes ``wp``, ``kp`` and pass A's preset min/max (``_kernels.pass_a(...,
minmax=...)``), and it finishes ``make_norm`` and K4's α/β in one launch
each. The regime rule is the same for both.

Layout: points as a contiguous SoA (3, N) f32, transposed once per problem;
``valid`` and the cotangent as (N,) f32; the waypoint table ``wp`` (W, 12) =
[R row-major 9, t 3]; ``kp`` (4,) = [fx, fy, cx, cy]; ``norm`` (W, 4) =
[m, 1/max(M − m, 1e-8), gate, M] and ``norm2`` (W, 6) adds α and β.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from trajectory_optimization_tpu_torch.ops import _kernels
from trajectory_optimization_tpu_torch.ops import quat as quat_ops

SCORE_CACHE_MAX_BYTES = 1 << 30  # the JAX twin's cache budget (pallas_vis.py)
SCORE_CACHE_TILE = 32768  # the JAX twin pads N to its point tile (TILE_ROWS·LANES)
SPAN_FLOOR = 1e-8
_BIG = _kernels.BIG


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


def uses_score_cache(W: int, N: int) -> bool:
    """The JAX twin's regime rule: cache the (W, N) scores while W times N
    padded to a multiple of its 32,768-point tile, at 4 B each, fits the
    budget (read at call time, so the budget can be patched)."""
    n_pad = -(-N // SCORE_CACHE_TILE) * SCORE_CACHE_TILE
    return W * n_pad * 4 <= SCORE_CACHE_MAX_BYTES


_on_cpu = _kernels.on_cpu


# ---------------------------------------------------------------------------
# shared score math (the plain twin of _tile_extras/_tile_scores/_tile_dcam)
# ---------------------------------------------------------------------------


def _extras(wp, kp, pts_t, k: VisConsts):
    """(W, N) transform/projection intermediates; s = sig·exp(arg). The
    kernels' ``tile_extras`` repeats these operations in this order, each
    rounded on its own, so both compute the same score bits on the card."""
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
    # × the f32 reciprocal of the image size, not ÷ it: PyTorch divides a CUDA
    # tensor by a Python scalar that way, so on the card this version and the
    # kernels compute the same bits (JAX divides; that differs by an ulp)
    xu_raw = (u * inv_zd - k.img_w * 0.5) * k.inv_w
    xv_raw = (v * inv_zd - k.img_h * 0.5) * k.inv_h
    xu = torch.clamp(xu_raw, -20.0, 20.0)
    xv = torch.clamp(xv_raw, -20.0, 20.0)
    sig = torch.sigmoid(cz)
    t0 = d2 * k.inv_var  # the distance term: arg ≤ −t0 / 2, what pass A prunes with
    arg = -0.5 * (t0 + xu * xu + xv * xv)
    return arg, dict(ex=ex, ey=ey, ez=ez, u=u, v=v, inv_zd=inv_zd, xu=xu, xv=xv, t0=t0,
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


def _scores(wp, kp, pts_t, k: VisConsts):
    arg, e = _extras(wp, kp, pts_t, k)
    return e["sig"] * torch.exp(arg), e


def _plane_sums(dcs, pts_t, sum_dtype=None):
    """(dcx, dcy, dcz), each (W, N) → (W, 12): [Σdc_c, Σdc_c·px, Σdc_c·py,
    Σdc_c·pz] for c = x, y, z; with ``sum_dtype`` the same terms are added
    in that type."""
    return torch.stack([(dc if axis is None else dc * pts_t[axis]).sum(1, dtype=sum_dtype)
                        for dc in dcs for axis in (None, 0, 1, 2)], dim=1)


def _pn_terms(norm, scores, g, eps):
    """Shared backward prologue: (s − m, c_pn, active) per (w, i), where
    active is the strict clip window and c_pn is the log-odds cotangent
    inside it and 0 outside it."""
    m, inv_d = norm[:, 0:1], norm[:, 1:2]
    sm = scores - m
    pn_raw = sm * inv_d
    active = (pn_raw > 0.5) & (pn_raw < 1.0 - eps)
    pn = torch.clamp(pn_raw, 0.5, 1.0 - eps)
    c_pn = torch.where(active, g[None, :] / (pn * (1.0 - pn)), torch.zeros_like(pn))
    return sm, c_pn, active


def _ties(norm, scores, valid):
    """Per (w, i): the valid min and max tie indicators (bool), s = m_w and
    s = M_w."""
    ok = valid[None, :] > 0
    return ok & (scores == norm[:, 0:1]), ok & (scores == norm[:, 3:4])


# ---------------------------------------------------------------------------
# K1 — pass A with score cache
# ---------------------------------------------------------------------------


def pass_a_ref(wp, kp, pts_t, valid, k: VisConsts):
    """Plain K1: (W, N) scores and their per-waypoint min/max over valid points.
    Returns (m (W,), M (W,), scores (W, N))."""
    s, _ = _scores(wp, kp, pts_t, k)
    ok = valid[None, :] > 0
    m = torch.amin(torch.where(ok, s, torch.full_like(s, _BIG)), dim=1)
    mx = torch.amax(torch.where(ok, s, torch.full_like(s, -_BIG)), dim=1)
    return m, mx, s


def pass_a(wp, kp, pts_t, valid, k: VisConsts):
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    if _on_cpu(pts_t):
        return pass_a_ref(wp, kp, pts_t, valid, k)
    return _kernels.pass_a(wp, kp, pts_t, valid, k)


def pass_a_minmax_ref(wp, kp, pts_t, valid, k: VisConsts):
    """Plain K1′: the per-waypoint min/max of K1 without keeping the scores.
    Returns (m (W,), M (W,))."""
    m, mx, _ = pass_a_ref(wp, kp, pts_t, valid, k)
    return m, mx


def pass_a_minmax(wp, kp, pts_t, valid, k: VisConsts):
    """K1′ on CUDA tensors, its plain version on CPU tensors."""
    if _on_cpu(pts_t):
        return pass_a_minmax_ref(wp, kp, pts_t, valid, k)
    return _kernels.pass_a_minmax(wp, kp, pts_t, valid, k)


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
# K2′ — pass B recomputing the scores
# ---------------------------------------------------------------------------


def pass_b_recompute_ref(wp, kp, norm, pts_t, k: VisConsts):
    """Plain K2′: K2 on scores recomputed from the waypoints. Returns (N,)."""
    s, _ = _scores(wp, kp, pts_t, k)
    return pass_b_ref(norm, s, k.eps)


def pass_b_recompute(wp, kp, norm, pts_t, k: VisConsts):
    if _on_cpu(pts_t):
        return pass_b_recompute_ref(wp, kp, norm, pts_t, k)
    return _kernels.pass_b_recompute(wp, kp, norm, pts_t, k)


# ---------------------------------------------------------------------------
# K3 — backward B1: min/max-pathway sums and tie counts
# ---------------------------------------------------------------------------


def _minmax_pathway(norm, scores, valid, g, eps):
    """Per (w, i): c_pn, the cotangents reaching m_w and M_w (c_pn·∂pn/∂m,
    c_pn·∂pn/∂M) and the valid min and max tie indicators."""
    sm, c_pn, _ = _pn_terms(norm, scores, g, eps)
    inv_d, gate = norm[:, 1:2], norm[:, 2:3]
    dm = c_pn * (-inv_d + sm * inv_d * inv_d * gate)
    dM = c_pn * (-(sm * inv_d * inv_d) * gate)
    eqmin, eqmax = (t.to(scores.dtype) for t in _ties(norm, scores, valid))
    return c_pn, dm, dM, eqmin, eqmax


def need_mask(norm, scores, valid, eps):
    """(W, N) bool: the pairs that can add a nonzero term to K4. A pair's
    term there is total·s·f with f finite, and total = c_pn·inv_d + α·1[s=m]
    + β·1[s=M] is zero unless the pair lies inside the strict clip window or
    is a valid min or max tie, so with finite α and β the term is exactly
    zero unless the pair is inside the window, or ties with s ≠ 0, or its
    score is not finite. The predicate ``direct | tie`` of ``skip_masks``,
    taken on the cached scores (with ±inf, which pass A never caches, flagged
    as NaN is); it does not depend on the cotangent."""
    pn_raw = (scores - norm[:, 0:1]) * norm[:, 1:2]
    active = (pn_raw > 0.5) & (pn_raw < 1.0 - eps)
    eqmin, eqmax = _ties(norm, scores, valid)
    return active | ~torch.isfinite(scores) | ((eqmin | eqmax) & (scores != 0))


def pack_need(mask):
    """(W, N) bool → (W, ⌈N/32⌉) int32: bit l of word j of row w is
    mask[w, 32 j + l]; the bits past N in the last word are 0."""
    W, N = mask.shape
    bits = torch.nn.functional.pad(mask, (0, (-N) % 32)).reshape(W, -1, 32).to(torch.int64)
    words = (bits << torch.arange(32, device=mask.device)).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_need(need, N: int):
    """(W, ⌈N/32⌉) int32 → (W, N) bool, the inverse of ``pack_need``."""
    bits = (need.to(torch.int64)[:, :, None] >> torch.arange(32, device=need.device)) & 1
    return bits.reshape(need.shape[0], -1)[:, :N].bool()


def bwd_stats_ref(norm, scores, valid, g, eps):
    """Plain K3. Returns the (W, 4) table [Σ c_pn·∂pn/∂m, Σ c_pn·∂pn/∂M,
    #(s = m), #(s = M)], the counts over valid points only, and the need
    mask for K4 (``need_mask``, packed by ``pack_need``)."""
    _, dm, dM, eqmin, eqmax = _minmax_pathway(norm, scores, valid, g, eps)
    table = torch.stack([dm.sum(1), dM.sum(1), eqmin.sum(1), eqmax.sum(1)], dim=1)
    return table, pack_need(need_mask(norm, scores, valid, eps))


def bwd_stats(norm, scores, valid, g, eps):
    if _on_cpu(scores):
        return bwd_stats_ref(norm, scores, valid, g, eps)
    return _kernels.bwd_stats(norm, scores, valid, g, eps)


# ---------------------------------------------------------------------------
# K4 — backward B2: combined cotangent → 12 camera-plane sums per waypoint
# ---------------------------------------------------------------------------


def _check_need(need, W: int, N: int):
    shape = (W, _kernels.need_words(N))
    if need.dtype != torch.int32 or tuple(need.shape) != shape:
        raise ValueError(f"need: expected int32 of shape {shape}, got {need.dtype} of shape "
                         f"{tuple(need.shape)}")


def _apply_total(norm2, scores, valid, g, eps):
    """K4's score cotangent per (w, i): c_pn·inv_d + α·1[s=m] + β·1[s=M]."""
    _, c_pn, _ = _pn_terms(norm2, scores, g, eps)
    inv_d, alpha, beta = norm2[:, 1:2], norm2[:, 4:5], norm2[:, 5:6]
    eqmin, eqmax = (t.to(scores.dtype) for t in _ties(norm2, scores, valid))
    return c_pn * inv_d + alpha * eqmin + beta * eqmax


def bwd_apply_ref(wp, kp, norm2, pts_t, valid, g, scores, need, k: VisConsts, sum_dtype=None):
    """Plain K4. The cotangent c_pn·inv_d + α·1[s=m] + β·1[s=M] is chained
    through the camera transform (reading s from the cache, not recomputing
    it). Computes every pair: ``need`` (K3's mask) is only checked for its
    type and shape, so this is the yardstick for what the mask leaves out.
    Returns (W, 3, 4): [c, (Σdc_c, Σdc_c·px, Σdc_c·py, Σdc_c·pz)], of
    ``sum_dtype`` if given: the same f32 terms, added in that type (float64
    where a summation order must not show: on a cloud in view of every
    waypoint the 12 sums cancel by six orders of magnitude)."""
    _check_need(need, *scores.shape)
    total = _apply_total(norm2, scores, valid, g, k.eps)
    _, e = _extras(wp, kp, pts_t, k)
    return _plane_sums(_dcam(total, scores, e, k), pts_t, sum_dtype).reshape(-1, 3, 4)


def bwd_apply_masked_ref(wp, kp, norm2, pts_t, valid, g, scores, need, k: VisConsts):
    """Plain K4 as the kernel computes it: every pair whose bit in ``need``
    is clear adds nothing. Where α or β is not finite, every pair of the
    waypoint has a NaN cotangent in the full version (α·0), flagged or not,
    so all 12 sums of that waypoint are NaN here as well."""
    _check_need(need, *scores.shape)
    total = _apply_total(norm2, scores, valid, g, k.eps)
    total = torch.where(unpack_need(need, scores.shape[1]), total, torch.zeros_like(total))
    _, e = _extras(wp, kp, pts_t, k)
    sums = _plane_sums(_dcam(total, scores, e, k), pts_t)
    poisoned = ~torch.isfinite(norm2[:, 4:6]).all(dim=1, keepdim=True)
    return torch.where(poisoned, torch.full_like(sums, float("nan")), sums).reshape(-1, 3, 4)


def bwd_apply(wp, kp, norm2, pts_t, valid, g, scores, need, k: VisConsts):
    if _on_cpu(scores):
        return bwd_apply_ref(wp, kp, norm2, pts_t, valid, g, scores, need, k)
    return _kernels.bwd_apply(wp, kp, norm2, pts_t, valid, g, scores, need, k)


# ---------------------------------------------------------------------------
# K5 — single-pass backward recomputing the scores
# ---------------------------------------------------------------------------


def bwd_fused_acc_ref(wp, kp, norm, pts_t, valid, g, k: VisConsts):
    """Plain K5. Recomputes the scores and returns the JAX twin's (W, 40)
    layout: the direct (c_pn·inv_d), min-tie (1[valid, s = m]) and max-tie
    (1[valid, s = M]) cotangents, each chained to 12 camera-plane sums, then
    Σ c_pn·∂pn/∂m, Σ c_pn·∂pn/∂M, #(s = m) and #(s = M)."""
    s, e = _scores(wp, kp, pts_t, k)
    c_pn, dm, dM, eqmin, eqmax = _minmax_pathway(norm, s, valid, g, k.eps)
    channels = [_plane_sums(_dcam(cot, s, e, k), pts_t)
                for cot in (c_pn * norm[:, 1:2], eqmin, eqmax)]
    tail = torch.stack([dm.sum(1), dM.sum(1), eqmin.sum(1), eqmax.sum(1)], dim=1)
    return torch.cat([*channels, tail], dim=1)


def bwd_fused_acc(wp, kp, norm, pts_t, valid, g, k: VisConsts):
    if _on_cpu(pts_t):
        return bwd_fused_acc_ref(wp, kp, norm, pts_t, valid, g, k)
    return _kernels.bwd_fused_acc(wp, kp, norm, pts_t, valid, g, k)


class SkipMasks(NamedTuple):
    """(W, N) bool masks of the pairs whose terms K5 and K2′ compute. Every
    other pair's terms are exactly zero for finite inputs, so the kernels
    skip them."""

    direct: torch.Tensor  # K5's direct channel and slots 36/37: c_pn ≠ 0, or s is NaN
    tie: torch.Tensor  # K5's tie channels: a valid min or max tie with s ≠ 0, or s is NaN
    unclipped: torch.Tensor  # K2′'s log term: pn above the 0.5 floor (log(0.5/0.5) = 0)


def skip_masks(wp, kp, norm, pts_t, valid, k: VisConsts) -> SkipMasks:
    """The predicates of K5's two warp votes and of K2′'s branch, on scores
    recomputed by the plain version. K5 needs a pair's gradient chain where
    ``direct | tie``. Used to count the work that the kernels do and to test
    that the pairs they skip add only zeros; not on the main path."""
    s, _ = _scores(wp, kp, pts_t, k)
    sm, _, active = _pn_terms(norm, s, torch.zeros_like(valid), k.eps)
    eqmin, eqmax = _ties(norm, s, valid)
    nan = torch.isnan(s)
    return SkipMasks(active | nan, ((eqmin | eqmax) & (s != 0)) | nan, sm * norm[:, 1:2] > 0.5)


class PruneMasks(NamedTuple):
    """(W, N) bool masks of the pairs that pass A finishes after the score's
    distance term t0 = d²·inv_var, disjoint."""

    zero: torch.Tensor  # t0 ≥ zero_t: the score is exactly +0 (K1 caches the 0; K1′ takes it)
    under_max: torch.Tensor  # K1′ only: the waypoint's min is 0 and t0 puts the score under M


def prune_masks(wp, kp, pts_t, k: VisConsts, m, M, zero_t: float = _kernels.PRUNE_ZERO_T,
                max_margin: float = _kernels.PRUNE_MAX_MARGIN) -> PruneMasks:
    """The predicates of pass A's pruning in plain PyTorch, with the kernels'
    constants. ``m`` and ``M`` (W,) are a waypoint's min and max so far: any
    scores of its valid points, as the kernels' running values are, or the
    final ones, which prune the most. Since s ≤ exp(arg) and arg ≤ −t0 / 2,
    ``zero`` pairs have s = +0 exactly (for finite inputs; NaN fails every
    test) and ``under_max`` pairs s ≤ M, where m = 0 means no score can lower
    the min any more. Used to count the work that the kernels do and to test
    that what they leave out cannot change min or max; not on the main path."""
    t0 = _extras(wp, kp, pts_t, k)[1]["t0"]
    zero = t0 >= zero_t
    thr = torch.where((m == 0) & (M >= _kernels.PRUNE_MAX_FLOOR), -2.0 * torch.log(M) + max_margin,
                      torch.full_like(M, float("inf")))
    return PruneMasks(zero, ~zero & (t0 > thr[:, None]))


def warp_groups(mask):
    """Per waypoint, whether each 32-point group (one warp's points, aligned
    as the kernels align them) holds a True: (W, ceil(N / 32)) bool."""
    pad = torch.nn.functional.pad(mask, (0, (-mask.shape[1]) % 32))
    return pad.reshape(mask.shape[0], -1, 32).any(-1)


def with_extreme_ties(wp, kp, pts_t, k: VisConsts):
    """``pts_t`` (3, N) with two copies of each waypoint's lowest- and
    highest-scoring point put first (3, N + 4W): on a cloud whose scores do
    not underflow, min and max ties with s ≠ 0, which K5 must chain."""
    s, _ = _scores(wp, kp, pts_t, k)
    lo, hi = pts_t[:, s.argmin(1)], pts_t[:, s.argmax(1)]
    return torch.cat([lo, hi, lo, hi, pts_t], dim=1).contiguous()


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

    Score-cache regime: forward K1 → ``make_norm`` → K2, backward K3 → α, β
    → K4 on the pairs K3's need mask flags; the backward reads the saved
    ``norm`` and score cache, so the tie tests ``s == m`` see the very values
    the min/max were taken over.
    Uncached regime: forward K1′ → ``make_norm`` → K2′, backward K5 →
    ``fused_acc_to_sums``; K5's recomputed scores are the bits K1′ took the
    min/max over. Both end in ``sums_to_param_grads``.
    """

    @staticmethod
    def forward(ctx, wp, kp, pts_t, valid, consts: VisConsts):
        if uses_score_cache(wp.shape[0], pts_t.shape[1]):
            m, mx, scores = pass_a(wp, kp, pts_t, valid, consts)
            norm = make_norm(m, mx)
            lo = pass_b(norm, scores, consts.eps)
        else:
            m, mx = pass_a_minmax(wp, kp, pts_t, valid, consts)
            norm = make_norm(m, mx)
            lo = pass_b_recompute(wp, kp, norm, pts_t, consts)
            scores = None
        ctx.save_for_backward(wp, kp, pts_t, valid, norm, scores)
        ctx.consts = consts
        return lo

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        wp, kp, pts_t, valid, norm, scores = ctx.saved_tensors
        k = ctx.consts
        g = g.contiguous()
        if scores is None:
            acc = bwd_fused_acc(wp, kp, norm, pts_t, valid, g, k)
            sums = fused_acc_to_sums(acc, wp.shape[0])
        else:
            st, need = bwd_stats(norm, scores, valid, g, k.eps)
            alpha = st[:, 0] / torch.clamp(st[:, 2], min=1.0)
            beta = st[:, 1] / torch.clamp(st[:, 3], min=1.0)
            norm2 = torch.cat([norm, alpha[:, None], beta[:, None]], dim=1).contiguous()
            sums = bwd_apply(wp, kp, norm2, pts_t, valid, g, scores, need, k)
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
    """(N,) accumulated observation log-odds over W waypoints, through K1–K4
    or, when the score cache would exceed its budget, K1′, K2′ and K5.

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
    R = quat_ops.to_matrix(quat_ops.normalize(quats))  # differentiable prologue
    wp = torch.cat([R.reshape(W, 9), trans], dim=1).contiguous()
    kp = torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).contiguous()
    consts = make_consts(img_width, img_height, min_dist, max_dist, eps)
    return FusedLoSum.apply(wp, kp.to(points.dtype), points_t, valid.to(points.dtype), consts)
