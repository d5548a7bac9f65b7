"""Hidden-point removal (Katz spherical-flip HPR).

Twin of ``trajectory_optimization_tpu/ops/hpr.py``'s dense tiers: flip the
cloud about the camera with R = max‖p‖·10^r_param, append the origin, take
the convex hull; the hull's vertices are the visible points.

1. :func:`hpr_mask_exact` — the hull by Qhull (scipy), the reference's own
   backend; host numpy, not differentiable, copied from the JAX package.
2. :func:`hpr_mask_approx` — every point pursues a witness direction of the
   support function, refined per pass by Agmon–Motzkin relaxation against
   its current blocker; a support winner that beats its runner-up by more
   than ``rel_tol``·2R is a hull vertex. Takes (N, 3) or a batch (C, N, 3)
   (one pursuit for a whole camera rig), on any device, without gradients.
3. :func:`hpr_mask_soft` — the differentiable relaxation: σ(β·(ρ'ᵢ + τ·scale
   − softmaxⱼ ρ'ⱼcosθᵢⱼ)), the (N, N) dominance reduced in row blocks with a
   hand-derived backward, so memory stays O(block·N) with gradients too.

The direction-binned soft tier (``hpr_mask_soft_binned``) is not ported:
:func:`soft_hpr_gate` raises for clouds above the dense size.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from trajectory_optimization_tpu_torch.ops.numerics import safe_norm

_BIG_SOFT = 1.0e30  # self-exclusion sentinel and runner-up mask
# Elements of one (C, rows, N) support tile of hpr_mask_approx or one
# (rows, N) dominance tile of hpr_mask_soft: ``block`` rows at most, fewer
# where a tile would exceed the budget. On the card 256 MiB in f32; on the
# CPU 8 MiB, so that a tile's passes stay in cache (3x faster than 1,024
# rows at 8,192 points). The reductions are per row, so the mask does not
# depend on the row count.
TILE_BUDGET = {"cuda": 1 << 26, "cpu": 1 << 21}
# The profiler range of the soft dominance tile's forward and backward, by
# which a trace separates its time from the rest of a step.
SOFT_DOMINANCE_RANGE = "hpr.soft_dominance"


def _tile_rows(block: int, row_elems: int, t: torch.Tensor) -> int:
    budget = TILE_BUDGET["cuda" if t.is_cuda else "cpu"]
    return max(1, min(int(block), budget // max(row_elems, 1)))


@contextlib.contextmanager
def _full_f32_matmul(t: torch.Tensor):
    """Full-precision f32 matmuls on the card for the duration (TF32 off),
    whatever the process has set; nothing to do on the CPU. The approx
    margin gate, rel_tol·2R, is about two f32 ulps of 2R: TF32's 10-bit
    mantissa would let rounding crown non-vertices."""
    if not (t.is_cuda and torch.backends.cuda.matmul.allow_tf32):
        yield
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True


def _maximum(x: torch.Tensor, floor: float) -> torch.Tensor:
    """max(x, floor) with the cotangent split 0.5/0.5 at a tie, as
    ``jnp.maximum`` splits it (``torch.clamp`` passes all of it)."""
    return torch.maximum(x, x.new_tensor(floor))


def spherical_flip(points: torch.Tensor, r_param: float = 2.0) -> torch.Tensor:
    """Katz spherical flip of (N, 3) points: p' = p·(2R − ‖p‖)/‖p‖ + p with
    R = max‖p‖·10^r_param. Differentiable, with a finite gradient at
    ‖p‖ = 0 (``safe_norm``)."""
    norms = safe_norm(points, dim=-1)
    radius = torch.amax(norms) * 10.0 ** r_param  # amax spreads ties as jnp.max
    safe = _maximum(norms, 1e-12)
    scale = (2.0 * (radius - norms) / safe) + 1.0
    return points * scale[:, None]


def hpr_mask_exact(
    points: np.ndarray, r_param: float = 2.0, radius: Optional[float] = None
) -> np.ndarray:
    """Exact Katz HPR visible-point mask via Qhull (host-side, reference parity).

    Args:
      points: (N, 3) cloud, camera at the origin.
      r_param: flip-radius exponent (reference default 2).
      radius: override the flip radius directly (the Open3D variant uses
        100 · cloud diameter, `src/tools.py:107`).

    Returns (N,) bool visibility mask.
    """
    from scipy.spatial import ConvexHull  # Qhull — the reference's own backend

    pts = np.asarray(points, dtype=np.float64)
    n = len(pts)
    norms = np.linalg.norm(pts, axis=1)
    if radius is None:
        radius = norms.max() * 10.0 ** r_param
    safe = np.maximum(norms, 1e-12)
    flipped = pts * ((2.0 * (radius - norms) / safe) + 1.0)[:, None]
    hull = ConvexHull(np.vstack([flipped, np.zeros(3)]))
    mask = np.zeros(n, dtype=bool)
    mask[[v for v in hull.vertices if v < n]] = True
    return mask


def hpr_points_exact(points: np.ndarray, r_param: float = 2.0) -> Tuple[np.ndarray, np.ndarray]:
    """(visible_points, mask) — the reference's `hidden_pts_removal` return
    shape (`src/tools.py:67-85`)."""
    mask = hpr_mask_exact(points, r_param)
    return np.asarray(points)[mask], mask


@torch.no_grad()
def hpr_mask_approx(
    points: torch.Tensor,
    r_param: float = 2.0,
    *,
    block: int = 1024,
    n_passes: int = 16,
    full_passes: int = 4,
    relax: float = 1.9,
    rel_tol: float = 1e-7,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """HPR visible mask by adaptive support-function pursuit.

    A flipped point p'ᵢ is a hull vertex (visible) iff it is the argmax of
    d ↦ maxⱼ p'ⱼ·d for some direction d. Each point starts from its radial
    direction; on each pass its blocker b = argmaxⱼ p'ⱼ·dᵢ defines the
    violated constraint (p'ᵢ − p'_b)·d > 0 and dᵢ moves ``relax`` of the way
    onto its boundary. After ``full_passes`` passes over every point, the
    pursuit continues for the ⌈N/4⌉ rows with the smallest key (unfound
    first, then the smallest separation deficit; stable sort). A winner is
    marked only where it beats the runner-up by more than ``rel_tol``·2R, so
    an f32 tie never crowns a non-vertex.

    ``points`` is (N, 3) or (C, N, 3), each cloud with its camera at the
    origin; ``valid`` is (N,) or (C, N) 0/1: padding sets no radius, never
    wins and reports 0. Each pass is one (C, rows, 3) × (C, 3, N) f32
    matmul per row block (TF32 off) and its per-row reductions, rows capped
    by ``TILE_BUDGET``. Returns a float mask in {0, 1} of the shape
    of ``valid``.
    """
    single = points.dim() == 2
    P = points[None] if single else points
    v = None if valid is None else (valid[None] if single else valid) > 0
    C, n = P.shape[0], P.shape[1]
    norms = torch.sqrt(torch.sum(P * P, dim=-1))  # (C, N)
    norms_v = norms if v is None else torch.where(v, norms, torch.zeros_like(norms))
    radius = torch.clamp(torch.amax(norms_v, dim=-1, keepdim=True), min=1e-12) * 10.0 ** r_param
    rho = 2.0 * radius - norms  # flipped radii (the flip keeps directions)
    u = P / torch.clamp(norms, min=1e-12)[..., None]
    if v is not None:
        # padding supports nothing (0 in every test) and its probe rows have
        # a zero projection, whose margin never clears the gate
        rho = torch.where(v, rho, torch.zeros_like(rho))
        u = torch.where(v[..., None], u, torch.zeros_like(u))
    inv2r = 1.0 / (2.0 * radius)  # (C, 1)
    thresh = rel_tol * 2.0 * radius
    s = rho[..., None] * u  # the flipped points, (C, N, 3)
    s_t = s.transpose(1, 2).contiguous()  # (C, 3, N)
    rows = _tile_rows(block, C * n, P)

    def sweep(d):
        """One pass for (C, m) probe directions against all N points:
        winner, max support and winner-vs-runner-up margin per row."""
        win, maxv, margin = [], [], []
        with _full_f32_matmul(d):
            for r0 in range(0, d.shape[1], rows):
                proj = torch.bmm(d[:, r0:r0 + rows], s_t)  # (C, rows, N)
                mv, w = torch.max(proj, dim=-1)  # the first maximal index
                proj.scatter_(-1, w[..., None], -_BIG_SOFT)
                win.append(w)
                maxv.append(mv)
                margin.append(mv - torch.amax(proj, dim=-1))
        return torch.cat(win, 1), torch.cat(maxv, 1), torch.cat(margin, 1)

    def gather(x, idx):
        if x.dim() == 2:
            return torch.gather(x, 1, idx)
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

    def update(d, rho_i, u_i, winners, maxv):
        s_own = rho_i * torch.sum(u_i * d, dim=-1)
        deficit = (maxv - s_own) * inv2r  # >= 0 while the point is blocked
        gv = (rho_i[..., None] * u_i
              - gather(rho, winners)[..., None] * gather(u, winners)) * inv2r[..., None]
        g2 = torch.sum(gv * gv, dim=-1)
        d2 = d + (relax * deficit / torch.clamp(g2, min=1e-18))[..., None] * gv
        d2 = d2 / torch.clamp(torch.linalg.norm(d2, dim=-1, keepdim=True), min=1e-12)
        return d2, deficit

    def mark(mask, winners, margin):
        # deterministic: amax does not depend on the order of the writes
        return mask.scatter_reduce_(1, winners, (margin > thresh).to(mask.dtype), "amax")

    mask = torch.zeros((C, n), dtype=P.dtype, device=P.device)
    d = u
    deficit = torch.zeros_like(mask)
    k_full = min(full_passes, n_passes)
    for p in range(k_full):
        winners, maxv, margin = sweep(d)
        mark(mask, winners, margin)
        if p + 1 < n_passes:
            d, deficit = update(d, rho, u, winners, maxv)

    if n_passes > k_full:
        m_sub = -(-n // 4)
        key = mask * 1e9 + deficit  # unfound first, smallest deficit first
        if v is not None:
            key = key + torch.where(v, 0.0, 2e9)  # padding rows sort last
        ids = torch.argsort(key, dim=1, stable=True)[:, :m_sub]
        d = gather(d, ids)
        rho_i, u_i = gather(rho, ids), gather(u, ids)
        for p in range(k_full, n_passes):
            winners, maxv, margin = sweep(d)
            mark(mask, winners, margin)
            if p + 1 < n_passes:
                d, _ = update(d, rho_i, u_i, winners, maxv)

    if v is not None:
        mask = mask * v.to(mask.dtype)
    return mask[0] if single else mask


def _dominance_tiles(u, rho, beta, rows):
    """Yield (r0, r1, cos, dom·β) for each (rows, N) tile of the dominance:
    cos the f32 dot products of the row block with every direction (TF32
    off), dom = max(clip(cos, −1, 1), 0)·ρⱼ with −1e30 on the diagonal."""
    n = u.shape[0]
    u_t = u.t().contiguous()
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        with _full_f32_matmul(u):
            cos = u[r0:r1] @ u_t
        dom = torch.clamp(cos, 0.0, 1.0) * rho
        dom[:, r0:r1].diagonal().fill_(-_BIG_SOFT)
        yield r0, r1, cos, dom.mul_(beta)


class _SoftLSE(torch.autograd.Function):
    """lseᵢ = logsumexpⱼ(β·domᵢⱼ) over the (N, N) dominance of
    ``hpr_mask_soft``, computed and differentiated in row blocks: nothing of
    size N² is kept between forward and backward. The backward recomputes
    each tile and its softmax weights wᵢⱼ = exp(β·domᵢⱼ − lseᵢ); the
    derivative of max(clip(cos, −1, 1), 0) is ½ at cos = 0 and at cos = 1,
    the ties where ``jnp.maximum``/``jnp.clip`` split the cotangent."""

    @staticmethod
    def forward(ctx, u, rho, beta, rows):
        lse = torch.empty_like(rho)
        with torch.profiler.record_function(SOFT_DOMINANCE_RANGE):
            for r0, r1, _, x in _dominance_tiles(u, rho, beta, rows):
                lse[r0:r1] = torch.logsumexp(x, dim=1)
        ctx.save_for_backward(u, rho, beta, lse)
        ctx.rows = rows
        return lse

    @staticmethod
    def backward(ctx, g):
        u, rho, beta, lse = ctx.saved_tensors
        du, drho = torch.zeros_like(u), torch.zeros_like(rho)
        with torch.profiler.record_function(SOFT_DOMINANCE_RANGE), _full_f32_matmul(u):
            for r0, r1, cos, x in _dominance_tiles(u, rho, beta, ctx.rows):
                # ∂L/∂domᵢⱼ = gᵢ·β·wᵢⱼ (0 on the diagonal: its weight underflows)
                t = torch.exp_(x.sub_(lse[r0:r1, None])).mul_((beta * g[r0:r1])[:, None])
                drho += torch.sum(t * torch.clamp(cos, 0.0, 1.0), dim=0)
                h = ((cos > 0).to(cos.dtype) + (cos >= 0).to(cos.dtype)) * (
                    (cos < 1).to(cos.dtype) + (cos <= 1).to(cos.dtype))
                a = t.mul_(rho).mul_(h).mul_(0.25)  # ∂L/∂cosᵢⱼ
                du[r0:r1] += a @ u
                du += a.t() @ u[r0:r1]
        return du, drho, None, None


def hpr_mask_soft(
    points: torch.Tensor,
    r_param: float = 2.0,
    *,
    block: int = 1024,
    sharpness: float = 400.0,
    tau: float = 0.02,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Differentiable HPR visibility in (0, 1) of (N, 3) camera-frame points.

    Point i is visible to the degree that its flipped radius stands clear of
    the strongest radial coverer, σ(β·(ρ'ᵢ + τ·scale − softmaxⱼ ρ'ⱼcosθᵢⱼ))
    with β = sharpness/scale, scale = max‖p‖ (no gradient) and the self pair
    excluded by a finite −1e30. ``valid`` (N,) 0/1: padding sets neither the
    radius nor the scale and covers no one. The (N, N) dominance runs in
    ``block``-row tiles (fewer rows where ``TILE_BUDGET`` asks), forward and
    backward: O(N²) work, O(block·N) memory.
    """
    n = points.shape[0]
    # safe_norm: real scans hold points exactly at the sensor origin, where
    # the norm's gradient would be 0/0
    norms = safe_norm(points, dim=-1)
    if valid is not None:
        norms_v = torch.where(valid > 0, norms, torch.zeros_like(norms))
    else:
        norms_v = norms
    radius = torch.amax(norms_v) * 10.0 ** r_param
    rho = 2.0 * radius - norms
    if valid is not None:
        rho = torch.where(valid > 0, rho, torch.full_like(rho, -_BIG_SOFT))
    # no gradient through the normalization, as the JAX twin's stop_gradient:
    # a traced beta times the -1e30 sentinel would poison the backward
    scale = torch.clamp(torch.amax(norms_v), min=1e-6).detach()
    u = points / _maximum(norms, 1e-12)[:, None]
    beta = sharpness / scale
    rows = _tile_rows(block, n, points)
    smax = _SoftLSE.apply(u, rho, beta, rows) / beta
    return torch.sigmoid(beta * (rho + tau * scale - smax))


def soft_hpr_gate(cam: torch.Tensor, valid: Optional[torch.Tensor], dense_max: int,
                  what: str) -> torch.Tensor:
    """The occlusion gate of the pose and trajectory losses on one camera's
    (N, 3) points: the dense ``hpr_mask_soft`` up to ``dense_max`` points.
    Above it the JAX twin runs the direction-binned tier, which is not
    ported: raise."""
    if cam.shape[0] > dense_max:
        raise NotImplementedError(
            f"{what}: {cam.shape[0]} points exceed soft_hpr_dense_max={dense_max}, and the "
            "direction-binned soft HPR (hpr_mask_soft_binned) that serves such clouds is not "
            "ported yet (ROADMAP.md Q1 item 9)"
        )
    return hpr_mask_soft(cam, valid=valid)
