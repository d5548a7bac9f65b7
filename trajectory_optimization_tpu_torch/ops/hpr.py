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
4. :func:`hpr_mask_soft_binned` — the same relaxation at scale: each point
   competes only against members of its own direction bin, in four
   staggered grids, O(N·cap) pairs; the tiles are reduced in chunks with a
   hand-derived backward that recomputes them.

:func:`soft_hpr_gate` picks the soft tier of the pose and trajectory losses
by the cloud's size, as the JAX twin does.
"""
from __future__ import annotations

import contextlib
import functools
import inspect
from typing import Optional, Tuple

import numpy as np
import torch

from trajectory_optimization_tpu_torch.ops.numerics import safe_norm
from trajectory_optimization_tpu_torch.utils.profiling import HPR_GATE, span

_BIG_SOFT = 1.0e30  # self-exclusion sentinel and runner-up mask
# Elements of one (C, rows, N) support tile of hpr_mask_approx or one
# (rows, N) dominance tile of hpr_mask_soft: ``block`` rows at most, fewer
# where a tile would exceed the budget. On the card 256 MiB in f32; on the
# CPU 8 MiB, so that a tile's passes stay in cache (3x faster than 1,024
# rows at 8,192 points). The reductions are per row, so the mask does not
# depend on the row count.
TILE_BUDGET = {"cuda": 1 << 26, "cpu": 1 << 21}
# The span (``utils.profiling.span``) of the soft dominance tile's forward
# and backward, by which a trace separates its time from the rest of a step.
SOFT_DOMINANCE_RANGE = "trajopt.hpr.soft_dominance"
# The same for the binned tier's tiles (hpr_mask_soft_binned).
SOFT_BINNED_RANGE = "trajopt.hpr.soft_binned"


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
    ``jnp.maximum`` splits it (``torch.clamp`` passes all of it). The floor
    is filled on the tensor's device: no host-to-device copy."""
    return torch.maximum(x, torch.full((), floor, dtype=x.dtype, device=x.device))


def gate_norms(points: torch.Tensor) -> torch.Tensor:
    """‖p‖ over the last axis of ``points``, in float64 and rounded once to
    their dtype (``safe_norm``: gradient 0 at ‖p‖ = 0): the binned and frozen
    soft gates' ρ and directions. With the card's f32 sum of squares an f32
    binned trajectory step came 5.8e-3 of its largest entry from float64
    (the CPU's 2.8e-4); with the norms rounded once, 2.5e-4 (chip_smoke.py
    [hpr], NVIDIA H100)."""
    return safe_norm(points.to(torch.float64), dim=-1).to(points.dtype)


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
        with span(SOFT_DOMINANCE_RANGE):
            for r0, r1, _, x in _dominance_tiles(u, rho, beta, rows):
                lse[r0:r1] = torch.logsumexp(x, dim=1)
        ctx.save_for_backward(u, rho, beta, lse)
        ctx.rows = rows
        return lse

    @staticmethod
    def backward(ctx, g):
        u, rho, beta, lse = ctx.saved_tensors
        du, drho = torch.zeros_like(u), torch.zeros_like(rho)
        with span(SOFT_DOMINANCE_RANGE), _full_f32_matmul(u):
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




# ---------------------------------------------------------------------------
# The direction-binned soft tier. The JAX twin lays each grid out with
# scatter-free custom-VJP co-sorts because row scatters serialize on a TPU;
# here a stable sort and plain gathers do (a gather's backward is an
# index_add, cheap on the GPU). A stable sort's permutation depends on the
# keys alone, so it is the JAX one, ties included.
# ---------------------------------------------------------------------------


def make_cosort(n_diff: int, n_aux: int, dimension: int = 0):
    """Multi-operand sort by key: ``cosort(key, *diff_ops, *aux_ops)``
    stable-sorts every operand (each of ``key``'s shape) along ``dimension``
    by the integer ``key`` alone and returns ``(key_sorted, *diff_sorted,
    *aux_sorted, perm)``, ``perm[p]`` the index landing at sorted position
    ``p``. Gradients reach the ``n_diff`` leading operands only."""

    def cosort(key, *ops):
        if len(ops) != n_diff + n_aux:
            raise ValueError(f"cosort takes {n_diff + n_aux} operands, got {len(ops)}")
        key_s, perm = torch.sort(key, dim=dimension, stable=True)
        out = [torch.gather(op if i < n_diff else op.detach(), dimension, perm)
               for i, op in enumerate(ops)]
        return (key_s, *out, perm)

    return cosort


# sort (u0, u1, u2, rho) by key: the binned tier's layout sort
_cosort = make_cosort(4, 0)


def _stratified_priority(rank: torch.Tensor, base: int, n: int) -> torch.Tensor:
    """Tiered distance-rank stratification of a bin's coverer candidates:
    all of the closest ``base`` members, then every 2^(k+1)-th member of
    tier k = ranks [base·2^k, base·2^(k+1)), down to rank 16·base. Selected
    members keep their rank (distance order); the rest sort after them
    (``n + rank``). k = ⌊log2 max(rank // base, 1)⌋ is read off the f32's
    exponent (``frexp``), exact, where the twin takes ⌊log2⌋ of the f32: the
    two agree on every rank below 16·base, the only ranks the tiers select."""
    rb = torch.clamp(torch.div(rank, base, rounding_mode="floor"), min=1).to(torch.float32)
    k = torch.frexp(rb).exponent.to(rank.dtype) - 1
    stride_mask = (torch.ones_like(k) << (k + 1)) - 1  # the stride is a power of two
    selected = (rank < base) | ((rank < 16 * base) & ((rank & stride_mask) == 0))
    return torch.where(selected, rank, n + rank)


def _unpermute(perm: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Map sorted-order ``x`` back to canonical order (``perm`` from
    :func:`_cosort`): ``out[perm[p]] = x[p]``; its backward is the gather
    ``g[perm]``. (The twin's first argument, the key its custom VJP re-sorts
    by, has no use here.)"""
    return torch.zeros_like(x).index_copy(0, perm, x)


def _binned_grids(r_param: float, tau: float, safety: float):
    """Static lat/az binning layouts for :func:`hpr_mask_soft_binned` (numpy,
    copied from the JAX twin).

    The Katz dominance term cosθᵢⱼ·ρⱼ only beats ρᵢ + τ·scale when
    cosθ ≥ 1 − (1+τ)·maxnorm/2R, i.e. within θ_max ≈ √(2c) of radial
    (c = (1+τ)·10^-r/2, padded by ``safety`` for the sigmoid tails) — for
    the reference's r_param=2 that is ~7°. So dominance is local in
    DIRECTION: bins of angular size Δ = 2θ_max, in four half-cell-staggered
    grids (lat shift × az shift), guarantee any pair within (Δ/2, Δ/2)
    shares a bin in at least one grid. Rings get ∝cos(lat) azimuth cells so
    the cell's angular width is ~Δ at every latitude.

    Returns (theta_max, list of (n_rings, delta, lat_shift, az_shift,
    n_az array, ring offsets, n_bins)).
    """
    c = safety * (1.0 + tau) * 0.5 * 10.0 ** (-r_param)
    theta_max = float(np.sqrt(2.0 * c))
    delta = 2.0 * theta_max
    grids = []
    for lat_shift in (0.0, 0.5):
        n_rings = int(np.ceil(np.pi / delta + lat_shift))
        lat_centers = -np.pi / 2 + (np.arange(n_rings) + 0.5 - lat_shift) * delta
        lat_centers = np.clip(lat_centers, -np.pi / 2, np.pi / 2)
        n_az = np.maximum(
            1, np.round(2.0 * np.pi * np.cos(lat_centers) / delta)
        ).astype(np.int32)
        offsets = np.concatenate([[0], np.cumsum(n_az)]).astype(np.int32)
        for az_shift in (0.0, 0.5):
            grids.append((n_rings, delta, lat_shift, az_shift, n_az,
                          offsets[:-1], int(offsets[-1])))
    return theta_max, grids


def _direction_angles(u: torch.Tensor):
    """(lat, az) routing angles of unit directions ``u``, detached: the
    gradients flow through ρ and u inside the tiles, not through the
    discrete bin assignment."""
    ud = u.detach()
    lat = torch.asin(torch.clamp(ud[:, 2], -1.0, 1.0))
    az = torch.atan2(ud[:, 1], ud[:, 0]) + np.pi  # [0, 2π)
    return lat, az


def _device_table(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The host array ``a`` as a tensor on ``dev``, copied on the first call
    and reused after it (:func:`_cached_table`). A run's first step is
    eager, so the copy never falls inside a captured step: a copy from
    pageable host memory synchronizes, which a capture forbids."""
    return _cached_table(a.tobytes(), a.dtype.str, a.shape, dev)


@functools.lru_cache(maxsize=256)
def _cached_table(data: bytes, dtype: str, shape, dev: torch.device) -> torch.Tensor:
    return torch.tensor(np.frombuffer(data, dtype=dtype).reshape(shape), device=dev)


def _grid_bin_key(grid, lat, az, norms, scale, v):
    """Bin ids and the quantized (bin, distance) int32 sort key for one grid
    of :func:`_binned_grids`: ``bins·2^frac_bits + ⌊frac·2^frac_bits⌋`` with
    frac = ‖p‖/scale clipped below 1, so that a sort makes each bin
    contiguous, closest (largest ρ) members first. ``v`` (bool or None)
    routes padding to the overflow bin ``n_bins``. frac takes the int32 bits
    the bin id leaves. Returns (key, frac_bits, n_bins); ``key >>
    frac_bits`` recovers the bins.

    The arithmetic is the twin's f32: the divisors are f32 tensors on the
    device, since a CUDA tensor divided by a Python scalar is multiplied by
    its reciprocal, which rounds differently and moves boundary points. They
    are filled on the device and the grid's tables copied there once
    (:func:`_device_table`): a captured step makes no host copy."""
    n_rings, delta, lat_shift, az_shift, n_az_np, offs_np, n_bins = grid
    frac_bits = 30 - max(1, int(n_bins + 1)).bit_length()
    if frac_bits < 8:
        raise ValueError(
            f"binning too fine for an int32 sort key ({n_bins} bins); "
            f"lower safety/raise r_param")
    dev = lat.device
    n_az, offs = _device_table(n_az_np, dev), _device_table(offs_np, dev)
    f32 = lambda x: torch.full((), x, dtype=torch.float32, device=dev)  # noqa: E731
    ring = torch.clamp(
        torch.floor((lat + np.pi / 2) / f32(delta) + lat_shift).to(torch.int32),
        0, n_rings - 1).long()
    cells = n_az[ring]
    azbin = torch.floor(az / f32(2.0 * np.pi) * cells + az_shift).to(torch.int32)
    azbin = torch.where(azbin >= cells, azbin - cells, azbin)  # wrap
    bins = offs[ring] + azbin
    if v is not None:
        bins = torch.where(v, bins, torch.full_like(bins, n_bins))  # padding -> overflow bin
    frac = torch.clamp(norms.detach() / torch.clamp(scale, min=1e-12), 0.0, 1.0 - 1e-6)
    key = bins * (1 << frac_bits) + (frac * float(1 << frac_bits)).to(torch.int32)
    return key, frac_bits, n_bins


def _binned_tiles(U, R, beta, bin_s, cov_pos, tiles, n: int, cap: int):
    """One chunk of query tiles against their coverers, (T, cap, cap).

    ``tiles`` rows are (bin b, query offset, coverer offset, deep): queries
    are ``cap`` consecutive rows of the layout sort from the query offset;
    coverers the ``cap`` rows from the coverer offset, of the layout sort
    (chunk 0 of a bin: its exact closest-cap prefix) or, where deep, of the
    stratified layout, stored after it in ``U``/``R`` (rows n..2n). A pair
    counts where the coverer is in bin b and is not the query itself
    (LAYOUT-1 positions, ``cov_pos`` mapping stratified rows back). Returns
    the row indices, the pair mask, the gathered directions and radii, cos
    and β·dom with dom = max(cos, 0)·ρ_cov (cos unclipped) and −1e30 off the
    mask."""
    b, qoff, coff, deep = tiles.unbind(1)
    ar = torch.arange(cap, device=U.device)
    q = qoff[:, None] + ar
    c = coff[:, None] + ar
    if cov_pos is None:
        crow, cself = c, c
    else:
        crow = c + deep[:, None] * n
        cself = torch.where(deep[:, None] > 0, cov_pos[c], c)
    ok = (bin_s[c] == b[:, None])[:, None, :] & (q[:, :, None] != cself[:, None, :])
    qu, cu, cr = U[q], U[crow], R[crow]
    with _full_f32_matmul(U):
        cos = torch.bmm(qu, cu.transpose(1, 2))
    x = torch.clamp_min(cos, 0.0).mul_(cr[:, None, :]).masked_fill_(~ok, -_BIG_SOFT).mul_(beta)
    return q, crow, ok, qu, cu, cr, cos, x


def add_rows(dst: torch.Tensor, rows: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst[rows[i]] += src[i]`` in a fixed order: the same bits on every
    call. On the CPU this is ``index_add_``, a serial loop in the order of
    i. On the card ``index_add_`` adds with atomics, in an order that
    changes from call to call where a row takes two or more terms;
    ``index_put_(accumulate=True)`` sorts the row indices stably and sums
    each row's run of terms in a fixed order, with no host read, so a
    captured step can hold it."""
    if dst.is_cuda:
        return dst.index_put_((rows,), src, accumulate=True)
    return dst.index_add_(0, rows, src)


class _BinnedLSE(torch.autograd.Function):
    """lse[t, i] = logsumexpⱼ(β·dom) of every query row of every tile of one
    grid, in chunks of ``chunk`` tiles: nothing of size T·cap² is kept
    between forward and backward. The backward recomputes each chunk; the
    derivative of max(cos, 0) is ½ at cos = 0, as ``jnp.maximum`` splits
    it. The softmax weights are exp(x − max)/Σ, from the row's max and sum
    kept by the forward, not exp(x − lse): β·dom reaches ~10⁵·10^(r−2),
    where one rounding of lse would scale a row's weights by e^ulp."""

    @staticmethod
    def forward(ctx, U, R, beta, bin_s, cov_pos, tiles, cap, chunk):
        n = bin_s.shape[0]
        top = U.new_empty((tiles.shape[0], cap))
        total = U.new_empty((tiles.shape[0], cap))
        with span(SOFT_BINNED_RANGE):
            for t0 in range(0, tiles.shape[0], chunk):
                t1 = t0 + chunk
                x = _binned_tiles(U, R, beta, bin_s, cov_pos, tiles[t0:t1], n, cap)[-1]
                top[t0:t1] = torch.amax(x, dim=2)
                total[t0:t1] = torch.sum(torch.exp_(x.sub_(top[t0:t1, :, None])), dim=2)
        ctx.save_for_backward(U, R, beta, bin_s, cov_pos, tiles, top, total)
        ctx.cap, ctx.chunk = cap, chunk
        return top + torch.log(total)

    @staticmethod
    def backward(ctx, g):
        U, R, beta, bin_s, cov_pos, tiles, top, total = ctx.saved_tensors
        n, cap, chunk = bin_s.shape[0], ctx.cap, ctx.chunk
        dU, dR = torch.zeros_like(U), torch.zeros_like(R)
        with span(SOFT_BINNED_RANGE), _full_f32_matmul(U):
            for t0 in range(0, tiles.shape[0], chunk):
                t1 = t0 + chunk
                q, crow, ok, qu, cu, cr, cos, x = _binned_tiles(
                    U, R, beta, bin_s, cov_pos, tiles[t0:t1], n, cap)
                # ∂L/∂dom = g·β·softmax weight, 0 off the mask
                t = torch.exp_(x.sub_(top[t0:t1, :, None])).mul_(
                    (beta * g[t0:t1] / total[t0:t1])[:, :, None]).masked_fill_(~ok, 0.0)
                add_rows(dR, crow.reshape(-1),
                         torch.sum(t * torch.clamp_min(cos, 0.0), dim=1).reshape(-1))
                h = (cos > 0).to(cos.dtype).add_((cos >= 0).to(cos.dtype)).mul_(0.5)
                a = t.mul_(cr[:, None, :]).mul_(h)  # ∂L/∂cos
                add_rows(dU, torch.cat([q.reshape(-1), crow.reshape(-1)]),
                         torch.cat([torch.bmm(a, cu).reshape(-1, 3),
                                    torch.bmm(a.transpose(1, 2), qu).reshape(-1, 3)]))
        return dU, dR, None, None, None, None, None, None


def hpr_mask_soft_binned(
    points: torch.Tensor,
    r_param: float = 2.0,
    *,
    sharpness: float = 400.0,
    tau: float = 0.02,
    cap: int = 1024,
    safety: float = 3.0,
    stratified_coverers: bool = True,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Differentiable HPR at scale: direction-binned dominance, O(N·cap).

    The smooth visibility of :func:`hpr_mask_soft`, σ(β(ρᵢ + τ·scale −
    softmaxⱼ cosθᵢⱼ·ρⱼ)), with each point competing only against members of
    its own angular bin (:func:`_binned_grids`), in four staggered grids
    whose soft maxima combine by elementwise max. Per grid, one stable sort
    by (bin, ‖p‖) makes each bin contiguous, closest first; the bin's
    queries run in tiles of ``cap`` rows against ``cap`` coverers: chunk 0
    against the exact closest-``cap`` prefix, deeper chunks, with
    ``stratified_coverers``, against a tiered distance-rank sample that
    reaches ~16·cap deep (:func:`_stratified_priority`, a second sort by
    (bin, priority)); the sample is skipped where its key would overflow
    (2n ≥ 2^frac_bits). The tiles are reduced in chunks sized by
    ``TILE_BUDGET`` (:class:`_BinnedLSE`) and each row takes the max of the
    tiles that cover it (``scatter_reduce``): max is order-independent, so
    this equals the twin's scan over tiles. The tile table is the twin's:
    ``n_bins + ⌈n/cap⌉`` static slots per grid, a size taken from shapes
    alone, of which the slots past the last real tile are masked out of the
    max (``tile_ok``). The function reads nothing from the device on the
    host, so a step that calls it can be captured as a CUDA graph.

    ``valid``: padded points set neither radius nor scale, cover no one and
    report 0. Returns (N,) visibility in (0, 1).
    """
    n = points.shape[0]
    cap = min(cap, n)
    dev = points.device
    norms = gate_norms(points)  # a finite gradient at ‖p‖ = 0
    if valid is not None:
        v = valid > 0
        norms_v = torch.where(v, norms, torch.zeros_like(norms))
    else:
        v = None
        norms_v = norms
    radius = _maximum(torch.amax(norms_v), 1e-12) * 10.0 ** r_param
    rho = 2.0 * radius - norms
    scale = torch.clamp(torch.amax(norms_v), min=1e-6).detach()
    beta = sharpness / scale
    u = points / _maximum(norms, 1e-12)[:, None]
    lat, az = _direction_angles(u)
    chunk = max(1, TILE_BUDGET["cuda" if points.is_cuda else "cpu"] // (cap * cap))
    ar = torch.arange(cap, device=dev)

    _, grids = _binned_grids(r_param, tau, safety)
    smax = torch.full((n,), -_BIG_SOFT, dtype=points.dtype, device=dev)
    for grid in grids:
        key, frac_bits, n_bins = _grid_bin_key(grid, lat, az, norms, scale, v)
        key_s, u0_s, u1_s, u2_s, rho_s, perm = _cosort(key, u[:, 0], u[:, 1], u[:, 2], rho)
        bin_s = key_s >> frac_bits
        u_s = torch.stack([u0_s, u1_s, u2_s], dim=1)
        # bins are sorted: member counts by binary search
        edges = torch.searchsorted(
            bin_s, torch.arange(n_bins + 1, dtype=bin_s.dtype, device=dev))
        counts, starts = edges[1:] - edges[:-1], edges[:-1]

        strat = stratified_coverers and cap < n and (2 * n) < (1 << frac_bits)
        if strat:
            # rank in bin: segment starts by one cummax pass
            iota = torch.arange(n, device=dev)
            seg_first = torch.ones(n, dtype=torch.bool, device=dev)
            seg_first[1:] = bin_s[1:] != bin_s[:-1]
            rank = iota - torch.cummax(torch.where(seg_first, iota, 0), dim=0).values
            prio = _stratified_priority(rank, max(cap // 4, 1), n)
            key2 = bin_s * (1 << frac_bits) + prio.to(bin_s.dtype)
            _, cov_u0, cov_u1, cov_u2, cov_rho, cov_pos = _cosort(
                key2, u0_s, u1_s, u2_s, rho_s)
            # both layouts in one table: the stratified one at rows n..2n
            U = torch.cat([u_s, torch.stack([cov_u0, cov_u1, cov_u2], dim=1)])
            R = torch.cat([rho_s, cov_rho])
        else:
            U, R, cov_pos = u_s, rho_s, None

        tiles_per_bin = (counts + cap - 1) // cap  # 0 for empty bins
        tile_cum = torch.cat([tiles_per_bin.new_zeros(1), torch.cumsum(tiles_per_bin, 0)])
        # the twin's static slots: Σ⌈count/cap⌉ ≤ n_bins + ⌈n/cap⌉, a size
        # from shapes alone; the slots past the last real tile are empty
        slot = torch.arange(n_bins + -(-n // cap), device=dev)
        tile_bin = torch.clamp(torch.searchsorted(tile_cum, slot, right=True) - 1, 0, n_bins - 1)
        within = slot - tile_cum[tile_bin]
        tile_ok = within < tiles_per_bin[tile_bin]
        qoff = torch.clamp(starts[tile_bin] + within * cap, 0, n - cap)
        coff = torch.clamp(starts[tile_bin], 0, n - cap)
        deep = (within >= 1).long() if strat else torch.zeros_like(within)
        tiles = torch.stack([tile_bin, qoff, coff, deep], dim=1)

        lse = _BinnedLSE.apply(U, R, beta, bin_s, cov_pos, tiles, cap, chunk)
        # each query row of bin b takes the max over the real tiles of b that
        # hold it; an empty slot's rows stay out (their gradient is exactly 0)
        q = qoff[:, None] + ar
        rows = torch.where((bin_s[q] == tile_bin[:, None]) & tile_ok[:, None], lse / beta,
                           -_BIG_SOFT)
        smax_g = torch.full((n,), -_BIG_SOFT, dtype=points.dtype, device=dev).scatter_reduce(
            0, q.reshape(-1), rows.reshape(-1), "amax", include_self=True)
        smax = torch.maximum(smax, _unpermute(perm, smax_g))

    out = torch.sigmoid(beta * (rho + tau * scale - smax))
    if v is not None:
        out = out * v.to(out.dtype)
    return out


#: the binned tier's knob defaults, read off the signature above
SOFT_BINNED_DEFAULTS = {
    k: p.default
    for k, p in inspect.signature(hpr_mask_soft_binned).parameters.items()
    if p.default is not inspect.Parameter.empty and k != "valid"
}


def soft_hpr_gate(cam: torch.Tensor, valid: Optional[torch.Tensor], problem) -> torch.Tensor:
    """The occlusion gate of the pose and trajectory losses on one camera's
    (N, 3) points: the dense ``hpr_mask_soft`` up to the problem's
    ``soft_hpr_dense_max`` points, the binned tier above it with the
    problem's ``hpr_cap`` and ``hpr_safety`` (the twin's defaults where the
    problem has none). The whole gate is the span ``HPR_GATE``."""
    with span(HPR_GATE):
        if cam.shape[0] > problem.soft_hpr_dense_max:
            return hpr_mask_soft_binned(
                cam, valid=valid,
                cap=getattr(problem, "hpr_cap", SOFT_BINNED_DEFAULTS["cap"]),
                safety=getattr(problem, "hpr_safety", SOFT_BINNED_DEFAULTS["safety"]))
        return hpr_mask_soft(cam, valid=valid)
