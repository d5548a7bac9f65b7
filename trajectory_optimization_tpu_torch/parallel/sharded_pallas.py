"""Sharded fused visibility: the multi-card hot path.

Twin of ``trajectory_optimization_tpu/parallel/sharded_pallas.py``. Each rank
runs the fused-visibility passes of ``ops.fused_vis`` (the hand kernels K1–K5
on CUDA tensors, their plain versions on CPU tensors) on its own slice of the
cloud and its own waypoints, and crosses ranks only through all_reduces of
(W,)-sized quantities:

  fwd:  pass A → MIN/MAX(2·W) over 'pts' → make_norm → pass B → SUM(N) over 'wps'
  bwd, cached:   K3 → SUM(4·W) over 'pts' → α, β → K4 → SUM(12·W) over 'pts'
  bwd, uncached: K5 → SUM(40·W) over 'pts'

then the waypoint shards' gradient rows are gathered over 'wps'. The min and
max are exact, so the normalization equals the single-device one; pass B is
per point, so ``lo`` does too wherever both take the same regime. K3's need
mask for K4 reads the forward's global normalization, the cached scores and
``valid``, nothing that the stats all_reduce changes. The regime is chosen per
shard, as the twin chooses it: the score cache is kept while
w_local · n_local · 4 bytes fit ``fused_vis.SCORE_CACHE_MAX_BYTES``.

Point counts keep the twin's multiple, :func:`pad_multiple` = 8 · 128 · D;
the (M, 128) plane layout behind it is not ported: each rank's points are a
contiguous (3, n_local) SoA, as the single-device kernels take them.
"""
from __future__ import annotations

from typing import Optional

import torch

from trajectory_optimization_tpu_torch.ops import fused_vis as fv
from trajectory_optimization_tpu_torch.ops import quat as quat_ops
from trajectory_optimization_tpu_torch.parallel.mesh import Mesh, all_reduce_

MIN_TILE_ROWS = 8  # the twin's f32 sublane granularity
LANES = 128
_DUMMY_T = 1.0e9  # the twin's dummy-waypoint camera centre: every score is exactly 0


def pad_multiple(mesh: Mesh) -> int:
    """Point-count multiple required by :func:`sharded_fused_lo_sum` on this
    mesh (pass as ``multiple=`` to utils.data.pad_points/bucket_size)."""
    return MIN_TILE_ROWS * LANES * int(mesh.shape["pts"])


def _pad_wp(wp: torch.Tensor, w_pad: int) -> torch.Tensor:
    """Waypoint rows padded with inert dummies (identity rotation, centre
    1e9 away): zero scores, zero log-odds, zero gradients."""
    pad = w_pad - wp.shape[0]
    if pad == 0:
        return wp
    dummy = torch.tensor([1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0] + [_DUMMY_T] * 3,
                         dtype=wp.dtype, device=wp.device)
    return torch.cat([wp, dummy.expand(pad, 12)], dim=0)


def uses_shard_cache(w_local: int, n_local: int) -> bool:
    """The twin's per-shard regime rule (read at call time, so the budget
    can be patched): keep the (w_local, n_local) f32 score cache while it
    fits the budget."""
    return w_local * n_local * 4 <= fv.SCORE_CACHE_MAX_BYTES


class ShardedFusedLoSum(torch.autograd.Function):
    """wp (W_pad, 12), replicated → this rank's (n_local,) log-odds, summed
    over all waypoints; differentiable w.r.t. wp, whose gradient comes back
    whole on every rank (the mesh module's convention)."""

    @staticmethod
    def forward(ctx, wp_all, kp, pts_t, valid, consts: fv.VisConsts, mesh: Mesh):
        d_w, a = mesh.shape["wps"], mesh.index("wps")
        w_loc = wp_all.shape[0] // d_w
        wp = wp_all[a * w_loc:(a + 1) * w_loc].contiguous()
        cache = uses_shard_cache(w_loc, pts_t.shape[1])
        if cache:
            m, mx, scores = fv.pass_a(wp, kp, pts_t, valid, consts)
        else:
            m, mx = fv.pass_a_minmax(wp, kp, pts_t, valid, consts)
            scores = None
        # one MIN over 'pts' for both: max(x) = −min(−x), exact
        mm = all_reduce_(torch.cat([m, -mx]), mesh, "pts", "min")
        norm = fv.make_norm(mm[:w_loc], -mm[w_loc:])
        if cache:
            lo = fv.pass_b(norm, scores, consts.eps)
        else:
            lo = fv.pass_b_recompute(wp, kp, norm, pts_t, consts)
        all_reduce_(lo, mesh, "wps")  # the log-odds fusion is a sum over waypoints
        ctx.save_for_backward(wp, kp, pts_t, valid, norm, scores)
        ctx.consts, ctx.mesh = consts, mesh
        return lo

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        wp, kp, pts_t, valid, norm, scores = ctx.saved_tensors
        k, mesh = ctx.consts, ctx.mesh
        g = g.contiguous()
        if scores is None:
            acc = all_reduce_(fv.bwd_fused_acc(wp, kp, norm, pts_t, valid, g, k), mesh, "pts")
            sums = fv.fused_acc_to_sums(acc, wp.shape[0])
        else:
            st, need = fv.bwd_stats(norm, scores, valid, g, k.eps)
            all_reduce_(st, mesh, "pts")
            alpha = st[:, 0] / torch.clamp(st[:, 2], min=1.0)
            beta = st[:, 1] / torch.clamp(st[:, 3], min=1.0)
            norm2 = torch.cat([norm, alpha[:, None], beta[:, None]], dim=1).contiguous()
            sums = all_reduce_(fv.bwd_apply(wp, kp, norm2, pts_t, valid, g, scores, need, k),
                               mesh, "pts")
        dwp = fv.sums_to_param_grads(wp, sums)
        # gather the waypoint shards' rows over 'wps' (a SUM of disjoint rows)
        d_w, a = mesh.shape["wps"], mesh.index("wps")
        full = dwp.new_zeros((d_w,) + tuple(dwp.shape))
        full[a] = dwp
        all_reduce_(full, mesh, "wps")
        return full.reshape(-1, dwp.shape[1]), None, None, None, None, None


def sharded_fused_lo_sum(
    mesh: Mesh,
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
    """This rank's (n_local,) log-odds over W waypoints, with the point axis
    sharded over 'pts' and the waypoints over 'wps'; differentiable w.r.t.
    quats/trans (replicated, gradients whole on every rank).

    ``points`` (and ``valid``, ``points_t``) are this rank's slice
    (``parallel.sharded.shard_points``); the whole cloud, n_local times the
    'pts' size, must be a multiple of :func:`pad_multiple` — pad with
    utils.data.pad_points first (padding entries carry valid=0). On a 2-D
    mesh the waypoints are padded with inert dummies to a multiple of the
    'wps' size; their gradient rows are dropped.
    """
    if "wps" not in mesh.shape or "pts" not in mesh.shape:
        raise ValueError(
            f"sharded_fused_lo_sum needs a ('wps', 'pts') mesh, got axes "
            f"{tuple(mesh.shape)}; build one with parallel.mesh.make_mesh.")
    D, d_w = mesh.shape["pts"], mesh.shape["wps"]
    n_loc, W = points.shape[0], quats.shape[0]
    tile = MIN_TILE_ROWS * LANES * D
    if (n_loc * D) % tile:
        raise ValueError(f"N={n_loc * D} must be a multiple of {tile} (pad the cloud)")
    if points_t is None:
        points_t = points.t().contiguous()
    if valid is None:
        valid = torch.ones(n_loc, dtype=points.dtype, device=points.device)
    R = quat_ops.to_matrix(quat_ops.normalize(quats))  # differentiable prologue
    wp = torch.cat([R.reshape(W, 9), trans], dim=1)
    wp = _pad_wp(wp, -(-W // d_w) * d_w).contiguous()
    kp = torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).contiguous()
    consts = fv.make_consts(img_width, img_height, min_dist, max_dist, eps)
    return ShardedFusedLoSum.apply(wp, kp.to(points.dtype), points_t,
                                   valid.to(points.dtype), consts, mesh)
