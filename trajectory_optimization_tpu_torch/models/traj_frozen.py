"""Frozen-routing occlusion-aware trajectory loss: host-planned soft HPR.

Twin of ``trajectory_optimization_tpu/models/traj_frozen.py``. The
occlusion-aware trajectory loss (``traj_forward(soft_hpr=True)`` above the
dense size) re-derives the binned-HPR routing — a sort, the bin searches and
the tile table per grid and waypoint — inside every Adam step, although the
routing is detached and adds nothing to the gradient. This module splits
the computation as the twin does:

- **Refresh (host numpy, every ``refresh_every`` steps)**: build a plan —
  per selected waypoint, gate the cloud down to the loss-relevant subset
  (points whose visibility score is non-negligible, plus every point close
  enough in range to occlude one of them in its own bin), route the
  survivors into the 4 staggered direction grids of
  :func:`ops.hpr.hpr_mask_soft_binned`, and pack bins into cap-aligned tiles
  (several small bins per tile). The builder is the twin's numpy, copied:
  its plans equal the twin's array for array.

- **Step (device)**: one batched dominance computation over the (W, grids,
  tiles, cap, cap) tile set, in ``TILE_BUDGET`` chunks with a recomputing
  backward (:class:`_FrozenLSE`), skipping the tiles that hold no query;
  no sort, no search, no host read. The
  stored permutations (cross-grid alignment, the plan→cloud embedding, the
  sparse criterion's grouping) are scatters whose backward is a gather by
  the same key. ρ, u and the score are recomputed from the live parameters
  every step, so gradients are exact for the current pose; only the pairing
  is frozen between refreshes.

At a refresh the loss matches ``traj_forward(soft_hpr=True,
soft_hpr_dense_max=0)`` to gate-threshold tolerance
(tests/test_torch_traj_frozen.py). The runner keeps the twin's plan-shape
policy: the tile counts rise monotonically along the builder's ladder, so
its plans equal the twin runner's across refreshes and a run settles on one
shape. On the card the step of a shape is one CUDA graph, the counterpart
of the twin's jitted step per ``PlanMeta`` (:class:`FrozenTrajOptimizer`).
The runner's plan builds run on one worker thread that ``close()`` joins.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import time
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from trajectory_optimization_tpu_torch.models.traj import (
    TrajProblem,
    logodds_from_minmax,
    observation_logodds,
    traj_criterion,
    traj_criterion_from_mean,
)
from trajectory_optimization_tpu_torch.ops.hpr import (
    _BIG_SOFT,
    TILE_BUDGET,
    _binned_grids,
    _full_f32_matmul,
    _maximum,
    gate_norms,
    SOFT_BINNED_DEFAULTS as _HPR_DEF,
)
from trajectory_optimization_tpu_torch.ops.scores import (
    camera_frames,
    camera_planes,
    scores_from_planes,
)
from trajectory_optimization_tpu_torch.opt.engine import (
    AdamStep,
    OptimizerConfig,
    apply_updates,
    assign,
    clone_tree,
    make_optimizer,
    value_and_grad,
)
from trajectory_optimization_tpu_torch.opt.graphs import (
    StepGraph,
    capture_stream,
    on_capture_stream,
)
from trajectory_optimization_tpu_torch.utils.profiling import span

LIVE_TILES_KEPT = 64  # refreshes whose live-tile counts stats["live_tiles"] keeps
_PAD_COORD = 1.0e6  # padding rows: huge norm -> rho ~ -2e6, can never cover
# The span (``utils.profiling.span``) of the frozen dominance tiles' forward
# and backward, by which a trace separates their time from the rest of a step.
FROZEN_TILES_RANGE = "trajopt.traj_frozen.tiles"


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# host-side mirrors (the refresh runs in numpy, copied from the twin)
# ---------------------------------------------------------------------------


def _np_quat_matrices(quats: np.ndarray) -> np.ndarray:
    """(W, 4) wxyz -> (W, 3, 3); mirrors ops.quat.normalize+to_matrix."""
    q = quats / np.maximum(np.linalg.norm(quats, axis=-1, keepdims=True), 1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty(q.shape[:-1] + (3, 3), np.float64)
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - w * z)
    R[:, 0, 2] = 2 * (x * z + w * y)
    R[:, 1, 0] = 2 * (x * y + w * z)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - w * x)
    R[:, 2, 0] = 2 * (x * z - w * y)
    R[:, 2, 1] = 2 * (y * z + w * x)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def _np_scores(cam: np.ndarray, K: np.ndarray, problem) -> np.ndarray:
    """(N, 3) camera-frame points -> (N,) dist·fov score (ops.scores mirror).
    The plan only thresholds these, so the numpy dtype is immaterial."""
    c0 = (problem.min_dist + problem.max_dist) / 2.0
    inv_var = 1.0 / ((problem.max_dist - problem.min_dist) / 2.0) ** 2
    d2 = np.sum(np.square(cam - c0), axis=-1)
    dm = np.exp(-0.5 * d2 * inv_var)
    fx, fy, cx0, cy0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u = fx * cam[:, 0] + cx0 * cam[:, 2]
    v = fy * cam[:, 1] + cy0 * cam[:, 2]
    zd = cam[:, 2] + problem.eps
    zd = np.where(zd >= 0, np.maximum(zd, 1e-12), np.minimum(zd, -1e-12))
    xu = np.clip((u / zd - problem.img_width / 2.0) / problem.img_width, -20, 20)
    xv = np.clip((v / zd - problem.img_height / 2.0) / problem.img_height, -20, 20)
    fm = 1.0 / (1.0 + np.exp(-cam[:, 2])) * np.exp(-0.5 * (xu**2 + xv**2))
    return dm * fm


def _np_grid_bins(grid, lat: np.ndarray, az: np.ndarray) -> np.ndarray:
    """ops.hpr._grid_bin_key's routing, in numpy (ids only, no quantization)."""
    n_rings, delta, lat_shift, az_shift, n_az, offs, _n_bins = grid
    ring = np.clip(
        np.floor((lat + np.pi / 2) / delta + lat_shift).astype(np.int64),
        0, n_rings - 1)
    cells = n_az[ring]
    azbin = np.floor(az / (2.0 * np.pi) * cells + az_shift).astype(np.int64)
    azbin = np.where(azbin >= cells, azbin - cells, azbin)
    return offs[ring] + azbin


# ---------------------------------------------------------------------------
# plan construction
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FrozenPlanConfig:
    """Knobs for the host-side plan builder (the twin's fields and defaults).

    score_rel_thresh: a point is a loss-relevant QUERY when its visibility
      score exceeds this fraction of the waypoint's max score — below it,
      the normalized score lands under the 0.5 log-odds clip with zero
      value and zero gradient.
    tail: logsumexp tail cutoff T — a coverer with β·(ρⱼcosθ − ρᵢ − τs)
      < −T shifts a query's sigmoid by < e^−T, so per grid a point is kept
      as a COVERER only when its own bin holds a query with
      normᵢ ≥ normⱼ − (T/sharpness − τ)·scale.
    drift_slack: metres of pose motion the gates stay valid under between
      refreshes (added to the coverer norm band; angular drift is absorbed
      by the binning ``safety`` factor).
    tile_round, tile_ladder_ratio: tile counts per grid round up onto a
      geometric ladder (base ``tile_round``, each rung ≥ ratio × the
      previous), and so does the runner's count of tiles holding a query
      (:func:`live_rung`): few rungs, few step shapes to capture.
    prewarm: the twin compiles the next ladder rungs' steps in the
      background, to hide 15-25 s XLA compiles. Kept for signature parity;
      the port captures nothing ahead of need: a new shape's first step
      runs eagerly and its capture takes a fraction of a refresh interval
      on the card (PERF.md), so ``stats["prewarms"]`` stays 0.
    async_refresh: build the next plan on a worker thread while steps run
      on the current one, swapping at the next refresh boundary
      (deterministic: the plan applied at boundary b was built from the
      params at boundary b−1). False = build synchronously at each
      boundary from the current params (the fidelity reference).
    """

    refresh_every: int = 8
    score_rel_thresh: float = 1e-5
    tail: float = 12.0
    drift_slack: float = 0.5
    tile_round: int = 8
    tile_ladder_ratio: float = 1.15
    prewarm: bool = True
    async_refresh: bool = True


@dataclasses.dataclass(frozen=True)
class PlanMeta:
    """Static shape info of a plan: every loop bound of the device step."""

    n_sel: int
    n_points: int
    cap: int
    n_grids: int
    tiles: int  # T per grid
    # tiles whose coverer span is NOT their own query span (big-bin query
    # chunks) — only these carry separate coverer data
    t_big: int = 1

    @property
    def rows(self) -> int:  # M = tiles * cap
        return self.tiles * self.cap


def _ladder_ceil(n: int, base: int, ratio: float) -> int:
    """Smallest rung ≥ n of the geometric ladder {base, ~base·ratio^k}
    (each rung a multiple of ``base``, strictly increasing). ratio ≤ 1
    degrades to plain ceil-to-base."""
    if ratio <= 1.0:
        return max(-(-int(n) // base) * base, base)
    v = base
    while v < n:
        v = max(-(-int(v * ratio) // base) * base, v + base)
    return v


def _np_stratified_ranks(count: int, cap: int) -> np.ndarray:
    """Numpy mirror of ops.hpr._stratified_priority's selection: the first
    ``cap`` in-bin distance ranks in tiered-priority order (all of the
    closest cap/4, then every 2^(k+1)-th of tier k; unselected ranks fill
    any remaining budget in distance order)."""
    base = max(cap // 4, 1)
    r = np.arange(count, dtype=np.int64)
    rb = np.maximum(r // base, 1)
    k = np.floor(np.log2(rb)).astype(np.int64)
    sel = (r < base) | ((r < 16 * base)
                        & ((r & ((1 << (k + 1)) - 1)) == 0))
    order = np.concatenate([r[sel], r[~sel]])
    return order[: min(cap, count)]


def _layout_grid(ids_sorted: np.ndarray, bins_sorted: np.ndarray, cap: int):
    """Pack one grid's (bin, distance)-sorted active points into cap-aligned
    tiles. Returns (row_ids, tile_coffs, tile_bigcnt): row_ids has -1
    padding; tile t's queries are rows [t·cap, (t+1)·cap); tile_bigcnt[t]
    is the tile's bin member count when the tile is a big-bin chunk
    (0 otherwise).

    Small bins (≤ cap) are packed first-fit-decreasing, several to a tile
    (coverers = the whole tile, restricted to same-bin pairs by the bin-id
    test — exactly the bin's full member set). A bin larger than cap gets a
    dedicated tile-aligned span: queries chunked per tile; chunk 0's
    coverers are the span's FIRST cap rows (exact — every possible
    dominator of a rank<cap query is nearer); deeper chunks get the tiered
    distance-rank sample (:func:`_np_stratified_ranks`) — the same rules as
    hpr_mask_soft_binned's stratified coverer layout.
    """
    if len(bins_sorted):
        cut = np.flatnonzero(np.diff(bins_sorted)) + 1
        starts = np.concatenate([[0], cut]).astype(np.int64)
        ends = np.concatenate([cut, [len(bins_sorted)]]).astype(np.int64)
    else:
        starts = ends = np.zeros(0, np.int64)
    counts = ends - starts

    big = np.flatnonzero(counts > cap)
    small = np.flatnonzero(counts <= cap)
    # first-fit-decreasing over the small bins
    order = small[np.argsort(-counts[small], kind="stable")]
    tiles: list[list[int]] = []   # small-bin groups per tile
    space: list[int] = []         # remaining capacity per tile
    for g in order:
        c = int(counts[g])
        for t, sp in enumerate(space):
            if sp >= c:
                tiles[t].append(g)
                space[t] -= c
                break
        else:
            tiles.append([g])
            space.append(cap - c)

    rows: list[np.ndarray] = []
    coffs: list[int] = []
    bigcnt: list[int] = []
    n_rows = 0
    for t, groups in enumerate(tiles):
        coffs.append(n_rows)
        bigcnt.append(0)
        used = 0
        for g in groups:
            rows.append(ids_sorted[starts[g]:ends[g]])
            used += int(counts[g])
        if used < cap:
            rows.append(np.full(cap - used, -1, np.int64))
        n_rows += cap
    for g in big:
        span = n_rows
        c = int(counts[g])
        nt = -(-c // cap)
        rows.append(ids_sorted[starts[g]:ends[g]])
        pad = nt * cap - c
        if pad:
            rows.append(np.full(pad, -1, np.int64))
        n_rows += nt * cap
        coffs.extend(span for _ in range(nt))
        bigcnt.extend(c for _ in range(nt))
    if not coffs:  # empty grid: one all-padding tile
        coffs.append(0)
        bigcnt.append(0)
        rows.append(np.full(cap, -1, np.int64))
        n_rows += cap
    return (np.concatenate(rows), np.asarray(coffs, np.int64),
            np.asarray(bigcnt, np.int64))


def build_traj_plan(
    points: np.ndarray,
    valid: Optional[np.ndarray],
    poses_sel: np.ndarray,
    quats_sel: np.ndarray,
    K: np.ndarray,
    problem: TrajProblem,
    cfg: FrozenPlanConfig = FrozenPlanConfig(),
    min_tiles: int = 1,
    min_t_big: int = 1,
    owner: Optional[Tuple[int, int]] = None,
    wp_active: Optional[np.ndarray] = None,
    embed: bool = True,
) -> Tuple[Dict[str, np.ndarray], PlanMeta]:
    """Build the frozen routing plan for the selected waypoints (host numpy,
    the twin's builder: the same arrays for the same inputs).

    ``min_tiles``/``min_t_big`` floor the per-grid tile count T and the
    big-tile count TB. ``owner=(lo, hi)`` builds a point-shard slice: only
    points with lo <= id < hi become queries, and the embedding maps plan
    rows into the local id range [0, hi-lo), while coverers still come from
    the full cloud. ``wp_active`` (bool per selected waypoint) gives the
    False waypoints all-padding layouts (zero queries, zero gradient).

    Returns (plan arrays, meta). Plan arrays (:func:`put_plan` moves them to
    the device):
      q_xyz   (W,G,M,3) world coords in layout order (_PAD_COORD padding)
      c_xyz_ext (W,G,TB,cap,3) coverer coords for non-self tiles
      q_bin/c_bin_ext int16 bin ids (-1 padding)
      c_sel (W,G,T) tile → ext slot (−1 = self-covering), c_sel_inv its
      inverse, c_row_ext the ext coverers' layout rows
      qmask (W,G,M) query rows
      align_fwd/align_bwd (W,G,M) int32 grid→grid-0 permutation keys
      embed_fwd/embed_bwd (W,M+n_emb) int32 plan→cloud embedding keys
      (n_emb = hi-lo under ``owner``, the full cloud size otherwise)
      combine_fwd/combine_bwd/seg_head/n_q the sparse criterion's grouping
      _q_id (W,G,M) the layout's point ids (host-only diagnostics)
    """
    # f32 throughout the per-point host math: every output is either a
    # threshold decision (gates, bins) or re-derived on device from live
    # params
    pts = np.asarray(points, np.float32)
    n = len(pts)
    v = (np.ones(n, bool) if valid is None
         else np.asarray(valid) > 0)
    lo_own, hi_own = (0, n) if owner is None else owner
    n_emb = hi_own - lo_own
    owned = np.zeros(n, bool)
    owned[lo_own:hi_own] = True
    min_tiles = int(min_tiles)
    K = np.asarray(K, np.float64)
    poses_sel = np.asarray(poses_sel, np.float64)
    quats_sel = np.asarray(quats_sel, np.float64)
    w_sel = len(poses_sel)
    cap = min(problem.hpr_cap, n)
    tau = _HPR_DEF["tau"]
    sharpness = _HPR_DEF["sharpness"]
    r_param = _HPR_DEF["r_param"]
    theta_max, grids = _binned_grids(r_param, tau, problem.hpr_safety)
    G = len(grids)
    # bin ids ride int16 (plan['q_bin']/['c_bin_ext']): fail loudly instead
    # of silently wrapping the same-bin dominance test
    n_bins_max = max(g[-1] for g in grids)
    if n_bins_max >= 32768:
        raise ValueError(
            f"binned grids produced {n_bins_max} bins >= 2**15; widen the "
            "plan's bin-id dtype to int32 before raising r_param/safety "
            "this far")
    Rs = _np_quat_matrices(quats_sel).astype(np.float32)
    poses32 = poses_sel.astype(np.float32)

    per_wp = []  # (g_rows (G,), g_coffs (G,), g_bins (G,), q_rel, g_bigs)
    max_tiles = 1
    for w in range(w_sel):
        cam = (pts - poses32[w]) @ Rs[w]
        norms = np.linalg.norm(cam, axis=1)
        score = np.where(v, _np_scores(cam, K, problem), 0.0)
        smax = score.max()
        q_rel = v & (score > cfg.score_rel_thresh * max(smax, 1e-300))
        if not q_rel.any():
            q_rel = v.copy()  # degenerate: keep everything (blind waypoint)
        # owner restriction AFTER the global gate/fallback: the query SET
        # partitions exactly across shards (union = the single-chip set)
        q_rel &= owned
        if wp_active is not None and not wp_active[w]:
            q_rel = np.zeros(n, bool)  # dummy waypoint: empty layout
        scale = max(norms[v].max() if v.any() else 1.0, 1e-6)
        # a point only matters as a coverer when ITS OWN BIN holds a query
        # within the logsumexp tail's norm band (dominance is same-bin
        # only, so the test is exact per grid, not a global band)
        slack = max(0.0, cfg.tail / sharpness - tau) * scale + cfg.drift_slack
        u = cam / np.maximum(norms, 1e-12)[:, None]
        lat = np.arcsin(np.clip(u[:, 2], -1.0, 1.0))
        az = np.arctan2(u[:, 1], u[:, 0]) + np.pi
        g_rows, g_coffs, g_bins, g_bigs = [], [], [], []
        for grid in grids:
            n_bins = grid[-1]
            bins = _np_grid_bins(grid, lat, az)
            qmax = np.full(n_bins, -np.inf)
            np.maximum.at(qmax, bins[q_rel], norms[q_rel])
            keep = v & (norms <= qmax[bins] + slack)  # queries pass trivially
            active = np.flatnonzero(keep)
            order = np.lexsort((norms[active], bins[active]))
            row_ids, coffs, bigcnt = _layout_grid(
                active[order], bins[active][order], cap)
            g_rows.append(row_ids)
            g_coffs.append(coffs)
            g_bigs.append(bigcnt)
            g_bins.append(bins)
            max_tiles = max(max_tiles, len(coffs))
        per_wp.append((g_rows, g_coffs, g_bins, q_rel, g_bigs))

    T = max(_ladder_ceil(max_tiles, cfg.tile_round, cfg.tile_ladder_ratio),
            min_tiles)
    M = T * cap

    q_id = np.full((w_sel, G, M), -1, np.int64)
    q_bin = np.full((w_sel, G, M), -1, np.int64)
    coff_arr = np.zeros((w_sel, G, T), np.int64)
    qmask = np.zeros((w_sel, G, M), bool)
    align_fwd = np.empty((w_sel, G, M), np.int64)
    align_bwd = np.empty((w_sel, G, M), np.int64)
    if embed:
        embed_fwd = np.empty((w_sel, M + n_emb), np.int64)
        embed_bwd = np.empty((w_sel, M + n_emb), np.int64)
    ids_all = np.full((w_sel, M), -1, np.int64)  # grid-0 rows' local ids
    n_q_arr = np.zeros(w_sel, np.int64)
    ar_m = np.arange(M)
    for w in range(w_sel):
        g_rows, g_coffs, g_bins, q_rel, _ = per_wp[w]
        # grid-0 row of every query point (queries are in every grid)
        g0 = np.full(M, -1, np.int64)
        g0[: len(g_rows[0])] = g_rows[0]
        valid0 = g0 >= 0
        qmask0 = np.zeros(M, bool)
        qmask0[valid0] = q_rel[g0[valid0]]
        pos0_q = np.full(n, -1, np.int64)
        pos0_q[g0[qmask0]] = ar_m[qmask0]
        nonq_pool = ar_m[~qmask0]  # grid-0 slots not holding a query
        for g in range(G):
            rows = g_rows[g]
            q_id[w, g, : len(rows)] = rows
            coffs = np.full(T, -1, np.int64)
            coffs[: len(g_coffs[g])] = g_coffs[g]
            # padding tiles cover themselves (all-pad rows)
            coffs[len(g_coffs[g]):] = ar_m[len(g_coffs[g]) * cap:: cap][
                : T - len(g_coffs[g])]
            coff_arr[w, g] = coffs
            qi = q_id[w, g]
            ok = qi >= 0
            q_bin[w, g, ok] = g_bins[g][qi[ok]]
            is_q = np.zeros(M, bool)
            is_q[ok] = q_rel[qi[ok]]
            qmask[w, g] = is_q

            # grid→grid-0 alignment: query rows go to the SAME point's
            # grid-0 row (smax must merge across grids per query); all
            # other rows fill the remaining slots bijectively
            fwd = np.empty(M, np.int64)
            fwd[is_q] = pos0_q[qi[is_q]]
            fwd[~is_q] = nonq_pool[: (~is_q).sum()]
            align_fwd[w, g] = fwd
            inv = np.empty(M, np.int64)
            inv[fwd] = ar_m
            align_bwd[w, g] = inv

        # sparse-criterion bookkeeping: grid-0 query rows' local ids + count
        loc0 = g0[qmask0] - lo_own  # owned query points' local ids
        ids_all[w, ar_m[qmask0]] = loc0
        n_q_arr[w] = int(qmask0.sum())
        if not embed:
            continue
        # plan(grid-0) → cloud embedding keys: slots are [M plan rows, n_emb
        # extension], slot j goes to fwd[j], the first n_emb are kept. Only
        # QUERY rows land at their canonical position — every non-query
        # point reads exactly 0 (the gate semantics). Canonical positions
        # are LOCAL under ``owner`` (global id − lo).
        fwd = np.empty(M + n_emb, np.int64)
        fwd[ar_m[qmask0]] = loc0
        nonq_pts = np.ones(n_emb, bool)
        nonq_pts[loc0] = False
        ext = np.arange(M, M + n_emb)
        fwd[ext[nonq_pts]] = np.flatnonzero(nonq_pts)  # fillers (0-valued)
        rest = np.concatenate([ar_m[~qmask0], ext[~nonq_pts]])
        fwd[rest] = np.arange(n_emb, n_emb + len(rest))
        embed_fwd[w] = fwd
        # backward keys: cotangent slots are [n_emb canonical, M zero
        # extension], ordered by bwd key, the first M = plan-row cotangents
        bwd = np.empty(M + n_emb, np.int64)
        bwd[loc0] = ar_m[qmask0]
        zslots = np.arange(n_emb, n_emb + M)
        bwd[zslots[: (~qmask0).sum()]] = ar_m[~qmask0]
        rest_dst = np.arange(M, M + n_emb)
        rest_src = np.concatenate([np.flatnonzero(nonq_pts),
                                   zslots[(~qmask0).sum():]])
        bwd[rest_src] = rest_dst
        embed_bwd[w] = bwd

    # Coverer data: a tile whose coverer span IS its own query span (all
    # packed small-bin tiles) reuses the query arrays on device; only
    # big-bin query-chunk tiles carry separate coverer rows, compacted into
    # (W, G, TB, cap) ext arrays.
    self_tile = coff_arr == (np.arange(T, dtype=np.int64) * cap)[None, None]
    TB = max(_ladder_ceil(int((~self_tile).sum(axis=2).max()), 4,
                          cfg.tile_ladder_ratio), 4, int(min_t_big))
    meta = PlanMeta(n_sel=w_sel, n_points=n_emb, cap=cap, n_grids=G, tiles=T,
                    t_big=TB)
    strat = bool(_HPR_DEF.get("stratified_coverers", True))
    c_sel = np.full((w_sel, G, T), -1, np.int64)
    c_sel_inv = np.full((w_sel, G, TB), -1, np.int64)  # slot -> its one tile
    c_id_ext = np.full((w_sel, G, TB, cap), -1, np.int64)
    c_bin_ext = np.full((w_sel, G, TB, cap), -1, np.int64)
    c_row_ext = np.full((w_sel, G, TB, cap), -1, np.int64)  # layout rows
    for w in range(w_sel):
        g_bins = per_wp[w][2]
        g_bigs = per_wp[w][4]
        for g in range(G):
            for k, t in enumerate(np.flatnonzero(~self_tile[w, g])):
                c_sel[w, g, t] = k
                c_sel_inv[w, g, k] = t
                off = coff_arr[w, g, t]
                cnt = int(g_bigs[g][t]) if t < len(g_bigs[g]) else 0
                if strat and cnt > cap:
                    # deep chunk of a big bin: tiered distance-rank sample
                    # over the WHOLE bin (chunk 0 stays a self tile = the
                    # exact closest-cap prefix)
                    pos = off + _np_stratified_ranks(cnt, cap)
                else:
                    pos = off + np.arange(cap)
                rows = q_id[w, g][pos]
                c_id_ext[w, g, k, : len(rows)] = rows
                c_row_ext[w, g, k, : len(rows)] = pos
                okr = rows >= 0
                c_bin_ext[w, g, k, : len(rows)][okr] = g_bins[g][rows[okr]]

    # sparse criterion tail (traj_forward_frozen_mean): group every
    # (w, grid-0 row) QUERY entry by canonical id — one stored permutation
    # over the W·M entries plus a segment-head mask for the device-side
    # O(log W) suffix sum
    flat = ids_all.reshape(-1)
    wm = flat.shape[0]
    order = np.argsort(np.where(flat >= 0, flat, n_emb), kind="stable")
    combine_bwd = order
    combine_fwd = np.empty(wm, np.int64)
    combine_fwd[order] = np.arange(wm)
    sorted_ids = flat[order]
    seg_head = (sorted_ids >= 0) & np.concatenate(
        [[True], sorted_ids[1:] != sorted_ids[:-1]])

    pad3 = np.full(3, _PAD_COORD)
    pts_ext = np.concatenate([pts, pad3[None]], axis=0)  # id -1 -> padding
    plan = {
        "q_xyz": pts_ext[q_id].astype(np.float32),
        "c_xyz_ext": pts_ext[c_id_ext].astype(np.float32),
        "q_bin": q_bin.astype(np.int16),
        "c_bin_ext": c_bin_ext.astype(np.int16),
        "c_sel": c_sel.astype(np.int32),
        "c_sel_inv": c_sel_inv.astype(np.int32),
        "c_row_ext": c_row_ext.astype(np.int32),
        "qmask": qmask,
        "align_fwd": align_fwd.astype(np.int32),
        "align_bwd": align_bwd.astype(np.int32),
        "combine_fwd": combine_fwd.astype(np.int32),
        "combine_bwd": combine_bwd.astype(np.int32),
        "seg_head": seg_head,
        "n_q": n_q_arr.astype(np.int32),
        # host-only diagnostics (underscored keys never go to the device)
        "_q_id": q_id.astype(np.int32),
    }
    if embed:
        plan["embed_fwd"] = embed_fwd.astype(np.int32)
        plan["embed_bwd"] = embed_bwd.astype(np.int32)
    return plan, meta


def live_tiles(plan: Dict[str, np.ndarray], meta: PlanMeta) -> np.ndarray:
    """The tiles of the flattened (W·G·T) tile axis that hold a query row."""
    W, G, T, cap = meta.n_sel, meta.n_grids, meta.tiles, meta.cap
    return np.flatnonzero(plan["qmask"].reshape(W * G * T, cap).any(axis=1))


def live_rung(n_live: int, meta: PlanMeta, cfg: FrozenPlanConfig, floor: int = 0) -> int:
    """The padded live-tile count of a plan: ``n_live`` rounded up onto the
    tile-count ladder (``cfg.tile_round``, ``cfg.tile_ladder_ratio``), at
    least ``floor``, at most every tile (W·G·T)."""
    rung = max(_ladder_ceil(n_live, cfg.tile_round, cfg.tile_ladder_ratio), int(floor))
    return min(rung, meta.n_sel * meta.n_grids * meta.tiles)


def stage_plan(plan: Dict[str, np.ndarray], meta: PlanMeta, pin: bool = False,
               n_live: Optional[int] = None):
    """A built plan as the CPU tensors the device step reads (pinned when
    ``pin``, so that :func:`put_plan`'s copies are asynchronous).

    Everything the step would otherwise derive from the plan each step is
    derived here once. ``live`` lists the tiles of the flattened (W·G·T)
    tile axis that hold a query row: the others (the tile-count ladder's
    padding tiles, coverer-only tiles) produce no value the loss reads, and
    the step skips them. Per live tile: the query bins, the coverers' bins
    (−2 on padding, so that no padding row pairs with another) and layout
    rows, the query layout rows, whether the tile covers itself and which
    compact ext slot it reads, and its waypoint. The index keys go to
    int64; the sparse criterion's segment ids and, per shift of its suffix
    sum, which entries share a segment. The twin's backward keys are not
    needed: each permutation's backward is a gather by its forward key.

    ``n_live`` pads the live list to that length (:func:`live_rung`), so
    that a step's shapes stay fixed while the count of tiles holding a
    query moves: the padding takes distinct tiles that hold no query (the
    gathers' backward still adds one term per slot), with query bins −1
    that pair with no coverer, so that they add nothing to the loss or its
    gradient, and they write only into tiles whose rows the loss masks."""
    W, G, T, TB, cap = meta.n_sel, meta.n_grids, meta.tiles, meta.t_big, meta.cap
    live = live_tiles(plan, meta)
    n_real = len(live)
    if n_live is not None and n_live > n_real:
        idle = np.setdiff1d(np.arange(W * G * T), live, assume_unique=True)
        live = np.concatenate([live, idle[: n_live - n_real]])
    sel = plan["c_sel"].astype(np.int64)
    is_self = sel < 0
    selc = np.maximum(sel, 0)[..., None]
    q_bin = plan["q_bin"].astype(np.int32).reshape(W, G, T, cap)
    c_bin = np.where(is_self[..., None], q_bin,
                     np.take_along_axis(plan["c_bin_ext"].astype(np.int32), selc, axis=2))
    q_row = np.broadcast_to(np.arange(T * cap, dtype=np.int32).reshape(T, cap), q_bin.shape)
    c_row = np.where(is_self[..., None], q_row,
                     np.take_along_axis(plan["c_row_ext"].astype(np.int32), selc, axis=2))
    ext_idx = (np.arange(W)[:, None, None] * G + np.arange(G)[None, :, None]) * TB + selc[..., 0]
    per_tile = lambda a: a.reshape((W * G * T,) + a.shape[3:])[live]  # noqa: E731
    q_bin_live = per_tile(q_bin)
    q_bin_live[n_real:] = -1  # padding tiles: no query pairs with a coverer
    arrays = {
        "q_xyz": plan["q_xyz"],
        "c_xyz_ext": plan["c_xyz_ext"],
        "live": live,
        "live_w": live // (G * T),
        "q_bin": q_bin_live,
        "c_key": per_tile(np.where(c_bin >= 0, c_bin, -2)),
        "q_row": per_tile(q_row),
        "c_row": per_tile(c_row),
        "is_self": per_tile(is_self),
        "ext_idx": per_tile(ext_idx),
        "qmask": plan["qmask"],
        "align_fwd": plan["align_fwd"].astype(np.int64),
    }
    if "seg_head" in plan:  # the sparse criterion's arrays (a sharded plan has none)
        head = plan["seg_head"]
        seg_id = np.cumsum(head, dtype=np.int64)
        same, k = [], 1
        while k < max(W, 2):
            same.append(np.concatenate([seg_id[k:], np.full(k, -1)]) == seg_id)
            k *= 2
        arrays.update(combine_fwd=plan["combine_fwd"].astype(np.int64), seg_head=head,
                      seg_same=np.stack(same), n_q=plan["n_q"].astype(np.float32))
    if "embed_fwd" in plan:
        arrays["embed_fwd"] = plan["embed_fwd"].astype(np.int64)
    out = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in arrays.items()}
    return {k: t.pin_memory() for k, t in out.items()} if pin else out


def put_plan(plan, meta: PlanMeta, device="cuda") -> Dict[str, torch.Tensor]:
    """A plan on ``device``: ``build_traj_plan``'s arrays (staged here) or
    :func:`stage_plan`'s tensors. Copies from pinned memory are
    asynchronous on the current stream, ahead of the steps that read them."""
    if any(isinstance(a, np.ndarray) for a in plan.values()):
        plan = stage_plan(plan, meta, pin=torch.device(device).type == "cuda")
    return {k: t.to(device, non_blocking=True) for k, t in plan.items()}


# ---------------------------------------------------------------------------
# stored permutations
# ---------------------------------------------------------------------------


def perm_apply(fwd_key, bwd_key, x, fill, n_out: int):
    """Batched stored-permutation apply: ``x`` (..., n_in) padded with
    ``fill`` to the key length, slot j placed at ``fwd_key[j]`` (a
    permutation of the last axis per batch row), the first ``n_out``
    positions kept. A scatter; its backward is the gather of the padded
    cotangent by ``fwd_key``. ``bwd_key``, the twin's stored inverse (its
    backward sorts by it), is accepted and not needed."""
    del bwd_key
    pad = fwd_key.shape[-1] - x.shape[-1]
    xp = F.pad(x, (0, pad), value=float(fill)) if pad else x
    return torch.empty_like(xp).scatter_(-1, fwd_key, xp)[..., :n_out]


def _select_ext(ext, self_vals, is_self, ext_idx):
    """Per-tile coverer pick over the flattened (W·G·T) tile axis:
    ``self_vals`` (B, cap[, 3]) where the tile covers itself, else its
    compact ext slot of ``ext`` (W, G, TB, cap[, 3]), a gather by
    ``ext_idx`` (B,). Each ext slot feeds one tile, so the gather's
    backward adds one term per slot."""
    flat = ext.reshape((-1,) + ext.shape[3:])
    picked = flat.index_select(0, ext_idx)
    keep = is_self.reshape((-1,) + (1,) * (self_vals.dim() - 1))
    return torch.where(keep, self_vals, picked)


# ---------------------------------------------------------------------------
# the per-step device computation
# ---------------------------------------------------------------------------


def _cam_planes_nd(xyz, R, tR):
    """(W, *batch, 3) world coords -> camera-frame (..., 3) under
    per-waypoint (R, t·R), the arithmetic of ops.scores.camera_planes. Any
    number of batch dims after the leading W."""
    px, py, pz = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    ones = (1,) * (xyz.dim() - 2)
    Rb = R.reshape((R.shape[0],) + ones + (3, 3))
    tb = tR.reshape((tR.shape[0],) + ones + (3,))
    cx = px * Rb[..., 0, 0] + py * Rb[..., 1, 0] + pz * Rb[..., 2, 0] - tb[..., 0]
    cy = px * Rb[..., 0, 1] + py * Rb[..., 1, 1] + pz * Rb[..., 2, 1] - tb[..., 1]
    cz = px * Rb[..., 0, 2] + py * Rb[..., 1, 2] + pz * Rb[..., 2, 2] - tb[..., 2]
    return torch.stack([cx, cy, cz], dim=-1)


def _frozen_tiles(qu, cu, crho, beta_t, q_bin, c_key, q_row, c_row, t0, t1):
    """Tiles [t0, t1) of the flattened tile axis: cos (n, cap, cap), the
    pairs off the mask, and β·dom with dom = max(cos, 0)·ρ_cov, −1e30 off
    the mask. A pair counts where query and coverer share a bin (padding
    rows share none) and are different layout rows."""
    with _full_f32_matmul(qu):
        cos = torch.bmm(qu[t0:t1], cu[t0:t1].transpose(1, 2))
    bad = ((q_bin[t0:t1, :, None] != c_key[t0:t1, None, :])
           | (q_row[t0:t1, :, None] == c_row[t0:t1, None, :]))
    x = (torch.clamp_min(cos, 0.0).mul_(crho[t0:t1, None, :]).masked_fill_(bad, -_BIG_SOFT)
         .mul_(beta_t[t0:t1, None, None]))
    return cos, bad, x


class _FrozenLSE(torch.autograd.Function):
    """lse[b, i] = logsumexpⱼ(β·dom) of every query row of every tile of the
    flattened (W·G·T, cap, cap) tile set, ``chunk`` tiles at a time: nothing
    of size W·G·T·cap² is kept between forward and backward. (The sharded
    binned gate, ``parallel.hpr_sharded``, runs its (T, rows, columns)
    tiles through it too.) The backward
    recomputes each chunk; its softmax weights are exp(x − max)/Σ from the
    row's max and sum kept by the forward, and the derivative of
    max(cos, 0) is ½ at cos = 0, as ``jnp.maximum`` splits it (the pattern
    of ops.hpr._BinnedLSE)."""

    @staticmethod
    def forward(ctx, qu, cu, crho, beta_t, q_bin, c_key, q_row, c_row, chunk):
        B, rows = qu.shape[:2]
        top, total = crho.new_empty((B, rows)), crho.new_empty((B, rows))
        with span(FROZEN_TILES_RANGE):
            for t0 in range(0, B, chunk):
                t1 = min(t0 + chunk, B)
                x = _frozen_tiles(qu, cu, crho, beta_t, q_bin, c_key, q_row, c_row, t0, t1)[-1]
                top[t0:t1] = torch.amax(x, dim=2)
                total[t0:t1] = torch.sum(torch.exp_(x.sub_(top[t0:t1, :, None])), dim=2)
        ctx.save_for_backward(qu, cu, crho, beta_t, q_bin, c_key, q_row, c_row, top, total)
        ctx.chunk = chunk
        return top + torch.log(total)

    @staticmethod
    def backward(ctx, g):
        qu, cu, crho, beta_t, q_bin, c_key, q_row, c_row, top, total = ctx.saved_tensors
        B, chunk = crho.shape[0], ctx.chunk
        dqu, dcu, dcrho = torch.empty_like(qu), torch.empty_like(cu), torch.empty_like(crho)
        half = torch.full((), 0.5, dtype=crho.dtype, device=crho.device)
        with span(FROZEN_TILES_RANGE), _full_f32_matmul(qu):
            for t0 in range(0, B, chunk):
                t1 = min(t0 + chunk, B)
                cos, bad, x = _frozen_tiles(qu, cu, crho, beta_t, q_bin, c_key, q_row, c_row,
                                            t0, t1)
                # ∂L/∂dom = g·β·softmax weight, 0 off the mask
                t = torch.exp_(x.sub_(top[t0:t1, :, None])).mul_(
                    (beta_t[t0:t1, None] * g[t0:t1] / total[t0:t1])[:, :, None]
                ).masked_fill_(bad, 0.0)
                dcrho[t0:t1] = torch.sum(t * torch.clamp_min(cos, 0.0), dim=1)
                a = t.mul_(crho[t0:t1, None, :]).mul_(torch.heaviside(cos, half))  # ∂L/∂cos
                torch.bmm(a, cu[t0:t1], out=dqu[t0:t1])
                torch.bmm(a.transpose(1, 2), qu[t0:t1], out=dcu[t0:t1])
        return dqu, dcu, dcrho, None, None, None, None, None, None


def _frozen_vis(
    plan: Dict[str, torch.Tensor],
    meta: PlanMeta,
    quats_sel: torch.Tensor,
    poses_sel: torch.Tensor,
    points: torch.Tensor,
    K: torch.Tensor,
    problem: TrajProblem,
    valid: Optional[torch.Tensor] = None,
    *,
    norm_allreduce=None,
    need_score: bool = True,
):
    """Shared frozen-plan core: everything up to the per-query visibility.

    Returns (vis (W, M) in grid-0 layout order, score (W, N) or None,
    qcam0 (W, M, 3) grid-0 camera-frame coords). ``need_score=False``
    skips the full-cloud score (the sparse path recomputes scores at query
    rows from qcam0); the full-cloud camera planes are still needed for the
    per-waypoint flip radius. Every loop bound comes from ``meta``: no
    host read.
    """
    W, cap, T, M, G = meta.n_sel, meta.cap, meta.tiles, meta.rows, meta.n_grids
    B = W * G * T
    tau = _HPR_DEF["tau"]
    sharpness = _HPR_DEF["sharpness"]
    r_param = _HPR_DEF["r_param"]

    # full-cloud scores + per-waypoint flip radius (exact, every step)
    cxp, cyp, czp = camera_planes(points, quats_sel, poses_sel)
    score = None
    if need_score:
        score = scores_from_planes(
            cxp, cyp, czp, K, problem.img_width, problem.img_height,
            min_dist=problem.min_dist, max_dist=problem.max_dist,
            eps=problem.eps)  # (W, N)
    # the norms as the routed tier takes them (gate_norms), so that a refresh
    # equals it; on cloud 10 this moves the f32 step from 8.4e-4 of its
    # largest entry off float64 to 3.0e-3 (chip_smoke.py [frozen], NVIDIA H100)
    norms = gate_norms(torch.stack([cxp, cyp, czp], dim=-1))  # (W, N)
    if valid is not None:
        norms = torch.where(valid[None, :] > 0, norms, 0.0)
    maxnorm = torch.amax(norms, dim=-1)  # (W,); amax splits ties as jnp.max
    if norm_allreduce is not None:
        maxnorm = norm_allreduce(maxnorm)
    radius = _maximum(maxnorm, 1e-12) * 10.0 ** r_param
    scale = _maximum(maxnorm, 1e-6).detach()
    beta = sharpness / scale  # (W,)

    R, tR = camera_frames(quats_sel, poses_sel)
    qcam = _cam_planes_nd(plan["q_xyz"], R, tR)  # (W, G, M, 3)
    qn = gate_norms(qcam)
    q_rho = 2.0 * radius[:, None, None] - qn
    qu = qcam / _maximum(qn, 1e-12)[..., None]

    # coverers: self-covering tiles reuse the query data; big-bin query-chunk
    # tiles pick their rows from the compact (W, G, TB, cap) ext arrays
    ccam_ext = _cam_planes_nd(plan["c_xyz_ext"], R, tR)  # (W, G, TB, cap, 3)
    cn_ext = gate_norms(ccam_ext)
    c_rho_ext = 2.0 * radius[:, None, None, None] - cn_ext
    cu_ext = ccam_ext / _maximum(cn_ext, 1e-12)[..., None]

    # the tiles that hold a query row (stage_plan's ``live``), flattened
    live = plan["live"]
    qv = qu.reshape(B, cap, 3).index_select(0, live)
    cv = _select_ext(cu_ext, qv, plan["is_self"], plan["ext_idx"])
    crho = _select_ext(c_rho_ext, q_rho.reshape(B, cap).index_select(0, live),
                       plan["is_self"], plan["ext_idx"])
    beta_t = beta.index_select(0, plan["live_w"])
    chunk = max(1, TILE_BUDGET["cuda" if qv.is_cuda else "cpu"] // (cap * cap))
    lse = _FrozenLSE.apply(qv, cv, crho, beta_t, plan["q_bin"], plan["c_key"], plan["q_row"],
                           plan["c_row"], chunk)
    smax = torch.full((B, cap), -_BIG_SOFT, dtype=lse.dtype, device=lse.device).index_copy(
        0, live, lse / beta_t[:, None]).reshape(W, G, M)

    # active sets differ per grid: only QUERY rows carry meaningful smax
    # into the cross-grid merge
    smax = torch.where(plan["qmask"], smax, -_BIG_SOFT)

    # cross-grid combine in grid-0 layout order, then σ(β(ρ + τs − smax));
    # amax splits the gradient among ties as jnp.max does
    smax0 = perm_apply(plan["align_fwd"], None, smax, -_BIG_SOFT, M)
    smax_all = torch.amax(smax0, dim=1)  # (W, M)
    vis = torch.sigmoid(beta[:, None] * (q_rho[:, 0] + tau * scale[:, None] - smax_all))
    return vis, score, qcam[:, 0]


def frozen_soft_hpr_scores(
    plan: Dict[str, torch.Tensor],
    meta: PlanMeta,
    quats_sel: torch.Tensor,
    poses_sel: torch.Tensor,
    points: torch.Tensor,
    K: torch.Tensor,
    problem: TrajProblem,
    valid: Optional[torch.Tensor] = None,
    *,
    norm_allreduce=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W, N) occlusion-gated visibility scores hpr·p under the frozen plan.

    Returns (gated_scores, hpr) — both (W_sel, N); points outside the
    plan's query set get exactly 0 (their score is below the gate
    threshold, see FrozenPlanConfig). Differentiable in (quats_sel,
    poses_sel). Requires a plan built with ``embed=True`` (the default).

    ``norm_allreduce`` (a point-sharded composition): maps the per-waypoint
    max point norm (W,) over the LOCAL ``points`` to the global maximum, so
    the flip radius and sharpness scale match the single-device values.
    None (default) = ``points`` is the whole cloud already.
    """
    if "embed_fwd" not in plan:
        raise ValueError("frozen_soft_hpr_scores needs a plan built with embed=True")
    vis, score, _ = _frozen_vis(
        plan, meta, quats_sel, poses_sel, points, K, problem, valid,
        norm_allreduce=norm_allreduce, need_score=True)
    # embed plan rows into the cloud; inactive/padding -> 0
    hpr = perm_apply(plan["embed_fwd"], None, vis, 0.0, meta.n_points)
    return hpr * score, hpr


def traj_forward_frozen(
    params,
    plan: Dict[str, torch.Tensor],
    meta: PlanMeta,
    points: torch.Tensor,
    K: torch.Tensor,
    poses0: torch.Tensor,
    quats0: torch.Tensor,
    problem: TrajProblem,
    *,
    valid: Optional[torch.Tensor] = None,
):
    """traj_forward(soft_hpr=True) under a frozen routing plan.

    Same (loss, aux) contract as models.traj.traj_forward; the plan must
    have been built for the problem's CURRENT selected waypoints
    (params['poses'][::wps_step] at some refresh point ≤ drift_slack away).
    """
    sel = slice(None, None, problem.wps_step)
    quats_sel, poses_sel = params["quats"][sel], params["poses"][sel]
    gated, _ = frozen_soft_hpr_scores(
        plan, meta, quats_sel, poses_sel, points, K, problem, valid)
    lo = observation_logodds(gated, problem.eps, valid)  # (W, N)
    lo_sum = torch.sum(lo, dim=0)
    return traj_criterion(lo_sum, params, poses0, problem, valid=valid)


def traj_forward_frozen_mean(
    params,
    plan: Dict[str, torch.Tensor],
    meta: PlanMeta,
    points: torch.Tensor,
    K: torch.Tensor,
    poses0: torch.Tensor,
    quats0: torch.Tensor,
    problem: TrajProblem,
    *,
    valid: Optional[torch.Tensor] = None,
):
    """traj_forward_frozen WITHOUT materializing the (N,) rewards — the
    training step of :class:`FrozenTrajOptimizer`.

    Everything the criterion needs from the cloud reduces to the mean
    reward, and every point outside the plan's query set contributes
    exactly σ(0) = 1/2 to it. So the tail runs in plan space: scores
    recomputed at the (W, M) grid-0 query rows, per-waypoint min/max from
    query rows plus the closed-form zero, the cross-waypoint log-odds
    fusion as a stored-permutation grouping of the W·M query entries and a
    segmented suffix sum of ⌈log2 W⌉ shifted adds (the twin's summation
    order). Same loss as ``traj_forward_frozen``; aux carries the scalar
    terms only (no 'rewards').
    """
    sel = slice(None, None, problem.wps_step)
    quats_sel, poses_sel = params["quats"][sel], params["poses"][sel]
    vis, _, qcam0 = _frozen_vis(
        plan, meta, quats_sel, poses_sel, points, K, problem, valid,
        need_score=False)
    score_q = scores_from_planes(
        qcam0[..., 0], qcam0[..., 1], qcam0[..., 2], K,
        problem.img_width, problem.img_height,
        min_dist=problem.min_dist, max_dist=problem.max_dist,
        eps=problem.eps)  # (W, M)
    qmask0 = plan["qmask"][:, 0]
    gated_q = torch.where(qmask0, vis * score_q, 0.0)

    n_valid = (torch.full((), float(meta.n_points), dtype=gated_q.dtype, device=gated_q.device)
               if valid is None else torch.sum(valid))
    big = torch.finfo(gated_q.dtype).max
    min_g = torch.amin(torch.where(qmask0, gated_q, big), dim=1)
    max_g = torch.amax(torch.where(qmask0, gated_q, -big), dim=1)
    # non-query VALID points exist almost always; their gated score is an
    # exact 0, which extends the min/max window (dense-path semantics);
    # minimum/maximum split the gradient at a tie as jnp's do
    has_other = plan["n_q"] < n_valid
    zero = torch.zeros_like(min_g)
    pmin = torch.where(has_other, torch.minimum(min_g, zero), min_g)
    pmax = torch.where(has_other, torch.maximum(max_g, zero), max_g)
    lo_q = torch.where(
        qmask0,
        logodds_from_minmax(gated_q, pmin[:, None], pmax[:, None], problem.eps),
        0.0)

    # cross-waypoint fusion: group the W·M grid-0 entries by canonical id
    # (host-stored permutation), then a segmented suffix sum — segments are
    # ≤ W_sel long, so ⌈log2 W⌉ shifted adds close the fusion
    x = lo_q.reshape(1, -1)
    wm = x.shape[-1]
    grouped = perm_apply(plan["combine_fwd"][None], None, x, 0.0, wm)[0]
    head = plan["seg_head"]
    tot, k = grouped, 1
    for same in plan["seg_same"]:
        tot = tot + torch.where(same, F.pad(tot[k:], (0, k)), 0.0)
        k *= 2
    # Σ_valid σ(lo_sum) = Σ_heads (σ − ½) + ½·n_valid (untouched points
    # sit at exactly lo_sum = 0)
    sum_sig = torch.sum(torch.where(head, torch.sigmoid(tot) - 0.5, 0.0))
    mean_reward = (sum_sig + 0.5 * n_valid) / torch.clamp(n_valid, min=1.0)
    return traj_criterion_from_mean(mean_reward, params, poses0, problem)


# ---------------------------------------------------------------------------
# runner: refresh cadence
# ---------------------------------------------------------------------------


class _FrozenBucket:
    """One step shape of a frozen optimizer on the ``"graph"`` or
    ``"static"`` route: the plan's static device buffers (pinned host
    buffers beside them on the card, from which a refresh copies
    asynchronously), the Adam step's static parameters, moments, loss and
    aux (``opt.engine.AdamStep``, made by the shape's first step from the
    caller's values) and its captured step."""

    def __init__(self, opt, key, staged):
        self.key = key
        dev = opt.device
        self.plan = {k: torch.empty(v.shape, dtype=v.dtype, device=dev) for k, v in staged.items()}
        self.host = None
        if dev.type == "cuda":  # made here, on the caller's thread, never during a capture
            self.host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                         for k, v in staged.items()}
        self.copied = None  # the event after the last refresh's copies
        # no reference back to the bucket, and only a weak one to the
        # optimizer (which holds the bucket): with no reference cycle, a
        # dropped bucket is freed at once, never later by the garbage
        # collector, which may run inside a capture, where freeing its
        # pinned buffers (an event record) or its graph fails the capture
        plan, meta, owner = self.plan, key[0], weakref.ref(opt)
        self.loss_fn = lambda p: owner()._step_loss(p, plan, meta)  # noqa: E731
        self.step: Optional[AdamStep] = None
        self.graph: Optional[StepGraph] = None

    def load(self, staged) -> None:
        """Copy a staged plan into the static buffers, on the current stream
        (the capture stream on the card, ahead of the next replay)."""
        if self.host is None:
            for k, v in staged.items():
                self.plan[k].copy_(v)
            return
        if self.copied is not None:
            self.copied.synchronize()  # the last copies out of the pinned buffers are done
        for k, v in staged.items():
            self.host[k].copy_(v)
            self.plan[k].copy_(self.host[k], non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record()


class FrozenTrajOptimizer:
    """Occlusion-aware trajectory optimization with host-refreshed routing.

    Drop-in peer of running Adam over ``traj_forward(soft_hpr=True)``:
    every ``plan_cfg.refresh_every`` steps the routing plan is rebuilt on
    the host for the current waypoints; in between, steps run the
    frozen-plan step on ``device`` (the card unless the caller passes
    ``"cpu"``) with no host read. The step runs the sparse criterion tail
    (traj_forward_frozen_mean). Call :meth:`close` when done: it joins the
    plan builder's worker thread and frees the captured step.

    Plan shapes, as the twin's runner keeps them: each build floors the
    tile count T and the big-tile count TB at the largest seen so far
    (``build_traj_plan(min_tiles=, min_t_big=)``), and on the graph and
    static routes the list of tiles holding a query is padded to a rung of
    the tile ladder, floored the same way (:func:`live_rung`), so that a
    run settles on one shape. The eager route stages the live tiles alone:
    the padding changes no bit of the step, only its work.

    Routes (``opt/graphs.py``): on the card the step of each shape
    (``PlanMeta``, live rung) is captured as one CUDA graph over static
    buffers, the counterpart of the twin's jitted step per ``PlanMeta``:
    the shape's first step runs eagerly, the later ones replay the graph,
    and a refresh copies the new plan into the shape's buffers (a larger
    shape takes a new bucket; the floors never let a smaller one come
    back, so the old one is freed). On the CPU the steps run the eager
    loop; ``"static"`` there runs the card's static-buffer step uncaptured. The
    plan builder's worker thread only computes numpy arrays: it makes no
    CUDA call, so it cannot fail a capture on the caller's thread.
    """

    _need_embed = False  # sparse step: no embedding keys

    def __init__(self, points, K, poses0, quats0, problem: TrajProblem,
                 opt_cfg=None, plan_cfg: FrozenPlanConfig = FrozenPlanConfig(),
                 valid=None, *, device="cuda"):
        self.device = torch.device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.points_np = _np(points).astype(np.float32)
        self.points = torch.as_tensor(self.points_np, **f32)
        self.valid_np = None if valid is None else _np(valid)
        self.valid = None if valid is None else torch.as_tensor(self.valid_np, **f32)
        self.K_np = _np(K).astype(np.float32)
        self.K = torch.as_tensor(self.K_np, **f32)
        self.poses0 = torch.as_tensor(_np(poses0), **f32)
        self.quats0 = torch.as_tensor(_np(quats0), **f32)
        self.problem = problem
        self.plan_cfg = plan_cfg
        self.opt_cfg = opt_cfg or OptimizerConfig()
        self.tx = make_optimizer(self.opt_cfg)
        # the route of its steps: the static-buffer step ("graph": captured on
        # the card, called directly elsewhere) or its own eager step ("eager")
        self._route = "graph" if self.device.type == "cuda" else "eager"
        self._steps_since_refresh = 0
        self._plan = None
        self._meta = None
        self._pending = None
        self._pool = None
        self._bucket: Optional[_FrozenBucket] = None
        self._t_floor = 1  # the largest tile count built: keeps one PlanMeta
        self._tb_floor = 1  # the largest big-tile count built (same reason)
        self._live_floor = 0  # the largest live rung staged (same reason)
        # live_tiles: (tiles holding a query, count staged) of the last
        # LIVE_TILES_KEPT refreshes (the count staged is padded on the graph
        # and static routes only); captures: the step shapes taken on those
        # routes (one capture each on the card), capture_s their capture
        # seconds; prewarms: shapes captured ahead of need (none: see
        # FrozenPlanConfig)
        self.stats = {"refreshes": 0, "swap_s": 0.0, "build_s": 0.0, "prewarms": 0,
                      "captures": 0, "capture_s": 0.0,
                      "live_tiles": collections.deque(maxlen=LIVE_TILES_KEPT)}

    def _selected(self, params_host):
        """(poses_sel, quats_sel) the plan is built for — numpy, host."""
        sel = slice(None, None, self.problem.wps_step)
        return params_host["poses"][sel], params_host["quats"][sel]

    def _build(self, params_host):
        poses_sel, quats_sel = self._selected(params_host)
        plan, meta = build_traj_plan(
            self.points_np, self.valid_np, poses_sel, quats_sel,
            self.K_np, self.problem, self.plan_cfg,
            min_tiles=self._t_floor, min_t_big=self._tb_floor, embed=self._need_embed)
        self._t_floor = max(self._t_floor, meta.tiles)
        self._tb_floor = max(self._tb_floor, meta.t_big)
        return plan, meta

    def _build_staged(self, params_host):
        """Build and stage a plan (numpy, then tensors): all of a refresh's
        host work, which the worker thread runs in async mode. Returns
        (staged, meta, (tiles holding a query, count staged)). The eager
        route stages the live tiles alone and pins them here; the graph and
        static routes pad the list to its rung (:func:`live_rung`), so that
        their step keeps its shape, and their buckets own pinned buffers,
        made on the caller's thread."""
        plan, meta = self._build(params_host)
        n_real = len(live_tiles(plan, meta))
        if self._route == "eager":
            pin = self.device.type == "cuda"
            return stage_plan(plan, meta, pin=pin), meta, (n_real, n_real)
        n_live = live_rung(n_real, meta, self.plan_cfg, self._live_floor)
        self._live_floor = max(self._live_floor, n_live)
        return stage_plan(plan, meta, n_live=n_live), meta, (n_real, n_live)

    def _swap(self, staged, meta, live=None):
        t0 = time.perf_counter()
        if self._route == "eager":
            self._plan = put_plan(staged, meta, self.device)
        else:
            key = (meta, int(staged["live"].shape[0]))
            if self._bucket is None or self._bucket.key != key:
                self._drop_bucket()
                self._bucket = _FrozenBucket(self, key, staged)
                self.stats["captures"] += 1
            with on_capture_stream(self.device):
                self._bucket.load(staged)
            self._plan = self._bucket.plan
        self._meta = meta
        self._steps_since_refresh = 0
        self.stats["refreshes"] += 1
        if live is not None:
            self.stats["live_tiles"].append(live)
        self.stats["swap_s"] += time.perf_counter() - t0

    def _drop_bucket(self):
        """Free the current bucket once the steps that read it are done (the
        next step then refreshes the plan). A freed graph's memory pool
        stays in the allocator's cache, which hands it back when an
        allocation outside a capture would otherwise fail;
        ``torch.cuda.empty_cache()``, the caller's to call (it empties the
        whole process's cache), returns it to the card at once: a caller
        short of memory calls it between shapes."""
        if self._bucket is None:
            return
        if self.device.type == "cuda":
            capture_stream(self.device).synchronize()
        self._bucket, self._plan = None, None

    def _kick_async(self, params):
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="frozenplan")
        # snapshot params on the host NOW (device steps keep updating them)
        host = {k: _np(v) for k, v in params.items()}
        self._pending = self._pool.submit(self._build_staged, host)

    def _refresh(self, params):
        if self._pending is not None:
            # async: apply the plan kicked off at the previous boundary
            # (built from params refresh_every steps back — the gate slacks
            # budget for that lag) and start the next build from the
            # CURRENT params
            t0 = time.perf_counter()
            staged_meta = self._pending.result()
            self.stats["build_s"] += time.perf_counter() - t0  # blocked part
            self._swap(*staged_meta)
            self._kick_async(params)
            return
        t0 = time.perf_counter()
        built = self._build_staged({k: _np(v) for k, v in params.items()})
        self.stats["build_s"] += time.perf_counter() - t0
        self._swap(*built)
        if self.plan_cfg.async_refresh:
            self._kick_async(params)

    def close(self):
        """Drop the plan, wait for a build in flight, join the worker thread
        and free the captured step."""
        self.reset()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        self._drop_bucket()

    def __del__(self):  # best effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass

    def _loss(self, p, plan, meta):
        return traj_forward_frozen_mean(
            p, plan, meta, self.points, self.K, self.poses0, self.quats0,
            self.problem, valid=self.valid)

    def _aux_out(self, aux):
        return {k: v for k, v in aux.items() if v.dim() == 0}

    def _step_loss(self, p, plan, meta):
        """The step's (loss, aux): the loss under ``plan``, aux cut to what
        ``step`` returns."""
        loss, aux = self._loss(p, plan, meta)
        return loss, self._aux_out(aux)

    def init(self, params):
        return self.tx.init(params)

    def reset(self):
        """Drop the current plan (and any in-flight async build). Call
        before optimizing from params discontinuous with the previous run —
        the routing gates are only valid within ``drift_slack`` of the poses
        they were built for. ``run()`` resets automatically. The shape
        floors stay, as in the twin. A failed build in flight raises here."""
        if self._pending is not None:
            if not self._pending.cancel():
                self._pending.result()  # a build already running: wait it out
            self._pending = None
        self._plan = None
        self._meta = None
        self._steps_since_refresh = 0

    def step(self, params, opt_state):
        """One Adam step (refreshing the plan when due). Returns (params,
        opt_state, loss, aux) as device tensors that the caller owns: a
        later step never writes into them. Assumes ``params`` continues the
        trajectory of the previous step call — call :meth:`reset` first when
        jumping to unrelated params. Between refreshes it reads nothing back
        from the device; on the card it launches one graph there (and copies
        ``params`` and ``opt_state`` into the shape's static buffers, the
        results out of them)."""
        if (self._plan is None
                or self._steps_since_refresh >= self.plan_cfg.refresh_every):
            self._refresh(params)
        if self._route == "eager":
            loss, aux, grads = value_and_grad(
                lambda p: self._step_loss(p, self._plan, self._meta), params)
            updates, opt_state = self.tx.update(grads, opt_state, params)
            params = apply_updates(params, updates)
            out = (params, opt_state, loss, aux)
        else:
            out = self._static_step(params, opt_state)
        self._steps_since_refresh += 1
        return out

    def _static_step(self, params, opt_state):
        """``step`` on the static buffers of the current shape's bucket: its
        first step eagerly, then one replay of its captured step (called
        directly off the card)."""
        b = self._bucket
        with on_capture_stream(self.device):
            if b.step is None:
                b.step = AdamStep(b.loss_fn, params, self.tx.cfg, self.tx.lrs, state=opt_state,
                                  keep_output=True)
                b.graph = StepGraph(b.step.step, self.device, f"{type(self).__name__} step")
                b.step.step()  # the shape's first step, eagerly
            else:
                assign(b.step.params, params)
                assign(b.step.state, opt_state)
                captured = b.graph.graph is not None
                b.graph()
                if not captured and b.graph.capture_s is not None:
                    self.stats["capture_s"] += b.graph.capture_s
        # copies the next step leaves alone, made on the caller's stream
        return (clone_tree(b.step.params), clone_tree(b.step.state), b.step.loss.clone(),
                clone_tree(b.step.aux))

    def run(self, params, n_steps: int):
        """Run n_steps from ``params``; returns (params, losses list).
        Resets any plan left over from a previous run."""
        self.reset()
        opt_state = self.init(params)
        losses = []
        for _ in range(n_steps):
            params, opt_state, loss, _ = self.step(params, opt_state)
            losses.append(float(loss))
        return params, losses


# ---------------------------------------------------------------------------
# frozen-routing variants for the other two optimization modes — the gate
# pipeline (frozen_soft_hpr_scores) is model-agnostic; only the criterion
# and the parameterization differ
# ---------------------------------------------------------------------------


def wps_forward_frozen(params, frozen, plan, meta, points, K, problem, *,
                       valid=None, occlusion_mask=None):
    """wps_forward(soft_hpr=True) under a frozen routing plan: the
    Waypoints-Optimization criterion Σ_w 1/(Σ_n hpr·score + eps) with the
    per-waypoint differentiable HPR gates coming from the plan. Same
    (loss, aux) contract as models.wps_opt.wps_forward."""
    from trajectory_optimization_tpu_torch.models.wps_opt import wps_path

    trans, quats = wps_path(params, frozen)
    gated, _ = frozen_soft_hpr_scores(
        plan, meta, quats, trans, points, K, problem, valid)
    if occlusion_mask is not None:
        gated = gated * occlusion_mask[None, :]
    if valid is not None:
        gated = gated * valid[None, :]
    per_wp = torch.sum(gated, dim=-1)
    losses = 1.0 / (per_wp + problem.eps)
    return torch.sum(losses), {
        "losses": losses,
        "observations": gated,
        "mean_reward": torch.mean(per_wp),
    }


def pose_forward_frozen(params, plan, meta, points, K, problem, *,
                        valid=None, occlusion_mask=None):
    """pose_forward(soft_hpr=True) under a frozen routing plan (W = 1).
    Same (loss, aux) contract as models.pose.pose_forward."""
    gated, _ = frozen_soft_hpr_scores(
        plan, meta, params["quat"], params["trans"], points, K, problem,
        valid)
    mask = gated[0]
    if occlusion_mask is not None:
        mask = mask * occlusion_mask
    if valid is not None:
        mask = mask * valid
    loss = 1.0 / (torch.sum(mask) + problem.eps)
    return loss, {"observations": mask}


def _sum_criterion_cfg(plan_cfg: FrozenPlanConfig) -> FrozenPlanConfig:
    """The pose/wps criteria SUM raw gated scores — no log-odds clip floor
    protects the tail, so the query gate must bound the DROPPED MASS:
    error ≤ N·thresh·smax ≤ N·thresh·Σ. The trajectory default (1e-5,
    sized for the 0.5 clip) loses whole percents when a pose sees little;
    1e-9 bounds the relative loss error at N·1e-9 (4e-5 at 40k points).
    Only applied when the caller left the field at its class default."""
    if plan_cfg.score_rel_thresh == FrozenPlanConfig.score_rel_thresh:
        plan_cfg = dataclasses.replace(plan_cfg, score_rel_thresh=1e-9)
    return plan_cfg


class FrozenWpsOptimizer(FrozenTrajOptimizer):
    """Waypoints-Optimization (X/Y/yaw per waypoint) with host-refreshed
    soft-HPR routing. Params are the wps_opt {'xy','yaw'} dict; pass the
    frozen path parts from models.wps_opt.init_wps_params. Two-group Adam
    (xy/yaw) like the single-device engine path."""

    _need_embed = True  # wps_forward_frozen materializes (W, N) gates

    def __init__(self, points, K, frozen, problem, opt_cfg=None,
                 plan_cfg: FrozenPlanConfig = FrozenPlanConfig(),
                 valid=None, occlusion_mask=None, *, device="cuda"):
        # reuse the base state via a dummy poses0/quats0 (criterion-unused)
        super().__init__(points, K, np.zeros((1, 3), np.float32),
                         np.asarray([[1.0, 0, 0, 0]], np.float32), problem,
                         opt_cfg, _sum_criterion_cfg(plan_cfg), valid, device=device)
        self.tx = make_optimizer(opt_cfg or OptimizerConfig(),
                                 pose_key="xy", quat_key="yaw")
        self._frozen_np = {k: _np(v) for k, v in frozen.items()}
        self.frozen = {k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                       for k, v in self._frozen_np.items()}
        self.occ = (None if occlusion_mask is None
                    else torch.as_tensor(_np(occlusion_mask), dtype=torch.float32,
                                         device=self.device))

    def _selected(self, params_host):
        # numpy mirror of wps_opt.wps_path (the refresh stays on the host)
        xy, yaw = params_host["xy"], params_host["yaw"]
        z = self._frozen_np["z"]
        q0 = self._frozen_np["quats0"]
        trans = np.concatenate([xy, z[:, None]], axis=1)
        half = 0.5 * yaw
        qz = np.stack([np.cos(half), np.zeros_like(half),
                       np.zeros_like(half), np.sin(half)], axis=1)
        aw, ax, ay, az = qz[:, 0], qz[:, 1], qz[:, 2], qz[:, 3]
        bw, bx, by, bz = q0[:, 0], q0[:, 1], q0[:, 2], q0[:, 3]
        quats = np.stack([
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ], axis=1)
        return trans, quats

    def _loss(self, p, plan, meta):
        return wps_forward_frozen(p, self.frozen, plan, meta, self.points, self.K,
                                  self.problem, valid=self.valid, occlusion_mask=self.occ)

    def _aux_out(self, aux):
        return {"losses": aux["losses"]}


class FrozenPoseOptimizer(FrozenTrajOptimizer):
    """Single-pose occlusion-aware optimization with host-refreshed
    routing (W = 1). Params are the pose {'trans','quat'} dict."""

    _need_embed = True  # pose_forward_frozen materializes the (N,) gate

    def __init__(self, points, K, problem, opt_cfg=None,
                 plan_cfg: FrozenPlanConfig = FrozenPlanConfig(),
                 valid=None, occlusion_mask=None, *, device="cuda"):
        super().__init__(points, K, np.zeros((1, 3), np.float32),
                         np.asarray([[1.0, 0, 0, 0]], np.float32), problem,
                         opt_cfg, _sum_criterion_cfg(plan_cfg), valid, device=device)
        self.tx = make_optimizer(opt_cfg or OptimizerConfig(),
                                 pose_key="trans", quat_key="quat")
        self.occ = (None if occlusion_mask is None
                    else torch.as_tensor(_np(occlusion_mask), dtype=torch.float32,
                                         device=self.device))

    def _selected(self, params_host):
        return (params_host["trans"].reshape(1, 3),
                params_host["quat"].reshape(1, 4))

    def _loss(self, p, plan, meta):
        return pose_forward_frozen(p, plan, meta, self.points, self.K,
                                   self.problem, valid=self.valid, occlusion_mask=self.occ)

    def _aux_out(self, aux):
        return {}
