"""Multi-card differentiable HPR: point-sharded direction-binned dominance.

Twin of ``trajectory_optimization_tpu/parallel/hpr_sharded.py``: the binned
soft HPR of ``ops.hpr.hpr_mask_soft_binned`` with the point axis sharded over
a mesh axis. No global sort and no cross-rank scatter:

- every rank bins and stable-sorts only its own points (the same static
  grids, ``ops.hpr._binned_grids``, so bin ids agree across ranks);
- per bin, a rank's closest ``cand_l`` members are a superset of its share
  of the bin's closest members, so one fixed-size all_gather of these
  (n_bins, cand_l) tables per grid and a stable merge sort by the quantized
  distance key give the single-card layout's order (ties by global id, as a
  stable sort of the whole cloud breaks them) to depth 4·cap;
- from it, two coverer tables per bin, each as the single card forms it:
  the closest ``cap`` members (what its chunk 0 reads) and, with
  stratification, the first ``cap`` of ``ops.hpr._stratified_priority``'s
  order over the bin's global member count (what its deeper chunks read);
- each query reads the table of its chunk: its exact global in-bin rank
  comes from its position in the merged table, and a chunk-0 query that the
  single card's last, clamped tile of a bin also holds takes the max over
  both tables, as there;
- collectives: the global per-bin counts (an all_reduce), the scalar
  radius/scale as an all_gather + max, and two all_gathers of the candidate
  tables per grid (int keys/ids/flags, f32 directions/radii). Under the mesh
  module's convention the gathered tables enter per-rank work through
  ``vary``, so their gradients are summed over the ranks and each rank keeps
  its own rows.

So a query meets the single card's coverer set, in the single card's order,
and the mask equals it up to f32 summation order. The JAX twin differs from
its single-chip function in three places that the port does not copy: it
ranks a query by key alone (ties at the cap-th key fall on one side), takes
the stratified columns as if every bin were 4·cap deep (a bin with fewer
members reads fewer coverers), and skips the clamped last tile's max. The
norms are ``ops.hpr.gate_norms`` (float64, rounded once), and the
stratified tables switch off where the single card's do (2N ≥ 2^frac_bits,
N ≳ 4.2M), as the single-card tier takes them.
"""
from __future__ import annotations

from typing import Optional

import torch

from trajectory_optimization_tpu_torch.models.traj_frozen import _FrozenLSE
from trajectory_optimization_tpu_torch.ops.hpr import (
    _BIG_SOFT,
    SOFT_BINNED_DEFAULTS,
    TILE_BUDGET,
    _binned_grids,
    _direction_angles,
    _grid_bin_key,
    _maximum,
    _unpermute,
    gate_norms,
    make_cosort,
)
from trajectory_optimization_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce_, vary

__all__ = ["hpr_mask_soft_binned_sharded"]

_cosort_gid = make_cosort(4, 1)  # (key, u0, u1, u2, rho, gid): gid carries no gradient
_KEY_LAST = 0x7FFFFFFF  # sort-last sentinel of an invalid candidate row


def resolve_hpr_knobs(problem, hpr_cap, hpr_safety):
    """Default the builder knobs to the PROBLEM's hpr_cap/hpr_safety, so the
    single-card and sharded paths compute the same visibility unless the
    caller overrides them."""
    if hpr_cap is None:
        hpr_cap = getattr(problem, "hpr_cap", SOFT_BINNED_DEFAULTS["cap"])
    if hpr_safety is None:
        hpr_safety = getattr(problem, "hpr_safety", SOFT_BINNED_DEFAULTS["safety"])
    return hpr_cap, hpr_safety


def _strat_order(counts, m: int, cap_g: int):
    """(n_bins, cap_g) positions into each bin's merged (rank-ordered)
    candidate table of the coverers the single card gives its deeper chunks:
    the first cap_g of ``ops.hpr._stratified_priority``'s order over the
    bin's ``counts`` members (the tiers' picks by rank, then the other
    members by rank), and whether each position holds a member."""
    M = min(4 * cap_g, m)  # the tiers reach rank 16·base = 4·cap_g
    r = torch.arange(M, device=counts.device)
    base = max(cap_g // 4, 1)
    rb = torch.clamp(torch.div(r, base, rounding_mode="floor"), min=1).to(torch.float32)
    k = torch.frexp(rb).exponent.to(r.dtype) - 1
    sel = (r < base) | ((r < 16 * base) & ((r & ((torch.ones_like(k) << (k + 1)) - 1)) == 0))
    member = r[None, :] < counts[:, None]
    prio = torch.where(member & sel, r, torch.where(member, M + r, 2 * M + r))
    prio_s, order = torch.sort(prio, dim=1, stable=True)
    return order[:, :cap_g], prio_s[:, :cap_g] < 2 * M


def _local_mask(points_l, valid_l, gid0: int, *, mesh: Mesh, axis, r_param, sharpness, tau, cap,
                safety, n_global: int, stratified=None):
    """This rank's (n_local,) soft visibility, the point axis sharded over
    ``axis`` of ``mesh``. ``gid0`` is the global id of its first point;
    ``cap`` is the global per-bin candidate budget (single-card min(cap, N))."""
    if stratified is None:
        stratified = bool(SOFT_BINNED_DEFAULTS.get("stratified_coverers", True))
    dev = points_l.device
    n_l = points_l.shape[0]
    cap_g = min(cap, n_global)
    cap_l = min(cap_g, n_l)
    norms = gate_norms(points_l)
    v = valid_l > 0
    norms_v = torch.where(v, norms, torch.zeros_like(norms))
    # the global max norm: all_gather + max (the gradient reaches the
    # argmax rank's point, as the single-card amax)
    gmax = torch.amax(all_gather(torch.amax(norms_v), mesh, axis))
    radius = vary(_maximum(gmax, 1e-12) * 10.0 ** r_param, mesh, axis)
    rho = 2.0 * radius - norms
    scale = torch.clamp(gmax, min=1e-6).detach()
    beta = sharpness / scale
    u = points_l / _maximum(norms, 1e-12)[:, None]
    gid = gid0 + torch.arange(n_l, dtype=torch.int32, device=dev)
    lat, az = _direction_angles(u)
    chunk_budget = TILE_BUDGET["cuda" if points_l.is_cuda else "cpu"]

    _, grids = _binned_grids(r_param, tau, safety)
    smax = torch.full((n_l,), -_BIG_SOFT, dtype=points_l.dtype, device=dev)
    ar_l = torch.arange(cap_l, device=dev)
    for grid in grids:
        key, frac_bits, n_bins = _grid_bin_key(grid, lat, az, norms, scale, v)
        key_s, u0_s, u1_s, u2_s, rho_s, gid_s, perm = _cosort_gid(
            key, u[:, 0], u[:, 1], u[:, 2], rho, gid)
        bin_s = key_s >> frac_bits
        u_s = torch.stack([u0_s, u1_s, u2_s], dim=1)
        edges = torch.searchsorted(bin_s, torch.arange(n_bins + 2, dtype=bin_s.dtype, device=dev))
        counts, starts = (edges[1:] - edges[:-1])[:n_bins], edges[:n_bins]
        # the global layout: each bin's member count and first position
        # (padding, in the overflow bin, sorts last)
        counts_g = all_reduce_((edges[1:] - edges[:-1]).clone(), mesh, axis)[:n_bins]
        start_g = torch.cumsum(counts_g, 0) - counts_g
        strat = stratified and cap_g < n_global and 2 * n_global < (1 << frac_bits)

        # local per-bin candidate tables: the first cand_l rows of each bin
        # (4·cap deep with stratification); rows spilling into a
        # neighbouring bin at the array's edge are marked invalid
        cand_l = min(4 * cap_g, n_l) if strat else cap_l
        bins = torch.arange(n_bins, device=dev)
        idx = torch.clamp(starts, 0, n_l - cand_l)[:, None] + torch.arange(cand_l, device=dev)
        ck = key_s[idx]
        tok = (ck >> frac_bits) == bins[:, None]
        ck = torch.where(tok, ck, torch.full_like(ck, _KEY_LAST))
        ints = torch.stack([ck, gid_s[idx], tok.to(torch.int32)], dim=-1)  # (n_bins, cand_l, 3)
        flts = torch.cat([u_s[idx], rho_s[idx][..., None]], dim=-1)  # (n_bins, cand_l, 4)

        # all_gather + stable merge by the quantized key: the global order,
        # ties by global id (ranks are in id order, each shard's rows too)
        g_int = all_gather(ints, mesh, axis).transpose(0, 1).reshape(n_bins, -1, 3)
        g_flt = vary(all_gather(flts, mesh, axis), mesh, axis)
        g_flt = g_flt.transpose(0, 1).reshape(n_bins, -1, 4)
        m = g_int.shape[1]
        _, mperm = torch.sort(g_int[..., 0], dim=1, stable=True)
        pre = mperm[:, :min(cap_g, m)]  # the closest cap_g members: chunk 0's coverers
        tables = [(torch.gather(g_int, 1, pre[..., None].expand(-1, -1, 3)),
                   torch.gather(g_flt, 1, pre[..., None].expand(-1, -1, 4)))]
        if strat:
            order, member = _strat_order(counts_g, m, cap_g)
            sp = torch.gather(mperm, 1, order)
            s_int = torch.gather(g_int, 1, sp[..., None].expand(-1, -1, 3))
            s_int = torch.cat([s_int[..., :2], (s_int[..., 2:] * member[..., None])], dim=-1)
            tables.append((s_int, torch.gather(g_flt, 1, sp[..., None].expand(-1, -1, 4))))

        # each local row's exact global in-bin rank below cap_g, from its
        # place among the closest cap_g (cap_g where it is not among them)
        p_int = tables[0][0]
        own = (p_int[..., 2] > 0) & (p_int[..., 1] >= gid0) & (p_int[..., 1] < gid0 + n_l)
        rank_of = torch.full((n_l,), cap_g, dtype=torch.long, device=dev)
        pos = torch.arange(p_int.shape[1], device=dev).expand_as(p_int[..., 1])
        rank_of[(p_int[..., 1] - gid0)[own].long()] = pos[own]
        rank_s = rank_of[(gid_s - gid0).long()]  # in the local layout order
        row_bin = torch.clamp(bin_s, max=n_bins - 1).long()
        deep = rank_s >= cap_g
        # the single card's last tile of a bin is clamped to end at n: a
        # chunk-0 row it holds takes the max over both tables there
        n_chunks = (counts_g + cap_g - 1) // cap_g
        both = (~deep & (n_chunks[row_bin] >= 2)
                & (start_g[row_bin] + rank_s >= n_global - cap_g))
        wants = [~deep | both, deep | both] if strat else [torch.ones_like(deep)]

        # this rank's query tiles: cap_l consecutive layout rows of one bin
        # (one host read per grid for the tiles' count and which table each
        # needs)
        tiles_per_bin = (counts + cap_l - 1) // cap_l
        tile_cum = torch.cat([tiles_per_bin.new_zeros(1), torch.cumsum(tiles_per_bin, 0)])
        slot = torch.arange(int(tile_cum[-1]), device=dev)
        tile_bin = torch.searchsorted(tile_cum, slot, right=True) - 1
        within = slot - tile_cum[tile_bin]
        qoff = torch.clamp(starts[tile_bin] + within * cap_l, 0, n_l - cap_l)
        q = qoff[:, None] + ar_l
        in_bin = bin_s[q] == tile_bin[:, None]
        for (t_int, t_flt), want in zip(tables, wants):
            rows_ok = in_bin & want[q]
            keep = rows_ok.any(dim=1)
            # no tile may be left out of the graph where another rank has
            # one: the gathered tables' backward is a collective
            tb, qt, ok_t = tile_bin[keep], q[keep], rows_ok[keep]
            ti, tf = t_int[tb], t_flt[tb]
            chunk = max(1, chunk_budget // (cap_l * ti.shape[1]))
            # a pair counts where the coverer is valid (bin key 0 against
            # the queries' 0) and is not the query itself (by global id)
            c_key = torch.where(ti[..., 2] > 0, 0, -2)
            lse = _FrozenLSE.apply(u_s[qt], tf[..., :3].contiguous(), tf[..., 3].contiguous(),
                                   beta.expand(len(tb)), torch.zeros_like(qt), c_key,
                                   gid_s[qt], ti[..., 1], chunk)
            rows = torch.where(ok_t, lse / beta, -_BIG_SOFT)
            smax_g = torch.full((n_l,), -_BIG_SOFT, dtype=points_l.dtype,
                                device=dev).scatter_reduce(
                0, qt.reshape(-1), rows.reshape(-1), "amax", include_self=True)
            smax = torch.maximum(smax, _unpermute(perm, smax_g))

    out = torch.sigmoid(beta * (rho + tau * scale - smax))
    return out * v.to(out.dtype)


def hpr_mask_soft_binned_sharded(
    points: torch.Tensor,
    mesh: Mesh,
    r_param: float = 2.0,
    *,
    sharpness: float = 400.0,
    tau: float = 0.02,
    cap: int = 1024,
    safety: float = 3.0,
    stratified_coverers: bool = True,
    valid: Optional[torch.Tensor] = None,
    axis: str = "pts",
) -> torch.Tensor:
    """Point-sharded differentiable HPR over a mesh axis.

    ``points`` (and ``valid``) are this rank's slice of the cloud
    (``parallel.mesh.points_sharding``: the cloud must divide by the axis
    size, pad with ``valid`` first); every rank's slice has the same size.
    Same semantics and defaults as ``ops.hpr.hpr_mask_soft_binned``,
    including the global min(cap, N) per-bin candidate budget, whatever the
    rank count. Returns this rank's (n_local,) visibility.
    """
    n_l = points.shape[0]
    if valid is None:
        valid = torch.ones(n_l, dtype=points.dtype, device=points.device)
    return _local_mask(
        points, valid.to(points.dtype), mesh.index(axis) * n_l, mesh=mesh, axis=axis,
        r_param=float(r_param), sharpness=float(sharpness), tau=float(tau), cap=int(cap),
        safety=float(safety), n_global=n_l * mesh.size(axis),
        stratified=bool(stratified_coverers))
