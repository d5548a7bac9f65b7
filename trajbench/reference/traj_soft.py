"""Plain PyTorch reference of one occlusion-aware trajectory request.

The trajectory model of ``traj.py`` (its scores, log-odds, criterion and
Adam, loaded from that file) with each scored waypoint's (N,) scores
multiplied by a differentiable hidden-point-removal gate before the
min-max normalization: the direction-binned soft Katz test, the system's
own extension of the published visibility model (upstream ``README.md:69-86``
names the Katz spherical flip; upstream's ``ModelTraj`` has none). Written
out term by term from the stated equations, in float64 with autograd,
importing nothing of the program: no static tile slots, no chunks sized by
a memory budget, no hand-derived backward, no scatter of row maxima, no
fixed-order row sums.

For one waypoint's camera-frame cloud p (N, 3):

  ‖p‖, scale = max‖p‖ (no gradient), R = max‖p‖·10^r, ρ = 2R − ‖p‖,
  β = sharpness/scale, û = p/‖p‖;
  routing (no gradient), in each of four grids: latitude asin(û_z) and
    azimuth atan2(û_y, û_x) + π, cut into rings of Δ = 2θ_max (θ_max =
    √(2c), c = safety·(1+τ)·10^-r/2) shifted by 0 or ½ a ring, each ring
    into round(2π cos(lat)/Δ) azimuth cells shifted by 0 or ½ a cell; a
    bin's members sorted closest first by the quantized key
    (bin, ⌊(‖p‖/scale)·2^f⌋) with f = 30 − bitlength(bins + 1), ties by
    index; the bin's queries in chunks of ``cap`` by that rank: chunk 0
    meets the bin's closest ``cap`` members, every deeper chunk the first
    ``cap`` members of the tiered distance-rank sample (all ranks below
    cap/4, then every 2^(k+1)-th rank of tier k = [cap/4·2^k, cap/4·2^(k+1))
    up to rank 4·cap, then the others by rank);
  smax_g(i) = (1/β)·log Σ_j exp(β·max(û_i·û_j, 0)·ρ_j) over i's coverers j
    in grid g, j ≠ i (−10³⁰ when there is none); smax = max_g smax_g;
  gate(i) = σ(β·(ρ_i + τ·scale − smax(i))).

Departures from the program's equations:

* the routing is computed in the cloud's dtype (float64 here): a point
  within float32 rounding of a bin edge or of the ``cap`` cut can be routed
  otherwise than by the program (``route`` lets a caller find such points);
* the program runs every tile over ``cap`` consecutive rows of the sorted
  cloud, and a chunk that would run past the padded cloud's end starts
  earlier, so a few rows of the previous chunk of the last bin can meet a
  second coverer set; here every query meets its own chunk's set only (at
  40,452 points padded to 40,960 that needs the last bin to hold 513–515
  points);
* the program decides whether to stratify from its padded point count
  (2n < 2^f), here from the count given; both hold at every size below
  about 4·10⁶ points;
* ρ and the direction come from the float64 norm, which the program also
  computes in float64 before rounding it to float32.

The gate has only its binned tier here: a cloud at or below
``soft_hpr_dense_max`` points, where the program takes its dense tier, is
refused. The gate is computed per waypoint (checkpointed, so a backward
holds one waypoint's tiles at a time) and per grid in blocks of
``TILE_BLOCK`` real tiles, each tile one matrix product of its queries'
and its coverers' directions.
"""
from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from registry import load_module

base = load_module(Path(__file__).resolve().parent / "traj.py")

EPS = base.EPS
BIG = 1.0e30  # the soft maximum of a query with no coverer: −BIG
TILE_BLOCK = 64  # tiles of a grid per block, (64, cap, cap) at a time
stride = base.stride
Solve = base.Solve


@dataclasses.dataclass(frozen=True)
class Settings(base.Settings):
    """A configuration's settings with the gate's, which its file states
    under ``assumed`` (the program's own defaults)."""

    dense_max: int
    cap: int
    safety: float
    r_param: float
    sharpness: float
    tau: float
    stratified: bool

    @classmethod
    def from_config(cls, cfg: dict) -> "Settings":
        if not cfg["settings"]["soft_hpr"]:
            raise ValueError("the occlusion-aware reference needs a configuration with soft_hpr")
        a = cfg["assumed"]
        plain = dataclasses.asdict(base.Settings.from_config(cfg))
        return cls(**plain, dense_max=int(a["soft_hpr_dense_max"]), cap=int(a["hpr_cap"]),
                   safety=float(a["hpr_safety"]), r_param=float(a["r_param"]),
                   sharpness=float(a["sharpness"]), tau=float(a["tau"]),
                   stratified=bool(a["stratified_coverers"]))


@dataclasses.dataclass(frozen=True)
class Grid:
    n_rings: int
    delta: float
    lat_shift: float
    az_shift: float
    n_az: np.ndarray  # azimuth cells per ring
    offsets: np.ndarray  # the first bin of each ring
    n_bins: int


def grids(r_param: float, tau: float, safety: float) -> List[Grid]:
    """The four staggered latitude/azimuth grids (module docstring)."""
    c = safety * (1.0 + tau) * 0.5 * 10.0 ** (-r_param)
    delta = 2.0 * math.sqrt(2.0 * c)
    out = []
    for lat_shift in (0.0, 0.5):
        n_rings = int(math.ceil(math.pi / delta + lat_shift))
        centers = np.clip(-math.pi / 2 + (np.arange(n_rings) + 0.5 - lat_shift) * delta,
                          -math.pi / 2, math.pi / 2)
        n_az = np.maximum(1, np.round(2.0 * math.pi * np.cos(centers) / delta)).astype(np.int64)
        offsets = np.concatenate([[0], np.cumsum(n_az)])
        for az_shift in (0.0, 0.5):
            out.append(Grid(n_rings, delta, lat_shift, az_shift, n_az, offsets[:-1],
                            int(offsets[-1])))
    return out


@dataclasses.dataclass
class Route:
    """One grid's routing of N points: each point's bin, and its real tiles,
    one per (bin, chunk) in bin order: ``queries`` (T, cap) the chunk's
    points, ``coverers`` (T, cap) the set it meets, both −1 past their
    members; ``row`` (N,) each point's place in the flattened ``queries``."""

    bins: torch.Tensor
    queries: torch.Tensor
    coverers: torch.Tensor
    row: torch.Tensor


def _sample_priority(rank: torch.Tensor, base_rank: int, n: int) -> torch.Tensor:
    """A bin member's place in the tiered distance-rank sample: its rank if
    it is sampled, n + rank if not (module docstring)."""
    tier = torch.frexp(torch.clamp(rank // base_rank, min=1).double()).exponent.long() - 1
    sampled = (rank < base_rank) | ((rank < 16 * base_rank) & (rank % (2 ** (tier + 1)) == 0))
    return torch.where(sampled, rank, n + rank)


def route(cam: torch.Tensor, st: Settings) -> List[Route]:
    """The four grids' routing of the camera-frame points ``cam`` (N, 3),
    computed in ``cam``'s dtype, without gradient."""
    with torch.no_grad():
        n, dev = cam.shape[0], cam.device
        cap = min(st.cap, n)
        norms = base._norm0(cam, -1)
        scale = torch.clamp(torch.amax(norms), min=1e-6)
        u = cam / torch.clamp(norms, min=1e-12)[:, None]
        lat = torch.asin(torch.clamp(u[:, 2], -1.0, 1.0))
        az = torch.atan2(u[:, 1], u[:, 0]) + math.pi
        frac = torch.clamp(norms / scale, 0.0, 1.0 - 1e-6)
        idx = torch.arange(n, device=dev)
        lane = torch.arange(cap, device=dev)
        out = []
        for g in grids(st.r_param, st.tau, st.safety):
            frac_bits = 30 - (g.n_bins + 1).bit_length()
            n_az = torch.as_tensor(g.n_az, device=dev)
            ring = torch.clamp(torch.floor((lat + math.pi / 2) / g.delta + g.lat_shift).long(),
                               0, g.n_rings - 1)
            cells = n_az[ring]
            azbin = torch.floor(az / (2.0 * math.pi) * cells + g.az_shift).long()
            azbin = torch.where(azbin >= cells, azbin - cells, azbin)
            bins = torch.as_tensor(g.offsets, device=dev)[ring] + azbin
            key = bins * 2 ** frac_bits + torch.floor(frac * 2 ** frac_bits).long()
            order = torch.sort(key, stable=True).indices  # bins contiguous, closest first
            counts = torch.bincount(bins, minlength=g.n_bins)
            starts = torch.cumsum(counts, 0) - counts
            rank = torch.empty_like(idx)
            rank[order] = idx - starts[bins[order]]
            sample = order
            if st.stratified and cap < n and 2 * n < 2 ** frac_bits:
                prio = _sample_priority(rank, max(cap // 4, 1), n)
                sample = torch.sort(bins * 2 * n + prio, stable=True).indices
            # the real tiles: chunk k of bin b holds ranks [k·cap, (k+1)·cap)
            per_bin = (counts + cap - 1) // cap
            tile_end = torch.cumsum(per_bin, 0)
            tile_start = tile_end - per_bin
            tile = torch.arange(int(tile_end[-1]), device=dev)
            tile_bin = torch.searchsorted(tile_end, tile, right=True)
            chunk = tile - tile_start[tile_bin]
            first, count = starts[tile_bin][:, None], counts[tile_bin][:, None]
            q_rank = chunk[:, None] * cap + lane
            queries = torch.where(q_rank < count, order[torch.clamp(first + q_rank, max=n - 1)], -1)
            c_pos = torch.clamp(first + lane, max=n - 1)
            coverers = torch.where(lane < count, torch.where(chunk[:, None] == 0, order[c_pos],
                                                             sample[c_pos]), -1)
            row = (tile_start[bins] + rank // cap) * cap + rank % cap
            out.append(Route(bins, queries, coverers, row))
        return out


def pairs(queries: torch.Tensor, coverers: torch.Tensor) -> torch.Tensor:
    """(T, cap, cap) bool: the (query, coverer) pairs of tiles (``Route``'s
    ``queries`` and ``coverers``) that count, both members and not one point."""
    return ((coverers >= 0)[:, None, :] & (queries >= 0)[:, :, None]
            & (queries[:, :, None] != coverers[:, None, :]))


def gate(cam: torch.Tensor, st: Settings) -> torch.Tensor:
    """(N,) soft HPR visibility in (0, 1) of the camera-frame points ``cam``
    (module docstring), differentiable in ``cam``."""
    n = cam.shape[0]
    if n <= st.dense_max:
        raise ValueError(f"{n} points: the reference writes out the binned tier only, which "
                         f"the program takes above {st.dense_max}")
    norms = base._norm0(cam, -1)
    radius = torch.amax(norms) * 10.0 ** st.r_param
    rho = 2.0 * radius - norms
    scale = torch.clamp(torch.amax(norms), min=1e-6).detach()
    beta = st.sharpness / scale
    u = cam / torch.clamp(norms, min=1e-12)[:, None]
    zero, off = cam.new_zeros(()), -BIG * beta  # a pair that does not count
    smax = torch.full((n,), -BIG, dtype=cam.dtype, device=cam.device)
    for r in route(cam, st):
        lse = []
        for t0 in range(0, r.queries.shape[0], TILE_BLOCK):
            qs, cs = r.queries[t0:t0 + TILE_BLOCK], r.coverers[t0:t0 + TILE_BLOCK]
            q, c = torch.clamp(qs, min=0), torch.clamp(cs, min=0)
            cos = torch.bmm(u[q], u[c].transpose(1, 2))
            dom = torch.maximum(cos, zero) * rho[c][:, None, :]
            x = torch.where(pairs(qs, cs), beta * dom, off)
            lse.append(torch.logsumexp(x, dim=2).reshape(-1))
        smax = torch.maximum(smax, torch.cat(lse)[r.row] / beta)
    return torch.sigmoid(beta * (rho + st.tau * scale - smax))


def camera_frame(points: torch.Tensor, quat: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """(N, 3) points in one waypoint's camera frame, R from the normalized
    wxyz quaternion: cam_c = Σ_j (p − t)_j R_jc, as ``traj.scores`` has it."""
    return (points - pose) @ base._rotation(quat[None])[0]


def forward(poses, quats, points, poses0, step: int, st: Settings, vis_dtype=None):
    """(loss, mean_reward, loss_smooth, rewards), as ``traj.forward``, each
    scored waypoint's scores gated. ``vis_dtype`` computes the scores and the
    gate, routing included, in another precision (the control); the log-odds
    and everything after them stay in the parameters' dtype."""
    sel = slice(None, None, step)
    p_sel, q_sel, pts = poses[sel], quats[sel], points
    if vis_dtype is not None:
        p_sel, q_sel, pts = p_sel.to(vis_dtype), q_sel.to(vis_dtype), pts.to(vis_dtype)

    def lo(q, p):
        s = base.scores(pts, q[None], p[None], st)[0]
        return base.logodds((gate(camera_frame(pts, q, p), st) * s).to(poses.dtype)[None])[0]

    lo_sum = torch.zeros(points.shape[0], dtype=poses.dtype, device=points.device)
    for q, p in zip(q_sel, p_sel):
        if torch.is_grad_enabled():
            lo_sum = lo_sum + checkpoint(lo, q, p, use_reentrant=False,
                                         preserve_rng_state=False)
        else:
            lo_sum = lo_sum + lo(q, p)
    rewards = torch.sigmoid(lo_sum)
    mean_reward = torch.mean(rewards)
    loss_smooth = st.smoothness_weight / (base.mean_angle(poses) + EPS)
    dlen = base.length(poses) - base.length(poses0)
    loss = (1.0 / (mean_reward + EPS) + base._norm0(poses[0] - poses0[0]) + loss_smooth
            + st.length_weight * torch.where(dlen >= 0, dlen, -dlen))
    return loss, mean_reward, loss_smooth, rewards


def evaluate(points: np.ndarray, path0: np.ndarray, poses: np.ndarray, quats: np.ndarray,
             st: Settings, device="cpu", dtype=torch.float64) -> Dict[str, object]:
    """The forward at given parameters of a request whose initial path is
    ``path0``: its loss, rewards, visibility and smoothness gains."""
    step = stride(path0, st.vis_wps_dist)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)  # noqa: E731
    P, p0 = t(points), t(path0)
    q0 = torch.zeros(len(path0), 4, dtype=dtype, device=device)
    q0[:, 0] = 1.0
    with torch.no_grad():
        _, r0, s0, _ = forward(p0, q0, P, p0, step, st)
        loss, mr, ls, rewards = forward(t(poses), t(quats), P, p0, step, st)
    return {"loss": float(loss), "rewards": rewards.cpu().numpy(),
            "visibility_gain": float(mr) / max(float(r0), 1e-9),
            "smoothness_gain": float(s0) / max(float(ls), 1e-9)}


def solve(points: np.ndarray, path0: np.ndarray, n_steps: int, st: Settings, device="cpu",
          dtype=torch.float64, vis_dtype: Optional[torch.dtype] = None,
          start: Optional[tuple] = None) -> Solve:
    """``n_steps`` Adam steps of the gated forward, as ``traj.solve`` takes
    them of its own (which calls ``traj.forward``, hence this copy)."""
    step = stride(path0, st.vis_wps_dist)
    P = torch.as_tensor(np.asarray(points), dtype=dtype, device=device)
    p0 = torch.as_tensor(np.asarray(path0), dtype=dtype, device=device)
    q0 = torch.zeros(len(path0), 4, dtype=dtype, device=device)
    q0[:, 0] = 1.0
    if start is None:
        params = {"poses": p0.clone(), "quats": q0.clone()}
    else:
        params = {"poses": torch.as_tensor(np.asarray(start[0]), dtype=dtype, device=device),
                  "quats": torch.as_tensor(np.asarray(start[1]), dtype=dtype, device=device)}
    lrs = {"poses": st.lr_pose, "quats": st.lr_quat}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    reward0 = smooth0 = None
    for i in range(1, n_steps + 1):
        leaves = {k: x.detach().requires_grad_(True) for k, x in params.items()}
        loss, mr, ls, _ = forward(leaves["poses"], leaves["quats"], P, p0, step, st, vis_dtype)
        if reward0 is None:
            reward0, smooth0 = float(mr.detach()), float(ls.detach())
        grads = torch.autograd.grad(loss, [leaves["poses"], leaves["quats"]])
        with torch.no_grad():
            for (k, x), g in zip(params.items(), grads):
                m[k] = base.ADAM_B1 * m[k] + (1 - base.ADAM_B1) * g
                v2[k] = base.ADAM_B2 * v2[k] + (1 - base.ADAM_B2) * g * g
                u = (m[k] / (1 - base.ADAM_B1 ** i)) / (
                    torch.sqrt(v2[k] / (1 - base.ADAM_B2 ** i)) + base.ADAM_EPS)
                params[k] = x - lrs[k] * u
    with torch.no_grad():
        loss, mr, ls, rewards = forward(params["poses"], params["quats"], P, p0, step, st,
                                        vis_dtype)
        if reward0 is None:
            reward0, smooth0 = float(mr), float(ls)
    q = params["quats"].double().cpu().numpy()
    return Solve(poses=params["poses"].double().cpu().numpy(),
                 quats_wxyz=q / np.linalg.norm(q, axis=1, keepdims=True),
                 rewards=rewards.double().cpu().numpy(), loss=float(loss),
                 visibility_gain=float(mr) / max(reward0, 1e-9),
                 smoothness_gain=smooth0 / max(float(ls), 1e-9), n_iters=n_steps)
