"""Plain PyTorch reference of one trajectory-optimization request.

The math of the upstream ``ModelTraj`` (ctu-vras/trajectory_optimization,
``src/model.py:158-260``) as the system under test states it, written out
term by term with autograd and nothing else: no kernel, no cache, no graph.
It imports nothing of the program: it is handed the unpadded cloud and the
request's path as numpy arrays and works out everything else (padding is
not needed, the waypoint stride, the intrinsics' constants, the Adam state).

For W waypoints, N points and the selected waypoints w (every ``stride``-th):

  cam(w,i) = R_wᵀ (p_i − t_w)                  (R_w from the normalized quaternion)
  s(w,i)   = exp(−½ |cam − c₀|²/σ²) · σ(cam_z) · exp(−½ (x_u² + x_v²))
  pn(w,i)  = clip((s − min_i s)/max(max_i s − min_i s, 1e-8), 0.5, 1 − eps)
  reward_i = σ(Σ_w log(pn/(1 − pn)))
  loss     = 1/(mean reward + eps) + ‖p₀ − p₀⁰‖ + w_s/(mean angle + eps)
             + w_l·|len − len⁰|

optimized by Adam with two groups (positions, quaternions), bias-corrected,
eps outside the root, for a fixed number of steps; the result is the final
parameters and the forward at them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

EPS = 1e-6
SPAN_FLOOR = 1e-8
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class Settings:
    """A configuration's settings, as its file states them."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: float
    height: float
    min_dist: float
    max_dist: float
    smoothness_weight: float
    length_weight: float
    lr_pose: float
    lr_quat: float
    vis_wps_dist: float

    @classmethod
    def from_config(cls, cfg: dict) -> "Settings":
        s, cam = cfg["settings"], cfg["camera"]
        return cls(fx=cam["fx"], fy=cam["fy"], cx=cam["cx"], cy=cam["cy"],
                   width=cam["width"], height=cam["height"], min_dist=s["min_dist"],
                   max_dist=s["max_dist"], smoothness_weight=s["smoothness_weight"],
                   length_weight=s["length_weight"], lr_pose=s["lr_pose"],
                   lr_quat=s["lr_quat"], vis_wps_dist=s["vis_wps_dist"])


def stride(path: np.ndarray, vis_wps_dist: float) -> int:
    """Every stride-th waypoint is scored: ⌊vis_wps_dist / mean segment⌋ + 1."""
    path = np.asarray(path, np.float64)
    if len(path) < 2:
        return 1
    mean_d = float(np.mean(np.linalg.norm(path[1:] - path[:-1], axis=-1)))
    if not np.isfinite(mean_d) or mean_d <= 0.0:
        return 1
    return int(vis_wps_dist / mean_d) + 1


def _norm0(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Euclidean norm whose gradient is 0 where the norm is 0."""
    sq = torch.sum(x * x, dim=dim)
    zero = sq == 0
    return torch.where(zero, torch.zeros_like(sq), torch.sqrt(torch.where(zero, torch.ones_like(sq), sq)))


def _rotation(q: torch.Tensor) -> torch.Tensor:
    """(W, 4) wxyz → (W, 3, 3), normalized first."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def scores(points: torch.Tensor, quats: torch.Tensor, poses: torch.Tensor, st: Settings):
    """(W, N) visibility scores of N points from W cameras."""
    R = _rotation(quats)
    rel = points[None, :, :] - poses[:, None, :]  # (W, N, 3)
    cam = torch.einsum("wnj,wjc->wnc", rel, R)  # cam_c = Σ_j (p − t)_j R_jc
    cx, cy, cz = cam.unbind(-1)
    c0 = (st.min_dist + st.max_dist) / 2.0
    inv_var = 1.0 / ((st.max_dist - st.min_dist) / 2.0) ** 2
    dist = torch.exp(-0.5 * ((cx - c0) ** 2 + (cy - c0) ** 2 + (cz - c0) ** 2) * inv_var)
    u = st.fx * cx + st.cx * cz
    v = st.fy * cy + st.cy * cz
    zd = cz + EPS
    zd = torch.where(zd >= 0, torch.clamp(zd, min=1e-12), torch.clamp(zd, max=-1e-12))
    xu = torch.clamp((u / zd - st.width / 2.0) / st.width, -20.0, 20.0)
    xv = torch.clamp((v / zd - st.height / 2.0) / st.height, -20.0, 20.0)
    fov = torch.sigmoid(cz) * torch.exp(-0.5 * (xu * xu + xv * xv))
    return dist * fov


def logodds(s: torch.Tensor) -> torch.Tensor:
    """(W, N) scores → per-waypoint min-max normalized, clipped log-odds."""
    lo, hi = torch.amin(s, dim=-1, keepdim=True), torch.amax(s, dim=-1, keepdim=True)
    pn = torch.clamp((s - lo) / torch.clamp(hi - lo, min=SPAN_FLOOR), 0.5, 1.0 - EPS)
    return torch.log(pn / (1.0 - pn))


def mean_angle(path: torch.Tensor) -> torch.Tensor:
    """Mean interior angle of the polyline (π for a straight line); its
    gradient is taken at the cosine clipped to ±(1 − 1e-6)."""
    if path.shape[0] < 3:
        return torch.full((), math.pi, dtype=path.dtype, device=path.device)
    ab, ac = path[:-2] - path[1:-1], path[2:] - path[1:-1]
    cos = torch.sum(ab * ac, -1) / (_norm0(ab, -1) * _norm0(ac, -1) + EPS)
    inner = torch.clamp(cos, -1.0 + 1e-6, 1.0 - 1e-6)
    phi = torch.arccos(inner) + (torch.arccos(torch.clamp(cos, -1.0, 1.0)) - torch.arccos(inner)).detach()
    return torch.sum(phi) / (path.shape[0] - 2)


def length(path: torch.Tensor) -> torch.Tensor:
    return torch.sum(_norm0(path[1:] - path[:-1], -1))


def forward(poses, quats, points, poses0, step: int, st: Settings, vis_dtype=None):
    """(loss, mean_reward, loss_smooth, rewards). ``vis_dtype`` computes the
    (W, N) scores in another precision (the control), casting their inputs;
    the log-odds and everything after them stay in the parameters' dtype."""
    sel = slice(None, None, step)
    p_sel, q_sel, pts = poses[sel], quats[sel], points
    if vis_dtype is not None:
        p_sel, q_sel, pts = p_sel.to(vis_dtype), q_sel.to(vis_dtype), pts.to(vis_dtype)
    lo_sum = torch.sum(logodds(scores(pts, q_sel, p_sel, st).to(poses.dtype)), dim=0)
    rewards = torch.sigmoid(lo_sum)
    mean_reward = torch.mean(rewards)
    loss_smooth = st.smoothness_weight / (mean_angle(poses) + EPS)
    dlen = length(poses) - length(poses0)
    loss = (1.0 / (mean_reward + EPS) + _norm0(poses[0] - poses0[0]) + loss_smooth
            + st.length_weight * torch.where(dlen >= 0, dlen, -dlen))
    return loss, mean_reward, loss_smooth, rewards


@dataclasses.dataclass
class Solve:
    poses: np.ndarray
    quats_wxyz: np.ndarray  # normalized
    rewards: np.ndarray
    loss: float
    visibility_gain: float
    smoothness_gain: float
    n_iters: int


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
    """``n_steps`` Adam steps from ``start`` (poses, wxyz quaternions), by
    default the path itself with identity orientations, with fresh Adam
    moments; and the forward at the result. ``path0`` is the request's path,
    the anchor and length targets and the source of the stride."""
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
                m[k] = ADAM_B1 * m[k] + (1 - ADAM_B1) * g
                v2[k] = ADAM_B2 * v2[k] + (1 - ADAM_B2) * g * g
                u = (m[k] / (1 - ADAM_B1 ** i)) / (torch.sqrt(v2[k] / (1 - ADAM_B2 ** i)) + ADAM_EPS)
                params[k] = x - lrs[k] * u
    with torch.no_grad():
        loss, mr, ls, rewards = forward(params["poses"], params["quats"], P, p0, step, st,
                                        vis_dtype)
        if reward0 is None:
            _, r0, s0, _ = forward(params["poses"], params["quats"], P, p0, step, st, vis_dtype)
            reward0, smooth0 = float(r0), float(s0)
    q = params["quats"].double().cpu().numpy()
    return Solve(poses=params["poses"].double().cpu().numpy(),
                 quats_wxyz=q / np.linalg.norm(q, axis=1, keepdims=True),
                 rewards=rewards.double().cpu().numpy(), loss=float(loss),
                 visibility_gain=float(mr) / max(reward0, 1e-9),
                 smoothness_gain=smooth0 / max(float(ls), 1e-9), n_iters=n_steps)
