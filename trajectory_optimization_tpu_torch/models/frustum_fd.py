"""Finite-difference frustum visibility estimator (notebook parity).

Twin of ``trajectory_optimization_tpu/models/frustum_fd.py``, the reference
notebook's pose model: a camera parametrized by (dist, elev, azim) around
the origin scores visibility as the *binary count* of in-frustum points;
the count is piecewise constant, so gradients are finite differences (δ =
0.1 perturbations of the look-at transform) inside an autograd Function.

The notebook's quirks are kept on purpose:
  * the backward multiplies the cotangent by the raw reward difference
    f(x+δ)−f(x), NOT the quotient (f(x+δ)−f(x))/δ;
  * the world→camera transform subtracts pytorch3d's T (which is −C·R, not
    the camera position) directly from world points.
"""
from __future__ import annotations

from typing import Tuple

import torch

from trajectory_optimization_tpu_torch.ops.hpr import _full_f32_matmul
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics


def look_at_view_transform(
    dist, elev, azim, *, degrees: bool = True, up=(0.0, 1.0, 0.0), at=(0.0, 0.0, 0.0)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """pytorch3d-convention look-at: (R (3, 3), T (3,)) with X_cam = X_world
    @ R + T (R's columns are the camera axes in world coordinates, T = −C·R
    for camera position C). Scalars or 0-dim f32 tensors; the result lies on
    their device."""
    dist, elev, azim = (torch.as_tensor(x, dtype=torch.float32) for x in (dist, elev, azim))
    if degrees:
        elev, azim = torch.deg2rad(elev), torch.deg2rad(azim)
    dev = dist.device
    at = torch.as_tensor(at, dtype=torch.float32, device=dev)
    C = at + dist * torch.stack(
        [torch.cos(elev) * torch.sin(azim), torch.sin(elev), torch.cos(elev) * torch.cos(azim)])
    z = at - C
    z = z / torch.linalg.norm(z)
    upv = torch.as_tensor(up, dtype=torch.float32, device=dev)
    x = torch.linalg.cross(upv, z)
    x = x / torch.clamp(torch.linalg.norm(x), min=1e-9)
    y = torch.linalg.cross(z, x)
    R = torch.stack([x, y, z], dim=1)  # columns = camera axes
    with _full_f32_matmul(R):
        T = -torch.matmul(C, R)
    return R, T


def binary_visibility_count(
    dist_elev_azim: torch.Tensor,
    points: torch.Tensor,
    *,
    min_dist: float = 1.0,
    max_dist: float = 10.0,
) -> torch.Tensor:
    """f32 count of the points inside the frustum of the (dist, elev, azim)
    camera: cam = Rᵀ(p − T), T subtracted as if it were the camera position
    (notebook behaviour), then hard z-range and 1-px-border pixel tests. The
    tests are strict inequalities: the products run in full f32 (TF32 off
    on the card)."""
    intr = default_intrinsics()
    K = intr.matrix(device=points.device)
    R, T = look_at_view_transform(dist_elev_azim[0], dist_elev_azim[1], dist_elev_azim[2])
    with _full_f32_matmul(points):
        cam = torch.matmul(points - T, R)  # Rᵀ(p − T), row-vector form
        ph = torch.matmul(cam, K.T)
    zc = cam[:, 2]
    dist_mask = (zc > min_dist) & (zc < max_dist)
    u = ph[:, 0] / ph[:, 2]
    v = ph[:, 1] / ph[:, 2]
    fov_mask = ((ph[:, 2] > 0) & (u > 1) & (u < intr.width - 1)
                & (v > 1) & (v < intr.height - 1))
    return torch.sum(dist_mask & fov_mask).to(torch.float32)


class _FrustumVisibilityFD(torch.autograd.Function):
    """The count forward; the backward scales the cotangent by the raw
    differences f(x + δeᵢ) − f(x), kept from the forward (the notebook never
    divides by δ)."""

    @staticmethod
    def forward(ctx, dist_elev_azim, points, delta):
        r0 = binary_visibility_count(dist_elev_azim, points)
        eye = torch.eye(3, dtype=torch.float32, device=dist_elev_azim.device)
        ctx.save_for_backward(torch.stack([
            binary_visibility_count(dist_elev_azim + delta * eye[i], points) - r0
            for i in range(3)]))
        return r0

    @staticmethod
    def backward(ctx, g):
        (diffs,) = ctx.saved_tensors
        return g * diffs, None, None


def frustum_visibility_fd(dist_elev_azim, points, delta: float = 0.1) -> torch.Tensor:
    """Binary visibility count with finite-difference gradients (δ per axis)."""
    return _FrustumVisibilityFD.apply(dist_elev_azim, points, delta)


def fd_pose_loss(dist_elev_azim, points, delta: float = 0.1) -> torch.Tensor:
    """The notebook's criterion: loss = 1/(visible count + eps)."""
    return 1.0 / (frustum_visibility_fd(dist_elev_azim, points, delta) + 1e-6)
