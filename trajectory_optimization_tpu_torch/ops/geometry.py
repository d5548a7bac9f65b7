"""SE(3) transforms, pinhole projection, and visibility masks.

Twin of ``trajectory_optimization_tpu/ops/geometry.py``, term for term:
  * the smooth distance mask measures ‖p − c·𝟙‖, the norm of the point
    minus the *scalar* mid-range broadcast over all three camera-frame
    coordinates (the reference's quirk), through ``safe_norm``;
  * the smooth FOV mask divides by (z + eps) with the sign-preserving 1e-12
    floor and clamps the Gaussian arguments at ±20;
  * the binary frustum test requires pixels strictly inside a 1-px border.

The JAX module pins ``precision="highest"`` on its matmuls so that the TPU
does not round them through bf16. PyTorch's counterpart is
``torch.backends.cuda.matmul.allow_tf32 = False``, which is PyTorch's
default: these matmuls run in full float32 on the card unless a caller has
turned TF32 on.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from trajectory_optimization_tpu_torch.ops import quat as quat_ops
from trajectory_optimization_tpu_torch.ops.numerics import safe_norm


def to_camera_frame(
    points: torch.Tensor, quats: torch.Tensor, trans: torch.Tensor
) -> torch.Tensor:
    """cam = R(q)⁻¹ · (p − t), batched over cameras.

    points (N, 3) world points; quats (4,) or (W, 4) wxyz (world←camera);
    trans (3,) or (W, 3) camera positions. Returns (N, 3) or (W, N, 3).
    """
    single = quats.dim() == 1
    q = torch.atleast_2d(quats)
    t = torch.atleast_2d(trans)
    R = quat_ops.to_matrix(quat_ops.normalize(q))  # (W, 3, 3), R @ v rotates cam→world
    # R⁻¹ x = Rᵀ x  ⇒  cam = (p − t) @ R
    cam = (
        torch.einsum("nj,wjk->wnk", points, R)
        - torch.einsum("wj,wjk->wk", t, R)[:, None, :]
    )
    return cam[0] if single else cam


def dist_mask(
    cam_points: torch.Tensor,
    min_dist: float = 1.0,
    max_dist: float = 5.0,
    *,
    binary: bool = False,
) -> torch.Tensor:
    """Soft (or hard) mask of points within [min_dist, max_dist].

    Smooth: Gaussian of ‖p − c·𝟙‖ with c = (min+max)/2, σ = (max−min)/2.
    Binary: z-depth range test (the hard frustum cull's variant).
    """
    if binary:
        z = cam_points[..., 2]
        return torch.logical_and(z > min_dist, z < max_dist)
    center = (min_dist + max_dist) / 2.0
    std = (max_dist - min_dist) / 2.0
    d = safe_norm(cam_points - center, dim=-1)
    return torch.exp(-0.5 * torch.square(d / std))


def project(cam_points: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pinhole projection: homogeneous pixel coordinates (u·z, v·z, z)."""
    return torch.matmul(cam_points, K.T)


def fov_mask(
    cam_points: torch.Tensor,
    K: torch.Tensor,
    img_width: float,
    img_height: float,
    *,
    eps: float = 1e-6,
    binary: bool = False,
) -> torch.Tensor:
    """Differentiable (or exact) frustum-membership mask.

    Smooth: sigmoid(z) · exp(−½((u/(z+eps) − W/2)/W)²) · exp(−½((v/(z+eps) − H/2)/H)²).
    Binary: z > 0 and the pixel strictly inside a 1-px border.
    """
    ph = project(cam_points, K)
    u, v, z = ph[..., 0], ph[..., 1], ph[..., 2]
    if binary:
        uz = u / z
        vz = v / z
        return (
            (z > 0)
            & (uz > 1)
            & (uz < img_width - 1)
            & (vz > 1)
            & (vz < img_height - 1)
        )
    depth = torch.sigmoid(z)
    # value-preserving gradient safety, as in the JAX twin: bound z + eps
    # away from 0 keeping its sign, and clamp the Gaussian arguments at ±20
    zd = z + eps
    zd = torch.where(zd >= 0, torch.clamp(zd, min=1e-12), torch.clamp(zd, max=-1e-12))
    xu = torch.clamp((u / zd - img_width / 2.0) / img_width, -20.0, 20.0)
    xv = torch.clamp((v / zd - img_height / 2.0) / img_height, -20.0, 20.0)
    wg = torch.exp(-0.5 * torch.square(xu))
    hg = torch.exp(-0.5 * torch.square(xv))
    return depth * wg * hg


def visibility(
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
) -> torch.Tensor:
    """Smooth visibility score dist_mask · fov_mask: (N,) or (W, N)."""
    cam = to_camera_frame(points, quats, trans)
    dm = dist_mask(cam, min_dist, max_dist)
    fm = fov_mask(cam, K, img_width, img_height, eps=eps)
    return dm * fm


def frustum_cull(
    cam_points: torch.Tensor,
    K: torch.Tensor,
    img_width: float,
    img_height: float,
    *,
    min_dist: float = 1.0,
    max_dist: float = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hard frustum mask: (combined, dist, fov), all (..., N) bool."""
    dm = dist_mask(cam_points, min_dist, max_dist, binary=True)
    fm = fov_mask(cam_points, K, img_width, img_height, binary=True)
    return torch.logical_and(dm, fm), dm, fm


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def compact_masked(points, mask) -> np.ndarray:
    """Host-side helper: the masked subset as a dense (M, 3) numpy array
    (data-dependent shape; for bus and visualization paths)."""
    return _host(points)[_host(mask).astype(bool)]
