"""Quaternion algebra in PyTorch (wxyz convention).

Twin of ``trajectory_optimization_tpu/ops/quat.py``, function for function;
``random`` takes a ``torch.Generator`` where the JAX twin takes a key. All
functions broadcast over leading batch axes; quaternions are (..., 4) in
(w, x, y, z) order.
"""
from __future__ import annotations

import numpy as np
import torch


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize, dividing by max(norm, eps) (F.normalize semantics)."""
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    """(w, -x, -y, -z): the inverse of a unit quaternion."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


invert = conjugate


def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b."""
    aw, ax, ay, az = torch.unbind(a, dim=-1)
    bw, bx, by, bz = torch.unbind(b, dim=-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4) (Rodrigues form)."""
    qw = q[..., :1]
    qv = q[..., 1:]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * t + torch.linalg.cross(qv, t, dim=-1)


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) (..., 4) → rotation matrices (..., 3, 3) with
    R @ v == apply(q, v). Does NOT normalize; callers normalize first."""
    w, x, y, z = torch.unbind(q, dim=-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = torch.stack([1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)], dim=-1)
    row1 = torch.stack([2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)], dim=-1)
    row2 = torch.stack([2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) → unit quaternion (..., 4), w >= 0
    (Shepperd's branch-free form: the candidate with the largest pivot)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)

    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 candidates, 4)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx).squeeze(-2)
    q = normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def from_euler(roll, pitch, yaw, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Intrinsic x-y-z (roll, pitch, yaw) Euler angles → wxyz quaternion
    (tf.transformations.quaternion_from_euler order, returned as wxyz)."""
    r, p, y = [torch.as_tensor(a, dtype=dtype, device=device) * 0.5 for a in (roll, pitch, yaw)]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        dim=-1,
    )


def random(
    generator: torch.Generator, n: int, dtype=torch.float32, device="cpu"
) -> torch.Tensor:
    """(n, 4) uniformly random unit quaternions (Gaussian projection), w >= 0.
    ``generator`` must live on ``device``."""
    q = torch.randn((n, 4), generator=generator, dtype=dtype, device=device)
    q = normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def wxyz_to_xyzw(q: torch.Tensor) -> torch.Tensor:
    """Reorder (w,x,y,z) → (x,y,z,w) (ROS wire order)."""
    return torch.cat([q[..., 1:], q[..., :1]], dim=-1)


def xyzw_to_wxyz(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., 3:], q[..., :3]], dim=-1)


# NumPy mirrors for host-side code ------------------------------------------


def from_euler_np(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """NumPy twin of :func:`from_euler` (wxyz)."""
    r, p, y = roll * 0.5, pitch * 0.5, yaw * 0.5
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    return np.array(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ]
    )


def normalize_np(q: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    n = np.linalg.norm(q, axis=-1, keepdims=True)
    return q / np.maximum(n, eps)


def wxyz_to_xyzw_np(q: np.ndarray) -> np.ndarray:
    return np.concatenate([q[..., 1:], q[..., :1]], axis=-1)


def xyzw_to_wxyz_np(q: np.ndarray) -> np.ndarray:
    return np.concatenate([q[..., 3:], q[..., :3]], axis=-1)
