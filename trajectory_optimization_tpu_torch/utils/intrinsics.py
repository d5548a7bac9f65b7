"""Camera intrinsics container.

PyTorch twin of ``trajectory_optimization_tpu/utils/intrinsics.py``: the same
frozen dataclass and the same reference camera (fx=758.03967, fy=761.62359,
cx=621.46572, cy=756.86402, 1232x1616 image), with ``matrix`` returning a
torch tensor on an explicit device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole camera intrinsics + image size (pixels; floats, as the
    visibility model treats them as continuous scales)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: float
    height: float
    distortion: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)
    frame_id: str = "camera_frame"

    def matrix(self, device="cpu", dtype=torch.float32) -> torch.Tensor:
        """3x3 camera matrix K."""
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=dtype,
            device=device,
        )

    def matrix_np(self, dtype=np.float32) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=dtype,
        )

    @classmethod
    def from_matrix(cls, K, width: float, height: float, **kw) -> "CameraIntrinsics":
        K = np.asarray(K, dtype=np.float64)
        return cls(
            fx=float(K[0, 0]),
            fy=float(K[1, 1]),
            cx=float(K[0, 2]),
            cy=float(K[1, 2]),
            width=float(width),
            height=float(height),
            **kw,
        )

    @classmethod
    def from_flat_k(cls, K, width: float, height: float, **kw) -> "CameraIntrinsics":
        """From a row-major 9-element K (the CameraInfo message layout)."""
        return cls.from_matrix(np.asarray(K, dtype=np.float64).reshape(3, 3), width, height, **kw)


# The reference robot camera.
_DEFAULT = CameraIntrinsics(
    fx=758.03967,
    fy=761.62359,
    cx=621.46572,
    cy=756.86402,
    width=1232.0,
    height=1616.0,
    distortion=(-0.20571, 0.04103, -0.00101, 0.00098, 0.0),
)


def default_intrinsics() -> CameraIntrinsics:
    """The hardcoded SubT robot camera used by all reference demos."""
    return _DEFAULT
