"""Typed scene-bus messages.

Twin of ``trajectory_optimization_tpu/bus/messages.py``, copied for the
messages the points processor reads and writes: ``Header``, ``CloudMsg``,
``CameraInfoMsg``, ``ImageMsg`` and ``TransformMsg``. Messages are immutable
dataclasses carrying numpy arrays, except ``ImageMsg.data``, which may hold
a CUDA tensor (see there).

Quaternion conventions: bus messages carry xyzw (ROS wire order); device math
uses wxyz.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Optional, Tuple

import numpy as np

_seq_counter = itertools.count()


def now() -> float:
    return time.monotonic()


@dataclasses.dataclass(frozen=True)
class Header:
    stamp: float
    frame_id: str = "world"
    seq: int = 0

    @classmethod
    def make(cls, frame_id: str = "world", stamp: Optional[float] = None) -> "Header":
        return cls(stamp=now() if stamp is None else stamp, frame_id=frame_id,
                   seq=next(_seq_counter))


@dataclasses.dataclass(frozen=True)
class CloudMsg:
    """Point cloud: (N, 3) xyz or (N, 4) xyz+intensity (float32)."""

    header: Header
    points: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "points", np.asarray(self.points, np.float32))

    @property
    def xyz(self) -> np.ndarray:
        return self.points[:, :3]

    @property
    def intensity(self) -> Optional[np.ndarray]:
        return self.points[:, 3] if self.points.shape[1] > 3 else None


@dataclasses.dataclass(frozen=True)
class CameraInfoMsg:
    """Pinhole camera description (CameraInfo parity: K/D/R/P rows)."""

    header: Header
    width: int
    height: int
    K: Tuple[float, ...]  # row-major 3x3
    D: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0, 0.0)
    R: Tuple[float, ...] = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
    P: Tuple[float, ...] = ()
    distortion_model: str = "plumb_bob"

    def intrinsics(self):
        from trajectory_optimization_tpu_torch.utils.intrinsics import CameraIntrinsics

        return CameraIntrinsics.from_flat_k(
            self.K, self.width, self.height, frame_id=self.header.frame_id
        )


@dataclasses.dataclass(frozen=True)
class ImageMsg:
    """(H, W, C) uint8 or float image.

    ``data`` may be a host numpy array OR a CUDA tensor: the points processor
    publishes its rendered image on the card, so the device-to-host copy is
    paid only by consumers that read pixels (``msg.data.cpu()``), not on
    every publish.
    """

    header: Header
    data: "np.ndarray"
    encoding: str = "bgr8"
    wire_format: str = ""


@dataclasses.dataclass(frozen=True)
class TransformMsg:
    """Frame-to-frame transform (TransformStamped parity)."""

    header: Header
    child_frame_id: str
    translation: np.ndarray
    rotation_xyzw: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "translation", np.asarray(self.translation, np.float64).reshape(3))
        object.__setattr__(
            self, "rotation_xyzw", np.asarray(self.rotation_xyzw, np.float64).reshape(4)
        )
