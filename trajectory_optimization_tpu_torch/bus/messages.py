"""Typed scene-bus messages.

Twin of ``trajectory_optimization_tpu/bus/messages.py``, copied for the
messages the ported nodes read and write: ``Header``, ``CloudMsg``,
``PoseMsg``, ``PathMsg``, ``CameraInfoMsg``, ``OdometryMsg``, ``ImageMsg``
(with ``bgr_to_rgb``) and ``TransformMsg``, plus ``host_image``. Messages
are immutable dataclasses carrying numpy arrays, except ``ImageMsg.data``,
which may hold a CUDA tensor (see there).

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
class PoseMsg:
    """Stamped pose: position (3,), orientation xyzw (4,)."""

    header: Header
    position: np.ndarray
    orientation_xyzw: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "position", np.asarray(self.position, np.float64).reshape(3))
        object.__setattr__(
            self, "orientation_xyzw", np.asarray(self.orientation_xyzw, np.float64).reshape(4)
        )

    @property
    def orientation_wxyz(self) -> np.ndarray:
        q = self.orientation_xyzw
        return np.array([q[3], q[0], q[1], q[2]])


@dataclasses.dataclass(frozen=True)
class PathMsg:
    """Waypoint path: positions (W, 3), orientations xyzw (W, 4)."""

    header: Header
    positions: np.ndarray
    orientations_xyzw: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "positions", np.asarray(self.positions, np.float64))
        object.__setattr__(
            self, "orientations_xyzw", np.asarray(self.orientations_xyzw, np.float64)
        )

    @property
    def orientations_wxyz(self) -> np.ndarray:
        q = self.orientations_xyzw
        return np.concatenate([q[:, 3:], q[:, :3]], axis=1)

    @classmethod
    def straight(
        cls, positions, frame_id: str = "world", stamp: Optional[float] = None
    ) -> "PathMsg":
        positions = np.asarray(positions, np.float64)
        quats = np.zeros((len(positions), 4))
        quats[:, 3] = 1.0  # identity xyzw
        return cls(Header.make(frame_id, stamp), positions, quats)


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
class OdometryMsg:
    header: Header
    position: np.ndarray
    orientation_xyzw: np.ndarray
    child_frame_id: str = "base_link"


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


def host_image(data) -> np.ndarray:
    """The host pixels of an ``ImageMsg.data``: a tensor (a CUDA one
    included) is copied with ``.cpu()``, anything else read by
    ``np.asarray``. Only the sinks that need the bytes call it (recording,
    the cross-process wire, extraction): the points processor still
    publishes on the card."""
    import torch

    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    return np.asarray(data)


def bgr_to_rgb(img: "np.ndarray", encoding: str) -> "np.ndarray":
    """Return ``img`` in true (RGB) channel order.

    Decoded CompressedImage streams are always rgb8, but user-constructed
    messages default to bgr8 (the cv/ROS convention, see ``ImageMsg``);
    true-colour sinks (PNG/JPEG encoders, dataset extraction) must swap
    BGR(A) bytes or red and blue come out flipped. No-op for non-BGR
    encodings or non-(H, W, >=3) arrays.
    """
    img = np.asarray(img)
    if encoding in ("bgr8", "bgra8") and img.ndim == 3 and img.shape[-1] >= 3:
        img = np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)
    return img


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
