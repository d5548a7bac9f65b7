"""PointCloud2 wire codec — ROS-compatible binary cloud (de)serialization.

Copy of ``trajectory_optimization_tpu/bus/codec.py`` (the port imports
nothing of the JAX package).

Capability parity with the reference's `src/pointcloud_utils.py` (280 LoC of
field/dtype mapping, padding handling, packed-RGB splitting, xyz/xyzi
encoders), reimplemented as a declarative field-spec codec so clouds recorded
by ROS tooling (bags, PCL) can be decoded without any ROS dependency, and
clouds we publish are byte-compatible with the PointCloud2 wire layout.

A ``WireCloud`` is the transport-level struct (fields + blob); ``CloudMsg``
(bus.messages) is the in-memory view. Conversions in both directions handle:
  * inter-field and inter-point padding bytes,
  * the packed float32 'rgb' convention (PCL packs r,g,b into the bytes of
    one float), and
  * NaN point removal on extraction.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from trajectory_optimization_tpu_torch.bus.messages import CloudMsg, Header

# PointField datatype codes (sensor_msgs/PointField wire values)
INT8, UINT8, INT16, UINT16, INT32, UINT32, FLOAT32, FLOAT64 = range(1, 9)

_CODE_TO_DTYPE = {
    INT8: np.dtype(np.int8),
    UINT8: np.dtype(np.uint8),
    INT16: np.dtype(np.int16),
    UINT16: np.dtype(np.uint16),
    INT32: np.dtype(np.int32),
    UINT32: np.dtype(np.uint32),
    FLOAT32: np.dtype(np.float32),
    FLOAT64: np.dtype(np.float64),
}
_DTYPE_TO_CODE = {v: k for k, v in _CODE_TO_DTYPE.items()}


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """One PointField: name, byte offset within a point record, type code."""

    name: str
    offset: int
    datatype: int
    count: int = 1

    @property
    def dtype(self) -> np.dtype:
        return _CODE_TO_DTYPE[self.datatype]


@dataclasses.dataclass
class WireCloud:
    """PointCloud2-equivalent wire struct."""

    header: Header
    height: int
    width: int
    fields: List[FieldSpec]
    point_step: int
    data: bytes
    is_bigendian: bool = False
    is_dense: bool = True

    @property
    def row_step(self) -> int:
        return self.point_step * self.width


def _record_dtype(fields: Sequence[FieldSpec], point_step: int) -> np.dtype:
    """Structured dtype covering a full point record, padding included."""
    names, formats, offsets = [], [], []
    for f in fields:
        names.append(f.name)
        formats.append(f.dtype)
        offsets.append(f.offset)
    return np.dtype(
        {"names": names, "formats": formats, "offsets": offsets, "itemsize": point_step}
    )


def decode(cloud: WireCloud) -> np.ndarray:
    """WireCloud → (height, width) structured array (zero-copy where possible)."""
    if cloud.is_bigendian:
        # essentially extinct on real robots; fail loudly rather than parse
        # every float byte-swapped into denormal garbage
        raise NotImplementedError("big-endian PointCloud2 decoding is unsupported")
    dt = _record_dtype(cloud.fields, cloud.point_step)
    arr = np.frombuffer(cloud.data, dtype=dt, count=cloud.height * cloud.width)
    return arr.reshape(cloud.height, cloud.width)


def encode(
    arr: np.ndarray, header: Optional[Header] = None, *, height: Optional[int] = None
) -> WireCloud:
    """Structured array → WireCloud (field offsets from the array dtype)."""
    arr2 = np.atleast_2d(arr)
    fields = [
        FieldSpec(name, arr2.dtype.fields[name][1], _DTYPE_TO_CODE[arr2.dtype.fields[name][0]])
        for name in arr2.dtype.names
    ]
    finite = all(
        np.isfinite(arr2[name]).all()
        for name in arr2.dtype.names
        if np.issubdtype(arr2.dtype.fields[name][0], np.floating)
    )
    return WireCloud(
        header=header or Header.make(),
        height=arr2.shape[0],
        width=arr2.shape[1],
        fields=fields,
        point_step=arr2.dtype.itemsize,
        data=arr2.tobytes(),
        is_dense=bool(finite),
    )


def xyz_record(points: np.ndarray, intensity: Optional[np.ndarray] = None) -> np.ndarray:
    """(N, 3) float points (+ optional intensity) → structured xyz[i] array."""
    pts = np.asarray(points, np.float32)
    names = ["x", "y", "z"] + (["intensity"] if intensity is not None else [])
    dt = np.dtype([(n, np.float32) for n in names])
    out = np.empty(len(pts), dtype=dt)
    out["x"], out["y"], out["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    if intensity is not None:
        out["intensity"] = np.asarray(intensity, np.float32).reshape(-1)
    return out


def encode_xyz(points: np.ndarray, header: Optional[Header] = None) -> WireCloud:
    """(N, 3) or (N, 4) xyz[+intensity] → WireCloud (reference
    `xyz_array_to_pointcloud2`/`xyzi_array_to_pointcloud2` parity)."""
    pts = np.asarray(points, np.float32)
    inten = pts[:, 3] if pts.shape[1] >= 4 else None
    return encode(xyz_record(pts[:, :3], inten), header)


def extract_xyz(cloud: WireCloud, remove_nans: bool = True) -> np.ndarray:
    """WireCloud → (N, 3) float xyz, NaNs dropped (reference
    `pointcloud2_to_xyz_array` parity)."""
    rec = decode(cloud).reshape(-1)
    xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float64)
    if remove_nans:
        xyz = xyz[np.isfinite(xyz).all(axis=1)]
    return xyz


def extract_fields(
    cloud: WireCloud, names: Sequence[str], remove_nans: bool = True
) -> np.ndarray:
    """WireCloud → (N, len(names)) float matrix of arbitrary fields."""
    rec = decode(cloud).reshape(-1)
    cols = np.stack([rec[n].astype(np.float64) for n in names], axis=1)
    if remove_nans:
        cols = cols[np.isfinite(cols).all(axis=1)]
    return cols


def split_rgb(rec: np.ndarray) -> np.ndarray:
    """Unpack a packed float32 'rgb' field into uint8 r/g/b columns."""
    packed = rec["rgb"].copy().view(np.uint32)
    r = ((packed >> 16) & 0xFF).astype(np.uint8)
    g = ((packed >> 8) & 0xFF).astype(np.uint8)
    b = (packed & 0xFF).astype(np.uint8)
    keep = [(n, rec.dtype.fields[n][0]) for n in rec.dtype.names if n != "rgb"]
    dt = np.dtype(keep + [("r", np.uint8), ("g", np.uint8), ("b", np.uint8)])
    out = np.empty(rec.shape, dtype=dt)
    for n, _ in keep:
        out[n] = rec[n]
    out["r"], out["g"], out["b"] = r, g, b
    return out


def merge_rgb(rec: np.ndarray) -> np.ndarray:
    """Pack uint8 r/g/b columns into one packed float32 'rgb' field (the PCL
    convention)."""
    packed = (
        (rec["r"].astype(np.uint32) << 16)
        | (rec["g"].astype(np.uint32) << 8)
        | rec["b"].astype(np.uint32)
    )
    keep = [(n, rec.dtype.fields[n][0]) for n in rec.dtype.names if n not in ("r", "g", "b")]
    dt = np.dtype(keep + [("rgb", np.float32)])
    out = np.empty(rec.shape, dtype=dt)
    for n, _ in keep:
        out[n] = rec[n]
    out["rgb"] = packed.view(np.float32)
    return out


def _extract_with_rgb(cloud: WireCloud, base: list, remove_nans: bool) -> np.ndarray:
    """base columns + r,g,b — layout-independent width: a packed float32
    'rgb' field is unpacked into separate r/g/b columns, so callers always
    get len(base)+3 columns whichever wire layout arrived."""
    rec = decode(cloud).reshape(-1)
    if "rgb" in (rec.dtype.names or ()):
        rec = split_rgb(rec)
    cols = np.stack([rec[n].astype(np.float64) for n in base + ["r", "g", "b"]], axis=1)
    if remove_nans:
        cols = cols[np.isfinite(cols).all(axis=1)]
    return cols


def extract_xyzrgb(cloud: WireCloud, remove_nans: bool = True) -> np.ndarray:
    """(N, 6) x,y,z,r,g,b (reference `pointcloud2_to_xyzrgb_array`; handles
    both the packed-'rgb' and separate-r/g/b wire layouts — packed rgb is
    unpacked so the width never depends on the layout)."""
    return _extract_with_rgb(cloud, ["x", "y", "z"], remove_nans)


def extract_xyzirgb(cloud: WireCloud, remove_nans: bool = True) -> np.ndarray:
    """(N, 7) x,y,z,intensity,r,g,b (reference
    `pointcloud2_to_xyzirgb_array`; layout-independent width, see
    :func:`extract_xyzrgb`)."""
    return _extract_with_rgb(cloud, ["x", "y", "z", "intensity"], remove_nans)


def encode_xyzirgb(points: np.ndarray, header: Optional[Header] = None) -> WireCloud:
    """(N, 7) x,y,z,intensity,r,g,b float rows → WireCloud (reference
    `xyzirgb_array_to_pointcloud2`'s field set)."""
    pts = np.asarray(points, np.float32)
    dt = np.dtype([(n, np.float32) for n in ("x", "y", "z", "intensity", "r", "g", "b")])
    rec = np.empty(len(pts), dtype=dt)
    for i, n in enumerate(dt.names):
        rec[n] = pts[:, i]
    return encode(rec, header)


def cloud_msg_to_wire(msg: CloudMsg) -> WireCloud:
    return encode_xyz(msg.points, msg.header)


def wire_to_cloud_msg(cloud: WireCloud) -> CloudMsg:
    names = [f.name for f in cloud.fields]
    want = ["x", "y", "z"] + (["intensity"] if "intensity" in names else [])
    return CloudMsg(cloud.header, extract_fields(cloud, want).astype(np.float32))
