"""ctypes loader for the native C++ host library, with numpy fallbacks.

Twin of ``trajectory_optimization_tpu/native/__init__.py``: the voxel and
frustum entry points and the codec ones (lz4, jpeg, png) that ``bus/``
calls. ``trajopt_native.cpp`` and ``Makefile`` are copies of the JAX
package's. The library is built on first use with ``g++`` and the
Makefile's flags (``make`` need not be installed) into
``build/torch_native/`` at the repository root, named by a digest of the
sources and the flags, and never into the package directory. Without a
toolchain every entry point falls back to the port's numpy or PyTorch
implementation: same semantics, slower. A codec entry point returns None
then, and its bus module takes its numpy path (same bytes). The digest in
the library's name takes the place of the JAX loader's ``_stale`` check:
a library built from other sources is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "trajopt_native.cpp", _HERE / "Makefile")
BUILD_DIR = _HERE.parents[1] / "build" / "torch_native"
# the Makefile's CXXFLAGS and link flags (tests/test_torch_voxel.py holds them equal)
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fwrapv", "-Wall", "-Wextra")
LINK_FLAGS = ("-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """The library built from the current sources: its name is a digest of
    the sources' bytes and the flags, so editing either builds a new one."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update(" ".join(CXXFLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libtrajopt_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``trajopt_native.cpp`` unless a library from the same sources
    and flags exists; return its path. Raises if ``g++`` fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found for the native library")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXXFLAGS, *LINK_FLAGS, "-o", tmp, str(SOURCES[0])],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)  # atomic: concurrent builders never load half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None

        lib.voxel_downsample.restype = ctypes.c_int64
        lib.voxel_downsample.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_float, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ]
        lib.frustum_cull_mask.restype = None
        lib.frustum_cull_mask.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.occupancy_grid.restype = None
        lib.occupancy_grid.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.POINTER(ctypes.c_uint8),
        ]
        u8p, i32, i64 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int64
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.lz4_block_decode.restype = i64
        lib.lz4_block_decode.argtypes = [u8p, i64, u8p, i64, i64]
        lib.lz4_block_encode.restype = i64
        lib.lz4_block_encode.argtypes = [u8p, i64, u8p, i64]
        lib.jpeg_probe.restype = i32
        lib.jpeg_probe.argtypes = [u8p, i64, i32p, i32p, i32p]
        lib.jpeg_decode.restype = i64
        lib.jpeg_decode.argtypes = [u8p, i64, u8p, i64]
        lib.jpeg_encode.restype = i64
        lib.jpeg_encode.argtypes = [u8p, i32, i32, i32, i32, u8p, i64]
        lib.jpeg_encode_sub.restype = i64
        lib.jpeg_encode_sub.argtypes = [u8p, i32, i32, i32, i32, i32, u8p, i64]
        lib.png_unfilter.restype = i32
        lib.png_unfilter.argtypes = [u8p, i64, i64, i32, u8p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def voxel_downsample_native(
    points: np.ndarray,
    leaf_size: float,
    *,
    z_limits: Optional[Tuple[float, float]] = None,
) -> np.ndarray:
    """Centroid voxel-grid downsample — C++ when built, numpy otherwise."""
    lib = _load()
    pts = np.ascontiguousarray(points, dtype=np.float32)
    if pts.ndim != 2 or pts.shape[1] < 3:
        raise ValueError(f"expected (N, >=3) points, got {pts.shape}")
    if lib is None:
        from trajectory_optimization_tpu_torch.ops.voxel import voxel_downsample

        return voxel_downsample(pts, leaf_size, z_limits=z_limits)
    n, dim = pts.shape
    out = np.empty_like(pts)
    zmin, zmax = z_limits if z_limits is not None else (0.0, 0.0)
    m = lib.voxel_downsample(
        _fptr(pts), n, dim, ctypes.c_float(leaf_size),
        1 if z_limits is not None else 0,
        ctypes.c_float(zmin), ctypes.c_float(zmax), _fptr(out), n,
    )
    if m < 0:
        raise ValueError("native voxel_downsample rejected its arguments")
    return out[:m].copy()


def frustum_cull_mask_native(
    cam_points: np.ndarray, K: np.ndarray, img_width: float, img_height: float,
    min_dist: float = 1.0, max_dist: float = 10.0,
) -> np.ndarray:
    """Hard frustum mask — C++ when built, ``ops.geometry.frustum_cull`` on
    CPU tensors otherwise."""
    lib = _load()
    pts = np.ascontiguousarray(cam_points[:, :3], dtype=np.float32)
    if lib is None:
        import torch

        from trajectory_optimization_tpu_torch.ops.geometry import frustum_cull

        m, _, _ = frustum_cull(
            torch.as_tensor(pts), torch.as_tensor(np.asarray(K, np.float32)),
            img_width, img_height, min_dist=min_dist, max_dist=max_dist,
        )
        return m.numpy().astype(bool)
    mask = np.empty(len(pts), dtype=np.uint8)
    K32 = np.ascontiguousarray(np.asarray(K, np.float32).reshape(-1))
    lib.frustum_cull_mask(
        _fptr(pts), len(pts), _fptr(K32),
        ctypes.c_float(img_width), ctypes.c_float(img_height),
        ctypes.c_float(min_dist), ctypes.c_float(max_dist),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return mask.astype(bool)


def occupancy_grid_native(
    points: np.ndarray, resolution: float = 0.15,
    x=(0.0, 90.0), y=(-50.0, 50.0), z=(-4.5, 5.5),
) -> np.ndarray:
    """Dense occupancy grid — C++ when built, ``ops.voxel`` otherwise."""
    lib = _load()
    if lib is None:
        from trajectory_optimization_tpu_torch.ops.voxel import occupancy_grid

        return occupancy_grid(points, resolution, x, y, z)
    pts = np.ascontiguousarray(points[:, :3], dtype=np.float32)
    dims = (
        int((x[1] - x[0]) / resolution),
        int((y[1] - y[0]) / resolution),
        int(round((z[1] - z[0]) / resolution)),
    )
    grid = np.empty(dims, dtype=np.uint8)
    lib.occupancy_grid(
        _fptr(pts), len(pts), ctypes.c_float(resolution),
        ctypes.c_float(x[0]), ctypes.c_float(x[1]),
        ctypes.c_float(y[0]), ctypes.c_float(y[1]),
        ctypes.c_float(z[0]), ctypes.c_float(z[1]),
        grid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return grid.astype(np.float64)


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def jpeg_decode_native(data: bytes) -> Optional[np.ndarray]:
    """Decode a baseline or progressive JPEG with the C++ from-spec decoder.

    Returns (H, W) gray or (H, W, 3) RGB uint8; None when the native
    library is unavailable (callers fall back to the numpy decoder in
    ``bus.jpeg``, identical numerics). Raises the ``bus.jpeg`` exception
    types on malformed or unsupported streams, as the numpy decoder does.
    """
    lib = _load()
    if lib is None:
        return None
    from trajectory_optimization_tpu_torch.bus.jpeg import JpegError, UnsupportedJpegError

    src = np.frombuffer(data, dtype=np.uint8)
    h, w, nc = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.jpeg_probe(_u8p(src), len(src), ctypes.byref(h), ctypes.byref(w),
                        ctypes.byref(nc))
    if rc == -2:
        raise UnsupportedJpegError("unsupported JPEG coding (native probe)")
    if rc != 0:
        raise JpegError("malformed JPEG (native probe)")
    out = np.empty(h.value * w.value * nc.value, dtype=np.uint8)
    n = lib.jpeg_decode(_u8p(src), len(src), _u8p(out), out.shape[0])
    if n == -2:
        raise UnsupportedJpegError("unsupported JPEG coding (native decode)")
    if n < 0:
        raise JpegError(f"malformed JPEG (native decode rc={n})")
    if nc.value == 1:
        return out.reshape(h.value, w.value)
    return out.reshape(h.value, w.value, nc.value)


def jpeg_encode_native(img: np.ndarray, quality: int = 85,
                       subsampling: str = "444") -> Optional[bytes]:
    """Encode uint8 gray or (H, W, 3) RGB as baseline JPEG (4:4:4 or 4:2:0)
    in C++. Returns None when the native library is unavailable or the
    output outgrows 4× the raw size (``bus.jpeg``'s numpy encoder, same
    tables and bytes, is the fallback)."""
    lib = _load()
    if lib is None:
        return None
    img = np.asarray(img)
    sub420 = subsampling == "420" and img.ndim == 3  # gray has no chroma
    if img.dtype != np.uint8:
        raise ValueError(f"JPEG encode needs uint8 input, got {img.dtype}")
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        ncomp = 1
    elif img.ndim == 3 and img.shape[2] == 3:
        ncomp = 3
    else:
        raise ValueError(f"cannot encode shape {img.shape} as JPEG")
    h, w = int(img.shape[0]), int(img.shape[1])
    if h == 0 or w == 0:
        raise ValueError("empty image")
    # entropy-coded noise at quality ~100 can exceed the raw size (~2.2x):
    # 2x + headers, then once at 4x, then the growable numpy encoder
    for mult in (2, 4):
        cap = mult * h * w * ncomp + (1 << 16)
        out = np.empty(cap, dtype=np.uint8)
        if sub420:
            n = lib.jpeg_encode_sub(_u8p(img), h, w, ncomp, int(quality), 1, _u8p(out), cap)
        else:
            n = lib.jpeg_encode(_u8p(img), h, w, ncomp, int(quality), _u8p(out), cap)
        if n != -3:  # -3 = output buffer overflow
            break
    if n == -3:
        return None
    if n < 0:
        raise ValueError(f"native jpeg_encode failed rc={n}")
    return out[:n].tobytes()


def png_unfilter_native(raw: bytes, height: int, stride: int,
                        bpp: int) -> Optional[np.ndarray]:
    """Undo PNG scanline filtering natively -> (height, stride) uint8.

    Returns None when the native library is unavailable (``bus.png`` falls
    back to its numpy loops). Raises ValueError on a bad filter byte, as
    the fallback does.
    """
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(raw, dtype=np.uint8)
    out = np.empty((height, stride), dtype=np.uint8)
    if lib.png_unfilter(_u8p(src), int(height), int(stride), int(bpp), _u8p(out)) != 0:
        raise ValueError("bad PNG filter type")
    return out


def lz4_block_encode_native(src: bytes) -> Optional[bytes]:
    """Compress one LZ4 block in C++. Returns the compressed bytes, ``b""``
    when the data does not shrink (the caller stores the block; the
    encoders are bit-identical, so retrying in Python gains nothing), or
    None when the native library is unavailable (the caller falls back to
    the numpy encoder)."""
    lib = _load()
    if lib is None:
        return None
    s = np.frombuffer(src, dtype=np.uint8)
    cap = len(s) - 1
    if cap <= 0:
        return b""
    dst = np.empty(cap, dtype=np.uint8)
    n = lib.lz4_block_encode(_u8p(s), len(s), _u8p(dst), cap)
    if n < 0:
        return b""
    return dst[:n].tobytes()


def lz4_block_decode_native(src: bytes, dst: np.ndarray, dst_pos: int):
    """Decode one LZ4 block into ``dst`` (uint8, C-contiguous) at ``dst_pos``.

    Returns the new write position, or None when the native library is
    unavailable (callers fall back to the numpy decoder in ``bus.lz4``).
    Raises ValueError on malformed input or too little capacity.
    """
    lib = _load()
    if lib is None:
        return None
    s = np.frombuffer(src, dtype=np.uint8)
    new_pos = lib.lz4_block_decode(_u8p(s), len(s), _u8p(dst), int(dst_pos), int(dst.shape[0]))
    if new_pos < 0:
        raise ValueError("malformed LZ4 block (or output buffer too small)")
    return int(new_pos)
