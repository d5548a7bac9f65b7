"""ctypes loader for the native C++ host library, with numpy fallbacks.

Twin of ``trajectory_optimization_tpu/native/__init__.py`` for its voxel and
frustum entry points. ``trajopt_native.cpp`` and ``Makefile`` are copies of
the JAX package's. The library is built on first use with ``g++`` and the
Makefile's flags (``make`` need not be installed) into
``build/torch_native/`` at the repository root, named by a digest of the
sources and the flags, and never into the package directory. Without a
toolchain every entry point falls back to the port's numpy or PyTorch
implementation: same semantics, slower. The codec entry points in the C++
source (lz4, jpeg, png) stay unbound until their bus modules are ported.
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
