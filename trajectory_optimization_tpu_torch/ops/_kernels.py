"""Build, bind and launch the hand-written CUDA kernels of ``csrc/``.

The kernels replace the Pallas TPU kernels of
``trajectory_optimization_tpu/ops/pallas_vis.py`` (see ``ops/fused_vis.py``
for the plain versions and the dispatch). ``csrc/fused_vis.cu`` is compiled
on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC

into ``build/torch_kernels/`` at the repository root (no fast-math flags:
denormal scores must survive), and loaded with ctypes. Nothing here runs at
import time: the CPU tests import this module without ``nvcc`` or a card.

Every wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream, raises if the
C entry point returns a CUDA error, and only then adds one to its entry in
``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "fused_vis.cu"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# One count per kernel, raised only where the wrapper launches its kernel.
LAUNCHES = {"pass_a": 0, "pass_b": 0, "bwd_stats": 0, "bwd_apply": 0}

_lib = None
build_log = ""  # nvcc's output (ptxas register/shared-memory report) of the last build


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cuda_nvcc.exists():
        return str(cuda_nvcc)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def build() -> Path:
    """Compile ``csrc/fused_vis.cu`` unless a library built from the same
    source and flags exists; return the library's path."""
    global build_log
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libfused_vis_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True, check=False,
        )
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
        os.replace(tmp, out)  # atomic: concurrent builders never load half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fv_block_points.argtypes, lib.fv_block_points.restype = [], I
    lib.fv_error_string.argtypes, lib.fv_error_string.restype = [I], ctypes.c_char_p
    lib.fv_pass_a.argtypes = [P, P, P, P, I, I] + [F] * 7 + [P, P, P, P]
    lib.fv_pass_b.argtypes = [P, P, I, I, F, P, P]
    lib.fv_bwd_stats.argtypes = [P, P, P, P, I, I, F, P, P]
    lib.fv_bwd_apply.argtypes = [P] * 7 + [I, I] + [F] * 8 + [P, P]
    for fn in (lib.fv_pass_a, lib.fv_pass_b, lib.fv_bwd_stats, lib.fv_bwd_apply):
        fn.restype = I
    _lib = lib
    return lib


def _check(name: str, t: torch.Tensor, shape) -> int:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.data_ptr()


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        msg = _load().fv_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: {msg} ({rc})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _n_blocks(N: int) -> int:
    bp = _load().fv_block_points()
    return (N + bp - 1) // bp


def _consts_args(k):
    return (k.c0, k.inv_var, k.img_w, k.img_h, k.eps, k.inv_w, k.inv_h)


def _sizes(pts_t: torch.Tensor, wp: torch.Tensor):
    N, W = pts_t.shape[1], wp.shape[0]
    if N == 0 or W == 0:
        raise ValueError(f"empty problem: N={N}, W={W}")
    return N, W


def pass_a(wp, kp, pts_t, valid, k):
    """K1: returns (m (W,), M (W,), scores (W, N))."""
    N, W = _sizes(pts_t, wp)
    args = (
        _check("pts_t", pts_t, (3, N)), _check("valid", valid, (N,)),
        _check("wp", wp, (W, 12)), _check("kp", kp, (4,)),
    )
    lib = _load()
    nb = _n_blocks(N)
    cache = torch.empty((W, N), dtype=torch.float32, device=pts_t.device)
    pmin = torch.empty((nb, W), dtype=torch.float32, device=pts_t.device)
    pmax = torch.empty((nb, W), dtype=torch.float32, device=pts_t.device)
    with torch.cuda.device(pts_t.device):
        rc = lib.fv_pass_a(*args, N, W, *_consts_args(k), cache.data_ptr(),
                           pmin.data_ptr(), pmax.data_ptr(), _stream(pts_t))
    _raise_on(rc, "pass_a")
    LAUNCHES["pass_a"] += 1
    return torch.amin(pmin, dim=0), torch.amax(pmax, dim=0), cache


def pass_b(norm, scores, eps):
    """K2: returns lo (N,)."""
    W, N = scores.shape
    args = (_check("scores", scores, (W, N)), _check("norm", norm, (W, 4)))
    lib = _load()
    lo = torch.empty((N,), dtype=torch.float32, device=scores.device)
    with torch.cuda.device(scores.device):
        rc = lib.fv_pass_b(*args, N, W, 1.0 - eps, lo.data_ptr(), _stream(scores))
    _raise_on(rc, "pass_b")
    LAUNCHES["pass_b"] += 1
    return lo


def bwd_stats(norm, scores, valid, g, eps):
    """K3: returns (W, 4) sums over points."""
    W, N = scores.shape
    args = (
        _check("norm", norm, (W, 4)), _check("scores", scores, (W, N)),
        _check("valid", valid, (N,)), _check("g", g, (N,)),
    )
    lib = _load()
    part = torch.empty((_n_blocks(N), W, 4), dtype=torch.float32, device=scores.device)
    with torch.cuda.device(scores.device):
        rc = lib.fv_bwd_stats(*args, N, W, 1.0 - eps, part.data_ptr(), _stream(scores))
    _raise_on(rc, "bwd_stats")
    LAUNCHES["bwd_stats"] += 1
    return torch.sum(part, dim=0)


def bwd_apply(wp, kp, norm2, pts_t, valid, g, scores, k):
    """K4: returns (W, 3, 4) camera-plane sums."""
    N, W = _sizes(pts_t, wp)
    args = (
        _check("wp", wp, (W, 12)), _check("kp", kp, (4,)), _check("norm2", norm2, (W, 6)),
        _check("pts_t", pts_t, (3, N)), _check("valid", valid, (N,)),
        _check("g", g, (N,)), _check("scores", scores, (W, N)),
    )
    lib = _load()
    part = torch.empty((_n_blocks(N), W, 12), dtype=torch.float32, device=pts_t.device)
    with torch.cuda.device(pts_t.device):
        rc = lib.fv_bwd_apply(*args, N, W, *_consts_args(k), 1.0 - k.eps,
                              part.data_ptr(), _stream(pts_t))
    _raise_on(rc, "bwd_apply")
    LAUNCHES["bwd_apply"] += 1
    return torch.sum(part, dim=0).reshape(W, 3, 4)
