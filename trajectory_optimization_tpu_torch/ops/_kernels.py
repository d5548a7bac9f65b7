"""Build, bind and launch the hand-written CUDA kernels of ``csrc/``.

``csrc/fused_vis.cu`` holds the seven kernels that replace the Pallas TPU
kernels of ``trajectory_optimization_tpu/ops/pallas_vis.py`` (plain versions
and dispatch: ``ops/fused_vis.py``); ``csrc/splat_render.cu`` the two that
replace those of ``ops/pallas_render.py`` (``ops/tile_render.py``). Every
``csrc/*.cu`` is compiled on first use, one ``nvcc -c`` per source, all
started together, with

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
         -Xcompiler -fPIC -Xptxas -v -c

and linked into one library under ``build/torch_kernels/`` at the
repository root, named by a digest of every source and the flags (no
fast-math flags: denormal scores must survive), then loaded with ctypes.
Nothing here runs at import time: the CPU tests import this module without
``nvcc`` or a card.

Every wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` (pass A's min/max preset by one copy, see
``_minmax_out``), launches on the current stream, raises if the
C entry point returns a CUDA error, and only then adds one to its entry in
``LAUNCHES``. K3 and K4 finish their own partial sums in the last block to
arrive; the partials and the arrival counters, which the kernels leave
zeroed, live in a scratch that is made once per device and stream
(``_launch_reduced``).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*_ARCH, "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c")
LINK_FLAGS = (*_ARCH, "-shared")
# the tile of csrc/splat_render.cu and the band of columns each warp owns
# (checked at load)
SPLAT_TILE_H, SPLAT_TILE_W, SPLAT_BAND_W = 32, 128, 16
# Pass A's pruning constants, those of csrc/fused_vis.cu (checked at load; the
# reasons for their values are given there). With T0 = d²·inv_var: T0 ≥
# PRUNE_ZERO_T makes the score exactly +0; T0 > −2·log(M) + PRUNE_MAX_MARGIN
# puts it under a score M ≥ PRUNE_MAX_FLOOR already seen.
PRUNE_ZERO_T, PRUNE_MAX_MARGIN, PRUNE_MAX_FLOOR = 210.0, 0.015625, 1.0e-30

# One count per kernel, raised only where the wrapper launches its kernel.
LAUNCHES = {
    "pass_a": 0, "pass_b": 0, "bwd_stats": 0, "bwd_apply": 0,
    "pass_a_minmax": 0, "pass_b_recompute": 0, "bwd_fused_acc": 0,
    "splat_runs": 0, "splat_dense": 0,
}

BWD_SLOTS = 40  # K5's sums per waypoint (the JAX twin's layout)
BIG = 3.0e38  # pass A's min of a waypoint without valid points; its max is −BIG

_lib = None
_sentinels = {}  # per device, the (2, 1) column [BIG, −BIG] that presets pass A's outputs
_reduction_scratch = {}  # per (device, stream), K3's and K4's (arrival counters, partial sums)
build_log = ""  # nvcc's output (ptxas register/spill report) of the library's build, per source


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (its op takes the plain version), False for a
    CUDA one (it launches the kernel); other devices are refused."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise NotImplementedError(f"the port's kernels run on CPU or CUDA tensors, not {t.device}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cuda_nvcc.exists():
        return str(cuda_nvcc)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def library_path(sources: Sequence[Path] = SOURCES) -> Path:
    """The library built from ``sources``: its name is a digest of every
    source's name and bytes and of the flags, so a change to any of them
    makes a new library."""
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libtorch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link them into one
    library, unless one built from the same sources and flags exists;
    return the library's path."""
    global build_log
    out = library_path()
    log_file = out.with_suffix(".log")  # the build's nvcc output, kept beside the library
    if out.exists():
        build_log = log_file.read_text() if log_file.exists() else ""
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        nvcc = _nvcc()
        logs, failed = [], []
        with contextlib.ExitStack() as stack:
            jobs = []
            for src in SOURCES:
                log = stack.enter_context(open(work / f"{src.stem}.log", "w+"))
                obj = work / f"{src.stem}.o"
                proc = subprocess.Popen([nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)],
                                        stdout=log, stderr=subprocess.STDOUT)
                jobs.append((src, obj, proc, log))
            for src, _, proc, log in jobs:
                rc = proc.wait()
                log.seek(0)
                logs.append(f"== {src.name}\n{log.read()}")
                if rc != 0:
                    failed.append(f"{src.name} ({rc})")
        build_log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{build_log}")
        tmp = work / out.name
        proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(j[1]) for j in jobs)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        (work / log_file.name).write_text(build_log)
        os.replace(work / log_file.name, log_file)
        os.replace(tmp, out)  # atomic: concurrent builders never load half a file
    finally:
        shutil.rmtree(work, ignore_errors=True)
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
    lib.fv_bwd_stats.argtypes = [P, P, P, P, I, I, F, P, I, P, P, P, P]
    lib.fv_bwd_apply.argtypes = [P] * 8 + [I, I] + [F] * 8 + [P, I, P, P, P]
    lib.fv_pass_a_minmax.argtypes = [P, P, P, P, I, I] + [F] * 7 + [P, P, P]
    lib.fv_pass_b_recompute.argtypes = [P, P, P, P, I, I] + [F] * 8 + [P, P]
    lib.fv_bwd_fused_acc.argtypes = [P] * 6 + [I, I] + [F] * 8 + [P, P]
    lib.sr_splat_runs.argtypes = [P, P, I, I, F, P, P]
    lib.sr_splat_dense.argtypes = [P, P, I, I, I, F, P, P]
    for fn in (lib.fv_pass_a, lib.fv_pass_b, lib.fv_bwd_stats, lib.fv_bwd_apply,
               lib.fv_pass_a_minmax, lib.fv_pass_b_recompute, lib.fv_bwd_fused_acc,
               lib.sr_splat_runs, lib.sr_splat_dense, lib.sr_tile_h, lib.sr_tile_w,
               lib.sr_band_w, lib.sr_resident_blocks):
        fn.restype = I
    lib.sr_tile_h.argtypes = lib.sr_tile_w.argtypes = lib.sr_band_w.argtypes = []
    lib.sr_resident_blocks.argtypes = [I]
    lib.fv_expf_zero_check.argtypes, lib.fv_expf_zero_check.restype = [P, P, P], I
    consts = []
    for fn in (lib.fv_prune_zero_t, lib.fv_prune_max_margin, lib.fv_prune_max_floor):
        fn.argtypes, fn.restype = [], F
        consts.append(fn())
    if consts != [F(c).value for c in (PRUNE_ZERO_T, PRUNE_MAX_MARGIN, PRUNE_MAX_FLOOR)]:
        raise RuntimeError(f"fused_vis.cu prunes with {consts}, the wrapper expects "
                           f"{(PRUNE_ZERO_T, PRUNE_MAX_MARGIN, PRUNE_MAX_FLOOR)}")
    splat = (lib.sr_tile_h(), lib.sr_tile_w(), lib.sr_band_w())
    if splat != (SPLAT_TILE_H, SPLAT_TILE_W, SPLAT_BAND_W):
        raise RuntimeError(f"splat_render.cu has tiles {splat[0]}x{splat[1]} in bands of "
                           f"{splat[2]} columns, the wrapper expects {SPLAT_TILE_H}x"
                           f"{SPLAT_TILE_W} in bands of {SPLAT_BAND_W}")
    _lib = lib
    return lib


def _check(name: str, t: torch.Tensor, shape, dtype=torch.float32) -> int:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
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


def _minmax_out(W: int, device) -> torch.Tensor:
    """Pass A's (2, W) output, row 0 the minima and row 1 the maxima, preset
    to what a waypoint without valid points returns (the kernel merges into
    it with atomic min/max): the wrapper's one initialising op."""
    col = _sentinels.get(device)
    if col is None:
        col = _sentinels[device] = torch.tensor([[BIG], [-BIG]], dtype=torch.float32,
                                                device=device)
    return col.repeat(1, W)  # always a copy (expand().contiguous() is col itself at W = 1)


def pass_a(wp, kp, pts_t, valid, k):
    """K1: returns (m (W,), M (W,), scores (W, N))."""
    N, W = _sizes(pts_t, wp)
    args = (
        _check("pts_t", pts_t, (3, N)), _check("valid", valid, (N,)),
        _check("wp", wp, (W, 12)), _check("kp", kp, (4,)),
    )
    lib = _load()
    cache = torch.empty((W, N), dtype=torch.float32, device=pts_t.device)
    m, mx = _minmax_out(W, pts_t.device).unbind(0)
    with torch.cuda.device(pts_t.device):
        rc = lib.fv_pass_a(*args, N, W, *_consts_args(k), cache.data_ptr(),
                           m.data_ptr(), mx.data_ptr(), _stream(pts_t))
    _raise_on(rc, "pass_a")
    LAUNCHES["pass_a"] += 1
    return m, mx, cache


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


def need_words(N: int) -> int:
    """Words per row of K3's need mask: one bit per point, 32 to a word."""
    return -(-N // 32)


def _launch_reduced(fn, args, W: int, device, stream: int, tail) -> int:
    """Launch K3 or K4, ``fn(*args, part, len(part), arrivals, *tail)``, with
    the scratch of this device and stream: at least W zeroed int32 arrival
    counters (the kernels put back the zeros they find, so they are zeroed
    once, when they are made) and a float64 buffer for the blocks' partial
    sums, which the launcher sizes: it launches nothing and returns the
    doubles it needs, negated, while the buffer is too small. Calls on one
    stream run one after the other, so they share the scratch."""
    arrivals, part = _reduction_scratch.get((device, stream), (None, None))
    if arrivals is None or arrivals.numel() < W:
        arrivals = torch.zeros(max(W, 4096), dtype=torch.int32, device=device)
    if part is None:
        part = torch.empty(0, dtype=torch.float64, device=device)
    while (rc := fn(*args, part.data_ptr(), part.numel(), arrivals.data_ptr(), *tail)) < 0:
        part = torch.empty(-rc, dtype=torch.float64, device=device)
    _reduction_scratch[(device, stream)] = (arrivals, part)
    return rc


def bwd_stats(norm, scores, valid, g, eps):
    """K3: returns ((W, 4) sums over points, need (W, ceil(N / 32)) int32:
    bit l of word j of row w is set iff pair (w, 32 j + l) can add a nonzero
    term to K4)."""
    W, N = scores.shape
    if N == 0 or W == 0:
        raise ValueError(f"empty problem: N={N}, W={W}")
    args = (
        _check("norm", norm, (W, 4)), _check("scores", scores, (W, N)),
        _check("valid", valid, (N,)), _check("g", g, (N,)),
    )
    lib = _load()
    dev = scores.device
    with torch.cuda.device(dev):
        stream = _stream(scores)
        out = torch.empty((W, 4), dtype=torch.float32, device=dev)
        need = torch.empty((W, need_words(N)), dtype=torch.int32, device=dev)
        rc = _launch_reduced(lib.fv_bwd_stats, (*args, N, W, 1.0 - eps), W, dev, stream,
                             (out.data_ptr(), need.data_ptr(), stream))
    _raise_on(rc, "bwd_stats")
    LAUNCHES["bwd_stats"] += 1
    return out, need


def bwd_apply(wp, kp, norm2, pts_t, valid, g, scores, need, k):
    """K4: returns (W, 3, 4) camera-plane sums. ``need`` is K3's mask of the
    same scores, norm and valid: pairs whose bit is clear are not read."""
    N, W = _sizes(pts_t, wp)
    args = (
        _check("wp", wp, (W, 12)), _check("kp", kp, (4,)), _check("norm2", norm2, (W, 6)),
        _check("pts_t", pts_t, (3, N)), _check("valid", valid, (N,)),
        _check("g", g, (N,)), _check("scores", scores, (W, N)),
        _check("need", need, (W, need_words(N)), torch.int32),
    )
    lib = _load()
    dev = pts_t.device
    with torch.cuda.device(dev):
        stream = _stream(pts_t)
        out = torch.empty((W, 3, 4), dtype=torch.float32, device=dev)
        rc = _launch_reduced(lib.fv_bwd_apply, (*args, N, W, *_consts_args(k), 1.0 - k.eps), W,
                             dev, stream, (out.data_ptr(), stream))
    _raise_on(rc, "bwd_apply")
    LAUNCHES["bwd_apply"] += 1
    return out


def pass_a_minmax(wp, kp, pts_t, valid, k):
    """K1′: returns (m (W,), M (W,)); no score cache."""
    N, W = _sizes(pts_t, wp)
    args = (
        _check("pts_t", pts_t, (3, N)), _check("valid", valid, (N,)),
        _check("wp", wp, (W, 12)), _check("kp", kp, (4,)),
    )
    lib = _load()
    m, mx = _minmax_out(W, pts_t.device).unbind(0)
    with torch.cuda.device(pts_t.device):
        rc = lib.fv_pass_a_minmax(*args, N, W, *_consts_args(k), m.data_ptr(),
                                  mx.data_ptr(), _stream(pts_t))
    _raise_on(rc, "pass_a_minmax")
    LAUNCHES["pass_a_minmax"] += 1
    return m, mx


def expf_zero_check(device) -> tuple[int, int]:
    """The premise of pass A's exact-zero pruning, tried on the card: returns
    (the number of floats x ≤ −PRUNE_ZERO_T / 2, every bit pattern down to
    −inf; how many of them have expf(x) ≠ 0 in the kernels' build). Not a
    kernel of any path: it has no entry in ``LAUNCHES``."""
    lib = _load()
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    n = ctypes.c_ulonglong(0)
    with torch.cuda.device(device):
        rc = lib.fv_expf_zero_check(bad.data_ptr(), ctypes.addressof(n), _stream(bad))
    _raise_on(rc, "expf_zero_check")
    return int(n.value), int(bad.item())


def pass_b_recompute(wp, kp, norm, pts_t, k):
    """K2′: returns lo (N,), recomputing the scores."""
    N, W = _sizes(pts_t, wp)
    args = (
        _check("wp", wp, (W, 12)), _check("kp", kp, (4,)), _check("norm", norm, (W, 4)),
        _check("pts_t", pts_t, (3, N)),
    )
    lib = _load()
    lo = torch.empty((N,), dtype=torch.float32, device=pts_t.device)
    with torch.cuda.device(pts_t.device):
        rc = lib.fv_pass_b_recompute(*args, N, W, *_consts_args(k), 1.0 - k.eps,
                                     lo.data_ptr(), _stream(pts_t))
    _raise_on(rc, "pass_b_recompute")
    LAUNCHES["pass_b_recompute"] += 1
    return lo


def bwd_fused_acc(wp, kp, norm, pts_t, valid, g, k):
    """K5: returns the (W, 40) single-pass-backward sums."""
    N, W = _sizes(pts_t, wp)
    args = (
        _check("wp", wp, (W, 12)), _check("kp", kp, (4,)), _check("norm", norm, (W, 4)),
        _check("pts_t", pts_t, (3, N)), _check("valid", valid, (N,)), _check("g", g, (N,)),
    )
    lib = _load()
    part = torch.empty((_n_blocks(N), W, BWD_SLOTS), dtype=torch.float32, device=pts_t.device)
    with torch.cuda.device(pts_t.device):
        rc = lib.fv_bwd_fused_acc(*args, N, W, *_consts_args(k), 1.0 - k.eps,
                                  part.data_ptr(), _stream(pts_t))
    _raise_on(rc, "bwd_fused_acc")
    LAUNCHES["bwd_fused_acc"] += 1
    return torch.sum(part, dim=0)


def _splat_args(offsets, entries, tiles_y, tiles_x):
    n_tiles = tiles_y * tiles_x
    if n_tiles <= 0:
        raise ValueError(f"empty tile grid: {tiles_y} x {tiles_x}")
    if entries.dim() != 2:
        raise ValueError(f"entries: expected (M, 8), got {tuple(entries.shape)}")
    if offsets.device != entries.device:
        raise ValueError(f"offsets on {offsets.device}, entries on {entries.device}")
    args = (_check("offsets", offsets, (n_tiles + 1,), torch.int32),
            _check("entries", entries, (entries.shape[0], 8)))
    if args[1] % 16:
        raise ValueError("entries: rows are read as float4, the data must be 16-byte aligned")
    out = torch.empty((3, tiles_y * SPLAT_TILE_H, tiles_x * SPLAT_TILE_W), dtype=torch.float32,
                      device=entries.device)
    return args, out


def splat_runs(offsets, entries, tiles_y: int, tiles_x: int, bg: float):
    """K6: returns the planar image (3, Hp, Wp)."""
    args, out = _splat_args(offsets, entries, tiles_y, tiles_x)
    lib = _load()
    with torch.cuda.device(entries.device):
        rc = lib.sr_splat_runs(*args, tiles_y, tiles_x, bg, out.data_ptr(), _stream(entries))
    _raise_on(rc, "splat_runs")
    LAUNCHES["splat_runs"] += 1
    return out


def splat_dense(offsets, entries, max_e: int, tiles_y: int, tiles_x: int, bg: float):
    """K7: returns the planar image (3, Hp, Wp); tile t blends the first
    ``max_e`` entries of its run."""
    if max_e <= 0:
        raise ValueError(f"max_e must be positive, got {max_e}")
    args, out = _splat_args(offsets, entries, tiles_y, tiles_x)
    lib = _load()
    with torch.cuda.device(entries.device):
        rc = lib.sr_splat_dense(*args, max_e, tiles_y, tiles_x, bg, out.data_ptr(),
                                _stream(entries))
    _raise_on(rc, "splat_dense")
    LAUNCHES["splat_dense"] += 1
    return out


def splat_resident_blocks() -> dict:
    """{kernel: blocks of K6 / K7 that one SM holds at once}, as the CUDA
    runtime computes it from their registers and shared memory."""
    lib = _load()
    out = {}
    for name, dense in (("splat_runs", 0), ("splat_dense", 1)):
        n = lib.sr_resident_blocks(dense)
        _raise_on(-n if n < 0 else 0, f"{name} occupancy")
        out[name] = n
    return out
