"""Build, bind and launch the hand-written CUDA kernels of ``csrc/``.

``csrc/fused_vis.cu`` holds the seven kernels that replace the Pallas TPU
kernels of ``trajectory_optimization_tpu/ops/pallas_vis.py`` (plain versions
and dispatch: ``ops/fused_vis.py``); ``csrc/fused_traj.cu`` the six of the
trajectory loss around them, which replace none (``ops/fused_traj.py``);
``csrc/splat_render.cu`` the two that replace those of
``ops/pallas_render.py`` (``ops/tile_render.py``); ``csrc/soft_binned.cu``
the binned soft-HPR gate's tile reduction and its backward, and
``csrc/binned_layout.cu`` the same gate's layout (routing, sorts' layouts,
tile tables, row maxima) and its backward, which replace none
(``ops/hpr.py``). Every
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
``_minmax_out``, unless the caller hands in the preset that ``traj_head``
writes), launches on the current stream, raises if the
C entry point returns a CUDA error, and only then adds one to its entry in
``LAUNCHES``. K3, K4 and ``traj_loss`` finish their own partial sums in the
last block to arrive; the partials and the arrival counters, which the
kernels leave zeroed, live in a scratch that is made once per device and
stream (``_launch_reduced``).

Every wrapper can be recorded into a CUDA graph (``opt/graphs.py``): the
stream is read at call time, and the device state made on first use (pass
A's sentinels, the reduction scratch) must exist before a capture starts,
which the captured engine's eager first step on the capture stream sees to;
a wrapper that would have to make it while its stream captures raises. A
capture holds a reference to the scratch it recorded
(``reduction_scratch``) and takes back the counts its wrappers raised:
each replay adds them (``add_launches``).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import math
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
    "traj_head": 0, "make_norm": 0, "traj_loss": 0, "lo_cotangent": 0, "alpha_beta": 0,
    "traj_tail": 0, "soft_binned_fwd": 0, "soft_binned_bwd": 0,
    "binned_keys": 0, "binned_layout": 0, "binned_tables": 0, "binned_rowmax": 0,
    "binned_rowmax_bwd": 0, "binned_rows": 0, "binned_layout_bwd": 0,
}
LAYOUT_GRIDS = 4  # the binned tier's staggered grids (ops/hpr.py _binned_grids)

BWD_SLOTS = 40  # K5's sums per waypoint (the JAX twin's layout)
BIG = 3.0e38  # pass A's min of a waypoint without valid points; its max is −BIG

_lib = None
_sentinels = {}  # per device, the (2, 1) column [BIG, −BIG] that presets pass A's outputs
_reduction_scratch = {}  # per (device, stream), K3's and K4's (arrival counters, partial sums)
build_log = ""  # nvcc's output (ptxas register/spill report) of the library's build, per source


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def add_launches(counts) -> None:
    """Add ``counts`` ({kernel: launches}) to ``LAUNCHES``: a replayed
    graph's launches, which no wrapper sees."""
    for name, n in counts.items():
        LAUNCHES[name] += n


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def reduction_scratch(device, stream: int):
    """The (arrival counters, partial sums) K3 and K4 use on ``device`` and
    ``stream``, or None: a captured graph keeps this pair alive."""
    return _reduction_scratch.get((torch.device(device), stream))


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
    lib.ft_traj_head.argtypes = [P, P, P, I, I, F, P, P, P, P]
    lib.ft_make_norm.argtypes = [P, I, P, P]
    lib.ft_traj_loss.argtypes = [P, P, P, P, I, I, I] + [F] * 6 + [P, I, P, P, P, P, P]
    lib.ft_lo_cotangent.argtypes = [P] * 5 + [I, P, P]
    lib.ft_alpha_beta.argtypes = [P, P, I, P, P]
    lib.ft_traj_tail.argtypes = [P, I] + [P] * 6 + [I, I] + [F] * 6 + [P, P, P]
    lib.sb_fwd.argtypes = [I] + [P] * 6 + [I, I, I] + [P] * 4
    lib.sb_bwd.argtypes = [I] + [P] * 9 + [I, I, I] + [P] * 3
    lib.bl_keys.argtypes = [I] + [P] * 6 + [I, P, P]
    lib.bl_layout.argtypes = [I] + [P] * 5 + [I, I, I] + [P] * 9
    lib.bl_tables.argtypes = [P, P, I, I, I, P, P, P, P]
    lib.bl_rowmax.argtypes = [I] + [P] * 7 + [I, I, P, P, P]
    lib.bl_rowmax_bwd.argtypes = [I] + [P] * 9 + [I, I, P, P]
    lib.bl_rows.argtypes = [I] + [P] * 4 + [I, I, I, I, P, P, P]
    lib.bl_layout_bwd.argtypes = [I] + [P] * 5 + [I, P, P, P]
    lib.sr_splat_runs.argtypes = [P, P, I, I, F, P, P]
    lib.sr_splat_dense.argtypes = [P, P, I, I, I, F, P, P]
    for fn in (lib.fv_pass_a, lib.fv_pass_b, lib.fv_bwd_stats, lib.fv_bwd_apply,
               lib.fv_pass_a_minmax, lib.fv_pass_b_recompute, lib.fv_bwd_fused_acc,
               lib.sr_splat_runs, lib.sr_splat_dense, lib.sr_tile_h, lib.sr_tile_w,
               lib.sr_band_w, lib.sr_resident_blocks, lib.ft_traj_head, lib.ft_make_norm,
               lib.ft_traj_loss, lib.ft_lo_cotangent, lib.ft_alpha_beta, lib.ft_traj_tail,
               lib.sb_fwd, lib.sb_bwd, lib.bl_keys, lib.bl_layout, lib.bl_tables, lib.bl_rowmax,
               lib.bl_rowmax_bwd, lib.bl_rows, lib.bl_layout_bwd):
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
        if _capturing():  # a host-to-device copy: illegal while the stream captures
            raise RuntimeError("pass A's sentinels must be made before a CUDA graph capture: "
                               "run the step once eagerly first")
        col = _sentinels[device] = torch.tensor([[BIG], [-BIG]], dtype=torch.float32,
                                                device=device)
    return col.repeat(1, W)  # always a copy (expand().contiguous() is col itself at W = 1)


def _preset(minmax, W: int, device) -> torch.Tensor:
    """Pass A's (2, W) output: ``minmax`` as given (preset to the sentinels by
    ``traj_head``) or a new preset one."""
    if minmax is None:
        return _minmax_out(W, device)
    _check("minmax", minmax, (2, W))
    return minmax


def pass_a(wp, kp, pts_t, valid, k, minmax=None):
    """K1: returns (m (W,), M (W,), scores (W, N)); m and M are the rows of
    ``minmax`` where given."""
    N, W = _sizes(pts_t, wp)
    args = (
        _check("pts_t", pts_t, (3, N)), _check("valid", valid, (N,)),
        _check("wp", wp, (W, 12)), _check("kp", kp, (4,)),
    )
    lib = _load()
    cache = torch.empty((W, N), dtype=torch.float32, device=pts_t.device)
    m, mx = _preset(minmax, W, pts_t.device).unbind(0)
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
    stream run one after the other, so they share the scratch. A larger
    problem replaces the pair (a graph captured with the old one keeps
    it); while the stream captures, the pair must already fit."""
    arrivals, part = _reduction_scratch.get((device, stream), (None, None))
    if arrivals is None or arrivals.numel() < W:
        _no_growth_in_capture()
        arrivals = torch.zeros(max(W, 4096), dtype=torch.int32, device=device)
    if part is None:
        part = torch.empty(0, dtype=torch.float64, device=device)
    while (rc := fn(*args, part.data_ptr(), part.numel(), arrivals.data_ptr(), *tail)) < 0:
        _no_growth_in_capture()
        part = torch.empty(-rc, dtype=torch.float64, device=device)
    _reduction_scratch[(device, stream)] = (arrivals, part)
    return rc


def _no_growth_in_capture() -> None:
    # arrival counters zeroed inside a capture would be zeroed only at
    # replay, and an eager call could meet them before that
    if _capturing():
        raise RuntimeError("the K3/K4 scratch must be sized before a CUDA graph capture: run "
                           "the step once eagerly on the capture stream first")


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


def pass_a_minmax(wp, kp, pts_t, valid, k, minmax=None):
    """K1′: returns (m (W,), M (W,)); no score cache. m and M are the rows of
    ``minmax`` where given."""
    N, W = _sizes(pts_t, wp)
    args = (
        _check("pts_t", pts_t, (3, N)), _check("valid", valid, (N,)),
        _check("wp", wp, (W, 12)), _check("kp", kp, (4,)),
    )
    lib = _load()
    m, mx = _preset(minmax, W, pts_t.device).unbind(0)
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


# ---- the trajectory loss around the visibility kernels (csrc/fused_traj.cu)

def _crit_args(c):
    """The kernels' criterion scalars from a ``fused_traj.TrajConsts``: the
    acos gradient's window and π, rounded to f32 by ctypes."""
    return (c.eps, c.smoothness_weight, c.length_weight, -1.0 + c.angle_margin,
            1.0 - c.angle_margin, math.pi)


def traj_head(poses, quats, K, step: int):
    """traj_head: returns (wp (W_s, 12), kp (4,), pass A's (2, W_s) output
    preset to its sentinels), W_s = ceil(W / step)."""
    W = poses.shape[0]
    if W == 0 or step < 1:
        raise ValueError(f"empty path or bad stride: W={W}, step={step}")
    W_s = -(-W // step)
    args = (_check("poses", poses, (W, 3)), _check("quats", quats, (W, 4)),
            _check("K", K, (3, 3)))
    lib = _load()
    dev = poses.device
    wp = torch.empty((W_s, 12), dtype=torch.float32, device=dev)
    kp = torch.empty((4,), dtype=torch.float32, device=dev)
    minmax = torch.empty((2, W_s), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ft_traj_head(*args, W_s, step, BIG, wp.data_ptr(), kp.data_ptr(),
                              minmax.data_ptr(), _stream(poses))
    _raise_on(rc, "traj_head")
    LAUNCHES["traj_head"] += 1
    return wp, kp, minmax


def make_norm(minmax):
    """make_norm: (2, W) min/max → norm (W, 4)."""
    W = minmax.shape[1]
    arg = _check("minmax", minmax, (2, W))
    lib = _load()
    norm = torch.empty((W, 4), dtype=torch.float32, device=minmax.device)
    with torch.cuda.device(minmax.device):
        rc = lib.ft_make_norm(arg, W, norm.data_ptr(), _stream(minmax))
    _raise_on(rc, "make_norm")
    LAUNCHES["make_norm"] += 1
    return norm


def traj_loss(lo, valid, poses, poses0, c):
    """traj_loss: returns (loss (), aux (8,), rewards (N,))."""
    N, W = lo.shape[0], poses.shape[0]
    if N == 0 or W == 0:
        raise ValueError(f"empty problem: N={N}, W={W}")
    args = (_check("lo", lo, (N,)), _check("valid", valid, (N,)),
            _check("poses", poses, (W, 3)), _check("poses0", poses0, (W, 3)))
    lib = _load()
    dev = lo.device
    with torch.cuda.device(dev):
        stream = _stream(lo)
        rewards = torch.empty((N,), dtype=torch.float32, device=dev)
        loss = torch.empty((), dtype=torch.float32, device=dev)
        aux = torch.empty((8,), dtype=torch.float32, device=dev)
        rc = _launch_reduced(lib.ft_traj_loss, (*args, N, W, c.wps_step, *_crit_args(c)), 1,
                             dev, stream, (rewards.data_ptr(), loss.data_ptr(), aux.data_ptr(),
                                           stream))
    _raise_on(rc, "traj_loss")
    LAUNCHES["traj_loss"] += 1
    return loss, aux, rewards


def lo_cotangent(g_loss, lo, rewards, valid, aux):
    """lo_cotangent: returns g (N,), the loss's cotangent on lo."""
    N = lo.shape[0]
    args = (_check("g_loss", g_loss, ()), _check("lo", lo, (N,)),
            _check("rewards", rewards, (N,)), _check("valid", valid, (N,)),
            _check("aux", aux, (8,)))
    lib = _load()
    g = torch.empty((N,), dtype=torch.float32, device=lo.device)
    with torch.cuda.device(lo.device):
        rc = lib.ft_lo_cotangent(*args, N, g.data_ptr(), _stream(lo))
    _raise_on(rc, "lo_cotangent")
    LAUNCHES["lo_cotangent"] += 1
    return g


def alpha_beta(stats, norm):
    """alpha_beta: K3's (W, 4) table and norm (W, 4) → norm2 (W, 6)."""
    W = norm.shape[0]
    args = (_check("stats", stats, (W, 4)), _check("norm", norm, (W, 4)))
    lib = _load()
    norm2 = torch.empty((W, 6), dtype=torch.float32, device=norm.device)
    with torch.cuda.device(norm.device):
        rc = lib.ft_alpha_beta(*args, W, norm2.data_ptr(), _stream(norm))
    _raise_on(rc, "alpha_beta")
    LAUNCHES["alpha_beta"] += 1
    return norm2


def traj_tail(sums, wp, quats, poses, poses0, aux, g_loss, c):
    """traj_tail: K4's (W_s, 3, 4) sums or K5's (W_s, 40) accumulator →
    (∂poses (W, 3), ∂quats (W, 4))."""
    W_s, W = wp.shape[0], poses.shape[0]
    if W_s != -(-W // c.wps_step):
        raise ValueError(f"wp: {W_s} rows for {W} waypoints at stride {c.wps_step}")
    slots = BWD_SLOTS if sums.dim() == 2 else 12
    args = (_check("sums", sums, (W_s, BWD_SLOTS) if slots == BWD_SLOTS else (W_s, 3, 4)), slots,
            _check("wp", wp, (W_s, 12)), _check("quats", quats, (W, 4)),
            _check("poses", poses, (W, 3)), _check("poses0", poses0, (W, 3)),
            _check("aux", aux, (8,)), _check("g_loss", g_loss, ()))
    lib = _load()
    dev = wp.device
    g_poses = torch.empty((W, 3), dtype=torch.float32, device=dev)
    g_quats = torch.empty((W, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ft_traj_tail(*args, W, c.wps_step, *_crit_args(c), g_poses.data_ptr(),
                              g_quats.data_ptr(), _stream(wp))
    _raise_on(rc, "traj_tail")
    LAUNCHES["traj_tail"] += 1
    return g_poses, g_quats


# ---- the binned soft-HPR gate's tiles (csrc/soft_binned.cu)

def _binned_args(U, R, beta, bin_s, cov_pos, tiles, cap: int):
    """The checked pointers and sizes of ``soft_binned_fwd``/``_bwd``: U
    (n or 2n, 3), R and beta of one float dtype, 2n rows exactly where the
    stratified layout's ``cov_pos`` (n,) int64 is given; ``bin_s`` (n,)
    int32; ``tiles`` (T, 4) int64; 1 <= cap <= n. float64 as well as
    float32: the card's float64 steps that hold the gate's float32 ones
    (``chip_smoke.py``) run the gate too."""
    n, T = bin_s.shape[0], tiles.shape[0]
    if U.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"U: expected float32 or float64, got {U.dtype}")
    if T == 0 or not 1 <= cap <= n:
        raise ValueError(f"empty tile table or bad cap: T={T}, cap={cap}, n={n}")
    rows = n if cov_pos is None else 2 * n
    args = (
        _check("U", U, (rows, 3), U.dtype), _check("R", R, (rows,), U.dtype),
        _check("beta", beta, (), U.dtype), _check("bin_s", bin_s, (n,), torch.int32),
        None if cov_pos is None else _check("cov_pos", cov_pos, (n,), torch.int64),
        _check("tiles", tiles, (T, 4), torch.int64),
    )
    return int(U.dtype == torch.float64), args, n, T


def soft_binned_fwd(U, R, beta, bin_s, cov_pos, tiles, cap: int):
    """soft_binned_fwd: returns (top, total, lse), each (T, cap), of one
    grid's tiles (``ops.hpr.binned_lse_ref``'s top and total on the rows
    the gate reads)."""
    dp, args, n, T = _binned_args(U, R, beta, bin_s, cov_pos, tiles, cap)
    lib = _load()
    top, total, lse = (torch.empty((T, cap), dtype=U.dtype, device=U.device) for _ in range(3))
    with torch.cuda.device(U.device):
        rc = lib.sb_fwd(dp, *args, n, T, cap, top.data_ptr(), total.data_ptr(), lse.data_ptr(),
                        _stream(U))
    _raise_on(rc, "soft_binned_fwd")
    LAUNCHES["soft_binned_fwd"] += 1
    return top, total, lse


def soft_binned_bwd(U, R, beta, bin_s, cov_pos, tiles, top, total, g, cap: int):
    """soft_binned_bwd: returns the partial sums (part_u (2 T cap, 3),
    part_r (T cap,)) that ``ops.hpr.add_rows`` adds into dU (every tile's
    query rows, then its coverer rows) and dR (the coverer rows), for the
    cotangent ``g`` of lse."""
    dp, args, n, T = _binned_args(U, R, beta, bin_s, cov_pos, tiles, cap)
    saved = (_check("top", top, (T, cap), U.dtype), _check("total", total, (T, cap), U.dtype),
             _check("g", g, (T, cap), U.dtype))
    lib = _load()
    part_u = torch.empty((2 * T * cap, 3), dtype=U.dtype, device=U.device)
    part_r = torch.empty((T * cap,), dtype=U.dtype, device=U.device)
    with torch.cuda.device(U.device):
        rc = lib.sb_bwd(dp, *args, *saved, n, T, cap, part_u.data_ptr(), part_r.data_ptr(),
                        _stream(U))
    _raise_on(rc, "soft_binned_bwd")
    LAUNCHES["soft_binned_bwd"] += 1
    return part_u, part_r



# ---- the binned soft-HPR gate's layout (csrc/binned_layout.cu)

class GridSpec(ctypes.Structure):
    """One grid of the binned layout as ``csrc/binned_layout.cu`` reads it:
    its rings and bins, the key's fraction bits, whether the stratified
    layout is built, where its ring tables start in the int32 table, its
    first slot and slots in the tile table, and its float32 cell size and
    shifts."""
    _fields_ = ([(k, ctypes.c_int) for k in ("n_rings", "n_bins", "frac_bits", "strat", "table",
                                             "tiles", "n_tiles")]
                + [(k, ctypes.c_float) for k in ("delta", "lat_shift", "az_shift")])


def grid_specs(grids) -> ctypes.Array:
    """The ``LAYOUT_GRIDS`` GridSpecs of a layout from one tuple per grid,
    in ``GridSpec``'s field order."""
    if len(grids) != LAYOUT_GRIDS:
        raise ValueError(f"the binned layout takes {LAYOUT_GRIDS} grids, got {len(grids)}")
    return (GridSpec * LAYOUT_GRIDS)(*(GridSpec(*g) for g in grids))


def _layout_sizes(specs):
    """(total slots, largest n_bins + 1) of ``specs``."""
    return (sum(g.n_tiles for g in specs), max(g.n_bins for g in specs) + 1)


def _float_kind(name: str, t: torch.Tensor) -> int:
    if t.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: expected float32 or float64, got {t.dtype}")
    return int(t.dtype == torch.float64)


def _pointers(ts) -> ctypes.Array:
    """A host array of the four grids' device addresses (0 for None)."""
    return (ctypes.c_void_p * LAYOUT_GRIDS)(*(0 if t is None else t.data_ptr() for t in ts))


def _launch_layout(name: str, fn, *args) -> None:
    _raise_on(fn(*args), name)
    LAUNCHES[name] += 1


def binned_keys(u, norms, scale, valid, table, specs):
    """binned_keys: the (4 N,) int32 sort keys of the four grids, grid g's
    (``ops.hpr._grid_bin_key``'s on ``ops.hpr._direction_angles(u)``)
    shifted by (g − 2)·2^30, from the (N, 3) unit directions, the norms and
    the scale (a 0-dim tensor) of one float dtype, ``valid`` (N,) bool or
    None and the grids' int32 ring tables."""
    n = u.shape[0]
    dt = u.dtype
    dp = _float_kind("u", u)
    args = (_check("u", u, (n, 3), dt), _check("norms", norms, (n,), dt),
            _check("scale", scale, (), dt),
            None if valid is None else _check("valid", valid, (n,), torch.bool),
            _check("table", table, table.shape, torch.int32))
    lib = _load()
    keys = torch.empty((LAYOUT_GRIDS * n,), dtype=torch.int32, device=u.device)
    with torch.cuda.device(u.device):
        _launch_layout("binned_keys", lib.bl_keys, dp, *args, ctypes.addressof(specs), n,
                       keys.data_ptr(), _stream(u))
    return keys


def binned_layout(keys_s, order, u, rho, specs, cap: int):
    """binned_layout: from the stably sorted keys and their order (a sort of
    ``binned_keys``'s), each grid's table ``U`` (rows, 3) and ``R`` (rows,)
    (rows = 2 N where the grid's stratified layout is built, else N) and the
    (4, N) layouts: ``bin_s`` int32, ``cov_pos`` int64 (the stratified rows'
    layout-sort rows; only where built), ``perm`` (sorted row → point),
    ``pos_a`` and ``pos_b`` (point → row of each layout), int32; and the
    (4, n_bins + 1) bin edges (``searchsorted``'s)."""
    n = u.shape[0]
    dt = u.dtype
    dp = _float_kind("u", u)
    if not 1 <= cap <= n:
        raise ValueError(f"bad cap: cap={cap}, n={n}")
    _, n_edges = _layout_sizes(specs)
    args = (_check("keys_s", keys_s, (LAYOUT_GRIDS * n,), torch.int32),
            _check("order", order, (LAYOUT_GRIDS * n,), torch.int64),
            _check("u", u, (n, 3), dt), _check("rho", rho, (n,), dt))
    dev = u.device
    U = [torch.empty(((2 if g.strat else 1) * n, 3), dtype=dt, device=dev) for g in specs]
    R = [torch.empty((t.shape[0],), dtype=dt, device=dev) for t in U]
    bin_s, perm, pos_a, pos_b = (torch.empty((LAYOUT_GRIDS, n), dtype=torch.int32, device=dev)
                                 for _ in range(4))
    cov_pos = torch.empty((LAYOUT_GRIDS, n), dtype=torch.int64, device=dev)
    edges = torch.empty((LAYOUT_GRIDS, n_edges), dtype=torch.int32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        _launch_layout("binned_layout", lib.bl_layout, dp, *args, ctypes.addressof(specs), n,
                       cap, n_edges, _pointers(U), _pointers(R), bin_s.data_ptr(),
                       edges.data_ptr(), cov_pos.data_ptr(), perm.data_ptr(), pos_a.data_ptr(),
                       pos_b.data_ptr(), _stream(u))
    return U, R, bin_s, edges, cov_pos, perm, pos_a, pos_b


def binned_tables(edges, specs, n: int, cap: int):
    """binned_tables: every grid's static tile table, one (Σ n_tiles, 4)
    int64 table of rows (bin, query offset, coverer offset, deep), grid by
    grid, and its (Σ n_tiles,) bool mask of real tiles, from
    ``binned_layout``'s bin edges."""
    total, n_edges = _layout_sizes(specs)
    if not 1 <= cap <= n:
        raise ValueError(f"bad cap: cap={cap}, n={n}")
    args = (_check("edges", edges, (LAYOUT_GRIDS, n_edges), torch.int32),)
    dev = edges.device
    cum = torch.empty((LAYOUT_GRIDS, n_edges), dtype=torch.int32, device=dev)
    tiles = torch.empty((total, 4), dtype=torch.int64, device=dev)
    tile_ok = torch.empty((total,), dtype=torch.bool, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        _launch_layout("binned_tables", lib.bl_tables, *args, ctypes.addressof(specs), n, cap,
                       n_edges, cum.data_ptr(), tiles.data_ptr(), tile_ok.data_ptr(),
                       _stream(edges))
    return tiles, tile_ok


def _rowmax_args(lses, beta, bin_s, rows, tiles, tile_ok, specs, cap: int):
    n = bin_s.shape[1]
    total, _ = _layout_sizes(specs)
    dt = beta.dtype
    dp = _float_kind("beta", beta)
    for g, (lse, spec) in enumerate(zip(lses, specs)):
        _check(f"lse[{g}]", lse, (spec.n_tiles, cap), dt)
    args = (_check("beta", beta, (), dt), _check("bin_s", bin_s, (LAYOUT_GRIDS, n), torch.int32),
            _check("rows", rows, (LAYOUT_GRIDS, n), torch.int32),
            _check("tiles", tiles, (total, 4), torch.int64),
            _check("tile_ok", tile_ok, (total,), torch.bool))
    return dp, args, n, total


def binned_rowmax(lses, beta, bin_s, pos_a, tiles, tile_ok, specs, cap: int):
    """binned_rowmax: (smax (N,), up (4, N)): each grid's row maximum of
    lse / β at each point, over the real tiles whose query rows hold it
    (−1e30 where none does), and their maximum over the grids, from the
    four grids' (n_tiles, cap) lse and ``binned_layout``'s layouts."""
    dp, args, n, _ = _rowmax_args(lses, beta, bin_s, pos_a, tiles, tile_ok, specs, cap)
    dev = beta.device
    up = torch.empty((LAYOUT_GRIDS, n), dtype=beta.dtype, device=dev)
    smax = torch.empty((n,), dtype=beta.dtype, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        _launch_layout("binned_rowmax", lib.bl_rowmax, dp, _pointers(lses), *args,
                       ctypes.addressof(specs), n, cap, up.data_ptr(), smax.data_ptr(),
                       _stream(beta))
    return smax, up


def binned_rowmax_bwd(g_smax, lses, beta, bin_s, perm, up, tiles, tile_ok, specs, cap: int):
    """binned_rowmax_bwd: the cotangent of every grid's lse for smax's
    ``g_smax``, the four grids' (n_tiles, cap) blocks one after the other in
    a (Σ n_tiles · cap,) tensor."""
    dp, args, n, total = _rowmax_args(lses, beta, bin_s, perm, tiles, tile_ok, specs, cap)
    dt = beta.dtype
    args = (_check("g_smax", g_smax, (n,), dt), _pointers(lses), args[0], args[1], args[2],
            _check("up", up, (LAYOUT_GRIDS, n), dt), *args[3:])
    g_lse = torch.empty((total * cap,), dtype=dt, device=beta.device)
    lib = _load()
    with torch.cuda.device(beta.device):
        _launch_layout("binned_rowmax_bwd", lib.bl_rowmax_bwd, dp, *args,
                       ctypes.addressof(specs), n, cap, g_lse.data_ptr(), _stream(beta))
    return g_lse


def binned_rows(part_u, part_r, bin_s, tiles, cap: int, rows: int):
    """binned_rows: one grid's (dU (rows, 3), dR (rows,)) from
    ``soft_binned_bwd``'s partial sums: each row of the table takes the
    partials of the tiles of its bin that hold it, query partials first,
    then coverer partials, each in tile order."""
    n, T = bin_s.shape[0], tiles.shape[0]
    dt = part_u.dtype
    dp = _float_kind("part_u", part_u)
    if rows not in (n, 2 * n) or not 1 <= cap <= n:
        raise ValueError(f"bad table: rows={rows}, cap={cap}, n={n}")
    args = (_check("part_u", part_u, (2 * T * cap, 3), dt),
            _check("part_r", part_r, (T * cap,), dt), _check("bin_s", bin_s, (n,), torch.int32),
            _check("tiles", tiles, (T, 4), torch.int64))
    dU = torch.empty((rows, 3), dtype=dt, device=part_u.device)
    dR = torch.empty((rows,), dtype=dt, device=part_u.device)
    lib = _load()
    with torch.cuda.device(part_u.device):
        _launch_layout("binned_rows", lib.bl_rows, dp, *args, n, T, cap, rows, dU.data_ptr(),
                       dR.data_ptr(), _stream(part_u))
    return dU, dR


def binned_layout_bwd(dU, dR, pos_a, pos_b, specs, dtype):
    """binned_layout_bwd: (du (N, 3), drho (N,)) from the cotangents of the
    four grids' tables (``binned_layout``'s U and R; None for none): each
    point's rows of every grid, both layouts, added in a fixed order."""
    n = pos_a.shape[1]
    for g, spec in enumerate(specs):
        rows = (2 if spec.strat else 1) * n
        if dU[g] is not None:
            _check(f"dU[{g}]", dU[g], (rows, 3), dtype)
        if dR[g] is not None:
            _check(f"dR[{g}]", dR[g], (rows,), dtype)
    dev = pos_a.device
    args = (_check("pos_a", pos_a, (LAYOUT_GRIDS, n), torch.int32),
            _check("pos_b", pos_b, (LAYOUT_GRIDS, n), torch.int32))
    du = torch.empty((n, 3), dtype=dtype, device=dev)
    drho = torch.empty((n,), dtype=dtype, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        _launch_layout("binned_layout_bwd", lib.bl_layout_bwd, int(dtype == torch.float64),
                       _pointers(dU), _pointers(dR), *args, ctypes.addressof(specs), n,
                       du.data_ptr(), drho.data_ptr(), _stream(pos_a))
    return du, drho

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
