#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``trajectory_optimization_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):

1. device — needs CUDA; prints ``nvidia-smi`` name and power limit; TF32 off.
2. build — compiles ``csrc/fused_vis.cu`` with nvcc for sm_90a.
3. kernels — K1–K4 against their plain PyTorch versions on the card, stage
   by stage, and the whole ``fused_lo_sum`` forward and gradient against the
   plain autodiff path, at the reference workload (cloud 10 padded to
   40,960 points, 14 selected waypoints) and at 1,048,576 points × 50
   waypoints (seeded synthetic cloud).
4. slice — ``TrajectoryOptimizer.optimize`` on cloud 10 for 400 steps through
   the kernels (launch counters reset just before, read just after), the
   same run on the plain backend, and 20 steps of 1M × 50.
5. times — per-stage and per-step ms, kernel and plain, and peak memory.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = "trajectory_optimization_tpu_torch/csrc/fused_vis.cu"
REPLACES = {
    "pass_a": "trajectory_optimization_tpu/ops/pallas_vis.py:228",
    "pass_b": "trajectory_optimization_tpu/ops/pallas_vis.py:264",
    "bwd_stats": "trajectory_optimization_tpu/ops/pallas_vis.py:288",
    "bwd_apply": "trajectory_optimization_tpu/ops/pallas_vis.py:320",
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def main() -> int:
    if not (ROOT / "trajectory_optimization_tpu_torch").is_dir():
        fail(f"the port's package is not beside this script in {ROOT}")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from trajectory_optimization_tpu_torch.api import TrajectoryOptimizer
    from trajectory_optimization_tpu_torch.models.traj import (
        TrajProblem, init_traj_params, traj_criterion, traj_forward, waypoint_stride,
    )
    from trajectory_optimization_tpu_torch.ops import _kernels
    from trajectory_optimization_tpu_torch.ops import fused_vis as fv
    from trajectory_optimization_tpu_torch.ops import quat as quat_ops
    from trajectory_optimization_tpu_torch.opt.engine import NEVER, OptimizerConfig, run_until_done
    from trajectory_optimization_tpu_torch.utils.data import (
        identity_quaternions, load_path, load_point_cloud, pad_points,
    )
    from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics

    # ---- 1. device ---------------------------------------------------------
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _kernels.build()
    _kernels._load()
    print(f"[build] {SOURCE} -> sm_90a in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in _kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", file=sys.stderr)

    intr = default_intrinsics()
    K = intr.matrix(device=dev)
    cfg = OptimizerConfig(lr_pose=0.1, lr_quat=0.02)

    def sync():
        torch.cuda.synchronize()

    def cuda_ms(fn, reps):
        fn()
        sync()
        times = []
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            sync()
            times.append(a.elapsed_time(b) / reps)
        return statistics.median(times)

    def close(name, got, want, rtol, atol):
        sync()
        err = (got.double() - want.double()).abs()
        bound = atol + rtol * want.double().abs()
        if not bool(torch.isfinite(got).all()):
            fail(f"{name}: non-finite kernel output")
        if bool((err > bound).any()):
            i = int(torch.argmax(err - bound))
            fail(f"{name}: max |err| {float(err.max()):.3e} over rtol {rtol} / atol {atol} "
                 f"(at flat {i}: got {float(got.flatten()[i]):.6e}, want {float(want.flatten()[i]):.6e})")
        return float(err.max())

    # ---- shapes --------------------------------------------------------------
    cloud10 = load_point_cloud(str(ROOT / "data/points/point_cloud_10.npz"))
    path10 = load_path(str(ROOT / "data/paths/path_poses_10.npz"))
    rng = np.random.default_rng(0)
    big_pts = rng.uniform(-20, 20, size=(1_048_576, 3)).astype(np.float32)
    t = np.linspace(0, 1, 50, dtype=np.float32)
    big_path = np.stack([30 * t, 10 * np.sin(4 * t), np.zeros_like(t)], axis=1).astype(np.float32)

    def shape_case(name, pts, path):
        padded, valid = pad_points(pts)
        stride = waypoint_stride(path, 0.5)
        q = identity_quaternions(len(path))
        q[::3] = [0.9, 0.1, -0.3, 0.2]  # rotate some waypoints so scores differ per waypoint
        P = torch.as_tensor(padded, device=dev)
        return dict(
            name=name, P=P, Pt=P.t().contiguous(), V=torch.as_tensor(valid, device=dev),
            path=torch.as_tensor(path, device=dev), quats=torch.as_tensor(q, device=dev),
            problem=TrajProblem(intr.width, intr.height, wps_step=stride),
            stride=stride,
        )

    cases = [shape_case("ref", cloud10, path10), shape_case("1m50", big_pts, big_path)]
    errs = {k: 0.0 for k in REPLACES}
    stage_ms = {}

    # ---- 3. kernels against their plain versions ---------------------------
    for c in cases:
        prob, sel = c["problem"], slice(None, None, c["stride"])
        quats, trans = c["quats"][sel].contiguous(), c["path"][sel].contiguous()
        W, N = quats.shape[0], c["P"].shape[0]
        k = fv.make_consts(intr.width, intr.height, prob.min_dist, prob.max_dist, prob.eps)
        R = quat_ops.to_matrix(quat_ops.normalize(quats))
        wp = torch.cat([R.reshape(W, 9), trans], dim=1).contiguous()
        kp = torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).contiguous()
        Pt, V = c["Pt"], c["V"]

        # K1: min/max rtol 1e-5 (atol 1e-30 only absorbs denormal quantization
        # of far-point minima); cache rtol 1e-5 / atol 1e-7.
        m, mx, cache = _kernels.pass_a(wp, kp, Pt, V, k)
        m_r, mx_r, cache_r = fv.pass_a_ref(wp, kp, Pt, V, k)
        e1 = close(f"K1 min {c['name']}", m, m_r, 1e-5, 1e-30)
        e1 = max(e1, close(f"K1 max {c['name']}", mx, mx_r, 1e-5, 1e-30))
        e1 = max(e1, close(f"K1 cache {c['name']}", cache, cache_r, 1e-5, 1e-7))
        errs["pass_a"] = max(errs["pass_a"], e1)
        del cache_r

        # K2..K4 get identical inputs (the kernel's own cache and norm) so each
        # comparison isolates one kernel. K2: rtol 1e-4 / atol 2e-4.
        norm = fv.make_norm(m, mx)
        lo = _kernels.pass_b(norm, cache, prob.eps)
        errs["pass_b"] = max(errs["pass_b"], close(
            f"K2 lo {c['name']}", lo, fv.pass_b_ref(norm, cache, prob.eps), 1e-4, 2e-4))

        # the main path's own cotangent for lo: d loss / d lo through the criterion
        lo_leaf = lo.detach().requires_grad_(True)
        params = {"poses": c["path"], "quats": c["quats"]}
        loss, _ = traj_criterion(lo_leaf, params, c["path"], prob, valid=V)
        (g,) = torch.autograd.grad(loss, lo_leaf)
        g = g.contiguous()

        # K3: sums rtol 2e-3 / atol 2e-3; tie counts exact (same cache, same norm).
        st = _kernels.bwd_stats(norm, cache, V, g, prob.eps)
        st_r = fv.bwd_stats_ref(norm, cache, V, g, prob.eps)
        e3 = close(f"K3 sums {c['name']}", st[:, :2], st_r[:, :2], 2e-3, 2e-3)
        if not torch.equal(st[:, 2:], st_r[:, 2:]):
            fail(f"K3 tie counts {c['name']}: {st[:, 2:].tolist()} vs {st_r[:, 2:].tolist()}")
        errs["bwd_stats"] = max(errs["bwd_stats"], e3)

        alpha = st[:, 0] / torch.clamp(st[:, 2], min=1.0)
        beta = st[:, 1] / torch.clamp(st[:, 3], min=1.0)
        norm2 = torch.cat([norm, alpha[:, None], beta[:, None]], dim=1).contiguous()
        # K4: sums rtol 2e-3 / atol 2e-3.
        sums = _kernels.bwd_apply(wp, kp, norm2, Pt, V, g, cache, k)
        sums_r = fv.bwd_apply_ref(wp, kp, norm2, Pt, V, g, cache, k)
        errs["bwd_apply"] = max(errs["bwd_apply"], close(
            f"K4 sums {c['name']}", sums, sums_r, 2e-3, 2e-3))

        # the whole fused_lo_sum against the plain autodiff path: forward
        # rtol 1e-4 / atol 2e-4, gradient w.r.t. quats and trans rtol 2e-3 / atol 2e-3
        grads = {}
        for backend in ("kernel", "torch"):
            q_leaf = quats.clone().requires_grad_(True)
            t_leaf = trans.clone().requires_grad_(True)
            if backend == "kernel":
                lo_b = fv.fused_lo_sum(c["P"], q_leaf, t_leaf, K, intr.width, intr.height,
                                       valid=V, points_t=Pt)
            else:
                from trajectory_optimization_tpu_torch.models.traj import observation_logodds
                from trajectory_optimization_tpu_torch.ops.scores import waypoint_scores

                s = waypoint_scores(c["P"], q_leaf, t_leaf, K, intr.width, intr.height)
                lo_b = torch.sum(observation_logodds(s, prob.eps, V), dim=0)
            gq, gt = torch.autograd.grad(torch.sum(lo_b * g), (q_leaf, t_leaf))
            grads[backend] = (lo_b.detach(), gq, gt)
        close(f"fused_lo_sum forward {c['name']}", grads["kernel"][0], grads["torch"][0], 1e-4, 2e-4)
        close(f"fused_lo_sum d/dquats {c['name']}", grads["kernel"][1], grads["torch"][1], 2e-3, 2e-3)
        close(f"fused_lo_sum d/dtrans {c['name']}", grads["kernel"][2], grads["torch"][2], 2e-3, 2e-3)
        del grads

        # per-stage times (printed, never asserted)
        reps = 50 if c["name"] == "ref" else 10
        stage_ms[c["name"]] = {
            "pass_a": (cuda_ms(lambda: _kernels.pass_a(wp, kp, Pt, V, k), reps),
                       cuda_ms(lambda: fv.pass_a_ref(wp, kp, Pt, V, k), reps)),
            "pass_b": (cuda_ms(lambda: _kernels.pass_b(norm, cache, prob.eps), reps),
                       cuda_ms(lambda: fv.pass_b_ref(norm, cache, prob.eps), reps)),
            "bwd_stats": (cuda_ms(lambda: _kernels.bwd_stats(norm, cache, V, g, prob.eps), reps),
                          cuda_ms(lambda: fv.bwd_stats_ref(norm, cache, V, g, prob.eps), reps)),
            "bwd_apply": (cuda_ms(lambda: _kernels.bwd_apply(wp, kp, norm2, Pt, V, g, cache, k), reps),
                          cuda_ms(lambda: fv.bwd_apply_ref(wp, kp, norm2, Pt, V, g, cache, k), reps)),
        }
        print(f"[kernels] {c['name']} N={N} W={W}: K1-K4 and fused_lo_sum match their plain "
              f"versions; max|err| " + ", ".join(f"{n}={v:.2e}" for n, v in errs.items()), flush=True)
        del cache
        torch.cuda.empty_cache()

    # ---- 4. the slice: 400 steps of cloud 10 through the kernels ------------
    opt = TrajectoryOptimizer(lr_pose=0.1, lr_quat=0.02, device=dev)
    sync()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    res_k = opt.optimize(cloud10, path10, n_steps=400)
    sync()
    slice_s = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    if not all(launches[n] > 0 for n in REPLACES):
        fail(f"a kernel of the main path was never launched: {launches}")
    if not (np.all(np.isfinite(res_k.poses)) and res_k.poses.shape == path10.shape
            and res_k.rewards.shape == (len(cloud10),)):
        fail("the optimized trajectory is malformed or not finite")
    if res_k.n_iters != 400:
        fail(f"expected 400 steps without early stop, got {res_k.n_iters}")
    if not (res_k.visibility_gain >= 1.1 and res_k.smoothness_gain >= 0.9):
        fail(f"unhealthy result: visibility gain {res_k.visibility_gain:.4f} (need >= 1.1), "
             f"smoothness gain {res_k.smoothness_gain:.4f} (need >= 0.9)")
    res_t = TrajectoryOptimizer(lr_pose=0.1, lr_quat=0.02, backend="torch", device=dev).optimize(
        cloud10, path10, n_steps=400)
    mr_k, mr_t = float(res_k.rewards.mean()), float(res_t.rewards.mean())
    r0_k, r0_t = mr_k / res_k.visibility_gain, mr_t / res_t.visibility_gain
    # First step, identical parameters: the two forwards agree to ~1e-5.
    if abs(r0_k - r0_t) > 1e-4 * abs(r0_t):
        fail(f"kernel vs plain mean_reward at step 0: {r0_k:.7f} vs {r0_t:.7f}")
    # After 400 steps: 2e-2. Adam normalizes each gradient component, so f32
    # rounding differences between two correct paths grow along the run; on
    # the CPU this port's two paths end 400 steps of this workload 5.7e-3
    # apart in mean_reward, and the JAX XLA path and this port's plain path
    # 1.7e-2 apart.
    if abs(mr_k - mr_t) > 2e-2 * abs(mr_t):
        fail(f"kernel vs plain mean_reward after 400 steps: {mr_k:.6f} vs {mr_t:.6f}")
    print(f"[slice] cloud10 400 steps in {slice_s:.2f} s: visibility gain "
          f"{res_k.visibility_gain:.4f}, smoothness gain {res_k.smoothness_gain:.4f}, mean_reward "
          f"{mr_k:.6f} (plain {mr_t:.6f}); launches {launches}", flush=True)

    big = cases[1]
    res_big = opt.optimize(big_pts, big_path, n_steps=20)
    if not (np.all(np.isfinite(res_big.poses)) and np.isfinite(res_big.loss) and res_big.n_iters == 20):
        fail("1M x 50 run: non-finite result or wrong step count")
    print(f"[slice] 1M x 50 20 steps: loss {res_big.loss:.6f}, visibility gain "
          f"{res_big.visibility_gain:.4f}", flush=True)

    # ---- 5. times ----------------------------------------------------------
    step_ms, peak_mb = {}, {}
    for c in cases:
        n = 50 if c["name"] == "ref" else 10
        for backend in ("kernel", "torch"):
            prob = TrajProblem(intr.width, intr.height, wps_step=c["stride"], backend=backend)

            def loss_fn(p, c=c, prob=prob):
                return traj_forward(p, c["P"], K, c["path"], c["quats"], prob,
                                    valid=c["V"], points_t=c["Pt"])

            p0 = init_traj_params(c["path"].cpu().numpy(), c["quats"].cpu().numpy(), dev)
            run_until_done(loss_fn, p0, cfg, n, NEVER)  # warm-up
            sync()
            torch.cuda.reset_peak_memory_stats()
            windows = []
            for _ in range(3):
                t0 = time.perf_counter()
                run_until_done(loss_fn, p0, cfg, n, NEVER)
                sync()
                windows.append((time.perf_counter() - t0) * 1e3 / n)
            step_ms[(c["name"], backend)] = statistics.median(windows)
            peak_mb[(c["name"], backend)] = torch.cuda.max_memory_allocated() / 2**20
    for c in cases:
        name = c["name"]
        print(f"[times] {card} | {name}: ms/step kernel {step_ms[(name, 'kernel')]:.4f} "
              f"plain {step_ms[(name, 'torch')]:.4f}; peak MiB kernel "
              f"{peak_mb[(name, 'kernel')]:.1f} plain {peak_mb[(name, 'torch')]:.1f}; stage ms "
              + ", ".join(f"{s} {a:.4f}/{b:.4f}" for s, (a, b) in stage_ms[name].items())
              + " (kernel/plain)", flush=True)

    record = {"kernels": [
        {"name": n, "route": "cuda", "source": SOURCE, "replaces": REPLACES[n],
         "launches": launches[n], "max_abs_err": errs[n],
         "ms": stage_ms["ref"][n][0], "plain_ms": stage_ms["ref"][n][1],
         "ms_1m50": stage_ms["1m50"][n][0], "plain_ms_1m50": stage_ms["1m50"][n][1]}
        for n in REPLACES
    ], "step_ms": {f"{a}/{b}": v for (a, b), v in step_ms.items()}}
    for n in REPLACES:
        if not all(math.isfinite(x) for x in (errs[n], *stage_ms["ref"][n], *stage_ms["1m50"][n])):
            fail(f"{n}: non-finite measurement")
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
