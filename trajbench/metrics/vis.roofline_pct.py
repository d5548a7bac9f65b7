"""vis.roofline_pct: the least time the card could take for a step's
visibility work, as a share of the time the visibility kernels took
(``vis.kernel_ms``), %. Layer: the vis kernels. Moves ``steps_s``.

The work is counted from the cell's inputs alone, never from the program's
masks, regimes or launches, so a kernel that merges, drops or skips work
cannot move the yardstick. Per Adam step of a request with N points and
its scored waypoints:

* operations: OPS_PER_PAIR for each contributing pair, a pair whose
  normalized score clears the 0.5 clip, so that its log-odds, and its
  gradient, are not zero: every correct implementation computes its score,
  log-odds and chain rule. OPS_PER_PAIR is the arithmetic of the stated
  formulas, each transcendental counted as one operation: forward 64 (the
  camera transform 18, the distance term 10, the projection 6, the depth
  floor 2, the normalized pixel coordinates and their clamps 10, the field
  of view term 5, the sigmoid 3, the products 2, normalize, clip, log-odds
  and sum 8) and backward 50 (the log-odds and normalization 5, the score's
  derivative in the camera frame 21, the 12 camera-plane sums per waypoint
  24). Pairs that contribute nothing are not counted at all. The pairs are
  counted by the reference at the request's initial path (its first step's
  inputs).
* bytes: the points (12 bytes) read by the forward and again by the
  backward, the (N,) log-odds sum written and its (N,) cotangent read: 32
  bytes a point. Waypoint tables are negligible.

Least time = max(operations / 67 TFLOP/s, bytes / 3.35 TB/s), the H100's
published float32 (no tensor core) and HBM3 peaks at a 700 W power limit.
A cell whose steps launch no visibility kernel reads nothing.
"""

import numpy as np
import torch

from registry import BENCH_DIR, load_module

OPS_PER_PAIR = 64 + 50
BYTES_PER_POINT = 32
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def contributing_pairs(ref, points, path0, st, device) -> int:
    """Pairs of (scored waypoint, point) at the path with identity
    orientations whose log-odds is not zero, by the reference, in float64."""
    step = ref.stride(path0, st.vis_wps_dist)
    p = torch.as_tensor(np.asarray(path0)[::step], dtype=torch.float64, device=device)
    q = torch.zeros(p.shape[0], 4, dtype=torch.float64, device=device)
    q[:, 0] = 1.0
    pts = torch.as_tensor(points, dtype=torch.float64, device=device)
    with torch.no_grad():
        lo = ref.logodds(ref.scores(pts, q, p, st))
    return int((lo > 0).sum())


def read(ctx):
    kernel_s = load_module(BENCH_DIR / "metrics" / "vis.kernel_ms.py").kernel_seconds(ctx)
    if kernel_s <= 0 or not ctx.n_steps:
        return None
    cell = ctx.cell
    pairs = [contributing_pairs(cell.ref, cell.points, cell.path(i), cell.settings, ctx.device)
             for i in range(ctx.n_requests)]
    per_req = cell.n_steps
    ops = OPS_PER_PAIR * sum(pairs) * per_req
    nbytes = BYTES_PER_POINT * len(cell.points) * per_req * ctx.n_requests
    least_s = max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)
    ctx.notes.append(
        f"vis work per step: contributing pairs {sum(pairs) / len(pairs):.1f} of "
        f"{cell.n_scored * len(cell.points)}, {ops / ctx.n_steps:.6e} operations, "
        f"{nbytes / ctx.n_steps:.6e} bytes, bound by "
        f"{'operations' if ops / PEAK_FLOPS >= nbytes / PEAK_BYTES else 'bytes'}; "
        f"least {least_s * 1e3 / ctx.n_steps:.6f} ms against kernels "
        f"{kernel_s * 1e3 / ctx.n_steps:.6f} ms (peaks 67 TFLOP/s, 3.35 TB/s)")
    return 100.0 * least_s / kernel_s
