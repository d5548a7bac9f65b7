"""hpr.roofline_pct: the least time the card could take for the binned
soft-HPR gate's tile work of one final forward, as a share of the device
time of the operations launched under the program's span
``trajopt.hpr.soft_binned`` (the tiles' reduction, ``ops/hpr._BinnedLSE``)
inside ``trajopt.runner.final_forward`` (``hpr.gate_ms``'s phase), %.
Layer: the HPR gate. Moves ``solve_ms.p50``.

The work is counted from the cell's inputs alone, by the reference's own
routing (``reference/traj_soft.route``), never from the program's static
slots, masks or launches, so a kernel that skips empty slots or merges
tiles cannot move the yardstick. For each traced request, at its initial
path with identity orientations (its first step's inputs), over every
scored waypoint and the four grids. The final forward runs at the
returned state, whose tiles hold a little more: on an H100, four cloud-10
requests held 0.17–0.25% more pairs there than at their initial paths
(1.061e9–1.079e9 at the initial paths), so the share reads that much low.
Neither ``hpr.*`` metric reads the replays' backward (a replay carries no
span):

* pairs: (query, coverer of its chunk in its bin, not itself) of the real
  tiles, each bin's queries in chunks of ``cap``;
* operations: OPS_PER_PAIR for each, the arithmetic of the stated formula,
  each transcendental counted once: the dot product of the two directions
  5, the clamp at 0 1, the product with ρ 1, the scaling by β 1, and the
  log-sum-exp's running maximum 1, subtraction 1, exp 1 and sum 1;
* bytes: each real tile's query rows and coverer rows read once (the
  direction and ρ, 16 bytes a row in float32) and one float32 output per
  query row.

Least time = max(operations / 67 TFLOP/s, bytes / 3.35 TB/s), the H100's
published float32 (no tensor core) and HBM3 peaks at a 700 W power limit,
as ``vis.roofline_pct`` states them. A program without the span, or a
stretch that launched nothing under it, reads nothing.
"""

import numpy as np
import torch

import program_trace
from registry import BENCH_DIR, load_module

OPS_PER_PAIR = 5 + 1 + 1 + 1 + 4
BYTES_PER_ROW = 16
BYTES_PER_OUTPUT = 4
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TILES = "trajopt.hpr.soft_binned"


def tile_work(ref, points, path0, st, device):
    """(pairs, bytes) of one forward's binned tiles over the scored
    waypoints of ``path0`` with identity orientations, by the reference's
    routing in float64."""
    step = ref.stride(path0, st.vis_wps_dist)
    P = torch.as_tensor(np.asarray(points), dtype=torch.float64, device=device)
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64, device=device)
    pairs = nbytes = 0
    blk = ref.TILE_BLOCK
    for pose in np.asarray(path0)[::step]:
        cam = ref.camera_frame(P, q, torch.as_tensor(pose, dtype=torch.float64, device=device))
        cap = min(st.cap, len(P))
        for r in ref.route(cam, st):
            counts = torch.bincount(r.bins)
            tiles = (counts + cap - 1) // cap
            queries = int(counts.sum())
            coverers = int((tiles * torch.clamp(counts, max=cap)).sum())
            pairs += sum(int(ref.pairs(r.queries[t:t + blk], r.coverers[t:t + blk]).sum())
                         for t in range(0, len(r.queries), blk))
            nbytes += BYTES_PER_ROW * (queries + coverers) + BYTES_PER_OUTPUT * queries
    return pairs, nbytes


def read(ctx):
    gate = load_module(BENCH_DIR / "metrics" / "hpr.gate_ms.py")
    pt = program_trace.stretch(ctx)
    if pt is None or not pt.n_requests:
        return None
    tiles_s = gate.device_seconds(gate.launched_under(pt, TILES))
    if tiles_s <= 0:
        return None
    cell = ctx.cell
    work = [tile_work(cell.ref, cell.points, cell.path(i), cell.settings, ctx.device)
            for i in range(pt.n_requests)]
    ops = OPS_PER_PAIR * sum(p for p, _ in work)
    nbytes = sum(b for _, b in work)
    least_s = max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)
    ctx.notes.append(
        f"hpr tile work per final forward: {sum(p for p, _ in work) / len(work):.6e} pairs, "
        f"{ops / len(work):.6e} operations, {nbytes / len(work):.6e} bytes, bound by "
        f"{'operations' if ops / PEAK_FLOPS >= nbytes / PEAK_BYTES else 'bytes'}; least "
        f"{least_s * 1e3 / len(work):.6f} ms against the tiles' "
        f"{tiles_s * 1e3 / pt.n_requests:.6f} ms (peaks 67 TFLOP/s, 3.35 TB/s)")
    return 100.0 * least_s / tiles_s
