#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``trajectory_optimization_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):

1. device — needs CUDA; prints ``nvidia-smi`` name and power limit; TF32 off.
2. build — compiles every ``csrc/*.cu`` (``fused_vis.cu``, ``splat_render.cu``)
   with nvcc for sm_90a, in parallel, into one library; prints ptxas's
   registers and spills (K1, K1′, K2′, K3, K4, K5, K6 and K7 on stdout). Then the
   premise of pass A's exact-zero pruning is tried on the card: ``expf(x)``
   is 0 for every float x ≤ −``PRUNE_ZERO_T``/2, all bit patterns, one launch.
3. kernels — K1–K4 and the uncached regime's K1′, K2′ and K5 against their
   plain PyTorch versions on the card, stage by stage (K1′'s min/max equal
   K1's bit for bit, K5's tie counts equal K3's exactly, K5's sums combined
   equal K4's), and the whole ``fused_lo_sum`` forward and gradient, in both
   regimes, against the plain autodiff path, at the reference workload
   (cloud 10 padded to 40,960 points, 14 selected waypoints) and at
   1,048,576 points × 50 waypoints (seeded synthetic cloud). K5 and K2′ skip
   the pairs whose terms are exactly zero: per shape, the share of pairs
   that need K5's chain or K2′'s log and the share of 32-point groups (one
   warp's points) that take them, from the plain ``fused_vis.skip_masks``.
   K5 and K2′ also run, against their plain versions and twice (bit-equal),
   on a dense case (1,048,576 points in view of 50 close waypoints: every
   warp takes the chain) and a tie case (that cloud plus two copies of each
   waypoint's lowest- and highest-scoring point: ties with s ≠ 0).
   K3 also leaves the need mask, one bit per pair that can add a nonzero
   term to K4, and K4 computes only the flagged pairs: at every shape, the
   dense and tie cases included, the mask is ``torch.equal`` to the plain
   one, K4 on it matches the plain K4 that computes every pair and adds
   its terms in float64 (rtol 2e-3 / atol 2e-3), two launches of each agree
   bit for bit and a call is one device operation; per shape,
   the share of pairs and of 32-point groups the mask flags.
   Pass A (K1, K1′) finishes a pair after the score's distance term where
   that decides it (``fused_vis.prune_masks``): at every shape, the dense and
   tie cases included (nothing is pruned there), K1's min, max and cache and
   K1′'s min and max are ``torch.equal`` to the plain version's and to each
   other, two launches agree bit for bit, and a call is one kernel and at
   most one other device operation; per shape, the share of pairs that are
   exact zeros, under the max, and scored in full. At 1M × 50 they also run
   on the same cloud in Morton order (same min and max, the cache permuted),
   where pruned pairs fill whole warps, and are timed there.
4. slice — ``TrajectoryOptimizer.optimize`` on cloud 10 for 400 steps through
   the cached kernels, its steps after the first replaying one captured step
   (launch counters reset just before, read just after; a replay adds the
   launches its graph recorded),
   the same run on the plain backend, ``TrajectoryOptimizer.evaluate`` of
   the optimized path (K1, K2 and the loss's forward kernels once each)
   beside the plain backend's, 20
   steps of 1M × 50, and 20 steps of 8,388,608 points × 50 waypoints
   (8m50), whose 1.68 GB of scores exceed
   the cache budget. Before that run, its first forward (K1′ → K2′) and K5
   on its cotangent are held against their plain versions run in chunks of
   waypoints, and 8m50's stage and step times are taken while the problem
   is on the card. The run itself must go through K1′, K2′ and K5 only, with
   its peak memory allocated under the size of a score cache (peak
   reserved printed beside it).
4b. loss — the trajectory loss's six kernels (``csrc/fused_traj.cu``) at
   cloud 10 padded as the facade pads it and path 10 moved (27 waypoints, 14
   scored): each against its plain version on the same inputs, timed
   through its wrapper, alone in a profiler trace, beside the plain version
   and its bound (``loss_work``); then the loss's forward and backward
   captured and replayed, beside the plain path it replaces (``fused_lo_sum``
   and ``traj_criterion`` under autograd): device operations per replay (at
   most 12 for the fused loss), device ms per replay, host ms of an eager
   call, and the gradients within 1e-4 of the largest entry.
5. render kernels — K6 (``splat_runs``) and K7 (``splat_dense``) against
   their plain versions on the card, images ``torch.equal`` and ``n_dropped``
   equal to the CPU prologue's, on the visible set of one camera of the
   six-camera ring over cloud 10 and over the 8,388,608-point cloud, each
   with both backends forced; each image also against the plain scatter
   renderer to the 0.1% pixel pin. Then the edge cases of
   ``utils.data.splat_cases`` at the reference camera, both backends:
   equal depths across tile, band and bin borders (ties across K6's two runs
   and K7's copies), footprints of r = 0.5 and r = 4 on the image's edges,
   and a cloud whose every tile exceeds the dense path's cap of 2,048
   (``n_dropped`` > 0). Every kernel is launched twice on each input and
   the two images must be equal.
6. render slice — ``PointsProcessorNode(device="cuda")`` (``hpr_backend=
   "none"``) driven over the bus with the six-camera ring at the reference
   camera (1232x1616), once per cloud (counts reset just before, read just
   after: cloud 10 must run K6 only, the 8M cloud K7 only), then ``process``
   for one camera; every image (1616, 1232, 3), finite, in [0, 1] and not
   all background; batched and serial counts within max(3, 1%).
7. nodes — ``TrajOptNode(device="cuda")`` over the bus with cloud 10 from
   ``CloudFeederNode(pc_index=10)`` and path 10 at bench.py's node settings
   (30 steps, lr_quat 0.02, rewards_th inf): one warm-up and 20 messages at
   pipeline depth 1, then at depth 2; every published path equal between
   the depths, launches K1 = K2 = 31 and K3 = K4 = 30 per message, the
   loss's forward kernels 31 and its backward kernels 30 (counts
   reset just before the 20, read just after), the first path equal to
   ``TrajectoryOptimizer(device="cuda").optimize``'s and to its 30 steps
   taken eagerly, each of which holds against the plain criterion's step
   from the same parameters and Adam state (``stepwise_parity``,
   ``STEP_PINS``: loss, aux, rewards, gradients and update); the facade's
   5-step result within ``NODE_TOL_5`` of the plain path run in float64,
   the mean reward within 1e-4 of ``backend="torch"``'s; the 30-step gap to
   the float64 run printed, not held. ``PoseOptNode`` with both feeders at (6, 2, 0),
   200 steps, 20 samples: 20 finite /odom messages, the last equal to
   ``PoseOptimizer``'s 200-step position. ``PoseOptimizer`` 200 steps at
   cloud 10 and at the seeded 1M cloud, and 20 steps at cloud 10 against
   the CPU (rtol 1e-4 / atol 1e-5): the pose path has no kernel. The native
   C++ library must build; ``VoxelFilterNode`` on cloud 10 against numpy
   (same count, 1e-4), and timed on the 8m cloud; ``voxel_downsample_jit``
   and ``occupancy_grid_jit`` on the card against the CPU (``torch.equal``
   occupied mask and grid, centroids 1e-5, grid against numpy on 99.9% of
   cells).
8. hpr — hidden-point removal (``ops/hpr.py``, eager PyTorch: no kernel of
   its own). ``PointsProcessorNode(device="cuda")`` over the bus with the
   ring at 1232x1616 over cloud 10 at its default ``hpr_backend="approx"``:
   one batched pursuit per cloud, every camera's visible points with no
   false positive against Qhull (``hpr_mask_exact``) on its culled points
   and recall >= 0.98, serial and batched counts within max(3, 1%), images
   as in 6; then with ``"exact"`` (visible == Qhull's). The estimate and
   bound of the 8m rig's pursuit, which stays at ``"none"``.
   ``hpr_mask_approx`` on the full cloud 10 from (6, 2, 0): no false
   positive, recall >= 0.99, two runs ``torch.equal``.
   ``PoseOptimizer(use_hpr=True)`` 200 steps (loss below the start) and
   ``PoseOptNode(use_hpr=True)`` over the bus (20 finite /odom, the last
   equal to the optimizer's). Soft HPR at the dense size, cloud 10
   voxel-filtered at leaf 0.15 (23,288 centroids, padded 24,576):
   ``PoseOptimizer(soft_hpr=True)`` 50 steps, ``TrajectoryOptimizer(
   soft_hpr=True)`` 10 steps with path 10 (loss below that after its first
   step, visibility gain > 1) and ``evaluate`` of the result; one step of
   each, loss and gradients, against the same step on the CPU within 2e-3
   of the largest entry (the trajectory's on path 10's first 3 waypoints).
   The direction-binned soft tier (``hpr_mask_soft_binned``): the mask on
   cloud 10 from path 10's waypoint 9, on its 16,384-point rng(0) subsample
   against Qhull (precision >= 0.86, recall >= 0.93, agreement >= 0.93,
   tests/test_hpr.py's pins) and on the full cloud against the same call on
   the CPU (99.8% within 3e-3, the 0.5 threshold on 99.9%);
   ``PoseOptimizer(soft_hpr=True)`` on bench.py's cloud at 262,144 points (5
   steps) and 1,048,576 (2 steps), loss below the start;
   ``TrajectoryOptimizer(soft_hpr=True)`` on the full cloud 10 with path 10
   (14 waypoints, cap 512) for 10 steps, one step in f32 on the card and on
   the CPU against the card's float64 step (1e-3 of the largest entry),
   its launches the tiles' two kernels once a grid and the layout's seven
   once a gate call (``binned_rows`` once a grid) and no other; the layout
   kernels B1–B7 (``csrc/binned_layout.cu``) at that cell's shapes (cap
   512) and the soft pose step's (cap 1024), in f32 and f64, against the
   plain per-grid chain on the same tensors (B1–B5 ``torch.equal``, B6 and
   B7 within ``LAYOUT_SUM_ULPS``), each timed alone and through its wrapper
   beside its bound and the plain chain's stage;
   ``optimize_waypoints`` at the demo's defaults
   (100 steps, every per-waypoint gain >= 1, mean > 1; with soft HPR it is
   held and timed under 12). These soft runs above ``soft_hpr_dense_max``
   are captured: each timed pose run replays the step its warm-up run
   captured, the timed trajectory run takes its first step eagerly and
   captures the rest; the traced steps are eager (a replay runs no
   profiler range). Then the distance-reward model and the finite-difference pose loss
   against the CPU (rtol 1e-4 and 2e-3; counts equal).
9. frozen — the frozen-routing soft-HPR engine (``models/traj_frozen.py``,
   PyTorch: no kernel of its own) at bench.py's shapes, each on its two
   routes: captured (one CUDA graph per plan shape, the default on the
   card) and eager. ``FrozenTrajOptimizer`` on cloud 10 and path 10 (14
   waypoints, cap 512, lr 0.1/0.02, the default ``FrozenPlanConfig``: async
   refresh every 8 steps): the first two steps (a shape's eager first step,
   its capture), 2 warm-up steps, 3 windows of 8 steps each ending in a
   sync (ms/step, peak memory, refreshes, shapes, the blocked build
   seconds); one step between refreshes under
   ``torch.cuda.set_sync_debug_mode("error")`` (it must make no host sync),
   then the other steps up to the next refresh traced (host kernel and
   graph launches and copy calls, device operations and busy per step, the
   tiles' share); the captured graph's replays alone and the memory its
   bucket holds (the captured route pads its live-tile list to a rung, the
   eager one does not). The stall a new shape causes (the tile floor raised a rung at a
   sync refresh) against one refresh interval. 24 steps over 3 refreshes,
   sync and async: every step's loss, parameters and aux captured
   ``torch.equal`` to eager; a first capture while the worker thread runs
   plan builds. At a refresh: the frozen loss, rewards and gradient against
   the per-step routed binned tier (``traj_forward(soft_hpr=True,
   soft_hpr_dense_max=0)``), the sparse mean against the embedding path
   (tests/test_torch_traj_frozen.py's pins, ``FROZEN_PINS``), and the f32
   frozen step against float64 within ``BINNED_TOL``, beside the same step
   with the gate's norms in f32.
   ``FrozenPoseOptimizer`` on 262,144 uniform ±40 m points (min_dist 1,
   max_dist 12, refresh_every 10,000) beside ``PoseOptimizer(soft_hpr=
   True)``, its first loss against the per-step loss (rtol 1e-4) and the
   loss falling; ``FrozenWpsOptimizer`` with the 27 waypoints of path 10
   (cap 1024), the same checks against ``wps_forward``; each of the two
   also 6 steps at refresh_every 2 (async) captured ``torch.equal`` to
   eager; 200 steps of path 10 displaced +12 m in z at
   the default config on both routes, the median and worst 20-step window
   and the shapes taken.
10. cli — the shell entry point, ``__main__.main([...])`` in this process
   with ``--device cuda:0``: ``eval`` of cloud 10 and path 10 with
   ``--optimize 100``, its printed census equal to a direct
   ``TrajectoryOptimizer`` run of the same steps (K1–K4 launched); the
   ``trajectory_optimization`` preset replaying a bag of three
   cloud-10/path-10 pairs with ``--record`` and ``--echo``, in-process and
   with ``--processes`` (the node in a worker process on the card), every
   recorded optimized path ``array_equal`` to TrajOptNode driven directly;
   the ``pointcloud_processor`` preset at its default ``hpr_backend`` over a
   bag of cloud 10, the ring's /tf and six camera infos, in-process (K6 once
   per camera) and with ``--processes``, each recorded image equal to the
   node's own after ``.cpu()``; the worker's start-up seconds, each preset's
   msgs/s in-process and with processes (three windows of at least 8
   messages and 1 s), and the recorder's MB/s (five passes).
11. parallel — the parallel layer (``parallel/``) over ``torch.distributed``.
   D = 1 over nccl in this process at 1m50: ``sharded_fused_lo_sum``'s lo
   and gradients and 20 ``make_sharded_train_step`` steps ``torch.equal``
   to ``fused_lo_sum`` and the single-card step the sharded path
   distributes (``fused_lo_sum`` + ``traj_criterion``), each step within
   ``PAR_PINS`` of ``traj_forward``'s kernel backend's step (``ops.
   fused_traj``) from the same parameters and Adam state. Then four ranks spawned
   over gloo, all on cuda:0 (NCCL refuses two ranks on one device): the
   2-rank mesh at 1m50, cached and with the cache forced off (lo
   ``torch.equal``; gradients within the JAX suite's pins, ``PAR_PINS``;
   each of 20 steps within them of ``traj_forward``'s kernel backend's step
   taken from the same parameters and Adam state, the 20 losses within them of the single-card
   run's; the parameters' end-to-end gap is printed, not held: a
   discontinuous gradient under Adam grows f32 summation order to ~1e-2
   in 20 steps), K1–K4 or K1′/K2′/K5 launched in each rank; the 2x2 mesh at cloud 10 x 27 (lo and gradients within the pins,
   K1–K4 launched on every rank); at D = 2 on cloud 10 the soft-HPR
   modules against their single-card twins (``SOFT_PINS``: the binned mask
   and its gradient, the pose, waypoints and trajectory losses and
   gradients, ``FrozenShardedTrajOptimizer`` against
   ``FrozenTrajOptimizer`` for 8 steps with one refresh). Any failed rank
   fails the script.
12. graphs — the captured optimization loop (``opt/graphs.py``): the
   runners' captured loop held ``torch.equal`` to the plain loop of
   tests/torch_loop_ref.py ("eager") on the card (n_iters, parameters,
   final loss and aux) at ref (400 steps, with the visibility and
   smoothness gates), 1m50 and 8m50 (20 steps), launches
   per step from the counters equal in both; ``optimize_with_history`` (50
   steps) and ``OptimizerLoop.run(0, 1, 7, 20)`` at ref; ``PoseOptimizer``'s
   runner at cloud 10 and 1M (100 steps); ``optimize_waypoints`` at the
   demo's defaults; the K3/K4 scratch round trip (a graph captured at W = 14,
   the scratch grown by a 1m50 run, the first graph replayed on the scratch
   it holds, equal to the eager run). Soft HPR above ``soft_hpr_dense_max``
   (the binned tier on its static tile slots, ``soft_graph_checks``): the
   trajectory runner on cloud 10 and path 10, the pose runner on bench.py's
   cloud at 262,144 and 1,048,576 points and ``optimize_waypoints`` on cloud
   10, each called captured, eager, eager, captured (the waypoints without
   the last): the two eager calls bit-equal (the binned backward adds its
   rows in a fixed order) and the captured ones ``torch.equal`` to them;
   at 1,048,576 points the f32 step, eager and captured (bit-equal), within ``HPR_TOL`` of the
   card's float64 step; the real tiles against the static slots per grid.
   Times under [times].
13. times — per-stage and per-step ms of the eager loop (the series of
   earlier runs), kernel and plain, peak memory, and
   the device's busy share of a step from a 20-step ``torch.profiler`` trace;
   K6/K7 ms through the wrapper and the kernel alone (``torch.profiler``)
   beside their plain versions, bounds, share of the bound and the first
   design's times from PERF.md, the splat prologue's ms,
   ms per ``process_all`` call and its peak memory for both clouds; the
   nodes' times: TrajOptNode messages/s at both depths and the device's busy
   share of one traced callback, ms per PoseOptNode callback, PoseOptimizer
   ms/step at cloud 10 and 1M, VoxelFilterNode ms at 8m; HPR: one batched
   ``_hpr_masks_rig`` and the pursuit alone at rig cloud10, ``process_all``
   at "approx", "exact" and "none", the pursuit on the full cloud 10,
   ``PoseOptimizer(use_hpr=True)`` ms/step, soft pose and trajectory
   ms/step with peak memory and the soft dominance tile's share of a traced
   step, each loop beside a bound from the pairs it touches; the binned
   tier's mask ms, soft pose ms/step at both sizes, trajectory and
   waypoints ms/step, peak memory and the binned tiles' share of a traced
   call, each beside a bound from its tiles' pairs; the frozen engine's
   ms/step beside a bound from the pairs of the tiles it computes; [cli]'s
   run seconds, start-up seconds, msgs/s and MB/s; [parallel]'s ms per
   configuration, labelled as ranks sharing one card; [graphs]' ms/step of the
   captured and the eager route (median of 3 windows after a warm-up, in
   turns) and of the replays alone, device-busy ms, device operations and
   host launch calls (kernel launches, graph launches) per step of a traced
   20-step run, capture seconds per bucket, peak MiB allocated and reserved;
   the pose runner's and ``optimize_waypoints``' times by route; per soft
   configuration, ms/step of whole calls and of replays alone, busy ms,
   device operations and host launch calls of a traced step by each route,
   capture seconds, the memory the cached graph holds, peak MiB and the
   tiles against the slots; the seconds each phase took.

The line before the last is the kernels' JSON record (all nine kernels, each
with its bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over 67 TFLOP/s, K1's, K1′'s, K4's, K5's and K2′'s work counted
on the pairs these inputs need); the last line is ``{"ok": true, "device":
{...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
VIS_SOURCE = "trajectory_optimization_tpu_torch/csrc/fused_vis.cu"
SPLAT_SOURCE = "trajectory_optimization_tpu_torch/csrc/splat_render.cu"
REPLACES = {
    "pass_a": "trajectory_optimization_tpu/ops/pallas_vis.py:228",
    "pass_b": "trajectory_optimization_tpu/ops/pallas_vis.py:264",
    "bwd_stats": "trajectory_optimization_tpu/ops/pallas_vis.py:288",
    "bwd_apply": "trajectory_optimization_tpu/ops/pallas_vis.py:320",
    "pass_a_minmax": "trajectory_optimization_tpu/ops/pallas_vis.py:212",
    "pass_b_recompute": "trajectory_optimization_tpu/ops/pallas_vis.py:275",
    "bwd_fused_acc": "trajectory_optimization_tpu/ops/pallas_vis.py:361",
    "splat_runs": "trajectory_optimization_tpu/ops/pallas_render.py:105",
    "splat_dense": "trajectory_optimization_tpu/ops/pallas_render.py:134",
}
VIS = tuple(REPLACES)[:7]
SPLAT = ("splat_runs", "splat_dense")
SPLAT_KERNELS = {"splat_runs_kernel": "splat_runs", "splat_dense_kernel": "splat_dense"}
CACHED = ("pass_a", "pass_b", "bwd_stats", "bwd_apply")  # the score-cache regime's path
UNCACHED = ("pass_a_minmax", "pass_b_recompute", "bwd_fused_acc")  # above the cache budget
# the trajectory loss's kernels around them (csrc/fused_traj.cu): the forward's,
# then the backward's (alpha_beta in the score-cache regime only)
LOSS_FWD = ("traj_head", "make_norm", "traj_loss")
LOSS_BWD = ("lo_cotangent", "alpha_beta", "traj_tail")
LOSS = LOSS_FWD + LOSS_BWD
LOSS_SOURCE = "trajectory_optimization_tpu_torch/csrc/fused_traj.cu"
N_8M = 8_388_608
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM, published
F32_OPS_PER_MS = 67e9  # H100 SXM f32 outside the tensor cores, published
# Operations per (waypoint, point) of each fused-visibility kernel, counted
# from its plain version (ops/fused_vis.py): every +, -, x, comparison,
# clamp bound and select is 1, and so are exp, log and a division; sigmoid
# is 3 (exp, add, division). The score (_extras + exp) is 59. K4 runs its 141
# only on the pairs that K3's need mask flags (``need_counts``), and reads,
# beside the mask, the 4-byte score of each flagged pair and the 20 bytes of
# x, y, z, g and valid of each point that some waypoint flags (each input
# byte once).
VIS_OPS = {"pass_b": 8, "bwd_stats": 30, "bwd_apply": 141}
# Pass A (K1, K1′) needs a pair's whole score (59), its valid select and the
# min and max (63 in all) only where the distance term does not decide the
# pair (fused_vis.prune_masks): a pruned pair costs the 27 operations up to
# t0 = d²·inv_var and the comparison. K1 prunes the exact zeros of every
# pair (it caches them all); K1′ the exact zeros and the pairs under the max,
# and needs nothing for a point that is not valid.
PASS_A_OPS = {"full": 63, "pruned": 28}
# K5 and K2′ compute only the terms that can be nonzero (fused_vis.skip_masks),
# so their counts depend on the data. K5: 70 on every pair (the score; s − m,
# × inv_d, the window's two comparisons and their and; two valid tie tests;
# two count adds), 83 more on a pair in its direct mask (clip 2, c_pn 4,
# c_pn·∂pn/∂m 6 and c_pn·∂pn/∂M 5 with their two sums, c_pn·inv_d, the dcam
# chain 42, the 12 plane sums 21) and 63 on a pair in its tie mask (one tie
# channel: the dcam chain and the plane sums). K2′: 63 on every pair (the
# score, s − m, × inv_d, the clip) and 4 more where pn > 0.5 (1 − pn, the
# division, the log, the add). With every mask full they are 279 and 67.
K5_OPS = {"hot": 70, "direct": 83, "tie": 63}
K2P_OPS = {"hot": 63, "unclipped": 4}
# Per covered (entry, pixel) pair of a splat: dr, dc, two squares, their sum,
# the coverage and the depth comparisons.
SPLAT_OPS = 7

def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def bound(nbytes: float, ops: float):
    """(ms, side): the least time the card could take, the larger of the
    bytes over the memory rate and the operations over the f32 rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_MS, ops / F32_OPS_PER_MS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def vis_bound(name: str, W: int, N: int, skips=None, prunes=None):
    """Each input read once and each output written once, per fused kernel;
    K5's and K2′'s operations on the pairs that ``skips`` (``skip_counts``
    of these inputs) says they need, K4's operations and reads on the pairs
    and points that K3's mask flags (``need_counts``, merged into ``skips``),
    K1's and K1′'s on those that ``prunes`` (``prune_counts``) leaves."""
    pts, cache, mask = 12 * N, 4 * W * N, 4 * W * (-(-N // 32))
    nbytes = {
        "pass_a": pts + 4 * N + 48 * W + cache + 8 * W,
        "pass_a_minmax": pts + 4 * N + 48 * W + 8 * W,
        "pass_b": cache + 16 * W + 4 * N,
        "pass_b_recompute": pts + 48 * W + 16 * W + 4 * N,
        "bwd_stats": cache + 16 * W + 8 * N + 16 * W + mask,
        "bwd_apply": 48 * W + 24 * W + 48 * W + mask + (
            4 * skips["k4_pairs"] + 20 * skips["k4_points"] if name == "bwd_apply" else 0),
        "bwd_fused_acc": 48 * W + 16 * W + pts + 8 * N + 160 * W,
    }[name]
    if name == "bwd_fused_acc":
        ops = (K5_OPS["hot"] * W * N + K5_OPS["direct"] * skips["direct"]
               + K5_OPS["tie"] * skips["tie"])
    elif name == "pass_b_recompute":
        ops = K2P_OPS["hot"] * W * N + K2P_OPS["unclipped"] * skips["unclipped"]
    elif name == "bwd_apply":
        ops = VIS_OPS[name] * skips["k4_pairs"]
    elif name in ("pass_a", "pass_a_minmax"):
        full = prunes["scored" if name == "pass_a" else "scored_valid"]
        seen = prunes["pairs" if name == "pass_a" else "valid_pairs"]
        ops = PASS_A_OPS["full"] * full + PASS_A_OPS["pruned"] * (seen - full)
    else:
        ops = VIS_OPS[name] * W * N
    return bound(nbytes, ops)


def morton_order(pts_t):
    """Indices that put the points of a (3, N) cloud in Morton (Z-curve)
    order of their coordinates quantized to 10 bits each: neighbours in the
    order are neighbours in space, so a warp's 32 points share their fate."""
    import torch

    lo, hi = pts_t.amin(dim=1, keepdim=True), pts_t.amax(dim=1, keepdim=True)
    q = ((pts_t - lo) / (hi - lo).clamp(min=1e-12) * 1023.0).long().clamp(0, 1023)
    code = torch.zeros_like(q[0])
    for bit in range(10):
        for axis in range(3):
            code |= ((q[axis] >> bit) & 1) << (3 * bit + axis)
    return torch.argsort(code, stable=True)


def skip_counts(masks):
    """Counts of ``fused_vis.skip_masks``: pairs in K5's direct and tie
    masks, in their union ``need`` and in K2′'s ``unclipped`` mask, and the
    32-point groups (one warp's points, aligned as the kernels align them)
    that hold such a pair, i.e. whose warp takes the chain or the log."""
    from trajectory_optimization_tpu_torch.ops.fused_vis import warp_groups

    need = masks.direct | masks.tie
    W, N = need.shape

    def groups(x):
        return int(warp_groups(x).sum())

    return {"pairs": W * N, "direct": int(masks.direct.sum()), "tie": int(masks.tie.sum()),
            "need": int(need.sum()), "unclipped": int(masks.unclipped.sum()),
            "groups": W * (-(-N // 32)), "need_groups": groups(need),
            "unclipped_groups": groups(masks.unclipped)}


def need_counts(need):
    """Counts of K3's need mask (W, ceil(N / 32)) int32: the pairs it flags
    (set bits), the (waypoint, 32-point group)s that hold one (nonzero words)
    and the points that some waypoint flags."""
    import torch

    def set_bits(words):
        return sum(int(((words >> b) & 1).sum()) for b in range(32))

    any_waypoint = need[0].clone()
    for row in need[1:]:
        any_waypoint |= row
    return {"k4_pairs": set_bits(need), "k4_groups": int(torch.count_nonzero(need)),
            "k4_points": set_bits(any_waypoint)}


def need_text(c):
    return (f"K4's mask flags {c['k4_pairs'] / c['pairs']:.6f} of pairs, "
            f"{c['k4_groups'] / c['groups']:.6f} of 32-point groups")


def prune_counts(masks, valid):
    """Counts of ``fused_vis.prune_masks`` (made with the final min and max,
    which prune the most): over all pairs, K1's exact zeros and the rest it
    scores; over the pairs of valid points, K1′'s exact zeros, those under
    the max, and the rest it scores."""
    ok = (valid > 0)[None, :]
    W, N = masks.zero.shape
    zero, zero_valid = int(masks.zero.sum()), int((masks.zero & ok).sum())
    under_valid, valid_pairs = int((masks.under_max & ok).sum()), W * int(ok.sum())
    return {"pairs": W * N, "zero": zero, "scored": W * N - zero, "valid_pairs": valid_pairs,
            "zero_valid": zero_valid, "under_max_valid": under_valid,
            "scored_valid": valid_pairs - zero_valid - under_valid}


def prune_text(c):
    v = max(c["valid_pairs"], 1)
    return (f"K1 scores {c['scored'] / c['pairs']:.6f} of pairs ({c['zero'] / c['pairs']:.6f} "
            f"exact zeros); K1′ scores {c['scored_valid'] / v:.6f} of valid pairs "
            f"({c['zero_valid'] / v:.6f} exact zeros, {c['under_max_valid'] / v:.6f} under the max)")


def skip_text(c):
    return (f"K5 needs {c['need'] / c['pairs']:.6f} of pairs ({c['direct']} direct, {c['tie']} "
            f"tie), {c['need_groups'] / c['groups']:.6f} of 32-point groups take its chain; K2′ "
            f"{c['unclipped'] / c['pairs']:.6f} of pairs, {c['unclipped_groups'] / c['groups']:.6f} "
            f"of groups")


def ptxas_report(log: str):
    """{kernel: (registers, spill stores, spill loads)} from nvcc -Xptxas -v."""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = [None, 0, 0]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            out[cur][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur][0] = int(m.group(1))
    return out

RING = [(6 + 3 * math.cos(2 * math.pi * i / 6), 2 + 3 * math.sin(2 * math.pi * i / 6), -2.0)
        for i in range(6)]  # the six-camera ring of tests/test_nodes.py, facing world +z
MAX_E = 2048  # render_point_cloud_tiles' default per-tile cap
# K6/K7 through the wrapper in their first design (PERF.md §6, NVIDIA H100
# 80GB HBM3, 700 W), printed beside this run's times and never compared with them
FIRST_SPLAT_MS = {("cloud10", "splat_runs"): 0.0365, ("8m", "splat_runs"): 0.9883,
                ("8m", "splat_dense"): 0.4626, ("cloud10", "splat_dense"): 0.0255}
PIN = 1e-3  # share of pixels that may differ from the scatter renderer (equal depths)
NODE_MSGS = 20  # timed TrajOptNode messages per depth, after one warm-up (bench.py's count)
# The facade's first 5 steps (the node's settings) against the plain path run
# in float64 from the same start: the largest |difference| of a position (m)
# or of a normalized quaternion's component. Rounding has not grown yet: on
# the CPU both float32 paths end 5.8e-6 m and 3.7e-7 from the float64 run.
NODE_TOL_5 = 1e-4
# Each of TrajOptNode's 30 steps (stepwise_parity), the kernel backend
# against the plain criterion around the same visibility kernels, from the
# same parameters and Adam state: the loss (relative), each aux scalar
# (rtol, atol), each gradient (share of its largest entry) and each Adam
# update (share of its learning rate). The loss and aux are
# tests/test_torch_fused_traj_cuda.py's bounds. On the card the node's
# steps read at most 1.4e-7, 9.5e-7, 6.0e-5 and 1.4e-5, and 1.5e-4 and
# 5.4e-5 for the gradient and update from three jittered starts (the anchor,
# smoothness and length gradients are held on their own in [loss],
# CRIT_GRAD_REL). The end-to-end gap after 30 steps is printed, not
# held: a step that agrees within these pins can still end 1.5e-2 m away
# (PERF.md §6).
STEP_PINS = {"loss": 2e-6, "aux": (2e-6, 1e-6), "grad": 2e-4, "update": 1e-3}
# ops/hpr.py has no hand-written kernel: its two O(N²) loops are timed in
# [hpr] beside a bound from the pairs they touch. Operations per pair: the
# approx pursuit's sweep (hpr_mask_approx) 8 (the 3-term projection 5, max
# and argmax 2, the runner-up 1) on every (probe row, point) pair of its 16
# passes, the last 12 on ⌈N/4⌉ rows; the soft dominance tile (hpr_mask_soft)
# 13 forward (cos 5, clip 2, × ρ, × β, the log-sum-exp's max, subtraction,
# exp and sum) and 38 backward (the forward's 9 again, the weight 3, ∂ρ 3,
# the tie-aware derivative 6, ∂cos 3, the two 3-term products 12, 2 adds).
# A training step runs the tile forward twice (the checkpointed waypoint is
# recomputed) and backward once.
HPR_SWEEP_OPS = 8
SOFT_OPS = {"forward": 13, "backward": 38}
# The direction-binned soft tier (hpr_mask_soft_binned) per (query, coverer)
# pair of its tiles: 13 forward (cos 5, max(cos, 0), × ρ, the mask's select,
# × β, the row max, subtraction, exp and sum) and 34 backward (the forward's
# 9 again, subtraction, exp, the weight's scale and mask 4, ∂ρ 3, the
# tie-aware derivative 4, × ρ·h 2, the two 3-term products 12). Its pairs
# are the tiles' (4 grids × tiles × cap²), counted on this run's inputs by
# binned_pairs.
BINNED_OPS = {"forward": 13, "backward": 34}
# The binned tiles' kernels (csrc/soft_binned.cu) against their plain version
# on the same CUDA tensors (binned_kernel_checks): in float32 the two take cos
# by different products, and β·ρ ≈ 8·10⁴ turns one ulp of cos near 1 (2⁻²⁴)
# into ~5e-3 of x. So the kernel's top and lse (absolute, in x) and its
# total, dU and dR (relative to the largest entry) are held no farther from
# the float64 plain version than twice the float32 plain version plus
# KERNEL_ULPS_X such ulps (tests/test_torch_soft_binned_cuda.py's rule).
# Its bound counts the pairs it reduces, (query, coverer) of one bin in a
# real tile, not the query itself, at BINNED_OPS each; bytes: each real
# tile's query and coverer rows (16 bytes) read once, 12 bytes out a query
# row (top, total, lse) forward, and backward 12 more in a query row (top,
# total, g), 12 out a query row and 16 out a coverer row (the partials).
KERNEL_ULPS_X = 8
BINNED_KERNEL_POSE = 262_144  # the soft pose step's points, cap 1024
BINNED_KERNEL_BYTES = {"forward": (16 + 12, 16), "backward": (16 + 12 + 12, 16 + 16)}
# The binned gate's layout kernels B1–B7 (csrc/binned_layout.cu) against the
# plain per-grid chain on the same CUDA tensors (layout_kernel_checks): B1–B5
# compute the plain chain's operations in its order (the keys, the layouts
# and tables, the row maxima and their cotangent) and are held torch.equal;
# B6 and B7 add each entry's terms (the tiles' partial sums into the rows,
# the rows into the points) in another fixed order than add_rows and
# autograd, and are held within LAYOUT_SUM_ULPS rounding units per term of
# the sum of the terms' magnitudes (two orders of a sum of m terms differ by
# at most 2·(m − 1) such units; a lost or doubled term moves it by far more),
# plus the smallest normal number per term: the plain chain's gathers are
# transposed by atomic adds, which flush subnormal terms to zero in float32.
# Their bound: the bytes of their arguments and results, once.
LAYOUT_SUM_ULPS = 2
LAYOUT_KERNELS = ("binned_keys", "binned_layout", "binned_tables", "binned_rowmax",
                  "binned_rowmax_bwd", "binned_rows", "binned_layout_bwd")
# (a name the trace gives each launch, launches a gate call) of each stage:
# the sort's radix passes are cub's, seven for int32 keys (a histogram, an
# exclusive sum, four one-sweep passes; the index fill before them aside)
LAYOUT_TRACE_NAMES = {
    "binned_keys": ("keys_kernel", 1), "sort": ("DeviceRadixSort", 6),
    "binned_layout": ("layout_kernel", 1), "binned_tables": ("tables_kernel", 1),
    "binned_rowmax": ("rowmax_kernel", 1), "binned_rowmax_bwd": ("rowmax_bwd_kernel", 1),
    "binned_rows": ("rows_kernel", 4), "binned_layout_bwd": ("layout_bwd_kernel", 1)}
# (points, timed steps) of the soft pose step on bench.py's cloud, and the
# waypoints optimization's steps (the demo's default)
BINNED_POSE = ((262_144, 5), (1_048_576, 2))
WPS_STEPS = 100
SOFT_LEAF = 0.15  # voxels_filtering.launch's leaf: cloud 10 -> 23,288 centroids
# [hpr]'s soft runs at that dense size: pose and trajectory steps, cut from
# 100 and 20 to hold the script's time
SOFT_POSE_STEPS, SOFT_TRAJ_STEPS = 50, 10
# Soft HPR, one step on the card against the same step on the CPU: the
# largest error within 2e-3 of the largest entry, the port's gradient pin
# against the JAX twin (tests/test_torch_pose.py). The mask's sigmoid turns
# one f32 rounding of its inputs into ~2.4e-3 of mask (tests/test_torch_hpr.py),
# and the pose gradient's translation moved 1.5e-3 of its largest entry
# between card and CPU (NVIDIA H100 80GB HBM3, 700 W).
HPR_TOL = 2e-3
# The frozen engine's f32 step (models/traj_frozen.py, the sparse mean over
# path 10's 14 waypoints) against the same step in float64 on the card: the
# largest error within 5e-3 of the largest entry. With the gate's norms taken
# in float64 and rounded once (ops.hpr.gate_norms, so that a refresh equals
# the routed tier) it came 3.0e-3 from float64 on the card;
# with the f32 norms it had before, 8.4e-4: the frozen engine trades that
# precision for refresh parity. [frozen] prints both (NVIDIA H100 80GB HBM3,
# 700 W). The JAX twin's own f32 gradient is up to 1.4e-2 of its largest
# entry from float64 on the planar scenes of tests/test_hpr.py.
BINNED_TOL = 5e-3
# The routed binned tier's trajectory step (path 10's first 3 waypoints), f32
# on the card and on the CPU, against the card's float64 step. With the
# gate's norms in f32 (the card's f32 sum of squares behind ρ and the
# directions) the card's step came 5.8e-3 of its largest entry from float64
# and the CPU's 2.8e-4; with the whole gate in float64, 3.8e-6; with the
# norms alone in float64, rounded once to f32 (ops.hpr.gate_norms), 2.5e-4
# on the card and 2.6e-4 on the CPU, card and CPU 2.9e-5 apart. [hpr] prints
# the step with the f32 norms beside the one held here (NVIDIA H100 80GB
# HBM3, 700 W). The step is deterministic on both devices.
BINNED_STEP_TOL = 1e-3
# [frozen], the frozen-routing engine (models/traj_frozen.py), at bench.py's
# shapes: bench_soft_hpr_traj_step (warm-up steps, windows, steps per
# window), bench_frozen_pose_long_range (points, timed steps), the waypoints
# demo's 27 waypoints (timed steps) and bench_occl_traj_worst_window (steps,
# steps per window). At a refresh the frozen losses are held to
# tests/test_torch_traj_frozen.py's pins: against the per-step routed binned
# tier loss rtol 1e-5, rewards atol 1e-6, gradient relnorm 1e-4; the sparse
# mean against the embedding path loss rtol 1e-6, mean reward atol 1e-6,
# gradient relnorm 1e-4; the pose and waypoints variants rtol 1e-4.
FROZEN_WINDOWS = (2, 3, 8)
FROZEN_POSE = (262_144, 8)
FROZEN_WPS_STEPS = 5
WORST = (200, 20)
FROZEN_HELD = 24  # trajectory steps held captured == eager: refreshes at 0, 8, 16
FROZEN_HELD_VARIANT = (6, 2)  # pose and waypoints: steps held, refresh_every
FROZEN_REPLAYS = 20  # timed replays of a frozen step's graph alone
FROZEN_PINS = {"loss": 1e-5, "rewards": 1e-6, "grad": 1e-4, "mean": 1e-6, "variant": 1e-4}


def splat_work(offsets, entries, use_runs: bool, tiles_y: int, tiles_x: int):
    """(bytes, covered (entry, pixel) pairs) that a blend needs on these
    inputs: the offsets, the entries it blends (K6: those binned in the grid;
    K7: those its cap keeps) and the planar image written once."""
    import torch

    n_tiles, Hp, Wp = tiles_y * tiles_x, tiles_y * 32, tiles_x * 128
    off = offsets.long()
    if use_runs:
        kept = entries[: int(off[-1])]
        y_lo, x_lo, y_hi, x_hi = 0, 0, Hp, Wp
    else:
        pos = torch.arange(entries.shape[0], device=entries.device)
        tile = torch.searchsorted(off, pos, right=True) - 1
        keep = (tile < n_tiles) & (pos - off[torch.clamp(tile, max=n_tiles - 1)] < MAX_E)
        kept, t = entries[keep], tile[keep]
        y_lo, x_lo = (t // tiles_x * 32).float(), (t % tiles_x * 128).float()
        y_hi, x_hi = y_lo + 32, x_lo + 128
    u, v, r2 = kept[:, 0], kept[:, 1], kept[:, 3]
    pairs = 0
    for dy in range(-4, 5):  # r^2 <= max_radius_px^2 = 16
        for dx in range(-4, 5):
            yy, xx = v + dy, u + dx
            pairs += int(((dy * dy + dx * dx <= r2) & (yy >= y_lo) & (yy < y_hi)
                          & (xx >= x_lo) & (xx < x_hi)).sum())
    return 4 * (n_tiles + 1) + 32 * kept.shape[0] + 12 * Hp * Wp, pairs


def traced(fn, sync):
    """Run fn once under torch.profiler: (profile, wall ms, device activities,
    device-busy µs, the union of the device intervals)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    return prof, wall_ms, len(spans), busy_us


def trace_call(fn, sync):
    """(wall ms, device-busy ms, top host ops [(name, self CPU ms)]) of one
    call of fn; device-busy is None when the trace holds no device activity."""
    prof, wall_ms, n_spans, busy_us = traced(fn, sync)
    top = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)[:4]
    return (wall_ms, busy_us / 1e3 if n_spans else None,
            [(e.key, e.self_cpu_time_total / 1e3) for e in top])


def render_checks(dev, intr, clouds, cuda_ms, kernel_ms, sync):
    """Phases 5 and 6: K6/K7 against their plain versions, then the points
    processor's rig over each cloud. Returns the numbers for [times] and the
    record."""
    import gc

    import numpy as np
    import torch

    from trajectory_optimization_tpu_torch.bus.core import Bus
    from trajectory_optimization_tpu_torch.bus.messages import CameraInfoMsg, CloudMsg, Header
    from trajectory_optimization_tpu_torch.bus.nodes import PointsProcessorNode
    from trajectory_optimization_tpu_torch.ops import _kernels
    from trajectory_optimization_tpu_torch.ops import tile_render as tr
    from trajectory_optimization_tpu_torch.ops.render import render_point_cloud
    from trajectory_optimization_tpu_torch.utils.config import PointsProcessorConfig
    from trajectory_optimization_tpu_torch.utils.data import pad_points, splat_cases

    H, W = int(intr.height), int(intr.width)
    tiles_y, tiles_x = tr.tile_grid(H, W)
    Kd = intr.matrix(device=dev)
    cams = [f"cam{i}" for i in range(6)]
    kflat = tuple(intr.matrix_np(np.float64).reshape(-1))
    cfg = PointsProcessorConfig(pc_topic="/cloud", hpr_backend="none")
    clip = dict(znear=cfg.frustum_min_dist, zfar=cfg.frustum_max_dist)

    def make_node(topics=(), render=True):
        bus = Bus(error_policy="raise")
        node = PointsProcessorNode(
            bus, PointsProcessorConfig(pc_topic="/cloud", cam_info_topics=topics,
                                       hpr_backend="none", render=render), device=dev)
        for c, t in zip(cams, RING):
            node.frames.set_transform("world", c, t, [0, 0, 0, 1])
        return bus, node

    def infos():
        return [CameraInfoMsg(Header(stamp=0.0, frame_id=c), W, H, K=kflat) for c in cams]

    def cloud_msg(pts):
        return CloudMsg(Header(stamp=0.0, frame_id="world"), pts)

    def blend_both(P, kw, what):
        """The prologue on the card, then the kernel twice and its plain
        version on its output: both launches ``torch.equal`` to the plain
        image, n_dropped equal to the CPU prologue's. Returns (kernel name,
        kernel call, plain call, args, prologue outputs, max |err|)."""
        use_runs, offsets, entries, dropped = tr.splat_prologue(P, Kd, H, W, **kw)
        kname = "splat_runs" if use_runs else "splat_dense"
        if use_runs:
            args = (offsets, entries, tiles_y, tiles_x, 1.0)
            kern, plain = _kernels.splat_runs, tr.splat_runs_ref
        else:
            args = (offsets, entries, kw.get("max_entries_per_tile", MAX_E), tiles_y, tiles_x, 1.0)
            kern, plain = _kernels.splat_dense, tr.splat_dense_ref
        got, again, want = kern(*args), kern(*args), plain(*args)
        sync()
        if not torch.equal(got, want):
            fail(f"{kname} {what}: {int((got != want).sum())} values differ from the plain "
                 f"version (max |err| {float((got - want).abs().max()):.3e})")
        if not torch.equal(again, got):
            fail(f"{kname} {what}: a second launch differs from the first")
        # n_dropped of the card's prologue == the CPU prologue's, exactly
        dropped_cpu = tr.splat_prologue(P.cpu(), Kd.cpu(), H, W, **{
            k: (v.cpu() if torch.is_tensor(v) else v) for k, v in kw.items()})[3]
        if int(dropped) != int(dropped_cpu):
            fail(f"{kname} {what}: n_dropped {int(dropped)} on the card, "
                 f"{int(dropped_cpu)} on the CPU")
        return kname, kern, plain, args, (use_runs, offsets, entries, dropped), float(
            (got - want).abs().max())

    res = {"err": {n: 0.0 for n in SPLAT}, "ms": {}, "plain_ms": {}, "bound": {}, "work": {},
           "kernel_ms": {}, "edge": {}, "prologue_ms": {}, "visible": {}, "launches": {},
           "rig_ms": {}, "rig_first_s": {}, "peak_mib": {}, "dropped": {}, "trace": {}}

    # ---- 5. K6 and K7 against their plain versions, on the card ------------
    _, probe = make_node(render=False)
    for name, pts in clouds.items():
        visible = probe.process(cloud_msg(pts), infos()[0])
        padded, valid = pad_points(visible)
        res["visible"][name] = (len(visible), len(padded))
        P, V = torch.as_tensor(padded, device=dev), torch.as_tensor(valid, device=dev)
        for backend in ("runs", "dense"):
            kw = dict(valid=V, backend=backend, **clip)
            kname, kern, plain, args, (use_runs, offsets, entries, dropped), err = blend_both(
                P, kw, name)
            res["err"][kname] = max(res["err"][kname], err)
            img = tr.render_point_cloud_tiles(P, Kd, H, W, **kw)
            ref = render_point_cloud(P, Kd, H, W, valid=V, **clip)
            n_diff = int(((img - ref).abs().amax(dim=2) > 1e-3).sum())
            if not n_diff < PIN * H * W:
                fail(f"{kname} {name}: {n_diff} pixels differ from the scatter renderer")
            key = (name, kname)
            res["ms"][key] = cuda_ms(lambda: kern(*args), 20)
            res["kernel_ms"][key] = kernel_ms(lambda: kern(*args), f"{kname}_kernel")
            res["plain_ms"][key] = cuda_ms(lambda: plain(*args), 1)
            res["prologue_ms"][(name, backend)] = cuda_ms(
                lambda: tr.splat_prologue(P, Kd, H, W, **kw), 10)
            res["work"][key] = splat_work(offsets, entries, use_runs, tiles_y, tiles_x)
            res["bound"][key] = bound(res["work"][key][0], SPLAT_OPS * res["work"][key][1])
            print(f"[kernels] {kname} {name} cam0: {len(visible)} visible points padded to "
                  f"{len(padded)}, backend={backend}: image == plain version (torch.equal), "
                  f"a second launch == the first, "
                  f"n_dropped {int(dropped)} == CPU prologue's; {n_diff} of {H * W} pixels differ "
                  f"from the scatter renderer (pin {PIN:.1%})", flush=True)
            del img, ref
    # the edge cases: ties across tile, band and bin borders, r = 0.5 and 4
    # on the image's edges, every tile over the dense path's cap
    for cname, (pts, kw_c) in splat_cases(intr.matrix_np(), H, W).items():
        P = torch.as_tensor(pts, device=dev)
        for backend in ("runs", "dense"):
            kname, _, _, _, (_, offsets, entries, dropped), err = blend_both(
                P, dict(backend=backend, **clip, **kw_c), cname)
            res["err"][kname] = max(res["err"][kname], err)
            counts = (offsets[1:] - offsets[:-1])[: tiles_y * tiles_x]
            if cname == "over_cap" and kname == "splat_dense" and not (
                    bool((counts > MAX_E).all()) and int(dropped) > 0):
                fail(f"over_cap: {int((counts <= MAX_E).sum())} tiles within the cap, "
                     f"n_dropped {int(dropped)}")
            res["edge"][(cname, kname)] = (len(entries), int(dropped))
        print(f"[kernels] edge case {cname} ({len(pts)} points, {W}x{H}): K6 and K7 images == "
              f"plain versions (torch.equal), second launches == first, n_dropped "
              f"{res['edge'][(cname, 'splat_dense')][1]} == CPU prologue's", flush=True)
        del P
    del probe
    gc.collect()  # a node and its bus reference each other

    # ---- 6. the points processor's rig over each cloud, through the bus ----
    for name, pts in clouds.items():
        want = "splat_runs" if name == "cloud10" else "splat_dense"
        bus, node = make_node(tuple(f"/{c}/info" for c in cams))
        images = {}
        for c in cams:
            bus.subscribe(f"/{c}/pointcloud_image", lambda m, c=c: images.__setitem__(c, m.data))
        msgs = infos()
        gc.collect()
        torch.cuda.empty_cache()
        sync()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        bus.publish("/cloud", cloud_msg(pts))
        for c, info in zip(cams, msgs):
            bus.publish(f"/{c}/info", info)
        sync()
        res["rig_first_s"][name] = time.perf_counter() - t0
        launches = dict(_kernels.LAUNCHES)
        res["launches"][name] = launches
        res["peak_mib"][name] = torch.cuda.max_memory_allocated() / 2**20
        if node.n_batched != 1 or sorted(images) != cams:
            fail(f"rig {name}: {node.n_batched} batched evaluations, images from {sorted(images)}")
        ran = {n for n, v in launches.items() if v}
        if ran != {want} or launches[want] != len(cams):
            fail(f"rig {name} launched {launches}; expected {want} once per camera only")
        visible = {c: bus.latest(f"/{c}/pointcloud_visible").points for c in cams}
        for c in cams:
            n_pad = len(pad_points(visible[c])[0])
            if (n_pad <= tr.RUN_PATH_MAX_ENTRIES) != (want == "splat_runs"):
                fail(f"rig {name} {c}: padded visible count {n_pad} leaves the {want} path")
            img = images[c]
            if not (img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
                    and float(img.min()) >= 0.0 and float(img.max()) <= 1.0
                    and bool((img < 1.0).any())):
                fail(f"rig {name} {c}: malformed image {tuple(img.shape)}")
        serial = node.process(cloud_msg(pts), msgs[0])
        if abs(len(serial) - len(visible["cam0"])) > max(3, 0.01 * len(visible["cam0"])):
            fail(f"rig {name}: serial cam0 {len(serial)} vs batched {len(visible['cam0'])} points")
        res["dropped"][name] = node.metrics.snapshot().get("render_dropped_splats", 0.0)
        times = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            node.process_all(cloud_msg(pts), msgs)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        res["rig_ms"][name] = statistics.median(times)
        res["trace"][name] = trace_call(lambda: node.process_all(cloud_msg(pts), msgs), sync)
        print(f"[slice] rig {name} ({len(pts)} points, 6 cameras at {W}x{H}): first process_all "
              f"over the bus {res['rig_first_s'][name]:.3f} s; visible per camera "
              f"{[len(visible[c]) for c in cams]}; serial cam0 {len(serial)}; launches {launches}; "
              f"render_dropped_splats {res['dropped'][name]:.0f}; images (1616, 1232, 3), finite, "
              f"in [0, 1], not all background", flush=True)
        del bus, node, images
        gc.collect()
    return res


def plain_loops():
    """tests/torch_loop_ref.py: the plain loops (fresh tensors every step, no
    capture) that the captured ones are held to bit for bit. The module
    imports torch and the port only."""
    tests = str(ROOT / "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    import torch_loop_ref

    return torch_loop_ref


def traj_run_on(route, runner, *args):
    """``runner``'s call (a ``TrajRunner``): captured (``"graph"``) or the same
    call on the plain loop (``"eager"``, the reference)."""
    if route == "graph":
        return runner(*args)
    return plain_loops().traj_run(runner.problem, runner.cfg, runner.stop, runner.n_steps, *args)


def pose_advance_on(route, advance, *args):
    """``advance``'s call (a ``PoseAdvance``): captured (``"graph"``) or the
    same segment on the plain loop (``"eager"``, the reference)."""
    if route == "graph":
        return advance(*args)
    return plain_loops().pose_advance(advance.problem, advance.cfg, advance.seg_steps, *args)


def plain_f64_run(dev, cloud, path, n_steps, kw):
    """``n_steps`` of the plain path (backend "torch") in float64 on the
    facade's padded data, from the identity orientations, on the plain loop
    of tests/torch_loop_ref.py: (positions
    (W, 3), normalized wxyz quaternions (W, 4)) as float64 arrays."""
    import numpy as np
    import torch

    from trajectory_optimization_tpu_torch.models.traj import TrajProblem, waypoint_stride
    from trajectory_optimization_tpu_torch.opt.engine import NEVER, OptimizerConfig
    from trajectory_optimization_tpu_torch.opt.runners import TrajRunner
    from trajectory_optimization_tpu_torch.utils.data import identity_quaternions, pad_points
    from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics

    intr = default_intrinsics()
    padded, valid = pad_points(cloud)
    q0 = identity_quaternions(len(path))
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64, device=dev)  # noqa: E731
    prob = TrajProblem(intr.width, intr.height, wps_step=waypoint_stride(path), backend="torch")
    run = TrajRunner(prob, OptimizerConfig(**kw), NEVER, n_steps)
    p, _, _, _ = traj_run_on("eager", run, {"poses": t(path).clone(), "quats": t(q0).clone()},
                           t(padded), t(valid), intr.matrix(dtype=torch.float64, device=dev),
                           t(path), t(q0))
    q = p["quats"] / torch.linalg.norm(p["quats"], dim=1, keepdim=True)
    return p["poses"].cpu().numpy(), q.cpu().numpy()


def stepwise_parity(dev, cloud, path, n_steps, kw, *, perm_seed=None):
    """The kernel backend's own ``n_steps`` from the facade's start (padded
    cloud, identity orientations), eagerly: the trajectory that
    ``TrajectoryOptimizer`` and ``TrajOptNode`` replay captured. At each
    step the kernel backend's loss, aux, rewards, gradients and Adam update
    beside those of ``fused_lo_sum`` + ``traj_criterion`` (the plain
    criterion around the same visibility kernels) taken from the same
    parameters and Adam state. ``perm_seed`` permutes the cloud first (the
    same problem, the sums in another order). Returns the worst gap of each
    kind over the steps with the step it came at, as shares of ``STEP_PINS``
    ("share", at most 1 where every step holds) and raw ("gap"), the
    rewards' equality, and the final parameters."""
    import numpy as np
    import torch

    from trajectory_optimization_tpu_torch.models.traj import (
        TrajProblem, init_traj_params, traj_criterion, traj_forward, waypoint_stride,
    )
    from trajectory_optimization_tpu_torch.ops import fused_vis as fv
    from trajectory_optimization_tpu_torch.ops.fused_traj import AUX
    from trajectory_optimization_tpu_torch.opt.engine import (
        OptimizerConfig, _adam_steps, adam_init, adam_update, group_lrs, value_and_grad,
    )
    from trajectory_optimization_tpu_torch.utils.data import identity_quaternions, pad_points
    from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics

    if perm_seed is not None:
        cloud = cloud[np.random.default_rng(perm_seed).permutation(len(cloud))]
    intr = default_intrinsics()
    padded, valid = pad_points(cloud)
    q0 = identity_quaternions(len(path))
    P, V = torch.as_tensor(padded, device=dev), torch.as_tensor(valid, device=dev)
    Pt, K = P.t().contiguous(), intr.matrix(device=dev)
    p0 = torch.as_tensor(path, device=dev)
    qq0 = torch.as_tensor(np.asarray(q0, np.float32), device=dev)
    prob = TrajProblem(intr.width, intr.height, wps_step=waypoint_stride(path), backend="kernel")
    sel = slice(None, None, prob.wps_step)
    cfg = OptimizerConfig(**kw)
    lrs = group_lrs(cfg)

    def kernel_loss(p):
        return traj_forward(p, P, K, p0, qq0, prob, valid=V, points_t=Pt)

    def plain_loss(p):
        lo = fv.fused_lo_sum(P, p["quats"][sel], p["poses"][sel], K, intr.width, intr.height,
                             valid=V, points_t=Pt)
        return traj_criterion(lo, p, p0, prob, valid=V)

    params = init_traj_params(path, q0, dev)
    state = adam_init(params)
    worst = {"share": {}, "gap": {}, "rewards_equal": True}

    def note(kind, gap, pin, i):
        if not gap / pin <= worst["share"].get(kind, (-1.0,))[0]:  # a NaN is kept
            worst["share"][kind], worst["gap"][kind] = (gap / pin, i), (gap, i)

    for i in range(n_steps):
        lk, ak, gk = value_and_grad(kernel_loss, params)
        lp, ap, gp = value_and_grad(plain_loss, params)
        uk, up = (_adam_steps(g, state, cfg, lrs)[0] for g in (gk, gp))
        note("loss", abs(float(lk) / float(lp) - 1.0), STEP_PINS["loss"], i)
        rtol, atol = STEP_PINS["aux"]
        for key in AUX:
            a, b = float(ak[key]), float(ap[key])
            note("aux", abs(a - b), atol + rtol * abs(b), i)
        worst["rewards_equal"] &= bool(torch.equal(ak["rewards"], ap["rewards"]))
        for k, lr in (("poses", cfg.lr_pose), ("quats", cfg.lr_quat)):
            note(f"grad_{k}", float((gk[k] - gp[k]).abs().max() / gp[k].abs().max()),
                 STEP_PINS["grad"], i)
            note(f"update_{k}", float((uk[k] - up[k]).abs().max()) / lr, STEP_PINS["update"], i)
        params, state = adam_update(gk, state, params, cfg, lrs)
    worst["params"] = {k: v.double().cpu().numpy() for k, v in params.items()}
    return worst


def node_checks(dev, clouds, path10, sync):
    """Phase 7: the optimizer nodes, the pose optimizer and the voxel
    operations on the card. ``clouds`` holds cloud 10 ("cloud10"), the
    seeded 1M cloud ("1m") and the 8,388,608-point cloud ("8m"). Returns the
    numbers for [times] and the record."""
    import gc

    import numpy as np
    import torch

    from trajectory_optimization_tpu_torch import native
    from trajectory_optimization_tpu_torch.api import PoseOptimizer, TrajectoryOptimizer
    from trajectory_optimization_tpu_torch.bus.core import Bus
    from trajectory_optimization_tpu_torch.bus.messages import CloudMsg, Header, PathMsg
    from trajectory_optimization_tpu_torch.bus.nodes import (
        CloudFeederNode, PoseFeederNode, PoseOptNode, TrajOptNode, VoxelFilterNode,
    )
    from trajectory_optimization_tpu_torch.ops import _kernels
    from trajectory_optimization_tpu_torch.ops import voxel as vox
    from trajectory_optimization_tpu_torch.opt.engine import EarlyStop
    from trajectory_optimization_tpu_torch.utils.config import (
        CloudFeederConfig, PoseFeederConfig, PoseOptNodeConfig, TrajOptNodeConfig,
        VoxelFilterConfig,
    )

    res = {"traj_msgs_per_s": {}, "traj_callback_ms": {}}
    data_dir = str(ROOT / "data" / "points")
    cloud10 = clouds["cloud10"]

    # ---- TrajOptNode over the bus: cloud 10 from the feeder, path 10, ------
    # bench.py's node settings (30 steps, lr_quat 0.02, rewards_th inf)
    paths = {}
    per_msg = {"pass_a": 31 * NODE_MSGS, "pass_b": 31 * NODE_MSGS,
               "bwd_stats": 30 * NODE_MSGS, "bwd_apply": 30 * NODE_MSGS,
               **{n: 31 * NODE_MSGS for n in LOSS_FWD}, **{n: 30 * NODE_MSGS for n in LOSS_BWD}}
    for depth in (1, 2):
        bus = Bus(error_policy="raise")
        node = TrajOptNode(bus, TrajOptNodeConfig(
            pc_topic="/pc", path_topic="/path", opt_steps=30, lr_pose=0.1, lr_quat=0.02,
            rewards_th=float("inf"), pipeline_depth=depth), device=dev)
        CloudFeederNode(bus, CloudFeederConfig(output_topic="/pc", pc_index=10,
                                               data_dir=data_dir, frame_id="map")).tick()
        fed = bus.latest("/pc").points
        if not np.array_equal(fed, cloud10):
            fail("CloudFeederNode(pc_index=10) did not publish cloud 10")
        out = []
        bus.subscribe("/path/optimized", out.append)

        def send(stamp, bus=bus, fed=fed):
            bus.publish("/pc", CloudMsg(Header(stamp=stamp, frame_id="map"), fed))
            bus.publish("/path", PathMsg.straight(path10, frame_id="map", stamp=stamp))

        send(0.0)  # warm-up
        node.flush()
        sync()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        for i in range(NODE_MSGS):
            send(10.0 * (i + 1))
        node.flush()
        sync()
        dt = time.perf_counter() - t0
        launches = dict(_kernels.LAUNCHES)
        if {n: v for n, v in launches.items() if v} != per_msg:
            fail(f"TrajOptNode depth {depth}: {NODE_MSGS} messages launched {launches}; "
                 f"expected {per_msg} (K1 = K2 = 31, K3 = K4 = 30 per message, the loss's "
                 f"forward kernels 31 and its backward kernels 30)")
        if len(out) != NODE_MSGS + 1 or node.last_result["n_iters"] != 30:
            fail(f"TrajOptNode depth {depth}: {len(out)} paths published, last n_iters "
                 f"{node.last_result['n_iters']}")
        res["traj_msgs_per_s"][depth] = NODE_MSGS / dt
        res["traj_callback_ms"][depth] = node.metrics.gauges["last_callback_ms"]
        paths[depth] = out
        if depth == 1:
            res["traj_trace"] = trace_call(lambda: (send(1e4), node.flush()), sync)
        node.close()
        del bus, node
        gc.collect()
    for a, b in zip(paths[1], paths[2]):
        if not (np.array_equal(a.positions, b.positions)
                and np.array_equal(a.orientations_xyzw, b.orientations_xyzw)):
            fail("TrajOptNode: depth 2 published another path than depth 1")
    first = paths[1][0]
    stop = EarlyStop(rewards_th=float("inf"), smoothness_th=0.9)
    kw = dict(lr_pose=0.1, lr_quat=0.02)
    fac = TrajectoryOptimizer(device=dev, **kw).optimize(cloud10, path10, n_steps=30,
                                                          early_stop=stop)
    fac_q = fac.quats_wxyz[:, [1, 2, 3, 0]]
    if not (np.array_equal(first.positions, fac.poses)
            and np.array_equal(first.orientations_xyzw, fac_q)):
        fail("TrajOptNode's first path differs from TrajectoryOptimizer(device='cuda')'s: "
             f"max |d pose| {np.abs(first.positions - fac.poses).max():.3e}")
    plain = TrajectoryOptimizer(device=dev, backend="torch", **kw).optimize(
        cloud10, path10, n_steps=30, early_stop=stop)
    short = TrajectoryOptimizer(device=dev, **kw).optimize(cloud10, path10, n_steps=5,
                                                            early_stop=stop)

    def f64_gap(poses, quats_wxyz, ref):
        q = quats_wxyz / np.linalg.norm(quats_wxyz, axis=1, keepdims=True)
        return (float(np.abs(poses - ref[0]).max()), float(np.abs(q - ref[1]).max()))

    steps = stepwise_parity(dev, cloud10, path10, 30, kw)
    if not np.array_equal(steps["params"]["poses"], fac.poses):
        fail("[nodes] stepwise_parity's 30 eager steps left another path than "
             f"TrajectoryOptimizer's: max |d pose| "
             f"{np.abs(steps['params']['poses'] - fac.poses).max():.3e}")
    shares = {k: v[0] for k, v in steps["share"].items()}
    if not (all(v <= 1.0 for v in shares.values()) and steps["rewards_equal"]):
        fail(f"[nodes] a step of TrajOptNode's 30 against the plain criterion's from the same "
             f"state: worst (gap, step) {steps['gap']}, pins {STEP_PINS}, rewards torch.equal "
             f"at every step: {steps['rewards_equal']}")
    f64_5, f64_30 = (plain_f64_run(dev, cloud10, path10, n, kw) for n in (5, 30))
    gap = (*f64_gap(first.positions, fac.quats_wxyz, f64_30),
           abs(float(fac.rewards.mean()) / float(plain.rewards.mean()) - 1.0),
           *f64_gap(plain.poses, plain.quats_wxyz, f64_30),
           *f64_gap(short.poses, short.quats_wxyz, f64_5))
    if not (max(gap[5:7]) <= NODE_TOL_5 and gap[2] <= 1e-4):
        fail(f"TrajOptNode: after 5 steps {gap[5]:.3e} m, {gap[6]:.3e} from the plain path's "
             f"float64 run (pin {NODE_TOL_5}); mean reward after 30 {gap[2]:.3e} relative to "
             f"backend='torch' (pin 1e-4)")
    res["traj_gap"] = gap
    res["traj_steps"] = steps["gap"]
    print(f"[nodes] TrajOptNode over the bus (cloud 10 from CloudFeederNode(pc_index=10), path "
          f"10, 30 steps, lr_quat 0.02, rewards_th inf): 1 + {NODE_MSGS} messages at depth 1 "
          f"and at depth 2, every published path equal; launches per {NODE_MSGS} messages "
          f"{per_msg}; the first path == TrajectoryOptimizer(device='cuda').optimize's "
          f"== its 30 eager steps' (np.array_equal); each step against the plain criterion's "
          f"from the same state, worst (gap, step): " + ", ".join(
              f"{k} ({v[0]:.2e}, {v[1]})" for k, v in steps["gap"].items())
          + f" (pins {STEP_PINS}), the rewards torch.equal at every step; after 5 steps (the "
          f"facade) {gap[5]:.3e} m, {gap[6]:.3e} from the plain path's float64 run (pin "
          f"{NODE_TOL_5}); mean reward {gap[2]:.3e} relative to backend='torch' (pin 1e-4); "
          f"after 30 steps, not held: {gap[0]:.3e} m, {gap[1]:.3e} from the float64 run "
          f"(backend='torch' in float32: {gap[3]:.3e} m, {gap[4]:.3e})", flush=True)

    # ---- PoseOptNode with both feeders: the reference's pose launch --------
    bus = Bus(error_policy="raise")
    node = PoseOptNode(bus, PoseOptNodeConfig(pc_topic="/pts", pose_topic="/pose",
                                              opt_steps=200, num_pub_samples=20), device=dev)
    clouds_in = CloudFeederNode(bus, CloudFeederConfig(output_topic="/pts", pc_index=10,
                                                       data_dir=data_dir))
    poses_in = PoseFeederNode(bus, PoseFeederConfig(output_topic="/pose", x=6.0, y=2.0, z=0.0,
                                                    roll=0.0, pitch=0.0, yaw=0.0))
    odoms = []
    bus.subscribe("/odom", odoms.append)
    cb_ms = []
    for _ in range(3):
        odoms.clear()
        clouds_in.tick()
        poses_in.tick()
        sync()
        cb_ms.append(node.metrics.gauges["last_callback_ms"])
    last = odoms[-1].position if odoms else None
    if len(odoms) != 20 or not all(np.all(np.isfinite(o.position))
                                   and np.all(np.isfinite(o.orientation_xyzw)) for o in odoms):
        fail(f"PoseOptNode: {len(odoms)} /odom messages (expected 20, all finite)")
    pose_kw = dict(lr_pose=0.1, lr_quat=0.0)
    ref = PoseOptimizer(device=dev, **pose_kw).optimize(cloud10, [6.0, 2.0, 0.0], n_steps=200)
    if not np.array_equal(last, ref.position):
        fail(f"PoseOptNode's last /odom {last} != PoseOptimizer's 200-step {ref.position}")
    res["pose_callback_ms"] = cb_ms[1:]
    node.close()
    del bus, node
    gc.collect()
    print(f"[nodes] PoseOptNode with CloudFeederNode(pc_index=10) and PoseFeederNode at (6, 2, 0), "
          f"roll = pitch = yaw = 0, 200 steps, 20 samples: 20 finite /odom messages per "
          f"callback; the last {np.round(last, 6).tolist()} == PoseOptimizer(device='cuda')'s "
          f"200-step position (np.array_equal)", flush=True)

    # ---- PoseOptimizer at cloud 10 and 1M: 200 steps, and 20 against the CPU
    res["pose_ms_per_step"] = {}
    for name in ("cloud10", "1m"):
        pts = clouds[name]
        opt = PoseOptimizer(device=dev, **pose_kw)
        opt.optimize(pts, [6.0, 2.0, 0.0], n_steps=5)  # warm-up
        sync()
        t0 = time.perf_counter()
        r = opt.optimize(pts, [6.0, 2.0, 0.0], n_steps=200)
        sync()
        res["pose_ms_per_step"][name] = (time.perf_counter() - t0) * 1e3 / 200
        if not (np.all(np.isfinite(r.position)) and np.isfinite(r.loss)
                and r.observations.shape == (len(pts),) and np.all(np.isfinite(r.observations))):
            fail(f"PoseOptimizer {name}: non-finite or malformed result")
    runs = [PoseOptimizer(device=d, **pose_kw).optimize(cloud10, [6.0, 2.0, 0.0], n_steps=20)
            for d in (dev, "cpu")]
    pose_err = 0.0
    for k in ("position", "quat_wxyz", "observations", "loss"):
        got, want = (np.asarray(getattr(r, k), np.float64) for r in runs)
        if not np.allclose(got, want, rtol=1e-4, atol=1e-5):
            fail(f"PoseOptimizer cloud10 20 steps, card vs CPU: {k} max |err| "
                 f"{np.abs(got - want).max():.3e} over rtol 1e-4 / atol 1e-5")
        pose_err = max(pose_err, float(np.abs(got - want).max()))
    res["pose_card_vs_cpu"] = pose_err
    print(f"[nodes] PoseOptimizer 200 steps at cloud10 and 1m ({len(clouds['1m'])} points, "
          f"camera inside the cloud): finite; 20 steps at cloud10 on the card == on the CPU "
          f"within rtol 1e-4 / atol 1e-5 (max |err| {pose_err:.3e})", flush=True)

    # ---- the voxel filter on the native library, and the voxel ops --------
    if not native.native_available():
        fail("native_available() is false: the C++ host library did not build")
    bus = Bus(error_policy="raise")
    VoxelFilterNode(bus, VoxelFilterConfig(input_topic="/in", output_topic="/out", leaf_size=0.15))
    bus.publish("/in", CloudMsg(Header(stamp=0.0), cloud10))
    got = bus.latest("/out").points
    want = vox.voxel_downsample(cloud10, 0.15)

    def lex(x):
        return x[np.lexsort((x[:, 2].round(4), x[:, 1].round(4), x[:, 0].round(4)))]

    if got.shape != want.shape or not np.allclose(lex(got), lex(want), rtol=0, atol=1e-4):
        fail(f"VoxelFilterNode (C++) on cloud 10: {got.shape} vs numpy {want.shape}")
    res["voxel_count"] = len(got)
    t0 = time.perf_counter()
    bus.publish("/in", CloudMsg(Header(stamp=0.0), clouds["8m"]))
    res["voxel_filter_ms_8m"] = (time.perf_counter() - t0) * 1e3
    res["voxel_count_8m"] = len(bus.latest("/out").points)
    del bus
    P_dev, P_cpu = torch.as_tensor(cloud10, device=dev), torch.as_tensor(cloud10)
    (c_dev, o_dev), (c_cpu, o_cpu) = (vox.voxel_downsample_jit(P, 0.15, table_size=1 << 20)
                                      for P in (P_dev, P_cpu))
    g_dev, g_cpu = (vox.occupancy_grid_jit(P) for P in (P_dev, P_cpu))
    if not (torch.equal(o_dev.cpu(), o_cpu) and torch.equal(g_dev.cpu(), g_cpu)):
        fail("voxel_downsample_jit's occupied mask or occupancy_grid_jit's grid differs "
             "between the card and the CPU")
    c_err = float((c_dev.cpu() - c_cpu).abs().max())
    share = float((g_cpu.numpy() == vox.occupancy_grid(cloud10)).mean())
    if not (c_err <= 1e-5 and share >= 0.999):
        fail(f"voxel ops on the card: centroids {c_err:.3e} from the CPU's (pin 1e-5), grid "
             f"equal to numpy's on {share:.5%} of cells (pin 99.9%)")
    res["voxel_jit"] = (int(o_dev.sum()), int(g_dev.sum()), c_err, share)
    print(f"[nodes] native_available() true; VoxelFilterNode (C++) on cloud 10 at leaf 0.15: "
          f"{len(got)} centroids == numpy's count, within 1e-4 after lexsort; on the 8m cloud "
          f"{res['voxel_count_8m']} centroids; voxel_downsample_jit on the card: "
          f"{res['voxel_jit'][0]} occupied slots torch.equal to the CPU's, centroids within "
          f"{c_err:.3e}; occupancy_grid_jit: {res['voxel_jit'][1]} cells torch.equal to the "
          f"CPU's, {share:.5%} of cells equal to numpy's", flush=True)
    return res


def approx_pairs(C: int, n: int, n_passes: int = 16, full_passes: int = 4) -> int:
    """(probe row, point) pairs hpr_mask_approx sweeps for C clouds of n
    points: ``full_passes`` passes over every row, then ⌈n/4⌉ rows."""
    return C * n * (full_passes * n + (n_passes - full_passes) * -(-n // 4))


def hpr_checks(dev, intr, cloud10, path10, sync, cuda_ms):
    """Phase [hpr]: hidden-point removal on the card. The points processor
    at its default configuration (``hpr_backend="approx"``) and with
    ``"exact"`` over the bus, the approximate mask on the full cloud 10,
    ``PoseOptimizer``/``PoseOptNode`` with ``use_hpr``, and soft HPR in the
    pose and trajectory losses at the dense size. Returns the numbers for
    [times] and the record."""
    import gc

    import numpy as np
    import torch

    from trajectory_optimization_tpu_torch.api import PoseOptimizer, TrajectoryOptimizer
    from trajectory_optimization_tpu_torch.bus import nodes as nodes_mod
    from trajectory_optimization_tpu_torch.bus.core import Bus
    from trajectory_optimization_tpu_torch.bus.messages import (
        CameraInfoMsg, CloudMsg, Header, PoseMsg,
    )
    from trajectory_optimization_tpu_torch.models.pose import (
        PoseProblem, init_pose_params, pose_forward,
    )
    from trajectory_optimization_tpu_torch.models.traj import (
        init_traj_params, traj_forward, waypoint_stride,
    )
    from trajectory_optimization_tpu_torch.ops import _kernels
    from trajectory_optimization_tpu_torch.ops import hpr
    from trajectory_optimization_tpu_torch.ops.voxel import voxel_downsample
    from trajectory_optimization_tpu_torch.utils.config import (
        PointsProcessorConfig, PoseOptNodeConfig,
    )
    from trajectory_optimization_tpu_torch.utils.data import (
        bucket_size, identity_quaternions, pad_points,
    )

    res = {"rig": {}, "process_all_ms": {}}
    H, W = int(intr.height), int(intr.width)
    cams = [f"cam{i}" for i in range(6)]
    topics = tuple(f"/{c}/info" for c in cams)
    kflat = tuple(intr.matrix_np(np.float64).reshape(-1))
    msgs = [CameraInfoMsg(Header(stamp=0.0, frame_id=c), W, H, K=kflat) for c in cams]

    def cloud_msg(pts):
        return CloudMsg(Header(stamp=0.0, frame_id="world"), pts)

    def rows(a):
        return {tuple(r) for r in np.asarray(a, np.float32).tolist()}

    # every approx pursuit the node starts, by the shape of its input
    calls = []
    real_approx = nodes_mod.hpr_mask_approx

    def counting_approx(points, **kw):
        calls.append(tuple(points.shape))
        return real_approx(points, **kw)

    nodes_mod.hpr_mask_approx = counting_approx

    # ---- the points processor at its default configuration, then "exact" --
    for backend in ("approx", "exact", "none"):
        bus = Bus(error_policy="raise")
        cfg = PointsProcessorConfig(pc_topic="/cloud", cam_info_topics=topics)
        if backend != "approx":  # the default configuration is "approx"
            cfg = PointsProcessorConfig(pc_topic="/cloud", cam_info_topics=topics,
                                        hpr_backend=backend)
        node = nodes_mod.PointsProcessorNode(bus, cfg, device=dev)
        for c, t in zip(cams, RING):
            node.frames.set_transform("world", c, t, [0, 0, 0, 1])
        images = {}
        for c in cams:
            bus.subscribe(f"/{c}/pointcloud_image", lambda m, c=c: images.__setitem__(c, m.data))
        if backend != "none":
            calls.clear()
            _kernels.reset_launches()
            bus.publish("/cloud", cloud_msg(cloud10))
            for c, info in zip(cams, msgs):
                bus.publish(f"/{c}/info", info)
            sync()
            launches = {n: v for n, v in _kernels.LAUNCHES.items() if v}
            batched_calls = list(calls)
            culled = [bus.latest(f"/{c}/pointcloud").points for c in cams]
            visible = [bus.latest(f"/{c}/pointcloud_visible").points for c in cams]
            bucket = bucket_size(max(len(x) for x in culled))
            want_calls = [(6, bucket, 3)] if backend == "approx" else []
            if node.n_batched != 1 or batched_calls != want_calls or sorted(images) != cams:
                fail(f"rig cloud10 hpr_backend={backend!r}: {node.n_batched} batched "
                     f"evaluations, approx pursuits {batched_calls} (expected {want_calls}), images "
                     f"from {sorted(images)}")
            if set(launches) - set(SPLAT) or sum(launches.values()) != len(cams):
                fail(f"rig cloud10 hpr_backend={backend!r} launched {launches}; expected one "
                     f"splat kernel per camera")
            fps, recalls = [], []
            for c, cul, vis in zip(cams, culled, visible):
                exact = hpr.hpr_mask_exact(cul)
                truth, got = rows(cul[exact]), rows(vis)
                fps.append(len(got - truth))
                recalls.append(len(got & truth) / max(len(truth), 1))
                if backend == "exact" and not np.array_equal(vis, cul[exact]):
                    fail(f"rig cloud10 exact {c}: visible points != Qhull's on the culled points")
                img = images[c]
                if not (img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
                        and float(img.min()) >= 0.0 and float(img.max()) <= 1.0
                        and bool((img < 1.0).any())):
                    fail(f"rig cloud10 {backend} {c}: malformed image {tuple(img.shape)}")
            if any(fps) or min(recalls) < 0.98:
                fail(f"rig cloud10 {backend}: false positives against Qhull {fps}, recall "
                     f"{[round(r, 4) for r in recalls]} (pins 0 and 0.98)")
            serial = node.process(cloud_msg(cloud10), msgs[0])
            if abs(len(serial) - len(visible[0])) > max(3, 0.01 * len(visible[0])):
                fail(f"rig cloud10 {backend}: serial cam0 {len(serial)} vs batched "
                     f"{len(visible[0])} points")
            res["rig"][backend] = {"culled": [len(x) for x in culled],
                                   "visible": [len(x) for x in visible], "bucket": bucket,
                                   "false_positives": fps, "recall": recalls,
                                   "serial_cam0": len(serial), "launches": launches}
            print(f"[hpr] rig cloud10 (6 cameras at {W}x{H}, hpr_backend={backend!r}"
                  + (", the default" if backend == "approx" else "")
                  + f") over the bus: one batched process_all, approx pursuits {batched_calls}; culled "
                  f"{res['rig'][backend]['culled']}, visible {res['rig'][backend]['visible']}; "
                  f"against Qhull on each camera's culled points: false positives {fps}, recall "
                  f"{[round(r, 4) for r in recalls]} (pins 0 and 0.98); serial cam0 {len(serial)}; "
                  f"launches {launches}; images (1616, 1232, 3), finite, in [0, 1], not all "
                  f"background", flush=True)
            if backend == "approx":
                res["rig_hpr_ms"] = cuda_ms(lambda: nodes_mod._hpr_masks_rig(culled, dev), 3)
                padded = [pad_points(x, target=bucket) for x in culled]
                P = torch.as_tensor(np.stack([p for p, _ in padded]), device=dev)
                V = torch.as_tensor(np.stack([v for _, v in padded]), device=dev)
                res["rig_sweep_ms"] = cuda_ms(lambda: hpr.hpr_mask_approx(P, valid=V), 3)
                res["rig_sweep_trace"] = traced_share(lambda: hpr.hpr_mask_approx(P, valid=V),
                                                      sync)
                res["rig_pairs"] = approx_pairs(6, bucket)
                del P, V
        times = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            node.process_all(cloud_msg(cloud10), msgs)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        res["process_all_ms"][backend] = statistics.median(times)
        del bus, node, images
        gc.collect()
    nodes_mod.hpr_mask_approx = real_approx
    n8 = 524_288
    b8 = bound(0, HPR_SWEEP_OPS * approx_pairs(6, n8))
    res["rig_8m_estimate"] = (6 * n8 * n8, approx_pairs(6, n8), b8[0])
    print(f"[hpr] the 8m rig stays at hpr_backend='none' here: each camera's culled cloud pads "
          f"to ~{n8} points, and the pursuit would sweep 6 x {n8}^2 = {6 * n8 * n8:.3e} pairs "
          f"per full pass, {approx_pairs(6, n8):.3e} over its 16 passes; bound "
          f"{b8[0]:.1f} ms by {b8[1]} at {HPR_SWEEP_OPS} operations per pair", flush=True)

    # ---- hpr_mask_approx on the full cloud 10, against Qhull, twice --------
    cam = cloud10 - np.array([6.0, 2.0, 0.0], np.float32)
    padded, valid = pad_points(cam)
    P, V = torch.as_tensor(padded, device=dev), torch.as_tensor(valid, device=dev)
    m1 = hpr.hpr_mask_approx(P, valid=V)
    m2 = hpr.hpr_mask_approx(P, valid=V)
    if not torch.equal(m1, m2):
        fail(f"hpr_mask_approx on cloud 10: two runs differ on {int((m1 != m2).sum())} points")
    got = m1.cpu().numpy()[: len(cam)] > 0.5
    exact = hpr.hpr_mask_exact(cam)
    fp, recall = int((got & ~exact).sum()), float((got & exact).sum() / exact.sum())
    if fp or recall < 0.99:
        fail(f"hpr_mask_approx on cloud 10: {fp} false positives, recall {recall:.4f} "
             f"(pins 0 and 0.99)")
    res["full"] = {"n": len(cam), "padded": len(padded), "visible": int(got.sum()),
                   "qhull_visible": int(exact.sum()), "false_positives": fp, "recall": recall,
                   "ms": cuda_ms(lambda: hpr.hpr_mask_approx(P, valid=V), 2),
                   "pairs": approx_pairs(1, len(padded))}
    print(f"[hpr] hpr_mask_approx on the card, cloud 10 from (6, 2, 0) ({len(cam)} points padded "
          f"to {len(padded)}): {res['full']['visible']} visible, Qhull {int(exact.sum())}; false "
          f"positives {fp}, recall {recall:.4f} (pins 0 and 0.99); two runs torch.equal",
          flush=True)
    del P, V, m1, m2

    # ---- PoseOptimizer(use_hpr=True) and PoseOptNode(use_hpr=True) ---------
    start = [6.0, 2.0, 0.0]
    opt = PoseOptimizer(device=dev, use_hpr=True)
    r0 = opt.optimize(cloud10, start, n_steps=0)
    opt.optimize(cloud10, start, n_steps=5)  # warm-up
    sync()
    t0 = time.perf_counter()
    r = opt.optimize(cloud10, start, n_steps=200)
    sync()
    res["pose_hpr_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / 200
    if not (np.all(np.isfinite(r.position)) and np.isfinite(r.loss) and r.loss < r0.loss):
        fail(f"PoseOptimizer(use_hpr=True) cloud10 200 steps: loss {r.loss} from {r0.loss}, "
             f"position {r.position}")
    bus = Bus(error_policy="raise")
    node = nodes_mod.PoseOptNode(bus, PoseOptNodeConfig(
        pc_topic="/pts", pose_topic="/pose", opt_steps=200, num_pub_samples=20, use_hpr=True),
        device=dev)
    odoms = []
    bus.subscribe("/odom", odoms.append)
    bus.publish("/pts", cloud_msg(cloud10))
    bus.publish("/pose", PoseMsg(Header(stamp=0.0, frame_id="world"), start, [0, 0, 0, 1]))
    sync()
    if len(odoms) != 20 or not all(np.all(np.isfinite(o.position)) for o in odoms):
        fail(f"PoseOptNode(use_hpr=True): {len(odoms)} /odom messages (expected 20, finite)")
    if not np.array_equal(odoms[-1].position, r.position):
        fail(f"PoseOptNode(use_hpr=True)'s last /odom {odoms[-1].position} != "
             f"PoseOptimizer(use_hpr=True)'s {r.position}")
    node.close()
    del bus, node
    res["pose_hpr"] = (r0.loss, r.loss)
    print(f"[hpr] PoseOptimizer(use_hpr=True) cloud 10, 200 steps: loss {r0.loss:.6f} -> "
          f"{r.loss:.6f}, position {np.round(r.position, 6).tolist()}; PoseOptNode(use_hpr=True) "
          f"over the bus: 20 finite /odom, the last == PoseOptimizer's (np.array_equal)",
          flush=True)

    # ---- soft HPR at the dense size: voxel-filtered cloud 10 ---------------
    vox = voxel_downsample(cloud10, SOFT_LEAF)
    vpad, vvalid = pad_points(vox)
    if not len(vpad) <= PoseProblem(1.0, 1.0).soft_hpr_dense_max:
        fail(f"the voxel-filtered cloud pads to {len(vpad)}: above the dense soft HPR's size")
    res["soft_n"] = (len(vox), len(vpad))
    Kd = intr.matrix(device=dev)

    def pose_step(device):
        Pd = torch.as_tensor(vpad, device=device)
        Vd = torch.as_tensor(vvalid, device=device)
        prob = PoseProblem(intr.width, intr.height, soft_hpr=True)
        params = {k: v.requires_grad_(True) for k, v in init_pose_params(
            np.asarray([start], np.float32), np.asarray([[1.0, 0, 0, 0]], np.float32),
            device).items()}
        loss, _ = pose_forward(params, Pd, intr.matrix(device=device), prob, valid=Vd)
        loss.backward()
        return [loss.detach()] + [params[k].grad for k in ("trans", "quat")]

    def traj_step(device, path, stride):
        Pd = torch.as_tensor(vpad, device=device)
        Vd = torch.as_tensor(vvalid, device=device)
        q0 = identity_quaternions(len(path))
        prob = TrajectoryOptimizer(device=device, soft_hpr=True)._traj_problem(path, stride)
        params = {k: v.requires_grad_(True)
                  for k, v in init_traj_params(path, q0, device).items()}
        loss, _ = traj_forward(params, Pd, intr.matrix(device=device),
                               torch.as_tensor(path, device=device),
                               torch.as_tensor(q0, device=device), prob, valid=Vd)
        loss.backward()
        return [loss.detach()] + [params[k].grad for k in ("poses", "quats")]

    def against_cpu(name, card, host):
        errs = []
        for what, a, b in zip(("loss", "grad 0", "grad 1"), card, host):
            a = a.cpu().double()
            b = b.double()
            if not bool(torch.isfinite(a).all()):
                fail(f"{name} on the card: non-finite {what}")
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            if not err <= HPR_TOL * scale:
                fail(f"{name}: card vs CPU {what} max |err| {err:.3e} over {HPR_TOL} of its "
                     f"largest entry {scale:.3e}")
            errs.append(err / scale)
        return errs

    # pose: SOFT_POSE_STEPS steps, one step against the CPU, a traced step
    opt = PoseOptimizer(device=dev, soft_hpr=True)
    r0 = opt.optimize(vox, start, n_steps=0)
    opt.optimize(vox, start, n_steps=3)  # warm-up
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = opt.optimize(vox, start, n_steps=SOFT_POSE_STEPS)
    sync()
    res["soft_pose_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / SOFT_POSE_STEPS
    res["soft_pose_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    if not (np.all(np.isfinite(r.position)) and np.isfinite(r.loss) and r.loss < r0.loss):
        fail(f"PoseOptimizer(soft_hpr=True) {SOFT_POSE_STEPS} steps: loss {r.loss} from {r0.loss}")
    res["soft_pose_vs_cpu"] = against_cpu("soft pose step", pose_step(dev), pose_step("cpu"))
    res["soft_pose_trace"] = traced_share(lambda: pose_step(dev), sync)
    res["soft_pose"] = (r0.loss, r.loss)
    print(f"[hpr] PoseOptimizer(soft_hpr=True) on cloud 10 voxel-filtered at leaf {SOFT_LEAF} "
          f"({len(vox)} centroids padded to {len(vpad)}, dense): {SOFT_POSE_STEPS} steps, loss {r0.loss:.6f} "
          f"-> {r.loss:.6f}; one step on the card against the CPU: relative max |err| loss, "
          f"trans, quat {[f'{e:.2e}' for e in res['soft_pose_vs_cpu']]} (pin {HPR_TOL})",
          flush=True)

    # trajectory: SOFT_TRAJ_STEPS steps with path 10, evaluate, one step against the CPU
    stride = waypoint_stride(path10, 0.5)  # the facade's default vis_wps_dist
    topt = TrajectoryOptimizer(device=dev, soft_hpr=True, lr_pose=0.1, lr_quat=0.02)
    # the first Adam step moves every waypoint by lr_pose and raises the
    # smoothness term (the JAX twin's run does the same): the loss falls from
    # there on, so the last loss is held below the 1-step one
    loss0 = topt.optimize(vox, path10, n_steps=1).loss  # and a warm-up
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = topt.optimize(vox, path10, n_steps=SOFT_TRAJ_STEPS)
    sync()
    # per step, the run's final forward (no gradient) included
    res["soft_traj_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / SOFT_TRAJ_STEPS
    res["soft_traj_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    if not (np.all(np.isfinite(tr.poses)) and np.isfinite(tr.loss) and tr.loss < loss0
            and tr.visibility_gain > 1.0 and tr.n_iters == SOFT_TRAJ_STEPS and np.all(np.isfinite(tr.rewards))):
        fail(f"TrajectoryOptimizer(soft_hpr=True) {SOFT_TRAJ_STEPS} steps: loss {tr.loss} (after 1 step "
             f"{loss0}), visibility gain {tr.visibility_gain}, {tr.n_iters} steps")
    ev = topt.evaluate(vox, tr.poses, tr.quats_wxyz, wps_step=stride)
    if not (np.all(np.isfinite(ev.rewards)) and 0 < ev.n_observed <= len(vox)
            and np.isfinite(ev.mean_reward)):
        fail(f"evaluate(soft_hpr=True) of the optimized path: {ev.n_observed} observed, mean "
             f"reward {ev.mean_reward}")
    card = traj_step(dev, path10, stride)
    if not all(bool(torch.isfinite(g).all()) for g in card):
        fail("soft trajectory step on the card: non-finite loss or gradients")
    n_wps = len(path10[::stride])
    res["soft_traj_vs_cpu"] = against_cpu("soft traj step (path 10's first 3 waypoints)",
                                          traj_step(dev, path10[:3], stride),
                                          traj_step("cpu", path10[:3], stride))
    res["soft_traj_trace"] = traced_share(lambda: traj_step(dev, path10, stride), sync)
    res["soft_traj"] = (loss0, tr.loss, tr.visibility_gain, ev.n_observed, ev.mean_reward)
    res["soft_wps"] = n_wps
    print(f"[hpr] TrajectoryOptimizer(soft_hpr=True) on the same cloud with path 10 ({n_wps} "
          f"waypoints at stride {stride}): loss after 1 step {loss0:.6f}, after "
          f"{SOFT_TRAJ_STEPS} {tr.loss:.6f}, "
          f"visibility gain {tr.visibility_gain:.4f}, gradients finite; evaluate of the "
          f"optimized path: {ev.n_observed} observed, mean reward {ev.mean_reward:.6f}; one "
          f"step of path 10's first 3 waypoints (2 at stride {stride}) on the card against the "
          f"CPU: relative max |err| loss, poses, quats "
          f"{[f'{e:.2e}' for e in res['soft_traj_vs_cpu']]} (pin {HPR_TOL})", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    res["binned"] = binned_checks(dev, intr, cloud10, path10, sync, cuda_ms)
    return res


def f32_gate_norms(module):
    """A context in which ``module.gate_norms`` takes the soft gate's norms in
    the points' own dtype (``safe_norm``), without the float64 detour: the
    gate as it was before its norms were rounded once from float64."""
    import contextlib

    from trajectory_optimization_tpu_torch.ops.numerics import safe_norm

    @contextlib.contextmanager
    def patched():
        keep = module.gate_norms
        module.gate_norms = lambda p: safe_norm(p, dim=-1)
        try:
            yield
        finally:
            module.gate_norms = keep

    return patched()


def camera_clouds(P, poses, quats):
    """The (N, 3) camera-frame clouds of ``P`` at each (pose, wxyz quat)."""
    import torch

    from trajectory_optimization_tpu_torch.ops.scores import camera_planes

    out = []
    for t, q in zip(poses, quats):
        cx, cy, cz = camera_planes(P, torch.as_tensor(q, dtype=torch.float32,
                                                      device=P.device)[None],
                                   torch.as_tensor(t, dtype=torch.float32, device=P.device)[None])
        out.append(torch.stack([cx[0], cy[0], cz[0]], dim=-1))
    return out


def binned_tiles(cams, valid=None, cap: int = 1024, safety: float = 3.0):
    """[(real tiles, static slots)] of ``hpr_mask_soft_binned`` per grid of
    each (N, 3) cloud of ``cams``: the tiles its non-empty bins need,
    Σ⌈count/cap⌉, from the same bin keys on these inputs, against the slots
    it computes, ``n_bins + ⌈N/cap⌉``."""
    import torch

    from trajectory_optimization_tpu_torch.ops import hpr

    out = []
    v = None if valid is None else valid > 0
    for P in cams:
        n = P.shape[0]
        c = min(cap, n)
        norms = hpr.safe_norm(P, dim=-1)
        norms_v = norms if v is None else torch.where(v, norms, torch.zeros_like(norms))
        scale = torch.clamp(torch.amax(norms_v), min=1e-6)
        lat, az = hpr._direction_angles(P / torch.clamp(norms, min=1e-12)[:, None])
        for grid in hpr._binned_grids(2.0, 0.02, safety)[1]:
            key, fb, nb = hpr._grid_bin_key(grid, lat, az, norms, scale, v)
            counts = torch.bincount((key >> fb).long(), minlength=nb + 1)[:nb]
            out.append((int(((counts + c - 1) // c).sum()), nb + -(-n // c)))
    return out


def binned_pairs(cams, valid=None, cap: int = 1024, safety: float = 3.0) -> int:
    """(query, coverer) pairs in the real tiles of ``hpr_mask_soft_binned``
    on each (N, 3) cloud of ``cams``, summed: 4 grids × the tiles of their
    non-empty bins × cap² (``binned_tiles``; the empty slots it also
    computes are not counted)."""
    tiles = binned_tiles(cams, valid, cap, safety)
    return sum(real * min(cap, P.shape[0]) ** 2
               for (real, _), P in zip(tiles, [P for P in cams for _ in range(4)]))


def tiles_text(tiles) -> str:
    """'real a-b of slots c-d per grid (static/real e-f)' from ``binned_tiles``."""
    real, slots = [r for r, _ in tiles], [t for _, t in tiles]
    ratio = [t / max(r, 1) for r, t in tiles]
    return (f"real tiles {min(real)}-{max(real)} of static slots {min(slots)}-{max(slots)} per "
            f"grid (static/real {min(ratio):.2f}-{max(ratio):.2f})")


def binned_kernel_checks(dev, cloud10, path10, sync, cuda_ms):
    """[hpr], the binned gate's tile kernels (``soft_binned_fwd``,
    ``soft_binned_bwd``; csrc/soft_binned.cu) against their plain version
    (``ops.hpr.binned_lse_ref``, ``binned_lse_bwd_ref``) on the same CUDA
    tensors, at the cell's shapes (cloud 10 from path 10's waypoint 9,
    padded to 40,960, cap 512) and the soft pose step's
    (``BINNED_KERNEL_POSE`` points of bench.py's cloud, camera at the
    origin, cap 1024). Per grid of one gate
    call: top, total and lse on the rows the gate reads, and dU and dR for a
    seeded cotangent on those rows, each within the KERNEL_ULPS_X rule of
    the float64 plain version; two launches of each kernel bit-equal. Then,
    per gate call (4 grids), the kernels' ms and the plain version's (CUDA
    events, median of 3 windows, the wrappers' host time included), the
    pairs the kernels reduce and their bound. Returns {cap: numbers}."""
    import numpy as np
    import torch

    from trajectory_optimization_tpu_torch.ops import _kernels
    from trajectory_optimization_tpu_torch.ops import hpr
    from trajectory_optimization_tpu_torch.utils.data import pad_points

    cam = (cloud10 - path10[9]).astype(np.float32)
    padded, valid = pad_points(cam)
    pose = np.random.default_rng(0).normal(size=(BINNED_KERNEL_POSE, 3)).astype(np.float32)
    cases = {512: (torch.as_tensor(padded, device=dev), torch.as_tensor(valid, device=dev)),
             1024: (torch.as_tensor((pose * [6, 6, 2] + [5, 0, 1]).astype(np.float32),
                                    device=dev), None)}
    cos_ulp = 2.0 ** -24
    res = {}
    for cap, (P, V) in cases.items():
        calls = []
        real_lse = hpr._BinnedLSE

        class Recording:
            @staticmethod
            def apply(*args):
                calls.append(args)
                return real_lse.apply(*args)

        hpr._BinnedLSE = Recording
        try:
            with torch.no_grad():
                hpr.hpr_mask_soft_binned(P, valid=V, cap=cap)
        finally:
            hpr._BinnedLSE = real_lse
        rng = np.random.default_rng(5)
        errs = {k: 0.0 for k in ("top", "total", "lse", "dU", "dR")}
        plain_errs = dict(errs)
        pairs = real_rows = 0
        grads = []
        for U, R, beta, bin_s, cov_pos, tiles, c, chunk in calls:
            n = bin_s.shape[0]
            n_bins = int(tiles[:, 0].max()) + 1
            counts = torch.bincount(bin_s.long(), minlength=n_bins + 1)[:n_bins]
            real = int(((counts + c - 1) // c).sum())
            q = tiles[:, 1:2] + torch.arange(c, device=dev)  # every tile's query rows
            read = bin_s[q] == tiles[:, :1]
            read[real:] = False
            c_idx = tiles[:, 2:3] + torch.arange(c, device=dev)
            c_in = bin_s[c_idx] == tiles[:, :1]
            c_self = c_idx if cov_pos is None else torch.where(tiles[:, 3:] > 0, cov_pos[c_idx],
                                                                c_idx)
            for t0 in range(0, real, 64):
                t1 = min(t0 + 64, real)
                pairs += int((read[t0:t1, :, None] & c_in[t0:t1, None, :]
                              & (q[t0:t1, :, None] != c_self[t0:t1, None, :])).sum())
            real_rows += real * c
            g = torch.as_tensor(rng.normal(size=(tiles.shape[0], c)), dtype=torch.float32,
                                device=dev) * read

            def run(kernel, dt):
                Ud, Rd = U.detach().to(dt), R.detach().to(dt)
                bd, gd = beta.to(dt), g.to(dt)
                if kernel:  # the tier's own path: _BinnedLSE on CUDA tensors
                    top, total, lse = _kernels.soft_binned_fwd(Ud, Rd, bd, bin_s, cov_pos, tiles,
                                                               c)
                    Ud.requires_grad_(True)
                    Rd.requires_grad_(True)
                    dU, dR = torch.autograd.grad(hpr._BinnedLSE.apply(
                        Ud, Rd, bd, bin_s, cov_pos, tiles, c, chunk), (Ud, Rd), gd)
                    return top, total, lse, dU, dR
                top, total = hpr.binned_lse_ref(Ud, Rd, bd, bin_s, cov_pos, tiles, c, chunk)
                dU, dR = hpr.binned_lse_bwd_ref(Ud, Rd, bd, bin_s, cov_pos, tiles, top, total, gd,
                                                c, chunk)
                return top, total, top + torch.log(total), dU, dR

            k32, again = run(True, torch.float32), run(True, torch.float32)
            if not all(torch.equal(a, b) for a, b in zip(k32, again)):
                fail(f"[hpr] soft_binned kernels at cap {c}: two launches differ")
            p32, p64 = run(False, torch.float32), run(False, torch.float64)
            paired = read & (p64[0] > -1.0)
            x_ulp = float(beta) * float(R.max()) * cos_ulp
            for i, key in enumerate(errs):
                a, p, w = k32[i], p32[i], p64[i]
                if i < 3:
                    a, p, w = a[paired], p[paired], w[paired]
                if not bool(torch.isfinite(k32[i]).all()):
                    fail(f"[hpr] soft_binned kernels at cap {c}: non-finite {key}")
                d_k = float((a.double() - w).abs().max())
                d_p = float((p.double() - w).abs().max())
                if key not in ("top", "lse"):  # relative to the largest entry
                    d_k, d_p = (d / max(float(w.abs().max()), 1e-300) for d in (d_k, d_p))
                errs[key] = max(errs[key], d_k)
                plain_errs[key] = max(plain_errs[key], d_p)
                if not d_k <= 2 * d_p + KERNEL_ULPS_X * x_ulp:
                    fail(f"[hpr] soft_binned kernels at cap {c}: {key} {d_k:.3e} from float64, "
                         f"the plain version {d_p:.3e} (pin twice it + {KERNEL_ULPS_X} x "
                         f"{x_ulp:.3e})")
            grads.append((U, R, beta, bin_s, cov_pos, tiles, c, chunk, g, k32[0], k32[1]))
            del k32, again, p32, p64

        def fwd_kernels():
            for U, R, beta, bin_s, cov_pos, tiles, c, _, _, _, _ in grads:
                _kernels.soft_binned_fwd(U, R, beta, bin_s, cov_pos, tiles, c)

        def bwd_kernels():
            for U, R, beta, bin_s, cov_pos, tiles, c, _, g, top, total in grads:
                _kernels.soft_binned_bwd(U, R, beta, bin_s, cov_pos, tiles, top, total, g, c)

        def fwd_plain():
            for U, R, beta, bin_s, cov_pos, tiles, c, chunk, _, _, _ in grads:
                hpr.binned_lse_ref(U, R, beta, bin_s, cov_pos, tiles, c, chunk)

        def bwd_plain():
            for U, R, beta, bin_s, cov_pos, tiles, c, chunk, g, top, total in grads:
                hpr.binned_lse_bwd_ref(U, R, beta, bin_s, cov_pos, tiles, top, total, g, c,
                                       chunk)

        fwd_rows, fwd_cov = BINNED_KERNEL_BYTES["forward"]
        bwd_rows, bwd_cov = BINNED_KERNEL_BYTES["backward"]
        res[cap] = {
            "points": int(P.shape[0]), "slots": [int(a[5].shape[0]) for a in calls],
            "pairs": pairs, "errs": errs, "plain_errs": plain_errs,
            "ms": {"forward": cuda_ms(fwd_kernels, 5), "backward": cuda_ms(bwd_kernels, 5)},
            "plain_ms": {"forward": cuda_ms(fwd_plain, 2), "backward": cuda_ms(bwd_plain, 2)},
            "bound": {"forward": bound(real_rows * (fwd_rows + fwd_cov),
                                       pairs * BINNED_OPS["forward"]),
                      "backward": bound(real_rows * (bwd_rows + bwd_cov),
                                        pairs * BINNED_OPS["backward"])}}
        r = res[cap]
        print(f"[hpr] soft_binned_fwd/_bwd (csrc/soft_binned.cu) against the plain version on "
              f"the same tensors, cap {cap}, {r['points']} points ({len(calls)} grids, "
              f"{min(r['slots'])}-{max(r['slots'])} slots, {pairs:.4e} pairs): from the float64 "
              "plain version, kernel / plain f32: " + ", ".join(
                  f"{k} {errs[k]:.2e} / {plain_errs[k]:.2e}" for k in errs)
              + f" (pin twice the plain + {KERNEL_ULPS_X} ulps of cos in x); two launches "
              f"bit-equal; per gate call forward {r['ms']['forward']:.4f} ms (plain "
              f"{r['plain_ms']['forward']:.3f}, bound {r['bound']['forward'][0]:.4f} by "
              f"{r['bound']['forward'][1]}), backward {r['ms']['backward']:.4f} ms (plain "
              f"{r['plain_ms']['backward']:.3f}, bound {r['bound']['backward'][0]:.4f} by "
              f"{r['bound']['backward'][1]})", flush=True)
        del grads, calls, P, V
        sync()
        torch.cuda.empty_cache()
    return res


def layout_kernel_checks(dev, cloud10, path10, sync, cuda_ms, launches):
    """[hpr], the binned gate's layout kernels B1–B7 (csrc/binned_layout.cu)
    against the plain per-grid chain on the same CUDA tensors (``ops.hpr``'s
    ``_grid_bin_key``, ``_plain_grid_layout``, ``_plain_smax``, ``add_rows``,
    and autograd through the plain row maxima and gathers), at the cell's
    shapes (cloud 10 from path 10's waypoint 9, padded to 40,960, cap 512)
    and the soft pose step's (``BINNED_KERNEL_POSE`` points, cap 1024), each
    in float32 and float64, from one gate call's own inputs: B1's keys, B2's
    tables U and R, bins, stratified rows, permutation (and its inverses)
    and bin edges, B3's tile table and mask, B4's row maxima (``_plain_smax``'s
    and each grid's) and B5's cotangent of every lse for a seeded cotangent
    of the maxima ``torch.equal`` to the plain chain's; B6's rows of the
    tiles' partial sums and B7's ∂u, ∂ρ within ``LAYOUT_SUM_ULPS`` (their
    terms added in another order). In float32, per gate call: each wrapper's
    ms (CUDA events, median of 3 windows, host time included), its kernel
    alone (device time in a ``torch.profiler`` trace) and its bound (the
    bytes of its arguments and results once), against the plain chain's ms
    for the same stage. ``launches``: [hpr]'s 10-step soft trajectory run's
    counts, printed per kernel. Returns {cap: numbers}."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from trajectory_optimization_tpu_torch.ops import _kernels
    from trajectory_optimization_tpu_torch.ops import hpr
    from trajectory_optimization_tpu_torch.utils.data import pad_points

    cam = (cloud10 - path10[9]).astype(np.float32)
    padded, valid = pad_points(cam)
    pose = np.random.default_rng(0).normal(size=(BINNED_KERNEL_POSE, 3)).astype(np.float32)
    cases = {512: (torch.as_tensor(padded, device=dev), torch.as_tensor(valid, device=dev)),
             1024: (torch.as_tensor((pose * [6, 6, 2] + [5, 0, 1]).astype(np.float32),
                                    device=dev), None)}

    def nbytes(*xs):
        flat = [y for x in xs for y in (x if isinstance(x, (list, tuple)) else [x])]
        return sum(t.numel() * t.element_size() for t in flat if t is not None)

    def alone_ms(fn, kernel, per_call, reps=3):
        """Device ms of fn's launches whose name holds ``kernel`` in a trace,
        per call, from a trace that holds all ``per_call`` x ``reps`` of them;
        None if five traces in a row miss some."""
        fn()
        sync()
        for _ in range(5):  # a trace now and then comes back without device activity
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                sync()
            spans = [e.time_range.end - e.time_range.start for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
            if len(spans) == per_call * reps:
                return sum(spans) / 1e3 / reps
        return None

    def within_sums(name, got, want, mag, terms, eps):
        """got and want, the same terms summed in two orders: |got − want| at
        most LAYOUT_SUM_ULPS·(terms − 1)·eps·Σ|term| + terms·tiny at every
        entry (tiny: the dtype's smallest normal number)."""
        d = (got - want).abs()
        lim = (LAYOUT_SUM_ULPS * (terms - 1).clamp(min=0) * eps * mag
               + terms * torch.finfo(got.dtype).tiny)
        if not bool((d <= lim).all()) or not bool(torch.isfinite(got).all()):
            fail(f"[hpr] {name}: {int((d > lim).sum())} entries off the plain chain's by more "
                 f"than {LAYOUT_SUM_ULPS} x (terms - 1) rounding units of their terms' sum "
                 f"(max |diff| {float(d.max()):.3e})")
        return int((d > 0).sum())

    res = {}
    for cap, (P0, V0) in cases.items():
        res[cap] = {}
        for dtype in (torch.float32, torch.float64):
            P = P0.to(dtype)
            V = None if V0 is None else V0.to(dtype)
            seen = []
            real = hpr._kernel_smax

            def recording(*args):
                seen.append(args)
                return real(*args)

            hpr._kernel_smax = recording
            try:
                with torch.no_grad():
                    hpr.hpr_mask_soft_binned(P, valid=V, cap=cap)
            finally:
                hpr._kernel_smax = real
            u, rho, norms, scale, beta, v, r_param, tau, safety, c, chunk, strat = seen[0]
            lat, az = hpr._direction_angles(u)
            n = u.shape[0]
            specs, table = hpr._layout_plan(r_param, tau, safety, n, c, strat)
            grids = hpr._binned_grids(r_param, tau, safety)[1]
            table_d = hpr._device_table(table, dev)
            ar = torch.arange(c, device=dev)
            eps = 2.0 ** (-24 if dtype == torch.float32 else -53)
            tag = f"layout kernels at cap {c}, {n} points, {str(dtype).split('.')[-1]}"
            held = []

            def equal(name, got, want):
                if not torch.equal(got, want):
                    fail(f"[hpr] {tag}: {name} != the plain chain's")
                held.append(name)

            # B1-B3 and the sort, against the plain chain's layout per grid
            b1 = lambda: _kernels.binned_keys(u, norms, scale, v, table_d, specs)  # noqa: E731
            keys = b1()
            srt = lambda: torch.sort(keys, stable=True)  # noqa: E731
            keys_s, order = srt()
            b2 = lambda: _kernels.binned_layout(keys_s, order, u, rho, specs, c)  # noqa: E731
            U, R, bin_s, edges, cov_pos, perm, pos_a, pos_b = b2()
            b3 = lambda: _kernels.binned_tables(edges, specs, n, c)  # noqa: E731
            tiles, tile_ok = b3()
            plain = [hpr._plain_grid_layout(grid, u, rho, lat, az, norms, scale, v, c, strat)
                     for grid in grids]
            for g, (grid, sp, (pU, pR, pb, pc, pt, pok, pp)) in enumerate(
                    zip(grids, specs, plain)):
                key, _, n_bins = hpr._grid_bin_key(grid, lat, az, norms, scale, v)
                equal(f"B1 keys, grid {g}", keys[g * n:(g + 1) * n].long() - (g - 2) * 2**30,
                      key.long())
                equal(f"B2 U, grid {g}", U[g], pU)
                equal(f"B2 R, grid {g}", R[g], pR)
                equal(f"B2 bin_s, grid {g}", bin_s[g], pb)
                equal(f"B2 perm, grid {g}", perm[g].long(), pp)
                equal(f"B2 pos_a, grid {g}", pos_a[g].long()[pp], torch.arange(n, device=dev))
                equal(f"B2 edges, grid {g}", edges[g, :n_bins + 1].long(), torch.searchsorted(
                    pb, torch.arange(n_bins + 1, dtype=pb.dtype, device=dev)))
                if (pc is None) != (not sp.strat):
                    fail(f"[hpr] {tag}: grid {g} builds the stratified layout where the plain "
                         "chain does not, or the reverse")
                if pc is not None:
                    equal(f"B2 cov_pos, grid {g}", cov_pos[g], pc)
                    equal(f"B2 pos_b, grid {g}", pc[pos_b[g].long()], pos_a[g].long())
                sl = slice(sp.tiles, sp.tiles + sp.n_tiles)
                equal(f"B3 tiles, grid {g}", tiles[sl], pt)
                equal(f"B3 tile_ok, grid {g}", tile_ok[sl], pok)

            # the tiles (H1), then B4 against _plain_smax and each grid's maxima
            fwd = [_kernels.soft_binned_fwd(U[g], R[g], beta, bin_s[g],
                                            cov_pos[g] if sp.strat else None,
                                            tiles[sp.tiles:sp.tiles + sp.n_tiles], c)
                   for g, sp in enumerate(specs)]
            lses = [f[2] for f in fwd]
            b4 = lambda: _kernels.binned_rowmax(lses, beta, bin_s, pos_a, tiles, tile_ok,  # noqa: E731
                                                specs, c)
            smax, up = b4()

            def plain_rowmax(ls):
                m = torch.full((n,), -hpr._BIG_SOFT, dtype=dtype, device=dev)
                ups = []
                for lse, (_, _, pb, _, pt, pok, pp) in zip(ls, plain):
                    q = pt[:, 1:2] + ar
                    rows = torch.where((pb[q] == pt[:, :1]) & pok[:, None], lse / beta,
                                       -hpr._BIG_SOFT)
                    m_g = torch.full((n,), -hpr._BIG_SOFT, dtype=dtype,
                                     device=dev).scatter_reduce(
                        0, q.reshape(-1), rows.reshape(-1), "amax", include_self=True)
                    ups.append(hpr._unpermute(pp, m_g))
                    m = torch.maximum(m, ups[-1])
                return m, ups

            equal("B4 smax", smax, hpr._plain_smax(u, rho, lat, az, norms, scale, beta, v,
                                                   grids, c, chunk, strat))
            for g, want in enumerate(plain_rowmax(lses)[1]):
                equal(f"B4 grid {g}'s maxima", up[g], want)

            # B5 against autograd through the plain row maxima
            g_smax = torch.as_tensor(np.random.default_rng(7).normal(size=n), dtype=dtype,
                                     device=dev)
            b5 = lambda: _kernels.binned_rowmax_bwd(g_smax, lses, beta, bin_s, perm, up,  # noqa: E731
                                                    tiles, tile_ok, specs, c)
            flat = b5()
            lq = [lse.detach().clone().requires_grad_(True) for lse in lses]
            sp_plain = plain_rowmax(lq)[0]
            b5_plain = lambda: torch.autograd.grad(sp_plain, lq, g_smax, retain_graph=True)  # noqa: E731
            g_lse = []
            for g, (sp, want) in enumerate(zip(specs, b5_plain())):
                g_lse.append(flat[sp.tiles * c:(sp.tiles + sp.n_tiles) * c].view(sp.n_tiles, c))
                equal(f"B5 lse cotangent, grid {g}", g_lse[-1], want)

            # the tiles' backward (H2), then B6 against add_rows on the plain rows
            parts = [_kernels.soft_binned_bwd(U[g], R[g], beta, bin_s[g],
                                              cov_pos[g] if sp.strat else None,
                                              tiles[sp.tiles:sp.tiles + sp.n_tiles], fwd[g][0],
                                              fwd[g][1], g_lse[g].contiguous(), c)
                     for g, sp in enumerate(specs)]
            b6 = lambda: [_kernels.binned_rows(pu, pr, bin_s[g],  # noqa: E731
                                               tiles[sp.tiles:sp.tiles + sp.n_tiles], c,
                                               U[g].shape[0])
                          for g, (sp, (pu, pr)) in enumerate(zip(specs, parts))]
            rows_k = b6()
            plain_rows = []
            for sp, (_, _, _, _, pt, _, _) in zip(specs, plain):
                crow = pt[:, 2:3] + ar + (pt[:, 3:] * n if sp.strat else 0)
                plain_rows.append(torch.cat([(pt[:, 1:2] + ar).reshape(-1), crow.reshape(-1)]))

            def b6_plain(fn=lambda x: x):
                out = []
                for g, ((pu, pr), rows) in enumerate(zip(parts, plain_rows)):
                    half = rows.shape[0] // 2
                    out.append((hpr.add_rows(torch.zeros_like(U[g]), rows, fn(pu)),
                                hpr.add_rows(torch.zeros_like(R[g]), rows[half:], fn(pr))))
                return out

            moved = 0
            for g, ((dU, dR), want, mag, cnt) in enumerate(zip(
                    rows_k, b6_plain(), b6_plain(torch.abs),
                    b6_plain(lambda x: (x != 0).to(dtype)))):
                moved += within_sums(f"{tag}: B6 dU, grid {g}", dU, want[0], mag[0], cnt[0], eps)
                moved += within_sums(f"{tag}: B6 dR, grid {g}", dR, want[1], mag[1], cnt[1], eps)
            held.append(f"B6 ({moved} entries not bit-equal)")

            # B7 against autograd through the plain chain's gathers
            dUs, dRs = [r[0] for r in rows_k], [r[1] for r in rows_k]
            b7 = lambda: _kernels.binned_layout_bwd(dUs, dRs, pos_a, pos_b, specs, dtype)  # noqa: E731
            du, drho = b7()
            ul, rl = u.detach().requires_grad_(True), rho.detach().requires_grad_(True)
            tabs = [t for grid in grids for t in hpr._plain_grid_layout(
                grid, ul, rl, lat, az, norms, scale, v, c, strat)[:2]]

            def b7_plain(fn=lambda x: x):
                cots = [fn(t) for pair in zip(dUs, dRs) for t in pair]
                return torch.autograd.grad(tabs, (ul, rl), cots, retain_graph=True)

            want, mag = b7_plain(), b7_plain(torch.abs)
            terms = torch.full_like(drho, 2.0 * len(grids))
            moved = within_sums(f"{tag}: B7 du", du, want[0], mag[0], terms[:, None], eps)
            moved += within_sums(f"{tag}: B7 drho", drho, want[1], mag[1], terms, eps)
            held.append(f"B7 ({moved} entries not bit-equal)")
            entry = {"held": held}
            if dtype == torch.float32:
                def plain_keys():
                    angles = hpr._direction_angles(u)
                    return [hpr._grid_bin_key(grid, *angles, norms, scale, v) for grid in grids]

                def plain_layout():
                    angles = hpr._direction_angles(u)
                    return [hpr._plain_grid_layout(grid, u, rho, *angles, norms, scale, v, c,
                                                   strat) for grid in grids]

                wrappers = {
                    "binned_keys": (b1, nbytes(u, norms, v, keys), plain_keys),
                    "sort": (srt, nbytes(keys, keys_s, order), None),
                    "binned_layout": (b2, nbytes(keys_s, order, u, rho, U, R, bin_s, edges,
                                                 cov_pos, perm, pos_a, pos_b), None),
                    "binned_tables": (b3, nbytes(edges, tiles, tile_ok), None),
                    "binned_rowmax": (b4, nbytes(lses, bin_s, pos_a, tiles, tile_ok, up, smax),
                                      lambda: plain_rowmax(lses)),
                    "binned_rowmax_bwd": (b5, nbytes(g_smax, lses, bin_s, perm, up, tiles,
                                                     tile_ok, flat), b5_plain),
                    "binned_rows": (b6, nbytes([p for pair in parts for p in pair], bin_s,
                                               tiles, dUs, dRs), b6_plain),
                    "binned_layout_bwd": (b7, nbytes(dUs, dRs, pos_a, pos_b, du, drho),
                                          b7_plain)}
                entry["ms"], entry["alone_ms"], entry["bound_ms"], entry["plain_ms"] = {}, {}, {}, {}
                for k, (fn, nb, plain_fn) in wrappers.items():
                    entry["ms"][k] = cuda_ms(fn, 5)
                    kernel, per_call = LAYOUT_TRACE_NAMES[k]
                    entry["alone_ms"][k] = alone_ms(fn, kernel, per_call)
                    entry["bound_ms"][k] = nb / HBM_BYTES_PER_MS
                    if plain_fn is not None:
                        entry["plain_ms"][k] = cuda_ms(plain_fn, 2)
                entry["plain_ms"]["layout"] = cuda_ms(plain_layout, 2)
                entry["layout_ms"] = sum(entry["ms"][k] for k in (
                    "binned_keys", "sort", "binned_layout", "binned_tables"))
            res[cap][str(dtype).split(".")[-1]] = entry
            print(f"[hpr] {tag}: torch.equal to the plain chain: " + ", ".join(
                sorted({h.split(",")[0] for h in held if not h.startswith(("B6", "B7"))}))
                + f"; {held[-2]}, {held[-1]}, within {LAYOUT_SUM_ULPS} x (terms - 1) "
                "rounding units of their terms' sum", flush=True)
            if dtype == torch.float32:
                print(f"[hpr] layout kernels at cap {c}, float32, per gate call: " + "; ".join(
                    f"{k} {entry['ms'][k]:.4f} ms (alone "
                    + ("not traced" if entry["alone_ms"][k] is None
                       else f"{entry['alone_ms'][k]:.4f}") + ", bound "
                    f"{entry['bound_ms'][k]:.5f} by bytes"
                    + (f", plain {entry['plain_ms'][k]:.3f}" if k in entry["plain_ms"] else "")
                    + ")" for k in entry["ms"])
                    + f"; the layout (keys, sort, layout, tables) {entry['layout_ms']:.4f} ms "
                    f"against _plain_grid_layout x 4 {entry['plain_ms']['layout']:.3f} ms",
                    flush=True)
            del seen, U, R, bin_s, edges, cov_pos, perm, pos_a, pos_b, tiles, tile_ok, plain
            del fwd, lses, parts, rows_k, dUs, dRs, tabs, lq, sp_plain
            sync()
            torch.cuda.empty_cache()
    print("[hpr] layout kernels in [hpr]'s 10-step soft trajectory run (the eager first step, "
          "the capture and nine replays): " + ", ".join(
              f"{k} {launches.get(k, 0)}" for k in ("soft_binned_fwd", "soft_binned_bwd")
              + LAYOUT_KERNELS), flush=True)
    res["launches"] = {k: launches.get(k, 0) for k in LAYOUT_KERNELS}
    return res


def binned_checks(dev, intr, cloud10, path10, sync, cuda_ms):
    """[hpr], the direction-binned soft tier: the mask on the full cloud 10
    from path 10's waypoint 9 against Qhull (tests/test_hpr.py's operating
    point pins on its 16,384-point subsample) and against the same call on
    the CPU; ``PoseOptimizer(soft_hpr=True)`` at bench.py's 262,144-point
    cloud and at 1,048,576 points; ``TrajectoryOptimizer(soft_hpr=True)`` on
    the full cloud 10 with path 10 (one step against the CPU); the waypoints
    optimization at the demo's defaults, plain and with soft HPR; the two
    notebook variants against the CPU. Returns the numbers for [times]."""
    import gc

    import numpy as np
    import torch

    from trajectory_optimization_tpu_torch.api import PoseOptimizer, TrajectoryOptimizer
    from trajectory_optimization_tpu_torch.models import distance_reward as dr
    from trajectory_optimization_tpu_torch.models import frustum_fd as ffd
    from trajectory_optimization_tpu_torch.models.pose import (
        PoseProblem, init_pose_params, pose_forward,
    )
    from trajectory_optimization_tpu_torch.models.traj import (
        TrajProblem, init_traj_params, traj_forward, waypoint_stride,
    )
    from trajectory_optimization_tpu_torch.models.wps_opt import WpsOptProblem, optimize_waypoints
    from trajectory_optimization_tpu_torch.ops import _kernels
    from trajectory_optimization_tpu_torch.ops import hpr
    from trajectory_optimization_tpu_torch.opt import runners
    from trajectory_optimization_tpu_torch.utils.data import identity_quaternions, pad_points

    res = {}

    # ---- the mask: cloud 10 from waypoint 9, against Qhull and the CPU -----
    cam = (cloud10 - path10[9]).astype(np.float32)
    sub = cam[np.random.default_rng(0).permutation(len(cam))[:16384]]
    truth = hpr.hpr_mask_exact(sub)
    vis = hpr.hpr_mask_soft_binned(torch.as_tensor(sub, device=dev)).cpu().numpy() > 0.5
    tp = int((vis & truth).sum())
    precision, recall = tp / max(int(vis.sum()), 1), tp / max(int(truth.sum()), 1)
    agree = float((vis == truth).mean())
    if not (recall >= 0.93 and precision >= 0.86 and agree >= 0.93):
        fail(f"hpr_mask_soft_binned on cloud 10's 16,384-point subsample from waypoint 9: "
             f"precision {precision:.4f}, recall {recall:.4f}, agreement {agree:.4f} (pins 0.86, "
             f"0.93, 0.93)")
    padded, valid = pad_points(cam)
    P, V = torch.as_tensor(padded, device=dev), torch.as_tensor(valid, device=dev)
    card_mask = hpr.hpr_mask_soft_binned(P, valid=V)
    if not bool(torch.isfinite(card_mask).all()):
        fail("hpr_mask_soft_binned on the card: non-finite mask")
    card_mask = card_mask.cpu().numpy()[: len(cam)]
    cpu_mask = hpr.hpr_mask_soft_binned(P.cpu(), valid=V.cpu()).numpy()[: len(cam)]
    d = np.abs(card_mask - cpu_mask)
    within, thr = float((d <= 3e-3).mean()), float(((card_mask > 0.5) == (cpu_mask > 0.5)).mean())
    if not (within >= 0.998 and thr > 0.999):
        fail(f"hpr_mask_soft_binned card vs CPU on cloud 10: {within:.5f} of points within 3e-3 "
             f"(pin 0.998), threshold agreement {thr:.5f} (pin 0.999)")
    res["mask"] = {"n": len(cam), "padded": len(padded), "precision": precision,
                   "recall": recall, "agreement": agree, "card_vs_cpu_within": within,
                   "card_vs_cpu_threshold": thr, "max_abs_err": float(d.max()),
                   "ms": cuda_ms(lambda: hpr.hpr_mask_soft_binned(P, valid=V), 2),
                   "pairs": binned_pairs([P], V),
                   "trace": traced_share(lambda: hpr.hpr_mask_soft_binned(P, valid=V), sync,
                                         hpr.SOFT_BINNED_RANGE)}
    print(f"[hpr] hpr_mask_soft_binned on the card, cloud 10 from path 10's waypoint 9: on its "
          f"16,384-point rng(0) subsample against Qhull precision {precision:.4f}, recall "
          f"{recall:.4f}, agreement {agree:.4f} (pins 0.86, 0.93, 0.93); the full cloud "
          f"({len(cam)} padded to {len(padded)}) against the same call on the CPU: {within:.5f} "
          f"of points within 3e-3, the 0.5 threshold agreeing on {thr:.5f} (pins 0.998, 0.999), "
          f"max |diff| {d.max():.2e}; {res['mask']['ms']:.3f} ms, "
          f"{res['mask']['pairs']:.4e} pairs", flush=True)
    del P, V
    res["kernels"] = binned_kernel_checks(dev, cloud10, path10, sync, cuda_ms)

    # ---- soft pose steps at 262,144 and 1,048,576 points -------------------
    def pose_step(Pd):
        params = {k: v.requires_grad_(True) for k, v in init_pose_params(
            np.zeros((1, 3), np.float32), np.array([[1.0, 0, 0, 0]], np.float32), dev).items()}
        loss, _ = pose_forward(params, Pd, intr.matrix(device=dev),
                               PoseProblem(intr.width, intr.height, soft_hpr=True))
        loss.backward()

    res["pose"] = {}
    for n, steps in BINNED_POSE:
        rng = np.random.default_rng(0)
        pts = (rng.normal(size=(n, 3)).astype(np.float32) * [6, 6, 2] + [5, 0, 1]).astype(np.float32)
        opt = PoseOptimizer(device=dev, soft_hpr=True, lr_pose=0.02, lr_quat=0.02)
        r0 = opt.optimize(pts, [0.0, 0.0, 0.0], n_steps=0)
        # warm-up: the run's runner makes its bucket, runs its first step eagerly
        # and captures the step; the timed run replays it
        opt.optimize(pts, [0.0, 0.0, 0.0], n_steps=steps)
        sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = opt.optimize(pts, [0.0, 0.0, 0.0], n_steps=steps)
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        peak = torch.cuda.max_memory_allocated() / 2**20
        if not (np.all(np.isfinite(r.position)) and np.isfinite(r.loss) and r.loss < r0.loss):
            fail(f"PoseOptimizer(soft_hpr=True) at {n} points, {steps} steps: loss {r.loss} "
                 f"from {r0.loss}")
        Pd = torch.as_tensor(pts, device=dev)
        entry = {"steps": steps, "ms_per_step": ms, "peak_mib": peak, "loss": (r0.loss, r.loss),
                 "pairs": binned_pairs([Pd])}
        if n == BINNED_POSE[0][0]:
            # an eager step: a replayed one runs no profiler range
            entry["trace"] = traced_share(lambda: pose_step(Pd), sync, hpr.SOFT_BINNED_RANGE)
        res["pose"][n] = entry
        print(f"[hpr] PoseOptimizer(soft_hpr=True) on bench.py's cloud (rng(0) normal x [6, 6, 2] "
              f"+ [5, 0, 1]) at {n} points, camera at the origin: binned (cap 1024), {steps} "
              f"captured steps (replays) after a warm-up run, {ms:.3f} ms/step, peak "
              f"{peak:.1f} MiB, loss {r0.loss:.6f} -> {r.loss:.6f}", flush=True)
        del Pd, opt
        runners.pose_runner.cache_clear()  # the run's captured step and its memory pool
        gc.collect()
        torch.cuda.empty_cache()

    # ---- soft trajectory on the full cloud 10 ------------------------------
    stride = waypoint_stride(path10, 0.5)
    topt = TrajectoryOptimizer(device=dev, soft_hpr=True, lr_pose=0.1, lr_quat=0.02)
    loss1 = topt.optimize(cloud10, path10, n_steps=1).loss  # and a warm-up
    sync()
    torch.cuda.reset_peak_memory_stats()
    before = dict(_kernels.LAUNCHES)
    t0 = time.perf_counter()
    tr = topt.optimize(cloud10, path10, n_steps=10)
    sync()
    traj_ms = (time.perf_counter() - t0) * 1e3 / 10
    traj_launches = {k: v - before[k] for k, v in _kernels.LAUNCHES.items() if v != before[k]}
    fwd, bwd = (traj_launches.get(k, 0) // 4 for k in ("soft_binned_fwd", "soft_binned_bwd"))
    if not (fwd and bwd and traj_launches == {
            "soft_binned_fwd": 4 * fwd, "soft_binned_bwd": 4 * bwd, "binned_keys": fwd,
            "binned_layout": fwd, "binned_tables": fwd, "binned_rowmax": fwd,
            "binned_rowmax_bwd": bwd, "binned_rows": 4 * bwd, "binned_layout_bwd": bwd}):
        fail(f"TrajectoryOptimizer(soft_hpr=True) on cloud 10, 10 steps: launches "
             f"{traj_launches} (the binned tiles' two kernels once a grid, and the layout's "
             "seven once a gate call, binned_rows once a grid, and no other)")
    traj_peak = torch.cuda.max_memory_allocated() / 2**20
    if not (np.all(np.isfinite(tr.poses)) and np.isfinite(tr.loss) and tr.n_iters == 10
            and tr.loss < loss1 and np.all(np.isfinite(tr.rewards))):
        fail(f"TrajectoryOptimizer(soft_hpr=True) on cloud 10, 10 steps: loss {tr.loss} (after "
             f"1 step {loss1}), {tr.n_iters} steps")
    padded, valid = pad_points(cloud10)

    def traj_step(device, path, dtype=torch.float32):
        Pd = torch.as_tensor(padded, device=device, dtype=dtype)
        Vd = torch.as_tensor(valid, device=device, dtype=dtype)
        q0 = identity_quaternions(len(path))
        prob = TrajProblem(intr.width, intr.height, wps_step=stride, soft_hpr=True)
        params = {k: v.to(dtype).requires_grad_(True)
                  for k, v in init_traj_params(path, q0, device).items()}
        loss, _ = traj_forward(params, Pd, intr.matrix(device=device, dtype=dtype),
                               torch.as_tensor(path, device=device, dtype=dtype),
                               torch.as_tensor(q0, device=device, dtype=dtype), prob, valid=Vd)
        loss.backward()
        return [x.cpu().double() for x in [loss.detach()] + [params[k].grad
                                                             for k in ("poses", "quats")]]

    def rel_errs(xs, ys):
        return [float((x - y).abs().max()) / float(y.abs().max()) for x, y in zip(xs, ys)]

    # the card's and the CPU's f32 step, each against the card's float64
    # evaluation of the same step (BINNED_STEP_TOL), and against each other;
    # beside them, not held, the card's step with the gate's norms in f32
    card32, cpu32 = traj_step(dev, path10[:3]), traj_step("cpu", path10[:3])
    card64 = traj_step(dev, path10[:3], torch.float64)
    with f32_gate_norms(hpr):
        card32_f32n = traj_step(dev, path10[:3])
    errs = {"card_vs_cpu": rel_errs(card32, cpu32), "card_vs_f64": rel_errs(card32, card64),
            "cpu_vs_f64": rel_errs(cpu32, card64),
            "card_f32_norms_vs_f64": rel_errs(card32_f32n, card64)}
    if not (all(bool(torch.isfinite(x).all()) for x in card32)
            and max(errs["card_vs_f64"] + errs["cpu_vs_f64"]) <= BINNED_STEP_TOL):
        fail(f"soft traj step on cloud 10 (path 10's first 3 waypoints): relative max |err| "
             f"(loss, poses, quats) {errs} (pin {BINNED_STEP_TOL} against the float64 step)")
    Pd = torch.as_tensor(padded, device=dev)
    wps = path10[::stride]
    res["traj"] = {"waypoints": len(wps), "ms_per_step": traj_ms, "peak_mib": traj_peak,
                   "launches": traj_launches,
                   "loss": (loss1, tr.loss), "visibility_gain": tr.visibility_gain,
                   "vs_cpu": errs,
                   "pairs": binned_pairs(camera_clouds(Pd, wps, identity_quaternions(len(wps))),
                                         torch.as_tensor(valid, device=dev), cap=512),
                   "trace": traced_share(lambda: traj_step(dev, path10), sync,
                                         hpr.SOFT_BINNED_RANGE)}
    del Pd
    print(f"[hpr] TrajectoryOptimizer(soft_hpr=True) on the full cloud 10 ({len(cloud10)} points "
          f"padded to {len(padded)}: binned, cap 512) with path 10 ({len(wps)} waypoints at "
          f"stride {stride}): 10 steps (the first eager, the capture, nine replays; clean "
          f"replays under [graphs] soft traj) {traj_ms:.3f} ms/step, peak {traj_peak:.1f} MiB, "
          f"loss "
          f"after 1 step {loss1:.6f}, after 10 {tr.loss:.6f}, visibility gain "
          f"{tr.visibility_gain:.4f}; one step of path 10's first 3 waypoints, relative max "
          f"|err| loss, poses, quats: " + "; ".join(
              f"{k.replace('_', ' ')} {[f'{e:.2e}' for e in v]}" for k, v in errs.items())
          + f" (pin {BINNED_STEP_TOL} against float64; the step with the gate's norms in f32 "
          f"is not held)", flush=True)
    runners.traj_runner.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    res["layout"] = layout_kernel_checks(dev, cloud10, path10, sync, cuda_ms, traj_launches)

    # ---- waypoints optimization at the demo's defaults ---------------------
    q_id = identity_quaternions(len(path10))
    K = intr.matrix_np()
    prob = WpsOptProblem(img_width=intr.width, img_height=intr.height)
    optimize_waypoints(cloud10, path10, q_id, K, prob, n_steps=5, device=dev)  # warm-up
    sync()
    t0 = time.perf_counter()
    trans, quats, aux = optimize_waypoints(cloud10, path10, q_id, K, prob, n_steps=WPS_STEPS,
                                           lr_xy=0.02, lr_yaw=0.02, device=dev)
    sync()
    wps_s = time.perf_counter() - t0
    gains = (aux["losses0"] / torch.clamp(aux["losses"], min=1e-12)).cpu().numpy()
    if not (np.all(np.isfinite(gains)) and gains.min() >= 1.0 and gains.mean() > 1.0
            and bool(torch.isfinite(trans).all()) and bool(torch.isfinite(quats).all())):
        fail(f"optimize_waypoints on cloud 10, {WPS_STEPS} steps: per-waypoint gains {gains.tolist()} "
             f"(every gain >= 1, mean > 1)")
    Pd = torch.as_tensor(cloud10, device=dev)
    res["wps"] = {"steps_per_s": WPS_STEPS / wps_s, "gains": gains.tolist(),
                  "soft_pairs": binned_pairs(camera_clouds(Pd, path10, q_id))}
    del Pd
    print(f"[hpr] optimize_waypoints on cloud 10 + path 10 ({len(path10)} waypoints, "
          f"{WPS_STEPS} steps (the demo's), lr 0.02/0.02): {WPS_STEPS / wps_s:.2f} steps/s, "
          f"per-waypoint visibility gains "
          f"min {gains.min():.4f}, mean {gains.mean():.4f}, max {gains.max():.4f} (every gain "
          f">= 1, mean > 1); with soft_hpr=True ({len(path10)} binned masks of {len(cloud10)} "
          f"points per step, cap 1024) under [graphs] soft wps", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the notebook variants, card against CPU ---------------------------
    def dr_step(device):
        params = {k: v.requires_grad_(True)
                  for k, v in dr.init_distance_reward_params(path10, device).items()}
        loss, aux = dr.distance_reward_forward(
            params, torch.as_tensor(cloud10, device=device), intr.matrix(device=device),
            torch.as_tensor(path10, device=device),
            dr.DistanceRewardProblem(img_width=intr.width, img_height=intr.height))
        loss.backward()
        return (loss.detach().cpu().double(), params["traj"].grad.cpu().double(),
                float(aux["mean_reward"].detach()))

    (cl, cg, c_reward), (hl, hg, _) = dr_step(dev), dr_step("cpu")
    dr_err = (float(abs(cl - hl) / abs(hl)), float((cg - hg).abs().max() / hg.abs().max()))
    if not (torch.isfinite(cg).all() and dr_err[0] <= 1e-4 and dr_err[1] <= HPR_TOL):
        fail(f"distance_reward_forward on cloud 10, card vs CPU: loss rel {dr_err[0]:.2e} "
             f"(pin 1e-4), gradient {dr_err[1]:.2e} of its largest entry (pin {HPR_TOL})")
    centered = (cloud10 - cloud10.mean(axis=0)).astype(np.float32)

    def fd_step(device):
        x = torch.tensor([10.0, 30.0, 10.0], device=device, requires_grad=True)
        loss = ffd.fd_pose_loss(x, torch.as_tensor(centered, device=device))
        loss.backward()
        return loss.detach().cpu(), x.grad.cpu()

    (fl, fg), (hfl, hfg) = fd_step(dev), fd_step("cpu")
    if not (torch.equal(fl, hfl) and torch.equal(fg, hfg)):
        fail(f"fd_pose_loss on cloud 10, card vs CPU: loss {float(fl)} vs {float(hfl)}, "
             f"gradient {fg.tolist()} vs {hfg.tolist()} (count differences: equal)")
    res["variants"] = {"distance_reward_vs_cpu": dr_err, "fd_loss": float(fl),
                       "fd_grad": fg.tolist()}
    print(f"[hpr] notebook variants on the card: distance_reward_forward on cloud 10 + path 10 "
          f"loss {float(cl):.6f}, mean reward {c_reward:.6f}, against the CPU "
          f"loss rel {dr_err[0]:.2e}, gradient {dr_err[1]:.2e} of its largest entry; "
          f"fd_pose_loss at (10, 30, 10) on cloud 10 centred: loss {float(fl):.6e}, gradient "
          f"{fg.tolist()} (from count differences), both equal to the CPU's", flush=True)
    return res


def print_hpr_times(card: str, hp) -> None:
    """[hpr]'s lines under [times], and its bounds into ``hp["bounds"]``."""
    bucket = hp["rig"]["approx"]["bucket"]
    hp["bounds"] = {
        "rig_sweep": bound(0, HPR_SWEEP_OPS * hp["rig_pairs"]),
        "full_sweep": bound(0, HPR_SWEEP_OPS * hp["full"]["pairs"]),
        # a pose step runs the tile forward and backward once; a trajectory
        # step twice forward (its waypoints are checkpointed) and once back,
        # per selected waypoint
        "soft_pose_step": bound(0, hp["soft_n"][1] ** 2 * (SOFT_OPS["forward"]
                                                          + SOFT_OPS["backward"])),
        "soft_traj_step": bound(0, hp["soft_wps"] * hp["soft_n"][1] ** 2 * (
            2 * SOFT_OPS["forward"] + SOFT_OPS["backward"])),
    }
    print(f"[times] {card} | HPR rig cloud10: one batched _hpr_masks_rig {hp['rig_hpr_ms']:.3f} "
          f"ms (padding, copies and the one device-to-host copy included), the pursuit alone "
          f"on (6, {bucket}) {hp['rig_sweep_ms']:.3f} ms ("
          + ("device not traced" if hp["rig_sweep_trace"][1] is None else
             "{3} device operations, busy {1:.3f} ms, traced".format(*hp["rig_sweep_trace"]))
          + "), bound "
          + "{:.4f} ms by {}".format(*hp["bounds"]["rig_sweep"])
          + f" ({hp['rig_pairs']:.4e} pairs); process_all ms/call (median of 3, with render): "
          + ", ".join(f"{b} {hp['process_all_ms'][b]:.2f}" for b in ("approx", "exact", "none"))
          + f"; hpr_mask_approx on cloud 10 padded to {hp['full']['padded']}: "
          f"{hp['full']['ms']:.3f} ms, bound " + "{:.4f} ms by {}".format(
              *hp["bounds"]["full_sweep"])
          + f" ({hp['full']['pairs']:.4e} pairs); PoseOptimizer(use_hpr=True) cloud10 "
          f"{hp['pose_hpr_ms_per_step']:.4f} ms/step", flush=True)

    def share_text(t, b):
        wall, busy, dom, n_ops = t
        if busy is None:
            return (f"traced {wall:.2f} ms, device time not measured (no device activity); "
                    f"bound {b[0]:.4f} ms by {b[1]}")
        return (f"traced {wall:.2f} ms, {n_ops} device operations, device busy {busy:.3f} ms, "
                f"the dominance tile {dom:.3f} ms ({100 * dom / busy:.1f}% of the busy time; "
                f"bound {b[0]:.4f} ms by {b[1]})")

    b = hp["binned"]
    fwd, bwd = BINNED_OPS["forward"], BINNED_OPS["backward"]
    hp["bounds"].update({
        "binned_mask": bound(0, b["mask"]["pairs"] * fwd),
        # a pose step runs the binned tiles forward and backward once; a
        # trajectory or waypoints step twice forward (checkpointed) and once back
        **{f"binned_pose_{n}": bound(0, e["pairs"] * (fwd + bwd)) for n, e in b["pose"].items()},
        "binned_traj_step": bound(0, b["traj"]["pairs"] * (2 * fwd + bwd)),
        "binned_wps_step": bound(0, b["wps"]["soft_pairs"] * (2 * fwd + bwd)),
    })

    def binned_share(t):
        wall, busy, rng, n_ops = t
        if busy is None:
            return f"traced {wall:.2f} ms, device time not measured (no device activity)"
        return (f"traced {wall:.2f} ms, {n_ops} device operations, device busy {busy:.3f} ms, "
                f"the binned tiles {rng:.3f} ms ({100 * rng / busy:.1f}% of the busy time)")

    bb = hp["bounds"]
    print(f"[times] {card} | soft HPR binned: the mask on cloud 10 ({b['mask']['padded']} "
          f"points) {b['mask']['ms']:.3f} ms, {b['mask']['pairs']:.4e} pairs, bound "
          f"{bb['binned_mask'][0]:.4f} ms by {bb['binned_mask'][1]}, one call "
          + binned_share(b["mask"]["trace"]) + "; PoseOptimizer(soft_hpr=True) "
          + "; ".join(f"{n} points {e['ms_per_step']:.3f} ms/step over {e['steps']} steps, peak "
                      f"{e['peak_mib']:.1f} MiB, {e['pairs']:.4e} pairs per mask, bound "
                      f"{bb[f'binned_pose_{n}'][0]:.4f} ms by {bb[f'binned_pose_{n}'][1]}"
                      for n, e in b["pose"].items())
          + f", one step at {BINNED_POSE[0][0]} "
          + binned_share(b["pose"][BINNED_POSE[0][0]]["trace"])
          + f"; TrajectoryOptimizer(soft_hpr=True) cloud 10, {b['traj']['waypoints']} waypoints "
          f"{b['traj']['ms_per_step']:.3f} ms/step, peak {b['traj']['peak_mib']:.1f} MiB, "
          f"{b['traj']['pairs']:.4e} pairs per forward, bound {bb['binned_traj_step'][0]:.4f} ms "
          f"by {bb['binned_traj_step'][1]}, one step " + binned_share(b["traj"]["trace"])
          + f"; optimize_waypoints {b['wps']['steps_per_s']:.2f} steps/s plain, soft "
          f"({b['wps']['soft_pairs']:.4e} pairs per forward, bound "
          f"{bb['binned_wps_step'][0]:.4f} ms by {bb['binned_wps_step'][1]}) timed under "
          f"graphs soft wps",
          flush=True)

    def kernel_text(r, side):
        ms, (bms, by) = r["ms"][side], r["bound"][side]
        return (f"{ms:.4f} ms, bound {bms:.4f} ms by {by} ({100 * bms / ms:.1f}% of it), plain "
                f"{r['plain_ms'][side]:.3f} ms")

    print(f"[times] {card} | binned tile kernels (csrc/soft_binned.cu), per gate call (4 grids, "
          "CUDA events, the wrappers' host time included): " + "; ".join(
              f"cap {cap} ({r['points']} points, {r['pairs']:.4e} pairs) soft_binned_fwd "
              f"{kernel_text(r, 'forward')}, soft_binned_bwd {kernel_text(r, 'backward')}"
              for cap, r in b["kernels"].items())
          + f"; 10 steps of TrajectoryOptimizer(soft_hpr=True) on cloud 10 launched "
          f"{b['traj']['launches']}", flush=True)
    print(f"[times] {card} | soft HPR dense ({hp['soft_n'][0]} points padded to "
          f"{hp['soft_n'][1]}): PoseOptimizer(soft_hpr=True) {hp['soft_pose_ms_per_step']:.3f} "
          f"ms/step, peak {hp['soft_pose_peak_mib']:.1f} MiB, one step "
          + share_text(hp["soft_pose_trace"], hp["bounds"]["soft_pose_step"])
          + f"; TrajectoryOptimizer(soft_hpr=True) {hp['soft_wps']} waypoints "
          f"{hp['soft_traj_ms_per_step']:.3f} ms/step, peak {hp['soft_traj_peak_mib']:.1f} MiB, "
          "one step " + share_text(hp["soft_traj_trace"], hp["bounds"]["soft_traj_step"]),
          flush=True)


def frozen_tile_pairs(opt):
    """(pairs in every tile of the plan, pairs in the tiles that hold a
    query, pairs in the tiles staged): a frozen forward computes cap² pairs
    per tile staged, those that hold a query (the bound's work) and, on the
    captured route, the padding tiles of their rung, and skips the rest
    (the tile-count ladder's padding tiles and coverer-only tiles)."""
    meta = opt._meta
    n_real, n_staged = opt.stats["live_tiles"][-1]
    return (meta.n_sel * meta.n_grids * meta.tiles * meta.cap ** 2, n_real * meta.cap ** 2,
            n_staged * meta.cap ** 2)


def frozen_checks(dev, intr, cloud10, path10, sync):
    """Phase [frozen]: the frozen-routing engine on the card at bench.py's
    shapes, captured (one CUDA graph per plan shape, the default on the
    card) and eager. (a) ``FrozenTrajOptimizer`` on cloud 10 and path 10 on
    both routes: ms/step, the first step of a shape (eager) and its capture,
    replays alone, a traced window of steps between refreshes (device busy,
    operations, host launch and copy calls; on the eager route the tiles'
    share), a
    step between refreshes under ``torch.cuda.set_sync_debug_mode("error")``,
    the memory the captured bucket holds; then 24 steps over 3 refreshes,
    sync and async, captured ``torch.equal`` to eager; then a first capture
    while a plan build runs on the worker thread; (b) at a refresh, the
    frozen loss against the per-step routed binned tier, the f32 step
    against float64, the sparse mean against the embedding path; (c)
    ``FrozenPoseOptimizer`` beside the per-step soft pose step on a uniform
    ±40 m cloud, and (d) ``FrozenWpsOptimizer`` at the waypoints demo's
    shape, each on both routes and held captured == eager over 3 refreshes
    (async); (e) 200 steps of the displaced path at the production
    config on both routes, median and worst 20-step window, shapes
    captured. Returns the numbers for [times] and the record."""
    import gc
    import threading

    import numpy as np
    import torch

    from trajectory_optimization_tpu_torch.api import PoseOptimizer
    from trajectory_optimization_tpu_torch.models import traj_frozen as tf
    from trajectory_optimization_tpu_torch.models.pose import PoseProblem, init_pose_params
    from trajectory_optimization_tpu_torch.models.traj import (
        TrajProblem, init_traj_params, traj_forward, waypoint_stride,
    )
    from trajectory_optimization_tpu_torch.models.wps_opt import (
        WpsOptProblem, init_wps_params, wps_forward,
    )
    from trajectory_optimization_tpu_torch.opt import graphs
    from trajectory_optimization_tpu_torch.opt.engine import OptimizerConfig, value_and_grad
    from trajectory_optimization_tpu_torch.utils.data import identity_quaternions

    res = {}
    part_s, part_t0 = {}, [None, time.perf_counter()]

    def mark(name):
        """Seconds of the part that ends here; the next one is ``name``."""
        now = time.perf_counter()
        if part_t0[0] is not None:
            part_s[part_t0[0]] = now - part_t0[1]
        part_t0[:] = [name, now]

    # the card captures; a CPU rehearsal runs the same static-buffer step uncaptured
    GRAPH = "graph" if dev.type == "cuda" else "static"
    ROUTES = (GRAPH, "eager")
    K_np = intr.matrix_np()
    K = torch.as_tensor(K_np, device=dev)
    q10 = identity_quaternions(len(path10))
    stride = waypoint_stride(path10, 0.5)
    prob = TrajProblem(intr.width, intr.height, wps_step=stride, soft_hpr=True,
                       soft_hpr_dense_max=0)
    cfg = OptimizerConfig(lr_pose=0.1, lr_quat=0.02)

    def finite(*xs):
        return all(bool(torch.isfinite(x).all()) for x in xs)

    def num(v, unit=""):
        return "not measured" if v is None else f"{v:.3f}{unit}"

    def stats_of(opt):
        return dict(opt.stats, live_tiles=list(opt.stats["live_tiles"]))

    def timed_windows(opt, params, st, n_win, per):
        sync()
        times = []
        for _ in range(n_win):
            t0 = time.perf_counter()
            for _ in range(per):
                params, st, loss, _ = opt.step(params, st)
            sync()
            times.append((time.perf_counter() - t0) * 1e3 / per)
        if not finite(loss, *params.values()):
            fail(f"{type(opt).__name__}: non-finite loss or parameters")
        return params, st, times

    def first_steps(opt, params, st):
        """The run's first two steps, each timed: the first refreshes and
        runs the shape's first step eagerly, the second captures (on the
        graph route) and replays. Returns (params, state, ms of each, the
        first one's blocked build ms)."""
        ms = []
        for _ in range(2):
            b0 = opt.stats["build_s"]
            sync()
            t0 = time.perf_counter()
            params, st, _, _ = opt.step(params, st)
            sync()
            ms.append(((time.perf_counter() - t0) * 1e3, (opt.stats["build_s"] - b0) * 1e3))
        return params, st, ms

    def bucket_memory(opt):
        """(MiB allocated, MiB reserved) the optimizer's captured bucket
        holds: its static buffers, and with them its graph's pool."""
        if opt._bucket is None:
            return None
        sync()
        gc.collect()
        torch.cuda.empty_cache()
        a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        opt._drop_bucket()
        gc.collect()
        sync()
        torch.cuda.empty_cache()
        return ((a0 - torch.cuda.memory_allocated()) / 2**20,
                (r0 - torch.cuda.memory_reserved()) / 2**20)

    def replays_ms(opt, n):
        """ms per replay of the current bucket's graph alone (no refresh, no
        copies in or out)."""
        g = opt._bucket.graph
        if g is None or g.graph is None:
            return None
        side = graphs.capture_stream(dev)
        with torch.cuda.stream(side):
            sync()
            t0 = time.perf_counter()
            for _ in range(n):
                g.replay()
            sync()
        return (time.perf_counter() - t0) * 1e3 / n

    def held(make, params0, n_steps, what):
        """Run ``n_steps`` on both routes from ``params0``: every step's
        loss, parameters and aux ``torch.equal``. Returns (steps, refreshes
        and shapes of the captured run)."""
        runs, stats = {}, {}
        for route in ROUTES:
            opt = make()
            opt._route = route
            p, out = params0, []
            st = opt.init(p)
            for _ in range(n_steps):
                p, st, loss, aux = opt.step(p, st)
                out.append([loss, p, aux])
            opt.close()
            runs[route], stats[route] = out, stats_of(opt)
        for i, (g, e) in enumerate(zip(runs[GRAPH], runs["eager"])):
            bad = differ(g, e)
            if bad:
                fail(f"[frozen] {what}: captured step {i} != eager: {'; '.join(bad)}")
        # the same tiles hold a query on both routes; the captured one pads
        if ([n for n, _ in stats[GRAPH]["live_tiles"]]
                != [n for n, _ in stats["eager"]["live_tiles"]]):
            fail(f"[frozen] {what}: the routes built other plans: {stats}")
        return {"steps": n_steps, "refreshes": stats[GRAPH]["refreshes"],
                "captures": stats[GRAPH]["captures"], "live_tiles": stats[GRAPH]["live_tiles"]}

    mark("traj")
    # ---- (a) bench_soft_hpr_traj_step's shape ------------------------------
    warm, n_win, per = FROZEN_WINDOWS
    res["traj"] = {}
    for route in ROUTES:
        opt = tf.FrozenTrajOptimizer(cloud10, K_np, path10, q10, prob, cfg, tf.FrozenPlanConfig(),
                                     device=dev)
        opt._route = route
        params = init_traj_params(path10, q10, dev)
        st = opt.init(params)
        params, st, first = first_steps(opt, params, st)
        for _ in range(warm):
            params, st, _, _ = opt.step(params, st)
        sync()
        torch.cuda.reset_peak_memory_stats()
        params, st, times = timed_windows(opt, params, st, n_win, per)
        peak = (torch.cuda.max_memory_allocated() / 2**20,
                torch.cuda.max_memory_reserved() / 2**20)
        # a step between refreshes reads nothing back: run one under the sync
        # debug mode, after the pending plan build has finished
        while opt._steps_since_refresh != 1:
            params, st, _, _ = opt.step(params, st)
        if opt._pending is not None:
            opt._pending.result()
        sync()
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            params, st, _, _ = opt.step(params, st)
        except RuntimeError as e:
            fail(f"FrozenTrajOptimizer ({route}): a step between refreshes synchronised with "
                 f"the host: {e}")
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
        # the other steps up to the next refresh, traced
        n_trace = opt.plan_cfg.refresh_every - opt._steps_since_refresh
        box = [params, st]

        def window():
            for _ in range(n_trace):
                box[0], box[1], _, _ = opt.step(box[0], box[1])

        tr = trace_window(window, n_trace, sync, tf.FROZEN_TILES_RANGE)
        replay = replays_ms(opt, FROZEN_REPLAYS) if route == GRAPH else None
        pairs = frozen_tile_pairs(opt)
        capture_s = opt._bucket.graph.capture_s if route == GRAPH else None
        entry = {"waypoints": opt._meta.n_sel, "meta": dataclasses.asdict(opt._meta),
                 "first_steps_ms": first, "capture_s": capture_s,
                 "ms_per_step": statistics.median(times), "windows_ms": times,
                 "replay_ms": replay, "peak_mib": peak, "pairs": pairs,
                 "traced_steps": n_trace, "trace": tr, "stats": stats_of(opt),
                 "bucket_mib": bucket_memory(opt) if route == GRAPH else None}
        opt.close()
        res["traj"][route] = entry
        busy, ops = tr["busy_ms"], tr["ops"]
        print(f"[frozen] FrozenTrajOptimizer on cloud 10 ({len(cloud10)} points) and path 10 "
              f"({entry['waypoints']} waypoints at stride {stride}, cap {prob.hpr_cap}, lr "
              f"0.1/0.02, FrozenPlanConfig() (async refresh every 8 steps)), route {route}: "
              f"first step {first[0][0]:.3f} ms ({first[0][1]:.3f} of it the blocked build), "
              f"second {first[1][0]:.3f} ms"
              + (f" (capture {capture_s:.3f} s)" if capture_s is not None else "")
              + f"; {warm} more warm-up steps, then {n_win} windows of {per} steps "
              + ", ".join(f"{t:.3f}" for t in times) + f" ms/step (median "
              f"{entry['ms_per_step']:.3f})"
              + (f", the graph's replays alone {replay:.3f} ms" if replay is not None else "")
              + f"; {n_trace} traced steps between refreshes: host launch calls "
              f"{tr['kernels']:.2f} kernels + {tr['graphs']:.2f} graphs + {tr['copies']:.2f} "
              f"copies per step, "
              + ("device time not measured" if busy is None else
                 f"device busy {busy:.3f} ms/step, {ops:.1f} device operations/step")
              + f"; peak {peak[0]:.1f} MiB allocated, {peak[1]:.1f} reserved"
              + (f"; the captured bucket holds {entry['bucket_mib'][0]:.1f} MiB allocated, "
                 f"{entry['bucket_mib'][1]:.1f} reserved" if entry["bucket_mib"] else "")
              + f"; plan {entry['meta']}, live tiles (holding a query, staged) per refresh "
              f"{entry['stats']['live_tiles']}; {opt.stats['refreshes']} refreshes, "
              f"{opt.stats['captures']} shapes taken, blocked build "
              f"{opt.stats['build_s']:.3f} s; a step between refreshes under "
              f"set_sync_debug_mode('error'): no host sync", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    mark("stall")
    # the stall a new plan shape causes: a sync run takes two refreshes on
    # one shape, then the tile floor is raised a rung, so that the next
    # refresh builds a larger shape: its step (the build excluded: a new
    # bucket and the shape's first step, eagerly) and the step after it (the
    # capture and a replay), each against the median of the steady steps
    res["stall"] = {}
    for route in (GRAPH,):
        sopt = tf.FrozenTrajOptimizer(cloud10, K_np, path10, q10, prob, cfg,
                                      tf.FrozenPlanConfig(async_refresh=False), device=dev)
        sopt._route = route
        every = sopt.plan_cfg.refresh_every
        params = init_traj_params(path10, q10, dev)
        st = sopt.init(params)
        for _ in range(2 * every):
            params, st, _, _ = sopt.step(params, st)
        sopt._t_floor = sopt._meta.tiles + sopt.plan_cfg.tile_round
        ms = []
        for _ in range(every):
            b0 = sopt.stats["build_s"]
            sync()
            t0 = time.perf_counter()
            params, st, _, _ = sopt.step(params, st)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3 - (sopt.stats["build_s"] - b0) * 1e3)
        steady = statistics.median(ms[2:])
        cap = sopt._bucket.graph.capture_s if route == GRAPH else None
        res["stall"][route] = {
            "first_ms": ms[0], "second_ms": ms[1], "steady_ms": steady, "capture_s": cap,
            "stall_ms": ms[0] + ms[1] - 2 * steady, "refresh_interval_ms": every * steady,
            "captures": sopt.stats["captures"], "tiles": sopt._meta.tiles}
        sopt.close()
        gc.collect()
    sg = res["stall"][GRAPH]
    print(f"[frozen] a new plan shape (the tile floor raised a rung at a sync refresh, T "
          f"{sg['tiles']}): its step {sg['first_ms']:.3f} ms (the blocked build excluded: a new "
          f"bucket and its first step, eagerly), the next {sg['second_ms']:.3f} ms (capture "
          f"{num(sg['capture_s'], ' s')} and a replay), steady {sg['steady_ms']:.3f} ms/step: "
          f"a stall of {sg['stall_ms']:.3f} ms against one refresh interval of {every} steps, "
          f"{sg['refresh_interval_ms']:.3f} ms; prewarm captures nothing ahead "
          f"(stats['prewarms'] {res['traj'][GRAPH]['stats']['prewarms']})", flush=True)

    mark("held")
    # held: 24 steps, 3 refreshes, captured == eager, sync and async
    res["traj_held"] = {}
    for mode in (False, True):
        res["traj_held"][mode] = held(
            lambda: tf.FrozenTrajOptimizer(cloud10, K_np, path10, q10, prob, cfg,
                                           tf.FrozenPlanConfig(async_refresh=mode), device=dev),
            init_traj_params(path10, q10, dev), FROZEN_HELD, f"trajectory (async {mode})")
    print(f"[frozen] FrozenTrajOptimizer on cloud 10, {FROZEN_HELD} steps, captured against "
          "eager: every step's loss, parameters and aux torch.equal, sync refresh ("
          f"{res['traj_held'][False]['refreshes']} refreshes, {res['traj_held'][False]['captures']}"
          f" shapes captured) and async ({res['traj_held'][True]['refreshes']} refreshes, "
          f"{res['traj_held'][True]['captures']} shapes)", flush=True)

    mark("forced")
    # a first capture while the worker thread builds a plan: the worker's
    # builder is held in a loop of real builds until the capture is over
    opt = tf.FrozenTrajOptimizer(cloud10, K_np, path10, q10, prob, cfg, tf.FrozenPlanConfig(),
                                 device=dev)
    opt._route = GRAPH
    builds, done, real = [], threading.Event(), opt._build_staged

    def building(host):
        if threading.current_thread() is threading.main_thread():
            return real(host)  # the first plan, built in step()
        while True:
            t0 = time.perf_counter()
            out = real(host)
            builds.append((t0, time.perf_counter()))
            if done.is_set():
                return out

    opt._build_staged = building
    params = init_traj_params(path10, q10, dev)
    st = opt.init(params)
    params, st, _, _ = opt.step(params, st)  # builds, steps eagerly, starts the worker
    deadline = time.perf_counter() + 120.0
    while not builds:
        if time.perf_counter() > deadline:
            fail("[frozen] the worker thread built no plan in 120 s")
        time.sleep(0.005)
    t0 = time.perf_counter()
    try:
        params, st, _, _ = opt.step(params, st)  # captures
        sync()
    except graphs.CaptureError as e:
        fail(f"[frozen] a capture with a plan build in flight failed: {e}")
    t1 = time.perf_counter()
    done.set()
    opt._pending.result()  # the build in flight ends its loop and is recorded
    over = sum(a < t1 and b > t0 for a, b in builds)
    if not over or opt._bucket.graph.graph is None and GRAPH == "graph":
        fail(f"[frozen] no plan build overlapped the first capture ({builds}, {t0}-{t1})")
    for _ in range(2 * opt.plan_cfg.refresh_every):
        params, st, loss, _ = opt.step(params, st)
    if not finite(loss, *params.values()):
        fail("[frozen] the run with a build in flight at its capture went non-finite")
    opt.close()
    del opt._build_staged
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(("frozenplan", "frozenwarm"))]
    if alive:
        fail(f"[frozen] threads of the engine alive after close(): {alive}")
    res["forced"] = {"capture_s": opt.stats["capture_s"], "builds_overlapping": over,
                     "builds": len(builds)}
    print(f"[frozen] a first capture ({1e3 * (t1 - t0):.3f} ms, capture "
          f"{opt.stats['capture_s']:.3f} s) while the worker thread ran {over} plan builds "
          f"(real builds, held in a loop until it ended): captured, then "
          f"{2 * opt.plan_cfg.refresh_every} more steps finite; after close() no thread of "
          "the engine alive", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    mark("refresh")
    # ---- (b) at a refresh, on the card -------------------------------------
    P = torch.as_tensor(cloud10, device=dev)
    p0, qq0 = torch.as_tensor(path10, device=dev), torch.as_tensor(q10, device=dev)
    sel = slice(None, None, stride)
    plan_e, meta_e = tf.build_traj_plan(cloud10, None, path10[sel], q10[sel], K_np, prob)
    dplan_e = tf.put_plan(plan_e, meta_e, dev)
    plan_s, meta_s = tf.build_traj_plan(cloud10, None, path10[sel], q10[sel], K_np, prob,
                                        embed=False)
    dplan_s = tf.put_plan(plan_s, meta_s, dev)
    start = init_traj_params(path10, q10, dev)
    l_f, a_f, g_f = value_and_grad(lambda p: tf.traj_forward_frozen(
        p, dplan_e, meta_e, P, K, p0, qq0, prob), start)
    l_r, a_r, g_r = value_and_grad(lambda p: traj_forward(p, P, K, p0, qq0, prob), start)
    l_s, a_s, g_s = value_and_grad(lambda p: tf.traj_forward_frozen_mean(
        p, dplan_s, meta_s, P, K, p0, qq0, prob), start)

    def relnorm(a, b):
        return float(torch.linalg.norm((a - b).double()) / torch.linalg.norm(b.double()))

    gap = {"loss": abs(float(l_f) - float(l_r)) / abs(float(l_r)),
           "rewards": float((a_f["rewards"] - a_r["rewards"]).abs().max()),
           "grad": max(relnorm(g_f[k], g_r[k]) for k in g_f)}
    mean_gap = {"loss": abs(float(l_s) - float(l_f)) / abs(float(l_f)),
                "mean_reward": abs(float(a_s["mean_reward"]) - float(a_f["mean_reward"])),
                "grad": max(relnorm(g_s[k], g_f[k]) for k in g_f)}
    if not (finite(l_f, l_s, *g_f.values(), *g_s.values()) and gap["loss"] < FROZEN_PINS["loss"]
            and gap["rewards"] < FROZEN_PINS["rewards"] and gap["grad"] < FROZEN_PINS["grad"]):
        fail(f"frozen loss at a refresh against the routed binned tier on cloud 10: {gap} "
             f"(pins {FROZEN_PINS})")
    if not (mean_gap["loss"] < FROZEN_PINS["mean"] and mean_gap["mean_reward"] < 1e-6
            and mean_gap["grad"] < FROZEN_PINS["grad"]):
        fail(f"sparse mean against the embedding path on cloud 10: {mean_gap} "
             f"(pins {FROZEN_PINS})")

    def mean_step(dtype):
        c = lambda x: x.to(dtype)  # noqa: E731
        plan = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in dplan_s.items()}
        loss, _, g = value_and_grad(lambda p: tf.traj_forward_frozen_mean(
            p, plan, meta_s, c(P), c(K), c(p0), c(qq0), prob), {k: c(v) for k, v in start.items()})
        return [loss.cpu().double()] + [g[k].cpu().double() for k in ("poses", "quats")]

    def rel_errs(xs, ys):
        return [float((x - y).abs().max()) / float(y.abs().max()) for x, y in zip(xs, ys)]

    # the f32 step against float64 (BINNED_TOL); beside it, not held, the
    # same step with the gate's norms in f32: what refresh parity costs
    s32, s64 = mean_step(torch.float32), mean_step(torch.float64)
    with f32_gate_norms(tf):
        s32_f32n = mean_step(torch.float32)
    f64_err, f32n_err = rel_errs(s32, s64), rel_errs(s32_f32n, s64)
    if not max(f64_err) <= BINNED_TOL:
        fail(f"frozen step on cloud 10, f32 against float64 on the card: relative max |err| "
             f"(loss, poses, quats) {f64_err} (pin {BINNED_TOL})")
    res["refresh"] = {"vs_routed": gap, "mean_vs_embed": mean_gap, "f32_vs_f64": f64_err,
                      "f32_norms_vs_f64": f32n_err}
    print(f"[frozen] at a refresh on cloud 10 ({meta_e.n_sel} waypoints): frozen against the "
          f"per-step routed binned tier loss rel {gap['loss']:.2e}, rewards max |diff| "
          f"{gap['rewards']:.2e}, gradient relnorm {gap['grad']:.2e} (pins "
          f"{FROZEN_PINS['loss']}, {FROZEN_PINS['rewards']}, {FROZEN_PINS['grad']}); the "
          f"sparse mean against the embedding path loss rel {mean_gap['loss']:.2e}, mean "
          f"reward {mean_gap['mean_reward']:.2e}, gradient {mean_gap['grad']:.2e}; the f32 "
          f"step against float64, relative max |err| loss, poses, quats "
          + ", ".join(f"{e:.2e}" for e in f64_err)
          + f" (pin {BINNED_TOL}), with the gate's norms in f32 "
          + ", ".join(f"{e:.2e}" for e in f32n_err) + " (not held)", flush=True)
    del dplan_e, dplan_s, P, a_f, a_r
    gc.collect()
    torch.cuda.empty_cache()

    mark("pose")
    # ---- (c) bench_frozen_pose_long_range ----------------------------------
    n, steps = FROZEN_POSE
    h_steps, h_every = FROZEN_HELD_VARIANT
    pts = np.random.default_rng(0).uniform(-40, 40, size=(n, 3)).astype(np.float32)
    pprob = PoseProblem(intr.width, intr.height, min_dist=1.0, max_dist=12.0, soft_hpr=True)
    pcfg = OptimizerConfig(lr_pose=0.02, lr_quat=0.02)
    res["pose"] = {"n": n, "steps": steps, "ms_per_step": {}}
    for route in ROUTES:
        popt = tf.FrozenPoseOptimizer(
            pts, K_np, pprob, pcfg,
            tf.FrozenPlanConfig(refresh_every=10_000, async_refresh=False, prewarm=False),
            device=dev)
        popt._route = route
        pp = init_pose_params(np.zeros(3), np.asarray([1.0, 0, 0, 0]), dev)
        pst = popt.init(pp)
        pp, pst, pl0, _ = popt.step(pp, pst)
        pp, pst, _, _ = popt.step(pp, pst)  # warm-up (the capture, on the graph route)
        pp, pst, ptimes = timed_windows(popt, pp, pst, 1, steps)
        pl1 = float(popt.step(pp, pst)[2])
        res["pose"]["ms_per_step"][route] = ptimes[0]
        if route == GRAPH:
            res["pose"]["capture_s"] = popt._bucket.graph.capture_s
            res["pose"]["replay_ms"] = replays_ms(popt, FROZEN_REPLAYS)
            pmeta, ppairs = popt._meta, frozen_tile_pairs(popt)
            res["pose"]["bucket_mib"] = bucket_memory(popt)
            first_loss = (float(pl0), pl1)
        popt.close()
    ref = PoseOptimizer(device=dev, soft_hpr=True, min_dist=1.0, max_dist=12.0, lr_pose=0.02,
                        lr_quat=0.02)
    r0 = ref.optimize(pts, [0.0, 0.0, 0.0], n_steps=0)
    ref.optimize(pts, [0.0, 0.0, 0.0], n_steps=2)  # warm-up
    sync()
    t0 = time.perf_counter()
    ref.optimize(pts, [0.0, 0.0, 0.0], n_steps=steps)
    sync()
    routed_ms = (time.perf_counter() - t0) * 1e3 / steps
    pose_gap = abs(first_loss[0] - r0.loss) / abs(r0.loss)
    if not (pose_gap < FROZEN_PINS["variant"] and first_loss[1] < first_loss[0]):
        fail(f"FrozenPoseOptimizer at {n} points: first loss {first_loss[0]} against the "
             f"per-step {r0.loss} (rel {pose_gap:.2e}, pin {FROZEN_PINS['variant']}); after "
             f"{steps + 2} steps {first_loss[1]}")
    pp0 = init_pose_params(np.zeros(3), np.asarray([1.0, 0, 0, 0]), dev)
    res["pose"]["held"] = held(
        lambda: tf.FrozenPoseOptimizer(pts, K_np, pprob, pcfg, tf.FrozenPlanConfig(
            refresh_every=h_every, prewarm=False), device=dev),
        pp0, h_steps, f"pose at {n} points")
    res["pose"].update(routed_ms=routed_ms, first_loss_gap=pose_gap, loss=first_loss,
                       meta=dataclasses.asdict(pmeta), pairs=ppairs)
    pm = res["pose"]
    print(f"[frozen] FrozenPoseOptimizer on bench_frozen_pose_long_range's cloud ({n} uniform "
          f"+-40 m points, min_dist 1, max_dist 12, refresh_every 10,000): {steps} steps "
          + ", ".join(f"{r} {v:.3f}" for r, v in pm["ms_per_step"].items())
          + f" ms/step (replays alone {num(pm['replay_ms'])}, capture {num(pm['capture_s'], ' s')}"
          + (f", the bucket holds {pm['bucket_mib'][0]:.1f} MiB allocated, "
             f"{pm['bucket_mib'][1]:.1f} reserved" if pm["bucket_mib"] else "")
          + f"), the per-step soft pose step (PoseOptimizer(soft_hpr=True)) "
          f"{routed_ms:.3f} ms/step; first loss against the per-step loss rel {pose_gap:.2e} "
          f"(pin {FROZEN_PINS['variant']}), loss {first_loss[0]:.6f} -> {first_loss[1]:.6f}; "
          f"plan {pm['meta']}; {h_steps} steps at refresh_every {h_every} (async), captured "
          f"against eager: every step torch.equal ({pm['held']['refreshes']} refreshes, "
          f"{pm['held']['captures']} shapes)", flush=True)
    del pts, ref
    gc.collect()
    torch.cuda.empty_cache()

    mark("wps")
    # ---- (d) the waypoints demo's shape ------------------------------------
    wprob = WpsOptProblem(intr.width, intr.height, soft_hpr=True)
    wparams, wfrozen = init_wps_params(path10, q10, dev)
    wcfg = OptimizerConfig(lr_pose=0.02, lr_quat=0.02)
    res["wps"] = {"waypoints": len(path10), "steps": FROZEN_WPS_STEPS, "ms_per_step": {}}
    for route in ROUTES:
        wopt = tf.FrozenWpsOptimizer(cloud10, K_np, wfrozen, wprob, wcfg, tf.FrozenPlanConfig(),
                                     device=dev)
        wopt._route = route
        wst = wopt.init(wparams)
        wp1, wst, wl0, _ = wopt.step(wparams, wst)
        wp1, wst, _, _ = wopt.step(wp1, wst)  # the capture, on the graph route
        wp1, wst, wtimes = timed_windows(wopt, wp1, wst, 1, FROZEN_WPS_STEPS)
        wl1 = float(wopt.step(wp1, wst)[2])
        res["wps"]["ms_per_step"][route] = wtimes[0]
        if route == GRAPH:
            res["wps"]["capture_s"] = wopt._bucket.graph.capture_s
            res["wps"]["replay_ms"] = replays_ms(wopt, FROZEN_REPLAYS)
            wmeta, wpairs = wopt._meta, frozen_tile_pairs(wopt)
            res["wps"]["bucket_mib"] = bucket_memory(wopt)
            wloss = (float(wl0), wl1)
        wopt.close()
    with torch.no_grad():
        wl_ref, _ = wps_forward(wparams, wfrozen, torch.as_tensor(cloud10, device=dev), K, wprob)
    wps_gap = abs(wloss[0] - float(wl_ref)) / abs(float(wl_ref))
    if not (wps_gap < FROZEN_PINS["variant"] and wloss[1] < wloss[0]):
        fail(f"FrozenWpsOptimizer on cloud 10: first loss {wloss[0]} against the per-step "
             f"{float(wl_ref)} (rel {wps_gap:.2e}, pin {FROZEN_PINS['variant']}); after "
             f"{FROZEN_WPS_STEPS + 2} steps {wloss[1]}")
    res["wps"]["held"] = held(
        lambda: tf.FrozenWpsOptimizer(cloud10, K_np, wfrozen, wprob, wcfg,
                                      tf.FrozenPlanConfig(refresh_every=h_every), device=dev),
        wparams, h_steps, "waypoints")
    res["wps"].update(first_loss_gap=wps_gap, loss=wloss, meta=dataclasses.asdict(wmeta),
                      pairs=wpairs)
    wm = res["wps"]
    print(f"[frozen] FrozenWpsOptimizer on cloud 10 and path 10 ({len(path10)} waypoints, cap "
          f"{wprob.hpr_cap}, lr 0.02/0.02): {FROZEN_WPS_STEPS} steps "
          + ", ".join(f"{r} {v:.3f}" for r, v in wm["ms_per_step"].items())
          + f" ms/step (replays alone {num(wm['replay_ms'])}, capture {num(wm['capture_s'], ' s')}"
          + (f", the bucket holds {wm['bucket_mib'][0]:.1f} MiB allocated, "
             f"{wm['bucket_mib'][1]:.1f} reserved" if wm["bucket_mib"] else "")
          + f"; the per-step soft waypoints 2,530-3,028); first loss against the per-step "
          f"wps_forward rel {wps_gap:.2e} (pin {FROZEN_PINS['variant']}), loss "
          f"{wloss[0]:.6f} -> {wloss[1]:.6f}; plan {wm['meta']}; {h_steps} steps at "
          f"refresh_every {h_every} (async), captured against eager: every step torch.equal "
          f"({wm['held']['refreshes']} refreshes, {wm['held']['captures']} shapes)", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    mark("worst")
    # ---- (e) bench_occl_traj_worst_window ----------------------------------
    n_steps, win = WORST
    path_d = (path10 + np.array([0.0, 0.0, 12.0], np.float32)).astype(np.float32)
    dprob = TrajProblem(intr.width, intr.height, wps_step=waypoint_stride(path_d, 0.5),
                        soft_hpr=True, soft_hpr_dense_max=0)
    res["worst"] = {}
    for route in ROUTES:
        opt = tf.FrozenTrajOptimizer(cloud10, K_np, path_d, q10, dprob, cfg,
                                     tf.FrozenPlanConfig(), device=dev)
        opt._route = route
        params = init_traj_params(path_d, q10, dev)
        st = opt.init(params)
        for _ in range(2):
            params, st, _, _ = opt.step(params, st)
        params, st, wins = timed_windows(opt, params, st, n_steps // win, win)
        res["worst"][route] = {"steps": n_steps // win * win, "window": win,
                               "median_ms": statistics.median(wins), "worst_ms": max(wins),
                               "windows_ms": wins, "stats": stats_of(opt),
                               "last_meta": dataclasses.asdict(opt._meta)}
        opt.close()
        w = res["worst"][route]
        print(f"[frozen] bench_occl_traj_worst_window, route {route}: path 10 displaced +12 m "
              f"in z, FrozenPlanConfig() (async refresh every 8), {w['steps']} steps in windows "
              f"of {win}: median {w['median_ms']:.3f}, worst {w['worst_ms']:.3f} ms/step; "
              f"{opt.stats['refreshes']} refreshes, {opt.stats['captures']} shapes taken"
              + (f" (capture {opt.stats['capture_s']:.3f} s in all)" if route == GRAPH else "")
              + f", blocked build {opt.stats['build_s']:.3f} s; live tiles per refresh from "
              f"{opt.stats['live_tiles'][0]} to {opt.stats['live_tiles'][-1]}; last plan "
              f"{w['last_meta']}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    mark(None)
    res["part_s"] = part_s
    print("[frozen] seconds per part: " + ", ".join(f"{k} {v:.1f}" for k, v in part_s.items()),
          flush=True)
    return res


def print_frozen_times(card: str, fr) -> None:
    """[frozen]'s lines under [times], and its bounds into ``fr["bounds"]``:
    a frozen step runs its tiles once forward and once backward."""
    ops = BINNED_OPS["forward"] + BINNED_OPS["backward"]
    graph, eager = (r for r in fr["traj"])
    fr["bounds"] = {"traj": bound(0, fr["traj"][eager]["pairs"][1] * ops),
                    "pose": bound(0, fr["pose"]["pairs"][1] * ops),
                    "wps": bound(0, fr["wps"]["pairs"][1] * ops)}
    b = fr["bounds"]
    t = fr["traj"][eager]
    tr = t["trace"]
    tile_text = ("the tiles not measured" if tr["busy_ms"] is None or tr["tiles_ms"] is None
                 else f"the tiles {tr['tiles_ms']:.3f} ms/step "
                 f"({100 * tr['tiles_ms'] / tr['busy_ms']:.1f}% of the busy time)")

    def launch_text(r):
        x = fr["traj"][r]["trace"]
        return (f"{x['kernels']:.2f} kernels + {x['graphs']:.2f} graphs + {x['copies']:.2f} "
                "copies per step, " + ("device busy not measured" if x["busy_ms"] is None else
                   f"busy {x['busy_ms']:.3f} ms/step ({100 * x['busy_ms'] / x['wall_ms']:.1f}% "
                   f"of the traced time), {x['ops']:.1f} device operations/step"))

    g = fr["traj"][graph]
    print(f"[times] {card} | frozen traj step (cloud 10, {g['waypoints']} waypoints): captured "
          f"{g['ms_per_step']:.3f} ms/step (replays alone "
          + ("not measured" if g["replay_ms"] is None else f"{g['replay_ms']:.3f}")
          + f"), eager {t['ms_per_step']:.3f} (median of {len(t['windows_ms'])} windows, "
          f"refreshes included); between refreshes, captured {launch_text(graph)}; eager "
          f"{launch_text(eager)}, {tile_text}; peak MiB captured {g['peak_mib'][0]:.1f} "
          f"allocated / {g['peak_mib'][1]:.1f} reserved, eager {t['peak_mib'][0]:.1f} / "
          f"{t['peak_mib'][1]:.1f}; stall of a new shape {fr['stall'][graph]['stall_ms']:.3f} "
          f"ms (refresh interval {fr['stall'][graph]['refresh_interval_ms']:.3f}); "
          f"{t['pairs'][1]:.4e} pairs in the tiles holding a query (captured, padded: "
          f"{g['pairs'][2]:.4e}; {t['pairs'][0]:.4e} in all), "
          f"bound {b['traj'][0]:.4f} ms by {b['traj'][1]}; pose at {fr['pose']['n']} points "
          + ", ".join(f"{r} {v:.3f}" for r, v in fr["pose"]["ms_per_step"].items())
          + f" ms/step (per-step {fr['pose']['routed_ms']:.3f}), bound {b['pose'][0]:.4f} ms by "
          f"{b['pose'][1]}; waypoints (27) "
          + ", ".join(f"{r} {v:.3f}" for r, v in fr["wps"]["ms_per_step"].items())
          + f" ms/step, bound {b['wps'][0]:.4f} ms by {b['wps'][1]}; worst window "
          + "; ".join(f"{r}: median {w['median_ms']:.3f}, worst {w['worst_ms']:.3f} ms/step, "
                      f"{w['stats']['captures']} shapes"
                      for r, w in fr["worst"].items()), flush=True)


CLI_PAIRS = 3  # cloud-10/path-10 pairs in the trajectory preset's bag
# [cli] (d): each preset's msgs/s (clouds/s for the processor) in CLI_WINDOWS
# windows after one warm-up message, each window at least CLI_WINDOW messages
# and seconds; the recorder's MB/s over CLI_RECORD_PASSES passes
CLI_WINDOWS = 2
CLI_WINDOW = (8, 1.0)
CLI_RECORD_PASSES = 5


def cli_checks(dev, intr, cloud10, path10, sync):
    """[cli], the shell entry point (``__main__.main``) in this process on
    the card: (a) ``eval`` of cloud 10 and path 10 with ``--optimize 100``
    against a direct ``TrajectoryOptimizer`` run (the printed lines equal;
    K1–K4 launched); (b) the ``trajectory_optimization`` preset replaying a
    bag of ``CLI_PAIRS`` cloud-10/path-10 pairs (written by the port's
    ``write_bag``) with ``--record`` and ``--echo``, in-process and with
    ``--processes``: every optimized path ``array_equal`` to TrajOptNode
    driven directly with ``default_trajopt_config()``, read back from the
    recording; (c) the ``pointcloud_processor`` preset at its default
    ``hpr_backend`` over a bag of cloud 10, the six-camera ring's /tf and
    its six camera infos, in-process (K6 once per camera) and with
    ``--processes``, recording the six image topics: each recorded image
    equal to the node's own image after ``.cpu()``; (d) the worker's
    start-up seconds, each preset's msgs/s in-process and with processes
    over ``CLI_WINDOWS`` windows, and the recorder's MB/s on the rig's six
    images over ``CLI_RECORD_PASSES`` passes. Returns the numbers
    for [times] and the record."""
    import contextlib
    import gc
    import io
    import os
    import tempfile

    import numpy as np
    import torch

    from trajectory_optimization_tpu_torch.__main__ import main as cli
    from trajectory_optimization_tpu_torch.api import TrajectoryOptimizer
    from trajectory_optimization_tpu_torch.bus import launch as L
    from trajectory_optimization_tpu_torch.bus.core import Bus
    from trajectory_optimization_tpu_torch.bus.messages import (
        CameraInfoMsg, CloudMsg, Header, PathMsg, TransformMsg,
    )
    from trajectory_optimization_tpu_torch.bus.nodes import PointsProcessorNode, TrajOptNode
    from trajectory_optimization_tpu_torch.bus.rosbag import BagRecorder, read_bag, write_bag
    from trajectory_optimization_tpu_torch.models.traj import waypoint_stride
    from trajectory_optimization_tpu_torch.ops import _kernels
    from trajectory_optimization_tpu_torch.utils.config import PointsProcessorConfig

    res = {"startup_s": {}, "msgs_per_s": {}, "run_s": {}}
    device = f"{dev.type}:{dev.index}" if dev.index is not None else dev.type
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_cli_")
    d = Path(tmp.name)

    def run(argv):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli([*argv, "--device", device])
        sync()
        return rc, out.getvalue(), time.perf_counter() - t0

    def wait(pred, timeout=240.0):
        t0 = time.monotonic()
        while not pred():
            if time.monotonic() - t0 > timeout:
                fail("[cli]: timed out waiting for a node's output")
            time.sleep(0.01)

    # ---- (a) eval --optimize 100 against the facade --------------------------
    cloud_f = str(ROOT / "data" / "points" / "point_cloud_10.npz")
    path_f = str(ROOT / "data" / "paths" / "path_poses_10.npz")
    _kernels.reset_launches()
    rc, out, res["run_s"]["eval"] = run(["eval", cloud_f, path_f, "--optimize", "100"])
    launches = {n: v for n, v in _kernels.LAUNCHES.items() if v}
    opt = TrajectoryOptimizer(device=dev)
    stride = waypoint_stride(path10, opt.vis_wps_dist)

    def report(tag, ev):
        return (f"{tag}: observed {ev.n_observed}/{len(cloud10)} "
                f"({100 * ev.frac_observed:.1f}%), mean reward {ev.mean_reward:.4f}, length "
                f"{ev.length:.2f} m, mean angle {ev.mean_angle:.3f} rad")

    ev0 = opt.evaluate(cloud10, path10, wps_step=stride)
    r = opt.optimize(cloud10, path10, n_steps=100)
    ev1 = opt.evaluate(cloud10, r.poses.astype(np.float32), r.quats_wxyz.astype(np.float32),
                       wps_step=stride)
    want = [report("initial  ", ev0), report("optimized", ev1)]
    if rc != 0 or out.splitlines()[:2] != want or set(launches) != set(CACHED + LOSS):
        fail(f"[cli] eval --optimize 100: rc {rc}, printed {out.splitlines()}, the facade "
             f"{want}; launches {launches} (expected K1-K4 and the loss's: {CACHED + LOSS})")
    res["eval"] = {"lines": want, "launches": launches}
    print(f"[cli] eval cloud 10 path 10 --optimize 100: rc 0 in {res['run_s']['eval']:.2f} s, "
          f"the printed census == TrajectoryOptimizer(device='cuda')'s ({want[0]!r}; "
          f"{want[1]!r}); launches {launches}", flush=True)

    # ---- (b) the trajectory_optimization preset over a bag --------------------
    cfg = L.default_trajopt_config()
    opt_topic = cfg.path_topic + "/optimized"
    pairs = []
    for i in range(CLI_PAIRS):
        hdr = Header(stamp=1.0 + i, frame_id="map", seq=i)
        pairs += [(cfg.pc_topic, CloudMsg(hdr, cloud10)),
                  (cfg.path_topic, PathMsg.straight(path10, frame_id="map", stamp=1.0 + i))]
    bag = str(d / "traj.bag")
    write_bag(bag, pairs)
    bus = Bus(error_policy="raise")
    node = TrajOptNode(bus, cfg, device=dev)
    direct = []
    bus.subscribe(opt_topic, direct.append)
    for topic, msg in pairs:
        bus.publish(topic, msg)
    node.close()
    if len(direct) != CLI_PAIRS:
        fail(f"[cli] TrajOptNode driven directly published {len(direct)} paths")
    for mode in ("in-process", "processes"):
        rec = str(d / f"traj_{mode}.bag")
        argv = ["trajectory_optimization", "--play", bag, "--record", rec, "--echo", opt_topic]
        rc, out, res["run_s"][f"traj {mode}"] = run(
            argv + (["--processes"] if mode == "processes" else []))
        got = [m for _, t, m in read_bag(rec) if t == opt_topic]
        if rc != 0 or f"{opt_topic}: {CLI_PAIRS} msgs" not in out.splitlines() or len(got) != \
                CLI_PAIRS:
            fail(f"[cli] trajectory_optimization ({mode}): rc {rc}, {len(got)} recorded paths, "
                 f"printed {out.splitlines()[-4:]}")
        for a, b in zip(got, direct):
            if not (np.array_equal(a.positions, b.positions)
                    and np.array_equal(a.orientations_xyzw, b.orientations_xyzw)):
                fail(f"[cli] trajectory_optimization ({mode}): a recorded path differs from "
                     f"TrajOptNode's (max |d pose| {np.abs(a.positions - b.positions).max():.3e})")
    print(f"[cli] trajectory_optimization --play (a bag of {CLI_PAIRS} cloud-10/path-10 pairs on "
          f"{cfg.pc_topic}, {cfg.path_topic}) --record --echo {opt_topic}: rc 0, {CLI_PAIRS} "
          f"msgs, every recorded path array_equal to TrajOptNode(default_trajopt_config(), "
          f"device='cuda') driven directly, in-process "
          f"({res['run_s']['traj in-process']:.2f} s) and from a worker on the card with "
          f"--processes ({res['run_s']['traj processes']:.2f} s, start-up and the 3 s drain "
          f"included)", flush=True)
    del bus, node

    # ---- (c) the pointcloud_processor preset over a bag ------------------------
    cams = [f"cam{i}" for i in range(6)]
    infos = tuple(f"/{c}/info" for c in cams)
    img_topics = [f"/{c}/pointcloud_image" for c in cams]
    H, W = int(intr.height), int(intr.width)
    kflat = tuple(intr.matrix_np(np.float64).reshape(-1))

    def rig_msgs(stamp):
        out = [("/tf", TransformMsg(Header(stamp=stamp, frame_id="world"), c, t, [0, 0, 0, 1]))
               for c, t in zip(cams, RING)]
        out.append(("/cloud", CloudMsg(Header(stamp=stamp, frame_id="world"), cloud10)))
        out += [(t, CameraInfoMsg(Header(stamp=stamp, frame_id=c), W, H, K=kflat))
                for c, t in zip(cams, infos)]
        return out

    bag = str(d / "rig.bag")
    write_bag(bag, rig_msgs(1.0))
    pcfg = PointsProcessorConfig(pc_topic="/cloud", cam_info_topics=infos)
    bus = Bus(error_policy="raise")
    PointsProcessorNode(bus, pcfg, device=dev)
    own = {}
    for c, t in zip(cams, img_topics):
        bus.subscribe(t, lambda m, c=c: own.__setitem__(c, m.data.cpu().numpy()))
    for topic, msg in rig_msgs(1.0):
        bus.publish(topic, msg)
    sync()
    if sorted(own) != cams or pcfg.hpr_backend != "approx":
        fail(f"[cli] PointsProcessorNode driven directly: images from {sorted(own)}")
    for mode in ("in-process", "processes"):
        rec = str(d / f"rig_{mode}.bag")
        _kernels.reset_launches()
        rc, out, res["run_s"][f"rig {mode}"] = run(
            ["pointcloud_processor", "pc_topic=/cloud", "cam_info_topics=" + ",".join(infos),
             "--play", bag, "--record", rec, "--record-topics", *img_topics,
             "--echo", *img_topics]  # with --processes the echo counts are what --drain awaits
            + (["--processes"] if mode == "processes" else []))
        launches = {n: v for n, v in _kernels.LAUNCHES.items() if v}
        got = {t: m for _, t, m in read_bag(rec)}
        if rc != 0 or sorted(got) != sorted(img_topics) or not all(
                f"{t}: 1 msgs" in out.splitlines() for t in img_topics):
            fail(f"[cli] pointcloud_processor ({mode}): rc {rc}, recorded {sorted(got)}, "
                 f"printed {out.splitlines()[-7:]}")
        if mode == "in-process" and launches != {"splat_runs": len(cams)}:
            fail(f"[cli] pointcloud_processor in-process launched {launches}; expected K6 "
                 f"(splat_runs) once per camera")
        for c, t in zip(cams, img_topics):
            if not (got[t].encoding == "rgb32f" and np.array_equal(got[t].data, own[c])):
                fail(f"[cli] pointcloud_processor ({mode}) {t}: the recorded image differs from "
                     f"the node's own after .cpu()")
        res.setdefault("rig_launches", {})[mode] = launches
    print(f"[cli] pointcloud_processor (hpr_backend {pcfg.hpr_backend!r}) --play (cloud 10, the "
          f"ring's /tf, six camera infos at {W}x{H}) --record --echo (six image topics): rc 0, "
          f"1 msgs on each, each recorded rgb32f image == PointsProcessorNode's own after "
          f".cpu(), in-process ({res['run_s']['rig in-process']:.2f} s; launches "
          f"{res['rig_launches']['in-process']}) "
          f"and with --processes ({res['run_s']['rig processes']:.2f} s)", flush=True)
    del bus

    # ---- (d) start-up, msgs/s, the recorder's MB/s ----------------------------
    def rates(send, done):
        """msgs/s of CLI_WINDOWS windows after one warm-up message: ``send(i)``
        publishes message i, ``done()`` counts the messages answered. At most
        two messages are in flight, and each window is drained before the
        next starts."""
        send(0)
        wait(lambda: done() >= 1)
        sent, out = 1, []
        n_min, t_min = CLI_WINDOW
        for _ in range(CLI_WINDOWS):
            first, t0 = sent, time.perf_counter()
            while sent - first < n_min or time.perf_counter() - t0 < t_min:
                wait(lambda: done() >= sent - 1)
                send(sent)
                sent += 1
            wait(lambda: done() >= sent)
            sync()
            out.append((sent - first) / (time.perf_counter() - t0))
        return out

    def traj_send(h, i):
        h.bus.publish(cfg.pc_topic, CloudMsg(Header(stamp=10.0 * i, frame_id="map"), cloud10))
        h.bus.publish(cfg.path_topic, PathMsg.straight(path10, stamp=10.0 * i))

    def rig_send(h, i):
        for topic, msg in rig_msgs(10.0 * i):
            h.bus.publish(topic, msg)

    for mode in ("in-process", "processes"):
        procs = mode == "processes"
        t0 = time.perf_counter()
        h = L.launch_trajectory_optimization(processes=procs, device=dev)
        if procs:
            res["startup_s"]["trajectory_optimization"] = time.perf_counter() - t0
        outs = []
        h.bus.subscribe(opt_topic, outs.append)
        try:
            res["msgs_per_s"][f"trajectory_optimization {mode}"] = rates(
                lambda i: traj_send(h, i), lambda: len(outs))
        finally:
            h.close()
        t0 = time.perf_counter()
        h = L.launch_pointcloud_processor(processes=procs, overrides=pcfg, device=dev)
        if procs:
            res["startup_s"]["pointcloud_processor"] = time.perf_counter() - t0
        imgs = []  # arrivals only: a cloud's six images are 143 MB
        for t in img_topics:
            h.bus.subscribe(t, lambda m: imgs.append(m.header.stamp))
        try:
            res["msgs_per_s"][f"pointcloud_processor {mode}"] = rates(
                lambda i: rig_send(h, i), lambda: len(imgs) // len(cams))
        finally:
            h.close()
        del imgs
    # the recorder alone: the rig's six CUDA images, rendered once, recorded
    # (the host copy, the encode and the write) from publish to closed file,
    # CLI_RECORD_PASSES times, each into a new bag
    bus = Bus(error_policy="raise")
    node = PointsProcessorNode(bus, pcfg, device=dev)
    rendered = []
    for t in img_topics:
        bus.subscribe(t, lambda m: rendered.append(m))
    for topic, msg in rig_msgs(1.0):
        bus.publish(topic, msg)
    sync()
    if len(rendered) != len(cams) or not all(m.data.is_cuda == (dev.type == "cuda")
                                             for m in rendered):
        fail(f"[cli] the rig published {len(rendered)} images, not on {dev}")
    image_bytes = sum(m.data.numel() * m.data.element_size() for m in rendered)
    record_s = []
    for k in range(CLI_RECORD_PASSES):
        rbus = Bus(error_policy="raise")
        rec = BagRecorder(rbus, img_topics, str(d / f"record{k}.bag"))
        t0 = time.perf_counter()
        for t, m in zip(img_topics, rendered):
            rbus.publish(t, m)
        rec.close()
        record_s.append(time.perf_counter() - t0)
        if rec.count != len(cams) or rec.skipped:
            fail(f"[cli] BagRecorder wrote {rec.count} images, skipped {rec.skipped}")
        nbytes = sum(os.path.getsize(p) for p in rec.paths)
        for p in rec.paths:
            os.remove(p)
    res["record"] = {"images": len(cams), "bag_bytes": nbytes, "image_bytes": image_bytes,
                     "record_s": record_s,
                     "mb_per_s": [image_bytes / 1e6 / t for t in record_s]}
    del bus, rbus, node, rendered
    tmp.cleanup()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[cli] launch handles: worker start-up (spawn to HELLO: the torch import and a "
          f"CUDA context) " + ", ".join(f"{k} {v:.2f} s" for k, v in res["startup_s"].items())
          + f"; msgs/s after one warm-up message, {CLI_WINDOWS} windows of at least "
          f"{CLI_WINDOW[0]} messages and {CLI_WINDOW[1]} s each (median [min, max]) "
          + ", ".join(f"{k} {spread(v)}" for k, v in res["msgs_per_s"].items())
          + f"; BagRecorder of the rig's six images ({image_bytes / 1e6:.1f} MB of rgb32f "
          f"pixels on the card, a {nbytes / 1e6:.1f} MB bag), {CLI_RECORD_PASSES} passes from "
          f"publish to the closed file: seconds {spread(record_s)}, MB/s "
          f"{spread(res['record']['mb_per_s'])}", flush=True)
    return res


# ---------------------------------------------------------------------------
# 11. the parallel layer: ranks of torch.distributed on the card
# ---------------------------------------------------------------------------

PAR_STEPS = 20  # train steps held against the single-card step
PAR_WORLD = 4  # spawned gloo ranks sharing the card: the 2-rank and 2x2 meshes
PAR_FROZEN = (8, 4)  # FrozenShardedTrajOptimizer steps, refresh_every: one refresh after the first plan
# tests/test_sharded_pallas.py's pins: lo, gradients, the train step's losses and params
PAR_PINS = {"lo": (1e-4, 2e-4), "grad": (2e-3, 2e-3), "loss": 1e-4, "params": (5e-3, 5e-4)}
# tests/test_hpr_sharded.py's and tests/test_traj_sharded.py's pins for the soft-HPR modules
SOFT_PINS = {"mean": 1e-4, "far": (0.01, 1e-3), "loss": 1e-4, "grad": 5e-3, "rewards": 5e-5,
             "runner": 1e-3, "runner_poses": 0.01}
PAR_WPS = 4  # waypoints of path 10 in the soft waypoints check


def parallel_inputs():
    """The phase's inputs, numpy, made alike in the parent and in every rank:
    the 1m50 shape of [kernels] (seeded cloud, 50 waypoints, every third
    rotated), cloud 10 padded to a multiple of 2,048 with the 27 waypoints of
    path 10 (every third rotated), and seeded cotangents and weights."""
    import numpy as np

    from trajectory_optimization_tpu_torch.models.traj import waypoint_stride
    from trajectory_optimization_tpu_torch.utils.data import (
        identity_quaternions, load_path, load_point_cloud, pad_points)

    rng = np.random.default_rng(0)
    big_pts = rng.uniform(-20, 20, size=(1_048_576, 3)).astype(np.float32)
    t = np.linspace(0, 1, 50, dtype=np.float32)
    big_path = np.stack([30 * t, 10 * np.sin(4 * t), np.zeros_like(t)], axis=1).astype(np.float32)
    q50 = identity_quaternions(50)
    q50[::3] = [0.9, 0.1, -0.3, 0.2]
    cloud10 = load_point_cloud(str(ROOT / "data/points/point_cloud_10.npz"))
    path10 = load_path(str(ROOT / "data/paths/path_poses_10.npz"))
    p10, v10 = pad_points(cloud10, multiple=2048)
    q27 = identity_quaternions(len(path10))
    q27[::3] = [0.9, 0.1, -0.3, 0.2]
    q27 = q27 / np.linalg.norm(q27, axis=1, keepdims=True)
    g = np.random.default_rng(1)
    return dict(big=big_pts, big_path=big_path, q50=q50,
                stride50=waypoint_stride(big_path, 0.5), g_big=g.normal(size=len(big_pts)).astype(np.float32),
                p10=p10, v10=v10, path10=path10, q27=q27, stride10=waypoint_stride(path10, 0.5),
                g10=g.normal(size=len(p10)).astype(np.float32),
                w10=g.normal(size=len(p10)).astype(np.float32))


def _par_problems(intr, X):
    from trajectory_optimization_tpu_torch.models.pose import PoseProblem
    from trajectory_optimization_tpu_torch.models.traj import TrajProblem
    from trajectory_optimization_tpu_torch.models.wps_opt import WpsOptProblem

    soft = dict(soft_hpr=True, soft_hpr_dense_max=0)
    return {"traj50": TrajProblem(intr.width, intr.height, wps_step=X["stride50"]),
            "traj27": TrajProblem(intr.width, intr.height, wps_step=1),
            "pose": PoseProblem(intr.width, intr.height, min_dist=1.0, max_dist=12.0, **soft),
            "wps": WpsOptProblem(intr.width, intr.height, min_dist=1.0, max_dist=12.0, **soft),
            "soft": TrajProblem(intr.width, intr.height, wps_step=X["stride10"], **soft)}


def _warm_ms(fn, n: int):
    """(fn()'s last result, the median wall ms of n synchronized calls after
    a warm-up call)."""
    import torch

    out = fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return out, statistics.median(times)


def _par_lo_grads(lo_fn, q, t, dev, reduce):
    """(lo, dq, dt, ms) of lo_fn(quats, trans) and the gradient of
    reduce(Σ lo·g) inside it; ms is the median of 3 forward and backward
    passes after a warm-up."""
    import torch

    def once():
        qq = torch.tensor(q, device=dev, requires_grad=True)
        tt = torch.tensor(t, device=dev, requires_grad=True)
        lo, loss = lo_fn(qq, tt)
        dq, dt = torch.autograd.grad(reduce(loss), [qq, tt])
        return lo.detach(), dq, dt

    out, ms = _warm_ms(once, 3)
    return (*out, ms)


def _par_train(step_fn, init_fn, params, args, n):
    """n steps; (losses, params, ms/step over the steps after the first,
    the states each step started from: {name: (n, ...)} of the parameters
    and the Adam moments, and the (n,) counts)."""
    import torch

    opt = init_fn(params)
    losses, states = [], []
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(n):
        states.append({**{f"p/{k}": v for k, v in params.items()},
                       **{f"mu/{k}": v for k, v in opt["mu"].items()},
                       **{f"nu/{k}": v for k, v in opt["nu"].items()}, "count": opt["count"]})
        params, opt, loss, _ = step_fn(params, opt, *args)
        losses.append(loss)
        if i == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t1) / max(n - 1, 1)
    states = {k: torch.stack([s[k] for s in states]) for k in states[0]}
    return torch.stack(losses), params, ms, states


def _single_train(loss_fn, params, cfg, n, tx=None):
    """The single-card step the sharded steps are held to: value_and_grad of
    the loss, ``make_optimizer``'s update, ``apply_updates``."""
    import torch

    from trajectory_optimization_tpu_torch.opt.engine import (
        apply_updates, make_optimizer, value_and_grad)

    tx = tx or make_optimizer(cfg)
    opt = tx.init(params)
    losses = []
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(n):
        loss, _, grads = value_and_grad(loss_fn, params)
        upd, opt = tx.update(grads, opt, params)
        params = apply_updates(params, upd)
        losses.append(loss)
        if i == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    torch.cuda.synchronize()
    return torch.stack(losses), params, 1e3 * (time.perf_counter() - t1) / max(n - 1, 1)


def parallel_rank(rank, world, port, out_dir):
    """One spawned rank of the [parallel] phase: gloo on the card (cuda:0,
    shared with the other ranks), the kernels loaded from the parent's
    build; saves its arrays, launch counts and times to out_dir."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    from trajectory_optimization_tpu_torch.ops import _kernels

    _kernels._load()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        res = _parallel_rank_body(rank, world, torch.device("cuda", 0))
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _parallel_rank_body(rank, world, dev):
    import numpy as np
    import torch

    from trajectory_optimization_tpu_torch.models.pose import init_pose_params
    from trajectory_optimization_tpu_torch.models.traj import init_traj_params
    from trajectory_optimization_tpu_torch.models.traj_frozen import FrozenPlanConfig
    from trajectory_optimization_tpu_torch.models.wps_opt import init_wps_params
    from trajectory_optimization_tpu_torch.ops import _kernels
    from trajectory_optimization_tpu_torch.ops import fused_vis as fv
    from trajectory_optimization_tpu_torch.opt.engine import OptimizerConfig, value_and_grad
    from trajectory_optimization_tpu_torch.parallel.hpr_sharded import hpr_mask_soft_binned_sharded
    from trajectory_optimization_tpu_torch.parallel.mesh import all_reduce, make_mesh, points_sharding
    from trajectory_optimization_tpu_torch.parallel.pose_sharded import pose_loss_sharded
    from trajectory_optimization_tpu_torch.parallel.sharded import make_sharded_train_step
    from trajectory_optimization_tpu_torch.parallel.sharded_pallas import sharded_fused_lo_sum
    from trajectory_optimization_tpu_torch.parallel.traj_frozen_sharded import (
        FrozenShardedTrajOptimizer)
    from trajectory_optimization_tpu_torch.parallel.traj_sharded import traj_soft_hpr_loss_sharded
    from trajectory_optimization_tpu_torch.parallel.wps_sharded import wps_loss_sharded
    from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics

    intr = default_intrinsics()
    K = intr.matrix(device=dev)
    X = parallel_inputs()
    probs = _par_problems(intr, X)
    cfg = OptimizerConfig(lr_pose=0.1, lr_quat=0.02)
    m2 = make_mesh(2, devices=[dev] * world)
    m22 = make_mesh(4, wps=2, devices=[dev] * world)
    res = {}

    def put(key, v):
        res[key] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    def fused_case(tag, mesh, pts, valid, g, q, t, prob, steps):
        P, V, G = (points_sharding(mesh, x) for x in (pts, valid, g))
        sel = slice(None, None, prob.wps_step)
        _kernels.reset_launches()
        lo, dq, dt, ms = _par_lo_grads(
            lambda qq, tt: (lambda lo: (lo, torch.sum(lo * G)))(sharded_fused_lo_sum(
                mesh, P, qq, tt, K, intr.width, intr.height, valid=V)),
            q[sel], t[sel], dev, lambda x: all_reduce(x, mesh, "pts"))
        for k, v in (("lo", lo), ("dq", dq), ("dt", dt), ("lo_ms", ms)):
            put(f"{tag}/{k}", v)
        if steps:
            init_fn, step_fn = make_sharded_train_step(mesh, prob, cfg)
            losses, params, ms, states = _par_train(
                step_fn, init_fn, init_traj_params(t, q, device=dev),
                (P, V, K, torch.as_tensor(t, device=dev), torch.as_tensor(q, device=dev)), steps)
            for k, v in (("losses", losses), ("poses", params["poses"]),
                         ("quats", params["quats"]), ("step_ms", ms)):
                put(f"{tag}/{k}", v)
            for k, v in states.items():
                put(f"{tag}/state/{k}", v)
        for k, v in _kernels.LAUNCHES.items():
            put(f"{tag}/launches/{k}", v)

    budget = fv.SCORE_CACHE_MAX_BYTES
    if m2.member:
        for regime, b in (("cached", budget), ("uncached", 0)):
            fv.SCORE_CACHE_MAX_BYTES = b
            fused_case(f"d2/{regime}", m2, X["big"], np.ones(len(X["big"]), np.float32),
                       X["g_big"], X["q50"], X["big_path"], probs["traj50"], PAR_STEPS)
        fv.SCORE_CACHE_MAX_BYTES = budget
    torch.cuda.empty_cache()
    fused_case("m22", m22, X["p10"], X["v10"], X["g10"], X["q27"], X["path10"], probs["traj27"], 0)
    torch.cuda.empty_cache()

    if m2.member:  # the soft-HPR modules at D = 2 on cloud 10
        P, V, W = (points_sharding(m2, x) for x in (X["p10"], X["v10"], X["w10"]))
        cam = points_sharding(m2, X["p10"] - X["path10"][9]).requires_grad_(True)
        def mask_and_grad():
            vis = hpr_mask_soft_binned_sharded(cam, m2, valid=V)
            return vis, torch.autograd.grad(all_reduce(torch.sum(vis * W), m2, "pts"), [cam])[0]

        (vis, d_cam), ms = _warm_ms(mask_and_grad, 1)
        put("soft/hpr_ms", ms)
        put("soft/hpr/vis", vis)
        put("soft/hpr/dcam", d_cam)
        q0 = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
        wparams, wfrozen = init_wps_params(X["path10"][:PAR_WPS],
                                           np.tile(q0, (PAR_WPS, 1)), device=dev)
        cases = {
            "pose": (lambda p: (lambda lo: (lo[0], {"obs": lo[1]}))(pose_loss_sharded(
                m2, p, P, V, K, probs["pose"])), init_pose_params(X["path10"][0], q0, device=dev)),
            "wps": (lambda p: wps_loss_sharded(m2, p, wfrozen, P, V, K, probs["wps"]), wparams),
            "traj": (lambda p: traj_soft_hpr_loss_sharded(
                m2, p, P, V, K, torch.as_tensor(X["path10"], device=dev), probs["soft"]),
                init_traj_params(X["path10"], X["q27"], device=dev)),
        }
        for name, (fn, params) in cases.items():
            (loss, aux, grads), ms = _warm_ms(lambda: value_and_grad(fn, params), 1)
            put(f"soft/{name}_ms", ms)
            put(f"soft/{name}/loss", loss)
            for k, v in grads.items():
                put(f"soft/{name}/d{k}", v)
            if name == "traj":
                put("soft/traj/rewards", aux["rewards"])
        n, every = PAR_FROZEN
        opt = FrozenShardedTrajOptimizer(
            m2, X["p10"], K, X["path10"], X["q27"], probs["soft"], cfg,
            FrozenPlanConfig(refresh_every=every, async_refresh=False), valid=X["v10"])
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p_end, losses = opt.run(init_traj_params(X["path10"], X["q27"], device=dev), n)
            torch.cuda.synchronize()
            put("soft/frozen_ms", 1e3 * (time.perf_counter() - t0) / n)
            put("soft/frozen/losses", losses)
            put("soft/frozen/poses", p_end["poses"])
            put("soft/frozen/refreshes", opt.stats["refreshes"])
        finally:
            opt.close()
    return res


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_checks(dev, intr, sync):
    """[parallel]: the parallel layer on the card. D = 1 over nccl in this
    process at 1m50; then PAR_WORLD spawned gloo ranks sharing the card: the
    2-rank mesh at 1m50 in both regimes, the 2x2 mesh at cloud 10 x 27, the
    soft-HPR modules at D = 2 on cloud 10; every result held against the
    single-card function on the card here."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from trajectory_optimization_tpu_torch.models.pose import init_pose_params, pose_forward
    from trajectory_optimization_tpu_torch.models.traj import (
        init_traj_params, traj_criterion, traj_forward)
    from trajectory_optimization_tpu_torch.models.traj_frozen import (
        FrozenPlanConfig, FrozenTrajOptimizer)
    from trajectory_optimization_tpu_torch.models.wps_opt import init_wps_params, wps_forward
    from trajectory_optimization_tpu_torch.ops import _kernels
    from trajectory_optimization_tpu_torch.ops import fused_vis as fv
    from trajectory_optimization_tpu_torch.ops.hpr import hpr_mask_soft_binned
    from trajectory_optimization_tpu_torch.opt.engine import (
        OptimizerConfig, make_optimizer, value_and_grad)
    from trajectory_optimization_tpu_torch.parallel.mesh import all_reduce, make_mesh, points_sharding
    from trajectory_optimization_tpu_torch.parallel.sharded import make_sharded_train_step
    from trajectory_optimization_tpu_torch.parallel.sharded_pallas import sharded_fused_lo_sum

    t_phase = time.perf_counter()
    K = intr.matrix(device=dev)
    X = parallel_inputs()
    probs = _par_problems(intr, X)
    cfg = OptimizerConfig(lr_pose=0.1, lr_quat=0.02)
    out = {"ms": {}, "launches": {}}
    T = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731

    def equal(what, got, want):
        if not torch.equal(got, want):
            fail(f"[parallel] {what}: not torch.equal (max |diff| "
                 f"{float((got.float() - want.float()).abs().max()):.3e})")

    def close(what, got, want, rtol, atol):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        if not np.allclose(got, want, rtol=rtol, atol=atol):
            err = np.abs(got - want) - atol - rtol * np.abs(want)
            fail(f"[parallel] {what}: off by {float(err.max()):.3e} beyond rtol {rtol} / atol {atol}")

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    # ---- single-card references, on the card ---------------------------------
    def single_lo(pts, valid, g, q, t, prob):
        P, V, G = T(pts), T(valid), T(g)
        sel = slice(None, None, prob.wps_step)
        lo, dq, dt, ms = _par_lo_grads(
            lambda qq, tt: (lambda lo: (lo, torch.sum(lo * G)))(fv.fused_lo_sum(
                P, qq, tt, K, intr.width, intr.height, valid=V)),
            q[sel], t[sel], dev, lambda x: x)
        return dict(lo=lo, dq=dq, dt=dt, lo_ms=ms)

    def single_steps(pts, valid, q, t, prob, n):
        # what the sharded kernel path distributes: the fused visibility passes
        # and the plain criterion (traj_forward's kernel backend fuses the
        # criterion too, and rounds it otherwise)
        P, V, p0 = T(pts), T(valid), T(t)
        Pt = P.t().contiguous()
        sel = slice(None, None, prob.wps_step)

        def loss_fn(p):
            lo = fv.fused_lo_sum(P, p["quats"][sel], p["poses"][sel], K, intr.width,
                                 intr.height, valid=V, points_t=Pt)
            return traj_criterion(lo, p, p0, prob, valid=V)

        losses, params, ms = _single_train(loss_fn, init_traj_params(t, q, device=dev), cfg, n)
        return dict(losses=losses, poses=params["poses"], quats=params["quats"], step_ms=ms)

    ones = np.ones(len(X["big"]), np.float32)
    budget = fv.SCORE_CACHE_MAX_BYTES
    ref = {}
    for regime, b in (("cached", budget), ("uncached", 0)):
        fv.SCORE_CACHE_MAX_BYTES = b
        ref[regime] = {**single_lo(X["big"], ones, X["g_big"], X["q50"], X["big_path"],
                                   probs["traj50"]),
                       **single_steps(X["big"], ones, X["q50"], X["big_path"], probs["traj50"],
                                      PAR_STEPS)}
    fv.SCORE_CACHE_MAX_BYTES = budget
    ref["m22"] = single_lo(X["p10"], X["v10"], X["g10"], X["q27"], X["path10"], probs["traj27"])
    out["ms"]["single 1m50 cached step"] = ref["cached"]["step_ms"]
    out["ms"]["single 1m50 uncached step"] = ref["uncached"]["step_ms"]

    # ---- D = 1 over nccl, in this process ------------------------------------
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        m1 = make_mesh(1, devices=[dev])
        P, V, G = T(X["big"]), T(ones), T(X["g_big"])
        sel = slice(None, None, probs["traj50"].wps_step)
        _kernels.reset_launches()
        lo, dq, dt, _ = _par_lo_grads(
            lambda qq, tt: (lambda lo: (lo, torch.sum(lo * G)))(sharded_fused_lo_sum(
                m1, P, qq, tt, K, intr.width, intr.height, valid=V)),
            X["q50"][sel], X["big_path"][sel], dev, lambda x: all_reduce(x, m1, "pts"))
        for k, v in (("lo", lo), ("dq", dq), ("dt", dt)):
            equal(f"D=1 nccl 1m50 {k} against fused_lo_sum", v, ref["cached"][k])
        init_fn, step_fn = make_sharded_train_step(m1, probs["traj50"], cfg)
        losses, params, ms, states = _par_train(
            step_fn, init_fn, init_traj_params(X["big_path"], X["q50"], device=dev),
            (P, V, K, T(X["big_path"]), T(X["q50"])), PAR_STEPS)
        d1_rec = {**{f"d1/state/{k}": v.cpu().numpy() for k, v in states.items()},
                  "d1/losses": losses.cpu().numpy(),
                  **{f"d1/{k}": v.cpu().numpy() for k, v in params.items()}}
        equal("D=1 nccl 1m50 20-step losses", losses, ref["cached"]["losses"])
        equal("D=1 nccl 1m50 20-step poses", params["poses"], ref["cached"]["poses"])
        equal("D=1 nccl 1m50 20-step quats", params["quats"], ref["cached"]["quats"])
        out["launches"]["D=1 nccl 1m50"] = dict(_kernels.LAUNCHES)
        out["ms"]["D=1 nccl 1m50 cached step"] = ms
    finally:
        dist.destroy_process_group()
    for k in ("pass_a", "pass_b", "bwd_stats", "bwd_apply"):
        if not out["launches"]["D=1 nccl 1m50"][k]:
            fail(f"[parallel] D=1: {k} did not launch on the sharded path")
    print(f"[parallel] D=1 nccl cuda:0 1m50: sharded_fused_lo_sum's lo and gradients and "
          f"{PAR_STEPS} make_sharded_train_step steps torch.equal to fused_lo_sum and the "
          f"single-card step; launches {out['launches']['D=1 nccl 1m50']}", flush=True)

    # ---- the spawned ranks ---------------------------------------------------
    soft = {}
    P10, V10, W10 = T(X["p10"]), T(X["v10"]), T(X["w10"])
    cam = (P10 - T(X["path10"][9])).requires_grad_(True)

    def mask_and_grad():
        vis = hpr_mask_soft_binned(cam, valid=V10)
        return vis.detach(), torch.autograd.grad(torch.sum(vis * W10), [cam])[0]

    (vis, d_cam), out["ms"]["single soft hpr mask + grad"] = _warm_ms(mask_and_grad, 1)
    soft["hpr"] = dict(vis=vis, dcam=d_cam)
    q0 = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    wparams, wfrozen = init_wps_params(X["path10"][:PAR_WPS], np.tile(q0, (PAR_WPS, 1)), device=dev)
    for name, fn, params in (
            ("pose", lambda p: pose_forward(p, P10, K, probs["pose"], valid=V10),
             init_pose_params(X["path10"][0], q0, device=dev)),
            ("wps", lambda p: wps_forward(p, wfrozen, P10, K, probs["wps"], valid=V10), wparams),
            ("traj", lambda p: traj_forward(p, P10, K, T(X["path10"]), T(X["q27"]),
                                            probs["soft"], valid=V10),
             init_traj_params(X["path10"], X["q27"], device=dev))):
        (loss, aux, grads), out["ms"][f"single soft {name} loss + grad"] = _warm_ms(
            lambda: value_and_grad(fn, params), 1)
        soft[name] = dict(loss=loss, **{f"d{k}": v for k, v in grads.items()})
        if name == "traj":
            soft[name]["rewards"] = aux["rewards"]
    n, every = PAR_FROZEN
    fopt = FrozenTrajOptimizer(X["p10"], K, X["path10"], X["q27"], probs["soft"], cfg,
                               FrozenPlanConfig(refresh_every=every, async_refresh=False),
                               valid=X["v10"], device=dev)
    try:
        t0 = time.perf_counter()
        p_end, f_losses = fopt.run(init_traj_params(X["path10"], X["q27"], device=dev), n)
        sync()
        out["ms"]["single frozen step"] = 1e3 * (time.perf_counter() - t0) / n
    finally:
        fopt.close()
    soft["frozen"] = dict(losses=np.asarray(f_losses), poses=p_end["poses"])

    out_dir = ROOT / "build" / "parallel_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.glob("rank*.npz"):
        f.unlink()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.start_processes(parallel_rank, args=(PAR_WORLD, _free_port(), str(out_dir)),
                       nprocs=PAR_WORLD, join=True, start_method="spawn")
    out["ms"]["spawned ranks, wall"] = 1e3 * (time.perf_counter() - t0)
    rk = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(PAR_WORLD)]

    def cat(key, ranks, axis=0):
        return np.concatenate([rk[r][key] for r in ranks], axis=axis)

    def single_step_parity(tag, rec=None):
        """Each of the sharded steps (rank 0's record, or ``rec``: the same
        keys from this process) against the single-card step taken from the
        same parameters and Adam state, traj_forward's kernel backend
        (ops.fused_traj): new parameters within PAR_PINS["params"], the loss
        within PAR_PINS["loss"]. Returns the largest |difference| of a
        parameter."""
        from trajectory_optimization_tpu_torch.opt.engine import apply_updates

        rec = rk[0] if rec is None else rec
        P, V = T(X["big"]), T(ones)
        Pt, p0, q0 = P.t().contiguous(), T(X["big_path"]), T(X["q50"])
        tx = make_optimizer(cfg)
        worst = -np.inf
        for i in range(PAR_STEPS):
            st = {k[len(f"{tag}/state/"):]: T(v[i]) for k, v in rec.items()
                  if k.startswith(f"{tag}/state/")}
            params = {k: st[f"p/{k}"] for k in ("poses", "quats")}
            opt = {"mu": {k: st[f"mu/{k}"] for k in params},
                   "nu": {k: st[f"nu/{k}"] for k in params}, "count": st["count"]}
            loss, _, grads = value_and_grad(
                lambda p: traj_forward(p, P, K, p0, q0, probs["traj50"], valid=V, points_t=Pt),
                params)
            upd, _ = tx.update(grads, opt, params)
            new_p = apply_updates(params, upd)
            nxt = ({k: rec[f"{tag}/state/p/{k}"][i + 1] for k in params} if i + 1 < PAR_STEPS
                   else {k: rec[f"{tag}/{k}"] for k in params})
            close(f"{tag} step {i} loss", rec[f"{tag}/losses"][i], loss.cpu(),
                  PAR_PINS["loss"], 0.0)
            for k in params:
                close(f"{tag} step {i} {k}", nxt[k], new_p[k].cpu(), *PAR_PINS["params"])
                worst = max(worst, float(np.abs(np.asarray(nxt[k], np.float64)
                                                - new_p[k].cpu().numpy()).max()))
        return worst

    # D = 1 at 1m50 against traj_forward's kernel backend, step by step
    d1_err = single_step_parity("d1", d1_rec)
    print(f"[parallel] D=1 nccl cuda:0 1m50: {PAR_STEPS} steps, each within "
          f"{PAR_PINS['params']} (params) and {PAR_PINS['loss']} (loss) of traj_forward's kernel "
          f"backend's step from the same state (largest |diff| {d1_err:.3e})", flush=True)

    # D = 2 at 1m50, both regimes
    for regime in ("cached", "uncached"):
        tag, want = f"d2/{regime}", ref[regime]
        lo = cat(f"{tag}/lo", [0, 1])
        equal(f"D=2 gloo 1m50 {regime} lo against fused_lo_sum", torch.as_tensor(lo),
              want["lo"].cpu())
        fv.SCORE_CACHE_MAX_BYTES = budget if regime == "cached" else 0
        step_err = single_step_parity(tag)
        fv.SCORE_CACHE_MAX_BYTES = budget
        for r in (0, 1):
            for k in ("dq", "dt"):
                close(f"D=2 {regime} {k} (rank {r})", rk[r][f"{tag}/{k}"], want[k].cpu(),
                      *PAR_PINS["grad"])
            close(f"D=2 {regime} 20-step losses (rank {r})", rk[r][f"{tag}/losses"],
                  want["losses"].cpu(), PAR_PINS["loss"], 0.0)
        drift = max(float(np.abs(rk[0][f"{tag}/{k}"] - want[k].cpu().numpy()).max())
                    for k in ("poses", "quats"))
        out["drift"] = {**out.get("drift", {}), regime: drift}
        launched = {k: int(rk[0][f"{tag}/launches/{k}"]) for k in VIS}
        need = CACHED if regime == "cached" else UNCACHED
        for k in need:
            if not launched[k]:
                fail(f"[parallel] D=2 {regime}: {k} did not launch on the sharded path")
        if any(launched[k] for k in VIS if k not in need):
            fail(f"[parallel] D=2 {regime}: launched {launched}, only {need} may")
        out["launches"][f"D=2 gloo 1m50 {regime}"] = launched
        out["ms"][f"D=2 gloo 1m50 {regime} step"] = float(rk[0][f"{tag}/step_ms"])
        out["ms"][f"D=2 gloo 1m50 {regime} lo + grad"] = float(rk[0][f"{tag}/lo_ms"])
        print(f"[parallel] D=2 gloo (2 ranks on cuda:0) 1m50 {regime}: lo torch.equal to "
              f"fused_lo_sum; gradients within {PAR_PINS['grad']}; {PAR_STEPS} steps, each "
              f"within {PAR_PINS['params']} (params) and {PAR_PINS['loss']} (loss) of "
              f"traj_forward's kernel backend's step from the same state (largest |diff| "
              f"{step_err:.3e}), losses "
              f"within {PAR_PINS['loss']} of the single-card run's; after {PAR_STEPS} steps the "
              f"params {drift:.3e} from the single-card run's (not held: a discontinuous "
              f"gradient under Adam); launches {launched}", flush=True)

    # the 2x2 mesh at cloud 10 x 27
    want = ref["m22"]
    for row in ([0, 1], [2, 3]):
        close("2x2 cloud 10 lo", cat("m22/lo", row), want["lo"].cpu(), *PAR_PINS["lo"])
    for r in range(PAR_WORLD):
        for k in ("dq", "dt"):
            close(f"2x2 cloud 10 {k} (rank {r})", rk[r][f"m22/{k}"], want[k].cpu(),
                  *PAR_PINS["grad"])
        launched = {k: int(rk[r][f"m22/launches/{k}"]) for k in CACHED}
        if not all(launched.values()):
            fail(f"[parallel] 2x2: rank {r} launched {launched}; K1-K4 must launch")
    out["launches"]["2x2 gloo cloud10x27 (rank 0)"] = {
        k: int(rk[0][f"m22/launches/{k}"]) for k in VIS}
    out["ms"]["2x2 gloo cloud10x27 lo + grad"] = float(rk[0]["m22/lo_ms"])
    print(f"[parallel] 2x2 gloo (4 ranks on cuda:0) cloud 10 x 27: lo and gradients within "
          f"{PAR_PINS['lo']} / {PAR_PINS['grad']} of fused_lo_sum; K1-K4 launched on every rank",
          flush=True)

    # the soft-HPR modules at D = 2 on cloud 10
    d = np.abs(cat("soft/hpr/vis", [0, 1]) - soft["hpr"]["vis"].cpu().numpy())
    far_t, far_share = SOFT_PINS["far"]
    if d.mean() >= SOFT_PINS["mean"] or (d > far_t).mean() >= far_share:
        fail(f"[parallel] hpr_mask_soft_binned_sharded: mean |diff| {d.mean():.3e}, "
             f"{(d > far_t).mean():.2e} of points off by > {far_t}")
    g_rel = rel(cat("soft/hpr/dcam", [0, 1]), soft["hpr"]["dcam"].cpu())
    if g_rel >= SOFT_PINS["grad"]:
        fail(f"[parallel] hpr_mask_soft_binned_sharded gradient {g_rel:.3e} off")
    soft_errs = {"hpr": (float(d.mean()), g_rel)}
    for name in ("pose", "wps", "traj"):
        want = {k: v.cpu().numpy() for k, v in soft[name].items()}
        for r in (0, 1):
            close(f"{name} sharded loss (rank {r})", rk[r][f"soft/{name}/loss"], want["loss"],
                  SOFT_PINS["loss"], 0.0)
            errs = [rel(rk[r][f"soft/{name}/{k}"], v) for k, v in want.items()
                    if k.startswith("d")]
            if max(errs) >= SOFT_PINS["grad"]:
                fail(f"[parallel] {name} sharded gradients off by {max(errs):.3e} (relative)")
        soft_errs[name] = (abs(float(rk[0][f"soft/{name}/loss"]) / float(want["loss"]) - 1),
                           max(errs))
        out["ms"][f"D=2 soft {name} loss + grad"] = float(rk[0][f"soft/{name}_ms"])
    rew = np.abs(cat("soft/traj/rewards", [0, 1]) - soft["traj"]["rewards"].cpu().numpy()).max()
    if rew >= SOFT_PINS["rewards"]:
        fail(f"[parallel] traj_soft_hpr_loss_sharded rewards off by {rew:.3e}")
    out["ms"]["D=2 soft hpr mask + grad"] = float(rk[0]["soft/hpr_ms"])
    for r in (0, 1):
        a, b = rk[r]["soft/frozen/losses"], soft["frozen"]["losses"]
        dev_l = float(np.max(np.abs(a - b) / np.abs(b)))
        pd = float(np.linalg.norm(rk[r]["soft/frozen/poses"] - soft["frozen"]["poses"].cpu().numpy()))
        if dev_l >= SOFT_PINS["runner"] or pd >= SOFT_PINS["runner_poses"]:
            fail(f"[parallel] FrozenShardedTrajOptimizer against FrozenTrajOptimizer: losses "
                 f"{dev_l:.3e}, poses {pd:.3e}")
        if int(rk[r]["soft/frozen/refreshes"]) != n // every:
            fail(f"[parallel] FrozenShardedTrajOptimizer refreshed {rk[r]['soft/frozen/refreshes']} times")
    soft_errs["frozen"] = (dev_l, pd)
    out["ms"]["D=2 frozen step"] = float(rk[0]["soft/frozen_ms"])
    out["soft_errs"] = soft_errs
    print(f"[parallel] soft-HPR modules at D=2 gloo on cloud 10 against their single-card "
          f"twins (mean |diff| or loss rel, gradient rel): {soft_errs}; FrozenSharded"
          f"TrajOptimizer {n} steps, refresh every {every}", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def print_parallel_times(card: str, pr) -> None:
    print(f"[times] parallel layer ({card}; ranks sharing one card: not a scaling figure): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in pr["ms"].items())
          + f"; phase {pr['phase_s']:.1f} s", flush=True)


def differ(a, b):
    """Where two (nested) dicts, tuples or lists of tensors differ, as text;
    empty where every leaf is ``torch.equal``."""
    import torch

    if isinstance(a, dict):
        return [f"{k}.{d}" for k in a for d in differ(a[k], b[k])]
    if isinstance(a, (tuple, list)):
        return [f"[{i}].{d}" for i, (x, y) in enumerate(zip(a, b)) for d in differ(x, y)]
    return [] if torch.equal(a, b) else [
        f"{int((a != b).sum())} of {a.numel()} (max |diff| "
        f"{float((a.double() - b.double()).abs().max()):.3e})"]


def trace_steps(fn, n, sync):
    """(device-busy ms per step, host kernel launches per step, graph
    launches per step, device operations per step) of one traced call of
    ``fn`` that takes ``n`` steps; the device numbers None without device
    activity in the trace."""
    import torch

    prof, _, n_spans, busy_us = traced(fn, sync)
    host = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    kernel = sum("LaunchKernel" in h for h in host) / n
    graph = sum("GraphLaunch" in h for h in host) / n
    if not n_spans:
        return None, kernel, graph, None
    return busy_us / 1e3 / n, kernel, graph, n_spans / n


def trace_window(fn, n, sync, range_name=None):
    """One traced call of ``fn`` that takes ``n`` steps, per step: wall ms,
    device-busy ms, device operations, host kernel launches, graph launches
    and copy calls (cudaMemcpy*), and the device ms of the kernels inside the profiler ranges
    named ``range_name`` (counted on their host side); the device numbers
    None without device activity in the trace."""
    import torch

    prof, wall_ms, n_spans, busy_us = traced(fn, sync)
    host = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    out = {"wall_ms": wall_ms / n, "kernels": sum("LaunchKernel" in e.name for e in host) / n,
           "graphs": sum("GraphLaunch" in e.name for e in host) / n,
           "copies": sum("Memcpy" in e.name for e in host) / n,
           "busy_ms": None, "ops": None, "tiles_ms": None}
    if n_spans:
        out.update(busy_ms=busy_us / 1e3 / n, ops=n_spans / n,
                   tiles_ms=sum(e.device_time_total for e in host if e.name == range_name)
                   / 1e3 / n)
    return out


GRAPH_STEPS = {"ref": 400, "1m50": 20, "8m50": 20}  # the held runs: captured == eager
GRAPH_WINDOW = {"ref": 100, "1m50": 20, "8m50": 10}  # steps per timed window
GRAPH_POSE = (("cloud10", 100), ("1m", 100))  # PoseOptimizer runs held and timed
GRAPH_TRACE = 20  # steps per traced run


def graph_checks(dev, intr, clouds, paths, sync):
    """Phase 12: the captured optimization loop (``opt/graphs.py``). The
    runners' captured loop against the plain loop of tests/torch_loop_ref.py
    ("eager" below) on the card, bit for bit, at ref, 1m50 and 8m50
    (``clouds``/``paths`` by name; the pose runs also take
    ``clouds["1m"]``); ``optimize_with_history`` and
    ``OptimizerLoop`` at ref; ``PoseOptimizer``'s runner at cloud 10 and 1M;
    ``optimize_waypoints`` at the demo's defaults; the K3/K4 scratch round
    trip; then times: ms/step of both loops (median of 3 windows after a
    warm-up, taken in turns) and of the replays alone, device-busy ms and
    host launch calls per step from a traced run, capture seconds, peak MiB
    allocated and reserved. Returns the numbers for [times] and the record."""
    import numpy as np
    import torch

    from trajectory_optimization_tpu_torch.api import TrajectoryOptimizer
    from trajectory_optimization_tpu_torch.models import wps_opt
    from trajectory_optimization_tpu_torch.models.pose import PoseProblem, init_pose_params
    from trajectory_optimization_tpu_torch.models.traj import init_traj_params, traj_forward
    from trajectory_optimization_tpu_torch.ops import _kernels
    from trajectory_optimization_tpu_torch.opt import engine as te
    from trajectory_optimization_tpu_torch.opt import runners
    from trajectory_optimization_tpu_torch.opt.graphs import capture_stream
    from trajectory_optimization_tpu_torch.utils.data import identity_quaternions, pad_points

    cfg = te.OptimizerConfig(lr_pose=0.1, lr_quat=0.02)
    facade = TrajectoryOptimizer(lr_pose=0.1, lr_quat=0.02, device=dev)
    K = intr.matrix(device=dev)
    res = {"traj": {}, "pose": {}}

    def same(what, a, b):
        bad = differ(a, b)
        if bad:
            fail(f"[graphs] {what}: captured != eager: {'; '.join(bad)}")

    def counted(fn):
        sync()
        _kernels.reset_launches()
        out = fn()
        sync()
        return out, {k: v for k, v in _kernels.LAUNCHES.items() if v}

    def peaks(fn):
        sync()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        sync()
        return out, (torch.cuda.max_memory_allocated() / 2**20,
                     torch.cuda.max_memory_reserved() / 2**20)

    def ms_per_step(fns, n):
        """{route: median ms/step of 3 windows} after one warm-up call each,
        the windows taken in turns (route order, then reversed)."""
        for fn in fns.values():
            fn()
        sync()
        times = {r: [] for r in fns}
        order = list(fns)
        for w in range(3):
            for r in (order if w % 2 == 0 else order[::-1]):
                t0 = time.perf_counter()
                fns[r]()
                sync()
                times[r].append((time.perf_counter() - t0) * 1e3 / n)
        return {r: statistics.median(v) for r, v in times.items()}

    def last_bucket(runner):
        # the bucket of the runner's latest call (runs of 1m50 and 8m50 share
        # a runner: one problem, two buckets)
        return list(runner.buckets._items.values())[-1]

    def traj_data(name):
        pts, path = clouds[name], paths[name]
        padded, valid = pad_points(pts)
        q = identity_quaternions(len(path))
        if name == "8m50":
            q[::3] = [0.9, 0.1, -0.3, 0.2]  # [slice]'s 8m50 quaternions
        data = (torch.as_tensor(padded, device=dev), torch.as_tensor(valid, device=dev), K,
                torch.as_tensor(path, device=dev), torch.as_tensor(q, device=dev))
        return facade._traj_problem(path), path, q, data

    # ---- the trajectory runner at the three shapes ------------------------
    for name, n in GRAPH_STEPS.items():
        problem, path, q, data = traj_data(name)
        run = runners.traj_runner(problem, cfg, te.NEVER, n)  # the facade's runner
        out, mem = {}, {}
        for route in ("graph", "eager"):
            (out[route], launches), mem[route] = peaks(lambda route=route: counted(
                lambda: traj_run_on(route, run, init_traj_params(path, q, dev), *data)))
            out[route] = (out[route], launches)
        (pg, ig, lg, ag), lau_g = out["graph"]
        (pe, ie, le, ae), lau_e = out["eager"]
        if int(ig) != int(ie) or int(ig) != n:
            fail(f"[graphs] {name}: n_iters captured {int(ig)}, eager {int(ie)}, expected {n}")
        same(f"{name} parameters", pg, pe)
        same(f"{name} final loss", lg, le)
        same(f"{name} final aux", ag, ae)
        if lau_g != lau_e or not lau_g:
            fail(f"[graphs] {name}: launches captured {lau_g} != eager {lau_e}")
        vis = float(ag["mean_reward"]) / float(ag["reward0"])
        smooth = float(ag["smooth0"]) / float(ag["loss_smooth"])
        if name == "ref" and not (vis >= 1.1 and smooth >= 0.9):
            fail(f"[graphs] ref 400 captured steps: visibility gain {vis:.4f} (need >= 1.1), "
                 f"smoothness gain {smooth:.4f} (need >= 0.9)")
        bucket = last_bucket(run)
        per_step = {k: v / n for k, v in lau_g.items()}
        # timed: a runner of the window's length, its own bucket (capture in the warm-up)
        nw = GRAPH_WINDOW[name]
        wrun = runners.traj_runner(problem, cfg, te.NEVER, nw)
        ms = ms_per_step({r: (lambda r=r: traj_run_on(r, wrun, init_traj_params(path, q, dev),
                                                      *data)) for r in ("graph", "eager")}, nw)
        wb = last_bucket(wrun)
        with torch.cuda.stream(capture_stream(dev)):
            wb.graph.replay()  # warm-up
            sync()
            t0 = time.perf_counter()
            for _ in range(nw):
                wb.graph.replay()
            sync()
        replay_ms = (time.perf_counter() - t0) * 1e3 / nw
        # what a cached bucket holds: a fresh one (2 steps), measured after
        # the cache is emptied: allocated = its static buffers, reserved =
        # those and its graph's private pool
        sync()
        torch.cuda.empty_cache()
        a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        runners.traj_runner(problem, cfg, te.NEVER, 2)(init_traj_params(path, q, dev), *data)
        sync()
        torch.cuda.empty_cache()
        held = ((torch.cuda.memory_allocated() - a0) / 2**20,
                (torch.cuda.memory_reserved() - r0) / 2**20)
        trun = runners.traj_runner(problem, cfg, te.NEVER, GRAPH_TRACE)
        trun(init_traj_params(path, q, dev), *data)  # capture before the trace
        tr = {r: trace_steps(lambda r=r: traj_run_on(r, trun, init_traj_params(path, q, dev),
                                                     *data), GRAPH_TRACE, sync)
              for r in ("graph", "eager")}
        res["traj"][name] = {
            "steps": n, "launches": lau_g, "launches_per_step": per_step,
            "ms_per_step": ms, "replay_ms_per_step": replay_ms,
            "busy_ms_per_step": {r: v[0] for r, v in tr.items()},
            "host_kernel_launches_per_step": {r: v[1] for r, v in tr.items()},
            "graph_launches_per_step": {r: v[2] for r, v in tr.items()},
            "device_ops_per_step": {r: v[3] for r, v in tr.items()},
            "capture_s": {"held run": bucket.graph.capture_s, "window": wb.graph.capture_s,
                          "trace": last_bucket(trun).graph.capture_s},
            "peak_mib": {r: {"allocated": a, "reserved": b} for r, (a, b) in mem.items()},
            "bucket_mib": {"allocated": held[0], "reserved": held[1]},
            "gains": (vis, smooth)}
        print(f"[graphs] {name} {n} steps through traj_runner: captured == eager (torch.equal "
              f"n_iters {int(ig)}, parameters, final loss and aux); launches per step "
              f"{per_step} in both; visibility gain {vis:.4f}, smoothness gain {smooth:.4f}; "
              f"ms/step captured {ms['graph']:.4f}, eager {ms['eager']:.4f}", flush=True)
        del out, pg, pe, ag, ae, data

    # ---- optimize_with_history and OptimizerLoop at ref ----------------------
    problem, path, q, data = traj_data("ref")
    P, V, _, p0, q0 = data
    Pt = P.t().contiguous()

    def loss_ref(p):
        return traj_forward(p, P, K, p0, q0, problem, valid=V, points_t=Pt)

    plain = plain_loops()
    hist = {"graph": te.optimize_with_history(loss_ref, init_traj_params(path, q, dev), cfg, 50),
            "eager": plain.with_history(loss_ref, init_traj_params(path, q, dev), cfg, 50)}
    same("optimize_with_history parameters", hist["graph"][0], hist["eager"][0])
    hg, he = hist["graph"][1], hist["eager"][1]
    if hg.keys() != he.keys() or not all(np.array_equal(hg[k], he[k]) for k in he):
        fail("[graphs] optimize_with_history: the captured history differs from the eager one")
    # a second call of the public entry point, on its own captured step
    pub = te.optimize_with_history(loss_ref, init_traj_params(path, q, dev), cfg, 50)
    same("optimize_with_history (public) parameters", pub[0], hist["eager"][0])
    if not all(np.array_equal(pub[1][k], he[k]) for k in he):
        fail("[graphs] optimize_with_history (public): the history differs from the eager one")
    got = te.optimize(loss_ref, init_traj_params(path, q, dev), cfg, 50)
    want = plain.optimize(loss_ref, init_traj_params(path, q, dev), cfg, 50)
    same("optimize (public) parameters", got[0], want[0])
    if got[1:] != want[1:]:
        fail(f"[graphs] optimize (public): n_iters, loss {got[1:]} != eager {want[1:]}")
    loop = te.OptimizerLoop(loss_ref, init_traj_params(path, q, dev), cfg)
    lp = init_traj_params(path, q, dev)
    ls = plain.adam_state(lp)
    for m in (0, 1, 7, 20):
        got = loop.run(m)
        lp, ls, *want = plain.steps(loss_ref, lp, ls, cfg, m)
        same(f"OptimizerLoop.run({m}) loss", got[0], want[0])
        same(f"OptimizerLoop.run({m}) aux", got[1], want[1])
        same(f"OptimizerLoop.run({m}) parameters", loop.params, lp)
    if not loop._graph.captures or loop._graph.graph is None:
        fail("[graphs] OptimizerLoop on the card did not capture its step")
    print(f"[graphs] ref: optimize_with_history 50 steps (history of {sorted(hg)}; two calls "
          f"of the public entry point), optimize 50 steps (public) and "
          f"OptimizerLoop.run(0, 1, 7, 20): captured == the plain loop (torch.equal); the loop "
          f"replayed {loop._graph.replays} steps", flush=True)

    # ---- the pose runner (PoseOptimizer's) at cloud 10 and 1M ---------------
    pose_problem = PoseProblem(img_width=intr.width, img_height=intr.height)
    for name, n in GRAPH_POSE:
        padded, valid = pad_points(clouds[name])
        Pp, Vp = torch.as_tensor(padded, device=dev), torch.as_tensor(valid, device=dev)
        init, adv = runners.pose_runner(pose_problem, te.OptimizerConfig(lr_pose=0.1,
                                                                         lr_quat=0.0), n)

        def pose_segment(route, adv=adv, init=init, Pp=Pp, Vp=Vp):
            p = init_pose_params(np.array([[6.0, 2.0, 0.0]], np.float32),
                                 np.array([[1.0, 0.0, 0.0, 0.0]], np.float32), dev)
            return pose_advance_on(route, adv, p, init(p), Pp, Vp, K)

        got, want = pose_segment("graph"), pose_segment("eager")
        for what, a, b in zip(("parameters", "Adam state", "loss", "aux"), got, want):
            same(f"pose {name} {what}", a, b)
        ms = ms_per_step({r: (lambda r=r: pose_segment(r)) for r in ("graph", "eager")}, n)
        b = last_bucket(adv)
        res["pose"][name] = {"steps": n, "ms_per_step": ms, "capture_s": b.graph.capture_s}
        print(f"[graphs] PoseOptimizer's runner {name} {n} steps: captured == eager (torch.equal "
              f"parameters, Adam state, loss, observations); ms/step captured {ms['graph']:.4f}, "
              f"eager {ms['eager']:.4f}", flush=True)

    # ---- optimize_waypoints at the demo's defaults ---------------------------
    q_id = identity_quaternions(len(paths["ref"]))
    wprob = wps_opt.WpsOptProblem(img_width=intr.width, img_height=intr.height)
    wps = {}
    optimize = wps_opt.optimize
    for route in ("graph", "eager"):
        # the reference: the module's optimize on the plain loop
        wps_opt.optimize = optimize if route == "graph" else plain.optimize
        try:
            sync()
            t0 = time.perf_counter()
            wps[route] = wps_opt.optimize_waypoints(
                clouds["ref"], paths["ref"], q_id, intr.matrix_np(), wprob, n_steps=WPS_STEPS,
                lr_xy=0.02, lr_yaw=0.02, device=dev)
            sync()
            wps[route + "_s"] = time.perf_counter() - t0
        finally:
            wps_opt.optimize = optimize
    for i, what in enumerate(("positions", "quaternions", "aux")):
        same(f"optimize_waypoints {what}", wps["graph"][i], wps["eager"][i])
    res["wps"] = {"steps": WPS_STEPS, "s": {r: wps[r + "_s"] for r in ("graph", "eager")}}
    print(f"[graphs] optimize_waypoints at the demo's defaults ({WPS_STEPS} steps, cloud 10, "
          f"path 10): captured == eager (torch.equal positions, quaternions, aux); "
          f"{wps['graph_s']:.3f} s captured, {wps['eager_s']:.3f} s eager", flush=True)

    # ---- the K3/K4 scratch: capture at W = 14, grow it at W = 50, replay ----
    side = capture_stream(dev)
    _kernels._reduction_scratch.pop((dev, side.cuda_stream), None)  # a fresh, small scratch
    problem, path, q, data = traj_data("ref")
    small = runners.traj_runner(problem, cfg, te.NEVER, 10)
    first = small(init_traj_params(path, q, dev), *data)
    held = last_bucket(small).graph.scratch
    bproblem, bpath, bq, bdata = traj_data("1m50")
    runners.traj_runner(bproblem, cfg, te.NEVER, 5)(init_traj_params(bpath, bq, dev), *bdata)
    grown = _kernels._reduction_scratch[(dev, side.cuda_stream)]
    if held is None or grown[1] is held[1] or grown[1].numel() <= held[1].numel():
        fail("[graphs] the 1m50 run did not replace the scratch the W = 14 graph holds: the "
             "round trip shows nothing")
    again = small(init_traj_params(path, q, dev), *data)
    eager = traj_run_on("eager", small, init_traj_params(path, q, dev), *data)
    for what, a in (("first run", first), ("replay after the scratch grew", again)):
        same(f"scratch round trip, {what}, parameters", a[0], eager[0])
        same(f"scratch round trip, {what}, final loss", a[2], eager[2])
    res["scratch_doubles"] = (held[1].numel(), grown[1].numel())
    print(f"[graphs] K3/K4 scratch round trip: captured at W = 14 with {held[1].numel()} "
          f"partial doubles, the 1m50 run grew the stream's scratch to {grown[1].numel()}, the "
          f"W = 14 graph replayed on the scratch it holds: equal to the eager run", flush=True)
    res["soft"] = soft_graph_checks(dev, intr, clouds["cloud10"], paths["ref"], sync)
    return res


GRAPH_SOFT = {"traj": 3, "wps": 2}  # steps per held call
GRAPH_SOFT_POSE = ((262_144, 3), (1_048_576, 2))  # (points, steps per held call)
GRAPH_SOFT_REPLAYS = 2  # timed replays of each soft configuration's graph


def soft_graph_checks(dev, intr, cloud10, path10, sync):
    """[graphs], soft HPR above ``soft_hpr_dense_max`` (the binned tier on
    its static tile slots): ``TrajectoryOptimizer(soft_hpr=True)``'s runner
    on cloud 10 and path 10 (cap 512), ``PoseOptimizer(soft_hpr=True)``'s on
    bench.py's cloud at 262,144 and 1,048,576 points (cap 1024) and
    ``optimize_waypoints(soft_hpr=True)`` on cloud 10 (27 waypoints, cap
    1024), each called captured and eager (the plain loop of
    tests/torch_loop_ref.py) in turns (captured, eager, eager, captured; the
    waypoints once captured, since each of its calls captures anew). The
    two eager calls must agree bit for bit (the binned backward adds its
    rows in a fixed order, ``csrc/binned_layout.cu``), and the captured
    calls are held ``torch.equal`` to them. At 1,048,576 points the f32
    step, eager and captured, bit-equal to each other and
    within ``HPR_TOL`` of the largest entry of the card's float64 step (as
    ``[hpr]`` holds a pose step). Then, per configuration: ms/step of
    the whole calls and of the graph's replays alone, device-busy ms, device
    operations and host launch calls of one traced step by each route
    (a replay; an eager step), capture seconds, the memory the cached graph
    holds (allocated and reserved, measured by dropping it), peak MiB, and
    the real tiles against the static slots per grid, counted outside the
    timed calls. Every cached graph is dropped before the next configuration."""
    import gc

    import numpy as np
    import torch

    from trajectory_optimization_tpu_torch.api import TrajectoryOptimizer
    from trajectory_optimization_tpu_torch.models import wps_opt
    from trajectory_optimization_tpu_torch.models.pose import (
        PoseProblem, init_pose_params, pose_forward,
    )
    from trajectory_optimization_tpu_torch.models.traj import init_traj_params, traj_forward
    from trajectory_optimization_tpu_torch.opt import engine as te
    from trajectory_optimization_tpu_torch.opt import graphs, runners
    from trajectory_optimization_tpu_torch.utils.data import identity_quaternions, pad_points

    K = intr.matrix(device=dev)
    res = {}

    def rel_errs(got, want):
        return [float((g.double() - w.double()).abs().max()) / float(w.double().abs().max())
                for g, w in zip(got, want)]

    def finite(tree):
        if isinstance(tree, dict):
            return all(finite(v) for v in tree.values())
        if isinstance(tree, (tuple, list)):
            return all(finite(v) for v in tree)
        return not tree.is_floating_point() or bool(torch.isfinite(tree).all())

    def step(loss_fn, params):
        loss, _, grads = te.value_and_grad(loss_fn, params)
        return [loss] + [grads[k] for k in params]

    def captured_step(loss_fn, params):
        """The loss and gradient of ``loss_fn`` at ``params`` from a CUDA
        graph of the step's forward and backward, replayed once after an
        eager run (the engine's order)."""
        box = []

        def fn():
            out = step(loss_fn, params)
            if not box:
                box.extend(x.clone() for x in out)
            else:
                for dst, src in zip(box, out):
                    dst.copy_(src)

        with graphs.on_capture_stream(dev):
            fn()
            graphs.StepGraph(fn, dev, "soft loss and gradient")()
        sync()
        return box

    def held(name, cfg_steps, call, graph_of, loss_of, params_of, keys, cams, cap, drop,
             f64_tol=None, trace_eager=True, order=("graph", "eager", "eager", "graph")):
        """Run the configuration's checks and measurements (docstring)."""
        t_config = time.perf_counter()
        outs, ms, peak = {"graph": [], "eager": []}, {"graph": [], "eager": []}, {}
        for route in order:
            sync()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = call(route)
            sync()
            ms[route].append((time.perf_counter() - t0) * 1e3 / cfg_steps)
            peak[route] = max(peak.get(route, (0.0, 0.0)), (
                torch.cuda.max_memory_allocated() / 2**20,
                torch.cuda.max_memory_reserved() / 2**20))
            outs[route].append(out)
        for route, runs in outs.items():
            if not all(finite(o) for o in runs):
                fail(f"[graphs] soft {name}: a {route} call returned a non-finite value")
        n_graph = len(outs["graph"])
        eager_bits = not differ(outs["eager"][0], outs["eager"][1])
        entry = {"steps": cfg_steps, "eager_runs_bit_equal": eager_bits}
        if not eager_bits:
            fail(f"[graphs] soft {name}: two eager calls differ: "
                 f"{'; '.join(differ(outs['eager'][0], outs['eager'][1]))} (the binned "
                 "backward's rows must add in a fixed order)")
        for i, got in enumerate(outs["graph"]):
            bad = differ(got, outs["eager"][0])
            if bad:
                fail(f"[graphs] soft {name}: captured call {i} != eager: {'; '.join(bad)}")
        entry["held"] = "torch.equal"
        lf32, p32 = loss_of(torch.float32), params_of(torch.float32)
        if f64_tol is not None:
            # the f32 step, eager and captured, against the card's float64 step
            want = step(loss_of(torch.float64), params_of(torch.float64))
            new = step(lf32, p32)
            captured = captured_step(lf32, p32)
            bad = differ(captured, new)
            if bad:
                fail(f"[graphs] soft {name}: the captured step != the eager step: "
                     f"{'; '.join(bad)}")
            entry["vs_f64"] = {"eager": rel_errs(new, want), "captured": rel_errs(captured, want)}
            if not max(entry["vs_f64"]["eager"] + entry["vs_f64"]["captured"]) <= f64_tol:
                fail(f"[graphs] soft {name}: the f32 step against float64, relative max |err| "
                     f"(loss, {', '.join(keys)}) {entry['vs_f64']} over {f64_tol}")
            entry["f64_tol"] = f64_tol
            del want, captured, new
        del lf32, p32
        g = graph_of()
        side = graphs.capture_stream(dev)
        with torch.cuda.stream(side):  # warm: the held calls replayed the graph
            sync()
            t0 = time.perf_counter()
            for _ in range(GRAPH_SOFT_REPLAYS):
                g.replay()
            sync()
        replay_ms = (time.perf_counter() - t0) * 1e3 / GRAPH_SOFT_REPLAYS

        def replay_once():
            with torch.cuda.stream(side):
                g.replay()

        lf, p0 = loss_of(torch.float32), params_of(torch.float32)
        lrs = te.group_lrs(te.OptimizerConfig(), *keys)

        def eager_step():
            # the eager loop's step: forward, backward, Adam
            _, _, grads = te.value_and_grad(lf, p0)
            te.adam_update(grads, te.adam_init(p0), p0, te.OptimizerConfig(), lrs)

        # the eager step is traced where that is cheap: a trace of ~34,000 or
        # ~83,000 operations (trajectory, waypoints) costs tens of seconds
        # ([hpr] traces the eager trajectory step)
        tr = {"graph": trace_steps(replay_once, 1, sync),
              "eager": trace_steps(eager_step, 1, sync) if trace_eager else (None,) * 4}
        capture_s = g.capture_s
        del g, lf, p0
        sync()
        torch.cuda.empty_cache()
        a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        drop()
        gc.collect()
        sync()
        torch.cuda.empty_cache()
        entry.update({
            "ms_per_step": {r: v for r, v in ms.items()}, "replay_ms_per_step": replay_ms,
            "busy_ms_per_step": {r: v[0] for r, v in tr.items()},
            "host_kernel_launches_per_step": {r: v[1] for r, v in tr.items()},
            "graph_launches_per_step": {r: v[2] for r, v in tr.items()},
            "device_ops_per_step": {r: v[3] for r, v in tr.items()},
            "capture_s": capture_s,
            "graph_mib": {"allocated": (a0 - torch.cuda.memory_allocated()) / 2**20,
                          "reserved": (r0 - torch.cuda.memory_reserved()) / 2**20},
            "peak_mib": {r: {"allocated": a, "reserved": b} for r, (a, b) in peak.items()},
            "tiles": binned_tiles(cams, cams_valid.get(name), cap)})
        entry["seconds"] = time.perf_counter() - t_config
        res[name] = entry
        def errs_text(v):
            return "[" + ", ".join(f"{e:.2e}" for e in v) + "]"

        how = (f"{'both captured calls' if n_graph > 1 else 'the captured call'} torch.equal "
               "to them"
               + (f"; the f32 step, eager and captured (torch.equal to each other), against "
                  f"the card's float64 step, relative max |err| (loss, {', '.join(keys)}) eager "
                  f"{errs_text(entry['vs_f64']['eager'])}, captured "
                  f"{errs_text(entry['vs_f64']['captured'])} (pin {f64_tol})" if f64_tol else ""))
        print(f"[graphs] soft {name}, {cfg_steps} steps per call, in turns "
              f"{', '.join(order)}: the two eager calls agree bit for bit; {how}; "
              f"{tiles_text(entry['tiles'])}", flush=True)

    cams_valid = {}

    # ---- the trajectory runner: cloud 10, path 10, cap 512 -----------------
    cfg = te.OptimizerConfig(lr_pose=0.1, lr_quat=0.02)
    problem = TrajectoryOptimizer(lr_pose=0.1, lr_quat=0.02, device=dev,
                                  soft_hpr=True)._traj_problem(path10)
    padded, valid = pad_points(cloud10)
    q = identity_quaternions(len(path10))
    data = {dt: (torch.as_tensor(padded, device=dev, dtype=dt),
                 torch.as_tensor(valid, device=dev, dtype=dt), intr.matrix(device=dev, dtype=dt),
                 torch.as_tensor(path10, device=dev, dtype=dt),
                 torch.as_tensor(q, device=dev, dtype=dt))
            for dt in (torch.float32, torch.float64)}
    n = GRAPH_SOFT["traj"]
    run = runners.traj_runner(problem, cfg, te.NEVER, n)

    def traj_loss(dt):
        P, V, Kd, p0, q0 = data[dt]
        return lambda p: traj_forward(p, P, Kd, p0, q0, problem, valid=V)

    def traj_params(dt):
        return {k: v.to(dt) for k, v in init_traj_params(path10, q, dev).items()}

    wps = path10[::problem.wps_step]
    cams_valid["traj"] = data[torch.float32][1]
    held("traj", n,
         lambda r: traj_run_on(r, run, init_traj_params(path10, q, dev),
                               *data[torch.float32]),
         lambda: list(run.buckets._items.values())[-1].graph, traj_loss, traj_params,
         ("poses", "quats"),
         camera_clouds(data[torch.float32][0], wps, identity_quaternions(len(wps))),
         problem.hpr_cap, run.buckets._items.clear, trace_eager=False)
    del run, data
    runners.traj_runner.cache_clear()

    # ---- the pose runner: bench.py's cloud at 262,144 and 1,048,576 --------
    pose_problem = PoseProblem(intr.width, intr.height, soft_hpr=True)
    pcfg = te.OptimizerConfig(lr_pose=0.02, lr_quat=0.02)
    for npts, n in GRAPH_SOFT_POSE:
        name = f"pose {npts}"
        rng = np.random.default_rng(0)
        pts = (rng.normal(size=(npts, 3)).astype(np.float32) * [6, 6, 2]
               + [5, 0, 1]).astype(np.float32)
        Pp = {dt: torch.as_tensor(pts, device=dev, dtype=dt)
              for dt in (torch.float32, torch.float64)}
        init, adv = runners.pose_runner(pose_problem, pcfg, n)

        def pose_params(dt):
            p = init_pose_params(np.zeros((1, 3), np.float32),
                                 np.array([[1.0, 0.0, 0.0, 0.0]], np.float32), dev)
            return {k: v.to(dt) for k, v in p.items()}

        def pose_loss(dt, Pp=Pp):
            return lambda p: pose_forward(p, Pp[dt], K.to(dt), pose_problem)

        def pose_call(route, adv=adv, init=init, Pp=Pp):
            p = pose_params(torch.float32)
            return pose_advance_on(route, adv, p, init(p), Pp[torch.float32], None, K)

        held(name, n, pose_call, lambda adv=adv: list(adv.buckets._items.values())[-1].graph,
             pose_loss, pose_params, ("trans", "quat"), [Pp[torch.float32]],
             pose_problem.hpr_cap, adv.buckets._items.clear,
             # held at 1,048,576 only: at 262,144 the f32 step's
             # translation gradient is 5.1e-3 from float64 (PERF.md §7)
             f64_tol=HPR_TOL if npts == 1_048_576 else None)
        del adv, init, Pp
        runners.pose_runner.cache_clear()

    # ---- optimize_waypoints at the demo's defaults: cloud 10, path 10 ------
    wprob = wps_opt.WpsOptProblem(img_width=intr.width, img_height=intr.height, soft_hpr=True)
    q_id = identity_quaternions(len(path10))
    made = []

    class Recording(graphs.StepGraph):
        """The engine's StepGraph, kept: optimize_waypoints drops its own."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    optimize, step_graph = wps_opt.optimize, te.StepGraph
    n = GRAPH_SOFT["wps"]

    def wps_call(route):
        # the reference: the module's optimize on the plain loop
        wps_opt.optimize = optimize if route == "graph" else plain_loops().optimize
        te.StepGraph = Recording
        try:
            return wps_opt.optimize_waypoints(cloud10, path10, q_id, intr.matrix_np(), wprob,
                                              n_steps=n, device=dev)
        finally:
            wps_opt.optimize, te.StepGraph = optimize, step_graph

    Pw = {dt: torch.as_tensor(cloud10, device=dev, dtype=dt)
          for dt in (torch.float32, torch.float64)}

    def wps_params(dt):
        params, _ = wps_opt.init_wps_params(path10, q_id, dev)
        return {k: v.to(dt) for k, v in params.items()}

    def wps_loss(dt):
        _, frozen = wps_opt.init_wps_params(path10, q_id, dev)
        frozen = {k: v.to(dt) for k, v in frozen.items()}
        return lambda p: wps_opt.wps_forward(p, frozen, Pw[dt], K.to(dt), wprob)

    # one captured call: each call of optimize_waypoints captures its own graph
    held("wps", n, wps_call, lambda: made[-1], wps_loss, wps_params, ("xy", "yaw"),
         camera_clouds(Pw[torch.float32], path10, q_id), wprob.hpr_cap, made.clear,
         trace_eager=False, order=("graph", "eager", "eager"))
    return res


def print_graph_times(card: str, gr) -> None:
    for name, t in gr["traj"].items():
        busy = t["busy_ms_per_step"]

        def b(r):
            return "not measured" if busy[r] is None else f"{busy[r]:.4f}"

        print(f"[times] {card} | graphs {name}: ms/step captured {t['ms_per_step']['graph']:.4f} "
              f"(replays alone {t['replay_ms_per_step']:.4f}), eager {t['ms_per_step']['eager']:.4f}"
              f" ({GRAPH_WINDOW[name]}-step runs, median of 3); device busy ms/step captured "
              f"{b('graph')}, eager {b('eager')}; host launch calls per step captured "
              f"{t['host_kernel_launches_per_step']['graph']:.2f} kernels + "
              f"{t['graph_launches_per_step']['graph']:.2f} graphs, eager "
              f"{t['host_kernel_launches_per_step']['eager']:.2f} kernels + "
              f"{t['graph_launches_per_step']['eager']:.2f} graphs ({GRAPH_TRACE}-step traced "
              f"runs); capture s " + ", ".join(f"{k} {v:.3f}" for k, v in t["capture_s"].items())
              + "; peak MiB " + ", ".join(
                  f"{r} {m['allocated']:.1f} allocated / {m['reserved']:.1f} reserved"
                  for r, m in t["peak_mib"].items())
              + f"; a cached bucket holds {t['bucket_mib']['allocated']:.1f} MiB allocated "
              f"(static buffers), {t['bucket_mib']['reserved']:.1f} MiB reserved (with its "
              f"graph's pool)", flush=True)
    print(f"[times] {card} | graphs PoseOptimizer ms/step " + "; ".join(
        f"{name} captured {t['ms_per_step']['graph']:.4f}, eager {t['ms_per_step']['eager']:.4f}"
        f" (capture {t['capture_s']:.3f} s)" for name, t in gr["pose"].items())
        + f"; optimize_waypoints {gr['wps']['steps']} steps: "
        + ", ".join(f"{r} {s:.3f} s" for r, s in gr["wps"]["s"].items()), flush=True)
    for name, t in gr["soft"].items():
        def num(v, fmt=".4f"):
            return "not measured" if v is None else format(v, fmt)

        busy, ops = t["busy_ms_per_step"], t["device_ops_per_step"]
        print(f"[times] {card} | graphs soft {name} (binned tier, static slots): ms/step of "
              f"{t['steps']}-step calls captured "
              + ", ".join(f"{v:.3f}" for v in t["ms_per_step"]["graph"]) + ", eager "
              + ", ".join(f"{v:.3f}" for v in t["ms_per_step"]["eager"])
              + f" (each call's first step eager; in turns); replays alone "
              f"{t['replay_ms_per_step']:.3f} ms/step; one traced step: device busy ms captured "
              f"{num(busy['graph'], '.3f')}, eager {num(busy['eager'], '.3f')}; device operations "
              f"captured {num(ops['graph'], '.0f')}, eager {num(ops['eager'], '.0f')}; host "
              f"launch calls captured {t['host_kernel_launches_per_step']['graph']:.0f} kernels + "
              f"{t['graph_launches_per_step']['graph']:.0f} graph, eager "
              f"{num(t['host_kernel_launches_per_step']['eager'], '.0f')} kernels; capture "
              f"{t['capture_s']:.3f} s; the cached graph holds {t['graph_mib']['allocated']:.1f} "
              f"MiB allocated, {t['graph_mib']['reserved']:.1f} MiB reserved; peak MiB "
              + ", ".join(f"{r} {m['allocated']:.1f} allocated / {m['reserved']:.1f} reserved"
                          for r, m in t["peak_mib"].items())
              + f"; {tiles_text(t['tiles'])}; held by {t['held']}; {t['seconds']:.1f} s in all",
              flush=True)


def spread(xs) -> str:
    """'median [min, max]' of a few measurements."""
    return f"{statistics.median(xs):.3f} [{min(xs):.3f}, {max(xs):.3f}]"


def print_cli_times(card: str, cl) -> None:
    """[cli]'s line under [times]."""
    print(f"[times] {card} | cli: eval --optimize 100 {cl['run_s']['eval']:.2f} s; preset runs "
          + ", ".join(f"{k} {v:.2f} s" for k, v in cl["run_s"].items() if k != "eval")
          + "; worker start-up " + ", ".join(f"{k} {v:.2f} s" for k, v in cl["startup_s"].items())
          + "; msgs/s (median [min, max] of windows) "
          + ", ".join(f"{k} {spread(v)}" for k, v in cl["msgs_per_s"].items())
          + f"; recording the rig's six images, MB/s {spread(cl['record']['mb_per_s'])}",
          flush=True)


def traced_share(fn, sync, range_name=None):
    """(wall ms, device-busy ms, device ms of the kernels launched inside
    ``ops.hpr``'s profiler ranges named ``range_name`` (the soft dominance
    tile's by default), device operations) of one traced call; the device
    numbers are None when the trace holds no device activity. A range is
    counted on its host side only: the trace also holds its device-side
    annotation, which would count it twice."""
    import torch

    from trajectory_optimization_tpu_torch.ops.hpr import SOFT_DOMINANCE_RANGE

    range_name = range_name or SOFT_DOMINANCE_RANGE
    prof, wall_ms, n_spans, busy_us = traced(fn, sync)
    if not n_spans:
        return wall_ms, None, None, None
    dom_us = sum(e.device_time_total for e in prof.events()
                 if e.name == range_name
                 and e.device_type == torch.autograd.DeviceType.CPU)
    return wall_ms, busy_us / 1e3, dom_us / 1e3, n_spans


def must_hold(what: str, check) -> None:
    """Fail the smoke where ``check`` raises an AssertionError (torch.testing's
    and plain ``assert``s)."""
    try:
        check()
    except AssertionError as e:
        fail(f"{what}: {e}")


def rel_to_largest(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got - want).abs().max() / max(float(want.abs().max()), 1e-30))


def close_to_largest(got, want, rel: float) -> None:
    """Finite, and every entry within ``rel`` of ``want``'s largest."""
    import torch

    assert torch.isfinite(got).all(), "not finite"
    err = rel_to_largest(got, want)
    assert err <= rel, f"{err:.3e} of the largest entry (pin {rel})"


def _held_traj_head(got, want, dev):
    import torch

    from trajectory_optimization_tpu_torch.ops import _kernels

    assert torch.equal(got[0], want[0]), "wp not torch.equal"
    assert torch.equal(got[1], want[1]), "kp not torch.equal"
    sentinels = torch.tensor([[_kernels.BIG], [-_kernels.BIG]], device=dev)
    assert torch.equal(got[2], sentinels.expand_as(got[2])), "pass A's preset is not the sentinels"


def _held_traj_loss(got, want, dev):
    import torch

    (loss, aux, rewards), (loss_r, aux_r, rewards_r) = got, want
    assert torch.equal(rewards, rewards_r), "rewards not torch.equal"
    torch.testing.assert_close(aux[:7], aux_r[:7], rtol=2e-6, atol=1e-7)
    torch.testing.assert_close(aux[7], aux_r[7], rtol=1e-6, atol=2e-5)
    torch.testing.assert_close(loss, loss_r, rtol=2e-6, atol=0)


def _held_equal(got, want, dev):
    import torch

    assert torch.equal(got[0], want[0]), "not torch.equal"


def _held_lo_cotangent(got, want, dev):
    import torch

    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=0)


def _held_traj_tail(got, want, dev):
    for a, b, what in zip(got, want, ("poses", "quats")):
        try:
            close_to_largest(a, b, 2e-5)
        except AssertionError as e:
            raise AssertionError(f"d/d{what}: {e}") from None


# Each trajectory-loss kernel against its plain version on the same inputs,
# at tests/test_torch_fused_traj_cuda.py's bounds: bit for bit where the two
# round the same operations, else within stated bounds.
LOSS_HELD = {"traj_head": _held_traj_head, "make_norm": _held_equal,
             "traj_loss": _held_traj_loss, "lo_cotangent": _held_lo_cotangent,
             "alpha_beta": _held_equal, "traj_tail": _held_traj_tail}
# traj_tail's anchor, smoothness and length gradients (its output on zero
# camera-plane sums) against criterion_grads_ref: share of the largest entry
# (tests/test_torch_fused_traj_cuda.py's bound; the cases there read at most
# 1.8e-5, while leaving out the length term moves it by 6e-3 or more and the
# anchor or smoothness term by 0.1 or more, where they are not 0)
CRIT_GRAD_REL = 1e-4


def loss_work(name: str, W: int, W_s: int, N: int):
    """(bytes, operations) of one call of a trajectory-loss kernel
    (csrc/fused_traj.cu) on W waypoints, W_s of them scored, and N points:
    each input read once, each output written once; operations counted from
    the plain versions (ops/fused_traj.py), a transcendental, a square root
    and a division 1 each."""
    return {
        # quats and poses rows 28 B, K 36 B in; wp 48 B, the preset 8 B, kp 16 B out;
        # the norm 8, 4 divisions, the rotation 30
        "traj_head": (28 * W_s + 36 + 56 * W_s + 16, 42 * W_s),
        "make_norm": (8 * W_s + 16 * W_s, 4 * W_s),
        # lo and valid in, rewards out; the mean's 7 a point; poses and poses0;
        # 40 a waypoint (two lengths, an angle)
        "traj_loss": (12 * N + 24 * W + 36, 7 * N + 40 * W),
        "lo_cotangent": (16 * N + 36, 8 * N),
        "alpha_beta": (16 * W_s + 16 * W_s + 24 * W_s, 4 * W_s),
        # sums and wp in, 48 B each a scored waypoint; quats, poses, poses0 in
        # and the gradients out, 68 B a waypoint; 120 a scored waypoint (the
        # plane sums to dR and dt 30, the rotation's 50 and the normalization's
        # 40), 150 a waypoint (three angles' gradients, two segments, the anchor)
        "traj_tail": (96 * W_s + 68 * W + 36, 120 * W_s + 150 * W),
    }[name]


def loss_checks(dev, intr, cloud10, path10, sync, cuda_ms, kernel_device_ms):
    """The trajectory loss's six kernels (csrc/fused_traj.cu) at the main
    path's shapes: cloud 10 as the facade pads it, path 10 moved off its
    initial positions (27 waypoints, 14 scored), the score-cache regime.
    Each kernel against its plain version (ops/fused_traj.py) on the same
    inputs, timed through its wrapper (CUDA events), alone (profiler) and
    beside the plain version and its bound; then the loss's forward and
    backward captured as one graph and replayed, beside the plain path it
    replaces (fused_lo_sum + traj_criterion, autograd): device operations and
    device ms per replay, and host ms of one eager call."""
    import numpy as np
    import torch

    from trajectory_optimization_tpu_torch.models.traj import TrajProblem, traj_criterion
    from trajectory_optimization_tpu_torch.ops import _kernels
    from trajectory_optimization_tpu_torch.ops import fused_traj as ft
    from trajectory_optimization_tpu_torch.ops import fused_vis as fv
    from trajectory_optimization_tpu_torch.opt import graphs as tg
    from trajectory_optimization_tpu_torch.utils.data import traj_case

    pts, valid, poses, quats, p0, _, step = traj_case(
        "moved", cloud10, path10, n_points=len(cloud10), target=-(-len(cloud10) // 1024) * 1024,
        every=1)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    P, V, poses, quats, p0 = t(pts), t(valid), t(poses), t(quats), t(p0)
    Pt, K = P.t().contiguous(), intr.matrix(device=dev)
    prob = TrajProblem(intr.width, intr.height, smoothness_weight=28.0, wps_step=step)
    c = ft.make_traj_consts(prob)
    k = fv.make_consts(intr.width, intr.height, prob.min_dist, prob.max_dist, prob.eps)
    N, W = P.shape[0], poses.shape[0]
    W_s = ft.n_scored(W, step)
    if not fv.uses_score_cache(W_s, N):
        fail("[loss] cloud 10 is not in the score-cache regime")

    wp, kp, minmax = _kernels.traj_head(poses, quats, K, step)
    scores = _kernels.pass_a(wp, kp, Pt, V, k, minmax=minmax)[2]
    norm = _kernels.make_norm(minmax)
    lo = fv.pass_b(norm, scores, k.eps)
    loss, aux, rewards = _kernels.traj_loss(lo, V, poses, p0, c)
    g_loss = torch.ones((), device=dev)
    g = _kernels.lo_cotangent(g_loss, lo, rewards, V, aux)
    stats, need = fv.bwd_stats(norm, scores, V, g, k.eps)
    norm2 = _kernels.alpha_beta(stats, norm)
    sums = fv.bwd_apply(wp, kp, norm2, Pt, V, g, scores, need, k)
    calls = {
        "traj_head": (lambda: _kernels.traj_head(poses, quats, K, step),
                      lambda: ft.traj_head_ref(poses, quats, K, step)),
        "make_norm": (lambda: _kernels.make_norm(minmax), lambda: ft.make_norm_ref(minmax)),
        "traj_loss": (lambda: _kernels.traj_loss(lo, V, poses, p0, c),
                      lambda: ft.traj_loss_ref(lo, V, poses, p0, c)),
        "lo_cotangent": (lambda: _kernels.lo_cotangent(g_loss, lo, rewards, V, aux),
                         lambda: ft.lo_cotangent_ref(g_loss, lo, rewards, V, aux)),
        "alpha_beta": (lambda: _kernels.alpha_beta(stats, norm),
                       lambda: ft.alpha_beta_ref(stats, norm)),
        "traj_tail": (lambda: _kernels.traj_tail(sums, wp, quats, poses, p0, aux, g_loss, c),
                      lambda: ft.traj_tail_ref(sums, wp, quats, poses, p0, aux, g_loss, c)),
    }
    res = {"ms": {}, "alone_ms": {}, "plain_ms": {}, "bound": {}, "err": {}, "replay": {}}
    for name, (kern, plain) in calls.items():
        got, want = kern(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        sync()
        res["err"][name] = max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(got, want))
        must_hold(f"[loss] {name} against its plain version",
             lambda: LOSS_HELD[name](got, want, dev))
        res["ms"][name] = cuda_ms(kern, 200)
        res["alone_ms"][name] = kernel_device_ms(kern, f"{name}_kernel", reps=20)
        res["plain_ms"][name] = cuda_ms(plain, 20)
        res["bound"][name] = bound(*loss_work(name, W, W_s, N))

    # the tail on zero camera-plane sums: the anchor, smoothness and length
    # gradients alone, which beside the visibility gradient are small
    zero = torch.zeros_like(sums)
    crit = _kernels.traj_tail(zero, wp, quats, poses, p0, aux, g_loss, c)[0]
    crit_ref = ft.traj_tail_ref(zero, wp, quats, poses, p0, aux, g_loss, c)[0]
    sync()
    res["err"]["criterion_grads"] = rel_to_largest(crit, crit_ref)
    must_hold("[loss] traj_tail's criterion gradients against criterion_grads_ref",
         lambda: close_to_largest(crit, crit_ref, CRIT_GRAD_REL))

    # the whole fused loss against the plain path, forward values
    leaves = {"poses": poses, "quats": quats}
    lf, af = ft.fused_traj(leaves, P, K, p0, prob, valid=V, points_t=Pt)
    lo_p = fv.fused_lo_sum(P, quats[::step], poses[::step], K, intr.width, intr.height,
                           valid=V, points_t=Pt)
    lp, ap = traj_criterion(lo_p, leaves, p0, prob, valid=V)
    sync()
    res["err"]["loss_vs_plain"] = abs(float(lf) / float(lp) - 1.0)

    def same_values():
        torch.testing.assert_close(lf, lp, rtol=2e-6, atol=0)
        for key in ft.AUX:
            torch.testing.assert_close(af[key], ap[key], rtol=2e-6, atol=1e-6, msg=key)
        assert torch.equal(af["rewards"], ap["rewards"]), "rewards not torch.equal"

    must_hold("[loss] the fused loss and its aux against fused_lo_sum + traj_criterion",
              same_values)

    def fused_step():
        leaves = {"poses": poses.detach().requires_grad_(True),
                  "quats": quats.detach().requires_grad_(True)}
        loss, _ = ft.fused_traj(leaves, P, K, p0, prob, valid=V, points_t=Pt)
        return torch.autograd.grad(loss, list(leaves.values()))

    def plain_step():
        leaves = {"poses": poses.detach().requires_grad_(True),
                  "quats": quats.detach().requires_grad_(True)}
        sel = slice(None, None, step)
        lo = fv.fused_lo_sum(P, leaves["quats"][sel], leaves["poses"][sel], K, intr.width,
                             intr.height, valid=V, points_t=Pt)
        loss, _ = traj_criterion(lo, leaves, p0, prob, valid=V)
        return torch.autograd.grad(loss, list(leaves.values()))

    grads = {}
    for route, fn in (("fused", fused_step), ("plain", plain_step)):
        sync()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / 20
        sync()
        with tg.on_capture_stream(dev):
            fn()
            graph = tg.StepGraph(fn, dev, f"{route} loss")
            graph.capture()
            graph.replay()
        sync()
        grads[route] = fn()

        def replays(n=200, graph=graph):
            with tg.on_capture_stream(dev):
                for _ in range(n):
                    graph.replay()

        replay_ms = cuda_ms(lambda: replays(), 1) / 200
        prof, _, n_ops, busy_us = traced(lambda: replays(1), sync)
        res["replay"][route] = {"device_ops": n_ops, "busy_ms": busy_us / 1e3,
                                "replay_ms": replay_ms, "eager_host_ms": host_ms,
                                "launches": graph.launches}
    if res["replay"]["fused"]["device_ops"] > 12:
        fail(f"[loss] a replay of the fused loss ran {res['replay']['fused']['device_ops']} "
             "device operations, more than 12")
    for (a, b), what in zip(zip(grads["fused"], grads["plain"]), ("poses", "quats")):
        err = float((a - b).abs().max() / b.abs().max())
        res["err"][f"grad_{what}_vs_plain"] = err
        if not err <= 1e-4:
            fail(f"[loss] fused d/d{what} {err:.2e} of its largest entry from the plain path's")
    for name in calls:
        b = res["bound"][name]
        alone = "not measured" if res["alone_ms"][name] is None else f"{res['alone_ms'][name]:.4f}"
        print(f"[loss] {name}: max|kernel - plain| {res['err'][name]:.2e}; "
              f"{res['ms'][name]:.4f} ms through the wrapper, "
              f"{alone} ms alone, plain {res['plain_ms'][name]:.4f} "
              f"ms, bound {b[0]:.2e} ms ({b[1]})", flush=True)
    for route, r in res["replay"].items():
        print(f"[loss] {route} loss forward + backward at cloud 10 (N {N}, W {W}, W_s {W_s}): "
              f"one replay {r['device_ops']} device operations, busy {r['busy_ms']:.4f} ms "
              f"(traced), {r['replay_ms']:.4f} ms a replay over 200; eager call "
              f"{r['eager_host_ms']:.3f} ms of host; kernel launches {r['launches']}",
              flush=True)
    print(f"[loss] fused gradients against the plain path's: poses "
          f"{res['err']['grad_poses_vs_plain']:.2e}, quats {res['err']['grad_quats_vs_plain']:.2e}"
          f" of the largest entry (pin 1e-4); the loss {res['err']['loss_vs_plain']:.2e} "
          f"relative (pin 2e-6), each aux scalar within rtol 2e-6 / atol 1e-6, the rewards "
          f"torch.equal; traj_tail's criterion gradients on zero sums "
          f"{res['err']['criterion_grads']:.2e} of the largest entry (pin {CRIT_GRAD_REL})",
          flush=True)
    return res


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
    from trajectory_optimization_tpu_torch.opt.engine import NEVER, OptimizerConfig
    from trajectory_optimization_tpu_torch.utils.data import (
        identity_quaternions, in_view_case, load_path, load_point_cloud, pad_points,
    )
    from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics

    phase_s, phase_t0 = {}, [time.perf_counter()]

    def phase_done(name):
        """Seconds of the phase that ends here, for [times] and the record."""
        now = time.perf_counter()
        phase_s[name], phase_t0[0] = now - phase_t0[0], now

    # ---- 1. device ---------------------------------------------------------
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    phase_done("device")
    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _kernels.build()
    _kernels._load()
    print(f"[build] {VIS_SOURCE} and {SPLAT_SOURCE} -> one sm_90a library in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in _kernels.build_log.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", file=sys.stderr)
    regs = ptxas_report(_kernels.build_log)
    splat_regs = {}
    for kname, mangled in (("pass_a_kernel<true> (K1)", "pass_a_kernelILb1E"),
                           ("pass_a_kernel<false> (K1')", "pass_a_kernelILb0E"),
                           ("pass_b_recompute_kernel (K2')", "pass_b_recompute_kernel"),
                           ("bwd_stats_kernel<true> (K3, 16-byte loads)", "bwd_stats_kernelILb1E"),
                           ("bwd_stats_kernel<false> (K3, scalar loads)", "bwd_stats_kernelILb0E"),
                           ("bwd_apply_kernel (K4)", "bwd_apply_kernel"),
                           ("bwd_fused_kernel (K5)", "bwd_fused_kernel"),
                           ("splat_runs_kernel (K6)", "splat_runs_kernel"),
                           ("splat_dense_kernel (K7)", "splat_dense_kernel")):
        found = [v for k, v in regs.items() if mangled in k]
        if not found:
            fail(f"ptxas reported no {kname}: is every csrc/*.cu built?")
        r, st, ld = found[0]
        print(f"[build] {kname}: {r} registers, {st} bytes spill stores, {ld} bytes spill loads",
              flush=True)
        if mangled in SPLAT_KERNELS:
            splat_regs[SPLAT_KERNELS[mangled]] = (r, st, ld)
    resident = _kernels.splat_resident_blocks()
    print("[build] resident blocks per SM (one per 32x128 tile): " + ", ".join(
        f"{n} {resident[n]}" for n in SPLAT), flush=True)

    n_tried, n_nonzero = _kernels.expf_zero_check(dev)
    if n_nonzero or n_tried < 1_000_000_000:
        fail(f"expf(x) != 0 for {n_nonzero} of the {n_tried} floats x <= "
             f"{-_kernels.PRUNE_ZERO_T / 2}: pass A's exact-zero pruning does not hold here")
    print(f"[build] expf(x) == 0 for all {n_tried} floats x <= {-_kernels.PRUNE_ZERO_T / 2} "
          f"(every bit pattern down to -inf): T0 >= {_kernels.PRUNE_ZERO_T} gives a score of "
          f"exactly 0", flush=True)

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

    def device_busy(loss_fn, p0, n):
        """(device activities per step, device-busy ms per step, busy share of
        the traced wall time) from a torch.profiler trace of n steps; None if
        the trace holds no device activity."""
        _, wall_ms, n_spans, busy_us = traced(
            lambda: eager_steps(loss_fn, p0, n), sync)
        if not n_spans:
            return None
        return n_spans / n, busy_us / 1e3 / n, busy_us / 1e3 / wall_ms

    def busy_text(b):
        if b is None:
            return "busy share not measured (no device activity in the trace)"
        return f"{b[0]:.1f} device ops/step, busy {b[1]:.4f} ms/step, {100 * b[2]:.1f}% of the traced step"

    def eager_steps(loss_fn, p0, n):
        # the plain loop (tests/torch_loop_ref.py), uncaptured: [times] keeps
        # the series of earlier runs; [graphs] times the captured loop beside it
        return plain_loops().until_done(loss_fn, p0, cfg, n, NEVER)

    def step_times(loss_fn, p0, n):
        """Median ms/step of 3 windows of n eager steps after a warm-up
        window, the peak MiB of those windows, and ``device_busy`` over 20
        traced steps."""
        eager_steps(loss_fn, p0, n)  # warm-up
        sync()
        torch.cuda.reset_peak_memory_stats()
        windows = []
        for _ in range(3):
            t0 = time.perf_counter()
            eager_steps(loss_fn, p0, n)
            sync()
            windows.append((time.perf_counter() - t0) * 1e3 / n)
        peak = torch.cuda.max_memory_allocated() / 2**20
        return statistics.median(windows), peak, device_busy(loss_fn, p0, 20)

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

    def kernel_inputs(c):
        """The waypoint table, camera row and constants fused_lo_sum builds."""
        sel = slice(None, None, c["stride"])
        quats, trans = c["quats"][sel].contiguous(), c["path"][sel].contiguous()
        R = quat_ops.to_matrix(quat_ops.normalize(quats))
        wp = torch.cat([R.reshape(len(quats), 9), trans], dim=1).contiguous()
        kp = torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).contiguous()
        prob = c["problem"]
        k = fv.make_consts(intr.width, intr.height, prob.min_dist, prob.max_dist, prob.eps)
        return quats, trans, wp, kp, k

    def criterion_cotangent(lo, c):
        """The main path's own cotangent for lo: d loss / d lo through the criterion."""
        lo_leaf = lo.detach().requires_grad_(True)
        params = {"poses": c["path"], "quats": c["quats"]}
        loss, _ = traj_criterion(lo_leaf, params, c["path"], c["problem"], valid=c["V"])
        (g,) = torch.autograd.grad(loss, lo_leaf)
        return g.contiguous()

    def same(what, got, want):
        if not torch.equal(got, want):
            diff = got != want
            fail(f"{what}: {int(diff.sum())} of {got.numel()} values differ (max |diff| "
                 f"{float((got - want)[diff].abs().max()):.3e}); they must be bit-equal")

    def pass_a_equal(name, wp, kp, Pt, V, k):
        """K1's min, max and cache and K1′'s min and max bit-equal to the
        plain pass A's (so K1′'s equal K1's), and a second launch of each to
        its first. Returns K1's outputs and the plain ones."""
        m, mx, cache = _kernels.pass_a(wp, kp, Pt, V, k)
        m_r, mx_r, cache_r = fv.pass_a_ref(wp, kp, Pt, V, k)
        m1, mx1 = _kernels.pass_a_minmax(wp, kp, Pt, V, k)
        sync()
        for what, got, want in (("K1 min", m, m_r), ("K1 max", mx, mx_r), ("K1 cache", cache, cache_r),
                                ("K1' min", m1, m_r), ("K1' max", mx1, mx_r)):
            same(f"{what} {name} against the plain version", got, want)
        again = (*_kernels.pass_a(wp, kp, Pt, V, k), *_kernels.pass_a_minmax(wp, kp, Pt, V, k))
        sync()
        for what, got, want in zip(("K1 min", "K1 max", "K1 cache", "K1' min", "K1' max"), again,
                                   (m, mx, cache, m1, mx1)):
            same(f"{what} {name}, second launch against the first", got, want)
        return m, mx, cache, m_r, mx_r, cache_r

    def cached_backward(name, wp, kp, Pt, V, g, k, cache, norm, eps):
        """K3 and K4 on one cache against their plain versions: K3's sums
        rtol 2e-3 / atol 2e-3, its tie counts and need mask exact; K4 on that
        mask, rtol 2e-3 / atol 2e-3, against the plain K4 that computes every
        pair and adds its f32 terms in float64 (on the dense and tie cases a
        sum of order 1 comes from terms whose magnitudes add up to 1e6, and
        an f32 sum of them is itself off by 5e-3 and more); a second launch
        of each bit-equal to the first. Returns (K3's table, its mask, norm2,
        K4's sums, the two max |err|, that plain K4's sums)."""
        st, need = _kernels.bwd_stats(norm, cache, V, g, eps)
        st_r, need_r = fv.bwd_stats_ref(norm, cache, V, g, eps)
        e3 = close(f"K3 sums {name}", st[:, :2], st_r[:, :2], 2e-3, 2e-3)
        if not torch.equal(st[:, 2:], st_r[:, 2:]):
            fail(f"K3 tie counts {name}: {st[:, 2:].tolist()} vs {st_r[:, 2:].tolist()}")
        same(f"K3 need mask {name} against the plain mask", need, need_r)
        del need_r
        alpha = st[:, 0] / torch.clamp(st[:, 2], min=1.0)
        beta = st[:, 1] / torch.clamp(st[:, 3], min=1.0)
        norm2 = torch.cat([norm, alpha[:, None], beta[:, None]], dim=1).contiguous()
        sums = _kernels.bwd_apply(wp, kp, norm2, Pt, V, g, cache, need, k)
        sums_r = fv.bwd_apply_ref(wp, kp, norm2, Pt, V, g, cache, need, k, sum_dtype=torch.float64)
        e4 = close(f"K4 sums {name}", sums, sums_r, 2e-3, 2e-3)
        st2, need2 = _kernels.bwd_stats(norm, cache, V, g, eps)
        sums2 = _kernels.bwd_apply(wp, kp, norm2, Pt, V, g, cache, need, k)
        sync()
        for what, got, want in (("K3 table", st2, st), ("K3 need mask", need2, need),
                                ("K4 sums", sums2, sums)):
            same(f"{what} {name}, second launch against the first", got, want)
        return st, need, norm2, sums, e3, e4, sums_r

    def kernel_device_ms(fn, kernel, reps=10):
        """Mean device time in ms of the launches whose name holds ``kernel``
        in a torch.profiler trace of ``reps`` calls of fn (the kernel alone,
        without the wrapper's host time that the CUDA-event times include
        where it is the longer); None if the trace holds no such activity."""
        fn()
        sync()

        def run():
            for _ in range(reps):
                fn()

        for _ in range(3):  # a trace now and then comes back without its device activity
            spans = [e.time_range.end - e.time_range.start for e in traced(run, sync)[0].events()
                     if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
            if spans:
                return sum(spans) / len(spans) / 1e3
        return None

    def cached_bwd_device_ms(wp, kp, Pt, V, g, k, cache, norm, norm2, need, eps):
        return {"bwd_stats": kernel_device_ms(
                    lambda: _kernels.bwd_stats(norm, cache, V, g, eps), "bwd_stats_kernel"),
                "bwd_apply": kernel_device_ms(
                    lambda: _kernels.bwd_apply(wp, kp, norm2, Pt, V, g, cache, need, k),
                    "bwd_apply_kernel")}

    def device_ops(fn):
        """Device operations (kernels, copies) of one call of fn, from a
        torch.profiler trace; 0 if the trace holds no device activity."""
        fn()
        sync()
        return traced(fn, sync)[2]

    cases = [shape_case("ref", cloud10, path10), shape_case("1m50", big_pts, big_path)]
    errs = {k: 0.0 for k in VIS}
    stage_ms, shape_wn, skips, prunes, dev_ms = {}, {}, {}, {}, {}

    phase_done("build")
    # ---- 3. kernels against their plain versions ---------------------------
    for c in cases:
        prob = c["problem"]
        quats, trans, wp, kp, k = kernel_inputs(c)
        W, N = quats.shape[0], c["P"].shape[0]
        shape_wn[c["name"]] = (W, N)
        Pt, V = c["Pt"], c["V"]

        # K1 and K1′: bit-equal to the plain pass A (tolerance 0; ``close``
        # below only takes the record's max |err|).
        m, mx, cache, m_r, mx_r, cache_r = pass_a_equal(c["name"], wp, kp, Pt, V, k)
        prunes[c["name"]] = prune_counts(fv.prune_masks(wp, kp, Pt, k, m, mx), V)
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

        g = criterion_cotangent(lo, c)

        # K3 and K4 (same cache, same norm): see cached_backward.
        st, need, norm2, sums, e3, e4, _ = cached_backward(c["name"], wp, kp, Pt, V, g, k, cache,
                                                           norm, prob.eps)
        errs["bwd_stats"] = max(errs["bwd_stats"], e3)
        errs["bwd_apply"] = max(errs["bwd_apply"], e4)

        # K1′: the same score arithmetic as K1 without the cache, so its
        # min/max are K1's bit for bit; against the plain K1 as K1 is.
        m1, mx1 = _kernels.pass_a_minmax(wp, kp, Pt, V, k)
        same(f"K1' min {c['name']} against K1's", m1, m)
        same(f"K1' max {c['name']} against K1's", mx1, mx)
        e1p = close(f"K1' min {c['name']}", m1, m_r, 1e-5, 1e-30)
        errs["pass_a_minmax"] = max(errs["pass_a_minmax"], e1p,
                                    close(f"K1' max {c['name']}", mx1, mx_r, 1e-5, 1e-30))

        # K2′ against its plain version and against K2 on K1's cache, with the
        # same norm: rtol 1e-4 / atol 2e-4.
        lo2 = _kernels.pass_b_recompute(wp, kp, norm, Pt, k)
        errs["pass_b_recompute"] = max(errs["pass_b_recompute"], close(
            f"K2' lo {c['name']}", lo2, fv.pass_b_recompute_ref(wp, kp, norm, Pt, k), 1e-4, 2e-4))
        close(f"K2' lo vs K2 {c['name']}", lo2, lo, 1e-4, 2e-4)

        # K5: sums (slots 0-37) rtol 2e-3 / atol 2e-3 against the plain K5. In
        # this regime each side tests s == m on its own recompute, so the plain
        # K5 gets the norm of the plain K1 (the kernel norm would split ties
        # the plain recompute's last bits may miss). Tie counts (38, 39) equal
        # K3's on K1's cache with the same norm, exactly.
        acc = _kernels.bwd_fused_acc(wp, kp, norm, Pt, V, g, k)
        acc_r = fv.bwd_fused_acc_ref(wp, kp, fv.make_norm(m_r, mx_r), Pt, V, g, k)
        errs["bwd_fused_acc"] = max(errs["bwd_fused_acc"], close(
            f"K5 sums {c['name']}", acc[:, :38], acc_r[:, :38], 2e-3, 2e-3))
        if not torch.equal(acc[:, 38:], st[:, 2:]):
            fail(f"K5 tie counts {c['name']}: {acc[:, 38:].tolist()} vs K3 {st[:, 2:].tolist()}")
        # linearity: the single pass, combined, is K4 with α and β from K3
        close(f"K5 combined vs K4 {c['name']}", fv.fused_acc_to_sums(acc, W), sums, 2e-3, 2e-3)
        del acc_r
        skips[c["name"]] = {**skip_counts(fv.skip_masks(wp, kp, norm, Pt, V, k)),
                            **need_counts(need)}

        # the whole fused_lo_sum in both regimes against the plain autodiff
        # path: forward rtol 1e-4 / atol 2e-4, gradient w.r.t. quats and trans
        # rtol 2e-3 / atol 2e-3. "uncached" forces the regime with a zero budget.
        from trajectory_optimization_tpu_torch.models.traj import observation_logodds
        from trajectory_optimization_tpu_torch.ops.scores import waypoint_scores

        grads = {}
        for backend in ("kernel", "uncached", "torch"):
            q_leaf = quats.clone().requires_grad_(True)
            t_leaf = trans.clone().requires_grad_(True)
            before = dict(_kernels.LAUNCHES)
            if backend == "torch":
                s = waypoint_scores(c["P"], q_leaf, t_leaf, K, intr.width, intr.height)
                lo_b = torch.sum(observation_logodds(s, prob.eps, V), dim=0)
                gq, gt = torch.autograd.grad(torch.sum(lo_b * g), (q_leaf, t_leaf))
            else:
                budget = fv.SCORE_CACHE_MAX_BYTES
                if backend == "uncached":
                    fv.SCORE_CACHE_MAX_BYTES = 0
                try:
                    lo_b = fv.fused_lo_sum(c["P"], q_leaf, t_leaf, K, intr.width, intr.height,
                                           valid=V, points_t=Pt)
                    gq, gt = torch.autograd.grad(torch.sum(lo_b * g), (q_leaf, t_leaf))
                finally:
                    fv.SCORE_CACHE_MAX_BYTES = budget
                ran = {n for n in REPLACES if _kernels.LAUNCHES[n] > before[n]}
                want = set(UNCACHED if backend == "uncached" else CACHED)
                if ran != want:
                    fail(f"fused_lo_sum {backend} {c['name']} launched {sorted(ran)}, "
                         f"expected {sorted(want)}")
            grads[backend] = (lo_b.detach(), gq, gt)
        for backend in ("kernel", "uncached"):
            close(f"fused_lo_sum {backend} forward {c['name']}", grads[backend][0],
                  grads["torch"][0], 1e-4, 2e-4)
            close(f"fused_lo_sum {backend} d/dquats {c['name']}", grads[backend][1],
                  grads["torch"][1], 2e-3, 2e-3)
            close(f"fused_lo_sum {backend} d/dtrans {c['name']}", grads[backend][2],
                  grads["torch"][2], 2e-3, 2e-3)
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
            "bwd_apply": (
                cuda_ms(lambda: _kernels.bwd_apply(wp, kp, norm2, Pt, V, g, cache, need, k), reps),
                cuda_ms(lambda: fv.bwd_apply_ref(wp, kp, norm2, Pt, V, g, cache, need, k), reps)),
            "pass_a_minmax": (cuda_ms(lambda: _kernels.pass_a_minmax(wp, kp, Pt, V, k), reps),
                              cuda_ms(lambda: fv.pass_a_minmax_ref(wp, kp, Pt, V, k), reps)),
            "pass_b_recompute": (
                cuda_ms(lambda: _kernels.pass_b_recompute(wp, kp, norm, Pt, k), reps),
                cuda_ms(lambda: fv.pass_b_recompute_ref(wp, kp, norm, Pt, k), reps)),
            "bwd_fused_acc": (
                cuda_ms(lambda: _kernels.bwd_fused_acc(wp, kp, norm, Pt, V, g, k), reps),
                cuda_ms(lambda: fv.bwd_fused_acc_ref(wp, kp, norm, Pt, V, g, k), reps)),
        }
        dev_ms[c["name"]] = cached_bwd_device_ms(wp, kp, Pt, V, g, k, cache, norm, norm2, need,
                                                 prob.eps)
        if c["name"] == "1m50":
            # the same cloud in a coherent (Morton) order: the pruned pairs
            # then fill whole warps, K1's exact zeros included. Same set of
            # points, so the same min and max, and the cache permuted.
            order = morton_order(Pt)
            Pt_s, V_s = Pt[:, order].contiguous(), V[order].contiguous()
            m_s, mx_s, cache_s = _kernels.pass_a(wp, kp, Pt_s, V_s, k)
            for what, got, want in (("min", m_s, m), ("max", mx_s, mx),
                                    ("cache", cache_s, cache[:, order])):
                same(f"K1 {what} 1m50 in Morton order against the given order", got, want)
            del cache_s
            for what, got, want in zip(("min", "max"),
                                       _kernels.pass_a_minmax(wp, kp, Pt_s, V_s, k), (m, mx)):
                same(f"K1' {what} 1m50 in Morton order against the given order", got, want)
            morton_ms = {
                "pass_a": cuda_ms(lambda: _kernels.pass_a(wp, kp, Pt_s, V_s, k), reps),
                "pass_a_minmax": cuda_ms(lambda: _kernels.pass_a_minmax(wp, kp, Pt_s, V_s, k), reps)}
            del Pt_s, V_s, order
        print(f"[kernels] {c['name']} N={N} W={W}: K1-K4, K1', K2', K5 and fused_lo_sum (both "
              f"regimes) match their plain versions; K1 and K1' bit-equal to the plain pass A and "
              f"to a second launch, K5 tie counts == K3's; K3's need mask == the plain mask, K3 "
              f"and K4 bit-equal to a second launch; "
              f"max|err| " + ", ".join(f"{n}={v:.2e}" for n, v in errs.items())
              + f"; {prune_text(prunes[c['name']])}; {skip_text(skips[c['name']])}; "
              f"{need_text(skips[c['name']])}", flush=True)
        if c["name"] == "ref":
            # a pass A call is its kernel and at most one initialising
            # operation; a K3 or K4 call is its kernel and nothing else
            for n, fn, most in (
                    ("pass_a", lambda: _kernels.pass_a(wp, kp, Pt, V, k), 2),
                    ("pass_a_minmax", lambda: _kernels.pass_a_minmax(wp, kp, Pt, V, k), 2),
                    ("bwd_stats", lambda: _kernels.bwd_stats(norm, cache, V, g, prob.eps), 1),
                    ("bwd_apply",
                     lambda: _kernels.bwd_apply(wp, kp, norm2, Pt, V, g, cache, need, k), 1)):
                n_ops = device_ops(fn)
                if n_ops > most:
                    fail(f"{n}: {n_ops} device operations in one call, expected at most {most}")
                print(f"[kernels] {n}: " + (f"{n_ops} device operations per call" if n_ops else
                      "device operations per call not measured (no device activity in the trace)"),
                      flush=True)
        del cache, need
        torch.cuda.empty_cache()

    # ---- 3b. the kernels where they skip little: dense and tie cases ----------
    # K3 and K4 as above (cached_backward), on K1's cache of the case; K5 sums
    # rtol 2e-3 / atol 2e-3 and tie counts exactly equal, each plain version on the min/max of its own
    # recompute; lo rtol 1e-4 / atol 2e-4; two launches of each kernel on the
    # same inputs bit-equal.
    kp0, k0 = kernel_inputs(cases[0])[3:]
    dense_pts, dense_q, dense_path = in_view_case(1_048_576, 50)
    R_c = quat_ops.to_matrix(quat_ops.normalize(torch.as_tensor(dense_q, device=dev)))
    wp_c = torch.cat([R_c.reshape(len(dense_q), 9), torch.as_tensor(dense_path, device=dev)],
                     dim=1).contiguous()
    dense_pt = torch.as_tensor(np.ascontiguousarray(dense_pts.T), device=dev)

    dense = {}
    for name in ("dense", "ties"):
        Pt_c = dense_pt if name == "dense" else fv.with_extreme_ties(wp_c, kp0, dense_pt, k0)
        N_c = Pt_c.shape[1]
        V_c = torch.ones(N_c, device=dev)
        g_c = torch.as_tensor(np.random.default_rng(1).normal(size=N_c).astype(np.float32),
                              device=dev)
        m_c, mx_c, cache_c, m_cr, mx_cr, cache_cr = pass_a_equal(name, wp_c, kp0, Pt_c, V_c, k0)
        del cache_cr
        prune_c = prune_counts(fv.prune_masks(wp_c, kp0, Pt_c, k0, m_c, mx_c), V_c)
        if prune_c["scored"] != prune_c["pairs"] or prune_c["scored_valid"] != prune_c["pairs"]:
            fail(f"{name}: pass A would prune where every score is positive: {prune_c}")
        norm_c = fv.make_norm(m_c, mx_c)
        norm_cr = fv.make_norm(m_cr, mx_cr)
        acc_c = _kernels.bwd_fused_acc(wp_c, kp0, norm_c, Pt_c, V_c, g_c, k0)
        acc_cr = fv.bwd_fused_acc_ref(wp_c, kp0, norm_cr, Pt_c, V_c, g_c, k0)
        errs["bwd_fused_acc"] = max(errs["bwd_fused_acc"], close(
            f"K5 sums {name}", acc_c[:, :38], acc_cr[:, :38], 2e-3, 2e-3))
        if not torch.equal(acc_c[:, 38:], acc_cr[:, 38:]):
            fail(f"K5 tie counts {name}: {acc_c[:, 38:].tolist()} vs plain {acc_cr[:, 38:].tolist()}")
        lo_c = _kernels.pass_b_recompute(wp_c, kp0, norm_c, Pt_c, k0)
        errs["pass_b_recompute"] = max(errs["pass_b_recompute"], close(
            f"K2' lo {name}", lo_c, fv.pass_b_recompute_ref(wp_c, kp0, norm_c, Pt_c, k0), 1e-4, 2e-4))
        if not (torch.equal(acc_c, _kernels.bwd_fused_acc(wp_c, kp0, norm_c, Pt_c, V_c, g_c, k0))
                and torch.equal(lo_c, _kernels.pass_b_recompute(wp_c, kp0, norm_c, Pt_c, k0))):
            fail(f"{name}: two launches of K5 or K2' on the same inputs differ")
        counts = skip_counts(fv.skip_masks(wp_c, kp0, norm_c, Pt_c, V_c, k0))
        if name == "dense" and counts["need_groups"] != counts["groups"]:
            fail(f"dense: only {counts['need_groups']} of {counts['groups']} groups take K5's chain")
        if name == "ties" and not (bool((m_c > 0).all()) and bool((acc_c[:, 38:] >= 2).all())):
            fail(f"ties: m {m_c.min():.3e}, tie counts {acc_c[:, 38:].min():.0f}: no ties with s != 0")
        st_c, need_c, norm2_c, sums_c, e3, e4, sums_cr = cached_backward(
            name, wp_c, kp0, Pt_c, V_c, g_c, k0, cache_c, norm_c, k0.eps)
        errs["bwd_stats"] = max(errs["bwd_stats"], e3)
        errs["bwd_apply"] = max(errs["bwd_apply"], e4)
        if not torch.equal(acc_c[:, 38:], st_c[:, 2:]):
            fail(f"K5 tie counts {name}: {acc_c[:, 38:].tolist()} vs K3 {st_c[:, 2:].tolist()}")
        # K5 adds in f32, so its sums, combined, carry the summation error
        # that K4 and its reference are free of: reported, not held
        k5_off = float((fv.fused_acc_to_sums(acc_c, len(dense_q)).double() - sums_cr).abs().max())
        counts.update(need_counts(need_c))
        if name == "dense" and counts["k4_groups"] != counts["groups"]:
            fail(f"dense: K3's mask flags only {counts['k4_groups']} of {counts['groups']} groups")
        dev_ms[name] = cached_bwd_device_ms(wp_c, kp0, Pt_c, V_c, g_c, k0, cache_c, norm_c, norm2_c,
                                            need_c, k0.eps)
        dense[name] = {"counts": counts, "prunes": prune_c, "W": len(dense_q), "N": N_c, "ms": {
            "bwd_stats": cuda_ms(lambda: _kernels.bwd_stats(norm_c, cache_c, V_c, g_c, k0.eps), 10),
            "bwd_apply": cuda_ms(lambda: _kernels.bwd_apply(wp_c, kp0, norm2_c, Pt_c, V_c, g_c,
                                                            cache_c, need_c, k0), 10),
            "pass_a": cuda_ms(lambda: _kernels.pass_a(wp_c, kp0, Pt_c, V_c, k0), 10),
            "pass_a_minmax": cuda_ms(lambda: _kernels.pass_a_minmax(wp_c, kp0, Pt_c, V_c, k0), 10),
            "pass_b_recompute": cuda_ms(
                lambda: _kernels.pass_b_recompute(wp_c, kp0, norm_c, Pt_c, k0), 10),
            "bwd_fused_acc": cuda_ms(
                lambda: _kernels.bwd_fused_acc(wp_c, kp0, norm_c, Pt_c, V_c, g_c, k0), 10)}}
        print(f"[kernels] {name} N={N_c} W={len(dense_q)}: K1 and K1' bit-equal to the plain pass "
              f"A (nothing pruned), K5 and K2' match their plain "
              f"versions, K5 tie counts equal, two launches bit-equal; m_w > 0 at "
              f"{int((m_c > 0).sum())} waypoints, tie counts >= {acc_c[:, 38:].min():.0f}; "
              f"{skip_text(counts)}; K3 and K4 match their plain versions on K1's cache (need mask "
              f"exact, K4 within 2e-3 of its plain terms added in float64, max |err| {e4:.3e}; K5 "
              f"combined, added in f32, is {k5_off:.3e} from them; two launches bit-equal), "
              f"{need_text(counts)}", flush=True)
        del Pt_c, V_c, g_c, acc_c, acc_cr, lo_c, cache_c, need_c, st_c, sums_c, norm2_c, sums_cr
        torch.cuda.empty_cache()
    del wp_c, dense_pt

    phase_done("kernels")
    # ---- 4. the slice: 400 steps of cloud 10 through the kernels ------------
    opt = TrajectoryOptimizer(lr_pose=0.1, lr_quat=0.02, device=dev)
    sync()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    res_k = opt.optimize(cloud10, path10, n_steps=400)
    sync()
    slice_s = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    if not (all(launches[n] > 0 for n in CACHED + LOSS)
            and all(launches[n] == 0 for n in UNCACHED)):
        fail(f"the cached path did not run exactly K1-K4 and the loss's kernels: {launches}")
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

    # TrajectoryOptimizer.evaluate of the optimized path, with the initial
    # path's stride: one no-grad forward, K1 and K2 once each, beside the
    # plain backend's (forward rtol 1e-4 / atol 2e-4; a point's census may
    # flip where its reward sits within that of 0.5)
    stride10 = waypoint_stride(path10, 0.5)
    _kernels.reset_launches()
    ev_k = opt.evaluate(cloud10, res_k.poses, res_k.quats_wxyz, wps_step=stride10)
    sync()
    ev_launches = {n: v for n, v in _kernels.LAUNCHES.items() if v}
    ev_t = TrajectoryOptimizer(lr_pose=0.1, lr_quat=0.02, backend="torch", device=dev).evaluate(
        cloud10, res_k.poses, res_k.quats_wxyz, wps_step=stride10)
    if ev_launches != {n: 1 for n in ("pass_a", "pass_b", *LOSS_FWD)}:
        fail(f"evaluate on cloud 10 launched {ev_launches}; expected K1, K2 and the loss's "
             f"forward kernels once each")
    off_half = [np.abs(r.astype(np.float64) - 0.5) for r in (ev_k.rewards, ev_t.rewards)]
    near_half = int(np.sum(np.any([(d > 0) & (d <= 2.5e-4) for d in off_half], axis=0)))
    if not (ev_k.rewards.shape == (len(cloud10),) and np.all(np.isfinite(ev_k.rewards))
            and abs(ev_k.n_observed - ev_t.n_observed) <= near_half
            and abs(ev_k.mean_reward - ev_t.mean_reward) <= 2e-4 + 1e-4 * abs(ev_t.mean_reward)):
        fail(f"evaluate on cloud 10: n_observed {ev_k.n_observed}, mean_reward "
             f"{ev_k.mean_reward:.7f}; plain {ev_t.n_observed}, {ev_t.mean_reward:.7f}")
    print(f"[slice] evaluate cloud10 (optimized path, wps_step {stride10}): n_observed "
          f"{ev_k.n_observed} of {len(cloud10)}, mean_reward {ev_k.mean_reward:.7f}, length "
          f"{ev_k.length:.4f}, mean_angle {ev_k.mean_angle:.4f}; backend=\"torch\": n_observed "
          f"{ev_t.n_observed}, mean_reward {ev_t.mean_reward:.7f}; launches {ev_launches}",
          flush=True)

    big = cases[1]
    res_big = opt.optimize(big_pts, big_path, n_steps=20)
    if not (np.all(np.isfinite(res_big.poses)) and np.isfinite(res_big.loss) and res_big.n_iters == 20):
        fail("1M x 50 run: non-finite result or wrong step count")
    print(f"[slice] 1M x 50 20 steps: loss {res_big.loss:.6f}, visibility gain "
          f"{res_big.visibility_gain:.4f}", flush=True)

    # 8m50: 8,388,608 points x 50 waypoints, over the score-cache budget.
    # The first forward of the run below (fused_lo_sum: K1' -> make_norm ->
    # K2') and K5 on its cotangent, against the kernels' plain versions in
    # chunks of 5 waypoints: min/max and K5's 40 sums are per waypoint and lo
    # is a sum over waypoints, so chunking is exact up to summation order.
    # (The plain autodiff path normalizes with a division: near the clip
    # ceiling, where d logit / d pn is ~1e6, its last-bit differences reach
    # 1e-3 in lo at this density.)
    pts8 = np.random.default_rng(8).uniform(-20, 20, size=(N_8M, 3)).astype(np.float32)
    c8 = shape_case("8m50", pts8, big_path)
    q8, t8, wp8, kp8, k8 = kernel_inputs(c8)
    P8, Pt8, V8 = c8["P"], c8["Pt"], c8["V"]
    W8, N8 = len(q8), P8.shape[0]
    cache_mib = W8 * N8 * 4 / 2**20
    if fv.uses_score_cache(W8, N8):
        fail(f"8m50 ({W8} x {N8}) fits the score cache: it must test the uncached regime")
    with torch.no_grad():
        lo8 = fv.fused_lo_sum(P8, q8, t8, K, intr.width, intr.height, valid=V8, points_t=Pt8)
        m8, mx8 = _kernels.pass_a_minmax(wp8, kp8, Pt8, V8, k8)
        norm8 = fv.make_norm(m8, mx8)
        # K1 is not on this shape's path (its cache is over the budget); it
        # runs once here so that K1′'s min and max are held against K1's and
        # K1's cache against the plain scores, below
        m8k, mx8k, cache8 = _kernels.pass_a(wp8, kp8, Pt8, V8, k8)
        same("8m50 K1' min against K1's", m8, m8k)
        same("8m50 K1' max against K1's", mx8, mx8k)
        again8 = _kernels.pass_a_minmax(wp8, kp8, Pt8, V8, k8)
        same("8m50 K1' min, second launch against the first", again8[0], m8)
        same("8m50 K1' max, second launch against the first", again8[1], mx8)
    g8 = criterion_cotangent(lo8, c8)
    acc8 = _kernels.bwd_fused_acc(wp8, kp8, norm8, Pt8, V8, g8, k8)
    lo8_r, acc8_r = torch.zeros_like(lo8), torch.empty_like(acc8)
    e8, sk8, pr8 = {}, [], []
    with torch.no_grad():
        for w0 in range(0, W8, 5):
            w = slice(w0, w0 + 5)
            wp_w = wp8[w].contiguous()
            # the pairs the kernels' skips leave, on the norm the kernels got
            sk8.append(skip_counts(fv.skip_masks(wp_w, kp8, norm8[w], Pt8, V8, k8)))
            pr8.append(prune_counts(fv.prune_masks(wp_w, kp8, Pt8, k8, m8[w], mx8[w]), V8))
            m_r, mx_r, s_r = fv.pass_a_ref(wp_w, kp8, Pt8, V8, k8)
            # K1 and K1': bit-equal to the plain pass A, as at the other shapes
            same(f"8m50 K1' min w{w0} against the plain version", m8[w], m_r)
            same(f"8m50 K1' max w{w0} against the plain version", mx8[w], mx_r)
            same(f"8m50 K1 cache w{w0} against the plain version", cache8[w], s_r)
            del s_r
            e8["pass_a_minmax"] = max(e8.get("pass_a_minmax", 0.0),
                                      close(f"8m50 K1' min w{w0}", m8[w], m_r, 1e-5, 1e-30),
                                      close(f"8m50 K1' max w{w0}", mx8[w], mx_r, 1e-5, 1e-30))
            norm_r = fv.make_norm(m_r, mx_r)
            lo8_r += fv.pass_b_recompute_ref(wp_w, kp8, norm_r, Pt8, k8)
            # the plain K5 ties on its own recompute (the plain K1′'s norm)
            acc8_r[w] = fv.bwd_fused_acc_ref(wp_w, kp8, norm_r, Pt8, V8, g8, k8)
    # K2' (through fused_lo_sum): rtol 1e-4 / atol 2e-4. K5: slots 0-37
    # rtol 2e-3 / atol 2e-3; tie counts equal the plain version's exactly.
    e8["pass_b_recompute"] = close("8m50 first forward vs chunked plain forward", lo8, lo8_r,
                                   1e-4, 2e-4)
    e8["bwd_fused_acc"] = close("8m50 K5 sums", acc8[:, :38], acc8_r[:, :38], 2e-3, 2e-3)
    if not torch.equal(acc8[:, 38:], acc8_r[:, 38:]):
        fail(f"8m50 K5 tie counts: {acc8[:, 38:].tolist()} vs plain {acc8_r[:, 38:].tolist()}")
    for n, e in e8.items():
        errs[n] = max(errs[n], e)
    skips["8m50"] = {key: sum(c[key] for c in sk8) for key in sk8[0]}
    prunes["8m50"] = {key: sum(c[key] for c in pr8) for key in pr8[0]}
    del lo8, lo8_r, acc8, acc8_r, cache8, m8k, mx8k, again8

    # 8m50 times, kernels only (a plain step there holds many (W, N)
    # tensors), taken while the problem is on the card; printed under [times]
    stage_ms["8m50"] = {
        "pass_a_minmax": cuda_ms(lambda: _kernels.pass_a_minmax(wp8, kp8, Pt8, V8, k8), 5),
        "pass_b_recompute": cuda_ms(lambda: _kernels.pass_b_recompute(wp8, kp8, norm8, Pt8, k8), 5),
        "bwd_fused_acc": cuda_ms(lambda: _kernels.bwd_fused_acc(wp8, kp8, norm8, Pt8, V8, g8, k8), 5),
    }
    step_ms, peak_mb, busy = {}, {}, {}
    prob8 = TrajProblem(intr.width, intr.height, wps_step=c8["stride"], backend="kernel")

    def loss8(p):
        return traj_forward(p, P8, K, c8["path"], c8["quats"], prob8, valid=V8, points_t=Pt8)

    q8_np = c8["quats"].cpu().numpy()
    key = ("8m50", "kernel")
    step_ms[key], peak_mb[key], busy[key] = step_times(
        loss8, init_traj_params(big_path, q8_np, dev), 5)
    del c8, P8, Pt8, V8, q8, t8, wp8, norm8, g8, m8, mx8
    torch.cuda.empty_cache()
    sync()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    res8 = opt.optimize(pts8, big_path, n_steps=20, quats_wxyz=q8_np)
    sync()
    slice8_s = time.perf_counter() - t0
    launches8 = dict(_kernels.LAUNCHES)
    peak8 = torch.cuda.max_memory_allocated() / 2**20
    peak8_reserved = torch.cuda.max_memory_reserved() / 2**20
    if not (all(launches8[n] > 0 for n in UNCACHED) and all(launches8[n] == 0 for n in CACHED)):
        fail(f"the 8m50 run did not run exactly K1', K2' and K5: {launches8}")
    if not (np.all(np.isfinite(res8.poses)) and np.isfinite(res8.loss) and res8.n_iters == 20
            and res8.rewards.shape == (N_8M,)):
        fail("8m50 run: non-finite or malformed result, or wrong step count")
    if not peak8 < cache_mib:
        fail(f"8m50 run: peak {peak8:.1f} MiB is not below a score cache's {cache_mib:.1f} MiB")
    print(f"[slice] 8m50 N={N8} W={W8} 20 steps in {slice8_s:.2f} s: loss {res8.loss:.6f}, "
          f"visibility gain {res8.visibility_gain:.4f}; first forward and K5 against chunked "
          f"plain versions, max|err| " + ", ".join(f"{n}={v:.2e}" for n, v in e8.items())
          + f", K1' and K1 bit-equal to the plain pass A, K5 tie counts equal; peak {peak8:.1f} MiB allocated, {peak8_reserved:.1f} reserved (a score cache alone: {cache_mib:.1f} MiB); launches "
          f"{launches8}; {prune_text(prunes['8m50'])}; {skip_text(skips['8m50'])}", flush=True)

    phase_done("slice")
    # ---- 4b. the trajectory loss's kernels around K1-K4 --------------------
    lk = loss_checks(dev, intr, cloud10, path10, sync, cuda_ms, kernel_device_ms)

    phase_done("loss")
    # ---- 5.-6. the render path: K6, K7 and the points processor ------------
    del res8
    torch.cuda.empty_cache()
    rend = render_checks(dev, intr, {"cloud10": cloud10, "8m": pts8}, cuda_ms, kernel_device_ms,
                         sync)

    phase_done("render")
    # ---- 7. the optimizer nodes, the pose optimizer, the voxel operations ---
    torch.cuda.empty_cache()
    nodes = node_checks(dev, {"cloud10": cloud10, "1m": big_pts, "8m": pts8}, path10, sync)
    del pts8

    phase_done("nodes")
    # ---- 8. hidden-point removal -------------------------------------------
    torch.cuda.empty_cache()
    hp = hpr_checks(dev, intr, cloud10, path10, sync, cuda_ms)

    phase_done("hpr")
    # ---- 9. the frozen-routing engine --------------------------------------
    torch.cuda.empty_cache()
    fr = frozen_checks(dev, intr, cloud10, path10, sync)

    phase_done("frozen")
    # ---- 10. the shell entry point -------------------------------------------
    torch.cuda.empty_cache()
    cl = cli_checks(dev, intr, cloud10, path10, sync)

    phase_done("cli")
    # ---- 11. the parallel layer ------------------------------------------------
    torch.cuda.empty_cache()
    pr = parallel_checks(dev, intr, sync)

    phase_done("parallel")
    # ---- 12. the captured optimization loop ------------------------------------
    torch.cuda.empty_cache()
    pts8 = np.random.default_rng(8).uniform(-20, 20, size=(N_8M, 3)).astype(np.float32)
    gr = graph_checks(dev, intr, {"ref": cloud10, "1m50": big_pts, "8m50": pts8,
                                  "cloud10": cloud10, "1m": big_pts},
                      {"ref": path10, "1m50": big_path, "8m50": big_path}, sync)
    del pts8

    phase_done("graphs")
    # ---- 13. times ---------------------------------------------------------
    for c in cases:
        n = 50 if c["name"] == "ref" else 10
        for backend in ("kernel", "torch"):
            prob = TrajProblem(intr.width, intr.height, wps_step=c["stride"], backend=backend)

            def loss_fn(p, c=c, prob=prob):
                return traj_forward(p, c["P"], K, c["path"], c["quats"], prob,
                                    valid=c["V"], points_t=c["Pt"])

            p0 = init_traj_params(c["path"].cpu().numpy(), c["quats"].cpu().numpy(), dev)
            key = (c["name"], backend)
            step_ms[key], peak_mb[key], busy[key] = step_times(loss_fn, p0, n)

    for c in cases:
        name = c["name"]
        print(f"[times] {card} | {name}: eager loop ms/step kernel {step_ms[(name, 'kernel')]:.4f} "
              f"plain {step_ms[(name, 'torch')]:.4f}; peak MiB kernel "
              f"{peak_mb[(name, 'kernel')]:.1f} plain {peak_mb[(name, 'torch')]:.1f}; stage ms "
              + ", ".join(f"{s} {a:.4f}/{b:.4f}" for s, (a, b) in stage_ms[name].items())
              + f" (kernel/plain); device, kernel: {busy_text(busy[(name, 'kernel')])}; "
              f"plain: {busy_text(busy[(name, 'torch')])}", flush=True)
    print(f"[times] {card} | 8m50: eager loop ms/step kernel {step_ms[('8m50', 'kernel')]:.4f}; peak MiB "
          f"kernel {peak_mb[('8m50', 'kernel')]:.1f} (optimize run {peak8:.1f}); stage ms "
          + ", ".join(f"{s} {a:.4f}" for s, a in stage_ms["8m50"].items())
          + f" (kernel); device, kernel: {busy_text(busy[('8m50', 'kernel')])}", flush=True)
    for n in ("pass_a", "pass_a_minmax"):
        parts = [f"{sh} {stage_ms[sh][n][0]:.4f} ms, bound "
                 + "{:.4f} by {}".format(*vis_bound(n, *shape_wn[sh], prunes=prunes[sh]))
                 for sh in ("ref", "1m50")]
        if n == "pass_a_minmax":
            parts.append(f"8m50 {stage_ms['8m50'][n]:.4f} ms, bound "
                         + "{:.4f} by {}".format(*vis_bound(n, W8, N8, prunes=prunes["8m50"])))
        parts += [f"{name} {d['ms'][n]:.4f} ms, bound "
                  + "{:.4f} by {}".format(*vis_bound(n, d["W"], d["N"], prunes=d["prunes"]))
                  for name, d in dense.items()]
        parts.append(f"1m50 with the points in Morton order {morton_ms[n]:.4f} ms")
        print(f"[times] {card} | {n} " + "; ".join(parts), flush=True)
    cached_bwd = {sh: {n: (stage_ms[sh][n][0], vis_bound(n, *shape_wn[sh], skips[sh]))
                       for n in ("bwd_stats", "bwd_apply")} for sh in ("ref", "1m50")}
    for name, d in dense.items():
        cached_bwd[name] = {n: (d["ms"][n], vis_bound(n, d["W"], d["N"], d["counts"]))
                            for n in ("bwd_stats", "bwd_apply")}
        shape_wn[name] = (d["W"], d["N"])
    for n in ("bwd_stats", "bwd_apply"):
        print(f"[times] {card} | {n} " + "; ".join(
            f"{sh} {v[n][0]:.4f} ms (the kernel alone "
            + ("not measured" if dev_ms[sh][n] is None else f"{dev_ms[sh][n]:.4f}")
            + f"), bound {v[n][1][0]:.4f} by {v[n][1][1]}" for sh, v in cached_bwd.items()),
            flush=True)
    # the pair against a yardstick that does not move with the design: one
    # read of the (W, N) score cache at the card's memory rate
    joint = {sh: (v["bwd_stats"][0] + v["bwd_apply"][0],
                  4 * shape_wn[sh][0] * shape_wn[sh][1] / HBM_BYTES_PER_MS)
             for sh, v in cached_bwd.items()}
    print(f"[times] {card} | K3 + K4 against one read of the score cache: " + "; ".join(
        f"{sh} {ms:.4f} ms, cache read {b:.4f} ms" for sh, (ms, b) in joint.items()), flush=True)
    for n in ("pass_b_recompute", "bwd_fused_acc"):
        b8 = vis_bound(n, W8, N8, skips["8m50"])
        bd = {name: vis_bound(n, d["W"], d["N"], d["counts"]) for name, d in dense.items()}
        print(f"[times] {card} | {n} 8m50 {stage_ms['8m50'][n]:.4f} ms, bound {b8[0]:.4f} by "
              f"{b8[1]}; "
              + ", ".join(f"{name} {d['ms'][n]:.4f} ms, bound {bd[name][0]:.4f} by {bd[name][1]}"
                          for name, d in dense.items())
              + f"; K1' on the same inputs: 8m50 {stage_ms['8m50']['pass_a_minmax']:.4f}, "
              + ", ".join(f"{name} {d['ms']['pass_a_minmax']:.4f}" for name, d in dense.items())
              + " ms", flush=True)

    def alone(key):
        ms = rend["kernel_ms"][key]
        return "not measured" if ms is None else f"{ms:.4f}"

    def share(key):
        ms = rend["kernel_ms"][key] or rend["ms"][key]
        return f"{100 * rend['bound'][key][0] / ms:.1f}%"

    for name in ("cloud10", "8m"):
        n_vis, n_pad = rend["visible"][name]
        print(f"[times] {card} | render {name} cam0 ({n_vis} visible, padded {n_pad}): "
              + ", ".join(
                  f"{k} {rend['ms'][(name, k)]:.4f} ms, the kernel alone {alone((name, k))} "
                  f"(first design {FIRST_SPLAT_MS[(name, k)]:.4f}; plain "
                  f"{rend['plain_ms'][(name, k)]:.4f}, "
                  f"bound {rend['bound'][(name, k)][0]:.4f} by {rend['bound'][(name, k)][1]}, "
                  f"{share((name, k))} of it: "
                  f"{rend['work'][(name, k)][0] / 1e6:.1f} MB, "
                  f"{rend['work'][(name, k)][1]} covered pairs)" for k in SPLAT)
              + "; prologue ms " + ", ".join(f"{b} {rend['prologue_ms'][(name, b)]:.4f}"
                                             for b in ("runs", "dense"))
              + f"; process_all {rend['rig_ms'][name]:.2f} ms/call (median of 3, 6 cameras), "
              f"peak {rend['peak_mib'][name]:.1f} MiB", flush=True)
        wall, busy_ms, top = rend["trace"][name]
        print(f"[times] {card} | rig {name}, one traced process_all: {wall:.2f} ms, device busy "
              + (f"{busy_ms:.3f} ms ({100 * busy_ms / wall:.1f}%)" if busy_ms is not None
                 else "not measured (no device activity in the trace)")
              + "; top host ops by self CPU ms: "
              + ", ".join(f"{k} {v:.2f}" for k, v in top), flush=True)

    wall, busy_ms, top = nodes["traj_trace"]
    print(f"[times] {card} | TrajOptNode (cloud 10, 30 steps): "
          + ", ".join(f"depth {d} {nodes['traj_msgs_per_s'][d]:.2f} msgs/s "
                      f"(last callback {nodes['traj_callback_ms'][d]:.2f} ms)" for d in (1, 2))
          + f"; one traced callback {wall:.2f} ms, device busy "
          + (f"{busy_ms:.3f} ms ({100 * busy_ms / wall:.1f}%)" if busy_ms is not None
             else "not measured (no device activity in the trace)")
          + "; top host ops by self CPU ms: " + ", ".join(f"{k} {v:.2f}" for k, v in top),
          flush=True)
    print(f"[times] {card} | PoseOptNode (cloud 10, 200 steps, 20 publishes): "
          + ", ".join(f"{v:.2f}" for v in nodes["pose_callback_ms"])
          + " ms per callback (two, after a first); "
          f"PoseOptimizer ms/step: " + ", ".join(
              f"{k} {v:.4f}" for k, v in nodes["pose_ms_per_step"].items())
          + f"; VoxelFilterNode (C++) on the 8m cloud at leaf 0.15: "
          f"{nodes['voxel_filter_ms_8m']:.1f} ms, {nodes['voxel_count_8m']} centroids",
          flush=True)

    print_hpr_times(card, hp)
    print_frozen_times(card, fr)
    print_cli_times(card, cl)
    print_parallel_times(card, pr)
    print_graph_times(card, gr)
    phase_done("times")
    print(f"[times] {card} | seconds per phase: "
          + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()), flush=True)

    def vis_entry(n):
        b_ref = vis_bound(n, *shape_wn["ref"], skips["ref"], prunes["ref"])
        b_1m = vis_bound(n, *shape_wn["1m50"], skips["1m50"], prunes["1m50"])
        e = {"name": n, "route": "cuda", "source": VIS_SOURCE, "replaces": REPLACES[n],
             "launches": (launches8 if n in UNCACHED else launches)[n], "max_abs_err": errs[n],
             "ms": stage_ms["ref"][n][0], "plain_ms": stage_ms["ref"][n][1],
             "bound_ms": b_ref[0], "bound_by": b_ref[1], "library_ms": None,
             "ms_1m50": stage_ms["1m50"][n][0], "plain_ms_1m50": stage_ms["1m50"][n][1],
             "bound_ms_1m50": b_1m[0], "bound_by_1m50": b_1m[1]}
        if n in UNCACHED:
            b_8 = vis_bound(n, W8, N8, skips["8m50"], prunes["8m50"])
            e.update(ms_8m50=stage_ms["8m50"][n], bound_ms_8m50=b_8[0], bound_by_8m50=b_8[1])
        if n in morton_ms:
            e["ms_1m50_morton"] = morton_ms[n]
        if n in ("pass_a", "bwd_stats", "bwd_apply", *UNCACHED):
            for name, d in dense.items():
                b = vis_bound(n, d["W"], d["N"], d["counts"], d["prunes"])
                e.update({f"ms_{name}": d["ms"][n], f"bound_ms_{name}": b[0],
                          f"bound_by_{name}": b[1]})
        return e

    def splat_entry(n):
        main, other = ("cloud10", "8m") if n == "splat_runs" else ("8m", "cloud10")
        return {"name": n, "route": "cuda", "source": SPLAT_SOURCE, "replaces": REPLACES[n],
                "launches": rend["launches"][main][n], "max_abs_err": rend["err"][n],
                "ms": rend["ms"][(main, n)], "plain_ms": rend["plain_ms"][(main, n)],
                "bound_ms": rend["bound"][(main, n)][0], "bound_by": rend["bound"][(main, n)][1],
                "library_ms": None, "kernel_alone_ms": rend["kernel_ms"][(main, n)],
                "registers": splat_regs[n][0], "resident_blocks_per_sm": resident[n],
                f"ms_{other}": rend["ms"][(other, n)],
                f"kernel_alone_ms_{other}": rend["kernel_ms"][(other, n)],
                f"plain_ms_{other}": rend["plain_ms"][(other, n)],
                f"bound_ms_{other}": rend["bound"][(other, n)][0]}

    def loss_entry(n):
        return {"name": n, "route": "cuda", "source": LOSS_SOURCE, "replaces": None,
                "launches": launches[n], "max_abs_err": lk["err"][n], "ms": lk["ms"][n],
                "kernel_alone_ms": lk["alone_ms"][n], "plain_ms": lk["plain_ms"][n],
                "bound_ms": lk["bound"][n][0], "bound_by": lk["bound"][n][1],
                "library_ms": None}

    record = {"kernels": [vis_entry(n) for n in VIS] + [splat_entry(n) for n in SPLAT]
              + [loss_entry(n) for n in LOSS],
              "loss_replay": lk["replay"],
              "step_ms": {f"{a}/{b}": v for (a, b), v in step_ms.items()},
              "peak_mib_8m50": peak8, "peak_reserved_mib_8m50": peak8_reserved,
              "cached_backward_ms": {sh: {"k3_plus_k4": ms, "cache_read_bound": b,
                                          "kernel_alone": dev_ms[sh]}
                                     for sh, (ms, b) in joint.items()},
              "rig_ms": rend["rig_ms"], "rig_peak_mib": rend["peak_mib"],
              "render_dropped_splats": rend["dropped"],
              "skip_counts": {**skips, **{name: d["counts"] for name, d in dense.items()}},
              "prune_counts": {**prunes, **{name: d["prunes"] for name, d in dense.items()}},
              "nodes": {"traj_msgs_per_s": nodes["traj_msgs_per_s"],
                        "traj_callback_ms": nodes["traj_callback_ms"],
                        "traj_traced_ms": nodes["traj_trace"][0],
                        "traj_device_busy_ms": nodes["traj_trace"][1],
                        "traj_vs_plain": nodes["traj_gap"],
                        "traj_step_parity": nodes["traj_steps"],
                        "pose_callback_ms": nodes["pose_callback_ms"],
                        "pose_ms_per_step": nodes["pose_ms_per_step"],
                        "pose_card_vs_cpu": nodes["pose_card_vs_cpu"],
                        "voxel_filter_ms_8m": nodes["voxel_filter_ms_8m"]},
              "hpr": hp, "frozen": fr, "parallel": pr, "graphs": gr, "phase_s": phase_s,
              "cli": {k: cl[k] for k in ("run_s", "startup_s", "msgs_per_s", "record")}}
    for e in record["kernels"]:
        nums = [v for k, v in e.items() if k.endswith("ms") or k == "max_abs_err"]
        if not all(isinstance(x, (int, float)) and math.isfinite(x) for x in nums if x is not None):
            fail(f"{e['name']}: non-finite measurement")
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
