"""Drives ``TrajectoryOptimizer.optimize``, the facade users call.

One request is one ``optimize(points, path, n_steps=...)`` call with numpy
inputs, as a user makes it: the configuration's cloud and a rigidly moved
copy of its path, early stop off, so every request takes exactly
``steps_per_request`` Adam steps.

What decides ``correct`` (``check``), for each sampled request, once the
window has closed:

* the final forward: the reference evaluates its plain forward, in
  float64, at the parameters the program returned, on the request's own
  cloud and path, and compares the program's rewards, loss and gains;
* the window's own solve: the reference solves the request itself, in
  float64, from the same initial path and for as many steps, and the
  program's visibility gain is compared with its own, by the mean of the
  signed gaps over the sample. Over a whole request the optimization is
  chaotic (float32 rounding alone moves a 30-step result by centimetres
  and a 400-step one into another basin), so one request's gain lands a
  percent or so either side of the reference's; the mean over the sample
  stays near 0. A runner that leaves its state unchanged, or takes fewer
  steps than it reports, falls short on every request (an unchanged state
  reads a gain of 1, about a tenth below the reference's);
* the steps, followed from the program's own state, where they are not
  chaotic: from the returned parameters the program takes
  ``follow_steps`` more steps through the same facade (a warm start: its
  eager first step and replays of a captured step) and the reference
  takes them in float64; the positions and orientations that come out are
  compared, each by the median waypoint. The median, because Adam's first
  step from fresh moments moves a coordinate by about the learning rate
  whatever its gradient's size: a coordinate whose gradient is smaller
  than float32's error on its sum steps the other way in any float32
  program, and its waypoint parts from the float64 reference by degrees
  or centimetres. A fault of the steps, or a lower precision, parts them
  all;
* the step count, exactly.

Every number but the solve's is the worst sampled request's.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

import inputs


class Cell:
    """One configuration under one traffic mix, on ``device``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str, registry,
                 phase=lambda name: None, system: bool = True):
        """``system=False`` draws the inputs and loads the reference only,
        without importing the program (the control runs so)."""
        self.ref = registry.reference(cfg["reference"])
        self.settings = self.ref.Settings.from_config(cfg)
        self.device = device
        self.n_steps = int(traffic["steps_per_request"])
        self.follow_steps = int(traffic["follow_steps"])
        self.notes: List[str] = []  # lines for standard error
        self.opt = self._system(cfg) if system else None
        phase("import")
        self.points = inputs.cloud(cfg["cloud"], seed, registry.root)
        base = inputs.path(cfg["path"], registry.root)
        self.paths = inputs.moved_paths(base, traffic["moves"], seed)
        step = self.ref.stride(base, self.settings.vis_wps_dist)
        for p in self.paths:
            if self.ref.stride(p, self.settings.vis_wps_dist) != step:
                raise RuntimeError("a moved path changed the waypoint stride")
        self.n_scored = len(range(0, len(base), step))
        phase("inputs")

    def _system(self, cfg: dict):
        from trajectory_optimization_tpu_torch.api import TrajectoryOptimizer
        from trajectory_optimization_tpu_torch.utils.intrinsics import CameraIntrinsics

        cam, s = cfg["camera"], cfg["settings"]
        return TrajectoryOptimizer(
            CameraIntrinsics(fx=cam["fx"], fy=cam["fy"], cx=cam["cx"], cy=cam["cy"],
                             width=cam["width"], height=cam["height"]),
            min_dist=s["min_dist"], max_dist=s["max_dist"],
            smoothness_weight=s["smoothness_weight"], length_weight=s["length_weight"],
            lr_pose=s["lr_pose"], lr_quat=s["lr_quat"], vis_wps_dist=s["vis_wps_dist"],
            backend=s["backend"], soft_hpr=s["soft_hpr"], device=self.device)

    def path(self, i: int) -> np.ndarray:
        return self.paths[i % len(self.paths)]

    def warm(self) -> None:
        """Two of the window's calls, at its own shape and step count: the
        first captures the bucket, the second runs as every later one does."""
        for i in range(2):
            self.opt.optimize(self.points, self.path(-1 - i), n_steps=self.n_steps)
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def request(self, i: int):
        return self.opt.optimize(self.points, self.path(i), n_steps=self.n_steps)

    def follow(self, i: int, res) -> Tuple[np.ndarray, np.ndarray]:
        """``follow_steps`` more steps of the program from ``res``."""
        out = self.opt.optimize(
            self.points, self.path(i), n_steps=self.follow_steps,
            warm_start={"poses": res.poses.astype(np.float32),
                        "quats": res.quats_wxyz.astype(np.float32)})
        return out.poses, out.quats_wxyz

    def free(self) -> None:
        """Drop the program's runners, buckets and graphs."""
        from trajectory_optimization_tpu_torch.opt.runners import traj_runner

        traj_runner.cache_clear()
        self.opt = None

    def check(self, sample: List[Tuple[int, object, tuple]], device: str) -> Dict[str, float]:
        """The numbers compared, over ``sample``: a list of (request index,
        its result, the positions and orientations ``follow`` reached from
        it); ``solve_vis_gain`` is the sample's mean, the others the worst
        request's. ``notes`` gets what a solve that left its state
        unchanged would read."""
        ref, st = self.ref, self.settings
        keys = ("rewards", "loss", "gains", "solve_vis_gain", "follow_pose_med_m",
                "follow_quat_med_deg", "steps")
        worst = dict.fromkeys(keys, 0.0)
        signed, unchanged = [], []

        def up(key, value):
            value = float(value)
            if not np.isnan(worst[key]) and (np.isnan(value) or value > worst[key]):
                worst[key] = value  # a NaN, once read, stays

        for i, res, (f_pose, f_quat) in sample:
            path0 = self.path(i)
            if (res.poses.shape != path0.shape or res.quats_wxyz.shape != (len(path0), 4)
                    or res.rewards.shape != (len(self.points),)):
                for key in keys:
                    up(key, float("nan"))
                continue
            ev = ref.evaluate(self.points, path0, res.poses, res.quats_wxyz, st, device=device)
            up("rewards", np.max(np.abs(np.asarray(res.rewards, np.float64) - ev["rewards"])))
            up("loss", abs(res.loss - ev["loss"]) / abs(ev["loss"]))
            up("gains", max(abs(res.visibility_gain / ev["visibility_gain"] - 1.0),
                            abs(res.smoothness_gain / ev["smoothness_gain"] - 1.0)))
            up("steps", abs(int(res.n_iters) - self.n_steps))
            whole = ref.solve(self.points, path0, self.n_steps, st, device=device)
            signed.append(res.visibility_gain / whole.visibility_gain - 1.0)
            unchanged.append(abs(1.0 / whole.visibility_gain - 1.0))
            start = (res.poses.astype(np.float32), res.quats_wxyz.astype(np.float32))
            fr = ref.solve(self.points, path0, self.follow_steps, st, device=device, start=start)
            # by the median waypoint: positions of all, orientations of the
            # scored ones (the others' have no gradient and stay put)
            up("follow_pose_med_m",
               np.median(np.linalg.norm(np.asarray(f_pose) - fr.poses, axis=1)))
            scored = slice(None, None, ref.stride(path0, st.vis_wps_dist))
            up("follow_quat_med_deg",
               np.median(quat_angle_deg(np.asarray(f_quat)[scored], fr.quats_wxyz[scored])))
        if signed:
            up("solve_vis_gain", abs(np.mean(signed)))
            self.notes.append(f"solve_vis_gain signed by request {signed!r}; a state left "
                              f"unchanged would read {float(np.mean(unchanged))!r}")
        return worst


def quat_angle_deg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation angle between quaternions, degrees, per row: 4·atan2(‖a − b‖,
    ‖a + b‖) of the unit quaternions with b's sign turned to a's, which
    stays exact near 0 where an arccos of the dot product does not."""
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    b = b * np.where(np.sum(a * b, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    return np.degrees(4.0 * np.arctan2(np.linalg.norm(a - b, axis=-1),
                                       np.linalg.norm(a + b, axis=-1)))
