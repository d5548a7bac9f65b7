"""Processing nodes on the scene bus.

Twin of ``trajectory_optimization_tpu/bus/nodes.py``; each node mirrors one
reference process:

  * :class:`TrajOptNode` — `src/trajectory_optimization.py`: pair (cloud,
    path), optimize the trajectory with early stopping, publish the
    optimized path (and optionally the rewards cloud).
  * :class:`PoseOptNode` — `src/pose_optimization.py`: pair (cloud, pose),
    optimize one camera pose, publishing odometry, TF, camera info and a
    rewards cloud about ``num_pub_samples`` times during the loop.
  * :class:`PointsProcessorNode` — `src/pc_processor.py`: per camera,
    transform the cloud into the camera frame, hard frustum-cull it, publish
    the culled and the visible subsets, and render the visible points with
    the tile splatter.
  * :class:`CloudFeederNode` / :class:`PoseFeederNode` — `src/pc_publisher.py`
    / `src/pose_publisher.py`: replay npz clouds / (random) poses; host only.
  * :class:`VoxelFilterNode` — the PCL VoxelGrid nodelet's role
    (`launch/voxels_filtering.launch`), on the native C++ library.

Device work runs on the node's ``device`` (default ``"cuda"``); the bus
carries numpy clouds, paths and poses, and on-card images. The HPR options
(``use_hpr``, ``use_soft_hpr``, ``hpr_backend``) run through ``ops/hpr.py``;
soft HPR takes the dense tier up to ``soft_hpr_dense_max`` points and the
direction-binned tier above it.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from trajectory_optimization_tpu_torch.bus.core import ApproximateTimeSynchronizer, Bus
from trajectory_optimization_tpu_torch.bus.frames import FrameGraph
from trajectory_optimization_tpu_torch.bus.messages import (
    CameraInfoMsg,
    CloudMsg,
    Header,
    ImageMsg,
    OdometryMsg,
    PathMsg,
    PoseMsg,
    TransformMsg,
)
from trajectory_optimization_tpu_torch.models.pose import PoseProblem, init_pose_params
from trajectory_optimization_tpu_torch.models.traj import (
    TrajProblem,
    init_traj_params,
    waypoint_stride,
)
from trajectory_optimization_tpu_torch.ops.geometry import (
    compact_masked,
    frustum_cull,
    to_camera_frame,
)
from trajectory_optimization_tpu_torch.ops.hpr import hpr_mask_approx, hpr_points_exact
from trajectory_optimization_tpu_torch.ops.tile_render import (
    RUN_PATH_MAX_ENTRIES,
    render_point_cloud_tiles,
)
from trajectory_optimization_tpu_torch.opt.engine import EarlyStop, OptimizerConfig
from trajectory_optimization_tpu_torch.opt.runners import pose_runner, traj_runner
from trajectory_optimization_tpu_torch.utils.config import (
    CloudFeederConfig,
    PointsProcessorConfig,
    PoseFeederConfig,
    PoseOptNodeConfig,
    TrajOptNodeConfig,
    VoxelFilterConfig,
)
from trajectory_optimization_tpu_torch.utils.data import bucket_size, pad_points
from trajectory_optimization_tpu_torch.utils.intrinsics import CameraIntrinsics, default_intrinsics
from trajectory_optimization_tpu_torch.utils.profiling import Metrics


def _to_host_async(t: torch.Tensor):
    """Start the copy of a 1-D tensor to the host: (host tensor, event) with
    a CUDA tensor copied into pinned memory and an event recorded after the
    copy on the current stream; (t, None) for a CPU tensor. Read the host
    tensor only after ``event.synchronize()``."""
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _host_numpy(pending) -> np.ndarray:
    host, done = pending
    if done is not None:
        done.synchronize()
    return host.numpy()


class TrajOptNode:
    """Trajectory optimizer node (`src/trajectory_optimization.py:25-158`)."""

    def __init__(
        self,
        bus: Bus,
        cfg: TrajOptNodeConfig,
        intrinsics: Optional[CameraIntrinsics] = None,
        device="cuda",
    ):
        self.bus = bus
        self.cfg = cfg
        self.intr = intrinsics or default_intrinsics()
        self.device = torch.device(device)
        self.last_result: Optional[Dict] = None
        self.metrics = Metrics()  # callbacks, iters, per-callback ms — the
        # reference's per-step prints (`src/trajectory_optimization.py:126`)
        self._pending = []  # in-flight (dispatched, not yet published) results
        self._sync = ApproximateTimeSynchronizer(
            bus, [cfg.pc_topic, cfg.path_topic], self.callback, queue_size=10, slop=0.5
        )

    def callback(self, pc_msg: CloudMsg, path_msg: PathMsg) -> None:
        """Dispatch this pair's optimization, then publish finished results.

        With cfg.pipeline_depth == 1 (default, the reference's synchronous
        semantics) each callback publishes its own result before returning.
        Depth d > 1 keeps up to d-1 messages in flight: each result is copied
        to pinned host memory without blocking, behind one CUDA event, so
        message i's device work and copy overlap the host work of message
        i+1. Outputs then lag their inputs by up to d-1 messages; call
        flush() to drain. The messages published are the same at any depth.
        """
        self._pending.append(self._dispatch(pc_msg, path_msg))
        while len(self._pending) >= max(int(self.cfg.pipeline_depth), 1):
            self._finish(self._pending.pop(0))

    def flush(self) -> None:
        """Publish every in-flight result (pipeline_depth > 1)."""
        while self._pending:
            self._finish(self._pending.pop(0))

    def _dispatch(self, pc_msg: CloudMsg, path_msg: PathMsg):
        _t0 = time.perf_counter()
        cfg = self.cfg
        dev = self.device
        points, valid = pad_points(pc_msg.xyz.astype(np.float32))
        poses0 = path_msg.positions.astype(np.float32)
        quats0 = path_msg.orientations_wxyz.astype(np.float32)

        problem = TrajProblem(
            img_width=self.intr.width,
            img_height=self.intr.height,
            min_dist=cfg.min_dist,
            max_dist=cfg.max_dist,
            smoothness_weight=cfg.smooth_weight,
            length_weight=cfg.length_weight,
            wps_step=waypoint_stride(poses0, cfg.vis_wps_dist),
            soft_hpr=cfg.use_soft_hpr,
        )
        run = traj_runner(
            problem,
            OptimizerConfig(lr_pose=cfg.lr_pose, lr_quat=cfg.lr_quat),
            EarlyStop(rewards_th=cfg.rewards_th, smoothness_th=cfg.smoothness_th),
            cfg.opt_steps,
        )
        params, n_iters, loss, aux = run(
            init_traj_params(poses0, quats0, dev),
            torch.as_tensor(points, device=dev),
            torch.as_tensor(valid, device=dev),
            self.intr.matrix(device=dev),
            torch.as_tensor(poses0, device=dev),
            torch.as_tensor(quats0, device=dev),
        )
        # every result in one flat f32 tensor, one device-to-host copy
        leaves = [params["poses"].reshape(-1), params["quats"].reshape(-1), loss.reshape(1),
                  aux["mean_reward"].reshape(1), n_iters.to(torch.float32).reshape(1)]
        if cfg.publish_rewards_cloud:
            leaves.append(aux["rewards"])
        fetch = _to_host_async(torch.cat(leaves))
        # the dispatch-side cost, taken now: under pipelining this result may
        # wait across messages, and wall time from _t0 at _finish would
        # measure message cadence, not work
        return fetch, pc_msg, path_msg, (time.perf_counter() - _t0) * 1e3

    def _finish(self, pending) -> None:
        fetch, pc_msg, path_msg, dispatch_ms = pending
        _t1 = time.perf_counter()
        cfg = self.cfg
        f = _host_numpy(fetch)
        W = len(path_msg.positions)
        loss, mean_reward, n_iters = float(f[7 * W]), float(f[7 * W + 1]), int(f[7 * W + 2])

        # optimized path out, wxyz → xyzw with normalization
        # (`src/trajectory_optimization.py:141-145`)
        poses_out = f[: 3 * W].reshape(W, 3).astype(np.float64)
        quats = f[3 * W: 7 * W].reshape(W, 4).astype(np.float64)
        quats = quats / np.linalg.norm(quats, axis=1, keepdims=True)
        quats_xyzw = np.concatenate([quats[:, 1:], quats[:, :1]], axis=1)
        self.bus.publish(
            cfg.path_topic + "/optimized",
            PathMsg(Header.make(path_msg.header.frame_id), poses_out, quats_xyzw),
        )

        if cfg.publish_rewards_cloud:
            rewards = f[7 * W + 3: 7 * W + 3 + len(pc_msg.xyz)]
            cloud = np.concatenate([pc_msg.xyz, rewards[:, None]], axis=1)
            self.bus.publish(
                cfg.pc_topic + "/rewards",
                CloudMsg(Header.make(pc_msg.header.frame_id), cloud),
            )

        self.last_result = {"n_iters": n_iters, "loss": loss, "mean_reward": mean_reward}
        self.metrics.incr("callbacks")
        self.metrics.incr("opt_iters", n_iters)
        # dispatch cost + finish cost, EXCLUDING any pipelined queue wait
        self.metrics.gauge(
            "last_callback_ms", dispatch_ms + (time.perf_counter() - _t1) * 1e3
        )
        self.metrics.gauge("last_loss", loss)
        self.metrics.gauge("last_mean_reward", mean_reward)

    def close(self):
        self.flush()
        self._sync.close()


class PoseOptNode:
    """Single-pose optimizer node (`src/pose_optimization.py:31-147`)."""

    def __init__(
        self,
        bus: Bus,
        cfg: PoseOptNodeConfig,
        intrinsics: Optional[CameraIntrinsics] = None,
        device="cuda",
    ):
        self.bus = bus
        self.cfg = cfg
        self.intr = intrinsics or default_intrinsics()
        self.device = torch.device(device)
        self.frames = FrameGraph()
        self.last_result: Optional[Dict] = None
        self.metrics = Metrics()  # reference prints step ms, `src/pose_optimization.py:145`
        self._sync = ApproximateTimeSynchronizer(
            bus, [cfg.pc_topic, cfg.pose_topic], self.callback, queue_size=10, slop=0.5
        )

    def callback(self, pc_msg: CloudMsg, pose_msg: PoseMsg) -> None:
        _t0 = time.perf_counter()
        cfg = self.cfg
        dev = self.device
        points, valid = pad_points(pc_msg.xyz.astype(np.float32))
        problem = PoseProblem(
            img_width=self.intr.width,
            img_height=self.intr.height,
            min_dist=cfg.min_dist,
            max_dist=cfg.max_dist,
            soft_hpr=cfg.use_soft_hpr,
        )
        P = torch.as_tensor(points, device=dev)
        V = torch.as_tensor(valid, device=dev)
        K = self.intr.matrix(device=dev)
        # the reference recomputes HPR on detached world points every step
        # (`src/model.py:112-115`), a constant: once here, on the
        # bucket-padded cloud (valid-masked)
        occlusion = hpr_mask_approx(P, valid=V) if cfg.use_hpr else None

        seg = max(cfg.opt_steps // cfg.num_pub_samples, 1)
        opt_cfg = OptimizerConfig(lr_pose=cfg.lr_pose, lr_quat=cfg.lr_quat)
        init_opt, advance = pose_runner(problem, opt_cfg, seg)
        params = init_pose_params(
            pose_msg.position.astype(np.float32)[None],
            pose_msg.orientation_wxyz.astype(np.float32)[None],
            dev,
        )
        opt_state = init_opt(params)
        loss = torch.tensor(float("inf"))
        done = 0
        # Enqueue every segment first, starting each one's device-to-host
        # copy as it is enqueued; the publishes below then wait only for the
        # copies, instead of stalling the device once per publish.
        pend = []

        def _enqueue(params, aux):
            leaves = [params["trans"].reshape(3), params["quat"].reshape(4)]
            if cfg.publish_rewards_cloud:
                leaves.append(aux["observations"])
            pend.append(_to_host_async(torch.cat(leaves)))

        while done + seg <= cfg.opt_steps:
            params, opt_state, loss, aux = advance(params, opt_state, P, V, K, occlusion)
            done += seg
            _enqueue(params, aux)
        if done < cfg.opt_steps:  # exact step-count parity for the remainder
            _, advance_rem = pose_runner(problem, opt_cfg, cfg.opt_steps - done)
            params, opt_state, loss, aux = advance_rem(params, opt_state, P, V, K, occlusion)
            done = cfg.opt_steps
            _enqueue(params, aux)
        for fetch in pend:
            self._publish(pc_msg, pose_msg, _host_numpy(fetch))
        loss_f = float(loss)
        self.last_result = {"loss": loss_f, "n_iters": done}
        self.metrics.incr("callbacks")
        self.metrics.incr("opt_iters", done)
        self.metrics.gauge("last_callback_ms", (time.perf_counter() - _t0) * 1e3)
        self.metrics.gauge("last_loss", loss_f)

    def _publish(self, pc_msg, pose_msg, f):
        # odometry + TF + camera info (`src/pose_optimization.py:99-112`)
        trans = f[:3].astype(np.float64)
        q = f[3:7].astype(np.float64)
        q = q / np.linalg.norm(q)
        q_xyzw = np.array([q[1], q[2], q[3], q[0]])
        frame = pose_msg.header.frame_id
        self.bus.publish("/odom", OdometryMsg(Header.make(frame), trans, q_xyzw))
        self.frames.set_transform(frame, "camera_frame", trans, q_xyzw)
        self.bus.publish(
            "/tf", TransformMsg(Header.make(frame), "camera_frame", trans, q_xyzw)
        )
        self.bus.publish(
            "/camera/camera_info",
            CameraInfoMsg(
                Header.make("camera_frame"),
                int(self.intr.width),
                int(self.intr.height),
                K=tuple(self.intr.matrix_np(np.float64).reshape(-1)),
                D=tuple(self.intr.distortion),
            ),
        )
        if self.cfg.publish_rewards_cloud:
            obs = f[7: 7 + len(pc_msg.xyz)]
            cloud = np.concatenate([pc_msg.xyz, obs[:, None]], axis=1)
            self.bus.publish(
                self.cfg.pc_topic + "/rewards",
                CloudMsg(Header.make(pc_msg.header.frame_id), cloud),
            )

    def close(self):
        self._sync.close()


def _rig_cull_and_transform(pts, valid, Q, T, K, *, img_w, img_h, min_dist, max_dist):
    """The whole rig at once: (C, N) frustum masks and the (C, N, 3)
    camera-frame points of a bucket-padded (valid-masked) cloud. The masks
    are ``multicam_frustum_masks``'s (``frustum_cull`` over the camera
    axis), taken on the one transform both need: the JAX twin's jit merges
    its two transforms, eager PyTorch would not."""
    cam = to_camera_frame(pts, Q, T)
    masks = frustum_cull(cam, K, img_w, img_h, min_dist=min_dist, max_dist=max_dist)[0]
    return masks & (valid[None, :] > 0), cam


def _hpr_masks_rig(culled_list, device) -> list:
    """Approx-HPR masks for a whole rig in one batched pursuit: every
    camera's culled subset padded to one bucket (valid-masked, as the JAX
    twin pads it), a leading camera axis, and one device-to-host copy of the
    (C, bucket) masks. One camera's is the JAX twin's
    ``_hpr_mask_bucketed``."""
    sizes = [len(c) for c in culled_list]
    if max(sizes, default=0) == 0:
        return [np.zeros(0, bool) for _ in culled_list]
    bucket = bucket_size(max(sizes))
    padded, valids = zip(*(pad_points(c.astype(np.float32), target=bucket)
                           for c in culled_list))
    masks = hpr_mask_approx(torch.as_tensor(np.stack(padded), device=device),
                            valid=torch.as_tensor(np.stack(valids), device=device))
    masks = masks.cpu().numpy()
    return [masks[i, : sizes[i]] > 0.5 for i in range(len(culled_list))]


class PointsProcessorNode:
    """Multi-camera visibility processor (`src/pc_processor.py:30-197`).

    ``hpr_backend`` picks the visible subset of each camera's culled points:
    ``"approx"`` (the default: ``hpr_mask_approx`` on the node's device,
    one batched pursuit per rig), ``"exact"`` (Qhull on the host) or
    ``"none"`` (every culled point).
    """

    def __init__(
        self,
        bus: Bus,
        cfg: PointsProcessorConfig,
        frames: Optional[FrameGraph] = None,
        device="cuda",
    ):
        self.bus = bus
        self.cfg = cfg
        self.device = torch.device(device)
        self.frames = frames or FrameGraph()
        self._cloud: Optional[CloudMsg] = None
        self._pending: Dict[str, CameraInfoMsg] = {}  # topic → info since cloud
        self.metrics = Metrics()
        self.n_batched = 0  # fused rig evaluations (observability/tests)
        self.n_serial = 0
        self.frames.listen(bus, cfg.tf_topics)  # tf.TransformListener role
        bus.subscribe(cfg.pc_topic, self._pc_callback)
        for t in cfg.cam_info_topics:
            bus.subscribe(t, self._make_info_cb(t))

    def _pc_callback(self, msg: CloudMsg):
        # flush a partial rig against the outgoing cloud so a dead camera
        # topic can only delay processing by one cloud period
        if self._cloud is not None and self._pending:
            self._flush()
        self._cloud = msg
        self._pending = {}

    def _make_info_cb(self, topic: str):
        def cb(info: CameraInfoMsg):
            if self._cloud is None:
                return
            if len(self.cfg.cam_info_topics) == 1:
                self.n_serial += 1
                self.process(self._cloud, info)
                return
            self._pending[topic] = info
            if len(self._pending) == len(self.cfg.cam_info_topics):
                self._flush()

        return cb

    def _flush(self):
        """Process the collected rig infos against the current cloud: one
        batched evaluation when the rig shares intrinsics, serial per-camera
        otherwise."""
        infos = [self._pending[t] for t in self.cfg.cam_info_topics if t in self._pending]
        self._pending = {}
        if not infos:
            return
        keys = {(i.K, i.width, i.height) for i in infos}
        _t0 = time.perf_counter()
        if len(infos) > 1 and len(keys) == 1:
            self.n_batched += 1
            self.metrics.incr("rig_batched")
            self.process_all(self._cloud, infos)
        else:
            self.n_serial += len(infos)
            self.metrics.incr("rig_serial", len(infos))
            for info in infos:
                self.process(self._cloud, info)
        self.metrics.gauge("last_rig_ms", (time.perf_counter() - _t0) * 1e3)

    def process(self, cloud: CloudMsg, info: CameraInfoMsg):
        """One camera: returns its visible points (numpy)."""
        cam_frame = info.header.frame_id
        intr = info.intrinsics()
        # cloud frame → camera frame through the frame graph (float64, host)
        cam_pts = self.frames.transform_points(
            cloud.xyz.astype(np.float64), cam_frame, cloud.header.frame_id
        ).astype(np.float32)

        mask, _, _ = frustum_cull(
            torch.as_tensor(cam_pts, device=self.device),
            intr.matrix(device=self.device),
            intr.width,
            intr.height,
            min_dist=self.cfg.frustum_min_dist,
            max_dist=self.cfg.frustum_max_dist,
        )
        culled = compact_masked(cam_pts, mask)
        out_topic = f"/{cam_frame}/pointcloud"
        self.bus.publish(out_topic, CloudMsg(Header.make(cam_frame), culled))
        if self.cfg.hpr_backend == "exact":
            visible, _ = hpr_points_exact(culled)
        elif self.cfg.hpr_backend == "approx":
            visible = culled[_hpr_masks_rig([culled], self.device)[0]]
        else:
            visible = culled
        self.bus.publish(out_topic + "_visible", CloudMsg(Header.make(cam_frame), visible))

        if self.cfg.render and len(visible):
            n_dropped = self._render(visible, intr, cam_frame)
            if n_dropped is not None:
                self.metrics.incr("render_dropped_splats", float(n_dropped))
        return visible

    def _render(self, visible, intr, cam_frame):
        """Render and publish; returns the dropped-splat count as a device
        scalar when the dense path ran (callers batch the fetch), None when
        the render is exact (the run path).

        The input is bucket-padded (valid-masked) as in the JAX twin, whose
        compile cache keys on bucket sizes; here the padded count also
        decides the path, as there. The image is published on the device,
        not copied to the host: consumers that need pixels pay the copy.
        """
        padded, pvalid = pad_points(np.asarray(visible, np.float32))
        exact = len(padded) <= RUN_PATH_MAX_ENTRIES  # the run path cannot drop
        out = render_point_cloud_tiles(
            torch.as_tensor(padded, device=self.device),
            intr.matrix(device=self.device),
            int(intr.height),
            int(intr.width),
            znear=self.cfg.frustum_min_dist,
            zfar=self.cfg.frustum_max_dist,
            valid=torch.as_tensor(pvalid, device=self.device),
            return_overflow=not exact,
        )
        img, n_dropped = (out, None) if exact else out
        self.bus.publish(
            f"/{cam_frame}/pointcloud_image",
            ImageMsg(Header.make(cam_frame), img, encoding="rgb32f"),
        )
        return n_dropped

    def process_all(self, cloud: CloudMsg, infos):
        """Batched multi-camera processing: one evaluation for all cameras
        sharing intrinsics. Returns {cam_frame: visible_points}."""
        infos = list(infos)
        intr = infos[0].intrinsics()
        dev = self.device
        # camera poses in the cloud frame, from the frame graph
        quats, trans = [], []
        for info in infos:
            t, q_xyzw = self.frames.lookup(cloud.header.frame_id, info.header.frame_id)
            trans.append(t)
            quats.append([q_xyzw[3], q_xyzw[0], q_xyzw[1], q_xyzw[2]])  # wxyz
        n = len(cloud.xyz)
        padded, valid = pad_points(cloud.xyz.astype(np.float32))
        masks, cam_pts = _rig_cull_and_transform(
            torch.as_tensor(padded, device=dev),
            torch.as_tensor(valid, device=dev),
            torch.as_tensor(np.asarray(quats, np.float32), device=dev),
            torch.as_tensor(np.asarray(trans, np.float32), device=dev),
            intr.matrix(device=dev),
            img_w=float(intr.width),
            img_h=float(intr.height),
            min_dist=self.cfg.frustum_min_dist,
            max_dist=self.cfg.frustum_max_dist,
        )
        # ONE device→host transfer of the rig's masks and camera-frame points
        host = torch.cat([cam_pts, masks[..., None].to(cam_pts.dtype)], dim=-1).cpu().numpy()
        culled_all = [
            compact_masked(host[c, :n, :3], host[c, :n, 3] > 0) for c in range(len(infos))
        ]
        if self.cfg.hpr_backend == "approx":
            hpr_masks = _hpr_masks_rig(culled_all, dev)  # one batched HPR for the rig
        out = {}
        dropped = []  # device scalars; ONE batched fetch below
        for c, info in enumerate(infos):
            cam_frame = info.header.frame_id
            culled = culled_all[c]
            self.bus.publish(f"/{cam_frame}/pointcloud", CloudMsg(Header.make(cam_frame), culled))
            if self.cfg.hpr_backend == "exact":
                visible, _ = hpr_points_exact(culled)
            elif self.cfg.hpr_backend == "approx" and len(culled):
                visible = culled[hpr_masks[c]]
            else:
                visible = culled
            self.bus.publish(
                f"/{cam_frame}/pointcloud_visible", CloudMsg(Header.make(cam_frame), visible)
            )
            if self.cfg.render and len(visible):
                n_dropped = self._render(visible, intr, cam_frame)
                if n_dropped is not None:
                    dropped.append(n_dropped)
            out[cam_frame] = visible
        if dropped:
            self.metrics.incr("render_dropped_splats", float(torch.stack(dropped).sum()))
        return out


class CloudFeederNode:
    """npz cloud replay (`src/pc_publisher.py`). Call tick() at the configured
    rate, or drive it by hand in tests."""

    def __init__(self, bus: Bus, cfg: CloudFeederConfig, rng: Optional[np.random.Generator] = None):
        self.bus = bus
        self.cfg = cfg
        self.rng = rng or np.random.default_rng()

    def tick(self):
        from trajectory_optimization_tpu_torch.utils.data import load_point_cloud

        idx = self.cfg.pc_index
        if idx == -1:
            idx = int(self.rng.integers(0, 30))
        path = os.path.join(self.cfg.data_dir, f"point_cloud_{idx}.npz")
        pts = load_point_cloud(path)
        self.bus.publish(self.cfg.output_topic, CloudMsg(Header.make(self.cfg.frame_id), pts))


class PoseFeederNode:
    """Random-or-fixed pose feeder (`src/pose_publisher.py`)."""

    def __init__(self, bus: Bus, cfg: PoseFeederConfig, rng: Optional[np.random.Generator] = None):
        self.bus = bus
        self.cfg = cfg
        self.rng = rng or np.random.default_rng()

    def tick(self):
        # host-only math: a device call here would stamp this message late on
        # first use (device initialization), breaking its pairing
        from trajectory_optimization_tpu_torch.ops.quat import from_euler_np

        c = self.cfg
        pos = np.array(
            [
                c.x if c.x is not None else self.rng.random() * 5 + 15,
                c.y if c.y is not None else self.rng.random() * 5 + 15,
                c.z if c.z is not None else self.rng.random() * 2,
            ]
        )
        rpy = [
            c.roll if c.roll is not None else self.rng.random() * np.pi,
            c.pitch if c.pitch is not None else self.rng.random() * np.pi,
            c.yaw if c.yaw is not None else self.rng.random() * np.pi,
        ]
        q_wxyz = from_euler_np(*rpy)
        q_xyzw = np.concatenate([q_wxyz[1:], q_wxyz[:1]])
        self.bus.publish(
            c.output_topic, PoseMsg(Header.make(c.frame_id), pos, q_xyzw)
        )


class VoxelFilterNode:
    """Voxel-grid downsampling filter (the PCL VoxelGrid nodelet's role,
    `launch/voxels_filtering.launch:8-21`). Uses the native C++ filter when
    built, numpy otherwise."""

    def __init__(self, bus: Bus, cfg: VoxelFilterConfig):
        self.bus = bus
        self.cfg = cfg
        bus.subscribe(cfg.input_topic, self.callback)

    def callback(self, msg: CloudMsg):
        from trajectory_optimization_tpu_torch.native import voxel_downsample_native

        out = voxel_downsample_native(
            msg.points, self.cfg.leaf_size, z_limits=self.cfg.z_limits
        )
        self.bus.publish(self.cfg.output_topic, CloudMsg(msg.header, out))
