"""Processing nodes on the scene bus.

Twin of ``trajectory_optimization_tpu/bus/nodes.py`` for the points
processor (`src/pc_processor.py`): per camera, transform the cloud into the
camera frame, hard frustum-cull it, publish the culled and the visible
subsets, and render the visible points with the tile splatter. Device work
runs on the node's ``device`` (default ``"cuda"``); the bus carries numpy
clouds and on-card images.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from trajectory_optimization_tpu_torch.bus.core import Bus
from trajectory_optimization_tpu_torch.bus.frames import FrameGraph
from trajectory_optimization_tpu_torch.bus.messages import (
    CameraInfoMsg,
    CloudMsg,
    Header,
    ImageMsg,
)
from trajectory_optimization_tpu_torch.ops.geometry import (
    compact_masked,
    frustum_cull,
    to_camera_frame,
)
from trajectory_optimization_tpu_torch.ops.tile_render import (
    RUN_PATH_MAX_ENTRIES,
    render_point_cloud_tiles,
)
from trajectory_optimization_tpu_torch.utils.config import PointsProcessorConfig
from trajectory_optimization_tpu_torch.utils.data import pad_points
from trajectory_optimization_tpu_torch.utils.profiling import Metrics


def _rig_cull_and_transform(pts, valid, Q, T, K, *, img_w, img_h, min_dist, max_dist):
    """The whole rig at once: (C, N) frustum masks and the (C, N, 3)
    camera-frame points of a bucket-padded (valid-masked) cloud. The masks
    are ``multicam_frustum_masks``'s (``frustum_cull`` over the camera
    axis), taken on the one transform both need: the JAX twin's jit merges
    its two transforms, eager PyTorch would not."""
    cam = to_camera_frame(pts, Q, T)
    masks = frustum_cull(cam, K, img_w, img_h, min_dist=min_dist, max_dist=max_dist)[0]
    return masks & (valid[None, :] > 0), cam


class PointsProcessorNode:
    """Multi-camera visibility processor (`src/pc_processor.py:30-197`).

    Only ``hpr_backend="none"`` is ported; the approximate and exact
    hidden-point-removal backends come with ``ops/hpr.py``.
    """

    def __init__(
        self,
        bus: Bus,
        cfg: PointsProcessorConfig,
        frames: Optional[FrameGraph] = None,
        device="cuda",
    ):
        if cfg.hpr_backend != "none":
            raise NotImplementedError(
                f"hpr_backend={cfg.hpr_backend!r} is not ported yet (ROADMAP.md Q1 item 9: "
                "ops/hpr.py); the port's PointsProcessorNode takes hpr_backend='none'"
            )
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
        visible = culled  # hpr_backend == "none"
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
        out = {}
        dropped = []  # device scalars; ONE batched fetch below
        for c, info in enumerate(infos):
            cam_frame = info.header.frame_id
            culled = culled_all[c]
            self.bus.publish(f"/{cam_frame}/pointcloud", CloudMsg(Header.make(cam_frame), culled))
            visible = culled  # hpr_backend == "none"
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
