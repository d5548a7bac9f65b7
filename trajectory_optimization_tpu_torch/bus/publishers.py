"""Function-level publish helpers (parity with `src/tools.py:199-317`).

Copy of ``trajectory_optimization_tpu/bus/publishers.py``.

The reference exposes free functions that construct and publish one message
each (publish_image / publish_odom / publish_pointcloud / publish_tf_pose /
publish_camera_info / to_pose_stamped / publish_pose / publish_path). These
are the same helpers against the scene bus — unlike the reference, they do
NOT create a fresh publisher per call (its noted inefficiency, SURVEY.md §1);
the bus holds topic state.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from trajectory_optimization_tpu_torch.bus.core import Bus
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


def publish_image(bus: Bus, img: np.ndarray, topic: str = "/image", *, frame_id: str = "camera_frame"):
    """Contrast-stretched uint8 image (reference `publish_image` + its
    percentile denormalize)."""
    from trajectory_optimization_tpu_torch.ops.render import denormalize_image

    img_u8 = np.uint8(255 * denormalize_image(img))
    bus.publish(topic, ImageMsg(Header.make(frame_id), img_u8, encoding="bgr8"))


def publish_odom(bus: Bus, pose, quat_xyzw, frame: str = "odom", topic: str = "/odom_0"):
    bus.publish(topic, OdometryMsg(Header.make(frame), np.asarray(pose), np.asarray(quat_xyzw)))


def publish_pointcloud(bus: Bus, points: np.ndarray, topic_name: str, stamp=None, frame_id: str = "world"):
    """(N,3) xyz or (N,4) xyz+intensity cloud (reference `publish_pointcloud`)."""
    bus.publish(topic_name, CloudMsg(Header.make(frame_id, stamp), np.asarray(points, np.float32)))


def publish_tf_pose(bus: Bus, pose, quat_xyzw, child_frame_id: str, frame_id: str = "world",
                    frames=None):
    """Broadcast a transform on /tf and optionally into a FrameGraph."""
    msg = TransformMsg(Header.make(frame_id), child_frame_id, np.asarray(pose), np.asarray(quat_xyzw))
    bus.publish("/tf", msg)
    if frames is not None:
        frames.set_transform(frame_id, child_frame_id, msg.translation, msg.rotation_xyzw)


def publish_camera_info(
    bus: Bus,
    image_width: int = 1232,
    image_height: int = 1616,
    K: Sequence[float] = (758.03967, 0.0, 621.46572, 0.0, 761.62359, 756.86402, 0.0, 0.0, 1.0),
    D: Sequence[float] = (-0.20571, 0.04103, -0.00101, 0.00098, 0.0),
    R: Sequence[float] = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0),
    P: Sequence[float] = (638.81494, 0.0, 625.98561, 0.0, 0.0, 585.79797, 748.57858, 0.0, 0.0, 0.0, 1.0, 0.0),
    topic_name: str = "/camera_info",
    frame_id: str = "camera_frame",
    distortion_model: str = "plumb_bob",
):
    """CameraInfo with the reference's default calibration rows."""
    bus.publish(
        topic_name,
        CameraInfoMsg(
            Header.make(frame_id), image_width, image_height,
            K=tuple(K), D=tuple(D), R=tuple(R), P=tuple(P),
            distortion_model=distortion_model,
        ),
    )


def to_pose_stamped(pose, quat_xyzw, stamp=None, frame_id: str = "world") -> PoseMsg:
    return PoseMsg(Header.make(frame_id, stamp), np.asarray(pose), np.asarray(quat_xyzw))


def publish_pose(bus: Bus, pose, quat_xyzw, topic_name: str, stamp=None, frame_id: str = "world"):
    bus.publish(topic_name, to_pose_stamped(pose, quat_xyzw, stamp, frame_id))


def publish_path(
    bus: Bus,
    path_list,
    orient_list: Optional[Sequence] = None,
    topic_name: str = "/path",
    frame_id: str = "world",
):
    """(W,3) positions + optional xyzw orientations (identity default,
    reference `publish_path`)."""
    positions = np.asarray(path_list, np.float64)
    if orient_list is None:
        orients = np.zeros((len(positions), 4))
        orients[:, 3] = 1.0
    else:
        orients = np.asarray(orient_list, np.float64)
    bus.publish(topic_name, PathMsg(Header.make(frame_id), positions, orients))
