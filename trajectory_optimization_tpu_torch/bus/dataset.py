"""Extract the reference's npz dataset layout from a recorded session bag.

Copy of ``trajectory_optimization_tpu/bus/dataset.py``.

The reference ships its sample data as `data/points/point_cloud_{i}.npz`
(key ``pts``, (N, 3) float64) and `data/paths/path_poses_{i}.npz` (key
``poses``, (W, 3) float64) — see `reference/src/pc_publisher.py:26`,
`src/trajectory_optimization_sample.py:34-42` — produced from the 15 GB
session bag's `/final_cost_cloud` (99 msgs) and `/path` (99 msgs) topics
(`reference/launch/rosbag_info.txt`; indices 0-98 per
`README.md:19-21`). Only index 10 is checked into either repo; the rest
live behind a Google-Drive link. This module regenerates the WHOLE layout
from the bag itself, so a user holding the session recording never needs
the secondary download:

    python -m trajectory_optimization_tpu_torch extract session.bag data/

Extraction streams (`read_bag`) and rides the trailing chunk index: only
chunks containing wanted topics are read, so pulling 99 clouds + 99 paths
out of a 15 GB bag costs I/O proportional to those topics. Camera streams
can be dumped alongside as PNG frames (decoded by the from-spec JPEG/PNG
codecs) with their CameraInfo intrinsics as npz — everything a pose-
optimization run needs (`reference/src/pc_processor.py:33-39`).
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["ExtractResult", "extract_dataset"]

# the reference's own topic choices (src/trajectory_optimization.py:27,162)
DEFAULT_CLOUD_TOPIC = "/final_cost_cloud"
DEFAULT_PATH_TOPIC = "/path"


@dataclasses.dataclass
class ExtractResult:
    """What `extract_dataset` wrote, by absolute path."""

    clouds: List[str]
    paths: List[str]
    images: Dict[str, List[str]]  # topic -> frame files
    camera_infos: Dict[str, str]  # topic -> intrinsics npz
    skipped_images: int = 0  # compressed frames the codecs could not decode

    @property
    def n_files(self) -> int:
        return (len(self.clouds) + len(self.paths) + len(self.camera_infos)
                + sum(len(v) for v in self.images.values()))


def _slug(topic: str) -> str:
    """Filesystem-safe name for a topic (camera dirs)."""
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", topic.strip("/")) or "topic"


def extract_dataset(
    bag_path: str,
    out_dir: str,
    *,
    cloud_topic: str = DEFAULT_CLOUD_TOPIC,
    path_topic: str = DEFAULT_PATH_TOPIC,
    image_topics: Sequence[str] = (),
    camera_info_topics: Sequence[str] = (),
    indices: Optional[Sequence[int]] = None,
    start_index: int = 0,
) -> ExtractResult:
    """Write the reference dataset layout out of a session bag.

    Per message #i (0-based arrival order per topic, offset by
    ``start_index`` in the file names):

    - ``cloud_topic`` -> ``<out>/points/point_cloud_{i}.npz`` (``pts``:
      finite xyz rows, float64 — the reference schema exactly; intensity
      columns are dropped, NaN/inf rows stripped like the reference's
      loaders expect).
    - ``path_topic`` -> ``<out>/paths/path_poses_{i}.npz`` (``poses``:
      (W, 3) float64 waypoint positions).
    - each of ``image_topics`` -> ``<out>/images/<topic>/frame_{i}.png``
      (decoded pixels re-packed losslessly by `bus.png`; compressed frames
      the from-spec codecs cannot decode are counted in
      ``skipped_images``, never written as garbage).
    - each of ``camera_info_topics`` -> ``<out>/images/<topic>/
      camera_info.npz`` (``K`` (3, 3) float64, ``width``, ``height``,
      ``D`` — enough to rebuild `utils.intrinsics.CameraIntrinsics`);
      only the first message is written (the rig is static in the
      reference session).

    ``indices`` restricts extraction to those per-topic arrival indices
    (e.g. ``[10]`` reproduces the in-repo sample pair); the scan stops
    early once every wanted topic has delivered its last wanted index.
    Returns an :class:`ExtractResult` of written files.
    """
    from trajectory_optimization_tpu_torch.bus.messages import (
        CameraInfoMsg,
        CloudMsg,
        ImageMsg,
        PathMsg,
        bgr_to_rgb,
        host_image,
    )
    from trajectory_optimization_tpu_torch.bus.rosbag import read_bag

    want = None if indices is None else {int(i) for i in indices}
    if want is not None and not want:
        raise ValueError("indices must be non-empty when given")
    last_wanted = max(want) if want is not None else None

    topics: List[str] = []
    if cloud_topic:
        topics.append(cloud_topic)
    if path_topic:
        topics.append(path_topic)
    topics += list(image_topics) + list(camera_info_topics)
    if not topics:
        raise ValueError("nothing to extract: every topic is disabled")
    image_set = set(image_topics)
    caminfo_set = set(camera_info_topics)

    res = ExtractResult(clouds=[], paths=[], images={t: [] for t in image_set},
                        camera_infos={})
    seen: Dict[str, int] = {}
    # topics that still owe us a wanted index (for the early stop)
    pending = set(topics)

    def _take(topic: str) -> Optional[int]:
        """Arrival index if this message should be written, else None."""
        i = seen.get(topic, 0)
        seen[topic] = i + 1
        if want is not None:
            if i not in want:
                if last_wanted is not None and i >= last_wanted:
                    pending.discard(topic)
                return None
            if i == last_wanted:
                pending.discard(topic)
        return i + start_index

    points_dir = os.path.join(out_dir, "points")
    paths_dir = os.path.join(out_dir, "paths")
    images_dir = os.path.join(out_dir, "images")

    for _t, topic, msg in read_bag(bag_path, topics=topics):
        if topic == cloud_topic and isinstance(msg, CloudMsg):
            i = _take(topic)
            if i is not None:
                xyz = np.asarray(msg.xyz, np.float64)
                xyz = xyz[np.isfinite(xyz).all(axis=1)]
                os.makedirs(points_dir, exist_ok=True)
                f = os.path.join(points_dir, f"point_cloud_{i}.npz")
                np.savez(f, pts=xyz)
                res.clouds.append(f)
        elif topic == path_topic and isinstance(msg, PathMsg):
            i = _take(topic)
            if i is not None:
                os.makedirs(paths_dir, exist_ok=True)
                f = os.path.join(paths_dir, f"path_poses_{i}.npz")
                np.savez(f, poses=np.asarray(msg.positions, np.float64))
                res.paths.append(f)
        elif topic in image_set and isinstance(msg, ImageMsg):
            i = _take(topic)
            if i is not None:
                img = host_image(msg.data)  # host copy of a CUDA payload
                if img.ndim == 1:
                    # undecodable compressed passthrough (lossless /
                    # arithmetic JPEG): no pixels to write
                    res.skipped_images += 1
                    continue
                from trajectory_optimization_tpu_torch.bus.png import encode_png

                # decoded compressed streams are always rgb8, but raw
                # sensor_msgs/Image topics may carry bgr8 (the cv/ROS
                # default) — PNG is true colour order, so swap
                img = bgr_to_rgb(img, msg.encoding)
                d = os.path.join(images_dir, _slug(topic))
                os.makedirs(d, exist_ok=True)
                f = os.path.join(d, f"frame_{i:05d}.png")
                with open(f, "wb") as fh:
                    fh.write(encode_png(img))
                res.images[topic].append(f)
        elif topic in caminfo_set and isinstance(msg, CameraInfoMsg):
            if topic in res.camera_infos:
                pending.discard(topic)
                continue
            d = os.path.join(images_dir, _slug(topic))
            os.makedirs(d, exist_ok=True)
            f = os.path.join(d, "camera_info.npz")
            np.savez(
                f,
                K=np.asarray(msg.K, np.float64).reshape(3, 3),
                width=np.int64(msg.width),
                height=np.int64(msg.height),
                D=np.asarray(msg.D, np.float64),
            )
            res.camera_infos[topic] = f
            pending.discard(topic)
        if want is not None and not pending:
            break  # every topic delivered its last wanted index
    return res
