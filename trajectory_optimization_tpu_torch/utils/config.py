"""Node configs: dataclasses with the reference's defaults.

Twin of ``trajectory_optimization_tpu/utils/config.py``, copied field for
field for the nodes the port has so far (the points processor).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class PointsProcessorConfig:
    """`src/pc_processor.py:30-53` + pointcloud_processor.launch."""

    pc_topic: str = "/final_cost_cloud"
    cam_info_topics: Tuple[str, ...] = ("/viz/camera_0/camera_info",)
    frustum_min_dist: float = 1.0
    frustum_max_dist: float = 15.0
    hpr_backend: str = "approx"  # 'exact' (Qhull) | 'approx' | 'none'
    render: bool = True
    # TransformListener role: the node's FrameGraph ingests these topics
    tf_topics: Tuple[str, ...] = ("/tf", "/tf_static")
