from trajectory_optimization_tpu_torch.ops import quat
from trajectory_optimization_tpu_torch.ops.geometry import (
    to_camera_frame,
    dist_mask,
    fov_mask,
    visibility,
    frustum_cull,
)
from trajectory_optimization_tpu_torch.ops.trajectory import (
    polyline_length,
    mean_segment_angle,
    menger_curvature,
)

__all__ = [
    "quat",
    "to_camera_frame",
    "dist_mask",
    "fov_mask",
    "visibility",
    "frustum_cull",
    "polyline_length",
    "mean_segment_angle",
    "menger_curvature",
]
