from trajectory_optimization_tpu_torch.utils.intrinsics import CameraIntrinsics, default_intrinsics
from trajectory_optimization_tpu_torch.utils.data import (
    load_point_cloud,
    load_path,
    pad_points,
    bucket_size,
)

__all__ = [
    "CameraIntrinsics",
    "default_intrinsics",
    "load_point_cloud",
    "load_path",
    "pad_points",
    "bucket_size",
]
