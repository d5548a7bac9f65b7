from trajectory_optimization_tpu_torch.bus.core import (
    ApproximateTimeSynchronizer,
    Bus,
    Subscription,
)
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
    bgr_to_rgb,
)
from trajectory_optimization_tpu_torch.bus.viewer import ViewerNode

__all__ = [
    "ViewerNode",
    "Bus",
    "Subscription",
    "ApproximateTimeSynchronizer",
    "FrameGraph",
    "Header",
    "CloudMsg",
    "PoseMsg",
    "PathMsg",
    "CameraInfoMsg",
    "OdometryMsg",
    "ImageMsg",
    "TransformMsg",
    "bgr_to_rgb",
]
