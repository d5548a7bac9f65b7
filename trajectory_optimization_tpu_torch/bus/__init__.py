from trajectory_optimization_tpu_torch.bus.core import Bus, Subscription
from trajectory_optimization_tpu_torch.bus.frames import FrameGraph
from trajectory_optimization_tpu_torch.bus.messages import (
    CameraInfoMsg,
    CloudMsg,
    Header,
    ImageMsg,
    TransformMsg,
)

__all__ = [
    "Bus",
    "Subscription",
    "FrameGraph",
    "Header",
    "CloudMsg",
    "CameraInfoMsg",
    "ImageMsg",
    "TransformMsg",
]
