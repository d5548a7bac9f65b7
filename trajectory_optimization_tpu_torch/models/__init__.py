from trajectory_optimization_tpu_torch.models.pose import PoseProblem, pose_forward, init_pose_params
from trajectory_optimization_tpu_torch.models.traj import (
    TrajProblem,
    traj_forward,
    init_traj_params,
    waypoint_stride,
)
from trajectory_optimization_tpu_torch.models.evaluate import TrajEvalResult, evaluate_trajectory
from trajectory_optimization_tpu_torch.models.traj_frozen import (
    FrozenPlanConfig,
    FrozenPoseOptimizer,
    FrozenTrajOptimizer,
    FrozenWpsOptimizer,
)
from trajectory_optimization_tpu_torch.models.wps_opt import (
    WpsOptProblem,
    init_wps_params,
    optimize_waypoints,
    wps_forward,
    wps_path,
)

__all__ = [
    "FrozenPlanConfig",
    "FrozenPoseOptimizer",
    "FrozenTrajOptimizer",
    "FrozenWpsOptimizer",
    "PoseProblem",
    "pose_forward",
    "init_pose_params",
    "TrajProblem",
    "traj_forward",
    "init_traj_params",
    "waypoint_stride",
    "TrajEvalResult",
    "evaluate_trajectory",
    "WpsOptProblem",
    "init_wps_params",
    "optimize_waypoints",
    "wps_forward",
    "wps_path",
]
