"""The parallel layer: the point axis, and optionally the waypoint axis, of
every optimizer across ranks of ``torch.distributed`` (one rank per device
of a ('wps', 'pts') mesh; ``parallel.mesh`` gives the layout and the
gradient convention). Twin of ``trajectory_optimization_tpu/parallel``."""
from trajectory_optimization_tpu_torch.parallel.mesh import make_mesh, points_sharding, replicated
from trajectory_optimization_tpu_torch.parallel.sharded import (
    make_sharded_train_step,
    shard_points,
    shardmap_visibility,
)
from trajectory_optimization_tpu_torch.parallel.sharded_pallas import sharded_fused_lo_sum
from trajectory_optimization_tpu_torch.parallel.hpr_sharded import (
    hpr_mask_soft_binned_sharded,
)
from trajectory_optimization_tpu_torch.parallel.pose_sharded import (
    make_sharded_pose_step,
    pose_loss_sharded,
)
from trajectory_optimization_tpu_torch.parallel.traj_sharded import (
    make_sharded_traj_step,
    traj_soft_hpr_loss_sharded,
)
from trajectory_optimization_tpu_torch.parallel.traj_frozen_sharded import (
    FrozenShardedTrajOptimizer,
    build_frozen_sharded_plan,
    make_frozen_sharded_traj_step,
    traj_frozen_loss_sharded,
)
from trajectory_optimization_tpu_torch.parallel.wps_sharded import (
    make_sharded_wps_step,
    wps_loss_sharded,
)

__all__ = [
    "FrozenShardedTrajOptimizer",
    "build_frozen_sharded_plan",
    "make_frozen_sharded_traj_step",
    "traj_frozen_loss_sharded",
    "make_sharded_pose_step",
    "pose_loss_sharded",
    "make_sharded_traj_step",
    "traj_soft_hpr_loss_sharded",
    "make_sharded_wps_step",
    "wps_loss_sharded",
    "make_mesh",
    "points_sharding",
    "replicated",
    "make_sharded_train_step",
    "shard_points",
    "shardmap_visibility",
    "sharded_fused_lo_sum",
    "hpr_mask_soft_binned_sharded",
]
