"""trajectory_optimization_tpu_torch — the PyTorch/CUDA port of
``trajectory_optimization_tpu``.

Same layout as the JAX package, module for module: ``ops`` (quaternions,
geometry, scores, trajectory metrics, the fused visibility kernels K1–K5,
the multi-camera rig, the scatter renderer and the tile splat renderer
K6/K7, each kernel with its plain version, hidden-point removal),
``models`` (the trajectory, pose and waypoints models, the evaluation of a
fixed path, the notebook variants), ``opt`` (functional two-group Adam, early stop, cached runners),
``bus`` (messages, pub/sub, the frame graph and the points processor node),
``utils`` (intrinsics, configs, metrics, data padding, numpy conversion) and
``api`` (``TrajectoryOptimizer``, ``PoseOptimizer``, re-exported here
lazily, as the JAX package does). The CUDA sources live in ``csrc/`` and
are built on first use by ``ops._kernels``. Imports ``torch``, never
``jax``, and nothing of the JAX package.
"""

__version__ = "0.1.0"

from trajectory_optimization_tpu_torch.utils.intrinsics import CameraIntrinsics, default_intrinsics


def __getattr__(name):
    # lazy re-exports so `import trajectory_optimization_tpu_torch` stays light
    if name in ("TrajectoryOptimizer", "PoseOptimizer", "TrajResult", "PoseResult"):
        from trajectory_optimization_tpu_torch import api

        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CameraIntrinsics",
    "default_intrinsics",
    "TrajectoryOptimizer",
    "PoseOptimizer",
    "__version__",
]
