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
``api`` (``TrajectoryOptimizer``). The CUDA sources live in ``csrc/`` and
are built on first use by ``ops._kernels``. Imports ``torch``, never
``jax``, and nothing of the JAX package.
"""

__version__ = "0.1.0"
