"""trajectory_optimization_tpu_torch — the PyTorch/CUDA port of
``trajectory_optimization_tpu``.

Same layout as the JAX package, module for module: ``ops`` (quaternions,
scores, trajectory metrics, the fused visibility kernels K1–K4 and their
plain versions), ``models`` (the trajectory model), ``opt`` (functional
two-group Adam, early stop, cached runners), ``utils`` (intrinsics, data
padding, numpy conversion) and ``api`` (``TrajectoryOptimizer``). The CUDA
sources live in ``csrc/`` and are built on first use by ``ops._kernels``.
Imports ``torch``, never ``jax``.
"""

__version__ = "0.1.0"
