from trajectory_optimization_tpu_torch.opt.engine import (
    OptimizerConfig,
    make_optimizer,
    exponential_every,
    optimize,
    optimize_with_history,
)

__all__ = [
    "OptimizerConfig",
    "make_optimizer",
    "exponential_every",
    "optimize",
    "optimize_with_history",
]
