"""vis.kernel_ms: device time per Adam step of every kernel of the
visibility family, found by the names below: the score-cache trio K1-K4
and the uncached K1', K2', K5 of ``csrc/fused_vis.cu``. Layer: the vis
kernels (``ops/fused_vis.py`` + ``csrc/fused_vis.cu``). Moves ``steps_s``.
A cell whose steps launch none of them reads nothing."""

import re

# K1 and K1' are one template (pass_a_kernel<true>, <false>); K2, K3, K4, K2', K5
KERNELS = ("pass_a_kernel", "pass_b_kernel", "bwd_stats_kernel", "bwd_apply_kernel",
           "pass_b_recompute_kernel", "bwd_fused_kernel")
_NAME = re.compile(r"\b(" + "|".join(KERNELS) + r")\b")


def kernel_seconds(ctx) -> float:
    return sum(e.end - e.start for e in ctx.trace.device if _NAME.search(e.name))


def read(ctx):
    s = kernel_seconds(ctx)
    if s <= 0 or not ctx.n_steps:
        return None
    return s * 1e3 / ctx.n_steps
