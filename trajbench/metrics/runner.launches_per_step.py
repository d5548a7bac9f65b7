"""runner.launches_per_step: host calls that launch work on the card (kernel
launches and graph launches, through the runtime or the driver API) per
Adam step. Layer: the captured loop (``opt/runners.py``, ``opt/graphs.py``):
a replayed step is one graph launch, an eager step hundreds of kernel
launches. Moves ``solve_ms.p50``."""

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch", "cudaLaunchCooperativeKernel")


def read(ctx):
    n = sum(1 for e in ctx.trace.host if e.name.split("_v")[0] in LAUNCH_CALLS)
    if not n or not ctx.n_steps:
        return None
    return n / ctx.n_steps
