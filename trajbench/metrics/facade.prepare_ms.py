"""facade.prepare_ms: host ms per request in the program's span
``trajopt.facade.prepare``: the float32 conversion, the padding, the
problem, the host-to-device tensors, the runner lookup and the initial
parameters of ``TrajectoryOptimizer.optimize``. Traced milliseconds, read
from the program's own traced stretch (``program_trace.py``): each launch
and copy call is slower under the profiler. Layer: the facade. Moves
``solve_ms.p50``. A program without the span reads nothing."""
import program_trace

SPAN = "trajopt.facade.prepare"


def read(ctx):
    pt = program_trace.stretch(ctx)
    if pt is None or not pt.n_requests or not any(s.name == SPAN for s in pt.spans):
        return None
    return pt.span_s(SPAN) * 1e3 / pt.n_requests
