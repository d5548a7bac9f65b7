"""device.host_idle_ms.solve: device-idle ms per request in gaps the host
caused (``program_trace.idle_parts``: the call that launched the operation
ending the gap had not returned when the gap began) while the host was in a
facade span or one of the runner's eager spans. Gaps under
``trajopt.runner.replays`` are left out: under the profiler each graph
launch records every node and is slowed by about a millisecond, which the
untraced program does not pay; they show in the ``idle_spans`` line.
Traced milliseconds, read from the program's own traced stretch: the host
phases that leave these gaps run slower under the profiler, so the reading
is larger than the untraced idle. Layer: the device (H100). Moves
``solve_ms.p50``. A program without the spans, or a trace without device
work, reads nothing."""
import program_trace

SPANS = ("trajopt.facade.optimize", "trajopt.facade.prepare", "trajopt.facade.fetch",
         "trajopt.runner.load", "trajopt.runner.first_step", "trajopt.runner.final_forward")


def read(ctx):
    pt = program_trace.stretch(ctx)
    if pt is None or not pt.n_requests or not pt.ops or not pt.spans:
        return None
    idle = sum(s for name, cause, s, _ in program_trace.idle_parts(pt)
               if cause == "host" and name in SPANS)
    return idle * 1e3 / pt.n_requests
