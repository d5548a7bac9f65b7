"""runner.host_ms: host ms per request in the runner's eager phases, the
program's spans ``trajopt.runner.load`` (the bucket, the data copied in,
the loop reset), ``trajopt.runner.first_step`` (the eager first step) and
``trajopt.runner.final_forward`` (the eager final forward and the clones):
what the runner pays outside its replays. Traced milliseconds, read from
the program's own traced stretch (``program_trace.py``): these phases are
kernel launches, each 10–45 µs under the profiler, so the reading is
1.5–1.7 times the untraced host time (an H100, cloud10.node30). Layer: the captured loop. Moves
``solve_ms.p50``. A program without the spans reads nothing."""
import program_trace

SPANS = ("trajopt.runner.load", "trajopt.runner.first_step", "trajopt.runner.final_forward")


def read(ctx):
    pt = program_trace.stretch(ctx)
    if pt is None or not pt.n_requests or not any(s.name in SPANS for s in pt.spans):
        return None
    return pt.span_s(*SPANS) * 1e3 / pt.n_requests
