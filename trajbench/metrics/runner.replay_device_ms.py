"""runner.replay_device_ms: the captured step's own device time, ms per
replay: the union of the device intervals of the operations launched by
the graph launches made inside the program's span
``trajopt.runner.replays`` (joined to them by the profiler's correlation
id), over the number of those launches. In a cell of short requests, where
the eager first step, the final forward and the copies are a large share
of the device's work, it gives the replays' share alone: times the
replays per request, the device time the captured step takes of a
request. Read from the program's own traced stretch
(``program_trace.py``); a replayed node's device time is the card's,
traced or not. Layer: the trajectory step. Moves ``solve_ms.p50``. A
program without the span, or a trace without replayed work, reads
nothing."""
import program_trace
import tracing

SPAN = "trajopt.runner.replays"


def read(ctx):
    pt = program_trace.stretch(ctx)
    if pt is None:
        return None
    replays = [s for s in pt.spans if s.name == SPAN]

    def replayed(call):
        return (call is not None and call.name.split("_v")[0] in program_trace.GRAPH_LAUNCHES
                and any(s.start <= call.start <= s.end for s in replays))

    launches = {id(o.launch): o.launch for o in pt.ops if replayed(o.launch)}
    busy = tracing.union((o.start, o.end) for o in pt.ops if replayed(o.launch))
    if not launches or not busy:
        return None
    return sum(b - a for a, b in busy) * 1e3 / len(launches)
