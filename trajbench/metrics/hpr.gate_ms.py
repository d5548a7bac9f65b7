"""hpr.gate_ms: device ms per request of the operations launched under the
program's span ``trajopt.hpr.gate`` (``ops/hpr.soft_hpr_gate``: the whole
soft occlusion gate of one camera, its norms, routing, sorts and searches,
tiles and row maxima) inside ``trajopt.runner.final_forward``: one forward
of the gate over every scored waypoint, in the eager phase every request
runs once. A replayed step runs no Python and carries no span, so the
gate's share of the replays is not seen here; the final forward's gate is
the same operations as a step's forward, without the backward. Read from
the program's own traced stretch (``program_trace.py``), the operations
joined to their launching calls by correlation id; a kernel's device time
is the card's, traced or not. Layer: the HPR gate. Moves
``solve_ms.p50``. A program without the span reads nothing."""
import bisect

import program_trace
import tracing

GATE = "trajopt.hpr.gate"
PHASE = "trajopt.runner.final_forward"


def launched_under(pt, name: str, phase: str = PHASE) -> list:
    """The stretch's device operations whose launching call started inside
    a span ``name`` that lies inside a span ``phase``."""
    phases = [s for s in pt.spans if s.name == phase]
    inner = sorted((s.start, s.end) for s in pt.spans if s.name == name
                   and any(p.start <= s.start and s.end <= p.end for p in phases))
    starts = [a for a, _ in inner]

    def under(call) -> bool:
        if call is None:
            return False
        i = bisect.bisect_right(starts, call.start) - 1
        return i >= 0 and call.start <= inner[i][1]

    return [o for o in pt.ops if under(o.launch)] if inner else []


def device_seconds(ops) -> float:
    return sum(b - a for a, b in tracing.union((o.start, o.end) for o in ops))


def read(ctx):
    pt = program_trace.stretch(ctx)
    if pt is None or not pt.n_requests:
        return None
    s = device_seconds(launched_under(pt, GATE))
    if s <= 0:
        return None
    return s * 1e3 / pt.n_requests
