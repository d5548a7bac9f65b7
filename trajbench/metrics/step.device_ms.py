"""step.device_ms: the union of the intervals in which the card ran an
operation, over the stretch, per Adam step (eager first steps, replays,
final forwards and the requests' copies included), ms. Layer: the
trajectory step (``models/traj.py`` and its ops). Moves ``steps_s``."""


def read(ctx):
    if not ctx.trace.busy or not ctx.n_steps:
        return None
    return ctx.trace.busy_s * 1e3 / ctx.n_steps
