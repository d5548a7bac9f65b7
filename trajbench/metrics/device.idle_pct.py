"""device.idle_pct: share of a request's time in which no operation ran on
the card, %: 1 − the device-busy seconds per request of the traced stretch
over the median seconds of the window's untraced requests. The traced
requests themselves run slower than the rest (CUPTI's buffer requests and
its records of each node of a replayed graph stall the host), so their own
idle share would mostly be the profiler's; the card's busy time is not
slowed. Layer: the device (H100). Moves ``steps_s``."""


def read(ctx):
    if not ctx.trace.busy or not ctx.request_s or not ctx.n_requests:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.n_requests / ctx.request_s)
