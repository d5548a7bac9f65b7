"""facade.memcpy_ms: device time of the copies a request makes (host to
device, device to host, device to device), ms per request. Layer: the
facade (``api.TrajectoryOptimizer``: the padded cloud and path in, the
results out). Moves ``solve_ms.p50``."""

COPY_PREFIX = "Memcpy"


def read(ctx):
    copies = [e for e in ctx.trace.device if e.name.startswith(COPY_PREFIX)]
    if not copies or not ctx.n_requests:
        return None
    return sum(e.end - e.start for e in copies) * 1e3 / ctx.n_requests
