"""Program spans for ``torch.profiler``, and the nodes' counters.

* :func:`span` — a ``torch.profiler.record_function`` range while a
  profiler records on the calling thread, else one shared null context:
  one enabled-check and nothing more when nobody traces. There is no
  switch: tracing is on exactly when a caller runs ``torch.profiler``,
  and the spans then sit on the clock of its device events.
* The span names below, all prefixed ``trajopt.`` (``PREFIX``), so a
  trace tells the program's ranges from its caller's:

  - the facade (``api.TrajectoryOptimizer.optimize``,
    ``api.PoseOptimizer.optimize``): ``FACADE_OPTIMIZE`` around the whole
    call; inside it ``FACADE_PREPARE`` (padding, the problem, the
    host-to-device tensors, the runner lookup, the initial parameters)
    and ``FACADE_FETCH`` (everything after the runner returns: the host
    copies, which wait for the card, and the result);
  - the runners (``opt/runners.py``, ``opt/engine.drive_until_done``):
    ``RUNNER_LOAD`` (the bucket got or made, the data copied in, the
    loop's state reset), ``RUNNER_FIRST_STEP`` (the run's eager first
    step), ``RUNNER_REPLAYS`` (one span around the whole replay loop; a
    bucket's first run captures its step inside it) and
    ``RUNNER_FINAL_FORWARD`` (the eager final forward and the result's
    clones, on the CPU route too);
  - ``HPR_GATE`` around the whole soft occlusion gate of a camera
    (``ops.hpr.soft_hpr_gate``, either tier: norms, routing, sorts and
    searches, tiles and the row maxima), and inside it the soft-HPR and
    frozen-tile ranges (``ops.hpr.SOFT_DOMINANCE_RANGE``,
    ``SOFT_BINNED_RANGE``, ``models.traj_frozen.FROZEN_TILES_RANGE``).

  A replay runs no Python, so nothing inside a captured step's kernels is
  a span; the device trace names them.
* :class:`Metrics` — counter/gauge sink the nodes report into (the
  reference's equivalent is rospy.loginfo + rviz inspection).
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict

import torch

PREFIX = "trajopt."
FACADE_OPTIMIZE = "trajopt.facade.optimize"
FACADE_PREPARE = "trajopt.facade.prepare"
FACADE_FETCH = "trajopt.facade.fetch"
RUNNER_LOAD = "trajopt.runner.load"
RUNNER_FIRST_STEP = "trajopt.runner.first_step"
RUNNER_REPLAYS = "trajopt.runner.replays"
RUNNER_FINAL_FORWARD = "trajopt.runner.final_forward"
HPR_GATE = "trajopt.hpr.gate"

_NO_SPAN = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


def span(name: str):
    """A ``record_function(name)`` range while a profiler records on this
    thread, else a shared null context."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class Metrics:
    """Minimal counters/gauges for node observability."""

    def __init__(self):
        self.counters: Dict[str, float] = collections.defaultdict(float)
        self.gauges: Dict[str, float] = {}

    def incr(self, name: str, by: float = 1.0) -> None:
        self.counters[name] += by

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def snapshot(self) -> Dict[str, float]:
        return {**self.counters, **self.gauges}
