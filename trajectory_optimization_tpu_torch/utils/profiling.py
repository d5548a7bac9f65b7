"""Node metrics: a counter/gauge sink.

Twin of ``Metrics`` in ``trajectory_optimization_tpu/utils/profiling.py``,
copied (that module is numpy only, but importing it imports the JAX
package). The step timer and the profiler trace are ported with the rest of
the node layer.
"""
from __future__ import annotations

import collections
from typing import Dict


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
