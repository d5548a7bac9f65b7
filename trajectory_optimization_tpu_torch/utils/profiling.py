"""Profiling & metrics: step timers and ``torch.profiler`` integration.

Twin of ``trajectory_optimization_tpu/utils/profiling.py``. Replaces the
reference's ad-hoc ``time.time()`` debug prints scattered through forward
passes and loops (SURVEY.md §5: `src/model.py:100-120`,
`src/pose_optimization_sample.py:100-124`, ...). Provides:

  * :class:`StepTimer` — named span/step timing with a true device sync
    (:func:`device_sync`: ``torch.cuda.synchronize`` on the device of a CUDA
    tensor; the work behind a CPU tensor is done when it returns) and
    mean/percentile summaries;
  * :func:`trace` — context manager around ``torch.profiler`` (host and,
    with a card, CUDA activity), written as a TensorBoard trace;
  * :class:`Metrics` — counter/gauge sink the nodes report into (the
    reference's equivalent is rospy.loginfo + rviz inspection).
"""
from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    elif x is not None:
        yield x


def device_sync(x) -> None:
    """Force real completion of the device work feeding ``x`` (a tensor or a
    dict/list/tuple of them): ``torch.cuda.synchronize`` on the device of
    its first CUDA tensor."""
    import torch

    for leaf in _leaves(x):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


class StepTimer:
    """Accumulates wall-time samples per named span."""

    def __init__(self):
        self._samples: Dict[str, list] = collections.defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                device_sync(sync_on)
            self._samples[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self._samples.items():
            a = np.asarray(xs)
            out[name] = {
                "count": len(a),
                "mean_ms": float(a.mean() * 1000),
                "p50_ms": float(np.percentile(a, 50) * 1000),
                "p99_ms": float(np.percentile(a, 99) * 1000),
                "total_s": float(a.sum()),
            }
        return out

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:30s} n={s['count']:5d} mean={s['mean_ms']:8.3f}ms "
                f"p50={s['p50_ms']:8.3f}ms p99={s['p99_ms']:8.3f}ms"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` trace around a code block, host activity and, when
    a card is present, CUDA activity; written to ``log_dir`` (default
    ``trajopt_trace`` in the temporary directory) as a TensorBoard trace.
    Yields the directory."""
    import torch

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "trajopt_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield log_dir


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
