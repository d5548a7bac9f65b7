"""Reduces a ``torch.profiler`` trace of a stretch of requests.

The stretch is the interval of the benchmark's own range ``STRETCH`` (host
clock, which CUPTI's device timestamps share). Device activity is every
event the profiler puts on the CUDA device: kernels, including those a
replayed graph launches, copies and sets. Host events are the CPU side's
operators and runtime calls. Nothing is written to disk.

The profiler stalls the host now and then to take a fresh activity buffer
from CUPTI or to flush one (its own host events ``PROFILER_OWN``); the
card idles meanwhile. Those gaps are the profiler's, not the program's:
``idle_gaps`` leaves them out.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

STRETCH = "trajbench.stretch"
REQUEST = "trajbench.request"
PROFILER_OWN = ("Activity Buffer Request", "Buffer Flush")


@dataclasses.dataclass
class Ev:
    name: str
    start: float  # seconds, host clock
    end: float


@dataclasses.dataclass
class Trace:
    device: List[Ev]  # device activity inside the stretch, clipped to it
    host: List[Ev]  # host events inside the stretch
    t0: float
    t1: float
    busy: List[Tuple[float, float]]  # union of the device intervals

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)


def _times(e) -> Tuple[float, float]:
    if hasattr(e, "start_ns"):
        s, d = e.start_ns(), e.duration_ns()
        return s * 1e-9, (s + d) * 1e-9
    s, d = e.start_us(), e.duration_us()
    return s * 1e-6, (s + d) * 1e-6


def union(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def collect(prof) -> Trace:
    """The stretch's events from a finished ``torch.profiler.profile``."""
    dev, host, stretch = [], [], None
    for e in prof.profiler.kineto_results.events():
        a, b = _times(e)
        if e.name() in (STRETCH, REQUEST) or getattr(e, "is_user_annotation", bool)():
            if e.name() == STRETCH and "cuda" not in str(e.device_type()).lower():
                stretch = (a, b)
            continue  # ranges, the benchmark's or the program's, are no device work
        if "cuda" in str(e.device_type()).lower():
            dev.append(Ev(e.name(), a, b))
        else:
            host.append(Ev(e.name(), a, b))
    if stretch is None:
        raise RuntimeError(f"the trace holds no {STRETCH} range")
    t0, t1 = stretch
    dev = [Ev(e.name, max(e.start, t0), min(e.end, t1)) for e in dev if e.end > t0 and e.start < t1]
    host = [e for e in host if e.end > t0 and e.start < t1]
    return Trace(dev, host, t0, t1, union((e.start, e.end) for e in dev))


def device_ops(tr: Trace, top: int = 10) -> List[list]:
    """[name, seconds] of the device operations that took most time."""
    tot: Dict[str, float] = {}
    for e in tr.device:
        tot[e.name] = tot.get(e.name, 0.0) + (e.end - e.start)
    return [[n[:160], s] for n, s in sorted(tot.items(), key=lambda x: -x[1])[:top]]


def gaps(tr: Trace) -> List[Tuple[float, float]]:
    """The stretch's device-idle intervals, in order."""
    out, last = [], tr.t0
    for a, b in tr.busy + [(tr.t1, tr.t1)]:
        if a > last:
            out.append((last, a))
        last = max(last, b)
    return out


def idle_gaps(tr: Trace, top: int = 10) -> List[list]:
    """[what the host was doing, seconds] of the longest device-idle gaps:
    the innermost host event that covers the gap's middle ("host: python"
    when none does, that is, the interpreter between operators). Gaps in
    which the host was in the profiler's own work are left out."""
    out = []
    for a, b in sorted(gaps(tr), key=lambda g: g[0] - g[1]):
        mid = 0.5 * (a + b)
        cover = [e for e in tr.host if e.start <= mid <= e.end]
        name = min(cover, key=lambda e: e.end - e.start).name if cover else "host: python"
        if name not in PROFILER_OWN:
            out.append([name[:160], b - a])
        if len(out) == top:
            break
    return out
