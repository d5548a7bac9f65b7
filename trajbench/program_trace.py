"""The program's own spans, for the per-layer metrics that read them.

The port marks the phases of a call with ``torch.profiler`` ranges named
``trajopt.*`` (its ``utils/profiling.py``). The harness's trace
(``tracing.collect``) keeps device work and host events and leaves every
range out, and keeps no launch call's correlation id. So, for now, these
readers profile a stretch of their own, once per traced run
(:func:`stretch`): after the window and before the check, the cell's
requests 0 to ``n_requests − 1`` again, the requests of the harness's
stretch, warm, each under ``tracing.REQUEST`` and all under
``tracing.STRETCH``. A program without the spans reads nothing, and no
stretch is run. This second profiler run is a stopgap: once
``tracing.collect`` keeps the ``trajopt.*`` ranges and the correlation ids,
the readers read the harness's stretch and this one goes.

Every time here is a traced one. Under the profiler a kernel launch takes
10–45 µs on the host and each graph launch records every node, so on an
H100 a traced cloud-10 30-step request took 1.6–2.1 times its untraced
time, the host's phases most of that excess; the figures size phases
against each other, not the untraced request.

:func:`reduce` keeps, of a finished profiler:

* the stretch's device operations and host events as ``tracing.collect``
  keeps them, the device ones moved onto the host's clock (below) before
  they are clipped to the stretch and their busy intervals joined;
* the ``trajopt.*`` ranges of the host side (their device-side
  annotations are no work and are dropped, as the benchmark's own are);
* the runtime call that launched each device operation, joined by the
  profiler's correlation id, which a kernel, a copy and every node of a
  replayed graph share with the ``cuda*`` / ``cu*`` call that launched it;
* the device operations moved onto the host's clock. CUPTI's device
  timestamps drift from the host's within one process, at a rate that
  differs between processes (on an H100, the offset grew to +2.8 ms,
  +0.3 ms and −3.9 ms over 12 cloud-10 requests, 0.6–0.8 s, and to +6.0 ms
  over 6 400-step ones), which would move gaps across spans and turn the
  card's waits for the host into waits of its own. Such a copy ends before its call returns and
  starts after the call began, so each request's fetch bounds the offset
  (:func:`clock_offsets`); between fetches it is taken as linear. Without
  such copies (a CPU run) the offset is 0.

:func:`idle_spans` splits the stretch's device-idle time by the innermost
program span the host was in and by cause: a gap is ``host``-caused when
the call that launched the operation ending it had not returned when the
gap began (the card waited for the host), or when no operation ends it
(the stretch's last); otherwise ``device``-caused (the work was queued:
launch latency, a graph's node scheduling, a stream wait). A call's end,
not its start: under the profiler a kernel launch takes 10–45 µs and its
kernel can start before it returns, so a gap that opens while the launch
is under way is the host's. Their sum is the stretch's idle time, its
device work on the host's clock.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import time
import weakref
from typing import Dict, List, Optional, Tuple

import tracing

PREFIX = "trajopt."
OUTSIDE = "outside"  # no program span: the harness between requests
GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")
SYNC_COPY = "Memcpy DtoH (Device -> Pageable)"  # ends before its call returns
ANCHOR_GAP_S = 1e-3  # copies closer than this bound one offset (one fetch)


@dataclasses.dataclass
class Span:
    name: str
    start: float  # seconds, host clock
    end: float
    thread: int


@dataclasses.dataclass
class Op:
    """A device operation on the host's clock, clipped to the stretch, with its
    launching call."""

    name: str
    start: float
    end: float
    launch: Optional[tracing.Ev]  # the runtime call, None when none was recorded


@dataclasses.dataclass
class ProgramTrace:
    trace: tracing.Trace  # as the harness reduces a stretch, device times on the host's clock
    ops: List[Op]  # trace.device with their launching calls, by start
    spans: List[Span]  # the program's spans inside the stretch
    requests: List[tracing.Ev]  # the benchmark's request ranges
    request_s: List[float]  # host seconds of each traced request
    offsets: List[Tuple[float, float]]  # the device clock's offsets (clock_offsets)

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    def span_s(self, *names) -> float:
        return sum(s.end - s.start for s in self.spans if s.name in names)


def _host(e) -> bool:
    return "cuda" not in str(e.device_type()).lower()


def clock_offsets(ops: List[Op]) -> List[Tuple[float, float]]:
    """(device time, device clock − host clock) at each group of copies to
    pageable host memory: the middle of the offsets they allow, from
    (copy end − call end) up to (copy start − call start)."""
    groups: List[list] = []
    for o in ops:
        if o.name.startswith(SYNC_COPY) and o.launch is not None:
            bound = (o.start, o.end - o.launch.end, o.start - o.launch.start)
            if groups and o.start - groups[-1][-1][0] < ANCHOR_GAP_S:
                groups[-1].append(bound)
            else:
                groups.append([bound])
    return [(g[0][0], 0.5 * (max(b[1] for b in g) + min(b[2] for b in g))) for g in groups]


def offset_at(anchors: List[Tuple[float, float]], t: float) -> float:
    """The offset at device time ``t``, linear through the anchors (and on
    past the first and the last two); 0 without anchors."""
    if len(anchors) < 2:
        return anchors[0][1] if anchors else 0.0
    i = min(max(bisect.bisect_right([a for a, _ in anchors], t), 1), len(anchors) - 1)
    (ta, da), (tb, db) = anchors[i - 1], anchors[i]
    return da + (db - da) * (t - ta) / (tb - ta)


def reduce(prof, request_s: Optional[List[float]] = None) -> ProgramTrace:
    """The stretch of a finished ``torch.profiler.profile`` (see the module)."""
    tr = tracing.collect(prof)
    t0, t1 = tr.t0, tr.t1
    calls, dev, spans, requests = {}, [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if getattr(e, "is_user_annotation", bool)() or name in (tracing.STRETCH, tracing.REQUEST):
            if _host(e):
                a, b = tracing._times(e)
                if name == tracing.REQUEST:
                    requests.append(tracing.Ev(name, a, b))
                elif name.startswith(PREFIX) and b > t0 and a < t1:
                    spans.append(Span(name, a, b, e.start_thread_id()))
            continue
        if _host(e):
            if name.startswith("cu"):
                calls[e.correlation_id()] = tracing.Ev(name, *tracing._times(e))
        else:
            dev.append((*tracing._times(e), name, e.correlation_id()))
    raw = [Op(name, a, b, calls.get(corr)) for a, b, name, corr in sorted(dev)]
    anchors = clock_offsets(raw)
    ops = []
    for o in raw:
        d = offset_at(anchors, o.start)
        a, b = o.start - d, o.end - d
        if b > t0 and a < t1:
            ops.append(Op(o.name, max(a, t0), min(b, t1), o.launch))
    ops.sort(key=lambda o: o.start)
    on_host = tracing.Trace([tracing.Ev(o.name, o.start, o.end) for o in ops], tr.host, t0, t1,
                            tracing.union((o.start, o.end) for o in ops))
    requests = [r for r in requests if r.end > t0 and r.start < t1]
    return ProgramTrace(on_host, ops, sorted(spans, key=lambda s: (s.start, -s.end)),
                        sorted(requests, key=lambda r: r.start), list(request_s or []), anchors)


def innermost(spans: List[Span], t: float) -> str:
    """The name of the shortest span covering ``t`` (``OUTSIDE`` if none)."""
    cover = [s for s in spans if s.start <= t <= s.end]
    return min(cover, key=lambda s: s.end - s.start).name if cover else OUTSIDE


def idle_parts(pt: ProgramTrace) -> List[Tuple[str, str, float, int]]:
    """(span, cause, seconds, gap index) of every piece of the stretch's
    device-idle time: each gap cut where a span begins or ends, each piece
    given to the innermost span at its middle."""
    bounds = sorted({t for s in pt.spans for t in (s.start, s.end)})
    labels = [innermost(pt.spans, 0.5 * (u + v)) for u, v in zip(bounds, bounds[1:])]

    def label(u, v):
        i = bisect.bisect_right(bounds, 0.5 * (u + v)) - 1
        return labels[i] if 0 <= i < len(labels) else OUTSIDE

    starts = [o.start for o in pt.ops]
    out = []
    for k, (a, b) in enumerate(tracing.gaps(pt.trace)):
        j = bisect.bisect_left(starts, b)
        op = pt.ops[j] if j < len(pt.ops) and starts[j] == b else None
        cause = "host" if op is None or (op.launch is not None and op.launch.end > a) \
            else "device"
        cuts = [a] + bounds[bisect.bisect_right(bounds, a):bisect.bisect_left(bounds, b)] + [b]
        out.extend((label(u, v), cause, v - u, k) for u, v in zip(cuts, cuts[1:]))
    return out


def idle_spans(pt: ProgramTrace) -> List[list]:
    """[span, cause, seconds, gaps] of the stretch's device-idle time, the
    longest first; a gap cut between spans counts in each."""
    rows: Dict[Tuple[str, str], list] = {}
    for name, cause, s, k in idle_parts(pt):
        row = rows.setdefault((name, cause), [0.0, set()])
        row[0] += s
        row[1].add(k)
    return sorted(([n, c, s, len(ks)] for (n, c), (s, ks) in rows.items()),
                  key=lambda r: -r[2])


def coverage(pt: ProgramTrace, root: str) -> List[Tuple[float, float]]:
    """Per request: (the root span's share of the request range, its other
    spans' union's share of the root span)."""
    out = []
    for r in pt.requests:
        inside = [s for s in pt.spans if r.start <= s.start and s.end <= r.end]
        roots = [s for s in inside if s.name == root]
        if not roots:
            out.append((0.0, 0.0))
            continue
        top = roots[0]
        kids = tracing.union((max(s.start, top.start), min(s.end, top.end)) for s in inside
                             if s is not top and s.end > top.start and s.start < top.end)
        out.append(((top.end - top.start) / (r.end - r.start),
                    sum(b - a for a, b in kids) / (top.end - top.start)))
    return out


_STRETCHES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _has_spans() -> bool:
    """Whether the program marks its phases (the parent of the spans does not)."""
    try:
        from trajectory_optimization_tpu_torch.utils.profiling import span  # noqa: F401
    except ImportError:
        return False
    return True


def stretch(ctx) -> Optional[ProgramTrace]:
    """The program's trace of a stretch of its own for this run (see the
    module), made on the first call and kept for the run's other readers;
    None for a program without its spans, or a stretch that failed."""
    if ctx in _STRETCHES:
        return _STRETCHES[ctx]
    _STRETCHES[ctx] = pt = _run(ctx)
    return pt


def _run(ctx) -> Optional[ProgramTrace]:
    if not _has_spans() or not ctx.n_requests:
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(ctx.device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    lat = []
    try:
        with profile(activities=acts) as prof:
            with record_function(tracing.STRETCH):
                for i in range(ctx.n_requests):
                    t = time.perf_counter()
                    with record_function(tracing.REQUEST):
                        ctx.cell.request(i)
                    lat.append(time.perf_counter() - t)
                if cuda:
                    torch.cuda.synchronize()
    except Exception as exc:  # noqa: BLE001 - the metrics read nothing; the run goes on
        ctx.notes.append(f"program spans: the stretch failed: {exc!r}")
        return None
    pt = reduce(prof, lat)
    _note(ctx, pt)
    return pt


def _note(ctx, pt: ProgramTrace) -> None:
    n = pt.n_requests
    lat = sorted(pt.request_s)
    ctx.notes.append(f"program spans: own stretch of {n} requests after the window, traced "
                     f"request median {1e3 * lat[len(lat) // 2]:.4f} ms; device clock offset by copy "
                     f"{[round(1e6 * d, 2) for _, d in pt.offsets]} us")
    names = sorted({s.name for s in pt.spans})
    ctx.notes.append("program spans: host ms per request "
                     + ", ".join(f"{s[len(PREFIX):]} {1e3 * pt.span_s(s) / n:.4f}" for s in names))
    cov = coverage(pt, "trajopt.facade.optimize")
    if cov:
        ctx.notes.append(f"program spans: facade.optimize over the request range, least "
                         f"{100 * min(c[0] for c in cov):.2f}%; its child spans over it, least "
                         f"{100 * min(c[1] for c in cov):.2f}%")
    if pt.ops:
        ctx.notes.append("idle_spans " + json.dumps(idle_spans(pt)))
