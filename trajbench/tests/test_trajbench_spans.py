"""The readers of the program's spans (``program_trace.py`` and its four
metrics) on a synthetic trace, and a tiny CPU cell traced.

The synthetic request holds every phase of a call on the card: the
host-to-device copy in ``facade.prepare``, two kernels of the eager first
step, two replays (one of two nodes with a gap between them the card made
itself), the final forward's kernel and the fetch's copy, with the program's
ranges on the host side and their device-side annotations, an operator
whose correlation id collides with a launch's, and the profiler's own
buffer request, and a launch that began before the gap it ends and
returned after. Times are microseconds."""
import json

import numpy as np
import pytest

import program_trace
import registry
import run
import tracing
from conftest import BENCH_DIR

SEED = 4_000_000_009
NEW = ("facade.prepare_ms", "runner.host_ms", "device.host_idle_ms.solve",
       "runner.replay_device_ms")
OLD = ("facade.memcpy_ms", "runner.launches_per_step", "device.idle_pct", "device.idle_pct.solve",
       "step.device_ms", "vis.kernel_ms", "vis.roofline_pct")


class _Ev:
    def __init__(self, name, t0, t1, cuda=False, ua=False, corr=0):
        self._n, self._t0, self._t1, self._cuda, self._ua, self._c = name, t0, t1, cuda, ua, corr

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._t0 * 1000)

    def duration_ns(self):
        return int((self._t1 - self._t0) * 1000)

    def device_type(self):
        return "DeviceType.CUDA" if self._cuda else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._ua

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return 1


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: list(events)})()
        self.profiler = type("P", (), {"kineto_results": results})()


def _host(name, t0, t1, corr=0):
    return _Ev(name, t0, t1, corr=corr)


def _dev(name, t0, t1, corr):
    return _Ev(name, t0, t1, cuda=True, corr=corr)


def _range(name, t0, t1, cuda=False):
    return _Ev(name, t0, t1, cuda=cuda, ua=True)


WORK = [
    _range(tracing.STRETCH, 0, 1000), _range(tracing.REQUEST, 10, 990),
    _host("cudaMemcpyAsync", 100, 110, corr=1),
    _dev("Memcpy HtoD (Pageable -> Device)", 115, 120, 1),
    _host("Activity Buffer Request", 121, 125),
    _host("cudaLaunchKernel", 160, 165, corr=2), _dev("void pass_a_kernel<true>", 170, 200, 2),
    _host("aten::mul", 299, 306, corr=3),  # an operator's id, not a launch's
    # begun before the gap it ends, returned after: the card waited for it
    _host("cudaLaunchKernel", 195, 305, corr=3), _dev("elementwise", 310, 350, 3),
    _host("cudaGraphLaunch", 410, 420, corr=4),
    _dev("node_a", 430, 460, 4), _dev("node_b", 465, 500, 4),
    _host("cudaGraphLaunch", 520, 530, corr=5), _dev("node_a", 540, 600, 5),
    _host("cudaLaunchKernel", 705, 710, corr=6), _dev("pass_b_kernel", 712, 750, 6),
    # a copy to pageable memory ends before its call returns
    _host("cudaMemcpyAsync", 815, 835, corr=7),
    _dev("Memcpy DtoH (Device -> Pageable)", 820, 830, 7),
]
SPANS = [
    ("trajopt.facade.optimize", 20, 980), ("trajopt.facade.prepare", 20, 120),
    ("trajopt.runner.load", 130, 150), ("trajopt.runner.first_step", 150, 400),
    ("trajopt.runner.replays", 400, 700), ("trajopt.runner.final_forward", 700, 800),
    ("trajopt.facade.fetch", 800, 980),
]
# the device-side annotations the profiler adds to the program's ranges
ANNOTATIONS = [_range("trajopt.facade.prepare", 115, 120, cuda=True),
               _range("trajopt.runner.replays", 430, 600, cuda=True)]


def _prof(with_spans=True, drift=0.0):
    """The synthetic trace; ``drift`` (us) delays every device timestamp."""
    spans = [_range(n, a, b) for n, a, b in SPANS] + ANNOTATIONS if with_spans else []
    work = [_Ev(e._n, e._t0 + drift, e._t1 + drift, cuda=True, corr=e._c) if e._cuda else e
            for e in WORK]
    return _Prof(work + spans)


class _Cell:
    """What ``vis.roofline_pct`` reads of a cell."""

    n_steps, n_scored, settings, ref = 30, 14, None, None
    points = np.zeros((1000, 3))

    def path(self, i):
        return None


def _ctx(trace):
    return run.MetricContext(trace=trace, cell=_Cell(), n_requests=1, n_steps=30, device="cpu",
                             request_s=0.002)


def _read(name, ctx):
    return registry.load_module(BENCH_DIR / "metrics" / f"{name}.py").read(ctx)


def test_program_ranges_change_nothing_the_harness_reads(monkeypatch):
    roof = registry.load_module(BENCH_DIR / "metrics" / "vis.roofline_pct.py")
    monkeypatch.setattr(roof, "contributing_pairs", lambda *a: 5000)
    bare, spanned = tracing.collect(_prof(False)), tracing.collect(_prof(True))
    assert (bare.host, bare.device, bare.busy, bare.t0, bare.t1) == (
        spanned.host, spanned.device, spanned.busy, spanned.t0, spanned.t1)
    assert tracing.idle_gaps(bare) == tracing.idle_gaps(spanned)
    for name in OLD:
        got = _read(name, _ctx(bare)), _read(name, _ctx(spanned))
        assert got[0] is not None and got[0] == got[1], name


def test_reduce_keeps_the_spans_and_joins_each_operation_to_its_launch():
    pt = program_trace.reduce(_prof(), [0.98e-3])
    assert [s.name for s in pt.spans] == [n for n, _, _ in SPANS]
    assert pt.n_requests == 1 and pt.trace.device == tracing.collect(_prof()).device
    launches = {o.name: o.launch.name for o in pt.ops}
    assert launches["elementwise"] == "cudaLaunchKernel"  # not the operator of the same id
    assert launches["node_b"] == "cudaGraphLaunch"
    assert launches["Memcpy HtoD (Pageable -> Device)"] == "cudaMemcpyAsync"


def test_idle_spans_split_the_idle_time_by_span_and_cause():
    pt = program_trace.reduce(_prof())
    rows = {(n, c): (s, k) for n, c, s, k in program_trace.idle_spans(pt)}
    idle = pt.trace.window_s - pt.trace.busy_s
    assert sum(s for s, _ in rows.values()) == pytest.approx(idle, rel=1e-12, abs=0)
    us = {key: round(s * 1e6, 3) for key, (s, _) in rows.items()}
    assert us == {
        ("outside", "host"): 40.0, ("trajopt.facade.prepare", "host"): 95.0,
        ("trajopt.facade.optimize", "host"): 10.0, ("trajopt.runner.load", "host"): 20.0,
        ("trajopt.runner.first_step", "host"): 180.0, ("trajopt.runner.replays", "host"): 170.0,
        ("trajopt.runner.replays", "device"): 5.0, ("trajopt.runner.final_forward", "host"): 62.0,
        ("trajopt.facade.fetch", "host"): 170.0,
    }
    assert rows[("trajopt.runner.first_step", "host")][1] == 3
    assert rows[("trajopt.runner.replays", "device")][1] == 1


def test_a_drifted_device_clock_is_brought_back_by_the_copy():
    clean = program_trace.reduce(_prof())
    drifted = program_trace.reduce(_prof(drift=40.0))
    assert [round(1e6 * d, 6) for _, d in drifted.offsets] == [40.0]
    assert [o.name for o in drifted.ops] == [o.name for o in clean.ops]
    times = [t for o in clean.ops for t in (o.start, o.end)]
    assert [t for o in drifted.ops for t in (o.start, o.end)] == pytest.approx(times, abs=1e-12)
    rows = program_trace.idle_spans(clean)
    assert [r[:2] + r[3:] for r in program_trace.idle_spans(drifted)] == [r[:2] + r[3:] for r in rows]
    assert [r[2] for r in program_trace.idle_spans(drifted)] == pytest.approx([r[2] for r in rows])


def test_the_offset_is_linear_between_copies_and_past_them():
    anchors = [(1.0, 10e-6), (3.0, 30e-6)]
    got = [program_trace.offset_at(anchors, t) for t in (0.0, 1.0, 2.0, 3.0, 4.0)]
    assert got == pytest.approx([0.0, 10e-6, 20e-6, 30e-6, 40e-6])
    assert program_trace.offset_at([(1.0, 5e-6)], 9.0) == 5e-6
    assert program_trace.offset_at([], 9.0) == 0.0


def test_coverage_of_the_request_by_the_root_span():
    (root, kids), = program_trace.coverage(program_trace.reduce(_prof()), "trajopt.facade.optimize")
    assert root == pytest.approx(960 / 980) and kids == pytest.approx(950 / 960)


@pytest.mark.parametrize("name,expected", [
    ("facade.prepare_ms", 0.1),
    ("runner.host_ms", 0.37),  # load 20, first step 250, final forward 100 us
    ("device.host_idle_ms.solve", 0.537),  # every host-caused piece but the replays' and outside
    ("runner.replay_device_ms", 0.0625),  # 30 + 35 + 60 us over 2 graph launches
])
def test_each_reader_gives_its_value(name, expected):
    ctx = _ctx(tracing.collect(_prof()))
    program_trace._STRETCHES[ctx] = program_trace.reduce(_prof())
    assert _read(name, ctx) == pytest.approx(expected, rel=1e-9)


def test_a_program_without_spans_reads_nothing():
    ctx = _ctx(tracing.collect(_prof(False)))
    program_trace._STRETCHES[ctx] = None
    assert all(_read(name, ctx) is None for name in NEW)
    ctx = _ctx(tracing.collect(_prof(False)))
    program_trace._STRETCHES[ctx] = program_trace.reduce(_prof(False))
    assert all(_read(name, ctx) is None for name in NEW)


def test_tiny_cell_traced_prints_the_host_metrics(tiny_root, one_thread):
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append("tiny.t5")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run.run_cell("tiny.t5", SEED, 1.5, True, device="cpu",
                       registry=registry.Registry(root=tiny_root), chips_check=False)
    assert out["correct"] is True
    got = out["metrics"]
    # on the CPU the runner takes the eager loop: its final forward is its host phase
    assert got["facade.prepare_ms"]["value"] > 0 and got["runner.host_ms"]["value"] > 0
    assert "device.host_idle_ms.solve" not in got and "runner.replay_device_ms" not in got
