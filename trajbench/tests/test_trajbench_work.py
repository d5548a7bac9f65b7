"""The visibility work behind vis.roofline_pct depends on the inputs alone,
and reads the same whichever kernel regime ran."""
import numpy as np
import pytest

import inputs
import registry
import tracing
from conftest import TINY_CONFIG
from run import MetricContext


class _Cell:
    def __init__(self):
        reg = registry.Registry()
        cfg = dict(reg.config("cloud10"), **TINY_CONFIG)
        self.ref = reg.reference(cfg["reference"])
        self.settings = self.ref.Settings.from_config(cfg)
        self.points = inputs.cloud(cfg["cloud"], 5, reg.root)
        self.paths = inputs.moved_paths(inputs.path(cfg["path"], reg.root),
                                        reg.traffic("node30")["moves"], 5)
        self.n_steps, self.n_scored = 30, 8

    def path(self, i):
        return self.paths[i]


def _ctx(cell, names, each_s):
    t, dev = 0.0, []
    for n in names:
        dev.append(tracing.Ev(f"void {n}<true>(float const*, int)", t, t + each_s))
        t += 2 * each_s
    tr = tracing.Trace(dev, [], 0.0, t, tracing.union((e.start, e.end) for e in dev))
    return MetricContext(tr, cell, n_requests=2, n_steps=2 * cell.n_steps, device="cpu")


def test_work_is_the_same_for_either_regime():
    reg = registry.Registry()
    roof, kms = reg.reader("vis.roofline_pct"), reg.reader("vis.kernel_ms")
    cell = _Cell()
    cached = _ctx(cell, ["pass_a_kernel", "pass_b_kernel", "bwd_stats_kernel",
                         "bwd_apply_kernel"], 1e-3)
    uncached = _ctx(cell, ["pass_a_kernel", "pass_b_recompute_kernel", "bwd_fused_kernel",
                           "unrelated_kernel"], 1e-3)
    assert kms.read(cached) == pytest.approx(4e-3 * 1e3 / 60)
    assert kms.read(uncached) == pytest.approx(3e-3 * 1e3 / 60)
    a, b = roof.read(cached), roof.read(uncached)
    assert 0 < a < 100 and b == pytest.approx(a * 4 / 3)


def test_work_depends_on_inputs_only(monkeypatch):
    from trajectory_optimization_tpu_torch.ops import fused_vis

    roof = registry.Registry().reader("vis.roofline_pct")
    cell = _Cell()
    counts = [roof.contributing_pairs(cell.ref, cell.points, cell.path(i), cell.settings, "cpu")
              for i in range(3)]
    monkeypatch.setattr(fused_vis, "SCORE_CACHE_MAX_BYTES", 0)
    again = [roof.contributing_pairs(cell.ref, cell.points, cell.path(i), cell.settings, "cpu")
             for i in range(3)]
    assert counts == again
    assert all(0 < c < cell.n_scored * len(cell.points) for c in counts)
    assert roof.read(_ctx(cell, ["other_kernel"], 1e-3)) is None


def test_trace_reduction():
    ev = [tracing.Ev("k1", 0.0, 1.0), tracing.Ev("k2", 0.5, 1.5), tracing.Ev("Memcpy HtoD", 3.0, 4.0)]
    tr = tracing.Trace(ev, [tracing.Ev("cudaStreamSynchronize", 1.6, 2.9)], 0.0, 5.0,
                       tracing.union((e.start, e.end) for e in ev))
    assert tr.busy_s == pytest.approx(2.5)
    gaps = tracing.idle_gaps(tr)
    assert gaps[0] == ["cudaStreamSynchronize", pytest.approx(1.5)]
    assert gaps[1] == ["host: python", pytest.approx(1.0)]
    assert tracing.device_ops(tr)[0][0] in ("k1", "k2", "Memcpy HtoD")
    assert np.isclose(sum(s for _, s in tracing.device_ops(tr)), 3.0)


def test_idle_share_leaves_the_profiler_out():
    ev = [tracing.Ev("k1", 0.0, 1.0), tracing.Ev("k2", 4.0, 5.0)]
    host = [tracing.Ev("Activity Buffer Request", 1.2, 2.2),
            tracing.Ev("cudaLaunchKernel", 2.3, 3.8), tracing.Ev("Buffer Flush", 5.2, 5.9)]
    tr = tracing.Trace(ev, host, 0.0, 6.0, tracing.union((e.start, e.end) for e in ev))
    assert [g[0] for g in tracing.idle_gaps(tr)] == ["cudaLaunchKernel"]
    idle = registry.Registry().reader("device.idle_pct")
    # two traced requests, 1 s of device work each, untraced requests of 4 s
    ctx = MetricContext(tr, None, n_requests=2, n_steps=2, device="cpu", request_s=4.0)
    assert idle.read(ctx) == pytest.approx(75.0)
    assert registry.Registry().reader("device.idle_pct.solve").read(ctx) == idle.read(ctx)
    ctx.request_s = None  # no untraced request to time
    assert idle.read(ctx) is None
