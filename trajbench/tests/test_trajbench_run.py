"""A whole run of the tiny cell on the CPU, the harness's look for a chip
skipped: its output's shape, the control failing the check, each fault the
cell can have failing it, and the imports a run makes."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import control
import run
from conftest import BENCH_DIR, ROOT

SEED = 4_000_000_007
TIMED_STEPS = 5  # the tiny cell's steps per request


def _run(reg, trace=False, seconds=1.5):
    return run.run_cell("tiny.t5", SEED, seconds, trace, device="cpu", registry=reg,
                        chips_check=False)


def test_sound_run_is_correct(tiny_registry, one_thread):
    out = _run(tiny_registry)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 4
    assert set(out["metrics"]) == {"solve_ms.p50", "solve_ms.p90", "steps_s", "peak_mib",
                                   "setup_s"}
    assert list(out)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    json.dumps(out)


def test_traced_run_reads_its_metrics(tiny_registry, one_thread):
    out = _run(tiny_registry, trace=True)
    assert out["correct"] is True
    # on the CPU no device metric has anything to read; the test's counter does
    assert out["metrics"] == {"tiny.requests": {"value": 2.0, "unit": "requests"}}
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_control_is_not_correct(tiny_registry):
    for seed in (1, 2, 3):
        res = control.control_seed(tiny_registry, "tiny.t5", seed, "cpu")
        assert res["correct"] is False, res


def _state_unchanged(monkeypatch):
    from trajectory_optimization_tpu_torch.opt import engine

    monkeypatch.setattr(engine, "adam_update", lambda grads, state, params, *a, **k: (
        {k_: v.clone() for k_, v in params.items()}, state))


def _half_batch(monkeypatch):
    from trajectory_optimization_tpu_torch.models import traj

    orig = traj.traj_criterion

    def half(lo_sum, params, poses0, problem, *, valid=None):
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = 0  # the mean over the first half only
        return orig(lo_sum, params, poses0, problem, valid=valid)

    monkeypatch.setattr(traj, "traj_criterion", half)


def _answer_altered(monkeypatch):
    from trajectory_optimization_tpu_torch.models import traj

    orig = traj.plain_lo_sum

    def altered(*a, **k):
        lo = orig(*a, **k)
        return lo + torch.nn.functional.one_hot(torch.tensor(7), lo.shape[0]).to(lo.dtype)

    monkeypatch.setattr(traj, "plain_lo_sum", altered)


def _in_timed_runner_only(fault):
    """``fault`` planted in the runner of the window's own step count alone:
    the follow-up steps, which take fewer, run on a sound runner."""

    def plant(monkeypatch):
        from trajectory_optimization_tpu_torch.opt import runners

        orig = runners.TrajRunner.__call__

        def call(self, *args):
            if self.n_steps != TIMED_STEPS:
                return orig(self, *args)
            with monkeypatch.context() as m:
                return fault(self, orig, args, m)

        monkeypatch.setattr(runners.TrajRunner, "__call__", call)

    return plant


def _timed_state_unchanged(runner, orig, args, m):
    _state_unchanged(m)
    return orig(runner, *args)


def _timed_half_steps(runner, orig, args, m):
    """Takes half its steps and reports them all."""
    m.setattr(runner, "n_steps", runner.n_steps // 2)
    params, n_iters, loss, aux = orig(runner, *args)
    return params, torch.full_like(n_iters, TIMED_STEPS), loss, aux


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered,
                                   _in_timed_runner_only(_timed_state_unchanged),
                                   _in_timed_runner_only(_timed_half_steps)],
                         ids=["state_unchanged", "half_batch", "answer_altered",
                              "timed_runner_state_unchanged", "timed_runner_half_steps"])
def test_fault_is_not_correct(fault, tiny_registry, monkeypatch, one_thread):
    from trajectory_optimization_tpu_torch.opt.runners import traj_runner

    traj_runner.cache_clear()
    fault(monkeypatch)
    out = _run(tiny_registry)
    traj_runner.cache_clear()
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("mix", [{"loop": "open"}, {"clients": 4}], ids=["open", "clients4"])
def test_mix_the_harness_does_not_run_is_refused(tiny_root, tiny_registry, mix):
    path = tiny_root / BENCH_DIR.name / "traffic" / "t5.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), **mix)))
    with pytest.raises(run.Refused, match="closed loop of one client"):
        _run(tiny_registry)


def test_run_loads_no_jax(tiny_root):
    code = (f"import sys; sys.path[:0] = [{str(tiny_root / BENCH_DIR.name)!r}, {str(ROOT)!r}]; "
            "import run, registry; "
            f"out = run.run_cell('tiny.t5', 5, 1.0, True, device='cpu', "
            f"registry=registry.Registry(root={str(tiny_root)!r}), chips_check=False); "
            "print(run.forbidden_modules()); sys.exit(1 if run.forbidden_modules() else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]


def test_no_card_means_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    out = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload",
                          "cloud10.node30", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "trajectory_optimization_tpu_torch.fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "trajectory_optimization_tpu.fake", object())
    monkeypatch.setitem(sys.modules, "jax.fake", object())
    assert run.forbidden_modules() == ["jax", "trajectory_optimization_tpu"]


def test_quantile_is_linear():
    assert run.quantile(list(np.arange(1, 12, dtype=float)), 0.9) == pytest.approx(10.0)
