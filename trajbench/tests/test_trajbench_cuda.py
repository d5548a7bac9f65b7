"""On the card: one short run of each cell, as the driver starts it, comes
out correct, and the control of each does not. Marked ``cuda``; skips
without a card (decided in the fixture, never at import)."""
import json
import subprocess
import sys

import pytest

from conftest import BENCH_DIR, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_short_run_is_correct(card, workload):
    out = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload", workload,
                          "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["failed"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct_on_the_card(card, workload):
    import control
    import registry

    res = control.control_seed(registry.Registry(), workload, 2147483659, "cuda")
    assert res["correct"] is False, res
