"""Shared fixtures of the benchmark's own tests: a copy of the benchmark in a
temporary checkout with one tiny cell added as new files and entries, which
the CPU can run in seconds."""
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(BENCH_DIR), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CONFIG = {"cloud": {"kind": "uniform", "n": 3000, "half_extent_m": 6.0},
               "path": {"kind": "sine", "n": 8, "x_len_m": 6.0, "y_amp_m": 2.0, "freq": 4.0}}
COUNT_METRIC = '''"""tiny.requests: requests in the traced stretch (a test's metric)."""


def read(ctx):
    return float(ctx.n_requests)
'''


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout holding BENCHMARK.json and the benchmark with, added as new
    files and entries only: configuration ``tiny``, mix ``t5`` and cell
    ``tiny.t5`` (3,000 points, 8 waypoints, 5-step requests), listed under
    every end-to-end metric, and the per-layer metric ``tiny.requests``."""
    shutil.copytree(BENCH_DIR, tmp_path / BENCH_DIR.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a test", "reduced": [], "why": "a test",
                             "file": f"{BENCH_DIR.name}/configs/tiny.json"})
    bench["workloads"].append({"name": "tiny.t5", "config": "tiny", "traffic": "t5", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("tiny.t5")
    bench["per_layer"].append({"name": "tiny.requests", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "test", "moves": "steps_s",
                               "workloads": ["tiny.t5"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    tb = tmp_path / BENCH_DIR.name
    cfg = json.loads((BENCH_DIR / "configs" / "cloud10.json").read_text())
    cfg.update(TINY_CONFIG)
    (tb / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH_DIR / "traffic" / "node30.json").read_text())
    mix.update(steps_per_request=5, trace_requests=2)
    (tb / "traffic" / "t5.json").write_text(json.dumps(mix))
    limits = json.loads((BENCH_DIR / "limits" / "cloud10.node30.json").read_text())
    # five steps on 3,000 points are not chaotic: float32 and float64 solves
    # reach visibility gains 2e-7 to 4e-7 apart, where 30 steps on cloud 10
    # part by up to some 1e-3, and a state left unchanged reads only 0.014
    limits["limits"]["solve_vis_gain"] = 1e-4
    (tb / "limits" / "tiny.t5.json").write_text(json.dumps(limits))
    (tb / "metrics" / "tiny.requests.py").write_text(COUNT_METRIC)
    return tmp_path


@pytest.fixture
def tiny_registry(tiny_root):
    import registry

    return registry.Registry(root=tiny_root)


@pytest.fixture
def one_thread():
    """Bits that depend on the thread count stay put."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
