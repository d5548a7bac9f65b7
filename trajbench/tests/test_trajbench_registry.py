"""The registry finds every piece of a cell by name, and a configuration, a
mix and a per-layer metric are added as new files and entries only."""
import json

import numpy as np

import control
import registry
from conftest import BENCH_DIR, ROOT


def test_every_cell_of_the_benchmark_resolves():
    reg = registry.Registry()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert spec["paths"] == [BENCH_DIR.name]
    for wl in spec["workloads"]:
        cfg = reg.config(wl["config"])
        assert reg.traffic(wl["traffic"])["steps_per_request"] > 0
        assert set(reg.limits(wl["name"])) == {"rewards", "loss", "gains", "solve_vis_gain",
                                                  "follow_pose_med_m", "follow_quat_med_deg",
                                                  "steps"}
        assert hasattr(reg.driver(cfg["driver"]), "Cell")
        assert hasattr(reg.reference(cfg["reference"]), "solve")
        for m in reg.metrics("per_layer", wl["name"]):
            assert callable(reg.reader(m["name"]).read)
        e2e = {m["name"] for m in reg.metrics("end_to_end", wl["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        names = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
        for m in reg.metrics("per_layer", wl["name"]):
            assert m["moves"] in e2e  # the metric it moves is reported in the cell
        for m in spec["end_to_end"] + spec["per_layer"]:
            assert set(m.get("workloads", [])) <= {w["name"] for w in spec["workloads"]}
        assert len(names) == len(spec["end_to_end"]) + len(spec["per_layer"])


def test_config_files_state_the_source_and_cuts():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in spec["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        assert entry["reduced"] == []
        assert cfg["precision"] in control.LOWER


def test_added_cell_is_found_without_editing_a_file(tiny_root, tiny_registry):
    before = {p.relative_to(BENCH_DIR): p.read_bytes() for p in BENCH_DIR.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts and "tests" not in p.parts}
    copied = tiny_root / BENCH_DIR.name
    for rel, data in before.items():
        assert (copied / rel).read_bytes() == data, rel  # every file as it is
    wl = tiny_registry.workload("tiny.t5")
    assert tiny_registry.config(wl["config"])["cloud"]["n"] == 3000
    assert tiny_registry.traffic("t5")["steps_per_request"] == 5
    names = [m["name"] for m in tiny_registry.metrics("per_layer", "tiny.t5")]
    assert "tiny.requests" in names and "vis.roofline_pct" not in names
    assert "tiny.requests" not in [m["name"] for m in tiny_registry.metrics("per_layer",
                                                                             "cloud10.node30")]
    assert tiny_registry.reader("tiny.requests").read(type("C", (), {"n_requests": 3})) == 3.0


def test_benchmark_json_names_and_units():
    import re

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[kind]:
            assert name.match(e["name"]), e["name"]
            if "unit" in e:
                assert unit.match(e["unit"]), e["unit"]
    for e in spec["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024
    assert np.all([w["chips"] == 1 for w in spec["workloads"]])
