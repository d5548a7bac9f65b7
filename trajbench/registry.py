"""Finds a cell's pieces by the names ``BENCHMARK.json`` gives them.

Everything that belongs to one configuration, traffic mix, driver or
per-layer metric sits in a file of its own under the benchmark's folder, so
that a new one is added as a file and an entry, with no edit to a file that
is there:

  configs/<config>.json        sizes, settings, source (named by the entry's ``file``)
  traffic/<mix>.json           loop, clients, steps per request, path moves
  limits/<workload>.json       the limit of each number that decides ``correct``
  drivers/<driver>.py          drives the system under test (the config's ``driver``)
  metrics/<metric>.py          one per-layer metric's reader
  reference/<reference>.py     a plain reference (the config's ``reference``)
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: Optional[str] = None) -> ModuleType:
    """Import a file by its path (metric files have dots in their names)."""
    name = name or f"trajbench_{path.parent.name}_{path.stem.replace('.', '_')}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Registry:
    def __init__(self, root: Path = ROOT, bench_dir: Optional[Path] = None):
        self.root = Path(root)
        self.bench_dir = Path(bench_dir) if bench_dir is not None else self.root / BENCH_DIR.name
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, kind: str, name: str) -> dict:
        for e in self.spec[kind]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r} in "
                       f"BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        entry = self._entry("configs", name)
        cfg = json.loads((self.root / entry["file"]).read_text())
        cfg["name"] = name
        return cfg

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench_dir / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> Dict[str, float]:
        return json.loads((self.bench_dir / "limits" / f"{workload}.json").read_text())["limits"]

    def driver(self, name: str) -> ModuleType:
        return load_module(self.bench_dir / "drivers" / f"{name}.py")

    def reference(self, name: str) -> ModuleType:
        return load_module(self.bench_dir / "reference" / f"{name}.py")

    def metrics(self, kind: str, workload: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics a workload reports: those
        listing it under ``workloads``, and those without that key."""
        return [m for m in self.spec[kind] if workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.bench_dir / "metrics" / f"{metric}.py")
