"""The port stands alone: importing every module of
``trajectory_optimization_tpu_torch`` and ``chip_smoke.py`` (with every
module it imports) loads neither ``jax`` nor the JAX package; and the kernel
library's name follows every CUDA source."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from trajectory_optimization_tpu_torch.ops import _kernels  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "trajectory_optimization_tpu")


def _chip_smoke_imports():
    """Every module ``chip_smoke.py`` imports, at any depth of its code."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return sorted(names)


def test_chip_smoke_imports_nothing_of_jax():
    for name in _chip_smoke_imports():
        assert name.split(".")[0] not in FORBIDDEN, name


def test_port_and_chip_smoke_import_no_jax():
    code = f"""
import importlib, pkgutil, sys
import trajectory_optimization_tpu_torch as pkg
names = []
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
    names.append(m.name)
for name in {_chip_smoke_imports()!r}:
    try:
        importlib.import_module(name)
    except ModuleNotFoundError:
        pass  # a name imported from a module, not a module
import chip_smoke
bad = sorted(n for n in sys.modules if n.split(".")[0] in {FORBIDDEN!r})
print(len(names), bad)
assert not bad, bad
assert len(names) >= 51, names
assert {{"models.pose", "ops.voxel", "native", "__main__", "bus.rosbag", "bus.remote",
         "bus.launch"}} <= {{n.split(".", 1)[1] for n in names}}, names
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_library_name_follows_every_source(tmp_path):
    copies = []
    for src in _kernels.SOURCES:
        copies.append(tmp_path / src.name)
        shutil.copyfile(src, copies[-1])
    assert {c.name for c in copies} >= {"fused_vis.cu", "splat_render.cu"}
    base = _kernels.library_path(copies)
    assert base == _kernels.library_path(_kernels.SOURCES)  # same bytes, same library
    seen = {base}
    for c in copies:
        original = c.read_bytes()
        c.write_bytes(original + b"\n")
        seen.add(_kernels.library_path(copies))
        c.write_bytes(original)
    assert len(seen) == len(copies) + 1  # each source's change gives a new name
    assert _kernels.library_path(copies) == base
    assert base.parent == _kernels.BUILD_DIR


def test_a_cached_library_keeps_its_build_log(tmp_path, monkeypatch):
    """build() of sources already built compiles nothing and hands back the
    first build's nvcc report, from which chip_smoke.py reads each kernel's
    registers: the script runs twice in one checkout."""
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "build_log", "")
    out = _kernels.library_path()
    out.write_bytes(b"")
    out.with_suffix(".log").write_text("== splat_render.cu\nptxas info    : Used 47 registers")
    assert _kernels.build() == out
    assert _kernels.build_log.endswith("Used 47 registers")
