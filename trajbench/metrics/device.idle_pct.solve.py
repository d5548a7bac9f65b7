"""device.idle_pct.solve: ``device.idle_pct`` in the cells whose end-to-end
metric is ``solve_ms.p50``, which it moves there (the per-call host work of
short requests leaves the card idle)."""
from registry import BENCH_DIR, load_module

read = load_module(BENCH_DIR / "metrics" / "device.idle_pct.py").read
