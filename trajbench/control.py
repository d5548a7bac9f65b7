"""The control of a cell's check: the reference put in the program's place,
its (W, N) scores computed in the precision below the one the
configuration states (``LOWER``: bfloat16 below float32; the visibility
model has no matrix product, so TF32 would change nothing). It must come
out as not correct.

    python3 trajbench/control.py --workload <name> --seeds <n> [<n> ...]

For each seed it draws the cell's inputs, takes as many requests as a run
checks (the lowest of the seed's priorities among the first ``POOL``
requests), solves each with the control, takes the control's follow-up
steps from its own result, and judges the lot with the cell's check and
limits, as a run judges the program. One JSON line per seed. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
for p in (str(BENCH_DIR), str(BENCH_DIR.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import inputs  # noqa: E402
import registry as registry_mod  # noqa: E402

LOWER = {"float32": torch.bfloat16}  # below each precision a configuration may state
POOL = 64  # the requests checked are drawn from the first POOL of the seed's


def control_seed(reg, workload: str, seed: int, device: str) -> dict:
    wl = reg.workload(workload)
    cfg, traffic = reg.config(wl["config"]), reg.traffic(wl["traffic"])
    limits = reg.limits(workload)
    cell = reg.driver(cfg["driver"]).Cell(cfg, traffic, seed, device, reg, system=False)
    order = inputs.sample_order(seed, 1 << 16)[:POOL]
    picked = sorted(np.argsort(order)[: int(traffic["check_requests"])].tolist())
    ref, st = cell.ref, cell.settings
    low = LOWER[cfg["precision"]]
    sample = []
    for i in picked:
        res = ref.solve(cell.points, cell.path(i), cell.n_steps, st, device=device,
                        dtype=torch.float32, vis_dtype=low)
        start = (res.poses.astype(np.float32), res.quats_wxyz.astype(np.float32))
        f = ref.solve(cell.points, cell.path(i), cell.follow_steps, st, device=device,
                      dtype=torch.float32, vis_dtype=low, start=start)
        sample.append((i, res, (f.poses, f.quats_wxyz)))
    numbers = cell.check(sample, device)
    return {"workload": workload, "seed": seed, "requests": picked, "numbers": numbers,
            "limits": limits, "notes": cell.notes,
            "correct": all(numbers[k] <= limits[k] for k in numbers)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    reg = registry_mod.Registry()
    for seed in args.seeds:
        print(json.dumps(control_seed(reg, args.workload, seed, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
