"""Runs one cell of the benchmark once and prints its result.

    python3 trajbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix; the configuration names the
driver that calls the system under test (``drivers/``) and its plain
reference (``reference/``). One run:

1. set-up, timed as ``setup_s`` and printed in parts on standard error:
   importing torch and the program and making the CUDA context, loading
   (or, the first time in a checkout, building) the program's kernel
   library, drawing the inputs from the seed, and the warm calls, which
   capture the cell's one shape;
2. the window: a closed loop of one client for ``--seconds``, each request
   sent when the last result is on the host; the requests started before
   the deadline all finish inside it;
3. with ``--trace 1``, a profiler over the window's first requests (the
   stretch) and the per-layer metrics read from it (``metrics/``);
4. the check: the peak memory is read, the sampled requests' follow-up
   steps run, the program is freed, and the reference judges the sample
   against the cell's limits (``limits/``).

The last line of standard output is the result's JSON; the numbers compared
are the last lines of standard error and the result's last key. A run that
finds no CUDA card, fewer cards than the cell asks for, or JAX or the JAX
package loaded, exits with code 2 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

# One host compute thread: the program's host work is one thread's launches
# and copies, and OpenMP workers idling on a shared host only take cores
# from it (on an H100 host cloud10.node30's p50 read 6% lower with it, and
# spread about as widely between runs); an outer setting wins.
os.environ.setdefault("OMP_NUM_THREADS", "1")

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
for p in (str(BENCH_DIR), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "trajectory_optimization_tpu")


class Refused(RuntimeError):
    """The run cannot give a result here (exit code 2, no result line)."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (the port's own name only begins with the latter)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def quantile(values, q: float) -> float:
    """The q-th quantile (0 < q < 1), linear between order statistics."""
    return statistics.quantiles(values, n=100, method="inclusive")[round(q * 100) - 1]


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def cache_dirs() -> None:
    """Kernel caches go inside the checkout, at fixed paths (the program's
    own library builds in ``build/torch_kernels/`` there already)."""
    cache = ROOT / "build" / "trajbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             registry=None, chips_check: bool = True) -> dict:
    """One run of one cell; returns the result's dict."""
    import inputs
    import registry as registry_mod

    reg = registry if registry is not None else registry_mod.Registry()
    wl = reg.workload(workload)
    cfg, traffic = reg.config(wl["config"]), reg.traffic(wl["traffic"])
    if traffic["loop"] != "closed" or int(traffic["clients"]) != 1:
        raise Refused(f"mix {wl['traffic']!r} asks for loop={traffic['loop']!r} with "
                      f"clients={traffic['clients']!r}: the harness runs a closed loop of one "
                      "client only")
    limits = reg.limits(workload)
    setup = {}
    mark = [T_START]

    def phase(name):
        now = time.perf_counter()
        setup[name] = setup.get(name, 0.0) + now - mark[0]
        mark[0] = now

    import torch

    cuda = torch.device(device).type == "cuda"
    if chips_check:
        if not torch.cuda.is_available():
            raise Refused("no CUDA card: the benchmark measures the card and has no CPU fallback")
        if torch.cuda.device_count() < int(wl["chips"]):
            raise Refused(f"{workload} needs {wl['chips']} cards, "
                          f"{torch.cuda.device_count()} found")
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=device)
    driver = reg.driver(cfg["driver"])
    cell = driver.Cell(cfg, traffic, seed, device, reg, phase=phase)
    if cuda:
        from trajectory_optimization_tpu_torch.ops import _kernels

        _kernels._load()
        phase("kernels")
    cell.warm()
    acts = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts):  # the profiler's own first start, outside the window
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize() if cuda else None
    phase("warm")
    setup_s = time.perf_counter() - T_START
    log("[setup] " + " ".join(f"{k}_s={v:.3f}" for k, v in setup.items())
        + f" total_s={setup_s:.3f}")

    stretch_n = int(traffic["trace_requests"]) if trace else 0
    latencies, failed, kept, window_s, prof = window(
        cell, seconds, inputs.sample_order(seed, 1 << 16), int(traffic["check_requests"]),
        stretch_n, acts, cuda)
    found = forbidden_modules()
    if found:
        raise Refused(f"modules of JAX or the JAX package were loaded: {', '.join(found)}")

    peak = torch.cuda.max_memory_reserved() if cuda else 0
    attempted = len(latencies)
    done_steps = (attempted - failed) * cell.n_steps
    metrics = {}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    breakdown = None
    if not trace:
        lat_ms = [x * 1e3 for x in latencies]
        values = {"solve_ms.p50": statistics.median(lat_ms),
                  "solve_ms.p90": quantile(lat_ms, 0.90),
                  "steps_s": done_steps / window_s,
                  "peak_mib": peak / 2 ** 20,
                  "setup_s": setup_s}
        for m in reg.metrics("end_to_end", workload):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        log(f"[window] requests={attempted} failed={failed} window_s={window_s:.3f} "
            f"steps={done_steps} p50_ms={values['solve_ms.p50']:.4f} "
            f"p90_ms={values['solve_ms.p90']:.4f} peak_alloc_mib="
            f"{(torch.cuda.max_memory_allocated() if cuda else 0) / 2 ** 20:.1f}")
        thirds = [lat_ms[k * len(lat_ms) // 3:(k + 1) * len(lat_ms) // 3] for k in range(3)]
        log("[window] p50_ms by third: "
            + " ".join(f"{statistics.median(t):.4f}" for t in thirds if t))
    else:
        import tracing

        tr = tracing.collect(prof)
        untraced = latencies[stretch_n:]
        ctx = MetricContext(trace=tr, cell=cell, n_requests=stretch_n,
                            n_steps=stretch_n * cell.n_steps, device=device,
                            request_s=statistics.median(untraced) if untraced else None)
        for m in reg.metrics("per_layer", workload):
            value = reg.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tracing.device_ops(tr), "idle_gaps": tracing.idle_gaps(tr)}
        log(f"[trace] requests={stretch_n} steps={ctx.n_steps} window_s={tr.window_s:.6f} "
            f"busy_s={tr.busy_s:.6f} card={power_limit() if cuda else 'cpu'}")
        for line in ctx.notes:
            log(f"[trace] {line}")

    # the check, after the window and the memory reading
    t_check = time.perf_counter()
    sample = sorted(kept.items())
    follows = [cell.follow(k, res) for k, res in sample]
    cell.free()
    del kept
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    numbers = cell.check([(k, res, f) for (k, res), f in zip(sample, follows)], device)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = (failed == 0 and len(sample) > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    log(f"[check] requests={[k for k, _ in sample]} reference_s={time.perf_counter() - t_check:.3f}")
    for line in getattr(cell, "notes", []):
        log(f"[check] {line}")
    found = forbidden_modules()
    if found:
        raise Refused(f"modules of JAX or the JAX package were loaded: {', '.join(found)}")
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def window(cell, seconds, order, n_sample, stretch_n, acts, cuda):
    """The measured window: a closed loop of one client for ``seconds``; the
    request running at the deadline finishes inside it. Keeps the results
    of the ``n_sample`` completed requests with the lowest ``order``, and
    profiles the first ``stretch_n``. Returns (latencies in s, failed
    requests, {index: result}, the window's seconds, the profiler)."""
    import torch
    from torch.profiler import profile, record_function

    import tracing

    kept, latencies, failed = {}, [], 0
    tracer = contextlib.ExitStack()
    prof = tracer.enter_context(profile(activities=acts)) if stretch_n else None
    if prof is not None:
        tracer.enter_context(record_function(tracing.STRETCH))
    t_open = time.perf_counter()
    deadline = t_open + seconds
    i = 0
    while time.perf_counter() < deadline:
        t = time.perf_counter()
        try:
            with record_function(tracing.REQUEST) if i < stretch_n else contextlib.nullcontext():
                res = cell.request(i)
        except Exception as exc:  # noqa: BLE001 - a failed request is counted, not fatal
            failed += 1
            log(f"[window] request {i} failed: {exc!r}")
            res = None
        latencies.append(time.perf_counter() - t)
        if res is not None and i < len(order):
            kept[i] = res
            if len(kept) > n_sample:
                del kept[max(kept, key=lambda k: order[k])]
        i += 1
        if i == stretch_n:
            if cuda:
                torch.cuda.synchronize()
            tracer.close()
    window_s = time.perf_counter() - t_open
    tracer.close()
    if i < stretch_n:
        raise RuntimeError(f"the window finished {i} of the {stretch_n} traced requests")
    return latencies, failed, kept, window_s, prof


class MetricContext:
    """What a per-layer metric's reader gets: the stretch's trace, the
    cell (its inputs, its reference), the stretch's requests and steps, the
    median seconds of the window's requests after the stretch (untraced),
    and ``notes``, lines a reader adds for standard error."""

    def __init__(self, trace, cell, n_requests: int, n_steps: int, device: str,
                 request_s: Optional[float] = None):
        self.trace, self.cell = trace, cell
        self.n_requests, self.n_steps, self.device = n_requests, n_steps, device
        self.request_s = request_s
        self.notes = []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    try:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except Refused as exc:
        log(f"[refused] {exc}")
        return 2
    log(f"correct {out['correct']}")
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
