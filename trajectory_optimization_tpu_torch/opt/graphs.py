"""The captured optimization step: one CUDA graph per shape bucket.

The JAX engine runs its step loops as one jitted program (``lax.while_loop``,
``scan``, ``fori_loop``). Here the counterpart is a ``torch.cuda.CUDAGraph``
of one step whose inputs and outputs live in static buffers: the step reads
the parameters, moments and counters from them and ``copy_``s the new ones
back, so replaying the graph iterates in place and each step costs one
graph launch instead of a few hundred kernel launches.

Routes:

* ``"eager"`` — the Python loop of fresh tensors (CPU tensors, and the
  configurations whose step reads the host: ``models.traj.capture_route``);
* ``"graph"`` — the static-buffer step, run once eagerly (the run's own
  first step: it makes the lazily created device state — cuBLAS handles,
  the kernel launcher's sentinels and scratch — on the capture stream),
  then captured and replayed;
* ``"static"`` — the same static-buffer step called directly, uncaptured:
  what the card captures, run on the CPU by the tests.

Every captured run, its eager first step included, runs on one side stream
per device (``capture_stream``) that first waits for the caller's stream;
the caller's stream waits for it at the end. A graph holds its own memory
pool (the step's intermediates) besides the static buffers of its bucket,
and a reference to the kernel launcher's scratch it was captured with
(``ops._kernels.reduction_scratch``), so a later, larger problem that grows
the scratch cannot free memory the graph still writes. The kernel launch
counts (``ops._kernels.LAUNCHES``) made while capturing are taken back and
added once per replay, so the counters keep counting launches on the card.
A capture or replay that fails raises :class:`CaptureError`; nothing falls
back to the eager loop.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import torch

from trajectory_optimization_tpu_torch.ops import _kernels

_streams: Dict[torch.device, "torch.cuda.Stream"] = {}


class CaptureError(RuntimeError):
    """A step routed to capture could not be captured or replayed."""


def device_route(device: torch.device, model_route: str = "graph") -> str:
    """The route of a step on ``device``: the model's route on a CUDA
    device, the eager loop on the CPU."""
    return model_route if torch.device(device).type == "cuda" else "eager"


def capture_stream(device) -> "torch.cuda.Stream":
    """The side stream on which ``device``'s steps are captured and run
    (made on first use)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    s = _streams.get(device)
    if s is None:
        s = _streams[device] = torch.cuda.Stream(device)
    return s


@contextlib.contextmanager
def on_capture_stream(device, route: str):
    """Run the body on ``device``'s capture stream for the ``"graph"``
    route, ordered after the caller's stream and before its later work;
    any other route runs where it is."""
    if route != "graph":
        yield
        return
    device = torch.device(device)
    with torch.cuda.device(device):
        caller = torch.cuda.current_stream(device)
        side = capture_stream(device)
        side.wait_stream(caller)
        try:
            with torch.cuda.stream(side):
                yield
        finally:
            caller.wait_stream(side)


class StepGraph:
    """One step function ``fn()`` over static buffers, replayed from a CUDA
    graph (route ``"graph"``) or called directly (route ``"static"``).

    ``capture()`` records ``fn`` without running it; ``replay()`` runs the
    recorded step once. ``__call__`` captures on first use, then replays.
    The first step of a run is expected to have been run eagerly (by
    calling ``fn`` on the capture stream) before the first capture.
    """

    def __init__(self, fn: Callable[[], None], route: str, what: str = "optimization step"):
        if route not in ("graph", "static"):
            raise ValueError(f"a StepGraph runs the 'graph' or 'static' route, not {route!r}")
        self.fn, self.route, self.what = fn, route, what
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.launches: Dict[str, int] = {}  # kernel launches one replay makes
        self.scratch = None  # the launcher's scratch the graph was captured with
        self.replays = 0
        self.capture_s = None  # host seconds the capture took (record and instantiate)

    def __call__(self) -> None:
        if self.route == "static":
            self.fn()
            return
        if self.graph is None:
            self.capture()
        self.replay()

    def capture(self) -> None:
        """Record ``fn`` into a new CUDA graph on the current (capture)
        stream. The launch counts the wrappers raised while recording are
        taken back: nothing ran. Raises :class:`CaptureError` if the step
        cannot be captured (it reads the host, synchronizes, or another
        thread made a call the capture forbids)."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.current_stream()
        before = dict(_kernels.LAUNCHES)
        fn_err = end_err = None
        # "global" (the default): a call that is unsafe during capture fails
        # the capture whichever thread of the process makes it, so a step
        # that reads the host is caught and never recorded half-way
        graph.capture_begin(capture_error_mode="global")
        try:
            self.fn()
        except Exception as e:  # reported below, once the capture has ended
            fn_err = e
        finally:
            try:
                graph.capture_end()
            except RuntimeError as e:
                end_err = e
            counted = dict(_kernels.LAUNCHES)
            _kernels.LAUNCHES.update(before)
        err = fn_err or end_err
        if err is not None:
            raise CaptureError(
                f"capturing the {self.what} as a CUDA graph failed: {err!r}. A captured step "
                "must not read the host (.item(), bool(tensor), int(tensor), a host copy) or "
                "synchronize; route the configuration to the eager loop if it has to."
            ) from err
        self.graph = graph
        self.launches = {k: counted[k] - before[k] for k in counted if counted[k] != before[k]}
        self.scratch = _kernels.reduction_scratch(stream.device, stream.cuda_stream)
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> None:
        try:
            self.graph.replay()
        except RuntimeError as e:
            raise CaptureError(f"replaying the captured {self.what} failed: {e!r}") from e
        self.replays += 1
        _kernels.add_launches(self.launches)
