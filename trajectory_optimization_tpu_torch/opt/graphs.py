"""The captured optimization step: one CUDA graph per shape bucket.

The JAX engine runs its step loops as one jitted program (``lax.while_loop``,
``scan``, ``fori_loop``). Here the counterpart is a ``torch.cuda.CUDAGraph``
of one step whose inputs and outputs live in static buffers: the step reads
the parameters, moments and counters from them and ``copy_``s the new ones
back, so replaying the graph iterates in place and each step costs one
graph launch instead of a few hundred kernel launches.

On a CUDA device the step is run once as it is (the run's own first step:
it makes the lazily created device state, cuBLAS handles, the kernel
launcher's sentinels and scratch, on the capture stream), then captured
and replayed. On any other device the same step is called directly.

Every run on a CUDA device, its first step included, runs on one side stream
per device (``capture_stream``) that first waits for the caller's stream;
the caller's stream waits for it at the end. A graph holds its own memory
pool (the step's intermediates) besides the static buffers of its bucket,
and a reference to the kernel launcher's scratch it was captured with
(``ops._kernels.reduction_scratch``), so a later, larger problem that grows
the scratch cannot free memory the graph still writes. The kernel launch
counts (``ops._kernels.LAUNCHES``) made while capturing are taken back and
added once per replay, so the counters keep counting launches on the card.
A capture or replay that fails raises :class:`CaptureError`; nothing falls
back to an uncaptured step. Python's cyclic garbage collector is off while a
step is recorded: a collected graph's ``reset`` is a call a capture
forbids, and would fail the capture under way.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, Optional

import torch

from trajectory_optimization_tpu_torch.ops import _kernels

_streams: Dict[torch.device, "torch.cuda.Stream"] = {}


class CaptureError(RuntimeError):
    """A step on a CUDA device could not be captured or replayed."""


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
def on_capture_stream(device):
    """Run the body on a CUDA ``device``'s capture stream, ordered after the
    caller's stream and before its later work; on any other device, where
    it is."""
    device = torch.device(device)
    if device.type != "cuda":
        yield
        return
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
    """One step function ``fn()`` over static buffers on ``device``:
    replayed from a CUDA graph on a CUDA device, called directly on any
    other.

    ``capture()`` records ``fn`` without running it; ``replay()`` runs the
    recorded step once. ``__call__`` captures on first use, then replays.
    The first step of a run is expected to have been run as it is (by
    calling ``fn`` on the capture stream) before the first capture.
    """

    def __init__(self, fn: Callable[[], None], device, what: str = "optimization step"):
        self.fn, self.what = fn, what
        self.captures = torch.device(device).type == "cuda"
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.launches: Dict[str, int] = {}  # kernel launches one replay makes
        self.scratch = None  # the launcher's scratch the graph was captured with
        self.replays = 0
        self.capture_s = None  # host seconds the capture took (record and instantiate)

    def __call__(self) -> None:
        if not self.captures:
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
        collecting = gc.isenabled()
        gc.disable()
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
            if collecting:
                gc.enable()
            counted = dict(_kernels.LAUNCHES)
            _kernels.LAUNCHES.update(before)
        err = fn_err or end_err
        if err is not None:
            raise CaptureError(
                f"capturing the {self.what} as a CUDA graph failed: {err!r}. A captured step "
                "must not read the host (.item(), bool(tensor), int(tensor), a host copy) or "
                "synchronize."
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
