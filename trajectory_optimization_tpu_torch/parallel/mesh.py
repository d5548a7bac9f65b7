"""Process meshes and the differentiable collectives of the parallel layer.

Twin of ``trajectory_optimization_tpu/parallel/mesh.py``. The mesh keeps the
twin's axes:

  * ``pts`` — the point-cloud axis: each rank holds a slice of the cloud;
    global reductions (per-waypoint min/max, mean rewards) are all_reduces
    over the ranks of one ``pts`` group;
  * ``wps`` — the waypoint axis: each rank of a ``wps`` group evaluates its
    own subset of the waypoints.

One rank is one device of the mesh. :func:`make_mesh` lays the ranks out as
the twin lays out devices, ``reshape(wps, n // wps)``: rank r sits at
(r // n_pts, r % n_pts). The caller starts ``torch.distributed`` and names
its backend: ``nccl`` for one rank per card, ``gloo`` for CPU ranks or for
several ranks sharing one card (NCCL refuses two ranks on one device). There
is no global array: each rank holds its own slice, on the mesh's device;
:func:`points_sharding`, :func:`waypoint_sharding` and :func:`replicated`
cut it. The collectives run on the groups the mesh holds and raise where the
backend cannot run them; none is skipped or rerouted.

Gradient convention, for the whole layer: every rank holds the whole loss. A
tensor is either per-rank (this rank's slice, or this rank's partial of a
sum) or replicated (the same on every rank of a group). The gradient of a
replicated tensor is, on every rank, the whole single-device gradient; that of
a per-rank tensor is the gradient of its own slice. The collectives keep it:

  * :func:`all_reduce` (per-rank → replicated), SUM: backward is the
    identity; MIN/MAX: the cotangent goes to the rank's entries equal to the
    result, split evenly over all such entries of the group, as ``amin``
    splits it over ties;
  * :func:`all_gather` (per-rank → replicated, stacked): backward keeps the
    rank's own row;
  * :func:`vary` (a replicated tensor entering per-rank work): forward the
    identity, backward the SUM over the group of the ranks' partial
    gradients.

So parameters and Adam state are replicated, each rank's parameter gradient
equals the single-device one, and no all_reduce follows the backward. Every
all_gather is an all_reduce SUM of a zero-filled (D, ...) buffer holding the
rank's own row: exact (x + 0 = x), and gloo, which reduces CUDA tensors but
gathers only CPU ones, runs it on both.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

AXES = ("wps", "pts")
Axis = Union[str, Tuple[str, ...]]

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


class Mesh:
    """This rank's view of a ('wps', 'pts') mesh: the axis sizes (``shape``,
    as the twin's ``mesh.shape``), this rank's coordinates, the process
    group of each axis through this rank, and the device its tensors live
    on. ``groups`` maps an axis name, or a tuple of names for the groups
    spanning several axes, to a process group."""

    def __init__(self, shape: Dict[str, int], coords: Optional[Dict[str, int]],
                 groups: Dict[Axis, object], device):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.coords = coords
        self.groups = groups
        self.device = torch.device(device)

    @property
    def member(self) -> bool:
        """Whether this rank is a device of the mesh (ranks past
        ``n_devices`` are not)."""
        return self.coords is not None

    def _key(self, axis: Axis) -> Axis:
        """An axis name, or a tuple of names in mesh order (one name alone)."""
        if isinstance(axis, str):
            return axis
        names = tuple(a for a in self.axis_names if a in axis)
        return names[0] if len(names) == 1 else names

    def group(self, axis: Axis):
        if not self.member:
            raise RuntimeError("this rank is not a device of the mesh")
        return self.groups[self._key(axis)]

    def size(self, axis: Axis) -> int:
        axis = self._key(axis)
        names = axis if isinstance(axis, tuple) else (axis,)
        return int(np.prod([self.shape[a] for a in names]))

    def index(self, axis: Axis) -> int:
        """This rank's position along ``axis`` (row-major over a tuple)."""
        if not self.member:
            raise RuntimeError("this rank is not a device of the mesh")
        axis = self._key(axis)
        idx = 0
        for a in axis if isinstance(axis, tuple) else (axis,):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def __repr__(self):
        return f"Mesh(shape={self.shape}, coords={self.coords}, device={self.device})"


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    wps: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ('wps', 'pts') mesh over the first ``n_devices`` ranks of the
    running ``torch.distributed`` world (all of them by default).

    Collective: every rank of the world calls it, in the same order as its
    other group creations. ``devices[r]`` is rank r's device (default: the
    card, ``cuda``); pass ``["cpu"] * n`` for CPU ranks. With wps=1 this is
    a pure point-sharding mesh; wps>1 also shards the waypoint axis."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed: call init_process_group (or "
                           "parallel.multihost.initialize_distributed) on every rank first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"n_devices={n_devices} exceeds the {world} ranks of the world")
    if n_devices % wps != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by wps={wps}")
    n_pts = n_devices // wps
    grid = np.arange(n_devices).reshape(wps, n_pts)
    member = rank < n_devices
    a, b = (rank // n_pts, rank % n_pts) if member else (None, None)
    groups: Dict[Axis, object] = {}
    # every rank takes part in creating every group, members or not
    for row in range(wps):
        g = dist.new_group(grid[row].tolist())
        if row == a:
            groups["pts"] = g
    for col in range(n_pts):
        g = dist.new_group(grid[:, col].tolist())
        if col == b:
            groups["wps"] = g
    g = dist.new_group(grid.reshape(-1).tolist())
    if member:
        groups[AXES] = g
    device = torch.device("cuda") if devices is None else torch.device(devices[rank % len(devices)])
    coords = {"wps": a, "pts": b} if member else None
    return Mesh({"wps": wps, "pts": n_pts}, coords, groups, device)


def _slice(mesh: Mesh, x, axis: str) -> torch.Tensor:
    n, d = x.shape[0], mesh.shape[axis]
    if n % d:
        raise ValueError(f"size {n} not divisible by mesh axis '{axis}'={d}; "
                         "pad with a valid mask first (utils.data.pad_points)")
    i, m = mesh.index(axis), n // d
    return _to(mesh, x[i * m:(i + 1) * m])


def _to(mesh: Mesh, x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(mesh.device).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x), device=mesh.device)


def points_sharding(mesh: Mesh, x) -> torch.Tensor:
    """This rank's slice of an (N, ...) cloud or (N,) mask along 'pts'."""
    return _slice(mesh, x, "pts")


def waypoint_sharding(mesh: Mesh, x) -> torch.Tensor:
    """This rank's slice of a (W, ...) waypoint-major tensor along 'wps'."""
    return _slice(mesh, x, "wps")


def replicated(mesh: Mesh, x) -> torch.Tensor:
    """The whole tensor, on the mesh's device."""
    return _to(mesh, x)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def all_reduce_(x: torch.Tensor, mesh: Mesh, axis: Axis, op: str = "sum") -> torch.Tensor:
    """In-place all_reduce of ``x`` over ``axis``; no gradient. Returns x."""
    dist.all_reduce(x, op=_OPS[op], group=mesh.group(axis))
    return x


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, op):
        y = all_reduce_(x.clone(), mesh, axis, op)
        ctx.op = op
        if op != "sum":
            tie = (x == y).to(x.dtype)
            ctx.save_for_backward(tie, all_reduce_(tie.clone(), mesh, axis))
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.op == "sum":
            return g, None, None, None
        tie, count = ctx.saved_tensors
        return g * tie / torch.clamp(count, min=1.0), None, None, None


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: Axis, op: str = "sum") -> torch.Tensor:
    """Per-rank → replicated reduction over ``axis`` (``op`` sum, min or
    max), differentiable under the module's convention."""
    return _AllReduce.apply(x, mesh, axis, op)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.index = mesh.index(axis)
        dtype = torch.int32 if x.dtype == torch.bool else x.dtype
        buf = x.new_zeros((mesh.size(axis),) + tuple(x.shape), dtype=dtype)
        buf[ctx.index] = x
        all_reduce_(buf, mesh, axis)
        return buf.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index], None, None


def all_gather(x: torch.Tensor, mesh: Mesh, axis: Axis) -> torch.Tensor:
    """Per-rank (...) → replicated (D, ...), row i from the rank at index i
    of ``axis``; backward keeps this rank's row."""
    return _AllGather.apply(x, mesh, axis)


class _Vary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.mesh, ctx.axis), None, None


def vary(x: torch.Tensor, mesh: Mesh, axis: Axis) -> torch.Tensor:
    """A replicated tensor entering per-rank work on ``axis``: the identity
    forward, the SUM over the group of its per-rank gradients backward. A
    tensor that needs no gradient passes through untouched."""
    if not x.requires_grad:
        return x
    return _Vary.apply(x, mesh, axis)
