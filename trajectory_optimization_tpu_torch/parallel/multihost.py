"""Multi-host scale-out helpers.

Twin of ``trajectory_optimization_tpu/parallel/multihost.py``: start the
``torch.distributed`` world from the environment (or explicit arguments),
build a ('wps', 'pts') mesh over all of its ranks with each host's ranks
contiguous along 'pts', and keep each rank's own slice of the cloud. The
per-waypoint min/max and mean-reward all_reduces then cross hosts once per
step (a few KB), while all heavy elementwise work stays local.
``tests/test_torch_parallel_multihost.py`` runs two processes over gloo,
the CPU stand-in for the interconnect.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from trajectory_optimization_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: str = "nccl",
) -> None:
    """Start the ``torch.distributed`` world (a no-op if one is up).

    ``coordinator_address`` is ``host:port`` of rank 0 (``tcp://`` is
    added); without it, ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK`` come from the environment (``env://``). ``backend`` is the
    caller's: ``nccl`` (the default, one rank per card) or ``gloo``. A
    failure to start (a refused connection, a timeout, a port in use) is
    raised, never swallowed."""
    if dist.is_initialized():
        return
    init_method = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend=backend, init_method=init_method, **kwargs)


def make_multihost_mesh(*, wps: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """('wps', 'pts') mesh over all ranks of the world, ranks in order along
    'pts' (a host's ranks are contiguous when ranks are numbered by host)."""
    n = dist.get_world_size()
    if n % wps != 0:
        raise ValueError(f"{n} devices not divisible by wps={wps}")
    return make_mesh(n, wps=wps, devices=devices)


def shard_points_multihost(mesh: Mesh, local_points, local_valid):
    """This rank's own (n_local, 3) slice and (n_local,) mask as f32 tensors
    on the mesh's device: the global cloud is the ranks' slices in rank
    order, and no host ever holds all of it."""
    pts = torch.as_tensor(np.asarray(local_points, np.float32), device=mesh.device)
    val = torch.as_tensor(np.asarray(local_valid, np.float32), device=mesh.device)
    return pts, val
