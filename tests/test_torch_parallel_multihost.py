"""The port's ``parallel/multihost.py``: a real two-process run, the twin of
``tests/test_multihost_process.py``.

Two spawned processes start the ``torch.distributed`` world themselves
(``initialize_distributed`` over gloo, a second call a no-op), build the mesh
over both (``make_multihost_mesh``), and keep only their own half of the
cloud (``shard_points_multihost``): five steps of the sharded train step
through the fused passes (their plain versions on the CPU) must match the
single-device steps on the whole cloud (losses rtol 1e-4, params rtol 1e-4 /
atol 1e-5, that file's pins), and the occlusion-aware pose loss and two
steps, whose candidate tables cross the processes, the single-device
``pose_forward`` (loss rtol 1e-4, params rtol 1e-4 / atol 1e-5). Also held:
``initialize_distributed`` re-raises a real failure to start and starts
nothing when a world is up; ``make_multihost_mesh`` rejects a world that
wps does not divide.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from trajectory_optimization_tpu_torch.parallel import multihost  # noqa: E402


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("multihost")
    return ranks.finish(ranks.start("multihost_checks", 2, out), 2, out)


def test_two_process_sharded_train_step(results):
    r0, r1 = results
    for r in (r0, r1):
        np.testing.assert_allclose(r["traj/losses"], r0["ref/traj/losses"], rtol=1e-4)
        np.testing.assert_allclose(r["traj/poses"], r0["ref/traj/poses"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r["traj/quats"], r0["ref/traj/quats"], rtol=1e-4, atol=1e-5)


def test_two_process_occlusion_aware_pose_step(results):
    r0, r1 = results
    for r in (r0, r1):
        np.testing.assert_allclose(r["pose/loss0"], r0["ref/pose/loss0"], rtol=1e-4)
        np.testing.assert_allclose(r["pose/trans"], r0["ref/pose/trans"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r["pose/quat"], r0["ref/pose/quat"], rtol=1e-4, atol=1e-5)


def test_multihost_mesh_rejects_an_undivided_world(results):
    assert all(bool(r["reject"]) for r in results)


def test_initialize_distributed_reraises_real_failures(monkeypatch):
    calls = []

    def refuse(**kw):
        calls.append(kw)
        raise RuntimeError("connection refused")

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", refuse)
    with pytest.raises(RuntimeError, match="connection refused"):
        multihost.initialize_distributed("127.0.0.1:1", 2, 0, backend="gloo")
    assert calls == [dict(backend="gloo", init_method="tcp://127.0.0.1:1", world_size=2,
                          rank=0)]
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    multihost.initialize_distributed("127.0.0.1:1", 2, 0, backend="gloo")  # a world is up
    assert len(calls) == 1
