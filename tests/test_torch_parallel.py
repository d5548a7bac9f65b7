"""The port's parallel layer, first part: ``parallel/mesh.py``,
``parallel/sharded_pallas.py`` and ``parallel/sharded.py``, on gloo CPU
ranks.

One 4-rank world per file (``torch_parallel_ranks.pallas_checks``, spawned
once by the module fixture while the parent computes the JAX references)
holds every module at D = 1, 2, 4 and on the 2×2 mesh:

- ``sharded_fused_lo_sum`` (the fused passes' plain versions on the CPU),
  both regimes (uncached forced by ``SCORE_CACHE_MAX_BYTES = 0``), against
  the port's single-device ``fused_lo_sum``: ``lo`` ``torch.equal`` on the
  point-only meshes (the min/max are exact, pass B is per point), within
  rtol 1e-4 / atol 2e-4 on the 2×2 mesh (two waypoint shards add their
  partials); gradients of Σ lo·g ``torch.equal`` at D = 1, within rtol/atol
  2e-3 elsewhere; and against the JAX twin on the 8-device virtual mesh's
  2×2 sub-mesh at the same pins (``tests/test_sharded_pallas.py``);
- ``make_sharded_train_step``, 5 steps with the kernel path ('pallas') and
  the plain path ('xla'), against the port's single-device step (value_and
  grad of ``traj_forward`` + ``make_optimizer``): losses rtol 1e-4, params
  rtol 5e-3 / atol 5e-4 (``tests/test_sharded_pallas.py:176-181``), equal
  at D = 1; the plain path also against the JAX twin's 'xla' step on 4
  virtual devices at ``tests/test_sharding.py``'s pins (loss rtol 1e-5,
  poses atol 1e-5);
- ``shardmap_visibility`` against the single-device rewards of both
  packages, atol 1e-6 (the JAX twin is held to JAX ``traj_forward`` by
  ``tests/test_sharding.py::test_shardmap_visibility_matches_single_device``;
  its shard_map takes ~15 s to compile here, so the port is held to that
  function);
- the rejections: an undivisible cloud, a partial mesh, soft HPR on the
  kernel path, a mesh size not divisible by wps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from trajectory_optimization_tpu_torch.models.traj import TrajProblem  # noqa: E402
from trajectory_optimization_tpu_torch.opt.engine import OptimizerConfig  # noqa: E402
from trajectory_optimization_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from trajectory_optimization_tpu_torch.parallel.sharded import (  # noqa: E402
    make_sharded_train_step,
    shard_points,
)
from trajectory_optimization_tpu_torch.parallel.sharded_pallas import (  # noqa: E402
    pad_multiple,
    sharded_fused_lo_sum,
)
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

INTR = default_intrinsics()
# the ranks holding one copy of the cloud, in slice order
SLICES = {"d1": [0], "d2": [0, 1], "d4": [0, 1, 2, 3], "m22": [0, 1]}


def _jax_refs():
    from trajectory_optimization_tpu.models.traj import TrajProblem as JProblem
    from trajectory_optimization_tpu.models.traj import init_traj_params, traj_forward
    from trajectory_optimization_tpu.opt.engine import OptimizerConfig as JConfig
    from trajectory_optimization_tpu.parallel.mesh import make_mesh
    from trajectory_optimization_tpu.parallel.sharded import make_sharded_train_step as jstep
    from trajectory_optimization_tpu.parallel.sharded import shard_points as jshard
    from trajectory_optimization_tpu.parallel.sharded_pallas import sharded_fused_lo_sum as jlo
    from trajectory_optimization_tpu.utils.intrinsics import default_intrinsics as jintr

    ji = jintr()
    K = ji.matrix()
    out = {}
    pts, q, t, g = ranks.pallas_inputs()
    mesh22 = make_mesh(4, wps=2)
    P, G = jnp.asarray(pts), jnp.asarray(g)
    f = lambda q_, t_: jnp.sum(jlo(mesh22, P, q_, t_, K, ji.width, ji.height) * G)  # noqa: E731
    out["lo"] = np.asarray(jlo(mesh22, P, jnp.asarray(q), jnp.asarray(t), K, ji.width, ji.height))
    dq, dt = jax.grad(f, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(t))
    out["dq"], out["dt"] = np.asarray(dq), np.asarray(dt)

    padded, valid, path, quats = ranks.train_inputs()
    mesh4 = make_mesh(4)
    prob = JProblem(img_width=ji.width, img_height=ji.height, wps_step=2, backend="xla")
    init_fn, step_fn = jstep(mesh4, prob, JConfig(lr_pose=0.1, lr_quat=0.02))
    Pj, Vj = jshard(mesh4, padded, valid)
    params = init_traj_params(path, quats)
    opt = init_fn(params)
    p0, q0 = jnp.asarray(path), jnp.asarray(quats)
    losses = []
    for _ in range(ranks.TRAIN_STEPS):
        params, opt, loss, _ = step_fn(params, opt, Pj, Vj, K, p0, q0)
        losses.append(float(loss))
    out["losses"], out["poses"] = np.asarray(losses), np.asarray(params["poses"])
    _, aux = traj_forward(init_traj_params(path, quats), jnp.asarray(padded), K, p0, q0, prob,
                          valid=jnp.asarray(valid))
    out["rewards"] = np.asarray(aux["rewards"])
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel")
    ctx = ranks.start("pallas_checks", 4, out)
    try:
        jref = _jax_refs()
    finally:
        res = ranks.finish(ctx, 4, out)
    return res, jref


def _cat(res, key, mesh):
    return np.concatenate([res[r][key] for r in SLICES[mesh]])


def _whole(res, key, mesh):
    """A replicated value: every rank of the mesh holds the same."""
    vals = [res[r][key] for r in range(len(SLICES[mesh]) * (2 if mesh == "m22" else 1))]
    for v in vals[1:]:
        np.testing.assert_array_equal(v, vals[0])
    return vals[0]


@pytest.mark.parametrize("regime", ["cached", "uncached"])
@pytest.mark.parametrize("mesh", list(SLICES))
def test_sharded_fused_lo_sum_matches_single_device(results, mesh, regime):
    res, _ = results
    single = {k: res[0][f"single/{regime}/{k}"] for k in ("lo", "dq", "dt")}
    lo = _cat(res, f"{mesh}/{regime}/lo", mesh)
    dq, dt = (_whole(res, f"{mesh}/{regime}/{k}", mesh) for k in ("dq", "dt"))
    if mesh == "m22":
        np.testing.assert_array_equal(_cat(res, f"{mesh}/{regime}/lo", mesh),
                                      np.concatenate([res[2][f"m22/{regime}/lo"],
                                                      res[3][f"m22/{regime}/lo"]]))
        np.testing.assert_allclose(lo, single["lo"], rtol=1e-4, atol=2e-4)
    else:
        np.testing.assert_array_equal(lo, single["lo"])
    if mesh == "d1":
        np.testing.assert_array_equal(dq, single["dq"])
        np.testing.assert_array_equal(dt, single["dt"])
    np.testing.assert_allclose(dq, single["dq"], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(dt, single["dt"], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("mesh", list(SLICES))
def test_sharded_fused_lo_sum_matches_the_jax_twin(results, mesh):
    res, jref = results
    np.testing.assert_allclose(_cat(res, f"{mesh}/cached/lo", mesh), jref["lo"],
                               rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(_whole(res, f"{mesh}/cached/dq", mesh), jref["dq"],
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_whole(res, f"{mesh}/cached/dt", mesh), jref["dt"],
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("mesh", list(SLICES))
def test_sharded_train_step_matches_single_device(results, mesh, backend):
    res, _ = results
    losses, poses, quats = (_whole(res, f"{mesh}/{backend}/{k}", mesh)
                            for k in ("losses", "poses", "quats"))
    single = {k: res[0][f"single/{backend}/{k}"] for k in ("losses", "poses", "quats")}
    if mesh == "d1":
        np.testing.assert_array_equal(losses, single["losses"])
        np.testing.assert_array_equal(poses, single["poses"])
    np.testing.assert_allclose(losses, single["losses"], rtol=1e-4)
    np.testing.assert_allclose(poses, single["poses"], rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(quats, single["quats"], rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("mesh", list(SLICES))
def test_sharded_train_step_matches_the_jax_twin(results, mesh):
    res, jref = results
    np.testing.assert_allclose(_whole(res, f"{mesh}/xla/losses", mesh), jref["losses"], rtol=1e-5)
    np.testing.assert_allclose(_whole(res, f"{mesh}/xla/poses", mesh), jref["poses"], atol=1e-5)


@pytest.mark.parametrize("mesh", list(SLICES))
def test_shardmap_visibility_matches_single_device(results, mesh):
    res, jref = results
    rewards = _cat(res, f"{mesh}/rewards", mesh)
    np.testing.assert_allclose(rewards, res[0]["single/rewards"], atol=1e-6)
    np.testing.assert_allclose(rewards, jref["rewards"], atol=1e-6)


def _fake_mesh(shape, coords):
    """A mesh whose collectives are never reached: the checks before them."""
    return tmesh.Mesh(shape, coords, {}, "cpu")


def test_rejections(results):
    res, _ = results
    assert bool(res[0]["reject/make_mesh"])
    mesh = _fake_mesh({"wps": 1, "pts": 4}, {"wps": 0, "pts": 1})
    assert pad_multiple(mesh) == 8 * 128 * 4
    pts, q, t, _ = ranks.pallas_inputs()
    with pytest.raises(ValueError, match="not divisible"):
        shard_points(mesh, pts[:1001])
    with pytest.raises(ValueError, match="multiple of 4096"):
        sharded_fused_lo_sum(mesh, torch.as_tensor(pts[:250]), torch.as_tensor(q),
                             torch.as_tensor(t), INTR.matrix(), INTR.width, INTR.height)
    with pytest.raises(ValueError, match="'wps', 'pts'"):
        sharded_fused_lo_sum(_fake_mesh({"pts": 4}, {"pts": 0}), torch.as_tensor(pts[:2048]),
                             torch.as_tensor(q), torch.as_tensor(t), INTR.matrix(),
                             INTR.width, INTR.height)
    prob = TrajProblem(img_width=INTR.width, img_height=INTR.height, soft_hpr=True,
                       backend="pallas")
    with pytest.raises(ValueError, match="does not support soft_hpr"):
        make_sharded_train_step(mesh, prob, OptimizerConfig())


def test_sharding_helpers_slice_by_coordinates():
    mesh = _fake_mesh({"wps": 2, "pts": 2}, {"wps": 1, "pts": 0})
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    assert torch.equal(tmesh.points_sharding(mesh, x), torch.as_tensor(x[:4]))
    assert torch.equal(tmesh.waypoint_sharding(mesh, x), torch.as_tensor(x[4:]))
    assert torch.equal(tmesh.replicated(mesh, x), torch.as_tensor(x))
    assert (mesh.index(("pts", "wps")), mesh.size(("wps", "pts"))) == (2, 4)
