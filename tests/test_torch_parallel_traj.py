"""The port's parallel layer, third part: ``parallel/traj_sharded.py`` and
``parallel/traj_frozen_sharded.py``, on gloo CPU ranks
(``torch_parallel_ranks.traj_checks``: one 4-rank world, meshes D = 1, 2, 4
and 2×2; on the 2×2 mesh the five waypoints pad to six).

The room of ``tests/test_torch_hpr_binned.py`` padded to 4,096 points and
the first five waypoints of its path (no point isolated, asserted), soft HPR
binned at cap 64.

- ``traj_soft_hpr_loss_sharded`` against the port's and the JAX
  single-chip ``traj_forward(soft_hpr=True, soft_hpr_dense_max=0)``, which
  the JAX suite holds its twin to (``tests/test_traj_sharded.py::
  test_loss_grad_parity``): loss rtol 1e-4, gradients 5e-3 relative;
  rewards within 5e-5 (``tests/test_traj_frozen_sharded.py:124``);
- ``make_sharded_traj_step``, two Adam steps, against the single-card steps:
  rtol 1e-4 / atol 1e-5;
- ``build_frozen_sharded_plan`` ``assert_array_equal`` to the JAX twin's
  plan, every array;
- ``traj_frozen_loss_sharded`` at a refresh against the port's
  single-chip ``traj_forward_frozen`` at the pins of
  ``tests/test_traj_frozen_sharded.py::test_sharded_frozen_matches_single_chip``
  (loss within 1e-6 relative, rewards within 1e-6, gradients 1e-4
  relative), and against the JAX one, whose gate norms are f32, at the
  cross-package pins of ``PINS``;
- ``FrozenShardedTrajOptimizer`` against ``FrozenTrajOptimizer`` over four
  steps with a refresh every two, synchronous (losses within 1e-3 relative,
  final poses within 0.01) and asynchronous (2e-2), the pins of
  ``test_sharded_frozen_runner_padding_and_valid``; the runners' threads
  are joined (``close()``);
- the rejections: the soft-HPR step without soft HPR, a plan built for
  other waypoints.
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
from trajectory_optimization_tpu_torch.parallel import traj_frozen_sharded as tfs  # noqa: E402
from trajectory_optimization_tpu_torch.parallel.traj_sharded import (  # noqa: E402
    make_sharded_traj_step,
)
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

INTR = default_intrinsics()
SLICES = {"d1": [0], "d2": [0, 1], "d4": [0, 1, 2, 3], "m22": [0, 1]}
SINGLE = 1
# the frozen loss against the port's own single-chip function: the JAX
# sharded-vs-single pins; against the JAX one, whose gate norms are f32 where
# the port's are float64 (ops.hpr.gate_norms): the port's frozen-vs-JAX loss
# pin (tests/test_torch_traj_frozen.py, rtol 1e-5), the JAX cross leg's
# rewards pin (tests/test_traj_frozen_sharded.py:124, 5e-5) and its
# occlusion-aware gradient pin (tests/test_traj_sharded.py::
# test_loss_grad_parity, relative norm 5e-3)
PINS = {"port": dict(loss=1e-6, rewards=1e-6, grad=1e-4),
        "jax": dict(loss=1e-5, rewards=5e-5, grad=5e-3)}


def _jax_problem():
    from trajectory_optimization_tpu.models.traj import TrajProblem as JProblem
    return JProblem(img_width=INTR.width, img_height=INTR.height, min_dist=1.0, max_dist=12.0,
                    wps_step=1, soft_hpr=True, soft_hpr_dense_max=0, hpr_cap=ranks.HPR_CAP)


def _jax_refs():
    from trajectory_optimization_tpu.models.traj import init_traj_params, traj_forward
    from trajectory_optimization_tpu.models.traj_frozen import build_traj_plan, traj_forward_frozen

    padded, valid, path, quats, _ = ranks.traj_inputs(INTR)
    prob = _jax_problem()
    K = jnp.asarray(INTR.matrix().numpy())
    P, V = jnp.asarray(padded), jnp.asarray(valid)
    p0, q0 = jnp.asarray(path), jnp.asarray(quats)
    params = init_traj_params(path, quats)
    out = {}
    (loss, aux), g = jax.value_and_grad(
        lambda p: traj_forward(p, P, K, p0, q0, prob, valid=V), has_aux=True)(params)
    out.update({"soft/loss": loss, "soft/rewards": aux["rewards"], "soft/dposes": g["poses"],
                "soft/dquats": g["quats"]})
    plan_np, meta = build_traj_plan(padded, valid, path, quats, np.asarray(K), prob)
    plan = {k: jnp.asarray(v) for k, v in plan_np.items() if not k.startswith("_")}
    (loss, aux), g = jax.value_and_grad(
        lambda p: traj_forward_frozen(p, plan, meta, P, K, p0, q0, prob, valid=V),
        has_aux=True)(params)
    out.update({"frozen/loss": loss, "frozen/rewards": aux["rewards"],
                "frozen/dposes": g["poses"], "frozen/dquats": g["quats"]})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel_traj")
    ctx = ranks.start("traj_checks", 4, out)
    try:
        jref = _jax_refs()
    finally:
        res = ranks.finish(ctx, 4, out)
    single = {k[len("single/"):]: v for k, v in res[SINGLE].items() if k.startswith("single/")}
    return res, {"port": single, "jax": jref}


def _cat(res, key, mesh):
    return np.concatenate([res[r][key] for r in SLICES[mesh]])


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_the_room_path_isolates_no_point():
    from test_torch_hpr_binned import assert_none_isolated
    _, _, path, quats, _ = ranks.traj_inputs(INTR)
    assert_none_isolated(ranks.room_scene(), path, quats)


@pytest.mark.parametrize("ref", ["port", "jax"])
@pytest.mark.parametrize("mesh", list(SLICES))
def test_traj_soft_hpr_loss_sharded(results, mesh, ref):
    res, refs = results
    want = refs[ref]
    for r in range(4 if mesh in ("d4", "m22") else len(SLICES[mesh])):
        np.testing.assert_allclose(res[r][f"{mesh}/soft/loss"], want["soft/loss"], rtol=1e-4)
        for g in ("dposes", "dquats"):
            assert _rel(res[r][f"{mesh}/soft/{g}"], want[f"soft/{g}"]) < 5e-3, g
    d = np.abs(_cat(res, f"{mesh}/soft/rewards", mesh) - want["soft/rewards"])
    assert d.max() < 5e-5, d.max()


@pytest.mark.parametrize("mesh", list(SLICES))
def test_sharded_traj_step_matches_single_card(results, mesh):
    res, refs = results
    for k in ("poses", "quats"):
        for r in SLICES[mesh]:
            np.testing.assert_allclose(res[r][f"{mesh}/step/{k}"], refs["port"][f"step/{k}"],
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (2, 1)])
def test_frozen_sharded_plan_equals_the_jax_twin(shape):
    from trajectory_optimization_tpu.parallel.traj_frozen_sharded import (
        build_frozen_sharded_plan as jbuild)
    padded, valid, path, quats, prob = ranks.traj_inputs(INTR)
    K = INTR.matrix().numpy()
    tplan, tmeta = tfs.build_frozen_sharded_plan(padded, valid, path, quats, K, prob,
                                                 d_wps=shape[0], d_pts=shape[1])
    jplan, jmeta = jbuild(padded, valid, path, quats, K, _jax_problem(),
                          d_wps=shape[0], d_pts=shape[1])
    assert tmeta.__dict__ == jmeta.__dict__
    assert sorted(tplan) == sorted(jplan)
    for k in jplan:
        np.testing.assert_array_equal(tplan[k], jplan[k], err_msg=k)


@pytest.mark.parametrize("ref", ["port", "jax"])
@pytest.mark.parametrize("mesh", list(SLICES))
def test_traj_frozen_loss_sharded(results, mesh, ref):
    res, refs = results
    want = refs[ref]
    for r in range(4 if mesh in ("d4", "m22") else len(SLICES[mesh])):
        loss = res[r][f"{mesh}/frozen/loss"]
        assert abs(loss - want["frozen/loss"]) / abs(want["frozen/loss"]) < PINS[ref]["loss"]
        for g in ("dposes", "dquats"):
            assert _rel(res[r][f"{mesh}/frozen/{g}"], want[f"frozen/{g}"]) < PINS[ref]["grad"], g
    d = np.abs(_cat(res, f"{mesh}/frozen/rewards", mesh) - want["frozen/rewards"])
    assert d.max() < PINS[ref]["rewards"], d.max()


@pytest.mark.parametrize("mode,pin", [("sync", 1e-3), ("async", 2e-2)])
@pytest.mark.parametrize("mesh", list(SLICES))
def test_frozen_sharded_runner_tracks_the_single_card_runner(results, mesh, mode, pin):
    res, refs = results
    want = refs["port"]
    for r in SLICES[mesh]:
        a, b = res[r][f"{mesh}/runner_{mode}/losses"], want[f"runner_{mode}/losses"]
        assert np.max(np.abs(a - b) / np.abs(b)) < pin
        if mode == "sync":
            pd = np.linalg.norm(res[r][f"{mesh}/runner_{mode}/poses"] - want["runner_sync/poses"])
            assert pd < 0.01, pd


def test_rejections():
    mesh = tmesh.Mesh({"wps": 2, "pts": 2}, {"wps": 0, "pts": 1}, {}, "cpu")
    prob = TrajProblem(img_width=INTR.width, img_height=INTR.height)
    with pytest.raises(ValueError, match="occlusion-aware"):
        make_sharded_traj_step(mesh, prob, OptimizerConfig())
    padded, valid, path, quats, sprob = ranks.traj_inputs(INTR)
    _, meta = tfs.build_frozen_sharded_plan(padded, valid, path, quats, INTR.matrix().numpy(),
                                            sprob, d_wps=2, d_pts=2)
    params = {"poses": torch.as_tensor(path[:3]), "quats": torch.as_tensor(quats[:3])}
    with pytest.raises(ValueError, match="rebuild the plan"):
        tfs.traj_frozen_loss_sharded(mesh, params, {}, meta, torch.as_tensor(padded[:2048]),
                                     torch.as_tensor(valid[:2048]), INTR.matrix(),
                                     torch.as_tensor(path), sprob)
    with pytest.raises(ValueError, match="not divisible"):
        tfs.build_frozen_sharded_plan(padded[:4095], None, path, quats, INTR.matrix().numpy(),
                                      sprob, d_wps=1, d_pts=2)
