"""The port's parallel layer, second part: ``parallel/hpr_sharded.py``,
``parallel/pose_sharded.py`` and ``parallel/wps_sharded.py``, on gloo CPU
ranks (``torch_parallel_ranks.hpr_checks``: one 4-rank world, meshes D = 1,
2, 4 and 2×2, the 'pts' axis carrying the cloud).

The scene is the closed room of ``tests/test_torch_hpr_binned.py`` padded
to 4,096 points, seen from the first waypoints of its path, where no point
is alone in its direction bin (asserted here): there the JAX binned tier is
an exact reference. Cap 64 (below the bins' counts, so the stratified
columns take part).

- ``hpr_mask_soft_binned_sharded`` against the port's single-card
  ``hpr_mask_soft_binned`` and the JAX single-chip one, which the JAX suite
  holds its twin to (``tests/test_hpr_sharded.py::
  test_sharded_matches_single_chip``, ``test_sharded_gradients_match``):
  mean |Δ| < 1e-4 with under 0.1% of points off by more than 0.01; the
  gradient of Σ vis·w within 5e-3 relative (those tests' pins);
- ``pose_loss_sharded`` with the soft gate (with and without the static
  occlusion gate) against ``pose_forward(soft_hpr=True,
  soft_hpr_dense_max=0)``: loss rtol 1e-4, gradients 5e-3 relative; without
  the soft gate loss rtol 1e-5, observations rtol 1e-5 / atol 1e-7,
  gradients 1e-4 relative (``tests/test_hpr_sharded.py:154-192``);
- ``wps_loss_sharded`` (three waypoints) against ``wps_forward``: plain loss
  and per-waypoint losses rtol 1e-5, observations rtol 1e-4 / atol 1e-6
  (``tests/test_wps_eval.py:219-225``), gradients 1e-4 relative; soft at
  the soft-gate pins above;
- two Adam steps of ``make_sharded_pose_step``/``make_sharded_wps_step``
  against the single-card steps: rtol 1e-4 / atol 1e-5
  (``tests/test_wps_eval.py:251-253``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402

SLICES = {"d1": [0], "d2": [0, 1], "d4": [0, 1, 2, 3], "m22": [0, 1]}
SINGLE = 1  # the rank that runs the single-card functions
SOFT = dict(loss=1e-4, grad=5e-3)
PLAIN = dict(loss=1e-5, grad=1e-4)


def _jax_refs():
    from trajectory_optimization_tpu.models.pose import PoseProblem, init_pose_params, pose_forward
    from trajectory_optimization_tpu.models.wps_opt import (
        WpsOptProblem, init_wps_params, wps_forward)
    from trajectory_optimization_tpu.ops.hpr import hpr_mask_soft_binned
    from trajectory_optimization_tpu.utils.intrinsics import default_intrinsics

    intr = default_intrinsics()
    K = intr.matrix()
    padded, valid, path, w, occ = ranks.hpr_inputs()
    V, W, O = jnp.asarray(valid), jnp.asarray(w), jnp.asarray(occ)
    out = {}
    cam = jnp.asarray(padded - path[0])
    f = lambda p: jnp.sum(hpr_mask_soft_binned(p, cap=ranks.HPR_CAP, valid=V) * W)  # noqa: E731
    out["hpr/vis"] = np.asarray(hpr_mask_soft_binned(cam, cap=ranks.HPR_CAP, valid=V))
    out["hpr/dP"] = np.asarray(jax.grad(f)(cam))
    P = jnp.asarray(padded)
    quat0 = jnp.asarray([1.0, 0.0, 0.0, 0.0])
    kw = dict(img_width=intr.width, img_height=intr.height, min_dist=1.0, max_dist=12.0,
              soft_hpr_dense_max=0, hpr_cap=ranks.HPR_CAP)
    for name, soft in (("soft", True), ("plain", False)):
        prob = PoseProblem(soft_hpr=soft, **kw)
        for gate in ((None, O) if soft else (None,)):
            tag = f"pose/{name}" + ("" if gate is None else "_occ")
            (loss, aux), g = jax.value_and_grad(
                lambda p: pose_forward(p, P, K, prob, valid=V, occlusion_mask=gate),
                has_aux=True)(init_pose_params(jnp.asarray(path[0]), quat0))
            out.update({f"{tag}/loss": np.asarray(loss), f"{tag}/obs": np.asarray(
                aux["observations"]), f"{tag}/dtrans": np.asarray(g["trans"]),
                f"{tag}/dquat": np.asarray(g["quat"])})
        wprob = WpsOptProblem(soft_hpr=soft, **kw)
        params, frozen = init_wps_params(path[:3], np.tile([1.0, 0.0, 0.0, 0.0], (3, 1)))
        (loss, aux), g = jax.value_and_grad(
            lambda p: wps_forward(p, frozen, P, K, wprob, valid=V), has_aux=True)(params)
        out.update({f"wps/{name}/loss": np.asarray(loss),
                    f"wps/{name}/losses": np.asarray(aux["losses"]),
                    f"wps/{name}/obs": np.asarray(aux["observations"]),
                    f"wps/{name}/dxy": np.asarray(g["xy"]),
                    f"wps/{name}/dyaw": np.asarray(g["yaw"])})
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel_hpr")
    ctx = ranks.start("hpr_checks", 4, out)
    try:
        jref = _jax_refs()
    finally:
        res = ranks.finish(ctx, 4, out)
    return res, jref


def _cat(res, key, mesh, axis=0):
    return np.concatenate([res[r][key] for r in SLICES[mesh]], axis=axis)


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _refs(results, mesh):
    res, jref = results
    single = {k[len("single/"):]: v for k, v in res[SINGLE].items() if k.startswith("single/")}
    return res, {"port": single, "jax": jref}


def test_the_room_isolates_no_point():
    from test_torch_hpr_binned import assert_none_isolated
    path = ranks.room_path()
    assert_none_isolated(ranks.room_scene(), path[:3], np.tile([1.0, 0.0, 0.0, 0.0], (3, 1)))


@pytest.mark.parametrize("ref", ["port", "jax"])
@pytest.mark.parametrize("mesh", list(SLICES))
def test_hpr_mask_soft_binned_sharded(results, mesh, ref):
    res, refs = _refs(results, mesh)
    want = refs[ref]
    d = np.abs(_cat(res, f"{mesh}/hpr/vis", mesh) - want["hpr/vis"])
    assert d.mean() < 1e-4, d.mean()
    assert (d > 0.01).mean() < 1e-3, (d > 0.01).sum()
    assert _rel(_cat(res, f"{mesh}/hpr/dP", mesh), want["hpr/dP"]) < 5e-3
    padded, valid, *_ = ranks.hpr_inputs()
    assert _cat(res, f"{mesh}/hpr/vis", mesh)[valid == 0].max() == 0.0


@pytest.mark.parametrize("ref", ["port", "jax"])
@pytest.mark.parametrize("tag", ["soft", "soft_occ", "plain"])
@pytest.mark.parametrize("mesh", list(SLICES))
def test_pose_loss_sharded(results, mesh, tag, ref):
    res, refs = _refs(results, mesh)
    want = refs[ref]
    k = f"pose/{tag}"
    pins = PLAIN if tag == "plain" else SOFT
    for r in range(4 if mesh in ("d4", "m22") else len(SLICES[mesh])):
        np.testing.assert_allclose(res[r][f"{mesh}/{k}/loss"], want[f"{k}/loss"],
                                   rtol=pins["loss"])
        for g in ("dtrans", "dquat"):
            assert _rel(res[r][f"{mesh}/{k}/{g}"], want[f"{k}/{g}"]) < pins["grad"], g
    if tag == "plain":
        np.testing.assert_allclose(_cat(res, f"{mesh}/{k}/obs", mesh), want[f"{k}/obs"],
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("ref", ["port", "jax"])
@pytest.mark.parametrize("tag", ["soft", "plain"])
@pytest.mark.parametrize("mesh", list(SLICES))
def test_wps_loss_sharded(results, mesh, tag, ref):
    res, refs = _refs(results, mesh)
    want = refs[ref]
    k = f"wps/{tag}"
    pins = PLAIN if tag == "plain" else SOFT
    r = SLICES[mesh][-1]
    np.testing.assert_allclose(res[r][f"{mesh}/{k}/loss"], want[f"{k}/loss"], rtol=pins["loss"])
    np.testing.assert_allclose(res[r][f"{mesh}/{k}/losses"], want[f"{k}/losses"],
                               rtol=pins["loss"])
    for g in ("dxy", "dyaw"):
        assert _rel(res[r][f"{mesh}/{k}/{g}"], want[f"{k}/{g}"]) < pins["grad"], g
    if tag == "plain":
        np.testing.assert_allclose(_cat(res, f"{mesh}/{k}/obs", mesh, axis=1), want[f"{k}/obs"],
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mesh", list(SLICES))
def test_sharded_pose_and_wps_steps_match_single_card(results, mesh):
    res, refs = _refs(results, mesh)
    for k in ("trans", "quat", "xy", "yaw"):
        for r in SLICES[mesh]:
            np.testing.assert_allclose(res[r][f"{mesh}/step/{k}"], refs["port"][f"step/{k}"],
                                       rtol=1e-4, atol=1e-5)
