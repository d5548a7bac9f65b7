"""Parity of the port's frozen-routing engine (``models/traj_frozen.py``)
with ``trajectory_optimization_tpu.models.traj_frozen``, on the CPU with
one torch thread, on tests/test_traj_frozen.py's scene (4,096 points, 4
waypoints, cap 256) and the room of tests/test_torch_hpr_binned.py.

Held, with the JAX suite's own pins:

* the host plan ``assert_array_equal`` to JAX's, key by key, with and
  without the embedding, under ``owner`` and ``wp_active``, with padding
  and on the big-bin scene of tests/test_traj_frozen.py (stratified ext
  coverers);
* ``perm_apply``'s values and VJP equal to JAX's custom VJP;
* at a refresh, the frozen loss, rewards and gradients against the port's
  own per-step routed ``traj_forward(soft_hpr=True, soft_hpr_dense_max=0)``
  (rtol 1e-5, atol 1e-6, gradient relnorm 1e-4), and the gated scores
  against JAX's ``frozen_soft_hpr_scores`` at every point whose query rows
  have a valid pair in every grid (99.8% within 3e-3 and the 0.5 threshold
  on more than 99.9%: the binned tier's pins; one f32 rounding of the
  sigmoid's argument, ~8e4 here, moves the mask ~2e-3); the frozen loss
  against JAX's on the room, where the test asserts that no query is
  isolated (loss rtol 1e-5, gradients rtol 2e-3 with atol 2e-3 of the
  largest entry, the binned tier's pin);
* the sparse mean against the embedding path (rtol 1e-6, gradients 1e-4),
  also under a valid mask;
* the runner against the per-step routed runner over 12 steps at
  ``refresh_every=4`` (losses rtol 1e-3 and positions 0.01 in sync mode,
  2e-2 and 0.3 in async mode), and against JAX's ``FrozenTrajOptimizer``
  on the room (the first 12 losses within rtol 1e-4, sync refresh);
* a finite gradient with a point at a waypoint; padding inert;
* ``FrozenWpsOptimizer`` and ``FrozenPoseOptimizer`` at a refresh against
  their per-step losses (rtol 1e-4), the loss falling over 8 steps;
* ``close()`` joins the plan builder's worker thread.

Isolated queries. A query alone in its bin in some grid has no valid pair
in its tile row; the jitted JAX twin on the CPU may read such a row as +inf
where the port keeps the −1e30 sentinel (tests/test_torch_hpr_binned.py).
The plan, equal in both packages, lists them (``_isolated_queries``).
"""
import dataclasses
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from test_torch_hpr_binned import room_path, room_scene  # noqa: E402
from trajectory_optimization_tpu.models import traj_frozen as jf  # noqa: E402
from trajectory_optimization_tpu.models.traj import (  # noqa: E402
    TrajProblem as JTrajProblem,
    init_traj_params as j_init,
)
from trajectory_optimization_tpu_torch import models as tmodels  # noqa: E402
from trajectory_optimization_tpu_torch.models import traj_frozen as tf  # noqa: E402
from trajectory_optimization_tpu_torch.models.traj import (  # noqa: E402
    TrajProblem,
    init_traj_params,
    traj_forward,
)
from trajectory_optimization_tpu_torch.opt.engine import (  # noqa: E402
    OptimizerConfig,
    apply_updates,
    make_optimizer,
    value_and_grad,
)
from trajectory_optimization_tpu_torch.utils.data import identity_quaternions  # noqa: E402
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

OPT = OptimizerConfig(lr_pose=0.1, lr_quat=0.02)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem_kw(cap=256):
    intr = default_intrinsics()
    return dict(img_width=intr.width, img_height=intr.height, wps_step=1, soft_hpr=True,
                soft_hpr_dense_max=0, hpr_cap=cap)


@pytest.fixture(scope="module")
def scene():
    """tests/test_traj_frozen.py's scene."""
    rng = np.random.default_rng(0)
    n = 4096
    pts = (rng.normal(size=(n, 3)) * [6, 6, 2] + [5, 0, 1]).astype(np.float32)
    t = np.linspace(0, 1, 4, dtype=np.float32)
    poses0 = np.stack([t * 4, t * 1.5, 0.5 + 0 * t], axis=1).astype(np.float32)
    return pts, poses0, identity_quaternions(4), default_intrinsics().matrix_np(), \
        TrajProblem(**_problem_kw())


@pytest.fixture(scope="module")
def room():
    """The closed room seen from the first five of its seven waypoints, cap
    256 (from the last two, one query of the plan is isolated)."""
    path = room_path()[:5]
    return (room_scene().astype(np.float32), path, identity_quaternions(len(path)),
            default_intrinsics().matrix_np(), TrajProblem(**_problem_kw()))


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _jplan(plan):
    return {k: jnp.asarray(v) for k, v in plan.items() if not k.startswith("_")}


def _isolated_queries(plan, meta):
    """(W, N) bool: the point is a query of waypoint w with no valid pair in
    its tile row in at least one grid."""
    W, G, T, cap = meta.n_sel, meta.n_grids, meta.tiles, meta.cap
    s = tf.stage_plan(plan, meta)
    qb, ck = s["q_bin"].numpy(), s["c_key"].numpy()
    qr, cr = s["q_row"].numpy(), s["c_row"].numpy()
    has = np.zeros((W * G * T, cap), bool)  # tiles off ``live`` hold no query
    has[s["live"].numpy()] = ((qb[:, :, None] == ck[:, None, :])
                              & (qr[:, :, None] != cr[:, None, :])).any(-1)
    lonely = plan["qmask"] & ~has.reshape(W, G, T * cap)
    out = np.zeros((W, meta.n_points), bool)
    for w in range(W):
        for g in range(G):
            out[w, plan["_q_id"][w, g][lonely[w, g]]] = True
    return out


def _grads(loss_fn, params):
    """(loss, aux, grads) of a port loss at ``params`` (dict of arrays)."""
    return value_and_grad(loss_fn, {k: _t(v) for k, v in params.items()})


def _relnorm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_exported_like_the_jax_package():
    for name in ("FrozenPlanConfig", "FrozenTrajOptimizer", "FrozenWpsOptimizer",
                 "FrozenPoseOptimizer"):
        assert getattr(tmodels, name) is getattr(tf, name)


def _big_bin_scene():
    """tests/test_traj_frozen.py's big-bin scene: 6,144 points in a tight
    blob, 3 waypoints, cap 64 (over-full bins, stratified ext coverers)."""
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(6144, 3)) * [2, 2, 0.5] + [6, 0, 1]).astype(np.float32)
    t = np.linspace(0, 1, 3, dtype=np.float32)
    poses0 = np.stack([t * 2, t * 1.0, 0.5 + 0 * t], axis=1).astype(np.float32)
    return pts, poses0, identity_quaternions(3), default_intrinsics().matrix_np(), 64


@pytest.mark.parametrize("case", ["embed", "sparse", "owner", "wp_active", "valid", "big_bin",
                                  "floors"])
def test_plan_equals_jax(scene, case):
    pts, poses0, quats0, K, problem = scene
    cap, valid, kw = 256, None, {}
    if case == "sparse":
        kw = dict(embed=False)
    elif case == "owner":
        kw = dict(owner=(1000, 3000))
    elif case == "wp_active":
        kw = dict(wp_active=np.array([True, False, True, True]))
    elif case == "valid":
        pts = np.concatenate([pts, np.full((512, 3), 1e6, np.float32)])
        valid = np.concatenate([np.ones(4096, np.float32), np.zeros(512, np.float32)])
    elif case == "big_bin":
        pts, poses0, quats0, K, cap = _big_bin_scene()
    elif case == "floors":
        kw = dict(min_tiles=40, min_t_big=9)
    kw_p = {**_problem_kw(cap)}
    jp, jm = jf.build_traj_plan(pts, valid, poses0, quats0, K, JTrajProblem(**kw_p), **kw)
    tp, tm = tf.build_traj_plan(pts, valid, poses0, quats0, K, TrajProblem(**kw_p), **kw)
    assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert jp[k].dtype == tp[k].dtype, k
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    if case == "big_bin":
        assert (tp["c_sel"] >= 0).sum() > 100  # really exercises ext tiles
    if case == "valid":
        assert (tp["_q_id"] < 4096).all()  # no padded point in any layout


def test_perm_apply_values_and_vjp_equal_jax():
    """tests/test_traj_frozen.py's permutation: slot j goes to dest[j], some
    slots land past ``n_out``; values and the VJP of a random cotangent
    equal the twin's custom VJP exactly."""
    rng = np.random.default_rng(1)
    m, n_out, n_ext = 6, 9, 12
    dest = rng.permutation(n_ext)
    inv = np.argsort(dest)
    x = rng.normal(size=(2, m)).astype(np.float32)
    cot = rng.normal(size=(2, n_out)).astype(np.float32)
    fk, bk = np.broadcast_to(dest, (2, n_ext)), np.broadcast_to(inv, (2, n_ext))

    j_out, j_vjp = jax.vjp(lambda xx: jf.perm_apply(jnp.asarray(fk), jnp.asarray(bk), xx,
                                                    7.5, n_out), jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    t_out = tf.perm_apply(_t(fk, torch.int64), _t(bk, torch.int64), xt, 7.5, n_out)
    t_out.backward(_t(cot))
    np.testing.assert_array_equal(t_out.detach().numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(j_vjp(jnp.asarray(cot))[0]))


def test_frozen_matches_per_step_routing_at_refresh(scene):
    """At a refresh the frozen loss and rewards match the port's per-step
    routed binned tier (loss rtol 1e-5, rewards atol 1e-6) and its
    gradients (relnorm 1e-4): JAX's pins for its own pair."""
    pts, poses0, quats0, K, problem = scene
    plan, meta = tf.build_traj_plan(pts, None, poses0, quats0, K, problem)
    dplan = tf.put_plan(plan, meta, "cpu")
    P, Kt, p0, q0 = _t(pts), _t(K), _t(poses0), _t(quats0)
    params = {"poses": poses0, "quats": quats0}
    l_f, a_f, g_f = _grads(lambda p: tf.traj_forward_frozen(p, dplan, meta, P, Kt, p0, q0,
                                                            problem), params)
    l_r, a_r, g_r = _grads(lambda p: traj_forward(p, P, Kt, p0, q0, problem), params)
    assert abs(float(l_f) - float(l_r)) / abs(float(l_r)) < 1e-5
    assert float((a_f["rewards"] - a_r["rewards"]).abs().max()) < 1e-6
    for k in ("poses", "quats"):
        assert _relnorm(g_f[k], g_r[k]) < 1e-4, k


def test_frozen_scores_match_jax_where_no_query_is_isolated(scene):
    pts, poses0, quats0, K, problem = scene
    plan, meta = tf.build_traj_plan(pts, None, poses0, quats0, K, problem)
    iso = _isolated_queries(plan, meta)
    assert 0 < iso.sum() < 0.02 * iso.size  # this scene has a few
    jp, jm = jf.build_traj_plan(pts, None, poses0, quats0, K, JTrajProblem(**_problem_kw()))
    j_gated, j_hpr = jax.jit(lambda q, p: jf.frozen_soft_hpr_scores(
        _jplan(jp), jm, q, p, jnp.asarray(pts), jnp.asarray(K),
        JTrajProblem(**_problem_kw())))(jnp.asarray(quats0), jnp.asarray(poses0))
    with torch.no_grad():
        t_gated, t_hpr = tf.frozen_soft_hpr_scores(
            tf.put_plan(plan, meta, "cpu"), meta, _t(quats0), _t(poses0), _t(pts), _t(K),
            problem)
    ok = ~iso
    d = np.abs(t_hpr.numpy() - np.asarray(j_hpr))[ok]
    agree = ((t_hpr.numpy() > 0.5) == (np.asarray(j_hpr) > 0.5))[ok]
    assert (d <= 3e-3).mean() >= 0.998 and agree.mean() > 0.999, (d.max(), agree.mean())
    dg = np.abs(t_gated.numpy() - np.asarray(j_gated))[ok]
    assert dg.max() <= 3e-3 * np.abs(np.asarray(j_gated)).max()


def test_frozen_loss_matches_jax_on_the_room(room):
    """No query of the room's plan is isolated, so the JAX frozen loss is an
    exact reference there: loss rtol 1e-5, mean reward atol 1e-6, gradients
    to the binned tier's pin (rtol 2e-3 with atol 2e-3 of the largest
    entry: one f32 rounding inside the sigmoid moves a mask value ~2e-3)."""
    pts, poses0, quats0, K, problem = room
    plan, meta = tf.build_traj_plan(pts, None, poses0, quats0, K, problem)
    assert not _isolated_queries(plan, meta).any()
    dplan = tf.put_plan(plan, meta, "cpu")
    l_t, a_t, g_t = _grads(lambda p: tf.traj_forward_frozen(
        p, dplan, meta, _t(pts), _t(K), _t(poses0), _t(quats0), problem),
        {"poses": poses0, "quats": quats0})
    jprob = JTrajProblem(**_problem_kw())
    jp, jm = jf.build_traj_plan(pts, None, poses0, quats0, K, jprob)
    (l_j, a_j), g_j = jax.jit(jax.value_and_grad(lambda p: jf.traj_forward_frozen(
        p, _jplan(jp), jm, jnp.asarray(pts), jnp.asarray(K), jnp.asarray(poses0),
        jnp.asarray(quats0), jprob), has_aux=True))(j_init(poses0, quats0))
    assert abs(float(l_t) - float(l_j)) / abs(float(l_j)) < 1e-5
    assert abs(float(a_t["mean_reward"]) - float(a_j["mean_reward"])) < 1e-6
    for k in ("poses", "quats"):
        a, b = g_t[k].numpy(), np.asarray(g_j[k])
        assert np.all(np.abs(a - b) <= 2e-3 * np.abs(b) + 2e-3 * np.abs(b).max()), k


def test_sparse_mean_matches_embed_path(scene):
    """tests/test_traj_frozen.py's pins: loss rtol 1e-6, mean reward atol
    1e-6, gradients relnorm 1e-4; and under a valid mask."""
    pts, poses0, quats0, K, problem = scene
    plan, meta = tf.build_traj_plan(pts, None, poses0, quats0, K, problem)
    dplan = tf.put_plan(plan, meta, "cpu")
    args = (_t(pts), _t(K), _t(poses0), _t(quats0), problem)
    params = {"poses": poses0, "quats": quats0}
    l_e, a_e, g_e = _grads(lambda p: tf.traj_forward_frozen(p, dplan, meta, *args), params)
    l_s, a_s, g_s = _grads(lambda p: tf.traj_forward_frozen_mean(p, dplan, meta, *args),
                           params)
    assert abs(float(l_s) - float(l_e)) / abs(float(l_e)) < 1e-6
    assert abs(float(a_s["mean_reward"]) - float(a_e["mean_reward"])) < 1e-6
    for k in ("poses", "quats"):
        assert _relnorm(g_s[k], g_e[k]) < 1e-4, k

    valid = np.ones(len(pts), np.float32)
    valid[-500:] = 0.0
    pts2 = pts.copy()
    pts2[-500:] = 1e6
    plan2, meta2 = tf.build_traj_plan(pts2, valid, poses0, quats0, K, problem)
    dplan2 = tf.put_plan(plan2, meta2, "cpu")
    args2 = (_t(pts2), _t(K), _t(poses0), _t(quats0), problem)
    with torch.no_grad():
        l2e, _ = tf.traj_forward_frozen(init_traj_params(poses0, quats0), dplan2, meta2, *args2,
                                        valid=_t(valid))
        l2s, _ = tf.traj_forward_frozen_mean(init_traj_params(poses0, quats0), dplan2, meta2,
                                             *args2, valid=_t(valid))
    assert abs(float(l2s) - float(l2e)) / abs(float(l2e)) < 1e-6


@pytest.fixture(scope="module")
def routed_run(scene):
    """12 Adam steps of the per-step routed loss (the port's own), with four
    torch threads: the runner comparisons hold 1e-3, not bits."""
    pts, poses0, quats0, K, problem = scene
    P, Kt, p0, q0 = _t(pts), _t(K), _t(poses0), _t(quats0)
    tx = make_optimizer(OPT)
    params = init_traj_params(poses0, quats0)
    state = tx.init(params)
    losses = []
    torch.set_num_threads(4)
    try:
        for _ in range(12):
            loss, _, g = value_and_grad(
                lambda p: traj_forward(p, P, Kt, p0, q0, problem), params)
            updates, state = tx.update(g, state, params)
            params = apply_updates(params, updates)
            losses.append(float(loss))
    finally:
        torch.set_num_threads(1)
    return params, losses


@pytest.mark.parametrize("async_refresh", [False, True])
def test_frozen_runner_tracks_per_step_routing(scene, routed_run, async_refresh):
    """tests/test_traj_frozen.py's pins: sync refresh within rtol 1e-3 of
    the routed losses and 0.01 of its positions; async (plans one boundary
    behind) within 2e-2 and 0.3. ``close()`` leaves no worker alive."""
    pts, poses0, quats0, K, problem = scene
    ref_params, ref_losses = routed_run
    opt = tf.FrozenTrajOptimizer(
        pts, K, poses0, quats0, problem, OPT,
        tf.FrozenPlanConfig(refresh_every=4, async_refresh=async_refresh), device="cpu")
    pf, losses = opt.run(init_traj_params(poses0, quats0), 12)
    opt.close()
    assert not [t for t in threading.enumerate() if t.name.startswith("frozenplan")]
    assert opt.stats["refreshes"] == 3
    dev = max(abs(a - b) / abs(a) for a, b in zip(ref_losses, losses))
    pd = float(torch.linalg.norm(pf["poses"] - ref_params["poses"]))
    assert dev < (2e-2 if async_refresh else 1e-3), (dev, ref_losses, losses)
    assert pd < (0.3 if async_refresh else 0.01), pd


def test_frozen_runner_matches_jax_on_the_room(room):
    """The first 12 losses of the port's runner and of JAX's, sync refresh
    every 4 steps, on a scene whose plans isolate no query: rtol 1e-4."""
    pts, poses0, quats0, K, problem = room
    opt = tf.FrozenTrajOptimizer(pts, K, poses0, quats0, problem, OPT,
                                 tf.FrozenPlanConfig(refresh_every=4, async_refresh=False),
                                 device="cpu")
    params = init_traj_params(poses0, quats0)
    state, t_losses = opt.init(params), []
    for i in range(12):
        if i % 4 == 0:  # the plan this refresh builds isolates no query
            host = {k: v.numpy() for k, v in params.items()}
            assert not _isolated_queries(*tf.build_traj_plan(
                pts, None, host["poses"], host["quats"], K, problem)).any(), i
        params, state, loss, _ = opt.step(params, state)
        t_losses.append(float(loss))
    from trajectory_optimization_tpu.opt.engine import OptimizerConfig as JOptimizerConfig

    jopt = jf.FrozenTrajOptimizer(
        pts, K, poses0, quats0, JTrajProblem(**_problem_kw()),
        JOptimizerConfig(lr_pose=0.1, lr_quat=0.02),
        jf.FrozenPlanConfig(refresh_every=4, async_refresh=False, prewarm=False))
    _, j_losses = jopt.run(j_init(poses0, quats0), 12)
    jopt.close()
    dev = max(abs(a - b) / abs(b) for a, b in zip(t_losses, j_losses))
    assert dev < 1e-4, (dev, t_losses, j_losses)


def test_async_refresh_applies_the_previous_boundary_plan(scene):
    """In async mode the plan swapped in at boundary b is the one built from
    the params at boundary b−1 (as in the twin): after 8 steps the plan in
    use equals a synchronous build from the params after step 4, under the
    runner's tile floors and staged with its live-tile count."""
    pts, poses0, quats0, K, problem = scene
    opt = tf.FrozenTrajOptimizer(pts, K, poses0, quats0, problem, OPT,
                                 tf.FrozenPlanConfig(refresh_every=4, async_refresh=True),
                                 device="cpu")
    params = init_traj_params(poses0, quats0)
    state = opt.init(params)
    seen = []
    for i in range(9):
        if i == 4:
            at4 = {k: v.numpy().copy() for k, v in params.items()}
        params, state, _, _ = opt.step(params, state)
        seen.append(opt._plan)
    meta8 = opt._meta
    opt.close()
    assert seen[3] is seen[0] and seen[4] is not seen[3] and seen[8] is not seen[4]
    want, want_meta = tf.build_traj_plan(pts, None, at4["poses"], at4["quats"], K, problem,
                                         min_tiles=meta8.tiles, min_t_big=meta8.t_big,
                                         embed=False)
    assert want_meta == meta8
    got = tf.put_plan(tf.stage_plan(want, want_meta, n_live=seen[8]["live"].numel()),
                      want_meta, "cpu")
    for k in got:
        assert torch.equal(got[k], seen[8][k]), k


def test_frozen_gradient_finite_at_sensor_origin(scene):
    pts, poses0, quats0, K, problem = scene
    pts = pts.copy()
    pts[0] = poses0[1]  # a point exactly at waypoint 1
    plan, meta = tf.build_traj_plan(pts, None, poses0, quats0, K, problem)
    dplan = tf.put_plan(plan, meta, "cpu")
    _, _, g = _grads(lambda p: tf.traj_forward_frozen(
        p, dplan, meta, _t(pts), _t(K), _t(poses0), _t(quats0), problem),
        {"poses": poses0, "quats": quats0})
    for k in ("poses", "quats"):
        assert torch.isfinite(g[k]).all(), k


def test_frozen_valid_mask_and_padding(scene):
    """Padded points contribute nothing: rewards σ(0) = 0.5 there, and the
    loss equals the unpadded scene's (rtol 1e-5)."""
    pts, poses0, quats0, K, problem = scene
    n, pad = len(pts), 512
    pts_p = np.concatenate([pts, np.full((pad, 3), 1e6, np.float32)])
    valid = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    params = init_traj_params(poses0, quats0)
    with torch.no_grad():
        plan, meta = tf.build_traj_plan(pts_p, valid, poses0, quats0, K, problem)
        loss_p, aux_p = tf.traj_forward_frozen(
            params, tf.put_plan(plan, meta, "cpu"), meta, _t(pts_p), _t(K), _t(poses0),
            _t(quats0), problem, valid=_t(valid))
        plan2, meta2 = tf.build_traj_plan(pts, None, poses0, quats0, K, problem)
        loss_u, _ = tf.traj_forward_frozen(
            params, tf.put_plan(plan2, meta2, "cpu"), meta2, _t(pts), _t(K), _t(poses0),
            _t(quats0), problem)
    np.testing.assert_allclose(aux_p["rewards"][n:].numpy(), 0.5, atol=1e-6)
    np.testing.assert_allclose(float(loss_p), float(loss_u), rtol=1e-5)


def test_frozen_wps_and_pose_variants(scene):
    """tests/test_traj_frozen.py's variants: each frozen runner's first loss
    against its per-step routed loss (rtol 1e-4), then 7 more steps lower
    the loss."""
    from trajectory_optimization_tpu_torch.models.pose import (
        PoseProblem, init_pose_params, pose_forward,
    )
    from trajectory_optimization_tpu_torch.models.wps_opt import (
        WpsOptProblem, init_wps_params, wps_forward,
    )

    pts, poses0, quats0, _, _ = scene
    K = np.array([[50.0, 0, 32.0], [0, 50.0, 24.0], [0, 0, 1.0]], np.float32)
    opt_cfg = OptimizerConfig(lr_pose=0.05, lr_quat=0.05)
    small = dict(img_width=64.0, img_height=48.0, soft_hpr=True, soft_hpr_dense_max=0,
                 hpr_cap=256)

    wp_prob = WpsOptProblem(**small)
    params, frozen = init_wps_params(poses0, quats0)
    opt = tf.FrozenWpsOptimizer(pts, K, frozen, wp_prob, opt_cfg,
                                tf.FrozenPlanConfig(async_refresh=False), device="cpu")
    st = opt.init(params)
    p1, st, l0, aux = opt.step(params, st)
    assert set(aux) == {"losses"}
    with torch.no_grad():
        l_ref, _ = wps_forward(params, frozen, _t(pts), _t(K), wp_prob)
    assert abs(float(l0) - float(l_ref)) / abs(float(l_ref)) < 1e-4
    for _ in range(7):
        p1, st, loss, _ = opt.step(p1, st)
    assert float(loss) < float(l0)
    opt.close()

    po_prob = PoseProblem(**small)
    params = init_pose_params(np.array([[1.0, 0.5, 0.4]], np.float32),
                              np.array([[1.0, 0, 0, 0]], np.float32))
    opt = tf.FrozenPoseOptimizer(pts, K, po_prob, opt_cfg,
                                 tf.FrozenPlanConfig(async_refresh=False), device="cpu")
    st = opt.init(params)
    p1, st, l0, aux = opt.step(params, st)
    assert aux == {}
    with torch.no_grad():
        l_ref, _ = pose_forward(params, _t(pts), _t(K), po_prob)
    assert abs(float(l0) - float(l_ref)) / abs(float(l_ref)) < 1e-4
    for _ in range(7):
        p1, st, loss, _ = opt.step(p1, st)
    assert float(loss) < float(l0)
    opt.close()


def test_frozen_step_equals_engine_step(scene):
    """One runner step is value_and_grad of the sparse loss then the
    two-group Adam of ``make_optimizer``: bit for bit."""
    pts, poses0, quats0, K, problem = scene
    opt = tf.FrozenTrajOptimizer(pts, K, poses0, quats0, problem, OPT,
                                 tf.FrozenPlanConfig(async_refresh=False), device="cpu")
    params = init_traj_params(poses0, quats0)
    p1, _, loss, aux = opt.step(params, opt.init(params))
    assert set(aux) == {"mean_reward", "loss_vis", "loss_l2", "loss_smooth", "loss_length"}
    plan, meta = tf.build_traj_plan(pts, None, poses0, quats0, K, problem, embed=False)
    dplan = tf.put_plan(plan, meta, "cpu")
    l_ref, _, g = value_and_grad(lambda p: tf.traj_forward_frozen_mean(
        p, dplan, meta, _t(pts), _t(K), _t(poses0), _t(quats0), problem), params)
    tx = make_optimizer(OPT)
    updates, _ = tx.update(g, tx.init(params), params)
    want = apply_updates(params, updates)
    assert torch.equal(loss, l_ref)
    for k in want:
        assert torch.equal(p1[k], want[k]), k
    opt.close()
