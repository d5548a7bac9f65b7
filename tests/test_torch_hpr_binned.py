"""Parity of the port's direction-binned soft HPR (``ops/hpr.py``:
``hpr_mask_soft_binned`` and its layout helpers) with
``trajectory_optimization_tpu.ops.hpr``, on the CPU with one torch thread.

Held:

* the layout helpers exactly: ``_binned_grids``; ``_grid_bin_key``'s keys
  and ``frac_bits`` on the same (lat, az, norms); ``_stratified_priority``
  on every rank below 16·base + 64; the co-sort's permutation
  ``torch.equal`` to JAX's stable sort on a tie-heavy key, with gradients
  equal to JAX's custom VJP and to autodiff through a plain gather; the
  ``frac_bits < 8`` error and the ``2n ≥ 2^frac_bits`` guard;
* the mask against the JAX function on the four adversarial scenes of
  tests/test_hpr.py and a cloud-10 viewpoint: 99.8% of points within atol
  3e-3, the 0.5 threshold agreeing on more than 99.9%; the gradient at the
  viewpoint rtol 2e-3 with atol 2e-3 of the largest entry, on the scenes
  against float64 beside JAX's (``_hold_to_jax``);
* padding invariance, and the binned tier against the port's own dense tier
  with tests/test_hpr.py's bounds.

Isolated points. A point alone in its bin in some grid has no coverer in
its tile row. The twin's intended value there is the −1e30 sentinel (the
point is visible as far as that grid goes), and that is what the port
computes. The jitted JAX function on the CPU returns +inf for such a row
instead: XLA evaluates β·dom in two fusions (the row max and the exp), and
at |β·dom| ~ 1e31 one ulp between them overflows exp, so the point is
hidden. The comparisons with JAX leave these points out (they are listed
by the port's own bin keys, ``_isolated``) and count them.

r_param = 4. There ρ ≈ 2·10⁴·max‖p‖ and β·ρ ≈ 10⁷, so one f32 rounding
moves a mask logit by ~1 and the twin's own mask is 1.4% of points beyond
3e-3 from the same formula in float64 (measured here). At r = 4 both
packages are held against the port's float64 evaluation instead: the port
no farther from it than JAX, mask and gradient.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from test_hpr import _ADVERSARIAL_SCENES, _grid_plane  # noqa: E402
from trajectory_optimization_tpu.ops import hpr as jhpr  # noqa: E402
from trajectory_optimization_tpu.ops.numerics import safe_norm as jsafe_norm  # noqa: E402
from trajectory_optimization_tpu_torch.ops import hpr as thpr  # noqa: E402
from trajectory_optimization_tpu_torch.utils.data import pad_points  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def view9(cloud10, path10):
    """Cloud 10 seen from path 10's waypoint 9 (tests/test_hpr.py's
    operating-point viewpoint), 2,048 points of its rng(0) permutation, one
    at the sensor origin."""
    sub = (cloud10[np.random.default_rng(0).permutation(len(cloud10))[:2048]]
           - path10[9]).astype(np.float32)
    sub[5] = 0.0
    return sub


def _isolated(pts, r_param=2.0, safety=3.0):
    """Points alone in their bin in at least one grid."""
    P = torch.as_tensor(pts)
    norms = thpr.safe_norm(P, dim=-1)
    lat, az = thpr._direction_angles(P / torch.clamp(norms, min=1e-12)[:, None])
    out = np.zeros(len(pts), bool)
    for grid in thpr._binned_grids(r_param, 0.02, safety)[1]:
        key, fb, nb = thpr._grid_bin_key(grid, lat, az, norms, torch.amax(norms), None)
        b = (key >> fb).numpy()
        out |= np.bincount(b, minlength=nb + 1)[b] == 1
    return out


def room_scene():
    """A closed room for the model-level tests above a lowered dense size:
    the six faces of the cube [-6, 6]³, 24 × 24 jittered points each, and a
    3 × 3 m occluder at z = 3 (3,681 points). Seen from inside, every
    direction bin holds several points, so no point is isolated and the JAX
    models are exact references (module docstring); the tests assert it per
    viewpoint with ``_isolated``."""
    faces = [_grid_plane(24, axis, value, (-6, 6), (-6, 6), jitter=0.05, seed=i)
             for i, (axis, value) in enumerate(
                 [(0, -6.0), (0, 6.0), (1, -6.0), (1, 6.0), (2, -6.0), (2, 6.0)])]
    faces.append(_grid_plane(15, 2, 3.0, (-1.5, 1.5), (-1.5, 1.5), jitter=0.01, seed=9))
    return np.vstack(faces)


def room_path():
    """Seven waypoints across the room, inside its walls."""
    return np.stack([np.linspace(-2.4, 2.4, 7), np.linspace(-0.8, 0.8, 7),
                     np.zeros(7)], axis=1).astype(np.float32)


def assert_none_isolated(points, poses, quats):
    """No point of ``points`` is isolated in the camera frame of any of the
    (pose, quat) waypoints: there the JAX twin's binned tier is exact."""
    from trajectory_optimization_tpu_torch.ops.scores import camera_planes

    P = torch.as_tensor(points)
    for t, q in zip(poses, quats):
        cx, cy, cz = camera_planes(P, torch.as_tensor(np.asarray(q, np.float32))[None],
                                   torch.as_tensor(np.asarray(t, np.float32))[None])
        cam = torch.stack([cx[0], cy[0], cz[0]], dim=-1).numpy()
        assert not _isolated(cam).any(), t


def _port(pts, w, **kw):
    P = torch.as_tensor(pts).requires_grad_(True)
    v = thpr.hpr_mask_soft_binned(P, **kw)
    torch.sum(v * torch.as_tensor(w, dtype=v.dtype)).backward()
    return v.detach().numpy(), P.grad.numpy()


def _jax(pts, w, **kw):
    P = jnp.asarray(pts)
    v = np.asarray(jhpr.hpr_mask_soft_binned(P, **kw))
    g = np.asarray(jax.grad(lambda p: jnp.sum(jhpr.hpr_mask_soft_binned(p, **kw) * w))(P))
    return v, g


@pytest.mark.parametrize("knobs", [(2.0, 0.02, 3.0), (4.0, 0.02, 3.0), (2.0, 0.1, 1.5)])
def test_binned_grids_equal_jax(knobs):
    jt, jg = jhpr._binned_grids(*knobs)
    tt, tg = thpr._binned_grids(*knobs)
    assert jt == tt and len(jg) == len(tg) == 4
    for a, b in zip(jg, tg):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("r_param", [2.0, 4.0])
def test_grid_bin_key_equal_jax(view9, r_param):
    """Keys and frac_bits from the same (lat, az, norms): JAX's, fed to both;
    the last 100 points are padding (overflow bin)."""
    P = jnp.asarray(view9)
    norms = jsafe_norm(P, axis=-1)
    lat, az = jhpr._direction_angles(P / jnp.maximum(norms, 1e-12)[:, None])
    scale = jnp.max(norms)
    v = np.arange(len(view9)) < len(view9) - 100
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    for grid in jhpr._binned_grids(r_param, 0.02, 3.0)[1]:
        jk, jfb, jnb = jhpr._grid_bin_key(grid, lat, az, norms, scale, jnp.asarray(v))
        tk, tfb, tnb = thpr._grid_bin_key(grid, t(lat), t(az), t(norms), t(scale),
                                          torch.as_tensor(v))
        assert (jfb, jnb) == (tfb, tnb) and tk.dtype == torch.int32
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        assert (tk.numpy()[~v] >> tfb == tnb).all()


@pytest.mark.parametrize("base", [1, 16, 64, 256])
def test_stratified_priority_equal_jax(base):
    n = 16 * base + 64
    rank = np.arange(n, dtype=np.int32)
    want = np.asarray(jhpr._stratified_priority(jnp.asarray(rank), base, n))
    for dtype in (torch.int32, torch.int64):
        got = thpr._stratified_priority(torch.as_tensor(rank).to(dtype), base, n)
        np.testing.assert_array_equal(got.numpy(), want)


def test_cosort_permutation_and_gradient_equal_jax():
    """17 distinct keys over 4,096 rows: long runs of ties. The permutation
    is torch.equal to JAX's stable sort; the gradients of the sorted
    operands and of _unpermute equal JAX's custom VJP's and autodiff
    through a plain gather."""
    rng = np.random.default_rng(7)
    n = 4096
    key = rng.integers(0, 17, n).astype(np.int32)
    ops = [rng.normal(size=n).astype(np.float32) for _ in range(5)]
    cot_sorted = rng.normal(size=n).astype(np.float32)
    cot_x = rng.normal(size=n).astype(np.float32)

    def jloss(u0, u1, u2, rho, x):
        _, u0s, u1s, u2s, rhos, perm = jhpr._cosort(jnp.asarray(key), u0, u1, u2, rho)
        xs = jhpr._unpermute(jnp.asarray(key), perm, x)
        return jnp.sum((u0s + u1s + u2s + rhos) * cot_sorted) + jnp.sum(xs * cot_x)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, ops))
    jperm = np.asarray(jhpr._cosort(jnp.asarray(key), *map(jnp.asarray, ops[:4]))[-1])

    leaves = [torch.as_tensor(o).requires_grad_(True) for o in ops]
    key_s, u0s, u1s, u2s, rhos, perm = thpr._cosort(torch.as_tensor(key), *leaves[:4])
    assert torch.equal(perm, torch.as_tensor(jperm, dtype=perm.dtype))
    assert torch.equal(key_s, torch.as_tensor(key)[perm])
    xs = thpr._unpermute(perm, leaves[4])
    loss = (torch.sum((u0s + u1s + u2s + rhos) * torch.as_tensor(cot_sorted))
            + torch.sum(xs * torch.as_tensor(cot_x)))
    tg = torch.autograd.grad(loss, leaves)

    plain = [torch.as_tensor(o).requires_grad_(True) for o in ops]
    inv = torch.argsort(perm)
    ploss = (torch.sum((plain[0][perm] + plain[1][perm] + plain[2][perm] + plain[3][perm])
                       * torch.as_tensor(cot_sorted))
             + torch.sum(plain[4][inv] * torch.as_tensor(cot_x)))
    pg = torch.autograd.grad(ploss, plain)
    for a, b, c in zip(tg, jg, pg):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert torch.equal(a, c)


def test_bin_key_guards(view9):
    """Too fine a binning for an int32 key raises in both packages; where
    the stratified key 2n would reach the bin bits (2n ≥ 2^frac_bits) the
    stratified layout is skipped, so the mask equals the closest-prefix one
    bit for bit, while at the default binning the two differ."""
    grid = thpr._binned_grids(2.0, 0.02, 5e-5)[1][0]
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="too fine"):
        thpr._grid_bin_key(grid, x, x, x, torch.tensor(1.0), None)
    with pytest.raises(ValueError, match="too fine"):
        jhpr._grid_bin_key(grid, jnp.zeros(4), jnp.zeros(4), jnp.zeros(4), 1.0, None)

    # safety 0.002: ~1.6e5 bins per grid, frac_bits 12, 2n = 4096 = 2^12
    assert thpr._binned_grids(2.0, 0.02, 0.002)[1][0][-1] + 1 >= 1 << 17
    P = torch.as_tensor(view9)
    on = thpr.hpr_mask_soft_binned(P, cap=64, safety=0.002)
    off = thpr.hpr_mask_soft_binned(P, cap=64, safety=0.002, stratified_coverers=False)
    assert torch.equal(on, off)
    on = thpr.hpr_mask_soft_binned(P, cap=64)
    off = thpr.hpr_mask_soft_binned(P, cap=64, stratified_coverers=False)
    assert not torch.equal(on, off)


def test_defaults_equal_jax():
    assert thpr.SOFT_BINNED_DEFAULTS == jhpr.SOFT_BINNED_DEFAULTS


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _hold_to_jax(pts, cap, exact_grad, **kw):
    """Mask and gradient against the JAX function (``cap`` and the knobs in
    ``kw``), isolated points left out
    (module docstring). With ``exact_grad`` the gradient is held to JAX's
    rtol 2e-3 / atol 2e-3 of its largest entry; otherwise both gradients go
    against the port's float64 evaluation: on the planar scenes JAX's own f32
    gradient breaks that pin against float64 on up to ~4% of entries (walls,
    plane+background), so the port is held to be no farther from float64
    than 1.5 times JAX's distance (L2), and within twice it of JAX's."""
    w = np.random.default_rng(1).normal(size=len(pts)).astype(np.float32)
    iso = _isolated(pts)
    w[iso] = 0.0  # the JAX mask is flat (0) there; see the module docstring
    jv, jg = _jax(pts, w, cap=cap, **kw)
    tv, tg = _port(pts, w, cap=cap, **kw)
    keep = ~iso
    assert iso.mean() <= 0.01, iso.sum()
    d = np.abs(tv - jv)[keep]
    assert (d > 3e-3).mean() <= 2e-3, np.sort(d)[-10:]
    assert ((tv > 0.5) == (jv > 0.5))[keep].mean() > 0.999
    assert np.isfinite(tg).all() and np.abs(jg).max() > 0
    if exact_grad:
        np.testing.assert_allclose(tg, jg, rtol=2e-3, atol=2e-3 * np.abs(jg).max())
    else:
        dg = _port(pts.astype(np.float64), w, cap=cap, **kw)[1]
        assert _rel(tg, dg) <= 1.5 * _rel(jg, dg) + 1e-3, (_rel(tg, dg), _rel(jg, dg))
        assert _rel(tg, jg) <= 2.0 * _rel(jg, dg) + 1e-3, (_rel(tg, jg), _rel(jg, dg))
    return tv


@pytest.mark.parametrize("name", sorted(_ADVERSARIAL_SCENES))
def test_binned_mask_and_gradient_match_jax_scenes(name):
    _hold_to_jax(_ADVERSARIAL_SCENES[name]()[::2].copy(), cap=256, exact_grad=False)


def test_binned_mask_and_gradient_match_jax_cloud10(view9):
    tv = _hold_to_jax(view9, cap=128, exact_grad=True)
    assert 0.05 < (tv > 0.5).mean() < 0.95  # occlusion at work, not all one way


def test_binned_r4_against_float64(view9):
    """r_param 4, cap 64: the port's and the JAX mask and gradient against
    the port's float64 evaluation, on the points that are not isolated."""
    w = np.random.default_rng(1).normal(size=len(view9)).astype(np.float32)
    iso = _isolated(view9, 4.0)
    w[iso] = 0.0
    kw = dict(r_param=4.0, cap=64)
    jv, jg = _jax(view9, w, **kw)
    tv, tg = _port(view9, w, **kw)
    dv, dg = _port(view9.astype(np.float64), w, **kw)
    keep = ~iso
    err = {k: np.abs(v - dv)[keep] for k, v in (("jax", jv), ("port", tv))}
    flips = {k: ((v > 0.5) != (dv > 0.5))[keep].mean() for k, v in (("jax", jv), ("port", tv))}
    assert (err["port"] > 3e-3).mean() <= (err["jax"] > 3e-3).mean() + 2e-3
    assert err["port"].mean() <= 1.25 * err["jax"].mean()
    assert flips["port"] <= flips["jax"] + 1e-3
    gerr = {k: _rel(g, dg) for k, g in (("jax", jg), ("port", tg))}
    assert gerr["port"] <= 1.25 * gerr["jax"], gerr


def test_binned_padding_invariance():
    """Bucket padding (tests/test_hpr.py's sphere shell, 6,000 points to
    8,192): the real points keep their mask within atol 3e-3, padding
    reports 0, and the gradient reaches no padded point."""
    pts = _ADVERSARIAL_SCENES["sphere-shell"]()
    plain = thpr.hpr_mask_soft_binned(torch.as_tensor(pts), cap=256).numpy()
    padded, valid = pad_points(pts, 8192)
    P = torch.as_tensor(padded).requires_grad_(True)
    masked = thpr.hpr_mask_soft_binned(P, cap=256, valid=torch.as_tensor(valid))
    masked.sum().backward()
    masked = masked.detach().numpy()
    np.testing.assert_allclose(masked[: len(pts)], plain, atol=3e-3)
    assert masked[len(pts):].max() < 1e-3
    assert not P.grad[len(pts):].any() and P.grad[: len(pts)].abs().max() > 0


@pytest.mark.parametrize("name", sorted(_ADVERSARIAL_SCENES))
def test_binned_tracks_the_port_dense(name):
    """tests/test_hpr.py's bounds: mean ≤ 1e-3, at most 0.1% of points more
    than 0.05 from the dense tier."""
    pts = torch.as_tensor(_ADVERSARIAL_SCENES[name]())
    d = np.abs(thpr.hpr_mask_soft(pts).numpy() - thpr.hpr_mask_soft_binned(pts, cap=512).numpy())
    assert d.mean() <= 1e-3, d.mean()
    assert (d > 0.05).mean() <= 1e-3, (d > 0.05).sum()


def _lowered(cls):
    """``cls`` (TrajProblem or PoseProblem) built with the dense size
    lowered to 2,048 and cap 64, whatever its caller asks."""
    def make(*args, **kw):
        return dataclasses.replace(cls(*args, **kw), soft_hpr_dense_max=2048, hpr_cap=64)
    return make


def test_facades_and_nodes_above_the_dense_size_match_jax(monkeypatch):
    """TrajectoryOptimizer.optimize and evaluate, PoseOptimizer, TrajOptNode
    and PoseOptNode with soft HPR, each beside its JAX twin, on the room
    (3,681 points) with the dense size lowered below it in both packages'
    facades and nodes, so the binned tier serves them. The room's path moved
    by seeded noise (on a straight path the smoothness gradient is ~0 and
    Adam's first step, ±lr·sign(g), follows its f32 rounding). One
    trajectory step at vis_wps_dist 2 (3 of 7 waypoints), three pose steps. Held as the
    dense facades are (tests/test_torch_pose.py, test_torch_nodes.py):
    poses 1e-4, loss rtol 1e-4, rewards and observations atol 5e-3."""
    from trajectory_optimization_tpu import api as japi
    from trajectory_optimization_tpu.bus import core as jcore, messages as jmsg, nodes as jnodes
    from trajectory_optimization_tpu.utils import config as jconfig
    from trajectory_optimization_tpu_torch import api as tapi
    from trajectory_optimization_tpu_torch.bus import core as tcore, messages as tmsg
    from trajectory_optimization_tpu_torch.bus import nodes as tnodes
    from trajectory_optimization_tpu_torch.utils import config as tconfig

    for mod in (japi, tapi, jnodes, tnodes):
        for name in ("TrajProblem", "PoseProblem"):
            monkeypatch.setattr(mod, name, _lowered(getattr(mod, name)))
    real = room_scene()
    path = room_path() + np.random.default_rng(0).normal(scale=0.1, size=(7, 3)).astype(np.float32)
    q_id = np.tile(np.array([1.0, 0, 0, 0], np.float32), (len(path), 1))
    start, q0 = [0.5, 0.3, 0.0], [0.9, 0.1, -0.2, 0.3]
    kw = dict(soft_hpr=True, lr_pose=0.1, lr_quat=0.02, vis_wps_dist=2.0)
    jr = japi.TrajectoryOptimizer(**kw).optimize(real, path, n_steps=1)
    tr = tapi.TrajectoryOptimizer(**kw, device="cpu").optimize(real, path, n_steps=1)
    for poses in (path, tr.poses):
        assert_none_isolated(real, poses[::3], q_id[::3])
    np.testing.assert_allclose(tr.poses, jr.poses, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tr.loss, jr.loss, rtol=1e-4)
    np.testing.assert_allclose(tr.rewards, jr.rewards, rtol=1e-4, atol=5e-3)
    je = japi.TrajectoryOptimizer(**kw).evaluate(real, path)
    te = tapi.TrajectoryOptimizer(**kw, device="cpu").evaluate(real, path)
    assert abs(te.n_observed - je.n_observed) <= 0.005 * len(real)
    np.testing.assert_allclose(te.rewards, je.rewards, rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(te.mean_reward, je.mean_reward, rtol=1e-4, atol=2e-4)

    pkw = dict(soft_hpr=True, lr_pose=0.02, lr_quat=0.02)
    jp = japi.PoseOptimizer(**pkw).optimize(real, start, q0, n_steps=3)
    tp = tapi.PoseOptimizer(**pkw, device="cpu").optimize(real, start, q0, n_steps=3)
    assert_none_isolated(real, [start, tp.position], [q0, tp.quat_wxyz])
    np.testing.assert_allclose(tp.position, jp.position, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tp.loss, jp.loss, rtol=1e-4)
    np.testing.assert_allclose(tp.observations, jp.observations, rtol=1e-4, atol=5e-3)

    outs = []
    for core, msg, nodes, config, dev in ((jcore, jmsg, jnodes, jconfig, {}),
                                          (tcore, tmsg, tnodes, tconfig, {"device": "cpu"})):
        bus = core.Bus(error_policy="raise")
        got = []
        bus.subscribe("/path/optimized", got.append)
        bus.subscribe("/odom", got.append)
        nodes.TrajOptNode(bus, config.TrajOptNodeConfig(
            pc_topic="/pc", path_topic="/path", opt_steps=1, lr_pose=0.1, lr_quat=0.02,
            rewards_th=float("inf"), use_soft_hpr=True, vis_wps_dist=2.0), **dev)
        nodes.PoseOptNode(bus, config.PoseOptNodeConfig(
            pc_topic="/pts", pose_topic="/pose", opt_steps=3, lr_pose=0.02, lr_quat=0.02,
            num_pub_samples=1, use_soft_hpr=True), **dev)
        bus.publish("/pc", msg.CloudMsg(msg.Header(stamp=1.0, frame_id="map"), real))
        bus.publish("/path", msg.PathMsg.straight(path, frame_id="map", stamp=1.2))
        bus.publish("/pts", msg.CloudMsg(msg.Header(stamp=5.0, frame_id="world"), real))
        bus.publish("/pose", msg.PoseMsg(msg.Header(stamp=5.1, frame_id="world"), start,
                                         [0.1, -0.2, 0.3, 0.9]))
        assert len(got) == 2
        outs.append(got)
    (jpath, jodom), (tpath, todom) = outs
    np.testing.assert_allclose(tpath.positions, jpath.positions, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(todom.position, jodom.position, rtol=1e-4, atol=1e-4)
