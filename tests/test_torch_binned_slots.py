"""The binned soft tier's static tile slots (``ops/hpr.py``:
``hpr_mask_soft_binned``) on the CPU, with one torch thread.

The tier's tile table is the JAX twin's: ``n_bins + ⌈n/cap⌉`` slots per
grid, a size taken from shapes alone, the slots past the last real tile
masked out of the max. So the function reads nothing from the device on the
host, and a soft step above ``soft_hpr_dense_max`` can be captured as a CUDA
graph. Held here, each at cap 512 (cap 1024 in
tests/test_torch_binned_slots_1024.py) and with the stratified coverers on
and off:

* the slot count per grid equals the twin's, the length of its scan over
  tiles read off its jaxpr;
* mask and gradient against the JAX function at the tolerances and with the
  isolated points left out as tests/test_torch_hpr_binned.py holds them
  (``_hold_to_jax``), on cloud 10 from path 10's waypoint 9 and on a seeded
  cloud inside a narrow cone, where most bins are empty and so most slots
  are; the cone is a synthetic scene with a sharp occluding edge, and its
  gradient is held as the adversarial scenes' are, against the port's
  float64 evaluation (in f32 both packages miss the exact pin on a few
  entries at the edge);
* an empty slot adds nothing: the static table gives the mask and gradient
  of the real tiles alone, bit for bit;
* no host read: with ``Tensor.item``, ``tolist``, ``__bool__``,
  ``__int__``, ``__float__`` and ``__index__`` patched to raise, the mask
  and its gradient, and one soft trajectory, pose and waypoint step above a
  lowered ``soft_hpr_dense_max`` through the runners' static-buffer steps,
  run to the end: the CPU stand-in for a capture's check that the step
  never synchronizes. (``hpr_safety`` 48 there makes ~8 bins per grid, so
  the steps stay cheap at the large caps; the count of host reads does not
  depend on it.)
"""
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from test_torch_hpr_binned import (  # noqa: E402,F401 (module fixtures)
    _hold_to_jax,
    one_torch_thread,
    room_path,
    room_scene,
    view9,
)
from trajectory_optimization_tpu.ops import hpr as jhpr  # noqa: E402
from trajectory_optimization_tpu_torch.models import pose as tpose  # noqa: E402
from trajectory_optimization_tpu_torch.models import traj as tt  # noqa: E402
from trajectory_optimization_tpu_torch.models import wps_opt as twps  # noqa: E402
from trajectory_optimization_tpu_torch.ops import hpr as thpr  # noqa: E402
from trajectory_optimization_tpu_torch.opt import engine as te  # noqa: E402
from trajectory_optimization_tpu_torch.opt import runners as tr  # noqa: E402
from trajectory_optimization_tpu_torch.utils.data import identity_quaternions  # noqa: E402
from trajectory_optimization_tpu_torch.utils.intrinsics import default_intrinsics  # noqa: E402

# the cap-1024 cases run from tests/test_torch_binned_slots_1024.py, a file
# of its own so that `--dist loadfile` can give them another worker
CAPS = (512,)
CASES = [(cap, strat) for cap in CAPS for strat in (True, False)]
INTR = default_intrinsics()
HOST_READS = ("item", "tolist", "__bool__", "__int__", "__float__", "__index__")


def cone_cloud(n=4096, seed=11):
    """n seeded points inside a cone of half-angle 0.15 rad about +z: a far
    wall 8-10 m out and a near blob 3-4 m out inside 0.06 rad that hides
    part of it. The cone covers a few direction bins of each grid."""
    rng = np.random.default_rng(seed)
    near = rng.random(n) < 0.3
    theta = np.sqrt(rng.random(n)) * np.where(near, 0.06, 0.15)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    r = np.where(near, rng.uniform(3.0, 4.0, n), rng.uniform(8.0, 10.0, n))
    d = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], 1)
    return (d * r[:, None]).astype(np.float32)


SCENES = {"cloud10": None, "cone": cone_cloud}


def _scene(name, view9):
    return view9 if name == "cloud10" else SCENES[name]()


def _real_count(bin_s, tiles, cap):
    """Σ⌈count/cap⌉ over the bins of a grid's sorted bin ids: its real tiles,
    which lead its slots (the overflow bin of padding has none)."""
    n_bins = int(tiles[:, 0].max()) + 1
    counts = torch.bincount(bin_s.long(), minlength=n_bins + 1)[:n_bins]
    return int(((counts + cap - 1) // cap).sum())


def _port_slots(pts, monkeypatch, **kw):
    """(static slots, real tiles) per grid, read off the table the port
    hands to the tiles (whose work is stubbed out)."""
    seen = []

    def apply(U, R, beta, bin_s, cov_pos, tiles, cap, chunk):
        seen.append((tiles.shape[0], _real_count(bin_s, tiles, cap)))
        return U.new_zeros((tiles.shape[0], cap))

    monkeypatch.setattr(thpr, "_BinnedLSE", types.SimpleNamespace(apply=apply))
    thpr.hpr_mask_soft_binned(torch.as_tensor(pts), **kw)
    return seen


def _jax_scan_lengths(pts, **kw):
    """The lengths of the twin's scans over its tile table, one per grid:
    the scans in its jaxpr over five arrays (the table's columns; the
    binary searches are scans over none)."""
    lengths = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            p = eqn.params
            if (eqn.primitive.name == "scan"
                    and len(eqn.invars) - p["num_consts"] - p["num_carry"] == 5):
                lengths.append(p["length"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else [v]):
                    if hasattr(sub, "eqns"):
                        walk(sub)
                    elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                        walk(sub.jaxpr)

    walk(jax.make_jaxpr(lambda p: jhpr.hpr_mask_soft_binned(p, **kw))(jnp.asarray(pts)).jaxpr)
    return lengths


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("cap,strat", CASES)
def test_slot_count_equals_the_twin(scene, cap, strat, view9, monkeypatch):
    """n_bins + ⌈n/cap⌉ per grid, the twin's scan length, at least the
    real tiles; in the cone most slots are empty."""
    pts = _scene(scene, view9)
    kw = dict(cap=cap, stratified_coverers=strat)
    got, real = zip(*_port_slots(pts, monkeypatch, **kw))
    c = min(cap, len(pts))
    want = [g[-1] + -(-len(pts) // c) for g in jhpr._binned_grids(2.0, 0.02, 3.0)[1]]
    assert list(got) == want
    assert sorted(_jax_scan_lengths(pts, **kw)) == sorted(want)
    assert all(0 < r <= s for r, s in zip(real, got))
    if scene == "cone":
        assert max(r / s for r, s in zip(real, got)) < 0.25, (real, got)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("cap,strat", CASES)
def test_static_slots_match_jax(scene, cap, strat, view9):
    """tests/test_torch_hpr_binned.py's ``_hold_to_jax``: the mask on 99.8%
    of the points that are not isolated within 3e-3 of the twin's, the 0.5
    threshold agreeing on more than 99.9%; the gradient at cloud 10 rtol
    2e-3 with atol 2e-3 of its largest entry, and in the cone, a synthetic
    scene with a sharp occluding edge as the adversarial scenes are,
    against the port's float64 evaluation beside JAX's distance from it."""
    tv = _hold_to_jax(_scene(scene, view9), cap=cap, exact_grad=scene == "cloud10",
                      stratified_coverers=strat)
    assert 0.02 < (tv > 0.5).mean() < 0.98  # occlusion at work, not all one way


def test_an_empty_slot_adds_nothing(view9, monkeypatch):
    """The empty slots' rows leave the mask and its gradient as they are:
    the static table against the table of the real tiles alone, computed
    from the same bins (a host read the test may make)."""
    w = torch.as_tensor(np.random.default_rng(2).normal(size=len(view9)).astype(np.float32))
    out = {}
    for table in ("static", "real"):
        if table == "real":
            real_apply = thpr._BinnedLSE.apply

            def apply(U, R, beta, bin_s, cov_pos, tiles, cap, chunk):
                # the real tiles are the leading slots; the rest are empty
                n_real = _real_count(bin_s, tiles, cap)
                lse = real_apply(U, R, beta, bin_s, cov_pos, tiles[:n_real], cap, chunk)
                return torch.cat([lse, lse.new_full((tiles.shape[0] - n_real, cap), 0.0)])

            monkeypatch.setattr(thpr, "_BinnedLSE", types.SimpleNamespace(apply=apply))
        P = torch.as_tensor(view9).requires_grad_(True)
        v = thpr.hpr_mask_soft_binned(P, cap=64)
        torch.sum(v * w).backward()
        out[table] = (v.detach(), P.grad)
    assert torch.equal(out["static"][0], out["real"][0])
    assert torch.equal(out["static"][1], out["real"][1])


@pytest.fixture
def no_host_reads(monkeypatch):
    """A context in which every read of a tensor's value on the host raises."""

    def refuse(name):
        def read(self, *args, **kwargs):
            raise AssertionError(f"a host read: Tensor.{name}")
        return read

    def arm():
        for name in HOST_READS:
            monkeypatch.setattr(torch.Tensor, name, refuse(name))

    return arm


def test_no_host_read_guard_catches_reads(no_host_reads):
    x = torch.ones(3)
    no_host_reads()
    for read in (lambda: x.sum().item(), lambda: x.tolist(), lambda: bool(x[0]),
                 lambda: int(x[0]), lambda: float(x[0]), lambda: [0, 1][x[0].long()]):
        with pytest.raises(AssertionError, match="a host read"):
            read()


@pytest.mark.parametrize("cap,strat", CASES)
def test_binned_mask_reads_nothing_on_the_host(cap, strat, view9, no_host_reads):
    P = torch.as_tensor(np.concatenate([view9, view9 * 1.01])).requires_grad_(True)
    V = torch.ones(P.shape[0])
    V[-7:] = 0.0
    no_host_reads()
    v = thpr.hpr_mask_soft_binned(P, cap=cap, stratified_coverers=strat, safety=48.0, valid=V)
    torch.sum(v).backward()
    assert P.grad is not None


def _soft_problem(cls, cap, **kw):
    return cls(INTR.width, INTR.height, soft_hpr=True, soft_hpr_dense_max=1024, hpr_cap=cap,
               hpr_safety=48.0, **kw)


@pytest.mark.parametrize("cap,strat", CASES)
def test_soft_steps_read_nothing_on_the_host(cap, strat, monkeypatch, no_host_reads):
    """Soft trajectory, pose and waypoint runs of two steps above a lowered
    dense size (the room of tests/test_torch_hpr_binned.py, 1,841 points):
    each run's first step and its static-buffer step, the one the card
    captures, with every host read refused."""
    binned = thpr.hpr_mask_soft_binned
    monkeypatch.setattr(thpr, "hpr_mask_soft_binned",
                        lambda *a, **kw: binned(*a, stratified_coverers=strat, **kw))
    pts = room_scene()[::2]
    path = room_path()[:3]
    q = identity_quaternions(len(path))
    P, K = torch.as_tensor(pts), INTR.matrix()
    cfg = te.OptimizerConfig(lr_pose=0.1, lr_quat=0.02)
    traj = tr.TrajRunner(_soft_problem(tt.TrajProblem, cap, wps_step=3), cfg, te.NEVER, 2)
    tparams = tt.init_traj_params(path, q)
    pose = tr.PoseAdvance(_soft_problem(tpose.PoseProblem, cap), cfg, 2)
    pparams = tpose.init_pose_params(path[:1], q[:1])
    pstate = te.adam_init(pparams)
    wprob = _soft_problem(twps.WpsOptProblem, cap)
    wparams, frozen = twps.init_wps_params(path[:1], q[:1])
    stop = te.EarlyStop(float("inf"), float("inf"), "mean_reward", "mean_reward")
    data = (P, None, K, torch.as_tensor(path), torch.as_tensor(q))
    no_host_reads()
    _, _, loss, _ = traj(tparams, *data)
    pose(pparams, pstate, P, None, K)
    te.run_until_done(lambda p: twps.wps_forward(p, frozen, P, K, wprob), wparams,
                      te.OptimizerConfig(lr_pose=0.02, lr_quat=0.02), 2, stop, pose_key="xy",
                      quat_key="yaw")
    assert loss.shape == ()
