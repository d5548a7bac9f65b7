"""The port's occlusion-aware trajectory path against the benchmark's plain
float64 reference of it, ``trajbench/reference/traj_soft.py``, loaded by
path: the binned soft-HPR gate alone, the gated forward's rewards and loss,
its gradients, and three steps of ``TrajectoryOptimizer(soft_hpr=True)``.

A closed room of 3,004 seeded points seen from six waypoints inside it, at
a small size that forces the binned tier (``soft_hpr_dense_max`` 0, cap
64), on one torch thread (the CPU's last bits follow the thread count).
The port computes in float32, the reference in float64. A point within
float32 rounding of a bin edge can take another bin in the port than in
the reference, and its gate then differs by up to 1: rewards and gates are
compared over the points whose bins agree between the reference's own
float32 and float64 routing (``_routed_alike``), a rule taken from the
inputs alone.

Each tolerance is a few times the float32 rounding it covers and well
below what the reference's bfloat16 control (its scores and gate, routing
included, in bfloat16, as ``trajbench/control.py`` computes them) reads:
``test_the_bfloat16_control_fails`` holds that.
"""
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "trajbench"
CAP = 64

# Each tolerance, with the worst reading of these cases on the CPU beside it
# and the bfloat16 control's reading of the same case.
# The gate: β·ρ ≈ sharpness·2·10^r_param = 8·10⁴, so one float32 rounding of
# ρ or of the soft maximum moves the gate's logit by ~5e-3 and the gate by
# ~1e-3 (here 7.8e-4; 5.6e-3 at cloud 10's 40,452 points); the control's
# bfloat16 ρ is off by tens of metres and its gate by 1.
GATE_TOL = 1e-2
# The gradient of a seeded weighted sum of the gate over its largest entry:
# float32 sums of ~10² softmax-weighted terms a row (4.2e-3; control 2e4).
GATE_GRAD_TOL = 2e-2
# The forward at a seeded state: rewards σ(Σ log-odds) move with the gates'
# rounding through the log-odds' slope, ≥ 4 (1.1e-4; control 0.50); the loss
# is a mean over 3,004 points (3.3e-7; control 3.6e-3); the loss's gradient
# over its largest entry (1.6e-5; control 12).
REWARDS_TOL = 2e-3
LOSS_TOL = 1e-5
GRAD_TOL = 1e-3
# Three Adam steps from the path, by the median waypoint as the benchmark's
# check compares them: the first step moves each coordinate by the learning
# rate times the sign of its gradient, so a coordinate whose gradient is
# below float32's error on it parts by twice the learning rate
# (2.1e-6 m, 1.3e-4 degrees).
STEP_POSE_MED_TOL = 1e-4  # m
STEP_QUAT_MED_TOL = 0.01  # degrees


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    import registry

    return registry.load_module(BENCH / "reference" / "traj_soft.py")


@pytest.fixture(scope="module")
def st(ref):
    cfg = json.loads((BENCH / "configs" / "cloud10_soft.json").read_text())
    cfg["assumed"].update(soft_hpr_dense_max=0, hpr_cap=CAP)
    return ref.Settings.from_config(cfg)


def _plane(n, axis, value, jitter, rng):
    a = np.linspace(-6.0, 6.0, n)
    g1, g2 = np.meshgrid(a, a)
    flat = np.stack([g1.ravel(), g2.ravel()], axis=1) + rng.normal(0, jitter, (n * n, 2))
    return np.insert(flat, axis, value, axis=1)


def room():
    """The six walls of the cube [-6, 6]³, 22 × 22 jittered points each, and
    a 3 × 3 m occluder at z = 3, 10 × 10 points: 3,004 points."""
    rng = np.random.default_rng(21)
    walls = [_plane(22, axis, value, 0.05, rng) for axis in range(3) for value in (-6.0, 6.0)]
    occluder = _plane(10, 2, 3.0, 0.01, rng)
    occluder[:, :2] *= 0.25
    return np.vstack(walls + [occluder]).astype(np.float32)


def path():
    """Six waypoints across the room, ~1 m apart, so that all six are scored."""
    return np.stack([np.linspace(-2.5, 2.5, 6), np.linspace(-0.8, 0.8, 6),
                     np.zeros(6)], axis=1).astype(np.float32)


def state(seed):
    """A seeded state near the path: positions moved by ~0.3 m, orientations
    turned by ~0.2 rad."""
    rng = np.random.default_rng(seed)
    p = path()
    quats = np.tile([1.0, 0.0, 0.0, 0.0], (len(p), 1)) + rng.normal(0, 0.1, (len(p), 4))
    return (p + rng.normal(0, 0.3, p.shape)).astype(np.float32), quats.astype(np.float32)


def _problem(st, step):
    from trajectory_optimization_tpu_torch.models.traj import TrajProblem

    return TrajProblem(img_width=st.width, img_height=st.height, min_dist=st.min_dist,
                       max_dist=st.max_dist, smoothness_weight=st.smoothness_weight,
                       length_weight=st.length_weight, wps_step=step, soft_hpr=True,
                       soft_hpr_dense_max=0, hpr_cap=CAP)


def _intrinsics(st):
    from trajectory_optimization_tpu_torch.utils.intrinsics import CameraIntrinsics

    return CameraIntrinsics(fx=st.fx, fy=st.fy, cx=st.cx, cy=st.cy, width=st.width,
                            height=st.height)


def _routed_alike(ref, st, pts, poses, quats):
    """(N,) bool: the points whose bin, in every grid and at every scored
    waypoint, is the same by the reference's float32 and float64 routing."""
    step = ref.stride(path(), st.vis_wps_dist)
    ok = torch.ones(len(pts), dtype=torch.bool)
    for p, q in zip(np.asarray(poses)[::step], np.asarray(quats)[::step]):
        routes = [ref.route(ref.camera_frame(torch.as_tensor(pts, dtype=dt),
                                             torch.as_tensor(q, dtype=dt),
                                             torch.as_tensor(p, dtype=dt)), st)
                  for dt in (torch.float64, torch.float32)]
        for r64, r32 in zip(*routes):
            ok &= r64.bins == r32.bins
    return ok.numpy()


def _rel(a, b):
    """Largest gap over the largest entry of ``b``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def gate_numbers(ref, st, dtype=None):
    """(gate gap, gradient gap) of waypoint 2's camera: the port's gate, or
    with ``dtype`` the reference's own in that dtype, against float64."""
    from trajectory_optimization_tpu_torch.ops.hpr import soft_hpr_gate
    from trajectory_optimization_tpu_torch.utils.data import pad_points

    pts = room()
    poses, quats = state(2)
    cam = ref.camera_frame(torch.as_tensor(pts, dtype=torch.float64),
                           torch.as_tensor(quats[2], dtype=torch.float64),
                           torch.as_tensor(poses[2], dtype=torch.float64))
    w = torch.as_tensor(np.random.default_rng(5).uniform(0.5, 1.5, len(pts)))
    c64 = cam.clone().requires_grad_(True)
    g64 = ref.gate(c64, st)
    (d64,) = torch.autograd.grad(torch.sum(w * g64), c64)
    if dtype is None:
        padded, valid = pad_points(cam.float().numpy())
        c = torch.as_tensor(padded).requires_grad_(True)
        g = soft_hpr_gate(c, torch.as_tensor(valid), _problem(st, 1))
        (d,) = torch.autograd.grad(torch.sum(w.float() * g[:len(pts)]), c)
        g, d = g[:len(pts)], d[:len(pts)]
    else:
        c = cam.to(dtype).requires_grad_(True)
        g = ref.gate(c, st)
        (d,) = torch.autograd.grad(torch.sum(w.to(dtype) * g), c)
    ok = _routed_alike(ref, st, pts, poses[2:3], quats[2:3])
    gap = np.abs(g.detach().double().numpy() - g64.detach().numpy())[ok]
    return {"gate": float(gap.max()), "grad": _rel(d.double(), d64)}


def forward_numbers(ref, st, seed, vis_dtype=None):
    """Rewards, loss and gradient gaps of the gated forward at a seeded state:
    the port's float32 forward, or with ``vis_dtype`` the reference's own
    scores and gate in that dtype, against the reference in float64."""
    from trajectory_optimization_tpu_torch.models.traj import traj_forward
    from trajectory_optimization_tpu_torch.utils.data import pad_points

    pts, p0 = room(), path()
    poses, quats = state(seed)
    step = ref.stride(p0, st.vis_wps_dist)
    t64 = functools.partial(torch.as_tensor, dtype=torch.float64)
    leaves = [t64(poses).requires_grad_(True), t64(quats).requires_grad_(True)]
    loss64, _, _, rewards64 = ref.forward(*leaves, t64(pts), t64(p0), step, st)
    g64 = torch.autograd.grad(loss64, leaves)
    if vis_dtype is None:
        padded, valid = pad_points(pts)
        params = {"poses": torch.as_tensor(poses).requires_grad_(True),
                  "quats": torch.as_tensor(quats).requires_grad_(True)}
        q0 = torch.zeros(len(p0), 4)
        q0[:, 0] = 1.0
        loss, aux = traj_forward(params, torch.as_tensor(padded), _intrinsics(st).matrix(),
                                 torch.as_tensor(p0), q0, _problem(st, step),
                                 valid=torch.as_tensor(valid))
        grads = torch.autograd.grad(loss, [params["poses"], params["quats"]])
        rewards = aux["rewards"][:len(pts)]
    else:
        leaves = [t64(poses).float().requires_grad_(True), t64(quats).float().requires_grad_(True)]
        loss, _, _, rewards = ref.forward(*leaves, torch.as_tensor(pts), torch.as_tensor(p0),
                                          step, st, vis_dtype)
        grads = torch.autograd.grad(loss, leaves)
    ok = _routed_alike(ref, st, pts, poses, quats)
    gap = np.abs(rewards.detach().double().numpy() - rewards64.detach().numpy())[ok]
    loss, loss64 = float(loss.detach()), float(loss64.detach())
    return {"rewards": float(gap.max()), "loss": abs(loss - loss64) / abs(loss64),
            "grad_poses": _rel(grads[0].double(), g64[0]),
            "grad_quats": _rel(grads[1].double(), g64[1])}


def quat_angle_deg(a, b):
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    b = b * np.where(np.sum(a * b, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    return np.degrees(4.0 * np.arctan2(np.linalg.norm(a - b, axis=-1),
                                       np.linalg.norm(a + b, axis=-1)))


def facade_numbers(ref, st, monkeypatch):
    """Three steps of ``TrajectoryOptimizer(soft_hpr=True)`` on the CPU from
    the path against the reference's three float64 steps: the median
    waypoint's position and orientation gaps, the final loss and rewards."""
    from trajectory_optimization_tpu_torch import api
    from trajectory_optimization_tpu_torch.models.traj import TrajProblem

    monkeypatch.setattr(api, "TrajProblem",
                        functools.partial(TrajProblem, soft_hpr_dense_max=0, hpr_cap=CAP))
    pts, p0 = room(), path()
    opt = api.TrajectoryOptimizer(_intrinsics(st), min_dist=st.min_dist, max_dist=st.max_dist,
                                  smoothness_weight=st.smoothness_weight,
                                  length_weight=st.length_weight, lr_pose=st.lr_pose,
                                  lr_quat=st.lr_quat, vis_wps_dist=st.vis_wps_dist,
                                  soft_hpr=True, device="cpu")
    res = opt.optimize(pts, p0, n_steps=3)
    whole = ref.solve(pts, p0, 3, st)
    ok = _routed_alike(ref, st, pts, res.poses, res.quats_wxyz)
    return {"pose_med_m": float(np.median(np.linalg.norm(res.poses - whole.poses, axis=1))),
            "quat_med_deg": float(np.median(quat_angle_deg(res.quats_wxyz, whole.quats_wxyz))),
            "loss": abs(res.loss - whole.loss) / abs(whole.loss),
            "rewards": float(np.max(np.abs(res.rewards - whole.rewards)[ok])),
            "steps": int(res.n_iters)}


LIMITS = {
    "gate": {"gate": GATE_TOL, "grad": GATE_GRAD_TOL},
    "forward": {"rewards": REWARDS_TOL, "loss": LOSS_TOL, "grad_poses": GRAD_TOL,
                "grad_quats": GRAD_TOL},
    "facade": {"pose_med_m": STEP_POSE_MED_TOL, "quat_med_deg": STEP_QUAT_MED_TOL,
               "loss": LOSS_TOL, "rewards": REWARDS_TOL},
}


@pytest.mark.parametrize("case", ["gate", "forward-7", "forward-8", "facade"])
def test_port_holds_to_the_reference(case, ref, st, monkeypatch):
    if case == "gate":
        got, limits = gate_numbers(ref, st), LIMITS["gate"]
    elif case == "facade":
        got, limits = facade_numbers(ref, st, monkeypatch), LIMITS["facade"]
        assert got.pop("steps") == 3
    else:
        got, limits = forward_numbers(ref, st, int(case[-1])), LIMITS["forward"]
    over = {k: (v, limits[k]) for k, v in got.items() if not v <= limits[k]}
    assert not over, f"{case}: {got}"


@pytest.mark.parametrize("case", ["gate", "forward"])
def test_the_bfloat16_control_fails(case, ref, st):
    """The reference with its scores and gate in bfloat16 (the benchmark's
    control) leaves at least one tolerance: they can tell a precision below
    float32 from float32."""
    if case == "gate":
        got, limits = gate_numbers(ref, st, torch.bfloat16), LIMITS["gate"]
    else:
        got, limits = forward_numbers(ref, st, 7, torch.bfloat16), LIMITS["forward"]
    assert any(not v <= limits[k] for k, v in got.items()), got


def test_reference_imports_neither_jax_nor_the_port():
    code = ("import sys; sys.path.insert(0, 'trajbench'); import registry; "
            "registry.Registry().reference('traj_soft'); "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', "
            "'trajectory_optimization_tpu', 'trajectory_optimization_tpu_torch'}); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_gate_readers_count_from_the_reference_and_the_spans(ref, st):
    """``hpr.roofline_pct`` counts its pairs and bytes from the reference's
    tiles (here against a count set by set), and ``hpr.gate_ms`` takes the
    operations launched inside a gate span of the final forward, not of
    another phase."""
    import program_trace
    import registry
    import tracing

    roof = registry.load_module(BENCH / "metrics" / "hpr.roofline_pct.py")
    pairs, nbytes = roof.tile_work(ref, room(), path(), st, "cpu")
    want_pairs = want_rows = 0
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)
    for pose in path():
        cam = ref.camera_frame(torch.as_tensor(room(), dtype=torch.float64), q,
                               torch.as_tensor(pose, dtype=torch.float64))
        for r in ref.route(cam, st):
            for qs, cs in zip(r.queries.tolist(), r.coverers.tolist()):
                members = {c for c in cs if c >= 0}
                want_pairs += sum(len(members - {i}) for i in qs if i >= 0)
                want_rows += sum(i >= 0 for i in qs) * 5 + len(members) * 4
    assert pairs == want_pairs > 0
    assert nbytes == want_rows * 4

    gate = registry.load_module(BENCH / "metrics" / "hpr.gate_ms.py")
    spans = [program_trace.Span(n, a, b, 0) for n, a, b in [
        ("trajopt.runner.first_step", 0.0, 1.0), ("trajopt.hpr.gate", 0.1, 0.2),
        ("trajopt.runner.final_forward", 2.0, 3.0), ("trajopt.hpr.gate", 2.1, 2.2),
        ("trajopt.hpr.gate", 2.5, 2.6)]]
    ops = [program_trace.Op(f"k{t}", t + 0.01, t + 0.02, tracing.Ev("cudaLaunchKernel", t, t))
           for t in (0.15, 2.05, 2.15, 2.55, 2.7)]
    pt = program_trace.ProgramTrace(None, ops, spans, [], [], [])
    assert [o.name for o in gate.launched_under(pt, gate.GATE)] == ["k2.15", "k2.55"]
