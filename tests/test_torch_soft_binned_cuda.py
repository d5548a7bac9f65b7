"""The binned soft-HPR gate's tile kernels (csrc/soft_binned.cu:
``soft_binned_fwd``, ``soft_binned_bwd``) on the card, against their plain
version (ops/hpr.py ``binned_lse_ref``, ``binned_lse_bwd_ref``) run on the
same CUDA tensors.

Every test here needs a CUDA card and is marked ``cuda``; without one each
skips (the kernels have no CPU mode; tests/test_torch_soft_binned.py holds
the plain version on the CPU). The file imports neither JAX nor the JAX
package and uses no conftest fixture:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_soft_binned_cuda.py

The cases: cloud 10 (padded to 40,960) in the camera frames of path 10's
scored waypoints at cap 512, the node's tiles, stratified and not; 262,144
points of bench.py's cloud at cap 1024, the soft pose step's; a ragged
``cap = n`` (300 points); bins so fine that some hold one point (rows with
no pair). Every case's table has static slots past its last real tile.

Tolerances. In float64 the kernels compute what the plain version computes
up to the order of a sum and an FMA: within ``F64_REL`` of the largest
entry. In float32 the two compute cos differently (cuBLAS's product, the
kernel's FMAs), and β·ρ ≈ 8·10⁴ turns one ulp of cos near 1 (2⁻²⁴) into
~5e-3 of x = β·max(cos, 0)·ρ, which moves top, lse and every softmax weight.
So in float32 the kernel is held against the plain version's own distance
from float64 on the same inputs: no farther than twice it, plus
``ULPS_X`` ulps of cos in x (top and lse), or that many in a weight
(total, the gradients, relative to the largest entry). A wrong mask, a lost
½, or a partial sum added to the wrong row moves them by far more.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from trajectory_optimization_tpu_torch.models.traj import waypoint_stride  # noqa: E402
from trajectory_optimization_tpu_torch.ops import _kernels  # noqa: E402
from trajectory_optimization_tpu_torch.ops import hpr as thpr  # noqa: E402
from trajectory_optimization_tpu_torch.ops.scores import camera_planes  # noqa: E402
from trajectory_optimization_tpu_torch.opt import graphs as tg  # noqa: E402
from trajectory_optimization_tpu_torch.utils.data import (  # noqa: E402
    identity_quaternions,
    load_path,
    load_point_cloud,
    pad_points,
)

pytestmark = pytest.mark.cuda

DATA = Path(__file__).resolve().parents[1] / "data"
F64_REL = 1e-9
ULPS_X = 8
COS_ULP = 2.0 ** -24  # one ulp of a float32 cos in [0.5, 1)
CASES = ("cloud10", "cloud10_unstratified", "pose262k", "ragged", "one_member_bins")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def cloud10_cams(dev):
    """Cloud 10 as the facade pads it, in the camera frame of each scored
    waypoint of path 10 (identity orientation), and its valid mask."""
    cloud = load_point_cloud(str(DATA / "points/point_cloud_10.npz"))
    path = load_path(str(DATA / "paths/path_poses_10.npz"))
    padded, valid = pad_points(cloud)
    P = torch.as_tensor(padded, device=dev)
    q = torch.as_tensor(identity_quaternions(1), device=dev)
    cams = []
    for pose in path[::waypoint_stride(path, 0.5)]:
        cx, cy, cz = camera_planes(P, q, torch.as_tensor(pose[None], device=dev))
        cams.append(torch.stack([cx[0], cy[0], cz[0]], dim=-1).contiguous())
    return cams, torch.as_tensor(valid, device=dev)


def _seeded(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)) * [6, 6, 2] + [5, 0, 1]).astype(np.float32)


def _case(name, dev, cloud10_cams):
    """[(points, valid, gate keywords)] of a case: one gate call each."""
    cams, valid = cloud10_cams
    if name == "cloud10":
        return [(c, valid, dict(cap=512)) for c in cams[::4]]
    if name == "cloud10_unstratified":
        return [(cams[2], valid, dict(cap=512, stratified_coverers=False))]
    if name == "pose262k":
        return [(torch.as_tensor(_seeded(262_144), device=dev), None, dict(cap=1024))]
    if name == "ragged":
        return [(torch.as_tensor(_seeded(300, 1), device=dev), None, dict(cap=1024))]
    return [(torch.as_tensor(_seeded(1024, 2), device=dev), None, dict(cap=64, safety=0.1))]


def _grid_calls(points, valid, kw, monkeypatch):
    """The arguments of every ``_BinnedLSE.apply`` of one gate call."""
    calls = []
    real = thpr._BinnedLSE

    class Recording:
        @staticmethod
        def apply(*args):
            calls.append(args)
            return real.apply(*args)

    monkeypatch.setattr(thpr, "_BinnedLSE", Recording)
    with torch.no_grad():
        thpr.hpr_mask_soft_binned(points, valid=valid, **kw)
    monkeypatch.setattr(thpr, "_BinnedLSE", real)
    return calls


def _read_rows(bin_s, tiles, cap):
    """(T, cap) bool: the rows the gate reads, in bin b and in a real tile
    (the real tiles lead the table: Σ⌈count/cap⌉ over the bins)."""
    n_bins = int(tiles[:, 0].max()) + 1
    counts = torch.bincount(bin_s.long(), minlength=n_bins + 1)[:n_bins]
    real = int(((counts + cap - 1) // cap).sum())
    b, qoff = tiles[:, 0], tiles[:, 1]
    q = qoff[:, None] + torch.arange(cap, device=tiles.device)
    read = bin_s[q] == b[:, None]
    read[real:] = False
    return read, real


def _lse_grads(args, g, plain, monkeypatch, dtype=None):
    """(top, total, lse, dU, dR) of ``_BinnedLSE`` on ``args`` for the
    cotangent ``g``, by the kernels or (``plain``) the plain version on the
    same CUDA tensors; ``dtype`` converts the float inputs first."""
    U, R, beta, bin_s, cov_pos, tiles, cap, chunk = args
    dt = dtype or U.dtype
    U = U.detach().to(dt).requires_grad_(True)
    R = R.detach().to(dt).requires_grad_(True)
    beta = beta.detach().to(dt)
    with monkeypatch.context() as m:
        if plain:
            m.setattr(_kernels, "on_cpu", lambda t: True)
            top, total = thpr.binned_lse_ref(U.detach(), R.detach(), beta, bin_s, cov_pos,
                                             tiles, cap, chunk)
        else:
            top, total, _ = _kernels.soft_binned_fwd(U.detach(), R.detach(), beta, bin_s,
                                                     cov_pos, tiles, cap)
        lse = thpr._BinnedLSE.apply(U, R, beta, bin_s, cov_pos, tiles, cap, chunk)
        dU, dR = torch.autograd.grad(lse, (U, R), g.to(dt))
    return top, total, lse.detach(), dU, dR


def _err(a, b):
    return float((a.double() - b.double()).abs().max())


def _rel(a, b):
    return _err(a, b) / max(float(b.double().abs().max()), 1e-300)


@pytest.mark.parametrize("name", CASES)
def test_kernels_against_the_plain_version(dev, cloud10_cams, name, monkeypatch):
    """Every grid of every gate call of the case: top, total and lse on the
    rows the gate reads, dU and dR for a seeded cotangent on those rows
    (the gate's is 0 elsewhere), in float64 within ``F64_REL`` and in
    float32 no farther from float64 than the plain version (docstring).
    Rows without a pair (top = −1e30·β, total = cap) are held apart, equal."""
    rng = np.random.default_rng(7)
    slack = []
    for points, valid, kw in _case(name, dev, cloud10_cams):
        for args in _grid_calls(points, valid, kw, monkeypatch):
            U, R, beta, bin_s, cov_pos, tiles, cap, _ = args
            read, real = _read_rows(bin_s, tiles, cap)
            slack.append(tiles.shape[0] - real)
            g = torch.as_tensor(rng.normal(size=tuple(read.shape)), dtype=torch.float32,
                                device=dev) * read
            k64 = _lse_grads(args, g, False, monkeypatch, torch.float64)
            p64 = _lse_grads(args, g, True, monkeypatch, torch.float64)
            k32 = _lse_grads(args, g, False, monkeypatch)
            p32 = _lse_grads(args, g, True, monkeypatch)
            paired = read & (p64[0] > -1.0)  # a pair's x is >= 0
            lone = read & ~paired
            for k, p in ((k64, p64), (k32, p32)):
                for i in range(3):
                    assert torch.equal(k[i][lone], p[i][lone]), (name, i)
            for i, (a, b) in enumerate(zip(k64, p64)):
                a, b = (a[paired], b[paired]) if i < 3 else (a, b)
                assert _rel(a, b) <= F64_REL, (name, i, _rel(a, b))
            x_ulp = float(beta) * float(R.max()) * COS_ULP
            for i in (0, 2):  # top, lse: absolute, in x
                kerr = _err(k32[i][paired], p64[i][paired])
                perr = _err(p32[i][paired], p64[i][paired])
                assert kerr <= 2 * perr + ULPS_X * x_ulp, (name, i, kerr, perr, x_ulp)
            for i in (1, 3, 4):  # total, dU, dR: relative to the largest entry
                a, p, w = ((k32[i][paired], p32[i][paired], p64[i][paired]) if i == 1
                           else (k32[i], p32[i], p64[i]))
                kerr, perr = _rel(a, w), _rel(p, w)
                assert kerr <= 2 * perr + ULPS_X * x_ulp, (name, i, kerr, perr, x_ulp)
            for t in k32:
                assert bool(torch.isfinite(t).all())
    assert min(slack) >= 0 and max(slack) > 0  # slots past the last real tile


@pytest.mark.parametrize("name", ("cloud10", "pose262k", "one_member_bins"))
def test_gate_against_the_plain_version(dev, cloud10_cams, name, monkeypatch):
    """The whole gate, ``hpr_mask_soft_binned``, and the gradient of a
    seeded weighting of it by the points: the kernels no farther from the
    float64 gate than the plain version, plus ``ULPS_X`` ulps of cos in x
    (the mask) or in a weight (the gradient, relative to its largest
    entry)."""
    points, valid, kw = _case(name, dev, cloud10_cams)[0]
    w = torch.as_tensor(np.random.default_rng(3).random(points.shape[0]), device=dev)

    def gate(plain, dtype=torch.float32):
        P = points.to(dtype, copy=True).requires_grad_(True)
        with monkeypatch.context() as m:
            if plain:
                m.setattr(_kernels, "on_cpu", lambda t: True)
            vis = thpr.hpr_mask_soft_binned(P, valid=None if valid is None else valid.to(dtype),
                                            **kw)
            (grad,) = torch.autograd.grad((vis * w.to(dtype)).sum(), P)
        return vis.detach(), grad

    kern, plain, f64 = gate(False), gate(True), gate(True, torch.float64)
    # β·ρ ≤ sharpness · 2·10^r_param = 400 · 200 at the gate's defaults
    x_ulp = 400.0 * 200.0 * COS_ULP
    assert _err(kern[0], f64[0]) <= 2 * _err(plain[0], f64[0]) + ULPS_X * x_ulp
    assert _rel(kern[1], f64[1]) <= 2 * _rel(plain[1], f64[1]) + ULPS_X * x_ulp
    assert all(bool(torch.isfinite(t).all()) for t in kern)


def test_two_calls_bit_equal_and_a_replay_equal_to_them(dev, cloud10_cams):
    """The gate on a cloud-10 camera at cap 512 with its gradient: two eager
    calls agree bit for bit (fixed-order sums in the kernels, ``add_rows``
    after them), and a CUDA graph of the same call replays
    ``torch.equal`` to them."""
    cams, valid = cloud10_cams
    P = cams[5].detach().clone().requires_grad_(True)
    w = torch.as_tensor(np.random.default_rng(4).random(P.shape[0]), dtype=torch.float32,
                        device=dev)

    def step():
        vis = thpr.hpr_mask_soft_binned(P, valid=valid, cap=512)
        (grad,) = torch.autograd.grad((vis * w).sum(), P)
        return [vis.detach(), grad]

    first, second = step(), step()
    box = []

    def fn():
        out = step()
        if not box:
            box.extend(x.clone() for x in out)
        else:
            for d, x in zip(box, out):
                d.copy_(x)

    with tg.on_capture_stream(dev):
        fn()
        g = tg.StepGraph(fn, dev, "soft gate and gradient")
        g()
    torch.cuda.synchronize()
    assert g.graph is not None and g.launches == {"soft_binned_fwd": 4, "soft_binned_bwd": 4}
    for a, b, c in zip(first, second, box):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_launches_one_kernel_per_grid_and_no_plain_tile_op(dev, cloud10_cams, monkeypatch):
    """One gate call and its backward on CUDA tensors: ``LAUNCHES`` rises by
    one ``soft_binned_fwd`` per grid and one ``soft_binned_bwd`` per grid's
    backward, and nothing reaches the plain tile operations."""
    def refused(*args):
        raise AssertionError("a CUDA tensor reached the plain tiles")

    for fn in ("_binned_tiles", "binned_lse_ref", "binned_lse_bwd_ref"):
        monkeypatch.setattr(thpr, fn, refused)
    cams, valid = cloud10_cams
    P = cams[0].detach().clone().requires_grad_(True)
    torch.cuda.synchronize()
    before = dict(_kernels.LAUNCHES)
    vis = thpr.hpr_mask_soft_binned(P, valid=valid, cap=512)
    after_fwd = dict(_kernels.LAUNCHES)
    vis.sum().backward()
    torch.cuda.synchronize()
    rise = {k: v - before[k] for k, v in _kernels.LAUNCHES.items() if v != before[k]}
    assert after_fwd["soft_binned_fwd"] - before["soft_binned_fwd"] == 4
    assert after_fwd["soft_binned_bwd"] == before["soft_binned_bwd"]
    assert rise == {"soft_binned_fwd": 4, "soft_binned_bwd": 4}
    assert bool(torch.isfinite(P.grad).all())
