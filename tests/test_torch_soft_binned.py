"""The binned soft-HPR gate's tile reduction (``ops/hpr.py``: ``_BinnedLSE``)
on the CPU, with one torch thread.

``_BinnedLSE`` launches ``soft_binned_fwd`` and ``soft_binned_bwd``
(``csrc/soft_binned.cu``) on CUDA tensors and runs its plain version,
``binned_lse_ref`` and ``binned_lse_bwd_ref``, on CPU tensors. Held here:

* CPU tensors take the plain version, forward and backward, and launch
  nothing: ``LAUNCHES`` stays as it was and the kernels' wrappers are never
  called;
* the plain forward and backward against autograd through the unfused tile
  expression (cos, max(cos, 0)·ρ, the mask, β, the row's max and log-sum-exp)
  on the tiles of seeded clouds, ``torch.equal``: the same operations on
  the CPU. Two arrangements make autograd's operations those of the plain
  backward: β = 1 (autograd multiplies the softmax weight by β last, the
  plain backward by β·g/total, so any other β differs in the last bit), and
  cos taken twice, once per operand, so that each operand's gradient is the
  product the plain backward forms (``a @ cu`` and ``aᵀ @ qu``); the tile
  gradients are added into the tables by ``add_rows`` in the plain order;
* the rows that ``soft_binned_bwd``'s partial sums are added into
  (``_tile_row_index``) are the plain version's query and coverer rows, in
  its order;
* the kernels' wrappers refuse CPU tensors and inputs of the wrong dtype or
  shape before they build or launch anything.

The cases: a stratified and an unstratified layout, a ragged ``cap = n``,
and bins so fine that some hold one point (rows with no pair).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from trajectory_optimization_tpu_torch.ops import _kernels  # noqa: E402
from trajectory_optimization_tpu_torch.ops import hpr as thpr  # noqa: E402

CASES = {
    "stratified": (4096, dict(cap=128)),
    "unstratified": (4096, dict(cap=128, stratified_coverers=False)),
    "ragged": (300, dict(cap=1024)),
    "one_member_bins": (1024, dict(cap=64, safety=0.1)),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)) * [6, 6, 2] + [5, 0, 1]).astype(np.float32)


def _grid_calls(name, monkeypatch):
    """The arguments of every ``_BinnedLSE.apply`` of one gate call on the
    case's cloud, one per grid."""
    n, kw = CASES[name]
    calls = []
    real = thpr._BinnedLSE

    def apply(*args):
        calls.append(args)
        return real.apply(*args)

    monkeypatch.setattr(thpr, "_BinnedLSE", types.SimpleNamespace(apply=apply))
    thpr.hpr_mask_soft_binned(torch.as_tensor(_cloud(n)), **kw)
    monkeypatch.setattr(thpr, "_BinnedLSE", real)
    return calls


def _tile_indices(bin_s, cov_pos, tiles, n, cap):
    b, qoff, coff, deep = tiles.unbind(1)
    ar = torch.arange(cap)
    q = qoff[:, None] + ar
    c = coff[:, None] + ar
    if cov_pos is None:
        crow, cself = c, c
    else:
        crow = c + deep[:, None] * n
        cself = torch.where(deep[:, None] > 0, cov_pos[c], c)
    ok = (bin_s[c] == b[:, None])[:, None, :] & (q[:, :, None] != cself[:, None, :])
    return q, crow, ok


def _autograd_lse(U, R, beta, bin_s, cov_pos, tiles, cap, chunk, g):
    """(top, total, dU, dR) by autograd through the unfused tile expression,
    chunk by chunk, each chunk's tile gradients added by ``add_rows`` as
    the plain backward adds its own."""
    n = bin_s.shape[0]
    top = U.new_empty((tiles.shape[0], cap))
    total = U.new_empty((tiles.shape[0], cap))
    dU, dR = torch.zeros_like(U), torch.zeros_like(R)
    zero = torch.zeros((), dtype=U.dtype)
    for t0 in range(0, tiles.shape[0], chunk):
        t1 = t0 + chunk
        q, crow, ok = _tile_indices(bin_s, cov_pos, tiles[t0:t1], n, cap)
        qu, cu, cr = (U[q].requires_grad_(True), U[crow].requires_grad_(True),
                      R[crow].requires_grad_(True))
        # the value of cos is the first product's; each operand's gradient
        # flows through the product laid out as the plain backward forms it
        cos_q = torch.bmm(qu, cu.detach().transpose(1, 2))
        cos_c = torch.bmm(cu, qu.detach().transpose(1, 2)).transpose(1, 2)
        cos = cos_q + (cos_c - cos_c.detach())
        x = (torch.maximum(cos, zero) * cr[:, None, :]).masked_fill(~ok, -thpr._BIG_SOFT) * beta
        m = torch.amax(x.detach(), dim=2)
        s = torch.sum(torch.exp(x - m[:, :, None]), dim=2)
        lse = m + torch.log(s)
        gq, gc, gr = torch.autograd.grad(lse, (qu, cu, cr), g[t0:t1])
        top[t0:t1], total[t0:t1] = m, s.detach()
        thpr.add_rows(dR, crow.reshape(-1), gr.reshape(-1))
        thpr.add_rows(dU, torch.cat([q.reshape(-1), crow.reshape(-1)]),
                      torch.cat([gq.reshape(-1, 3), gc.reshape(-1, 3)]))
    return top, total, dU, dR


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_tensors_take_the_plain_version(name, monkeypatch):
    """A soft gate's forward and backward on CPU tensors: the plain version
    once per grid each way, no kernel wrapper, ``LAUNCHES`` unchanged."""
    n, kw = CASES[name]
    seen = {"fwd": 0, "bwd": 0}

    def counting(key, fn):
        def run(*args):
            seen[key] += 1
            return fn(*args)
        return run

    def refused(*args):
        raise AssertionError("a CPU tensor reached a kernel wrapper")

    monkeypatch.setattr(thpr, "binned_lse_ref", counting("fwd", thpr.binned_lse_ref))
    monkeypatch.setattr(thpr, "binned_lse_bwd_ref", counting("bwd", thpr.binned_lse_bwd_ref))
    monkeypatch.setattr(_kernels, "soft_binned_fwd", refused)
    monkeypatch.setattr(_kernels, "soft_binned_bwd", refused)
    before = dict(_kernels.LAUNCHES)
    P = torch.as_tensor(_cloud(n)).requires_grad_(True)
    vis = thpr.hpr_mask_soft_binned(P, **kw)
    vis.sum().backward()
    assert seen == {"fwd": 4, "bwd": 4}
    assert _kernels.LAUNCHES == before
    assert bool(torch.isfinite(vis).all()) and bool(torch.isfinite(P.grad).all())


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_is_autograd_through_the_tiles(name, monkeypatch):
    """``binned_lse_ref`` and ``binned_lse_bwd_ref`` on every grid's tiles,
    β = 1 and a seeded cotangent on every row: top, total and the gradients
    of U and R ``torch.equal`` to autograd's (module docstring)."""
    rng = np.random.default_rng(1)
    for U, R, _, bin_s, cov_pos, tiles, cap, chunk in _grid_calls(name, monkeypatch):
        beta = torch.ones((), dtype=U.dtype)
        g = torch.as_tensor(rng.normal(size=(tiles.shape[0], cap)), dtype=U.dtype)
        top, total = thpr.binned_lse_ref(U, R, beta, bin_s, cov_pos, tiles, cap, chunk)
        dU, dR = thpr.binned_lse_bwd_ref(U, R, beta, bin_s, cov_pos, tiles, top, total, g, cap,
                                         chunk)
        want = _autograd_lse(U, R, beta, bin_s, cov_pos, tiles, cap, chunk, g)
        for got, ref in zip((top, total, dU, dR), want):
            assert torch.equal(got, ref)
        assert bool(torch.isfinite(dU).all()) and bool(torch.isfinite(dR).all())


@pytest.mark.parametrize("name", sorted(CASES))
def test_partial_sums_land_on_the_plain_rows(name, monkeypatch):
    """``_tile_row_index``: every tile's query rows, then every tile's
    coverer rows, as the plain backward concatenates them."""
    for U, _, _, bin_s, cov_pos, tiles, cap, _ in _grid_calls(name, monkeypatch):
        n = bin_s.shape[0]
        q, crow, _ = _tile_indices(bin_s, cov_pos, tiles, n, cap)
        want = torch.cat([q.reshape(-1), crow.reshape(-1)])
        got = thpr._tile_row_index(tiles, n, cap, cov_pos is not None)
        assert torch.equal(got, want)
        assert int(got.max()) < U.shape[0]


def test_kernel_wrappers_refuse_bad_inputs(monkeypatch):
    """The wrappers check before they build or launch: CPU tensors, a cap
    over n, a half-precision table."""
    U, R, beta, bin_s, cov_pos, tiles, cap, _ = _grid_calls("stratified", monkeypatch)[0]

    def loaded():
        raise AssertionError("the wrapper reached the library")

    monkeypatch.setattr(_kernels, "_load", loaded)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        _kernels.soft_binned_fwd(U, R, beta, bin_s, cov_pos, tiles, cap)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        g = torch.zeros((tiles.shape[0], cap))
        _kernels.soft_binned_bwd(U, R, beta, bin_s, cov_pos, tiles, g, g, g, cap)
    with pytest.raises(ValueError, match="bad cap"):
        _kernels.soft_binned_fwd(U, R, beta, bin_s, cov_pos, tiles, bin_s.shape[0] + 1)
    with pytest.raises(ValueError, match="float32 or float64"):
        _kernels.soft_binned_fwd(U.half(), R, beta, bin_s, cov_pos, tiles, cap)
