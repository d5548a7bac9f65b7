"""The port's package-level exports and ``opt.engine.make_optimizer``,
against the JAX package.

Held: every name of each JAX subpackage's ``__all__`` (the top level,
``ops``, ``opt``, ``utils``, ``models``, ``bus``, ``parallel``) resolves in the port's
twin, the facade lazily, ``bus.ViewerNode`` included; ``make_optimizer``
over 5 steps of seeded gradients, with and without the exponential decay,
under both key pairs of the package (``poses``/``quats``, ``xy``/``yaw``,
``trans``/``quat``): within rtol 1e-6
(atol 1e-7) of the JAX twin's optax transformation, and ``params +
updates`` ``torch.equal`` to ``adam_update``'s new parameters at every step.
"""
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from trajectory_optimization_tpu.opt import engine as jengine  # noqa: E402
from trajectory_optimization_tpu_torch.opt import engine as tengine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SUBPACKAGES = ("", "ops", "opt", "utils", "models", "bus", "parallel")
NOT_PORTED = set()


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_export_resolves_in_the_port(sub):
    suffix = "." + sub if sub else ""
    jmod = importlib.import_module("trajectory_optimization_tpu" + suffix)
    tmod = importlib.import_module("trajectory_optimization_tpu_torch" + suffix)
    want = [n for n in jmod.__all__ if (sub, n) not in NOT_PORTED]
    assert [n for n in want if not hasattr(tmod, n)] == []
    if hasattr(tmod, "__all__"):
        assert set(want) <= set(tmod.__all__) | {"__version__"}


def test_facade_stays_lazy():
    """``import trajectory_optimization_tpu_torch`` loads the intrinsics, not
    the facade; the first attribute access imports it."""
    code = ("import sys, trajectory_optimization_tpu_torch as t\n"
            "assert 'trajectory_optimization_tpu_torch.api' not in sys.modules\n"
            "assert t.TrajectoryOptimizer.__module__ == 'trajectory_optimization_tpu_torch.api'\n"
            "assert t.PoseResult is sys.modules['trajectory_optimization_tpu_torch.api'].PoseResult\n"
            "try:\n    t.NoSuchName\nexcept AttributeError:\n    pass\nelse:\n    raise SystemExit(1)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


KEYS = {("poses", "quats"): ((5, 3), (5, 4)), ("xy", "yaw"): ((5, 2), (5,)),
        ("trans", "quat"): ((1, 3), (1, 4))}


@pytest.mark.parametrize("decay", [False, True])
@pytest.mark.parametrize("keys", list(KEYS))
def test_make_optimizer_matches_optax_and_adam_update(keys, decay):
    kw = dict(lr_pose=0.1, lr_quat=0.02)
    if decay:
        kw.update(decay_gamma=0.5, decay_every=2)
    pose_key, quat_key = keys
    rng = np.random.default_rng(7)
    p_np = {k: rng.normal(size=s).astype(np.float32) for k, s in zip(keys, KEYS[keys])}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p_np.items()}
             for _ in range(5)]

    jtx = jengine.make_optimizer(jengine.OptimizerConfig(**kw), pose_key, quat_key)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    js = jtx.init(jp)
    cfg = tengine.OptimizerConfig(**kw)
    tx = tengine.make_optimizer(cfg, pose_key, quat_key)
    tp = {k: torch.as_tensor(v) for k, v in p_np.items()}
    ts = tx.init(tp)
    lrs = tengine.group_lrs(cfg, pose_key, quat_key)
    ap, st = dict(tp), tengine.adam_init(tp)
    for g in grads:
        u, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        tg = {k: torch.as_tensor(v) for k, v in g.items()}
        upd, ts = tx.update(tg, ts, tp)
        tp = tengine.apply_updates(tp, upd)
        ap, st = tengine.adam_update(tg, st, ap, cfg, lrs)
        for k in keys:
            assert torch.equal(tp[k], ap[k]), k
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
    assert int(ts["count"]) == 5
