"""The port's ``utils/checkpoint.py`` against the JAX package's.

Held: a port checkpoint of tensors (f32, f64, int64), numpy arrays,
scalars, a namedtuple state and None reads back bit-equal, tensors as
tensors; its treedef string is ``str(jax.tree_util.tree_structure(...))``
of the same payload, so a port checkpoint loads in the JAX package and a
JAX one in the port, equal; a structure mismatch, a leaf-count mismatch and
a missing ``like`` raise as in the twin.
"""
import collections

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from trajectory_optimization_tpu.utils import checkpoint as jckpt  # noqa: E402
from trajectory_optimization_tpu_torch.utils import checkpoint as tckpt  # noqa: E402

State = collections.namedtuple("State", ["count", "mu"])


def _payload(rng):
    params = {"poses": rng.normal(size=(5, 3)).astype(np.float32),
              "quats": rng.normal(size=(5, 4)).astype(np.float32)}
    opt = (State(np.int64(7), {"poses": rng.normal(size=(5, 3)), "quats": None}), ())
    return params, opt


def _torch(x):
    if isinstance(x, dict):
        return {k: _torch(v) for k, v in x.items()}
    if isinstance(x, State):
        return State(*(_torch(v) for v in x))
    if isinstance(x, tuple):
        return tuple(_torch(v) for v in x)
    return None if x is None else torch.as_tensor(np.asarray(x))


def _leaves_equal(a, b):
    la, lb = tckpt.tree_flatten(a)[0], tckpt.tree_flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_a_port_checkpoint_reads_back_bit_equal(tmp_path):
    params, opt = _payload(np.random.default_rng(0))
    tp, to = _torch(params), _torch(opt)
    path = tckpt.save_checkpoint(str(tmp_path / "ck"), tp, to, step=12, extra={"lr": 0.1})
    assert path.endswith(".npz")
    like = {"params": tp, "opt_state": to, "step": 0, "extra": {"lr": 0.0}}
    back = tckpt.load_checkpoint(path, like)
    assert isinstance(back["params"]["poses"], torch.Tensor)
    assert isinstance(back["opt_state"][0], State)
    assert back["opt_state"][0].mu["quats"] is None and back["opt_state"][1] == ()
    _leaves_equal(back, {"params": tp, "opt_state": to, "step": 12, "extra": {"lr": 0.1}})


def test_checkpoints_cross_between_the_packages(tmp_path):
    params, opt = _payload(np.random.default_rng(1))
    payload = {"params": params, "opt_state": opt, "step": 3, "extra": {}}
    assert tckpt.tree_flatten(payload)[1] == str(jax.tree_util.tree_structure(payload))
    t_path = tckpt.save_checkpoint(str(tmp_path / "t.npz"), _torch(params), _torch(opt), 3)
    j_path = jckpt.save_checkpoint(str(tmp_path / "j.npz"),
                                   jax.tree_util.tree_map(jnp.asarray, params), opt, 3)
    from_port = jckpt.load_checkpoint(t_path, payload)
    from_jax = tckpt.load_checkpoint(j_path, payload)
    _leaves_equal(from_port, from_jax)
    _leaves_equal(from_jax, payload)


def test_a_mismatched_checkpoint_raises(tmp_path):
    params, opt = _payload(np.random.default_rng(2))
    path = tckpt.save_checkpoint(str(tmp_path / "m.npz"), _torch(params), None, 1)
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.load_checkpoint(path, {"params": {"poses": 0}, "opt_state": None, "step": 0,
                                     "extra": {}})
    with pytest.raises(ValueError, match="requires `like`"):
        tckpt.load_checkpoint(path)
    with np.load(path) as d:
        arrays = {k: d[k] for k in d.files if k != "treedef"}
    arrays["n_leaves"] = np.int64(5)
    np.savez(tmp_path / "n.npz", **arrays)
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load_checkpoint(str(tmp_path / "n.npz"),
                              {"params": params, "opt_state": None, "step": 0, "extra": {}})
