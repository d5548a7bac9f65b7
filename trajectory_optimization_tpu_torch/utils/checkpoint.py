"""Checkpoint / resume for optimization state (flat npz).

Twin of ``trajectory_optimization_tpu/utils/checkpoint.py``'s npz format:
one ``leaf_i`` array per leaf of the payload (params, opt_state, step,
extra), ``n_leaves``, and the structure as the JAX twin's treedef string,
so a checkpoint written by either package reads back in the other. Leaves
are tensors (copied to the host), numpy arrays or Python scalars; dicts
(sorted keys), lists, tuples, namedtuples and None make the structure, as
in a JAX pytree. The JAX twin's orbax directory format is not ported (the
card's machine has no orbax): every path is an ``.npz``.

The reference has no persistence at all — optimization state lives for one
ROS callback and dies (SURVEY.md §5 "checkpoint/resume: none"). Here any
(params, opt_state, step) tuple can be saved and restored, enabling
long-running / preemptible trajectory optimization and warm-starting the
next message's problem from the previous solution.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, leaves: List) -> str:
    """Append ``tree``'s leaves to ``leaves`` in JAX's order; return the
    structure in ``str(jax.tree_util.tree_structure(tree))``'s notation,
    without the ``PyTreeDef(...)`` wrapper."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        keys = sorted(tree)
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}" for k in keys) + "}"
    if _is_namedtuple(tree):
        kids = ", ".join(_flatten(v, leaves) for v in tree)
        return f"CustomNode(namedtuple[{type(tree).__name__}], [{kids}])"
    if isinstance(tree, tuple):
        kids = [_flatten(v, leaves) for v in tree]
        return "(" + ", ".join(kids) + ("," if len(kids) == 1 else "") + ")"
    if isinstance(tree, list):
        return "[" + ", ".join(_flatten(v, leaves) for v in tree) + "]"
    leaves.append(tree)
    return "*"


def tree_flatten(tree) -> Tuple[List, str]:
    """(leaves, treedef string) of a payload, the JAX twin's order and
    notation."""
    leaves: List = []
    return leaves, f"PyTreeDef({_flatten(tree, leaves)})"


def _unflatten(like, it):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], it) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, it) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, it) for v in like)
    arr = next(it)
    import torch

    if isinstance(like, torch.Tensor):  # back on the example's device, bit-equal
        return torch.from_numpy(np.array(arr)).to(like.device)
    return arr


def _host(x) -> np.ndarray:
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _save_npz(path: str, payload) -> str:
    flat, treedef = tree_flatten(payload)
    path = path if path.endswith(".npz") else path + ".npz"
    np.savez(
        path,
        treedef=np.frombuffer(treedef.encode(), dtype=np.uint8),
        n_leaves=len(flat),
        **{f"leaf_{i}": _host(x) for i, x in enumerate(flat)},
    )
    return path


def save_checkpoint(path: str, params, opt_state=None, step: int = 0, extra: Optional[Dict] = None) -> str:
    """Save an optimization state as a flat ``.npz`` (appended to ``path``
    where missing); returns the path written."""
    payload = {"params": params, "opt_state": opt_state, "step": step, "extra": extra or {}}
    return _save_npz(path, payload)


def load_checkpoint(path: str, like=None):
    """Restore a checkpoint saved by :func:`save_checkpoint`.

    ``like``: an example payload (same structure), required. The restore
    verifies the saved treedef against ``like`` and requires every leaf to
    be present (a structure mismatch raises instead of silently
    mis-assigning leaves). A leaf whose example is a tensor comes back as a
    tensor on the example's device; every other leaf as a numpy array.
    """
    if like is None:
        raise ValueError("npz checkpoint restore requires `like` (an example pytree)")
    with np.load(path if path.endswith(".npz") else path + ".npz", allow_pickle=False) as data:
        flat, treedef = tree_flatten(like)
        if "treedef" in data:
            saved_td = bytes(np.asarray(data["treedef"])).decode()
            if saved_td != treedef:
                raise ValueError(
                    "checkpoint structure mismatch: saved treedef "
                    f"{saved_td!r} != `like` treedef {treedef!r}"
                )
        n_saved = int(data["n_leaves"]) if "n_leaves" in data else len(flat)
        if n_saved != len(flat):
            raise ValueError(f"checkpoint has {n_saved} leaves, `like` has {len(flat)}")
        leaves = []
        for i in range(len(flat)):
            key = f"leaf_{i}"
            if key not in data:
                raise KeyError(f"checkpoint missing {key} (corrupt or partial save)")
            leaves.append(data[key])
    return _unflatten(like, iter(leaves))
