"""Parameters and optimizer state carried across from numpy.

The JAX package's parameters are a {"poses": (W,3), "quats": (W,4)} pytree
and its Adam state is optax's (per-group mu, nu and count). Handed over as
numpy arrays, these helpers rebuild the port's parameter dict and its
functional Adam state (``opt.engine.adam_init`` layout), so both engines can
start from the same mid-run state; ``api.TrajectoryOptimizer`` warm-starts
from the same dict.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

PARAM_KEYS = ("poses", "quats")


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device).clone()


def params_from_numpy(params: Mapping[str, np.ndarray], device="cpu") -> Dict[str, torch.Tensor]:
    """{"poses", "quats"} numpy (or array-like) → the port's f32 parameter dict."""
    return {k: _tensor(params[k], device) for k in PARAM_KEYS}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def adam_state_from_numpy(
    mu: Mapping[str, np.ndarray], nu: Mapping[str, np.ndarray], count: int, device="cpu"
) -> Dict:
    """First/second moments per parameter and the step count → the port's
    Adam state."""
    return {
        "mu": {k: _tensor(mu[k], device) for k in PARAM_KEYS},
        "nu": {k: _tensor(nu[k], device) for k in PARAM_KEYS},
        "count": torch.tensor(int(count), dtype=torch.int32, device=device),
    }
