"""Gradient-safe numerical primitives.

Twin of ``trajectory_optimization_tpu/ops/numerics.py``. ``torch.linalg.norm``
already has a zero subgradient at 0, but a sum-then-sqrt written by hand does
not; ``safe_norm`` keeps the JAX package's double-``where`` form so the two
packages agree term for term (cloud 10 and the first step's anchor
‖p₀ − p₀⁰‖ hit exactly 0).
"""
from __future__ import annotations

import torch


def safe_norm(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """L2 norm with subgradient 0 at x == 0 (double-``where`` trick)."""
    sq = torch.sum(torch.square(x), dim=dim, keepdim=keepdim)
    is_zero = sq == 0
    safe_sq = torch.where(is_zero, torch.ones_like(sq), sq)
    return torch.where(is_zero, torch.zeros_like(sq), torch.sqrt(safe_sq))


def acos_clipped(cos: torch.Tensor, grad_margin: float = 1e-6) -> torch.Tensor:
    """arccos with the value from clip(cos, -1, 1) and the gradient from
    clip(cos, -1+m, 1-m): finite slope at exactly ±1 (collinear waypoints)."""
    value_arg = torch.clamp(cos, -1.0, 1.0)
    grad_arg = torch.clamp(cos, -1.0 + grad_margin, 1.0 - grad_margin)
    return torch.arccos(grad_arg) + (torch.arccos(value_arg) - torch.arccos(grad_arg)).detach()
