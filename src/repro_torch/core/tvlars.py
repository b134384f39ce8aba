"""TVLARS (the paper's Algorithm 1): the port of ``repro.core.tvlars``.

Base LR γ_target·φ_t with φ_t = 1/(α + exp(λ(t − d_e))) + γ_min
(Eq. 5) and no external scheduler. ``momentum_style="paper"`` is
Algorithm 1's parameter-space momentum (the buffer holds the previous
proposed params, m_0 = w_0); ``"lars"`` the conventional heavy ball.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.base import GradientTransform, PyTree
from repro_torch.core.layerwise import layerwise_transform
from repro_torch.core.schedules import tvlars_phi


class TVLarsState(NamedTuple):
    step: torch.Tensor
    momentum: PyTree   # previous proposed params (paper) or velocity


def tvlars(gamma_target: float, *, lam: float = 1e-4,
           delay_steps: int = 100, alpha: float = 1.0,
           gamma_min: float = 1e-3, eta: float = 1e-3,
           momentum: float = 0.9, weight_decay: float = 5e-4,
           eps: float = 1e-9, momentum_style: str = "paper",
           use_kernel=False, precision: str = "f32", segments=None,
           device="cuda") -> GradientTransform:
    """Build TVLARS; ``gamma_target`` is Table 1's target LR."""
    if momentum_style not in ("paper", "lars"):
        raise ValueError(f"unknown momentum_style {momentum_style!r}")
    phi = tvlars_phi(lam, delay_steps, alpha, gamma_min)

    def base_lr(step):
        return gamma_target * phi(step)

    return layerwise_transform(
        base_lr, mode=momentum_style, state_cls=TVLarsState, eta=eta,
        momentum=momentum, weight_decay=weight_decay, eps=eps,
        use_kernel=use_kernel,
        precision=precision, optimizer_name="tvlars", segments=segments,
        device=device)
