"""LARS (You, Gitman, Ginsburg 2017): the port of ``repro.core.lars``.

Eq. (2): γ_t^k = γ_scale(t)·η·‖w^k‖ / (‖∇L(w^k)‖ + wd·‖w^k‖ + eps),
then heavy ball m ← μ·m + γ_t^k·(g + wd·w); w ← w − m (optionally
nesterov). ``γ_scale`` is an external schedule (WA-LARS: warm-up +
cosine; NOWA-LARS: polynomial). 1-D segments bypass the trust ratio.
``trust_clip`` caps the ratio (LAMBC-style). Built on
:func:`repro_torch.core.layerwise.layerwise_transform`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.base import GradientTransform, PyTree
from repro_torch.core.layerwise import layerwise_transform
from repro_torch.core.schedules import Schedule


class LarsState(NamedTuple):
    step: torch.Tensor
    momentum: PyTree    # f32 tree, or flat (rows, 128) when fused


def lars(learning_rate: Schedule, *, eta: float = 1e-3,
         momentum: float = 0.9, weight_decay: float = 5e-4,
         eps: float = 1e-9, nesterov: bool = False,
         trust_clip: Optional[float] = None,
         use_kernel=False, precision: str = "f32", segments=None,
         device="cuda") -> GradientTransform:
    """Build LARS; ``segments`` / ``device`` as in
    :func:`~repro_torch.core.layerwise.layerwise_transform`."""
    return layerwise_transform(
        learning_rate, mode="lars", state_cls=LarsState, eta=eta,
        momentum=momentum, weight_decay=weight_decay, eps=eps,
        nesterov=nesterov, trust_clip=trust_clip,
        use_kernel=use_kernel,
        precision=precision, optimizer_name="lars", segments=segments,
        device=device)
