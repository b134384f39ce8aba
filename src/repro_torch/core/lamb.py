"""LAMB (You et al. 2020): the port of ``repro.core.lamb``.

Adam moments with bias correction, r = m̂/(√v̂ + eps) + wd·w, and the
layer-wise ratio ‖w‖/‖r‖ (clipped at ``trust_clip``). 1-D segments
bypass the ratio. There is no per-tensor kernel for LAMB.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.base import GradientTransform, PyTree
from repro_torch.core.layerwise import layerwise_transform
from repro_torch.core.schedules import Schedule


class LambState(NamedTuple):
    step: torch.Tensor
    mu: PyTree      # f32 trees, or flat (rows, 128) when fused
    nu: PyTree


def lamb(learning_rate: Schedule, *, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-6, weight_decay: float = 5e-4,
         trust_clip: Optional[float] = 10.0,
         use_kernel=False, precision: str = "f32", segments=None,
         device="cuda", placement=None) -> GradientTransform:
    return layerwise_transform(
        learning_rate, mode="lamb", state_cls=LambState, b1=b1, b2=b2,
        eps=eps, weight_decay=weight_decay, trust_clip=trust_clip,
        use_kernel=use_kernel,
        precision=precision, optimizer_name="lamb", segments=segments,
        device=device, placement=placement)
