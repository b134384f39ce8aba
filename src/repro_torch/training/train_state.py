"""TrainState: the port of ``repro.training.train_state``.

``params`` is the model's tree (updated in place by the trainer);
``opt_state`` the optimizer's (under ``use_kernel="fused"``, flat
``(rows, 128)`` buffers at the precision policy's storage dtype);
``step`` counts optimizer steps on the host.
"""
from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.core.base import GradientTransform


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any

    @classmethod
    def create(cls, params, optimizer: GradientTransform) -> "TrainState":
        return cls(step=0, params=params, opt_state=optimizer.init(params))
