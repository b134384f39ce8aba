"""SGD + momentum: the port of ``repro.core.sgd`` (the small-batch
baseline)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.base import (GradientTransform, PyTree,
                                   tree_flatten_with_path, tree_from_paths,
                                   tree_get, tree_leaves, tree_map)
from repro_torch.core.schedules import Schedule


class SgdState(NamedTuple):
    step: torch.Tensor
    momentum: PyTree


def sgd(learning_rate: Schedule, *, momentum: float = 0.9,
        weight_decay: float = 0.0, nesterov: bool = False
        ) -> GradientTransform:

    def init(params):
        dev = tree_leaves(params)[0].device
        return SgdState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            momentum=tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params))

    def update(grads, state, params=None):
        lr = learning_rate(state.step)
        new_m, updates = {}, {}
        with torch.no_grad():
            for path, g in tree_flatten_with_path(grads):
                g32 = g.float()
                if weight_decay:
                    g32 = g32 + weight_decay * tree_get(params, path).float()
                m = momentum * tree_get(state.momentum, path) + g32
                step_dir = g32 + momentum * m if nesterov else m
                new_m[path] = m
                updates[path] = -lr * step_dir
        return (tree_from_paths(params, updates),
                SgdState(step=state.step + 1,
                         momentum=tree_from_paths(params, new_m)))

    return GradientTransform(init, update)
