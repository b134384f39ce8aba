"""Filter-normalized 1-D / 2-D loss-landscape slices (Li et al. 2018):
the port of ``repro.diagnostics.landscape``.

The loss along ``w + α·d`` (1-D) or ``w + α·d₁ + β·d₂`` (2-D) for
directions that are either random *filter-normalized* Gaussians — each
filter of d rescaled to the norm of the matching filter of w, which
removes the scale invariance that makes raw random slices meaningless
— or the difference between two checkpoints.

Evaluation runs on the flat ``(rows, 128)`` layout: params and
directions are packed once in f32 and every point is ``loss(w2d +
α·d2d)`` through the microbatch loop, unpacked to the params' dtypes.

Filters follow the port's layouts: the last axis of a dense weight
(``x @ w``: its output features) as in the reference, but axis 0 of a
4-D convolution weight, which the port stores OIHW where the JAX
package stores HWIO. An LM's per-layer tensors are filtered layer by
layer, where the reference's stacked leaves share a filter's norm
across the group axis.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import flatten
from repro_torch.core.base import (tree_flatten_with_path, tree_from_paths,
                                   tree_map)
from repro_torch.diagnostics import hvp

PyTree = Any


def _filter_dims(w: torch.Tensor) -> tuple:
    """The axes a filter's norm sums over: all but the output axis."""
    out_axis = 0 if w.dim() == 4 else w.dim() - 1
    return tuple(a for a in range(w.dim()) if a != out_axis)


def filter_normalized_direction(gen: torch.Generator, params: PyTree, *,
                                eps: float = 1e-12) -> PyTree:
    """Random Gaussian direction, filter-normalized against ``params``.

    Leaves are drawn in flatten order from ``gen`` (on the leaves'
    device). For leaves with ndim ≥ 2 each output filter of d is scaled
    to the norm of the matching filter of w; 0/1-D leaves (biases,
    norms) are scaled leaf-wise.
    """

    def one(w):
        w = w.detach().float()
        d = torch.randn(w.shape, generator=gen, dtype=torch.float32,
                        device=w.device)
        if w.dim() >= 2:
            dims = _filter_dims(w)
            w_n = torch.sqrt(torch.sum(w ** 2, dim=dims, keepdim=True))
            d_n = torch.sqrt(torch.sum(d ** 2, dim=dims, keepdim=True))
        else:
            w_n = torch.sqrt(torch.sum(w ** 2))
            d_n = torch.sqrt(torch.sum(d ** 2))
        return d * w_n / (d_n + eps)

    # draw in flatten (sorted-key) order, as the reference splits its
    # key over the flattened leaves: tree_map would follow insertion order
    drawn = {path: one(leaf) for path, leaf in
             tree_flatten_with_path(params)}
    return tree_from_paths(params, drawn)


def direction_between(params_a: PyTree, params_b: PyTree) -> PyTree:
    """Checkpoint-to-checkpoint direction ``b − a`` (α=0 is a, α=1 b)."""
    return tree_map(lambda a, b: b.detach().float() - a.detach().float(),
                    params_a, params_b)


def _packed(task, params: PyTree, *directions: PyTree):
    spec = hvp.build_spec(task, params)
    with torch.no_grad():
        return spec, [flatten.pack(t, spec) for t in (params,) + directions]


def loss_slice_1d(task, params: PyTree, direction: PyTree, batch: PyTree,
                  alphas, *, accum_steps: int = 1) -> torch.Tensor:
    """``loss(w + α·d)`` for each α — returns ``[len(alphas)]`` f32."""
    spec, (w2d, d2d) = _packed(task, params, direction)
    loss_of = hvp.flat_loss_fn(task, spec, batch, accum_steps,
                               template=params)
    alphas = torch.as_tensor(alphas, dtype=torch.float32,
                             device=w2d.device)
    return torch.stack([loss_of(w2d + a * d2d) for a in alphas])


def loss_slice_2d(task, params: PyTree, d1: PyTree, d2: PyTree,
                  batch: PyTree, alphas, betas, *,
                  accum_steps: int = 1) -> torch.Tensor:
    """``loss(w + α·d₁ + β·d₂)`` grid — ``[len(alphas), len(betas)]``."""
    spec, (w2d, d1_2d, d2_2d) = _packed(task, params, d1, d2)
    loss_of = hvp.flat_loss_fn(task, spec, batch, accum_steps,
                               template=params)
    alphas = torch.as_tensor(alphas, dtype=torch.float32,
                             device=w2d.device)
    betas = torch.as_tensor(betas, dtype=torch.float32, device=w2d.device)
    grid = torch.stack(torch.meshgrid(alphas, betas, indexing="ij"),
                       dim=-1).reshape(-1, 2)
    losses = torch.stack([loss_of(w2d + ab[0] * d1_2d + ab[1] * d2_2d)
                          for ab in grid])
    return losses.reshape(alphas.shape[0], betas.shape[0])
