"""Scalar sharpness measures, SAM ε-ball sharpness and the gradient
noise scale: the port of ``repro.diagnostics.sharpness``.

* :func:`sam_sharpness` — loss rise at the worst-case-direction
  first-order ascent step ``w + ρ·g/‖g‖`` (Foret et al. 2021); the
  paper's "warm-up LARS is trapped in sharp minimizers early" shows up
  directly in this trace.
* :func:`gradient_noise_scale` — the McCandlish et al. (2018) simple
  noise scale ``B_noise = tr(Σ)/‖G‖²`` from the K per-microbatch
  gradients of a stacked probe batch: unbiased ``‖G‖²`` and ``tr(Σ)``
  estimates from the (B/K)-sample and B-sample gradient norms.

Both run microbatch by microbatch at fixed peak memory (one microbatch
of activations), like the training step. Neither writes to the params:
the perturbed point is a new tree. Both take ``mesh=`` for the
data-parallel path (``hvp``'s module docstring). Under data parallelism
the noise-scale estimator is nearly free: the per-rank gradients ARE
the small-batch samples, so with D ranks and K microbatches it
contrasts K·D per-shard norms (b = B/(K·D)) against the averaged
global gradient (B), and K = 1 suffices whenever D ≥ 2.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.base import global_norm, tree_leaves, tree_map
from repro_torch.diagnostics import hvp

PyTree = Any


def sam_sharpness(task, params: PyTree, batch: PyTree, *,
                  rho: float = 0.05, accum_steps: int = 1, mesh=None,
                  data_axes=None,
                  eps: float = 1e-12) -> dict[str, torch.Tensor]:
    """SAM-style ε-ball sharpness on a probe batch.

    Returns ``{"sam_sharpness", "loss", "perturbed_loss"}`` (0-d f32
    device tensors) where ``sam_sharpness = loss(w + ρ·g/‖g‖) −
    loss(w)`` for the accumulated mean loss and gradient (≥ 0 up to
    higher-order terms). The perturbed params are ``(p.f32 +
    ρ·g/(‖g‖+ε))`` cast back to each leaf's dtype, a new tree. With
    ``mesh=`` both passes run on the rank's shard, on the averaged
    global gradient (the ascent direction every rank agrees on).
    """
    loss, grads = hvp.scanned_grads(task, params, batch, accum_steps,
                                    mesh=mesh, data_axes=data_axes)
    with torch.no_grad():
        gnorm = global_norm(grads)
        perturbed = tree_map(
            lambda p, g: (p.float() + rho * g / (gnorm + eps)).to(p.dtype),
            params, grads)
    del grads
    perturbed_loss = hvp.scanned_loss(task, perturbed, batch, accum_steps,
                                      mesh=mesh, data_axes=data_axes)
    return {"sam_sharpness": perturbed_loss - loss, "loss": loss,
            "perturbed_loss": perturbed_loss}


def _microbatch_size(batch: PyTree, accum_steps: int) -> int:
    leaf = tree_leaves(batch)[0]
    if accum_steps > 1:
        if leaf.dim() < 2:
            raise ValueError(
                f"stacked probe batch leaves need a [K, B/K, ...] shape; "
                f"got {tuple(leaf.shape)}")
        return int(leaf.shape[1])
    return int(leaf.shape[0])


def _gns_from_norms(s_small, s_big, b_small: int, b_big: int,
                    eps: float) -> dict[str, torch.Tensor]:
    """McCandlish estimators from E[‖g_b‖²] and ‖g_B‖²."""
    grad_sq = (b_big * s_big - b_small * s_small) / (b_big - b_small)
    trace_cov = (s_small - s_big) / (1.0 / b_small - 1.0 / b_big)
    noise_scale = trace_cov / torch.clamp(grad_sq, min=eps)
    return {"grad_noise_scale": noise_scale, "grad_sq": grad_sq,
            "trace_cov": trace_cov}


def gradient_noise_scale(task, params: PyTree, batch: PyTree, *,
                         accum_steps: int, mesh=None, data_axes=None,
                         eps: float = 1e-12) -> dict[str, torch.Tensor]:
    """Simple gradient noise scale from per-microbatch gradients.

    Single device: ``batch`` stacked ``[K, B/K, ...]`` with K ≥ 2. With
    ``b = B/K`` and ``B = K·b``, the unbiased estimators

        ‖G‖²   ≈ (B·‖g_B‖² − b·E[‖g_b‖²]) / (B − b)
        tr(Σ)  ≈ (E[‖g_b‖²] − ‖g_B‖²) / (1/b − 1/B)

    give ``B_noise = tr(Σ)/‖G‖²``, the McCandlish et al. critical batch
    size. Under ``mesh=`` with data width D the small-batch samples are
    the K·D per-rank per-microbatch gradients (b = B/(K·D)) and the big
    batch is the averaged global gradient, so K ≥ 2 is needed only at
    D = 1. Returns ``{"grad_noise_scale", "grad_sq", "trace_cov"}``
    (``grad_sq`` clamped to ≥ eps in the ratio: in a noise-dominated
    regime the ``‖G‖²`` estimate can go negative, so the reported scale
    saturates rather than flipping sign).
    """
    dp = hvp.mesh_dp_size(mesh, data_axes)
    if accum_steps * dp < 2:
        raise ValueError(
            "gradient_noise_scale needs two batch sizes to contrast: "
            "accum_steps >= 2 single-device, or a mesh with data "
            f"width >= 2 (got accum_steps={accum_steps}, "
            f"data_parallel={dp})")
    hvp.check_stacked(batch, accum_steps)
    b_small_global = _microbatch_size(batch, accum_steps)
    if b_small_global % dp:
        raise ValueError(
            f"probe microbatch {b_small_global} does not split over the "
            f"data-parallel width {dp}")
    b_small = b_small_global // dp
    b_big = accum_steps * b_small_global

    def local_norms(params, batch):
        """(E[‖g_b‖²] over the local microbatches, local mean grads)."""
        grad_acc, sq_acc = None, None
        for _, grads in hvp.microbatch_grads(task, params, batch,
                                             accum_steps):
            with torch.no_grad():
                sq = global_norm(grads) ** 2
                grad_acc = hvp.accumulate_f32(grad_acc, grads)
            del grads
            sq_acc = sq if sq_acc is None else sq_acc + sq
        with torch.no_grad():
            for a in grad_acc:
                a.div_(accum_steps)
        return sq_acc / accum_steps, grad_acc

    if not hvp._on_mesh(mesh):
        s_small, g_big = local_norms(params, batch)
    else:
        axes = hvp.mesh_data_axes(mesh, data_axes)

        def sharded(params, batch):
            sq_local, g_local = local_norms(params, batch)
            mesh.mean_([sq_local, *g_local])
            return sq_local, g_local

        s_small, g_big = hvp.pipeline.shard_over_data(
            sharded, mesh, axes, accum_steps)(params, batch)
    with torch.no_grad():
        s_big = global_norm(g_big) ** 2
    del g_big
    return _gns_from_norms(s_small, s_big, b_small, b_big, eps)
