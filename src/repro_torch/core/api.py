"""Optimizer factory: the port of ``repro.core.api``.

``build_optimizer(name, total_steps=..., **hyper)`` returns a
GradientTransform for ``"wa-lars"`` / ``"lars"`` (LARS + warm-up +
cosine), ``"nowa-lars"`` (LARS + polynomial decay), ``"lambc-lars"``
(trust-ratio-clipped LARS, no warm-up), ``"lamb"`` (LAMB + warm-up +
cosine), ``"tvlars"`` (Algorithm 1) and ``"sgd"``.

``batch_size`` is the GLOBAL batch (samples per optimizer step): the
chosen ``scaling_rule`` scales the target LR (§5.2.2) and TVLARS's
γ_min defaults to (B/B_base)·1e-3 (§5.2.1), capped at 0.5.

``use_kernel="fused"`` runs the layer-wise update as two segmented
kernel launches per step on the flat substrate; ``"per_tensor"`` runs
two per-tensor LARS kernel launches per ADAPT segment (lars, wa-lars,
nowa-lars, tvlars with ``momentum_style="lars"``). Both run on
``device`` (default ``"cuda"``: asking for it on a host without CUDA
raises at build time). ``segments`` groups an LM tree by the JAX
package's stacked leaves (pass ``model.segments``). Unsupported
combinations raise at build time.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import schedules
from repro_torch.core.base import GradientTransform
from repro_torch.core.lamb import lamb
from repro_torch.core.lars import lars
from repro_torch.core.layerwise import normalize_use_kernel
from repro_torch.core.sgd import sgd
from repro_torch.core.tvlars import tvlars

OPTIMIZERS = ("wa-lars", "nowa-lars", "lars", "lambc-lars", "lamb",
              "tvlars", "sgd")


def build_optimizer(name: str, *, total_steps: int,
                    learning_rate: float = 1.0,
                    batch_size: Optional[int] = None,
                    base_batch_size: int = 256,
                    warmup_steps: Optional[int] = None,
                    delay_steps: Optional[int] = None,
                    lam: float = 1e-4,
                    alpha: float = 1.0,
                    gamma_min: Optional[float] = None,
                    eta: float = 1e-3,
                    momentum: float = 0.9,
                    weight_decay: float = 5e-4,
                    use_kernel=False,   # False | "per_tensor" | "fused"/True
                    precision: str = "f32",
                    momentum_style: str = "paper",
                    scaling_rule: str = "sqrt",
                    segments=None,
                    device="cuda", placement=None) -> GradientTransform:
    name = name.lower()
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; one of {OPTIMIZERS}")

    lr = learning_rate
    if batch_size is not None:
        lr = schedules.batch_scaled_lr(learning_rate, batch_size,
                                       base_batch_size, scaling_rule)
    if warmup_steps is None:
        warmup_steps = max(total_steps // 10, 1)
    if delay_steps is None:
        delay_steps = max(total_steps // 10, 1)
    if gamma_min is None:
        if batch_size is not None:
            gamma_min = (batch_size / base_batch_size) * 1e-3  # §5.2.1
        else:
            gamma_min = 1e-3
    gamma_min = min(gamma_min, 0.5)
    common = dict(use_kernel=use_kernel, precision=precision,
                  segments=segments, device=device, placement=placement)

    if name in ("wa-lars", "lars"):
        sched = schedules.warmup_cosine(lr, warmup_steps, total_steps)
        return lars(sched, eta=eta, momentum=momentum,
                    weight_decay=weight_decay, **common)
    if name == "lambc-lars":
        sched = schedules.polynomial(lr, total_steps)
        return lars(sched, eta=eta, momentum=momentum,
                    weight_decay=weight_decay, trust_clip=10.0, **common)
    if name == "nowa-lars":
        sched = schedules.polynomial(lr, total_steps)
        return lars(sched, eta=eta, momentum=momentum,
                    weight_decay=weight_decay, **common)
    if name == "lamb":
        sched = schedules.warmup_cosine(lr, warmup_steps, total_steps)
        return lamb(sched, weight_decay=weight_decay, **common)
    if name == "tvlars":
        return tvlars(lr, lam=lam, delay_steps=delay_steps, alpha=alpha,
                      gamma_min=gamma_min, eta=eta, momentum=momentum,
                      weight_decay=weight_decay,
                      momentum_style=momentum_style, **common)
    if name == "sgd":
        if normalize_use_kernel(use_kernel):
            raise ValueError(
                "sgd has no layer-wise kernel path; use_kernel must be "
                "False (the trust-ratio kernels only apply to "
                "lars/tvlars/lamb)")
        if precision != "f32":
            raise ValueError(
                "sgd has no fused substrate; precision must be 'f32'")
        sched = schedules.warmup_cosine(lr, warmup_steps, total_steps)
        return sgd(sched, momentum=momentum, weight_decay=weight_decay)
    raise AssertionError(name)
