"""Learning-rate schedules of the paper: the port of
``repro.core.schedules``.

Each schedule is ``f(step) -> 0-d f32 tensor``; ``step`` is an int or
an int tensor and the result lies on the step's device, so a training
step keeps its scalars on the card (the optimizer's step counter is a
device tensor) and reads none of them back.

* ``warmup_cosine``  — WA-LARS / WA-LAMB (Eq. 4): linear warm-up, then
  cosine anneal.
* ``polynomial``     — NOWA-LARS decay.
* ``tvlars_phi``     — Eq. 5: φ_t = 1/(α + exp(λ(t − d_e))) + γ_min.
* ``batch_scaled_lr`` — the sqrt / linear batch-size rules (§5.2.2).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

Schedule = Callable[[object], torch.Tensor]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  min_lr: float = 0.0) -> Schedule:
    """Eq. (4): linear warm-up to ``peak_lr`` then cosine anneal."""
    warmup_steps = max(int(warmup_steps), 1)
    decay_steps = max(int(total_steps) - warmup_steps, 1)

    def f(step):
        step = _f32(step)
        warm = peak_lr * step / warmup_steps
        t = torch.clamp((step - warmup_steps) / decay_steps, 0.0, 1.0)
        q = 0.5 * (1.0 + torch.cos(math.pi * t))
        cos = peak_lr * q + min_lr * (1.0 - q)
        return torch.where(step < warmup_steps, warm, cos)

    return f


def polynomial(peak_lr: float, total_steps: int, power: float = 2.0,
               min_lr: float = 0.0) -> Schedule:
    """Polynomial decay (NOWA-LARS baseline)."""
    total_steps = max(int(total_steps), 1)

    def f(step):
        t = torch.clamp(_f32(step) / total_steps, 0.0, 1.0)
        return (peak_lr - min_lr) * (1.0 - t) ** power + min_lr

    return f


def tvlars_phi(lam: float, delay_steps: int, alpha: float = 1.0,
               gamma_min: float = 0.0) -> Schedule:
    """Eq. (5), with ``exp``'s argument clamped to ±60."""

    def f(step):
        psi = lam * (_f32(step) - delay_steps)
        psi = torch.clamp(psi, -60.0, 60.0)
        return 1.0 / (alpha + torch.exp(psi)) + gamma_min

    return f


def tvlars_phi_bounds(lam: float, delay_steps: int, alpha: float = 1.0,
                      gamma_min: float = 0.0) -> tuple[float, float]:
    """Closed-form (lower, upper) bounds of φ_t (Eq. 6)."""
    upper = 1.0 / (alpha + math.exp(max(-60.0,
                                        min(60.0, -lam * delay_steps))))
    return gamma_min, upper + gamma_min


def sqrt_scaling(base_lr: float, batch_size: int,
                 base_batch_size: int) -> float:
    """γ = ε·sqrt(B/B_base) (§5.2.2)."""
    return base_lr * math.sqrt(batch_size / base_batch_size)


def linear_scaling(base_lr: float, batch_size: int,
                   base_batch_size: int) -> float:
    """γ = ε·(B/B_base)."""
    return base_lr * batch_size / base_batch_size


BATCH_SCALING_RULES = ("sqrt", "linear")


def batch_scaled_lr(base_lr: float, batch_size: Optional[int] = None,
                    base_batch_size: int = 256, rule: str = "sqrt", *,
                    batch_size_fn: Optional[Callable[[], int]] = None):
    """Batch-size LR scaling by named rule. ``batch_size`` is the GLOBAL
    batch (samples per optimizer step). With ``batch_size_fn`` instead,
    returns a zero-argument callable that re-reads the batch on every
    call."""
    if (batch_size is None) == (batch_size_fn is None):
        raise ValueError(
            "pass exactly one of batch_size (static) or batch_size_fn "
            "(stateful)")
    if batch_size_fn is not None:
        return lambda: batch_scaled_lr(base_lr, int(batch_size_fn()),
                                       base_batch_size, rule)
    if rule == "sqrt":
        return sqrt_scaling(base_lr, batch_size, base_batch_size)
    if rule == "linear":
        return linear_scaling(base_lr, batch_size, base_batch_size)
    raise ValueError(
        f"unknown batch-scaling rule {rule!r}; one of {BATCH_SCALING_RULES}")
