"""Task abstraction: the port of ``repro.training.tasks``.

A :class:`Task` is a name plus ``loss_fn(params, batch) -> (loss,
metrics)``; both are mean-reduced over the batch, which is what makes
gradient accumulation exact. An LM task also carries its model's
``segments`` (the JAX package's stacked leaves), so the diagnostics'
flat vectors use the reference's layout on the port's per-layer tree.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

from repro_torch.training import losses


class Task(NamedTuple):
    """name + ``loss_fn(params, batch) -> (scalar loss, metrics dict)``;
    ``segments`` groups the params for the flat layout
    (``core.flatten.build_spec``; None = one segment per leaf)."""
    name: str
    loss_fn: Callable
    segments: Optional[Callable] = None


def lm_task(model, *, lb_coef: float = 1e-2, z_coef: float = 1e-3) -> Task:
    """Next-token LM: the fused chunked CE head plus the MoE auxiliary
    terms (zero for the dense family). ``batch``: ``{"tokens": [B,S],
    "labels": [B,S]}``."""

    def loss_fn(params, batch):
        ce, aux = model.loss(params, batch)
        loss = ce + lb_coef * aux.load_balance_loss \
            + z_coef * aux.router_z_loss
        return loss, {"ce": ce, "load_balance": aux.load_balance_loss}

    return Task("lm", loss_fn, getattr(model, "segments", None))


def classifier_task(apply_fn: Callable) -> Task:
    """Image classification: CE + accuracy. ``batch``: (images, labels)."""

    def loss_fn(params, batch):
        images, labels = batch
        logits = apply_fn(params, images)
        return losses.cross_entropy(logits, labels), \
            {"accuracy": losses.accuracy(logits, labels)}

    return Task("classifier", loss_fn)


def ssl_task(embed_fn: Callable, *, lambda_offdiag: float = 5e-3) -> Task:
    """Barlow Twins: ``embed_fn(params, images) -> [B, D]``. ``batch``:
    (view1, view2)."""

    def loss_fn(params, batch):
        v1, v2 = batch
        z1 = embed_fn(params, v1)
        z2 = embed_fn(params, v2)
        return losses.barlow_twins_loss(z1, z2, lambda_offdiag), {}

    return Task("ssl", loss_fn)
