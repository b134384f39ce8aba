"""Task abstraction: the port of ``repro.training.tasks``.

A :class:`Task` is a name plus ``loss_fn(params, batch) -> (loss,
metrics)``; both are mean-reduced over the batch, which is what makes
gradient accumulation exact.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.training import losses


class Task(NamedTuple):
    """name + ``loss_fn(params, batch) -> (scalar loss, metrics dict)``."""
    name: str
    loss_fn: Callable


def lm_task(model, *, lb_coef: float = 1e-2, z_coef: float = 1e-3) -> Task:
    """Next-token LM: the fused chunked CE head plus the MoE auxiliary
    terms (zero for the dense family). ``batch``: ``{"tokens": [B,S],
    "labels": [B,S]}``."""

    def loss_fn(params, batch):
        ce, aux = model.loss(params, batch)
        loss = ce + lb_coef * aux.load_balance_loss \
            + z_coef * aux.router_z_loss
        return loss, {"ce": ce, "load_balance": aux.load_balance_loss}

    return Task("lm", loss_fn)


def classifier_task(apply_fn: Callable) -> Task:
    """Image classification: CE + accuracy. ``batch``: (images, labels)."""

    def loss_fn(params, batch):
        images, labels = batch
        logits = apply_fn(params, images)
        return losses.cross_entropy(logits, labels), \
            {"accuracy": losses.accuracy(logits, labels)}

    return Task("classifier", loss_fn)
