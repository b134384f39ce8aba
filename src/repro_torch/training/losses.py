"""Losses: the port of ``repro.training.losses`` (the CE family).

Every loss is MEAN-reduced over the batch; :class:`WeightedMean` folds
K per-microbatch means into the global-batch mean, so K microbatches of
B/K samples reproduce the 1×B statistics.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint


class WeightedMean(NamedTuple):
    """Running weighted mean ``total / weight`` in f32 (0-d tensors on
    the value's device)."""
    total: torch.Tensor
    weight: torch.Tensor

    @classmethod
    def zero(cls, device=None) -> "WeightedMean":
        z = torch.zeros((), dtype=torch.float32, device=device)
        return cls(z, z)

    def add(self, value, weight=1.0) -> "WeightedMean":
        v = torch.as_tensor(value).to(torch.float32)
        w = torch.as_tensor(weight, dtype=torch.float32, device=v.device)
        return WeightedMean(self.total.to(v.device) + w * v,
                            self.weight.to(v.device) + w)

    def result(self) -> torch.Tensor:
        return self.total / torch.clamp(self.weight, min=1e-12)


def _ce_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Σ (logsumexp − gold logit) over all positions, in f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum(logz - gold)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """logits [..., C], labels [...] int -> scalar mean CE (f32)."""
    return _ce_sum(logits, labels) / labels.numel()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, dim=-1) == labels)
                      .to(torch.float32))


CE_CHUNK = 256


def _chunk_ce(h_blk, unembed_w, y_blk):
    return _ce_sum(h_blk @ unembed_w, y_blk)


def fused_ce_from_hidden(h: torch.Tensor, unembed_w: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Chunked softmax cross-entropy fused with the unembed projection:
    the sequence is cut into ``CE_CHUNK`` blocks whose logits are
    recomputed in the backward (checkpointed), so [B, S, V] logits
    never exist whole. h [B,S,D], unembed_w [D,V], labels [B,S] ->
    scalar mean CE."""
    b, s, _ = h.shape
    chunk = CE_CHUNK if s % CE_CHUNK == 0 else s
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for off in range(0, s, chunk):
        h_blk, y_blk = h[:, off:off + chunk], labels[:, off:off + chunk]
        if torch.is_grad_enabled():
            part = checkpoint(_chunk_ce, h_blk, unembed_w, y_blk,
                              use_reentrant=False)
        else:
            part = _chunk_ce(h_blk, unembed_w, y_blk)
        total = total + part
    return total / (b * s)
