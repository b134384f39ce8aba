"""Losses: the port of ``repro.training.losses`` (the CE family and
the Barlow-Twins loss).

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
        # a Python weight is filled on the value's device, not copied
        # there from the host (a copy would synchronise the card)
        w = weight.to(device=v.device, dtype=torch.float32) \
            if isinstance(weight, torch.Tensor) \
            else torch.full((), weight, dtype=torch.float32,
                            device=v.device)
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


def barlow_twins_loss(z1: torch.Tensor, z2: torch.Tensor,
                      lambda_offdiag: float = 5e-3) -> torch.Tensor:
    """Redundancy-reduction loss on two embedding views [B, D]:
    C = (z1_norm^T z2_norm)/B;  loss = Σ_i (1−C_ii)² + λ Σ_{i≠j} C_ij²
    (per-feature standardisation with the population std, in f32)."""
    z1, z2 = z1.float(), z2.float()
    b = z1.shape[0]
    z1 = (z1 - z1.mean(0)) / (z1.std(0, unbiased=False) + 1e-5)
    z2 = (z2 - z2.mean(0)) / (z2.std(0, unbiased=False) + 1e-5)
    c = (z1.T @ z2) / b
    diag = torch.diagonal(c)
    on = torch.sum(torch.square(1.0 - diag))
    off = torch.sum(torch.square(c)) - torch.sum(torch.square(diag))
    return on + lambda_offdiag * off


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
