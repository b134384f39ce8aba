"""Losses: the port of ``repro.training.losses`` (the CE family and
the Barlow-Twins loss).

Every loss is MEAN-reduced over the batch; :class:`WeightedMean` folds
K per-microbatch means into the global-batch mean, so K microbatches of
B/K samples reproduce the 1×B statistics.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

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


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two matrices as an f32 product, unrounded. Narrower
    operands (bf16) go to ``torch.mm(..., out_dtype=torch.float32)`` on
    the card (tensor cores, no f32 copy of either operand) and on meta
    (the dry run); on the CPU, which has no kernel for it, to the plain
    f32 product of the same values. Operands of f32 or wider take the
    plain product."""
    if a.dtype == b.dtype and a.dtype.itemsize >= 4:
        return a.mm(b)
    if a.device.type == "cpu":
        return a.float().mm(b.float())
    return torch.mm(a, b, out_dtype=torch.float32)


class _F32Product(torch.autograd.Function):
    """:func:`_mm_f32` under autograd (``mm``'s ``out_dtype`` form has
    no derivative). The product is bilinear, so its backward is the two
    products a single rank's head differentiates twice with, in the
    operands' dtypes: ``c @ bᵀ`` and ``aᵀ @ c``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, c):
        a, b = ctx.saved_tensors
        ga = c.to(a.dtype).mm(b.t()) if ctx.needs_input_grad[0] else None
        gb = a.t().mm(c.to(b.dtype)) if ctx.needs_input_grad[1] else None
        return ga, gb


class _VocabParallelHead(torch.autograd.Function):
    """``h @ w`` for this rank's columns ``w`` [D, V/M] of a head split
    over the model row: the logits block in the operands' dtype. The
    backward gives ``w`` the gradient autograd gives a product's second
    operand (``hᵀ @ g``, the same call for the same layout), and ``h``
    the row's sum of each rank's partial ``g @ wᵀ``: each partial an f32
    product (:class:`_F32Product`), summed over the row in f32
    (``sum_over_row``) and rounded to ``h``'s dtype once, after the sum.
    A bf16 partial rounded on each rank first would lose the bits that
    cancel in the sum. The backward is made of autograd functions, so
    a Hessian-vector product differentiates through it."""

    @staticmethod
    def forward(ctx, h, w, mesh):
        ctx.mesh = mesh
        ctx.save_for_backward(h, w)
        return h @ w

    @staticmethod
    def backward(ctx, g):
        from repro_torch.distributed import copy_to_row, sum_over_row
        h, w = ctx.saved_tensors
        g2d = g.reshape(-1, g.shape[-1])
        gh = gw = None
        if ctx.needs_input_grad[0]:
            part = _F32Product.apply(g2d, w.t())
            gh = sum_over_row(part, ctx.mesh).to(h.dtype).view(h.shape)
        if ctx.needs_input_grad[1]:
            # h is whole on every rank of the row and this rank's
            # gradient of w reads it: differentiated again, the row's
            # parts of h's gradient are summed (copy_to_row)
            h2d = copy_to_row(h, ctx.mesh).reshape(-1, h.shape[-1])
            # as autograd's mm backward forms a second operand's
            # gradient (column-major for a column-major operand), so
            # w's gradient has the bits of the plain product's
            if w.stride(0) == 1 and w.stride(1) == w.shape[0]:
                gw = g2d.t().mm(h2d).t()
            else:
                gw = h2d.t().mm(g2d)
        return gh, gw, None


def _chunk_ce_vocab_parallel(h_blk, unembed_w, y_blk, mesh):
    """One chunk's Σ CE over a vocabulary split over the model row: this
    rank's logits block [B, c, V/M] only. The row max (a stabiliser, no
    gradient), the row's Σ exp and the target logit from the rank that
    owns it are each one collective over the row, so f32 logits are
    never gathered; the backward (softmax − one-hot on the rank's
    block, scaled by the upstream gradient) is local, and the gradient
    of ``h_blk`` is summed over the row in f32 and rounded once
    (:class:`_VocabParallelHead`)."""
    from repro_torch.distributed import sum_over_row
    logits = _VocabParallelHead.apply(h_blk, unembed_w, mesh).float()
    local = logits.shape[-1]
    m = mesh.row_max_(logits.detach().amax(dim=-1))
    sumexp = sum_over_row(torch.exp(logits - m[..., None]).sum(dim=-1),
                          mesh)
    loc = y_blk.long() - mesh.coords["model"] * local
    mine = (loc >= 0) & (loc < local)
    gold = torch.gather(logits, -1,
                        torch.where(mine, loc, 0)[..., None])[..., 0]
    gold = sum_over_row(torch.where(mine, gold, torch.zeros_like(gold)),
                        mesh)
    return torch.sum(torch.log(sumexp) + m - gold)


def fused_ce_from_hidden(h: torch.Tensor, unembed_w: torch.Tensor,
                         labels: torch.Tensor, *, mesh=None,
                         vocab: Optional[int] = None) -> torch.Tensor:
    """Chunked softmax cross-entropy fused with the unembed projection:
    the sequence is cut into ``CE_CHUNK`` blocks whose logits are
    recomputed in the backward (checkpointed), so [B, S, V] logits
    never exist whole. h [B,S,D], unembed_w [D,V], labels [B,S] ->
    scalar mean CE. A head holding ``V/M`` of ``vocab`` columns (split
    over ``mesh``'s model row) is vocabulary-parallel cross-entropy
    (:func:`_chunk_ce_vocab_parallel`)."""
    b, s, _ = h.shape
    chunk = CE_CHUNK if s % CE_CHUNK == 0 else s
    split = vocab is not None and unembed_w.shape[1] != vocab
    if split and (mesh is None
                  or unembed_w.shape[1] * mesh.shape["model"] != vocab):
        raise ValueError(f"a head of {unembed_w.shape[1]} of {vocab} "
                         f"columns needs the mesh whose model row splits "
                         f"it, got {mesh}")
    fn = _chunk_ce_vocab_parallel if split else _chunk_ce
    extra = (mesh,) if split else ()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for off in range(0, s, chunk):
        h_blk, y_blk = h[:, off:off + chunk], labels[:, off:off + chunk]
        if torch.is_grad_enabled():
            part = checkpoint(fn, h_blk, unembed_w, y_blk, *extra,
                              use_reentrant=False)
        else:
            part = fn(h_blk, unembed_w, y_blk, *extra)
        total = total + part
    return total / (b * s)
