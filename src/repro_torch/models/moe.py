"""Mixture-of-Experts layer: top-k capacity routing, the port of
``repro.models.moe``.

Each batch row is a routing group with its own per-expert capacity
C = ceil(S·k/E · capacity_factor) (padded to a multiple of 8 for full
sequences, at least 1 for a decode step). The (token, k) entries of a
row claim expert slots token-major, then by k-rank; entries past an
expert's capacity are dropped (their expert contribution is zero, the
residual stream carries them). Dispatch scatter-ADDS the kept tokens
into an [E·C, d] buffer per row, the experts run as three stacked
batched products over all E experts, and the combine gathers each
entry's slot weighted by its renormalised top-k probability.

A dropped entry is zeroed but still points at slot ``expert·C + 0``,
the slot of the token that really holds position 0 of that expert, so
dispatch must accumulate (``index_add``): an indexed assignment would
let the dropped zero overwrite the kept token, and on CUDA in no fixed
order.

Aux losses: load balance ``E · Σ_e mean(probs_e) · mean(top-1 == e)``
and router z ``mean(logsumexp(logits)²)``, returned for the trainer to
add. In a GSPMD training step (``layers.training`` over a data axis D >
1) each data row holds a block of the batch, and the two means of the
load balance are the global batch's, as the reference's GSPMD step
takes them: the column mean of the rows' means
(``distributed.column_mean``, whose backward is the column mean of the
gradient), before the product. A row's loss is the mean over its
block, and the fsdp gather's backward divides the router's gradient by
D, so that backward gives the reference's gradient. The router z loss
is linear in the positions and stays the row's mean (the step averages
the loss over the column). The mesh-native data axis (``--mesh-data``)
keeps each shard's means, as the reference's ``shard_map`` step does.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor
    router_z_loss: torch.Tensor


class Routing(NamedTuple):
    """A layer's routing decisions for x [B, S, d], per (token, k)
    entry flattened token-major: ``topk_idx`` [B, S, k] (experts by
    descending probability), ``keep`` [B, S·k] and ``slot`` [B, S·k]
    (``expert · cap + position``, position 0 where dropped)."""
    logits: torch.Tensor
    probs: torch.Tensor
    topk_probs: torch.Tensor
    topk_idx: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    cap: int


def init_moe(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Router [d, E] in f32 whatever the model's dtype; experts stacked
    on a leading expert axis: wi, wg [E, d, F], wo [E, F, d]."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    out_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    return {
        "router": L.normal_init(gen, (d, e), torch.float32, device),
        "wi": L.normal_init(gen, (e, d, f), cfg.pdtype, device),
        "wg": L.normal_init(gen, (e, d, f), cfg.pdtype, device),
        "wo": L.normal_init(gen, (e, f, d), cfg.pdtype, device, out_scale),
    }


def moe_capacity(group_tokens: int, cfg: ModelConfig) -> int:
    """Per-expert capacity within one routing group (one batch row of
    ``group_tokens`` positions, padding included): exact (at least 1)
    for a decode step, else padded to a multiple of 8, at least 8."""
    c = math.ceil(group_tokens * cfg.experts_per_token / cfg.num_experts
                  * cfg.capacity_factor)
    if group_tokens == 1:
        return max(1, c)
    return max(8, -(-c // 8) * 8)


def route(params: dict, cfg: ModelConfig, x: torch.Tensor) -> Routing:
    """Router logits in f32, softmax, top-k (ties to the lower expert
    index) renormalised by their sum + 1e-9, and each entry's slot: its
    position inside its expert is the number of earlier entries of the
    row (token-major, then k-rank) routed to the same expert."""
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = moe_capacity(s, cfg)
    logits = x.float() @ params["router"].float()               # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort breaks ties by the lower expert index,
    # as jax.lax.top_k does (torch.topk does not, on the CPU)
    topk_probs, topk_idx = torch.sort(probs, dim=-1, descending=True,
                                      stable=True)
    topk_probs, topk_idx = topk_probs[..., :k], topk_idx[..., :k]
    topk_probs = topk_probs / (topk_probs.sum(-1, keepdim=True) + 1e-9)
    expert_of = topk_idx.reshape(b, s * k)
    fa = F.one_hot(expert_of, e)                                # [B,S·k,E]
    pos = (torch.cumsum(fa, dim=1) - fa).gather(
        -1, expert_of[..., None])[..., 0]                       # [B,S·k]
    keep = pos < cap
    slot = expert_of * cap + torch.where(keep, pos, 0)
    return Routing(logits, probs, topk_probs, topk_idx, keep, slot, cap)


def moe_apply(params: dict, cfg: ModelConfig, x: torch.Tensor
              ) -> tuple[torch.Tensor, MoEAux]:
    """x: [B, S, d] -> (out [B, S, d], aux losses)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    r = route(params, cfg, x)
    cap = r.cap

    # dispatch: every row's kept entries added into its [E·C, d] block
    src = x.repeat_interleave(k, dim=1)                         # [B,S·k,d]
    src = torch.where(r.keep[..., None], src,
                      torch.zeros((), dtype=x.dtype, device=x.device))
    rows = torch.arange(b, device=x.device)[:, None] * (e * cap)
    buf = torch.zeros((b * e * cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, (rows + r.slot).reshape(-1),
                        src.reshape(b * s * k, d))
    # [B, E, C, d] -> [E, B·C, d]: one batched product per expert
    buf = buf.reshape(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)

    h = torch.bmm(buf, params["wi"].to(buf.dtype))
    g = torch.bmm(buf, params["wg"].to(buf.dtype))
    h = F.silu(g) * h
    out_buf = torch.bmm(h, params["wo"].to(buf.dtype))

    # combine: gather each entry's slot, weighted by its kept probability
    out_buf = out_buf.reshape(e, b, cap, d).transpose(0, 1).reshape(
        b, e * cap, d)
    gathered = out_buf[torch.arange(b, device=x.device)[:, None], r.slot]
    w = (r.topk_probs.reshape(b, s * k, 1) * r.keep[..., None]).to(
        gathered.dtype)
    out = (gathered * w).reshape(b, s, k, d).sum(dim=2)

    # aux losses (means over every position of the batch)
    me = r.probs.mean(dim=(0, 1))                               # [E]
    ce = F.one_hot(r.topk_idx[..., 0], e).float().mean(dim=(0, 1))
    column = L.data_column()
    if column is not None:
        # a GSPMD step's data row holds a block of the batch: both
        # means are the global batch's, the column mean of the rows'
        from repro_torch.distributed import column_mean
        me, ce = column_mean(torch.stack([me, ce]), column,
                             "moe_aux").unbind(0)
    lb = e * torch.sum(me * ce)
    z = torch.mean(torch.square(torch.logsumexp(r.logits, dim=-1)))
    return out, MoEAux(lb, z)
