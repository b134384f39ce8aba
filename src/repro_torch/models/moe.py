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

Expert parallelism (the model axis, ``launch.sharding``'s rules: the
router's ``[d, E/M]`` and the experts' ``[E/M, ...]`` blocks). Where
the reference's GSPMD scatter is an all-to-all, the port keeps the
tensor-parallel pattern: activations are whole on a model row, so every
rank holds every token of its data block. The rank's router block gives
the logits' block, gathered over the row (``distributed.gather_row``,
f32); routing then runs replicated and gives the decisions, capacity
and slots of M = 1. Dispatch scatters only the entries of the rank's
experts ``[e0, e0 + E/M)`` into a ``[B, (E/M)·C, d]`` buffer (slots
offset by ``e0·C``; the rest add zero at local slot 0, so ``index_add``
stays), the experts run on the rank's blocks, the combine gathers the
local entries (the others weigh 0) and ``sum_over_row`` sums the partial
output; ``x`` enters through ``copy_to_row`` (a column-parallel
input). The gathered logits feed the combine weights, used in part (a
rank combines its own experts' entries), and the aux losses, used
whole and the same on every rank. So the combine weights read the
logits through ``copy_to_row`` (their gradient summed over the row)
and the aux losses read them as they are (counted once), and
``gather_row``'s backward keeps the rank's block of that sum. Where M
does not divide E the rules leave the router and the experts whole:
the layer runs whole on every rank, with no collective.
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


def _experts(local: int, cfg: ModelConfig):
    """(this rank's first expert, its expert count, the mesh whose
    model row splits the experts or None when they are whole) for a
    leaf that holds ``local`` of the experts."""
    if local == cfg.num_experts:
        return 0, local, None
    mesh = L._row_mesh(local, cfg.num_experts, "moe experts")
    return mesh.coords["model"] * local, local, mesh


def route(params: dict, cfg: ModelConfig, x: torch.Tensor) -> Routing:
    """Router logits in f32, softmax, top-k (ties to the lower expert
    index) renormalised by their sum + 1e-9, and each entry's slot: its
    position inside its expert is the number of earlier entries of the
    row (token-major, then k-rank) routed to the same expert. A router
    block [d, E/M] gives the logits' block, gathered over the model row
    (``gather_row``), so every rank of the row routes alike; the
    top-k weights then come from the gathered logits through
    ``copy_to_row``: the rank combines its own experts' entries only,
    so their gradient is summed over the row, while the aux losses read
    the logits whole and count once."""
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = moe_capacity(s, cfg)
    logits = x.float() @ params["router"].float()               # [B,S,E]
    _, _, mesh = _experts(params["router"].shape[1], cfg)
    if mesh is not None:
        from repro_torch.distributed import copy_to_row, gather_row
        logits = gather_row(logits, mesh, logits.dim() - 1)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort breaks ties by the lower expert index,
    # as jax.lax.top_k does (torch.topk does not, on the CPU)
    topk_probs, topk_idx = torch.sort(probs, dim=-1, descending=True,
                                      stable=True)
    topk_probs, topk_idx = topk_probs[..., :k], topk_idx[..., :k]
    if mesh is not None:
        topk_probs = torch.softmax(copy_to_row(logits, mesh), dim=-1) \
            .gather(-1, topk_idx)
    topk_probs = topk_probs / (topk_probs.sum(-1, keepdim=True) + 1e-9)
    expert_of = topk_idx.reshape(b, s * k)
    fa = F.one_hot(expert_of, e)                                # [B,S·k,E]
    pos = (torch.cumsum(fa, dim=1) - fa).gather(
        -1, expert_of[..., None])[..., 0]                       # [B,S·k]
    keep = pos < cap
    slot = expert_of * cap + torch.where(keep, pos, 0)
    return Routing(logits, probs, topk_probs, topk_idx, keep, slot, cap)


def aux_losses(cfg: ModelConfig, r: Routing) -> MoEAux:
    """Load balance and router z over every position of the batch, from
    the whole logits (replicated over the model row, counted once)."""
    e = cfg.num_experts
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
    return MoEAux(lb, z)


def moe_apply(params: dict, cfg: ModelConfig, x: torch.Tensor, seq=None
              ) -> tuple[torch.Tensor, MoEAux]:
    """x: [B, S, d] -> (out [B, S, d], aux losses). Over experts split
    on the model row, the rank dispatches and combines the entries of
    its experts ``[e0, e0 + E/M)`` only and the row sums the partial
    output. ``seq`` (sequence parallelism): ``x`` and ``out`` are the
    rank's block of the sequence; routing, capacity and drops stay the
    whole sequence's (split experts: the sequence gathered at the
    entry, the partial reduce-scattered at the exit; whole experts:
    ``layers.seq_replicated``)."""
    if seq is not None and params["wi"].shape[0] == cfg.num_experts:
        return L.seq_replicated(lambda xs: moe_apply(params, cfg, xs), x,
                                seq)
    k = cfg.experts_per_token
    e0, el, _ = _experts(params["wi"].shape[0], cfg)
    x = L._col_in(x, el, cfg.num_experts, "moe experts", seq)
    b, s, d = x.shape
    r = route(params, cfg, x)
    cap = r.cap

    # dispatch: every row's kept entries of this rank's experts added
    # into its [E/M·C, d] block (the rest add zero at local slot 0)
    mine, slot = r.keep, r.slot
    if el != cfg.num_experts:
        mine = mine & (slot >= e0 * cap) & (slot < (e0 + el) * cap)
        slot = torch.where(mine, slot - e0 * cap, 0)
    src = x.repeat_interleave(k, dim=1)                         # [B,S·k,d]
    src = torch.where(mine[..., None], src,
                      torch.zeros((), dtype=x.dtype, device=x.device))
    rows = torch.arange(b, device=x.device)[:, None] * (el * cap)
    buf = torch.zeros((b * el * cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, (rows + slot).reshape(-1),
                        src.reshape(b * s * k, d))
    # [B, E, C, d] -> [E, B·C, d]: one batched product per expert
    buf = buf.reshape(b, el, cap, d).transpose(0, 1).reshape(
        el, b * cap, d)

    h = torch.bmm(buf, params["wi"].to(buf.dtype))
    g = torch.bmm(buf, params["wg"].to(buf.dtype))
    h = F.silu(g) * h
    out_buf = torch.bmm(h, params["wo"].to(buf.dtype))

    # combine: gather each entry's slot, weighted by its kept probability
    out_buf = out_buf.reshape(el, b, cap, d).transpose(0, 1).reshape(
        b, el * cap, d)
    gathered = out_buf[torch.arange(b, device=x.device)[:, None], slot]
    w = (r.topk_probs.reshape(b, s * k, 1) * mine[..., None]).to(
        gathered.dtype)
    out = (gathered * w).reshape(b, s, k, d).sum(dim=2)
    out = L._row_exit(out, el, cfg.num_experts, "moe wo", seq)
    return out, aux_losses(cfg, r)
