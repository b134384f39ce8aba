"""SSM and hybrid language models: the port of ``repro.models.hybrid``.

* ssm LM (mamba2-1.3b): embed -> L x mamba block -> norm -> unembed.
  Attention-free; decode carries a (state, conv) cache per block.
* hybrid LM (zamba2-1.2b, arXiv:2411.15242): a Mamba2 backbone with ONE
  weight-shared attention+MLP block applied after every
  ``attn_every`` mamba blocks. The weights are shared by the call
  sites (its gradient is their sum); each call site keeps its own
  full-length KV cache.

The reference stacks the blocks (ssm: ``blocks`` [L, ...]; hybrid:
``groups`` [G, attn_every, ...] and ``trailing`` [L % attn_every, ...])
and scans over them. Here ``params["blocks"]`` is a list of the L block
dicts in order (the hybrid's groups first, block ``g * attn_every + i``,
then its trailing blocks), as the transformer keeps ``layers``;
``models.convert`` maps the stacked layouts. Neither family has a
batched prefill (``serving.decode.prefill`` streams the prompt through
decode, as the reference does).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T


def _init_mamba_block(cfg: ModelConfig, gen, device) -> dict:
    return {"norm": L.init_norm(cfg, cfg.d_model, device),
            "mamba": S.init_mamba(cfg, gen, device)}


def _mamba_block(p: dict, cfg: ModelConfig, h: torch.Tensor, seq=None
                 ) -> torch.Tensor:
    return h + S.mamba_apply(p["mamba"], cfg,
                             L.norm(cfg, p["norm"], h, seq), seq)


def _gathered_block(p: dict, i: int, cfg: ModelConfig, h: torch.Tensor,
                    seq=None) -> torch.Tensor:
    """Block ``i`` on its leaves gathered over the data column when a
    training placement splits them (``layers.gathered``; a no-op
    otherwise): inside the block's checkpoint, so the gather is redone
    in the recomputation."""
    return _mamba_block(L.gathered(p, ("blocks", i)), cfg, h, seq)


def _mamba_block_decode(p: dict, cfg: ModelConfig, h: torch.Tensor,
                        cache: S.SSMCache) -> torch.Tensor:
    y, _ = S.mamba_decode(p["mamba"], cfg, L.norm(cfg, p["norm"], h),
                          cache)
    return h + y


def _call(fn, remat: bool, *args):
    """``fn(*args)``, checkpointed (recomputed in the backward) under
    remat; checkpointing changes no value."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _finish(cfg: ModelConfig, params: dict, h: torch.Tensor, seq=None):
    """The final norm (on the rank's rows under sequence parallelism,
    then the whole sequence gathered for the head) and the zero aux."""
    final = L.gathered(params["final_norm"], ("final_norm",))
    return L.seq_whole(L.norm(cfg, final, h, seq), seq), \
        T.zero_aux(h.device)


# --------------------------------------------------------------------------
# pure SSM LM
# --------------------------------------------------------------------------

def init_ssm_lm(cfg: ModelConfig, gen: torch.Generator,
                device: torch.device) -> dict:
    return {"embed": L.init_embedding(cfg, gen, device),
            "blocks": [_init_mamba_block(cfg, gen, device)
                       for _ in range(cfg.num_layers)],
            "final_norm": L.init_norm(cfg, cfg.d_model, device)}


def apply_ssm_lm_hidden(cfg: ModelConfig, params: dict,
                        tokens: torch.Tensor):
    """Backbone up to the final norm and the (zero) aux; with
    ``cfg.remat`` and gradients enabled each block is checkpointed.
    Under a training placement (``layers.training``) each block's fsdp
    leaves are gathered inside its checkpoint, and ``embed`` /
    ``final_norm`` where they are used. Under sequence parallelism
    (``layers.seq_mesh``) the residual is the rank's block of the
    sequence."""
    seq = L.seq_mesh(tokens.shape[1])
    h = L.embed(L.gathered(params["embed"], ("embed",)), cfg, tokens, seq)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, p in enumerate(params["blocks"]):
        h = _call(_gathered_block, remat, p, i, cfg, h, seq)
    return _finish(cfg, params, h, seq)


def apply_ssm_lm(cfg: ModelConfig, params: dict, tokens: torch.Tensor
                 ) -> torch.Tensor:
    h, _ = apply_ssm_lm_hidden(cfg, params, tokens)
    return L.unembed(params["embed"], cfg, h)


def init_ssm_cache(cfg: ModelConfig, params: dict, batch: int,
                   max_len: int) -> dict:
    """One zeroed (state, conv) cache per block, at the rank's block of
    its block's leaves (``ssm.mamba_init_cache``); position-free, so
    ``max_len`` is unused."""
    del max_len
    dev = params["embed"]["table"].device
    return {"ssm": [S.mamba_init_cache(cfg, batch, cfg.cdtype, dev,
                                       p["mamba"])
                    for p in params["blocks"]]}


def decode_ssm_lm(cfg: ModelConfig, params: dict, cache: dict,
                  tokens: torch.Tensor, pos) -> tuple[torch.Tensor, dict]:
    """One-token step; the state carries the history, so ``pos`` is
    unused. The cache is updated in place and returned."""
    del pos
    h = L.embed(params["embed"], cfg, tokens)
    for p, c in zip(params["blocks"], cache["ssm"]):
        h = _mamba_block_decode(p, cfg, h, c)
    h = L.norm(cfg, params["final_norm"], h)
    return L.unembed(params["embed"], cfg, h), cache


# --------------------------------------------------------------------------
# Zamba2 hybrid LM
# --------------------------------------------------------------------------

def hybrid_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(groups, trailing): zamba2-1.2b's 38 blocks are 6 groups of 6
    mamba blocks, each followed by the shared block, then 2 more."""
    n = max(cfg.attn_every, 1)
    return cfg.num_layers // n, cfg.num_layers % n


def _shared_after(cfg: ModelConfig, i: int) -> int:
    """The call site of the shared block that follows block ``i``
    (-1 if none)."""
    groups, _ = hybrid_layout(cfg)
    n = max(cfg.attn_every, 1)
    return i // n if (i + 1) % n == 0 and i < groups * n else -1


def init_hybrid_lm(cfg: ModelConfig, gen: torch.Generator,
                   device: torch.device) -> dict:
    return {"embed": L.init_embedding(cfg, gen, device),
            "blocks": [_init_mamba_block(cfg, gen, device)
                       for _ in range(cfg.num_layers)],
            "shared_attn": T.init_layer(cfg, gen, device),
            "final_norm": L.init_norm(cfg, cfg.d_model, device)}


def apply_hybrid_lm_hidden(cfg: ModelConfig, params: dict,
                           tokens: torch.Tensor):
    """Backbone up to the final norm and the (zero) aux. Under remat
    each mamba block and each call of the shared block is checkpointed
    on its own, as the reference's nested remat is. Under a training
    placement each block gathers its fsdp leaves inside its checkpoint,
    and the shared block is gathered inside each call site's, one
    gather a call: autograd sums its gradient over the call sites.
    Under sequence parallelism the residual is the rank's block of the
    sequence."""
    b, s = tokens.shape
    seq = L.seq_mesh(s)
    h = L.embed(L.gathered(params["embed"], ("embed",)), cfg, tokens, seq)
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    shared = params["shared_attn"]
    remat = cfg.remat and torch.is_grad_enabled()

    def attn(p, h2):
        return T.layer_apply(L.gathered(p, ("shared_attn",)), cfg, h2,
                             positions, ("causal", None), seq=seq)[0]

    for i, p in enumerate(params["blocks"]):
        h = _call(_gathered_block, remat, p, i, cfg, h, seq)
        if _shared_after(cfg, i) >= 0:
            h = _call(attn, remat, shared, h)
    return _finish(cfg, params, h, seq)


def apply_hybrid_lm(cfg: ModelConfig, params: dict, tokens: torch.Tensor
                    ) -> torch.Tensor:
    h, _ = apply_hybrid_lm_hidden(cfg, params, tokens)
    return L.unembed(params["embed"], cfg, h)


def init_hybrid_cache(cfg: ModelConfig, params: dict, batch: int,
                      max_len: int) -> dict:
    """A (state, conv) cache per block and a [B, max_len, Hkv, Dh] K/V
    pair per call site of the shared block, in the compute dtype (as
    the reference's); each the rank's block of its leaves on a mesh."""
    groups, _ = hybrid_layout(cfg)
    shape = (batch,) + L.cache_block(
        cfg, max_len, L.model_split(cfg, params["shared_attn"]))
    dev = params["embed"]["table"].device

    def zeros():
        return torch.zeros(shape, dtype=cfg.cdtype, device=dev)

    return {"ssm": [S.mamba_init_cache(cfg, batch, cfg.cdtype, dev,
                                       p["mamba"])
                    for p in params["blocks"]],
            "kv": [{"k": zeros(), "v": zeros()} for _ in range(groups)]}


def decode_hybrid_lm(cfg: ModelConfig, params: dict, cache: dict,
                     tokens: torch.Tensor, pos) -> tuple[torch.Tensor, dict]:
    """One-token step; every call of the shared block decodes through
    ``transformer.layer_decode`` (the decode-attention kernel on CUDA)
    into its own KV cache. The cache is updated in place and
    returned."""
    h = L.embed(params["embed"], cfg, tokens)
    shared = params["shared_attn"]
    for i, (p, c) in enumerate(zip(params["blocks"], cache["ssm"])):
        h = _mamba_block_decode(p, cfg, h, c)
        site = _shared_after(cfg, i)
        if site >= 0:
            kv = cache["kv"][site]
            h = T.layer_decode(shared, cfg, h, kv, pos)
    h = L.norm(cfg, params["final_norm"], h)
    return L.unembed(params["embed"], cfg, h), cache
