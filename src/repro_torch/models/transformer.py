"""Decoder-only transformer LM: the dense family and the gemma3
local:global pattern.

The port of ``repro.models.transformer`` without MoE and VLM cross
layers. The reference scans over groups of stacked layers; here the
layers are a Python list of ``G × len(kinds)`` per-layer parameter
dicts, layer ``g * len(kinds) + i`` being kind ``kinds[i]`` of group
``g``. Each layer is pre-norm: h += attn(norm(h)); h += mlp(norm(h)).

The KV cache is a list with one ``{"k", "v"}`` pair of
``[B, T, Hkv, Dh]`` tensors per layer (``T = min(window, max_len)``
for local layers); decode appends into it in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def _group_spec(cfg: ModelConfig) -> tuple[int, list[str]]:
    """Returns (num_groups, [kind per layer-in-group])."""
    if cfg.global_every and cfg.sliding_window:
        n = cfg.global_every
        if cfg.num_layers % n:
            raise ValueError(f"num_layers {cfg.num_layers} is not a "
                             f"multiple of global_every {n}")
        return cfg.num_layers // n, ["local"] * (n - 1) + ["attn"]
    return cfg.num_layers, ["attn"]


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """The kind ("local" | "attn") of every layer, in order."""
    groups, kinds = _group_spec(cfg)
    return kinds * groups


def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    return cfg.sliding_window if kind == "local" else None


def _cache_len(cfg: ModelConfig, kind: str, max_len: int) -> int:
    if kind == "local" and cfg.sliding_window:
        return min(cfg.sliding_window, max_len)
    return max_len


def _masks(cfg: ModelConfig) -> dict:
    return {"attn": ("causal", None),
            "local": ("causal", cfg.sliding_window)
            if cfg.sliding_window else None}


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def init_layer(cfg: ModelConfig, gen, device) -> dict:
    return {"norm1": L.init_rmsnorm(cfg.d_model, cfg.pdtype, device),
            "attn": L.init_attention(cfg, gen, device),
            "norm2": L.init_rmsnorm(cfg.d_model, cfg.pdtype, device),
            "mlp": L.init_mlp(cfg, gen, device)}


def init_lm(cfg: ModelConfig, gen: torch.Generator,
            device: torch.device) -> dict:
    """Random weights drawn from ``gen`` on ``device``: normal(0.02),
    out-projections normal(0.02 / sqrt(2L)), zero norm scales."""
    return {"embed": L.init_embedding(cfg, gen, device),
            "layers": [init_layer(cfg, gen, device)
                       for _ in layer_kinds(cfg)],
            "final_norm": L.init_rmsnorm(cfg.d_model, cfg.pdtype,
                                         device)}


def _device(params: dict) -> torch.device:
    return params["embed"]["table"].device


# --------------------------------------------------------------------------
# full-sequence forward
# --------------------------------------------------------------------------

def layer_apply(p: dict, cfg: ModelConfig, h: torch.Tensor,
                positions: torch.Tensor, mask, return_kv: bool = False):
    out = L.attention(p["attn"], cfg, L.rmsnorm(p["norm1"], h,
                                                cfg.norm_eps),
                      positions, mask, return_kv=return_kv)
    a, kv = out if return_kv else (out, None)
    h = h + a
    h = h + L.mlp(p["mlp"], cfg, L.rmsnorm(p["norm2"], h, cfg.norm_eps))
    return (h, kv) if return_kv else h


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device)[None].expand(b, s)


class LMAux(NamedTuple):
    """MoE auxiliary losses; zero for the dense family (the reference's
    ``zero_aux``)."""
    load_balance_loss: torch.Tensor
    router_z_loss: torch.Tensor


def zero_aux(device) -> LMAux:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return LMAux(z, z)


def apply_lm_hidden(cfg: ModelConfig, params: dict, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, LMAux]:
    """Backbone forward up to the final norm (no unembed): h [B,S,D]
    and the (zero) MoE aux. With ``cfg.remat`` and gradients enabled,
    each layer is checkpointed (its activations recomputed in the
    backward), the counterpart of the reference's ``scan_layers``
    remat; it changes no value."""
    h = L.embed(params["embed"], cfg, tokens)
    positions = _positions(tokens)
    masks = _masks(cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    for p, kind in zip(params["layers"], layer_kinds(cfg)):
        if remat:
            h = checkpoint(layer_apply, p, cfg, h, positions, masks[kind],
                           use_reentrant=False)
        else:
            h = layer_apply(p, cfg, h, positions, masks[kind])
    return L.rmsnorm(params["final_norm"], h, cfg.norm_eps), \
        zero_aux(h.device)


def apply_lm(cfg: ModelConfig, params: dict, tokens: torch.Tensor
             ) -> torch.Tensor:
    """Full-sequence forward. tokens: [B,S] -> logits [B,S,V]."""
    h = L.embed(params["embed"], cfg, tokens)
    positions = _positions(tokens)
    masks = _masks(cfg)
    for p, kind in zip(params["layers"], layer_kinds(cfg)):
        h = layer_apply(p, cfg, h, positions, masks[kind])
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return L.unembed(params["embed"], cfg, h)


# --------------------------------------------------------------------------
# KV cache, prefill, decode
# --------------------------------------------------------------------------

def init_lm_cache(cfg: ModelConfig, params: dict, batch: int,
                  max_len: int) -> list:
    """Zeroed pool at ``cfg.kv_dtype`` on the params' device (decode
    accumulates in f32 whatever the storage dtype)."""
    hkv, hd, dev = cfg.num_kv_heads, cfg.head_dim_, _device(params)
    cache = []
    for kind in layer_kinds(cfg):
        t = _cache_len(cfg, kind, max_len)
        cache.append({
            "k": torch.zeros((batch, t, hkv, hd), dtype=cfg.kv_dtype,
                             device=dev),
            "v": torch.zeros((batch, t, hkv, hd), dtype=cfg.kv_dtype,
                             device=dev)})
    return cache


def _prefill_cache_layout(cfg: ModelConfig, kind: str, k: torch.Tensor,
                          v: torch.Tensor, max_len: int,
                          lens: Optional[torch.Tensor] = None) -> dict:
    """[B,S,...] prefill K/V -> the ``init_lm_cache`` layout at
    ``max_len``: global layers zero-pad the sequence axis to max_len;
    local layers gather each ROW's last ``min(lens[b], window)`` tokens
    into their ring slots (p % T) — what streaming that row's prompt
    through decode leaves behind. ``lens`` [B] gives per-row prompt
    lengths of a right-padded batch (None = every row is the full S)."""
    b, s, hkv, hd = k.shape
    k = k.to(cfg.kv_dtype)
    v = v.to(cfg.kv_dtype)
    if kind == "local" and cfg.sliding_window:
        t = min(cfg.sliding_window, max_len)
        if lens is None:
            last = torch.full((b, 1), s - 1, device=k.device)
        else:
            last = lens.to(device=k.device, dtype=torch.int64)[:, None] - 1
        # ring slot q holds the LARGEST position p <= last with
        # p % t == q (exactly what decode's abs_pos arithmetic assumes)
        q = torch.arange(t, device=k.device)[None, :]            # [1,T]
        p = last - torch.remainder(last - q, t)                   # [B,T]
        valid = (p >= 0)[:, :, None, None]
        idx = p.clamp(0, s - 1)
        rows = torch.arange(b, device=k.device)[:, None]
        zero = torch.zeros((), dtype=k.dtype, device=k.device)
        return {"k": torch.where(valid, k[rows, idx], zero),
                "v": torch.where(valid, v[rows, idx], zero)}
    kc = torch.zeros((b, max_len, hkv, hd), dtype=k.dtype, device=k.device)
    vc = torch.zeros_like(kc)
    kc[:, :s] = k
    vc[:, :s] = v
    return {"k": kc, "v": vc}


def apply_lm_prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                     max_len: int, lens: Optional[torch.Tensor] = None,
                     logits_at: Optional[torch.Tensor] = None):
    """Single-shot batched prefill: ONE full-sequence forward that also
    dumps a decode-ready KV cache. tokens: [B,S]. Returns (logits,
    cache) where ``cache`` matches ``init_lm_cache(..., max_len)`` after
    streaming the prompt through ``decode_lm``. Right-padded prompts are
    safe: pass ``lens`` [B] so local layers ring-pack each row's own
    last ``window`` tokens.

    ``logits_at`` [B] unembeds only one position per row (logits
    [B,1,V]); the serving paths sample one token per row, and at
    gemma3-12b's 262144-word vocabulary the full [B,S,V] logits of a
    long prompt batch are gigabytes. None gives all positions [B,S,V].
    """
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds cache max_len "
                         f"{max_len}")
    h = L.embed(params["embed"], cfg, tokens)
    positions = _positions(tokens)
    masks = _masks(cfg)
    cache = []
    for p, kind in zip(params["layers"], layer_kinds(cfg)):
        h, (k, v) = layer_apply(p, cfg, h, positions, masks[kind],
                                return_kv=True)
        cache.append(_prefill_cache_layout(cfg, kind, k, v, max_len,
                                           lens))
    if logits_at is not None:
        rows = torch.arange(b, device=h.device)
        h = h[rows, logits_at.to(device=h.device,
                                 dtype=torch.int64)][:, None]
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return L.unembed(params["embed"], cfg, h), cache


def layer_decode(p: dict, cfg: ModelConfig, h: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor, pos, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """One-token layer step; appends to the caches in place."""
    x = L.rmsnorm(p["norm1"], h, cfg.norm_eps)
    h = h + L.attention_decode(p["attn"], cfg, x, k_cache, v_cache, pos,
                               window=window)
    return h + L.mlp(p["mlp"], cfg, L.rmsnorm(p["norm2"], h,
                                              cfg.norm_eps))


def decode_lm(cfg: ModelConfig, params: dict, cache: list,
              tokens: torch.Tensor, pos) -> tuple[torch.Tensor, list]:
    """One-token step. tokens: [B,1]; pos: an int (tokens cached so far)
    or a [B] int32 tensor of per-row depths. The cache is updated in
    place and returned. Returns (logits [B,1,V], cache)."""
    h = L.embed(params["embed"], cfg, tokens)
    for p, c, kind in zip(params["layers"], cache, layer_kinds(cfg)):
        h = layer_decode(p, cfg, h, c["k"], c["v"], pos,
                         window=_window(cfg, kind))
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return L.unembed(params["embed"], cfg, h), cache
