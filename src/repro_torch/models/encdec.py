"""Whisper-style encoder–decoder (whisper-large-v3, arXiv:2212.04356).

The port of ``repro.models.encdec``. The mel-spectrogram + conv
frontend is a stub: ``extra_embeds`` carries precomputed frame
embeddings [B, encoder_seq, d_model]. The transformer backbone is real:

  encoder: L_enc × (bidirectional self-attention + MLP), LayerNorm, GELU
  decoder: L_dec × (causal self-attention + cross-attention to the
           encoder's output + MLP)

Both stacks use RoPE (the reference's adaptation; the encoder over
positions 0..S_enc-1). Params: ``{"embed", "encoder": [layer dicts],
"enc_norm", "decoder": [layer dicts], "final_norm"}``, an encoder
layer being ``transformer.init_layer``'s and a decoder layer ``{"norm1",
"self_attn", "norm_x", "cross_attn", "norm2", "mlp"}``.

The decode cache is a list with one dict per decoder layer: ``{"k",
"v"}`` [B, T, Hkv, Dh] at the compute dtype, which decode appends into
in place (the decode kernel on CUDA), and ``{"ck", "cv"}`` [B, S_enc,
Hkv, Dh], the encoder output's K/V, computed once by
:func:`init_encdec_cache` and only read. On a mesh with a model axis the
encoder's and decoder's heads and d_ff are split as the LM's are, and
each cache leaf is the rank's block (``layers.cache_block``: its KV
heads, else block r of T, else of the head dim: whisper-large-v3 at
model 8 keeps its 20 heads whole, its self caches over T where 8
divides their length, its 1500-frame cross K/V over the head dim).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _init_dec_layer(cfg: ModelConfig, gen, device) -> dict:
    return {"norm1": L.init_norm(cfg, cfg.d_model, device),
            "self_attn": L.init_attention(cfg, gen, device),
            "norm_x": L.init_norm(cfg, cfg.d_model, device),
            "cross_attn": L.init_attention(cfg, gen, device),
            "norm2": L.init_norm(cfg, cfg.d_model, device),
            "mlp": L.init_mlp(cfg, gen, device)}


def init_encdec(cfg: ModelConfig, gen: torch.Generator,
                device: torch.device) -> dict:
    """Random weights drawn from ``gen`` on ``device``, initialised as
    the LM's (normal(0.02), LayerNorm scale 1 and bias 0)."""
    return {"embed": L.init_embedding(cfg, gen, device),
            "encoder": [T.init_layer(cfg, gen, device)
                        for _ in range(cfg.encoder_layers)],
            "enc_norm": L.init_norm(cfg, cfg.d_model, device),
            "decoder": [_init_dec_layer(cfg, gen, device)
                        for _ in range(cfg.num_layers)],
            "final_norm": L.init_norm(cfg, cfg.d_model, device)}


def _frames(extra: Optional[torch.Tensor]) -> torch.Tensor:
    if extra is None:
        raise ValueError("encdec needs frame embeddings: pass extra "
                         "[B, encoder_seq, d_model]")
    return extra


def _enc_layer(p: dict, i: int, cfg: ModelConfig, h: torch.Tensor,
               positions: torch.Tensor, seq=None) -> torch.Tensor:
    """Encoder layer ``i`` on its leaves gathered over the data column
    when a training placement splits them (``layers.gathered``)."""
    return T.layer_apply(L.gathered(p, ("encoder", i)), cfg, h, positions,
                         None, seq=seq)[0]


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames [B, S_enc, D] (the stub frontend's output) -> the encoder
    states after ``enc_norm``, in the compute dtype: bidirectional
    self-attention with RoPE over positions 0..S_enc-1. Under a
    training placement each layer's fsdp leaves are gathered inside its
    checkpoint, and ``enc_norm``'s before the norm. Under sequence
    parallelism (``layers.seq_mesh`` of S_enc; whisper's 1500 frames
    run unsplit where M does not divide them) the layers run on the
    rank's block of the frames and the states are gathered whole at
    the end: the decoder's cross layers read every frame."""
    b, s, _ = frames.shape
    seq = L.seq_mesh(s)
    h = L.seq_rows(frames, seq).to(cfg.cdtype)
    positions = torch.arange(s, device=h.device)[None].expand(b, s)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, p in enumerate(params["encoder"]):
        if remat:
            h = checkpoint(_enc_layer, p, i, cfg, h, positions, seq,
                           use_reentrant=False)
        else:
            h = _enc_layer(p, i, cfg, h, positions, seq)
    return L.seq_whole(L.norm(cfg, L.gathered(params["enc_norm"],
                                              ("enc_norm",)), h, seq), seq)


def _dec_layer_apply(p: dict, cfg: ModelConfig, h: torch.Tensor,
                     positions: torch.Tensor, enc: torch.Tensor, seq=None
                     ) -> torch.Tensor:
    h = h + L.attention(p["self_attn"], cfg,
                        L.norm(cfg, p["norm1"], h, seq), positions,
                        ("causal", None), seq=seq)
    h = h + L.attention(p["cross_attn"], cfg,
                        L.norm(cfg, p["norm_x"], h, seq), positions, None,
                        kv_src=enc, use_rope=False, seq=seq)
    return h + L.mlp(p["mlp"], cfg, L.norm(cfg, p["norm2"], h, seq), seq)


def _dec_layer(p: dict, i: int, cfg: ModelConfig, h: torch.Tensor,
               positions: torch.Tensor, enc: torch.Tensor, seq=None
               ) -> torch.Tensor:
    """Decoder layer ``i`` on its gathered leaves (as :func:`_enc_layer`):
    the cross-attention's K/V from ``enc`` through the same
    column-parallel path as its self-attention's."""
    return _dec_layer_apply(L.gathered(p, ("decoder", i)), cfg, h,
                            positions, enc, seq)


def apply_encdec_hidden(cfg: ModelConfig, params: dict,
                        tokens: torch.Tensor,
                        extra: Optional[torch.Tensor] = None):
    """tokens [B, S_dec], extra [B, S_enc, D] -> (h after the final
    norm [B, S_dec, D], zero aux). With ``cfg.remat`` and gradients
    enabled every encoder and decoder layer is checkpointed; under a
    training placement (``layers.training``) each gathers its fsdp
    leaves inside its checkpoint, and ``embed`` / ``final_norm`` are
    gathered where they are used. Under sequence parallelism each stack
    whose length the model axis divides runs on the rank's block of its
    sequence (``layers.seq_mesh``)."""
    enc = encode(cfg, params, _frames(extra))
    seq = L.seq_mesh(tokens.shape[1])
    h = L.embed(L.gathered(params["embed"], ("embed",)), cfg, tokens, seq)
    positions = T._positions(tokens)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, p in enumerate(params["decoder"]):
        if remat:
            h = checkpoint(_dec_layer, p, i, cfg, h, positions, enc, seq,
                           use_reentrant=False)
        else:
            h = _dec_layer(p, i, cfg, h, positions, enc, seq)
    final = L.gathered(params["final_norm"], ("final_norm",))
    return L.seq_whole(L.norm(cfg, final, h, seq), seq), \
        T.zero_aux(h.device)


def apply_encdec(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                 extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward: logits [B, S_dec, V]."""
    h, _ = apply_encdec_hidden(cfg, params, tokens, extra)
    return L.unembed(params["embed"], cfg, h)


def init_encdec_cache(cfg: ModelConfig, params: dict, batch: int,
                      max_len: int, extra: Optional[torch.Tensor] = None
                      ) -> list:
    """Runs the encoder once over ``extra`` [batch, S_enc, D] and
    precomputes every decoder layer's cross K/V; zeroed self-attention
    caches at the compute dtype, as the reference's (each the rank's
    block on the declared mesh)."""
    enc = encode(cfg, params, _frames(extra))
    cache = []
    for p in params["decoder"]:
        m = L.model_split(cfg, p)
        ck, cv = T.cross_kv_from_embeds({"attn": p["cross_attn"]}, cfg,
                                        enc)
        shape = (batch,) + L.cache_block(cfg, max_len, m)
        cache.append({
            "k": torch.zeros(shape, dtype=cfg.cdtype, device=enc.device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=enc.device),
            "ck": L.cache_slice(cfg, ck, m),
            "cv": L.cache_slice(cfg, cv, m)})
    return cache


def decode_encdec(cfg: ModelConfig, params: dict, cache: list,
                  tokens: torch.Tensor, pos) -> tuple[torch.Tensor, list]:
    """One-token decoder step: self-attention through
    ``layers.attention_decode`` (the Hopper kernel on CUDA, appending
    to the cache in place), cross-attention in plain PyTorch. Returns
    (logits [B,1,V], cache)."""
    h = L.embed(params["embed"], cfg, tokens)
    for p, c in zip(params["decoder"], cache):
        m = L.model_split(cfg, p)
        h = h + L.attention_decode(p["self_attn"], cfg,
                                   L.norm(cfg, p["norm1"], h), c["k"],
                                   c["v"], pos, split=m)
        h = h + L.cross_attention_decode(p["cross_attn"],
                                         L.norm(cfg, p["norm_x"], h),
                                         c["ck"], c["cv"], cfg, m)
        h = h + L.mlp(p["mlp"], cfg, L.norm(cfg, p["norm2"], h))
    h = L.norm(cfg, params["final_norm"], h)
    return L.unembed(params["embed"], cfg, h), cache
