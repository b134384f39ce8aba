"""Model registry: family -> (init, apply, init_cache, decode_step,
prefill), one functional surface so the server never branches on the
architecture:

    model = get_model(cfg)
    params = model.init(seed, device="cuda")
    logits = model.apply(params, tokens)                 # [B,S,V]
    cache = model.init_cache(params, batch, max_len)
    logits, cache = model.decode_step(params, cache, tokens, pos)
    logits, cache = model.prefill(params, tokens, max_len, lens,
                                  logits_at)
    ce, aux = model.loss(params, batch)   # fused chunked CE head
    segments = model.segments(params)     # the reference's leaves

Ported families: dense (including gemma3's local:global pattern) and
moe through ``models.transformer``, ssm (mamba2) and hybrid (zamba2)
through ``models.hybrid``; encdec and vlm raise
``NotImplementedError``. ``prefill`` is ``None`` for ssm and hybrid,
which have no batched prefill (``serving.decode.prefill`` streams the
prompt through ``decode_step`` instead, as the reference does).
``decode_step`` updates ``cache`` in place.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import convert
from repro_torch.models import hybrid as H
from repro_torch.models import transformer as T
from repro_torch.training import losses


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable          # (seed=0, *, device="cuda") -> params
    apply: Callable         # (params, tokens) -> logits [B,S,V]
    init_cache: Callable    # (params, batch, max_len) -> cache
    decode_step: Callable   # (params, cache, tokens, pos) -> (logits, cache)
    prefill: Optional[Callable]
                            # (params, tokens, max_len, lens=None,
                            #  logits_at=None) -> (logits, cache);
                            #  None: no batched prefill (ssm, hybrid)
    loss: Callable          # (params, batch) -> (mean CE, aux): the
                            #  chunked CE head, never whole logits
    segments: Callable      # (params) -> [Segment]: the reference's
                            #  stacked leaves, for the optimizer


FAMILIES = {
    # family: (init, apply, hidden, init_cache, decode, batched prefill)
    "dense": (T.init_lm, T.apply_lm, T.apply_lm_hidden, T.init_lm_cache,
              T.decode_lm, T.apply_lm_prefill),
    "moe": (T.init_lm, T.apply_lm, T.apply_lm_hidden, T.init_lm_cache,
            T.decode_lm, T.apply_lm_prefill),
    "ssm": (H.init_ssm_lm, H.apply_ssm_lm, H.apply_ssm_lm_hidden,
            H.init_ssm_cache, H.decode_ssm_lm, None),
    "hybrid": (H.init_hybrid_lm, H.apply_hybrid_lm,
               H.apply_hybrid_lm_hidden, H.init_hybrid_cache,
               H.decode_hybrid_lm, None),
}


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: not ported yet, see ROADMAP")
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r}: not ported yet")
    init_fn, apply_fn, hidden_fn, cache_fn, decode_fn, prefill_fn = \
        FAMILIES[cfg.family]

    def init(seed: int = 0, *, device="cuda") -> dict:
        dev = _device.resolve(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return init_fn(cfg, gen, dev)

    def apply(params, tokens):
        return apply_fn(cfg, params, tokens)

    def init_cache(params, batch_size: int, max_len: int):
        return cache_fn(cfg, params, batch_size, max_len)

    def decode_step(params, cache, tokens, pos):
        return decode_fn(cfg, params, cache, tokens, pos)

    prefill = None
    if prefill_fn is not None:
        def prefill(params, tokens, max_len, lens=None, logits_at=None):
            return prefill_fn(cfg, params, tokens, max_len, lens,
                              logits_at)

    def loss(params, batch: dict):
        h, aux = hidden_fn(cfg, params, batch["tokens"])
        emb = params["embed"]
        w = emb["table"].T if cfg.tie_embeddings else emb["head"]
        ce = losses.fused_ce_from_hidden(h, w.to(h.dtype), batch["labels"])
        return ce, aux

    def segments(params):
        return convert.segment_paths(cfg, params)

    return Model(cfg, init, apply, init_cache, decode_step, prefill, loss,
                 segments)
