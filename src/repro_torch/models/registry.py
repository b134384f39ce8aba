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

Only the dense family (including gemma3's local:global pattern) is
ported; other families raise ``NotImplementedError``. ``decode_step``
appends into ``cache`` in place.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable          # (seed=0, *, device="cuda") -> params
    apply: Callable         # (params, tokens) -> logits [B,S,V]
    init_cache: Callable    # (params, batch, max_len) -> cache
    decode_step: Callable   # (params, cache, tokens, pos) -> (logits, cache)
    prefill: Callable       # (params, tokens, max_len, lens=None,
                            #  logits_at=None) -> (logits, cache)


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: not ported yet, see ROADMAP")
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r}: not ported yet")

    def init(seed: int = 0, *, device="cuda") -> dict:
        dev = _device.resolve(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return T.init_lm(cfg, gen, dev)

    def apply(params, tokens):
        return T.apply_lm(cfg, params, tokens)

    def init_cache(params, batch_size: int, max_len: int):
        return T.init_lm_cache(cfg, params, batch_size, max_len)

    def decode_step(params, cache, tokens, pos):
        return T.decode_lm(cfg, params, cache, tokens, pos)

    def prefill(params, tokens, max_len, lens=None, logits_at=None):
        return T.apply_lm_prefill(cfg, params, tokens, max_len, lens,
                                  logits_at)

    return Model(cfg, init, apply, init_cache, decode_step, prefill)
