"""Model registry: family -> (init, apply, init_cache, decode_step,
prefill), one functional surface so the server never branches on the
architecture:

    model = get_model(cfg)
    params = model.init(seed, device="cuda")
    params = model.init(seed, device="cuda", mesh=mesh)  # this rank's
                                                         # blocks
    params = model.init(seed, device="cuda", mesh=mesh,  # training's:
                        fsdp=True)                       # also over data
    logits = model.apply(params, tokens, extra)          # [B,S,V]
    cache = model.init_cache(params, batch, max_len, extra)
    logits, cache = model.decode_step(params, cache, tokens, pos)
    logits, cache = model.prefill(params, tokens, max_len, lens,
                                  logits_at, extra)
    ce, aux = model.loss(params, batch)   # fused chunked CE head
    segments = model.segments(params)     # the reference's leaves

Families: dense (including gemma3's local:global pattern), moe and vlm
through ``models.transformer``, ssm (mamba2) and hybrid (zamba2)
through ``models.hybrid``, encdec (whisper) through ``models.encdec``.
``extra`` is the stubbed modality frontend's output, image embeddings
for vlm and audio frames for encdec, of ``extra_embed_shape(cfg, B)``;
``loss`` reads it from ``batch["extra_embeds"]``. The other families
take no ``extra``. ``prefill`` is ``None`` for ssm, hybrid and encdec,
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
from repro_torch.models import encdec as E
from repro_torch.models import hybrid as H
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.training import losses


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable          # (seed=0, *, device="cuda", mesh=None,
                            #  fsdp=False) -> params; on a mesh, this
                            #  rank's blocks of the whole draw (fsdp:
                            #  the training placement, split over the
                            #  data axis too)
    apply: Callable         # (params, tokens, extra=None) -> logits
    init_cache: Callable    # (params, batch, max_len, extra=None) -> cache
    decode_step: Callable   # (params, cache, tokens, pos) -> (logits, cache)
    prefill: Optional[Callable]
                            # (params, tokens, max_len, lens=None,
                            #  logits_at=None, extra=None) -> (logits,
                            #  cache); None: no batched prefill (ssm,
                            #  hybrid, encdec)
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
    "vlm": (T.init_lm, T.apply_lm, T.apply_lm_hidden, T.init_lm_cache,
            T.decode_lm, T.apply_lm_prefill),
    "encdec": (E.init_encdec, E.apply_encdec, E.apply_encdec_hidden,
               E.init_encdec_cache, E.decode_encdec, None),
}

NEEDS_EXTRA = ("vlm", "encdec")


def extra_embed_shape(cfg: ModelConfig, batch: int) -> Optional[tuple]:
    """The shape of ``batch`` rows of the stubbed frontend's output:
    image embeddings for vlm, audio frames for encdec; None for the
    text-only families."""
    if cfg.family == "vlm":
        return (batch, cfg.num_image_tokens, cfg.d_model)
    if cfg.family == "encdec":
        return (batch, cfg.encoder_seq, cfg.d_model)
    return None


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    init_fn, apply_fn, hidden_fn, cache_fn, decode_fn, prefill_fn = \
        FAMILIES[cfg.family]
    needs_extra = cfg.family in NEEDS_EXTRA

    def with_extra(extra) -> tuple:
        """``extra`` as a trailing argument where the family takes one."""
        if not needs_extra:
            if extra is not None:
                raise ValueError(f"family {cfg.family!r} takes no extra "
                                 f"embeddings")
            return ()
        return (extra,)

    def init(seed: int = 0, *, device="cuda", mesh=None,
             fsdp: bool = False) -> dict:
        dev = _device.resolve(device)
        # a meta init draws nothing: its leaves are empty tensors of
        # their shapes (the dry run's), from a CPU generator
        gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
        gen.manual_seed(seed)
        if mesh is None or (mesh.shape["model"] == 1 and not fsdp):
            return init_fn(cfg, gen, dev)
        return convert.init_sharded(cfg, init_fn, gen, dev, mesh,
                                    fsdp=fsdp)

    def apply(params, tokens, extra=None):
        return apply_fn(cfg, params, tokens, *with_extra(extra))

    def init_cache(params, batch_size: int, max_len: int, extra=None):
        return cache_fn(cfg, params, batch_size, max_len,
                        *with_extra(extra))

    def decode_step(params, cache, tokens, pos):
        return decode_fn(cfg, params, cache, tokens, pos)

    prefill = None
    if prefill_fn is not None:
        def prefill(params, tokens, max_len, lens=None, logits_at=None,
                    extra=None):
            return prefill_fn(cfg, params, tokens, max_len, lens,
                              logits_at, *with_extra(extra))

    def loss(params, batch: dict):
        extra = batch.get("extra_embeds") if needs_extra else None
        h, aux = hidden_fn(cfg, params, batch["tokens"],
                           *with_extra(extra))
        emb = params["embed"]
        w = emb["table"].T if cfg.tie_embeddings else emb["head"]
        ce = losses.fused_ce_from_hidden(h, w.to(h.dtype), batch["labels"],
                                         mesh=L.declared_mesh(),
                                         vocab=cfg.vocab_size)
        return ce, aux

    def segments(params):
        return convert.segment_paths(cfg, params)

    return Model(cfg, init, apply, init_cache, decode_step, prefill, loss,
                 segments)
