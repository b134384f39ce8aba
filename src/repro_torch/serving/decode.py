"""Serving: batched prefill + autoregressive decode with KV caches.

``prefill`` is single-shot: ONE full-sequence ``model.prefill`` forward
that emits the last-position logits and the populated KV cache; for a
family without a batched prefill (``model.prefill is None``: ssm,
hybrid, encdec) it streams the prompt through ``prefill_reference``,
as the reference does. ``extra_embeds`` is the vlm's image embeddings
or the encdec's audio frames, one row per prompt. ``prefill_reference`` streams the prompt token by
token through ``decode_step``: the oracle the tests hold the batched
path against.
``generate`` is the per-request host loop; the continuous-batching
scheduler lives in :mod:`repro_torch.serving.engine`.

``mesh=`` (a mesh with a model axis) runs a step on this rank's blocks
of the params (``Model.init(mesh=)`` or ``convert.shard_params``): the
heads, d_ff and vocabulary split as ``launch.sharding`` says, the
row-parallel partials summed and the logits gathered over the model
row (``layers.batch_sharding``), so every rank of a row returns the
same logits and tokens. ``make_serve_step`` and ``prefill`` compute the
batch they are given; ``generate(mesh=)`` splits the prompts' rows over
the data axis (``Mesh.data_block``), each data row generating its own,
and gathers the tokens over the data column.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.models import layers as L
from repro_torch.models.registry import Model
from repro_torch.models.transformer import check_model_axis


def make_serve_step(model: Model, mesh=None) -> Callable:
    """(params, cache, tokens [B,1], pos) -> (next_tokens [B,1], cache);
    on ``mesh``, over this rank's blocks of the params and cache."""

    def serve_step(params, cache, tokens, pos):
        check_model_axis(model.cfg, params, mesh)
        with L.batch_sharding(mesh):
            logits, cache = model.decode_step(params, cache, tokens, pos)
        nxt = torch.argmax(logits[:, -1:], dim=-1)
        return nxt.to(torch.int32), cache

    return serve_step


def prefill_reference(model: Model, params, tokens: torch.Tensor,
                      max_len: int, extra_embeds=None):
    """Token-by-token prefill through decode_step: O(seq_len) steps,
    the parity oracle of the batched ``prefill`` and the prefill of the
    families without one."""
    b, s = tokens.shape
    cache = model.init_cache(params, b, max_len, extra_embeds)
    last = None
    for t in range(s):
        last, cache = model.decode_step(params, cache,
                                        tokens[:, t:t + 1], t)
    return last, cache


def prefill(model: Model, params, tokens: torch.Tensor, max_len: int,
            extra_embeds=None, mesh=None):
    """Batched prefill: (last-position logits [B,1,V], cache); the
    token-by-token loop where the family has no batched prefill. On
    ``mesh``, over this rank's blocks (the logits gathered)."""
    check_model_axis(model.cfg, params, mesh)
    with L.batch_sharding(mesh):
        if model.prefill is None:
            return prefill_reference(model, params, tokens, max_len,
                                     extra_embeds)
        b, s = tokens.shape
        last = torch.full((b,), s - 1, dtype=torch.int64,
                          device=tokens.device)
        return model.prefill(params, tokens, max_len, logits_at=last,
                             extra=extra_embeds)


def generate(model: Model, params, prompt, *, num_tokens: int,
             max_len: Optional[int] = None, extra_embeds=None,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             device="cuda", mesh=None) -> torch.Tensor:
    """Greedy/temperature generation on ``device`` (where ``params``
    must lie). prompt: [B, S] ints -> [B, num_tokens] int32;
    ``extra_embeds`` [B, ...] where the family needs it. On ``mesh``
    this rank generates its data row's block of the rows on its blocks
    of the params and returns every row's tokens; a sampled step draws
    for all B rows, as at D = 1, and keeps its own."""
    dev = _device.resolve(device)
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                             device=dev)
    b, s = prompt.shape
    max_len = max_len or (s + num_tokens)
    rows = slice(0, b) if mesh is None else mesh.data_block(b)
    split = rows != slice(0, b)
    if extra_embeds is not None:
        extra_embeds = extra_embeds.to(dev)[rows]
    logits, cache = prefill(model, params, prompt[rows], max_len,
                            extra_embeds, mesh=mesh)
    out = []
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    with L.batch_sharding(mesh):
        for i in range(num_tokens):
            out.append(tok)
            logits, cache = model.decode_step(params, cache, tok, s + i)
            lg = logits[:, -1]
            if temperature > 0 and generator is not None:
                if split:
                    lg = torch.zeros((b, lg.shape[1]), dtype=lg.dtype,
                                     device=lg.device).index_copy_(
                        0, torch.arange(rows.start, rows.stop,
                                        device=lg.device), lg)
                probs = torch.softmax(lg.float() / temperature, dim=-1)
                tok = torch.multinomial(probs, 1,
                                        generator=generator)[rows]
            else:
                tok = torch.argmax(lg, dim=-1)[:, None]
            tok = tok.to(torch.int32)
    tokens = torch.cat(out, dim=1)
    return mesh.data_gather(tokens, 0) if split else tokens
