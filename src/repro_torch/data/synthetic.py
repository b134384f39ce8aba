"""Deterministic synthetic LM data: the port of ``lm_batch`` /
``lm_iterator`` from ``repro.data.synthetic``.

Tokens follow a bigram chain, ``next = (5·tok + 1 + noise) % vocab``
with noise in {0, 1, 2}; labels are the next tokens. The draws come
from an explicit ``torch.Generator`` (on the CPU, then moved), so they
are reproducible but are not the JAX PRNG's tokens: tests feed both
packages the same numpy batch instead.
"""
from __future__ import annotations

from typing import Iterator

import torch


def lm_batch(gen: torch.Generator, batch_size: int, seq_len: int,
             vocab: int, *, device="cpu") -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(tokens, labels), each [B, S] int64 on ``device``."""
    first = torch.randint(0, vocab, (batch_size, 1), generator=gen)
    noise = torch.randint(0, 3, (batch_size, seq_len), generator=gen)
    toks = torch.empty((batch_size, seq_len), dtype=torch.int64)
    tok = first[:, 0]
    for j in range(seq_len):
        tok = (5 * tok + 1 + noise[:, j]) % vocab
        toks[:, j] = tok
    tokens = torch.cat([first, toks], dim=1)[:, :seq_len]
    labels = torch.cat([toks, first], dim=1)[:, :seq_len]
    return tokens.to(device), labels.to(device)


def stack_microbatches(batch: dict, accum_steps: int) -> dict:
    """``[B, ...]`` leaves -> ``[K, B/K, ...]`` (microbatch k holds
    samples k·B/K .. (k+1)·B/K − 1)."""
    out = {}
    for k, x in batch.items():
        if x.shape[0] % accum_steps:
            raise ValueError(f"batch {x.shape[0]} is not divisible by "
                             f"accum_steps {accum_steps}")
        out[k] = x.reshape((accum_steps, x.shape[0] // accum_steps)
                           + tuple(x.shape[1:]))
    return out


def lm_iterator(batch_size: int, seq_len: int, vocab: int, seed: int = 0,
                *, accum_steps: int = 1, device="cpu") -> Iterator[dict]:
    """Infinite ``{"tokens", "labels"}`` stream: ``batch_size`` is the
    GLOBAL batch per step, stacked ``[K, B/K, S]`` when
    ``accum_steps`` K > 1."""
    gen = torch.Generator().manual_seed(seed)
    while True:
        tokens, labels = lm_batch(gen, batch_size, seq_len, vocab,
                                  device=device)
        batch = {"tokens": tokens, "labels": labels}
        yield batch if accum_steps == 1 \
            else stack_microbatches(batch, accum_steps)
