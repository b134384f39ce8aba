"""Deterministic synthetic data: the port of ``repro.data.synthetic``.

* ``ClassificationData`` — Gaussian class-mean images [B, H, W, C]
  with per-sample noise and optional label noise (the paper's
  CIFAR stand-in); ``augment`` / ``two_view_batch`` make Barlow-Twins
  views (a random shift, a channel scale, additive noise).
* ``lm_batch`` — bigram-chain tokens, ``next = (5·tok + 1 + noise) %
  vocab`` with noise in {0, 1, 2}; labels are the next tokens.

The draws come from explicit ``torch.Generator``s seeded from the
given seeds (the LM stream's on the CPU, then moved; the image data's
on its device), so they are reproducible but are not the JAX PRNG's
samples: tests feed both packages the same numpy batch instead.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import torch

from repro_torch import device as _device


@dataclasses.dataclass(frozen=True)
class ClassificationData:
    num_classes: int = 10
    image_size: int = 16
    channels: int = 3
    mean_scale: float = 1.0
    noise_scale: float = 1.5
    label_noise: float = 0.0
    seed: int = 0

    def class_means(self, device="cuda") -> torch.Tensor:
        """[num_classes, H, W, C] from a generator seeded ``seed``."""
        dev = _device.resolve(device)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        return self.mean_scale * torch.randn(
            (self.num_classes, self.image_size, self.image_size,
             self.channels), generator=gen, device=dev)

    def batch(self, gen: torch.Generator, batch_size: int,
              means: Optional[torch.Tensor] = None) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
        """(images [B,H,W,C] f32, labels [B] int64) on the generator's
        device; ``means`` saves recomputing :meth:`class_means`."""
        dev = gen.device
        if means is None:
            means = self.class_means(dev)
        labels = torch.randint(0, self.num_classes, (batch_size,),
                               generator=gen, device=dev)
        picked = means[labels]
        images = picked + self.noise_scale * torch.randn(
            picked.shape, generator=gen, device=dev)
        if self.label_noise > 0:
            flip = torch.rand((batch_size,), generator=gen,
                              device=dev) < self.label_noise
            rand_labels = torch.randint(0, self.num_classes, (batch_size,),
                                        generator=gen, device=dev)
            labels = torch.where(flip, rand_labels, labels)
        return images, labels

    def eval_set(self, n: int = 2048, device="cuda"):
        """A held-out batch from a generator seeded ``seed + 10000``."""
        dev = _device.resolve(device)
        gen = torch.Generator(device=dev).manual_seed(self.seed + 10_000)
        return self.batch(gen, n)


def _roll_index(n: int, shift: torch.Tensor) -> torch.Tensor:
    """Indices i -> (i - shift) mod n: ``x[idx]`` is ``torch.roll(x,
    shift)`` with the shift a device tensor (nothing read back)."""
    return torch.remainder(torch.arange(n, device=shift.device) - shift, n)


def augment(gen: torch.Generator, images: torch.Tensor, *, shift: int = 2,
            noise: float = 0.3) -> torch.Tensor:
    """Cheap augmentation of [B,H,W,C] images: one random shift of the
    batch along H and W, a per-sample channel scale and noise."""
    dev = images.device
    b, h, w, c = images.shape
    dx = torch.randint(-shift, shift + 1, (2,), generator=gen, device=dev)
    images = images[:, _roll_index(h, dx[0])][:, :, _roll_index(w, dx[1])]
    scale = 1.0 + 0.2 * torch.randn((b, 1, 1, c), generator=gen,
                                    device=dev)
    return images * scale + noise * torch.randn(
        images.shape, generator=gen, device=dev)


def two_view_batch(data: ClassificationData, gen: torch.Generator,
                   batch_size: int, means: Optional[torch.Tensor] = None):
    """Barlow-Twins input: (view1, view2) of the same samples."""
    images, _ = data.batch(gen, batch_size, means)
    return augment(gen, images), augment(gen, images)


def batch_iterator(data: ClassificationData, batch_size: int,
                   seed: int = 0, *, accum_steps: int = 1,
                   device="cuda") -> Iterator[tuple]:
    """Infinite (images, labels) stream on ``device`` from a generator
    seeded ``seed``; ``batch_size`` is the GLOBAL batch per step,
    stacked ``[K, B/K, ...]`` when ``accum_steps`` K > 1."""
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    means = data.class_means(dev)
    while True:
        yield stack_microbatches(data.batch(gen, batch_size, means),
                                 accum_steps)


def two_view_iterator(data: ClassificationData, batch_size: int,
                      seed: int = 0, *, accum_steps: int = 1,
                      device="cuda") -> Iterator[tuple]:
    """Infinite (view1, view2) SSL stream from a generator seeded
    ``seed + 1``; global ``batch_size`` per step, stacked for
    accumulation as :func:`batch_iterator`."""
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    means = data.class_means(dev)
    while True:
        yield stack_microbatches(two_view_batch(data, gen, batch_size,
                                                means), accum_steps)


def lm_batch(gen: torch.Generator, batch_size: int, seq_len: int,
             vocab: int, *, device="cuda") -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(tokens, labels), each [B, S] int64 on ``device``; the chain is
    drawn from ``gen`` (a CPU generator) and then moved there."""
    dev = _device.resolve(device)
    first = torch.randint(0, vocab, (batch_size, 1), generator=gen)
    noise = torch.randint(0, 3, (batch_size, seq_len), generator=gen)
    toks = torch.empty((batch_size, seq_len), dtype=torch.int64)
    tok = first[:, 0]
    for j in range(seq_len):
        tok = (5 * tok + 1 + noise[:, j]) % vocab
        toks[:, j] = tok
    tokens = torch.cat([first, toks], dim=1)[:, :seq_len]
    labels = torch.cat([toks, first], dim=1)[:, :seq_len]
    return tokens.to(dev), labels.to(dev)


def stack_microbatches(batch, accum_steps: int):
    """``[B, ...]`` leaves of a dict or tuple batch -> ``[K, B/K,
    ...]`` (microbatch k holds samples k·B/K .. (k+1)·B/K − 1); K = 1
    returns the batch as it is."""
    if accum_steps == 1:
        return batch

    def stack(x):
        if x.shape[0] % accum_steps:
            raise ValueError(f"batch {x.shape[0]} is not divisible by "
                             f"accum_steps {accum_steps}")
        return x.reshape((accum_steps, x.shape[0] // accum_steps)
                         + tuple(x.shape[1:]))

    if isinstance(batch, dict):
        return {k: stack(x) for k, x in batch.items()}
    return tuple(stack(x) for x in batch)


def lm_iterator(batch_size: int, seq_len: int, vocab: int, seed: int = 0,
                *, accum_steps: int = 1,
                device="cuda") -> Iterator[dict]:
    """Infinite ``{"tokens", "labels"}`` stream on ``device``:
    ``batch_size`` is the GLOBAL batch per step, stacked ``[K, B/K, S]``
    when ``accum_steps`` K > 1. The chain is drawn on the CPU, so the
    tokens do not depend on the device."""
    dev = _device.resolve(device)
    gen = torch.Generator().manual_seed(seed)
    while True:
        tokens, labels = lm_batch(gen, batch_size, seq_len, vocab,
                                  device=dev)
        yield stack_microbatches({"tokens": tokens, "labels": labels},
                                 accum_steps)
