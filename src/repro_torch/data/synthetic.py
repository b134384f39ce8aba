"""Deterministic synthetic data: the port of ``repro.data.synthetic``.

* ``ClassificationData`` — Gaussian class-mean images [B, H, W, C]
  with per-sample noise and optional label noise (the paper's
  CIFAR stand-in); ``augment`` / ``two_view_batch`` make Barlow-Twins
  views (a random shift, a channel scale, additive noise).
* ``lm_batch`` — bigram-chain tokens, ``next = (5·tok + 1 + noise) %
  vocab`` with noise in {0, 1, 2}; labels are the next tokens.
* ``classification_sample_source`` / ``lm_sample_source`` /
  ``lm_varlen_sample_source`` — sample-level sources ``(start, count)
  -> batch`` for the streams of ``repro_torch.data.pipeline``: sample
  ``i`` comes from its own CPU generator seeded from ``(seed, i)``.

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
from repro_torch.data.pipeline import stack_microbatches


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


def _bigram_chain(first: torch.Tensor, noise: torch.Tensor,
                  vocab: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(tokens, labels) [B, S] of the chain from ``first`` [B, 1] and
    ``noise`` [B, S] in {0, 1, 2}."""
    batch_size, seq_len = noise.shape
    toks = torch.empty((batch_size, seq_len), dtype=torch.int64)
    tok = first[:, 0]
    for j in range(seq_len):
        tok = (5 * tok + 1 + noise[:, j]) % vocab
        toks[:, j] = tok
    tokens = torch.cat([first, toks], dim=1)[:, :seq_len]
    labels = torch.cat([toks, first], dim=1)[:, :seq_len]
    return tokens, labels


def _to_device(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``x`` on ``dev``; to the card through a contiguous pinned block
    without blocking, so drawing a batch does not wait for the card's
    queue (the pinned block is kept until the copy has run). ``x`` may
    be a strided view: pinning it as it is would leave the copy to
    stage a contiguous pageable temporary."""
    if dev.type != "cuda":
        return x.to(dev)
    pinned = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return pinned.copy_(x).to(dev, non_blocking=True)


def lm_batch(gen: torch.Generator, batch_size: int, seq_len: int,
             vocab: int, *, device="cuda") -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(tokens, labels), each [B, S] int64 on ``device``; the chain is
    drawn from ``gen`` (a CPU generator) and then moved there."""
    dev = _device.resolve(device)
    first = torch.randint(0, vocab, (batch_size, 1), generator=gen)
    noise = torch.randint(0, 3, (batch_size, seq_len), generator=gen)
    tokens, labels = _bigram_chain(first, noise, vocab)
    return _to_device(tokens, dev), _to_device(labels, dev)


_MASK64 = (1 << 64) - 1


def _sample_seed(seed: int, index: int) -> int:
    """The 64-bit seed of sample ``index`` of a stream seeded ``seed``:
    splitmix64 of the pair, so neighbouring indices and seeds give
    unrelated generators."""
    z = (seed * 0x9E3779B97F4A7C15 + index + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _sample_generators(seed: int, start: int, count: int):
    """One CPU generator per absolute sample index in ``[start, start +
    count)``: sample ``i`` depends only on ``(seed, i)``, never on how
    the stream was batched around it (the reference's
    ``fold_in(seed, i)``)."""
    if start < 0 or count < 0:
        raise ValueError(f"need start >= 0 and count >= 0, got {start}, "
                         f"{count}")
    return [torch.Generator().manual_seed(_sample_seed(seed, i))
            for i in range(start, start + count)]


def classification_sample_source(data: ClassificationData, seed: int = 0,
                                 *, device="cuda"):
    """Sample-level source ``(start, count) -> (images, labels)`` for
    :class:`repro_torch.data.pipeline.MicrobatchedStream`.

    Each sample's label, noise and label flip are drawn on the CPU from
    its own generator (:func:`_sample_seed`), so any contiguous
    ``[start, start + count)`` request returns the same samples however
    the stream around it was partitioned; the batch moves to ``device``
    once and takes the class means of that device
    (:meth:`ClassificationData.class_means`), as the eval set does."""
    dev = _device.resolve(device)
    means = data.class_means(dev)
    shape = (data.image_size, data.image_size, data.channels)

    def source(start: int, count: int):
        labels, noise = [], []
        for gen in _sample_generators(seed, start, count):
            label = torch.randint(0, data.num_classes, (1,), generator=gen)
            noise.append(torch.randn(shape, generator=gen))
            if data.label_noise > 0:
                flip = torch.rand((1,), generator=gen) < data.label_noise
                other = torch.randint(0, data.num_classes, (1,),
                                      generator=gen)
                label = torch.where(flip, other, label)
            labels.append(label)
        labels = torch.cat(labels).to(dev)
        noise = torch.stack(noise).to(dev)
        return means[labels] + data.noise_scale * noise, labels

    return source


def _chain_samples(seed: int, start: int, count: int, seq_len: int,
                   vocab: int, min_seq: Optional[int] = None):
    """The per-sample bigram chains (and, with ``min_seq``, lengths in
    ``[min_seq, seq_len]``) of ``[start, start + count)``, on the CPU."""
    firsts, noises, lengths = [], [], []
    for gen in _sample_generators(seed, start, count):
        firsts.append(torch.randint(0, vocab, (1, 1), generator=gen))
        noises.append(torch.randint(0, 3, (1, seq_len), generator=gen))
        if min_seq is not None:
            lengths.append(torch.randint(min_seq, seq_len + 1, (1,),
                                         generator=gen))
    tokens, labels = _bigram_chain(torch.cat(firsts), torch.cat(noises),
                                   vocab)
    return tokens, labels, (torch.cat(lengths) if lengths else None)


def lm_sample_source(seq_len: int, vocab: int, seed: int = 0, *,
                     device="cuda"):
    """Sample-level LM source ``(start, count) -> {"tokens", "labels"}``
    with the per-absolute-index determinism of
    :func:`classification_sample_source`; drawn on the CPU, moved to
    ``device`` once."""
    dev = _device.resolve(device)

    def source(start: int, count: int):
        tokens, labels, _ = _chain_samples(seed, start, count, seq_len,
                                           vocab)
        return {"tokens": tokens.to(dev), "labels": labels.to(dev)}

    return source


def lm_varlen_sample_source(max_seq: int, vocab: int, seed: int = 0, *,
                            min_seq: int = 1, device="cuda"):
    """Variable-length LM source for length bucketing: ``(start, count)
    -> {"tokens", "labels", "length"}``, every sequence leaf padded to
    ``max_seq`` with zeros past ``length``, and ``length`` uniform in
    ``[min_seq, max_seq]``; tokens and length depend only on the
    sample's absolute index."""
    if not 1 <= min_seq <= max_seq:
        raise ValueError(
            f"need 1 <= min_seq <= max_seq, got {min_seq}, {max_seq}")
    dev = _device.resolve(device)

    def source(start: int, count: int):
        tokens, labels, lengths = _chain_samples(seed, start, count,
                                                 max_seq, vocab, min_seq)
        mask = torch.arange(max_seq)[None, :] < lengths[:, None]
        return {"tokens": torch.where(mask, tokens, 0).to(dev),
                "labels": torch.where(mask, labels, 0).to(dev),
                "length": lengths.to(dev)}

    return source


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
