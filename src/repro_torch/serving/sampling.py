"""Token sampling for the serving engine: greedy / temperature / top-k.

``SamplingParams`` is the static half (it rides inside ``ServeConfig``);
randomness comes from an explicit ``torch.Generator`` seeded from
``SamplingParams.seed``. Greedy decoding is exact and equals the
reference's; sampled tokens come from torch's generator, so their bits
differ from the reference's ``jax.random`` draws by design.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature == 0.0 -> greedy argmax (top_k ignored);
    temperature > 0 -> categorical over logits/temperature, optionally
    restricted to the ``top_k`` highest-logit tokens (0 = no cap)."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")


def make_sampler(params: SamplingParams) -> Callable:
    """``(logits [N, V], generator) -> tokens [N] int32``."""
    if params.temperature == 0.0:
        def greedy(logits: torch.Tensor,
                   gen: Optional[torch.Generator] = None) -> torch.Tensor:
            del gen
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return greedy

    temp = params.temperature
    top_k = params.top_k

    def sample(logits: torch.Tensor,
               gen: Optional[torch.Generator] = None) -> torch.Tensor:
        lg = logits.float() / temp
        if top_k and top_k < lg.shape[-1]:
            kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
            lg = torch.where(lg < kth, float("-inf"), lg)
        probs = torch.softmax(lg, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0] \
            .to(torch.int32)

    return sample
