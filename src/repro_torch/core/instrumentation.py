"""LWN / LGN / LNR telemetry (the paper's Fig. 2): the port of
``global_norm`` and ``layer_norms`` from ``repro.core.instrumentation``.

``layer_norms`` is per segment, in the reference's leaf order (pass
``segments=model.segments`` for an LM tree), so its rows line up with
the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import flatten
from repro_torch.core.base import (PyTree, global_norm, sum_of_squares,
                                   tree_get)

__all__ = ["LayerNorms", "global_norm", "layer_norms"]


class LayerNorms(NamedTuple):
    lwn: torch.Tensor  # [num_segments]
    lgn: torch.Tensor
    lnr: torch.Tensor


def layer_norms(params: PyTree, grads: PyTree, eps: float = 1e-12, *,
                segments: Optional[flatten.Segmenter] = None
                ) -> LayerNorms:
    """Per-segment LWN/LGN/LNR (f32 accumulation)."""
    segs = (segments or flatten.tree_segments)(params)

    def norm(tree, seg):
        return torch.sqrt(sum(sum_of_squares(tree_get(tree, p))
                              for p in seg.paths))

    with torch.no_grad():
        lwn = torch.stack([norm(params, s) for s in segs])
        lgn = torch.stack([norm(grads, s) for s in segs])
    return LayerNorms(lwn=lwn, lgn=lgn, lnr=lwn / (lgn + eps))
