"""LWN / LGN / LNR telemetry (the paper's Fig. 2): the port of
``repro.core.instrumentation``.

``layer_norms`` is per segment, in the reference's leaf order (pass
``segments=model.segments`` for an LM tree), so its rows line up with
the JAX package's. ``NormRecorder`` keeps their history on the host
and summarises it as the paper reports it.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import flatten, labels as labels_lib
from repro_torch.core.base import (PyTree, global_norm, sum_of_squares,
                                   tree_get)

__all__ = ["LayerNorms", "NormRecorder", "global_norm", "layer_norms"]


class LayerNorms(NamedTuple):
    lwn: torch.Tensor  # [num_segments]
    lgn: torch.Tensor
    lnr: torch.Tensor


def layer_norms(params: PyTree, grads: PyTree, eps: float = 1e-12, *,
                segments: Optional[flatten.Segmenter] = None,
                placement=None) -> LayerNorms:
    """Per-segment LWN/LGN/LNR (f32 accumulation). ``placement``: the
    trees are this rank's blocks, and each segment's Σw², Σg² are
    summed over the mesh with each distinct block counted once (one
    collective) before the square roots."""
    segs = (segments or flatten.tree_segments)(params)

    def sq(tree, seg):
        return sum(sum_of_squares(tree_get(tree, p)) for p in seg.paths)

    with torch.no_grad():
        sums = torch.stack([torch.stack([sq(params, s) for s in segs]),
                            torch.stack([sq(grads, s) for s in segs])])
        if placement is not None:
            counted = torch.tensor([placement.counts_once(s.paths[0])
                                    for s in segs], dtype=torch.bool)
            placement.mesh.sum_blocks_(sums, counted, name="layer_norms")
        lwn, lgn = torch.sqrt(sums[0]), torch.sqrt(sums[1])
    return LayerNorms(lwn=lwn, lgn=lgn, lnr=lwn / (lgn + eps))


class NormRecorder:
    """Host-side history of layer norms across steps (Fig. 2)."""

    def __init__(self, params: PyTree):
        self.names = labels_lib.leaf_names(params)
        self.steps: list[int] = []
        self.history: list[LayerNorms] = []

    def record(self, step: int, norms: LayerNorms) -> None:
        """Keep one step's norms as numpy arrays (one read-back)."""
        host = torch.stack(list(norms)).detach().float().cpu().numpy()
        self.steps.append(int(step))
        self.history.append(LayerNorms(*host))

    def as_arrays(self) -> dict[str, np.ndarray]:
        """``{lwn, lgn, lnr}``: [steps, leaves] float arrays."""
        if not self.history:
            return {k: np.zeros((0, len(self.names)))
                    for k in ("lwn", "lgn", "lnr")}
        return {k: np.stack([getattr(h, k) for h in self.history])
                for k in ("lwn", "lgn", "lnr")}

    @staticmethod
    def summary_window(n: int) -> int:
        """Head/tail window of :meth:`summary`: ``max(1, n // 5)``, the
        same at both ends and disjoint for n >= 2."""
        return max(1, n // 5)

    def summary(self) -> dict[str, Any]:
        """The aggregates the paper reports: max initial LNR, LNR
        decline, over symmetric head/tail windows of the mean-LNR
        trace."""
        arr = self.as_arrays()
        if arr["lnr"].shape[0] == 0:
            return {}
        mean_lnr = arr["lnr"].mean(axis=1)
        n = len(mean_lnr)
        win = self.summary_window(n)
        head = mean_lnr[:win]
        tail = mean_lnr[n - win:]
        return {
            "window": win,
            "max_initial_lnr": float(head.max()),
            "mean_initial_lnr": float(head.mean()),
            "mean_final_lnr": float(tail.mean()),
            "lnr_decline": float(head.mean() - tail.mean()),
            "mean_final_lwn": float(arr["lwn"].mean(axis=1)[-1]),
            "lnr_variance": float(mean_lnr.var()),
        }
