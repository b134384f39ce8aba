"""TrainState: the port of ``repro.training.train_state``.

``params`` is the model's tree (updated in place by the trainer);
``opt_state`` the optimizer's (under ``use_kernel="fused"``, flat
``(rows, 128)`` buffers at the precision policy's storage dtype);
``step`` counts optimizer steps on the host.

The data-parallel train step (``trainer.make_train_step(mesh=...)``)
needs the whole state equal on every rank of the mesh: :func:`replicate`
copies rank 0's params and optimizer state (the fused flat substrate
included) to every rank, byte for byte.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.base import GradientTransform, tree_leaves


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any

    @classmethod
    def create(cls, params, optimizer: GradientTransform) -> "TrainState":
        return cls(step=0, params=params, opt_state=optimizer.init(params))


def replicate(tree: Any, mesh) -> Any:
    """Make every tensor leaf of ``tree`` rank 0's on every rank of
    ``mesh``'s world, in place (``Mesh.broadcast_``), and return
    ``tree``: afterwards every rank's state is bitwise equal. Non-tensor
    leaves (the host step count) are left as they are; every rank
    counts them alike."""
    if mesh is not None:
        mesh.broadcast_([x for x in tree_leaves(tree)
                         if isinstance(x, torch.Tensor)])
    return tree


def fingerprint(tree: Any) -> list:
    """Two exact integers per tensor leaf (the sum of its bit patterns,
    and of each pattern times its index modulo 8191 plus 1), computed on
    the leaf's device in chunks of ``2**24`` elements with one
    read-back: equal trees give equal lists, so ranks compare states
    bitwise without copying them."""
    sums = []
    for x in tree_leaves(tree):
        if not isinstance(x, torch.Tensor):
            continue
        bits = x.detach().reshape(-1)
        if bits.dtype == torch.bool:
            bits = bits.to(torch.int8)
        elif bits.dtype.is_floating_point:
            bits = bits.view(_INT_OF_WIDTH[bits.element_size()])
        plain = torch.zeros((), dtype=torch.int64, device=bits.device)
        weighted = torch.zeros_like(plain)
        for start in range(0, bits.numel(), _CHUNK):
            part = bits[start:start + _CHUNK].to(torch.int64)
            weight = torch.arange(start, start + part.numel(),
                                  device=bits.device) % 8191 + 1
            plain += part.sum()
            weighted += (part * weight).sum()
        sums.append(torch.stack([plain, weighted]))
    return torch.stack(sums).reshape(-1).tolist() if sums else []


_CHUNK = 1 << 24
_INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}
