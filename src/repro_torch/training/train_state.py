"""TrainState: the port of ``repro.training.train_state``.

``params`` is the model's tree (updated in place by the trainer);
``opt_state`` the optimizer's (under ``use_kernel="fused"``, flat
``(rows, 128)`` buffers at the precision policy's storage dtype);
``step`` counts optimizer steps on the host.

The data-parallel train step (``trainer.make_train_step(mesh=...)``)
needs the whole state equal on every rank of the mesh: :func:`replicate`
copies rank 0's params and optimizer state (the fused flat substrate
included) to every rank, byte for byte. Over a mesh with a model axis
it copies over each data column only (a tensor-parallel state whose
column ranks hold the same blocks).

The GSPMD step (``make_train_step(mesh=, placement=)``) runs on a state
:meth:`TrainState.create` made from a rank's blocks
(``Model.init(seed, mesh=, fsdp=True)``), which needs no copy: every
rank drew its blocks from the same whole draw. :func:`replicas_equal`
checks afterwards that the ranks holding the same block of a leaf hold
the same bits.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.base import (GradientTransform, path_name,
                                   tree_flatten_with_path, tree_leaves)


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


def block_trees(state: TrainState, segments=None) -> list:
    """The trees shaped like the params that hold ``state``'s blocks:
    the params and every optimizer buffer (a fused flat buffer viewed
    leaf by leaf through its flat spec: ``segments`` as the optimizer
    was built with)."""
    from repro_torch.core import flatten
    trees = [state.params]
    for buf in list(state.opt_state)[1:]:
        if isinstance(buf, torch.Tensor) and buf.dim() == 2 \
                and buf.shape[1] == flatten.LANES:
            spec = flatten.build_spec(state.params, dtype=buf.dtype,
                                      segments=segments)
            buf = flatten.unpack(buf, spec, state.params)
        trees.append(buf)
    return trees


def replicas_equal(state: TrainState, place, *, segments=None) -> bool:
    """Whether, for every leaf of the params and the optimizer state,
    the ranks of ``place``'s mesh that hold the same block of it (the
    same coordinates on the axes that split it) hold the same bits: the
    replicated leaves equal over the model row (norm scales, biases),
    the data-replicated ones (the embedding table, the head) over the
    data column. One ``all_gather_object`` of per-block fingerprints
    over the mesh's ranks."""
    mesh = place.mesh
    mine = []
    for t, tree in enumerate(block_trees(state, segments)):
        for path, leaf in tree_flatten_with_path(tree):
            axes = place.spec(path).axes()
            key = tuple(mesh.coords[a] for a in ("data", "model")
                        if a in axes)
            mine.append((t, path_name(path), key))
    prints = fingerprint([leaf for tree in block_trees(state, segments)
                          for leaf in tree_leaves(tree)])
    entries = [(k, tuple(prints[2 * i:2 * i + 2]))
               for i, k in enumerate(mine)]
    if mesh.world == 1:
        return True
    seen: dict = {}
    for rank_entries in mesh.all_gather_object(entries):
        for key, value in rank_entries:
            if seen.setdefault(key, value) != value:
                return False
    return True


def fingerprint(tree: Any) -> list:
    """Two exact integers per tensor leaf (the sum of its bit patterns,
    and of each pattern times its index modulo 8191 plus 1), computed on
    the leaf's device in chunks of ``2**24`` elements with one
    read-back: equal trees give equal lists, so ranks compare states
    bitwise without copying them."""
    sums = []
    home = None
    for x in tree_leaves(tree):
        if not isinstance(x, torch.Tensor):
            continue
        home = x.device if home is None else home
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
        sums.append(torch.stack([plain, weighted]).to(home))
    return torch.stack(sums).reshape(-1).tolist() if sums else []


_CHUNK = 1 << 24
_INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}
