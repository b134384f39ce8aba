"""Flat parameter substrate of the fused optimizer path: the port of
``repro.core.flatten``.

Every segment of a parameter tree is flattened, zero-padded to whole
128-lane rows and placed at a static row offset of ONE ``(num_rows,
LANES)`` buffer, so a whole optimizer step is two segmented kernel
launches whatever the number of tensors (``kernels.segmented_update``).
The layout is the reference's row for row: the same segment order,
the same adapt flags, segments padded to whole rows and ``num_rows``
padded to a multiple of ``max_block_rows(dtype)`` (or to the sublane
tile below one block). Segment ids, adapt masks, buffers and the
stochastic-rounding element index therefore equal the JAX package's.

**Segments are the JAX package's leaves.** The JAX LM tree stacks each
layer kind on a group axis (``groups/l{i}_{kind}/...`` of shape
``[G, ...]``), so its optimizer sees one segment per layer kind and
leaf, with one trust ratio across all G layers, and the 1-D norm
scales of a layer become 2-D stacked leaves tagged ADAPT. The port
keeps a per-layer list instead; :class:`Segment` maps a segment to its
member tensors in group order, and a segmenter (``tree -> [Segment]``)
says how a tree groups. Plain trees use :func:`tree_segments` (each
leaf its own segment, in flatten order); LM trees use the model's
``segments`` (``models.convert.segment_paths``), and
:func:`tree_segments` refuses them rather than silently packing 36x
more segments with other ratios.

A segment's flat range is the concatenation of its members' ravels in
group order: exactly the ravel of the reference's stacked leaf.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from repro_torch.core import labels as labels_lib
from repro_torch.core.base import (PyTree, path_name, tree_flatten_with_path,
                                   tree_from_paths, tree_get)

LANES = 128
BLOCK_BYTES = 512 * LANES * 4      # per-operand tile budget: 256 KiB
_MIN_SUBLANES = {4: 8, 2: 16, 1: 32}


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def max_block_rows(dtype: torch.dtype) -> int:
    """``BLOCK_BYTES`` worth of rows: 512 for f32, 1024 for bf16 (the
    reference's tile height, kept because it sets ``num_rows``)."""
    return BLOCK_BYTES // (LANES * _itemsize(dtype))


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


class Segment(NamedTuple):
    """One packed segment: its reference leaf name, the tree paths of
    its members in pack order, and whether the members are stacked on
    a leading group axis."""
    name: str
    paths: tuple
    stacked: bool


Segmenter = Callable[[PyTree], Sequence[Segment]]


def tree_segments(params: PyTree) -> list[Segment]:
    """Each leaf one segment, in flatten order (sorted dict keys, then
    sequence index). Refuses an LM tree (a ``"layers"`` list)."""
    if isinstance(params, dict) and isinstance(params.get("layers"), list):
        raise ValueError(
            "an LM parameter tree (a 'layers' list) packs by the JAX "
            "package's stacked group leaves; pass segments=model.segments")
    return [Segment(path_name(p), (p,), False)
            for p, _ in tree_flatten_with_path(params)]


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static segment metadata for one packed tree. Per segment:
    ``names``, member ``paths``, ``shapes`` (stacked: ``(G,) +
    member shape``), ``sizes``, ``member_sizes``, ``row_offset``,
    ``seg_rows`` and ``adapt``; ``dtype`` is the storage dtype."""
    names: tuple
    paths: tuple
    shapes: tuple
    sizes: tuple
    member_sizes: tuple
    row_offset: tuple
    seg_rows: tuple
    adapt: tuple
    num_rows: int
    block_rows: int
    num_segments: int
    nseg_pad: int
    dtype: torch.dtype = torch.float32

    def segment_ids(self, device=None) -> torch.Tensor:
        """(num_rows,) int32 row -> segment id; tail padding rows take
        the last segment's id (they are all zero)."""
        return _segment_ids(self, str(torch.device(device or "cpu")))

    def adapt_mask(self, device=None) -> torch.Tensor:
        """(num_segments,) bool: which segments take the trust ratio."""
        return _adapt_mask(self, str(torch.device(device or "cpu")))


@functools.lru_cache(maxsize=64)
def _segment_ids(spec: FlatSpec, device: str) -> torch.Tensor:
    ids = torch.full((spec.num_rows,), max(spec.num_segments - 1, 0),
                     dtype=torch.int32)
    for s, (off, rows) in enumerate(zip(spec.row_offset, spec.seg_rows)):
        ids[off:off + rows] = s
    return ids.to(device)


@functools.lru_cache(maxsize=64)
def _adapt_mask(spec: FlatSpec, device: str) -> torch.Tensor:
    return torch.tensor(spec.adapt, dtype=torch.bool, device=device)


@functools.lru_cache(maxsize=64)
def _build_spec_cached(names: tuple, paths: tuple, shapes: tuple,
                       member_sizes: tuple, labels: tuple,
                       dtype: torch.dtype) -> FlatSpec:
    sizes = tuple(math.prod(s) for s in shapes)
    seg_rows = tuple(max(1, _ceil_to(n, LANES) // LANES) for n in sizes)
    offsets, acc = [], 0
    for r in seg_rows:
        offsets.append(acc)
        acc += r
    mbr = max_block_rows(dtype)
    block_rows = mbr if acc >= mbr \
        else _ceil_to(acc, _MIN_SUBLANES.get(_itemsize(dtype), 8))
    nseg = len(shapes)
    return FlatSpec(
        names=names, paths=paths, shapes=shapes, sizes=sizes,
        member_sizes=member_sizes, row_offset=tuple(offsets),
        seg_rows=seg_rows,
        adapt=tuple(t == labels_lib.ADAPT for t in labels),
        num_rows=_ceil_to(acc, block_rows), block_rows=block_rows,
        num_segments=nseg, nseg_pad=_ceil_to(max(nseg, 1), LANES),
        dtype=dtype)


def build_spec(params: PyTree, dtype: torch.dtype = torch.float32,
               segments: Optional[Segmenter] = None) -> FlatSpec:
    """Packing metadata for ``params`` at storage ``dtype`` (cached on
    the tree's structure). ``segments`` groups the tree (default
    :func:`tree_segments`); a segment is ADAPT when its (stacked)
    shape has two or more dimensions."""
    segs = (segments or tree_segments)(params)
    names, paths, shapes, msizes, labels = [], [], [], [], []
    for seg in segs:
        mshapes = {tuple(tree_get(params, p).shape) for p in seg.paths}
        if len(mshapes) != 1:
            raise ValueError(f"segment {seg.name!r}: members have "
                             f"different shapes {sorted(mshapes)}")
        mshape = mshapes.pop()
        shape = (len(seg.paths),) + mshape if seg.stacked else mshape
        if not seg.stacked and len(seg.paths) != 1:
            raise ValueError(f"segment {seg.name!r}: several members "
                             f"but not stacked")
        names.append(seg.name)
        paths.append(tuple(seg.paths))
        shapes.append(shape)
        msizes.append(math.prod(mshape))
        labels.append(labels_lib.label_for_ndim(len(shape)))
    return _build_spec_cached(tuple(names), tuple(paths), tuple(shapes),
                              tuple(msizes), tuple(labels), dtype)


def _member_ranges(spec: FlatSpec):
    """(path, start, size) of every member, in pack order."""
    for paths, off, msize in zip(spec.paths, spec.row_offset,
                                 spec.member_sizes):
        for g, path in enumerate(paths):
            yield path, off * LANES + g * msize, msize


def pack(tree: PyTree, spec: FlatSpec,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Copy ``tree`` (shaped like the spec's params) into a
    ``(num_rows, LANES)`` buffer at the spec's dtype. ``out`` is
    written in place: only segment ranges are touched, so padding a
    fresh (zeroed) buffer held stays zero."""
    if out is None:
        first = tree_get(tree, spec.paths[0][0])
        out = torch.zeros((spec.num_rows, LANES), dtype=spec.dtype,
                          device=first.device)
    elif out.shape != (spec.num_rows, LANES) or out.dtype != spec.dtype:
        raise ValueError(f"pack: out is {tuple(out.shape)} {out.dtype}, "
                         f"spec wants ({spec.num_rows}, {LANES}) "
                         f"{spec.dtype}")
    flat = out.view(-1)
    for path, start, size in _member_ranges(spec):
        flat[start:start + size].copy_(tree_get(tree, path).reshape(-1))
    return out


def unpack(flat2d: torch.Tensor, spec: FlatSpec,
           template: PyTree) -> PyTree:
    """A tree shaped like ``template`` of views into ``flat2d`` (its
    own dtype: f32 deltas stay f32)."""
    flat = flat2d.view(-1)
    views = {}
    for path, start, size in _member_ranges(spec):
        shape = tree_get(template, path).shape
        views[path] = flat[start:start + size].view(shape)
    return tree_from_paths(template, views)
