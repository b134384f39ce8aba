"""Per-tensor LARS step: the Hopper kernels' wrappers (the
``use_kernel="per_tensor"`` path of the layer-wise optimizers).

One optimizer step is one PASS over every kernel segment of the step,
two launches whatever the number of segments and member tensors:

  norm   ``lars_norm2_cuda``  — a ``[2, S]`` f32 table on the card,
                              column s ``[Σw², Σg²]`` over segment s's
                              members (w and g read at their storage
                              dtype);
  apply  ``lars_apply_cuda``  — per segment, the trust ratio and
                              ``scale = base_lr·ratio`` from its column
                              of a sums table, then ``scaled =
                              scale·(g + wd·w)``, ``m' = μ·m + scaled``
                              written IN PLACE into the f32 momentum,
                              and the f32 delta ``−(scaled + μ·m')``
                              (nesterov) or ``−m'`` into one buffer of
                              the pass.

A segment is one leaf of the JAX package's tree: a single tensor, or on
an LM tree the per-layer members of one stacked group leaf (all of one
shape), which share one trust ratio. A pass is a list of segments,
``(ws, gs)`` for the norm and ``(ws, gs, ms)`` for the apply; each
segment has one w and one g dtype, and segments may differ in them
(mamba2-1.3b keeps some leaves in f32). The
kernels are ``csrc/lars_update.cu`` (ported from ``_norm2_kernel`` and
``_apply_kernel`` of ``repro/kernels/lars_update.py``); the plain
version is ``kernels.ref.lars_norm2_pass`` / ``lars_apply_pass``.
``kernels.ops.lars_norm2`` / ``lars_apply`` pick between them by the
tensors' device and count launches.

Host work per pass: one check of every member that also reads its
pointers, one walk that writes the pass's table (a record per segment
and per member, see the source's note) and one copy of it to the card
from pinned memory, its tickets and counters zeroed, in front of the
launch on the same stream. Nothing is kept between calls, so a pass
over new tensors (a step's fresh gradients) costs what a pass over the
same ones does. The apply makes its deltas' views (a few calls a
segment) after its launch, so that work overlaps the kernel. The apply
reads the sums and ``base_lr`` from device memory, so a step reads
nothing back to the host.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import operator
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 8192             # kTile of csrc/lars_update.cu
DELTA_ALIGN = 4         # f32 elements: each delta starts 16-byte aligned
FLAG_BITS = 3           # kFlagBits: a member's dtype and alignment bits
_DTYPE, _DEVICE = operator.attrgetter("dtype"), operator.attrgetter("device")
_NUMEL, _CONTIG, _PTR = (torch.Tensor.numel, torch.Tensor.is_contiguous,
                         torch.Tensor.data_ptr)
_GET_DEVICE = torch.Tensor.get_device


def pass_tiles(segments) -> int:
    """Tiles of a pass's work list: ``ceil(n / TILE)`` per member."""
    return sum(len(seg[0]) * -(-seg[0][0].numel() // TILE)
               for seg in segments)


# ---------------------------------------------------------------------------
# Hopper kernels
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = _build.load("lars_update")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.repro_lars_tile.argtypes = []
    lib.repro_lars_tile.restype = ll
    lib.repro_lars_norm2.argtypes = [p, i, ll, p, p, p, p, p]
    lib.repro_lars_norm2.restype = i
    lib.repro_lars_apply.argtypes = [i, p, i, ll, p, ll, p, f, f, f, f, p,
                                     p, p, p]
    lib.repro_lars_apply.restype = i
    if lib.repro_lars_tile() != TILE:
        raise RuntimeError("lars_update.cu and lars_update.py disagree on "
                           "the tile size")
    return lib


def _check_pass(segments, with_m: bool) -> tuple:
    """Raise on anything the kernels do not take (before building);
    returns the pass's device and its members' pointers, a list a
    component (w, g[, m]) in the pass's order. Each segment has one w
    dtype and one g dtype (float32 or bfloat16, not f32 w with bf16 g);
    segments may differ in them. One device for the whole pass. Each
    component's dtypes, devices, sizes, layouts and pointers are read a
    list of the whole pass at a time (``map``): a few calls a segment
    and five C-level reads a tensor, no Python work a member."""
    want = 3 if with_m else 2
    if not segments or not segments[0] or not segments[0][0]:
        raise ValueError("an empty pass: give at least one segment")
    dev = segments[0][0][0].device
    counts, ns, dts = [], [], []
    for j, seg in enumerate(segments):
        if len(seg) != want:
            raise ValueError(f"segment {j}: need (ws, gs"
                             f"{', ms' if with_m else ''}), got {len(seg)} "
                             f"lists")
        ws, gs = seg[0], seg[1]
        if not ws or any(len(xs) != len(ws) for xs in seg[1:]):
            raise ValueError(f"segment {j}: need as many w, g"
                             f"{', m' if with_m else ''} members, got "
                             f"{[len(xs) for xs in seg]}")
        n = ws[0].numel()
        if n < 1:
            raise ValueError(f"segment {j}: empty members")
        wdt, gdt = ws[0].dtype, gs[0].dtype
        if wdt not in _DTYPE_CODES or gdt not in _DTYPE_CODES:
            raise ValueError(f"segment {j}: w, g dtypes {wdt}, {gdt}: the "
                             f"kernels take float32 and bfloat16")
        if wdt == torch.float32 and gdt == torch.bfloat16:
            raise ValueError(f"segment {j}: f32 weights with bf16 "
                             f"gradients: no path makes them, and the "
                             f"kernels do not take them")
        counts.append(len(ws))
        ns.append(n)
        dts.append((wdt, gdt, torch.float32))

    def per_member(values):
        return list(itertools.chain.from_iterable(
            map(itertools.repeat, values, counts)))

    total = sum(counts)
    want_n = per_member(ns)
    # a CUDA pass compares device indices (-1 off CUDA): cheaper reads
    where, on_dev = (_GET_DEVICE, [dev.index] * total) \
        if dev.type == "cuda" else (_DEVICE, [dev] * total)
    ptrs = []
    for c in range(want):
        xs = list(itertools.chain.from_iterable(seg[c] for seg in segments))
        for got, expect, why in (
                (list(map(_DTYPE, xs)), per_member(d[c] for d in dts),
                 "a segment's w members share one dtype, its g members "
                 "one, its momentum is f32"),
                (list(map(where, xs)), on_dev,
                 f"the pass is on {dev}: members on more than one device"),
                (list(map(_NUMEL, xs)), want_n,
                 "members must be contiguous, of one size a segment"),
                (all(map(_CONTIG, xs)), True,
                 "members must be contiguous, of one size a segment")):
            if got != expect:
                if got is False:
                    got = list(map(_CONTIG, xs))
                    expect = [True] * total
                i = next(i for i, (a, b) in enumerate(zip(got, expect))
                         if a != b)
                starts = list(itertools.accumulate(counts, initial=0))
                j = next(j for j in range(len(counts)) if starts[j + 1] > i)
                raise ValueError(
                    f"segment {j}: {'wgm'[c]} member {i - starts[j]} of "
                    f"{xs[i].dtype}, {tuple(xs[i].shape)} on "
                    f"{xs[i].device} ({ns[j]} elements each): {why}")
        ptrs.append(list(map(_PTR, xs)))
    if dev.type != "cuda" or dev.index != torch.cuda.current_device():
        raise ValueError(f"members must lie on the current CUDA device, "
                         f"got {dev}")
    return dev, ptrs


def _table(segments, ptrs, columns) -> tuple:
    """The pass's records (int64, the source's ``Seg`` then ``Member``
    layout, then zeroed uint32 tickets and the two counters), its tile
    count, each member's delta offset (apply, ``ptrs`` with an m list;
    else empty) and the delta buffer's length. Segment records in
    Python, member records a column at a time from ``ptrs``."""
    seg_rows, bits, steps, counts = [], [], [], []
    tile = member = 0
    for seg, col in zip(segments, columns):
        ws = seg[0]
        n, count = ws[0].numel(), len(ws)
        tiles = -(-n // TILE)
        seg_rows += (tile, n, tiles, member, count, col, 0, 0)
        bits.append(_DTYPE_CODES[ws[0].dtype] << 2
                    | _DTYPE_CODES[seg[1][0].dtype] << 1)
        steps.append(-(-n // DELTA_ALIGN) * DELTA_ALIGN)
        counts.append(count)
        tile += tiles * count
        member += count
    mem = np.zeros((member, 4), dtype=np.int64)
    for c, col in enumerate(ptrs):
        mem[:, c] = col
    mem[:, 3] = np.repeat(bits, counts) | (
        (mem[:, 0] | mem[:, 1] | mem[:, 2]) % 16 == 0)
    offsets, total = [], 0
    if len(ptrs) == 3:
        per = np.repeat(steps, counts)
        starts = np.cumsum(per) - per
        mem[:, 3] |= starts << FLAG_BITS
        offsets, total = starts.tolist(), int(per.sum())
    rec = np.concatenate([np.array(seg_rows, dtype=np.int64), mem.ravel(),
                          np.zeros(-(-len(segments) // 2) + 2,
                                   dtype=np.int64)])
    return rec, tile, offsets, total


def _to_card(rec: np.ndarray, nseg: int, dev) -> tuple:
    """The table on the card, copied from pinned memory on the current
    stream in front of the launch (PyTorch's pinned-memory cache keeps
    the host block until the copy is done), and the device addresses of
    its tickets and counters."""
    host = torch.from_numpy(rec.view(np.uint8)).pin_memory()
    table = torch.empty(host.numel(), dtype=torch.uint8, device=dev)
    table.copy_(host, non_blocking=True)
    counters = table.data_ptr() + 8 * (len(rec) - 2)
    return table, counters - 8 * (-(-nseg // 2)), counters


def _delta_views(flat: torch.Tensor, segments, offsets) -> list:
    """Each member's delta as a view of the pass's buffer ``flat``, a
    segment at a time: its members lie ``ceil(n / DELTA_ALIGN) *
    DELTA_ALIGN`` elements apart from ``offsets`` of its first, so one
    strided view of the segment and one ``unbind`` (a single member:
    one view), no call per member."""
    deltas, k = [], 0
    for ws, _, _ in segments:
        shape, count = ws[0].shape, len(ws)
        strides, acc = [], 1             # a contiguous member's strides
        for d in reversed(shape):
            strides.insert(0, acc)
            acc *= d
        if count == 1:
            deltas.append([flat.as_strided(shape, strides, offsets[k])])
        else:
            step = -(-ws[0].numel() // DELTA_ALIGN) * DELTA_ALIGN
            deltas.append(list(flat.as_strided(
                (count, *shape), (step, *strides), offsets[k]).unbind(0)))
        k += count
    return deltas


def lars_norm2_cuda(segments) -> torch.Tensor:
    """The norm pass (ONE launch) on PyTorch's current stream over the
    segments ``[(ws, gs), ...]``: a ``[2, S]`` f32 table on the card,
    column s ``[Σw², Σg²]`` of segment s."""
    dev, ptrs = _check_pass(segments, with_m=False)
    lib = _lib()
    rec, ntiles, _, _ = _table(segments, ptrs, range(len(segments)))
    table, tickets, counters = _to_card(rec, len(segments), dev)
    partial = torch.empty(2 * ntiles, dtype=torch.float32, device=dev)
    out = torch.empty((2, len(segments)), dtype=torch.float32, device=dev)
    rc = lib.repro_lars_norm2(table.data_ptr(), len(segments), ntiles,
                              tickets, partial.data_ptr(), out.data_ptr(),
                              counters,
                              torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"per-tensor norm kernel launch failed: CUDA "
                           f"error {rc}")
    return out


def lars_apply_cuda(segments, sums: torch.Tensor, *, base_lr, eta: float,
                    weight_decay: float, momentum_mu: float,
                    eps: float = 1e-9, nesterov: bool = False,
                    stats: bool = False,
                    columns: Optional[Sequence[int]] = None):
    """The apply pass (ONE launch) on PyTorch's current stream over the
    segments ``[(ws, gs, ms), ...]``: segment s reads column
    ``columns[s]`` (default s) of the ``[2, N]`` f32 table ``sums``; the
    f32 momentum members are updated IN PLACE and the f32 deltas written
    to views of one new buffer. Returns ``(deltas, stats)``: the deltas
    per segment, per member; ``stats`` a ``[3, S]`` table (w_norm,
    g_norm, ratio) on the card when asked for, else None. Bitwise equal
    to ``ref.lars_apply_pass`` given the same sums."""
    dev, ptrs = _check_pass(segments, with_m=True)
    cols = list(range(len(segments)) if columns is None else columns)
    if sums.dim() != 2 or sums.shape[0] != 2 or sums.dtype != torch.float32 \
            or sums.device != dev or sums.stride(1) != 1:
        raise ValueError(f"sums must be a [2, N] float32 table on {dev} with "
                         f"contiguous rows, got {tuple(sums.shape)} "
                         f"{sums.dtype} on {sums.device}")
    if len(cols) != len(segments) or not all(
            0 <= c < sums.shape[1] for c in cols):
        raise ValueError(f"columns {cols}: one column of the {sums.shape[1]}"
                         f" of sums per segment")
    lib = _lib()
    rec, ntiles, offsets, total = _table(segments, ptrs, cols)
    table, _, counters = _to_card(rec, len(segments), dev)
    flat = torch.empty(total, dtype=torch.float32, device=dev)
    lr = torch.as_tensor(base_lr).to(device=dev, dtype=torch.float32) \
        .reshape(())
    out_stats = torch.empty((3, len(segments)), dtype=torch.float32,
                            device=dev) if stats else None
    rc = lib.repro_lars_apply(
        int(bool(nesterov)), table.data_ptr(), len(segments), ntiles,
        sums.data_ptr(),
        sums.stride(0), lr.data_ptr(), eta, weight_decay, eps, momentum_mu,
        flat.data_ptr(), out_stats.data_ptr() if stats else None,
        counters, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"per-tensor apply kernel launch failed: CUDA "
                           f"error {rc}")
    # the views after the launch: their host work overlaps the kernel
    return _delta_views(flat, segments, offsets), out_stats
