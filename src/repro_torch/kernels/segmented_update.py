"""Segmented whole-tree optimizer step on the flat substrate: the Hopper
kernels' wrappers, their plain PyTorch version and the host glue.

One step over the ``(rows, 128)`` buffers of ``core.flatten`` is two
kernel launches whatever the number of tensors:

  pass 1  ``seg_norm_cuda``  — per-segment Σw², Σb² -> (2, nseg) f32
                              (b = g for "lars"/"paper"; the
                              wd-augmented Adam direction for "lamb");
  table   ``ref.trust_ratio`` -> ``ref.scales_from_ratio``: per-segment
          (sg, sw), in plain PyTorch on the buffers' device;
  pass 2  ``seg_apply_cuda`` — each row gathers its (sg, sw) and runs
                              the mode's update; the state buffers are
                              written IN PLACE at their storage dtype
                              (the reference donates them, so this
                              computes the same values) and the delta
                              is f32.

The kernels are ``csrc/segmented_update.cu`` (ported from the four
bodies of ``repro/kernels/segmented_update.py``); the plain version
:func:`segmented_update_ref` is the port of
``repro.kernels.ref.ref_segmented_update``. ``kernels.ops
.segmented_update`` picks between them by the tensors' device and
counts launches. Scalars that change every step (``base_lr``, ``bc1``,
``bc2`` and the stochastic-rounding seed) may be 0-d tensors on the
card: the kernels read them from device memory, so a step reads
nothing back to the host.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

LANES = 128
# rows per chunk of the plain version's elementwise work (bounds its
# temporaries; every op is per element or per row, so the chunking
# changes no value)
PLAIN_CHUNK_ROWS = 1 << 18

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MODE_CODES = {"lars": 0, "paper": 1, "lamb": 2}
KERNELS = {"lars": ("seg_norm_lars", "seg_apply_lars"),
           "paper": ("seg_norm_lars", "seg_apply_lars"),
           "lamb": ("seg_norm_lamb", "seg_apply_lamb")}


def _check_mode(mode: str) -> None:
    if mode not in ref.MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {ref.MODES}")


def _scalar(x, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=dtype).reshape(())


def _n_bufs(mode: str) -> int:
    return 2 if mode == "lamb" else 1


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _chunks(rows: int):
    for r0 in range(0, rows, PLAIN_CHUNK_ROWS):
        yield r0, min(rows, r0 + PLAIN_CHUNK_ROWS)


def _bvec(mode, w32, g32, bufs32, *, weight_decay, b1, b2, eps, bc1, bc2):
    if mode != "lamb":
        return g32
    d, _ = ref.direction(mode, w32, g32, bufs32, b1=b1, b2=b2, bc1=bc1,
                         bc2=bc2, eps=eps)
    return d + weight_decay * w32


def seg_norm_ref(w2d, g2d, bufs, seg_ids, nseg: int, *, mode: str,
                 weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-6, bc1=1.0, bc2=1.0) -> torch.Tensor:
    """Pass 1 in plain PyTorch: (2, nseg) f32 per-segment Σw², Σb²
    (f32 squares and row sums, the rows' sums added in f64)."""
    _check_mode(mode)
    dev = w2d.device
    ids = seg_ids.reshape(-1).to(device=dev, dtype=torch.int64)
    bc1 = _scalar(bc1, torch.float32, dev)
    bc2 = _scalar(bc2, torch.float32, dev)
    row_w2 = torch.empty(w2d.shape[0], dtype=torch.float32, device=dev)
    row_b2 = torch.empty_like(row_w2)
    for r0, r1 in _chunks(w2d.shape[0]):
        w32 = w2d[r0:r1].float()
        bvec = _bvec(mode, w32, g2d[r0:r1].float(),
                     tuple(b[r0:r1].float() for b in bufs),
                     weight_decay=weight_decay, b1=b1, b2=b2, eps=eps,
                     bc1=bc1, bc2=bc2)
        row_w2[r0:r1] = torch.sum(w32 * w32, dim=1)
        row_b2[r0:r1] = torch.sum(bvec * bvec, dim=1)
    # per-segment sums of the f32 row sums, accumulated in f64: a
    # scatter-add of millions of rows into one f32 total (the
    # reference's segment_sum) drifts by ~1e-4 relative, which would
    # make this the less accurate side of the kernel check
    out = torch.zeros((2, nseg), dtype=torch.float64, device=dev)
    out[0].index_add_(0, ids, row_w2.double())
    out[1].index_add_(0, ids, row_b2.double())
    return out.float()


def seg_apply_ref(w2d, g2d, bufs, seg_ids, table, *, mode: str,
                  momentum: float = 0.9, nesterov: bool = False,
                  b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                  bc1=1.0, bc2=1.0, stochastic_round: bool = False,
                  seed=0, rows=None, out_bufs=None, out_delta=None):
    """Pass 2 in plain PyTorch on the rows given (``seg_ids`` holds
    those rows' ids; ``rows`` their global row numbers for the
    stochastic-rounding element index, default ``0..R-1``). Returns
    ``(new_bufs, delta)``: new state at the buffers' dtypes and the f32
    delta, written into ``out_bufs`` / ``out_delta`` when given (which
    may be ``bufs`` themselves)."""
    _check_mode(mode)
    dev = w2d.device
    n_rows = w2d.shape[0]
    ids = seg_ids.reshape(-1).to(device=dev, dtype=torch.int64)
    bc1 = _scalar(bc1, torch.float32, dev)
    bc2 = _scalar(bc2, torch.float32, dev)
    seed = _scalar(seed, torch.int64, dev)
    rows = torch.arange(n_rows, device=dev) if rows is None \
        else rows.to(device=dev, dtype=torch.int64)
    if out_bufs is None:
        out_bufs = tuple(torch.empty_like(b) for b in bufs)
    if out_delta is None:
        out_delta = torch.empty(w2d.shape, dtype=torch.float32, device=dev)
    for r0, r1 in _chunks(n_rows):
        w32 = w2d[r0:r1].float()
        bufs32 = tuple(b[r0:r1].float() for b in bufs)
        d, bufs2 = ref.direction(mode, w32, g2d[r0:r1].float(), bufs32,
                                 b1=b1, b2=b2, bc1=bc1, bc2=bc2, eps=eps)
        sg = table[0][ids[r0:r1]][:, None]
        sw = table[1][ids[r0:r1]][:, None]
        scaled = sg * d + sw * w32
        new_bufs, delta = ref.integrate(mode, w32, bufs2, scaled,
                                        momentum=momentum,
                                        nesterov=nesterov)
        idx = ref.element_index(r1 - r0, w2d.shape[1], rows[r0:r1]) \
            if stochastic_round else None
        for k, (nb, out) in enumerate(zip(new_bufs, out_bufs)):
            bits = ref.buf_bits(idx, seed, k) if stochastic_round else None
            out[r0:r1] = ref.store(nb, out.dtype, bits=bits)
        out_delta[r0:r1] = delta
    return tuple(out_bufs), out_delta


def segmented_update_ref(w2d, g2d, bufs, *, seg_ids, adapt_mask, base_lr,
                         mode: str, eta: float, weight_decay: float,
                         momentum: float, b1: float, b2: float, eps: float,
                         nesterov: bool = False, trust_clip=None,
                         bc1=1.0, bc2=1.0, stochastic_round: bool = False,
                         seed=0, telemetry: bool = False,
                         reduce_norms=None):
    """Whole-tree step in plain PyTorch: the port of
    ``ref.ref_segmented_update``. Returns ``(new_bufs, delta2d)`` (plus
    the ``{"w_norm", "g_norm", "trust_ratio"}`` triple with
    ``telemetry=True``); the inputs are not modified. ``reduce_norms``
    (a rank holding blocks of the segments) maps pass 1's ``(2, nseg)``
    table to the whole segments' before the trust table."""
    nseg = adapt_mask.shape[0]
    adapt = adapt_mask.to(w2d.device)
    norms = seg_norm_ref(w2d, g2d, bufs, seg_ids, nseg, mode=mode,
                         weight_decay=weight_decay, b1=b1, b2=b2, eps=eps,
                         bc1=bc1, bc2=bc2)
    if reduce_norms is not None:
        norms = reduce_norms(norms)
    wn, bn, ratio = ref.trust_ratio(norms[0], norms[1], adapt, mode=mode,
                                    eta=eta, weight_decay=weight_decay,
                                    eps=eps, trust_clip=trust_clip)
    table = ref.scales_from_ratio(ratio, adapt, base_lr, weight_decay)
    new_bufs, delta = seg_apply_ref(
        w2d, g2d, bufs, seg_ids, table, mode=mode, momentum=momentum,
        nesterov=nesterov, b1=b1, b2=b2, eps=eps, bc1=bc1, bc2=bc2,
        stochastic_round=stochastic_round, seed=seed)
    if telemetry:
        return new_bufs, delta, {"w_norm": wn, "g_norm": bn,
                                 "trust_ratio": ratio}
    return new_bufs, delta


# ---------------------------------------------------------------------------
# Hopper kernels
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = _build.load("segmented_update")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.repro_seg_chunk_rows.argtypes = []
    lib.repro_seg_chunk_rows.restype = i
    lib.repro_seg_norm.argtypes = [i, i, p, p, p, p, p, ll, i, p] \
        + [f] * 6 + [p, i, p, p, p]
    lib.repro_seg_norm.restype = i
    lib.repro_seg_apply.argtypes = [i, i, i, i, p, p, p, p, p, p, p, i, ll,
                                    p, p] + [f] * 6 + [p]
    lib.repro_seg_apply.restype = i
    return lib


def _check_operands(w2d, g2d, bufs, seg_ids, mode: str):
    """Raise on anything the kernels do not take (before building)."""
    _check_mode(mode)
    dev = w2d.device
    if dev.type != "cuda" or dev.index != torch.cuda.current_device():
        raise ValueError(f"w2d must lie on the current CUDA device, got "
                         f"{dev}")
    if len(bufs) != _n_bufs(mode):
        raise ValueError(f"mode {mode!r} takes {_n_bufs(mode)} state "
                         f"buffers, got {len(bufs)}")
    if w2d.dim() != 2 or w2d.shape[1] != LANES or w2d.shape[0] < 1:
        raise ValueError(f"buffers must be (rows, {LANES}), got "
                         f"{tuple(w2d.shape)}")
    if w2d.dtype not in _DTYPE_CODES:
        raise ValueError(f"storage dtype {w2d.dtype} not supported "
                         f"(float32 or bfloat16)")
    for name, x in [("g2d", g2d)] + [(f"bufs[{k}]", b)
                                     for k, b in enumerate(bufs)]:
        if x.device != dev or x.shape != w2d.shape or x.dtype != w2d.dtype:
            raise ValueError(f"{name} is {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}; w2d is {tuple(w2d.shape)} "
                             f"{w2d.dtype} on {dev}")
    for name, x in [("w2d", w2d), ("g2d", g2d)] + [
            (f"bufs[{k}]", b) for k, b in enumerate(bufs)]:
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    ids = seg_ids.reshape(-1)
    if ids.device != dev or ids.dtype != torch.int32 \
            or ids.numel() != w2d.shape[0] or not ids.is_contiguous():
        raise ValueError(f"seg_ids must be ({w2d.shape[0]},) int32 on "
                         f"{dev}, got {tuple(seg_ids.shape)} "
                         f"{seg_ids.dtype} on {seg_ids.device}")
    return dev, ids


def _adam_consts(b1: float, b2: float, eps: float) -> tuple:
    # (1 - b) is formed in double and rounded once to f32, as the
    # reference's Python-scalar arithmetic does
    return (b1, 1.0 - b1, b2, 1.0 - b2, eps)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def seg_norm_cuda(w2d, g2d, bufs, seg_ids, nseg: int, *, mode: str,
                  weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-6, bc1=1.0, bc2=1.0) -> torch.Tensor:
    """Launch pass 1 (one launch) on PyTorch's current stream: (2, nseg)
    f32 per-segment Σw², Σb². Same operands as :func:`seg_norm_ref`;
    ``bufs`` are read only in mode "lamb"."""
    dev, ids = _check_operands(w2d, g2d, bufs, seg_ids, mode)
    if nseg < 1:
        raise ValueError("nseg must be >= 1")
    lib = _lib()
    rows = w2d.shape[0]
    chunk = lib.repro_seg_chunk_rows()
    stride = min(chunk, nseg)
    partial = torch.empty(-(-rows // chunk) * stride * 2,
                          dtype=torch.float32, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty((2, nseg), dtype=torch.float32, device=dev)
    bc = torch.stack([_scalar(bc1, torch.float32, dev),
                      _scalar(bc2, torch.float32, dev)])
    lamb = mode == "lamb"
    mu, nu = (bufs[0].data_ptr(), bufs[1].data_ptr()) if lamb else (0, 0)
    rc = lib.repro_seg_norm(
        int(lamb), _DTYPE_CODES[w2d.dtype], w2d.data_ptr(), g2d.data_ptr(),
        mu, nu, ids.data_ptr(), rows, nseg, bc.data_ptr(),
        *_adam_consts(b1, b2, eps), weight_decay, partial.data_ptr(),
        stride, ticket.data_ptr(), out.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"segmented norm kernel launch failed: CUDA "
                           f"error {rc}")
    return out


def seg_apply_cuda(w2d, g2d, bufs, seg_ids, table, *, mode: str,
                   momentum: float = 0.9, nesterov: bool = False,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                   bc1=1.0, bc2=1.0, stochastic_round: bool = False,
                   seed=0, out_delta: Optional[torch.Tensor] = None):
    """Launch pass 2 (one launch) on PyTorch's current stream: ``bufs``
    are updated IN PLACE, the f32 delta goes to ``out_delta``
    (allocated when None). Returns ``(bufs, delta)``; bitwise equal to
    :func:`seg_apply_ref` given the same table."""
    dev, ids = _check_operands(w2d, g2d, bufs, seg_ids, mode)
    nseg = table.shape[-1]
    if table.shape != (2, nseg) or table.dtype != torch.float32 \
            or table.device != dev:
        raise ValueError(f"table must be (2, nseg) float32 on {dev}, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if out_delta is None:
        out_delta = torch.empty(w2d.shape, dtype=torch.float32, device=dev)
    if out_delta.shape != w2d.shape or out_delta.dtype != torch.float32 \
            or out_delta.device != dev or not out_delta.is_contiguous() \
            or out_delta.data_ptr() % 16:
        raise ValueError("out_delta must be a contiguous, 16-byte aligned "
                         "float32 buffer of w2d's shape on its device")
    lib = _lib()
    table = table.contiguous()
    bc = torch.stack([_scalar(bc1, torch.float32, dev),
                      _scalar(bc2, torch.float32, dev)])
    seed_t = _scalar(seed, torch.int32, dev)
    nu = bufs[1].data_ptr() if mode == "lamb" else 0
    rc = lib.repro_seg_apply(
        _MODE_CODES[mode], int(bool(nesterov)), int(bool(stochastic_round)),
        _DTYPE_CODES[w2d.dtype], w2d.data_ptr(), g2d.data_ptr(),
        bufs[0].data_ptr(), nu, out_delta.data_ptr(), ids.data_ptr(),
        table.data_ptr(), nseg, w2d.shape[0], bc.data_ptr(),
        seed_t.data_ptr(), momentum, *_adam_consts(b1, b2, eps),
        _stream(dev))
    if rc != 0:
        raise RuntimeError(f"segmented apply kernel launch failed: CUDA "
                           f"error {rc}")
    return tuple(bufs), out_delta


def segmented_update_cuda(w2d, g2d, bufs, *, seg_ids, adapt_mask, base_lr,
                          mode: str, eta: float, weight_decay: float,
                          momentum: float, b1: float, b2: float, eps: float,
                          nesterov: bool = False, trust_clip=None,
                          bc1=1.0, bc2=1.0, stochastic_round: bool = False,
                          seed=0, telemetry: bool = False,
                          delta: Optional[torch.Tensor] = None,
                          launches: Optional[dict] = None,
                          reduce_norms=None):
    """The host glue of the two launches (the port of
    ``segmented_update_pallas``): pass 1, the trust table in PyTorch on
    the card, pass 2. State is updated in place; ``launches[name]`` is
    incremented right after each kernel launch when a dict is given.
    ``reduce_norms`` maps pass 1's table of a rank's blocks to the whole
    segments' (one collective) before the trust table."""
    _check_mode(mode)
    norm_name, apply_name = KERNELS[mode]
    nseg = adapt_mask.shape[0]
    adapt = adapt_mask.to(w2d.device)
    norms = seg_norm_cuda(w2d, g2d, bufs, seg_ids, nseg, mode=mode,
                          weight_decay=weight_decay, b1=b1, b2=b2, eps=eps,
                          bc1=bc1, bc2=bc2)
    if launches is not None:
        launches[norm_name] += 1
    if reduce_norms is not None:
        norms = reduce_norms(norms)
    wn, bn, ratio = ref.trust_ratio(norms[0], norms[1], adapt, mode=mode,
                                    eta=eta, weight_decay=weight_decay,
                                    eps=eps, trust_clip=trust_clip)
    table = ref.scales_from_ratio(ratio, adapt, base_lr, weight_decay)
    new_bufs, delta = seg_apply_cuda(
        w2d, g2d, bufs, seg_ids, table, mode=mode, momentum=momentum,
        nesterov=nesterov, b1=b1, b2=b2, eps=eps, bc1=bc1, bc2=bc2,
        stochastic_round=stochastic_round, seed=seed, out_delta=delta)
    if launches is not None:
        launches[apply_name] += 1
    if telemetry:
        return new_bufs, delta, {"w_norm": wn, "g_norm": bn,
                                 "trust_ratio": ratio}
    return new_bufs, delta


def segmented_update_meta(w2d, g2d, bufs, *, seg_ids, adapt_mask, base_lr,
                          mode: str, eta: float, weight_decay: float,
                          momentum: float, b1: float, b2: float, eps: float,
                          nesterov: bool = False, trust_clip=None,
                          bc1=1.0, bc2=1.0, stochastic_round: bool = False,
                          seed=0, telemetry: bool = False,
                          delta: Optional[torch.Tensor] = None,
                          launches: Optional[dict] = None,
                          reduce_norms=None):
    """:func:`segmented_update_cuda`'s glue on meta tensors (the dry
    run): each launch gives an output of its kernel's shape and dtype
    (pass 1 the ``(2, nseg)`` f32 table, pass 2 the f32 delta, the state
    in place), counted in ``launches``; the table's reduction and the
    trust table run as on the card."""
    _check_mode(mode)
    norm_name, apply_name = KERNELS[mode]
    nseg = adapt_mask.shape[0]
    adapt = adapt_mask.to(w2d.device)
    norms = torch.empty((2, nseg), dtype=torch.float32, device=w2d.device)
    if launches is not None:
        launches[norm_name] += 1
    if reduce_norms is not None:
        norms = reduce_norms(norms)
    wn, bn, ratio = ref.trust_ratio(norms[0], norms[1], adapt, mode=mode,
                                    eta=eta, weight_decay=weight_decay,
                                    eps=eps, trust_clip=trust_clip)
    ref.scales_from_ratio(ratio, adapt, base_lr, weight_decay)
    if delta is None:
        delta = torch.empty(w2d.shape, dtype=torch.float32,
                            device=w2d.device)
    if launches is not None:
        launches[apply_name] += 1
    if telemetry:
        return tuple(bufs), delta, {"w_norm": wn, "g_norm": bn,
                                    "trust_ratio": ratio}
    return tuple(bufs), delta
