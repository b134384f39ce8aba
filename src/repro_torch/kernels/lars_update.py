"""Per-tensor LARS step: the Hopper kernels' wrappers and their plain
PyTorch version (the ``use_kernel="per_tensor"`` path of the layer-wise
optimizers).

One step over one kernel segment is two launches, whatever the number
of member tensors:

  norm   ``lars_norm2_cuda``  — ``[Σw², Σg²]`` over the members, f32
                              on the card (w and g read at their
                              storage dtype);
  apply  ``lars_apply_cuda``  — the trust ratio and ``scale =
                              base_lr·ratio`` from those sums, then
                              ``scaled = scale·(g + wd·w)``, ``m' =
                              μ·m + scaled`` written IN PLACE into the
                              f32 momentum, and the f32 delta
                              ``−(scaled + μ·m')`` (nesterov) or
                              ``−m'``.

A segment is one leaf of the JAX package's tree: a single tensor, or
on an LM tree the per-layer members of one stacked group leaf (all of
one shape), which share one trust ratio. The kernels are
``csrc/lars_update.cu`` (ported from ``_norm2_kernel`` and
``_apply_kernel`` of ``repro/kernels/lars_update.py``); the plain
version is ``kernels.ref.lars_update_ref``. ``kernels.ops.lars_update``
picks between them by the tensors' device and counts launches. The
apply reads the sums and ``base_lr`` from device memory, so a step
reads nothing back to the host.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_MEMBERS = 64        # kMaxMembers of csrc/lars_update.cu


def norm_bytes(ws, gs) -> int:
    """Bytes the norm must move: w and g read once, two sums written."""
    return sum(w.numel() * w.element_size() + g.numel() * g.element_size()
               for w, g in zip(ws, gs)) + 8


def apply_bytes(ws, gs) -> int:
    """Bytes the apply must move: w, g and the f32 momentum read, the
    momentum and the f32 delta written, the sums and base_lr read."""
    return sum(w.numel() * (w.element_size() + 12) + g.numel()
               * g.element_size() for w, g in zip(ws, gs)) + 12


# ---------------------------------------------------------------------------
# Hopper kernels
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = _build.load("lars_update")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.repro_lars_max_members.argtypes = []
    lib.repro_lars_max_members.restype = i
    lib.repro_lars_chunk.argtypes = []
    lib.repro_lars_chunk.restype = ll
    lib.repro_lars_norm2.argtypes = [i, i, i, i, p, p, ll, p, p, p, p]
    lib.repro_lars_norm2.restype = i
    lib.repro_lars_apply.argtypes = [i, i, i, i, i, p, p, p, p, ll, p, p,
                                     f, f, f, f, p, p]
    lib.repro_lars_apply.restype = i
    if lib.repro_lars_max_members() != MAX_MEMBERS:
        raise RuntimeError("lars_update.cu and lars_update.py disagree on "
                           "the largest member count")
    return lib


def _aligned(x: torch.Tensor) -> bool:
    return x.data_ptr() % (4 * x.element_size()) == 0


def _check_members(ws: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                   ms: Optional[Sequence[torch.Tensor]] = None):
    """Raise on anything the kernels do not take (before building);
    returns ``(device, numel per member, vectorised)``."""
    if not ws or len(ws) != len(gs) or (ms is not None
                                        and len(ms) != len(ws)):
        raise ValueError(f"need as many w, g (and m) members, got "
                         f"{len(ws)}, {len(gs)}"
                         f"{'' if ms is None else f', {len(ms)}'}")
    if len(ws) > MAX_MEMBERS:
        raise ValueError(f"{len(ws)} members; one launch takes at most "
                         f"{MAX_MEMBERS}")
    if ws[0].dtype == torch.float32 and gs[0].dtype == torch.bfloat16:
        raise ValueError("f32 weights with bf16 gradients: no path makes "
                         "them, and the kernels do not take them")
    dev = ws[0].device
    if dev.type != "cuda" or dev.index != torch.cuda.current_device():
        raise ValueError(f"members must lie on the current CUDA device, "
                         f"got {dev}")
    n = ws[0].numel()
    if n < 1:
        raise ValueError("empty members")
    groups = [("w", ws), ("g", gs)] + ([("m", ms)] if ms is not None
                                       else [])
    for name, xs in groups:
        dtypes = {x.dtype for x in xs}
        if len(dtypes) != 1 or dtypes.pop() not in _DTYPE_CODES \
                or (name == "m" and xs[0].dtype != torch.float32):
            raise ValueError(f"{name} members must share one dtype "
                             f"(float32 or bfloat16; m float32), got "
                             f"{sorted(str(x.dtype) for x in xs)}")
        for x in xs:
            if x.device != dev or x.numel() != n or not x.is_contiguous():
                raise ValueError(f"{name} member {tuple(x.shape)} on "
                                 f"{x.device}: members must be contiguous,"
                                 f" on {dev}, of {n} elements each")
    vec = n % 4 == 0 and all(_aligned(x) for _, xs in groups for x in xs)
    return dev, n, vec


def _ptrs(xs) -> ctypes.Array:
    return (ctypes.c_void_p * len(xs))(*[x.data_ptr() for x in xs])


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def lars_norm2_cuda(ws, gs) -> torch.Tensor:
    """Launch the norm (one launch) on PyTorch's current stream:
    ``[Σw², Σg²]`` f32 on the card over all members."""
    dev, n, vec = _check_members(ws, gs)
    lib = _lib()
    chunks = -(-n // lib.repro_lars_chunk())
    partial = torch.empty(2 * chunks * len(ws), dtype=torch.float32,
                          device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    rc = lib.repro_lars_norm2(
        _DTYPE_CODES[ws[0].dtype], _DTYPE_CODES[gs[0].dtype], int(vec),
        len(ws), _ptrs(ws), _ptrs(gs), n, partial.data_ptr(),
        ticket.data_ptr(), out.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"per-tensor norm kernel launch failed: CUDA "
                           f"error {rc}")
    return out


def lars_apply_cuda(ws, gs, ms, sums, *, base_lr, eta: float,
                    weight_decay: float, momentum_mu: float,
                    eps: float = 1e-9, nesterov: bool = False,
                    stats: bool = False):
    """Launch the apply (one launch) on PyTorch's current stream: the
    f32 momentum members ``ms`` are updated IN PLACE and the f32 deltas
    written to views of one new buffer. Returns ``(deltas, stats)``:
    ``stats`` is ``[w_norm, g_norm, ratio]`` on the card when asked
    for, else None. Bitwise equal to ``ref.lars_ratio`` +
    ``ref.lars_apply`` given the same sums."""
    dev, n, vec = _check_members(ws, gs, ms)
    flat = torch.empty(len(ws) * n, dtype=torch.float32, device=dev)
    deltas = [flat[k * n:(k + 1) * n].view(w.shape)   # aligned as vec
              for k, w in enumerate(ws)]                # needs: n % 4 == 0
    if sums.shape != (2,) or sums.dtype != torch.float32 \
            or sums.device != dev:
        raise ValueError(f"sums must be (2,) float32 on {dev}, got "
                         f"{tuple(sums.shape)} {sums.dtype}")
    lib = _lib()
    lr = torch.as_tensor(base_lr).to(device=dev, dtype=torch.float32) \
        .reshape(())
    out_stats = torch.empty(3, dtype=torch.float32, device=dev) if stats \
        else None
    rc = lib.repro_lars_apply(
        _DTYPE_CODES[ws[0].dtype], _DTYPE_CODES[gs[0].dtype], int(vec),
        int(bool(nesterov)), len(ws), _ptrs(ws), _ptrs(gs), _ptrs(ms),
        _ptrs(deltas), n, sums.data_ptr(), lr.data_ptr(), eta,
        weight_decay, eps, momentum_mu,
        out_stats.data_ptr() if stats else None, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"per-tensor apply kernel launch failed: CUDA "
                           f"error {rc}")
    return deltas, out_stats


def lars_update_cuda(ws, gs, ms, *, launches: dict, base_lr, eta: float,
                     weight_decay: float, momentum_mu: float,
                     eps: float = 1e-9, nesterov: bool = False,
                     telemetry: bool = False):
    """The two launches of one segment's step. ``ms`` are updated in
    place; returns ``(ms, deltas, stats)`` (``stats`` None unless
    ``telemetry``). ``launches["lars_norm2"]`` / ``["lars_apply"]`` are
    incremented right after each launch."""
    sums = lars_norm2_cuda(ws, gs)
    launches["lars_norm2"] += 1
    deltas, stats = lars_apply_cuda(
        ws, gs, ms, sums, base_lr=base_lr, eta=eta,
        weight_decay=weight_decay, momentum_mu=momentum_mu, eps=eps,
        nesterov=nesterov, stats=telemetry)
    launches["lars_apply"] += 1
    return list(ms), deltas, stats
