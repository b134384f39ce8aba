"""RMSNorm: the Hopper kernel's wrapper, its plain PyTorch version and
its parity bound.

``y = x·rsqrt(mean(x²) + eps)·(1 + w)`` over the last axis, computed in
f32 and stored in x's dtype: the port of ``_rmsnorm_kernel``
(``repro/kernels/rmsnorm.py``). The kernels are ``csrc/rmsnorm.cu``
(d a multiple of 128 up to 8192, the row held in registers): one warp
per row for rows of up to ``NARROW_MAX_D`` with 16-byte aligned
operands, one block per row otherwise (:func:`rmsnorm_launch` says
which); the plain version is ``kernels.ref.rmsnorm_ref``.
``kernels.ops.rmsnorm`` picks between them by the tensor's device and
counts launches. As in the JAX package, the models do not call it:
they keep the plain ``models.layers.rmsnorm``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_D = 8192            # 4 * kMaxGroups * kMaxThreads of csrc/rmsnorm.cu
NARROW_MAX_D = 2048     # kNarrowMaxD: widest row of the warp-per-row kernel
ROWS_PER_BLOCK = 4      # kRowsPerBlock: rows (warps) of a narrow block


def rmsnorm_tolerance(dtype: torch.dtype) -> dict:
    """Kernel or JAX against the plain version, on the same input: f32
    within 1e-5 relative (the sum of d squares in another order, a few
    ulp of the mean, halved by the rsqrt, plus rsqrt's own 2 ulp); a
    16-bit output within one storage ulp (2^-7 relative for bf16,
    2^-10 for f16, with a matching absolute floor), because f32 results
    a few ulp apart can round to neighbouring 16-bit values."""
    if dtype == torch.float32:
        return {"rtol": 1e-5, "atol": 1e-6}
    eps = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    return {"rtol": eps, "atol": eps}


def rmsnorm_bytes(x: torch.Tensor, w: torch.Tensor) -> int:
    """Bytes the function must move: x read, y written, w read once."""
    return 2 * x.numel() * x.element_size() + w.numel() * w.element_size()


def rmsnorm_launch(rows: int, d: int, aligned: bool) -> dict:
    """Which kernel normalises ``rows`` rows of ``d`` and its grid:
    ``narrow`` (one warp per row, ``ROWS_PER_BLOCK`` rows a block) for
    d <= ``NARROW_MAX_D`` when x, w and y are 16-byte ``aligned``, else
    one block of min(256, d / 4) threads per row."""
    if d <= NARROW_MAX_D and aligned:
        return {"narrow": True, "blocks": -(-rows // ROWS_PER_BLOCK),
                "threads": 32 * ROWS_PER_BLOCK}
    return {"narrow": False, "blocks": rows, "threads": min(256, d // 4)}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared (once)."""
    lib = _build.load("rmsnorm")
    lib.repro_rmsnorm.argtypes = [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_float,
                                  ctypes.c_int, ctypes.c_void_p]
    lib.repro_rmsnorm.restype = ctypes.c_int
    return lib


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
                 launches: Optional[dict] = None) -> torch.Tensor:
    """Launch the kernel (one launch; none for an empty x) on PyTorch's
    current stream. x: (..., d) f32 / bf16 / f16 on the current CUDA
    device, d a multiple of 128 up to 8192; w: (d,). Returns y shaped
    like x; ``launches["rmsnorm"]`` is incremented right after the
    launch when a dict is given. Refuses what the kernels do not take
    before building them."""
    d = x.shape[-1] if x.dim() else 0
    if d < 128 or d % 128 or d > MAX_D:
        raise ValueError(f"d={d}: the kernel takes a multiple of 128 up "
                         f"to {MAX_D}")
    if x.dtype not in _DTYPE_CODES or w.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtypes {x.dtype}, {w.dtype} not supported "
                         f"(float32, bfloat16, float16)")
    if w.shape != (d,):
        raise ValueError(f"w must be ({d},), got {tuple(w.shape)}")
    dev = x.device
    if dev.type != "cuda" or dev.index != torch.cuda.current_device():
        raise ValueError(f"x must lie on the current CUDA device, got {dev}")
    if w.device != dev:
        raise ValueError(f"w must lie on {dev}, got {w.device}")
    x2 = x.contiguous()
    w = w.contiguous()
    for name, t in (("x", x2), ("w", w)):
        if t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"{name} must be aligned to 4 elements")
    y = torch.empty_like(x2)
    rows = x2.numel() // d
    if rows == 0:
        return y
    aligned = (x2.data_ptr() | w.data_ptr() | y.data_ptr()) % 16 == 0
    rc = _lib().repro_rmsnorm(
        _DTYPE_CODES[x2.dtype], _DTYPE_CODES[w.dtype], x2.data_ptr(),
        w.data_ptr(), y.data_ptr(), rows, d, eps,
        int(rmsnorm_launch(rows, d, aligned)["narrow"]),
        torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc}")
    if launches is not None:
        launches["rmsnorm"] += 1
    return y
