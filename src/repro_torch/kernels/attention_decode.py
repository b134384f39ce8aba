"""Fused serving-decode attention: the Hopper kernel's wrapper and its
plain PyTorch version.

One call per layer per decode step does, for every slot row ``b``:

  (a) the KV ring append, in place on the caches, at
      ``slot = pos[b] % T`` (windowed layers, ``T`` = the ring length)
      or ``pos[b]`` (global layers);
  (b) the validity mask computed from ``pos`` alone;
  (c) grouped-query attention with scores, softmax and probs·V in f32,
      the output in ``q.dtype``.

``attention_decode_ref`` is the plain version (a transcription of
``repro.kernels.ref.ref_attention_decode``); ``attention_decode_cuda``
launches ``csrc/attention_decode.cu``. ``kernels.ops.attention_decode``
picks between them by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -2.0e38  # f32-safe mask value (matches models.layers)

MAX_HEAD_DIM = 256
SMEM_LIMIT = 232448   # bytes of shared memory one Hopper block may use
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def decode_parity_tolerance(cache_dtype: torch.dtype) -> dict:
    """Bound for decode-attention parity (``repro.kernels.ref``'s).

    * Kernel ≡ plain version at the SAME cache dtype: both upcast the
      identical stored KV values to f32 and accumulate in f32, so the
      only divergence is reassociation (online blockwise softmax vs
      one global softmax) — 1e-5 on O(1) outputs.
    * A bf16 pool: each KV operand is rounded once to bf16 (8-bit
      mantissa, <= 2^-8 relative), and a bf16 output may land one bf16
      ulp apart — ``4·2^-8`` with a matching absolute floor.
    """
    if cache_dtype == torch.bfloat16:
        eps = 2.0 ** -8
        return {"rtol": 4 * eps, "atol": 4 * eps}
    return {"rtol": 1e-5, "atol": 1e-5}


def _slots(pos: torch.Tensor, t: int, window: Optional[int]):
    """(ring slot used by the mask, write slot clamped into [0, T) as
    ``jax.lax.dynamic_update_slice`` clamps)."""
    slot = pos % t if window is not None else pos
    return slot, slot.clamp(0, t - 1)


def attention_decode_ref(q, new_k, new_v, k_cache, v_cache, pos, *,
                         window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch decode attention. q [B,1,H,Dh], new_k/new_v
    [B,1,Hkv,Dh] (rope'd), caches [B,T,Hkv,Dh] (updated in place),
    pos [B] int per-row depths. Returns out [B,1,H,Dh] in q's dtype."""
    b, _, h, dh = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    pos = pos.to(torch.int64)
    slot, write = _slots(pos, t, window)
    rows = torch.arange(b, device=q.device)
    k_cache[rows, write] = new_k[:, 0].to(k_cache.dtype)
    v_cache[rows, write] = new_v[:, 0].to(v_cache.dtype)
    kpos = torch.arange(t, device=q.device)[None, :]          # [1,T]
    pos_c, slot_c = pos[:, None], slot[:, None]
    if window is not None:
        wraps = torch.div(pos_c, t, rounding_mode="floor") * t
        abs_pos = kpos + torch.where(kpos <= slot_c, wraps, wraps - t)
        ok = (abs_pos >= 0) & (abs_pos <= pos_c) \
            & (abs_pos > pos_c - window)
    else:
        ok = kpos <= pos_c                                     # [B,T]
    qg = q.float().reshape(b, hkv, h // hkv, dh)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float()) \
        / math.sqrt(dh)
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v_cache.float())
    return out.reshape(b, 1, h, dh).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = _build.load("attention_decode")
    fn = lib.repro_attention_decode
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    smem = lib.repro_attention_decode_smem
    smem.argtypes = [ctypes.c_int] * 5
    smem.restype = ctypes.c_longlong
    return lib


def attention_decode_cuda(q, new_k, new_v, k_cache, v_cache, pos, *,
                          window: Optional[int] = None) -> torch.Tensor:
    """Launch the Hopper kernel on PyTorch's current stream (no
    synchronisation). Same operands and result as
    :func:`attention_decode_ref`; raises on anything the kernel does
    not take."""
    dev = q.device
    if dev.type != "cuda" or dev.index != torch.cuda.current_device():
        raise ValueError(f"q must lie on the current CUDA device, got "
                         f"{dev}")
    for name, x in (("new_k", new_k), ("new_v", new_v),
                    ("k_cache", k_cache), ("v_cache", v_cache),
                    ("pos", pos)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B,1,H,Dh], got {tuple(q.shape)}")
    b, _, h, dh = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != b or k_cache.shape[3] != dh:
        raise ValueError(f"caches must both be [B,T,Hkv,Dh] with B={b}, "
                         f"Dh={dh}; got {tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)}")
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    kv_shape = (b, 1, hkv, dh)
    if tuple(new_k.shape) != kv_shape or tuple(new_v.shape) != kv_shape:
        raise ValueError(f"new_k/new_v must be {kv_shape}, got "
                         f"{tuple(new_k.shape)}, {tuple(new_v.shape)}")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be [{b}], got {tuple(pos.shape)}")
    if h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    cdt = k_cache.dtype
    if q.dtype not in _DTYPE_CODES or cdt not in _DTYPE_CODES \
            or v_cache.dtype != cdt:
        raise ValueError(f"dtypes not supported: q {q.dtype}, caches "
                         f"{cdt}/{v_cache.dtype} (float32 or bfloat16)")
    esize = k_cache.element_size()
    if dh > MAX_HEAD_DIM or (dh * esize) % 16:
        raise ValueError(f"head_dim {dh} unsupported: at most "
                         f"{MAX_HEAD_DIM}, rows a multiple of 16 bytes")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned (it is updated in place)")
    if t < 1:
        raise ValueError("cache length must be >= 1")
    lib = _lib()
    smem = lib.repro_attention_decode_smem(_DTYPE_CODES[cdt], t, h, hkv,
                                           dh)
    if smem > SMEM_LIMIT:
        raise ValueError(f"H/Hkv={h // hkv} x Dh={dh} needs {smem} bytes "
                         f"of shared memory, more than {SMEM_LIMIT}")
    q = q.contiguous()
    new_k = new_k.to(cdt).contiguous()
    new_v = new_v.to(cdt).contiguous()
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty((b, 1, h, dh), dtype=q.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.repro_attention_decode(
        q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), _DTYPE_CODES[q.dtype], _DTYPE_CODES[cdt], b, t,
        h, hkv, dh, -1 if window is None else int(window), stream)
    if rc != 0:
        raise RuntimeError(f"attention_decode kernel launch failed: CUDA "
                           f"error {rc}")
    return out
