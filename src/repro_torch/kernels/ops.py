"""Public kernel entry points of the port, dispatched by tensor device.

A CUDA tensor goes to the hand-written Hopper kernel; if the build or
the launch fails, the call raises. A CPU tensor goes to the kernel's
plain PyTorch version. There is no environment switch and no fallback
from the kernel to the plain version.

``launches`` counts kernel launches per entry point (plain integers,
incremented only where a kernel is launched), so a run can show that
its main path went through the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import attention_decode as _ad

launches = {"attention_decode": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def attention_decode(q, new_k, new_v, k_cache, v_cache, pos, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Serving-decode attention: per-row KV ring append (in place on
    the caches) + mask from ``pos`` + f32 GQA softmax attention.
    q [B,1,H,Dh], new_k/new_v [B,1,Hkv,Dh] (rope'd), caches
    [B,T,Hkv,Dh], pos [B] int32 -> out [B,1,H,Dh] in q's dtype; see
    ``attention_decode.decode_parity_tolerance`` for the parity bound.
    """
    if q.device.type == "cuda":
        out = _ad.attention_decode_cuda(q, new_k, new_v, k_cache, v_cache,
                                        pos, window=window)
        launches["attention_decode"] += 1
        return out
    if q.device.type == "cpu":
        return _ad.attention_decode_ref(q, new_k, new_v, k_cache, v_cache,
                                        pos, window=window)
    raise RuntimeError(f"attention_decode: no implementation for device "
                       f"{q.device}")
