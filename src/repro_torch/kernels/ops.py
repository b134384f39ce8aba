"""Public kernel entry points of the port, dispatched by tensor device.

* :func:`attention_decode` — serving-decode attention (one launch);
* :func:`segmented_update` — the fused optimizer step on the flat
  substrate (two launches: segmented norms, then the apply).

A CUDA tensor goes to the hand-written Hopper kernel; if the build or
the launch fails, the call raises. A CPU tensor goes to the kernel's
plain PyTorch version. There is no environment switch and no fallback
from the kernel to the plain version.

``launches`` counts kernel launches per kernel (plain integers,
incremented only where a kernel is launched), so a run can show that
its main path went through the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import attention_decode as _ad
from repro_torch.kernels import segmented_update as _su

launches = {"attention_decode": 0, "seg_norm_lars": 0, "seg_norm_lamb": 0,
            "seg_apply_lars": 0, "seg_apply_lamb": 0}


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


def segmented_update(w2d, g2d, bufs, *, delta=None, **kw):
    """Whole-tree layer-wise step on the flat substrate.

    ``w2d``/``g2d``/``bufs`` are ``(rows, 128)`` buffers at the storage
    dtype; ``kw`` are ``segmented_update_ref``'s (seg_ids, adapt_mask,
    base_lr, mode, eta, weight_decay, momentum, b1, b2, eps, nesterov,
    trust_clip, bc1, bc2, stochastic_round, seed, telemetry). The state
    buffers are updated IN PLACE and the f32 delta is written into
    ``delta`` (allocated when None). Returns ``(bufs, delta)``, plus the
    per-segment ``{"w_norm", "g_norm", "trust_ratio"}`` with
    ``telemetry=True``.

    On CUDA: two launches, counted under ``seg_norm_{lars,lamb}`` and
    ``seg_apply_{lars,lamb}``. On the CPU: the plain version.
    """
    if w2d.device.type == "cuda":
        return _su.segmented_update_cuda(w2d, g2d, bufs, delta=delta,
                                         launches=launches, **kw)
    if w2d.device.type == "cpu":
        out = _su.segmented_update_ref(w2d, g2d, bufs, **kw)
        for buf, new in zip(bufs, out[0]):
            buf.copy_(new)
        if delta is None:
            delta = out[1]
        else:
            delta.copy_(out[1])
        return (tuple(bufs), delta) + tuple(out[2:])
    raise RuntimeError(f"segmented_update: no implementation for device "
                       f"{w2d.device}")
