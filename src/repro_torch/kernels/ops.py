"""Public kernel entry points of the port, dispatched by tensor device.

* :func:`attention_decode` — serving-decode attention (one launch);
  :func:`attention_decode_scores` and :func:`attention_decode_apply`
  are its two launches for a KV cache split over the head dim, whose
  partial scores are summed over the model row between them;
* :func:`segmented_update` — the fused optimizer step on the flat
  substrate (two launches: segmented norms, then the apply);
* :func:`lars_norm2` and :func:`lars_apply` — the per-tensor LARS
  step of the layer-wise optimizers: one norm launch and one apply
  launch over every kernel segment of a step (a pass), whose table of
  sums is reduced over the mesh between them on a rank holding blocks;
  :func:`lars_update` is a pass of one segment;
* :func:`rmsnorm` — RMSNorm with ``(1 + weight)`` scaling (one launch;
  off the models' path, as in the JAX package).

A CUDA tensor goes to the hand-written Hopper kernel; if the build or
the launch fails, the call raises. A CPU tensor goes to the kernel's
plain PyTorch version. A tensor on the ``meta`` device (the dry run,
``launch.dryrun``, which traces a step without allocating) gets outputs
of the kernel's shapes and dtypes and nothing else: in-place outputs
stay in place, nothing is allocated beyond the outputs, and no value is
computed (a meta tensor holds none). There is no environment switch and
no fallback from the kernel to the plain version.

``launches`` counts kernel launches per kernel (plain integers,
incremented only where a kernel is launched), so a run can show that
its main path went through the kernels. ``meta_launches`` counts, under
the same names, the launches a meta call stands for: the launches per
step the card would make; ``meta_flops`` the matmul FLOPs of those
launches (decode attention's q·K and p·V over every cached key, as its
plain version computes them), which a FLOP counter cannot see in a
kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import attention_decode as _ad
from repro_torch.kernels import lars_update as _lu
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import segmented_update as _su

launches = {"attention_decode": 0, "attention_decode_scores": 0,
            "attention_decode_apply": 0, "seg_norm_lars": 0,
            "seg_norm_lamb": 0,
            "seg_apply_lars": 0, "seg_apply_lamb": 0, "lars_norm2": 0,
            "lars_apply": 0, "rmsnorm": 0}


meta_launches = dict.fromkeys(launches, 0)
meta_flops = dict.fromkeys(launches, 0)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def reset_meta_launches() -> None:
    for name in meta_launches:
        meta_launches[name] = 0
        meta_flops[name] = 0


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def attention_decode(q, new_k, new_v, k_cache, v_cache, pos, *,
                     window: Optional[int] = None, t0: int = 0,
                     t_total: Optional[int] = None,
                     return_lse: bool = False):
    """Serving-decode attention: per-row KV ring append (in place on
    the caches) + mask from ``pos`` + f32 GQA softmax attention.
    q [B,1,H,Dh], new_k/new_v [B,1,Hkv,Dh] (rope'd), caches
    [B,T,Hkv,Dh], pos [B] int32 -> out [B,1,H,Dh] in q's dtype; see
    ``attention_decode.decode_parity_tolerance`` for the parity bound.
    The partial mode (a cache holding keys ``[t0, t0 + T)`` of
    ``t_total``; ``return_lse`` adds lse [B, H] f32) is the same
    launch, counted alike.
    """
    kw = dict(window=window, t0=t0, t_total=t_total, return_lse=return_lse)
    if q.device.type == "cuda":
        out = _ad.attention_decode_cuda(q, new_k, new_v, k_cache, v_cache,
                                        pos, **kw)
        launches["attention_decode"] += 1
        return out
    if q.device.type == "cpu":
        return _ad.attention_decode_ref(q, new_k, new_v, k_cache, v_cache,
                                        pos, **kw)
    if q.device.type == "meta":
        meta_launches["attention_decode"] += 1
        meta_flops["attention_decode"] += 4 * q.numel() * k_cache.shape[1]
        out = _meta(q.shape, q.dtype)
        if return_lse:
            return out, _meta(q.shape[:1] + q.shape[2:3], torch.float32)
        return out
    raise RuntimeError(f"attention_decode: no implementation for device "
                       f"{q.device}")


def attention_decode_scores(q, new_k, new_v, k_cache, v_cache, pos, *,
                            window: Optional[int] = None) -> torch.Tensor:
    """The scores mode of decode attention over a block of the head dim
    (``attention_decode.attention_decode_scores_ref``): the append of
    the block of new_k / new_v in place, then the f32 partial scores
    [B, H, T] up to each row's last needed key. On CUDA one launch,
    counted under ``attention_decode_scores``."""
    if q.device.type == "cuda":
        s = _ad.attention_decode_scores_cuda(q, new_k, new_v, k_cache,
                                             v_cache, pos, window=window)
        launches["attention_decode_scores"] += 1
        return s
    if q.device.type == "cpu":
        return _ad.attention_decode_scores_ref(q, new_k, new_v, k_cache,
                                               v_cache, pos, window=window)
    if q.device.type == "meta":
        meta_launches["attention_decode_scores"] += 1
        meta_flops["attention_decode_scores"] += \
            2 * q.numel() * k_cache.shape[1]
        return _meta((q.shape[0], q.shape[2], k_cache.shape[1]),
                     torch.float32)
    raise RuntimeError(f"attention_decode_scores: no implementation for "
                       f"device {q.device}")


def attention_decode_apply(s, v_cache, pos, *, head_dim: int,
                           dtype: torch.dtype,
                           window: Optional[int] = None) -> torch.Tensor:
    """The apply mode (``attention_decode.attention_decode_apply_ref``):
    summed scores ``s`` [B, H, T] f32 -> out [B, 1, H, Dl] in ``dtype``
    over the block of V. On CUDA one launch, counted under
    ``attention_decode_apply``."""
    kw = dict(head_dim=head_dim, dtype=dtype, window=window)
    if s.device.type == "cuda":
        out = _ad.attention_decode_apply_cuda(s, v_cache, pos, **kw)
        launches["attention_decode_apply"] += 1
        return out
    if s.device.type == "cpu":
        return _ad.attention_decode_apply_ref(s, v_cache, pos, **kw)
    if s.device.type == "meta":
        meta_launches["attention_decode_apply"] += 1
        meta_flops["attention_decode_apply"] += 2 * s.numel() \
            * v_cache.shape[3]
        return _meta((s.shape[0], 1, s.shape[1], v_cache.shape[3]), dtype)
    raise RuntimeError(f"attention_decode_apply: no implementation for "
                       f"device {s.device}")


DECODE_KERNELS = ("attention_decode", "attention_decode_scores",
                  "attention_decode_apply")


def decode_launches() -> int:
    """The decode-attention launches counted so far, every mode."""
    return sum(launches[name] for name in DECODE_KERNELS)


def segmented_update(w2d, g2d, bufs, *, delta=None, **kw):
    """Whole-tree layer-wise step on the flat substrate.

    ``w2d``/``g2d``/``bufs`` are ``(rows, 128)`` buffers at the storage
    dtype; ``kw`` are ``segmented_update_ref``'s (seg_ids, adapt_mask,
    base_lr, mode, eta, weight_decay, momentum, b1, b2, eps, nesterov,
    trust_clip, bc1, bc2, stochastic_round, seed, telemetry,
    reduce_norms: pass 1's table reduced between the passes). The state
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
    if w2d.device.type == "meta":
        return _su.segmented_update_meta(w2d, g2d, bufs, delta=delta,
                                         launches=meta_launches, **kw)
    raise RuntimeError(f"segmented_update: no implementation for device "
                       f"{w2d.device}")


def lars_update(w, g, m, *, base_lr, eta: float, weight_decay: float,
                momentum_mu: float, eps: float = 1e-9, nesterov: bool = False,
                telemetry: bool = False):
    """Per-tensor LARS trust-ratio + momentum step -> ``(new_m, delta)``
    (the port of ``repro.kernels.ops.lars_update``).

    ``w``, ``g``, ``m`` are tensors, or equal-length lists of one
    segment's member tensors (all of one shape), which then share one
    trust ratio; the results follow the same form. w and g are read at
    their dtype (f32 or bf16), ``m`` is the f32 momentum and is updated
    IN PLACE (the returned ``new_m`` is ``m``); deltas are f32. With
    ``telemetry=True`` a third value ``[w_norm, g_norm, ratio]`` (f32)
    is returned, from the same sums, with no extra launch.

    A pass of one segment: on CUDA :func:`lars_norm2` and
    :func:`lars_apply`'s two launches, counted under ``lars_norm2`` and
    ``lars_apply``; on the CPU the plain version.
    """
    single = isinstance(w, torch.Tensor)
    ws, gs, ms = ([w], [g], [m]) if single else (list(w), list(g), list(m))
    kw = dict(base_lr=base_lr, eta=eta, weight_decay=weight_decay,
              momentum_mu=momentum_mu, eps=eps, nesterov=nesterov)
    if ws[0].device.type == "cpu":
        new_ms, deltas, stats = _ref.lars_update_ref(ws, gs, ms, **kw)
        for buf, new in zip(ms, new_ms):
            buf.copy_(new)
    else:
        (deltas,), stats = lars_apply([(ws, gs, ms)],
                                      lars_norm2([(ws, gs)]),
                                      telemetry=telemetry, **kw)
        stats = None if stats is None else stats[:, 0]
    out = (ms[0], deltas[0]) if single else (ms, deltas)
    return out + (stats,) if telemetry else out


def _pass_device(segments, name: str) -> torch.device:
    if not segments or not segments[0][0]:
        raise ValueError(f"{name}: an empty pass")
    return segments[0][0][0].device


def lars_norm2(segments) -> torch.Tensor:
    """The per-tensor path's norm pass over a step's kernel segments
    ``[(ws, gs), ...]`` -> a ``[2, S]`` f32 table, column s ``[Σw²,
    Σg²]`` of segment s's members. On CUDA ONE launch for the whole
    pass, counted under ``lars_norm2``; on the CPU the plain version
    (``ref.lars_norm2_pass``, segment by segment); on meta one meta
    launch."""
    segments = [(list(seg[0]), list(seg[1])) for seg in segments]
    dev = _pass_device(segments, "lars_norm2")
    if dev.type == "cuda":
        out = _lu.lars_norm2_cuda(segments)
        launches["lars_norm2"] += 1
        return out
    if dev.type == "cpu":
        return _ref.lars_norm2_pass(segments)
    if dev.type == "meta":
        meta_launches["lars_norm2"] += 1
        return _meta((2, len(segments)), torch.float32)
    raise RuntimeError(f"lars_norm2: no implementation for device {dev}")


def lars_apply(segments, sums, *, base_lr, eta: float, weight_decay: float,
               momentum_mu: float, eps: float = 1e-9, nesterov: bool = False,
               telemetry: bool = False, columns=None):
    """The per-tensor path's apply pass over segments ``[(ws, gs, ms),
    ...]`` from ``sums``, a ``[2, N]`` f32 table (e.g. :func:`lars_norm2`'s,
    summed over a mesh's blocks, with other segments' columns between):
    segment s reads column ``columns[s]`` (default s), forms its trust
    ratio, updates its ``ms`` IN PLACE and gets f32 deltas. Returns
    ``(deltas, stats)``: deltas per segment, per member; ``stats`` the
    ``[3, S]`` table ``[w_norm, g_norm, ratio]`` with ``telemetry``,
    else None. On CUDA ONE launch for the whole pass, counted under
    ``lars_apply``; on the CPU the plain version
    (``ref.lars_apply_pass``); on meta one meta launch."""
    segments = [(list(seg[0]), list(seg[1]), list(seg[2]))
                for seg in segments]
    kw = dict(base_lr=base_lr, eta=eta, weight_decay=weight_decay,
              momentum_mu=momentum_mu, eps=eps, nesterov=nesterov)
    dev = _pass_device(segments, "lars_apply")
    if dev.type == "cuda":
        out = _lu.lars_apply_cuda(segments, sums, stats=telemetry,
                                  columns=columns, **kw)
        launches["lars_apply"] += 1
        return out
    if dev.type == "meta":
        meta_launches["lars_apply"] += 1
        return [[_meta(w.shape, torch.float32) for w in seg[0]]
                for seg in segments], \
            (_meta((3, len(segments)), torch.float32) if telemetry
             else None)
    if dev.type != "cpu":
        raise RuntimeError(f"lars_apply: no implementation for device "
                           f"{dev}")
    lr = kw.pop("base_lr")
    new_ms, deltas, stats = _ref.lars_apply_pass(segments, sums, lr,
                                                 columns=columns, **kw)
    for seg, news in zip(segments, new_ms):
        for m, new in zip(seg[2], news):
            m.copy_(new)
    return deltas, (stats if telemetry else None)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm, gemma convention (scale = 1 + weight): the port of
    ``repro.kernels.ops.rmsnorm``. x (..., d), weight (d,) -> x's shape
    and dtype. On CUDA one launch, counted under ``rmsnorm``; on the
    CPU the plain version. See ``rmsnorm.rmsnorm_tolerance``."""
    if x.device.type == "cuda":
        return _rms.rmsnorm_cuda(x, weight, eps=eps, launches=launches)
    if x.device.type == "cpu":
        return _ref.rmsnorm_ref(x, weight, eps=eps)
    if x.device.type == "meta":
        meta_launches["rmsnorm"] += 1
        return _meta(x.shape, x.dtype)
    raise RuntimeError(f"rmsnorm: no implementation for device {x.device}")
