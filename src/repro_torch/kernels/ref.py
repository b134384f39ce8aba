"""Shared layer-wise update math: the port of the optimizer half of
``repro.kernels.ref``, and the plain math of the per-tensor LARS and
RMSNorm kernels (:func:`lars_update_ref`, :func:`rmsnorm_ref`).

Every optimizer of the family runs the same three steps per segment:

    d          = direction(mode, ...)        # g, or the Adam direction
    scaled     = sg·d + sw·w                 # sg = lr·ratio, sw = sg·wd
    new, delta = integrate(mode, ...)        # heavy ball / Alg. 1 / none

with per-segment ``(sg, sw)`` from :func:`trust_scale_table`. The tree
path (``core.layerwise``), the segmented plain version and the Hopper
kernels (``kernels.segmented_update``) all round at the same program
points: every operand is upcast to f32, each elementwise op rounds to
f32 once, state is written back at its storage dtype (round to
nearest, or :func:`stochastic_round_to`) and the weight delta is f32.

Stochastic rounding draws its bits from a counter hash of the global
flat element index. The hash is uint32 arithmetic; PyTorch on the CPU
has no uint32 add, so it is written on int64 and masked to 32 bits
after every step (:data:`MASK32`), which gives the reference's bits
exactly, indices past 2^31 included.
"""
from __future__ import annotations

from typing import Optional

import torch

MODES = ("lars", "paper", "lamb")
MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# precision model: parity bounds + stochastic rounding
# ---------------------------------------------------------------------------

def parity_tolerance(precision: str, steps: int = 1) -> dict:
    """Bound for comparing a precision policy's update with the f32
    reference: 1e-6 for ``"f32"`` (summation order only); ``4·2^-8 ·
    steps`` relative with a matching absolute floor for the bf16
    policies (each operand rounded once to bf16, compounding linearly
    through momentum)."""
    if precision == "f32":
        return {"rtol": 1e-6, "atol": 1e-6}
    eps = 2.0 ** -8
    return {"rtol": 4 * eps * steps, "atol": 4 * eps * steps}


def _u32(x) -> torch.Tensor:
    """``x`` (int tensor or Python int) as int64 holding its uint32 bit
    pattern (two's complement for negative int32 values)."""
    return torch.as_tensor(x).to(torch.int64) & MASK32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for ``x`` in [0, 2^32) held in int64, split
    so that no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def hash_bits(idx: torch.Tensor, seed) -> torch.Tensor:
    """Counter-based uint32 hash (xxhash-style avalanche) of per-element
    indices, as int64 values in [0, 2^32)."""
    x = _mul32(_u32(idx), 2654435761)
    x = (x + _u32(seed).to(x.device)) & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 2246822519)
    x = x ^ (x >> 13)
    x = _mul32(x, 3266489917)
    return x ^ (x >> 16)


def buf_bits(idx: torch.Tensor, seed, buf: int) -> torch.Tensor:
    """Bits for state buffer ``buf``'s write-back: the seed is mixed
    with ``buf · 0x9E3779B9`` so LAMB's mu and nu draw independent
    streams."""
    mixed = (_u32(seed) + (buf * 0x9E3779B9 & MASK32)) & MASK32
    return hash_bits(idx, mixed)


def element_index(rows: int, lanes: int, row0=0, *,
                  device=None) -> torch.Tensor:
    """(rows, lanes) global flat element index from row ``row0`` (an
    int, or a (rows,) tensor of global row numbers), mod 2^32: the
    reference's int32 iota wraps past 2^31 and is then read as uint32,
    which is this value."""
    r = torch.as_tensor(row0, dtype=torch.int64, device=device)
    if r.dim() == 0:
        r = r + torch.arange(rows, dtype=torch.int64, device=r.device)
    c = torch.arange(lanes, dtype=torch.int64, device=r.device)
    return (r[:, None] * lanes + c[None, :]) & MASK32


def stochastic_round_to(x: torch.Tensor, bits: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
    """Round f32 ``x`` to bf16 stochastically: add the low 16 of
    ``bits`` to the f32 bit pattern and truncate, leaving inf/nan
    untouched. Non-bf16 dtypes round to nearest."""
    if dtype != torch.bfloat16:
        return x.to(dtype)
    x32 = x.float()
    u = x32.view(torch.int32).to(torch.int64) & MASK32
    u = (u + (bits & 0xFFFF)) & 0xFFFF0000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)
    rounded = u.view(torch.float32)
    return torch.where(torch.isfinite(x32), rounded, x32).to(dtype)


def store(x: torch.Tensor, dtype: torch.dtype, *,
          bits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """State write-back cast: round to nearest, or stochastic when
    ``bits`` is given (the ``_sr`` policies)."""
    if bits is not None:
        return stochastic_round_to(x, bits, dtype)
    return x.to(dtype)


# ---------------------------------------------------------------------------
# shared elementwise math (modes: "lars" heavy ball, "paper" Alg. 1, "lamb")
# ---------------------------------------------------------------------------

def direction(mode: str, w, g, bufs, *, b1: float = 0.9,
              b2: float = 0.999, bc1=1.0, bc2=1.0, eps: float = 1e-6):
    """Pre-trust-ratio direction -> ``(d, new_bufs)``; LAMB advances its
    moments here, the momentum modes pass ``bufs`` through."""
    if mode == "lamb":
        mu, nu = bufs
        new_mu = b1 * mu + (1.0 - b1) * g
        new_nu = b2 * nu + (1.0 - b2) * (g * g)
        d = (new_mu / bc1) / (torch.sqrt(new_nu / bc2) + eps)
        return d, (new_mu, new_nu)
    return g, bufs


def integrate(mode: str, w, bufs, scaled, *, momentum: float = 0.9,
              nesterov: bool = False):
    """Momentum integration -> ``(new_bufs, delta)``; params' = w + delta.

    * "lars":  m' = μm + scaled;  Δ = −m' (nesterov: −(scaled + μm'))
    * "paper": Algorithm 1 l.7–8, the buffer holds the previous
      proposed params: m' = w − scaled;  Δ = (m' − w) + μ(m' − m)
    * "lamb":  Δ = −scaled (moments advanced in :func:`direction`).
    """
    if mode == "paper":
        (m,) = bufs
        proposed = w - scaled
        delta = (proposed - w) + momentum * (proposed - m)
        return (proposed,), delta
    if mode == "lars":
        (m,) = bufs
        new_m = momentum * m + scaled
        delta = -(scaled + momentum * new_m) if nesterov else -new_m
        return (new_m,), delta
    return bufs, -scaled


def trust_ratio(w2, b2, adapt_mask, *, mode: str, eta: float,
                weight_decay: float, eps: float, trust_clip=None):
    """Per-segment ``(w_norm, b_norm, ratio)`` from Σw², Σb² (f32
    tensors): the layer-wise telemetry triple. Ratio 1 where a norm is
    zero or the segment is not ADAPT."""
    wn = torch.sqrt(w2)
    bn = torch.sqrt(b2)
    nonzero = (wn > 0.0) & (bn > 0.0)
    if mode == "lamb":
        ratio = torch.where(nonzero, wn / torch.where(nonzero, bn, 1.0),
                            1.0)
    else:
        ratio = torch.where(
            nonzero, eta * wn / (bn + weight_decay * wn + eps), 1.0)
    if trust_clip is not None:
        ratio = torch.clamp(ratio, max=trust_clip)
    ratio = torch.where(adapt_mask, ratio, 1.0)
    return wn, bn, ratio


def scales_from_ratio(ratio, adapt_mask, base_lr,
                      weight_decay: float) -> torch.Tensor:
    """(sg, sw) = (lr·ratio, lr·ratio·wd) stacked -> (2, ...) f32;
    non-ADAPT segments take no weight decay."""
    lr = torch.as_tensor(base_lr, dtype=torch.float32,
                         device=ratio.device)
    sg = lr * ratio
    sw = torch.where(adapt_mask, sg * weight_decay, 0.0)
    return torch.stack([sg, sw]).to(torch.float32)


def trust_scale_table(w2, b2, adapt_mask, base_lr, *, mode: str,
                      eta: float, weight_decay: float, eps: float,
                      trust_clip=None) -> torch.Tensor:
    """Per-segment (sg, sw) from Σw², Σb² -> (2, nseg) f32."""
    _, _, ratio = trust_ratio(w2, b2, adapt_mask, mode=mode, eta=eta,
                              weight_decay=weight_decay, eps=eps,
                              trust_clip=trust_clip)
    return scales_from_ratio(ratio, adapt_mask, base_lr, weight_decay)


# ---------------------------------------------------------------------------
# per-tensor LARS (``repro/kernels/lars_update.py``) and RMSNorm
# (``repro/kernels/rmsnorm.py``), written as those TPU kernels compute
# ---------------------------------------------------------------------------

def lars_norm2(ws, gs) -> torch.Tensor:
    """``[Σw², Σg²]`` over a segment's member tensors, in f32 from the
    storage dtype (``_norm2_kernel``)."""
    w2 = sum(torch.sum(torch.square(w.float())) for w in ws)
    g2 = sum(torch.sum(torch.square(g.float())) for g in gs)
    return torch.stack([w2, g2]).to(torch.float32)


def lars_ratio(sums: torch.Tensor, base_lr, *, eta: float,
               weight_decay: float, eps: float):
    """``(w_norm, g_norm, ratio, scale)`` from ``[Σw², Σg²]``:
    ``ratio = η‖w‖ / (‖g‖ + wd·‖w‖ + eps)`` where both norms are
    positive, else 1; ``scale = base_lr·ratio`` (``lars_update.py``
    between its two launches)."""
    wn = torch.sqrt(sums[0])
    gn = torch.sqrt(sums[1])
    ratio = torch.where((wn > 0.0) & (gn > 0.0),
                        eta * wn / (gn + weight_decay * wn + eps), 1.0)
    lr = torch.as_tensor(base_lr, dtype=torch.float32, device=wn.device)
    return wn, gn, ratio, lr * ratio


def lars_apply(w, g, m, scale, *, weight_decay: float, momentum_mu: float,
               nesterov: bool = False):
    """``_apply_kernel`` on one tensor: ``scaled = scale·(g + wd·w)``,
    ``m' = μ·m + scaled``, ``Δ = −(scaled + μ·m')`` (nesterov) or
    ``−m'``. Returns ``(m', Δ)`` in f32. This rounds otherwise than the
    tree path's ``sg·g + sw·w`` (:func:`scales_from_ratio`)."""
    scaled = scale * (g.float() + weight_decay * w.float())
    new_m = momentum_mu * m.float() + scaled
    delta = -(scaled + momentum_mu * new_m) if nesterov else -new_m
    return new_m, delta


def lars_update_ref(ws, gs, ms, *, base_lr, eta: float, weight_decay: float,
                    momentum_mu: float, eps: float = 1e-9,
                    nesterov: bool = False):
    """The per-tensor LARS step over a segment's member tensors (one
    trust ratio for all of them). Returns ``(new_ms, deltas, stats)``,
    f32, with ``stats = [w_norm, g_norm, ratio]``; inputs unchanged."""
    wn, gn, ratio, scale = lars_ratio(lars_norm2(ws, gs), base_lr, eta=eta,
                                      weight_decay=weight_decay, eps=eps)
    out = [lars_apply(w, g, m, scale, weight_decay=weight_decay,
                      momentum_mu=momentum_mu, nesterov=nesterov)
           for w, g, m in zip(ws, gs, ms)]
    return [o[0] for o in out], [o[1] for o in out], \
        torch.stack([wn, gn, ratio])


def lars_norm2_pass(segments) -> torch.Tensor:
    """The plain norm pass: a ``[2, S]`` f32 table whose column s is
    :func:`lars_norm2` of segment s ``(ws, gs)`` (the per-tensor path's
    kernel takes every segment of a step in one launch)."""
    return torch.stack([lars_norm2(seg[0], seg[1]) for seg in segments],
                       dim=1)


def lars_apply_pass(segments, sums: torch.Tensor, base_lr, *, eta: float,
                    weight_decay: float, momentum_mu: float,
                    eps: float = 1e-9, nesterov: bool = False,
                    columns=None):
    """The plain apply pass over segments ``(ws, gs, ms)``: segment s
    takes :func:`lars_ratio` of column ``columns[s]`` (default s) of the
    ``[2, N]`` table ``sums``, then :func:`lars_apply` on each member.
    Returns ``(new_ms, deltas, stats)``: lists per segment of f32
    tensors, and the ``[3, S]`` table of ``[w_norm, g_norm, ratio]``;
    inputs unchanged."""
    cols = range(len(segments)) if columns is None else columns
    new_ms, deltas, stats = [], [], []
    for (ws, gs, ms), c in zip(segments, cols):
        wn, gn, ratio, scale = lars_ratio(sums[:, c], base_lr, eta=eta,
                                          weight_decay=weight_decay, eps=eps)
        out = [lars_apply(w, g, m, scale, weight_decay=weight_decay,
                          momentum_mu=momentum_mu, nesterov=nesterov)
               for w, g, m in zip(ws, gs, ms)]
        new_ms.append([o[0] for o in out])
        deltas.append([o[1] for o in out])
        stats.append(torch.stack([wn, gn, ratio]))
    return new_ms, deltas, torch.stack(stats, dim=1)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``x·rsqrt(mean(x²) + eps)·(1 + w)`` in f32, cast to x's dtype
    (``_rmsnorm_kernel``; its oracle divides by a sqrt instead)."""
    x32 = x.float()
    var = torch.sum(x32 * x32, dim=-1, keepdim=True) / x.shape[-1]
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)
