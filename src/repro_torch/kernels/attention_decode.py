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

The kernel splits each row's keys across blocks: :func:`decode_plan`
gives the split length L (from T, Dh and the cache dtype, never from
the batch), the number of splits and the query heads per block. A split
past the row's last needed key (:func:`last_key`) reads nothing; each
split leaves an f32 partial (m, l, acc) and the last split to finish
merges them in split order in the same launch.

The partial mode serves a cache split over T across the ranks of a
model row (``launch.sharding.cache_pspecs``' T fallback): the cache
holds keys ``[t0, t0 + T_local)`` of ``t_total``; positions, the ring's
slot and the mask use global key indices, the append lands only on the
rank whose block holds the slot, and the call also returns ``lse = m +
log(l)`` [B, H] f32 per row and query head, from which the ranks merge
their outputs (:func:`merge_partials`). A row with no needed key in the
block gives out 0 and lse -inf.

Two more modes serve a cache split over the head dim (``cache_pspecs``'
Dh fallback: the model axis divides neither the KV heads nor T): a rank
holds ``Dl = Dh / M`` of every KV head's dims, so its scores are
partial sums that the model row must sum before the softmax, which one
launch cannot do. The scores mode (:func:`attention_decode_scores_ref`,
:func:`attention_decode_scores_cuda`) appends the rank's block of the
new K / V and writes the f32 partial scores ``q[blk] · K[blk]`` of
every key up to the row's last needed key (0 past it); the caller sums
them over the row; the apply mode (:func:`attention_decode_apply_ref`,
:func:`attention_decode_apply_cuda`) masks, scales by the WHOLE head
dim's ``1/sqrt(Dh)``, runs the f32 softmax and returns probs · V over
the rank's block of the dims.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -2.0e38  # f32-safe mask value (matches models.layers)

MAX_HEAD_DIM = 256
SMEM_LIMIT = 232448   # bytes of shared memory one Hopper block may use
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}


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


def _block(t: int, t0: int, t_total: Optional[int]) -> int:
    """The global length of a cache block of ``t`` keys at ``t0``."""
    tg = t if t_total is None else int(t_total)
    if t0 < 0 or tg < t0 + t:
        raise ValueError(f"a block of {t} keys at t0={t0} does not fit a "
                         f"sequence of {tg}")
    return tg


def _valid(pos: torch.Tensor, t0: int, t: int, tg: int,
           window: Optional[int]) -> torch.Tensor:
    """[B, T] bool: key ``t0 + k`` of a sequence of ``tg`` is one row
    ``pos`` [B] (int64) attends to: global layers k <= pos; a ring of
    ``tg`` the keys whose absolute position lies in (pos - window,
    pos]."""
    kpos = t0 + torch.arange(t, device=pos.device)[None, :]   # [1,T]
    pos_c = pos[:, None]
    if window is None:
        return kpos <= pos_c
    slot_c = (pos % tg)[:, None]
    wraps = torch.div(pos_c, tg, rounding_mode="floor") * tg
    abs_pos = kpos + torch.where(kpos <= slot_c, wraps, wraps - tg)
    return (abs_pos >= 0) & (abs_pos <= pos_c) & (abs_pos > pos_c - window)


def attention_decode_ref(q, new_k, new_v, k_cache, v_cache, pos, *,
                         window: Optional[int] = None, t0: int = 0,
                         t_total: Optional[int] = None,
                         return_lse: bool = False):
    """Plain PyTorch decode attention. q [B,1,H,Dh], new_k/new_v
    [B,1,Hkv,Dh] (rope'd), caches [B,T,Hkv,Dh] (updated in place),
    pos [B] int per-row depths. Returns out [B,1,H,Dh] in q's dtype.

    Partial mode (``t0`` / ``t_total`` / ``return_lse``): the caches
    hold keys ``[t0, t0 + T)`` of ``t_total``, and ``return_lse`` also
    returns lse [B, H] f32; a row with no needed key in the block gives
    out 0 and lse -inf."""
    b, _, h, dh = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    tg = _block(t, t0, t_total)
    partial = return_lse or t0 != 0 or tg != t
    pos = pos.to(torch.int64)
    _, write = _slots(pos, tg, window)
    rows = torch.arange(b, device=q.device)
    mine = (write >= t0) & (write < t0 + t)
    local = (write - t0).clamp(0, t - 1)
    k_cache[rows[mine], local[mine]] = new_k[mine, 0].to(k_cache.dtype)
    v_cache[rows[mine], local[mine]] = new_v[mine, 0].to(v_cache.dtype)
    ok = _valid(pos, t0, t, tg, window)                       # [B,T]
    qg = q.float().reshape(b, hkv, h // hkv, dh)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float()) \
        / math.sqrt(dh)
    if not partial:
        s = torch.where(ok[:, None, None, :], s, NEG_INF)
        probs = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgt,btkd->bkgd", probs, v_cache.float())
        return out.reshape(b, 1, h, dh).to(q.dtype)
    s = torch.where(ok[:, None, None, :], s, -math.inf)
    lse = torch.logsumexp(s, dim=-1)                           # [B,Hkv,G]
    empty = torch.isneginf(lse)
    probs = torch.exp(s - torch.where(empty, 0.0, lse)[..., None])
    out = torch.einsum("bkgt,btkd->bkgd", probs, v_cache.float())
    out = out.reshape(b, 1, h, dh).to(q.dtype)
    return (out, lse.reshape(b, h)) if return_lse else out


def last_keys(pos: torch.Tensor, t: int, window: Optional[int]
              ) -> torch.Tensor:
    """:func:`last_key` of every row of ``pos`` [B] (int64)."""
    if window is None:
        return pos.clamp(max=t - 1)
    return torch.where(pos < t, pos, torch.full_like(pos, t - 1))


def attention_decode_scores_ref(q, new_k, new_v, k_cache, v_cache, pos, *,
                                window: Optional[int] = None
                                ) -> torch.Tensor:
    """Plain PyTorch scores mode (a cache split over the head dim). q
    [B,1,H,Dl] (a block of the rope'd q's dims, every head), new_k /
    new_v [B,1,Hkv,Dl], caches [B,T,Hkv,Dl] holding the same block of
    every key's dims (the append lands in place at the ring's slot, as
    :func:`attention_decode_ref`'s). Returns the unscaled f32 partial
    scores s [B,H,T] of every key up to the row's last needed key, and
    0 past it."""
    b, _, h, dl = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    pos = pos.to(torch.int64)
    _, write = _slots(pos, t, window)
    rows = torch.arange(b, device=q.device)
    k_cache[rows, write] = new_k[:, 0].to(k_cache.dtype)
    v_cache[rows, write] = new_v[:, 0].to(v_cache.dtype)
    qg = q.float().reshape(b, hkv, h // hkv, dl)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float()) \
        .reshape(b, h, t)
    kpos = torch.arange(t, device=q.device)
    keep = kpos[None, :] <= last_keys(pos, t, window)[:, None]    # [B,T]
    return torch.where(keep[:, None], s, 0.0)


def attention_decode_apply_ref(s, v_cache, pos, *, head_dim: int,
                               dtype: torch.dtype,
                               window: Optional[int] = None
                               ) -> torch.Tensor:
    """Plain PyTorch apply mode: ``s`` [B,H,T] f32, the scores mode's
    partials summed over the model row; v_cache [B,T,Hkv,Dl] a block of
    the dims. The mask from ``pos``, the scale ``1/sqrt(head_dim)`` of
    the WHOLE head dim, an f32 softmax over T and probs · V over the
    block: out [B,1,H,Dl] in ``dtype``."""
    b, h, t = s.shape
    hkv, dl = v_cache.shape[2], v_cache.shape[3]
    ok = _valid(pos.to(torch.int64), 0, t, t, window)
    sc = torch.where(ok[:, None], s / math.sqrt(head_dim), NEG_INF)
    probs = torch.softmax(sc, dim=-1).reshape(b, hkv, h // hkv, t)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v_cache.float())
    return out.reshape(b, 1, h, dl).to(dtype)


def merge_partials(outs, lses) -> torch.Tensor:
    """The attention of a sequence split into blocks, from each block's
    output and lse (the partial mode's results, in block order): ``o =
    Σ_r exp(lse_r - lse) · o_r`` with ``lse = logsumexp_r lse_r``, in
    f32, summed in block order. outs [R][B,1,H,Dh], lses [R][B,H];
    returns [B,1,H,Dh] in the outputs' dtype."""
    lse = torch.logsumexp(torch.stack([x.float() for x in lses]), dim=0)
    acc = None
    for o, x in zip(outs, lses):
        w = torch.exp(x.float() - lse)[:, None, :, None]
        term = w * o.float()
        acc = term if acc is None else acc + term
    return acc.to(outs[0].dtype)


# The kernel's fixed shape (csrc/attention_decode.cu: kWarps, kStages,
# chunk_rows): each of WARPS warps keeps a ring of STAGES chunks of
# ROWS[cache dtype] key rows (K and V) in shared memory.
WARPS, STAGES = 8, 4
ROWS = {torch.bfloat16: 2, torch.float32: 1}
SPLIT_BYTES = 128 * 1024   # bytes of K rows one split reads at most
HEADS_PER_BLOCK = (8, 4, 2, 1)   # G: the kernel's instantiations


def split_keys(t: int, dh: int, cache_dtype: torch.dtype) -> int:
    """L, the keys of one split: ``SPLIT_BYTES`` of K rows in whole
    multiples of one pass of the block's warps (``WARPS * ROWS`` rows),
    at most T. A function of (T, Dh, cache dtype) only, so a row's
    result never depends on how many rows share the launch."""
    row_bytes = dh * _ITEMSIZE[cache_dtype]
    per_pass = WARPS * ROWS[cache_dtype]
    keys = max(per_pass, SPLIT_BYTES // row_bytes // per_pass * per_pass)
    return min(keys, t)


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How one launch cuts its work: splits of ``keys`` keys
    (``splits`` of them cover [0, T)), ``heads`` query heads of a KV
    head per block (``head_groups`` blocks per KV head), ``smem`` bytes
    of dynamic shared memory per block."""
    t: int
    keys: int
    splits: int
    heads: int
    head_groups: int
    smem: int

    def grid(self, b: int, hkv: int) -> tuple[int, int]:
        return b * hkv * self.head_groups, self.splits

    def bounds(self) -> list[tuple[int, int]]:
        """[start, end) of every split, in split order."""
        return [(s * self.keys, min((s + 1) * self.keys, self.t))
                for s in range(self.splits)]

    def partial_floats(self, dh: int) -> int:
        """f32 values of one split's partial (m, l, acc[G, Dh])."""
        return 2 * self.heads + self.heads * dh


@functools.lru_cache(maxsize=None)
def decode_plan(t: int, dh: int, cache_dtype: torch.dtype,
                grp: int) -> DecodePlan:
    """The launch plan for a cache of length ``t``, head dim ``dh`` and
    ``grp`` query heads per KV head (no dependence on the batch)."""
    keys = split_keys(t, dh, cache_dtype)
    heads = next(g for g in HEADS_PER_BLOCK if grp % g == 0)
    row_bytes = dh * _ITEMSIZE[cache_dtype]
    ring = WARPS * STAGES * ROWS[cache_dtype] * 2 * row_bytes
    merge = 4 * (2 * WARPS * heads + WARPS * heads * dh)
    return DecodePlan(t=t, keys=keys, splits=-(-t // keys), heads=heads,
                      head_groups=grp // heads, smem=max(ring, merge))


def last_key(pos: int, t: int, window: Optional[int]) -> int:
    """The last key row ``pos`` needs (negative: none). Global layers:
    k <= pos; a ring before its first lap: k <= pos; else every key."""
    if window is None:
        return min(pos, t - 1)
    return pos if pos < t else t - 1


# repro_attention_decode's C signature: ten pointers (q, new_k, new_v,
# the caches, pos, out, the workspace, the tickets, lse), thirteen ints
# (dtype codes, B, T, t0, T_total, H, Hkv, Dh, window, the plan's L, S,
# G), the stream
C_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 13 \
    + [ctypes.c_void_p]


# the head-dim split's two modes: repro_attention_decode_scores takes
# seven pointers (q, new_k, new_v, the caches, pos, s), ten ints (dtype
# codes, B, T, H, Hkv, Dl, window, G, the load width in bytes) and the
# stream; repro_attention_decode_apply four pointers (s, v_cache, pos,
# out), the same ten ints, the scale and the stream
SCORES_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 \
    + [ctypes.c_void_p]
APPLY_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 \
    + [ctypes.c_float, ctypes.c_void_p]
# the modes' load widths: 16 bytes, else one element (the kernel's two
# instantiations)
PIECE_BYTES = 16


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = _build.load("attention_decode")
    fn = lib.repro_attention_decode
    fn.argtypes = C_ARGTYPES
    fn.restype = ctypes.c_int
    smem = lib.repro_attention_decode_smem
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_longlong
    for name, types in (("repro_attention_decode_scores", SCORES_ARGTYPES),
                        ("repro_attention_decode_apply", APPLY_ARGTYPES)):
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return lib


# operand signature (shapes and dtypes) -> its checked plan
_plans: dict = {}

# per (device, stream): the self-resetting tickets (zeroed once; the
# last block of every (row, KV head, head group) puts its ticket back
# to 0) and the partials' workspace, grown on demand
_scratch: dict = {}


def _workspace(dev: torch.device, stream: int, n_tickets: int,
               n_floats: int) -> tuple[torch.Tensor, torch.Tensor]:
    key = (dev.index, stream)
    tickets, ws = _scratch.get(key, (None, None))
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=dev)
    if ws is None or ws.numel() < n_floats:
        ws = torch.empty(n_floats, dtype=torch.float32, device=dev)
    _scratch[key] = (tickets, ws)
    return tickets, ws


def check_operands(q, new_k, new_v, k_cache, v_cache,
                   pos) -> DecodePlan:
    """Raise ``ValueError`` for operands the kernel does not take (on
    any device); return the launch plan otherwise."""
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
    if hkv < 1 or h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    cdt = k_cache.dtype
    if q.dtype not in _DTYPE_CODES or cdt not in _DTYPE_CODES \
            or v_cache.dtype != cdt:
        raise ValueError(f"dtypes not supported: q {q.dtype}, caches "
                         f"{cdt}/{v_cache.dtype} (float32 or bfloat16)")
    if dh > MAX_HEAD_DIM or (dh * _ITEMSIZE[cdt]) % 16:
        raise ValueError(f"head_dim {dh} unsupported: at most "
                         f"{MAX_HEAD_DIM}, rows a multiple of 16 bytes")
    if t < 1:
        raise ValueError("cache length must be >= 1")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous (it is updated "
                             f"in place)")
    plan = decode_plan(t, dh, cdt, h // hkv)
    if plan.smem > SMEM_LIMIT:
        raise ValueError(f"Dh={dh} needs {plan.smem} bytes of shared "
                         f"memory, more than {SMEM_LIMIT}")
    return plan


def attention_decode_cuda(q, new_k, new_v, k_cache, v_cache, pos, *,
                          window: Optional[int] = None, t0: int = 0,
                          t_total: Optional[int] = None,
                          return_lse: bool = False):
    """Launch the Hopper kernel on PyTorch's current stream (no
    synchronisation). Same operands and result as
    :func:`attention_decode_ref`, the partial mode included; raises on
    anything the kernel does not take, before building it."""
    key = (q.shape, q.dtype, new_k.shape, new_v.shape, k_cache.shape,
           k_cache.dtype, v_cache.shape, v_cache.dtype, pos.shape)
    plan = _plans.get(key)
    if plan is None:
        plan = check_operands(q, new_k, new_v, k_cache, v_cache, pos)
        _plans[key] = plan
    elif not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("caches must be contiguous (they are updated in "
                         "place)")
    tg = _block(k_cache.shape[1], t0, t_total)
    dev = q.device
    if dev.type != "cuda" or dev.index != torch.cuda.current_device():
        raise ValueError(f"q must lie on the current CUDA device, got "
                         f"{dev}")
    for name, x in (("new_k", new_k), ("new_v", new_v),
                    ("k_cache", k_cache), ("v_cache", v_cache),
                    ("pos", pos)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, _, h, dh = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    cdt = k_cache.dtype
    if new_k.dtype != cdt:
        new_k = new_k.to(cdt)
    if new_v.dtype != cdt:
        new_v = new_v.to(cdt)
    if pos.dtype != torch.int32:
        pos = pos.to(torch.int32)
    q, new_k, new_v, pos = (x.contiguous() for x in (q, new_k, new_v, pos))
    out = torch.empty((b, 1, h, dh), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h), dtype=torch.float32, device=dev) \
        if return_lse else None
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    blocks = plan.grid(b, hkv)[0]
    tickets, ws = _workspace(dev, stream, blocks,
                             blocks * plan.splits * plan.partial_floats(dh))
    rc = _lib().repro_attention_decode(
        q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
        None if lse is None else lse.data_ptr(),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[cdt], b, t, int(t0), tg, h, hkv,
        dh, -1 if window is None else int(window), plan.keys, plan.splits,
        plan.heads, stream)
    if rc != 0:
        raise RuntimeError(f"attention_decode kernel launch failed: CUDA "
                           f"error {rc}")
    return (out, lse) if return_lse else out


def check_block_operands(q, new_k, new_v, k_cache, v_cache,
                         pos) -> int:
    """Raise ``ValueError`` for operands the scores mode does not take
    (on any device); return G, the query heads a block handles. A block
    of the head dim may be as narrow as one element: rows of any width
    are read 16 bytes at a time where they can be, else an element at a
    time."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B,1,H,Dl], got {tuple(q.shape)}")
    b, _, h, dl = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != b or k_cache.shape[3] != dl:
        raise ValueError(f"caches must both be [B,T,Hkv,Dl] with B={b}, "
                         f"Dl={dl}; got {tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)}")
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    kv_shape = (b, 1, hkv, dl)
    if tuple(new_k.shape) != kv_shape or tuple(new_v.shape) != kv_shape:
        raise ValueError(f"new_k/new_v must be {kv_shape}, got "
                         f"{tuple(new_k.shape)}, {tuple(new_v.shape)}")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be [{b}], got {tuple(pos.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    cdt = k_cache.dtype
    if q.dtype not in _DTYPE_CODES or cdt not in _DTYPE_CODES \
            or v_cache.dtype != cdt:
        raise ValueError(f"dtypes not supported: q {q.dtype}, caches "
                         f"{cdt}/{v_cache.dtype} (float32 or bfloat16)")
    if not 1 <= dl <= MAX_HEAD_DIM or t < 1:
        raise ValueError(f"a block of {dl} dims of {t} keys: want 1 to "
                         f"{MAX_HEAD_DIM} dims and at least one key")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous (it is updated "
                             f"in place)")
    return next(g for g in HEADS_PER_BLOCK if (h // hkv) % g == 0)


def piece_bytes(dl: int, cache_dtype: torch.dtype, *ptrs: int) -> int:
    """The modes' load width for rows of ``dl`` elements: 16 bytes when
    that divides a row's bytes and every address in ``ptrs``, else one
    element's."""
    if (dl * _ITEMSIZE[cache_dtype]) % PIECE_BYTES == 0 \
            and all(p % PIECE_BYTES == 0 for p in ptrs):
        return PIECE_BYTES
    return _ITEMSIZE[cache_dtype]


def _stream_of(dev: torch.device, named: dict) -> int:
    """PyTorch's current stream on ``dev``, after checking every tensor
    of ``named`` lies there."""
    if dev.type != "cuda" or dev.index != torch.cuda.current_device():
        raise ValueError(f"operands must lie on the current CUDA device, "
                         f"got {dev}")
    for name, x in named.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
    return torch._C._cuda_getCurrentRawStream(dev.index)


def attention_decode_scores_cuda(q, new_k, new_v, k_cache, v_cache, pos, *,
                                 window: Optional[int] = None
                                 ) -> torch.Tensor:
    """Launch the scores mode (``csrc/attention_decode.cu``,
    ``scores_kernel``) on PyTorch's current stream: the same operands
    and result as :func:`attention_decode_scores_ref`; raises on
    anything it does not take, before building it."""
    heads = check_block_operands(q, new_k, new_v, k_cache, v_cache, pos)
    dev = q.device
    stream = _stream_of(dev, {"new_k": new_k, "new_v": new_v,
                              "k_cache": k_cache, "v_cache": v_cache,
                              "pos": pos})
    b, _, h, dl = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    cdt = k_cache.dtype
    new_k, new_v = (x.to(cdt).contiguous() for x in (new_k, new_v))
    q = q.contiguous()
    pos = pos.to(torch.int32).contiguous()
    s = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    piece = piece_bytes(dl, cdt, k_cache.data_ptr(), v_cache.data_ptr(),
                        new_k.data_ptr(), new_v.data_ptr())
    rc = _lib().repro_attention_decode_scores(
        q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        s.data_ptr(), _DTYPE_CODES[q.dtype], _DTYPE_CODES[cdt], b, t, h,
        hkv, dl, -1 if window is None else int(window), heads, piece,
        stream)
    if rc != 0:
        raise RuntimeError(f"attention_decode scores launch failed: CUDA "
                           f"error {rc}")
    return s


def attention_decode_apply_cuda(s, v_cache, pos, *, head_dim: int,
                                dtype: torch.dtype,
                                window: Optional[int] = None
                                ) -> torch.Tensor:
    """Launch the apply mode (``apply_kernel``) on PyTorch's current
    stream: the same operands and result as
    :func:`attention_decode_apply_ref`."""
    if s.dim() != 3 or s.dtype != torch.float32:
        raise ValueError(f"s must be [B,H,T] float32, got "
                         f"{tuple(s.shape)} {s.dtype}")
    b, h, t = s.shape
    if v_cache.dim() != 4 or tuple(v_cache.shape[:2]) != (b, t) \
            or h % v_cache.shape[2] or tuple(pos.shape) != (b,):
        raise ValueError(f"v_cache {tuple(v_cache.shape)} and pos "
                         f"{tuple(pos.shape)} do not fit s {(b, h, t)}")
    hkv, dl = v_cache.shape[2], v_cache.shape[3]
    cdt = v_cache.dtype
    if dtype not in _DTYPE_CODES or cdt not in _DTYPE_CODES \
            or not 1 <= dl <= MAX_HEAD_DIM or not v_cache.is_contiguous():
        raise ValueError(f"apply: out {dtype}, cache {cdt} "
                         f"{tuple(v_cache.shape)} not supported")
    heads = next(g for g in HEADS_PER_BLOCK if (h // hkv) % g == 0)
    dev = s.device
    stream = _stream_of(dev, {"v_cache": v_cache, "pos": pos})
    s = s.contiguous()
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty((b, 1, h, dl), dtype=dtype, device=dev)
    piece = piece_bytes(dl, cdt, v_cache.data_ptr())
    rc = _lib().repro_attention_decode_apply(
        s.data_ptr(), v_cache.data_ptr(), pos.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[dtype], _DTYPE_CODES[cdt], b, t, h, hkv, dl,
        -1 if window is None else int(window), heads, piece,
        1.0 / math.sqrt(head_dim), stream)
    if rc != 0:
        raise RuntimeError(f"attention_decode apply launch failed: CUDA "
                           f"error {rc}")
    return out
