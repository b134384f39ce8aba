"""Decode attention: the port's plain version against the reference.

The same numpy operands go through ``repro_torch``'s
``attention_decode_ref`` (what ``kernels.ops.attention_decode`` runs for
CPU tensors), the reference's Pallas kernel in interpret mode
(``repro.kernels.ops.attention_decode_fused``) and its jnp oracle
(``repro.kernels.ref.ref_attention_decode``). Outputs must agree within
``decode_parity_tolerance`` of the cache dtype and the updated caches
bit for bit. The Hopper kernel itself is held against the plain version
on the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import attention_decode as tad
from repro_torch.kernels import ops

# jitted so each case compiles once (the kernel body is unchanged)
_pallas = jax.jit(jax_ops.attention_decode_fused, static_argnames="window")
_oracle = jax.jit(jax_ref.ref_attention_decode, static_argnames="window")

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _operands(b, t, h, hkv, dh, cache_dtype, pos, seed=0):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(b, 1, h, dh), rng.randn(b, 1, hkv, dh),
              rng.randn(b, 1, hkv, dh), rng.randn(b, t, hkv, dh),
              rng.randn(b, t, hkv, dh)]
    arrays = [a.astype(np.float32) for a in arrays]
    jdt, tdt = _DTYPES[cache_dtype]
    jx = [jnp.asarray(a) for a in arrays[:3]] \
        + [jnp.asarray(a).astype(jdt) for a in arrays[3:]] \
        + [jnp.asarray(pos, jnp.int32)]
    tx = [torch.from_numpy(a) for a in arrays[:3]] \
        + [torch.from_numpy(a).to(tdt) for a in arrays[3:]] \
        + [torch.tensor(pos, dtype=torch.int32)]
    return jx, tx


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("h,hkv", [(4, 2), (4, 1), (2, 2)])
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_and_oracle(h, hkv, window,
                                                 cache_dtype):
    """GQA / MQA / MHA, global and ring-buffer layers, f32 and bf16
    pools; windowed rows sit several laps past the window."""
    t = 8 if window else 32
    pos = [0, 9, 30, 61] if window else [0, 5, 17, 31]
    jx, tx = _operands(4, t, h, hkv, 16, cache_dtype, pos)
    o_pallas, k_pallas, v_pallas = _pallas(*jx, window=window)
    o_oracle, k_oracle, v_oracle = _oracle(*jx, window=window)
    out = ops.attention_decode(*tx, window=window)   # CPU -> plain path
    tol = tad.decode_parity_tolerance(_DTYPES[cache_dtype][1])
    for want in (o_pallas, o_oracle):
        np.testing.assert_allclose(_f32(out), _f32(want), **tol)
    # x.float() is exact for f32 and bf16, so equality is bitwise
    for want_k, want_v in ((k_pallas, v_pallas), (k_oracle, v_oracle)):
        np.testing.assert_array_equal(_f32(tx[3]), _f32(want_k))
        np.testing.assert_array_equal(_f32(tx[4]), _f32(want_v))
    assert out.dtype == torch.float32 and out.shape == (4, 1, h, 16)


def test_plain_version_bf16_query_output_dtype():
    """A bf16 query gives a bf16 output within one bf16 rounding of the
    oracle (scores and softmax still in f32)."""
    jx, tx = _operands(2, 16, 4, 2, 16, "bfloat16", [3, 15])
    jx[0] = jx[0].astype(jnp.bfloat16)
    tx[0] = tx[0].to(torch.bfloat16)
    want, _, _ = _oracle(*jx, window=None)
    out = ops.attention_decode(*tx, window=None)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(out), _f32(want),
                               **tad.decode_parity_tolerance(
                                   torch.bfloat16))


# ---------------------------------------------------------------------------
# the Hopper kernel's split plan and its algorithm, on the CPU
# ---------------------------------------------------------------------------

_TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [32, 128, 256])
def test_split_plan_covers_the_cache_without_the_batch(dh, cache_dtype):
    """The splits cover [0, T) exactly, in order, each at most L keys
    (T = 1, T < L, T not a multiple of L among them); L depends on
    (T, Dh, cache dtype) only and the grid's split axis not on B."""
    dt = _TORCH_DT[cache_dtype]
    for t in (1, 7, 15, 16, 17, 127, 128, 129, 255, 256, 257, 1000, 1024,
              2048, 4099):
        keys = tad.split_keys(t, dh, dt)
        # whole passes of the block's warps, unless one split holds T
        assert keys == t or keys % (tad.WARPS * tad.ROWS[dt]) == 0
        for grp in (1, 2, 3, 8, 16):
            plan = tad.decode_plan(t, dh, dt, grp)
            assert plan.keys == keys
            assert plan.heads in tad.HEADS_PER_BLOCK
            assert plan.heads * plan.head_groups == grp
            bounds = plan.bounds()
            assert len(bounds) == plan.splits
            assert bounds[0][0] == 0 and bounds[-1][1] == t
            for (a, b), (c, _) in zip(bounds, bounds[1:]):
                assert b == c
            assert all(0 < b - a <= keys for a, b in bounds)
            grids = {b: plan.grid(b, 8) for b in (1, 8, 64)}
            assert {g[1] for g in grids.values()} == {plan.splits}
            assert grids[64][0] == 64 * grids[1][0] == 8 * grids[8][0]


@pytest.mark.parametrize("name,dh,grp", [("gemma3-12b", 256, 2),
                                         ("qwen2.5-3b", 128, 8),
                                         ("smoke", 32, 2)])
def test_split_plan_leaves_room_for_two_blocks_per_sm(name, dh, grp):
    for t in (8, 64, 1024, 2048):
        for cache_dtype in ("float32", "bfloat16"):
            plan = tad.decode_plan(t, dh, _TORCH_DT[cache_dtype], grp)
            assert plan.smem <= tad.SMEM_LIMIT // 2, (name, plan)


def test_split_plan_at_gemma_widths():
    """gemma3-12b's phase-3 shapes: 256 keys a split in bf16 (4 local,
    8 global splits), 128 in f32."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert tad.decode_plan(1024, 256, bf16, 2).grid(8, 8) == (64, 4)
    assert tad.decode_plan(2048, 256, bf16, 2).grid(8, 8) == (64, 8)
    assert tad.decode_plan(1024, 256, f32, 2).keys == 128
    assert tad.decode_plan(2048, 256, f32, 2).splits == 16


def _key_ok(k, pos, t, window):
    """The kernel's per-key predicate (``key_valid``) for one row."""
    if window is None:
        return k <= pos
    slot = pos % t
    wraps = pos - slot
    a = k + torch.where(k <= slot, wraps, wraps - t)
    return (a >= 0) & (a <= pos) & (a > pos - window)


def _split_merge(q, new_k, new_v, k_cache, v_cache, pos, window):
    """The kernel's algorithm at the block level, in f32 on the CPU: the
    append; then per row, for every split of the plan up to the row's
    last needed key, an (m, l, acc) partial over the split's keys with
    the per-key predicate (a split past that key is empty: m = NEG_INF,
    l = 0); the partials merged in split order, empty ones skipped."""
    b, _, h, dh = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    grp = h // hkv
    plan = tad.decode_plan(t, dh, k_cache.dtype, grp)
    rows = torch.arange(b)
    slot = pos.long() % t if window is not None else pos.long()
    write = slot.clamp(0, t - 1)
    k_cache[rows, write] = new_k[:, 0].to(k_cache.dtype)
    v_cache[rows, write] = new_v[:, 0].to(v_cache.dtype)
    qg = q.float().reshape(b, hkv, grp, dh)
    out = torch.empty(b, hkv, grp, dh)
    empty = 0
    for bi in range(b):
        p = int(pos[bi])
        last = tad.last_key(p, t, window)
        parts = []
        for s0, s1 in plan.bounds():
            e = min(s1, last + 1)
            if e <= s0:
                parts.append((torch.full((hkv, grp), tad.NEG_INF),
                              torch.zeros(hkv, grp), None))
                empty += 1
                continue
            ok = _key_ok(torch.arange(s0, e), p, t, window)
            kf = k_cache[bi, s0:e].float()
            vf = v_cache[bi, s0:e].float()
            s = torch.einsum("kgd,nkd->kgn", qg[bi], kf) / math.sqrt(dh)
            m = torch.where(ok, s, tad.NEG_INF).amax(-1)
            pr = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
            parts.append((m, pr.sum(-1),
                          torch.einsum("kgn,nkd->kgd", pr, vf)))
        mm = torch.full((hkv, grp), tad.NEG_INF)
        for m, l, _ in parts:
            mm = torch.where(l > 0, torch.maximum(mm, m), mm)
        ll = torch.zeros(hkv, grp)
        acc = torch.zeros(hkv, grp, dh)
        for m, l, a in parts:
            if a is None:
                continue
            f = torch.where(l > 0, torch.exp(m - mm), 0.0)
            ll = ll + l * f
            acc = acc + a * f[..., None]
        out[bi] = acc / ll[..., None]
    return out.reshape(b, 1, h, dh).to(q.dtype), plan, empty


def _edge_positions(kind, keys, t):
    """pos = 0 (every split but the first empty), the split boundary
    L - 1, L, L + 1, T - 1, and (rings) several laps past the window."""
    if kind == "global":
        return [0, keys - 1, keys, keys + 1, t - 1, 5, t // 2, t - 2]
    return [0, keys - 1, keys, keys + 1, t - 1, t + keys, 3 * t + 5,
            9 * t - 1]


@pytest.mark.parametrize("kind,t,window,cache_dtype", [
    ("local", 1024, 1024, "bfloat16"), ("local", 1024, 1024, "float32"),
    ("global", 2048, None, "bfloat16"), ("global", 2048, None, "float32"),
    ("short-window", 512, 300, "float32")])
def test_split_and_merge_at_the_plan_matches_the_oracle(kind, t, window,
                                                        cache_dtype):
    """gemma3-12b's head dim (256) and GQA group (2) at the plan's own
    split length; outputs within ``decode_parity_tolerance`` of the JAX
    oracle, caches bitwise."""
    keys = tad.split_keys(t, 256, _TORCH_DT[cache_dtype])
    pos = _edge_positions("global" if window is None else "local", keys, t)
    jx, tx = _operands(8, t, 4, 2, 256, cache_dtype, pos, seed=t)
    want, k_want, v_want = _oracle(*jx, window=window)
    got, plan, empty = _split_merge(*tx, window=window)
    assert plan.splits > 1 and empty > 0
    np.testing.assert_allclose(_f32(got), _f32(want),
                               **tad.decode_parity_tolerance(
                                   _TORCH_DT[cache_dtype]))
    np.testing.assert_array_equal(_f32(tx[3]), _f32(k_want))
    np.testing.assert_array_equal(_f32(tx[4]), _f32(v_want))


def test_last_key_follows_the_predicate():
    """No key past ``last_key`` is valid, for global layers, rings
    before and after their first lap and windows shorter than the ring;
    ``last_key`` itself is valid (pos >= 0) except on a short window's
    ring after its first lap, where the per-key predicate decides."""
    for t, window in ((16, None), (16, 16), (16, 5), (16, 40)):
        for p in range(0, 5 * t):
            last = tad.last_key(p, t, window)
            ok = _key_ok(torch.arange(t), p, t, window)
            assert not ok[last + 1:].any(), (t, window, p)
            if window is None or window >= t or p < t:
                assert ok[last], (t, window, p)
    assert tad.last_key(-1, 16, None) < 0


def test_cuda_wrapper_refuses_bad_operands_before_building(monkeypatch):
    def no_build(name):
        raise AssertionError("must not build for a refused call")
    monkeypatch.setattr(tad._build, "load", no_build)
    _, good = _operands(2, 16, 4, 2, 16, "bfloat16", [3, 15])

    def call(**swap):
        names = ("q", "new_k", "new_v", "k_cache", "v_cache", "pos")
        args = dict(zip(names, good))
        args.update(swap)
        return tad.attention_decode_cuda(*(args[n] for n in names))

    q, nk, nv, kc, vc, pos = good
    cases = [
        ({"q": q[:, 0]}, "q must be"),
        ({"k_cache": kc[:, :, :, :8].contiguous()}, "caches must"),
        ({"new_k": nk[:, :, :1]}, "new_k/new_v must"),
        ({"pos": pos[:1]}, "pos must"),
        ({"q": torch.zeros(2, 1, 3, 16)}, "not a multiple"),
        ({"k_cache": kc.half(), "v_cache": vc.half()}, "dtypes"),
        ({"k_cache": kc.float()}, "dtypes"),
        ({"q": torch.zeros(2, 1, 4, 6), "new_k": torch.zeros(2, 1, 2, 6),
          "new_v": torch.zeros(2, 1, 2, 6),
          "k_cache": torch.zeros(2, 16, 2, 6, dtype=torch.bfloat16),
          "v_cache": torch.zeros(2, 16, 2, 6, dtype=torch.bfloat16)},
         "16 bytes"),
        ({"q": torch.zeros(2, 1, 4, 264), "new_k": torch.zeros(2, 1, 2, 264),
          "new_v": torch.zeros(2, 1, 2, 264),
          "k_cache": torch.zeros(2, 16, 2, 264),
          "v_cache": torch.zeros(2, 16, 2, 264)}, "at most"),
        ({"k_cache": kc.transpose(1, 2).contiguous().transpose(1, 2)},
         "contiguous"),
        ({}, "CUDA device"),
    ]
    for swap, match in cases:
        with pytest.raises(ValueError, match=match):
            call(**swap)
