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
