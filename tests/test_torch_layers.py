"""Layer parity: ``repro_torch.models.layers`` against
``repro.models.layers`` on the same numpy inputs and the reference's own
initialised weights, all in f32 on the CPU.

Tolerances: elementwise ops (rmsnorm, rope) 1e-5; contractions (mlp,
attention) 1e-5 relative with a 1e-5 absolute floor: both sides sum in
f32, in a different order.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.kernels import ref as jax_ref
from repro.models import layers as jl
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.attention_decode import decode_parity_tolerance
from repro_torch.models import layers as tl

TOL = {"rtol": 1e-5, "atol": 1e-5}


def _t(tree):
    """JAX pytree -> the same nesting of torch tensors (a copy)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_rmsnorm():
    x = _randn(2, 5, 64)
    scale = _randn(64, seed=1) * 0.1
    want = jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    got = tl.rmsnorm({"scale": torch.from_numpy(scale)},
                     torch.from_numpy(x), 1e-6)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_rope_large_positions():
    x = _randn(2, 7, 4, 32)
    pos = np.random.RandomState(2).randint(0, 5000, (2, 7))
    want = jl.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = tl.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("arch", ["gemma3-12b", "qwen2.5-3b"])
def test_mlp(arch):
    """gemma3: tanh-approximated gelu; qwen2.5: SwiGLU."""
    jcfg = jax_smoke_config(arch)
    params = jl.init_mlp(jcfg, jax.random.PRNGKey(0))
    x = _randn(2, 6, jcfg.d_model)
    want = jl.mlp(params, jcfg, jnp.asarray(x))
    got = tl.mlp(_t(params), get_smoke_config(arch), torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _attn_cfgs(qkv_bias=False):
    kw = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
              qkv_bias=qkv_bias)
    return JaxModelConfig(**kw), ModelConfig(**kw)


@pytest.mark.parametrize("s,window", [(13, None), (13, 8), (1024, None),
                                      (1024, 100)])
def test_prefill_attention_with_kv(s, window):
    """Full-sequence attention with the lazy causal/window mask; s=1024
    takes the Q_CHUNK=512 query-chunk loop (s % 512 == 0)."""
    jcfg, tcfg = _attn_cfgs(qkv_bias=True)
    params = jl.init_attention(jcfg, jax.random.PRNGKey(1))
    x = _randn(1, s, 64, seed=3)
    pos = np.arange(s)[None]
    mask = ("causal", window)
    want, (wk, wv) = jl.attention(params, jcfg, jnp.asarray(x),
                                  jnp.asarray(pos), mask, return_kv=True)
    got, (gk, gv) = tl.attention(_t(params), tcfg, torch.from_numpy(x),
                                 torch.from_numpy(pos), mask,
                                 return_kv=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(gk), _np(wk), **TOL)
    np.testing.assert_allclose(_np(gv), _np(wv), **TOL)


def test_gqa_scores_apply_decode_branch_explicit_mask():
    """One query against a cache with an additive [B,1,1,T] mask."""
    q, k, v = _randn(2, 1, 4, 16), _randn(2, 10, 2, 16, seed=1), \
        _randn(2, 10, 2, 16, seed=2)
    ok = np.arange(10)[None, :] <= np.array([[3], [9]])
    mask = np.where(ok, 0.0, -2.0e38).astype(np.float32)[:, None, None, :]
    want = jl.gqa_scores_apply(*map(jnp.asarray, (q, k, v, mask)))
    got = tl.gqa_scores_apply(*map(torch.from_numpy, (q, k, v, mask)))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("window,t,pos", [
    (None, 32, [0, 5, 31]),          # global, vector pos
    (8, 8, [2, 29, 17]),             # ring buffer, deep wrap
    (8, 8, 19),                      # scalar pos
])
def test_attention_decode(window, t, pos):
    """Projections + RoPE + ops.attention_decode (plain version on the
    CPU) against the reference's jnp decode. The caches are appended in
    place: rows the step did not write stay bitwise equal; the written
    row holds a projection computed by each library (TOL)."""
    jcfg, tcfg = _attn_cfgs()
    params = jl.init_attention(jcfg, jax.random.PRNGKey(0))
    x = _randn(3, 1, 64, seed=1)
    kc, vc = _randn(3, t, 2, 16, seed=2), _randn(3, t, 2, 16, seed=3)
    jpos = jnp.asarray(pos, jnp.int32)
    want, wk, wv = jl.attention_decode(params, jcfg, jnp.asarray(x),
                                       jnp.asarray(kc), jnp.asarray(vc),
                                       jpos, window=window)
    tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
    tpos = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) \
        else pos
    got = tl.attention_decode(_t(params), tcfg, torch.from_numpy(x), tk,
                              tv, tpos, window=window)
    tol = jax_ref.decode_parity_tolerance(jnp.float32)
    assert tol == decode_parity_tolerance(torch.float32)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    rows = np.arange(3)
    slot = np.broadcast_to(np.asarray(pos) % t if window else pos, (3,))
    written = np.zeros((3, t), bool)
    written[rows, slot] = True
    for g, w in ((tk, wk), (tv, wv)):
        g, w = _np(g), _np(w)
        np.testing.assert_array_equal(g[~written], w[~written])
        np.testing.assert_allclose(g[written], w[written], **TOL)


def test_embed_unembed():
    jcfg = jax_smoke_config("gemma3-12b")
    params = jl.init_embedding(jcfg, jax.random.PRNGKey(4))
    tokens = np.random.RandomState(5).randint(0, jcfg.vocab_size, (2, 9))
    tcfg = get_smoke_config("gemma3-12b")
    want_x = jl.embed(params, jcfg, jnp.asarray(tokens))
    got_x = tl.embed(_t(params), tcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(got_x), _np(want_x), **TOL)
    want = jl.unembed(params, jcfg, want_x)
    got = tl.unembed(_t(params), tcfg, got_x)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
