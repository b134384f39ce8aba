"""Whole-model parity: ``repro_torch`` against the JAX package on the
reference's own weights (``get_model(cfg).init(PRNGKey(0))``, carried
across with ``params_from_jax``), smoke configs in f32 on the CPU.

Covered for gemma3-12b (5:1 -> 1:1 local:global at smoke size, window 8),
qwen2.5-3b (QKV bias, SwiGLU, all-global), codeqwen1.5-7b (full MHA:
one query head per KV head) and qwen2-72b (GQA 4:1 at smoke size): ``apply_lm`` logits,
``apply_lm_prefill`` logits and KV cache with ragged ``lens`` including
prompts longer than the window, and a chain of ``decode_lm`` steps.
Tolerance: rtol = atol = 1e-4 in f32 (two libraries summing in
different orders through a few layers).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model, params_from_jax
from repro_torch.models.transformer import _group_spec

TOL = {"rtol": 1e-4, "atol": 1e-4}
ARCHS = ["gemma3-12b", "qwen2.5-3b", "codeqwen1.5-7b", "qwen2-72b"]


def _pair(arch):
    jmodel = jax_get_model(jax_smoke_config(arch))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jmodel, jparams, get_model(cfg), \
        params_from_jax(cfg, tree, device="cpu")


def _close(got, want, what):
    got, want = got.numpy(), np.asarray(want)
    err = float(np.max(np.abs(got - want)))
    print(f"{what}: max |diff| = {err:.3e}")
    np.testing.assert_allclose(got, want, err_msg=what, **TOL)


def _jax_layer_cache(jcache, cfg, idx):
    groups, kinds = _group_spec(cfg)
    g, i = divmod(idx, len(kinds))
    return jcache[f"l{i}_{kinds[i]}"], g


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_lm_logits(arch):
    jmodel, jparams, model, params = _pair(arch)
    tokens = np.random.RandomState(0).randint(1, 512, (2, 12))
    want, _ = jmodel.apply(jparams, {"tokens": jnp.asarray(tokens)})
    got = model.apply(params, torch.from_numpy(tokens))
    _close(got, want, f"{arch} apply_lm logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_decode_chain(arch):
    """Ragged right-padded prefill (row 0 longer than gemma3's window of
    8, row 1 shorter), then five decode steps at per-row depths."""
    jmodel, jparams, model, params = _pair(arch)
    rng = np.random.RandomState(1)
    max_len, lens = 32, np.array([13, 5])
    tokens = rng.randint(1, 512, (2, 16))
    tokens[1, 5:] = 0
    want, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), max_len,
                                  None, jnp.asarray(lens, jnp.int32))
    got, cache = model.prefill(params, torch.from_numpy(tokens), max_len,
                               torch.from_numpy(lens))
    _close(got, want, f"{arch} prefill logits")
    for idx, c in enumerate(cache):
        jc, g = _jax_layer_cache(jcache, model.cfg, idx)
        for name in ("k", "v"):
            _close(c[name], jc[name][g], f"{arch} prefill cache "
                   f"layer {idx} {name}")

    # logits_at picks the same rows out of the full logits
    last, _ = model.prefill(params, torch.from_numpy(tokens), max_len,
                            torch.from_numpy(lens),
                            logits_at=torch.from_numpy(lens - 1))
    np.testing.assert_array_equal(last[:, 0].numpy(),
                                  got[np.arange(2), lens - 1].numpy())

    pos = lens.astype(np.int32)
    for step in range(5):
        tok = rng.randint(1, 512, (2, 1)).astype(np.int32)
        want, jcache = jmodel.decode_step(jparams, jcache,
                                          jnp.asarray(tok),
                                          jnp.asarray(pos))
        got, cache = model.decode_step(params, cache,
                                       torch.from_numpy(tok),
                                       torch.from_numpy(pos))
        _close(got, want, f"{arch} decode step {step} logits")
        pos = pos + 1
    for idx, c in enumerate(cache):
        jc, g = _jax_layer_cache(jcache, model.cfg, idx)
        for name in ("k", "v"):
            _close(c[name], jc[name][g], f"{arch} cache after decode "
                   f"layer {idx} {name}")


def test_param_count_and_layouts_match_reference():
    for arch in ARCHS:
        assert get_smoke_config(arch).param_count() == \
            jax_smoke_config(arch).param_count()
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    full = get_config("gemma3-12b")
    assert full.param_count() == jax_get_config("gemma3-12b").param_count()
    assert full.pdtype == torch.bfloat16 and full.kv_dtype == torch.bfloat16
    _, jparams, _, params = _pair("gemma3-12b")
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(jparams))
    n_port = sum(p.numel() for p in jax.tree_util.tree_leaves(params))
    assert n_port == n_jax == get_smoke_config("gemma3-12b").param_count()


@pytest.mark.parametrize("arch,count", [("codeqwen1.5-7b", 8_189_644_800),
                                        ("qwen2-72b", 72_705_384_448)])
def test_dense_configs_match_reference(arch, count):
    """Every field of the full and smoke configs equals the
    reference's (the port has no ``use_decode_kernel``: it picks the
    kernel by the tensors' device); the full parameter counts are the
    published ones."""
    import dataclasses

    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ARCH_IDS
    for ours, theirs in ((get_config(arch), jax_get_config(arch)),
                         (get_smoke_config(arch), jax_smoke_config(arch))):
        names = {f.name for f in dataclasses.fields(ours)}
        assert {f.name for f in dataclasses.fields(theirs)} - names == {
            "use_decode_kernel"}
        for name in names:
            assert getattr(ours, name) == getattr(theirs, name), name
        assert ours.param_count() == theirs.param_count()
    assert get_config(arch).param_count() == count
    assert arch in ARCH_IDS and len(ARCH_IDS) == 10
