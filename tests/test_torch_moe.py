"""The MoE family of the port (olmoe-1b-7b, qwen3-moe-30b-a3b) against
the JAX package on the CPU, smoke configs in f32 on the reference's own
weights (helpers in ``torch_family.py``).

* ``moe_apply``: output, load-balance and z losses within 1e-4, and the
  routing decisions (top-k experts, keep mask, slots) EQUAL to the
  reference's, at the smoke capacity factor (no drops) and at 1.0,
  where tokens are dropped and a dropped entry shares slot 0 with the
  kept token that holds it; ties in the router's probabilities go to
  the lower expert index, as ``jax.lax.top_k``'s do; ``moe_capacity``
  at the reference test's values.
* The LM: logits, the summed aux losses and their gradients; the
  batched prefill with ragged ``lens`` and decode steps; the engine at
  bucket-aligned prompts gives the JAX engine's tokens.
* One training step (fused TVLARS, tree and per-tensor WA-LARS) against
  the reference's; segment names and order; ``params_to_jax`` /
  ``params_from_jax`` round trip; a checkpoint across packages both
  ways.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_family as fam

from repro import serving as jserving
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro_torch import serving
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import moe

ARCHS = ["olmoe-1b-7b", "qwen3-moe-30b-a3b"]


def _reference_routing(params, cfg, x):
    """The reference's routing decisions, computed by its own lines
    (``repro/models/moe.py:76-89``) on the same inputs."""
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = jmoe.moe_capacity(s, cfg)
    logits = x.astype(jnp.float32) @ params["router"]
    probs = jax.nn.softmax(logits, axis=-1)
    _, topk_idx = jax.lax.top_k(probs, k)
    fa = jax.nn.one_hot(topk_idx, e, dtype=jnp.int32).reshape(b, s * k, e)
    pos = jnp.sum((jnp.cumsum(fa, axis=1) - fa) * fa, axis=-1)
    keep = pos < cap
    slot = topk_idx.reshape(b, s * k) * cap + jnp.where(keep, pos, 0)
    return [np.asarray(a) for a in (topk_idx, keep, slot)]


@pytest.mark.parametrize("capacity_factor", [1.25, 1.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_and_routing_match_reference(arch, capacity_factor):
    jcfg = jax_smoke_config(arch).replace(capacity_factor=capacity_factor)
    cfg = get_smoke_config(arch).replace(capacity_factor=capacity_factor)
    jparams = jmoe.init_moe(jcfg, jax.random.PRNGKey(0))
    params = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    x = np.random.default_rng(0).normal(size=(3, 16, cfg.d_model)) \
        .astype(np.float32)
    want, jaux = jmoe.moe_apply(jparams, jcfg, jnp.asarray(x))
    got, aux = moe.moe_apply(params, cfg, torch.from_numpy(x))
    fam.close(got, want, f"{arch} moe_apply")
    for a, j in zip(aux, jaux):
        np.testing.assert_allclose(float(a), float(j), rtol=1e-5)

    r = moe.route(params, cfg, torch.from_numpy(x))
    idx, keep, slot = _reference_routing(jparams, jcfg, jnp.asarray(x))
    np.testing.assert_array_equal(r.topk_idx.numpy(), idx)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    dropped = int((~r.keep).sum())
    if capacity_factor == 1.0:
        assert dropped > 0
        # every dropped entry points at slot expert*cap + 0, which a
        # kept token of its row holds: dispatch must add, not assign
        for row in range(x.shape[0]):
            kept = set(r.slot[row][r.keep[row]].tolist())
            drops = r.slot[row][~r.keep[row]].tolist()
            assert all(s % r.cap == 0 and s in kept for s in drops)
    else:
        assert dropped == 0


def test_router_ties_go_to_the_lower_expert_index():
    """Equal router probabilities: the reference's ``jax.lax.top_k``
    takes the lower index first, and so does the port's stable sort
    (``torch.topk`` does not on the CPU)."""
    cfg = get_smoke_config("olmoe-1b-7b")
    params = {"router": torch.zeros(cfg.d_model, cfg.num_experts)}
    x = torch.randn(2, 8, cfg.d_model)
    r = moe.route(params, cfg, x)
    _, want = jax.lax.top_k(jnp.full((2, 8, cfg.num_experts),
                                     1.0 / cfg.num_experts),
                            cfg.experts_per_token)
    np.testing.assert_array_equal(r.topk_idx.numpy(), np.asarray(want))
    assert r.topk_idx[0, 0].tolist() == list(range(cfg.experts_per_token))


@pytest.mark.parametrize("tokens,experts,k,cf,cap", [
    (16, 4, 2, 1.0, 8), (4096, 128, 8, 1.25, 320), (1, 64, 8, 1.25, 1),
    (1, 128, 8, 1.25, 1), (512, 64, 8, 1.25, 80), (1024, 128, 8, 1.25, 80)])
def test_moe_capacity_matches_reference(tokens, experts, k, cf, cap):
    from repro.configs.base import ModelConfig as JCfg
    from repro_torch.configs.base import ModelConfig
    kw = dict(num_experts=experts, experts_per_token=k, capacity_factor=cf)
    assert moe.moe_capacity(tokens, ModelConfig(**kw)) == cap \
        == jmoe.moe_capacity(tokens, JCfg(**kw))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_match_reference(arch):
    import dataclasses

    from repro.configs import get_config as jax_get_config
    ours, theirs = get_config(arch), jax_get_config(arch)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert moe.moe_capacity(1, ours) == 1      # a decode step drops none


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_logits_match_reference(arch):
    jmodel, jparams, model, params = fam.pair(arch)
    tokens = np.random.default_rng(3).integers(1, 512, (2, 12))
    want, jaux = jmodel.apply(jparams, {"tokens": jnp.asarray(tokens)})
    fam.close(model.apply(params, torch.from_numpy(tokens)), want,
              f"{arch} logits")
    assert float(jaux.load_balance_loss) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_grads_match_reference(arch):
    aux = fam.check_loss_and_grads(arch)
    # summed over the 2 layers, not averaged: each layer's lb is ~1
    assert float(aux.load_balance_loss.detach()) > 1.5
    assert float(aux.router_z_loss.detach()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Ragged right-padded prefill, its KV cache, then decode steps at
    per-row depths (one token a row: capacity 1, nothing dropped)."""
    jmodel, jparams, model, params = fam.pair(arch)
    rng = np.random.default_rng(1)
    max_len, lens = 32, np.array([13, 5])
    tokens = rng.integers(1, 512, (2, 16))
    tokens[1, 5:] = 0
    want, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), max_len,
                                  None, jnp.asarray(lens, jnp.int32))
    got, cache = model.prefill(params, torch.from_numpy(tokens), max_len,
                               torch.from_numpy(lens))
    fam.close(got, want, f"{arch} prefill logits")
    for idx, c in enumerate(cache):
        for name in ("k", "v"):
            fam.close(c[name], jcache["l0_attn"][name][idx],
                      f"{arch} prefill cache {idx} {name}")
    pos = lens.astype(np.int32)
    for step in range(4):
        tok = rng.integers(1, 512, (2, 1)).astype(np.int32)
        want, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tok),
                                          jnp.asarray(pos))
        got, cache = model.decode_step(params, cache, torch.from_numpy(tok),
                                       torch.from_numpy(pos))
        fam.close(got, want, f"{arch} decode step {step}")
        pos = pos + 1


def test_engine_matches_jax_engine_at_bucket_aligned_prompts():
    """Capacity drops depend on the padded length, so the engines are
    held at prompts already on the pow2 / page buckets (8 = page_size),
    staggered as ``tests/test_serving.py``'s MoE test."""
    jmodel, jparams, model, params = fam.pair("olmoe-1b-7b")
    kw = dict(slots=2, max_len=32, page_size=8, prefill_batch=2)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 512, size=8).astype(np.int32)
               for _ in range(3)]

    def run(eng):
        ids = {}
        for i in (0, 1):
            ids[i] = eng.submit(prompts[i], max_new_tokens=5)
        out = {}
        for t in range(64):
            if t == 3:
                ids[2] = eng.submit(prompts[2], max_new_tokens=5)
            for r in eng.step():
                out[r.id] = r.tokens
            if len(out) == 3:
                break
        return [out[ids[i]] for i in range(3)]

    want = run(jserving.Engine(jmodel, jparams, jserving.ServeConfig(**kw)))
    got = run(serving.Engine(model, params, serving.ServeConfig(**kw),
                             device="cpu"))
    assert got == want
    alone = serving.generate(model, params, prompts[0][None],
                             num_tokens=5, max_len=32, device="cpu")
    assert alone[0].tolist() == got[0]


@pytest.mark.parametrize("name,use_kernel", [
    ("tvlars", "fused"), ("wa-lars", False), ("wa-lars", "per_tensor")])
def test_train_step_matches_reference(name, use_kernel):
    fam.check_train_step("olmoe-1b-7b", name, use_kernel)


@pytest.mark.parametrize("arch", ARCHS)
def test_segments_are_the_reference_leaves(arch):
    fam.check_segments(arch)


def test_params_round_trip():
    fam.check_round_trip("qwen3-moe-30b-a3b")


def test_checkpoint_crosses_packages(tmp_path):
    fam.check_checkpoint_both_ways("olmoe-1b-7b", tmp_path)
