"""Serving parity of the port on the CPU (plain decode attention):

* the port's engine == the port's ``generate``, token for token, under
  greedy sampling with staggered arrivals and windowed ring wrap;
* the port's engine greedy tokens == the JAX engine's on the same
  weights (carried across with ``params_from_jax``);
* batched prefill == the token-by-token reference loop;
* page-table accounting, page reuse after eviction, config validation.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro import serving as jax_serving
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro_torch import serving
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model, params_from_jax


def _model(arch="qwen2.5-3b"):
    model = get_model(get_smoke_config(arch))
    return model, model.init(0, device="cpu")


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 512, size=n).astype(np.int32) for n in lens]


def _run_staggered(eng, prompts, new, arrive):
    """Submit per the arrival schedule {step: [idx]}, step to drain."""
    ids, results = {}, {}
    t = 0
    while len(results) < len(prompts):
        for i in arrive.get(t, []):
            ids[i] = eng.submit(prompts[i], max_new_tokens=new[i])
        for r in eng.step():
            results[r.id] = r
        t += 1
        assert t < 10_000, "engine failed to drain"
    return {i: results[rid].tokens for i, rid in ids.items()}


SCHEDULE = {0: [0, 1], 2: [2, 3], 5: [4]}
LENS, NEW = (5, 9, 3, 12, 7), [6, 4, 8, 5, 7]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma3-12b"])
def test_engine_matches_generate_staggered(arch):
    """gemma3's smoke window is 8, so prompts of 9 and 12 ring-pack at
    prefill and every row wraps the ring during decode."""
    model, params = _model(arch)
    sc = serving.ServeConfig(slots=3, max_len=64, page_size=8,
                             prefill_batch=2)
    eng = serving.Engine(model, params, sc, device="cpu")
    prompts = _prompts(LENS)
    got = _run_staggered(eng, prompts, NEW, SCHEDULE)
    for i, p in enumerate(prompts):
        want = serving.generate(model, params, p[None],
                                num_tokens=NEW[i], max_len=sc.max_len,
                                device="cpu")
        assert got[i] == want[0].tolist(), f"req {i}"
    assert eng.stats()["kernel_launches"] == 0      # plain path on CPU


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma3-12b",
                                  "codeqwen1.5-7b", "qwen2-72b"])
def test_engine_matches_jax_engine(arch):
    jmodel = jax_get_model(jax_smoke_config(arch))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = get_model(get_smoke_config(arch))
    params = params_from_jax(model.cfg,
                             jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    kw = dict(slots=3, max_len=64, page_size=8, prefill_batch=2)
    prompts = _prompts(LENS, seed=7)
    want = _run_staggered(
        jax_serving.Engine(jmodel, jparams, jax_serving.ServeConfig(**kw)),
        prompts, NEW, SCHEDULE)
    got = _run_staggered(
        serving.Engine(model, params, serving.ServeConfig(**kw),
                       device="cpu"),
        prompts, NEW, SCHEDULE)
    assert got == want


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma3-12b"])
def test_batched_prefill_matches_reference_loop(arch):
    model, params = _model(arch)
    tokens = torch.from_numpy(np.stack(_prompts((11, 11), seed=3)))
    fast, fast_cache = serving.prefill(model, params, tokens, 32)
    ref, ref_cache = serving.prefill_reference(model, params, tokens, 32)
    np.testing.assert_allclose(fast.numpy(), ref.numpy(), atol=1e-5)
    tok = torch.argmax(fast[:, -1:], -1).to(torch.int32)
    fast_next, _ = model.decode_step(params, fast_cache, tok, 11)
    ref_next, _ = model.decode_step(params, ref_cache, tok, 11)
    np.testing.assert_allclose(fast_next.numpy(), ref_next.numpy(),
                               atol=1e-5)


def test_page_reuse_after_eviction():
    model, params = _model()
    sc = serving.ServeConfig(slots=2, max_len=32, page_size=8,
                             prefill_batch=2)
    eng = serving.Engine(model, params, sc, device="cpu")
    prompts = _prompts((12, 12, 12))

    rid = eng.submit(prompts[0], max_new_tokens=8)
    for _ in range(3):
        eng.step()
    assert eng._kv.table.pages_used() >= 2           # 12 tokens, 8/page
    eng.evict(rid)
    assert eng._kv.table.pages_used() == 0
    assert eng._kv.table.free_pages == eng._kv.table.total_pages

    before = eng._kv.table.reused_pages
    eng.submit(prompts[1], max_new_tokens=4)
    eng.drain()
    assert eng._kv.table.reused_pages > before

    # and serves exactly what a fresh engine would (stale KV unreachable)
    fresh = serving.Engine(model, params, sc, device="cpu")
    r2 = fresh.submit(prompts[2], max_new_tokens=6)
    fresh.drain()
    r1 = eng.submit(prompts[2], max_new_tokens=6)
    eng.drain()
    assert eng.result(r1).tokens == fresh.result(r2).tokens


def test_page_table_accounting():
    t = serving.PageTable(slots=2, pages_per_slot=4, page_size=8)
    assert t.ensure(0, 12) == [0, 1]
    assert t.ensure(0, 13) == []                 # still page 1
    assert t.ensure(0, 17) == [2]
    assert t.pages_used(0) == 3 and t.free_pages == 5
    with pytest.raises(ValueError):
        t.ensure(1, 33)                          # beyond the slot
    assert t.release(0) == [0, 1, 2]
    assert t.ensure(0, 9) == [0, 1] and t.reused_pages == 2


def test_serve_config_validation():
    with pytest.raises(ValueError):
        serving.ServeConfig(max_len=30, page_size=16)
    with pytest.raises(ValueError):
        serving.ServeConfig(slots=0)
    with pytest.raises(ValueError):
        serving.ServeConfig(cache_dtype="int3")
    with pytest.raises(ValueError):
        serving.SamplingParams(temperature=-1.0)
    model, params = _model()
    eng = serving.Engine(model, params, serving.ServeConfig(
        slots=1, max_len=32, page_size=8), device="cpu")
    with pytest.raises(ValueError):
        eng.submit(np.arange(30), max_new_tokens=8)   # exceeds max_len
    with pytest.raises(ValueError):
        eng.submit([], max_new_tokens=1)


def test_temperature_sampling_is_seeded():
    """Sampled tokens come from a torch.Generator seeded by
    SamplingParams.seed: same seed, same tokens."""
    model, params = _model()
    sc = serving.ServeConfig(slots=2, max_len=32, page_size=8,
                             sampling=serving.SamplingParams(
                                 temperature=1.0, top_k=5, seed=3))
    runs = []
    for _ in range(2):
        eng = serving.Engine(model, params, sc, device="cpu")
        ids = [eng.submit(p, max_new_tokens=5) for p in _prompts((4, 6))]
        eng.drain()
        runs.append([eng.result(i).tokens for i in ids])
    assert runs[0] == runs[1]
    assert all(0 <= t < 512 for toks in runs[0] for t in toks)
