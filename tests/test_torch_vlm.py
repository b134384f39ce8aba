"""The vlm family of the port (llama-3.2-vision-11b) against the JAX
package on the CPU, smoke config in f32 on the reference's own weights
(helpers in ``torch_family.py``). The smoke config has 2 groups of 2
self-attention layers and 1 gated cross layer. Init leaves every gate
at 0, where the image changes nothing (both packages, bitwise), so the
parity tests open the gates to ``GATE`` in both trees and feed image
embeddings drawn from a seed.

Tolerances: rtol = atol = 1e-4 in f32 on logits, caches and gradients;
the training step as ``torch_family.py`` states (1e-5 relative);
engine and ``generate`` tokens equal.

* The group layout; the closed gate; logits, loss and gradients with
  the gates open, and the image moves the logits.
* ``init_cache``'s cross K/V; the batched prefill (ragged ``lens``)
  and its cache against the reference's, then decode steps at per-row
  depths; the batched prefill's cache equal to the token-by-token one.
* The engine on one image block with a distinct row per slot gives the
  reference engine's tokens, and each request is served on row i of its
  admission batch whatever its slot (F10); the engine refuses a vlm
  without ``extra`` with the reference's error; ``launch.serve`` runs
  it on the stub frontend.
* One training step (fused TVLARS, tree and per-tensor WA-LARS); the
  segments, the f32 gate among the other leaves; the round trip;
  checkpoints across packages both ways; ``param_count()``'s
  undercount (F9); ``launch.train`` on the stub frontend.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_family as fam

from repro import serving as jserving
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro_torch import serving
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import flatten
from repro_torch.core.base import tree_leaves
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import get_model, jax_template, transformer

ARCH = "llama-3.2-vision-11b"
GATE = 0.5


def _gated():
    return fam.pair(ARCH, GATE)


def test_configs_match_reference():
    for ours, theirs in ((get_config(ARCH), jax_get_config(ARCH)),
                         (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


def test_group_layout():
    full = get_config(ARCH)
    assert transformer._group_spec(full) == (8, ["attn"] * 5 + ["cross"])
    assert len(transformer.layer_kinds(full)) == 48
    kinds = transformer.layer_kinds(get_smoke_config(ARCH))
    assert kinds == ["attn", "attn", "cross"] * 2
    _, jparams, _, params = fam.pair(ARCH)
    assert sorted(jparams["groups"]) == ["l0_attn", "l1_attn", "l2_cross"]
    for layer, kind in zip(params["layers"], kinds):
        assert ("gate" in layer) == (kind == "cross")
        assert "mlp" in layer
    gate = params["layers"][2]["gate"]
    assert gate.shape == () and gate.dtype == torch.float32 and gate == 0
    with pytest.raises(ValueError, match="cross_attn_every"):
        transformer._group_spec(full.replace(num_layers=42))


def test_closed_gate_ignores_the_image():
    """At init (gate 0) two different images give bitwise the same
    logits in both packages."""
    jmodel, jparams, model, params = fam.pair(ARCH)
    tokens = np.random.default_rng(3).integers(1, 512, (2, 12))
    jl, tl = [], []
    for seed in (0, 1):
        img = fam.extra_embeds(model.cfg, 2, seed)
        jl.append(np.asarray(jmodel.apply(
            jparams, {"tokens": jnp.asarray(tokens),
                      "extra_embeds": jnp.asarray(img)})[0]))
        tl.append(model.apply(params, torch.from_numpy(tokens),
                              torch.from_numpy(img)))
    np.testing.assert_array_equal(jl[0], jl[1])
    assert torch.equal(tl[0], tl[1])
    fam.close(tl[0], jl[0], "closed-gate logits")


def test_open_gate_logits_match_reference_and_depend_on_the_image():
    jmodel, jparams, model, params = _gated()
    tokens = np.random.default_rng(3).integers(1, 512, (2, 12))
    got = {}
    for seed in (0, 1):
        img = fam.extra_embeds(model.cfg, 2, seed)
        want, _ = jmodel.apply(jparams, {"tokens": jnp.asarray(tokens),
                                         "extra_embeds": jnp.asarray(img)})
        got[seed] = model.apply(params, torch.from_numpy(tokens),
                                torch.from_numpy(img))
        fam.close(got[seed], want, f"vlm logits, image {seed}")
    assert (got[0] - got[1]).abs().max() > 1e-3
    with pytest.raises(ValueError, match="image embeddings"):
        model.apply(params, torch.from_numpy(tokens))


def test_loss_and_grads_match_reference():
    fam.check_loss_and_grads(ARCH, extra=True, gate=GATE)


def test_remat_changes_no_number():
    _, _, model, params = _gated()
    remat = get_model(model.cfg.replace(remat=True))
    bt = fam.torch_batch(fam.batch(0, cfg=model.cfg))
    out = []
    torch.use_deterministic_algorithms(True)
    try:
        for m in (model, remat):
            leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
            loss, _ = m.loss(params, bt)
            out.append((loss, torch.autograd.grad(loss, leaves)))
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def _layer_cache(jcache: dict, cfg, j: int) -> dict:
    """The reference cache's entry of the port's layer ``j``."""
    kinds = transformer._group_spec(cfg)[1]
    g, i = divmod(j, len(kinds))
    return {k: v[g] for k, v in jcache[f"l{i}_{kinds[i]}"].items()}


def test_init_cache_cross_kv_matches_reference():
    jmodel, jparams, model, params = _gated()
    img = fam.extra_embeds(model.cfg, 2, 5)
    jcache = jmodel.init_cache(jparams, 2, 16, jnp.asarray(img))
    cache = model.init_cache(params, 2, 16, torch.from_numpy(img))
    for j, (c, kind) in enumerate(zip(cache,
                                      transformer.layer_kinds(model.cfg))):
        want = _layer_cache(jcache, model.cfg, j)
        assert set(c) == set(want) == ({"ck", "cv"} if kind == "cross"
                                       else {"k", "v"})
        for name in c:
            fam.close(c[name], want[name], f"layer {j} {name}")


def test_prefill_and_decode_match_reference():
    """Ragged right-padded prefill with the image, its cache (the cross
    K/V in the compute dtype), then decode steps at per-row depths."""
    jmodel, jparams, model, params = _gated()
    rng = np.random.default_rng(1)
    max_len, lens = 32, np.array([13, 5])
    tokens = rng.integers(1, 512, (2, 16))
    tokens[1, 5:] = 0
    img = fam.extra_embeds(model.cfg, 2, 6)
    want, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), max_len,
                                  jnp.asarray(img),
                                  jnp.asarray(lens, jnp.int32))
    got, cache = model.prefill(params, torch.from_numpy(tokens), max_len,
                               torch.from_numpy(lens),
                               extra=torch.from_numpy(img))
    fam.close(got, want, "vlm prefill logits")
    for j, c in enumerate(cache):
        for name, t in _layer_cache(jcache, model.cfg, j).items():
            fam.close(c[name], t, f"prefill cache layer {j} {name}")
    pos = lens.astype(np.int32)
    for step in range(4):
        tok = rng.integers(1, 512, (2, 1)).astype(np.int32)
        want, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tok),
                                          jnp.asarray(pos))
        got, cache = model.decode_step(params, cache, torch.from_numpy(tok),
                                       torch.from_numpy(pos))
        fam.close(got, want, f"vlm decode step {step}")
        pos = pos + 1


def test_prefill_cache_equals_token_by_token():
    """The batched prefill's cache (one forward) and the one streaming
    the prompt through ``decode_step`` hold the same K/V, and the last
    logits agree."""
    _, _, model, params = _gated()
    tokens = torch.from_numpy(
        np.random.default_rng(7).integers(1, 512, (2, 9)))
    img = torch.from_numpy(fam.extra_embeds(model.cfg, 2, 7))
    fast, fast_cache = serving.prefill(model, params, tokens, 16, img)
    slow, slow_cache = serving.decode.prefill_reference(model, params,
                                                        tokens, 16, img)
    fam.close(fast, slow.numpy(), "last logits")
    for j, (a, b) in enumerate(zip(fast_cache, slow_cache)):
        for name in a:
            fam.close(a[name], b[name].numpy(), f"layer {j} {name}")


def test_engine_matches_reference_engine_with_distinct_rows():
    """Both engines on one image block with a different row per slot:
    the same tokens. Requests 0-2 are admitted together (rows 0-2),
    request 3 alone into the slot request 1 freed, and reads row 0 of
    the block, not its slot's (F10): ``generate`` on row 0 gives its
    tokens, on its slot's row others."""
    jmodel, jparams, model, params = _gated()
    kw = dict(slots=3, max_len=32, page_size=8, prefill_batch=3)
    block = fam.extra_embeds(model.cfg, 3, 8)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 512, size=n).astype(np.int32)
               for n in (7, 5, 8, 6)]
    budget = (9, 3, 9, 6)

    def run(eng):
        ids = [eng.submit(prompts[i], max_new_tokens=budget[i])
               for i in range(3)]
        out = {}
        for _ in range(64):
            for r in eng.step():
                out[r.id] = r.tokens
            if len(ids) == 3 and len(out) == 1:
                ids.append(eng.submit(prompts[3],
                                      max_new_tokens=budget[3]))
            if len(out) == 4:
                break
        return [out[i] for i in ids]

    want = run(jserving.Engine(jmodel, jparams, jserving.ServeConfig(**kw),
                               extra=jnp.asarray(block)))
    eng = serving.Engine(model, params, serving.ServeConfig(**kw),
                         device="cpu", extra=torch.from_numpy(block))
    got = run(eng)
    assert got == want
    assert eng.stats()["kernel_launches"] == 0

    def alone(i, row):
        return serving.generate(
            model, params, prompts[i][None], num_tokens=budget[i],
            max_len=32, extra_embeds=torch.from_numpy(block[row:row + 1]),
            device="cpu")[0].tolist()

    assert [alone(i, i) for i in range(3)] == got[:3]
    assert alone(3, 0) == got[3]           # slot 1, row 0 of its batch
    assert alone(3, 1) != got[3]


def test_engine_refuses_vlm_without_extra():
    jmodel, jparams, model, params = fam.pair(ARCH)
    with pytest.raises(ValueError) as want:
        jserving.Engine(jmodel, jparams, jserving.ServeConfig())
    with pytest.raises(ValueError) as got:
        serving.Engine(model, params, serving.ServeConfig(), device="cpu")
    assert str(got.value) == str(want.value)
    assert "extra-embeddings frontend" in str(got.value)


def test_launch_serve_on_cpu(capsys):
    launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "8",
                       "--num-tokens", "4", "--slots", "2",
                       "--page-size", "8"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "sample:" in out


@pytest.mark.parametrize("name,use_kernel", [
    ("tvlars", "fused"), ("wa-lars", False), ("wa-lars", "per_tensor")])
def test_train_step_matches_reference(name, use_kernel):
    fam.check_train_step(ARCH, name, use_kernel, extra=True, gate=GATE)


def test_segments_are_the_reference_leaves():
    """The reference's order, the cross group last; its gate is one
    [G] f32 segment, PLAIN, among bf16 leaves in a bf16 tree."""
    fam.check_segments(ARCH)
    _, _, model, params = fam.pair(ARCH, param_dtype="bfloat16")
    spec = flatten.build_spec(params, segments=model.segments)
    names = list(spec.names)
    k = names.index("groups/l2_cross/gate")
    assert spec.shapes[k] == (2,) and not spec.adapt[k]
    assert names[k - 1] == "groups/l2_cross/attn/wv"
    assert params["layers"][2]["gate"].dtype == torch.float32
    assert params["layers"][2]["attn"]["wq"].dtype == torch.bfloat16
    assert names.index("groups/l1_attn/norm2/scale") < names.index(
        "groups/l2_cross/attn/wk")


def test_params_round_trip():
    fam.check_round_trip(ARCH)


def test_checkpoint_crosses_packages(tmp_path):
    fam.check_checkpoint_both_ways(ARCH, tmp_path)


def test_param_count_undercounts_the_tree():
    """F9: ``param_count()`` leaves out the cross layers' MLPs and
    gates; the tree is what trains and serves."""
    cfg = get_config(ARCH)
    tree = sum(t.numel() for t in tree_leaves(jax_template(cfg)))
    assert (tree, cfg.param_count()) == (11_520_053_256, 10_110_767_104)


def test_launch_train_on_cpu():
    before = dict(ops.launches)
    out = launch_train.run(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--seq", "16", "--steps", "2", "--global-batch",
                            "4", "--microbatch", "2", "--use-kernel",
                            "fused"], log_fn=lambda *_: None)
    assert ops.launches == before
    assert np.all(np.isfinite(out["losses"])) and len(out["losses"]) == 2
