"""The encdec family of the port (whisper-large-v3) against the JAX
package on the CPU, smoke config in f32 on the reference's own weights
(helpers in ``torch_family.py``), every input that needs frames fed
normal draws from a seed.

Tolerances: rtol = atol = 1e-4 in f32 on logits, caches and gradients
(two libraries summing in other orders through a few layers); LayerNorm
alone 1e-5 in f32 and BITWISE in bf16 (the port rounds where the
reference rounds: the f32 statistics, then the mean and rsqrt cast to
x's dtype before (x - mean) * inv); the training step as
``torch_family.py`` states (1e-5 relative).

* The layers: LayerNorm (f32, bf16), the GELU MLP, cross-attention.
* The model: logits, loss and gradients on random frames, and the
  frames move the logits (zero frames leave the cross path idle: the
  encoder's output and every cross K/V are 0 in both packages, and
  its gradient explodes alike in both, F11);
  ``init_cache``'s per-layer cross K/V; the token-by-token prefill, a
  chain of decode steps and ``generate``'s tokens; the engine refuses
  the family with the reference's error (no batched prefill), and so
  does ``launch.serve``.
* One training step (fused TVLARS, tree and per-tensor WA-LARS); the
  segment names and ADAPT / PLAIN classes; the round trip; checkpoints
  across packages both ways; ``param_count()``'s undercount (F9);
  ``launch.train`` on the stub frontend.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401  (autouse)
import torch_family as fam

from repro import serving as jserving
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.models import layers as JL
from repro_torch import serving
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import flatten
from repro_torch.core.base import tree_leaves
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import get_model, jax_template, params_from_jax
from repro_torch.models import layers as L

ARCH = "whisper-large-v3"


def test_configs_match_reference():
    for ours, theirs in ((get_config(ARCH), jax_get_config(ARCH)),
                         (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert get_config(ARCH).norm_eps == 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """f32 within 1e-5; bf16 bitwise (0 ulp), which ``F.layer_norm``
    (a two-pass variance, one rounding) is not."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 33, 256)) * 3 + 1.5).astype(np.float32)
    scale, bias = rng.normal(size=(2, 256)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = JL.layernorm({"scale": jnp.asarray(scale, jdt),
                         "bias": jnp.asarray(bias, jdt)},
                        jnp.asarray(x, jdt), 1e-5)
    p = {"scale": torch.from_numpy(scale).to(tdt),
         "bias": torch.from_numpy(bias).to(tdt)}
    got = L.layernorm(p, torch.from_numpy(x).to(tdt), 1e-5)
    assert got.dtype == tdt
    if dtype == "float32":
        fam.close(got, want, "layernorm f32", {"rtol": 1e-5, "atol": 1e-5})
        return
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    lib = torch.nn.functional.layer_norm(torch.from_numpy(x).to(tdt),
                                         (256,), p["scale"], p["bias"],
                                         1e-5)
    assert not torch.equal(lib, got)


def test_init_norm_is_the_configs():
    cfg = get_smoke_config(ARCH)
    p = L.init_norm(cfg, 8, "cpu")
    assert set(p) == {"scale", "bias"}
    assert torch.equal(p["scale"], torch.ones(8))
    assert torch.equal(p["bias"], torch.zeros(8))
    assert set(L.init_norm(get_smoke_config("qwen2.5-3b"), 8, "cpu")) == \
        {"scale"}


def test_gelu_mlp_and_cross_attention_match_reference():
    _, jparams, model, params = fam.pair(ARCH)
    cfg, jcfg = model.cfg, jax_smoke_config(ARCH)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 10, cfg.d_model)).astype(np.float32)
    src = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    layer = params["decoder"][1]
    jlayer = {k: {n: v[1] for n, v in sub.items()}
              for k, sub in jparams["decoder"].items()}
    assert set(layer["mlp"]) == {"wi", "wo"}
    fam.close(L.mlp(layer["mlp"], cfg, torch.from_numpy(x)),
              JL.mlp(jlayer["mlp"], jcfg, jnp.asarray(x)), "gelu mlp")
    pos = np.broadcast_to(np.arange(10)[None], (2, 10))
    want = JL.attention(jlayer["cross_attn"], jcfg, jnp.asarray(x),
                        jnp.asarray(pos), None, kv_src=jnp.asarray(src),
                        use_rope=False)
    got = L.attention(layer["cross_attn"], cfg, torch.from_numpy(x),
                      torch.from_numpy(pos.copy()), None,
                      kv_src=torch.from_numpy(src), use_rope=False)
    fam.close(got, want, "cross-attention")


def test_apply_matches_reference_and_depends_on_frames():
    jmodel, jparams, model, params = fam.pair(ARCH)
    tokens = np.random.default_rng(3).integers(1, 512, (2, 16))
    logits = {}
    for seed in (0, 1):
        frames = fam.extra_embeds(model.cfg, 2, seed)
        want, _ = jmodel.apply(jparams, {"tokens": jnp.asarray(tokens),
                                         "extra_embeds": jnp.asarray(frames)})
        got = model.apply(params, torch.from_numpy(tokens),
                          torch.from_numpy(frames))
        fam.close(got, want, f"encdec logits, frames {seed}")
        logits[seed] = got
    assert (logits[0] - logits[1]).abs().max() > 1e-3
    with pytest.raises(ValueError, match="frame embeddings"):
        model.apply(params, torch.from_numpy(tokens))


def test_zero_frames_leave_the_cross_path_idle():
    """The launchers' stub frontend (zeros): LayerNorm of 0 is its bias
    (0 at init), so the encoder's output and every cross K/V are 0 in
    both packages."""
    jmodel, jparams, model, params = fam.pair(ARCH)
    zeros = np.zeros((2, 24, model.cfg.d_model), np.float32)
    jcache = jmodel.init_cache(jparams, 2, 8, jnp.asarray(zeros))
    cache = model.init_cache(params, 2, 8, torch.from_numpy(zeros))
    assert not np.asarray(jcache["ck"]).any()
    for c in cache:
        assert not c["ck"].any() and not c["cv"].any()


def test_zero_frames_blow_up_the_gradient_like_the_reference():
    """F11: on zero frames every encoder row has zero variance, so each
    LayerNorm's backward scales by rsqrt(eps) (316 at eps 1e-5); at
    full width the gradient is 5 orders of magnitude above the one on
    random frames after 2 + 2 layers (and overflows bf16 at full
    depth), in both packages alike (f32, 1e-4 relative)."""
    edit = dict(num_layers=2, encoder_layers=2, encoder_seq=16,
                vocab_size=512, param_dtype="float32",
                compute_dtype="float32", remat=False)
    jmodel = jax_get_model(jax_get_config(ARCH).replace(**edit))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH).replace(**edit)
    model = get_model(cfg)
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                             device="cpu")
    rng = np.random.default_rng(0)
    bt = {"tokens": rng.integers(1, 512, (2, 8)),
          "labels": rng.integers(1, 512, (2, 8))}
    norms = []
    for frames in (np.zeros((2, 16, 1280), np.float32),
                   rng.normal(size=(2, 16, 1280)).astype(np.float32)):
        b = dict(bt, extra_embeds=frames)
        _, jg = jax.value_and_grad(jmodel.loss, has_aux=True)(
            jparams, fam.jax_batch(b))
        want = float(np.sqrt(sum(np.sum(np.square(np.asarray(g)))
                                 for g in jax.tree_util.tree_leaves(jg))))
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        loss, _ = model.loss(params, fam.torch_batch(b))
        got = float(torch.sqrt(sum(g.square().sum() for g in
                                   torch.autograd.grad(loss, leaves))))
        np.testing.assert_allclose(got, want, rtol=1e-4)
        norms.append(got)
    assert norms[0] > 1e5 * norms[1]


def test_loss_and_grads_match_reference():
    fam.check_loss_and_grads(ARCH, extra=True)


def test_remat_changes_no_number():
    _, _, model, params = fam.pair(ARCH)
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


def test_init_cache_cross_kv_matches_reference():
    jmodel, jparams, model, params = fam.pair(ARCH)
    frames = fam.extra_embeds(model.cfg, 2, 5)
    jcache = jmodel.init_cache(jparams, 2, 12, jnp.asarray(frames))
    cache = model.init_cache(params, 2, 12, torch.from_numpy(frames))
    assert len(cache) == model.cfg.num_layers
    for i, c in enumerate(cache):
        for name in ("ck", "cv"):
            fam.close(c[name], jcache[name][i], f"layer {i} {name}")
        for name in ("k", "v"):
            assert c[name].shape == jcache[name][i].shape
            assert c[name].dtype == torch.float32 and not c[name].any()


def test_decode_chain_and_generate_match_reference():
    assert fam.pair(ARCH)[2].prefill is None
    before = dict(ops.launches)
    jcache, cache = fam.check_decode_through_prefill_reference(
        ARCH, steps=5, extra=True)
    assert ops.launches == before              # CPU: the plain version
    for i, c in enumerate(cache):
        for name in ("k", "v", "ck", "cv"):
            fam.close(c[name], jcache[name][i], f"layer {i} {name}")


def test_engine_and_launcher_refuse_the_family():
    jmodel, jparams, model, params = fam.pair(ARCH)
    frames = fam.extra_embeds(model.cfg, 8, 0)
    with pytest.raises(ValueError) as want:
        jserving.Engine(jmodel, jparams, jserving.ServeConfig(),
                        extra=jnp.asarray(frames))
    with pytest.raises(ValueError) as got:
        serving.Engine(model, params, serving.ServeConfig(), device="cpu",
                       extra=torch.from_numpy(frames))
    assert str(got.value) == str(want.value)
    assert "no batched-prefill" in str(got.value)
    with pytest.raises(ValueError, match="no batched-prefill"):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("name,use_kernel", [
    ("tvlars", "fused"), ("wa-lars", False), ("wa-lars", "per_tensor")])
def test_train_step_matches_reference(name, use_kernel):
    fam.check_train_step(ARCH, name, use_kernel, extra=True)


def test_segments_are_the_reference_leaves():
    """32 leaves in the reference's order, 28 of them ADAPT (the
    stacked LayerNorm scales and biases too, F3); the 1-D ``enc_norm``
    and ``final_norm`` leaves are PLAIN."""
    fam.check_segments(ARCH)
    _, _, model, params = fam.pair(ARCH)
    spec = flatten.build_spec(params, segments=model.segments)
    names = list(spec.names)
    assert len(names) == 32
    assert names[:2] == ["decoder/cross_attn/wk", "decoder/cross_attn/wo"]
    assert names.index("embed/head") < names.index("enc_norm/bias") \
        < names.index("encoder/attn/wk") < names.index("final_norm/bias")
    plain = [n for n, a in zip(names, spec.adapt) if not a]
    assert plain == ["enc_norm/bias", "enc_norm/scale", "final_norm/bias",
                     "final_norm/scale"]


def test_params_round_trip():
    fam.check_round_trip(ARCH)


def test_checkpoint_crosses_packages(tmp_path):
    fam.check_checkpoint_both_ways(ARCH, tmp_path)


def test_param_count_undercounts_the_tree():
    """F9: ``param_count()`` leaves out the LayerNorm biases and
    ``enc_norm``; the tree is what trains."""
    cfg = get_config(ARCH)
    tree = sum(t.numel() for t in tree_leaves(jax_template(cfg)))
    assert (tree, cfg.param_count()) == (1_601_198_080, 1_600_989_440)


def test_launch_train_on_cpu():
    """The launcher's stub frontend: every batch carries zero frames."""
    before = dict(ops.launches)
    seen = []
    real = launch_train._stub_frontend

    def spy(cfg, batch):
        out = real(cfg, batch)
        seen.append(out["extra_embeds"])
        return out

    launch_train._stub_frontend = spy
    try:
        out = launch_train.run(["--arch", ARCH, "--smoke", "--device",
                                "cpu", "--seq", "16", "--steps", "2",
                                "--global-batch", "4", "--microbatch", "2",
                                "--use-kernel", "fused"],
                               log_fn=lambda *_: None)
    finally:
        launch_train._stub_frontend = real
    assert ops.launches == before
    assert np.all(np.isfinite(out["losses"])) and len(out["losses"]) == 2
    assert len(seen) == 2
    assert all(tuple(e.shape) == (2, 2, 24, 128) and not e.any()
               for e in seen)
