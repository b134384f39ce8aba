"""The ssm family of the port (mamba2-1.3b) against the JAX package on
the CPU, smoke config in f32 on the reference's own weights (helpers in
``torch_family.py``).

* ``_ssd_chunked`` against the reference's and against a naive
  per-token recurrence at chunks 4, 8 and 16; ``_causal_conv`` and
  ``mamba_apply`` against the reference's; ``mamba_decode`` step by
  step against ``mamba_apply`` over the same tokens and against the
  reference's decode.
* The LM: logits, loss and gradients; ``serving.decode.prefill`` takes
  the token-by-token path (``model.prefill is None``) and, with the
  decode steps after it and ``generate``, matches the JAX package; the
  engine refuses the family with the reference's error.
* One training step (fused TVLARS, tree and per-tensor WA-LARS) against
  the reference's; segment names and order (``blocks`` before
  ``embed``, ``mamba/D`` before ``mamba/a_log``); the round trip;
  ``launch.train`` refuses a ``--seq`` that the SSD chunk does not
  divide and trains the smoke config on the CPU.
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
from repro.models import ssm as jssm
from repro_torch import serving
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import ssm

ARCH = "mamba2-1.3b"


def _ssd_inputs(b=2, s=16, h=3, p=4, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32))


def _naive(xh, dt, a, bm, cm):
    b, s, h, p = xh.shape
    y = np.zeros((b, s, h, p), np.float32)
    for bi in range(b):
        state = np.zeros((h, p, bm.shape[-1]), np.float32)
        for t in range(s):
            state = state * np.exp(dt[bi, t] * a)[:, None, None] \
                + np.einsum("h,hp,n->hpn", dt[bi, t], xh[bi, t], bm[bi, t])
            y[bi, t] = np.einsum("hpn,n->hp", state, cm[bi, t])
    return y


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_reference_and_recurrence(chunk):
    args = _ssd_inputs()
    got = ssm._ssd_chunked(*map(torch.from_numpy, args), chunk)
    fam.close(got, jssm._ssd_chunked(*map(jnp.asarray, args), chunk),
              f"ssd chunk {chunk} vs reference", {"rtol": 1e-5,
                                                  "atol": 1e-5})
    fam.close(got, _naive(*args), f"ssd chunk {chunk} vs recurrence",
              {"rtol": 1e-4, "atol": 1e-5})
    with pytest.raises(ValueError, match="not divisible"):
        ssm._ssd_chunked(*map(torch.from_numpy, _ssd_inputs(s=12)), 8)


def _block_pair():
    jcfg = jax_smoke_config(ARCH)
    _, jparams, model, params = fam.pair(ARCH)
    return jcfg, jparams["blocks"]["mamba"], model.cfg, \
        params["blocks"][0]["mamba"]


def test_causal_conv_and_mamba_apply_match_reference():
    jcfg, jstack, cfg, p = _block_pair()
    jp = jax.tree_util.tree_map(lambda v: v[0], jstack)
    rng = np.random.default_rng(4)
    c = cfg.ssm_d_inner + 2 * cfg.ssm_state
    x = rng.normal(size=(2, 16, c)).astype(np.float32)
    fam.close(ssm._causal_conv(torch.from_numpy(x), p["conv_w"],
                               p["conv_b"]),
              jssm._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"]),
              "causal conv")
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    fam.close(ssm.mamba_apply(p, cfg, torch.from_numpy(x)),
              jssm.mamba_apply(jp, jcfg, jnp.asarray(x)), "mamba_apply")


def test_mamba_decode_steps_match_apply_and_reference():
    jcfg, jstack, cfg, p = _block_pair()
    jp = jax.tree_util.tree_map(lambda v: v[0], jstack)
    x = np.random.default_rng(5).normal(size=(2, 16, cfg.d_model)) \
        .astype(np.float32)
    full = ssm.mamba_apply(p, cfg, torch.from_numpy(x))
    cache = ssm.mamba_init_cache(cfg, 2, torch.float32, "cpu")
    jcache = jssm.mamba_init_cache(jcfg, 2, jnp.float32)
    for t in range(x.shape[1]):
        xt = x[:, t:t + 1]
        got, cache = ssm.mamba_decode(p, cfg, torch.from_numpy(xt), cache)
        want, jcache = jssm.mamba_decode(jp, jcfg, jnp.asarray(xt), jcache)
        fam.close(got, want, f"decode step {t} vs reference")
        fam.close(got[:, 0], full[:, t].numpy(), f"decode step {t} vs apply")
    fam.close(cache.state, jcache.state, "final state")
    fam.close(cache.conv, jcache.conv, "final conv window")


def test_lm_logits_loss_and_grads_match_reference():
    jmodel, jparams, model, params = fam.pair(ARCH)
    tokens = np.random.default_rng(3).integers(1, 512, (2, 16))
    want, _ = jmodel.apply(jparams, {"tokens": jnp.asarray(tokens)})
    fam.close(model.apply(params, torch.from_numpy(tokens)), want,
              "ssm logits")
    aux = fam.check_loss_and_grads(ARCH)
    assert float(aux.load_balance_loss) == 0.0


def test_decode_through_prefill_reference_matches_jax():
    assert fam.pair(ARCH)[2].prefill is None
    before = dict(ops.launches)
    jcache, cache = fam.check_decode_through_prefill_reference(ARCH)
    assert ops.launches == before                 # no attention at all
    for c, state, conv in zip(cache["ssm"], jcache["ssm"].state,
                              jcache["ssm"].conv):
        fam.close(c.state, state, "cache state")
        fam.close(c.conv, conv, "cache conv")


def test_engine_refuses_the_family_as_the_reference_does():
    jmodel, jparams, model, params = fam.pair(ARCH)
    with pytest.raises(ValueError) as want:
        jserving.Engine(jmodel, jparams, jserving.ServeConfig())
    with pytest.raises(ValueError) as got:
        serving.Engine(model, params, serving.ServeConfig(), device="cpu")
    assert str(got.value) == str(want.value)
    assert "no batched-prefill" in str(got.value)


@pytest.mark.parametrize("name,use_kernel", [
    ("tvlars", "fused"), ("wa-lars", False), ("wa-lars", "per_tensor")])
def test_train_step_matches_reference(name, use_kernel):
    fam.check_train_step(ARCH, name, use_kernel)


def test_segments_are_the_reference_leaves():
    fam.check_segments(ARCH)
    _, _, model, params = fam.pair(ARCH)
    names = [s.name for s in model.segments(params)]
    assert names[:2] == ["blocks/mamba/D", "blocks/mamba/a_log"]
    assert names.index("blocks/norm/scale") < names.index("embed/head")


def test_params_round_trip():
    fam.check_round_trip(ARCH)


def test_param_count_undercounts_the_tree():
    """F8: the reference's ``param_count`` undercounts the ssm tree; the
    port keeps the reference's formula and counts tensors instead."""
    from repro_torch.core.base import tree_leaves
    from repro_torch.models import jax_template
    cfg = get_config(ARCH)
    tree = sum(t.numel() for t in tree_leaves(jax_template(cfg)))
    assert (tree, cfg.param_count()) == (1_446_714_368, 1_343_627_264)


def test_launch_train_checks_seq_and_trains_on_cpu():
    with pytest.raises(SystemExit, match="ssm_chunk"):
        launch_train.run(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--seq", "12", "--steps", "1"])
    before = dict(ops.launches)
    out = launch_train.run(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--seq", "16", "--steps", "2", "--use-kernel",
                            "fused"], log_fn=lambda *_: None)
    assert ops.launches == before
    assert np.all(np.isfinite(out["losses"])) and len(out["losses"]) == 2
    assert out["segment_names"][0] == "blocks/mamba/D"
