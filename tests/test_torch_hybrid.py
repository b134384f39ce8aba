"""The hybrid family of the port (zamba2-1.2b) against the JAX package
on the CPU, smoke config in f32 on the reference's own weights (helpers
in ``torch_family.py``). The smoke config has 5 mamba blocks with the
shared attention block after every 2: 2 groups and 1 trailing block.

* The LM: logits, loss and gradients (the shared block's gradient is
  the sum over its call sites, the reference's by construction); the
  block order of the port's ``blocks`` list against the reference's
  groups and trailing stack.
* ``serving.decode.prefill`` streams the prompt through
  ``decode_hybrid_lm`` (``model.prefill is None``); with the decode
  steps after it and ``generate`` it matches the JAX package, every
  call site keeping its own KV cache; the engine refuses the family
  with the reference's error, and so does ``launch.serve``.
* One training step (fused TVLARS, tree and per-tensor WA-LARS) against
  the reference's; segment names and order; the round trip; a
  checkpoint across packages both ways; ``launch.train`` trains the
  smoke config on the CPU.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_family as fam

from repro import serving as jserving
from repro_torch import serving
from repro_torch.configs import get_config
from repro_torch.core.base import tree_leaves
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import get_model, hybrid, jax_template

ARCH = "zamba2-1.2b"


def test_layout_and_block_order():
    assert hybrid.hybrid_layout(get_config(ARCH)) == (6, 2)
    _, jparams, model, params = fam.pair(ARCH)
    cfg = model.cfg
    assert hybrid.hybrid_layout(cfg) == (2, 1)
    blocks = params["blocks"]
    assert len(blocks) == 5
    want = [np.asarray(jparams["groups"]["mamba"]["in_proj"][g, i])
            for g in range(2) for i in range(2)] \
        + [np.asarray(jparams["trailing"]["mamba"]["in_proj"][0])]
    for b, w in zip(blocks, want):
        np.testing.assert_array_equal(b["mamba"]["in_proj"].numpy(), w)
    # the shared block follows blocks 1 and 3 (the two groups' ends)
    assert [hybrid._shared_after(cfg, i) for i in range(5)] == \
        [-1, 0, -1, 1, -1]


def test_lm_logits_loss_and_grads_match_reference():
    jmodel, jparams, model, params = fam.pair(ARCH)
    tokens = np.random.default_rng(3).integers(1, 512, (2, 16))
    want, _ = jmodel.apply(jparams, {"tokens": jnp.asarray(tokens)})
    fam.close(model.apply(params, torch.from_numpy(tokens)), want,
              "hybrid logits")
    fam.check_loss_and_grads(ARCH)


def test_remat_changes_no_number():
    _, _, model, params = fam.pair(ARCH)
    remat = get_model(model.cfg.replace(remat=True))
    bt = fam.torch_batch(fam.batch(0))
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


def test_decode_through_prefill_reference_matches_jax():
    assert fam.pair(ARCH)[2].prefill is None
    before = dict(ops.launches)
    jcache, cache = fam.check_decode_through_prefill_reference(ARCH)
    assert ops.launches == before              # CPU: the plain version
    assert len(cache["kv"]) == 2
    for g, kv in enumerate(cache["kv"]):
        for name in ("k", "v"):
            fam.close(kv[name], jcache[name][g], f"call site {g} {name}")
    assert not torch.equal(cache["kv"][0]["k"], cache["kv"][1]["k"])
    states = [c.state for c in cache["ssm"]]
    want = [jcache["ssm"].state[g, i] for g in range(2) for i in range(2)] \
        + [jcache["ssm_trailing"].state[0]]
    for got, w in zip(states, want):
        fam.close(got, w, "ssm state")


def test_engine_and_launcher_refuse_the_family():
    jmodel, jparams, model, params = fam.pair(ARCH)
    with pytest.raises(ValueError) as want:
        jserving.Engine(jmodel, jparams, jserving.ServeConfig())
    with pytest.raises(ValueError) as got:
        serving.Engine(model, params, serving.ServeConfig(), device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="no batched-prefill"):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("name,use_kernel", [
    ("tvlars", "fused"), ("wa-lars", False), ("wa-lars", "per_tensor")])
def test_train_step_matches_reference(name, use_kernel):
    fam.check_train_step(ARCH, name, use_kernel)


def test_segments_are_the_reference_leaves():
    fam.check_segments(ARCH)
    _, _, model, params = fam.pair(ARCH)
    names = [s.name for s in model.segments(params)]
    assert names[:3] == ["embed/head", "embed/table", "final_norm/scale"]
    assert names[3] == "groups/mamba/D"
    assert names.index("shared_attn/attn/wk") < names.index(
        "trailing/mamba/D")


def test_params_round_trip():
    fam.check_round_trip(ARCH)


def test_checkpoint_crosses_packages(tmp_path):
    fam.check_checkpoint_both_ways(ARCH, tmp_path)


def test_param_count_undercounts_the_tree():
    """F8, as for mamba2-1.3b in ``test_torch_ssm.py``."""
    cfg = get_config(ARCH)
    tree = sum(t.numel() for t in tree_leaves(jax_template(cfg)))
    assert (tree, cfg.param_count()) == (1_170_473_856, 1_120_057_088)


def test_launch_train_on_cpu():
    before = dict(ops.launches)
    out = launch_train.run(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--seq", "16", "--steps", "2", "--use-kernel",
                            "fused"], log_fn=lambda *_: None)
    assert ops.launches == before
    assert np.all(np.isfinite(out["losses"])) and len(out["losses"]) == 2
