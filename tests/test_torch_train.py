"""LM training in ``repro_torch`` against the JAX package, on the
reference's own smoke weights (``params_from_jax``) and the same numpy
batches, in f32 on the CPU.

* ``Model.loss`` (the chunked fused CE head over ``apply_lm_hidden``)
  and its gradients, mapped onto the reference's stacked leaves:
  relative 1e-5 on the loss, 1e-4 on the gradients (two libraries
  summing the same products in other orders through a few layers; the
  forward parity tests use the same 1e-4).
* ``make_train_step`` at K = 1 and K = 2 (fused TVLARS f32, fused LAMB
  bf16_master_sr, tree WA-LARS) for 3 steps against the reference's
  jitted step: loss and ``grad_norm`` relative 1e-5 each step; params
  after the 3 steps within 1e-5 relative at each leaf's scale in f32
  (10x the observed gap), ``parity_tolerance(precision, 3)`` for the
  bf16 policy.
* In the port alone: K × (B/K) ≡ 1 × B (1e-6, the reference's own
  accumulation bound), per-layer remat changes no number, the data
  stream is the bigram chain, and ``launch.train --smoke --device cpu``
  runs end to end without launching a kernel.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import build_optimizer as jbuild
from repro.models import get_model as jax_get_model
from repro.training.train_state import TrainState as JTrainState
from repro.training.trainer import make_train_step as jmake_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.core import build_optimizer
from repro_torch.core.base import tree_leaves, tree_map
from repro_torch.data import synthetic
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as launch_train
from repro_torch.models import get_model, params_from_jax
from repro_torch.models.convert import jax_segments
from repro_torch.training import TrainState, lm_task, make_train_step

B, S = 4, 32


def _pair(arch: str, cfg_edit=None):
    jcfg = jax_smoke_config(arch)
    cfg = get_smoke_config(arch)
    if cfg_edit:
        jcfg, cfg = jcfg.replace(**cfg_edit), cfg.replace(**cfg_edit)
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = get_model(cfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jmodel, jparams, model, params_from_jax(cfg, tree,
                                                    device="cpu")


def _batches(steps: int, k: int = 1, seed: int = 0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        b = {"tokens": rng.integers(0, 512, (B, S)),
             "labels": rng.integers(0, 512, (B, S))}
        if k > 1:
            b = {n: v.reshape(k, B // k, S) for n, v in b.items()}
        out.append(b)
    return out


def _jax_batch(b):
    return {k: jnp.asarray(v, jnp.int32) for k, v in b.items()}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma3-12b"])
def test_lm_loss_and_grads_match_reference(arch):
    jmodel, jparams, model, params = _pair(arch)
    batch = _batches(1)[0]
    (jloss, _), jgrads = jax.value_and_grad(
        jmodel.loss, has_aux=True)(jparams, _jax_batch(batch))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss, aux = model.loss(params, _torch_batch(batch))
    assert float(aux.load_balance_loss) == 0.0
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    by_id = {id(p): g for p, g in zip(tree_leaves(params), grads)}
    jleaves = jax.tree_util.tree_leaves(jgrads)
    for (name, members), jg in zip(jax_segments(model.cfg, params),
                                   jleaves):
        got = torch.stack([by_id[id(m)] for m in members]) \
            if name.startswith("groups/") else by_id[id(members[0])]
        scale = float(np.abs(np.asarray(jg)).max())
        np.testing.assert_allclose(got.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def test_remat_changes_no_number():
    _, _, model, params = _pair("qwen2.5-3b")
    remat = get_model(model.cfg.replace(remat=True))
    batch = _torch_batch(_batches(1)[0])
    out = []
    # the embedding's backward (an accumulating index_put) is
    # scheduled across threads on the CPU unless deterministic
    # algorithms are asked for; exact equality needs them
    torch.use_deterministic_algorithms(True)
    try:
        for m in (model, remat):
            for p in tree_leaves(params):
                p.requires_grad_(True)
            loss, _ = m.loss(params, batch)
            out.append((loss, torch.autograd.grad(loss,
                                                  tree_leaves(params))))
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


STEP_CASES = [("tvlars", "fused", "f32", 1),
              ("lamb", "fused", "bf16_master_sr", 2),
              ("wa-lars", False, "f32", 2)]


@pytest.mark.parametrize("name,use_kernel,precision,k", STEP_CASES,
                         ids=[f"{n}-{u or 'tree'}-{p}-K{k}"
                              for n, u, p, k in STEP_CASES])
def test_train_step_matches_reference(name, use_kernel, precision, k):
    jmodel, jparams, model, params = _pair("qwen2.5-3b")
    hyper = dict(total_steps=10, learning_rate=2.0, batch_size=B,
                 use_kernel=use_kernel, precision=precision)
    jopt = jbuild(name, **hyper)
    opt = build_optimizer(name, segments=model.segments, device="cpu",
                          **hyper)
    jstate = JTrainState.create(jparams, jopt)
    state = TrainState.create(params, opt)
    jstep = jax.jit(jmake_train_step(jmodel, jopt, accum_steps=k))
    step = make_train_step(lm_task(model), opt, accum_steps=k)
    for batch in _batches(3, k):
        jstate, jm = jstep(jstate, _jax_batch(batch))
        state, m = step(state, _torch_batch(batch))
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
    assert state.step == 3
    want = params_from_jax(model.cfg, jax.tree_util.tree_map(
        np.asarray, jstate.params), device="cpu")
    tol = {"rtol": 1e-5, "atol": 1e-5} if precision == "f32" \
        else ref.parity_tolerance(precision, 3)
    for a, b in zip(tree_leaves(state.params), tree_leaves(want)):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(),
                                   rtol=tol["rtol"],
                                   atol=tol["atol"] * scale)


@pytest.mark.parametrize("use_kernel", [False, "fused"])
def test_accumulation_k_by_b_over_k_equals_one_by_b(use_kernel):
    _, _, model, params = _pair("qwen2.5-3b")
    runs = []
    for k in (1, 2):
        p = tree_map(lambda t: t.detach().clone(), params)
        opt = build_optimizer("tvlars", total_steps=10, batch_size=B,
                              use_kernel=use_kernel,
                              segments=model.segments, device="cpu")
        state = TrainState.create(p, opt)
        step = make_train_step(lm_task(model), opt, accum_steps=k)
        losses = []
        for batch in _batches(2, k):
            state, m = step(state, _torch_batch(batch))
            losses.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((losses, state.params))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-6)
    for a, b in zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_lm_stream_is_the_bigram_chain():
    gen = torch.Generator().manual_seed(3)
    tokens, labels = synthetic.lm_batch(gen, 4, 16, 97)
    assert torch.equal(labels[:, :-1], tokens[:, 1:])
    step = (labels - 5 * tokens - 1) % 97
    assert set(step[:, :-1].unique().tolist()) <= {0, 1, 2}
    stacked = next(synthetic.lm_iterator(8, 16, 97, accum_steps=2))
    assert stacked["tokens"].shape == (2, 4, 16)
    first = next(synthetic.lm_iterator(8, 16, 97))
    assert torch.equal(stacked["tokens"].reshape(8, 16), first["tokens"])
    with pytest.raises(ValueError, match="divisible"):
        synthetic.stack_microbatches({"x": torch.zeros(5, 2)}, 2)


@pytest.mark.parametrize("argv", [
    ["--optimizer", "tvlars", "--use-kernel", "fused",
     "--layerwise-every", "1"],
    ["--optimizer", "lamb", "--use-kernel", "fused", "--precision",
     "bf16_master_sr", "--global-batch", "8", "--microbatch", "4"],
])
def test_launch_train_smoke_on_cpu(argv, tmp_path):
    before = dict(ops.launches)
    trace = tmp_path / "trace.jsonl"
    out = launch_train.run(["--smoke", "--device", "cpu", "--steps", "2",
                            "--seq", "32", "--trace-out", str(trace)]
                           + argv, log_fn=lambda *_: None)
    assert ops.launches == before                 # CPU: plain versions
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
    assert len(out["segment_names"]) == 15
    assert out["segment_names"][0] == "embed/head"
    assert out["peak_memory_bytes"] is None
    assert all(s > 0 for s in out["optimizer_seconds"])
    assert trace.read_text().count('"loss_grad"') == 2
    if "--layerwise-every" in argv:
        keys = out["history"][-1]
        assert "layerwise/groups/l0_attn/mlp/wi/trust_ratio" in keys


def test_launch_train_refuses_bad_flags():
    with pytest.raises(SystemExit):
        launch_train.run(["--smoke", "--device", "cpu", "--precision",
                          "bf16_master"])
    with pytest.raises(SystemExit):
        launch_train.run(["--smoke", "--device", "cpu", "--global-batch",
                          "6", "--microbatch", "4"])
