"""Shared checks of ``test_torch_moe.py``, ``test_torch_ssm.py``,
``test_torch_hybrid.py``, ``test_torch_encdec.py`` and
``test_torch_vlm.py``: a model family of the port held against the JAX
package on the reference's own smoke weights (``init(PRNGKey(0))``
carried across with ``params_from_jax``) and the same numpy batches,
in f32 on the CPU. With ``extra=True`` the batches and caches also
carry the stubbed frontend's output (``extra_embeds``: audio frames
for encdec, image embeddings for vlm), normal draws from a seed, never
zeros; ``gate=`` opens a vlm's cross gates in both packages (init
leaves them closed, where the image changes nothing).

Tolerances: rtol = atol = 1e-4 on logits, caches and gradients (two
libraries summing in other orders through a few layers, as
``test_torch_model.py``); the training step as ``test_torch_train.py``
(loss and ``grad_norm`` 1e-5 relative, params 1e-5 at each leaf's
scale). Tree is held against tree and fused against fused (F1).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import checkpoint as jck
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import build_optimizer as jbuild
from repro.models import get_model as jax_get_model
from repro.training.train_state import TrainState as JTrainState
from repro.training.trainer import make_train_step as jmake_train_step
from repro_torch import checkpoint as ck
from repro_torch.configs import get_smoke_config
from repro_torch.core import build_optimizer
from repro_torch.core.base import tree_get, tree_leaves
from repro_torch.models import (extra_embed_shape, get_model, jax_template,
                                params_from_jax, params_to_jax)
from repro_torch.training import TrainState, lm_task, make_train_step

TOL = {"rtol": 1e-4, "atol": 1e-4}
B, S = 2, 16


@functools.lru_cache(maxsize=None)
def _reference(arch: str, edit: tuple):
    """The reference's model and smoke weights (immutable: kept for the
    process, each test gets fresh port tensors)."""
    jmodel = jax_get_model(jax_smoke_config(arch).replace(**dict(edit)))
    return jmodel, jmodel.init(jax.random.PRNGKey(0))


def open_gates(jparams: dict, value: float) -> dict:
    """A copy of a vlm reference tree with every stacked cross ``gate``
    at ``value`` (the cached tree is left alone)."""
    groups = {name: dict(layer, gate=jnp.full_like(layer["gate"], value))
              if "gate" in layer else layer
              for name, layer in jparams["groups"].items()}
    return dict(jparams, groups=groups)


def pair(arch: str, gate=None, **edit):
    """(JAX model, JAX params, port model, port params) on the
    reference's smoke weights; ``gate`` opens a vlm's cross gates."""
    jmodel, jparams = _reference(arch, tuple(sorted(edit.items())))
    if gate is not None:
        jparams = open_gates(jparams, gate)
    cfg = get_smoke_config(arch).replace(**edit)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jmodel, jparams, get_model(cfg), \
        params_from_jax(cfg, tree, device="cpu")


def close(got, want, what, tol=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, err_msg=what, **(tol or TOL))


def extra_embeds(cfg, b: int, seed: int) -> np.ndarray:
    """``b`` rows of the stubbed frontend's output for ``cfg``: f32
    normal draws (the smoke configs compute in f32)."""
    return np.random.default_rng(seed).normal(
        size=extra_embed_shape(cfg, b)).astype(np.float32)


def batch(seed: int = 0, b: int = B, s: int = S, vocab: int = 512,
          cfg=None):
    """Tokens and labels; with ``cfg`` of a family that needs them,
    ``extra_embeds`` too."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(1, vocab, (b, s)),
           "labels": rng.integers(1, vocab, (b, s))}
    if cfg is not None and extra_embed_shape(cfg, b) is not None:
        out["extra_embeds"] = extra_embeds(cfg, b, seed + 100)
    return out


def jax_batch(bt):
    return {k: jnp.asarray(v) if v.dtype.kind == "f"
            else jnp.asarray(v, jnp.int32) for k, v in bt.items()}


def torch_batch(bt):
    return {k: torch.from_numpy(v) for k, v in bt.items()}


def reference_names(jparams) -> list[str]:
    """'/'-joined key paths of the reference tree, in its flatten order."""
    return ["/".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]


def as_reference_leaves(model, params, values: dict, jparams) -> list:
    """``values`` ({id(port tensor): tensor}) gathered per segment of
    ``model.segments`` and shaped like the reference's leaves."""
    out = []
    for seg, jleaf in zip(model.segments(params),
                          jax.tree_util.tree_leaves(jparams)):
        members = [values[id(tree_get(params, p))] for p in seg.paths]
        t = torch.stack(members) if seg.stacked else members[0]
        out.append(t.reshape(np.shape(jleaf)))
    return out


def check_segments(arch: str):
    """Segment names, order and stacked shapes are the reference's
    leaves'."""
    _, jparams, model, params = pair(arch)
    segs = model.segments(params)
    assert [s.name for s in segs] == reference_names(jparams)
    got = as_reference_leaves(
        model, params, {id(t): t for t in tree_leaves(params)}, jparams)
    for t, j in zip(got, jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def check_round_trip(arch: str):
    """params_to_jax(params_from_jax(tree)) is the reference tree leaf
    for leaf (names, shapes, dtypes, bits), and jax_template has its
    shapes and dtypes."""
    _, jparams, model, params = pair(arch, param_dtype="bfloat16")
    back = params_to_jax(model.cfg, params)
    assert reference_names(back) == reference_names(jparams)
    tmpl = jax_template(model.cfg)
    for a, t, j in zip(tree_leaves(back), tree_leaves(tmpl),
                       jax.tree_util.tree_leaves(jparams)):
        assert tuple(a.shape) == tuple(t.shape) == np.shape(j)
        assert a.dtype == t.dtype
        np.testing.assert_array_equal(
            a.view(torch.int16).numpy() if a.dtype == torch.bfloat16
            else a.numpy(),
            np.asarray(j).view(np.int16) if a.dtype == torch.bfloat16
            else np.asarray(j))


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous()
        return t.reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def check_checkpoint_both_ways(arch: str, tmp_path):
    """A JAX ``save`` restored by the port (through ``jax_template``)
    and a port ``save`` restored by JAX, both bitwise, in bf16."""
    jmodel, jparams, model, params = pair(arch, param_dtype="bfloat16")
    cfg = model.cfg
    jck.save(str(tmp_path / "jax"), jparams, step=2)
    got = params_from_jax(cfg, ck.restore(str(tmp_path / "jax"),
                                          jax_template(cfg), device="cpu"),
                          device="cpu")
    for a, b in zip(tree_leaves(got), tree_leaves(params)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    ck.save(str(tmp_path / "port"), params_to_jax(cfg, params), step=3)
    back = jck.restore(str(tmp_path / "port"), jparams)
    assert jck.latest_step(str(tmp_path / "port")) == 3
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def check_loss_and_grads(arch: str, extra: bool = False, gate=None):
    """``Model.loss`` (CE and aux) and its gradients, each gathered onto
    the reference's leaves."""
    jmodel, jparams, model, params = pair(arch, gate)
    bt = batch(0, cfg=model.cfg if extra else None)
    (jloss, jaux), jgrads = jax.value_and_grad(
        jmodel.loss, has_aux=True)(jparams, jax_batch(bt))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, aux = model.loss(params, torch_batch(bt))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    for got, want in zip(aux, jaux):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5, atol=1e-7)
    grads = torch.autograd.grad(loss, leaves)
    got = as_reference_leaves(model, params,
                              {id(p): g for p, g in zip(leaves, grads)},
                              jparams)
    for name, g, jg in zip(reference_names(jparams), got,
                           jax.tree_util.tree_leaves(jgrads)):
        scale = float(np.abs(np.asarray(jg)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
    return aux


def check_train_step(arch: str, name: str, use_kernel, extra: bool = False,
                     gate=None):
    """One ``make_train_step`` against the reference's jitted step from
    the same params and batch: loss, ce and grad_norm 1e-5 relative,
    params 1e-5 at each leaf's scale."""
    jmodel, jparams, model, params = pair(arch, gate)
    hyper = dict(total_steps=10, learning_rate=2.0, batch_size=B,
                 use_kernel=use_kernel)
    jopt = jbuild(name, **hyper)
    opt = build_optimizer(name, segments=model.segments, device="cpu",
                          **hyper)
    jstate = JTrainState.create(jparams, jopt)
    state = TrainState.create(params, opt)
    bt = batch(1, cfg=model.cfg if extra else None)
    jstate, jm = jax.jit(jmake_train_step(jmodel, jopt))(jstate,
                                                         jax_batch(bt))
    state, m = make_train_step(lm_task(model), opt)(state, torch_batch(bt))
    for key in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    want = params_from_jax(model.cfg, jax.tree_util.tree_map(
        np.asarray, jstate.params), device="cpu")
    for a, b in zip(tree_leaves(state.params), tree_leaves(want)):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(),
                                   rtol=1e-5, atol=1e-5 * scale)


def check_decode_through_prefill_reference(arch: str, steps: int = 4,
                                           extra: bool = False, gate=None):
    """``serving.decode.prefill`` (the token-by-token loop where the
    family has no batched prefill) and ``steps`` decode steps against
    the JAX package's ``serving.prefill`` and ``decode_step``; then
    ``generate``'s greedy tokens. Returns the final (JAX, port)
    caches."""
    from repro import serving as jserving
    from repro_torch import serving
    jmodel, jparams, model, params = pair(arch, gate)
    jmodel = jmodel._replace(decode_step=jax.jit(jmodel.decode_step))
    rng = np.random.default_rng(2)
    max_len = 16
    tokens = rng.integers(1, 512, (2, 6))
    ex = extra_embeds(model.cfg, 2, 3) if extra else None
    want, jcache = jserving.prefill(
        jmodel, jparams, jnp.asarray(tokens), max_len,
        None if ex is None else jnp.asarray(ex))
    got, cache = serving.prefill(
        model, params, torch.from_numpy(tokens), max_len,
        None if ex is None else torch.from_numpy(ex))
    close(got, want, f"{arch} prefill logits")
    pos = tokens.shape[1]
    for step in range(steps):
        tok = rng.integers(1, 512, (2, 1)).astype(np.int32)
        want, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(tok),
                                          jnp.int32(pos))
        got, cache = model.decode_step(params, cache, torch.from_numpy(tok),
                                       pos)
        close(got, want, f"{arch} decode step {step} logits")
        pos += 1
    jtok = np.asarray(jserving.generate(
        jmodel, jparams, jnp.asarray(tokens[:1]), num_tokens=5,
        extra_embeds=None if ex is None else jnp.asarray(ex[:1])))
    ptok = serving.generate(
        model, params, tokens[:1], num_tokens=5,
        extra_embeds=None if ex is None else torch.from_numpy(ex[:1]),
        device="cpu")
    np.testing.assert_array_equal(ptok.numpy(), jtok)
    return jcache, cache
