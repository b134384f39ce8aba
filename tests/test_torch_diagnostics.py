"""The sharpness diagnostics of ``repro_torch`` against the JAX package,
on the CPU, with the same numpy inputs and weights
(``classifier_params_from_jax`` / ``params_from_jax``).

Tolerances (f32 throughout):

* flat HVP on the tiny MLP: 1e-5 of the product's largest entry; on
  the qwen2.5-3b smoke LM 1e-4 of it (two libraries summing the same
  products in other orders through two layers, the bound
  ``test_torch_train`` holds LM gradients to); port K=4 ≡ K=1 and
  flat ≡ tree within 1e-6 (the reference's own bounds); the smoke LM in
  bf16 at K = 4 and K = 1: 4·2^-8 of the product's norm
  (``HVP_BF16_RTOL``);
* ``padding_mask`` bit for bit;
* Lanczos α/β from the same v0: 1e-4 of their largest entry with
  reorthogonalization (10 steps), 1e-3 without (6 steps: plain Lanczos
  in f32 amplifies the libraries' rounding differences);
* top-k against dense ``eigh``, and a converged probe's λ_max against
  the reference probe's (other Lanczos seeds): 1e-4 absolute, the
  reference's bound;
* SLQ: Ritz values and weights 1e-4, density 1e-3 of its peak;
* SAM sharpness 1e-4 relative, noise scale 1e-3 relative, loss slices
  1e-5 relative, filter norms 1e-5 relative;
* ``JsonlSink`` byte-identical; ``validate_jsonl`` accepting and
  rejecting the same files.
"""
from __future__ import annotations

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from torch_threads import one_thread  # noqa: F401  (autouse)
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import flatten as jflatten
from repro.data.pipeline import stack_microbatches as jstack
from repro.data.synthetic import ClassificationData as JData
from repro.diagnostics import hvp as jhvp
from repro.diagnostics import landscape as jlandscape
from repro.diagnostics import lanczos as jlanczos
from repro.diagnostics import sharpness as jsharpness
from repro.diagnostics import sink as jsink
from repro.models import get_model as jax_get_model
from repro.models.cnn import apply_mlp_classifier as japply_mlp
from repro.models.cnn import init_mlp_classifier as jinit_mlp
from repro.training import classifier_task as jclassifier_task
from repro.training.tasks import lm_task as jlm_task
from repro_torch.configs import get_smoke_config
from repro_torch.core import NormRecorder, build_optimizer, flatten
from repro_torch.core.base import tree_leaves, tree_map
from repro_torch.core.instrumentation import LayerNorms
from repro_torch.data import synthetic
from repro_torch.diagnostics import (hvp, landscape, lanczos, probes,
                                     sharpness)
from repro_torch.diagnostics import sink as sink_lib
from repro_torch.diagnostics import smoke as diag_smoke
from repro_torch.kernels import ops
from repro_torch.launch import sharpness as launch_sharpness
from repro_torch.launch import train as launch_train
from repro_torch.models import cnn, get_model, params_from_jax
from repro_torch.models.convert import classifier_params_from_jax
from repro_torch.obs import trace as obs_trace
from repro_torch.training import (FitOptions, Task, TrainState,
                                  classifier_task, fit, lm_task,
                                  make_train_step)


# ----- fixtures: the same numpy inputs for both packages -----

def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _close(got, want, rtol, what=""):
    """``got`` within ``rtol`` of ``want``'s largest entry."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=what)


def _quadratic(dim: int = 12, seed: int = 0):
    """(port task, port params, jax params, A): loss 0.5 wᵀAw, whose
    Hessian is exactly A (SPD)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(dim, dim))
    a = (q @ q.T).astype(np.float32)
    w = rng.normal(size=(dim,)).astype(np.float32)
    ta = torch.from_numpy(a)

    def loss_fn(params, batch):
        x = params["w"].float()
        return 0.5 * x @ ta @ x, {}

    return (Task("quad", loss_fn), {"w": torch.from_numpy(w.copy())},
            {"w": jnp.asarray(w)}, a)


_MLP_CACHE: dict = {}


def _tiny_mlp(batch_size: int = 16):
    """(port task, port params, port batch, jax task, jax params, jax
    batch) of the reference test's tiny MLP, on the reference's own
    weights and batch."""
    if batch_size not in _MLP_CACHE:
        data = JData(num_classes=3, image_size=2, seed=0)
        jparams = jinit_mlp(jax.random.PRNGKey(0), in_dim=2 * 2 * 3,
                            num_classes=3, hidden=8, depth=2)
        jbatch = data.batch(jax.random.PRNGKey(1), batch_size)
        _MLP_CACHE[batch_size] = (jparams, jbatch)
    jparams, jbatch = _MLP_CACHE[batch_size]
    params = classifier_params_from_jax(_np_tree(jparams), device="cpu")
    images, labels = (np.asarray(x) for x in jbatch)
    batch = (torch.from_numpy(images.copy()),
             torch.from_numpy(labels.astype(np.int64)))
    return (classifier_task(cnn.apply_mlp_classifier), params, batch,
            jclassifier_task(japply_mlp), jparams, jbatch)


def _masked_normal(spec, seed: int, lead=()) -> np.ndarray:
    mask = np.asarray(jhvp.padding_mask(spec)) if hasattr(spec, "treedef") \
        else hvp.padding_mask(spec).numpy()
    rng = np.random.default_rng(seed)
    return (mask * rng.normal(size=tuple(lead) + mask.shape)
            ).astype(np.float32)


_LM_CACHE: dict = {}


def _smoke_lm():
    """(jax model, jax params, port cfg, numpy params tree, numpy batch)
    of the qwen2.5-3b smoke LM in f32 and one B=4, S=32 batch."""
    if not _LM_CACHE:
        jmodel = jax_get_model(jax_smoke_config("qwen2.5-3b"))
        jparams = jmodel.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        batch = {"tokens": rng.integers(0, 512, (4, 32)),
                 "labels": rng.integers(0, 512, (4, 32))}
        _LM_CACHE.update(jmodel=jmodel, jparams=jparams,
                         tree=_np_tree(jparams), batch=batch)
    return _LM_CACHE


# ----- HVP on the flat layout -----

def test_flat_hvp_matches_reference_mlp():
    task, params, batch, jtask, jparams, jbatch = _tiny_mlp()
    op = hvp.make_flat_hvp(task, params, batch)
    jop = jhvp.make_flat_hvp(jtask, jparams, jbatch)
    assert (op.spec.num_rows, op.dim) == (jop.spec.num_rows, jop.dim)
    v = _masked_normal(jop.spec, 1)
    got = op.matvec(torch.from_numpy(v)).numpy()
    _close(got, jop.matvec(jnp.asarray(v)), 1e-5, "mlp hvp")
    np.testing.assert_array_equal(op.w2d.numpy(), np.asarray(jop.w2d))


@pytest.mark.parametrize("remat", [False, True])
def test_flat_hvp_matches_reference_lm(remat):
    lm = _smoke_lm()
    cfg = get_smoke_config("qwen2.5-3b").replace(remat=remat)
    model = get_model(cfg)
    params = params_from_jax(cfg, lm["tree"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in lm["batch"].items()}
    jbatch = {k: jnp.asarray(v, jnp.int32) for k, v in lm["batch"].items()}
    op = hvp.make_flat_hvp(lm_task(model), params, batch)
    if "jop" not in lm:
        lm["jop"] = jhvp.make_flat_hvp(jlm_task(lm["jmodel"]),
                                       lm["jparams"], jbatch)
        lm["v"] = _masked_normal(lm["jop"].spec, 2)
        lm["jhv"] = np.asarray(lm["jop"].matvec(jnp.asarray(lm["v"])))
    assert op.spec.num_rows == lm["jop"].spec.num_rows
    assert op.spec.sizes == lm["jop"].spec.sizes
    got = op.matvec(torch.from_numpy(lm["v"])).numpy()
    _close(got, lm["jhv"], 1e-4, f"lm hvp remat={remat}")


# a bf16 model's HVP: both packages take each microbatch's product in
# bf16 (the reference through the f32-packed buffer cast to bf16 leaves,
# the port at the leaves' dtype), and sum the K products in f32 (the
# reference's scan carry) or in the leaves' bf16 ``.grad`` (the port).
# Stated bound: the products' difference within 4 * 2^-8 of the
# reference's product in norm (four bf16 roundings, the bf16 rule of
# ``ref.parity_tolerance``); K = 1, which has no sum, is held to the
# same bound, and the port's own K = 4 against K = 1 (the bf16 sum's
# rounding) to 2^-8. Measured on this input: 0.72% (K = 4), 0.71%
# (K = 1) and 0.30% (the reference's own K = 4 against K = 1: 0.27%),
# so what separates the packages is the bf16 arithmetic of each
# product, not the sum.
HVP_BF16_RTOL = 4 * 2.0 ** -8


def test_flat_hvp_bf16_lm_matches_reference():
    edit = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = jax_smoke_config("qwen2.5-3b").replace(**edit)
    cfg = get_smoke_config("qwen2.5-3b").replace(**edit)
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = get_model(cfg)
    params = params_from_jax(cfg, _np_tree(jparams), device="cpu")
    assert {p.dtype for p in tree_leaves(params)} == {torch.bfloat16}
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 512, (8, 32)),
             "labels": rng.integers(0, 512, (8, 32))}
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, want = {}, {}
    for k in (1, 4):
        jop = jhvp.make_flat_hvp(jlm_task(jmodel), jparams,
                                 jstack(jb, k) if k > 1 else jb,
                                 accum_steps=k)
        v = _masked_normal(jop.spec, 2)
        want[k] = np.asarray(jop.matvec(jnp.asarray(v)), np.float64)
        op = hvp.make_flat_hvp(lm_task(model), params,
                               synthetic.stack_microbatches(tb, k),
                               accum_steps=k)
        assert op.spec.sizes == jop.spec.sizes
        got[k] = op.matvec(torch.from_numpy(v)).double().numpy()
        rel = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
        assert rel <= HVP_BF16_RTOL, (k, rel)
    rel = np.linalg.norm(got[4] - got[1]) / np.linalg.norm(got[1])
    assert rel <= 2.0 ** -8, rel


def test_flat_hvp_matches_tree_hvp():
    task, params, batch, *_ = _tiny_mlp()
    spec = flatten.build_spec(params)
    rng = np.random.default_rng(1)
    v_tree = tree_map(lambda p: torch.from_numpy(
        rng.normal(size=tuple(p.shape)).astype(np.float32)), params)
    op = hvp.make_flat_hvp(task, params, batch)
    out_flat = flatten.unpack(op.matvec(flatten.pack(v_tree, spec)), spec,
                              params)
    out_tree = hvp.tree_hvp(task, params, batch, v_tree)
    for a, b in zip(tree_leaves(out_flat), tree_leaves(out_tree)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_flat_hvp_zero_on_padding_and_dim():
    task, params, batch, *_ = _tiny_mlp()
    op = hvp.make_flat_hvp(task, params, batch)
    mask = hvp.padding_mask(op.spec)
    assert op.dim == sum(math.prod(s) for s in op.spec.shapes)
    assert float(mask.sum()) == op.dim
    out = op.matvec(torch.ones_like(op.w2d))   # pad coords set to 1
    assert torch.equal(out * (1 - mask), torch.zeros_like(out))


def test_flat_hvp_accumulated_matches_single():
    task, params, batch, jtask, jparams, jbatch = _tiny_mlp(batch_size=32)
    spec = flatten.build_spec(params)
    v = torch.from_numpy(_masked_normal(spec, 2))
    h1 = hvp.make_flat_hvp(task, params, batch).matvec(v)
    hk = hvp.make_flat_hvp(task, params,
                           synthetic.stack_microbatches(batch, 4),
                           accum_steps=4).matvec(v)
    np.testing.assert_allclose(h1.numpy(), hk.numpy(), atol=1e-6)
    jk = jhvp.make_flat_hvp(jtask, jparams, jstack(jbatch, 4),
                            accum_steps=4).matvec(jnp.asarray(v.numpy()))
    _close(hk.numpy(), jk, 1e-5, "K=4 hvp against the reference's")


def test_hvp_rejects_unstacked_batch():
    task, params, batch, *_ = _tiny_mlp()
    with pytest.raises(ValueError, match="accum_steps=4"):
        hvp.make_flat_hvp(task, params, batch, accum_steps=4)
    with pytest.raises(ValueError, match=">= 1"):
        hvp.make_flat_hvp(task, params, batch, accum_steps=0)


@pytest.mark.parametrize("which", ["mlp", "quadratic", "lm"])
def test_padding_mask_bit_for_bit(which):
    if which == "mlp":
        task, params, _, _, jparams, _ = _tiny_mlp()
    elif which == "quadratic":
        task, params, jparams, _ = _quadratic(dim=5)
    else:
        lm = _smoke_lm()
        cfg = get_smoke_config("qwen2.5-3b")
        params = params_from_jax(cfg, lm["tree"], device="cpu")
        task, jparams = lm_task(get_model(cfg)), lm["jparams"]
    got = hvp.padding_mask(hvp.build_spec(task, params)).numpy()
    want = np.asarray(jhvp.padding_mask(jflatten.build_spec(jparams)))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


# ----- Lanczos -----

@pytest.mark.parametrize("reorth,iters,rtol", [(True, 10, 1e-4),
                                               (False, 6, 1e-3)])
def test_lanczos_alpha_beta_match_reference(reorth, iters, rtol):
    task, params, batch, jtask, jparams, jbatch = _tiny_mlp()
    op = hvp.make_flat_hvp(task, params, batch)
    jop = jhvp.make_flat_hvp(jtask, jparams, jbatch)
    v0 = _masked_normal(jop.spec, 0)
    res = lanczos.lanczos(op.matvec, torch.from_numpy(v0), iters,
                          reorth=reorth)
    jres = jlanczos.lanczos(jop.matvec, jnp.asarray(v0), iters,
                            reorth=reorth)
    got = np.concatenate([res.alphas.numpy(), res.betas.numpy()])
    want = np.concatenate([np.asarray(jres.alphas),
                           np.asarray(jres.betas)])
    _close(got, want, rtol, f"alpha/beta reorth={reorth}")


def _plain_lanczos(matvec, v0, m: int, reorth: bool):
    """The reference's loop, written plainly in torch: every vector on
    the device, v_prev kept apart from the basis, ``(w − αv) − βv_prev``
    then the reorthogonalization, the 1e-10 breakdown rule."""
    v = v0.reshape(-1).float()
    v = v / torch.sqrt(torch.dot(v, v))
    basis = torch.zeros((m, v.numel()))
    v_prev, beta = torch.zeros_like(v), torch.zeros(())
    alphas, betas = [], []
    for i in range(m):
        basis[i] = v
        w = matvec(v.view(v0.shape)).reshape(-1)
        alpha = torch.dot(w, v)
        w = w - alpha * v - beta * v_prev
        if reorth:
            w = w - basis.T @ (basis @ w)
        b = torch.sqrt(torch.dot(w, w))
        ok = b > 1e-10
        v_next = torch.where(ok, w / torch.clamp(b, min=1e-10),
                             torch.zeros_like(w))
        beta = torch.where(ok, b, torch.zeros_like(b))
        alphas.append(alpha)
        betas.append(beta)
        v_prev, v = v, v_next
    return torch.stack(alphas), torch.stack(betas)


@pytest.mark.parametrize("reorth", [False, True])
def test_lanczos_matches_the_plain_loop(reorth):
    """v_prev read from the basis (reorth) or held in host memory (no
    basis), the residual formed in pieces: the plain loop's α/β, bit
    for bit; and through a breakdown (rank 4 < 12 steps)."""
    task, params, batch, *_ = _tiny_mlp()
    op = hvp.make_flat_hvp(task, params, batch)
    v0 = torch.from_numpy(_masked_normal(op.spec, 0))
    res = lanczos.lanczos(op.matvec, v0, 6, reorth=reorth)
    alphas, betas = _plain_lanczos(op.matvec, v0, 6, reorth)
    assert torch.equal(res.alphas, alphas) and torch.equal(res.betas, betas)
    qtask, qparams, _, _ = _quadratic(dim=4)
    qop = hvp.make_flat_hvp(qtask, qparams, None)
    q0 = torch.from_numpy(_masked_normal(qop.spec, 1))
    res = lanczos.lanczos(qop.matvec, q0, 12, reorth=reorth)
    alphas, betas = _plain_lanczos(qop.matvec, q0, 12, reorth)
    assert torch.equal(res.alphas, alphas) and torch.equal(res.betas, betas)


def test_lanczos_quadratic_matches_dense_eigh():
    task, params, _, a = _quadratic()
    op = hvp.make_flat_hvp(task, params, None)
    v0 = torch.from_numpy(_masked_normal(op.spec, 0))
    evs = lanczos.lanczos_top_k(op.matvec, v0, 20, 3).numpy()
    dense = np.linalg.eigh(a.astype(np.float64))[0][::-1][:3]
    np.testing.assert_allclose(evs, dense, atol=1e-4)


def test_lanczos_tiny_mlp_matches_dense_eigh():
    task, params, batch, jtask, jparams, jbatch = _tiny_mlp()
    theta, unravel = ravel_pytree(jparams)
    dense_h = jax.hessian(
        lambda t: jtask.loss_fn(unravel(t), jbatch)[0])(theta)
    dense = np.asarray(jnp.linalg.eigh(dense_h)[0])[::-1][:3]
    op = hvp.make_flat_hvp(task, params, batch)
    v0 = torch.from_numpy(_masked_normal(op.spec, 0))
    evs = lanczos.lanczos_top_k(op.matvec, v0, 30, 3).numpy()
    np.testing.assert_allclose(evs, dense, atol=1e-4)


def test_lanczos_top_eig_accumulated_matches_single():
    task, params, batch, *_ = _tiny_mlp(batch_size=32)
    spec = flatten.build_spec(params)
    v0 = torch.from_numpy(_masked_normal(spec, 0))
    op1 = hvp.make_flat_hvp(task, params, batch)
    opk = hvp.make_flat_hvp(task, params,
                            synthetic.stack_microbatches(batch, 4),
                            accum_steps=4)
    lam1 = float(lanczos.lanczos_top_k(op1.matvec, v0, 10, 1)[0])
    lamk = float(lanczos.lanczos_top_k(opk.matvec, v0, 10, 1)[0])
    assert abs(lam1 - lamk) <= 1e-5


def test_lanczos_breakdown_is_safe():
    """Operator rank < m: trailing zeros, top eigenvalues still right."""
    task, params, _, a = _quadratic(dim=4)
    op = hvp.make_flat_hvp(task, params, None)
    v0 = torch.from_numpy(_masked_normal(op.spec, 0))
    res = lanczos.lanczos(op.matvec, v0, 12)
    assert torch.isfinite(res.alphas).all()
    evs = lanczos.lanczos_top_k(op.matvec, v0, 12, 2).numpy()
    dense = np.linalg.eigh(a.astype(np.float64))[0][::-1][:2]
    np.testing.assert_allclose(evs, dense, atol=1e-4)
    with pytest.raises(ValueError, match=">= 1"):
        lanczos.lanczos(op.matvec, v0, 0)


def test_spectral_density_stem_weights():
    task, params, _, _ = _quadratic()
    op = hvp.make_flat_hvp(task, params, None)
    v0 = torch.from_numpy(_masked_normal(op.spec, 0))
    res = lanczos.lanczos(op.matvec, v0, 12)
    nodes, weights = lanczos.spectral_density_stem(res.alphas, res.betas)
    assert nodes.shape == weights.shape == (12,)
    np.testing.assert_allclose(float(weights.sum()), 1.0, atol=1e-5)


def test_slq_stem_and_density_match_reference():
    task, params, batch, jtask, jparams, jbatch = _tiny_mlp()
    op = hvp.make_flat_hvp(task, params, batch)
    jop = jhvp.make_flat_hvp(jtask, jparams, jbatch)
    v0s = _masked_normal(jop.spec, 5, lead=(3,))
    got = lanczos.slq_spectral_density(op.matvec, torch.from_numpy(v0s), 8,
                                       grid_points=32)
    want = jlanczos.slq_spectral_density(jop.matvec, jnp.asarray(v0s), 8,
                                         grid_points=32)
    _close(got.ritz.numpy(), want.ritz, 1e-4, "ritz")
    _close(got.weights.numpy(), want.weights, 1e-4, "weights")
    _close(got.grid.numpy(), want.grid, 1e-4, "grid")
    np.testing.assert_allclose(got.sigma, want.sigma, rtol=1e-4)
    _close(got.density.numpy(), want.density, 1e-3, "density")
    # the density from the reference's own stems and grid
    dens = lanczos.spectral_density(np.asarray(want.ritz),
                                    np.asarray(want.weights),
                                    np.asarray(want.grid), want.sigma)
    _close(dens.numpy(), want.density, 1e-5, "density from the same stems")


def test_lanczos_probe_matches_reference_when_converged():
    """Other seeds (a torch generator, not the JAX PRNG): the probes'
    λ_max agree once Lanczos has converged (30 iterations on 131
    parameters), to the dense-eigh bound."""
    task, params, batch, jtask, jparams, jbatch = _tiny_mlp()
    from repro.diagnostics.probes import LanczosProbe as JLanczosProbe
    from repro.training import TrainState as JTrainState
    from repro.core import build_optimizer as jbuild
    state = TrainState(0, params, None)
    got = probes.LanczosProbe(task, batch, num_iters=30, top_k=2)(0, state)
    jstate = JTrainState.create(jparams, jbuild("sgd", total_steps=1,
                                                learning_rate=0.1))
    want = JLanczosProbe(jtask, jbatch, num_iters=30, top_k=2)(0, jstate)
    assert set(got) == set(want) == {"lambda_max", "eig_2"}
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])


# ----- probes leave training alone -----

def _ops_calls(monkeypatch) -> dict:
    """Count calls into every kernel entry point of ``kernels.ops``."""
    calls = {}
    for name in ("attention_decode", "segmented_update", "lars_update",
                 "lars_norm2", "lars_apply", "rmsnorm"):
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(ops, name, counted)
    return calls


def _state_bytes(state) -> list:
    return [t.detach().clone() for t in tree_leaves(state.params)
            + tree_leaves(state.opt_state) if isinstance(t, torch.Tensor)]


def test_probes_leave_state_bitwise_and_launch_nothing(monkeypatch):
    """Each probe: params and optimizer state bitwise unchanged, no call
    into a kernel entry point (so no ``ops.launches``), while the
    per-tensor step itself goes through ``ops.lars_norm2`` and
    ``ops.lars_apply``; and a run
    with all three probes trains exactly as one without."""
    calls = _ops_calls(monkeypatch)
    data = synthetic.ClassificationData(num_classes=4, image_size=4,
                                        seed=0)
    probe_batch = data.batch(torch.Generator().manual_seed(2), 16)
    task = classifier_task(cnn.apply_mlp_classifier)

    def train(callbacks):
        params = cnn.init_mlp_classifier(0, in_dim=48, num_classes=4,
                                         hidden=16, device="cpu")
        opt = build_optimizer("wa-lars", total_steps=4, learning_rate=0.3,
                              use_kernel="per_tensor", device="cpu")
        state = TrainState.create(params, opt)
        return fit(make_train_step(task, opt), state,
                   synthetic.batch_iterator(data, 16, device="cpu"), 4,
                   options=FitOptions(callbacks=callbacks))

    plain_state, plain_hist = train([])
    step_calls = dict(calls)
    assert step_calls.get("lars_norm2", 0) > 0
    assert step_calls["lars_apply"] == step_calls["lars_norm2"]

    class Watched:
        """Runs a probe and checks it left the state and ops alone."""

        def __init__(self, probe):
            self.probe, self.name, self.every = probe, probe.name, 1
            self.runs = 0

        def __call__(self, step, state):
            before, n_calls = _state_bytes(state), dict(calls)
            launches = dict(ops.launches)
            out = self.probe(step, state)
            assert dict(calls) == n_calls and dict(ops.launches) == launches
            for a, b in zip(before, _state_bytes(state)):
                assert torch.equal(a, b)
            assert all(math.isfinite(v) for v in out.values())
            self.runs += 1
            return out

    watched = [Watched(probes.LanczosProbe(task, probe_batch, num_iters=3)),
               Watched(probes.SharpnessProbe(task, probe_batch)),
               Watched(probes.GradNoiseProbe(
                   task, synthetic.stack_microbatches(probe_batch, 4),
                   accum_steps=4))]
    state, hist = train(watched)
    assert [w.runs for w in watched] == [4, 4, 4]
    assert hist == plain_hist
    for a, b in zip(_state_bytes(state), _state_bytes(plain_state)):
        assert torch.equal(a, b)


# ----- SAM sharpness + gradient noise scale -----

def test_sam_sharpness_quadratic_closed_form():
    """For loss 0.5 wᵀAw: g = Aw and sharpness has the closed form
    ρ·‖g‖ + 0.5·ρ²·ĝᵀAĝ with ĝ = g/‖g‖."""
    task, params, _, a = _quadratic()
    rho = 0.1
    out = sharpness.sam_sharpness(task, params, None, rho=rho)
    w = params["w"].double().numpy()
    g = a.astype(np.float64) @ w
    ghat = g / np.linalg.norm(g)
    expected = rho * np.linalg.norm(g) + 0.5 * rho ** 2 * ghat @ a @ ghat
    np.testing.assert_allclose(float(out["sam_sharpness"]), expected,
                               rtol=1e-4)
    assert float(out["perturbed_loss"]) > float(out["loss"])


@pytest.mark.parametrize("k", [1, 4])
def test_sam_sharpness_matches_reference(k):
    task, params, batch, jtask, jparams, jbatch = _tiny_mlp(batch_size=32)
    before = [p.clone() for p in tree_leaves(params)]
    got = sharpness.sam_sharpness(task, params,
                                  synthetic.stack_microbatches(batch, k),
                                  accum_steps=k)
    want = jsharpness.sam_sharpness(
        jtask, jparams, jstack(jbatch, k) if k > 1 else jbatch,
        accum_steps=k)
    assert set(got) == set(want)
    for name in got:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-4, err_msg=name)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 tree_leaves(params)))


def test_sam_sharpness_accumulated_matches_single():
    task, params, batch, *_ = _tiny_mlp(batch_size=32)
    s1 = sharpness.sam_sharpness(task, params, batch)
    sk = sharpness.sam_sharpness(task, params,
                                 synthetic.stack_microbatches(batch, 4),
                                 accum_steps=4)
    np.testing.assert_allclose(float(s1["sam_sharpness"]),
                               float(sk["sam_sharpness"]), atol=1e-5)


def test_grad_noise_scale_matches_reference():
    task, params, batch, jtask, jparams, jbatch = _tiny_mlp(batch_size=32)
    got = sharpness.gradient_noise_scale(
        task, params, synthetic.stack_microbatches(batch, 4), accum_steps=4)
    want = jsharpness.gradient_noise_scale(jtask, jparams,
                                           jstack(jbatch, 4), accum_steps=4)
    assert set(got) == set(want)
    for name in got:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-3, err_msg=name)


def test_grad_noise_scale_tiled_is_zero():
    """K identical microbatches => per-microbatch grads coincide with
    the mean => tr(Σ) estimate and noise scale are 0."""
    task, params, batch, *_ = _tiny_mlp(batch_size=8)
    images, labels = batch
    tiled = (images.repeat(4, 1, 1, 1), labels.repeat(4))
    out = sharpness.gradient_noise_scale(
        task, params, synthetic.stack_microbatches(tiled, 4), accum_steps=4)
    np.testing.assert_allclose(float(out["trace_cov"]), 0.0, atol=1e-6)
    np.testing.assert_allclose(float(out["grad_noise_scale"]), 0.0,
                               atol=1e-4)


def test_grad_noise_scale_distinct_is_positive():
    task, params, batch, *_ = _tiny_mlp(batch_size=32)
    out = sharpness.gradient_noise_scale(
        task, params, synthetic.stack_microbatches(batch, 4), accum_steps=4)
    assert float(out["trace_cov"]) > 0.0
    assert float(out["grad_noise_scale"]) > 0.0
    with pytest.raises(ValueError, match=">= 2"):
        sharpness.gradient_noise_scale(task, params, batch, accum_steps=1)


# ----- landscape slices -----

def _np_direction(params, seed):
    rng = np.random.default_rng(seed)
    return {k: {n: rng.normal(size=tuple(t.shape)).astype(np.float32)
                for n, t in v.items()} for k, v in params.items()}


def test_loss_slices_match_reference():
    task, params, batch, jtask, jparams, jbatch = _tiny_mlp()
    d1, d2 = _np_direction(params, 3), _np_direction(params, 4)
    t = lambda d: tree_map(torch.from_numpy, d)         # noqa: E731
    alphas = np.asarray([-1.0, -0.25, 0.0, 0.5], np.float32)
    betas = np.asarray([-0.5, 0.0, 0.5], np.float32)
    got1 = landscape.loss_slice_1d(task, params, t(d1), batch, alphas)
    want1 = jlandscape.loss_slice_1d(jtask, jparams, d1, jbatch, alphas)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), rtol=1e-5)
    got2 = landscape.loss_slice_2d(task, params, t(d1), t(d2), batch,
                                   alphas, betas)
    want2 = jlandscape.loss_slice_2d(jtask, jparams, d1, d2, jbatch,
                                     alphas, betas)
    assert got2.shape == (4, 3)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=1e-5)


def test_loss_slice_1d_quadratic_closed_form():
    task, params, _, a = _quadratic()
    d = {"w": torch.ones_like(params["w"])}
    alphas = [-1.0, 0.0, 0.5, 1.0]
    losses = landscape.loss_slice_1d(task, params, d, None, alphas).numpy()
    w = params["w"].double().numpy()
    a64 = a.astype(np.float64)
    expected = [0.5 * (w + al) @ a64 @ (w + al) for al in alphas]
    np.testing.assert_allclose(losses, expected, rtol=1e-4)


def test_loss_slice_2d_shape_and_center():
    task, params, batch, *_ = _tiny_mlp()
    gen = torch.Generator().manual_seed(3)
    d1 = landscape.filter_normalized_direction(gen, params)
    d2 = landscape.filter_normalized_direction(gen, params)
    alphas = torch.linspace(-0.5, 0.5, 3)
    grid = landscape.loss_slice_2d(task, params, d1, d2, batch, alphas,
                                   alphas)
    assert grid.shape == (3, 3)
    base = float(task.loss_fn(params, batch)[0])
    np.testing.assert_allclose(float(grid[1, 1]), base, rtol=1e-5)


@pytest.mark.parametrize("model", ["mlp", "cnn"])
def test_filter_normalized_direction_matches_filter_norms(model):
    """Each output filter of d has its weight's filter norm: the last
    axis of a dense weight (as the reference), axis 0 of the port's
    OIHW convolution weights (the reference's HWIO last axis)."""
    if model == "mlp":
        params = _tiny_mlp()[1]
        leaf, out_axis = ("fc0", "w"), 1
    else:
        params = cnn.init_cnn(0, width=8, device="cpu")
        leaf = next((k, n) for k, v in params.items() if isinstance(v, dict)
                    for n, t in v.items() if torch.is_tensor(t)
                    and t.dim() == 4)
        out_axis = 0
    d = landscape.filter_normalized_direction(
        torch.Generator().manual_seed(0), params)
    w, dw = params[leaf[0]][leaf[1]], d[leaf[0]][leaf[1]]
    dims = tuple(i for i in range(w.dim()) if i != out_axis)
    np.testing.assert_allclose(torch.linalg.vector_norm(dw, dim=dims),
                               torch.linalg.vector_norm(w.float(), dim=dims),
                               rtol=1e-5)
    for path_leaf, dl in zip(tree_leaves(params), tree_leaves(d)):
        if path_leaf.dim() < 2:
            np.testing.assert_allclose(float(torch.linalg.vector_norm(dl)),
                                       float(torch.linalg.vector_norm(
                                           path_leaf.float())), atol=1e-6)


def test_direction_between_matches_reference():
    _, params, _, _, jparams, _ = _tiny_mlp()
    moved = tree_map(lambda p: p * 1.5 + 1.0, params)
    jmoved = jax.tree_util.tree_map(lambda p: p * 1.5 + 1.0, jparams)
    got = landscape.direction_between(params, moved)
    want = jlandscape.direction_between(jparams, jmoved)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


# ----- sinks -----

def _nan_records():
    """The same records as the port's values (torch, incl. 0-d/1-d and
    bf16) and as the reference's (numpy)."""
    vec = np.asarray([0.1, float("nan"), 2.5], np.float32)
    bf = torch.tensor(1.3, dtype=torch.bfloat16)
    port = [
        (0, {"loss": 1.5, "n": 3, "flag": True, "name": "x", "none": None}),
        (1, {"nan": float("nan"), "inf": float("inf"),
             "ninf": float("-inf")}),
        (2, {"scalar": torch.tensor(0.1), "vec": torch.from_numpy(vec),
             "i": torch.tensor(5), "bf": bf, "np": np.float32(0.7),
             "grad": torch.tensor(2.0, requires_grad=True) * 1.5}),
    ]
    ref = [
        port[0], port[1],
        (2, {"scalar": np.asarray(np.float32(0.1)), "vec": vec,
             "i": np.asarray(5), "bf": np.float32(float(bf)),
             "np": np.float32(0.7), "grad": np.asarray(np.float32(3.0))}),
    ]
    return port, ref


def test_jsonl_sink_byte_identical_to_reference(tmp_path):
    port, ref = _nan_records()
    a, b = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    with sink_lib.JsonlSink(str(a), static={"run": "t", "k": 2}) as s:
        for step, m in port:
            s.write(step, m)
    with jsink.JsonlSink(str(b), static={"run": "t", "k": 2}) as s:
        for step, m in ref:
            s.write(step, m)
    assert a.read_bytes() == b.read_bytes()
    assert "NaN" not in a.read_text() and "Infinity" not in a.read_text()
    assert sink_lib.validate_jsonl(str(a)) == 3


_SCHEMA_CASES = {
    "ok": '{"step": 0, "loss": 1.0}\n\n{"step": 1, "v": [1, null]}\n',
    "no_step": '{"no_step": 1}\n',
    "bool_step": '{"step": true}\n',
    "float_step": '{"step": 1.0}\n',
    "not_json": "not json\n",
    "not_object": "[1, 2]\n",
    "nested": '{"step": 0, "d": {"a": 1}}\n',
    "trace_ok": '{"step": 0, "trace": "v1", "kind": "span", "name": "a", '
                '"ts_us": 1.0, "dur_us": 2.0}\n{"step": 0, "trace": "v1", '
                '"kind": "counter", "name": "c", "ts_us": 0, "value": 3}\n',
    "trace_version": '{"step": 0, "trace": "v2", "kind": "span", '
                     '"name": "a", "ts_us": 1.0, "dur_us": 2.0}\n',
    "trace_kind": '{"step": 0, "trace": "v1", "kind": "blip", "name": "a", '
                  '"ts_us": 1.0}\n',
    "trace_name": '{"step": 0, "trace": "v1", "kind": "instant", '
                  '"name": "", "ts_us": 1.0}\n',
    "trace_ts": '{"step": 0, "trace": "v1", "kind": "instant", "name": "a", '
                '"ts_us": -1}\n',
    "span_no_dur": '{"step": 0, "trace": "v1", "kind": "span", "name": "a", '
                   '"ts_us": 1.0}\n',
    "counter_bool": '{"step": 0, "trace": "v1", "kind": "counter", '
                    '"name": "a", "ts_us": 1.0, "value": true}\n',
}


@pytest.mark.parametrize("case", sorted(_SCHEMA_CASES))
def test_validate_jsonl_agrees_with_reference(case, tmp_path):
    path = tmp_path / f"{case}.jsonl"
    path.write_text(_SCHEMA_CASES[case])
    results = []
    for validate in (sink_lib.validate_jsonl, jsink.validate_jsonl):
        try:
            results.append(("ok", validate(str(path), counts=True)))
        except ValueError as e:
            results.append(("error", str(e)))
    assert results[0] == results[1]
    assert (results[0][0] == "ok") == (case in ("ok", "trace_ok"))


def test_jsonl_sink_truncates_and_encodes_nonfinite_as_null(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with sink_lib.JsonlSink(path) as sink:
        sink.write(0, {"stale": 1.0})
    with sink_lib.JsonlSink(path) as sink:
        sink.write(0, {"loss": float("nan"), "lam": torch.tensor(
            float("inf"))})
    lines = open(path).read().strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["loss"] is None and rec["lam"] is None
    with pytest.raises(ValueError, match="mode"):
        sink_lib.JsonlSink(path, mode="x")
    with sink_lib.JsonlSink(path, mode="a") as sink:
        sink.write(1, {"loss": 2.0})
    assert sink_lib.validate_jsonl(path) == 2


def test_csv_sink_and_export_recorder(tmp_path):
    """The port's CsvSink + export_recorder write the reference's
    bytes for the same recorder history."""
    from repro.core.instrumentation import LayerNorms as JLayerNorms
    from repro.core.instrumentation import NormRecorder as JNormRecorder
    rec = NormRecorder({"w": torch.ones((2, 2))})
    jrec = JNormRecorder({"w": jnp.ones((2, 2))})
    for i in range(3):
        rec.record(i, LayerNorms(torch.tensor([1.0 + i]),
                                 torch.tensor([2.0]),
                                 torch.tensor([0.5 + i])))
        jrec.record(i, JLayerNorms(lwn=jnp.asarray([1.0 + i]),
                                   lgn=jnp.asarray([2.0]),
                                   lnr=jnp.asarray([0.5 + i])))
    paths = []
    for lib, r, name in ((sink_lib, rec, "port"), (jsink, jrec, "ref")):
        path = tmp_path / f"{name}.csv"
        with lib.CsvSink(str(path), fieldnames=["step", "opt", "lwn", "lgn",
                                                "lnr"]) as sink:
            assert lib.export_recorder(r, sink,
                                       extra={"opt": "tvlars"}) == 3
        paths.append(path)
    rows = paths[0].read_text().strip().splitlines()
    assert rows[0] == "step,opt,lwn,lgn,lnr"
    assert rows[1].startswith("0,tvlars,1.0,2.0,0.5") and len(rows) == 4
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_csv_sink_rejects_disjoint_rows(tmp_path):
    with sink_lib.CsvSink(str(tmp_path / "t.csv")) as sink:
        sink.write(0, {"loss": 1.0})
        with pytest.raises(ValueError, match="JsonlSink"):
            sink.write(0, {"lanczos/lambda_max": 3.0})


def test_multi_null_memory_and_buffered_sinks(tmp_path):
    got = []

    class ListSink(sink_lib.MetricsSink):
        def write(self, step, metrics, *, last=False):
            got.append((step, dict(metrics)))

    memory = sink_lib.MemorySink()
    multi = sink_lib.MultiSink(ListSink(), sink_lib.NullSink(), memory)
    multi.write(3, {"a": 1.0})
    multi.write(4, {"b": torch.tensor(2.0)})
    multi.close()
    assert got[0] == (3, {"a": 1.0})
    assert memory.records == [{"step": 3, "a": 1.0}, {"step": 4, "b": 2.0}]
    assert memory.by_key("b") == [(4, 2.0)]
    # the buffered sink writes the same bytes, in order, as the sink itself
    direct, buffered = tmp_path / "d.jsonl", tmp_path / "b.jsonl"
    with sink_lib.JsonlSink(str(direct)) as s:
        for i in range(50):
            s.write(i, {"x": float(i), "y": torch.tensor([i, i + 1.0])})
    bs = sink_lib.BufferedSink(sink_lib.JsonlSink(str(buffered)),
                               capacity=4)
    metrics = {}
    for i in range(50):
        metrics.update(x=float(i), y=torch.tensor([i, i + 1.0]))
        bs.write(i, metrics)          # the caller may reuse its dict
    bs.flush()
    bs.close()
    bs.close()
    assert direct.read_bytes() == buffered.read_bytes()
    with pytest.raises(ValueError, match="closed"):
        bs.write(0, {"x": 1.0})


def test_console_sink_matches_reference_line():
    """``fit``'s console line through ConsoleSink: ``step {i:5d}
    k=v.vvvv`` for every float metric, every ``log_every``-th step and
    the last, the reference's ConsoleSink line for the same metrics."""
    task, params, _, *_ = _tiny_mlp()
    data = synthetic.ClassificationData(num_classes=3, image_size=2, seed=0)
    opt = build_optimizer("sgd", total_steps=4, learning_rate=0.1)
    lines = []
    _, hist = fit(make_train_step(task, opt), TrainState.create(params, opt),
                  synthetic.batch_iterator(data, 16, device="cpu"), 4,
                  options=FitOptions(log_every=2, log_fn=lines.append))
    ref_lines = []
    ref = jsink.ConsoleSink(every=2, log_fn=ref_lines.append)
    for i, h in enumerate(hist):
        ref.write(i, h, last=i == 3)
    assert lines == ref_lines
    assert lines[0].startswith("step     0 loss=") and len(lines) == 3


def test_fit_sink_and_probe_callbacks_jsonl(tmp_path):
    task, params, _, *_ = _tiny_mlp()
    data = synthetic.ClassificationData(num_classes=3, image_size=2, seed=0)
    opt = build_optimizer("tvlars", total_steps=4, learning_rate=0.3)
    probe_batch = data.batch(torch.Generator().manual_seed(9), 8)
    path = str(tmp_path / "m.jsonl")
    with sink_lib.JsonlSink(path, static={"tag": "t"}) as sink:
        _, hist = fit(make_train_step(task, opt),
                      TrainState.create(params, opt),
                      synthetic.batch_iterator(data, 16, device="cpu"), 4,
                      options=FitOptions(sink=sink, callbacks=[
                          probes.LanczosProbe(task, probe_batch, every=2,
                                              num_iters=2),
                          probes.SharpnessProbe(task, probe_batch,
                                                every=4),
                      ]))
    assert sink_lib.validate_jsonl(path) == 4 + 2 + 1
    assert jsink.validate_jsonl(path) == 4 + 2 + 1
    recs = [json.loads(line) for line in open(path)]
    assert all(r["tag"] == "t" for r in recs)
    lam = [r for r in recs if "lanczos/lambda_max" in r]
    assert [r["step"] for r in lam] == [0, 2]
    sam = [r for r in recs if "sharpness/sam_sharpness" in r]
    assert [r["step"] for r in sam] == [0]
    assert set(sam[0]) == {"step", "tag", "sharpness/sam_sharpness",
                           "sharpness/loss", "sharpness/perturbed_loss"}
    train = [r for r in recs if "loss" in r]
    assert [r["step"] for r in train] == [0, 1, 2, 3]
    assert all(not any("/" in k for k in h) for h in hist)   # not history


def test_fit_closes_only_what_it_should(tmp_path):
    task, params, _, *_ = _tiny_mlp()
    data = synthetic.ClassificationData(num_classes=3, image_size=2, seed=0)
    opt = build_optimizer("sgd", total_steps=2, learning_rate=0.1)
    for close in (False, True):
        sink = sink_lib.JsonlSink(str(tmp_path / f"{close}.jsonl"))
        fit(make_train_step(task, opt), TrainState.create(params, opt),
            synthetic.batch_iterator(data, 8, device="cpu"), 2,
            options=FitOptions(sink=sink, close_sink=close))
        assert sink._f.closed == close
        sink.close()


def test_gradnoise_probe_requires_stacked_batch():
    task, params, batch, *_ = _tiny_mlp()
    with pytest.raises(ValueError, match=">= 2"):
        probes.GradNoiseProbe(task, batch, accum_steps=1)
    stacked = synthetic.stack_microbatches(batch, 4)
    probe = probes.GradNoiseProbe(task, stacked, accum_steps=4, every=1)
    out = probe(0, TrainState(0, params, None))
    assert math.isfinite(out["grad_noise_scale"])
    with pytest.raises(ValueError, match="top_k"):
        probes.LanczosProbe(task, batch, num_iters=2, top_k=3)


def test_probe_schedule():
    assert probes.should_run(0, 5)
    assert probes.should_run(10, 5)
    assert not probes.should_run(3, 5)
    assert not probes.should_run(0, 0)

    class Odd:
        every = 1

        def due(self, step):
            return step % 2 == 1

    assert [probes.probe_due(Odd(), i) for i in range(4)] == \
        [False, True, False, True]
    assert isinstance(probes.SharpnessProbe(None, None), probes.Probe)


# ----- the trace export and the entry points -----

def test_tracer_export_writes_the_former_records(tmp_path):
    """``Tracer.export`` through a ``JsonlSink`` writes the bytes the
    launchers' former writer wrote: ``{"step": rec.pop("step", 0),
    **rec}`` per record, in order."""
    tracer = obs_trace.Tracer()
    for i in range(3):
        with tracer.span("loss_grad", step=i):
            pass
        with tracer.span("probe", step=i, probe="lanczos"):
            pass
    tracer.instant("switch", k=4)
    tracer.counter("batch", 16.0, step=2)
    expected = []
    for rec in tracer.events():
        rec = dict(rec)
        expected.append(json.dumps({"step": rec.pop("step", 0), **rec})
                        + "\n")
    path = tmp_path / "t.jsonl"
    with sink_lib.JsonlSink(str(path)) as sink:
        assert tracer.export(sink) == 8
    assert path.read_text() == "".join(expected)
    assert len(tracer) == 0                      # drained
    assert jsink.validate_jsonl(str(path), counts=True) == (8, 8)


def test_launch_train_probes_metrics_and_trace(tmp_path):
    metrics, trace = str(tmp_path / "m.jsonl"), str(tmp_path / "t.jsonl")
    out = launch_train.run(
        ["--smoke", "--device", "cpu", "--steps", "2", "--seq", "16",
         "--global-batch", "4", "--microbatch", "2", "--optimizer",
         "wa-lars", "--use-kernel", "per_tensor", "--probe-every", "1",
         "--probe-iters", "3", "--probe-topk", "2", "--metrics-out",
         metrics, "--trace-out", trace], log_fn=lambda *_: None)
    assert sink_lib.validate_jsonl(metrics) == jsink.validate_jsonl(
        metrics) == 4
    recs = [json.loads(line) for line in open(metrics)]
    assert all(r["arch"] == "qwen2.5-3b" and r["optimizer"] == "wa-lars"
               and r["global_batch"] == 4 for r in recs)
    assert [r["step"] for r in out["probes"]] == [0, 1]
    assert all(set(r) >= {"lanczos/lambda_max", "lanczos/eig_2"}
               and r["lanczos/lambda_max"] >= r["lanczos/eig_2"]
               for r in out["probes"])
    assert all(p > 0 for p in out["probe_seconds"])
    n, n_trace = jsink.validate_jsonl(trace, counts=True)
    assert n == n_trace > 0
    names = {json.loads(line)["name"] for line in open(trace)}
    assert names == {"data_wait", "dispatch", "loss_grad", "optimizer",
                     "resolve", "probe"}
    assert all(v == 0 for v in ops.launches.values())


def test_diagnostics_smoke_cpu(tmp_path):
    path = diag_smoke.run(str(tmp_path), steps=2, probe_every=2,
                          num_iters=2, device="cpu")
    assert sink_lib.validate_jsonl(path) >= 2
    diag_smoke.main(["--device", "cpu", "--steps", "2", "--out",
                     str(tmp_path / "cli")])


def test_launch_sharpness_cpu(tmp_path):
    out = launch_sharpness.run(["--device", "cpu", "--steps", "6", "--out",
                                str(tmp_path)], log_fn=lambda *_: None)
    assert set(out["early"]) == {"wa-lars", "tvlars"}
    for opt, paths in out["paths"].items():
        assert [s for s, _ in out["trajectories"][opt]] == [0, 5]
        for path in paths:
            assert sink_lib.validate_jsonl(path) >= 1
            jsink.validate_jsonl(path)
    slq = json.loads(open(out["paths"]["tvlars"][1]).read())
    assert len(slq["grid"]) == len(slq["density"]) == 64
    assert math.isfinite(out["ratio"]) and out["ratio"] > 0


def test_entry_points_refuse_cuda_without_it(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        diag_smoke.run(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_sharpness.run(["--out", str(tmp_path)])
