"""The optimizer family of ``repro_torch`` against the JAX package.

* Schedules and the shared elementwise math (``direction``,
  ``integrate``, ``trust_ratio``, ``scales_from_ratio``,
  ``stochastic_round_to``) on the same numpy inputs: relative 1e-6
  (f32, one rounding apart at most); stochastic rounding bit for bit.
* ``build_optimizer`` for all 7 names over the tree path and (for the
  layer-wise ones) the fused path at every precision, 3 steps on a
  mixed-shape tree against the JAX package's same path (its fused path
  through the Pallas kernels in interpret mode). Params after the
  steps within ``parity_tolerance(precision, steps)`` (f32: 1e-6
  relative with an absolute floor at the params' scale, ROADMAP F1),
  per-step updates within the same bound relative to the update's
  scale (TVLARS's Algorithm-1 delta: the params' scale), fused bf16
  state within one storage ulp (rtol = atol = 2^-7, the reference
  tests' bound).
* The build-time errors, and the port's own: the fused path refuses
  params on another device than it was built for. (The per-tensor
  path is held against the reference in ``test_torch_lars_update``.)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import apply_updates as japply
from repro.core import build_optimizer as jbuild
from repro.core import schedules as jsched
from repro.core.instrumentation import layer_norms as jlayer_norms
from repro.core.base import global_norm as jglobal_norm
from repro.kernels import ref as jref
from repro_torch import core
from repro_torch.core import schedules
from repro_torch.core.base import tree_leaves
from repro_torch.kernels import ref

SHAPES = {"dense": {"w": (8, 16), "b": (16,)}, "odd": (7,),
          "t3": (3, 5, 13), "head": (33, 65), "big": (130, 100)}
STEPS = 3


def _close(got, want, rtol=1e-6, atol=1e-7, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

STEP_GRID = np.array([0, 1, 2, 5, 9, 10, 11, 50, 99, 100, 150])

SCHEDULES = [
    ("warmup_cosine", (0.8, 10, 100), {}),
    ("warmup_cosine", (0.8, 10, 100), {"min_lr": 0.05}),
    ("polynomial", (0.8, 100), {}),
    ("polynomial", (0.8, 100), {"power": 1.0, "min_lr": 0.1}),
    ("tvlars_phi", (1e-2, 20), {}),
    ("tvlars_phi", (5.0, 20), {"alpha": 2.0, "gamma_min": 0.01}),
]


@pytest.mark.parametrize("name,args,kw", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(SCHEDULES)])
def test_schedules_match_reference(name, args, kw):
    want = [float(getattr(jsched, name)(*args, **kw)(jnp.int32(s)))
            for s in STEP_GRID]
    fn = getattr(schedules, name)(*args, **kw)
    got = [float(fn(torch.tensor(int(s), dtype=torch.int32)))
           for s in STEP_GRID]
    _close(got, want, what=name)
    assert fn(3).dtype == torch.float32


def test_tvlars_bounds_and_batch_scaling_match_reference():
    assert schedules.tvlars_phi_bounds(1e-3, 50, 1.0, 0.01) \
        == jsched.tvlars_phi_bounds(1e-3, 50, 1.0, 0.01)
    for rule in ("sqrt", "linear"):
        assert schedules.batch_scaled_lr(2.0, 4096, 256, rule) \
            == jsched.batch_scaled_lr(2.0, 4096, 256, rule)
    stateful = schedules.batch_scaled_lr(2.0, base_batch_size=256,
                                         batch_size_fn=lambda: 1024)
    assert stateful() == jsched.batch_scaled_lr(2.0, 1024, 256)
    with pytest.raises(ValueError):
        schedules.batch_scaled_lr(2.0)
    with pytest.raises(ValueError, match="rule"):
        schedules.batch_scaled_lr(2.0, 512, 256, "cubic")


# ---------------------------------------------------------------------------
# shared elementwise math
# ---------------------------------------------------------------------------

def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)


@pytest.mark.parametrize("mode", ["lars", "paper", "lamb"])
@pytest.mark.parametrize("nesterov", [False, True])
def test_direction_and_integrate_match_reference(mode, nesterov):
    w, g, m, v = _rand(0, 64, 128), _rand(1, 64, 128), \
        _rand(2, 64, 128, scale=0.1), np.abs(_rand(3, 64, 128, scale=0.01))
    bufs = (m, v) if mode == "lamb" else (m,)
    kw = dict(b1=0.9, b2=0.999, eps=1e-6)
    jd, jb = jref.direction(mode, jnp.asarray(w), jnp.asarray(g),
                            tuple(map(jnp.asarray, bufs)),
                            bc1=jnp.float32(0.271), bc2=jnp.float32(0.003),
                            **kw)
    td, tb = ref.direction(mode, torch.from_numpy(w), torch.from_numpy(g),
                           tuple(map(torch.from_numpy, bufs)),
                           bc1=torch.tensor(0.271), bc2=torch.tensor(0.003),
                           **kw)
    _close(td, jd, rtol=2e-6, what="direction")
    for a, b in zip(tb, jb):
        _close(a, b, what="moments")
    scaled = _rand(4, 64, 128, scale=1e-3)
    jn, jdelta = jref.integrate(mode, jnp.asarray(w), jb,
                                jnp.asarray(scaled), momentum=0.9,
                                nesterov=nesterov)
    tn, tdelta = ref.integrate(mode, torch.from_numpy(w), tb,
                               torch.from_numpy(scaled), momentum=0.9,
                               nesterov=nesterov)
    # the paper mode's delta cancels (w - scaled) - w: compare it at
    # the params' scale
    _close(tdelta, jdelta, atol=1e-6, what="delta")
    for a, b in zip(tn, jn):
        _close(a, b, what="state")


@pytest.mark.parametrize("mode", ["lars", "lamb"])
@pytest.mark.parametrize("trust_clip", [None, 0.05])
def test_trust_ratio_and_table_match_reference(mode, trust_clip):
    w2 = np.array([4.0, 0.0, 9.0, 1e-6, 25.0, 3.0], np.float32)
    b2 = np.array([1.0, 2.0, 0.0, 4.0, 1e-4, 2.0], np.float32)
    adapt = np.array([1, 1, 1, 1, 1, 0], bool)
    kw = dict(mode=mode, eta=1e-3, weight_decay=5e-4, eps=1e-9,
              trust_clip=trust_clip)
    want = jref.trust_ratio(jnp.asarray(w2), jnp.asarray(b2),
                            jnp.asarray(adapt), **kw)
    got = ref.trust_ratio(torch.from_numpy(w2), torch.from_numpy(b2),
                          torch.from_numpy(adapt), **kw)
    for a, b in zip(got, want):
        _close(a, b)
    jtab = jref.trust_scale_table(jnp.asarray(w2), jnp.asarray(b2),
                                  jnp.asarray(adapt), jnp.float32(0.3), **kw)
    ttab = ref.trust_scale_table(torch.from_numpy(w2), torch.from_numpy(b2),
                                 torch.from_numpy(adapt),
                                 torch.tensor(0.3), **kw)
    assert ttab.shape == (2, 6) and ttab.dtype == torch.float32
    _close(ttab, jtab)


def test_stochastic_round_and_store_bitwise():
    x = np.concatenate([_rand(5, 4096), [np.inf, -np.inf, np.nan, 0.0,
                                         1.0, -0.0]]).astype(np.float32)
    idx = np.arange(x.size, dtype=np.int64) + 2 ** 31 - 100
    jbits = jref.hash_bits(jnp.asarray(idx.astype(np.uint32)), 3)
    want = np.asarray(jref.stochastic_round_to(jnp.asarray(x), jbits,
                                               jnp.bfloat16))
    tbits = ref.hash_bits(torch.from_numpy(idx), 3)
    got = ref.stochastic_round_to(torch.from_numpy(x), tbits,
                                  torch.bfloat16)
    fin = np.isfinite(x)
    np.testing.assert_array_equal(got.view(torch.int16).numpy()[fin],
                                  want.view(np.int16)[fin])
    np.testing.assert_array_equal(np.isnan(got.float().numpy()),
                                  np.isnan(want.astype(np.float32)))
    rn = ref.store(torch.from_numpy(x), torch.bfloat16)
    np.testing.assert_array_equal(
        rn.view(torch.int16).numpy()[fin],
        np.asarray(jref.store(jnp.asarray(x), jnp.bfloat16))
        .view(np.int16)[fin])
    assert ref.stochastic_round_to(torch.ones(3), tbits[:3],
                                   torch.float32).dtype == torch.float32


def test_parity_tolerance_is_the_reference_model():
    for p in ("f32", "bf16_master", "bf16_master_sr"):
        for steps in (1, 3):
            assert ref.parity_tolerance(p, steps) \
                == jref.parity_tolerance(p, steps)


# ---------------------------------------------------------------------------
# build_optimizer: 3 steps against the JAX package
# ---------------------------------------------------------------------------

def _problem():
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s) * 0.3).astype(np.float32), SHAPES,
        is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        for _ in range(STEPS)]
    return params, grads


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


CASES = [(name, False, "f32") for name in core.OPTIMIZERS] + [
    (name, "fused", p) for name in core.OPTIMIZERS if name != "sgd"
    for p in ("f32", "bf16_master", "bf16_master_sr")]


@pytest.mark.parametrize("name,use_kernel,precision", CASES,
                         ids=[f"{n}-{'fused' if k else 'tree'}-{p}"
                              for n, k, p in CASES])
def test_build_optimizer_matches_reference(name, use_kernel, precision):
    params, grads = _problem()
    hyper = dict(total_steps=10, learning_rate=0.5, batch_size=512,
                 use_kernel=use_kernel, precision=precision)
    jopt = jbuild(name, **hyper)
    topt = core.build_optimizer(name, device="cpu", **hyper)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = _torch_tree(params)
    js, ts = jopt.init(jp), topt.init(tp)
    tol = ref.parity_tolerance(precision, STEPS)
    for g in grads:
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(_torch_tree(g), ts, tp)
        for a, b, w in zip(tree_leaves(tu), jax.tree_util.tree_leaves(ju),
                           jax.tree_util.tree_leaves(jp)):
            # TVLARS's Algorithm-1 momentum forms its delta as
            # (w - scaled) - w: exact only to the params' last bit
            ref_arr = w if name == "tvlars" else b
            scale = max(float(np.abs(np.asarray(ref_arr)).max()), 1e-30)
            _close(a, b, rtol=tol["rtol"], atol=tol["atol"] * scale,
                   what="update")
        jp = japply(jp, ju)
        tp = core.apply_updates(tp, tu)
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        scale = float(np.abs(np.asarray(b)).max())
        _close(a, b, rtol=tol["rtol"], atol=tol["atol"] * scale,
               what="params")
    assert int(ts.step) == STEPS
    if use_kernel == "fused":
        for a, b in zip(ts[1:], js[1:]):
            assert a.dtype == (torch.float32 if precision == "f32"
                               else torch.bfloat16)
            _close(a.float(), np.asarray(b, np.float32), rtol=2.0 ** -7,
                   atol=2.0 ** -7, what="flat state")


def test_norms_match_reference():
    params, grads = _problem()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jg = jax.tree_util.tree_map(jnp.asarray, grads[0])
    want = jlayer_norms(jp, jg)
    got = core.layer_norms(_torch_tree(params), _torch_tree(grads[0]))
    for a, b in zip(got, want):
        _close(a, b, rtol=1e-6)
    _close(core.global_norm(_torch_tree(grads[0])), jglobal_norm(jg),
           rtol=1e-6)


# ---------------------------------------------------------------------------
# build-time errors
# ---------------------------------------------------------------------------

ERRORS = [
    ("unknown-name", dict(name="adam"), ValueError),
    ("sgd-kernel", dict(name="sgd", use_kernel="fused"), ValueError),
    ("sgd-precision", dict(name="sgd", precision="bf16_master"),
     ValueError),
    ("precision-tree", dict(name="lars", precision="bf16_master"),
     ValueError),
    ("precision-unknown", dict(name="lamb", use_kernel="fused",
                               precision="fp8"), ValueError),
    ("use-kernel-unknown", dict(name="tvlars", use_kernel="tensor"),
     ValueError),
    ("momentum-style", dict(name="tvlars", momentum_style="adam"),
     ValueError),
]


@pytest.mark.parametrize("case,kw,exc", ERRORS, ids=[e[0] for e in ERRORS])
def test_build_time_errors_match_reference(case, kw, exc):
    kw = dict(kw)
    name = kw.pop("name")
    with pytest.raises(exc):
        jbuild(name, total_steps=10, **kw)
    with pytest.raises(exc):
        core.build_optimizer(name, total_steps=10, device="cpu", **kw)


def test_fused_substrate_refuses_params_on_another_device():
    opt = core.build_optimizer("tvlars", total_steps=10,
                               use_kernel="fused", device="cpu")
    params = {"w": torch.ones(4, 4, device="meta")}
    with pytest.raises(ValueError, match="params lie on"):
        opt.init(params)
