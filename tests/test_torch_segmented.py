"""The segmented optimizer step of ``repro_torch`` against the JAX
package's fused Pallas kernels (interpret mode on the CPU, as the JAX
package's own tests run them).

``segmented_update_ref`` (the plain version the CUDA kernels are held
to on the card) runs every mode × nesterov × trust_clip × precision on
a flat buffer of several kernel tiles (1536 rows at f32, 2048 at bf16:
3 and 2 grid steps of the reference), segments from 1 element to
several tiles, and the telemetry triple. Tolerances (ROADMAP F1: the
two packages sum the norms in other orders, and XLA contracts the
elementwise arithmetic into FMAs where PyTorch rounds every op):

* telemetry (norms, trust ratios): relative 1e-5;
* the f32 delta and f32 state: ``parity_tolerance("f32")`` (1e-6)
  relative, with the absolute floor scaled to the array's magnitude;
* bf16 state: at most one storage ulp apart, as the reference's own
  tests hold it (rtol = atol = 2^-7).

``kernels.ops.segmented_update`` on CPU tensors is the plain version
with the state updated in place, and counts no launch.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flatten as jflatten
from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import segmented_update as su

SHAPES = {"big": (600, 200), "w": (64, 96), "b": (96,), "t3": (3, 5, 13),
          "odd": (7,), "head": (33, 65), "e": (257, 129)}
PRECISIONS = ["f32", "bf16_master", "bf16_master_sr"]
HYPER = dict(eta=1e-3, weight_decay=5e-4, momentum=0.9, b1=0.9, b2=0.999,
             eps=1e-6)
BASE_LR, BC1, BC2, SEED = 0.7, 0.19, 0.002, 5


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _problem(mode: str, precision: str):
    """Reference-packed flat buffers at the policy's storage dtype."""
    rng = np.random.default_rng(0)
    tree = {k: jnp.asarray(rng.normal(size=s).astype(np.float32) * 0.3)
            for k, s in SHAPES.items()}
    dtype = jnp.float32 if precision == "f32" else jnp.bfloat16
    spec = jflatten.build_spec(tree, dtype=dtype)

    def packed(scale, seed, absval=False):
        r = np.random.default_rng(seed)
        t = {k: r.normal(size=v.shape).astype(np.float32) * scale
             for k, v in tree.items()}
        if absval:
            t = {k: np.abs(v) for k, v in t.items()}
        return jflatten.pack_tree(
            {k: jnp.asarray(v) for k, v in t.items()}, spec)

    w = jflatten.pack_tree(tree, spec)
    g = packed(1.0, 1)
    bufs = (packed(0.1, 2),) if mode != "lamb" \
        else (packed(0.1, 2), packed(0.05, 3, absval=True))
    return spec, w, g, bufs


def _kwargs(spec, mode, nesterov, trust_clip, precision, *, torch_side):
    kw = dict(HYPER, mode=mode, nesterov=nesterov, trust_clip=trust_clip,
              stochastic_round=precision.endswith("_sr"), telemetry=True)
    if torch_side:
        kw.update(seg_ids=_to_torch(spec.segment_ids()),
                  adapt_mask=_to_torch(spec.adapt_mask()),
                  base_lr=torch.tensor(BASE_LR), bc1=torch.tensor(BC1),
                  bc2=torch.tensor(BC2),
                  seed=torch.tensor(SEED, dtype=torch.int32))
    else:
        kw.update(seg_ids=spec.segment_ids(), adapt_mask=spec.adapt_mask(),
                  base_lr=jnp.float32(BASE_LR), bc1=jnp.float32(BC1),
                  bc2=jnp.float32(BC2), seed=jnp.int32(SEED))
    return kw


def _close_f32(got, want, what):
    got, want = _f32(got), _f32(want)
    tol = ref.parity_tolerance("f32")
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    print(f"{what}: max |diff| {err:.3e} (scale {scale:.3g})")
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale, err_msg=what)


def _within_one_bf16_ulp(got, want, what):
    """One storage ulp as the reference's own tests hold bf16 state
    (``tests/test_precision.py``: rtol = atol = 2^-7): where
    ``b·m + (1-b)·g`` nearly cancels, an FMA and two roundings differ
    in the f32 operands' last bit, far below one bf16 step of them."""
    got, want = _f32(got), _f32(want)
    diff = np.abs(got - want)
    print(f"{what}: {int((diff > 0).sum())} elements differ, "
          f"max {float(diff.max()):.3e}")
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=2.0 ** -7,
                               err_msg=what)


CASES = [(m, n, c, p) for m in ("lars", "paper", "lamb")
         for n in (False, True) for c in (None, 0.5) for p in PRECISIONS]


@pytest.mark.parametrize("mode,nesterov,trust_clip,precision", CASES,
                         ids=[f"{m}-{'nest' if n else 'hb'}-"
                              f"{'clip' if c else 'noclip'}-{p}"
                              for m, n, c, p in CASES])
def test_plain_version_matches_jax_kernel(mode, nesterov, trust_clip,
                                          precision):
    spec, w, g, bufs = _problem(mode, precision)
    assert spec.num_rows // spec.block_rows >= 2     # a multi-tile grid
    jbufs, jdelta, jtel = jops.segmented_update(
        w, g, bufs, **_kwargs(spec, mode, nesterov, trust_clip, precision,
                              torch_side=False))
    tbufs, tdelta, ttel = su.segmented_update_ref(
        _to_torch(w), _to_torch(g), tuple(_to_torch(b) for b in bufs),
        **_kwargs(spec, mode, nesterov, trust_clip, precision,
                  torch_side=True))
    for k in ("w_norm", "g_norm", "trust_ratio"):
        np.testing.assert_allclose(ttel[k].numpy(), np.asarray(jtel[k]),
                                   rtol=1e-5, err_msg=k)
    assert tdelta.dtype == torch.float32
    _close_f32(tdelta, jdelta, "delta")
    for k, (tb, jb) in enumerate(zip(tbufs, jbufs)):
        assert tb.dtype == _to_torch(jb).dtype
        if precision == "f32":
            _close_f32(tb, jb, f"state {k}")
        else:
            _within_one_bf16_ulp(tb, jb, f"state {k}")


@pytest.mark.parametrize("mode", ["lars", "paper", "lamb"])
def test_ops_on_cpu_updates_state_in_place_without_launching(mode):
    spec, w, g, bufs = _problem(mode, "bf16_master_sr")
    kw = _kwargs(spec, mode, False, None, "bf16_master_sr",
                 torch_side=True)
    w_t, g_t = _to_torch(w), _to_torch(g)
    state = tuple(_to_torch(b) for b in bufs)
    want_bufs, want_delta, want_tel = su.segmented_update_ref(
        w_t, g_t, tuple(b.clone() for b in state), **kw)
    before = dict(ops.launches)
    delta = torch.full(w_t.shape, 9.0)
    got_bufs, got_delta, got_tel = ops.segmented_update(
        w_t, g_t, state, delta=delta, **kw)
    assert ops.launches == before
    assert got_delta is delta and all(a is b for a, b in zip(got_bufs,
                                                               state))
    assert torch.equal(delta, want_delta)
    for a, b in zip(state, want_bufs):
        assert torch.equal(a, b)
    assert torch.equal(got_tel["trust_ratio"], want_tel["trust_ratio"])


@pytest.mark.parametrize("precision", ["f32", "bf16_master_sr"])
def test_apply_on_a_row_subset_equals_whole_buffer(precision):
    """What the card check recomputes: the plain apply of chosen rows,
    with their global row numbers for the rounding hash."""
    spec, w, g, bufs = _problem("lamb", precision)
    kw = _kwargs(spec, "lamb", False, 10.0, precision, torch_side=True)
    w_t, g_t = _to_torch(w), _to_torch(g)
    state = tuple(_to_torch(b) for b in bufs)
    table = torch.tensor(np.random.default_rng(4).uniform(
        0.01, 1.0, size=(2, spec.num_segments)), dtype=torch.float32)
    common = dict(mode="lamb", b1=0.9, b2=0.999, eps=1e-6, bc1=kw["bc1"],
                  bc2=kw["bc2"], stochastic_round=kw["stochastic_round"],
                  seed=kw["seed"])
    full_bufs, full_delta = su.seg_apply_ref(w_t, g_t, state,
                                             kw["seg_ids"], table, **common)
    rows = torch.tensor([0, 5, 700, 1101, spec.num_rows - 1])
    sub_bufs, sub_delta = su.seg_apply_ref(
        w_t[rows], g_t[rows], tuple(b[rows] for b in state),
        kw["seg_ids"][rows], table, rows=rows, **common)
    assert torch.equal(sub_delta, full_delta[rows])
    for a, b in zip(sub_bufs, full_bufs):
        assert torch.equal(a, b[rows])


def test_plain_chunking_changes_no_value(monkeypatch):
    spec, w, g, bufs = _problem("paper", "bf16_master_sr")
    kw = _kwargs(spec, "paper", False, None, "bf16_master_sr",
                 torch_side=True)
    args = (_to_torch(w), _to_torch(g), tuple(_to_torch(b) for b in bufs))
    whole = su.segmented_update_ref(*args, **kw)
    monkeypatch.setattr(su, "PLAIN_CHUNK_ROWS", 100)
    chunked = su.segmented_update_ref(*args, **kw)
    assert torch.equal(whole[1], chunked[1])
    assert torch.equal(whole[0][0], chunked[0][0])
    np.testing.assert_allclose(whole[2]["w_norm"].numpy(),
                               chunked[2]["w_norm"].numpy(), rtol=1e-6)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown mode"):
        su.seg_norm_ref(torch.zeros(8, 128), torch.zeros(8, 128), (),
                        torch.zeros(8, dtype=torch.int32), 1, mode="adam",
                        weight_decay=0.0)
