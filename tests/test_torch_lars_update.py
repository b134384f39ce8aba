"""The per-tensor LARS path of ``repro_torch`` against the JAX package.

* ``ops.lars_update`` (the plain version on the CPU) against JAX's
  ``repro.kernels.ops.lars_update`` (the Pallas kernels in interpret
  mode) on single tensors of odd sizes and a 4-D conv shape, heavy ball
  and nesterov, f32 and bf16 w/g, and on a multi-member segment held
  against JAX on the stacked leaf. Bound: rtol 1e-5 with an absolute
  floor of 1e-6 of the array's scale; the two sum the squares in other
  orders (ROADMAP F1: ~6e-7 relative on a norm), which moves the ratio
  and so every element by about that much.
* ``build_optimizer(..., use_kernel="per_tensor")`` for lars, wa-lars,
  nowa-lars and tvlars(momentum_style="lars"), 3 steps on a mixed tree
  and on the qwen2.5-3b smoke LM tree (the reference's weights through
  ``params_from_jax``) against the JAX package's per-tensor path, at
  the JAX package's own per-tensor bound (``test_segmented_parity``:
  rtol 2e-5, atol 1e-6).
* Selection: the port's kernel segments on the smoke LM tree, two
  launches each, equal the ``pallas_call``s of the JAX per-tensor step.
* The reference's build-time errors for ``per_tensor`` raise the same
  ``ValueError``; a CUDA-less host builds ``per_tensor`` for the CPU
  and runs the plain version; the kernel wrappers refuse CPU tensors
  before building; the tree path updates its state in place with the
  values of the functional update.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import apply_updates as japply
from repro.core import build_optimizer as jbuild
from repro.kernels import ops as jops
from repro.models import get_model as jax_get_model
from repro_torch import core
from repro_torch.configs import get_smoke_config
from repro_torch.core import flatten, layerwise
from repro_torch.core.base import tree_get, tree_leaves
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import lars_update as lu
from repro_torch.models import get_model, params_from_jax

RTOL, ATOL = 1e-5, 1e-6          # op level: relative to the array scale
OPT_RTOL, OPT_ATOL = 2e-5, 1e-6  # the reference's per-tensor bound
HYPER = dict(base_lr=0.37, eta=1e-3, weight_decay=5e-4, momentum_mu=0.9,
             eps=1e-9)


def _rand(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol * scale, err_msg=what)


def _to_dtype(a: np.ndarray, dtype: str):
    """(jax array, torch tensor) of the same values at ``dtype``."""
    j = jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16) if dtype == "bf16" else t


SIZES = [(7,), (8,), (129,), (513, 130), (3, 3, 16, 32)]


@pytest.mark.parametrize("shape", SIZES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("nesterov", [False, True], ids=["hb", "nesterov"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lars_update_matches_reference(shape, nesterov, dtype):
    rng = np.random.default_rng(sum(shape))
    jw, tw = _to_dtype(_rand(rng, shape, 0.05), dtype)
    jg, tg = _to_dtype(_rand(rng, shape, 1e-3), dtype)
    m = _rand(rng, shape, 1e-4)
    jm, jd = jops.lars_update(jw, jg, jnp.asarray(m), nesterov=nesterov,
                              **HYPER)
    tm = torch.from_numpy(m.copy())
    before = dict(ops.launches)
    new_m, delta = ops.lars_update(tw, tg, tm, nesterov=nesterov, **HYPER)
    assert ops.launches == before              # the plain path: no launch
    assert new_m is tm and new_m.dtype == delta.dtype == torch.float32
    assert delta.shape == tw.shape
    _close(new_m.numpy(), jm, what="momentum")
    _close(delta.numpy(), jd, what="delta")


@pytest.mark.parametrize("nesterov", [False, True], ids=["hb", "nesterov"])
def test_multi_member_segment_matches_reference_stacked_leaf(nesterov):
    rng = np.random.default_rng(11)
    shape, count = (33, 65), 5
    w = [_rand(rng, shape, 0.05) for _ in range(count)]
    g = [_rand(rng, shape, 1e-3) for _ in range(count)]
    m = [_rand(rng, shape, 1e-4) for _ in range(count)]
    jm, jd = jops.lars_update(jnp.asarray(np.stack(w)),
                              jnp.asarray(np.stack(g)),
                              jnp.asarray(np.stack(m)), nesterov=nesterov,
                              **HYPER)
    tms = [torch.from_numpy(x.copy()) for x in m]
    new_ms, deltas, stats = ops.lars_update(
        [torch.from_numpy(x) for x in w], [torch.from_numpy(x) for x in g],
        tms, nesterov=nesterov, telemetry=True, **HYPER)
    assert all(a is b for a, b in zip(new_ms, tms))
    _close(torch.stack(new_ms).numpy(), jm, what="momentum")
    _close(torch.stack(deltas).numpy(), jd, what="delta")
    # the telemetry triple: the norms of the stacked leaf and its ratio
    wn = float(np.linalg.norm(np.stack(w).astype(np.float64)))
    gn = float(np.linalg.norm(np.stack(g).astype(np.float64)))
    ratio = 1e-3 * wn / (gn + 5e-4 * wn + 1e-9)
    np.testing.assert_allclose(stats.numpy(), [wn, gn, ratio], rtol=1e-6)


def test_plain_version_is_norm_then_apply():
    """The plain update is the two plain halves the kernels are held
    against on the card: ``lars_norm2`` then ``lars_ratio`` +
    ``lars_apply`` given those sums (bitwise)."""
    rng = np.random.default_rng(3)
    ws = [torch.from_numpy(_rand(rng, (40, 9), 0.1)) for _ in range(3)]
    gs = [torch.from_numpy(_rand(rng, (40, 9), 0.01)) for _ in range(3)]
    ms = [torch.from_numpy(_rand(rng, (40, 9), 0.001)) for _ in range(3)]
    new_ms, deltas, stats = ref.lars_update_ref(ws, gs, ms, nesterov=True,
                                                **HYPER)
    sums = ref.lars_norm2(ws, gs)
    wn, gn, ratio, scale = ref.lars_ratio(sums, HYPER["base_lr"],
                                          eta=HYPER["eta"],
                                          weight_decay=HYPER["weight_decay"],
                                          eps=HYPER["eps"])
    assert torch.equal(stats, torch.stack([wn, gn, ratio]))
    for w, g, m, nm, d in zip(ws, gs, ms, new_ms, deltas):
        a, b = ref.lars_apply(w, g, m, scale, weight_decay=5e-4,
                              momentum_mu=0.9, nesterov=True)
        assert torch.equal(a, nm) and torch.equal(b, d)
    # a zero gradient leaves the ratio at 1
    zero = ref.lars_norm2(ws, [torch.zeros_like(g) for g in gs])
    assert float(ref.lars_ratio(zero, 1.0, eta=1e-3, weight_decay=0.0,
                                eps=0.0)[2]) == 1.0


# ---------------------------------------------------------------------------
# the per-tensor optimizers against the JAX package's per-tensor path
# ---------------------------------------------------------------------------

SHAPES = {"dense": {"w": (8, 16), "b": (16,)}, "odd": (7,),
          "t3": (3, 5, 13), "head": (33, 65), "big": (130, 100),
          "tiny": (2, 3)}
STEPS = 3
PER_TENSOR = [("lars", {}), ("wa-lars", {}), ("nowa-lars", {}),
              ("tvlars", {"momentum_style": "lars"})]


def _mixed_problem():
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


def _run_pair(name, kw, params, grads, *, to_port=_torch_tree,
              segments=None):
    hyper = dict(total_steps=10, learning_rate=0.5, batch_size=512,
                 use_kernel="per_tensor", **kw)
    jopt = jbuild(name, **hyper)
    topt = core.build_optimizer(name, device="cpu", segments=segments,
                                **hyper)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = to_port(params)
    js, ts = jopt.init(jp), topt.init(tp)
    jupdate = jax.jit(jopt.update)
    for g in grads:
        ju, js = jupdate(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(to_port(g), ts, tp)
        jp = japply(jp, ju)
        tp = core.apply_updates(tp, tu)
    assert int(ts.step) == len(grads)
    return jp, tp, js, ts


@pytest.mark.parametrize("name,kw", PER_TENSOR, ids=[n for n, _ in PER_TENSOR])
def test_per_tensor_optimizer_matches_reference(name, kw):
    params, grads = _mixed_problem()
    jp, tp, js, ts = _run_pair(name, kw, params, grads)
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=OPT_RTOL,
                                   atol=OPT_ATOL)
    for a, b in zip(tree_leaves(ts[1]), jax.tree_util.tree_leaves(js[1])):
        _close(a.numpy(), b, rtol=OPT_RTOL, atol=OPT_ATOL, what="momentum")


def _smoke_lm():
    jcfg = jax_smoke_config("qwen2.5-3b")
    cfg = get_smoke_config("qwen2.5-3b")
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(4)
    grads = [jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) * 0.01).astype(p.dtype), tree)
        for _ in range(STEPS)]
    return cfg, get_model(cfg), tree, grads


@pytest.mark.parametrize("name,kw", PER_TENSOR, ids=[n for n, _ in PER_TENSOR])
def test_per_tensor_smoke_lm_matches_reference(name, kw):
    cfg, model, tree, grads = _smoke_lm()
    jp, tp, _, _ = _run_pair(
        name, kw, tree, grads, segments=model.segments,
        to_port=lambda t: params_from_jax(cfg, t, device="cpu"))
    jleaves = jax.tree_util.tree_leaves(jp)
    for seg, jw in zip(model.segments(tp), jleaves):
        got = torch.stack([tree_get(tp, p) for p in seg.paths]) \
            if seg.stacked else tree_get(tp, seg.paths[0])
        np.testing.assert_allclose(got.numpy(), np.asarray(jw),
                                   rtol=OPT_RTOL, atol=OPT_ATOL,
                                   err_msg=seg.name)


def test_kernel_segments_match_reference_pallas_calls():
    cfg, model, tree, grads = _smoke_lm()
    jopt = jbuild("wa-lars", total_steps=10, use_kernel="per_tensor")
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jaxpr = jax.make_jaxpr(jopt.update)(
        jax.tree_util.tree_map(jnp.asarray, grads[0]), jopt.init(jp), jp)
    n_calls = jops.count_pallas_calls(jaxpr.jaxpr)
    params = params_from_jax(cfg, tree, device="cpu")
    spec = flatten.build_spec(params, segments=model.segments)
    names = layerwise.kernel_segments(spec)
    assert n_calls > 0 and 2 * len(names) == n_calls
    # the 1-D final norm stays on the tree math
    assert "final_norm/scale" not in names
    # and the run launches nothing on the CPU but counts what the card
    # would: one ops.lars_norm2 and one ops.lars_apply call per step,
    # each over exactly those segments, with their member counts
    calls = {"lars_norm2": [], "lars_apply": []}
    real = {name: getattr(ops, name) for name in calls}

    def spy(name):
        def call(segments, *a, **kw):
            calls[name].append([len(seg[0]) for seg in segments])
            return real[name](segments, *a, **kw)
        return call

    topt = core.build_optimizer("wa-lars", total_steps=10,
                                use_kernel="per_tensor", device="cpu",
                                segments=model.segments)
    state = topt.init(params)
    for name in calls:
        setattr(ops, name, spy(name))
    try:
        topt.update(params_from_jax(cfg, grads[0], device="cpu"), state,
                    params)
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)
    counts = [len(paths) for name, paths in zip(spec.names, spec.paths)
              if name in names]
    assert calls["lars_norm2"] == calls["lars_apply"] == [counts]
    # stacked group members
    assert max(counts) == cfg.num_layers


# ---------------------------------------------------------------------------
# build-time errors, guards
# ---------------------------------------------------------------------------

PER_TENSOR_ERRORS = [
    ("trust-clip", dict(name="lambc-lars")),
    ("tvlars-paper", dict(name="tvlars")),
    ("tvlars-paper-explicit", dict(name="tvlars", momentum_style="paper")),
    ("lamb", dict(name="lamb")),
]


@pytest.mark.parametrize("case,kw", PER_TENSOR_ERRORS,
                         ids=[c for c, _ in PER_TENSOR_ERRORS])
def test_per_tensor_build_errors_match_reference(case, kw):
    kw = dict(kw)
    name = kw.pop("name")
    with pytest.raises(ValueError) as jerr:
        jbuild(name, total_steps=10, use_kernel="per_tensor", **kw)
    with pytest.raises(ValueError) as terr:
        core.build_optimizer(name, total_steps=10, use_kernel="per_tensor",
                             device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def test_per_tensor_builds_for_cpu_on_a_cuda_less_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        core.build_optimizer("wa-lars", total_steps=4,
                             use_kernel="per_tensor")      # default device
    opt = core.build_optimizer("wa-lars", total_steps=4,
                               use_kernel="per_tensor", device="cpu")
    params = {"w": torch.ones(4, 8), "b": torch.ones(8)}
    state = opt.init(params)
    before = dict(ops.launches)
    updates, state = opt.update({"w": torch.full((4, 8), 0.1),
                                 "b": torch.full((8,), 0.1)}, state, params)
    assert ops.launches == before
    assert torch.isfinite(updates["w"]).all() and int(state.step) == 1
    with pytest.raises(ValueError, match="params lie on"):
        opt.init({"w": torch.ones(4, 8, device="meta")})


def test_lars_cuda_wrappers_refuse_cpu_tensors_before_building(
        monkeypatch):
    def no_build(name):
        raise AssertionError("must not build for a refused call")
    monkeypatch.setattr(_build, "load", no_build)
    w, g, m = torch.ones(16), torch.ones(16), torch.zeros(16)
    with pytest.raises(ValueError, match="CUDA device"):
        lu.lars_norm2_cuda([([w], [g])])
    with pytest.raises(ValueError, match="CUDA device"):
        lu.lars_apply_cuda([([w], [g], [m])], torch.ones(2, 1), base_lr=0.1,
                           eta=1e-3, weight_decay=0.0, momentum_mu=0.9)
    # no cap on the members of a segment: 100 members are refused only
    # for lying on the CPU
    with pytest.raises(ValueError, match="CUDA device"):
        lu.lars_norm2_cuda([([w] * 100, [g] * 100)])
    with pytest.raises(ValueError, match="f32 weights with bf16"):
        lu.lars_apply_cuda([([w], [g.bfloat16()], [m])], torch.ones(2, 1),
                           base_lr=0.1, eta=1e-3, weight_decay=0.0,
                           momentum_mu=0.9)
    # meta tensors (the dry run): the kernel's outputs, its two
    # launches counted apart, nothing built or launched
    before, meta = dict(ops.launches), dict(ops.meta_launches)
    mm = m.to("meta")
    new_m, delta = ops.lars_update(w.to("meta"), g.to("meta"), mm, **HYPER)
    assert new_m is mm and delta.device.type == "meta"
    assert delta.shape == w.shape and delta.dtype == torch.float32
    assert ops.launches == before
    assert ops.meta_launches["lars_norm2"] == meta["lars_norm2"] + 1
    assert ops.meta_launches["lars_apply"] == meta["lars_apply"] + 1


def test_lars_library_is_keyed_on_source_hash(tmp_path, monkeypatch):
    first = _build.library_path("lars_update")
    assert first.parent == _build.BUILD_DIR
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "lars_update.cu").write_text("// edited\n")
    assert _build.library_path("lars_update").name != first.name


def _lr(step):
    return torch.tensor(0.2)


IN_PLACE_CASES = {
    "lars": (lambda: core.lars(_lr, nesterov=True), "lars", _lr, {}),
    "lamb": (lambda: core.lamb(_lr), "lamb", _lr,
             dict(b1=0.9, b2=0.999, eps=1e-6)),
    "tvlars-paper": (lambda: core.tvlars(0.5, lam=1e-2, delay_steps=2),
                     "paper",
                     lambda step: 0.5 * core.schedules.tvlars_phi(
                         1e-2, 2, 1.0, 1e-3)(step), {}),
}


@pytest.mark.parametrize("case", list(IN_PLACE_CASES))
def test_tree_path_updates_state_in_place_with_functional_values(case):
    """The tree path's in-place state update gives the values of the
    functional update it replaced (recomputed here from the shared
    math, leaf by leaf, bitwise), and the state buffers stay the same
    objects from step to step."""
    make, mode, base_lr_fn, adam = IN_PLACE_CASES[case]
    opt = make()
    params, grads = _mixed_problem()
    tp = _torch_tree(params)
    state = opt.init(tp)
    bufs0 = [tree_leaves(b) for b in state[1:]]
    want = [[b.clone() for b in bl] for bl in bufs0]
    trust_clip = 10.0 if mode == "lamb" else None
    eps = adam.get("eps", 1e-9)
    for g in grads:
        tg = _torch_tree(g)
        stepf = (state.step + 1).float()
        bc = dict(bc1=1.0 - 0.9 ** stepf, bc2=1.0 - 0.999 ** stepf)
        lr = base_lr_fn(state.step)
        updates, state = opt.update(tg, state, tp)
        for i, (w, gl, u) in enumerate(zip(tree_leaves(tp), tree_leaves(tg),
                                           tree_leaves(updates))):
            d, nb = ref.direction(mode, w, gl, tuple(bl[i] for bl in want),
                                  **bc, **adam)
            bvec = d + 5e-4 * w if mode == "lamb" else gl
            adapt = torch.tensor(w.dim() >= 2)
            _, _, ratio = ref.trust_ratio(
                torch.sum(w * w), torch.sum(bvec * bvec), adapt, mode=mode,
                eta=1e-3, weight_decay=5e-4, eps=eps, trust_clip=trust_clip)
            table = ref.scales_from_ratio(ratio, adapt, lr, 5e-4)
            new, delta = ref.integrate(mode, w, nb,
                                       table[0] * d + table[1] * w,
                                       momentum=0.9,
                                       nesterov=case == "lars")
            assert torch.equal(delta, u), f"leaf {i}"
            for bl, x in zip(want, new):
                bl[i] = x
        tp = core.apply_updates(tp, updates)
    for k, bl in enumerate(bufs0):
        for i, b in enumerate(tree_leaves(state[1 + k])):
            assert b is bl[i]                        # updated in place
            assert torch.equal(b, want[k][i])


# ---------------------------------------------------------------------------
# the pass: every kernel segment of a step in one norm and one apply launch
# ---------------------------------------------------------------------------

PASS_SHAPES = [((7,), 1), ((33, 65), 5), ((3, 3, 4, 8), 2), ((129,), 3),
               ((5, 7), 40)]


def _pass(rng, dtype=torch.float32, shapes=PASS_SHAPES):
    """Segments ``(ws, gs, ms)`` of seeded members (w ~ 0.05, g ~ 1e-3,
    m ~ 1e-4; ms f32)."""
    segs = []
    for shape, count in shapes:
        segs.append(tuple(
            [torch.from_numpy(_rand(rng, shape, scale)).to(dt)
             for _ in range(count)]
            for scale, dt in ((0.05, dtype), (1e-3, dtype),
                              (1e-4, torch.float32))))
    return segs


@pytest.mark.parametrize("nesterov", [False, True], ids=["hb", "nesterov"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_pass_is_the_per_segment_plain_functions(dtype, nesterov):
    """``ref.lars_norm2_pass`` / ``lars_apply_pass`` (and ``ops`` on the
    CPU, which runs them) are bitwise the per-segment plain functions,
    a segment reading its own column of a wider table."""
    segs = _pass(np.random.default_rng(8), dtype)
    table = ref.lars_norm2_pass([s[:2] for s in segs])
    assert table.shape == (2, len(segs)) and table.dtype == torch.float32
    for j, (ws, gs, _) in enumerate(segs):
        assert torch.equal(table[:, j], ref.lars_norm2(ws, gs))
    # the table with other segments' columns between (the tree path's
    # table in the spec's order): segment j reads column 2 j + 1
    wide = torch.zeros(2, 2 * len(segs))
    wide[:, 1::2] = table
    cols = [2 * j + 1 for j in range(len(segs))]
    hyper = {k: v for k, v in HYPER.items() if k != "base_lr"}
    new_ms, deltas, stats = ref.lars_apply_pass(
        segs, wide, HYPER["base_lr"], columns=cols, nesterov=nesterov,
        **hyper)
    for j, (ws, gs, ms) in enumerate(segs):
        nm, d, st = ref.lars_update_ref(ws, gs, ms, nesterov=nesterov,
                                        **HYPER)
        assert torch.equal(stats[:, j], st)
        for a, b in zip(nm + d, new_ms[j] + deltas[j]):
            assert torch.equal(a, b)
    # ops on the CPU: one call per pass, momentum in place, no launch
    before = dict(ops.launches)
    assert torch.equal(ops.lars_norm2([s[:2] for s in segs]), table)
    kms = [[m.clone() for m in s[2]] for s in segs]
    got, got_stats = ops.lars_apply(
        [(s[0], s[1], m) for s, m in zip(segs, kms)], wide, columns=cols,
        nesterov=nesterov, telemetry=True, **HYPER)
    assert ops.launches == before
    assert torch.equal(got_stats, stats)
    for j in range(len(segs)):
        for a, b in zip(kms[j] + got[j], new_ms[j] + deltas[j]):
            assert torch.equal(a, b)


def _walk(rec: np.ndarray, nseg: int, ntiles: int, tile: int):
    """The kernels' walk of a pass's table, as ``lars_update.cu`` does
    it: each tile's (segment, member record, element range)."""
    segs = rec[:8 * nseg].reshape(nseg, 8)
    out, s = [], 0
    for t in range(ntiles):
        while s + 1 < nseg and segs[s + 1, 0] <= t:
            s += 1
        tile0, n, tiles, member0 = (int(x) for x in segs[s, :4])
        k, r = divmod(t - tile0, tiles)
        out.append((s, member0 + k, r * tile, min(r * tile + tile, n)))
    return out


def _pointers(segs) -> list:
    """A pass's pointers a component, as the wrappers' check reads
    them."""
    return [[x.data_ptr() for seg in segs for x in seg[c]]
            for c in range(len(segs[0]))]


@pytest.mark.parametrize("with_m", [False, True], ids=["norm", "apply"])
def test_pass_table_covers_every_element_once(with_m):
    """The host half of the kernels' contract: the table's records, the
    kernels' walk of it (emulated) covering every element of every
    member exactly once, tile by tile in segment order; deltas at
    16-byte aligned offsets of one buffer, without overlap; zeroed
    tickets at the end."""
    segs = _pass(np.random.default_rng(9),
                 shapes=[((3,), 1), ((lu.TILE + 5,), 2), ((40,), 3),
                         ((2, lu.TILE), 1)])
    # a pass of mixed (w, g) dtype pairs, as mamba2-1.3b's
    bf = torch.bfloat16
    segs[1] = ([w.to(bf) for w in segs[1][0]],
               [g.to(bf) for g in segs[1][1]], segs[1][2])
    segs[2] = ([w.to(bf) for w in segs[2][0]],) + segs[2][1:]
    cols = [4, 0, 2, 1]
    part = segs if with_m else [s[:2] for s in segs]
    rec, ntiles, offsets, total = lu._table(part, _pointers(part), cols)
    assert ntiles == lu.pass_tiles(segs) == 1 + 2 * 2 + 3 + 2
    nseg, nmem = len(segs), sum(len(s[0]) for s in segs)
    assert len(rec) == 8 * nseg + 4 * nmem + 2 + 2
    assert not rec[8 * nseg + 4 * nmem:].any()      # tickets, counters
    assert list(rec[:8 * nseg].reshape(nseg, 8)[:, 5]) == cols
    mems = rec[8 * nseg:8 * nseg + 4 * nmem].reshape(nmem, 4)
    members = [(w, g, m) for s in segs for w, g, m in zip(*s)]
    covered = [np.zeros(w.numel(), np.int64) for w, _, _ in members]
    for s, k, e0, e1 in _walk(rec, nseg, ntiles, lu.TILE):
        w, g, m = members[k]
        assert k in range(sum(len(x[0]) for x in segs[:s]),
                          sum(len(x[0]) for x in segs[:s + 1]))
        assert mems[k, 0] == w.data_ptr() and mems[k, 1] == g.data_ptr()
        assert mems[k, 2] == (m.data_ptr() if with_m else 0)
        covered[k][e0:e1] += 1
        ptrs = (w.data_ptr(), g.data_ptr()) + ((m.data_ptr(),) if with_m
                                               else ())
        assert int(mems[k, 3]) & 7 == ((w.dtype == bf) << 2
                                       | (g.dtype == bf) << 1
                                       | all(p % 16 == 0 for p in ptrs))
    assert all((c == 1).all() for c in covered)
    if with_m:
        ends = [o + w.numel() for o, (w, _, _) in zip(offsets, members)]
        assert [int(x) >> lu.FLAG_BITS for x in mems[:, 3]] == offsets
        assert all(o % lu.DELTA_ALIGN == 0 for o in offsets)
        assert all(a <= b for a, b in zip(ends, offsets[1:]))
        assert total >= ends[-1]
    else:
        assert not offsets and total == 0


def test_delta_views_are_the_members_slots():
    """Each member's delta is a contiguous view of the pass's buffer of
    the member's shape, starting at its offset in the table: writing
    every view fills exactly those slots."""
    segs = _pass(np.random.default_rng(10),
                 shapes=[((3,), 1), ((5, 7), 3), ((2, 4), 2)])
    segs.insert(2, tuple([torch.tensor(0.5) for _ in range(2)]
                         for _ in range(3)))        # 0-d members
    _, _, offsets, total = lu._table(segs, _pointers(segs),
                                     range(len(segs)))
    flat = torch.zeros(total)
    deltas = lu._delta_views(flat, segs, offsets)
    members = [w for s in segs for w in s[0]]
    views = [d for ds in deltas for d in ds]
    assert [len(ds) for ds in deltas] == [len(s[0]) for s in segs]
    want = torch.zeros(total)
    for k, (w, d, o) in enumerate(zip(members, views, offsets)):
        assert d.shape == w.shape and d.is_contiguous()
        assert d.data_ptr() == flat.data_ptr() + 4 * o
        d.fill_(k + 1)
        want[o:o + w.numel()] = k + 1
    assert torch.equal(flat, want)


def test_pass_summation_depth_stays_at_the_old_bound():
    """The depth the source's note states, from the wrapper's tile: on
    qwen2.5-3b's deepest segment (36 MLP members of 2048 x 11008) the
    kernel adds at most 445 times on a term's path, the depth that
    ``chip_smoke.LARS_NORM_RTOL`` rests on."""
    threads, block = 256, 13
    tiles = 36 * -(-2048 * 11008 // lu.TILE)
    depth = lu.TILE // threads + block + -(-tiles // threads) + block
    assert (tiles, depth) == (99072, 445)


PASS_REFUSALS = {
    "cpu": (lambda w, g, m: [([w], [g], [m])], "CUDA device"),
    "mixed-w-dtypes": (lambda w, g, m: [([w, w.bfloat16()], [g, g],
                                         [m, m])], "share one dtype"),
    "mixed-g-dtypes": (lambda w, g, m: [([w.bfloat16()] * 2,
                                         [g, g.bfloat16()], [m, m])],
                       "share one dtype"),
    # segments of different (w, g) pairs share a pass (mamba2-1.3b keeps
    # some leaves in f32): refused here only for lying on the CPU
    "mixed-pairs-across-segments": (
        lambda w, g, m: [([w], [g], [m]), ([w.bfloat16()], [g], [m]),
                         ([w.bfloat16()], [g.bfloat16()], [m])],
        "CUDA device"),
    "f32-w-bf16-g": (lambda w, g, m: [([w.bfloat16()], [g], [m]),
                                      ([w], [g.bfloat16()], [m])],
                     "f32 weights with bf16"),
    "other-device": (lambda w, g, m: [([w], [g], [m]),
                                      ([w.to("meta")], [g.to("meta")],
                                       [m.to("meta")])],
                     "more than one device"),
    "bf16-momentum": (lambda w, g, m: [([w], [g], [m.bfloat16()])],
                      "momentum is f32", "CUDA device"),
    "ragged-members": (lambda w, g, m: [([w, w[:8]], [g, g[:8]],
                                         [m, m[:8]])], "16 elements each"),
    "strided": (lambda w, g, m: [([w.view(4, 4).t()], [g], [m])],
                "contiguous"),
    "empty-pass": (lambda w, g, m: [], "empty pass"),
}


@pytest.mark.parametrize("case", list(PASS_REFUSALS))
def test_pass_wrappers_refuse_before_building(case, monkeypatch):
    def no_build(name):
        raise AssertionError("must not build for a refused call")
    monkeypatch.setattr(_build, "load", no_build)
    make, match, *norm_match = PASS_REFUSALS[case]
    segs = make(torch.ones(16), torch.ones(16), torch.zeros(16))
    # the norm takes no momentum: there a CPU pass is refused as such
    with pytest.raises(ValueError, match=(norm_match or [match])[0]):
        lu.lars_norm2_cuda([s[:2] for s in segs])
    with pytest.raises(ValueError, match=match):
        lu.lars_apply_cuda(segs, torch.ones(2, 2), base_lr=0.1, eta=1e-3,
                           weight_decay=0.0, momentum_mu=0.9)


def test_meta_pass_counts_one_launch_each():
    """A pass on meta (the dry run) stands for one launch of each,
    whatever its segment count, with outputs of the kernels' shapes."""
    segs = [tuple([x.to("meta") for x in xs] for xs in seg)
            for seg in _pass(np.random.default_rng(2))]
    before, meta = dict(ops.launches), dict(ops.meta_launches)
    table = ops.lars_norm2([s[:2] for s in segs])
    deltas, stats = ops.lars_apply(segs, table, telemetry=True, **HYPER)
    assert table.shape == (2, len(segs)) and table.device.type == "meta"
    assert stats.shape == (3, len(segs))
    assert [[d.shape for d in ds] for ds in deltas] == \
        [[w.shape for w in s[0]] for s in segs]
    assert ops.launches == before
    assert ops.meta_launches["lars_norm2"] == meta["lars_norm2"] + 1
    assert ops.meta_launches["lars_apply"] == meta["lars_apply"] + 1


def _tiny_tree(count=40):
    rng = np.random.default_rng(5)
    shapes = [(2, 3), (3, 3), (8,), (4, 2, 2), (5, 7), (9,), (1, 8)]
    return {f"l{i}": (rng.normal(size=shapes[i % len(shapes)]) * 0.3)
            .astype(np.float32) for i in range(count)}


@pytest.mark.parametrize("name,kw", PER_TENSOR, ids=[n for n, _ in PER_TENSOR])
def test_per_tensor_many_tiny_segments_match_reference(name, kw):
    """40 leaves of 6-16 elements, most of them ADAPT kernel segments
    of one pass: the port equals the JAX per-tensor path after 3 steps,
    and each step is one norm and one apply call."""
    params = _tiny_tree()
    rng = np.random.default_rng(6)
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(STEPS)]
    calls = []
    real = ops.lars_apply

    def spy(segments, *a, **k):
        calls.append(len(segments))
        return real(segments, *a, **k)

    ops.lars_apply = spy
    try:
        jp, tp, js, ts = _run_pair(name, kw, params, grads)
    finally:
        ops.lars_apply = real
    names = layerwise.kernel_segments(flatten.build_spec(_torch_tree(
        params)))
    assert len(names) > 20 and calls == [len(names)] * STEPS
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=OPT_RTOL,
                                   atol=OPT_ATOL)


@pytest.mark.parametrize("arch,mesh", [("qwen2.5-3b", (1, 1)),
                                       ("qwen2.5-3b", (2, 2)),
                                       ("whisper-large-v3", (1, 2))],
                         ids=["qwen-1x1", "qwen-2x2", "whisper-1x2"])
def test_dry_run_predicts_one_norm_and_one_apply_per_step(arch, mesh):
    """The dry run of a per-tensor WA-LARS step (meta, a rank of a
    ``DryMesh``) counts 1 + 1 per-tensor launches, whatever the number
    of kernel segments."""
    import torch_sp_ref as sp
    from repro_torch.launch import dryrun
    got = sp.dry_trace(arch, "tiny_train", dryrun.DryMesh(*mesh),
                       optimizer_name="wa-lars", use_kernel="per_tensor")
    assert got["launches"] == {"lars_norm2": 1, "lars_apply": 1}
