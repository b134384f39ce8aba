"""The JAX package's side of ``test_torch_tp_fallback.py`` and
``test_torch_tp_families.py``.

Not collected: each test file runs :func:`main` once, in a subprocess
whose environment fabricates 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, set before jax
is imported), and reads the one ``.npz`` file it writes:

    python -c "import torch_tp_more_ref as r; r.main(WHAT, OUT)"

``WHAT`` is ``"fallback"``:

* ``step{tag}/...``: the reference test's ``DECODE_SCRIPT`` model with
  2 KV heads (:data:`FALLBACK_LM`; ``-ring``: its first layer a
  sliding-window one whose ring of :data:`RING_T` keys the steps run
  past several laps) on one device and on a ``(2, 4)`` mesh built by
  ``make_data_mesh(2, 4)`` (ROADMAP F2), params placed by
  ``state_pspecs`` and the cache by ``cache_pspecs``, whose spec of the
  first K cache is kept (``{tag}/kspec``: T on "model"). Each step's
  tokens and logits, from the script's all-ones start and from varied
  start tokens.
* ``engine/{arch}/...``: the reference engine (one device) on the
  smoke configs of :data:`FALLBACK_ENGINES`, their seed-0 params with
  seeded QKV biases (vlm: cross gates opened, seeded image
  embeddings), serving ``torch_tp_ref.PROMPTS``.
* ``dh/{tag}/...``: each case of :data:`DH_CASES` (the KV cache over T
  beside whole heads, or over the head dim) decoded on one device and
  on its mesh, each step's tokens and logits, and ``cache_pspecs``'
  specs of the first self and cross K caches.
* ``{arch}/...``: one GSPMD TVLARS step of each job of
  :data:`DH_TRAIN` (``torch_tp_train_families_ref.run_jobs``: the heads
  whole at (1, 8)).

``WHAT`` is ``"families"``: the same engine for the vlm smoke config,
``generate`` for the encdec, ssm and hybrid ones (:data:`GENERATE`),
and for each of them ``cache/{arch}/{D}x{M}/{name}``: the shapes of a
rank's blocks of the reference's cache leaves under ``cache_pspecs``
on a ``(D, M)`` mesh (stacked leading dims dropped), by leaf name.
"""
from __future__ import annotations

import sys

import numpy as np

import torch_tp_ref as base

FALLBACK_LM = dict(base.DECODE_LM, num_kv_heads=2)
RING_T = 4
RING_LM = dict(FALLBACK_LM, sliding_window=RING_T, global_every=2)
STEPS = {"": base.STEPS, "-ring": 3 * RING_T}
FALLBACK_ENGINES = ("qwen2.5-3b", "gemma3-12b", "llama-3.2-vision-11b")
GATE = 0.5
# encdec, ssm and hybrid through generate: B prompts of S tokens, N new
GENERATE = ("whisper-large-v3", "mamba2-1.3b", "zamba2-1.2b")
GEN_B, GEN_S, GEN_N = 4, 8, 6
FAMILY_MESHES = ((1, 2), (2, 2))
# the KV cache over T beside whole heads and over the head dim, on the
# reference's own mesh: (tag, arch, config edits, mesh, cache length).
# whisper's smoke config at (1, 8) keeps its 4 heads whole: a length 8
# divides puts its self caches over T, 14 over Dh (32 in blocks of 4),
# and 20 encoder frames its cross K/V over Dh (24 over T); qwen2.5-3b's
# (4 heads, 2 KV heads) at (1, 4) and (2, 4) splits its heads, and 18
# keys go over Dh (case B)
DH_CASES = (("whisper-t", "whisper-large-v3", {}, (1, 8), 16),
            ("whisper-dh", "whisper-large-v3", {}, (1, 8), 14),
            ("whisper-cross-dh", "whisper-large-v3", {"encoder_seq": 20},
             (1, 8), 14),
            ("qwen-1x4", "qwen2.5-3b", {}, (1, 4), 18),
            ("qwen-2x4", "qwen2.5-3b", {}, (2, 4), 18))
DH_BATCH, DH_STEPS = 4, 8
# training where the heads stay whole (the reference's GSPMD step,
# torch_tp_train_families_ref's)
DH_TRAIN = (("whisper-large-v3", (1, 8), ("tree",)),
            ("qwen2.5-3b", (1, 8), ("tree",)))


def dh_start(vocab: int) -> np.ndarray:
    return np.random.RandomState(31).randint(
        1, vocab, size=(DH_BATCH, 1)).astype(np.int32)


def gen_prompts(vocab: int) -> np.ndarray:
    return np.random.RandomState(21).randint(1, vocab, size=(GEN_B, GEN_S))


def extra_rows(shape) -> np.ndarray:
    """Seeded f32 normal rows of the stubbed frontend's output."""
    return np.random.RandomState(23).normal(size=shape).astype(np.float32)


def reference_params(arch: str) -> dict:
    """The reference's seed-0 smoke params as numpy: QKV biases set to
    seeded draws, a vlm's cross gates opened to :data:`GATE`."""
    import jax
    from repro.configs import get_smoke_config
    from repro.models import get_model
    params = jax.tree_util.tree_map(np.asarray, get_model(
        get_smoke_config(arch)).init(jax.random.PRNGKey(0)))
    params = base.with_biases(params)
    if "groups" in params and isinstance(params["groups"], dict):
        params["groups"] = {
            k: dict(v, gate=np.full_like(v["gate"], GATE))
            if "gate" in v else v for k, v in params["groups"].items()}
    return params


def _spec_str(spec) -> str:
    return repr(tuple(spec))


def _run(step_fn, decode, params, cache, tok, steps: int):
    """``steps`` serve steps from ``tok``, each step's logits read first
    by ``decode`` on the same cache: (tokens, logits) stacked."""
    import jax.numpy as jnp
    logits, got = [], []
    for i in range(steps):
        logits.append(np.asarray(decode(params, cache, tok,
                                        jnp.int32(i))[0]))
        tok, cache = step_fn(params, cache, tok, jnp.int32(i))
        got.append(np.asarray(tok))
    return np.stack(got), np.stack(logits)


def _shapes(tree):
    import jax
    return jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)


def dh_step(out, tag: str, arch: str, edits: dict, shape: tuple,
            length: int) -> None:
    """One :data:`DH_CASES` case: the decode from :func:`dh_start` for
    :data:`DH_STEPS` steps on one device and on ``make_data_mesh(*shape)``
    (params by ``state_pspecs``, cache by ``cache_pspecs``, whose specs
    of the self and cross K caches are kept)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.launch import sharding
    from repro.launch.mesh import make_data_mesh
    from repro.models import extra_embed_shape, get_model
    from repro.models import layers as layers_lib
    from repro.serving.decode import make_serve_step
    cfg = get_smoke_config(arch).replace(**edits)
    m = get_model(cfg)
    layers_lib.set_batch_sharding(None)
    if f"dh/{arch}/params/0" not in out:
        base._put(out, f"dh/{arch}/params", reference_params(arch))
    params = jax.tree_util.tree_map(jnp.asarray, reference_params(arch))
    es = extra_embed_shape(cfg, DH_BATCH)
    extra = None if es is None else jnp.asarray(extra_rows(es))
    cache = m.init_cache(params, DH_BATCH, length, extra)
    tok = jnp.asarray(dh_start(cfg.vocab_size))
    serve = make_serve_step(m)
    key = f"dh/{tag}"
    out[f"{key}/single/tokens"], out[f"{key}/single/logits"] = _run(
        jax.jit(serve), jax.jit(m.decode_step), params, cache, tok,
        DH_STEPS)
    mesh = make_data_mesh(*shape)
    with mesh:
        layers_lib.set_batch_sharding(("data",), None, model_size=shape[1],
                                      mesh=mesh)
        params_sh = sharding.named(
            mesh, sharding.state_pspecs(mesh, _shapes(params)))
        cspecs = sharding.cache_pspecs(mesh, _shapes(cache))
        for (path, _), spec in zip(
                jax.tree_util.tree_leaves_with_path(cache),
                jax.tree_util.tree_leaves(cspecs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))):
            name = str(getattr(path[-1], "key", ""))
            if name in ("k", "ck") and f"{key}/{name}spec" not in out:
                out[f"{key}/{name}spec"] = np.asarray(_spec_str(spec))
        cache_sh = sharding.named(mesh, cspecs)
        ins = (params_sh, cache_sh, None, None)
        out[f"{key}/mesh/tokens"], out[f"{key}/mesh/logits"] = _run(
            jax.jit(serve, in_shardings=ins),
            jax.jit(m.decode_step, in_shardings=ins),
            jax.device_put(params, params_sh),
            jax.device_put(cache, cache_sh), tok, DH_STEPS)
    layers_lib.set_batch_sharding(None)


def step(out, tag: str, lm: dict):
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ModelConfig
    from repro.launch import sharding
    from repro.launch.mesh import make_data_mesh
    from repro.models import get_model
    from repro.models import layers as layers_lib
    from repro.serving.decode import make_serve_step
    cfg = ModelConfig(**lm)
    m = get_model(cfg)
    layers_lib.set_batch_sharding(None)
    params = m.init(jax.random.PRNGKey(0))
    base._put(out, f"step{tag}/params", params)
    starts = {"": jnp.ones((base.STEP_BATCH, 1), jnp.int32),
              "-varied": jnp.asarray(base.varied_tokens())}
    serve = make_serve_step(m)
    steps = STEPS[tag]

    def run(step_fn, decode, params, cache, tok):
        logits, got = [], []
        for i in range(steps):
            logits.append(np.asarray(decode(params, cache, tok,
                                            jnp.int32(i))[0]))
            tok, cache = step_fn(params, cache, tok, jnp.int32(i))
            got.append(np.asarray(tok))
        return np.stack(got), np.stack(logits)

    cache = m.init_cache(params, base.STEP_BATCH, base.STEP_LEN, None)
    for start, tok in starts.items():
        k = f"step{tag}/single{start}"
        out[f"{k}/tokens"], out[f"{k}/logits"] = run(
            jax.jit(serve), jax.jit(m.decode_step), params, cache, tok)
    mesh = make_data_mesh(2, 4)

    def shapes(tree):
        return jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)

    with mesh:
        layers_lib.set_batch_sharding(("data",), None, model_size=4,
                                      mesh=mesh)
        params_sh = sharding.named(
            mesh, sharding.state_pspecs(mesh, shapes(params)))
        cspecs = sharding.cache_pspecs(mesh, shapes(cache))
        out[f"step{tag}/kspec"] = np.asarray(_spec_str(
            jax.tree_util.tree_leaves(
                cspecs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]))
        cache_sh = sharding.named(mesh, cspecs)
        ins = (params_sh, cache_sh, None, None)
        for start, tok in starts.items():
            k = f"step{tag}/mesh{start}"
            out[f"{k}/tokens"], out[f"{k}/logits"] = run(
                jax.jit(serve, in_shardings=ins),
                jax.jit(m.decode_step, in_shardings=ins),
                jax.device_put(params, params_sh),
                jax.device_put(cache, cache_sh), tok)
    layers_lib.set_batch_sharding(None)


def engine(out, arch: str):
    from repro import serving
    from repro.configs import get_smoke_config
    from repro.models import extra_embed_shape, get_model
    cfg = get_smoke_config(arch)
    params = reference_params(arch)
    base._put(out, f"engine/{arch}/params", params)
    es = extra_embed_shape(cfg, base.SERVE["slots"])
    extra = None if es is None else extra_rows(es)
    eng = serving.Engine(get_model(cfg), params,
                         serving.ServeConfig(**base.SERVE), extra=extra)
    ids = [eng.submit(p, max_new_tokens=n)
           for p, n in base.prompts(cfg.vocab_size)]
    got = {r.id: r.tokens for r in eng.drain()}
    for j, i in enumerate(ids):
        out[f"engine/{arch}/tokens/{j}"] = np.asarray(got[i], np.int32)


def generate(out, arch: str):
    import jax.numpy as jnp
    from repro import serving
    from repro.configs import get_smoke_config
    from repro.models import extra_embed_shape, get_model
    cfg = get_smoke_config(arch)
    params = reference_params(arch)
    base._put(out, f"generate/{arch}/params", params)
    es = extra_embed_shape(cfg, GEN_B)
    extra = None if es is None else jnp.asarray(extra_rows(es))
    out[f"generate/{arch}/tokens"] = np.asarray(serving.generate(
        get_model(cfg), params, jnp.asarray(gen_prompts(cfg.vocab_size)),
        num_tokens=GEN_N, extra_embeds=extra))


class _MeshShape:
    """The axis sizes of a ``(D, M)`` mesh: all ``cache_pspecs`` reads."""

    def __init__(self, data: int, model: int):
        self.shape = {"data": data, "model": model}


def cache_blocks(out, arch: str, batch: int, max_len: int):
    """A rank's block shapes of the reference's cache leaves on every
    mesh of :data:`FAMILY_MESHES`, by leaf name."""
    import jax
    from repro.configs import get_smoke_config
    from repro.launch import sharding
    from repro.models import extra_embed_shape, get_model
    cfg = get_smoke_config(arch)
    m = get_model(cfg)
    params = jax.eval_shape(m.init, jax.random.PRNGKey(0))
    es = extra_embed_shape(cfg, batch)
    extra = None if es is None else jax.ShapeDtypeStruct(es, np.float32)
    cache = jax.eval_shape(lambda p, e: m.init_cache(p, batch, max_len, e),
                           params, extra)
    leaves = jax.tree_util.tree_leaves_with_path(cache)
    for d, mm in FAMILY_MESHES:
        mesh = _MeshShape(d, mm)
        specs = jax.tree_util.tree_leaves(
            sharding.cache_pspecs(mesh, cache),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        by_name: dict = {}
        for (path, leaf), spec in zip(leaves, specs):
            name = str(getattr(path[-1], "key", getattr(path[-1], "name",
                                                        path[-1])))
            shape = list(leaf.shape)
            for i, entry in enumerate(tuple(spec)):
                axes = entry if isinstance(entry, tuple) else (entry,)
                for a in axes:
                    if a is not None:
                        shape[i] //= mesh.shape[a]
            tail = 3 if name == "conv" else 4
            by_name.setdefault(name, set()).add(tuple(shape[-tail:]))
        for name, got in by_name.items():
            out[f"cache/{arch}/{d}x{mm}/{name}"] = np.asarray(sorted(got))


def main(what: str, path: str) -> None:
    out = {}
    if what == "fallback":
        import torch_tp_train_families_ref as train_ref
        step(out, "", FALLBACK_LM)
        step(out, "-ring", RING_LM)
        for arch in FALLBACK_ENGINES:
            engine(out, arch)
        for case in DH_CASES:
            dh_step(out, *case)
        train_ref.run_jobs(DH_TRAIN, out)
    elif what == "families":
        engine(out, "llama-3.2-vision-11b")
        cache_blocks(out, "llama-3.2-vision-11b", base.SERVE["slots"],
                     base.SERVE["max_len"])
        for arch in GENERATE:
            generate(out, arch)
            cache_blocks(out, arch, GEN_B, GEN_S + GEN_N)
    else:
        raise ValueError(what)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
