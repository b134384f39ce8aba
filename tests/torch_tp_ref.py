"""The JAX package's side of the tensor-parallel serving tests
(``test_torch_tp_serving.py``).

Not collected: the test file runs :func:`main` in a subprocess whose
environment fabricates 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, set before jax
is imported) and writes every result the port is held against to one
``.npz`` file:

    python -c "import torch_tp_ref as r; r.main(OUT)"

* ``step/...``: the reference test's ``DECODE_SCRIPT`` model and batch
  (``tests/test_sharding_multidevice.py``), its serve step on one
  device and on a ``(2, 4)`` mesh built by ``make_data_mesh(2, 4)``
  (``jax.make_mesh`` breaks that path on this jax: ROADMAP F2), with
  the params placed by ``state_pspecs`` and the cache by
  ``cache_pspecs``. Then the step is run on for ``STEPS`` steps, each
  feeding the tokens it chose, and every step's tokens and logits are
  kept on both; the same again from seeded start tokens that differ
  by row (``step/*-varied``: the script's all-ones batch gives every
  row the same tokens).
* ``engine/{arch}/...``: the reference engine at M = 1 on the smoke
  config of ``arch``, on the reference's seed-0 params with the QKV
  biases set to seeded draws (their init is zero, which would hide a
  bias left whole on a rank), serving :data:`PROMPTS`.

Keys ``{what}/{i}`` hold leaf lists (bf16 leaves as uint16 bits).
"""
from __future__ import annotations

import sys

import numpy as np

DECODE_LM = dict(family="dense", num_layers=2, d_model=64, num_heads=4,
                 num_kv_heads=4, d_ff=128, vocab_size=128, remat=False)
STEP_BATCH, STEP_LEN, STEPS = 8, 16, 4
ENGINE_ARCHS = ("gemma3-12b", "qwen2-72b")
SERVE = dict(slots=4, max_len=48, page_size=8, prefill_batch=4)
# (seed, prompt length, new tokens): gemma3's smoke window is 8, so
# prompts and decodes run the ring past T several laps
PROMPTS = [(0, 5, 12), (1, 19, 9), (2, 3, 16), (3, 11, 7), (4, 26, 10),
           (5, 8, 14)]


def prompts(vocab: int) -> list:
    return [(np.random.RandomState(s).randint(1, vocab, size=n), new)
            for s, n, new in PROMPTS]


def varied_tokens() -> np.ndarray:
    return np.random.RandomState(11).randint(
        1, DECODE_LM["vocab_size"], size=(STEP_BATCH, 1)).astype(np.int32)


def with_biases(params: dict, seed: int = 7) -> dict:
    """``params`` with every QKV bias a seeded normal(0.05) draw, in the
    bias's dtype (numpy leaves; the same in both test processes)."""
    rng = np.random.RandomState(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (np.asarray(rng.normal(0.0, 0.05, np.shape(v)),
                                   np.asarray(v).dtype)
                        if k in ("bq", "bk", "bv") else walk(v))
                    for k, v in sorted(node.items())}
        return np.asarray(node)

    return walk(params)


def engine_params(arch: str) -> dict:
    import jax
    from repro.configs import get_smoke_config
    from repro.models import get_model
    params = get_model(get_smoke_config(arch)).init(jax.random.PRNGKey(0))
    return with_biases(jax.tree_util.tree_map(np.asarray, params))


def _put(out, key, tree):
    import jax
    for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
        a = np.asarray(jax.device_get(leaf))
        out[f"{key}/{i}"] = a.view(np.uint16) \
            if str(a.dtype) == "bfloat16" else a


def step(out):
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ModelConfig
    from repro.launch import sharding
    from repro.launch.mesh import make_data_mesh
    from repro.models import get_model
    from repro.models import layers as layers_lib
    from repro.serving.decode import make_serve_step
    cfg = ModelConfig(**DECODE_LM)
    m = get_model(cfg)
    layers_lib.set_batch_sharding(None)
    params = m.init(jax.random.PRNGKey(0))
    _put(out, "step/params", params)
    starts = {"": jnp.ones((STEP_BATCH, 1), jnp.int32),
              "-varied": jnp.asarray(varied_tokens())}
    serve = make_serve_step(m)

    def run(step_fn, decode, params, cache, tok):
        logits, got = [], []
        for i in range(STEPS):
            logits.append(np.asarray(decode(params, cache, tok,
                                            jnp.int32(i))[0]))
            tok, cache = step_fn(params, cache, tok, jnp.int32(i))
            got.append(np.asarray(tok))
        return np.stack(got), np.stack(logits)

    cache = m.init_cache(params, STEP_BATCH, STEP_LEN, None)
    for tag, tok in starts.items():
        out[f"step/single{tag}/tokens"], out[f"step/single{tag}/logits"] = \
            run(jax.jit(serve), jax.jit(m.decode_step), params, cache, tok)

    mesh = make_data_mesh(2, 4)

    def shapes(tree):
        return jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)

    with mesh:
        layers_lib.set_batch_sharding(("data",), None, model_size=4,
                                      mesh=mesh)
        params_sh = sharding.named(
            mesh, sharding.state_pspecs(mesh, shapes(params)))
        cache_sh = sharding.named(
            mesh, sharding.cache_pspecs(mesh, shapes(cache)))
        ins = (params_sh, cache_sh, None, None)
        for tag, tok in starts.items():
            out[f"step/mesh{tag}/tokens"], out[f"step/mesh{tag}/logits"] = \
                run(jax.jit(serve, in_shardings=ins),
                    jax.jit(m.decode_step, in_shardings=ins),
                    jax.device_put(params, params_sh),
                    jax.device_put(cache, cache_sh), tok)
    layers_lib.set_batch_sharding(None)


def engine(out):
    from repro import serving
    from repro.configs import get_smoke_config
    from repro.models import get_model
    for arch in ENGINE_ARCHS:
        cfg = get_smoke_config(arch)
        params = engine_params(arch)
        _put(out, f"engine/{arch}/params", params)
        eng = serving.Engine(get_model(cfg), params,
                             serving.ServeConfig(**SERVE))
        ids = [eng.submit(p, max_new_tokens=n)
               for p, n in prompts(cfg.vocab_size)]
        got = {r.id: r.tokens for r in eng.drain()}
        for j, i in enumerate(ids):
            out[f"engine/{arch}/tokens/{j}"] = np.asarray(got[i], np.int32)


def main(path: str) -> None:
    out = {}
    step(out)
    engine(out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
