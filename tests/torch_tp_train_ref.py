"""The JAX package's side of the tensor-parallel training tests
(``test_torch_tp_train.py``).

Not collected: the test file runs :func:`main` in a subprocess whose
environment fabricates 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, set before jax
is imported) and writes every result the port is held against to one
``.npz`` file:

    python -c "import torch_tp_train_ref as r; r.main(OUT)"

The reference test's ``SCRIPT`` model (``tests/test_sharding_multidevice
.py``) with QKV biases drawn from a seed (their init is zero, which
would hide a bias gradient left unsummed on a rank), its batch, and
TVLARS one step:

* ``{case}/mesh/...``: the step on a ``(2, 4)`` mesh built by
  ``make_data_mesh(2, 4)`` (``jax.make_mesh``
  breaks that path on this jax: ROADMAP F2), the state placed by
  ``state_pspecs(fsdp=True)`` as the reference's launcher places it,
  for the tree optimizer (``tree``) and ``use_kernel="fused"``
  (``fused``): the loss, ``grad_norm``, the layer-wise ``w_norm`` /
  ``g_norm`` / ``trust_ratio`` and the params after the step
  (``.../params/{i}``, leaf order);
* ``inputs/...``: the params and tokens it started from;
* ``{case}/provenance/{D}x{M}``: the per-leaf provenance (JSON) the
  reference's ``save`` records for the same state placed so on
  ``make_data_mesh(D, M)``, before a step (after one, XLA picks its own
  layouts and some leaves carry no named sharding at all).
"""
from __future__ import annotations

import json
import sys
import tempfile

import numpy as np

TRAIN_LM = dict(family="dense", num_layers=2, d_model=64, num_heads=4,
                num_kv_heads=2, d_ff=128, vocab_size=128, remat=True,
                qkv_bias=True)
BATCH, SEQ = 8, 32
HYPER = dict(total_steps=10, learning_rate=1.0)
CASES = {"tree": False, "fused": "fused"}
MESHES = ((2, 4), (2, 2))
METRICS = ("loss", "grad_norm", "layerwise/w_norm", "layerwise/g_norm",
           "layerwise/trust_ratio")


def with_biases(params: dict, seed: int = 7) -> dict:
    """``params`` (numpy leaves) with every QKV bias a seeded
    normal(0.05) draw in the bias's dtype; the same in both test
    processes."""
    rng = np.random.RandomState(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (np.asarray(rng.normal(0.0, 0.05, np.shape(v)),
                                   np.asarray(v).dtype)
                        if k in ("bq", "bk", "bv") else walk(v))
                    for k, v in sorted(node.items())}
        return np.asarray(node)

    return walk(params)


def inputs() -> tuple:
    """(params, batch) as numpy: the reference's seed-0 params with
    seeded biases, and the SCRIPT's batch."""
    import jax
    from repro.configs.base import ModelConfig
    from repro.data.synthetic import lm_batch
    from repro.models import get_model
    params = jax.jit(get_model(ModelConfig(**TRAIN_LM)).init)(
        jax.random.PRNGKey(0))
    toks, labels = lm_batch(jax.random.PRNGKey(1), BATCH, SEQ,
                            TRAIN_LM["vocab_size"])
    return with_biases(jax.tree_util.tree_map(np.asarray, params)), \
        {"tokens": np.asarray(toks), "labels": np.asarray(labels)}


def _put(out, key, metrics, state):
    import jax
    for name in METRICS:
        out[f"{key}/{name}"] = np.asarray(jax.device_get(metrics[name]))
    for i, leaf in enumerate(jax.tree_util.tree_leaves(state.params)):
        out[f"{key}/params/{i}"] = np.asarray(jax.device_get(leaf))


def run(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    from repro import checkpoint
    from repro.configs.base import ModelConfig
    from repro.core import build_optimizer
    from repro.launch import sharding
    from repro.launch.mesh import make_data_mesh
    from repro.models import get_model
    from repro.models import layers as layers_lib
    from repro.training.train_state import TrainState
    from repro.training.trainer import make_train_step
    m = get_model(ModelConfig(**TRAIN_LM))
    params_np, batch_np = inputs()
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    for i, leaf in enumerate(jax.tree_util.tree_leaves(params_np)):
        out[f"inputs/params/{i}"] = leaf
    out["inputs/tokens"] = batch_np["tokens"]

    def shapes(tree):
        return jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)

    for case, use_kernel in CASES.items():
        opt = build_optimizer("tvlars", **HYPER, use_kernel=use_kernel)
        layers_lib.set_batch_sharding(None)
        state = TrainState.create(jax.tree_util.tree_map(jnp.asarray,
                                                         params_np), opt)
        for d, mm in MESHES:
            mesh = make_data_mesh(d, mm)
            with mesh:
                layers_lib.set_batch_sharding(("data",), None,
                                              model_size=mm, mesh=mesh)
                state_sh = sharding.named(mesh, sharding.state_pspecs(
                    mesh, shapes(state), fsdp=True))
                batch_sh = sharding.named(mesh, sharding.batch_pspecs(
                    mesh, shapes(batch)))
                placed = jax.device_put(state, state_sh)
                with tempfile.TemporaryDirectory() as tmp:
                    checkpoint.save(tmp, placed, step=0)
                    out[f"{case}/provenance/{d}x{mm}"] = np.asarray(
                        json.dumps(checkpoint.saved_shardings(tmp)))
                if (d, mm) == (2, 4):
                    new, metrics = jax.jit(
                        make_train_step(m, opt, layerwise=True),
                        in_shardings=(state_sh, batch_sh))(
                        placed, jax.device_put(batch, batch_sh))
                    _put(out, f"{case}/mesh", metrics, new)
            layers_lib.set_batch_sharding(None)


def main(path: str) -> None:
    out = {}
    run(out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
