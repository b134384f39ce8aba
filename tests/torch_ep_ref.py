"""The JAX package's side of the expert-parallel tests
(``test_torch_ep_train.py``, ``test_torch_ep_serving.py``): the MoE
family with its experts over the model axis.

Not collected: each test file runs :func:`main` once, in a subprocess
whose environment fabricates 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, set before jax
is imported), and reads the one ``.npz`` file it writes:

    python -c "import torch_ep_ref as r; r.main(WHAT, OUT)"

``WHAT`` is ``"train"``: for each job of :data:`TRAIN`, one TVLARS step
of the reference's GSPMD path on ``make_data_mesh(2, 4)`` from its own
smoke params and seeded batch (``torch_tp_train_families_ref.run_jobs``:
``{arch}/{case}/...`` the loss, ``grad_norm``, ``load_balance``, the
layer-wise norms and the params after it; ``{arch}/inputs/...``), and
``{arch}/provenance-2x2``: the per-leaf provenance (JSON) the
reference's ``save`` records for a fused TVLARS state placed by
``state_pspecs(fsdp=True)`` on ``make_data_mesh(2, 2)``.

``WHAT`` is ``"serve"``: for each arch of :data:`SERVE_ARCHS`, the
reference test's decode loop (``tests/test_sharding_multidevice.py``
``DECODE_SCRIPT``: ``make_serve_step`` and ``decode_step``) on the
smoke config's seed-0 params, from seeded start tokens that differ by
row, on one device and on ``make_data_mesh(2, 4)`` with the params
placed by ``state_pspecs`` and the cache by ``cache_pspecs``
(``serve/{arch}/{single,mesh}/{tokens,logits}``, every step's;
``serve/{arch}/params/{i}``; ``serve/{arch}/specs``: the experts' and
the first K cache's specs).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

import torch_tp_train_families_ref as families_ref

ARCHS = ("olmoe-1b-7b", "qwen3-moe-30b-a3b")
# (arch, reference mesh, cases): tree TVLARS for both archs, fused for
# one, as the reference's own (2, 4) MoE test steps them
TRAIN = (("olmoe-1b-7b", (2, 4), ("tree", "fused")),
         ("qwen3-moe-30b-a3b", (2, 4), ("tree",)))
SERVE_ARCHS = ARCHS
STEP_BATCH, STEP_LEN, STEPS = 8, 16, 4
TIMEOUT_S = 240


def start_tokens(vocab: int) -> np.ndarray:
    return np.random.RandomState(11).randint(
        1, vocab, size=(STEP_BATCH, 1)).astype(np.int32)


def serve_params(arch: str) -> dict:
    """The reference's seed-0 smoke params as numpy."""
    import jax
    from repro.configs import get_smoke_config
    from repro.models import get_model
    return jax.tree_util.tree_map(np.asarray, get_model(
        get_smoke_config(arch)).init(jax.random.PRNGKey(0)))


def _shapes(tree):
    import jax
    return jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)


def provenance_2x2(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    from repro import checkpoint
    from repro.core import build_optimizer
    from repro.launch import sharding
    from repro.launch.mesh import make_data_mesh
    from repro.training.train_state import TrainState
    mesh = make_data_mesh(2, 2)
    for arch, _, _ in TRAIN:
        params, _ = families_ref.inputs(arch)
        state = TrainState.create(
            jax.tree_util.tree_map(jnp.asarray, params),
            build_optimizer("tvlars", **families_ref.HYPER,
                            use_kernel="fused"))
        with mesh:
            placed = jax.device_put(state, sharding.named(
                mesh, sharding.state_pspecs(mesh, _shapes(state),
                                            fsdp=True)))
            with tempfile.TemporaryDirectory() as tmp:
                checkpoint.save(tmp, placed, step=0)
                out[f"{arch}/provenance-2x2"] = np.asarray(
                    json.dumps(checkpoint.saved_shardings(tmp)))


def serve(out: dict) -> None:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.launch import sharding
    from repro.launch.mesh import make_data_mesh
    from repro.models import get_model
    from repro.models import layers as layers_lib
    from repro.serving.decode import make_serve_step

    def is_spec(x):
        return isinstance(x, jax.sharding.PartitionSpec)

    for arch in SERVE_ARCHS:
        cfg = get_smoke_config(arch)
        m = get_model(cfg)
        layers_lib.set_batch_sharding(None)
        params = serve_params(arch)
        for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
            out[f"serve/{arch}/params/{i}"] = leaf
        params = jax.tree_util.tree_map(jnp.asarray, params)
        serve_step = make_serve_step(m)
        start = jnp.asarray(start_tokens(cfg.vocab_size))

        def run(step_fn, decode, params, cache, tok):
            logits, got = [], []
            for i in range(STEPS):
                logits.append(np.asarray(decode(params, cache, tok,
                                                jnp.int32(i))[0]))
                tok, cache = step_fn(params, cache, tok, jnp.int32(i))
                got.append(np.asarray(tok))
            return np.stack(got), np.stack(logits)

        cache = m.init_cache(params, STEP_BATCH, STEP_LEN, None)
        key = f"serve/{arch}"
        out[f"{key}/single/tokens"], out[f"{key}/single/logits"] = run(
            jax.jit(serve_step), jax.jit(m.decode_step), params, cache,
            start)
        mesh = make_data_mesh(2, 4)
        with mesh:
            layers_lib.set_batch_sharding(("data",), None, model_size=4,
                                          mesh=mesh)
            pspecs = sharding.state_pspecs(mesh, _shapes(params))
            cspecs = sharding.cache_pspecs(mesh, _shapes(cache))
            moe = pspecs["groups"]["l0_attn"]["moe"]
            out[f"{key}/specs"] = np.asarray(json.dumps({
                name: repr(tuple(moe[name])) for name in sorted(moe)}
                | {"k": repr(tuple(jax.tree_util.tree_leaves(
                    cspecs, is_leaf=is_spec)[0]))}))
            params_sh = sharding.named(mesh, pspecs)
            cache_sh = sharding.named(mesh, cspecs)
            ins = (params_sh, cache_sh, None, None)
            out[f"{key}/mesh/tokens"], out[f"{key}/mesh/logits"] = run(
                jax.jit(serve_step, in_shardings=ins),
                jax.jit(m.decode_step, in_shardings=ins),
                jax.device_put(params, params_sh),
                jax.device_put(cache, cache_sh), start)
        layers_lib.set_batch_sharding(None)


def main(what: str, path: str) -> None:
    out: dict = {}
    if what == "train":
        families_ref.run_jobs(TRAIN, out)
        provenance_2x2(out)
    elif what == "serve":
        serve(out)
    else:
        raise ValueError(what)
    np.savez(path, **out)


# ---------------------------------------------------------------- the tests'
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start(what: str, out: str) -> subprocess.Popen:
    """:func:`main` in a subprocess of 8 fabricated host devices (the
    caller waits with :func:`finish`)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
        + " --xla_cpu_multi_thread_eigen=false").strip(),
        OMP_NUM_THREADS="1",
        PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                    os.path.join(ROOT, "tests")]))
    return subprocess.Popen(
        [sys.executable, "-c",
         f"import torch_ep_ref as r; r.main({what!r}, {out!r})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def finish(proc: subprocess.Popen, out: str) -> dict:
    """The subprocess's results; it is killed if it outlives
    :data:`TIMEOUT_S` or the caller fails first."""
    try:
        log, _ = proc.communicate(timeout=TIMEOUT_S)
        assert proc.returncode == 0, log.decode()[-4000:]
        with np.load(out) as z:
            return {k: z[k] for k in z.files}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
