"""The JAX package's side of the tests that train the ssm, hybrid,
encdec, vlm and MoE families over the model axis
(``test_torch_tp_train_families.py``, ``test_torch_tp_train_cross.py``).

Not collected: each test file runs :func:`main` in a subprocess whose
environment fabricates 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, set before jax
is imported) and writes every result the port is held against to one
``.npz`` file:

    python -c "import torch_tp_train_families_ref as r; r.main(FILE, OUT)"

``FILE`` names a group of :data:`FILES`. For each arch of the group, on
the reference's own smoke weights (:func:`inputs`; the vlm's cross
gates opened, every family that reads extra embeddings fed seeded
normal ones) and its seeded batch, one TVLARS step of the reference's
GSPMD path on ``make_data_mesh(D, M)`` (``jax.make_mesh`` breaks that
path on this jax: ROADMAP F2) with the state placed by
``state_pspecs(fsdp=True)``, for each optimizer case of the arch:

* ``{arch}/{case}/...``: the loss, ``grad_norm``, ``load_balance``,
  the layer-wise ``w_norm`` / ``g_norm`` / ``trust_ratio`` and the
  params after the step (``.../params/{i}``, leaf order);
* ``{arch}/inputs/...``: the params, tokens and extra embeddings it
  started from;
* ``{arch}/provenance``: the per-leaf provenance (JSON) the reference's
  ``save`` records for the tree case's state so placed, before a step.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

BATCH, SEQ = 8, 32
HYPER = dict(total_steps=10, learning_rate=1.0)
CASES = {"tree": False, "fused": "fused"}
# a smoke config's edits: mamba2 at 6 blocks, so that its conv_w /
# conv_b stack to [6, ...] and fsdp gives the data axis to the stacked
# dim, as it does at full size (48 blocks); at the smoke config's 2
# blocks the conv width (4) takes it
EDITS = {"mamba2-1.3b": dict(num_layers=6)}
GATE = 0.5                       # the vlm's cross gates, opened
# group -> ((arch, mesh, cases), ...): tree TVLARS for every family and
# fused for one a group
FILES = {
    "families": (("mamba2-1.3b", (2, 4), ("tree", "fused")),
                 ("zamba2-1.2b", (2, 4), ("tree",))),
    "cross": (("whisper-large-v3", (2, 4), ("tree",)),
              ("llama-3.2-vision-11b", (2, 4), ("tree", "fused")),
              ("olmoe-1b-7b", (8, 1), ("tree",))),
}
METRICS = ("loss", "grad_norm", "load_balance", "layerwise/w_norm",
           "layerwise/g_norm", "layerwise/trust_ratio")


def config(arch: str):
    from repro.configs import get_smoke_config
    return get_smoke_config(arch).replace(**EDITS.get(arch, {}))


def inputs(arch: str) -> tuple:
    """(params, batch) as numpy: the reference's seed-0 smoke params
    (the vlm's gates at :data:`GATE`) and a seeded batch, with seeded
    normal extra embeddings for vlm and encdec."""
    import jax
    from repro.data.synthetic import lm_batch
    from repro.models import extra_embed_shape, get_model
    cfg = config(arch)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(get_model(cfg).init)(jax.random.PRNGKey(0)))
    if cfg.family == "vlm":
        params["groups"] = {
            k: dict(v, gate=np.full_like(v["gate"], GATE)) if "gate" in v
            else v for k, v in params["groups"].items()}
    toks, labels = lm_batch(jax.random.PRNGKey(1), BATCH, SEQ,
                            cfg.vocab_size)
    batch = {"tokens": np.asarray(toks), "labels": np.asarray(labels)}
    shape = extra_embed_shape(cfg, BATCH)
    if shape is not None:
        batch["extra_embeds"] = np.random.RandomState(3).normal(
            size=shape).astype(np.float32)
    return params, batch


def run(group: str, out: dict) -> None:
    run_jobs(FILES[group], out)


def run_jobs(jobs: tuple, out: dict) -> None:
    """:func:`run`'s steps for ``jobs`` (``(arch, mesh, cases)`` as a
    group of :data:`FILES` holds them)."""
    import jax
    import jax.numpy as jnp
    from repro import checkpoint
    from repro.core import build_optimizer
    from repro.launch import sharding
    from repro.launch.mesh import make_data_mesh
    from repro.models import get_model
    from repro.models import layers as layers_lib
    from repro.training.train_state import TrainState
    from repro.training.trainer import make_train_step

    def shapes(tree):
        return jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)

    for arch, (d, mm), cases in jobs:
        model = get_model(config(arch))
        params_np, batch_np = inputs(arch)
        for i, leaf in enumerate(jax.tree_util.tree_leaves(params_np)):
            out[f"{arch}/inputs/params/{i}"] = leaf
        for k, v in batch_np.items():
            out[f"{arch}/inputs/{k}"] = v
        batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
        mesh = make_data_mesh(d, mm)
        for case in cases:
            opt = build_optimizer("tvlars", **HYPER,
                                  use_kernel=CASES[case])
            state = TrainState.create(
                jax.tree_util.tree_map(jnp.asarray, params_np), opt)
            with mesh:
                layers_lib.set_batch_sharding(("data",), None,
                                              model_size=mm, mesh=mesh)
                state_sh = sharding.named(mesh, sharding.state_pspecs(
                    mesh, shapes(state), fsdp=True))
                batch_sh = sharding.named(mesh, sharding.batch_pspecs(
                    mesh, shapes(batch)))
                placed = jax.device_put(state, state_sh)
                if case == "tree":
                    with tempfile.TemporaryDirectory() as tmp:
                        checkpoint.save(tmp, placed, step=0)
                        out[f"{arch}/provenance"] = np.asarray(
                            json.dumps(checkpoint.saved_shardings(tmp)))
                new, metrics = jax.jit(
                    make_train_step(model, opt, layerwise=True),
                    in_shardings=(state_sh, batch_sh))(
                    placed, jax.device_put(batch, batch_sh))
            layers_lib.set_batch_sharding(None)
            key = f"{arch}/{case}"
            for name in METRICS:
                out[f"{key}/{name}"] = np.asarray(
                    jax.device_get(metrics[name]))
            for i, leaf in enumerate(jax.tree_util.tree_leaves(new.params)):
                out[f"{key}/params/{i}"] = np.asarray(jax.device_get(leaf))


def main(group: str, path: str) -> None:
    out = {}
    run(group, out)
    np.savez(path, **out)


# ---------------------------------------------------------------- the tests'
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240


def start(group: str, out: str):
    """:func:`main` of ``group`` in a subprocess of 8 fabricated host
    devices (a ``subprocess.Popen``; the caller waits)."""
    import subprocess
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
        + " --xla_cpu_multi_thread_eigen=false").strip(),
        OMP_NUM_THREADS="1",
        PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                    os.path.join(ROOT, "tests")]))
    return subprocess.Popen(
        [sys.executable, "-c", "import torch_tp_train_families_ref as r; "
         f"r.main({group!r}, {out!r})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def collect(group: str, tmp: str, controls: dict, launches: tuple = ()
            ) -> dict:
    """Everything a test file of ``group`` holds: the reference's
    results (its subprocess started first, so it overlaps the port's
    world), the inputs, the port's single-rank step of every case, and
    one world of 8 gloo ranks running, for each arch, its cases and
    ``controls[arch]`` on the reference's mesh, its tree case (and the
    fused one where the group runs it) on the first 4 ranks as ``(2,
    2)`` (an MoE arch: ``(8, 1)`` only), and ``launches``."""
    import torch_tp_train_families_ranks as ranks
    from repro_torch.launch import mesh as mesh_lib
    out = f"{tmp}/ref.npz"
    proc = start(group, out)
    try:
        inp = {arch: inputs(arch) for arch, _, _ in FILES[group]}
        jobs, single = [], {}
        for arch, mesh, cases in FILES[group]:
            params, batch = inp[arch]
            single[arch] = {case: ranks.step(arch, params, batch, case)
                            for case in cases}
            jobs.append((arch, params, batch, mesh, cases,
                         controls.get(arch, ())))
            if mesh[1] > 1:
                jobs.append((arch, params, batch, (2, 2), cases, ()))
        worlds = mesh_lib.spawn(ranks.world, 8, "gloo", "cpu",
                                args=(tuple(jobs), tmp, launches),
                                timeout=TIMEOUT_S)
        log, _ = proc.communicate(timeout=TIMEOUT_S)
        assert proc.returncode == 0, log.decode()[-4000:]
        with np.load(out) as z:
            reference = {k: z[k] for k in z.files}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return {"ref": reference, "inputs": inp, "single": single,
            "worlds": worlds, "root": tmp}


def leaves(res: dict, key: str) -> list:
    """``res[key/0]``, ``res[key/1]``, ... in order."""
    n = sum(1 for k in res if k.startswith(key + "/")
            and k[len(key) + 1:].isdigit())
    return [res[f"{key}/{i}"] for i in range(n)]


def rel_gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


# the reference test's bounds (tests/test_sharding_multidevice.py) and
# the norms', and the port's own single-rank step in f32
BOUNDS = dict(loss=1e-3, params_rtol=2e-2, params_atol=2e-3, norms=1e-3,
              load_balance=1e-4)
F32 = 1e-5
NORMS = ("grad_norm", "layerwise/w_norm", "layerwise/g_norm",
         "layerwise/trust_ratio")


def mesh_key(mesh: tuple) -> str:
    return f"{mesh[0]}x{mesh[1]}"


def cases(group: str) -> list:
    """``(arch, case)`` of every step the group holds against the
    reference."""
    return [(arch, case) for arch, _, cs in FILES[group] for case in cs]


def single_cases(group: str) -> list:
    """``(arch, mesh, case)`` of every step the group holds against the
    port's single-rank step: ``(2, 2)``, or the reference's mesh for an
    MoE arch (no model axis)."""
    return [(arch, mesh_key((2, 2) if m[1] > 1 else m), case)
            for arch, m, cs in FILES[group] for case in cs]


def check_inputs(runs: dict, arch: str) -> None:
    """The subprocess and the test process made the same inputs."""
    import jax
    params, batch = runs["inputs"][arch]
    mine = jax.tree_util.tree_leaves(params)
    theirs = leaves(runs["ref"], f"{arch}/inputs/params")
    assert len(mine) == len(theirs) > 0
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    for k, v in batch.items():
        np.testing.assert_array_equal(v, runs["ref"][f"{arch}/inputs/{k}"])


def check_mesh_step(runs: dict, arch: str, case: str) -> None:
    """The port's step on the reference's mesh against the reference's
    own GSPMD step there, within :data:`BOUNDS`."""
    mesh = dict((a, m) for a, m, _ in FILES_ALL)[arch]
    got = runs["worlds"][0][f"{arch}/{mesh_key(mesh)}"][case]
    ref, key = runs["ref"], f"{arch}/{case}"
    np.testing.assert_allclose(got["loss"], ref[f"{key}/loss"],
                               rtol=BOUNDS["loss"])
    np.testing.assert_allclose(got["load_balance"],
                               ref[f"{key}/load_balance"],
                               rtol=BOUNDS["load_balance"])
    theirs = leaves(ref, f"{key}/params")
    assert len(got["params"]) == len(theirs)
    for a, b in zip(got["params"], theirs):
        np.testing.assert_allclose(a, b, rtol=BOUNDS["params_rtol"],
                                   atol=BOUNDS["params_atol"])
    for name in NORMS:
        np.testing.assert_allclose(got[name], ref[f"{key}/{name}"],
                                   rtol=BOUNDS["norms"], err_msg=name)


def single_gaps(got: dict, want: dict) -> dict:
    """The largest gaps of a mesh step to the single-rank step: the
    loss's and the norms' relative, the params' absolute."""
    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
                            * (np.abs(a - b) > 0)))
    return {"loss": rel(got["loss"], want["loss"]),
            "load_balance": rel(got["load_balance"], want["load_balance"]),
            "params": max(float(np.abs(a - b).max())
                          for a, b in zip(got["params"], want["params"])),
            "norms": max(rel(got[n], want[n]) for n in NORMS)}


def check_single(runs: dict, arch: str, mesh: str, case: str) -> None:
    gaps = single_gaps(runs["worlds"][0][f"{arch}/{mesh}"][case],
                       runs["single"][arch][case])
    assert all(v <= F32 for v in gaps.values()), gaps


def control_gap(runs: dict, arch: str, name: str, metric: str) -> float:
    """The relative gap of ``metric`` of the control's step (the tree
    case under its fault, on the reference's mesh) to the reference's
    tree step."""
    mesh = dict((a, m) for a, m, _ in FILES_ALL)[arch]
    got = runs["worlds"][0][f"{arch}/{mesh_key(mesh)}"][name]
    return rel_gap(got[metric], runs["ref"][f"{arch}/tree/{metric}"])


def check_checkpoint(runs: dict, arch: str) -> None:
    """The state saved on the reference's mesh restores in the JAX
    package to the single-rank step's params, and its provenance is the
    reference's for the same state on the same mesh."""
    import jax
    from repro import checkpoint as jck
    from repro.core import build_optimizer
    from repro.training.train_state import TrainState
    mesh = dict((a, m) for a, m, _ in FILES_ALL)[arch]
    path = os.path.join(runs["root"], arch, mesh_key(mesh), "tree")
    params, _ = runs["inputs"][arch]
    like = TrainState.create(jax.tree_util.tree_map(np.asarray, params),
                             build_optimizer("tvlars", **HYPER))
    restored = jax.tree_util.tree_leaves(jck.restore(path, like))
    assert len(restored) == len(jax.tree_util.tree_leaves(like))
    want = runs["single"][arch]["tree"]["params"]
    for a, b in zip(restored[1:1 + len(want)], want):
        np.testing.assert_allclose(np.asarray(a, np.float32), b, atol=1e-5)
    assert jck.saved_shardings(path) == json.loads(
        str(runs["ref"][f"{arch}/provenance"]))


FILES_ALL = tuple(job for group in FILES.values() for job in group)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
