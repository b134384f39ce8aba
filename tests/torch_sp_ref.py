"""Both sides of the sequence-parallel tests
(``test_torch_seq_parallel.py``): the JAX package's GSPMD step with
``set_batch_sharding(..., seq_axis="model")``, and the port's step over
a gloo world.

Not collected. The module imports numpy, torch and ``repro_torch`` only
at its top (a spawned rank imports it afresh); the reference side
imports jax inside :func:`main`, which runs in a subprocess whose
environment fabricates 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, set before jax
is imported) and writes every result the port is held against to one
``.npz`` file:

    python -c "import torch_sp_ref as r; r.main(OUT)"

On the reference's own smoke weights and seeded batch
(``torch_tp_train_families_ref.inputs``: mamba2 at 6 blocks, the vlm's
cross gates opened, seeded extra embeddings), for each arch of
:data:`ARCHS`, on ``make_data_mesh(2, 4)`` with the sequence over the
model axis:

* ``{arch}/tree/...``: one tree-TVLARS GSPMD step (loss, ``grad_norm``,
  ``load_balance``, the layer-wise norms, the params after it);
* ``{arch}/logits``: the forward's last-position logits [B, 1, V];

and for the bf16 question (:data:`Q1`: the vlm's cross gate and
whisper's final norm), the bf16 configs' layer-wise ``g_norm`` of one
tree step on one device and on the ``(2, 4)`` mesh with and without
the sequence axis (``q1/{arch}/{single,mesh,seq}``).
"""
from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch

import torch_tp_train_families_ref as fam
from repro_torch import distributed as dist_lib
from repro_torch.core import build_optimizer
from repro_torch.core.base import tree_leaves
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import convert, get_model
from repro_torch.models import layers as L
from repro_torch.training import TrainState, make_train_step

ARCHS = ("qwen2.5-3b", "olmoe-1b-7b", "mamba2-1.3b", "zamba2-1.2b",
         "whisper-large-v3", "llama-3.2-vision-11b")
MESH = (2, 4)
# archs also run at (1, 8), where their heads (whisper, the vlm) or
# experts (olmoe) stay whole: the rows-only attention and the
# replicated MoE block of the recipe
WHOLE = ("olmoe-1b-7b", "whisper-large-v3", "llama-3.2-vision-11b")
HYPER = fam.HYPER
METRICS = fam.METRICS
Q1 = ("llama-3.2-vision-11b", "whisper-large-v3")
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


def config(arch: str, bf16: bool = False):
    """The port's config of the reference side's (``fam.config``)."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch).replace(**fam.EDITS.get(arch, {}))
    return cfg.replace(**BF16) if bf16 else cfg


# ------------------------------------------------------------ the port's
def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _batch(batch_np: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(
        v, np.float32 if k == "extra_embeds" else np.int64))
        for k, v in batch_np.items()}


def step(cfg, params_np: dict, batch_np: dict, mesh=None, *,
         seq: bool = False) -> dict:
    """One TVLARS step from the reference's params on the global batch:
    on one rank (``mesh=None``) or on this rank's fsdp + tensor-parallel
    blocks of ``mesh``, with the sequence over the model axis when
    ``seq``. The metrics, the params after it gathered whole in the
    reference's leaf order, and the mesh's collective records."""
    model = get_model(cfg)
    params = convert.params_from_jax(cfg, params_np, device="cpu")
    place = None
    if mesh is not None:
        params = convert.shard_params(cfg, params, mesh, fsdp=True)
        place = convert.placement(cfg, mesh)
    opt = build_optimizer("tvlars", **HYPER, segments=model.segments,
                          device="cpu", placement=place)
    state = TrainState.create(params, opt)
    train = make_train_step(model, opt, mesh=mesh, placement=place,
                            layerwise=True)
    if seq:
        L.set_batch_sharding(("data",), "model", model_size=mesh.model,
                             mesh=mesh)
    try:
        state, metrics = train(state, _batch(batch_np))
    finally:
        L.set_batch_sharding(None)
    out = {k: _np(metrics[k]) for k in METRICS}
    whole = state.params if place is None \
        else convert.gather_params(state.params, place)
    out["params"] = [_np(x) for x in tree_leaves(
        convert.params_to_jax(cfg, whole))]
    if mesh is not None:
        out["collectives"] = {k: (v["calls"], v["bytes"])
                              for k, v in mesh.collectives.items()}
    return out


def logits(cfg, params_np: dict, batch_np: dict, mesh) -> np.ndarray:
    """``Model.apply``'s last-position logits [B, 1, V] of the global
    batch on this rank's tensor-parallel blocks of ``mesh`` (its data
    row's block of the batch, gathered over the data column), with the
    sequence over the model axis."""
    model = get_model(cfg)
    params = convert.shard_params(
        cfg, convert.params_from_jax(cfg, params_np, device="cpu"), mesh)
    batch = _batch(batch_np)
    extra = batch.get("extra_embeds")
    rows = mesh.data_block(batch["tokens"].shape[0])
    L.set_batch_sharding(("data",), "model", model_size=mesh.model,
                         mesh=mesh)
    try:
        with torch.no_grad():
            out = model.apply(params, batch["tokens"][rows],
                              None if extra is None else extra[rows])
    finally:
        L.set_batch_sharding(None)
    return _np(mesh.data_gather(out[:, -1:].contiguous(), 0))


def no_sum_scatter(x, mesh, dim=1):
    """The control's ``scatter_seq``: the rank's block of its own
    partial, never summed over the row."""
    if mesh.model == 1:
        return x
    n = x.shape[dim] // mesh.model
    return x.narrow(dim, mesh.coords["model"] * n, n).contiguous()


def world(jobs: tuple) -> dict:
    """On one rank of a gloo world of 8: each job ``(name, arch, params,
    batch, (D, M), kind)`` on a ``(D, M)`` mesh of the world's first
    ranks; ``kind`` is ``"sp"`` / ``"plain"`` (a tree step with and
    without the sequence axis), ``"no-sum"`` (the SP step with
    :func:`no_sum_scatter`), ``"logits"``, ``"bf16-sp"`` /
    ``"bf16-plain"`` (the bf16 config's steps). Every rank's results;
    rank 0's are the test's."""
    torch.set_num_threads(1)
    out: dict = {"rank": dist_lib.world().rank}
    for name, arch, params_np, batch_np, (d, m), kind in jobs:
        mesh = mesh_lib.make_host_mesh(d, m)
        if not mesh.member:
            continue
        cfg = config(arch, bf16=kind.startswith("bf16"))
        if kind == "logits":
            out[name] = logits(cfg, params_np, batch_np, mesh)
        elif kind == "no-sum":
            real = dist_lib.scatter_seq
            dist_lib.scatter_seq = no_sum_scatter
            try:
                out[name] = step(cfg, params_np, batch_np, mesh, seq=True)
            finally:
                dist_lib.scatter_seq = real
        else:
            out[name] = step(cfg, params_np, batch_np, mesh,
                             seq=kind.endswith("sp"))
    return out


# ------------------------------------------------------- the reference's
def run_reference(out: dict) -> None:
    """Every result of the module docstring, into ``out``."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.core import build_optimizer as ref_build
    from repro.launch import sharding
    from repro.launch.mesh import make_data_mesh
    from repro.models import get_model as ref_model
    from repro.models import layers as ref_layers
    from repro.training.train_state import TrainState as RefState
    from repro.training.trainer import make_train_step as ref_step

    def shapes(tree):
        return jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)

    mesh = make_data_mesh(*MESH)

    def train(model, params_np, batch, seq_axis, on_mesh=True):
        opt = ref_build("tvlars", **HYPER)
        state = RefState.create(
            jax.tree_util.tree_map(jnp.asarray, params_np), opt)
        fn = ref_step(model, opt, layerwise=True)
        if not on_mesh:
            return jax.jit(fn)(state, batch)
        with mesh:
            ref_layers.set_batch_sharding(("data",), seq_axis,
                                          model_size=MESH[1], mesh=mesh)
            state_sh = sharding.named(mesh, sharding.state_pspecs(
                mesh, shapes(state), fsdp=True))
            batch_sh = sharding.named(mesh, sharding.batch_pspecs(
                mesh, shapes(batch)))
            try:
                return jax.jit(fn, in_shardings=(state_sh, batch_sh))(
                    jax.device_put(state, state_sh),
                    jax.device_put(batch, batch_sh))
            finally:
                ref_layers.set_batch_sharding(None)

    for arch in ARCHS:
        model = ref_model(fam.config(arch))
        params_np, batch_np = fam.inputs(arch)
        batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
        new, metrics = train(model, params_np, batch, "model")
        for name in METRICS:
            out[f"{arch}/tree/{name}"] = np.asarray(metrics[name])
        for i, leaf in enumerate(jax.tree_util.tree_leaves(new.params)):
            out[f"{arch}/tree/params/{i}"] = np.asarray(leaf)
        with mesh:
            ref_layers.set_batch_sharding(("data",), "model",
                                          model_size=MESH[1], mesh=mesh)
            p_sh = sharding.named(mesh, sharding.state_pspecs(
                mesh, shapes(params_np), fsdp=False))
            b_sh = sharding.named(mesh, sharding.batch_pspecs(
                mesh, shapes(batch)))
            try:
                lg = jax.jit(lambda p, b: model.apply(p, b)[0][:, -1:],
                             in_shardings=(p_sh, b_sh))(
                    jax.device_put(jax.tree_util.tree_map(
                        jnp.asarray, params_np), p_sh),
                    jax.device_put(batch, b_sh))
            finally:
                ref_layers.set_batch_sharding(None)
        out[f"{arch}/logits"] = np.asarray(lg)

    for arch in Q1:
        cfg = get_smoke_config(arch).replace(**fam.EDITS.get(arch, {}),
                                             **BF16)
        model = ref_model(cfg)
        params_np, batch_np = q1_inputs(arch)
        batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
        for key, args in (("single", (None, False)), ("mesh", (None, True)),
                          ("seq", ("model", True))):
            _, metrics = train(model, params_np, batch, *args)
            out[f"q1/{arch}/{key}"] = np.asarray(
                metrics["layerwise/g_norm"], np.float32)


def q1_inputs(arch: str) -> tuple:
    """The bf16 config's params (the f32 inputs' leaves rounded to each
    leaf's dtype under the bf16 config) and the same batch."""
    import jax
    import ml_dtypes
    from repro.configs import get_smoke_config
    from repro.models import get_model as ref_model
    params, batch = fam.inputs(arch)
    cfg = get_smoke_config(arch).replace(**fam.EDITS.get(arch, {}), **BF16)
    like = jax.eval_shape(ref_model(cfg).init, jax.random.PRNGKey(0))
    cast = jax.tree_util.tree_map(
        lambda x, s: np.asarray(x).astype(
            ml_dtypes.bfloat16 if s.dtype.name == "bfloat16" else x.dtype),
        params, like)
    return cast, batch


# the dry-run tests' small shapes (test_torch_dryrun.py), added to
# both packages' INPUT_SHAPES where they run
TINY_SHAPES = {
    "tiny_train": {"seq_len": 32, "global_batch": 8, "kind": "train"},
    "tiny_prefill": {"seq_len": 32, "global_batch": 8, "kind": "prefill"},
    "tiny_decode": {"seq_len": 32, "global_batch": 8, "kind": "decode"},
}
# (arch, shape) pairs the dry-run tests hold to the reference
DRY_PAIRS = (("qwen2.5-3b", "tiny_train"), ("qwen2.5-3b", "tiny_prefill"),
             ("qwen2.5-3b", "tiny_decode"), ("olmoe-1b-7b", "tiny_train"),
             ("mamba2-1.3b", "tiny_train"), ("whisper-large-v3",
                                             "tiny_train"),
             ("llama-3.2-vision-11b", "tiny_train"))


def run_dryrun_reference(out: dict) -> None:
    """For each of :data:`DRY_PAIRS`, on the smoke config and its tiny
    shape: the reference's ``build_lowerable`` lowered and compiled on
    ``make_data_mesh(2, 4)`` (``dry/{arch}/{shape}/...``): the argument
    bytes a device (``memory_analysis``), the structural dot FLOPs a
    device (``hlo_analysis.analyze``) and the collectives
    (``parse_collectives``, JSON)."""
    import json

    import jax
    from repro.configs import INPUT_SHAPES as ref_shapes
    from repro.configs import get_smoke_config
    from repro.launch.mesh import make_data_mesh
    jax.devices()        # 8 host devices, before dryrun sets its flags
    from repro.launch import dryrun, hlo_analysis
    ref_shapes.update(TINY_SHAPES)
    dryrun.get_config = get_smoke_config
    mesh = make_data_mesh(*MESH)
    for arch, shape in DRY_PAIRS:
        with mesh:
            fn, args = dryrun.build_lowerable(arch, shape, mesh)
            compiled = fn.lower(*args).compile()
        from repro.models import layers as ref_layers
        ref_layers.set_batch_sharding(None)
        text = compiled.as_text()
        key = f"dry/{arch}/{shape}"
        out[f"{key}/argument_bytes"] = np.asarray(
            compiled.memory_analysis().argument_size_in_bytes)
        out[f"{key}/flops"] = np.asarray(hlo_analysis.analyze(text)["flops"])
        out[f"{key}/collectives"] = np.asarray(json.dumps(
            dryrun.parse_collectives(text)))


def main(path: str, group: str = "sp") -> None:
    out: dict = {}
    (run_reference if group == "sp" else run_dryrun_reference)(out)
    np.savez(path, **out)


# ---------------------------------------------------------------- the tests'
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300


def start(out: str, group: str = "sp"):
    """:func:`main` of ``group`` in a subprocess of 8 fabricated host
    devices."""
    import subprocess
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
        + " --xla_cpu_multi_thread_eigen=false").strip(),
        OMP_NUM_THREADS="1",
        PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                    os.path.join(ROOT, "tests")]))
    return subprocess.Popen(
        [sys.executable, "-c",
         f"import torch_sp_ref as r; r.main({out!r}, {group!r})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def jobs_for(inputs: dict) -> tuple:
    """The port world's jobs (:func:`world`) for ``inputs`` ``{arch:
    (params, batch)}`` (the bf16 question's archs also ``{arch +
    "/bf16": ...}``)."""
    jobs = []
    for arch in ARCHS:
        p, b = inputs[arch]
        jobs += [(f"{arch}/2x4/sp", arch, p, b, MESH, "sp"),
                 (f"{arch}/2x4/logits", arch, p, b, MESH, "logits"),
                 (f"{arch}/2x2/sp", arch, p, b, (2, 2), "sp"),
                 (f"{arch}/2x2/plain", arch, p, b, (2, 2), "plain")]
        if arch in WHOLE:
            jobs.append((f"{arch}/1x8/sp", arch, p, b, (1, 8), "sp"))
    p, b = inputs[ARCHS[0]]
    jobs.append((f"{ARCHS[0]}/2x4/no-sum", ARCHS[0], p, b, MESH, "no-sum"))
    for arch in Q1:
        p, b = inputs[arch + "/bf16"]
        jobs += [(f"q1/{arch}/mesh", arch, p, b, MESH, "bf16-plain"),
                 (f"q1/{arch}/seq", arch, p, b, MESH, "bf16-sp")]
    return tuple(jobs)


def collect(tmp: str) -> dict:
    """Everything ``test_torch_seq_parallel.py`` holds: the reference's
    results (its subprocess started first, so it overlaps the port's
    world), the inputs, the port's single-rank steps (f32, and bf16 for
    :data:`Q1`) and one gloo world of 8 ranks running
    :func:`jobs_for`'s jobs."""
    out = f"{tmp}/ref.npz"
    proc = start(out)
    try:
        inputs = {arch: fam.inputs(arch) for arch in ARCHS}
        for arch in Q1:
            inputs[arch + "/bf16"] = q1_inputs(arch)
        single = {arch: step(config(arch), *inputs[arch]) for arch in ARCHS}
        for arch in Q1:
            single[f"q1/{arch}"] = step(config(arch, bf16=True),
                                        *inputs[arch + "/bf16"])
        worlds = mesh_lib.spawn(world, 8, "gloo", "cpu",
                                args=(jobs_for(inputs),), timeout=TIMEOUT_S)
        log, _ = proc.communicate(timeout=TIMEOUT_S)
        assert proc.returncode == 0, log.decode()[-4000:]
        with np.load(out) as z:
            reference = {k: z[k] for k in z.files}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return {"ref": reference, "inputs": inputs, "single": single,
            "world": worlds[0]}


@contextlib.contextmanager
def tiny_shapes():
    """The port's dry run on the smoke configs and :data:`TINY_SHAPES`
    inside the block (``INPUT_SHAPES`` extended, ``dryrun.get_config``
    the smoke config's), as the reference side patches its own."""
    from repro_torch.configs import INPUT_SHAPES, get_smoke_config
    from repro_torch.launch import dryrun
    saved = dryrun.get_config
    INPUT_SHAPES.update(TINY_SHAPES)
    dryrun.get_config = get_smoke_config
    try:
        yield dryrun
    finally:
        dryrun.get_config = saved
        for k in TINY_SHAPES:
            INPUT_SHAPES.pop(k, None)


def dry_trace(arch: str, shape: str, mesh, device="meta", **kw) -> dict:
    """``dryrun.build_step`` + ``dryrun.trace`` of (arch, shape) on
    ``mesh`` (a ``DryMesh`` on meta, or a joined world's mesh on the
    CPU: the same step run for real), under :func:`tiny_shapes`."""
    with tiny_shapes() as dryrun:
        try:
            step = dryrun.build_step(arch, shape, mesh, device=device, **kw)
            return dryrun.trace(step, mesh)
        finally:
            L.set_batch_sharding(None)


def dry_world(pairs: tuple, mesh_shape: tuple) -> dict:
    """On each rank of a gloo world: each pair's step built for real on
    the CPU over a ``mesh_shape`` mesh and traced: its collective
    records and FLOPs (rank 0's and the last rank's are the test's)."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_host_mesh(*mesh_shape)
    out = {"rank": mesh.rank}
    for arch, shape in pairs:
        got = dry_trace(arch, shape, mesh, device="cpu")
        out[f"{arch}/{shape}"] = {k: got[k] for k in ("collectives",
                                                      "flops")}
    return out


def q1_gaps(runs: dict) -> dict:
    """The bf16 question (ROADMAP §3 Q1) from :func:`collect`'s results:
    for each arch of :data:`Q1` and each of the vlm gate's and the final
    norm's segments, the relative gap of the ``(2, 4)`` step's g_norm to
    the one-device step's, without and with the sequence axis, in the
    reference and in the port; and the two packages' one-device
    values' own gap."""
    from repro_torch.models import get_model as port_model
    out = {}
    for arch in Q1:
        cfg = config(arch, bf16=True)
        names = [s.name for s in port_model(cfg).segments(
            port_model(cfg).init(0, device="meta"))]
        ref_one = runs["ref"][f"q1/{arch}/single"]
        port_one = runs["single"][f"q1/{arch}"]["layerwise/g_norm"]
        for i, name in enumerate(names):
            if not (name.endswith("gate") or name.startswith("final_norm")):
                continue
            row = {"one-device, port vs reference":
                   abs(port_one[i] - ref_one[i]) / abs(ref_one[i])}
            for key in ("mesh", "seq"):
                ref = runs["ref"][f"q1/{arch}/{key}"][i]
                port = runs["world"][f"q1/{arch}/{key}"][
                    "layerwise/g_norm"][i]
                row[f"reference {key}"] = abs(ref - ref_one[i]) \
                    / abs(ref_one[i])
                row[f"port {key}"] = abs(port - port_one[i]) \
                    / abs(port_one[i])
            out[f"{arch} {name}"] = {k: float(v) for k, v in row.items()}
    return out


if __name__ == "__main__":
    # PYTHONPATH=src:tests python tests/torch_sp_ref.py: the Q1 table
    # (about 2 minutes)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        for row, gaps in q1_gaps(collect(tmp)).items():
            print(row, {k: f"{v:.4%}" for k, v in gaps.items()})
