"""The port's side of the expert-parallel tests (``test_torch_ep_train.py``,
``test_torch_ep_serving.py``): functions that run on every rank of a
gloo world on the CPU (``launch.mesh.spawn``), and the same steps on
one rank for the single-rank comparisons.

Not collected, and imports torch, numpy and ``repro_torch`` only (a
spawned rank imports this module afresh). Training inputs are the
reference's own smoke params and batch in its stacked layout
(``torch_tp_train_families_ref.inputs``); every function returns numpy.

A step (``torch_tp_train_families_ranks.step``) also records every MoE
layer's routing decisions (``topk_idx``, ``keep``) in the order the
forward routes them, with the batch rows the rank's data row holds, so
the tests first hold the decisions equal to the single-rank step's.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

import torch_tp_ranks as serving_ranks
import torch_tp_train_families_ranks as fam
from repro_torch import distributed as dist_lib
from repro_torch import serving
from repro_torch.configs import get_smoke_config
from repro_torch.core import build_optimizer
from repro_torch.core.base import tree_leaves
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as train_launch
from repro_torch.models import convert, get_model, moe
from repro_torch.models import layers as L
from repro_torch.training import TrainState, make_train_step

# each control's fault and the metric that must show it: the segments'
# gradient norms (at init the experts' output is small beside the
# residual stream, so an unsummed output moves the loss by 4.7e-6 only,
# under its bound, while its gradients move by 2.5e-3)
CONTROLS = {"router-unsummed": "layerwise/g_norm",
            "aux-counted-m-times": "layerwise/g_norm",
            "expert-out-unsummed": "layerwise/g_norm"}
# the whole-experts run: olmoe's smoke config with 8 heads, so that a
# model axis of 8 splits the heads (4 would not: the Dh fallback) and
# not its 4 experts
WHOLE_ARCH = "olmoe-1b-7b"
WHOLE_EDITS = dict(num_heads=8, num_kv_heads=8)
WHOLE_MESH = (1, 8)


@contextlib.contextmanager
def recording():
    """Inside the block every ``moe.route`` call appends its decisions
    ``(topk_idx, keep)`` (numpy) to the yielded list."""
    calls: list = []
    real = moe.route

    def route(params, cfg, x):
        r = real(params, cfg, x)
        calls.append((r.topk_idx.numpy().copy(), r.keep.numpy().copy()))
        return r

    moe.route = route
    try:
        yield calls
    finally:
        moe.route = real


def step(arch: str, params_np: dict, batch_np: dict, case: str,
         mesh=None, *, ckpt: str = "") -> dict:
    """``torch_tp_train_families_ranks.step`` with its routing recorded
    (``routing``: a list of ``(topk_idx, keep)`` a layer call) and the
    rows of the batch this rank routes (``rows``)."""
    with recording() as calls:
        out = fam.step(arch, params_np, batch_np, case, mesh, ckpt=ckpt)
    b = len(batch_np["tokens"])
    rows = slice(0, b) if mesh is None else mesh.data_block(b)
    out["routing"] = calls
    out["rows"] = (rows.start, rows.stop)
    return out


@contextlib.contextmanager
def fault(name: str, cfg):
    """One of :data:`CONTROLS` put into the port for the block."""
    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "router-unsummed":
        # the gathered logits reach the combine weights without
        # copy_to_row: gather_row's backward then takes this rank's
        # block of a gradient that holds only its own experts' entries
        real = dist_lib.copy_to_row

        def copy_to_row(x, mesh):
            if x.dtype == torch.float32 and x.dim() == 3 \
                    and x.shape[-1] == cfg.num_experts:
                return x
            return real(x, mesh)
        patch(dist_lib, "copy_to_row", copy_to_row)
    elif name == "aux-counted-m-times":
        # the aux losses read the logits through copy_to_row too: their
        # gradient, the same on every rank, is summed over the row
        real_aux = moe.aux_losses

        def aux_losses(cfg_, r):
            logits = dist_lib.copy_to_row(r.logits, L.declared_mesh())
            return real_aux(cfg_, r._replace(
                logits=logits, probs=torch.softmax(logits, dim=-1)))
        patch(moe, "aux_losses", aux_losses)
    elif name == "expert-out-unsummed":
        # each rank's partial expert output left unsummed over the row
        real_sum = L._row_sum

        def row_sum(y, local, full, what):
            return y if what == "moe wo" else real_sum(y, local, full, what)
        patch(L, "_row_sum", row_sum)
    else:
        raise ValueError(name)
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)


def whole_step(mesh=None) -> dict:
    """One tree TVLARS step of :data:`WHOLE_ARCH` at
    :data:`WHOLE_EDITS` from the port's seed-0 draw (on one rank, or
    this rank's blocks of it on ``mesh``): the loss, the params after
    it gathered whole, the routing and each rank's experts' count."""
    cfg = get_smoke_config(WHOLE_ARCH).replace(**WHOLE_EDITS)
    model = get_model(cfg)
    place = None if mesh is None else convert.placement(cfg, mesh)
    params = model.init(0, device="cpu", mesh=mesh, fsdp=True)
    opt = build_optimizer("tvlars", **fam.HYPER, segments=model.segments,
                          device="cpu", placement=place)
    g = torch.Generator().manual_seed(5)
    batch = {k: torch.randint(0, cfg.vocab_size, (fam.BATCH, fam.SEQ),
                              generator=g) for k in ("tokens", "labels")}
    train = make_train_step(model, opt, mesh=mesh, placement=place)
    experts = params["layers"][0]["moe"]["wi"].shape[0]
    heads = params["layers"][0]["attn"]["wq"].shape[1]
    with recording() as calls:
        state, metrics = train(TrainState.create(params, opt), batch)
    whole = state.params if place is None \
        else convert.gather_params(state.params, place)
    return {"loss": float(metrics["loss"]), "experts": experts,
            "heads": heads, "routing": calls,
            "params": [p.detach().numpy().copy()
                       for p in tree_leaves(whole)]}


def train_world(jobs: tuple, ckpt: str, probes: tuple,
                launches: tuple) -> dict:
    """On one rank of the world: each job ``(arch, params, batch, (D,
    M), cases, controls, save)`` on a ``(D, M)`` mesh of the world's
    first ranks (each case's recorded step, the fused case's state saved
    under ``ckpt/{arch}/{D}x{M}/fused`` where ``save``, then each
    control's tree step under its fault); the whole-experts step on
    :data:`WHOLE_MESH`; each
    probe job ``(arch, params, batch, (D, M), controls)`` (the probe,
    then each control's probe under its fault); then
    ``launch.train.run`` on each argv of ``launches``. Every rank's
    numbers; rank 0's are the test's."""
    torch.set_num_threads(1)
    out: dict = {"rank": dist_lib.world().rank}
    shapes = [job[3] for job in jobs] + [WHOLE_MESH] \
        + [job[3] for job in probes]
    meshes = {s: mesh_lib.make_host_mesh(*s) for s in dict.fromkeys(shapes)}
    for arch, params_np, batch_np, shape, cases, controls, save in jobs:
        mesh = meshes[shape]
        if not mesh.member:
            continue
        key = f"{arch}/{shape[0]}x{shape[1]}"
        got: dict = {}
        for case in cases:
            path = f"{ckpt}/{key}/fused" if save and case == "fused" \
                else ""
            got[case] = step(arch, params_np, batch_np, case, mesh,
                             ckpt=path)
        for name in controls:
            with fault(name, fam.config(arch)):
                got[name] = step(arch, params_np, batch_np, "tree", mesh)
        out[key] = got
    out["whole"] = whole_step(meshes[WHOLE_MESH])
    for arch, params_np, batch_np, shape, controls in probes:
        mesh = meshes[shape]
        if not mesh.member:
            continue
        key = f"probe/{arch}/{shape[0]}x{shape[1]}"
        out[key] = {"probe": fam.probe(arch, params_np, batch_np, mesh)}
        for name in controls:
            with fam.fault(name):
                out[key][name] = fam.probe(arch, params_np, batch_np, mesh)
    for i, argv in enumerate(launches):
        lines: list = []
        res = train_launch.run(argv, log_fn=lines.append)
        out[f"launch/{i}"] = {"probes": res["probes"],
                              "losses": res["losses"], "lines": lines}
    return out


# ---------------------------------------------------------------- serving

def _serve_params(arch: str, params_np: dict, mesh):
    cfg = get_smoke_config(arch)
    return cfg, convert.shard_params(cfg, convert.params_from_jax(
        cfg, params_np, device="cpu"), mesh)


def step_world(ref_params: dict, starts: dict) -> dict:
    """The reference's decode loop (``make_serve_step`` and
    ``decode_step``, ``serving_ranks.STEP_LEN`` keys) for each arch of
    ``ref_params`` on a (2, 4) mesh of this world's 8 ranks, on the
    reference's params placed by ``shard_params``: each data row steps
    its half of the batch, tokens and logits gathered over the data
    column; the rank's experts' and KV cache's shapes, and the
    collectives a step."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_host_mesh(2, 4)
    out: dict = {"coords": dict(mesh.coords)}
    for arch, params_np in ref_params.items():
        cfg, params = _serve_params(arch, params_np, mesh)
        model = get_model(cfg)
        rows = mesh.data_block(len(starts[arch]))
        layer = params["layers"][0]
        with L.batch_sharding(mesh):
            cache = model.init_cache(params, rows.stop - rows.start,
                                     serving_ranks.STEP_LEN)
        out[f"{arch}/shapes"] = {
            "router": tuple(layer["moe"]["router"].shape),
            "wi": tuple(layer["moe"]["wi"].shape),
            "wo": tuple(layer["moe"]["wo"].shape),
            "k": tuple(cache[0]["k"].shape)}
        mesh.collectives.clear()
        toks, logits = serving_ranks._serve_step_run(
            model, params, mesh, starts[arch][rows])
        out[f"{arch}/collectives"] = {k: v["calls"] for k, v in
                                      mesh.collectives.items()}
        out[f"{arch}/tokens"] = mesh.data_gather(
            torch.from_numpy(toks), 1).numpy()
        out[f"{arch}/logits"] = mesh.data_gather(
            torch.from_numpy(logits), 1).numpy()
    out["equal"] = mesh_lib.all_equal(mesh, [
        out[k].tobytes() for k in sorted(out)
        if k.endswith(("tokens", "logits"))])
    return out


GEN = (4, 8, 6)                  # generate: prompts, prompt length, new


def gen_prompts(vocab: int) -> torch.Tensor:
    b, s, _ = GEN
    return torch.from_numpy(np.random.RandomState(21).randint(
        1, vocab, size=(b, s)))


def engine_world(data: int, model_axis: int, archs: tuple,
                 launches: tuple = ()) -> dict:
    """The engine (``serving_ranks.PROMPTS``) and ``generate(mesh=)``
    for each arch on a (data, model) mesh of this world, on this rank's
    blocks of the seed-0 draw (``Model.init(0, mesh=)``); then
    ``launch.serve.main`` on each argv of ``launches`` in this world
    (its console lines, rank 0's)."""
    import io
    from repro_torch.launch import serve as serve_launch
    torch.set_num_threads(1)
    mesh = mesh_lib.make_host_mesh(data, model_axis)
    out: dict = {"coords": dict(mesh.coords)}
    for arch in archs:
        model = get_model(get_smoke_config(arch))
        params = model.init(0, device="cpu", mesh=mesh)
        got = serving_ranks.drain(model, params, mesh)
        gen = serving.generate(model, params,
                               gen_prompts(model.cfg.vocab_size),
                               num_tokens=GEN[2], device="cpu", mesh=mesh)
        out[arch] = {"tokens": got["tokens"],
                     "collectives": {k: v["calls"] for k, v in
                                     got["collectives"].items()},
                     "decode_steps": got["stats"]["decode_steps"],
                     "experts": params["layers"][0]["moe"]["wi"].shape[0],
                     "generate": gen.numpy()}
    out["equal"] = mesh_lib.all_equal(
        mesh, [(out[a]["tokens"], out[a]["generate"].tolist())
               for a in archs])
    for i, argv in enumerate(launches):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            serve_launch.main(argv)
        out[f"launch/{i}"] = text.getvalue().splitlines()
    return out


def single_serving(arch: str) -> dict:
    """The engine's and ``generate``'s tokens at M = 1 on the seed-0
    draw, as :func:`engine_world` serves them."""
    model = get_model(get_smoke_config(arch))
    params = model.init(0, device="cpu")
    return {"tokens": serving_ranks.drain(model, params)["tokens"],
            "generate": serving.generate(
                model, params, gen_prompts(model.cfg.vocab_size),
                num_tokens=GEN[2], device="cpu").numpy()}
