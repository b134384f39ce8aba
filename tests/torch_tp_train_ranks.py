"""The port's side of the tensor-parallel training tests: functions that
run on every rank of a gloo world on the CPU (``launch.mesh.spawn``),
and the same step on one rank for the single-rank controls.

Not collected, and imports torch, numpy and ``repro_torch`` only (a
spawned rank imports this module afresh). Inputs arrive as numpy trees
in the reference's stacked layout (the reference's own params and
batch). Every function returns numpy: the step's loss, ``grad_norm``
and layer-wise ``w_norm`` / ``g_norm`` / ``trust_ratio``, the params
after the step gathered whole (``convert.gather_params``) in the
reference's leaf order, what the ranks saw of their collectives, and
whether the ranks that hold the same block hold the same bits
(``train_state.replicas_equal``).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch import distributed as dist_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.core import build_optimizer
from repro_torch.core.base import tree_leaves
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as train_launch
from repro_torch.models import convert, get_model
from repro_torch.models import layers as L
from repro_torch.training import TrainState, make_train_step
from repro_torch.training.train_state import replicas_equal

# the reference test's SCRIPT model (tests/test_sharding_multidevice.py)
# with QKV biases, which it leaves out: 4 heads and 2 KV heads, so at
# model 4 wk / wv stay whole and every rank reads one KV group
TRAIN_LM = dict(family="dense", num_layers=2, d_model=64, num_heads=4,
                num_kv_heads=2, d_ff=128, vocab_size=128, remat=True,
                qkv_bias=True)
BATCH, SEQ = 8, 32
HYPER = dict(total_steps=10, learning_rate=1.0)
# (name, optimizer, use_kernel)
CASES = {"tree": ("tvlars", False), "fused": ("tvlars", "fused"),
         "per_tensor": ("wa-lars", "per_tensor"),
         "fused-k2": ("tvlars", "fused")}
ACCUM = {"fused-k2": 2}         # microbatches of the global batch
# the faults each control puts in, which the f32 bounds must catch
CONTROLS = ("bias-unsummed", "wk-unsummed", "table-unweighted",
            "fsdp-undivided")
METRICS = ("loss", "grad_norm", "layerwise/w_norm", "layerwise/g_norm",
           "layerwise/trust_ratio")


def config() -> ModelConfig:
    return ModelConfig(**TRAIN_LM)


def port_inputs(seed: int = 0) -> tuple:
    """(params, batch) as numpy without jax: the port's seed-``seed``
    init in the reference's layout with seeded QKV biases (normal(0.05),
    as the reference side draws them), and a seeded batch."""
    cfg = config()
    params = convert.params_to_jax(cfg, get_model(cfg).init(seed,
                                                            device="cpu"))
    rng = np.random.RandomState(7)

    def walk(node):
        if isinstance(node, dict):
            return {k: (rng.normal(0.0, 0.05, tuple(v.shape))
                        .astype(np.float32) if k in ("bq", "bk", "bv")
                        else walk(v)) for k, v in sorted(node.items())}
        return node.numpy()

    tokens = np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=(BATCH, SEQ + 1))
    return walk(params), {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def step(params_np: dict, batch_np: dict, case: str, mesh=None, *,
         accum: int = 1, steps: int = 1, ckpt: str = "") -> dict:
    """``steps`` steps of ``case`` from the reference's params on the
    global batch: on one rank (``mesh=None``) or on this rank's fsdp +
    tensor-parallel blocks of ``mesh``; given ``ckpt``, the state after
    them saved there (``checkpoint.save_train_state``) and its gathered
    leaves returned under ``saved`` (rank 0's; None elsewhere)."""
    cfg = config()
    model = get_model(cfg)
    optimizer, use_kernel = CASES[case]
    accum = ACCUM.get(case, accum)
    params = convert.params_from_jax(cfg, params_np, device="cpu")
    place = None
    if mesh is not None:
        params = convert.shard_params(cfg, params, mesh, fsdp=True)
        place = convert.placement(cfg, mesh)
    opt = build_optimizer(optimizer, **HYPER, use_kernel=use_kernel,
                          segments=model.segments, device="cpu",
                          placement=place)
    state = TrainState.create(params, opt)
    train = make_train_step(model, opt, mesh=mesh, placement=place,
                            layerwise=True, accum_steps=accum)
    batch = {k: torch.from_numpy(np.asarray(v, np.int64))
             for k, v in batch_np.items()}
    if accum > 1:
        batch = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                 for k, v in batch.items()}
    history = []
    for _ in range(steps):
        state, metrics = train(state, batch)
        history.append({k: _np(metrics[k]) for k in METRICS})
    whole = state.params if place is None \
        else convert.gather_params(state.params, place)
    out = dict(history[-1])
    out["history"] = history
    out["params"] = [_np(x) for x in tree_leaves(
        convert.params_to_jax(cfg, whole))]
    if place is not None:
        out["replicas_equal"] = replicas_equal(state, place,
                                               segments=model.segments)
    if ckpt:
        whole = checkpoint.save_train_state(ckpt, state, cfg=cfg,
                                            mesh=mesh, placement=place,
                                            segments=model.segments)
        out["saved"] = None if whole is None else [
            _np(x) if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in tree_leaves(whole)]
    return out


@contextlib.contextmanager
def fault(name: str):
    """One of :data:`CONTROLS` put into the port for the block."""
    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "bias-unsummed":
        def head_rows(b, heads, partial=False):
            if b.shape[0] == heads:
                return b
            i = L._MESH.coords["model"]
            return b[i * heads:(i + 1) * heads]
        patch(L, "_head_rows", head_rows)
    elif name == "wk-unsummed":
        patch(L, "_partial_use", lambda w, *args: w)
    elif name == "table-unweighted":
        patch(dist_lib.Mesh, "counts_once", lambda self, spec: True)
    elif name == "fsdp-undivided":
        def backward(ctx, g):
            mesh = ctx.mesh
            total = mesh.column_sum_(g.float().contiguous(), "fsdp_reduce")
            mine = total.narrow(ctx.dim, mesh.coords["data"] * ctx.local,
                                ctx.local)
            return mine.to(g.dtype).contiguous(), None, None
        patch(dist_lib._FsdpGather, "backward", staticmethod(backward))
    else:
        raise ValueError(name)
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)


def world(data: int, model: int, params_np: dict, batch_np: dict,
          cases: tuple, controls: tuple = (), ckpt: str = "",
          accum: int = 1, launches: tuple = ()) -> dict:
    """On one rank of a ``(data, model)`` mesh: each case's step (its
    state saved under ``ckpt/{D}x{M}/{case}`` when ``ckpt`` is given),
    then each control's (the tree case under the fault), then
    ``launch.train.run`` on each argv of ``launches`` in this world (its
    losses, world size and rank 0's console lines under
    ``launch/{i}``). Every rank's numbers; rank 0's are the test's."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_host_mesh(data, model)
    out = {"rank": mesh.rank, "coords": dict(mesh.coords)}
    for case in cases:
        mesh.collectives.clear()
        path = f"{ckpt}/{data}x{model}/{case}" if ckpt else ""
        out[case] = step(params_np, batch_np, case, mesh, accum=accum,
                         ckpt=path)
        out[case]["collectives"] = {
            k: v["calls"] for k, v in mesh.collectives.items()}
    for name in controls:
        with fault(name):
            out[name] = step(params_np, batch_np, "tree", mesh)
    for i, argv in enumerate(launches):
        lines: list = []
        got = train_launch.run(argv, log_fn=lines.append)
        out[f"launch/{i}"] = {"losses": got["losses"],
                              "world": got["world"], "lines": lines}
    return out
