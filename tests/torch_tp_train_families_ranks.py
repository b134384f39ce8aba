"""The port's side of the tests that train the ssm, hybrid, encdec, vlm
and MoE families over the model axis and probe over it
(``test_torch_tp_train_families.py``, ``test_torch_tp_train_cross.py``,
``test_torch_tp_probes.py``): functions that run on every rank of a
gloo world on the CPU (``launch.mesh.spawn``), and the same step or
probe on one rank for the single-rank comparisons.

Not collected, and imports torch, numpy and ``repro_torch`` only (a
spawned rank imports this module afresh). Inputs arrive as numpy trees
in the reference's stacked layout (the reference's own params and
batches). Every function returns numpy: a step's loss, ``grad_norm``,
``load_balance``, the layer-wise ``w_norm`` / ``g_norm`` /
``trust_ratio``, the params after it gathered whole
(``convert.gather_params``) in the reference's leaf order, and whether
the ranks that hold the same block hold the same bits; a probe's
λ_max.

One world serves several meshes: a mesh narrower than the world is its
first ranks (every rank builds it, since its groups are made over the
world), and the ranks past it sit its work out.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

import torch_tp_train_ranks as dense
from repro_torch import checkpoint
from repro_torch import distributed as dist_lib
from repro_torch.configs import get_smoke_config
from repro_torch.core import build_optimizer
from repro_torch.core.base import tree_leaves
from repro_torch.diagnostics import probes
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as train_launch
from repro_torch.models import convert, get_model
from repro_torch.models import layers as L
from repro_torch.training import TrainState, lm_task, make_train_step
from repro_torch.training.train_state import replicas_equal

BATCH, SEQ = 8, 32
HYPER = dict(total_steps=10, learning_rate=1.0)
CASES = {"tree": False, "fused": "fused"}
# as the reference side's (torch_tp_train_families_ref.EDITS)
EDITS = {"mamba2-1.3b": dict(num_layers=6)}
METRICS = ("loss", "grad_norm", "load_balance", "layerwise/w_norm",
           "layerwise/g_norm", "layerwise/trust_ratio")
# each control's fault, the arch it is put into and the metric that
# must show it
CONTROLS = {"ssm-copy-missing": ("mamba2-1.3b", "layerwise/g_norm"),
            "stacked-dim-counted": ("mamba2-1.3b", "layerwise/w_norm"),
            "moe-per-shard": ("olmoe-1b-7b", "load_balance"),
            "first-order-row": ("dense", "lambda_max")}
PROBE_ITERS = 4


def config(arch: str):
    return get_smoke_config(arch).replace(**EDITS.get(arch, {}))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _batch(batch_np: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(
        v, np.float32 if k == "extra_embeds" else np.int64))
        for k, v in batch_np.items()}


def step(arch: str, params_np: dict, batch_np: dict, case: str,
         mesh=None, *, ckpt: str = "") -> dict:
    """One TVLARS step of ``case`` from the reference's params on the
    global batch: on one rank (``mesh=None``) or on this rank's fsdp +
    tensor-parallel blocks of ``mesh``; given ``ckpt``, the state after
    it saved there (``checkpoint.save_train_state``)."""
    cfg = config(arch)
    model = get_model(cfg)
    params = convert.params_from_jax(cfg, params_np, device="cpu")
    place = None
    if mesh is not None:
        params = convert.shard_params(cfg, params, mesh, fsdp=True)
        place = convert.placement(cfg, mesh)
    opt = build_optimizer("tvlars", **HYPER, use_kernel=CASES[case],
                          segments=model.segments, device="cpu",
                          placement=place)
    state = TrainState.create(params, opt)
    train = make_train_step(model, opt, mesh=mesh, placement=place,
                            layerwise=True)
    state, metrics = train(state, _batch(batch_np))
    out = {k: _np(metrics[k]) for k in METRICS}
    whole = state.params if place is None \
        else convert.gather_params(state.params, place)
    out["params"] = [_np(x) for x in tree_leaves(
        convert.params_to_jax(cfg, whole))]
    if place is not None:
        out["replicas_equal"] = replicas_equal(state, place,
                                               segments=model.segments)
        out["stacked_picks"] = sorted("/".join(map(str, p))
                                      for p in place.stacked_picks)
    if ckpt:
        checkpoint.save_train_state(ckpt, state, cfg=cfg, mesh=mesh,
                                    placement=place,
                                    segments=model.segments)
    return out


def probe(arch: str, params_np: dict, batch_np: dict, mesh=None
          ) -> float:
    """λ_max of a :data:`PROBE_ITERS`-iteration Lanczos probe of
    ``arch`` (``"dense"``: the dense test model,
    ``torch_tp_train_ranks.TRAIN_LM``) on the global batch, from the
    probe's fixed seed: on one rank, or on this rank's fsdp +
    tensor-parallel blocks of ``mesh``."""
    cfg = dense.config() if arch == "dense" else config(arch)
    model = get_model(cfg)
    params = convert.params_from_jax(cfg, params_np, device="cpu")
    place = None
    if mesh is not None:
        params = convert.shard_params(cfg, params, mesh, fsdp=True)
        place = convert.placement(cfg, mesh)
    opt = build_optimizer("tvlars", **HYPER, segments=model.segments,
                          device="cpu", placement=place)
    state = TrainState.create(params, opt)
    p = probes.LanczosProbe(lm_task(model), _batch(batch_np),
                            num_iters=PROBE_ITERS, placement=place)
    return p(0, state)["lambda_max"]


@contextlib.contextmanager
def fault(name: str, cfg=None):
    """One of :data:`CONTROLS` put into the port for the block."""
    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "ssm-copy-missing":
        # the conv's input ([B, S, di + 2N], the only such tensor)
        # reaches the rank's channels without copy_to_row: its gradient
        # is the rank's channels' part only, which the gathered
        # projection's backward then cuts at its own column blocks
        real = dist_lib.copy_to_row

        def copy_to_row(x, mesh):
            if x.shape[-1] == cfg.ssm_d_inner + 2 * cfg.ssm_state:
                return x
            return real(x, mesh)
        patch(dist_lib, "copy_to_row", copy_to_row)
    elif name == "stacked-dim-counted":
        # a leaf whole over the data column because the reference gave
        # the data axis to a stacked dim, counted by every data row
        from repro_torch.launch.sharding import Placement
        real_counts = Placement.counts_once

        def counts_once(self, path):
            if tuple(path) in self.stacked_picks:
                return self.mesh.coords["model"] == 0 \
                    or "model" in self.spec(path).axes()
            return real_counts(self, path)
        patch(Placement, "counts_once", counts_once)
    elif name == "moe-per-shard":
        # each data row's means of its block, averaged as the loss is
        patch(L, "data_column", lambda: None)
    elif name == "first-order-row":
        # the row's backwards as first-order code: copy_to_row's an
        # in-place sum over the row of a tensor autograd sees,
        # sum_over_row's the gradient itself, gather_row's a plain
        # slice (each first-order right, each second order wrong where
        # the product passes it)
        def copy_backward(ctx, g):
            return ctx.mesh.model_sum_(g.contiguous().clone()), None

        def sum_backward(ctx, g):
            return g, None

        def gather_backward(ctx, g):
            return g.narrow(ctx.dim, ctx.mesh.coords["model"] * ctx.local,
                            ctx.local).contiguous(), None, None
        patch(dist_lib._CopyToRow, "backward", staticmethod(copy_backward))
        patch(dist_lib._SumOverRow, "backward", staticmethod(sum_backward))
        patch(dist_lib._GatherRow, "backward",
              staticmethod(gather_backward))
    else:
        raise ValueError(name)
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)


def world(jobs: tuple, ckpt: str = "", launches: tuple = ()) -> dict:
    """On one rank of the world: each job ``(arch, params, batch, (D, M),
    cases, controls)`` on a ``(D, M)`` mesh of the world's first ranks
    (each case's step, its state saved under ``ckpt/{arch}/{D}x{M}/
    {case}`` when given, then each control's tree step under its
    fault; the case ``"probe"``: the probe, and each control's probe);
    then ``launch.train.run`` on each argv of ``launches`` in this
    world (its probe records and rank 0's console lines). Every rank's
    numbers; rank 0's are the test's."""
    torch.set_num_threads(1)
    rank = dist_lib.world().rank
    out: dict = {"rank": rank}
    for arch, params_np, batch_np, (d, m), cases, controls in jobs:
        mesh = mesh_lib.make_host_mesh(d, m)
        key = f"{arch}/{d}x{m}"
        if not mesh.member:
            continue
        got: dict = {}
        if cases == ("probe",):
            got["probe"] = probe(arch, params_np, batch_np, mesh)
            for name in controls:
                with fault(name):
                    got[name] = probe(arch, params_np, batch_np, mesh)
        else:
            for case in cases:
                path = f"{ckpt}/{arch}/{d}x{m}/{case}" \
                    if ckpt and case == "tree" else ""
                got[case] = step(arch, params_np, batch_np, case, mesh,
                                 ckpt=path)
            for name in controls:
                with fault(name, config(arch)):
                    got[name] = step(arch, params_np, batch_np, "tree",
                                     mesh)
        out[key] = got
    for i, argv in enumerate(launches):
        lines: list = []
        res = train_launch.run(argv, log_fn=lines.append)
        out[f"launch/{i}"] = {"probes": res["probes"],
                              "losses": res["losses"], "lines": lines}
    return out
