"""The port's side of ``test_torch_vocab_head.py`` (not collected):
functions that run on the ranks of one gloo world on the CPU
(``launch.mesh.spawn``), the per-rank-rounding control, and the
single-rank Hessian-vector product the world's is held against.

The vocabulary-parallel head (``training.losses._chunk_ce_vocab_parallel``)
gives each rank the logits of its ``V/M`` columns; the gradient of the
hidden state is the row's sum of each rank's partial ``g @ wᵀ``. The
port forms each partial in f32 and rounds the sum once. The control,
:func:`parent_chunk_ce`, is the head before that: each partial a bf16
product, rounded on its rank before the row sums it.

Imports torch, numpy and ``repro_torch`` only (a spawned rank imports
this module afresh); every function returns numpy.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_smoke_config
from repro_torch.core import flatten
from repro_torch.core.base import (tree_flatten_with_path, tree_from_paths,
                                   tree_leaves)
from repro_torch.diagnostics import hvp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import convert, get_model
from repro_torch.models import layers as L
from repro_torch.training import lm_task, losses

BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
# the head's inputs: B x S positions of D wide against V words; S = 512
# is two of the head's 256-position chunks, each a strided slice of h.
# N = B x 256 rows a chunk, D and V / M all differ, so a product's
# output shape says which product it is
HEAD = dict(B=2, S=512, D=48, V=384)
HEAD_MESHES = ((1, 2), (1, 4))
# the Hessian-vector product's model: the dense smoke LM (2 layers),
# B x S tokens
HVP_ARCH, HVP_B, HVP_S = "qwen2.5-3b", 4, 32


def parent_chunk_ce(h_blk, unembed_w, y_blk, mesh):
    """``losses._chunk_ce_vocab_parallel`` before the head summed f32
    partials: the logits through ``copy_to_row(h_blk) @ unembed_w``,
    whose backward forms each rank's partial of ``h_blk``'s gradient as
    a product in ``h_blk``'s dtype (rounded on the rank) before
    ``copy_to_row`` sums the row's partials in f32 and rounds again."""
    from repro_torch.distributed import copy_to_row, sum_over_row
    logits = (copy_to_row(h_blk, mesh) @ unembed_w).float()
    local = logits.shape[-1]
    m = mesh.row_max_(logits.detach().amax(dim=-1))
    sumexp = sum_over_row(torch.exp(logits - m[..., None]).sum(dim=-1),
                          mesh)
    loc = y_blk.long() - mesh.coords["model"] * local
    mine = (loc >= 0) & (loc < local)
    gold = torch.gather(logits, -1,
                        torch.where(mine, loc, 0)[..., None])[..., 0]
    gold = sum_over_row(torch.where(mine, gold, torch.zeros_like(gold)),
                        mesh)
    return torch.sum(torch.log(sumexp) + m - gold)


@contextlib.contextmanager
def per_rank_rounding():
    """:func:`parent_chunk_ce` as the port's head inside the block."""
    real = losses._chunk_ce_vocab_parallel
    losses._chunk_ce_vocab_parallel = parent_chunk_ce
    try:
        yield
    finally:
        losses._chunk_ce_vocab_parallel = real


@contextlib.contextmanager
def first_order_head():
    """The port's head with a backward that autograd does not
    differentiate: the gradient of ``h`` comes out right, but a
    Hessian-vector product loses what passes through it."""
    cls = losses._VocabParallelHead
    real = cls.backward

    def backward(ctx, g):
        with torch.no_grad():
            return real(ctx, g)
    cls.backward = staticmethod(backward)
    try:
        yield
    finally:
        cls.backward = staticmethod(real)


class Products(TorchDispatchMode):
    """Inside the block, every matrix product (``aten.mm``, any
    overload) as ``(a, b, output shape)``, the operands copied to f32
    (which holds bf16 values exactly)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket is torch.ops.aten.mm:
            self.calls.append((args[0].detach().float().clone(),
                               args[1].detach().float().clone(),
                               tuple(out.shape)))
        return out


def head_inputs(seed: int = 0) -> dict:
    """The head's seeded inputs as numpy: ``h`` [B, S, D] and the table
    [V, D] (the head is its transpose) at values of bf16, labels [B,
    S]."""
    rng = np.random.default_rng(seed)
    b, s, d, v = (HEAD[k] for k in ("B", "S", "D", "V"))
    bf = lambda x: torch.from_numpy(x.astype(np.float32)).to(  # noqa: E731
        torch.bfloat16).float().numpy()
    return {"h": bf(rng.standard_normal((b, s, d))),
            "table": bf(rng.standard_normal((v, d)) / np.sqrt(d)),
            "labels": rng.integers(0, v, (b, s))}


def head_grads(inputs: dict, mesh, tied: bool, control: bool) -> dict:
    """``fused_ce_from_hidden`` on this rank's ``V/M`` columns of the
    head, in bf16, and its backward: the loss, ``h``'s gradient, the
    gradient of the rank's block of the table (``tied``: the head is
    the block's transpose, a column-major operand) or of the head
    ``[D, V/M]``, and for each chunk the operands of the product that
    formed this rank's partial of ``h``'s gradient (the logits'
    gradient ``g`` and ``wᵀ``), found by the forward product recomputed
    just before it (the chunk's ``h`` rows)."""
    v, n = HEAD["V"], HEAD["B"] * losses.CE_CHUNK
    local = v // mesh.model
    cols = slice(mesh.coords["model"] * local,
                 (mesh.coords["model"] + 1) * local)
    h = torch.from_numpy(inputs["h"]).to(torch.bfloat16).requires_grad_()
    table = torch.from_numpy(inputs["table"]).to(torch.bfloat16)
    if tied:
        leaf = table[cols].clone().requires_grad_()
        w = leaf.T
    else:
        leaf = table[cols].T.contiguous().requires_grad_()
        w = leaf
    labels = torch.from_numpy(inputs["labels"])
    with Products() as rec, (per_rank_rounding() if control
                             else contextlib.nullcontext()):
        loss = losses.fused_ce_from_hidden(h, w, labels, mesh=mesh,
                                           vocab=v)
        loss.backward()
    chunks = [h.detach()[:, i:i + losses.CE_CHUNK].reshape(n, -1).float()
              for i in range(0, HEAD["S"], losses.CE_CHUNK)]
    partials, last = [], None
    for a, b, shape in rec.calls:
        if shape == (n, local) and a.shape == (n, HEAD["D"]):
            last = next(i for i, c in enumerate(chunks) if torch.equal(a, c))
        elif shape == (n, HEAD["D"]) and a.shape == (n, local):
            partials.append((last, a.numpy(), b.numpy()))
    return {"loss": loss.detach().numpy(),
            "h_grad": h.grad.float().numpy(),
            "w_grad": leaf.grad.float().numpy(),
            "partials": partials}


def hvp_inputs(bf16: bool, seed: int = 0) -> tuple:
    """The smoke LM's config, seed-0 params, a seeded batch and a seeded
    tangent, whole."""
    cfg = get_smoke_config(HVP_ARCH)
    if bf16:
        cfg = cfg.replace(**BF16)
    params = get_model(cfg).init(0, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (HVP_B, HVP_S + 1),
                           generator=gen)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    tangent = {p: torch.randn(t.shape, generator=gen).to(t.dtype)
               for p, t in tree_flatten_with_path(params)}
    return cfg, params, batch, tangent


def hvp_whole(bf16: bool, mesh=None, seq: bool = False) -> list:
    """H @ v of the smoke LM's mean CE at its seed-0 params, whole, in
    flatten order (f32 numpy): on one rank (``mesh=None``, the tree
    product), or from this rank's fsdp + tensor-parallel blocks of
    ``mesh`` (``make_flat_hvp(placement=)``, the probes' product),
    gathered, with the sequence over the model axis when ``seq``."""
    cfg, params, batch, tangent = hvp_inputs(bf16)
    task = lm_task(get_model(cfg))
    if mesh is None:
        hv = hvp.tree_hvp(task, params, batch,
                          tree_from_paths(params, tangent))
        return [t.float().numpy() for t in tree_leaves(hv)]
    place = convert.placement(cfg, mesh)
    blocks = convert.shard_params(cfg, params, mesh, fsdp=True)
    vblocks = tree_from_paths(blocks, {p: place.block(p, tangent[p])
                                       for p, _ in
                                       tree_flatten_with_path(blocks)})
    op = hvp.make_flat_hvp(task, blocks, batch, placement=place)
    if seq:
        L.set_batch_sharding(("data",), "model", model_size=mesh.model,
                             mesh=mesh)
    try:
        hv2d = op.matvec(flatten.pack(vblocks, op.spec))
    finally:
        L.set_batch_sharding(None)
    hv = flatten.unpack(hv2d, op.spec, blocks)
    return [t.float().numpy() for t in tree_leaves(
        convert.gather_params(hv, place))]


def world(inputs: dict) -> dict:
    """On one rank of a world of 4: the head's gradients at each of
    :data:`HEAD_MESHES` (the world's first M ranks), tied and untied,
    the port's and the control's; then the bf16 and f32 products of
    :func:`hvp_whole` at ``(1, 2)``, split and with the sequence over
    the model axis, and the bf16 one through :func:`first_order_head`.
    Ranks past a mesh return nothing for it (every rank builds every
    mesh: its groups are made over the world)."""
    meshes = {shape: mesh_lib.make_host_mesh(*shape) for shape in HEAD_MESHES}
    out = {}
    for (_, m), mesh in meshes.items():
        if not mesh.member:
            continue
        for tied in (True, False):
            for control in (False, True):
                out[(m, tied, control)] = head_grads(inputs, mesh, tied,
                                                     control)
    mesh = meshes[(1, 2)]
    if mesh.member:
        for bf16 in (True, False):
            for seq in (False, True):
                out[("hvp", bf16, seq)] = hvp_whole(bf16, mesh, seq)
        with first_order_head():
            out[("hvp-first-order", True, False)] = hvp_whole(True, mesh)
    return out
