"""Carry a reference parameter tree across to the port.

:func:`classifier_params_from_jax` does it for the classifiers of
``models.cnn`` (MLP and CNN): the same tree, conv weights from the
reference's HWIO to the port's OIHW, nothing else.

The JAX package stacks layers on leading axes. Dense, MoE and vlm LMs:
``{"embed", "groups": {"l{i}_{kind}": [G, ...]}, "final_norm"}`` (MoE
experts inside a layer are stacked too: ``moe/wi`` is [G, E, d, F]; a
vlm group's last layer is ``l{n}_cross``, whose ``gate`` stacks to a
[G] f32 leaf); ssm: ``{"blocks": [L, ...], "embed", "final_norm"}``;
hybrid: ``{"embed", "final_norm", "groups": [G, attn_every, ...],
"shared_attn", "trailing": [L % attn_every, ...]}``; encdec:
``{"decoder": [L, ...], "embed", "enc_norm", "encoder": [L_enc, ...],
"final_norm"}``. :func:`params_from_jax` takes such a tree as numpy
arrays and unstacks it into the port's lists (layer ``g * n + i`` is
``groups["l{i}_{kind}"][g]``; hybrid block ``g * attn_every + i`` is
``groups[g, i]``, then the trailing blocks; encdec's ``encoder`` and
``decoder`` lists are their stacks' members), so both packages compute
the same function. Leaf layouts are shared, so every leaf is a copy of
a numpy leaf or a view of a torch one.
:func:`params_to_jax` is its inverse, which is how an LM's params cross
packages in a checkpoint; :func:`jax_template` is that tree's shapes
and dtypes on the meta device, a restore template that allocates
nothing.

:func:`segment_paths` is the same mapping for the optimizer: the
reference's leaves in its flatten order, each naming the port tensors
it stacks (``groups/l{i}_{kind}/...`` <- layers ``i, n + i, 2n + i,
...``), so the fused substrate packs, norms and scales exactly the
reference's segments.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.base import (path_name, tree_flatten_with_path,
                                   tree_from_paths, tree_get)
from repro_torch.core.base import tree_map
from repro_torch.core.flatten import Segment
from repro_torch.launch import sharding
from repro_torch.models import layers as L
from repro_torch.models.hybrid import hybrid_layout
from repro_torch.models.transformer import _group_spec, check_model_axis


def _tensor(x, dev: torch.device) -> torch.Tensor:
    # torch leaves (a restore's own tree) are used in place on their
    # device, so a restore never holds the params twice. A numpy leaf is
    # always copied: the port's optimizers update params in place, and
    # a tensor sharing the caller's array would write the step into it
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    a = np.array(x, order="C")
    if a.dtype.name == "bfloat16":     # ml_dtypes bf16: reinterpret bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(dev)
    return torch.from_numpy(a).to(dev)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(tree: dict, index, dev: torch.device) -> dict:
    """One member of a stacked subtree: every leaf indexed by
    ``index`` (an int or a tuple) and copied onto ``dev``."""
    return _map(tree, lambda x: _tensor(x[index], dev))


def _stack(members: list, dev, lead: tuple) -> dict:
    """The stacked subtree of ``members`` (equal trees), each leaf
    ``torch.stack``-ed on ``dev`` and shaped ``lead + member shape``."""
    paths = [p for p, _ in tree_flatten_with_path(members[0])]
    return tree_from_paths(members[0], {
        p: torch.stack([tree_get(m, p).detach().to(dev) for m in members])
        .reshape(lead + tuple(tree_get(members[0], p).shape))
        for p in paths})


def _top(params: dict, key: str, dev) -> dict:
    return _map(params[key], lambda x: x.detach().to(dev))


# encdec: stacked list -> the config field holding its length
_ENCDEC_STACKS = {"decoder": "num_layers", "encoder": "encoder_layers"}


def params_from_jax(cfg: ModelConfig, tree: dict, *,
                    device="cuda") -> dict:
    """Reference params (numpy leaves) -> the port's params on
    ``device``: the stacked layer / block axes unstacked into the
    port's lists (``layers``, or ``blocks`` for ssm and hybrid). Numpy
    leaves are copied; torch leaves already on ``device`` are used in
    place (views of the stacked tensors), for the restore paths that
    hand over their tree."""
    dev = _device.resolve(device)
    out = {"embed": _map(tree["embed"], lambda x: _tensor(x, dev)),
           "final_norm": _map(tree["final_norm"],
                              lambda x: _tensor(x, dev))}
    if cfg.family == "ssm":
        out["blocks"] = [_unstack(tree["blocks"], j, dev)
                         for j in range(cfg.num_layers)]
        return out
    if cfg.family == "encdec":
        for key, n in _ENCDEC_STACKS.items():
            out[key] = [_unstack(tree[key], j, dev)
                        for j in range(getattr(cfg, n))]
        out["enc_norm"] = _map(tree["enc_norm"], lambda x: _tensor(x, dev))
        return out
    if cfg.family == "hybrid":
        groups, rem = hybrid_layout(cfg)
        out["blocks"] = [_unstack(tree["groups"], (g, i), dev)
                         for g in range(groups)
                         for i in range(cfg.attn_every)] \
            + [_unstack(tree["trailing"], r, dev) for r in range(rem)]
        out["shared_attn"] = _map(tree["shared_attn"],
                                  lambda x: _tensor(x, dev))
        return out
    groups, kinds = _group_spec(cfg)
    stacked = tree["groups"]
    names = [f"l{i}_{kind}" for i, kind in enumerate(kinds)]
    if set(stacked) != set(names):
        raise ValueError(f"group layer names {sorted(stacked)} do not "
                         f"match this config's {names}")
    out["layers"] = [_unstack(stacked[name], g, dev)
                     for g in range(groups) for name in names]
    return out


def params_to_jax(cfg: ModelConfig, params: dict, *,
                  device="cpu") -> dict:
    """The port's params -> the reference's tree, each leaf a tensor on
    ``device`` (numpy has no bfloat16 without ``ml_dtypes``, so the
    leaves stay tensors; ``checkpoint.save`` byte-views them as the
    reference does). The inverse of :func:`params_from_jax`: dense and
    moe restack ``layers[g * n + i]`` into ``groups["l{i}_{kind}"][g]``;
    ssm stacks ``blocks`` [L, ...]; hybrid stacks its groups' blocks
    [G, attn_every, ...] and its trailing ones [L % attn_every, ...];
    encdec stacks ``encoder`` and ``decoder``."""
    dev = device if str(device) == "meta" else _device.resolve(device)
    out = {"embed": _top(params, "embed", dev),
           "final_norm": _top(params, "final_norm", dev)}
    if cfg.family == "encdec":
        for key, n in _ENCDEC_STACKS.items():
            count = getattr(cfg, n)
            if len(params[key]) != count:
                raise ValueError(f"{len(params[key])} {key} layers, "
                                 f"config says {count}")
            out[key] = _stack(params[key], dev, (count,))
        out["enc_norm"] = _top(params, "enc_norm", dev)
        return out
    if cfg.family in ("ssm", "hybrid"):
        blocks = params["blocks"]
        if len(blocks) != cfg.num_layers:
            raise ValueError(f"{len(blocks)} blocks, config says "
                             f"{cfg.num_layers}")
        if cfg.family == "ssm":
            out["blocks"] = _stack(blocks, dev, (cfg.num_layers,))
            return out
        groups, rem = hybrid_layout(cfg)
        n = cfg.attn_every
        out["groups"] = _stack(blocks[:groups * n], dev, (groups, n))
        out["shared_attn"] = _top(params, "shared_attn", dev)
        if rem:
            out["trailing"] = _stack(blocks[groups * n:], dev, (rem,))
        return out
    groups, kinds = _group_spec(cfg)
    n = len(kinds)
    layers = params["layers"]
    if len(layers) != groups * n:
        raise ValueError(f"{len(layers)} layers, config says "
                         f"{groups * n}")
    out["groups"] = {
        f"l{i}_{kind}": _stack([layers[g * n + i] for g in range(groups)],
                               dev, (groups,))
        for i, kind in enumerate(kinds)}
    return out


def jax_template(cfg: ModelConfig) -> dict:
    """The reference's param tree for ``cfg`` as meta tensors (shapes
    and dtypes, no storage): the template ``checkpoint.restore`` checks
    an LM checkpoint against."""
    # imported here: the registry imports this module
    from repro_torch.models.registry import FAMILIES
    meta = torch.device("meta")
    init = FAMILIES[cfg.family][0]
    return params_to_jax(cfg, init(cfg, torch.Generator(), meta),
                         device=meta)


def _block(leaf: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``leaf`` under ``spec``: a copy when the spec
    splits it (so the whole leaf can be freed), else ``leaf``."""
    if not spec.axes():
        return leaf
    return leaf[sharding.local_block(spec, mesh, leaf.shape)].clone()


def _local_meta(params: dict, mesh) -> dict:
    """Meta tensors of the shapes this rank's blocks of ``params`` have
    over the model axis (the tensor-parallel blocks, without fsdp)."""
    return tree_from_paths(params, {
        path: torch.empty(leaf[sharding.local_block(
            sharding.leaf_pspec(path, leaf, mesh), mesh, leaf.shape)].shape,
            device="meta")
        for path, leaf in tree_flatten_with_path(params)})


def shard_params(cfg: ModelConfig, params: dict, mesh, *,
                 fsdp: bool = False) -> dict:
    """This rank's blocks of the port's whole ``params`` under
    :func:`placement` (``fsdp=fsdp``), the reference's placement of its
    stacked tree: a leaf the rules split keeps the block at the rank's
    coordinates (a copy), every other leaf stays whole.
    ``params_from_jax`` then ``shard_params`` gives each rank the
    reference's params as the reference places them (``fsdp=True``:
    its training placement, also split over the data axis). Refuses
    what ``transformer.check_model_axis`` refuses."""
    check_model_axis(cfg, _local_meta(params, mesh), mesh)
    place = placement(cfg, mesh, fsdp=fsdp)
    return tree_from_paths(params, {
        path: _block(leaf, place.spec(path), mesh)
        for path, leaf in tree_flatten_with_path(params)})


def init_sharded(cfg: ModelConfig, init, gen: torch.Generator,
                 dev: torch.device, mesh, *, fsdp: bool = False) -> dict:
    """``init(cfg, gen, dev)`` keeping this rank's block of each leaf as
    it is drawn: every leaf is drawn whole from ``gen`` in ``init``'s
    order (so a rank's weights are the whole draw's blocks) and its
    block (:func:`placement`'s) copied out before the next draw, so the
    peak is the rank's blocks plus the largest leaf. A first pass on
    the meta device (which draws nothing) names each draw's path. A
    leaf made without a draw (a zero bias such as mamba's ``conv_b``)
    keeps its block after the init. ``fsdp=True``: the training
    placement (blocks over the data axis too)."""
    drawn: list = []
    with L.on_draw(lambda x: drawn.append(x) or x):
        meta = init(cfg, torch.Generator(), torch.device("meta"))
    check_model_axis(cfg, _local_meta(meta, mesh), mesh)
    where = {id(leaf): path for path, leaf in tree_flatten_with_path(meta)}
    paths = iter([where[id(x)] for x in drawn])
    place = _placement(cfg, meta, mesh, fsdp)
    del meta, drawn, where
    with L.on_draw(lambda x: _block(x, place.spec(next(paths)), mesh)):
        params = init(cfg, gen, dev)
    return tree_from_paths(params, {
        path: _block(leaf, place.spec(path), mesh)
        if tuple(leaf.shape) == place.whole[path] else leaf
        for path, leaf in tree_flatten_with_path(params)})


def stacked_dims(cfg: ModelConfig, tree: dict) -> dict:
    """``{path: dims}`` for every leaf of the port's ``tree`` (whole
    leaves, or meta tensors of their shapes): the dims the reference's
    leaf that stacks it has in front of its own (``(L,)`` for an ssm
    block, ``(G, attn_every)`` for a hybrid group's, ``(G,)`` for a
    dense, moe or vlm layer kind, ``()`` for an unstacked leaf)."""
    ref = {path_name(p): tuple(x.shape) for p, x in
           tree_flatten_with_path(params_to_jax(cfg, tree, device="meta"))}
    out = {}
    for seg in segment_paths(cfg, tree):
        shape = ref[seg.name]
        for path in seg.paths:
            out[path] = shape[:len(shape) - tree_get(tree, path).dim()]
    return out


def _placement(cfg: ModelConfig, meta: dict, mesh, fsdp: bool
               ) -> sharding.Placement:
    return sharding.Placement(
        mesh, {path: tuple(leaf.shape)
               for path, leaf in tree_flatten_with_path(meta)}, fsdp=fsdp,
        stacked=stacked_dims(cfg, meta))


def placement(cfg: ModelConfig, mesh, *, fsdp: bool = True
              ) -> sharding.Placement:
    """The :class:`launch.sharding.Placement` of ``cfg``'s port tree on
    ``mesh`` (whole shapes from an init on the meta device): each leaf
    placed as the reference places the stacked leaf it is a member of,
    the stacked dims dropped (:func:`stacked_dims`)."""
    from repro_torch.models.registry import FAMILIES
    meta = FAMILIES[cfg.family][0](cfg, torch.Generator(),
                                   torch.device("meta"))
    return _placement(cfg, meta, mesh, fsdp)


def gather_params(tree, place: sharding.Placement, *,
                  dst: Optional[int] = None):
    """The whole tree of which this rank holds ``tree``'s blocks under
    ``place`` (a tree shaped like the params: the params themselves, or
    a tree-path optimizer buffer): on every rank of the mesh, or with
    ``dst`` on that rank only (None elsewhere). One collective per split
    leaf (``Mesh.gather_whole``), every rank taking part in the same
    order. The inverse of :func:`shard_params`; the tests and
    ``checkpoint.save_train_state`` read it."""
    mesh = place.mesh
    out = {path: mesh.gather_whole(leaf.detach().contiguous(),
                                   place.spec(path), place.whole[path],
                                   dst=dst)
           for path, leaf in tree_flatten_with_path(tree)}
    if dst is not None and mesh.rank != dst:
        return None
    return tree_from_paths(tree, out)


def _leaf_segments(params: dict, top: str) -> list[Segment]:
    """One unstacked segment per leaf of ``params[top]``."""
    return [Segment(path_name(path), (path,), False)
            for path, _ in tree_flatten_with_path(params[top], (top,))]


def segment_paths(cfg: ModelConfig, params: dict) -> list[Segment]:
    """The reference LM tree's leaves, in its flatten order (sorted dict
    keys), as segments of the port's tree. A stacked leaf is one
    segment over all its layers or blocks (F3):

    * dense / moe: ``embed``, ``final_norm``, then
      ``groups/l{i}_{kind}/<path>`` stacking ``layers[g * n + i]<path>``
      for g = 0..G-1;
    * ssm: ``blocks/<path>`` stacking all L blocks, then ``embed`` and
      ``final_norm``;
    * hybrid: ``embed``, ``final_norm``, ``groups/<path>`` stacking
      blocks 0..G·n-1 (the reference's [G, n, ...] raveled g-major),
      ``shared_attn`` unstacked, ``trailing/<path>`` stacking the rest;
    * encdec: ``decoder/<path>`` stacking the decoder layers, ``embed``,
      ``enc_norm``, ``encoder/<path>`` stacking the encoder layers,
      ``final_norm``.

    Inside a block, keys sort as the reference's: ``mamba/D`` before
    ``mamba/a_log``."""
    def stacked(name: tuple, top: str, index: range) -> list[Segment]:
        # one segment per leaf path of a member: that path of
        # params[top][j] for every j of the stack, in order
        return [Segment(path_name(name + path),
                        tuple((top, j) + path for j in index), True)
                for path, _ in tree_flatten_with_path(params[top][index[0]])]

    if cfg.family == "encdec":
        for key, n in _ENCDEC_STACKS.items():
            if len(params[key]) != getattr(cfg, n):
                raise ValueError(f"{len(params[key])} {key} layers, "
                                 f"config says {getattr(cfg, n)}")
        return stacked(("decoder",), "decoder", range(cfg.num_layers)) \
            + _leaf_segments(params, "embed") \
            + _leaf_segments(params, "enc_norm") \
            + stacked(("encoder",), "encoder", range(cfg.encoder_layers)) \
            + _leaf_segments(params, "final_norm")
    if cfg.family in ("ssm", "hybrid"):
        if len(params["blocks"]) != cfg.num_layers:
            raise ValueError(f"{len(params['blocks'])} blocks, config "
                             f"says {cfg.num_layers}")
        if cfg.family == "ssm":
            return stacked(("blocks",), "blocks", range(cfg.num_layers)) \
                + _leaf_segments(params, "embed") \
                + _leaf_segments(params, "final_norm")
        groups, rem = hybrid_layout(cfg)
        split = groups * cfg.attn_every
        out = _leaf_segments(params, "embed") \
            + _leaf_segments(params, "final_norm") \
            + stacked(("groups",), "blocks", range(split)) \
            + _leaf_segments(params, "shared_attn")
        if rem:
            out += stacked(("trailing",), "blocks",
                           range(split, cfg.num_layers))
        return out
    groups, kinds = _group_spec(cfg)
    n = len(kinds)
    if len(params["layers"]) != groups * n:
        raise ValueError(f"{len(params['layers'])} layers, config says "
                         f"{groups * n}")
    out = _leaf_segments(params, "embed") \
        + _leaf_segments(params, "final_norm")
    for name, i in sorted((f"l{i}_{kind}", i)
                          for i, kind in enumerate(kinds)):
        out += stacked(("groups", name), "layers",
                       range(i, groups * n, n))
    return out


def jax_segments(cfg: ModelConfig, params: dict
                 ) -> list[tuple[str, list[torch.Tensor]]]:
    """``[(reference leaf name, [member tensors in group order])]`` in
    the reference's flatten order (see :func:`segment_paths`)."""
    return [(seg.name, [tree_get(params, p) for p in seg.paths])
            for seg in segment_paths(cfg, params)]


def classifier_params_from_jax(tree, *, device="cuda"):
    """A reference classifier tree (numpy leaves; dicts and lists) ->
    the port's on ``device``: 4-D (HWIO conv) leaves transposed to
    OIHW, every other leaf copied."""
    dev = _device.resolve(device)

    def leaf(x):
        t = _tensor(x, dev)
        return t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return leaf(node)

    return walk(tree)
