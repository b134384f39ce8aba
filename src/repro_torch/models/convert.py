"""Carry a reference parameter tree across to the port.

The JAX package stacks each layer kind of a group on a leading group
axis: ``{"embed", "groups": {"l{i}_{kind}": [G, ...]}, "final_norm"}``.
:func:`params_from_jax` takes that tree as numpy arrays and unstacks
the group axis into the port's per-layer list (layer ``g * n + i`` is
``groups["l{i}_{kind}"][g]``), so both packages compute the same
function. Leaf layouts are shared, so every leaf is a copy.

:func:`segment_paths` is the same mapping for the optimizer: the
reference's leaves in its flatten order, each naming the port tensors
it stacks (``groups/l{i}_{kind}/...`` <- layers ``i, n + i, 2n + i,
...``), so the fused substrate packs, norms and scales exactly the
reference's segments.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.base import (path_name, tree_flatten_with_path,
                                   tree_get)
from repro_torch.core.flatten import Segment
from repro_torch.models.transformer import _group_spec


def _tensor(x, dev: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":     # ml_dtypes bf16: reinterpret bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(cfg: ModelConfig, tree: dict, *,
                    device="cuda") -> dict:
    """Reference params (numpy leaves) -> the port's params on
    ``device``."""
    dev = _device.resolve(device)
    groups, kinds = _group_spec(cfg)
    stacked = tree["groups"]
    names = [f"l{i}_{kind}" for i, kind in enumerate(kinds)]
    if set(stacked) != set(names):
        raise ValueError(f"group layer names {sorted(stacked)} do not "
                         f"match this config's {names}")
    layers = [_map(stacked[name], lambda x, g=g: _tensor(x[g], dev))
              for g in range(groups) for name in names]
    return {"embed": _map(tree["embed"], lambda x: _tensor(x, dev)),
            "layers": layers,
            "final_norm": _map(tree["final_norm"],
                               lambda x: _tensor(x, dev))}


def segment_paths(cfg: ModelConfig, params: dict) -> list[Segment]:
    """The reference LM tree's leaves, in its flatten order (sorted dict
    keys: ``embed`` < ``final_norm`` < ``groups``), as segments of the
    port's tree: a group leaf ``groups/l{i}_{kind}/<path>`` stacks
    ``params["layers"][g * n + i]<path>`` for g = 0..G-1."""
    groups, kinds = _group_spec(cfg)
    n = len(kinds)
    if len(params["layers"]) != groups * n:
        raise ValueError(f"{len(params['layers'])} layers, config says "
                         f"{groups * n}")
    virtual = {"embed": {}, "final_norm": {}, "groups": {}}
    for top in ("embed", "final_norm"):
        for path, _ in tree_flatten_with_path(params[top], (top,)):
            virtual[top][path] = Segment(path_name(path), (path,), False)
    for i, kind in enumerate(kinds):
        layer = {}
        for path, _ in tree_flatten_with_path(params["layers"][i]):
            members = tuple(("layers", g * n + i) + path
                            for g in range(groups))
            name = path_name(("groups", f"l{i}_{kind}") + path)
            layer[path] = Segment(name, members, True)
        virtual["groups"][f"l{i}_{kind}"] = layer
    out = []
    for top in ("embed", "final_norm"):
        out.extend(virtual[top].values())
    for key in sorted(virtual["groups"]):
        out.extend(virtual["groups"][key].values())
    return out


def jax_segments(cfg: ModelConfig, params: dict
                 ) -> list[tuple[str, list[torch.Tensor]]]:
    """``[(reference leaf name, [member tensors in group order])]`` in
    the reference's flatten order (see :func:`segment_paths`)."""
    return [(seg.name, [tree_get(params, p) for p in seg.paths])
            for seg in segment_paths(cfg, params)]
