"""Carry a reference parameter tree across to the port.

The JAX package stacks each layer kind of a group on a leading group
axis: ``{"embed", "groups": {"l{i}_{kind}": [G, ...]}, "final_norm"}``.
:func:`params_from_jax` takes that tree as numpy arrays and unstacks
the group axis into the port's per-layer list (layer ``g * n + i`` is
``groups["l{i}_{kind}"][g]``), so both packages compute the same
function. Leaf layouts are shared, so every leaf is a copy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
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
