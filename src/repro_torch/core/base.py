"""Gradient-transformation plumbing and parameter trees: the port of
``repro.core.base``.

A transform is ``GradientTransform(init, update)`` with
``init(params) -> state`` and ``update(grads, state, params) ->
(updates, new_state)``; ``updates`` are deltas applied as ``params +
updates``. Parameter trees are nested dicts, lists and tuples of
tensors. Their leaf order is the JAX package's ``tree_flatten`` order
(sorted dict keys, then sequence index), so a plain tree flattens to
the same leaves in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, NamedTuple, Optional

import torch

PyTree = Any
Path = tuple


def tree_flatten_with_path(tree: PyTree, path: Path = ()
                           ) -> Iterator[tuple[Path, Any]]:
    """``(path, leaf)`` in JAX flatten order; ``None`` is an empty
    subtree, as in JAX."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_flatten_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_flatten_with_path(v, path + (i,))
    elif tree is not None:
        yield path, tree


def tree_leaves(tree: PyTree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over corresponding leaves; the result has ``tree``'s
    structure (NamedTuples included)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else tuple(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_get(tree: PyTree, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def tree_from_paths(template: PyTree, values: dict) -> PyTree:
    """A tree shaped like ``template`` whose leaf at each path is
    ``values[path]``."""
    pairs = iter(tree_flatten_with_path(template))
    by_leaf = {id(leaf): values[path] for path, leaf in pairs}
    return tree_map(lambda leaf: by_leaf[id(leaf)], template)


def path_name(path: Path) -> str:
    """'/'-joined key path (the reference's ``leaf_names`` style)."""
    return "/".join(str(p) for p in path)


class GradientTransform(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, Optional[PyTree]],
                     tuple[PyTree, PyTree]]


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    """``params + updates`` leaf-wise, each update cast to its param's
    dtype first (the reference's rounding)."""
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def chain(*transforms: GradientTransform) -> GradientTransform:
    """Compose transforms left to right."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransform(init, update)


def sum_of_squares(x: torch.Tensor) -> torch.Tensor:
    """Σx² accumulated in f32 whatever x's dtype."""
    x = x.float()
    return torch.sum(x * x)


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of Σ over leaves of Σx², in f32."""
    total = None
    for leaf in tree_leaves(tree):
        s = sum_of_squares(leaf)
        total = s if total is None else total + s
    return torch.sqrt(total)

