"""Parameter-tree labelling: the port of ``repro.core.labels``.

LARS-family reference implementations exclude 1-D parameters (biases,
norm scales) from the trust ratio and weight decay. Every leaf is
tagged ``"adapt"`` (trust-ratio scaled) or ``"plain"``. On an LM tree
the tags follow the JAX package's STACKED leaves, see
:mod:`repro_torch.core.flatten`.
"""
from __future__ import annotations

from repro_torch.core.base import (PyTree, path_name,
                                   tree_flatten_with_path, tree_map)

ADAPT = "adapt"
PLAIN = "plain"


def label_for_ndim(ndim: int) -> str:
    return ADAPT if ndim >= 2 else PLAIN


def default_labels(params: PyTree) -> PyTree:
    """Tag >=2-D leaves ADAPT, 1-D/0-D leaves PLAIN."""
    return tree_map(lambda p: label_for_ndim(p.dim()), params)


def leaf_names(params: PyTree) -> list[str]:
    """'/'-joined key-path name per leaf, in flatten order."""
    return [path_name(path) for path, _ in tree_flatten_with_path(params)]
