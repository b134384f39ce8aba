"""repro_torch.core — the layer-wise large-batch optimizers (the paper),
ported from ``repro.core``.

    build_optimizer        factory by name ("tvlars", "wa-lars", ...)
    lars / lamb / tvlars / sgd   explicit constructors
    apply_updates / chain / GradientTransform   transform plumbing
    schedules              warm-up + cosine, polynomial, tvlars_phi
    layerwise_transform    shared trust-ratio core (tree, per-tensor and
                           fused paths)
    NormRecorder           LWN / LGN / LNR history (Fig. 2)
    flatten                the flat substrate of the fused path
"""
from repro_torch.core.api import OPTIMIZERS, build_optimizer
from repro_torch.core.base import (GradientTransform, apply_updates, chain,
                                   global_norm)
from repro_torch.core.instrumentation import (LayerNorms, NormRecorder,
                                              layer_norms)
from repro_torch.core.lamb import lamb
from repro_torch.core.lars import lars
from repro_torch.core.layerwise import layerwise_transform
from repro_torch.core.sgd import sgd
from repro_torch.core.tvlars import tvlars
from repro_torch.core import flatten, labels, schedules

__all__ = [
    "OPTIMIZERS", "build_optimizer", "GradientTransform", "apply_updates",
    "chain", "global_norm", "LayerNorms", "NormRecorder", "layer_norms",
    "lamb", "lars", "layerwise_transform", "sgd", "tvlars", "flatten",
    "labels", "schedules",
]
