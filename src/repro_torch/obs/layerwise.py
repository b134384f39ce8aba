"""Layer-wise trust-ratio telemetry tap: the port of
``repro.obs.layerwise`` (``capture`` / ``deposit`` / ``active``, the
record shaping ``split_record`` / ``expand``).

The fused step already computes the per-segment ``(w_norm, g_norm,
trust_ratio)`` triple between its two launches; the tree path computes
it per segment. ``make_train_step(..., layerwise=True)`` wraps the
optimizer update in :func:`capture`, the layer-wise transforms
:func:`deposit` the triple, and the step adds it to its metrics under
``layerwise/{metric}`` (each a ``(nseg,)`` f32 tensor): no extra
launch, no read-back.
"""
from __future__ import annotations

import threading
from typing import Any, Optional, Sequence

PREFIX = "layerwise/"

_TAP = threading.local()


class _Capture:
    """Context manager exposing the deposited telemetry as a dict."""

    def __init__(self):
        self.telemetry: dict[str, Any] = {}

    def __enter__(self) -> dict[str, Any]:
        stack = getattr(_TAP, "stack", None)
        if stack is None:
            stack = _TAP.stack = []
        stack.append(self.telemetry)
        return self.telemetry

    def __exit__(self, *exc) -> None:
        _TAP.stack.pop()


def capture() -> _Capture:
    """Activate the tap for the enclosed code; :func:`deposit` lands in
    the innermost active capture of this thread."""
    return _Capture()


def active() -> bool:
    """True when a :func:`capture` is active on this thread."""
    return bool(getattr(_TAP, "stack", None))


def deposit(telemetry: dict[str, Any]) -> None:
    """Hand the per-segment telemetry to the innermost capture (no-op
    when none is active)."""
    stack = getattr(_TAP, "stack", None)
    if stack:
        stack[-1].update(telemetry)


def split_record(host: dict) -> tuple[dict, dict]:
    """Split a metrics dict into (non-layerwise, layerwise) parts."""
    lw = {k: host[k] for k in host if k.startswith(PREFIX)}
    rest = {k: v for k, v in host.items() if k not in lw}
    return rest, lw


def expand(layerwise: dict, names: Optional[Sequence[str]]) -> dict:
    """``{"layerwise/w_norm": (nseg,) values, ...}`` ->
    ``{"layerwise/{segment}/w_norm": float, ...}``; raises when the
    name list's length disagrees with the arrays."""
    if names is None:
        return dict(layerwise)
    out: dict[str, Any] = {}
    for key, arr in layerwise.items():
        metric = key[len(PREFIX):]
        vals = [float(v) for v in arr]
        if len(vals) != len(names):
            raise ValueError(
                f"layerwise telemetry {key!r} has {len(vals)} segments "
                f"but {len(names)} segment names were provided")
        for name, v in zip(names, vals):
            out[f"{PREFIX}{name}/{metric}"] = v
    return out
