"""Shared core of the layer-wise trust-ratio optimizers: the port of
``repro.core.layerwise``.

``lars``, ``tvlars`` and ``lamb`` are instantiations of
:func:`layerwise_transform`, which owns labelling, state and the
dispatch paths:

  * ``use_kernel=False``   — per-segment PyTorch math over the tree
                             (the reference's ``_update_tree``);
  * ``use_kernel="fused"`` — the flat substrate (``core.flatten``): the
                             whole tree packed into ``(rows, 128)``
                             buffers and updated by two segmented
                             kernel launches per step
                             (``kernels.ops.segmented_update``), for
                             every mode: heavy ball, nesterov,
                             trust_clip, TVLARS "paper" momentum, LAMB.
                             ``True`` is an alias.
  * ``use_kernel="per_tensor"`` raises ``NotImplementedError``: its
    TPU kernels (``lars_update.py``) are not ported yet (ROADMAP §2,
    item 7). Nothing falls back to another path.

Both paths compute over the JAX package's SEGMENTS (``core.flatten``):
on an LM tree one segment per stacked group leaf, so the trust ratios,
adapt flags and updates equal the reference's. The tree path's norms
sum the members' Σx² (the reference sums the stacked leaf: the same
terms in another order).

Fused-path memory: the state buffers are updated IN PLACE (the
reference donates its state, so the values are the same), and the
packed params, packed grads and the f32 delta live in work buffers
kept across steps; the updates returned are views into the delta,
valid until the next update. The step's scalars (``base_lr``,
``bc1``, ``bc2`` and the stochastic-rounding seed = the step) are 0-d
tensors on the state's device: a step reads nothing back.

Precision (fused only): ``"f32"``, ``"bf16_master"`` (bf16 working
params / grads / state, f32 norms, table and delta) and
``"bf16_master_sr"`` (stochastic rounding on the state write-back).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch

from repro_torch import device as _device
from repro_torch.core import flatten
from repro_torch.core.base import (GradientTransform, sum_of_squares,
                                   tree_from_paths, tree_get, tree_leaves,
                                   tree_map)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.obs import layerwise as obs_layerwise

UseKernel = Union[bool, str]

KERNEL_CHOICES = (False, "per_tensor", "fused")

PRECISIONS = ("f32", "bf16_master", "bf16_master_sr")

PER_TENSOR_NOT_PORTED = (
    "use_kernel='per_tensor' runs the TPU kernels of "
    "src/repro/kernels/lars_update.py (_norm2_kernel, _apply_kernel), "
    "which are not ported yet: ROADMAP.md §2 item 7. Use "
    "use_kernel='fused' (it covers the same math) or False")


def storage_dtype(precision: str) -> torch.dtype:
    """The flat substrate's storage dtype under ``precision``."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision={precision!r}; expected one of {PRECISIONS}")
    return torch.float32 if precision == "f32" else torch.bfloat16


def _validate_precision(precision: str, use_kernel: UseKernel,
                        optimizer: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(
            f"{optimizer}: precision={precision!r}; expected one of "
            f"{PRECISIONS}")
    if precision != "f32" and use_kernel != "fused":
        raise ValueError(
            f"{optimizer}: precision={precision!r} requires "
            f"use_kernel='fused' — only the flat substrate has a "
            f"storage-dtype axis (got use_kernel={use_kernel!r})")


def normalize_use_kernel(use_kernel: UseKernel) -> UseKernel:
    """Map the public flag onto ``False | "per_tensor" | "fused"``."""
    if use_kernel is True:
        return "fused"
    if use_kernel in (False, None):
        return False
    if use_kernel not in ("per_tensor", "fused"):
        raise ValueError(
            f"use_kernel={use_kernel!r}; expected one of "
            f"{(False, True) + KERNEL_CHOICES[1:]}")
    return use_kernel


def layerwise_transform(base_lr_fn: Callable, *,
                        mode: str,
                        state_cls: Any,
                        eta: float = 1e-3,
                        momentum: float = 0.9,
                        weight_decay: float = 5e-4,
                        b1: float = 0.9,
                        b2: float = 0.999,
                        eps: float = 1e-9,
                        nesterov: bool = False,
                        trust_clip: Optional[float] = None,
                        use_kernel: UseKernel = False,
                        precision: str = "f32",
                        optimizer_name: str = "layerwise",
                        segments: Optional[flatten.Segmenter] = None,
                        device="cuda") -> GradientTransform:
    """Build a layer-wise GradientTransform (updates are deltas).

    ``mode``: "lars", "paper" or "lamb". ``state_cls(step, *bufs)`` is
    the optimizer's state NamedTuple; buffers are f32 trees shaped like
    the params (tree path) or flat substrate buffers at the storage
    dtype (fused). ``segments`` groups the tree (default: each leaf;
    LM trees need ``model.segments``). ``device`` is where the fused
    substrate lives: resolved at build time, so asking for CUDA on a
    host without it raises; the tree path runs on the params' device.
    """
    if mode not in ref.MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {ref.MODES}")
    use_kernel = normalize_use_kernel(use_kernel)
    if use_kernel == "per_tensor":
        raise NotImplementedError(f"{optimizer_name}: "
                                  f"{PER_TENSOR_NOT_PORTED}")
    _validate_precision(precision, use_kernel, optimizer_name)
    sdtype = storage_dtype(precision)
    stochastic = precision.endswith("_sr")
    n_bufs = 2 if mode == "lamb" else 1
    fused_device = _device.resolve(device) if use_kernel == "fused" \
        else None
    work: dict = {}     # fused work buffers: (spec, device) -> w, g, delta

    def _spec(params, dtype):
        return flatten.build_spec(params, dtype=dtype, segments=segments)

    def _step_scalars(step):
        base_lr = base_lr_fn(step)
        stepf = (step + 1).to(torch.float32)
        bc1 = 1.0 - b1 ** stepf
        bc2 = 1.0 - b2 ** stepf
        return base_lr, bc1, bc2

    def _check_device(params):
        spec = _spec(params, sdtype)
        dev = tree_get(params, spec.paths[0][0]).device
        if dev != fused_device and not (
                dev.type == fused_device.type == "cuda"
                and fused_device.index is None
                and dev.index == torch.cuda.current_device()):
            raise ValueError(f"{optimizer_name}: fused substrate built "
                             f"for {fused_device}, params lie on {dev}")
        return spec, dev

    def init(params):
        if use_kernel == "fused":
            spec, dev = _check_device(params)
            with torch.no_grad():
                if mode == "paper":
                    bufs = (flatten.pack(params, spec),)
                else:
                    bufs = tuple(
                        torch.zeros((spec.num_rows, flatten.LANES),
                                    dtype=sdtype, device=dev)
                        for _ in range(n_bufs))
        else:
            dev = tree_leaves(params)[0].device
            with torch.no_grad():
                if mode == "paper":
                    bufs = (tree_map(lambda p: p.detach().float().clone(),
                                     params),)
                else:
                    bufs = tuple(tree_map(
                        lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
                        for _ in range(n_bufs))
        return state_cls(torch.zeros((), dtype=torch.int32, device=dev),
                         *bufs)

    # ---- fused path: flat substrate, two kernel launches per step ----

    def _work(spec, dev):
        key = (spec, str(dev))
        if key not in work:
            work.clear()        # one tree at a time: free the old buffers
            shape = (spec.num_rows, flatten.LANES)
            work[key] = (torch.zeros(shape, dtype=sdtype, device=dev),
                         torch.zeros(shape, dtype=sdtype, device=dev),
                         torch.zeros(shape, dtype=torch.float32,
                                     device=dev))
        return work[key]

    def _update_fused(grads, state, params):
        spec, dev = _check_device(params)
        w2d, g2d, delta = _work(spec, dev)
        flatten.pack(params, spec, out=w2d)
        flatten.pack(grads, spec, out=g2d)
        base_lr, bc1, bc2 = _step_scalars(state.step)
        telemetry = obs_layerwise.active()
        out = kops.segmented_update(
            w2d, g2d, tuple(state[1:]), delta=delta,
            seg_ids=spec.segment_ids(dev), adapt_mask=spec.adapt_mask(dev),
            base_lr=base_lr, mode=mode, eta=eta,
            weight_decay=weight_decay, momentum=momentum, b1=b1, b2=b2,
            eps=eps, nesterov=nesterov, trust_clip=trust_clip,
            bc1=bc1, bc2=bc2, stochastic_round=stochastic,
            seed=state.step, telemetry=telemetry)
        if telemetry:
            obs_layerwise.deposit(out[2])
        updates = flatten.unpack(out[1], spec, params)
        return updates, state_cls(state.step + 1, *out[0])

    # ---- tree path: per-segment PyTorch math ----

    def _update_tree(grads, state, params):
        spec = _spec(params, torch.float32)
        base_lr, bc1, bc2 = _step_scalars(state.step)
        telemetry = obs_layerwise.active()
        rows = []
        updates = {}
        new_bufs = [dict() for _ in range(n_bufs)]
        for paths, adapt in zip(spec.paths, spec.adapt):
            ws = [tree_get(params, p).float() for p in paths]
            gs = [tree_get(grads, p).float() for p in paths]
            bs = [tuple(tree_get(state[1 + k], p) for k in range(n_bufs))
                  for p in paths]
            dirs = [ref.direction(mode, w, g, b, b1=b1, b2=b2, bc1=bc1,
                                  bc2=bc2, eps=eps)
                    for w, g, b in zip(ws, gs, bs)]
            bvecs = [d + weight_decay * w if mode == "lamb" else g
                     for (d, _), w, g in zip(dirs, ws, gs)]
            w2 = sum(sum_of_squares(w) for w in ws)
            b2_ = sum(sum_of_squares(b) for b in bvecs)
            adapt_t = torch.as_tensor(adapt, device=w2.device)
            wn, bn, ratio = ref.trust_ratio(
                w2, b2_, adapt_t, mode=mode, eta=eta,
                weight_decay=weight_decay, eps=eps, trust_clip=trust_clip)
            if telemetry:
                rows.append((wn, bn, ratio))
            table = ref.scales_from_ratio(ratio, adapt_t, base_lr,
                                          weight_decay)
            for p, w, (d, bufs2) in zip(paths, ws, dirs):
                scaled = table[0] * d + table[1] * w
                nb, delta = ref.integrate(mode, w, bufs2, scaled,
                                          momentum=momentum,
                                          nesterov=nesterov)
                updates[p] = delta
                for k in range(n_bufs):
                    new_bufs[k][p] = nb[k]
        if telemetry and rows:
            obs_layerwise.deposit({
                "w_norm": torch.stack([r[0] for r in rows]),
                "g_norm": torch.stack([r[1] for r in rows]),
                "trust_ratio": torch.stack([r[2] for r in rows])})
        return (tree_from_paths(params, updates),
                state_cls(state.step + 1,
                          *(tree_from_paths(params, m) for m in new_bufs)))

    def update(grads, state, params=None):
        if params is None:
            raise ValueError(f"{optimizer_name} requires params")
        with torch.no_grad():
            if use_kernel == "fused":
                return _update_fused(grads, state, params)
            return _update_tree(grads, state, params)

    return GradientTransform(init, update)
