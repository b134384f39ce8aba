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
  * ``use_kernel="per_tensor"`` — the tree path, except that every
                             ADAPT segment of 8 or more elements goes
                             through the per-tensor LARS kernels
                             (``kernels.ops.lars_norm2``, then
                             ``lars_apply``): one launch of each per
                             step over all such segments, heavy ball or
                             nesterov only (``_validate_use_kernel``
                             refuses the rest, as the reference does).

Every path computes over the JAX package's SEGMENTS (``core.flatten``):
on an LM tree one segment per stacked group leaf, so the trust ratios,
adapt flags and updates equal the reference's, and the per-tensor path
sends the same leaves to its kernel. The tree path's norms sum the
members' Σx² (the reference sums the stacked leaf: the same terms in
another order).

Every path updates the state buffers IN PLACE (the reference donates
its state, so the values are the same): a run holds one momentum tree,
not two. Fused-path memory besides: the packed params, packed grads
and the f32 delta live in work buffers kept across steps; the updates
returned are views into the delta, valid until the next update. The step's scalars (``base_lr``,
``bc1``, ``bc2`` and the stochastic-rounding seed = the step) are 0-d
tensors on the state's device: a step reads nothing back.

Every path takes all segments' Σw² and Σg² first and applies after:
the fused path in its two launches, the tree and per-tensor paths in a
pass of sums (the kernel segments' one norm launch; a plain segment's
terms kept for its apply) and a pass of applies (the kernel segments'
one apply launch, then the plain segments). Over a mesh (``placement=``,
a ``launch.sharding.Placement``: training over fsdp and the model
axis), each rank holds blocks of the leaves and packs or walks its
blocks: the same segments in the same order on every rank, and the
table of sums is summed over the mesh between the two, in ONE
collective for all segments (``Mesh.sum_blocks_``: each distinct block
counted once, so a segment replicated over the model row is not counted
M times). The launches stay 1 + 1 per rank per step on the fused and on the
per-tensor path, a segment's kernel chosen by the WHOLE segment's size
so every rank enters the same collectives in the same order.

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

# which modes the per-tensor kernel can express, and the smallest
# segment it takes (the reference's ``w.size >= 8``)
_PER_TENSOR_MODES = ("lars",)
PER_TENSOR_MIN_SIZE = 8


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


def _validate_use_kernel(use_kernel: UseKernel, *, mode: str,
                         trust_clip, optimizer: str) -> None:
    if use_kernel != "per_tensor":
        return
    if mode not in _PER_TENSOR_MODES:
        raise ValueError(
            f"{optimizer}: use_kernel='per_tensor' only supports "
            f"heavy-ball LARS math (got mode={mode!r}); use "
            f"use_kernel='fused' which covers it")
    if trust_clip is not None:
        raise ValueError(
            f"{optimizer}: use_kernel='per_tensor' does not support "
            f"trust_clip; use use_kernel='fused'")


def kernel_segments(spec: flatten.FlatSpec, placement=None) -> list:
    """Names of the segments the per-tensor path sends to its kernels:
    ADAPT and at least ``PER_TENSOR_MIN_SIZE`` elements (on an LM tree
    the size of the whole stacked leaf; under a ``placement``, of the
    whole segment, not the rank's block). They share the step's one
    norm and one apply launch."""
    sizes = whole_sizes(spec, placement)
    return [name for name, adapt, size in zip(spec.names, spec.adapt,
                                              sizes)
            if adapt and size >= PER_TENSOR_MIN_SIZE]


def whole_sizes(spec: flatten.FlatSpec, placement=None) -> list:
    """Each segment's element count over the whole leaves (a rank's
    block size times the blocks the placement cuts the leaf into)."""
    if placement is None:
        return list(spec.sizes)
    return [size * placement.parts(paths[0])
            for size, paths in zip(spec.sizes, spec.paths)]


def block_reducer(spec: flatten.FlatSpec, placement) -> Callable:
    """``table -> table``: a ``[..., nseg]`` f32 table of per-segment
    sums over this rank's blocks summed over the placement's mesh, each
    distinct block counted once (``Mesh.sum_blocks_``, in place); the
    identity without a placement."""
    if placement is None:
        return lambda t: t
    counted = torch.tensor([placement.counts_once(paths[0])
                            for paths in spec.paths], dtype=torch.bool)
    return lambda t: placement.mesh.sum_blocks_(t, counted)


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
                        device="cuda", placement=None) -> GradientTransform:
    """Build a layer-wise GradientTransform (updates are deltas).

    ``mode``: "lars", "paper" or "lamb". ``state_cls(step, *bufs)`` is
    the optimizer's state NamedTuple; buffers are f32 trees shaped like
    the params (tree path) or flat substrate buffers at the storage
    dtype (fused). ``segments`` groups the tree (default: each leaf;
    LM trees need ``model.segments``). ``device`` is where a kernel
    path (fused substrate, per-tensor kernels) runs: resolved at build
    time, so asking for CUDA on a host without it raises; the tree path
    runs on the params' device. ``placement``: the params are this
    rank's blocks of a tree placed over a mesh (see the module
    docstring).
    """
    if mode not in ref.MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {ref.MODES}")
    use_kernel = normalize_use_kernel(use_kernel)
    _validate_use_kernel(use_kernel, mode=mode, trust_clip=trust_clip,
                         optimizer=optimizer_name)
    _validate_precision(precision, use_kernel, optimizer_name)
    sdtype = storage_dtype(precision)
    stochastic = precision.endswith("_sr")
    n_bufs = 2 if mode == "lamb" else 1
    kernel_device = _device.resolve(device) if use_kernel else None

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
        if dev != kernel_device and not (
                dev.type == kernel_device.type == "cuda"
                and kernel_device.index is None
                and dev.index == torch.cuda.current_device()):
            raise ValueError(f"{optimizer_name}: {use_kernel} path built "
                             f"for {kernel_device}, params lie on {dev}")
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
            dev = _check_device(params)[1] if use_kernel \
                else tree_leaves(params)[0].device
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

    def _update_fused(grads, state, params):
        # the packed params and grads and the delta live for one update
        # only (the returned updates are views into the delta): between
        # steps the card holds the state alone, which leaves room for an
        # accumulator of K microbatches' gradients and for the probes
        spec, dev = _check_device(params)
        w2d = flatten.pack(params, spec)
        g2d = flatten.pack(grads, spec)
        delta = torch.zeros((spec.num_rows, flatten.LANES),
                            dtype=torch.float32, device=dev)
        base_lr, bc1, bc2 = _step_scalars(state.step)
        telemetry = obs_layerwise.active()
        out = kops.segmented_update(
            w2d, g2d, tuple(state[1:]), delta=delta,
            seg_ids=spec.segment_ids(dev), adapt_mask=spec.adapt_mask(dev),
            base_lr=base_lr, mode=mode, eta=eta,
            weight_decay=weight_decay, momentum=momentum, b1=b1, b2=b2,
            eps=eps, nesterov=nesterov, trust_clip=trust_clip,
            bc1=bc1, bc2=bc2, stochastic_round=stochastic,
            seed=state.step, telemetry=telemetry,
            reduce_norms=block_reducer(spec, placement))
        if telemetry:
            obs_layerwise.deposit(out[2])
        updates = flatten.unpack(out[1], spec, params)
        return updates, state_cls(state.step + 1, *out[0])

    # ---- tree path: per-segment PyTorch math, optional per-tensor
    # kernels; state buffers updated in place ----

    def _update_tree(grads, state, params):
        spec = _check_device(params)[0] if use_kernel \
            else _spec(params, torch.float32)
        base_lr, bc1, bc2 = _step_scalars(state.step)
        telemetry = obs_layerwise.active()
        sizes = whole_sizes(spec, placement)

        def members(paths):
            return [tuple(tree_get(state[1 + k], p) for k in range(n_bufs))
                    for p in paths]

        def on_kernel(adapt, size):
            return use_kernel == "per_tensor" and adapt \
                and size >= PER_TENSOR_MIN_SIZE

        def plain_terms(paths, bs):
            ws = [tree_get(params, p).float() for p in paths]
            gs = [tree_get(grads, p).float() for p in paths]
            dirs = [ref.direction(mode, w, g, b, b1=b1, b2=b2, bc1=bc1,
                                  bc2=bc2, eps=eps)
                    for w, g, b in zip(ws, gs, bs)]
            bvecs = [d + weight_decay * w if mode == "lamb" else g
                     for (d, _), w, g in zip(dirs, ws, gs)]
            sums = torch.stack([sum(sum_of_squares(w) for w in ws),
                                sum(sum_of_squares(b) for b in bvecs)])
            return (ws, dirs), sums

        def kernel_members(paths):
            return ([tree_get(params, p).contiguous() for p in paths],
                    [tree_get(grads, p).contiguous() for p in paths])

        # 1. one norm launch over every kernel segment; 2. the plain
        # segments' sums (their terms kept for the apply); 3. the table
        # in the spec's segment order; 4. one collective over the
        # placement's mesh (none on one device); 5. one apply launch
        # over every kernel segment, then the plain applies
        kernel = [on_kernel(adapt, size)
                  for adapt, size in zip(spec.adapt, sizes)]
        kcols = [i for i, k in enumerate(kernel) if k]
        kpass = [kernel_members(spec.paths[i]) for i in kcols]
        ktable = kops.lars_norm2(kpass) if kpass else None
        terms, parts = {}, []
        for i, paths in enumerate(spec.paths):
            if kernel[i]:
                parts.append(ktable[:, len(parts) - len(terms)])  # next col
            else:
                terms[i], sums = plain_terms(paths, members(paths))
                parts.append(sums)
        table = ktable if not terms else torch.stack(parts, dim=1)
        table = block_reducer(spec, placement)(table)
        updates = {}
        if kpass:
            deltas, kstats = kops.lars_apply(
                [(ws, gs, [b[0] for b in members(spec.paths[i])])
                 for (ws, gs), i in zip(kpass, kcols)], table,
                columns=kcols, base_lr=base_lr, eta=eta,
                weight_decay=weight_decay, momentum_mu=momentum,
                eps=eps, nesterov=nesterov, telemetry=telemetry)
            for i, ds in zip(kcols, deltas):
                updates.update(zip(spec.paths[i], ds))
        rows = []
        for s_i, (ws, dirs) in terms.items():
            paths, adapt = spec.paths[s_i], spec.adapt[s_i]
            w2, b2_ = table[0, s_i], table[1, s_i]
            adapt_t = torch.as_tensor(adapt, device=w2.device)
            wn, bn, ratio = ref.trust_ratio(
                w2, b2_, adapt_t, mode=mode, eta=eta,
                weight_decay=weight_decay, eps=eps, trust_clip=trust_clip)
            if telemetry:
                rows.append((s_i, (wn, bn, ratio)))
            table_s = ref.scales_from_ratio(ratio, adapt_t, base_lr,
                                            weight_decay)
            for p, w, b, (d, bufs2) in zip(paths, ws, members(paths),
                                           dirs):
                scaled = table_s[0] * d + table_s[1] * w
                nb, delta = ref.integrate(mode, w, bufs2, scaled,
                                          momentum=momentum,
                                          nesterov=nesterov)
                updates[p] = delta
                for buf, new in zip(b, nb):
                    buf.copy_(new)
        if telemetry and not terms:
            obs_layerwise.deposit({"w_norm": kstats[0], "g_norm": kstats[1],
                                   "trust_ratio": kstats[2]})
        elif telemetry:
            rows += [(i, tuple(kstats[:, j])) for j, i in enumerate(kcols)]
            rows.sort(key=lambda r: r[0])
            obs_layerwise.deposit({
                key: torch.stack([r[1][k] for r in rows])
                for k, key in enumerate(("w_norm", "g_norm",
                                         "trust_ratio"))})
        return (tree_from_paths(params, updates),
                state_cls(state.step + 1, *state[1:]))

    def update(grads, state, params=None):
        if params is None:
            raise ValueError(f"{optimizer_name} requires params")
        with torch.no_grad():
            if use_kernel == "fused":
                return _update_fused(grads, state, params)
            return _update_tree(grads, state, params)

    return GradientTransform(init, update)
