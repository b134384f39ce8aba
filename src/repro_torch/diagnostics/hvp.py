"""Hessian-vector products on the flat ``(rows, 128)`` layout: the port
of ``repro.diagnostics.hvp``.

The probes measure the curvature of any
:class:`repro_torch.training.tasks.Task` loss. A probe vector is one
``(num_rows, LANES)`` f32 tensor laid out as ``core.flatten.build_spec``
packs the params: one segment per leaf, or per stacked leaf of the JAX
package for an LM task (``task.segments``), so a numpy vector in the
reference's layout is the same direction here.

The HVP is reverse-over-reverse: the gradient is taken with
``create_graph=True`` and differentiated again against the tangent
(``torch.func`` transforms do not compose with the models'
``torch.utils.checkpoint``). It is taken at the params' own dtype and
on detached aliases of their leaves, so a probe never writes to the
caller's tensors or their ``.grad``.

Under gradient accumulation the probe batch carries the same ``[K,
B/K, ...]`` stacked microbatch axis as training batches. HVPs are
linear in the loss, so the Hessian of the accumulated mean loss is the
mean of the K per-microbatch Hessians: they are summed (in the params'
dtype) and divided by K, which keeps peak memory at one microbatch of
activations whatever K.

Padding: the tangent is read from the segments' ranges only and the
product is packed into a zeroed buffer, so the flat operator is the
tree Hessian embedded in the padded space with an exact null space on
the pad coordinates. Seed Lanczos with a :func:`padding_mask`-projected
vector and every Krylov vector stays in the real-parameter subspace.

Data-parallel probing: every entry point takes ``mesh=`` /
``data_axes=`` (a :class:`repro_torch.distributed.Mesh`). Each rank is
handed the global probe batch, computes on its shard of the microbatch
dim (``pipeline.shard_over_data``) and the per-shard results (f32) are
averaged over the ranks (``Mesh.mean_``), so every rank holds the same
global-batch loss, gradients or Hessian product. Probe vectors are
whole on every rank: Lanczos on top runs unchanged, its Krylov basis
replicated.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Optional

import torch

from repro_torch.core import flatten
from repro_torch.data import pipeline
from repro_torch.core.base import (tree_flatten_with_path, tree_from_paths,
                                   tree_leaves, tree_map)

PyTree = Any

mesh_data_axes = pipeline.resolve_data_axes
mesh_dp_size = pipeline.resolve_dp_size


def _on_mesh(mesh) -> bool:
    """True when a probe runs over ranks (a mesh over a world of more
    than one process); a mesh of one rank is the single-device path."""
    return mesh is not None and mesh.world > 1


def check_stacked(batch: PyTree, accum_steps: int) -> None:
    """Validate the ``[K, B/K, ...]`` microbatch axis — the contract
    shared by the trainer's accumulation loop and every probe."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if accum_steps == 1:
        return
    for leaf in tree_leaves(batch):
        if tuple(leaf.shape[:1]) != (accum_steps,):
            raise ValueError(
                f"accum_steps={accum_steps} but a batch leaf has leading "
                f"dim {tuple(leaf.shape[:1])} (shape {tuple(leaf.shape)}); "
                f"stack microbatches as [K, B/K, ...] — see "
                f"data.synthetic.stack_microbatches")


def microbatches(batch: PyTree, accum_steps: int) -> Iterator[PyTree]:
    """The K microbatches of a stacked batch (the batch itself at K=1)."""
    if accum_steps == 1:
        yield batch
        return
    for k in range(accum_steps):
        yield tree_map(lambda x: x[k], batch)


def grad_aliases(params: PyTree) -> tuple[list, PyTree]:
    """(leaves, tree): detached aliases of the params' leaves (same
    storage) that require grad, in flatten order, and the tree of
    them — differentiating through these leaves the caller's tensors
    and their ``.grad`` alone."""
    pairs = list(tree_flatten_with_path(params))
    leaves = [leaf.detach().requires_grad_(True) for _, leaf in pairs]
    return leaves, tree_from_paths(
        params, {path: a for (path, _), a in zip(pairs, leaves)})


def _f32_loss(task, params: PyTree, batch: PyTree) -> torch.Tensor:
    loss, _ = task.loss_fn(params, batch)
    return loss.float()


def _local_loss(task, params: PyTree, batch: PyTree,
                accum_steps: int) -> torch.Tensor:
    total = None
    with torch.no_grad():
        for mb in microbatches(batch, accum_steps):
            loss = _f32_loss(task, params, mb)
            total = loss if total is None else total + loss
    return total if accum_steps == 1 else total / accum_steps


def scanned_loss(task, params: PyTree, batch: PyTree,
                 accum_steps: int = 1, *, mesh=None,
                 data_axes=None) -> torch.Tensor:
    """Mean task loss over K stacked microbatches (forward only, no
    graph): the accumulated training objective, an f32 0-d tensor.
    ``mesh=``: the microbatch dim is split over the data axes and the
    per-shard means are averaged."""
    check_stacked(batch, accum_steps)
    if not _on_mesh(mesh):
        return _local_loss(task, params, batch, accum_steps)
    axes = mesh_data_axes(mesh, data_axes)

    def local(params, batch):
        loss = _local_loss(task, params, batch, accum_steps)
        mesh.mean_([loss])
        return loss

    return pipeline.shard_over_data(local, mesh, axes,
                                    accum_steps)(params, batch)


def microbatch_grads(task, params: PyTree, batch: PyTree,
                     accum_steps: int) -> Iterator[tuple]:
    """``(f32 loss, grads)`` of each microbatch in turn: the gradients a
    list in flatten order at the params' dtypes, zeros for a leaf the
    loss does not use. One microbatch's activations and gradients live
    at a time."""
    leaves, tree = grad_aliases(params)
    for mb in microbatches(batch, accum_steps):
        with torch.enable_grad():
            loss, _ = task.loss_fn(tree, mb)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        yield loss.detach().float(), grads
        del grads       # before the next microbatch's backward


def accumulate_f32(acc: Optional[list], grads: list) -> list:
    """``acc + grads`` in f32 (the first call casts)."""
    if acc is None:
        return [g.float() for g in grads]
    for a, g in zip(acc, grads):
        a.add_(g)
    return acc


def _local_grads(task, params: PyTree, batch: PyTree,
                 accum_steps: int) -> tuple[torch.Tensor, list]:
    loss_acc, grad_acc = None, None
    for loss, grads in microbatch_grads(task, params, batch, accum_steps):
        grad_acc = accumulate_f32(grad_acc, grads)
        del grads
        loss_acc = loss if loss_acc is None else loss_acc + loss
    if accum_steps > 1:
        loss_acc = loss_acc / accum_steps
        for a in grad_acc:
            a.div_(accum_steps)
    return loss_acc, grad_acc


def scanned_grads(task, params: PyTree, batch: PyTree,
                  accum_steps: int = 1, *, mesh=None,
                  data_axes=None) -> tuple[torch.Tensor, PyTree]:
    """(mean loss, f32 mean grads tree) over K stacked microbatches;
    peak memory is one microbatch of activations, one microbatch's
    gradients and the f32 accumulator. ``mesh=``: per-shard results
    averaged over the data axes (global-batch loss and gradients on
    every rank)."""
    check_stacked(batch, accum_steps)
    if not _on_mesh(mesh):
        loss, grads = _local_grads(task, params, batch, accum_steps)
    else:
        axes = mesh_data_axes(mesh, data_axes)

        def local(params, batch):
            loss, grads = _local_grads(task, params, batch, accum_steps)
            mesh.mean_([loss, *grads])
            return loss, grads

        loss, grads = pipeline.shard_over_data(local, mesh, axes,
                                               accum_steps)(params, batch)
    return loss, tree_from_paths(
        params, {p: g for (p, _), g in zip(tree_flatten_with_path(params),
                                           grads)})


def build_spec(task, params: PyTree) -> flatten.FlatSpec:
    """The f32 flat layout of ``params``: one segment per leaf, or per
    stacked leaf of the JAX package for an LM task."""
    return flatten.build_spec(params, segments=getattr(task, "segments",
                                                       None))


def flat_loss_fn(task, spec: flatten.FlatSpec, batch: PyTree,
                 accum_steps: int = 1, *, template: PyTree, mesh=None,
                 data_axes=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """``loss(w2d)`` on the flat buffer: unpacked to a tree shaped like
    ``template``, each leaf at its template leaf's dtype (f32 leaves
    are views), then scanned."""

    def loss_of(w2d: torch.Tensor) -> torch.Tensor:
        params = tree_map(lambda v, t: v.to(t.dtype),
                          flatten.unpack(w2d, spec, template), template)
        return scanned_loss(task, params, batch, accum_steps, mesh=mesh,
                            data_axes=data_axes)

    return loss_of


def padding_mask(spec: flatten.FlatSpec, device=None) -> torch.Tensor:
    """(num_rows, LANES) f32 mask: 1 on real parameter coords, 0 on
    lane/tail padding. Project Lanczos seed vectors with this so the
    Krylov space never leaves the real-parameter subspace."""
    m = torch.zeros(spec.num_rows * flatten.LANES, dtype=torch.float32,
                    device=device)
    for off, size in zip(spec.row_offset, spec.sizes):
        m[off * flatten.LANES: off * flatten.LANES + size] = 1.0
    return m.view(spec.num_rows, flatten.LANES)


def _hvp_leaves(task, params: PyTree, batch: PyTree, accum_steps: int,
                tangent: list) -> list:
    """H @ tangent per leaf (flatten order, the params' dtypes): K
    reverse-over-reverse products summed in the leaves' ``.grad`` of
    fresh aliases, then divided by K."""
    leaves, tree = grad_aliases(params)
    with torch.enable_grad():
        for mb in microbatches(batch, accum_steps):
            loss = _f32_loss(task, tree, mb)
            grads = torch.autograd.grad(loss, leaves, create_graph=True,
                                        allow_unused=True)
            live = [(g, t) for g, t in zip(grads, tangent)
                    if g is not None and g.requires_grad]
            del loss, grads
            if live:
                outs, tans = zip(*live)
                del live
                torch.autograd.backward(outs, grad_tensors=tans,
                                        inputs=leaves)
                del outs, tans
    out = [torch.zeros_like(x) if x.grad is None else x.grad
           for x in leaves]
    if accum_steps > 1:
        for h in out:
            h.div_(accum_steps)
    return out


class FlatHVP:
    """Flat-layout Hessian operator for one (task, params, batch).

    ``matvec(v2d) -> H @ v2d`` (a new ``(num_rows, LANES)`` f32
    tensor); ``dim`` is the true parameter count. The operator works
    on the parameter leaves themselves: ``w2d``, the params packed in
    f32, is built only when read (the landscape slices read it)."""

    def __init__(self, spec: flatten.FlatSpec, params: PyTree,
                 matvec: Callable[[torch.Tensor], torch.Tensor]):
        self.spec = spec
        self.params = params
        self.matvec = matvec
        self.dim = sum(spec.sizes)
        self._w2d: Optional[torch.Tensor] = None

    @property
    def w2d(self) -> torch.Tensor:
        if self._w2d is None:
            with torch.no_grad():
                self._w2d = flatten.pack(self.params, self.spec)
        return self._w2d


def _placed_hvp(task, params: PyTree, batch: PyTree, accum_steps: int,
                tangent: list, place) -> list:
    """:func:`_hvp_leaves` of the GSPMD step's loss over ``place``'s
    mesh: this data row's block of the batch under
    ``layers.training(mesh, place)``, differentiated twice through the
    row's and the column's autograd functions (``distributed``) and the
    vocab-parallel cross-entropy. A leaf split over the data axis gets
    its product from its gather's backward; every other leaf's is
    averaged over the data column here, in f32, as the train step
    averages its gradient."""
    from repro_torch.models import layers as L
    mesh = place.mesh
    local = pipeline.place_over_data(
        mesh, batch, batch_dim=1 if accum_steps > 1 else 0)
    with L.training(mesh, place):
        hv = _hvp_leaves(task, params, local, accum_steps, tangent)
    if mesh.data > 1:
        whole = [i for i, (p, _) in enumerate(tree_flatten_with_path(params))
                 if place.data_dim(p) is None]
        for i in whole:
            hv[i] = hv[i].float().contiguous()
        mesh.mean_([hv[i] for i in whole], name="column_reduce")
    return hv


def make_flat_hvp(task, params: PyTree, batch: PyTree, *,
                  accum_steps: int = 1, mesh=None,
                  data_axes=None, placement=None) -> FlatHVP:
    """Build ``v2d -> H(loss) @ v2d`` on the flat buffer.

    The Hessian is of the *accumulated* mean loss; K > 1 runs one
    per-microbatch product at a time (linearity of the HVP), so peak
    memory stays one microbatch of activations whatever K. The tangent
    is read from ``v2d`` as f32 views and cast to each leaf's dtype;
    the product is packed into a fresh f32 buffer. ``mesh=``: each rank
    takes the product on its shard of the probe batch and the flat
    products are averaged over the data axes; the probe vectors stay
    whole on every rank. ``placement=`` (a ``launch.sharding.Placement``
    of the GSPMD step, with ``params`` this rank's blocks): the product
    of the global batch's loss on this rank's blocks (:func:`_placed_hvp`),
    the probe vectors this rank's blocks in the flat layout of its
    blocks."""
    check_stacked(batch, accum_steps)
    spec = build_spec(task, params)
    template = tree_leaves(params)

    def local_hvp(v2d: torch.Tensor, batch_: PyTree) -> torch.Tensor:
        views = tree_leaves(flatten.unpack(v2d.float(), spec, params))
        tangent = [v.to(p.dtype) for v, p in zip(views, template)]
        del views
        if placement is None:
            hv = _hvp_leaves(task, params, batch_, accum_steps, tangent)
        else:
            hv = _placed_hvp(task, params, batch_, accum_steps, tangent,
                             placement)
        del tangent
        pairs = tree_flatten_with_path(params)
        return flatten.pack(tree_from_paths(
            params, {p: h for (p, _), h in zip(pairs, hv)}), spec)

    if placement is not None and mesh is not None:
        raise ValueError("make_flat_hvp: mesh= is the mesh-native data "
                         "axis, placement= the GSPMD mesh; pass one")
    if not _on_mesh(mesh):
        def matvec(v2d: torch.Tensor) -> torch.Tensor:
            return local_hvp(v2d, batch)
    else:
        axes = mesh_data_axes(mesh, data_axes)

        def sharded(v2d, batch_):
            hv = local_hvp(v2d, batch_)
            mesh.mean_([hv])
            return hv

        smapped = pipeline.shard_over_data(sharded, mesh, axes,
                                           accum_steps)

        def matvec(v2d: torch.Tensor) -> torch.Tensor:
            return smapped(v2d, batch)

    return FlatHVP(spec, params, matvec)


def tree_hvp(task, params: PyTree, batch: PyTree, v: PyTree) -> PyTree:
    """Reference tree-space HVP (gradient of ⟨∇loss, v⟩); the flat path
    must match this to float32 precision."""
    tangent = [t.to(p.dtype) for t, p in zip(tree_leaves(v),
                                             tree_leaves(params))]
    hv = _hvp_leaves(task, params, batch, 1, tangent)
    return tree_from_paths(
        params, {p: h for (p, _), h in zip(tree_flatten_with_path(params),
                                           hv)})
