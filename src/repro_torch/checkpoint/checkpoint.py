"""Tree checkpoints in the JAX package's format: the port of
``repro.checkpoint.checkpoint``.

A checkpoint is a directory holding

* ``arrays.npz``: member ``leaf_{i}`` is the i-th leaf in the flatten
  order of :func:`repro_torch.core.base.tree_flatten_with_path` (sorted
  dict keys, then sequence index: JAX's order). A ``bfloat16`` leaf is
  stored as its bytes, ``uint8`` and flattened, since ``.npz`` has no
  bfloat16; every other leaf as its numpy array;
* ``meta.json``: ``num_leaves``, ``treedef`` (a description; neither
  package checks it), ``step``, and per leaf ``dtypes`` and ``shapes``,
  plus ``shardings``: per leaf the placement it was saved from, ``{}``
  from one device, and from a data-parallel world (``save(mesh=)``)
  ``{"spec": "PartitionSpec()", "mesh": {"data": D, "model": 1}}``,
  the provenance the reference writes for a state replicated on a
  ``(D, 1)`` mesh.

Both files are written to a temporary name and moved into place with
``os.replace``. The layout is the reference's byte for byte, so a
checkpoint of the same tree restores in either package. An LM's params
cross packages in the reference's stacked tree
(:func:`repro_torch.models.convert.params_to_jax` /
``params_from_jax``); a port :class:`TrainState` in the reference's
``(step, params, opt_state)`` order with ``step`` a 0-d int32 leaf
(:func:`train_state_tree`).

:func:`restore` checks every leaf against the metadata and the template
(count, shape, dtype, and the byte count of a byte-viewed leaf) and
raises ``ValueError`` naming the leaf before it reinterprets any bytes.
bfloat16 bytes are decoded as ``uint8`` viewed as ``torch.bfloat16``,
which needs no ``ml_dtypes``.

Across worlds: the payload does not depend on the mesh. ``save(mesh=)``
is called on every rank; rank 0 writes and every rank waits at a
barrier. With ``shardings=`` (one spec per leaf) each rank's leaf is
its block under that spec: every leaf is gathered whole over the mesh
(every rank takes part, in leaf order) and rank 0 writes the whole
payload, recording the spec as the leaf's provenance.
:func:`save_train_state` saves a GSPMD-trained state (fsdp + tensor
parallelism, ``launch.sharding.Placement``) that way in the
reference's layout: the params and tree-path buffers stacked as the
reference stacks them, a fused state's flat buffers packed over the
whole tree as the reference's are, and each leaf's provenance the spec
the reference's launcher places it with (``state_pspecs(mesh, state,
fsdp=True)``).
``restore(mesh=)`` places every leaf whole on each rank's device;
``restore(shardings=)`` takes placements
(``distributed.NamedSharding``, one for all leaves or a tree of them,
e.g. ``launch.sharding.named(mesh, state_pspecs(mesh, like))``): a
replicated one places the leaf whole, one that splits it reads the
member and keeps this rank's block (``launch.sharding.local_block``).
A spec that cannot tile a leaf's shape raises ``ValueError`` naming
the leaf before any leaf is read.
"""
from __future__ import annotations

import json
import math
import os
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.base import (path_name, tree_flatten_with_path,
                                   tree_leaves)
from repro_torch.distributed import (NamedSharding, PartitionSpec,
                                     placement_device, replicated)
from repro_torch.launch.sharding import local_block, named, state_pspecs
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.training.train_state import TrainState

ARRAYS = "arrays.npz"
META = "meta.json"


def _dtype_name(x) -> Optional[str]:
    """A leaf's dtype as the reference writes it (``"float32"``,
    ``"bfloat16"``, ...), or None for a leaf without one."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    dt = getattr(x, "dtype", None)
    return None if dt is None else str(dt)


def _payload(x) -> tuple[np.ndarray, str, list]:
    """``(array stored in the npz, dtype name, shape)`` of one leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        shape = list(t.shape)
        if t.dtype == torch.bfloat16:
            return t.reshape(-1).view(torch.uint8).numpy(), "bfloat16", \
                shape
        arr = t.numpy()
    else:
        arr = np.asarray(x)
    shape = list(arr.shape)
    if arr.dtype.kind not in "fiub" or str(arr.dtype) == "bfloat16":
        # npz cannot hold ml_dtypes (numpy bfloat16 etc.): byte-view
        return np.ascontiguousarray(arr).reshape(-1).view(np.uint8), \
            str(arr.dtype), shape
    return arr, str(arr.dtype), shape


def _atomic_write(path: str, name: str, write) -> None:
    fd, tmp = tempfile.mkstemp(dir=path, suffix=f".{name}.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, os.path.join(path, name))
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def _leaf_sharding_meta(mesh, spec=None) -> Optional[dict]:
    """The provenance of a leaf placed on ``mesh`` by ``spec``
    (replicated when None); None without a mesh."""
    if mesh is None:
        return None
    return {"spec": str(replicated(mesh).spec if spec is None else spec),
            "mesh": {str(k): int(v) for k, v in mesh.shape.items()}}


def _specs(shardings: Any) -> list:
    """The spec of every ``NamedSharding`` of a tree, in the
    checkpoint's leaf order."""
    out = tree_leaves(shardings)
    for i, sh in enumerate(out):
        if not isinstance(sh, NamedSharding):
            raise ValueError(f"leaf {i}: sharding entry is "
                             f"{type(sh).__name__}, expected a "
                             f"distributed.NamedSharding")
    return [sh.spec for sh in out]


def _whole(block: torch.Tensor, spec: PartitionSpec, mesh) -> tuple:
    """The whole shape of which ``block`` is one rank's block."""
    shape = list(block.shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            shape[d] *= int(mesh.shape[a])
    return tuple(shape)


def save(path: str, tree: Any, *, step: Optional[int] = None,
         mesh=None, shardings: Any = None) -> None:
    """Write ``tree`` (tensors on any device, numpy arrays or numbers)
    as a checkpoint directory at ``path``. ``mesh=``: called on every
    rank of a world; rank 0 writes and the ranks meet at a barrier
    before returning. Without ``shardings`` the state is equal on every
    rank and every leaf is recorded as replicated on the mesh; with
    ``shardings`` (a tree of ``NamedSharding`` matching ``tree``, as
    :func:`restore` takes) each rank's leaf is its block under that spec:
    every split leaf is gathered whole over the mesh first (all ranks,
    in leaf order) and its spec recorded."""
    pairs = list(tree_flatten_with_path(tree))
    specs = None
    if shardings is not None:
        if mesh is None:
            raise ValueError("save: shardings= needs the mesh= the "
                             "leaves are placed on")
        specs = _specs(shardings)
        if len(specs) != len(pairs):
            raise ValueError(f"save: {len(specs)} shardings for "
                             f"{len(pairs)} leaves")
        pairs = [(p, mesh.gather_whole(
            x.detach().contiguous(), sp, _whole(x, sp, mesh),
            name="checkpoint_gather")
            if isinstance(x, torch.Tensor) and sp.axes() else x)
            for (p, x), sp in zip(pairs, specs)]
    _write(path, pairs, step, mesh, specs)


def _write(path: str, pairs: list, step, mesh, specs) -> None:
    """Rank 0 writes ``pairs`` (path, whole leaf) with each leaf's
    provenance (``specs[i]``, replicated when None); with a mesh every
    rank meets the others at a barrier after."""
    if mesh is not None and mesh.rank != 0:
        mesh.barrier()
        return
    arrays, dtypes, shapes = {}, {}, {}
    for i, (_, leaf) in enumerate(pairs):
        arrays[f"leaf_{i}"], dtypes[f"leaf_{i}"], shapes[f"leaf_{i}"] = \
            _payload(leaf)
    meta = {"num_leaves": len(pairs),
            "treedef": "repro_torch tree: " + ", ".join(
                path_name(p) for p, _ in pairs),
            "step": step, "dtypes": dtypes, "shapes": shapes,
            "shardings": {} if mesh is None else {
                f"leaf_{i}": _leaf_sharding_meta(
                    mesh, None if specs is None else specs[i])
                for i in range(len(pairs))}}
    os.makedirs(path, exist_ok=True)
    _atomic_write(path, ARRAYS, lambda f: np.savez(f, **arrays))
    _atomic_write(path, META,
                  lambda f: f.write(json.dumps(meta).encode()))
    if mesh is not None:
        mesh.barrier()


def _torch_dtype(name: str, leaf: int) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"leaf {leaf}: checkpoint dtype {name!r} has no "
                         f"torch counterpart")
    return dt


def _resolve_shardings(shardings: Any, mesh, n: int) -> Optional[list]:
    """Per-leaf placement list (None: the ``device`` argument's)."""
    if shardings is None and mesh is None:
        return None
    if shardings is None:
        return [replicated(mesh)] * n
    if isinstance(shardings, NamedSharding):
        return [shardings] * n
    sh_leaves = tree_leaves(shardings)
    if len(sh_leaves) != n:
        raise ValueError(
            f"shardings pytree has {len(sh_leaves)} leaves, template has "
            f"{n}: pass one NamedSharding, or a tree matching the "
            f"template structure")
    return sh_leaves


def _check_placeable(i: int, shape: tuple, sh) -> None:
    """Refuse a placement that cannot tile the leaf (the reference's
    ``ValueError``)."""
    if not isinstance(sh, NamedSharding):
        raise ValueError(
            f"leaf {i}: sharding entry is {type(sh).__name__}, expected "
            f"a distributed.NamedSharding")
    spec = sh.spec
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        parts = math.prod(int(sh.mesh.shape[a]) for a in axes)
        if d >= len(shape) or shape[d] % parts:
            raise ValueError(
                f"leaf {i}: shape {tuple(shape)} cannot be placed with "
                f"spec {spec} on mesh {sh.mesh.shape}: sharding mismatch "
                f"between checkpoint and restore target")


def restore(path: str, like: Any, *, device="cuda", mesh=None,
            shardings=None) -> Any:
    """Restore into the structure of ``like`` (tensors, meta tensors or
    numpy arrays; only their shapes and dtypes are read), every leaf a
    tensor on ``device``.

    Raises ``ValueError`` naming the leaf when the leaf count, a shape,
    a dtype or a byte-viewed leaf's byte count disagrees with the
    metadata or the template. ``mesh=`` places every leaf whole on this
    rank's device (``mesh.device`` in a joined world, which must be of
    ``device``'s type; ``device`` outside one); ``shardings=`` takes
    placements (one ``NamedSharding`` or a tree of them), every one
    checked before any leaf is read: a leaf whose spec splits it comes
    back as this rank's block."""
    with open(os.path.join(path, META)) as f:
        meta = json.load(f)
    pairs = list(tree_flatten_with_path(like))
    placements = _resolve_shardings(shardings, mesh, len(pairs))
    if placements is not None:
        shapes = meta.get("shapes", {})
        for i, (_, template) in enumerate(pairs):
            shape = shapes.get(f"leaf_{i}", getattr(template, "shape",
                                                    None))
            if shape is not None:
                _check_placeable(i, tuple(shape), placements[i])
    dev = placement_device(
        None if placements is None else placements[0].mesh, device)
    if meta["num_leaves"] != len(pairs):
        raise ValueError(
            f"checkpoint has {meta['num_leaves']} leaves, template has "
            f"{len(pairs)}: restoring across optimizer layouts (e.g. "
            f"per-leaf momentum trees vs the fused flat substrate) needs "
            f"a template built with the same use_kernel mode")
    dtypes = meta.get("dtypes", {})
    shapes = meta.get("shapes", {})
    # metadata against the template first: nothing is read or
    # reinterpreted while any leaf disagrees
    for i, (_, template) in enumerate(pairs):
        key = f"leaf_{i}"
        want_shape, want_dtype = shapes.get(key), dtypes.get(key)
        t_shape = getattr(template, "shape", None)
        if want_shape is not None and t_shape is not None \
                and tuple(want_shape) != tuple(t_shape):
            raise ValueError(
                f"leaf {i}: checkpoint shape {tuple(want_shape)} != "
                f"template {tuple(t_shape)}")
        t_dtype = _dtype_name(template)
        if want_dtype is not None and t_dtype is not None \
                and want_dtype != t_dtype:
            raise ValueError(
                f"leaf {i}: checkpoint dtype {want_dtype} != template "
                f"{t_dtype}: refusing to silently reinterpret; cast the "
                f"template (or re-save) explicitly")
    values = {}
    with np.load(os.path.join(path, ARRAYS)) as data:
        for i, (leaf_path, template) in enumerate(pairs):
            key = f"leaf_{i}"
            arr = data[key]
            want_dtype, want_shape = dtypes.get(key), shapes.get(key)
            if want_dtype and str(arr.dtype) != want_dtype:
                # byte-viewed payload: check the byte count against the
                # recorded shape and dtype before viewing
                tdt = _torch_dtype(want_dtype, i)
                if want_shape is None:
                    raise ValueError(
                        f"leaf {i}: checkpoint stores {want_dtype} bytes "
                        f"but records no shape: cannot safely "
                        f"reinterpret")
                itemsize = torch.empty((), dtype=tdt).element_size()
                expected = math.prod(want_shape) * itemsize
                if arr.dtype != np.uint8 or arr.nbytes != expected:
                    raise ValueError(
                        f"leaf {i}: byte payload is {arr.nbytes}B "
                        f"({arr.dtype}) but meta says shape {want_shape} "
                        f"dtype {want_dtype} = {expected}B: checkpoint "
                        f"and metadata disagree")
                t = torch.from_numpy(np.asarray(arr, order="C")).view(
                    tdt).reshape(want_shape)
            else:
                t = torch.from_numpy(np.asarray(arr, order="C"))
            if want_shape is not None \
                    and tuple(t.shape) != tuple(want_shape):
                raise ValueError(
                    f"leaf {i}: payload shape {tuple(t.shape)} != "
                    f"recorded shape {tuple(want_shape)}: corrupt "
                    f"checkpoint")
            t_shape = getattr(template, "shape", None)
            if t_shape is not None and tuple(t.shape) != tuple(t_shape):
                raise ValueError(
                    f"leaf {i}: checkpoint shape {tuple(t.shape)} != "
                    f"template {tuple(t_shape)}")
            t_dtype = _dtype_name(template)
            if t_dtype is not None and _dtype_name(t) != t_dtype:
                raise ValueError(
                    f"leaf {i}: checkpoint dtype {_dtype_name(t)} != "
                    f"template {t_dtype}")
            if placements is not None and placements[i].spec.axes():
                sh = placements[i]
                t = t[local_block(sh.spec, sh.mesh, t.shape)].clone()
            values[leaf_path] = t.to(dev)
    return _rebuild(like, values)


def _rebuild(tree: Any, values: dict, path: tuple = ()) -> Any:
    """``tree``'s structure with the leaf at each path from ``values``
    (by path, not identity: a template may repeat one leaf object)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, values, path + (i,))
               for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else tuple(out)
    if tree is None:
        return None
    return values[path]


def saved_shardings(path: str) -> dict:
    """The per-leaf source-sharding provenance in ``meta.json``
    (``{"leaf_i": {"spec": str, "mesh": {axis: size}}}``; ``{}`` for a
    checkpoint written from one device)."""
    with open(os.path.join(path, META)) as f:
        return json.load(f).get("shardings", {})


def latest_step(path: str) -> Optional[int]:
    """The ``step`` recorded by :func:`save`, or None when ``path``
    holds no checkpoint."""
    try:
        with open(os.path.join(path, META)) as f:
            return json.load(f).get("step")
    except FileNotFoundError:
        return None


def train_state_tree(state: TrainState, *, cfg=None) -> TrainState:
    """A port :class:`TrainState` in the reference's layout: ``step`` a
    0-d int32 array ahead of ``params`` and ``opt_state``; with ``cfg``
    (an LM's config) the params in the reference's stacked tree."""
    params = state.params if cfg is None \
        else params_to_jax(cfg, state.params)
    return TrainState(np.asarray(int(state.step), np.int32), params,
                      state.opt_state)


def _is_flat(buf) -> bool:
    from repro_torch.core import flatten
    return isinstance(buf, torch.Tensor) and buf.dim() == 2 \
        and buf.shape[1] == flatten.LANES


def gathered_train_state(state: TrainState, *, cfg, placement,
                         segments=None, dst: Optional[int] = None
                         ) -> Optional[TrainState]:
    """The whole state of which every rank of ``placement``'s mesh
    holds ``state``'s blocks, in the reference's layout: on every rank,
    or with ``dst`` on that rank only (None elsewhere); every rank takes
    part. The params gathered and stacked (``convert.gather_params``,
    ``params_to_jax``), a tree-path buffer alike, a fused flat buffer
    unpacked to its leaves, gathered and packed again over the whole
    tree (``segments`` as the optimizer was built with), so it is the
    flat buffer a one-device run of the same state holds."""
    from repro_torch.core import flatten
    from repro_torch.models import convert
    whole = convert.gather_params(state.params, placement, dst=dst)
    bufs = []
    for buf in list(state.opt_state)[1:]:
        if _is_flat(buf):
            spec = flatten.build_spec(state.params, dtype=buf.dtype,
                                      segments=segments)
            tree = convert.gather_params(
                flatten.unpack(buf, spec, state.params), placement, dst=dst)
            bufs.append(None if tree is None else flatten.pack(
                tree, flatten.build_spec(whole, dtype=buf.dtype,
                                         segments=segments)))
        else:
            tree = convert.gather_params(buf, placement, dst=dst)
            bufs.append(None if tree is None else params_to_jax(cfg, tree))
    if whole is None:
        return None
    opt = type(state.opt_state)(state.opt_state[0], *bufs)
    dev = next(iter(tree_leaves(whole))).device
    return TrainState(np.asarray(int(state.step), np.int32),
                      params_to_jax(cfg, whole, device=dev), opt)


def save_train_state(path: str, state: TrainState, *, cfg, mesh,
                     placement, segments=None) -> TrainState:
    """Save a state trained over ``placement`` (every rank holding its
    blocks) as the reference saves the same state placed on the same
    mesh by its launcher: rank 0 writes :func:`gathered_train_state`'s
    payload, and each leaf's provenance is its spec under
    ``state_pspecs(mesh, ..., fsdp=True)`` of that whole tree. Called on
    every rank (the leaves are gathered to rank 0 only); returns the
    whole tree written on rank 0, None elsewhere."""
    whole = gathered_train_state(state, cfg=cfg, placement=placement,
                                 segments=segments, dst=0)
    specs = None if whole is None else _specs(
        named(mesh, state_pspecs(mesh, whole, fsdp=True)))
    _write(path, [] if whole is None else
           list(tree_flatten_with_path(whole)), int(state.step), mesh,
           specs)
    return whole


def restore_train_state(path: str, like: TrainState, *, cfg=None,
                        device="cuda", mesh=None) -> TrainState:
    """Restore a checkpoint of :func:`train_state_tree`'s layout (written
    by either package) into a port :class:`TrainState` shaped like
    ``like``; ``mesh=`` places it whole on every rank's device."""
    template = TrainState(
        np.zeros((), np.int32),
        like.params if cfg is None
        else params_to_jax(cfg, like.params, device="meta"),
        like.opt_state)
    tree = restore(path, template, device=device, mesh=mesh)
    device = placement_device(mesh, device)
    params = tree.params if cfg is None \
        else params_from_jax(cfg, tree.params, device=device)
    return TrainState(int(tree.step), params, tree.opt_state)
