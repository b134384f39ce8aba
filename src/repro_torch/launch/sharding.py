"""PartitionSpec rules — Megatron-style tensor parallelism with a
divisibility guard: the port of ``repro.launch.sharding``.

Params are split over the ``model`` axis only (replicated over data);
the batch splits over ``data``. Rules are keyed by the leaf's path name,
so they apply alike to the reference's stacked tree and to the port's
per-layer one (the model axis counts from the END of a leaf's shape,
so leading stacked dims never move it), and to optimizer state that
mirrors the param tree.

The guard: a dim is given the ``model`` axis only when its size divides
by the axis size, otherwise that dim stays replicated (e.g. whisper's
20 heads, or kv = 2 / 8 on a 16-way axis).

Every rule takes any ``mesh`` with a ``.shape`` dict (a
:class:`repro_torch.distributed.Mesh`, or a stand-in with the axis
sizes only) and any leaf with a ``.shape`` (tensors, meta tensors,
numpy arrays). Trees are the port's: nested dicts, lists, tuples and
NamedTuples (the SSM cache), whose fields name their leaves.
:func:`local_block` is the port's own: the slices of a leaf that one
rank holds under a spec, where the reference hands the spec to
``jax.device_put``; so is :class:`Placement`, the specs of a whole tree
that a training step, its optimizer and a checkpoint read to know which
of a rank's blocks are split over which axes.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.distributed import NamedSharding, PartitionSpec as P


def _path_names(path) -> list[str]:
    return [str(p) for p in path]


# (leaf name, context) -> axis-from-the-END to shard with "model"
#   e.g. wq [*, D, H, Dh] -> shard H = end-2
_END_AXIS_RULES = {
    "wq": 2, "wk": 2, "wv": 2,       # [.., D, H, Dh] -> H
    "table": 2,                       # [V, D] -> V (vocab-parallel embed)
    "head": 1,                        # [D, V] -> V
    "router": 1,                      # [D, E] -> E
    "in_proj": 1,                     # [D, X] -> X (mamba column-parallel)
    "out_proj": 2,                    # [Di, D] -> Di (row-parallel)
    "conv_w": 1,                      # [W, C] -> C (channel-parallel)
    "conv_b": 1,
}


def _leaf_model_axis(names: list[str], ndim: int) -> Optional[int]:
    """Returns the dim index (from the front) to try sharding, or None."""
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    if leaf == "wo":
        # attn wo [.., H, Dh, D] -> H (end-3); mlp/moe wo [.., F|E.., D]
        if parent == "attn" or "attn" in parent:
            end = 3
        elif parent == "moe":
            end = 3                   # [E, F, D] -> E (expert-parallel)
        else:
            end = 2                   # [F, D] -> F (row-parallel)
    elif leaf in ("wi", "wg"):
        if parent == "moe":
            end = 3                   # [E, D, F] -> E
        else:
            end = 1                   # [D, F] -> F (column-parallel)
    elif leaf in _END_AXIS_RULES:
        end = _END_AXIS_RULES[leaf]
    else:
        return None                   # biases, norms, scalars: replicate
    if end > ndim:
        return None
    return ndim - end


def _data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _axes_size(mesh, axes: tuple) -> int:
    size = 1
    for a in axes:
        size *= int(mesh.shape[a])
    return size


def leaf_pspec(path, leaf, mesh, *, fsdp: bool = False) -> P:
    """PartitionSpec for one param / opt-state leaf (guarded).

    ``fsdp=True`` (training) additionally shards one remaining dim over
    the data axes (ZeRO-3-style parameter / optimizer-state sharding);
    ``table`` and ``head`` stay TP-only."""
    shape = tuple(leaf.shape)
    if len(shape) == 0:
        return P()
    m = int(mesh.shape.get("model", 1))
    names = _path_names(path)
    dim = _leaf_model_axis(names, len(shape))
    spec: list = [None] * len(shape)
    if dim is not None and m > 1 and shape[dim] % m == 0 and shape[dim] >= m:
        spec[dim] = "model"
    if fsdp and names[-1] not in ("table", "head"):
        dp = _data_axes(mesh)
        dp_size = _axes_size(mesh, dp) if dp else 1
        if dp and dp_size > 1:
            # largest unsharded dim divisible by the dp extent
            cands = [i for i in range(len(shape))
                     if spec[i] is None and shape[i] % dp_size == 0
                     and shape[i] >= dp_size]
            if cands:
                best = max(cands, key=lambda i: shape[i])
                spec[best] = dp
    return P(*spec)


def _map_with_path(fn, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over the leaves, in ``tree``'s structure. A
    NamedTuple's fields are named in the path (the reference's
    ``GetAttrKey``), and a ``PartitionSpec`` is a leaf."""
    if isinstance(tree, P) or tree is None:
        return None if tree is None else fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(fn, v, path + (i,))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(path, tree)


def state_pspecs(mesh, state_shapes: Any, *, fsdp: bool = False) -> Any:
    """PartitionSpec tree for a params (or state) shape tree."""
    return _map_with_path(
        lambda path, leaf: leaf_pspec(path, leaf, mesh, fsdp=fsdp),
        state_shapes)


def batch_pspecs(mesh, batch_shapes: Any) -> Any:
    """Batch dims shard over the data axes; scalars replicate."""
    dp = _data_axes(mesh)
    dp_size = _axes_size(mesh, dp) if dp else 1

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return P()
        if dp and shape[0] % dp_size == 0 and shape[0] >= dp_size:
            return P(dp, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))   # tiny batch: replicate

    return _map_with_path(spec, batch_shapes)


def cache_pspecs(mesh, cache_shapes: Any) -> Any:
    """KV / SSM cache sharding for decode. Attention caches end in
    [B, T, Hkv, Dh] (``k`` / ``v`` / ``ck`` / ``cv``), SSM state in
    [B, H, P, N] and conv in [B, W-1, C]. Batch shards over the data
    axes. The model axis goes to Hkv when it divides, else to the
    sequence dim T, else to Dh, else stays replicated."""
    m = int(mesh.shape.get("model", 1))
    dp = _data_axes(mesh)
    dp_size = _axes_size(mesh, dp) if dp else 1

    def shard_b(out, shape, b_dim):
        if dp and shape[b_dim] % dp_size == 0 and shape[b_dim] >= dp_size:
            out[b_dim] = dp

    def spec(path, leaf):
        names = _path_names(path)
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd == 0:
            return P()
        out: list = [None] * nd
        if names[-1] in ("k", "v", "ck", "cv"):
            b_dim, t_dim, h_dim, d_dim = nd - 4, nd - 3, nd - 2, nd - 1
            shard_b(out, shape, b_dim)
            for dim in (h_dim, t_dim, d_dim):
                if m > 1 and shape[dim] % m == 0 and shape[dim] >= m:
                    out[dim] = "model"
                    break
            return P(*out)
        if names[-1] == "state":          # [.., B, H, P, N]
            b_dim, h_dim = nd - 4, nd - 3
            shard_b(out, shape, b_dim)
            if m > 1 and shape[h_dim] % m == 0:
                out[h_dim] = "model"
            return P(*out)
        if names[-1] == "conv":           # [.., B, W-1, C]
            b_dim, c_dim = nd - 3, nd - 1
            shard_b(out, shape, b_dim)
            if m > 1 and shape[c_dim] % m == 0:
                out[c_dim] = "model"
            return P(*out)
        return P(*out)                    # unknown cache leaf: replicate

    return _map_with_path(spec, cache_shapes)


def named(mesh, pspec_tree: Any) -> Any:
    """The spec tree as ``NamedSharding`` placements on ``mesh``."""
    return _map_with_path(lambda path, spec: NamedSharding(mesh, spec),
                          pspec_tree)


def local_block(spec: P, mesh, shape) -> tuple:
    """The slices of a leaf of ``shape`` that this rank of ``mesh``
    holds under ``spec``: each dim split over axes is cut into the
    axes' size of equal blocks, and the rank keeps the block at its
    coordinate on them (``mesh.coords``, data-major over several)."""
    shape = tuple(shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the leaf's "
                         f"{len(shape)} dims")
    out = []
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            out.append(slice(None))
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        parts, index = 1, 0
        for a in axes:
            n = int(mesh.shape[a])
            parts, index = parts * n, index * n + int(mesh.coords[a])
        if size % parts:
            raise ValueError(f"dim {d} of size {size} does not split "
                             f"into {parts} blocks (spec {spec})")
        block = size // parts
        out.append(slice(index * block, (index + 1) * block))
    return tuple(out)


class Placement:
    """Where every leaf of a parameter tree lies over ``mesh``: each
    leaf's spec under :func:`leaf_pspec` (``fsdp=True``: the model axis
    on the Megatron dim, the data axes on the largest remaining dim that
    divides them), computed from the WHOLE leaves' shapes ``whole``
    (``{path: shape}``), so a rank that holds only its blocks can ask
    what the whole leaf is. Paths are the port's tree paths.

    ``stacked`` (``{path: dims}``) gives, for a leaf that is one member
    of a stacked leaf of the reference's tree (a layer, block or group),
    the stacked dims that leaf has in front of the member's: the spec is
    then the reference leaf's with those dims dropped, so the port
    places each member as the reference places its stacked leaf. Where
    the reference gives the data axes to a stacked dim (mamba2's and
    zamba2's ``conv_w`` / ``conv_b``, the vlm cross layers' ``gate``),
    the member stays whole over the data column: it keeps its model
    split, counts once in a sum over the mesh (:meth:`counts_once`) and
    has its gradient averaged over the column like any leaf the data
    axis leaves whole; :attr:`stacked_picks` names those leaves."""

    def __init__(self, mesh, whole: dict, *, fsdp: bool = True,
                 stacked: Optional[dict] = None):
        self.mesh = mesh
        self.fsdp = fsdp
        self.whole = {tuple(p): tuple(s) for p, s in whole.items()}
        lead = {tuple(p): tuple(d) for p, d in (stacked or {}).items()}
        self.specs = {}
        self.stacked_picks = set()
        for p, s in self.whole.items():
            dims = lead.get(p, ())
            spec = leaf_pspec(p, _Shape(dims + s), mesh, fsdp=fsdp)
            self.specs[p] = P(*spec[len(dims):])
            if P(*spec[:len(dims)]).axes():
                self.stacked_picks.add(p)

    def spec(self, path) -> P:
        return self.specs[tuple(path)]

    def data_dim(self, path) -> Optional[int]:
        """The dim split over the data axes, or None."""
        for d, entry in enumerate(self.spec(path)):
            axes = entry if isinstance(entry, tuple) else (entry,)
            if "data" in axes:
                return d
        return None

    def parts(self, path) -> int:
        """How many blocks the whole leaf is cut into."""
        n = 1
        for a in self.spec(path).axes():
            n *= int(self.mesh.shape[a])
        return n

    def counts_once(self, path) -> bool:
        """Whether this rank counts its block of the leaf in a sum over
        the mesh (``Mesh.counts_once``)."""
        return self.mesh.counts_once(self.spec(path))

    def block(self, path, leaf):
        """This rank's block of the whole ``leaf`` at ``path`` (a view)."""
        return leaf[local_block(self.spec(path), self.mesh, leaf.shape)]


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)
