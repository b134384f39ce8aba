"""The data and model axes over ``torch.distributed`` process groups:
the world a process joined, :class:`Mesh` and its collectives.

A :class:`Mesh` is a ``("data", "model")`` mesh of ``data × model``
ranks over the world: it answers what the reference's
``jax.sharding.Mesh`` answers (axis names, axis sizes) and adds what a
process needs to take part (its rank, its coordinates, its device, the
groups and the backend). Rank ``r`` of the mesh sits at ``(data_index,
model_index) = divmod(r, model)``: the reference's ``reshape(data,
model)`` of ``make_data_mesh``. A model row (the ``model`` ranks of one
data index) holds one copy of the params, split as
:mod:`repro_torch.launch.sharding` says; a data column holds one model
rank of every row.

The mesh's ranks are the first ``data × model`` ranks of the world, the
reference's ``make_data_mesh`` prefix, so meshes of different widths
share ranks: the adaptive-batch controller builds one per visited data
width D over a world of ``data_max`` ranks. At ``model = 1`` a rank at
or past D takes part in every collective of a narrower mesh but
contributes nothing to it (:meth:`Mesh.mean_`), and so ends every step
with the same state.

Collectives:

* :meth:`Mesh.mean_` averages a list of f32 tensors over the data axis
  in place: flat f32 buckets of at most :data:`BUCKET_BYTES`, in a
  fixed leaf order, each summed by one ``all_reduce`` and divided by D.
  The backend hands every rank the same bits of each sum; a rank past
  D contributes ``-0.0``, the exact additive identity, so a step at
  D < world sums what a world of D ranks sums. At D = 1 it hands rank
  0's tensors, in their own dtype, to the other ranks. Over a mesh with
  a model axis it runs over this rank's data column (``D`` ranks of one
  model index), so each model rank keeps its own blocks.
* :meth:`Mesh.broadcast_` copies rank 0's tensors to every rank in
  place, byte for byte (``train_state.replicate``); over a mesh with a
  model axis, data index 0's to the rest of the column.
* :meth:`Mesh.model_sum_` sums a row-parallel partial over the model
  row in place, in f32 (a bf16 partial is widened, summed, rounded
  back); :meth:`Mesh.model_gather` concatenates the row's blocks of a
  column-parallel output in model-rank order (also q and the decode
  kernel's partials of a KV cache over T, counted as ``q_gather`` and
  ``partial_gather``, and the outputs of a cache over the head dim,
  ``dh_gather``, whose partial scores ``model_sum_`` sums as
  ``score_sum``);
  :meth:`Mesh.model_scatter` sums the row's partials in f32 and keeps
  this rank's block (a reduce-scatter: sequence parallelism's exit);
  :meth:`Mesh.data_gather` concatenates a data column's blocks in
  data-index order (the tokens of the serving slots each data row
  holds, :meth:`Mesh.data_block`). Each call is counted and timed on
  the host in :attr:`Mesh.collectives` (host-staged: after the card's
  queue has drained, so the time is the collective's own).

Training over the model axis (fsdp + tensor parallelism, the
reference's GSPMD step) differentiates through these collectives, so
the Megatron pair and the fsdp pair are ``torch.autograd.Function``
classes (the model's layers call the Megatron pair when serving too;
its forward gives the bits of the in-place calls):

* :func:`copy_to_row` is the identity, and its backward sums the
  gradient over the model row: it stands at every column-parallel
  input and on every replicated leaf a rank uses only in part (the QKV
  biases' rows of its heads, a whole ``wk`` / ``wv`` of which it reads
  its heads' KV groups);
* :func:`sum_over_row` sums a row-parallel partial over the row, and
  its backward is the identity;
* :func:`gather_row` concatenates the row's blocks, and its backward
  keeps this rank's block;
* :func:`fsdp_gather` all-gathers a leaf's blocks over the data column,
  and its backward sums the gradient over the column, keeps this
  rank's block and divides by D: the reference's mean over the global
  batch;
* :func:`column_mean` averages a statistic over the data column (the
  MoE load-balance means of the global batch);
* :func:`gather_seq` and :func:`scatter_seq` are sequence parallelism's
  pair (``layers.set_batch_sharding(seq_axis="model")``): the row's
  sequence blocks gathered at a block's column-parallel entry (backward:
  the partial gradients reduce-scattered), and a row-parallel partial
  reduce-scattered at its exit (backward: gathered); counted as
  ``seq_gather`` / ``seq_scatter``. :func:`row_block` keeps the rank's
  block of a row-replicated tensor (backward: gathered).

Each backward is itself one of these functions (``copy_to_row`` and
``sum_over_row`` are each other's backward, and so are ``gather_seq``
and ``scatter_seq``; ``gather_row``'s keeps the rank's block, whose
backward gathers; ``fsdp_gather``'s reduces over the column, whose
backward gathers), never an in-place collective on a
tensor autograd sees, so a Hessian-vector product differentiates
through them twice.

Serving calls the in-place :meth:`Mesh.model_sum_` /
:meth:`Mesh.model_gather` directly, as before. :meth:`Mesh.sum_blocks_`
sums per-block statistics (Σw², Σg²) over the whole mesh with each
distinct block counted once: a rank whose coordinate is not 0 on an
axis that does not split the leaf adds ``-0.0``.

Backends: ``nccl`` when every rank has a card of its own, ``gloo`` on
the CPU or when ranks share one card. ``gloo`` collectives run on host
copies of the buckets (host-staged); ``nccl`` on the card's tensors.
NCCL refuses two ranks on one device, so that pairing raises
(:func:`check_backend`); nothing tries one backend and falls back to
the other. Every process group is made with a timeout
(:data:`TIMEOUT_S`), so a collective that hangs fails.

Outside a joined world a mesh is one rank with no device of its own:
whoever places tensors on it says where (:func:`placement_device`).
Worlds are joined and started by :mod:`repro_torch.launch.mesh`.
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import time
import types
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import device as _device

AXES = ("data", "model")
BUCKET_BYTES = 256 << 20
TIMEOUT_S = 300.0
BACKENDS = ("gloo", "nccl")


class PartitionSpec(tuple):
    """Which dims of a leaf are split over which mesh axes (the
    reference's ``jax.sharding.PartitionSpec``; the port places whole
    leaves only, so this is a descriptor the helpers pass around)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        inner = ", ".join(repr(e[0] if isinstance(e, tuple) and len(e) == 1
                               else e) for e in self)
        if len(self) == 1:
            inner += ","
        return f"PartitionSpec({inner})"

    def axes(self) -> set:
        out = set()
        for e in self:
            if e is None:
                continue
            out.update(e if isinstance(e, tuple) else (e,))
        return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A placement of a leaf over a mesh (``jax.sharding.NamedSharding``):
    ``spec`` empty means replicated on every rank's device."""
    mesh: "Mesh"
    spec: PartitionSpec = PartitionSpec()


@dataclasses.dataclass(frozen=True)
class World:
    """The world this process joined: its rank, size, backend and the
    device its rank computes on (None outside a joined world)."""
    rank: int
    size: int
    backend: str
    device: Optional[torch.device]


_world: Optional[World] = None


def world() -> World:
    """The joined world, or a world of one with no device of its own
    when none was joined."""
    if _world is None:
        return World(0, 1, "gloo", None)
    return _world


def joined() -> bool:
    """True when this process has joined a world (of any size)."""
    return _world is not None


def rank_device(device, rank: int) -> torch.device:
    """The device rank ``rank`` computes on: the CPU, or card ``rank``
    modulo the cards present (ranks share a card when there are more
    ranks than cards)."""
    dev = _device.resolve(device)
    if dev.type == "cpu":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def default_backend(device, world_size: int) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``."""
    dev = torch.device(device)
    if dev.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def check_backend(backend: str, device, world_size: int) -> None:
    """Refuse a backend / device pairing that cannot work."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; one of {BACKENDS}")
    dev = torch.device(device)
    if backend != "nccl":
        return
    if dev.type != "cuda":
        raise ValueError(f"backend nccl needs CUDA devices, got device "
                         f"{str(dev)!r}; use gloo on the CPU")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world_size > cards:
        raise ValueError(
            f"backend nccl needs one card per rank: {world_size} ranks on "
            f"{cards} card(s) (NCCL refuses two ranks on one device); use "
            f"gloo for ranks that share a card")


def init_world(backend: str, device, rank: int, size: int,
               init_method: str, timeout: float = TIMEOUT_S) -> World:
    """Join the process group of ``size`` ranks as ``rank`` and compute
    on :func:`rank_device`; collectives time out after ``timeout`` s."""
    global _world
    check_backend(backend, device, size)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=timeout))
    _world = World(rank, size, backend, dev)
    return _world


def leave() -> None:
    """Destroy the process group this process joined."""
    global _world
    if dist.is_initialized():
        dist.destroy_process_group()
    _world = None


def _check_devices(shape: tuple, axes: tuple) -> None:
    need = 1
    for ax, n in zip(axes, shape):
        if n < 1:
            raise ValueError(f"mesh axis {ax!r} must be >= 1, got {n}")
        need *= n
    have = world().size
    if need > have:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} needs {need} ranks but only "
            f"{have} are in the world; start {need} ranks (torchrun "
            f"--nproc-per-node {need}, or mesh.spawn(fn, {need}, ...)) or "
            f"shrink the mesh")


class Mesh:
    """A ``("data", "model")`` mesh of ``data × model`` ranks: the first
    ``data × model`` ranks of the joined world, rank ``r`` at
    ``coords == {"data": r // model, "model": r % model}``. ``rank`` is
    this process's rank, ``shard`` the data shard it computes (its data
    index; at ``model = 1`` ``rank % data`` for a rank past the mesh,
    whose results :meth:`mean_` ignores); ``device`` its rank's device,
    None outside a joined world. At ``model > 1`` every rank of the
    world makes one process group per model row and one per data
    column, in the same order; a rank past the mesh belongs to
    neither. Serving uses the rows (the model axis) and the columns
    (the slots each data row holds); training uses both (tensor
    parallelism over the rows, fsdp and the batch over the columns)."""

    axis_names = AXES

    def __init__(self, data: int, model: int = 1):
        _check_devices((data, model), AXES)
        w = world()
        self.data = int(data)
        self.model = int(model)
        self.rank = w.rank
        self.world = w.size
        self.backend = w.backend
        self.device = w.device
        self.member = w.rank < self.data * self.model
        data_index, model_index = divmod(w.rank, self.model)
        self.coords = {"data": data_index % self.data, "model": model_index}
        self.shard = self.coords["data"]
        self.collectives: dict = collections.defaultdict(
            lambda: {"calls": 0, "seconds": 0.0, "bytes": 0})
        self._row = self._column = self._all = None
        if self.model > 1 and dist.is_initialized():
            self._row, self._column, self._all = self._make_groups()

    def _make_groups(self):
        """Every rank makes every row's and every column's group, and
        the mesh's own when it is a prefix of a larger world, in the
        same order (``new_group`` is collective over the world)."""
        timeout = datetime.timedelta(seconds=TIMEOUT_S)
        row = column = everyone = None
        size = self.data * self.model
        if self.world > size:
            g = dist.new_group(list(range(size)), timeout=timeout,
                               backend=self.backend)
            everyone = g if self.member else None
        for d in range(self.data):
            g = dist.new_group([d * self.model + m
                                for m in range(self.model)],
                               timeout=timeout, backend=self.backend)
            if self.member and d == self.coords["data"]:
                row = g
        for m in range(self.model):
            g = dist.new_group([d * self.model + m
                                for d in range(self.data)],
                               timeout=timeout, backend=self.backend)
            if self.member and m == self.coords["model"]:
                column = g
        return row, column, everyone

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, "
                f"rank={self.rank}, world={self.world}, "
                f"backend={self.backend!r}, device={str(self.device)!r})")

    # -------------------------------------------------------- collectives
    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend reads it: a host copy for gloo."""
        if self.backend == "gloo" and t.device.type != "cpu":
            return t.detach().to("cpu")
        return t

    def _column_group(self, what: str):
        """The process group of this rank's data column (None: the
        default group, when the column is the whole world)."""
        if not self.member:
            raise RuntimeError(f"{what}: rank {self.rank} lies past the "
                               f"{self.data} x {self.model} mesh")
        if self.model > 1:
            return self._column
        if self.world == self.data:
            return None
        raise RuntimeError(f"{what}: {self.world} ranks in the world, "
                           f"{self.data} in the data column")

    def _mesh_group(self, what: str):
        """The group of the mesh's ranks: the default group when the
        mesh is the whole world, else (at ``model > 1``) the mesh's own
        group over the world's first ranks."""
        if self.world == self.data * self.model:
            return None
        if self._all is not None:
            return self._all
        raise RuntimeError(f"{what}: rank {self.rank} of {self.world} in "
                           f"the world, {self.data} x {self.model} in the "
                           f"mesh")

    def all_gather_object(self, value: Any) -> list:
        """``value`` of every rank that takes part in the mesh's steps,
        in rank order (one ``all_gather_object``): the mesh's ranks, over
        its own group where it is narrower than the world at ``model >
        1`` (a rank past it takes no part); every rank of the world at
        ``model = 1``, where a rank past D computes a data shard too."""
        if self.world == 1:
            return [value]
        if self.model == 1:
            group, n = None, self.world
        else:
            group = self._mesh_group("all_gather_object")
            n = self.data * self.model
        got = [None] * n
        dist.all_gather_object(got, value, group=group)
        return got

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Copy rank 0's ``tensors`` into every rank's, in place, byte
        for byte, in chunks of at most :data:`BUCKET_BYTES`. Over a mesh
        with a model axis the copy runs over this rank's data column,
        from its data index 0 (each model rank keeps its own blocks)."""
        if self.world == 1:
            return
        group, src = None, 0
        if self.model > 1:
            group = self._column_group("broadcast_")
            src = self.coords["model"]
            if self.data == 1:
                return
        for t in tensors:
            if not t.is_contiguous():
                raise ValueError("broadcast_: contiguous tensors only")
            flat = t.detach().reshape(-1).view(torch.uint8)
            for start in range(0, flat.numel(), BUCKET_BYTES):
                part = flat[start:start + BUCKET_BYTES]
                staged = self._staged(part).contiguous()
                self._broadcast(staged, src, group)
                if staged.data_ptr() != part.data_ptr():
                    part.copy_(staged)

    def mean_(self, tensors: Sequence[torch.Tensor],
              name: Optional[str] = None) -> None:
        """Average ``tensors`` over the data axis, in place: each is f32
        and contiguous, and every rank ends with the sum of the mesh
        ranks' values divided by D; at D = 1 over several ranks every
        rank ends with rank 0's values (their own dtype). Over a mesh
        with a model axis the average runs over this rank's data column
        (a no-op at D = 1). A joined world of one rank still runs the
        collectives (a sum of one); outside any world this is a no-op.
        ``name`` counts and times the call in :attr:`collectives`."""
        for t in tensors:
            if not t.is_contiguous():
                raise ValueError("mean_: contiguous tensors only (a "
                                 "reshaped copy would not be written)")
        if self.world == 1 and not dist.is_initialized():
            return
        group = None
        if self.model > 1:
            group = self._column_group("mean_")
            if self.data == 1:
                return
        elif self.data == 1 and self.world > 1:
            self.broadcast_(tensors)
            return
        for t in tensors:
            if t.dtype != torch.float32:
                raise TypeError(f"mean_: f32 tensors only, got {t.dtype}")
        t0 = self._start(tensors[0]) if name and tensors else 0.0
        flats = [t.detach().view(-1) for t in tensors]
        limit = BUCKET_BYTES // 4
        bucket: list = []
        used = 0
        for i, f in enumerate(flats):
            start = 0
            while start < f.numel():
                take = min(f.numel() - start, limit - used)
                bucket.append((i, start, start + take))
                used += take
                start += take
                if used == limit:
                    self._mean_bucket(flats, bucket, used, group)
                    bucket, used = [], 0
        if bucket:
            self._mean_bucket(flats, bucket, used, group)
        if name and tensors:
            self._record(name, t0, sum(f.numel() for f in flats) * 4)

    def _mean_bucket(self, flats, pieces, n: int, group) -> None:
        dev = flats[pieces[0][0]].device
        stage = torch.device("cpu") if self.backend == "gloo" else dev
        buf = torch.empty(n, dtype=torch.float32, device=stage)
        if self.member:
            o = 0
            for i, a, b in pieces:
                buf[o:o + b - a].copy_(flats[i][a:b])
                o += b - a
        else:
            buf.fill_(-0.0)
        self._all_reduce(buf, dist.ReduceOp.SUM, group)
        buf.div_(self.data)
        o = 0
        for i, a, b in pieces:
            flats[i][a:b].copy_(buf[o:o + b - a])
            o += b - a

    def counts_once(self, spec: PartitionSpec) -> bool:
        """Whether this rank counts its block of a leaf placed by
        ``spec`` in a sum over the whole mesh: its coordinate is 0 on
        every mesh axis that does not split the leaf (the ranks that
        hold copies of one block count it once between them)."""
        split = spec.axes()
        return all(self.coords[a] == 0 for a in AXES if a not in split)

    def sum_blocks_(self, t: torch.Tensor, counted: torch.Tensor,
                    name: str = "norm_table") -> torch.Tensor:
        """Sum per-block statistics over the whole mesh, in place: ``t``
        is f32 ``[..., n]`` with one column per leaf (or segment) and
        ``counted`` a ``[n]`` bool, whether this rank counts each
        (:meth:`counts_once`); an uncounted column adds ``-0.0``, the
        exact additive identity. One ``all_reduce``; every rank ends
        with the same bits. Returns ``t``."""
        if self.world == 1 and not dist.is_initialized():
            return t
        group = self._mesh_group("sum_blocks_")
        t0 = self._start(t)
        mask = counted.to(device=t.device, dtype=torch.bool)
        buf = torch.where(mask, t.detach(),
                          torch.full((), -0.0, dtype=t.dtype,
                                     device=t.device)).contiguous()
        staged = self._staged(buf)
        self._all_reduce(staged, dist.ReduceOp.SUM, group)
        t.copy_(staged)
        self._record(name, t0, staged.numel() * 4)
        return t

    def row_max_(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` over this rank's model row, in
        place (no gradient: a stabiliser); counted as ``model_sum``."""
        if self.model == 1:
            return t
        group = self._row_group("row_max_")
        t0 = self._start(t)
        staged = self._staged(t.detach().contiguous())
        self._all_reduce(staged, dist.ReduceOp.MAX, group)
        if staged.data_ptr() != t.data_ptr():
            t.copy_(staged)
        self._record("model_sum", t0, staged.numel() * t.element_size())
        return t

    def column_sum_(self, t: torch.Tensor, name: str = "column_reduce"
                    ) -> torch.Tensor:
        """Sum ``t`` over this rank's data column, in place, in f32 (a
        bf16 tensor widened, summed, rounded back). Returns ``t``."""
        if self.data == 1:
            return t
        group = self._column_group("column_sum_")
        t0 = self._start(t)
        buf = t.detach()
        if buf.dtype != torch.float32 or not buf.is_contiguous():
            buf = buf.float().contiguous()
        staged = self._staged(buf)
        self._all_reduce(staged, dist.ReduceOp.SUM, group)
        if staged.data_ptr() != t.data_ptr():
            t.copy_(staged)
        self._record(name, t0, staged.numel() * 4)
        return t

    def column_gather(self, t: torch.Tensor, dim: int,
                      name: str = "fsdp_gather") -> torch.Tensor:
        """The data column's blocks of ``t`` concatenated along ``dim``
        in data-index order (bits, as :meth:`model_gather`)."""
        if self.data == 1:
            return t
        return self._gather(t, dim, self._column_group(name), self.data,
                            name)

    def gather_whole(self, block: torch.Tensor, spec: PartitionSpec,
                     shape: Sequence[int], name: str = "gather_whole",
                     dst: Optional[int] = None) -> Optional[torch.Tensor]:
        """The whole leaf of ``shape`` whose blocks the mesh's ranks hold
        under ``spec`` (``launch.sharding.local_block``), each block
        placed at its rank's coordinates: on every rank (one all-gather
        over the mesh), or with ``dst`` on that rank only (one gather;
        the others get None). A replicated leaf is returned as it is."""
        if not spec.axes():
            return block if dst is None or self.rank == dst else None
        group = self._mesh_group(name)
        size = self.data * self.model
        if dst is None:
            parts = self._gather(block[None], 0, group, size, name)
        else:
            t0 = self._start(block)
            wire = block.detach().contiguous()
            bits = wire.dtype == torch.bfloat16 and self.backend == "gloo"
            wire = self._staged(wire.view(torch.uint8) if bits else wire)
            into = [torch.empty_like(wire) for _ in range(size)] \
                if self.rank == dst else None
            self._gather_to(wire, into, dst, group)
            self._record(name, t0, wire.numel() * wire.element_size()
                         * (size if into is not None else 1))
            if into is None:
                return None
            parts = [(x.view(torch.bfloat16) if bits else x)
                     .to(block.device) for x in into]
        # imported here: launch.sharding imports this module
        from repro_torch.launch.sharding import local_block
        out = torch.empty(tuple(shape), dtype=block.dtype,
                          device=block.device)
        for r in range(size):
            at = types.SimpleNamespace(
                shape=self.shape, coords=dict(zip(AXES, divmod(r,
                                                               self.model))))
            out[local_block(spec, at, shape)] = parts[r]
        return out

    def _row_group(self, what: str):
        if not self.member:
            raise RuntimeError(f"{what}: rank {self.rank} lies past the "
                               f"{self.data} x {self.model} mesh")
        return self._row

    def _start(self, t: torch.Tensor) -> float:
        """The clock of a model-row collective on ``t``. A host-staged
        one waits for the card's queue when it copies ``t`` to the host
        anyway; that wait is taken first, so the reading is the
        collective's own time (copies and the host-side reduction)."""
        if self.backend == "gloo" and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        return time.perf_counter()

    def _record(self, name: str, t0: float, nbytes: int) -> None:
        c = self.collectives[name]
        c["calls"] += 1
        c["seconds"] += time.perf_counter() - t0
        c["bytes"] += nbytes

    def model_sum_(self, t: torch.Tensor, name: str = "model_sum"
                   ) -> torch.Tensor:
        """Sum ``t`` over this rank's model row, in place, in f32: a
        bf16 partial is widened, summed and rounded back once. Every
        rank of the row ends with the same bits. Returns ``t``; at
        ``model = 1`` it is left alone. Counted under ``name``."""
        if self.model == 1:
            return t
        group = self._row_group("model_sum_")
        t0 = self._start(t)
        buf = t.detach()
        if buf.dtype != torch.float32 or not buf.is_contiguous():
            buf = buf.float().contiguous()
        staged = self._staged(buf)
        self._all_reduce(staged, dist.ReduceOp.SUM, group)
        if staged.data_ptr() != t.data_ptr():
            t.copy_(staged)
        self._record(name, t0, staged.numel() * 4)
        return t

    def model_gather(self, t: torch.Tensor, dim: int,
                     name: str = "model_gather") -> torch.Tensor:
        """The model row's blocks of ``t`` concatenated along ``dim`` in
        model-rank order, on ``t``'s device, counted under ``name``.
        Under gloo a bf16 block travels as its bytes (a uint8 view:
        gloo refuses int16, and bf16 only in some versions); the gather
        moves bits, so the result is the blocks' bits."""
        if self.model == 1:
            return t
        return self._gather(t, dim, self._row_group("model_gather"),
                            self.model, name)

    def data_block(self, n: int) -> slice:
        """The rows of a batch of ``n`` this rank's data row holds:
        block ``data`` index of ``data`` equal blocks, the reference's
        batch-over-data placement (``cache_pspecs``); all ``n`` when
        the data axis does not divide it (replicated, as
        ``batch_pspecs`` leaves a tiny batch)."""
        if self.data == 1 or n % self.data:
            return slice(0, n)
        k = n // self.data
        j = self.coords["data"]
        return slice(j * k, (j + 1) * k)

    def data_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The data column's blocks of ``t`` concatenated along ``dim``
        in data-index order, on ``t``'s device (the column's ranks hold
        the same model index). Counted as ``data_gather``."""
        if self.data == 1:
            return t
        if self.model > 1:
            group = self._column
        elif self.world == self.data:
            group = None
        else:
            raise RuntimeError(f"data_gather: {self.world} ranks in the "
                               f"world, {self.data} in the data column")
        if not self.member:
            raise RuntimeError(f"data_gather: rank {self.rank} lies past "
                               f"the {self.data} x {self.model} mesh")
        return self._gather(t, dim, group, self.data, "data_gather")

    def _gather(self, t: torch.Tensor, dim: int, group, n: int,
                name: str) -> torch.Tensor:
        t0 = self._start(t)
        wire = t.detach().contiguous()
        bits = wire.dtype == torch.bfloat16 and self.backend == "gloo"
        if bits:
            wire = wire.view(torch.uint8)
        wire = self._staged(wire)
        parts = [torch.empty_like(wire) for _ in range(n)]
        self._all_gather(parts, wire, group)
        out = torch.cat(parts, dim=dim)
        if bits:
            out = out.view(torch.bfloat16)
        self._record(name, t0, out.numel() * out.element_size())
        return out.to(t.device)

    def model_scatter(self, t: torch.Tensor, dim: int,
                      name: str = "seq_scatter") -> torch.Tensor:
        """Sum the row's partials ``t`` in f32 and return this rank's
        block along ``dim`` (block ``model`` index of ``model`` equal
        blocks), rounded to ``t``'s dtype: a reduce-scatter. Under gloo
        it is :meth:`model_sum_`'s all-reduce of the f32 buffer, then
        the rank's block (so its bits are ``model_sum_``'s); under nccl
        one ``reduce_scatter_tensor`` over the dim moved to the front.
        Counted under ``name`` with the f32 partial's bytes, either
        way."""
        if self.model == 1:
            return t
        group = self._row_group("model_scatter")
        n = t.shape[dim] // self.model
        r = self.coords["model"]
        t0 = self._start(t)
        buf = t.detach().float().contiguous()
        if self.backend == "nccl":
            front = buf.movedim(dim, 0).contiguous()
            out = torch.empty((n,) + tuple(front.shape[1:]),
                              dtype=torch.float32, device=front.device)
            self._reduce_scatter(out, front, group)
            mine = out.movedim(0, dim)
        else:
            staged = self._staged(buf)
            self._all_reduce(staged, dist.ReduceOp.SUM, group)
            mine = staged.narrow(dim, r * n, n).to(t.device)
        self._record(name, t0, buf.numel() * 4)
        return mine.to(t.dtype).contiguous()

    # the backend's calls: the one place a collective reaches
    # torch.distributed (a dry mesh, ``launch.dryrun.DryMesh``, makes
    # them no-ops on meta tensors and keeps everything else)
    def _all_reduce(self, t: torch.Tensor, op, group) -> None:
        dist.all_reduce(t, op=op, group=group)

    def _all_gather(self, parts: list, t: torch.Tensor, group) -> None:
        dist.all_gather(parts, t, group=group)

    def _broadcast(self, t: torch.Tensor, src: int, group) -> None:
        dist.broadcast(t, src=src, group=group)

    def _gather_to(self, t: torch.Tensor, into, dst: int, group) -> None:
        dist.gather(t, into, dst=dst, group=group)

    def _reduce_scatter(self, out: torch.Tensor, t: torch.Tensor,
                        group) -> None:
        dist.reduce_scatter_tensor(out, t, op=dist.ReduceOp.SUM,
                                   group=group)

    def barrier(self) -> None:
        """Every rank of the world meets here; of the mesh's only, when
        the mesh has a group of its own (a prefix at ``model > 1``)."""
        if self.world > 1:
            dist.barrier(group=self._all)


# --------------------------------------------------------------------------
# collectives that autograd differentiates (training over the model axis)
# --------------------------------------------------------------------------

class _CopyToRow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _SumOverRow.apply(g, ctx.mesh), None


class _SumOverRow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.model_sum_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return _CopyToRow.apply(g, ctx.mesh), None


class _GatherRow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.local = mesh, dim, x.shape[dim]
        return mesh.model_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _RowBlock.apply(g, ctx.mesh, ctx.dim, ctx.local), None, None


class _RowBlock(torch.autograd.Function):
    """This rank's block of a tensor replicated over the model row (the
    gather's backward); its own backward gathers the row's blocks."""

    @staticmethod
    def forward(ctx, x, mesh, dim, local):
        ctx.mesh, ctx.dim = mesh, dim
        return x.narrow(dim, mesh.coords["model"] * local,
                        local).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _GatherRow.apply(g, ctx.mesh, ctx.dim), None, None, None


class _GatherSeq(torch.autograd.Function):
    """The row's sequence blocks concatenated (``seq_gather``); the
    backward reduce-scatters the row's partial gradients."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.model_gather(x, dim, "seq_gather")

    @staticmethod
    def backward(ctx, g):
        return _ScatterSeq.apply(g, ctx.mesh, ctx.dim), None, None


class _ScatterSeq(torch.autograd.Function):
    """The row's partials summed in f32, this rank's sequence block
    kept (``seq_scatter``); the backward gathers the blocks."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.model_scatter(x, dim, "seq_scatter")

    @staticmethod
    def backward(ctx, g):
        return _GatherSeq.apply(g, ctx.mesh, ctx.dim), None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, mesh, dim):
        ctx.mesh, ctx.dim, ctx.local = mesh, dim, block.shape[dim]
        return mesh.column_gather(block, dim)

    @staticmethod
    def backward(ctx, g):
        return _ColumnBlock.apply(g, ctx.mesh, ctx.dim, ctx.local), \
            None, None


class _ColumnBlock(torch.autograd.Function):
    """The fsdp gather's backward: the gradient summed over the data
    column in f32 (``fsdp_reduce``), this rank's block kept and divided
    by D, rounded to the gradient's dtype. Its own backward gathers the
    column's blocks of the cotangent, undivided: a data row's graph
    carries D times its share of the global mean loss (each row
    differentiates the mean over its own shard), which the division
    here takes back out."""

    @staticmethod
    def forward(ctx, g, mesh, dim, local):
        ctx.mesh, ctx.dim = mesh, dim
        total = mesh.column_sum_(g.detach().to(torch.float32, copy=True)
                                 .contiguous(), "fsdp_reduce")
        mine = total.narrow(dim, mesh.coords["data"] * local, local) \
            / mesh.data
        return mine.to(g.dtype).contiguous()

    @staticmethod
    def backward(ctx, c):
        return _FsdpGather.apply(c, ctx.mesh, ctx.dim), None, None, None


class _ColumnMean(torch.autograd.Function):
    """The mean of ``x`` over the data column in f32 (its own adjoint:
    the backward is the column mean of the gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, name):
        ctx.mesh, ctx.name = mesh, name
        buf = mesh.column_sum_(x.detach().to(torch.float32, copy=True)
                               .contiguous(), name)
        return buf.div_(mesh.data).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return _ColumnMean.apply(g, ctx.mesh, ctx.name), None, None


def copy_to_row(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over the model
    row (Megatron's f: every column-parallel input, and every
    replicated leaf a rank uses in part). The backward is
    :func:`sum_over_row` itself, so it differentiates again."""
    if mesh.model == 1:
        return x
    return _CopyToRow.apply(x, mesh)


def sum_over_row(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of a row-parallel partial over the model row (a new
    tensor, summed in f32 as :meth:`Mesh.model_sum_`); the backward is
    :func:`copy_to_row` (Megatron's g)."""
    if mesh.model == 1:
        return x
    return _SumOverRow.apply(x, mesh)


def gather_row(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The row's blocks of ``x`` concatenated along ``dim``; the
    backward keeps this rank's block of the gradient (whose own
    backward gathers again). Every consumer of the result must run
    replicated over the row: an input a rank uses only in part goes
    through :func:`copy_to_row` first."""
    if mesh.model == 1:
        return x
    return _GatherRow.apply(x, mesh, dim)


def row_block(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x``, a tensor replicated over
    the model row (block ``model`` index of ``model`` equal blocks); the
    backward gathers the row's blocks of the gradient:
    :func:`gather_row`'s inverse."""
    if mesh.model == 1:
        return x
    return _RowBlock.apply(x, mesh, dim, x.shape[dim] // mesh.model)


def gather_seq(x: torch.Tensor, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """Sequence parallelism's entry to a block: the row's blocks of the
    sequence concatenated along ``dim`` in model-rank order (counted as
    ``seq_gather``). The backward is :func:`scatter_seq`: the consumers
    are column-parallel, so each rank's gradient of the whole sequence
    is a partial, summed over the row and cut to the rank's block."""
    if mesh.model == 1:
        return x
    return _GatherSeq.apply(x, mesh, dim)


def scatter_seq(x: torch.Tensor, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """Sequence parallelism's exit from a block: a row-parallel partial
    of the whole sequence summed over the row in f32 and cut to this
    rank's block along ``dim`` (a reduce-scatter,
    :meth:`Mesh.model_scatter`, counted as ``seq_scatter``). The
    backward is :func:`gather_seq`, so either differentiates again."""
    if mesh.model == 1:
        return x
    return _ScatterSeq.apply(x, mesh, dim)


def fsdp_gather(block: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """A leaf's blocks over the data column, all-gathered along ``dim``
    (counted as ``fsdp_gather``). The backward sums the gradient over
    the column in f32 (``fsdp_reduce``), keeps this rank's block and
    divides it by D, then rounds to the leaf's dtype: each data row
    computed the mean loss of its shard of the batch, so this is the
    gradient of the mean over the global batch. That backward is itself
    an autograd function (its backward gathers), so a Hessian-vector
    product differentiates through it."""
    if mesh.data == 1:
        return block
    return _FsdpGather.apply(block, mesh, dim)


def column_mean(x: torch.Tensor, mesh: Mesh,
                name: str = "column_mean") -> torch.Tensor:
    """The mean of ``x`` over this rank's data column, in f32, with a
    gradient (the column mean of the gradient): a statistic of the
    global batch from each data row's statistic of its shard (the MoE
    layer's load-balance means)."""
    if mesh.data == 1:
        return x
    return _ColumnMean.apply(x, mesh, name)


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A mesh over the world's first ``data × model`` ranks (tests / CPU
    runs)."""
    return Mesh(data, model)


def make_data_mesh(data: int, model: int = 1) -> Mesh:
    """A ``("data", "model")`` mesh over the FIRST ``data × model``
    ranks of the world, so meshes of different data widths share ranks
    (the adaptive controller's per-D meshes)."""
    return make_host_mesh(data, model)


def replicated(mesh: Mesh) -> NamedSharding:
    """The placement of a leaf whole on every rank of ``mesh``."""
    return NamedSharding(mesh, PartitionSpec())


def placement_device(mesh: Optional[Mesh], device) -> torch.device:
    """The device a leaf placed on ``mesh`` lives on: this rank's device
    in a joined world, ``device`` otherwise. Asking for another device
    type than the rank computes on raises ``ValueError``."""
    want = torch.device(device)
    got = None if mesh is None else mesh.device
    if got is None:
        return _device.resolve(want)
    if got.type != want.type:
        raise ValueError(
            f"device {str(want)!r} requested, but rank {mesh.rank} of the "
            f"mesh computes on {str(got)!r}; pass device={got.type!r}")
    return got


def all_equal(mesh: Optional[Mesh], values: Any) -> bool:
    """True when ``values`` (any picklable object) is equal on every rank
    that takes part in ``mesh``'s steps (:meth:`Mesh.all_gather_object`:
    the mesh's ranks at ``model > 1``, the whole world at ``model =
    1``). Only those ranks call it."""
    if mesh is None or mesh.world == 1:
        return True
    got = mesh.all_gather_object(values)
    return all(g == got[0] for g in got)
