"""Microbatch streams and the data-axis helpers: the port of
``repro.data.pipeline``.

An accumulating train step consumes ``[K, B/K, ...]`` leaves
(:func:`stack_microbatches`). :class:`MicrobatchedStream` pulls
contiguous samples from a sample-level source (``data.synthetic.*
_sample_source``) and stacks them at an accumulation depth K and a data
width D that the adaptive-batch controller may change between steps
without skipping or re-reading a sample. :class:`PrefetchingStream`
runs any stream a few batches ahead on a producer thread;
:class:`LengthBucketedStream` groups variable-length LM samples by
length.

The data axis (a :class:`repro_torch.distributed.Mesh` of D ranks):
every rank holds the GLOBAL batch, as the reference's step is handed
the global array, and :func:`shard_batch` is the placement: rank r
computes rows ``[r·b, (r+1)·b)`` of the microbatch dim (dim 1 of
stacked ``[K, D·b, ...]`` leaves, dim 0 otherwise), the order in which
the reference's ``make_data_mesh`` devices take shards. The global
batch is ``K × D × microbatch``. :func:`shard_over_data` runs a
function on this rank's shard (the reference's ``shard_map``); the
function averages its own outputs over the axis (``Mesh.mean_``). On a
``(data, model)`` mesh (the reference's GSPMD step, fsdp + tensor
parallelism) the batch goes over the data column the same way
(:func:`place_over_data`: every rank of a model row takes its data
row's block, or the whole batch when the data width does not divide
it), and ``--microbatch`` is the global size of one pass. The
``PartitionSpec`` helpers keep the reference's descriptor of which dim
is split over which axes.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Any, Callable, Iterator, Optional

import torch

from repro_torch import device as _device
from repro_torch.distributed import Mesh, PartitionSpec as P
from repro_torch.obs import trace as obs_trace

PyTree = Any


def _tree_map(fn, batch):
    if isinstance(batch, dict):
        return {k: fn(x) for k, x in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(fn(x) for x in batch)
    return fn(batch)


def stack_microbatches(batch: PyTree, accum_steps: int) -> PyTree:
    """``[B, ...]`` leaves of a dict, tuple or single-tensor batch ->
    ``[K, B/K, ...]`` (microbatch k holds samples k·B/K .. (k+1)·B/K −
    1); K = 1 returns the batch as it is. A pure reshape, so K × (B/K)
    accumulation consumes exactly the samples of one B pass."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if accum_steps == 1:
        return batch

    def stack(x):
        if x.shape[0] % accum_steps:
            raise ValueError(f"batch {x.shape[0]} is not divisible by "
                             f"accum_steps {accum_steps}")
        return x.reshape((accum_steps, x.shape[0] // accum_steps)
                         + tuple(x.shape[1:]))

    return _tree_map(stack, batch)


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def resolve_data_axes(mesh: Mesh, axes=None) -> tuple[str, ...]:
    """The data-axis resolver every ``mesh=`` entry point (train step
    and probes alike) goes through: the ``("pod", "data")`` subset
    present in ``mesh``, or explicit ``axes`` validated against it."""
    if axes is None:
        return data_axes(mesh)
    axes = tuple(axes)
    missing = [a for a in axes if a not in mesh.shape]
    if missing:
        raise ValueError(f"data_axes {axes} not in mesh axes "
                         f"{tuple(mesh.axis_names)}")
    return axes


def resolve_dp_size(mesh: Optional[Mesh], axes=None) -> int:
    """Data-parallel width of ``mesh`` (1 for ``mesh=None``)."""
    if mesh is None:
        return 1
    return dp_size(mesh, resolve_data_axes(mesh, axes))


def dp_size(mesh: Mesh, axes: Optional[tuple] = None) -> int:
    """Total data-parallel width: the product of the data axes."""
    out = 1
    for a in (data_axes(mesh) if axes is None else axes):
        out *= int(mesh.shape[a])
    return out


def batch_axes_pspec(axes, accum_steps: int = 1) -> P:
    """The batch layout: the microbatch dim split over ``axes``, the K
    dim of stacked leaves whole."""
    axes = tuple(axes)
    return P(None, axes) if accum_steps > 1 else P(axes)


def batch_pspec(mesh: Mesh) -> P:
    return batch_axes_pspec(data_axes(mesh))


def microbatch_pspec(mesh: Mesh) -> P:
    """Spec of stacked ``[K, B/K, ...]`` leaves: K whole, B/K split over
    the data axes."""
    return batch_axes_pspec(data_axes(mesh), 2)


def shard_batch(mesh: Mesh, batch: PyTree, *, batch_dim: int = 0
                ) -> PyTree:
    """This rank's shard of a global batch: rows ``[s·b, (s+1)·b)`` of
    ``batch_dim`` (1 for stacked microbatch leaves), ``b`` the dim over
    the data width and ``s`` the rank's shard (``mesh.shard``). A dim
    that does not split over the data width raises the reference's
    ``ValueError`` with the offending sizes."""
    axes = data_axes(mesh)
    dp = dp_size(mesh)

    def place(x):
        if x.dim() <= batch_dim:
            raise ValueError(
                f"shard_batch(batch_dim={batch_dim}): leaf of shape "
                f"{tuple(x.shape)} has no dim {batch_dim} to shard over "
                f"{axes}")
        if dp > 1 and x.shape[batch_dim] % dp:
            raise ValueError(
                f"batch dim {batch_dim} of size {x.shape[batch_dim]} "
                f"(leaf shape {tuple(x.shape)}) is not divisible by the "
                f"data-parallel width {dp} (mesh axes "
                f"{ {a: int(mesh.shape[a]) for a in axes} }); pick a "
                f"microbatch that is a multiple of the data width")
        if dp == 1:
            return x
        b = x.shape[batch_dim] // dp
        return x.narrow(batch_dim, mesh.shard * b, b)

    return _tree_map(place, batch)


def place_over_data(mesh: Mesh, batch: PyTree, *, batch_dim: int = 0
                    ) -> PyTree:
    """The GSPMD batch placement (``launch.sharding.batch_pspecs``):
    this data row's block of ``batch_dim`` when the data width divides
    it (:func:`shard_batch`, at any model width: every rank of a model
    row computes the row's block), else the whole batch on every rank
    (a tiny batch stays replicated, as the reference leaves it)."""
    dp = dp_size(mesh)

    def fits(x):
        return x.dim() > batch_dim and x.shape[batch_dim] % dp == 0

    leaves = [batch] if isinstance(batch, torch.Tensor) else (
        list(batch.values()) if isinstance(batch, dict) else list(batch))
    if dp == 1 or not all(fits(x) for x in leaves):
        return batch
    return shard_batch(mesh, batch, batch_dim=batch_dim)


def sharded_iterator(mesh: Mesh, host_iter: Iterator, *,
                     batch_dim: int = 0) -> Iterator:
    for batch in host_iter:
        yield shard_batch(mesh, batch, batch_dim=batch_dim)


def shard_over_data(fn: Callable, mesh: Mesh, axes: tuple,
                    accum_steps: int) -> Callable:
    """Run a ``(replicated..., batch) -> replicated`` computation on this
    rank's shard (the reference's ``shard_map`` over the data axes):
    every positional argument but the LAST is whole on every rank, the
    last is the global batch, of which ``fn`` sees :func:`shard_batch`'s
    shard (the :func:`batch_axes_pspec` layout). ``fn`` makes its
    outputs equal on every rank itself (``mesh.mean_``)."""
    batch_dim = 1 if accum_steps > 1 else 0

    def wrapped(*args):
        local = shard_batch(mesh, args[-1], batch_dim=batch_dim)
        return fn(*args[:-1], local)

    return wrapped


class MicrobatchedStream:
    """A microbatched stream whose accumulation depth K and data width D
    can be retargeted mid-stream (``global batch = K × D ×
    microbatch``): the adaptive-batch controller's re-stack boundary.

    ``source`` is a sample-level provider ``(start, count) -> batch``
    whose sample ``i`` depends only on ``i``. Each ``next()`` takes the
    next ``K × D × microbatch`` contiguous samples and advances
    ``position`` by exactly that, so changing K or D skips and re-reads
    nothing, and a fresh stream started at the same ``position`` sees
    the same upcoming samples. Yields ``[K, D·microbatch, ...]`` leaves
    for K > 1 and ``[D·microbatch, ...]`` for K = 1, what
    ``make_train_step(accum_steps=K)`` expects.
    """

    def __init__(self, source: Callable[[int, int], PyTree],
                 microbatch: int, accum_steps: int = 1, *,
                 data_parallel: int = 1, position: int = 0):
        if microbatch < 1:
            raise ValueError(f"microbatch must be >= 1, got {microbatch}")
        self.source = source
        self.microbatch = microbatch
        self.position = position
        self._k = 0
        self._dp = 0
        self.set_accum_steps(accum_steps)
        self.set_data_parallel(data_parallel)

    @property
    def accum_steps(self) -> int:
        return self._k

    @property
    def data_parallel(self) -> int:
        return self._dp

    @property
    def global_batch(self) -> int:
        return self._k * self._dp * self.microbatch

    def set_accum_steps(self, accum_steps: int) -> None:
        """Retarget K; takes effect from the next ``next()``."""
        if accum_steps < 1:
            raise ValueError(
                f"accum_steps must be >= 1, got {accum_steps}")
        self._k = int(accum_steps)

    def set_data_parallel(self, data_parallel: int) -> None:
        """Retarget D; takes effect from the next ``next()``."""
        if data_parallel < 1:
            raise ValueError(
                f"data_parallel must be >= 1, got {data_parallel}")
        self._dp = int(data_parallel)

    def __iter__(self) -> "MicrobatchedStream":
        return self

    def __next__(self):
        n = self.global_batch
        batch = self.source(self.position, n)
        self.position += n
        return stack_microbatches(batch, self._k)


def microbatched_iterator(host_iter: Iterator, accum_steps: int) -> Iterator:
    """Stack every batch of a global-batch stream at a fixed K (a stream
    whose K changes mid-run is a :class:`MicrobatchedStream`)."""
    for batch in host_iter:
        yield stack_microbatches(batch, accum_steps)


def place_batch(batch: PyTree, device) -> PyTree:
    """Every leaf of ``batch`` on ``device`` (the counterpart of the
    reference's ``device_put_batch``)."""
    dev = _device.resolve(device)
    return _tree_map(lambda x: x.to(dev), batch)


class PrefetchingStream:
    """A background producer that runs any batch stream ahead of its
    consumer.

    A daemon thread pulls batches from ``stream`` into a buffer of
    ``size`` (2 = double buffering), applying ``place`` to each on the
    producer thread, so that drawing the samples of batch N+1 overlaps
    the card's work on batch N. ``next()`` pops the oldest batch and
    blocks only when the producer is behind. An exception of the
    producer, ``StopIteration`` of a finite stream included, is raised
    on the consumer at the ``next()`` where it becomes visible.

    Work the producer enqueues on the card goes to the stream that was
    current on the consumer's thread when this object was built, so
    every copy of a batch is ordered before the consumer's first read
    of it (both are on one CUDA stream).

    Retargeting (the controller's re-stack boundary):
    ``set_accum_steps`` / ``set_data_parallel`` drain and refill. With
    the producer held off its next pull, every buffered batch not yet
    consumed is dropped, the wrapped stream's ``position`` is rewound
    by the samples those batches took, the retarget is forwarded, and
    the buffer refills at the new shape; a switch at step N is
    therefore sample-identical to switching the unprefetched stream at
    step N. Retargeting needs a wrapped stream with the ``set_*``
    method and a writable ``position``.

    One producer, one consumer: ``set_*`` is called from the consumer's
    thread between ``next()`` calls (as ``trainer.fit`` does). ``close``
    stops the producer; the object is also a context manager.
    ``tracer=`` records a ``produce`` span around each pull and place.
    """

    def __init__(self, stream, *, size: int = 2,
                 place: Optional[Callable[[Any], Any]] = None,
                 tracer: Optional[obs_trace.Tracer] = None):
        if size < 1:
            raise ValueError(f"size must be >= 1, got {size}")
        self.stream = stream
        self.size = int(size)
        self.place = place
        self._tracer = obs_trace.NULL if tracer is None else tracer
        self._cuda_stream = torch.cuda.current_stream() \
            if torch.cuda.is_available() else None
        self._buf: collections.deque = collections.deque()
        self._cv = threading.Condition()
        # one pull at a time: a producer pull against the drain, rewind
        # and retarget of the consumer
        self._plock = threading.Lock()
        self._err: Optional[BaseException] = None
        self._stop = False
        self._thread = threading.Thread(
            target=self._produce, name="PrefetchingStream-producer",
            daemon=True)
        self._thread.start()

    @property
    def microbatch(self):
        return self.stream.microbatch

    @property
    def accum_steps(self):
        return self.stream.accum_steps

    @property
    def data_parallel(self):
        return self.stream.data_parallel

    @property
    def global_batch(self):
        return self.stream.global_batch

    @property
    def position(self):
        return self.stream.position

    def _pull(self):
        pos0 = getattr(self.stream, "position", None)
        ctx = torch.cuda.stream(self._cuda_stream) \
            if self._cuda_stream is not None else contextlib.nullcontext()
        with ctx, self._tracer.span("produce"):
            batch = next(self.stream)
            if self.place is not None:
                batch = self.place(batch)
        consumed = None if pos0 is None else self.stream.position - pos0
        return batch, consumed

    def _produce(self) -> None:
        while True:
            with self._cv:
                while len(self._buf) >= self.size and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
            with self._plock:
                if self._stop:
                    return
                try:
                    item = self._pull()
                except BaseException as e:   # StopIteration included
                    with self._cv:
                        self._err = e
                        self._cv.notify_all()
                    return
                # appended before the pull lock is released: a retarget
                # between the pull and the append would rewind past
                # the buffer without this batch and keep its old shape
                with self._cv:
                    self._buf.append(item)
                    self._cv.notify_all()

    def __iter__(self) -> "PrefetchingStream":
        return self

    def __next__(self):
        with self._cv:
            while not self._buf and self._err is None:
                self._cv.wait()
            if self._buf:
                batch, _ = self._buf.popleft()
                self._cv.notify_all()
                return batch
            err = self._err
        if isinstance(err, StopIteration):
            raise StopIteration
        raise err

    def _drain_and(self, apply: Callable[[], None]) -> None:
        """With the producer parked (no pull in flight), rewind the
        wrapped stream past every unconsumed buffered batch, apply the
        retarget, and let the buffer refill at the new shape."""
        with self._plock:
            with self._cv:
                unconsumed = 0
                for _, n in self._buf:
                    if n is None:
                        raise RuntimeError(
                            "PrefetchingStream: cannot retarget a stream "
                            "without a sample position (the drain "
                            "rewinds stream.position)")
                    unconsumed += n
                self._buf.clear()
                if unconsumed:
                    self.stream.position -= unconsumed
                apply()
                self._cv.notify_all()

    def set_accum_steps(self, accum_steps: int) -> None:
        if getattr(self.stream, "accum_steps", None) == accum_steps:
            return
        self._drain_and(lambda: self.stream.set_accum_steps(accum_steps))

    def set_data_parallel(self, data_parallel: int) -> None:
        if getattr(self.stream, "data_parallel", None) == data_parallel:
            return
        self._drain_and(
            lambda: self.stream.set_data_parallel(data_parallel))

    def close(self) -> None:
        """Stop the producer (idempotent); buffered batches are
        dropped. Raises if the producer does not stop."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=60.0)
        if self._thread.is_alive():
            raise RuntimeError("PrefetchingStream: the producer did not "
                               "stop within 60 s")

    def __enter__(self) -> "PrefetchingStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class LengthBucketedStream:
    """Length bucketing for LM batches: samples of similar length share a
    batch, which is padded only to its bucket's boundary.

    ``source`` is a sample-level provider ``(start, count) -> dict``
    with a per-sample ``length_key`` leaf (for example
    ``data.synthetic.lm_varlen_sample_source``) and sequence leaves
    padded to a common length. The stream pulls ``lookahead ×
    microbatch`` samples at a time in index order, queues each in the
    smallest bucket whose boundary covers its length (the last bucket
    for longer ones), and yields ``microbatch`` samples from the first
    full bucket (first in, first out), with every leaf of two or more
    dims trimmed to the bucket's boundary. Deterministic, and every
    pulled sample is yielded exactly once (``queued()`` are the ones
    pulled and not yet yielded).
    """

    def __init__(self, source, microbatch: int,
                 boundaries: tuple[int, ...], *, lookahead: int = 8,
                 length_key: str = "length", position: int = 0):
        if microbatch < 1:
            raise ValueError(f"microbatch must be >= 1, got {microbatch}")
        if lookahead < 1:
            raise ValueError(f"lookahead must be >= 1, got {lookahead}")
        bounds = tuple(sorted(int(b) for b in boundaries))
        if not bounds or any(b < 1 for b in bounds) \
                or len(set(bounds)) != len(bounds):
            raise ValueError(
                f"boundaries must be distinct positive ints, "
                f"got {boundaries}")
        self.source = source
        self.microbatch = int(microbatch)
        self.boundaries = bounds
        self.lookahead = int(lookahead)
        self.length_key = length_key
        self.position = int(position)
        self._buckets: dict[int, list] = {b: [] for b in bounds}

    def _bucket_of(self, length: int) -> int:
        for b in self.boundaries:
            if length <= b:
                return b
        return self.boundaries[-1]

    def _refill(self) -> None:
        n = self.lookahead * self.microbatch
        batch = self.source(self.position, n)
        self.position += n
        lengths = batch[self.length_key].tolist()
        for i in range(n):
            self._buckets[self._bucket_of(int(lengths[i]))].append(
                {k: v[i] for k, v in batch.items()})

    def queued(self) -> int:
        """Samples pulled from the source but not yet yielded."""
        return sum(len(q) for q in self._buckets.values())

    def __iter__(self) -> "LengthBucketedStream":
        return self

    def __next__(self) -> dict:
        while True:
            for b in self.boundaries:
                q = self._buckets[b]
                if len(q) >= self.microbatch:
                    rows = q[:self.microbatch]
                    self._buckets[b] = q[self.microbatch:]
                    out = {}
                    for k in rows[0]:
                        stacked = torch.stack([r[k] for r in rows])
                        if stacked.dim() >= 2 and stacked.shape[1] > b:
                            stacked = stacked[:, :b]
                        out[k] = stacked
                    return out
            self._refill()
