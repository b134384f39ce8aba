"""Training step with gradient accumulation, and the host loop: the
port of ``repro.training.trainer``.

``make_train_step(task, optimizer, accum_steps=K)`` returns ``step(state,
batch) -> (state, metrics)``. With K > 1 every batch leaf carries a
leading ``[K, B/K, ...]`` microbatch axis; the K gradients are summed
in f32 and divided by K (the reference's ``_accumulate``), the loss and
task metrics are weighted means, and the optimizer applies once per
step (under ``use_kernel="fused"`` that is two kernel launches whatever
K). With K = 1 the gradients keep the params' dtype, as in the
reference. ``grad_norm`` is the f32 global norm of the gradients the
optimizer sees.

The optimizer's updates are added to the params IN PLACE (``p += u``
cast to p's dtype, the reference's rounding; it donates its state, so
the values are the same) and the gradients are freed right after the
update, which is what lets qwen2.5-3b train at full width on one card.

``tracer=`` records a ``loss_grad`` and an ``optimizer`` span per step;
an enabled tracer ends each span with a device synchronisation on the
card (``sync_spans=True``), so the spans time the device's work rather
than its enqueueing. ``sync_spans=False`` leaves the card alone: the
spans then time the host's dispatch, and a step makes no host
synchronisation, which ``fit(async_metrics=)`` needs to run ahead.

:class:`MetricRing` and ``fit(options=FitOptions(async_metrics=W))``
resolve each step's device metrics W steps late, with the same values.

``make_train_step(..., mesh=mesh)`` is the data-parallel path (the
reference's ``shard_map`` step) over a
:class:`repro_torch.distributed.Mesh` of D ranks, one process each:
every rank is handed the global batch and computes the loss and
gradients (the K loop inside) on its shard of the microbatch dim
(``pipeline.shard_over_data``); at D > 1 the local loss, metrics and
gradients are cast to f32 (at K = 1 too, where the single-device step
keeps the params' dtype) and averaged over the ranks in place
(``Mesh.mean_``: flat f32 buckets, one ``all_reduce`` each, so every
rank holds the same bits). Everything after the average (the optimizer,
``grad_norm``, the layer-wise tap, LWN / LGN / LNR) sees the
global-batch gradients on every rank, so the params and optimizer state
(replicated by ``train_state.replicate``) stay bitwise equal, and the
fused optimizer still launches 1 + 1 kernels per rank per step at any
(D, K). A mesh whose data width is 1 runs the single-device body; over
a world of several ranks rank 0's gradients are then handed to the
others. Under a mesh, ``fit`` is called on every rank (probes and the
controller take part in collectives); only rank 0 writes to its sink
and steps its profiler (``FitOptions(rank=mesh.rank)``).

``make_train_step(..., mesh=mesh, placement=place)`` is the reference's
GSPMD step over a ``(D, M)`` mesh (fsdp over the data axis, tensor
parallelism over the model axis): each rank holds its blocks of the
params and optimizer state (``Model.init(seed, mesh=, fsdp=True)``,
``place = convert.placement(cfg, mesh)``, the optimizer built with
``placement=place``). The loss runs under ``layers.training(mesh,
place)`` on this data row's block of the global batch
(``pipeline.place_over_data``); the fsdp leaves' gradients come back
averaged over the data column from their gather's backward, every other
leaf's gradient, the loss and the metrics are averaged over the column
here (``Mesh.mean_``, counted as ``column_reduce``). ``grad_norm``, the
layer-wise tap and ``layer_norms`` are summed over the blocks with each
distinct block counted once (``Mesh.sum_blocks_``).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Optional, Sequence, Union

import torch

from repro_torch.core import instrumentation
from repro_torch.core.base import (GradientTransform, global_norm,
                                   sum_of_squares, tree_flatten_with_path,
                                   tree_from_paths, tree_leaves, tree_map)
from repro_torch.data import pipeline
from repro_torch.diagnostics import probes
from repro_torch.diagnostics import sink as sinks
from repro_torch.obs import layerwise as obs_layerwise
from repro_torch.obs import trace as obs_trace
from repro_torch.training import tasks
from repro_torch.training.losses import WeightedMean
from repro_torch.training.train_state import TrainState


def _grads(task: tasks.Task, params, batch):
    """(loss, metrics, grads tree) of one (micro)batch."""
    paths = [p for p, _ in tree_flatten_with_path(params)]
    leaves = [leaf for _, leaf in tree_flatten_with_path(params)]
    for leaf in leaves:
        if not leaf.requires_grad:
            leaf.requires_grad_(True)
    loss, metrics = task.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_from_paths(
        params, dict(zip(paths, grads)))


def _microbatch(batch, k: int):
    return tree_map(lambda x: x[k], batch)


def _accumulate(task: tasks.Task, params, batch, accum_steps: int):
    """K microbatches: f32 gradient sum / K, weighted-mean loss and
    metrics. Peak memory is one microbatch of activations plus one f32
    gradient accumulator."""
    grad_acc = None
    loss_acc = None
    metric_acc: dict = {}
    for k in range(accum_steps):
        loss, metrics, grads = _grads(task, params, _microbatch(batch, k))
        if grad_acc is None:
            grad_acc = tree_map(lambda g: torch.zeros(
                g.shape, dtype=torch.float32, device=g.device), grads)
            loss_acc = WeightedMean.zero(loss.device)
        tree_map(lambda a, g: a.add_(g), grad_acc, grads)
        del grads
        loss_acc = loss_acc.add(loss)
        for name, v in metrics.items():
            acc = metric_acc.get(name)
            if acc is None:
                acc = WeightedMean(
                    torch.zeros(v.shape, dtype=torch.float32,
                                device=v.device),
                    torch.zeros((), dtype=torch.float32, device=v.device))
            metric_acc[name] = acc.add(v)
    tree_map(lambda a: a.div_(accum_steps), grad_acc)
    return loss_acc.result(), \
        {k: a.result() for k, a in metric_acc.items()}, grad_acc


def _check_divisible(batch, accum_steps: int, dp: int, axes) -> None:
    """Every microbatch dim must split over the data axes; raises
    naming the offending sizes (the reference's message)."""
    dim = 1 if accum_steps > 1 else 0
    for leaf in tree_leaves(batch):
        if leaf.dim() <= dim or leaf.shape[dim] % dp:
            raise ValueError(
                f"mesh train step: batch leaf {tuple(leaf.shape)} has "
                f"microbatch dim {dim} of size "
                f"{leaf.shape[dim] if leaf.dim() > dim else '<missing>'} "
                f"which does not split over the data-parallel width "
                f"{dp} (axes {axes}); global batch must be "
                f"K x D x per-device-microbatch")


def _sharded_grad_fn(task: tasks.Task, mesh, axes, accum_steps: int,
                     tracer, sync: Callable):
    """``(params, step, batch) -> (loss, metrics, grads)`` on this rank's
    shard of the global batch, averaged over the data axis: at D > 1 in
    f32 (the reference's ``pmean`` of f32 values), at D = 1 rank 0's, in
    their own dtype. The average runs inside an ``all_reduce`` span,
    synchronised on the card at both ends when the tracer is on."""
    dp = pipeline.dp_size(mesh, axes)

    def local(params, step, batch):
        if accum_steps == 1:
            loss, metrics, grads = _grads(task, params, batch)
        else:
            loss, metrics, grads = _accumulate(task, params, batch,
                                               accum_steps)
        paths = [p for p, _ in tree_flatten_with_path(grads)]
        leaves = [g for _, g in tree_flatten_with_path(grads)]
        del grads
        if dp > 1:
            loss = loss.float()
            metrics = {k: v.float() for k, v in metrics.items()}
            for i in range(len(leaves)):
                leaves[i] = leaves[i].float()
        sync(loss.device)
        with tracer.span("all_reduce", step=step):
            mesh.mean_([loss, *metrics.values(), *leaves])
            sync(loss.device)
        return loss, metrics, tree_from_paths(params,
                                              dict(zip(paths, leaves)))

    return pipeline.shard_over_data(local, mesh, axes, accum_steps)


def _gspmd_grad_fn(task: tasks.Task, mesh, place, accum_steps: int,
                   tracer, sync: Callable):
    """``(params, step, batch) -> (loss, metrics, grads)`` of the GSPMD
    step: the loss on this data row's block of the global batch under
    ``layers.training``; the gradients of leaves not split over the
    data axis, the loss and the metrics averaged over the data column
    in f32 (the fsdp leaves' were averaged by their gather's
    backward)."""
    from repro_torch.models import layers as L
    batch_dim = 1 if accum_steps > 1 else 0

    def fn(params, step, batch):
        local = pipeline.place_over_data(mesh, batch, batch_dim=batch_dim)
        with L.training(mesh, place):
            if accum_steps == 1:
                loss, metrics, grads = _grads(task, params, local)
            else:
                loss, metrics, grads = _accumulate(task, params, local,
                                                   accum_steps)
        paths = [p for p, _ in tree_flatten_with_path(grads)]
        leaves = [g for _, g in tree_flatten_with_path(grads)]
        del grads
        whole = [i for i, p in enumerate(paths)
                 if place.data_dim(p) is None]
        if mesh.data > 1:
            loss = loss.float()
            metrics = {k: v.float() for k, v in metrics.items()}
            for i in whole:
                leaves[i] = leaves[i].float().contiguous()
        sync(loss.device)
        with tracer.span("all_reduce", step=step):
            mesh.mean_([loss, *metrics.values(),
                        *(leaves[i] for i in whole)], name="column_reduce")
            sync(loss.device)
        return loss, metrics, tree_from_paths(params,
                                              dict(zip(paths, leaves)))

    return fn


def block_norm(tree, place) -> torch.Tensor:
    """The f32 global norm of a tree of this rank's blocks under
    ``place``: Σx² of each block, summed over the mesh with each
    distinct block counted once (one collective, ``grad_norm``), then
    over the leaves in order; ``global_norm`` without a placement."""
    if place is None:
        return global_norm(tree)
    pairs = list(tree_flatten_with_path(tree))
    sums = torch.stack([sum_of_squares(x) for _, x in pairs])
    counted = torch.tensor([place.counts_once(p) for p, _ in pairs],
                           dtype=torch.bool)
    place.mesh.sum_blocks_(sums, counted, name="grad_norm")
    total = sums[0]
    for x in sums[1:]:
        total = total + x
    return torch.sqrt(total)


def make_train_step(task, optimizer: GradientTransform, *,
                    accum_steps: int = 1, mesh=None, data_axes=None,
                    placement=None,
                    layerwise: bool = False,
                    record_norms: bool = False,
                    tracer: Optional[obs_trace.Tracer] = None,
                    sync_spans: bool = True) -> Callable:
    """The step factory: ``(state, batch) -> (state, metrics)``.

    ``task``: a :class:`~repro_torch.training.tasks.Task`, or a model
    (wrapped in ``tasks.lm_task``). ``layerwise=True`` adds the
    optimizer's per-segment ``(w_norm, g_norm, trust_ratio)`` under
    ``layerwise/{metric}``. ``record_norms=True`` adds the per-leaf
    ``LayerNorms`` (LWN / LGN / LNR) of the params before the update
    and the accumulated gradients under ``layer_norms``, which ``fit``
    hands to its recorder. Metrics are 0-d (or per-segment) tensors on
    the device; nothing is read back here. ``sync_spans=False`` ends
    the tracer's spans without a device synchronisation.

    ``mesh=``: the data-parallel step over the mesh's data axes
    (default ``data_axes``: the ``("pod", "data")`` subset present):
    ``batch`` is the GLOBAL batch, its microbatch dim split over the
    ranks; params and optimizer state must be equal on every rank
    (``train_state.replicate``). With ``placement=`` (a
    ``launch.sharding.Placement`` of ``mesh``) it is the GSPMD step
    over the rank's blocks instead. See the module docstring."""
    if not isinstance(task, tasks.Task):
        task = tasks.lm_task(task)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    tracer = obs_trace.NULL if tracer is None else tracer

    def _sync(device):
        if sync_spans and tracer.enabled and device.type == "cuda":
            torch.cuda.synchronize(device)

    dp = pipeline.resolve_dp_size(mesh, data_axes)
    sharded = None
    if placement is not None:
        if mesh is None or placement.mesh is not mesh:
            raise ValueError("make_train_step: placement= needs the mesh "
                             "it was made for (mesh=)")
        sharded = _gspmd_grad_fn(task, mesh, placement, accum_steps,
                                 tracer, _sync)
        dp = 1          # the batch need not divide: placed or replicated
    elif mesh is not None and mesh.world > 1:
        data_axes = pipeline.resolve_data_axes(mesh, data_axes)
        sharded = _sharded_grad_fn(task, mesh, data_axes, accum_steps,
                                   tracer, _sync)

    def train_step(state: TrainState, batch):
        with tracer.span("loss_grad", step=state.step):
            if sharded is not None:
                if dp > 1:
                    _check_divisible(batch, accum_steps, dp, data_axes)
                loss, task_metrics, grads = sharded(state.params,
                                                    state.step, batch)
            elif accum_steps == 1:
                loss, task_metrics, grads = _grads(task, state.params,
                                                   batch)
            else:
                loss, task_metrics, grads = _accumulate(
                    task, state.params, batch, accum_steps)
            _sync(loss.device)
        clash = {"loss", "grad_norm", "layer_norms"} & set(task_metrics)
        if clash:
            raise ValueError(
                f"task {task.name!r} metrics {sorted(clash)} collide with "
                f"trainer-reserved metric names")
        with tracer.span("optimizer", step=state.step):
            with torch.no_grad():
                grad_norm = block_norm(grads, placement)
                # on the accumulated grads, before the in-place update:
                # the reference's layer_norms(state.params, grads)
                norms = instrumentation.layer_norms(
                    state.params, grads, placement=placement) \
                    if record_norms else None
                if layerwise:
                    with obs_layerwise.capture() as tap:
                        updates, opt_state = optimizer.update(
                            grads, state.opt_state, state.params)
                else:
                    tap = {}
                    updates, opt_state = optimizer.update(
                        grads, state.opt_state, state.params)
                del grads
                tree_map(lambda p, u: p.add_(u.to(p.dtype)), state.params,
                         updates)
                del updates
            _sync(loss.device)
        metrics = {"loss": loss, **task_metrics, "grad_norm": grad_norm}
        for k, v in tap.items():
            metrics[f"{obs_layerwise.PREFIX}{k}"] = v
        if norms is not None:
            metrics["layer_norms"] = norms
        return TrainState(state.step + 1, state.params, opt_state), metrics

    return train_step


def make_classifier_step(apply_fn: Callable, optimizer: GradientTransform,
                         *, accum_steps: int = 1, mesh=None,
                         record_norms: bool = False) -> Callable:
    """``make_train_step(tasks.classifier_task(apply_fn), ...)``."""
    return make_train_step(tasks.classifier_task(apply_fn), optimizer,
                           accum_steps=accum_steps, mesh=mesh,
                           record_norms=record_norms)


def make_ssl_step(embed_fn: Callable, optimizer: GradientTransform, *,
                  lambda_offdiag: float = 5e-3, accum_steps: int = 1,
                  mesh=None, record_norms: bool = False) -> Callable:
    """``make_train_step(tasks.ssl_task(embed_fn, ...), ...)``."""
    return make_train_step(
        tasks.ssl_task(embed_fn, lambda_offdiag=lambda_offdiag), optimizer,
        accum_steps=accum_steps, mesh=mesh, record_norms=record_norms)


def fetch(tree: Any) -> Any:
    """``tree`` with every tensor leaf copied to the host, exactly (no
    arithmetic), with one synchronisation: the card's leaves are copied
    without blocking, then the stream is waited on once."""
    waits = set()

    def one(x):
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            waits.add(x.device)
            return x.detach().to("cpu", non_blocking=True)
        return x

    out = tree_map(one, tree)
    for dev in waits:
        torch.cuda.current_stream(dev).synchronize()
    return out


class MetricRing:
    """Bounded ring of in-flight device metrics: the port of the
    reference's ``MetricRing``.

    The loop ``append``s each step's device tensors without reading
    them; once more than ``window`` entries are in flight the oldest is
    resolved, one device-to-host read (:func:`fetch`) inside a
    ``resolve`` span, the single point where the host waits on the
    card, and handed to its ``emit(step, host, last)`` callback. The
    loop therefore runs up to ``window`` steps ahead of the card.

    Values are exact: the same tensors the synchronous path reads, read
    later (no metric may be a view of a buffer that a later step writes
    in place). Emission order is append order. ``drain`` resolves
    everything still in flight (the end of a run)."""

    def __init__(self, window: int, *,
                 tracer: Optional[obs_trace.Tracer] = None):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self._tracer = obs_trace.NULL if tracer is None else tracer
        self._ring: collections.deque = collections.deque()

    def __len__(self) -> int:
        return len(self._ring)

    def append(self, step: int, values, emit: Callable, *,
               last: bool = False) -> None:
        """Enqueue device ``values``; resolves the oldest entries down
        to ``window`` in flight (FIFO, so order is preserved)."""
        self._ring.append((step, values, emit, last))
        while len(self._ring) > self.window:
            self._pop()

    def _pop(self) -> None:
        step, values, emit, last = self._ring.popleft()
        with self._tracer.span("resolve", step=step,
                               in_flight=len(self._ring) + 1):
            host = fetch(values)
        emit(step, host, last)

    def drain(self) -> None:
        """Resolve every in-flight entry (the end-of-run barrier)."""
        while self._ring:
            self._pop()


@dataclasses.dataclass(frozen=True)
class FitOptions:
    """The ``fit`` knobs: the norm ``recorder`` (fed each step's
    ``layer_norms`` metric); logging (``log_every``, ``log_fn``, or a
    metrics ``sink`` with ``close_sink``); probe ``callbacks``; the
    host-span ``tracer``; the layer-wise stream's decimation and names
    (``layerwise_every``, ``layerwise_names``) and its decimating
    ``layerwise_history`` (a :class:`repro_torch.obs.LayerwiseHistory`);
    the adaptive-batch ``controller`` (a
    :class:`repro_torch.training.controller.AdaptiveBatchController`);
    ``async_metrics`` (the :class:`MetricRing`'s window: 0/False off,
    True ``max(log_every, 1)`` or 8); the ``profiler`` window (a
    :class:`repro_torch.obs.StepProfiler`); ``rank``, this process's
    rank in a data-parallel world (its mesh's ``rank``): only rank 0
    writes to the sink and steps the profiler."""
    recorder: Optional[instrumentation.NormRecorder] = None
    log_every: int = 0
    log_fn: Callable = print
    sink: Optional[sinks.MetricsSink] = None
    close_sink: bool = False
    callbacks: Sequence = ()
    tracer: Optional[obs_trace.Tracer] = None
    layerwise_every: int = 0
    layerwise_names: Optional[Sequence[str]] = None
    layerwise_history: Optional[obs_layerwise.LayerwiseHistory] = None
    controller: Optional[Any] = None
    async_metrics: Union[bool, int] = False
    profiler: Optional[Any] = None
    rank: int = 0


def _to_host(metrics: dict) -> dict:
    """0-d tensors -> floats (one read-back), others -> lists."""
    scalars = [k for k, v in metrics.items() if v.dim() == 0]
    host = {}
    if scalars:
        values = torch.stack([metrics[k].float() for k in scalars]).tolist()
        host.update(zip(scalars, values))
    for k, v in metrics.items():
        if v.dim() != 0:
            host[k] = v.detach().float().cpu().tolist()
    return host


def fit(train_step: Optional[Callable], state: TrainState, batches,
        num_steps: int, *, options: Optional[FitOptions] = None
        ) -> tuple[TrainState, list[dict]]:
    """Host loop: ``num_steps`` steps over ``batches`` (one batch per
    global step). Records ``data_wait`` / ``dispatch`` / ``resolve``
    spans; each step's metrics are read back once (``resolve``), the
    layer-wise arrays kept every ``layerwise_every``-th step (0/1 =
    every step) and expanded to ``layerwise/{segment}/{metric}`` when
    names are given.

    Metrics stream through one
    :class:`repro_torch.diagnostics.sink.MetricsSink`: pass ``sink=``
    (written every step) or rely on ``log_every`` / ``log_fn``, which
    build a :class:`ConsoleSink` (``step {i:5d} k=v.vvvv ...``).
    ``callbacks`` are :class:`repro_torch.diagnostics.probes.Probe`
    objects: each step, every callback's ``prepare(step, state)`` hook
    (where it has one) runs, then each due probe (``probe_due``) runs
    inside a ``probe`` span, and its metrics go to the sink as
    ``{probe.name}/{key}`` with ``last=True``; they are not kept in
    the returned history. ``close_sink=True`` closes ``sink`` after the
    last write (the console sink built here is always closed).

    ``async_metrics`` (W, or True for ``max(log_every, 1)`` / 8): each
    step's device metrics enter a :class:`MetricRing` and are read W
    steps late, the same values in the same order; probes with a
    ``dispatch`` / ``resolve`` split are dispatched at their step and
    resolved through the ring (their records keep the dispatch step).
    The controller stays synchronous: its decision changes the next
    pull. ``profiler.step(i)`` runs before each step and
    ``profiler.close()`` in the ``finally``; each kept layer-wise
    snapshot is offered to ``layerwise_history``.

    ``controller``: pass ``train_step=None`` and a ``batches`` stream
    with ``set_accum_steps`` (a
    :class:`repro_torch.data.pipeline.MicrobatchedStream`, maybe inside
    a ``PrefetchingStream``). The controller builds and caches the step
    of each K it visits, runs as the last callback inside a
    ``controller`` span (its metrics as ``controller/*``), and its
    switches take effect at the next pull; every step's record carries
    the ``global_batch`` it trained at. Returns ``(state, history)``.

    In a data-parallel world every rank calls ``fit`` (the steps,
    probes and controller take part in collectives) with its ``rank``
    and keeps the same history, but only rank 0 writes to the sink,
    console included, and steps the profiler."""
    o = options if options is not None else FitOptions()
    tracer = obs_trace.NULL if o.tracer is None else o.tracer
    controller = o.controller
    callbacks = tuple(o.callbacks)
    if controller is not None:
        if train_step is not None:
            raise ValueError(
                "pass train_step=None with controller=: the controller "
                "builds (and caches) the per-K train steps itself")
        controller.attach(batches)
        callbacks = (*callbacks, controller)
    elif train_step is None:
        raise ValueError("fit needs a train_step or a controller")
    sink, close_sink = o.sink, o.close_sink
    if sink is None:
        sink = sinks.ConsoleSink(every=o.log_every, log_fn=o.log_fn) \
            if o.log_every else None
        close_sink = close_sink or sink is not None
    window = o.async_metrics
    if window is True:
        window = max(o.log_every, 1) if o.log_every else 8
    ring = MetricRing(int(window), tracer=tracer) if window else None
    writes = o.rank == 0
    profiler = o.profiler if writes else None
    history: list[dict] = []

    def emit_train(step, host, last, step_batch):
        if step_batch is not None:
            host["global_batch"] = float(step_batch)
        rest, lw = obs_layerwise.split_record(host)
        if lw and (o.layerwise_every <= 1
                   or step % o.layerwise_every == 0):
            expanded = obs_layerwise.expand(lw, o.layerwise_names)
            host = {**rest, **expanded}
            if o.layerwise_history is not None:
                o.layerwise_history.add(step, expanded)
        else:
            host = rest
        history.append(host)
        if sink is not None and writes:
            sink.write(step, host, last=last)

    def emit_probe(step, out, probe):
        if out and sink is not None and writes:
            # probe lines always flush (last=True beats the console
            # sink's every-N gate)
            sink.write(step, {f"{probe.name}/{k}": v
                              for k, v in out.items()}, last=True)

    try:
        for i in range(num_steps):
            if profiler is not None:
                profiler.step(i)
            # the batch this step trains at: a switch lands at the pull
            # after the boundary that decides it
            step_batch = controller.global_batch \
                if controller is not None else None
            with tracer.span("data_wait", step=i):
                batch = next(batches)
            fn = controller.step_fn() if controller is not None \
                else train_step
            with tracer.span("dispatch", step=i):
                state, metrics = fn(state, batch)
            norms = metrics.pop("layer_norms", None)
            last = i == num_steps - 1
            if ring is None:
                if o.recorder is not None and norms is not None:
                    o.recorder.record(i, norms)
                with tracer.span("resolve", step=i):
                    host = _to_host(metrics)
                emit_train(i, host, last, step_batch)
            else:
                # the values stay on the card; the ring reads them
                # `window` steps later (the same numbers)
                if o.recorder is not None and norms is not None:
                    ring.append(i, norms,
                                lambda s, v, _l: o.recorder.record(s, v))
                ring.append(i, metrics,
                            lambda s, v, l, _b=step_batch:
                                emit_train(s, _to_host(v), l, _b),
                            last=last)
            for probe in callbacks:
                prepare = getattr(probe, "prepare", None)
                if prepare is not None:
                    prepare(i, state)
                if not probes.probe_due(probe, i):
                    continue
                span = "controller" if probe is controller else "probe"
                name = getattr(probe, "name", "?")
                if ring is not None and probe is not controller \
                        and hasattr(probe, "dispatch") \
                        and hasattr(probe, "resolve"):
                    with tracer.span(span, step=i, probe=name,
                                     mode="dispatch"):
                        raw = probe.dispatch(i, state)
                    ring.append(i, raw,
                                lambda s, v, _l, _p=probe:
                                    emit_probe(s, _p.resolve(v), _p))
                    continue
                # the controller decides the next pull, so it stays
                # synchronous; its record rides the ring for order
                with tracer.span(span, step=i, probe=name):
                    out = probe(i, state)
                if ring is None:
                    emit_probe(i, out, probe)
                else:
                    ring.append(i, out,
                                lambda s, v, _l, _p=probe:
                                    emit_probe(s, v, _p))
        if ring is not None:
            ring.drain()
    finally:
        if profiler is not None:
            profiler.close()
        if close_sink and sink is not None:
            sink.close()
    return state, history
