"""Training step with gradient accumulation, and the host loop: the
single-device port of ``repro.training.trainer``.

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
card, so the spans time the device's work rather than its enqueueing.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core.base import (GradientTransform, global_norm,
                                   tree_flatten_with_path,
                                   tree_from_paths, tree_map)
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


def make_train_step(task, optimizer: GradientTransform, *,
                    accum_steps: int = 1, layerwise: bool = False,
                    tracer: Optional[obs_trace.Tracer] = None
                    ) -> Callable:
    """The step factory: ``(state, batch) -> (state, metrics)``.

    ``task``: a :class:`~repro_torch.training.tasks.Task`, or a model
    (wrapped in ``tasks.lm_task``). ``layerwise=True`` adds the
    optimizer's per-segment ``(w_norm, g_norm, trust_ratio)`` under
    ``layerwise/{metric}``. Metrics are 0-d (or per-segment) tensors on
    the device; nothing is read back here."""
    if not isinstance(task, tasks.Task):
        task = tasks.lm_task(task)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    tracer = obs_trace.NULL if tracer is None else tracer

    def _sync(device):
        if tracer.enabled and device.type == "cuda":
            torch.cuda.synchronize(device)

    def train_step(state: TrainState, batch):
        with tracer.span("loss_grad", step=state.step):
            if accum_steps == 1:
                loss, task_metrics, grads = _grads(task, state.params,
                                                   batch)
            else:
                loss, task_metrics, grads = _accumulate(
                    task, state.params, batch, accum_steps)
            _sync(loss.device)
        clash = {"loss", "grad_norm"} & set(task_metrics)
        if clash:
            raise ValueError(
                f"task {task.name!r} metrics {sorted(clash)} collide with "
                f"trainer-reserved metric names")
        with tracer.span("optimizer", step=state.step):
            with torch.no_grad():
                grad_norm = global_norm(grads)
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
        return TrainState(state.step + 1, state.params, opt_state), metrics

    return train_step


@dataclasses.dataclass(frozen=True)
class FitOptions:
    """The ``fit`` knobs the launcher uses: logging (``log_every``,
    ``log_fn``), the host-span ``tracer`` and the layer-wise stream's
    decimation and names (``layerwise_every``, ``layerwise_names``)."""
    log_every: int = 0
    log_fn: Callable = print
    tracer: Optional[obs_trace.Tracer] = None
    layerwise_every: int = 0
    layerwise_names: Optional[Sequence[str]] = None


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


def fit(train_step: Callable, state: TrainState, batches, num_steps: int,
        *, options: Optional[FitOptions] = None
        ) -> tuple[TrainState, list[dict]]:
    """Host loop: ``num_steps`` steps over ``batches`` (one batch per
    global step). Records ``data_wait`` / ``dispatch`` / ``resolve``
    spans; each step's metrics are read back once (``resolve``), the
    layer-wise arrays kept every ``layerwise_every``-th step (0/1 =
    every step) and expanded to ``layerwise/{segment}/{metric}`` when
    names are given. Returns ``(state, history)``."""
    o = options if options is not None else FitOptions()
    tracer = obs_trace.NULL if o.tracer is None else o.tracer
    history: list[dict] = []
    for i in range(num_steps):
        with tracer.span("data_wait", step=i):
            batch = next(batches)
        with tracer.span("dispatch", step=i):
            state, metrics = train_step(state, batch)
        with tracer.span("resolve", step=i):
            host = _to_host(metrics)
        rest, lw = obs_layerwise.split_record(host)
        if lw and (o.layerwise_every <= 1 or i % o.layerwise_every == 0):
            host = {**rest, **obs_layerwise.expand(lw, o.layerwise_names)}
        else:
            host = rest
        history.append(host)
        if o.log_every and (i % o.log_every == 0 or i == num_steps - 1):
            line = " ".join(f"{k}={host[k]:.4f}"
                            for k in ("loss", "ce", "grad_norm")
                            if k in host)
            o.log_fn(f"step {i:4d} {line}")
    return state, history
