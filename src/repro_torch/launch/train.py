"""Training launcher: the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --optimizer tvlars --use-kernel fused --global-batch 8 --seq 512 \\
        --steps 3

Builds the model on random weights from seed 0, the optimizer from the
GLOBAL batch (the batch-size LR rule and TVLARS's γ_min key off it),
and trains on the synthetic bigram LM stream. ``--microbatch`` below
``--global-batch`` accumulates K = global / micro microbatches in f32;
``--use-kernel fused`` runs the optimizer as two segmented kernel
launches per step on the flat substrate, ``--precision bf16_master[_sr]``
stores its buffers in bf16. ``--layerwise-every N`` streams the
per-segment ``(w_norm, g_norm, trust_ratio)``; ``--trace-out PATH``
writes the loop's spans (``loss_grad`` / ``optimizer`` synchronised on
the card, ``probe``) as trace-v1 JSONL. ``--probe-every N`` runs a
Lanczos λ_max probe (``--probe-iters`` steps, top ``--probe-topk``
eigenvalues, ``--probe-no-reorth`` to keep no Krylov basis on the card,
which a full-size model needs) after every N-th step on a held batch:
the global batch drawn from a fixed seed, stacked like the run's. The
probe reads the params and never writes them. ``--metrics-out PATH`` streams
every step's metrics and the probe results to a JSONL file
(``repro_torch.diagnostics.sink.JsonlSink``, with the arch, optimizer
and global batch on every record).

``--adaptive-batch`` closes the loop: a gradient-noise-scale probe on
a held batch (``max(2, global / micro)`` microbatches drawn from seed
998) retargets the global batch (the accumulation
depth K at a fixed ``--microbatch``, within ``--batch-min`` ..
``--batch-max``) every ``--controller-every`` steps, with the LR
re-scaled to the current batch; its stream draws each sample from its
own index (``data.synthetic.lm_sample_source``), so a switch skips and
re-reads nothing. ``--prefetch N`` draws the next N batches on a
producer thread (``data.pipeline.PrefetchingStream``), for the fixed
and the adaptive stream alike. ``--async-metrics W`` reads each step's
metrics W steps late through a :class:`repro_torch.training.MetricRing`
(the same numbers; the ``loss_grad`` / ``optimizer`` spans then time
the host's dispatch, since a synchronised span would stall the loop)
and writes the JSONL file from a writer thread
(``diagnostics.sink.BufferedSink``). ``--profile-dir DIR`` captures a
``torch.profiler`` Chrome trace of the steps ``[--profile-start,
--profile-start + --profile-steps)`` into DIR. ``--batch`` is the
reference launcher's alias of ``--global-batch``. Runs on CUDA unless
``--device cpu``. The vlm and encdec archs (llama-3.2-vision-11b,
whisper-large-v3) train on the stubbed modality frontend, as the
reference launcher does: every batch, the held probe batches included,
carries ``extra_embeds``, zeros of ``extra_embed_shape`` in the compute
dtype.

Data parallelism (``--mesh-data D`` with ``--mesh-model 1``, D > 1):
the reference's mesh-native path, one rank per data shard over
``torch.distributed``. Params and optimizer state are replicated
(broadcast from rank 0), every rank draws the same global batch and
trains on its shard of the microbatch dim, and the gradients are
averaged in f32 (``make_train_step(mesh=)``); ``--microbatch`` is then
PER RANK and the global batch is K × D × microbatch. Without a
``torchrun`` world the launcher spawns the D ranks itself (their
results come back from rank 0, without the state); under ``torchrun``
it joins the world given. ``--dist-backend`` picks ``gloo`` or ``nccl``
(default: ``nccl`` when every rank has a card of its own, else
``gloo``; printed). Rank 0 alone prints and writes the metrics, trace
and profile. ``--adaptive-batch`` then moves D too (``data_max`` =
``--mesh-data``, a power of two).

The reference's GSPMD path (``--mesh-model M > 1`` with ``--mesh-data
D``, its alias ``--model-parallel``, or the legacy ``--data-parallel D
> 1``): D × M ranks, spawned or joined as above, each holding its
blocks of the params and optimizer state under the reference's
training placement (``state_pspecs(fsdp=True)``: tensor parallelism
over the model axis, fsdp over the data axis;
``Model.init(0, mesh=, fsdp=True)``), the batch over the data axis and
``--microbatch`` GLOBAL (K = global / micro), as in the reference
(``make_train_step(mesh=, placement=)``). Every family trains there
(the vlm and encdec archs' extra embeddings split over the data axis
with their batch; the MoE family's experts over the model axis, as
the reference's rules place them, where M divides their count);
``--adaptive-batch`` is refused with the reference's message.
``--probe-every`` probes the global held batch on each rank's blocks,
as the reference's probe runs on its sharded
params (``diagnostics.probes.LanczosProbe(placement=)``), and prints
the single-rank run's probe lines. After the run the ranks that hold
the same block of a leaf are checked bitwise equal.

:func:`run` is the entry point for programs (``chip_smoke.py``): it
takes the argument list and returns the run's numbers and final state.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import build_optimizer
from repro_torch.core import flatten
from repro_torch.core.layerwise import PRECISIONS
from repro_torch.data import pipeline
from repro_torch.data.synthetic import (lm_batch, lm_iterator,
                                        lm_sample_source)
from repro_torch.diagnostics import probes
from repro_torch.diagnostics import sink as sinks
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import extra_embed_shape, get_model
from repro_torch.obs import profiler as obs_profiler
from repro_torch.obs import trace as obs_trace
from repro_torch.training import (AdaptiveBatchController,
                                  ControllerConfig, FitOptions, TrainState,
                                  fit, lm_task, make_train_step)
from repro_torch.models import convert
from repro_torch.training.train_state import (fingerprint, replicas_equal,
                                              replicate)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2.5-3b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--optimizer", default="tvlars")
    ap.add_argument("--learning-rate", type=float, default=2.0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8,
                    help="alias of --global-batch (the reference "
                         "launcher's flag)")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="total samples per optimizer step (default: "
                         "--batch)")
    ap.add_argument("--microbatch", type=int, default=None,
                    help="samples per pass; K = global / micro grads are "
                         "accumulated (default: --global-batch)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--use-kernel", default="off",
                    choices=("off", "per_tensor", "fused"))
    ap.add_argument("--precision", default="f32", choices=PRECISIONS)
    ap.add_argument("--layerwise-every", type=int, default=0, metavar="N")
    ap.add_argument("--trace-out", default=None, metavar="PATH")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--probe-every", type=int, default=0, metavar="N",
                    help="run the Lanczos sharpness probe every N steps "
                         "(0 = off) on a held batch; the train step is "
                         "untouched")
    ap.add_argument("--probe-topk", type=int, default=1,
                    help="how many top Hessian eigenvalues to report")
    ap.add_argument("--probe-iters", type=int, default=8,
                    help="Lanczos iterations per probe")
    ap.add_argument("--probe-no-reorth", action="store_true",
                    help="skip full reorthogonalization: no Krylov basis "
                         "(iters x params floats) on the device, and the "
                         "previous Lanczos vector waits in host memory; "
                         "for full-size (non --smoke) archs")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="stream per-step metrics + probe results to "
                         "this JSONL file")
    ap.add_argument("--adaptive-batch", action="store_true",
                    help="retarget the global batch (K at a fixed "
                         "--microbatch) from a gradient-noise-scale probe "
                         "every --controller-every steps, the LR re-scaled "
                         "to the current batch")
    ap.add_argument("--batch-min", type=int, default=None,
                    help="adaptive-batch lower clamp on the global batch "
                         "(default: --microbatch)")
    ap.add_argument("--batch-max", type=int, default=None,
                    help="adaptive-batch upper clamp on the global batch "
                         "(default: 4x --global-batch)")
    ap.add_argument("--controller-every", type=int, default=5,
                    help="adaptive-batch decision cadence in steps")
    ap.add_argument("--prefetch", type=int, default=0, metavar="N",
                    help="draw N batches ahead on a producer thread (0 = "
                         "off); a retarget drains and refills them")
    ap.add_argument("--async-metrics", type=int, default=0, metavar="W",
                    help="read each step's metrics W steps late through "
                         "a bounded ring instead of waiting on every "
                         "step (0 = off; the same numbers), and write "
                         "the JSONL file from a writer thread")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler Chrome trace into DIR "
                         "over the [--profile-start, +--profile-steps) "
                         "step window")
    ap.add_argument("--profile-start", type=int, default=1,
                    help="first step of the profiler window (default 1: "
                         "skips the cold first step)")
    ap.add_argument("--profile-steps", type=int, default=3,
                    help="length of the profiler window in steps")
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="the reference's GSPMD data axis (fsdp + TP "
                         "rules; --microbatch is global)")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--mesh-data", type=int, default=None,
                    help="data axis of the mesh: D > 1 with --mesh-model "
                         "1 trains on D ranks, the batch split over them "
                         "(--microbatch is PER RANK)")
    ap.add_argument("--mesh-model", type=int, default=None,
                    help="model axis of the mesh (alias of "
                         "--model-parallel): M > 1 trains on D x M ranks "
                         "over the GSPMD path (fsdp + tensor "
                         "parallelism, --microbatch global)")
    ap.add_argument("--dist-backend", default=None,
                    choices=mesh_lib.BACKENDS,
                    help="collective backend of the ranks (default: nccl "
                         "with a card per rank, else gloo)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


class _Console(sinks.MetricsSink):
    """The launcher's console: loss, CE and gradient norm of every
    ``every``-th step and the last, and every probe result."""

    def __init__(self, every: int, log_fn):
        self.every = every
        self.log_fn = log_fn

    def write(self, step: int, metrics, *, last: bool = False) -> None:
        if "controller/global_batch" in metrics:
            self.log_fn(
                f"step {step:4d} controller "
                f"B_noise={metrics['controller/b_noise']:.1f} "
                f"global_batch={int(metrics['controller/global_batch'])} "
                f"D={int(metrics['controller/data_parallel'])} "
                f"K={int(metrics['controller/accum_steps'])} "
                f"lr={metrics['controller/lr']:.4f}"
                + (" [switched]" if metrics["controller/changed"] else ""))
        elif "loss" not in metrics:
            self.log_fn(f"step {step:4d} probe " + " ".join(
                f"{k}={v:.4f}" for k, v in metrics.items()
                if isinstance(v, float)))
        elif self.every and (step % self.every == 0 or last):
            self.log_fn(f"step {step:4d} " + " ".join(
                f"{k}={metrics[k]:.4f}" for k in ("loss", "ce", "grad_norm")
                if k in metrics))


def _stub_frontend(cfg, batch: dict) -> dict:
    """``batch`` with the stubbed modality frontend's output beside its
    tokens: zeros of ``extra_embed_shape`` in the compute dtype, one row
    per sequence (stacked ``[K, B/K, ...]`` like the tokens); the batch
    itself for a text-only family."""
    es = extra_embed_shape(cfg, 1)
    if es is None:
        return batch
    tokens = batch["tokens"]
    return dict(batch, extra_embeds=torch.zeros(
        tuple(tokens.shape[:-1]) + es[1:], dtype=cfg.cdtype,
        device=tokens.device))


def _span_seconds(records: list, name: str, steps: int) -> list:
    out = [0.0] * steps
    for rec in records:
        if rec.get("kind") == "span" and rec["name"] == name \
                and rec.get("step", -1) < steps:
            out[rec["step"]] += rec["dur_us"] / 1e6
    return out


def run(argv: Optional[Sequence[str]] = None, *,
        log_fn=print) -> dict:
    """Train as the flags say; returns ``{"losses", "loss_grad_seconds",
    "optimizer_seconds", "probe_seconds", "dispatch_seconds",
    "resolve_seconds", "seconds", "peak_memory_bytes" (None off the
    card), "segment_names", "history", "probes" (the probe records,
    ``{"step", "lanczos/lambda_max", ...}``), "state", "model", "mesh",
    "placement" (the GSPMD path's, else None), "collectives" (the
    mesh's counts, seconds and bytes per collective)}``.
    Without ``--async-metrics`` the step spans synchronise the card and
    a probe reads its result back, so their times are device times;
    with it they are the host's."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    if args.global_batch is None:
        args.global_batch = args.batch
    if args.async_metrics < 0:
        raise SystemExit(f"--async-metrics {args.async_metrics} must be "
                         f">= 0")
    if args.layerwise_every < 0:
        raise SystemExit(f"--layerwise-every {args.layerwise_every} "
                         f"must be >= 0")
    mesh_data = args.mesh_data if args.mesh_data is not None \
        else args.data_parallel
    mesh_model = args.mesh_model if args.mesh_model is not None \
        else args.model_parallel
    if mesh_data < 1 or mesh_model < 1:
        raise SystemExit(f"--mesh-data {mesh_data} and --mesh-model "
                         f"{mesh_model} must be >= 1")
    # the mesh-native path (batch over ranks, params replicated) is
    # opted into by the explicit --mesh-data flag at --mesh-model 1; a
    # model axis or the legacy --data-parallel take the GSPMD path
    mesh_native = args.mesh_data is not None and mesh_data > 1 \
        and mesh_model == 1
    gspmd = mesh_model > 1 or (args.mesh_data is None and mesh_data > 1)
    if gspmd and args.adaptive_batch:
        raise SystemExit(
            "--adaptive-batch composes with the shard_map data axis only: "
            "pass --mesh-data (with --mesh-model 1); the GSPMD fsdp+TP "
            "path has no re-stack boundary")
    need = mesh_data * mesh_model
    if (mesh_native or gspmd) and not mesh_lib.joined():
        backend = args.dist_backend or mesh_lib.default_backend(
            args.device, need)
        if not mesh_lib.in_torchrun():
            log_fn(f"data_parallel={mesh_data} model_parallel={mesh_model} "
                   f"backend={backend}: spawning {need} ranks")
            return mesh_lib.spawn(_rank_run, need, backend,
                                  args.device, args=(argv,))[0]
        mesh_lib.join(backend, args.device)
        try:
            return run(argv, log_fn=log_fn)
        finally:
            mesh_lib.leave()
    microbatch = args.microbatch if args.microbatch is not None \
        else args.global_batch
    if args.global_batch < 1 or microbatch < 1:
        raise SystemExit(f"--global-batch {args.global_batch} and "
                         f"--microbatch {microbatch} must be >= 1")
    # adaptive runs start where the controller puts them, so only the
    # fixed mesh-native path divides the pull by the data width up front
    per_pull = microbatch * (
        mesh_data if mesh_native and not args.adaptive_batch else 1)
    if args.global_batch % per_pull:
        raise SystemExit(
            f"--global-batch {args.global_batch} must be divisible by "
            f"--microbatch x data width = {microbatch} x "
            f"{per_pull // microbatch} = {per_pull} (global batch is "
            f"K x D x per-device microbatch)")
    accum_steps = args.global_batch // per_pull
    mesh = mesh_lib.make_host_mesh(mesh_data, mesh_model) \
        if mesh_lib.joined() else None
    if mesh is not None and mesh.rank != 0:
        log_fn = _quiet
    dev = mesh_lib.placement_device(mesh, args.device)
    use_kernel = False if args.use_kernel == "off" else args.use_kernel
    if args.precision != "f32" and use_kernel != "fused":
        raise SystemExit(f"--precision {args.precision} requires "
                         f"--use-kernel fused")
    if args.probe_every < 0:
        raise SystemExit(f"--probe-every {args.probe_every} must be >= 0")
    if args.prefetch < 0:
        raise SystemExit(f"--prefetch {args.prefetch} must be >= 0")

    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    if cfg.family in ("ssm", "hybrid") and args.seq % cfg.ssm_chunk:
        raise SystemExit(f"--seq {args.seq} must be a multiple of "
                         f"ssm_chunk={cfg.ssm_chunk} for {args.arch}")
    model = get_model(cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    place = convert.placement(cfg, mesh) if gspmd else None
    params = model.init(0, device=dev, mesh=mesh, fsdp=True) if gspmd \
        else model.init(0, device=dev)
    tracer = obs_trace.Tracer()
    layerwise = args.layerwise_every > 0

    def optimizer_for(batch_size: int):
        # the LR rule and TVLARS's γ_min see the GLOBAL batch
        return build_optimizer(args.optimizer, total_steps=args.steps,
                               learning_rate=args.learning_rate,
                               batch_size=batch_size,
                               use_kernel=use_kernel,
                               precision=args.precision,
                               segments=model.segments, device=dev,
                               placement=place)

    def step_for(opt_, k: int, mesh_=mesh):
        return make_train_step(lm_task(model), opt_, accum_steps=k,
                               mesh=mesh_, placement=place,
                               layerwise=layerwise,
                               tracer=tracer,
                               sync_spans=args.async_metrics == 0)

    controller = None
    if args.adaptive_batch:
        if mesh_data & (mesh_data - 1):
            raise SystemExit(
                f"--adaptive-batch: --mesh-data {mesh_data} must be a "
                f"power of two (the controller snaps D to powers of "
                f"two)")
        batch_min = microbatch if args.batch_min is None \
            else args.batch_min
        batch_max = 4 * args.global_batch if args.batch_max is None \
            else args.batch_max
        # held noise-probe batch: stacked K >= 2 (the estimator contrasts
        # per-microbatch and accumulated gradient norms)
        k_probe = max(2, accum_steps)
        ptoks, plabels = lm_batch(torch.Generator().manual_seed(998),
                                  k_probe * microbatch, args.seq,
                                  cfg.vocab_size, device=dev)
        try:
            controller = AdaptiveBatchController(
                step_for, optimizer_for,
                probes.GradNoiseProbe(
                    lm_task(model), _stub_frontend(
                        cfg, pipeline.stack_microbatches(
                            {"tokens": ptoks, "labels": plabels},
                            k_probe)),
                    accum_steps=k_probe, every=args.controller_every),
                ControllerConfig(microbatch=microbatch,
                                 batch_min=batch_min, batch_max=batch_max,
                                 every=args.controller_every,
                                 data_max=mesh_data),
                init_batch=args.global_batch,
                base_lr=args.learning_rate)
        except ValueError as e:
            raise SystemExit(f"--adaptive-batch: {e}") from e
        opt = controller.optimizer()
        step_fn = None
        # sample-level stream: a K switch skips and re-reads nothing
        source = lm_sample_source(args.seq, cfg.vocab_size, seed=0,
                                  device=dev)
        batches = pipeline.MicrobatchedStream(
            lambda start, count: _stub_frontend(cfg, source(start, count)),
            microbatch, accum_steps=accum_steps)
    else:
        opt = optimizer_for(args.global_batch)
        step_fn = step_for(opt, accum_steps)
        batches = (_stub_frontend(cfg, b) for b in lm_iterator(
            args.global_batch, args.seq, cfg.vocab_size, seed=0,
            accum_steps=accum_steps, device=dev))
    if args.prefetch > 0:
        batches = pipeline.PrefetchingStream(batches, size=args.prefetch,
                                             tracer=tracer)
    state = TrainState.create(params, opt)
    if not gspmd:
        state = replicate(state, mesh)
    names = list(flatten.build_spec(params, segments=model.segments).names)
    callbacks = []
    if args.probe_every > 0:
        # held probe batch: a fixed seed, the run's [K, B/K, ...] stacking
        # (and so the training step's activation memory per microbatch)
        ptoks, plabels = lm_batch(torch.Generator().manual_seed(997),
                                  args.global_batch, args.seq,
                                  cfg.vocab_size, device=dev)
        callbacks.append(probes.LanczosProbe(
            lm_task(model), _stub_frontend(cfg, pipeline.stack_microbatches(
                {"tokens": ptoks, "labels": plabels}, accum_steps)),
            every=args.probe_every, num_iters=args.probe_iters,
            top_k=args.probe_topk, accum_steps=accum_steps,
            # mesh-native runs probe data-parallel too: per-shard HVPs,
            # averaged products, a replicated Krylov basis; GSPMD runs
            # probe the global batch on each rank's blocks (the
            # reference builds its probe with mesh=None there: the HVP
            # runs on the sharded params)
            mesh=mesh if mesh_native and controller is None else None,
            placement=place, reorth=not args.probe_no_reorth))
    rank0 = mesh is None or mesh.rank == 0
    memory = sinks.MemorySink()
    sink_list = [_Console(args.log_every, log_fn), memory]
    if args.metrics_out and rank0:
        static = {"arch": args.arch, "optimizer": args.optimizer}
        if controller is None:
            # an adaptive run's records carry the batch of their step
            static["global_batch"] = args.global_batch
        jsonl = sinks.JsonlSink(args.metrics_out, static=static)
        # with the ring, formatting and writing leave the step loop too
        sink_list.append(sinks.BufferedSink(jsonl)
                         if args.async_metrics > 0 else jsonl)
    profiler = obs_profiler.StepProfiler(
        args.profile_dir, start=args.profile_start,
        steps=args.profile_steps) if args.profile_dir and rank0 else None
    log_fn(f"{args.arch}{' (smoke)' if args.smoke else ''}: "
           f"{cfg.num_layers} layers, {cfg.param_dtype}; "
           f"optimizer={args.optimizer} use_kernel={args.use_kernel} "
           f"precision={args.precision} global_batch={args.global_batch} "
           f"microbatch={microbatch} accum_steps={accum_steps} "
           f"seq={args.seq} device={dev}"
           + (f" adaptive batch {controller.config.batch_min}.."
              f"{controller.config.batch_max} every "
              f"{controller.every}" if controller is not None else "")
           + (f" prefetch={args.prefetch}" if args.prefetch else "")
           + (f" async_metrics={args.async_metrics}"
              if args.async_metrics else ""))
    shape = mesh.shape if mesh is not None else {"data": 1, "model": 1}
    log_fn(f"global_batch={args.global_batch} microbatch={microbatch} "
           f"accum_steps={accum_steps} "
           f"data_parallel={mesh_data if mesh_native else 1} "
           f"mesh={tuple(shape.items())} "
           f"use_kernel={args.use_kernel} precision={args.precision}")
    if mesh is not None:
        log_fn(f"world={mesh.world} backend={mesh.backend} "
               f"device={mesh.device}")
    t0 = time.perf_counter()
    try:
        state, history = fit(step_fn, state, batches, args.steps,
                             options=FitOptions(
                                 sink=sinks.MultiSink(*sink_list),
                                 close_sink=True, callbacks=callbacks,
                                 tracer=tracer,
                                 layerwise_every=args.layerwise_every,
                                 layerwise_names=names,
                                 controller=controller,
                                 async_metrics=args.async_metrics,
                                 profiler=profiler,
                                 rank=0 if mesh is None else mesh.rank))
    finally:
        if isinstance(batches, pipeline.PrefetchingStream):
            batches.close()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    records = tracer.events()
    out = {
        "losses": [h["loss"] for h in history],
        "loss_grad_seconds": _span_seconds(records, "loss_grad",
                                           args.steps),
        "optimizer_seconds": _span_seconds(records, "optimizer",
                                           args.steps),
        "probe_seconds": _span_seconds(records, "probe", args.steps),
        "controller_seconds": _span_seconds(records, "controller",
                                            args.steps),
        "dispatch_seconds": _span_seconds(records, "dispatch",
                                          args.steps),
        "resolve_seconds": _span_seconds(records, "resolve", args.steps),
        "all_reduce_seconds": _span_seconds(records, "all_reduce",
                                            args.steps),
        "seconds": elapsed,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)
        if dev.type == "cuda" else None,
        "segment_names": names, "history": history,
        "probes": [r for r in memory.records if "loss" not in r
                   and "controller/changed" not in r],
        "controller_records": [r for r in memory.records
                               if "controller/changed" in r],
        "controller": controller, "global_batches": [
            h.get("global_batch", args.global_batch) for h in history],
        "state": state, "model": model, "mesh": mesh, "placement": place,
        "collectives": {} if mesh is None else {
            k: dict(v) for k, v in mesh.collectives.items()},
        "rank": 0 if mesh is None else mesh.rank,
        "world": 1 if mesh is None else mesh.world,
        "fingerprint": fingerprint(state),
    }
    if gspmd:
        if not replicas_equal(state, place, segments=model.segments):
            raise RuntimeError("ranks holding the same block of a leaf "
                               "differ after the run")
    # the data mesh (M = 1): every rank of the world, a rank past D
    # included, takes part in every step, so the check spans the world
    elif mesh is not None and not mesh_lib.all_equal(mesh,
                                                     out["fingerprint"]):
        raise RuntimeError("the ranks' states differ after the run")
    for i, (lg, op, pr, ct, ar) in enumerate(zip(
            out["loss_grad_seconds"], out["optimizer_seconds"],
            out["probe_seconds"], out["controller_seconds"],
            out["all_reduce_seconds"])):
        log_fn(f"step {i:4d} time: loss+grad {lg * 1e3:.1f} ms"
               + (f" (all-reduce {ar * 1e3:.1f} ms)"
                  if mesh is not None else "")
               + f", optimizer {op * 1e3:.1f} ms"
               + (f", probe {pr * 1e3:.1f} ms" if callbacks else "")
               + (f", controller {ct * 1e3:.1f} ms (global batch "
                  f"{int(out['global_batches'][i])})"
                  if controller is not None else ""))
    if out["peak_memory_bytes"] is not None:
        log_fn(f"peak device memory {out['peak_memory_bytes'] / 2**30:.2f} "
               f"GiB")
    if profiler is not None:
        log_fn(f"profile -> {args.profile_dir}")
    if args.metrics_out:
        log_fn(f"metrics -> {args.metrics_out} "
               f"({len(memory.records)} records)")
    if gspmd:
        log_fn(f"replicas bitwise equal: {mesh.world} ranks of a "
               f"{(mesh_data, mesh_model)} mesh, each block of a leaf "
               f"equal on the ranks that hold it")
    elif mesh is not None:
        log_fn(f"ranks bitwise equal: {mesh.world} ranks, state "
               f"fingerprint {out['fingerprint'][:2]}")
    if args.trace_out and rank0:
        with sinks.JsonlSink(args.trace_out) as trace_sink:
            n = tracer.export(trace_sink)
        log_fn(f"trace -> {args.trace_out} ({n} records)")
    if not all(torch.isfinite(torch.tensor(out["losses"]))):
        raise RuntimeError(f"non-finite loss: {out['losses']}")
    log_fn(f"done: {args.steps} steps in {elapsed:.1f} s, final loss "
           f"{out['losses'][-1]:.4f}")
    return out


def _quiet(*_args, **_kw) -> None:
    """The console of a rank other than 0."""


def _rank_run(argv: list) -> dict:
    """One spawned rank of ``run(argv)``: its numbers, without the
    state, model, controller, mesh and placement (rank 0's go back to
    the caller)."""
    out = run(argv)
    return {k: v for k, v in out.items()
            if k not in ("state", "model", "controller", "mesh",
                         "placement")}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
