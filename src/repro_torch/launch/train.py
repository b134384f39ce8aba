"""Training launcher: the single-device port of ``repro.launch.train``.

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
the card) as trace-v1 JSONL. Runs on CUDA unless ``--device cpu``.

:func:`run` is the entry point for programs (``chip_smoke.py``): it
takes the argument list and returns the run's numbers and final state.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import torch

from repro_torch import device as _device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import build_optimizer
from repro_torch.core import flatten
from repro_torch.core.layerwise import PRECISIONS
from repro_torch.data.synthetic import lm_iterator
from repro_torch.models import get_model
from repro_torch.obs import trace as obs_trace
from repro_torch.training import (FitOptions, TrainState, fit, lm_task,
                                  make_train_step)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2.5-3b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--optimizer", default="tvlars")
    ap.add_argument("--learning-rate", type=float, default=2.0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8,
                    help="total samples per optimizer step")
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
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def _write_trace(path: str, records: list) -> None:
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        for rec in records:
            rec = dict(rec)
            f.write(json.dumps({"step": rec.pop("step", 0), **rec}) + "\n")


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
    "optimizer_seconds", "seconds", "peak_memory_bytes" (None off the
    card), "segment_names", "history", "state", "model"}``. The step
    spans synchronise the card, so their times are device times."""
    args = parser().parse_args(argv)
    if args.layerwise_every < 0:
        raise SystemExit(f"--layerwise-every {args.layerwise_every} "
                         f"must be >= 0")
    dev = _device.resolve(args.device)
    microbatch = args.microbatch or args.global_batch
    if args.global_batch < 1 or microbatch < 1 \
            or args.global_batch % microbatch:
        raise SystemExit(f"--global-batch {args.global_batch} must be a "
                         f"positive multiple of --microbatch {microbatch}")
    accum_steps = args.global_batch // microbatch
    use_kernel = False if args.use_kernel == "off" else args.use_kernel
    if args.precision != "f32" and use_kernel != "fused":
        raise SystemExit(f"--precision {args.precision} requires "
                         f"--use-kernel fused")

    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    model = get_model(cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = model.init(0, device=dev)
    opt = build_optimizer(args.optimizer, total_steps=args.steps,
                          learning_rate=args.learning_rate,
                          batch_size=args.global_batch,
                          use_kernel=use_kernel, precision=args.precision,
                          segments=model.segments, device=dev)
    state = TrainState.create(params, opt)
    tracer = obs_trace.Tracer()
    layerwise = args.layerwise_every > 0
    step_fn = make_train_step(lm_task(model), opt, accum_steps=accum_steps,
                              layerwise=layerwise, tracer=tracer)
    batches = lm_iterator(args.global_batch, args.seq, cfg.vocab_size,
                          seed=0, accum_steps=accum_steps, device=dev)
    names = list(flatten.build_spec(params, segments=model.segments).names)
    log_fn(f"{args.arch}{' (smoke)' if args.smoke else ''}: "
           f"{cfg.num_layers} layers, {cfg.param_dtype}; "
           f"optimizer={args.optimizer} use_kernel={args.use_kernel} "
           f"precision={args.precision} global_batch={args.global_batch} "
           f"microbatch={microbatch} accum_steps={accum_steps} "
           f"seq={args.seq} device={dev}")
    t0 = time.perf_counter()
    state, history = fit(step_fn, state, batches, args.steps,
                         options=FitOptions(
                             log_every=args.log_every, log_fn=log_fn,
                             tracer=tracer,
                             layerwise_every=args.layerwise_every,
                             layerwise_names=names))
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
        "seconds": elapsed,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)
        if dev.type == "cuda" else None,
        "segment_names": names, "history": history, "state": state,
        "model": model,
    }
    for i, (lg, op) in enumerate(zip(out["loss_grad_seconds"],
                                     out["optimizer_seconds"])):
        log_fn(f"step {i:4d} time: loss+grad {lg * 1e3:.1f} ms, "
               f"optimizer {op * 1e3:.1f} ms")
    if out["peak_memory_bytes"] is not None:
        log_fn(f"peak device memory {out['peak_memory_bytes'] / 2**30:.2f} "
               f"GiB")
    if args.trace_out:
        _write_trace(args.trace_out, records)
        log_fn(f"trace -> {args.trace_out} ({len(records)} records)")
    if not all(torch.isfinite(torch.tensor(out["losses"]))):
        raise RuntimeError(f"non-finite loss: {out['losses']}")
    log_fn(f"done: {args.steps} steps in {elapsed:.1f} s, final loss "
           f"{out['losses'][-1]:.4f}")
    return out


def main() -> None:
    run()


if __name__ == "__main__":
    main()
