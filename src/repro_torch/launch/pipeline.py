"""The instrumented training loop, synchronous against asynchronous: the
port of ``benchmarks/bench_pipeline.py``.

    PYTHONPATH=src python -m repro_torch.launch.pipeline --device cpu

Both loops train the paper loop's MLP classifier (``launch.classify``:
192 -> 128 -> 128 -> 32) at B = 256 with fused TVLARS, a Lanczos
sharpness probe every 10 steps (8 iterations on a held batch) and JSONL
logging. The synchronous loop reads every step's metrics back and
writes the JSONL file itself; the asynchronous one reads them
``RING`` = 8 steps late through ``fit``'s ``MetricRing`` (the probe is
dispatched at its step and resolved through the ring), draws batches
``PREFETCH`` = 2 ahead on a producer thread and writes the JSONL file
from a writer thread (``BufferedSink``). A bare loop (no probe, no
sink, no read-back) gives the floor.

Reported, as the bench's rows: µs per step of the bare, synchronous and
asynchronous loops and the sync / async ratio (the reference asserts
>= 1.3x on an overlap-capable host; here it is measured, not asserted);
the largest difference between the two loops' metrics (must be 0: the
ring reads the same tensors later); the segmented kernel launches per
step (must be 2 on the card, none in the probe); and the padded-token
waste of the variable-length LM source with and without length
bucketing. The JSONL files go to ``--out-dir``. Runs on CUDA unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import torch

from repro_torch import device as _device
from repro_torch.core import build_optimizer
from repro_torch.core.base import tree_map
from repro_torch.data.pipeline import LengthBucketedStream, PrefetchingStream
from repro_torch.data.synthetic import batch_iterator, lm_varlen_sample_source
from repro_torch.diagnostics import LanczosProbe
from repro_torch.diagnostics import sink as sink_lib
from repro_torch.kernels import ops
from repro_torch.launch.classify import BASE_BATCH, DATA, IN_DIM
from repro_torch.launch.paper_io import DEFAULT_OUT_DIR, emit
from repro_torch.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch.training import (FitOptions, TrainState, classifier_task,
                                  fit, make_train_step)

BATCH = 256
LR = 1.0
PROBE_EVERY = 10
RING = 8
PREFETCH = 2
STEPS = 300
SEGMENTED = ("seg_norm_lars", "seg_apply_lars")


def build(dev: torch.device) -> tuple:
    """``(task, optimizer, params, step, probe)`` of the bench."""
    task = classifier_task(apply_mlp_classifier)
    opt = build_optimizer("tvlars", total_steps=10_000, learning_rate=LR,
                          batch_size=BATCH, base_batch_size=BASE_BATCH,
                          use_kernel="fused", device=dev)
    params = init_mlp_classifier(0, in_dim=IN_DIM, num_classes=32,
                                 hidden=128, device=dev)
    probe = LanczosProbe(task, DATA.batch(
        torch.Generator(device=dev).manual_seed(7), BATCH),
        every=PROBE_EVERY, num_iters=8)
    return task, opt, params, make_train_step(task, opt), probe


def _copy(params):
    return tree_map(lambda p: p.detach().clone(), params)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_loop(step, opt, params, probe, *, steps: int, sync: bool,
             jsonl: str, dev: torch.device) -> tuple[float, list[dict]]:
    """One instrumented ``fit`` from a copy of ``params`` (the step
    updates them in place): ``(µs per step, history)``."""
    state = TrainState.create(_copy(params), opt)
    stream = batch_iterator(DATA, BATCH, seed=0, device=dev)
    base = sink_lib.JsonlSink(jsonl, static={"run": "pipeline"})
    if sync:
        sink = base
    else:
        stream = PrefetchingStream(stream, size=PREFETCH)
        sink = sink_lib.BufferedSink(base)
    _sync(dev)
    t0 = time.perf_counter()
    try:
        _, history = fit(step, state, stream, steps,
                         options=FitOptions(
                             sink=sink, callbacks=[probe],
                             async_metrics=False if sync else RING))
        _sync(dev)
    finally:
        sink.close()
        if isinstance(stream, PrefetchingStream):
            stream.close()
    elapsed = time.perf_counter() - t0
    sink_lib.validate_jsonl(jsonl)
    return elapsed / steps * 1e6, history


def max_metric_difference(a: list[dict], b: list[dict]) -> float:
    """Largest |a - b| over every metric of every step; raises when the
    records' steps or keys differ."""
    if len(a) != len(b):
        raise ValueError(f"{len(a)} records against {len(b)}")
    worst = 0.0
    for i, (x, y) in enumerate(zip(a, b)):
        if x.keys() != y.keys():
            raise ValueError(f"step {i}: keys {sorted(x)} != {sorted(y)}")
        for k in x:
            worst = max(worst, abs(float(x[k]) - float(y[k])))
    return worst


def bucketing(quick: bool, dev: torch.device) -> dict:
    """Padded-token waste of pad-to-max against length-bucketed
    batches of the variable-length LM source."""
    max_seq, micro = 64, 8
    n_batches = 20 if quick else 100
    src = lm_varlen_sample_source(max_seq, vocab=50, min_seq=4, device=dev)
    stream = LengthBucketedStream(src, microbatch=micro,
                                  boundaries=(16, 32, 64))
    bucketed_tok = real_tok = 0
    for _ in range(n_batches):
        b = next(stream)
        bucketed_tok += b["tokens"].numel()
        real_tok += int(b["length"].sum())
    flat_tok = n_batches * micro * max_seq
    return {"pad_waste_flat": 1 - real_tok / flat_tok,
            "pad_waste_bucketed": 1 - real_tok / bucketed_tok,
            "padded_token_ratio": flat_tok / bucketed_tok}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=STEPS,
                    help=f"timed steps per loop (default {STEPS})")
    ap.add_argument("--quick", action="store_true",
                    help="20 bucketing batches in place of 100")
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR)
    return ap


def run(argv: Optional[Sequence[str]] = None, *, log_fn=print) -> dict:
    """Run the bench as the flags say; returns ``{"bare_us", "sync_us",
    "async_us", "ratio", "max_abs_diff", "launches_per_step" (the
    segmented kernels' launches per timed step, 0 off the card),
    "bucketing", "histories"}``."""
    args = parser().parse_args(argv)
    dev = _device.resolve(args.device)
    if args.steps < PROBE_EVERY + 1:
        raise SystemExit(f"--steps {args.steps} must be > {PROBE_EVERY}")
    os.makedirs(args.out_dir, exist_ok=True)

    def jsonl(name):
        return os.path.join(args.out_dir, f"pipeline_{name}.jsonl")

    _, opt, params, step, probe = build(dev)
    # warm both loops (first calls, the producer thread)
    for sync in (True, False):
        run_loop(step, opt, params, probe, steps=PROBE_EVERY + 1,
                 sync=sync, jsonl=jsonl("warmup"), dev=dev)

    # the floor: dispatch only, no probe, no sink, no read-back
    state = TrainState.create(_copy(params), opt)
    it = batch_iterator(DATA, BATCH, seed=0, device=dev)
    batch = next(it)
    state, m = step(state, batch)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, m = step(state, batch)
        batch = next(it)
    _sync(dev)
    bare_us = (time.perf_counter() - t0) / args.steps * 1e6

    before = {k: ops.launches[k] for k in SEGMENTED}
    sync_us, sync_h = run_loop(step, opt, params, probe, steps=args.steps,
                               sync=True, jsonl=jsonl("sync"), dev=dev)
    async_us, async_h = run_loop(step, opt, params, probe,
                                 steps=args.steps, sync=False,
                                 jsonl=jsonl("async"), dev=dev)
    per_step = {k: (ops.launches[k] - before[k]) / (2 * args.steps)
                for k in SEGMENTED}
    worst = max_metric_difference(sync_h, async_h)
    buckets = bucketing(args.quick, dev)
    out = {"bare_us": bare_us, "sync_us": sync_us, "async_us": async_us,
           "ratio": sync_us / async_us, "max_abs_diff": worst,
           "launches_per_step": per_step, "bucketing": buckets,
           "histories": (sync_h, async_h)}
    emit(log_fn, "pipeline/step_bare", bare_us, f"steps={args.steps}")
    emit(log_fn, "pipeline/step_sync", sync_us,
         f"probe_every={PROBE_EVERY} launches_per_step={per_step}")
    emit(log_fn, "pipeline/step_async", async_us,
         f"ring={RING} prefetch={PREFETCH}")
    emit(log_fn, "pipeline/overlap_ratio", 0.0,
         f"sync/async={out['ratio']:.3f} metric_max_abs_diff={worst} "
         f"device={dev}")
    emit(log_fn, "pipeline/bucketing", 0.0, " ".join(
        f"{k}={v:.3f}" for k, v in buckets.items()))
    if worst != 0.0:
        raise RuntimeError(f"async metrics differ from sync by {worst}")
    return out


def main() -> None:
    run()


if __name__ == "__main__":
    main()
