"""Adaptive batch size, the McCandlish schedule against fixed-B runs:
the port of ``benchmarks/bench_adaptive_batch.py``.

    PYTHONPATH=src python -m repro_torch.launch.adaptive_batch \\
        --device cpu --steps 20

The gradient noise scale (small while gradients are large and aligned,
growing as ‖G‖² shrinks) drives the global batch through
``training.controller.AdaptiveBatchController``, with the LR re-scaled
to the current batch at every switch. Three runs of the paper's MLP
classifier:

* ``wa-lars``  — fixed global batch :data:`BATCH_MAX`;
* ``tvlars``   — fixed global batch :data:`BATCH_MAX`;
* ``adaptive`` — TVLARS and the controller, the batch free in
  ``[MICROBATCH, BATCH_MAX]`` at a fixed microbatch, fed by the
  sample-indexed ``classification_sample_source``.

Each run streams its steps and the controller's decisions to
``adaptive_batch_{name}.jsonl`` in ``--out-dir`` (validated); the
adaptive run must switch at least once, each switch record carrying
``controller/lr`` equal to ``schedules.batch_scaled_lr`` at its batch.
"""
from __future__ import annotations

import json
import math
import os
from typing import Optional, Sequence

import torch

from repro_torch import device as _device
from repro_torch.core import build_optimizer, schedules
from repro_torch.data.pipeline import MicrobatchedStream, stack_microbatches
from repro_torch.data.synthetic import classification_sample_source
from repro_torch.diagnostics import GradNoiseProbe
from repro_torch.diagnostics import sink as sink_lib
from repro_torch.launch import classify, paper_io
from repro_torch.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch.training import (AdaptiveBatchController, ControllerConfig,
                                  FitOptions, TrainState, classifier_task,
                                  fit, make_train_step)

MICROBATCH = 16
BATCH_MAX = 256
LR = 1.0
STEPS = 60
EVERY = 5
PROBE_K = 8
FIXED = ("wa-lars", "tvlars")


def _init_params(dev):
    return init_mlp_classifier(0, in_dim=classify.IN_DIM, num_classes=32,
                               hidden=128, device=dev)


def _optimizer(name: str, batch: int, steps: int, use_kernel: str, dev):
    return build_optimizer(name, total_steps=steps, learning_rate=LR,
                           batch_size=batch,
                           base_batch_size=classify.BASE_BATCH,
                           use_kernel=paper_io.kernel_for(name, use_kernel),
                           device=dev)


def run_fixed(name: str, *, steps: int, use_kernel: str, dev,
              out_dir: str) -> tuple[float, str]:
    """A fixed-B run at the adaptive run's batch ceiling; returns (eval
    accuracy, JSONL path)."""
    opt = _optimizer(name, BATCH_MAX, steps, use_kernel, dev)
    state = TrainState.create(_init_params(dev), opt)
    task = classifier_task(apply_mlp_classifier)
    path = os.path.join(out_dir, f"adaptive_batch_{name}.jsonl")
    with sink_lib.JsonlSink(path, static={"run": name,
                                          "global_batch": BATCH_MAX}) as s:
        state, _ = fit(make_train_step(task, opt), state,
                       classify.batch_iterator(classify.DATA, BATCH_MAX,
                                               device=dev), steps,
                       options=FitOptions(sink=s))
    sink_lib.validate_jsonl(path)
    return classify._accuracy(apply_mlp_classifier, state.params, dev), path


def run_adaptive(*, steps: int, use_kernel: str, dev, out_dir: str
                 ) -> tuple[float, str, AdaptiveBatchController]:
    """TVLARS with the controller; returns (eval accuracy, JSONL path,
    controller)."""
    task = classifier_task(apply_mlp_classifier)
    cfg = ControllerConfig(microbatch=MICROBATCH, batch_min=MICROBATCH,
                           batch_max=BATCH_MAX, every=EVERY)
    probe_batch = stack_microbatches(classify.DATA.batch(
        torch.Generator(device=dev).manual_seed(777),
        PROBE_K * MICROBATCH, classify.DATA.class_means(dev)), PROBE_K)
    ctrl = AdaptiveBatchController(
        lambda opt, k: make_train_step(task, opt, accum_steps=k),
        lambda b: _optimizer("tvlars", b, steps, use_kernel, dev),
        GradNoiseProbe(task, probe_batch, accum_steps=PROBE_K,
                       every=EVERY),
        cfg, base_lr=LR, base_batch_size=classify.BASE_BATCH)
    state = TrainState.create(_init_params(dev), ctrl.optimizer())
    stream = MicrobatchedStream(
        classification_sample_source(classify.DATA, device=dev),
        microbatch=MICROBATCH, accum_steps=1)
    path = os.path.join(out_dir, "adaptive_batch_adaptive.jsonl")
    with sink_lib.JsonlSink(path, static={"run": "adaptive"}) as s:
        state, _ = fit(None, state, stream, steps,
                       options=FitOptions(sink=s, controller=ctrl))
    sink_lib.validate_jsonl(path)
    return (classify._accuracy(apply_mlp_classifier, state.params, dev),
            path, ctrl)


def controller_switches(path: str) -> list[dict]:
    """The controller records where the batch changed; each must carry
    the LR of ``batch_scaled_lr`` at its new batch."""
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    switches = [r for r in recs if r.get("controller/changed") == 1.0]
    for s in switches:
        want = schedules.batch_scaled_lr(
            LR, int(s["controller/global_batch"]), classify.BASE_BATCH)
        if not math.isclose(s["controller/lr"], want, rel_tol=1e-12):
            raise RuntimeError(f"switch at step {s['step']}: "
                               f"controller/lr {s['controller/lr']}, "
                               f"batch_scaled_lr gives {want}")
    return switches


def run(argv: Optional[Sequence[str]] = None, *, log_fn=print) -> dict:
    """Returns ``{"accuracy": {run: acc}, "switches": [records],
    "visited_ks", "compiles", "paths"}``; raises if the adaptive run
    never switched."""
    args = paper_io.parser(__doc__, steps=STEPS).parse_args(argv)
    dev = _device.resolve(args.device)
    acc, paths = {}, {}
    for name in FIXED:
        acc[name], paths[name] = run_fixed(name, steps=args.steps,
                                           use_kernel=args.use_kernel,
                                           dev=dev, out_dir=args.out_dir)
        paper_io.emit(log_fn, f"adaptive_batch/{name}-fixedB{BATCH_MAX}",
                      0.0, f"acc={acc[name]:.3f}")
    acc["adaptive"], paths["adaptive"], ctrl = run_adaptive(
        steps=args.steps, use_kernel=args.use_kernel, dev=dev,
        out_dir=args.out_dir)
    switches = controller_switches(paths["adaptive"])
    if not switches:
        raise RuntimeError(
            f"adaptive run made no controller-initiated batch change "
            f"(visited Ks {ctrl.visited_ks}); see {paths['adaptive']}")
    batches = [int(s["controller/global_batch"]) for s in switches]
    paper_io.emit(log_fn, f"adaptive_batch/adaptive-B{MICROBATCH}.."
                  f"{BATCH_MAX}", 0.0,
                  f"acc={acc['adaptive']:.3f} switches={len(switches)} "
                  f"batches={batches} visited_K={list(ctrl.visited_ks)} "
                  f"compiles={ctrl.compiles}")
    return {"accuracy": acc, "switches": switches,
            "visited_ks": ctrl.visited_ks, "compiles": ctrl.compiles,
            "paths": paths}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
