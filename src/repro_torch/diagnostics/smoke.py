"""Probe smoke: tiny MLP + 2-iteration Lanczos + JSONL schema check,
the port of ``repro.diagnostics.smoke``.

    PYTHONPATH=src python -m repro_torch.diagnostics.smoke --device cpu

Trains a tiny MLP classifier for a few steps with a LanczosProbe and a
SharpnessProbe streaming into a JSONL sink — with a span
:class:`~repro_torch.obs.trace.Tracer` on the fit loop — then
schema-validates the metrics file, asserts the probe emitted a finite
λ_max every scheduled step, exports the trace as trace-v1 JSONL and
schema-validates that (including the per-step ``data_wait`` /
``dispatch`` / ``resolve`` and probe spans). Runs on CUDA unless
``--device cpu``. Exit code 0 = the subsystem works end to end.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import tempfile

import torch

from repro_torch import device as _device
from repro_torch.core import build_optimizer
from repro_torch.data.synthetic import ClassificationData, batch_iterator
from repro_torch.diagnostics import probes, sink as sink_lib
from repro_torch.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch.obs import trace as obs_trace
from repro_torch.training import (FitOptions, TrainState, classifier_task,
                                  fit, make_train_step)


def run(out_dir: str, *, steps: int = 4, probe_every: int = 2,
        num_iters: int = 2, device="cuda") -> str:
    """Run the smoke; returns the JSONL path (raises on any failure)."""
    dev = _device.resolve(device)
    data = ClassificationData(num_classes=4, image_size=8, seed=0)
    params = init_mlp_classifier(0, in_dim=8 * 8 * 3, num_classes=4,
                                 hidden=16, depth=2, device=dev)
    opt = build_optimizer("tvlars", total_steps=steps, learning_rate=0.5)
    state = TrainState.create(params, opt)
    task = classifier_task(apply_mlp_classifier)
    probe_batch = data.batch(torch.Generator(device=dev).manual_seed(99),
                             16)
    path = os.path.join(out_dir, "probe_smoke.jsonl")
    tracer = obs_trace.Tracer()
    with sink_lib.JsonlSink(path, static={"run": "smoke"}) as sink:
        fit(make_train_step(task, opt), state,
            batch_iterator(data, 16, device=dev), steps,
            options=FitOptions(sink=sink, tracer=tracer, callbacks=[
                probes.LanczosProbe(task, probe_batch, every=probe_every,
                                    num_iters=num_iters, top_k=1),
                probes.SharpnessProbe(task, probe_batch,
                                      every=probe_every),
            ]))

    n = sink_lib.validate_jsonl(path)
    expected_probe_steps = len(range(0, steps, probe_every))
    with open(path) as f:
        lam = [r["lanczos/lambda_max"] for r in map(json.loads, f)
               if "lanczos/lambda_max" in r]
    if len(lam) != expected_probe_steps:
        raise AssertionError(
            f"expected {expected_probe_steps} lambda_max records, "
            f"got {len(lam)} (of {n} total)")
    if not all(x is not None and math.isfinite(x) for x in lam):
        raise AssertionError(f"non-finite lambda_max in trace: {lam}")

    # trace smoke: export the loop's spans and schema-validate them
    trace_path = os.path.join(out_dir, "trace_smoke.jsonl")
    with sink_lib.JsonlSink(trace_path) as tsink:
        tracer.export(tsink)
    _, n_trace = sink_lib.validate_jsonl(trace_path, counts=True)
    with open(trace_path) as f:
        names = {r["name"] for r in map(json.loads, f)}
    # every step records its three loop phases (+ probe spans on the
    # scheduled steps)
    missing = {"data_wait", "dispatch", "resolve", "probe"} - names
    if missing:
        raise AssertionError(
            f"trace smoke: expected span names missing: {sorted(missing)} "
            f"(got {sorted(names)})")
    if n_trace < 3 * steps:
        raise AssertionError(
            f"trace smoke: {n_trace} trace records < {3 * steps} "
            f"(3 loop spans x {steps} steps)")
    print(f"probe smoke ({dev}): OK — {n} JSONL records, "
          f"{len(lam)} λ_max probes (last={lam[-1]:.4f}) -> {path}; "
          f"{n_trace} trace spans -> {trace_path}")
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None,
                    help="output dir (default: fresh tempdir)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--probe-every", type=int, default=2)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    kw = dict(steps=args.steps, probe_every=args.probe_every,
              num_iters=args.iters, device=args.device)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        run(args.out, **kw)
    else:
        with tempfile.TemporaryDirectory() as td:
            run(td, **kw)


if __name__ == "__main__":
    main()
