"""Early-phase sharpness, WA-LARS against TVLARS: the port of
``benchmarks/bench_sharpness.py``.

    PYTHONPATH=src python -m repro_torch.launch.sharpness --device cpu

The paper's narrative is that LARS with warm-up "gets trapped in sharp
minimizers early on" while TVLARS's large early learning rate
"promotes gradient exploration". This trains the paper loop's MLP
classifier (``launch.classify``: 32 classes of 8×8×3 images, MLP 192 →
128 → 128 → 32) at B = 256, LR 1.0 for 40 steps with both optimizers,
probing the top Hessian eigenvalue (8 Lanczos iterations on a held
batch of 128) and the SAM sharpness every 5 steps. Each optimizer's
metric stream and probe trace goes to ``sharpness_{opt}.jsonl`` under
``--out`` (schema-validated). At the end of each run the Hessian gets
the full stochastic-Lanczos-quadrature treatment (4 seeds × 16
iterations, a 64-point grid), written to ``sharpness_slq_{opt}.jsonl``.
Prints each optimizer's mean λ_max over the early phase (the first
fifth of the probes, plus one) and their ratio (> 1: warm-up LARS sits
in sharper curvature early). Runs on CUDA unless ``--device cpu``.

The data, weights and Lanczos seeds come from the port's generators:
the same distributions as the JAX package's bench, other samples.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import torch

from repro_torch import device as _device
from repro_torch.core import build_optimizer
from repro_torch.data.synthetic import batch_iterator
from repro_torch.diagnostics import (LanczosProbe, SharpnessProbe, hvp,
                                     slq_spectral_density)
from repro_torch.diagnostics import sink as sink_lib
from repro_torch.launch.classify import BASE_BATCH, DATA, IN_DIM
from repro_torch.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch.training import (FitOptions, TrainState, classifier_task,
                                  fit, make_train_step)

BATCH = 256
LR = 1.0
STEPS = 40
PROBE_EVERY = 5
LANCZOS_ITERS = 8
SLQ_SEEDS = 4
SLQ_ITERS = 16
SLQ_GRID = 64
OPTS = ("wa-lars", "tvlars")   # LARS + warm-up vs the contribution


def _trajectory(path: str) -> list[tuple[int, float]]:
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [(r["step"], r["lanczos/lambda_max"]) for r in recs
            if "lanczos/lambda_max" in r]


def run_one(opt_name: str, out_dir: str, *, steps: int = STEPS,
            device="cuda"):
    """Train one optimizer with the probes; returns ``(jsonl path,
    final state, task, probe batch)``."""
    dev = _device.resolve(device)
    params = init_mlp_classifier(0, in_dim=IN_DIM, num_classes=32,
                                 hidden=128, device=dev)
    opt = build_optimizer(opt_name, total_steps=steps, learning_rate=LR,
                          batch_size=BATCH, base_batch_size=BASE_BATCH)
    state = TrainState.create(params, opt)
    task = classifier_task(apply_mlp_classifier)
    probe_batch = DATA.batch(torch.Generator(device=dev).manual_seed(777),
                             128)
    path = os.path.join(out_dir, f"sharpness_{opt_name}.jsonl")
    with sink_lib.JsonlSink(path, static={"optimizer": opt_name}) as sink:
        state, _ = fit(make_train_step(task, opt), state,
                       batch_iterator(DATA, BATCH, device=dev), steps,
                       options=FitOptions(sink=sink, callbacks=[
                           LanczosProbe(task, probe_batch,
                                        every=PROBE_EVERY,
                                        num_iters=LANCZOS_ITERS, top_k=1),
                           SharpnessProbe(task, probe_batch,
                                          every=PROBE_EVERY),
                       ]))
    sink_lib.validate_jsonl(path)
    return path, state, task, probe_batch


def slq_density(opt_name: str, out_dir: str, state, task, probe_batch, *,
                step: int) -> str:
    """End-of-run SLQ spectral density -> one JSONL record
    (grid/density lists, the largest Ritz value, sigma)."""
    op = hvp.make_flat_hvp(task, state.params, probe_batch)
    dev = probe_batch[0].device
    mask = hvp.padding_mask(op.spec, dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    v0s = mask[None] * torch.randn((SLQ_SEEDS,) + tuple(mask.shape),
                                   generator=gen, device=dev)
    # grid=None: the library brackets the observed Ritz range itself
    slq = slq_spectral_density(op.matvec, v0s, SLQ_ITERS,
                               grid_points=SLQ_GRID)
    path = os.path.join(out_dir, f"sharpness_slq_{opt_name}.jsonl")
    with sink_lib.JsonlSink(path, static={"optimizer": opt_name}) as sink:
        sink.write(step, {
            "grid": [float(x) for x in slq.grid],
            "density": [float(x) for x in slq.density],
            "ritz_max": float(slq.ritz.max()),
            "sigma": float(slq.sigma),
            "num_seeds": SLQ_SEEDS, "num_iters": SLQ_ITERS,
        }, last=True)
    sink_lib.validate_jsonl(path)
    return path


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--out", default=os.path.join("experiments",
                                                  "sharpness"),
                    help="directory for the JSONL files")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def run(argv: Optional[Sequence[str]] = None, *, log_fn=print) -> dict:
    """Run both optimizers as the flags say; returns ``{"early": {opt:
    mean early λ_max}, "ratio": WA-LARS / TVLARS, "trajectories": {opt:
    [(step, λ_max)]}, "paths": {opt: [metrics path, SLQ path]}}``."""
    args = parser().parse_args(argv)
    dev = _device.resolve(args.device)
    os.makedirs(args.out, exist_ok=True)
    out: dict = {"early": {}, "trajectories": {}, "paths": {}}
    for opt_name in OPTS:
        path, state, task, probe_batch = run_one(
            opt_name, args.out, steps=args.steps, device=dev)
        traj = _trajectory(path)
        if not traj:
            raise RuntimeError(f"no lambda_max records in {path}")
        lams = [lam for _, lam in traj]
        # "early phase" = the warm-up window (first 1/5 of training)
        n_early = max(1, len(lams) // 5 + 1)
        out["early"][opt_name] = sum(lams[:n_early]) / n_early
        out["trajectories"][opt_name] = traj
        slq_path = slq_density(opt_name, args.out, state, task,
                               probe_batch, step=args.steps - 1)
        out["paths"][opt_name] = [path, slq_path]
        log_fn(f"sharpness/{opt_name}: lam0={lams[0]:.3f} "
               f"lam_final={lams[-1]:.3f} n_probes={len(lams)} "
               f"early mean={out['early'][opt_name]:.4f} -> {path}; SLQ "
               f"{SLQ_SEEDS} seeds x {SLQ_ITERS} iters -> {slq_path}")
    out["ratio"] = out["early"]["wa-lars"] / max(out["early"]["tvlars"],
                                                 1e-12)
    log_fn(f"sharpness/early_lam_ratio_wa_vs_tvlars: {out['ratio']:.3f} "
           f"(>1 means warm-up LARS sits in sharper curvature early, the "
           f"paper's trap story)")
    return out


def main() -> None:
    run()


if __name__ == "__main__":
    main()
