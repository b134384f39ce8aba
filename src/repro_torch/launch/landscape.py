"""2-D filter-normalized loss landscape between a WA-LARS and a TVLARS
checkpoint: the port of ``benchmarks/bench_landscape.py``.

    PYTHONPATH=src python -m repro_torch.launch.landscape --device cpu

The paper's geometric claim, that warm-up LARS parks in sharper basins
than TVLARS, rendered the Li et al. (2018) way: train both optimizers
from the same init (the paper loop's MLP classifier at B = 256, LR 1.0,
40 steps), checkpoint both endpoints through
:mod:`repro_torch.checkpoint` (the JAX package's format), restore them,
and evaluate the loss on the plane spanned by d₁, the WA-LARS ->
TVLARS direction (α = 0 is the WA-LARS checkpoint, α = 1 the TVLARS
one), and d₂, a filter-normalized random direction. The 9 × 7 grid
(α in [-0.5, 1.5], β in [-1, 1]) is one
``diagnostics.landscape.loss_slice_2d`` call on a held batch of 256,
written as ``landscape_2d.csv`` (``step, alpha, beta, loss``) under
``--out-dir``, with the checkpoints beside it. Prints the two endpoint
losses and the barrier (the highest point of the β = 0 segment between
them above the higher endpoint). Runs on CUDA unless ``--device cpu``.

Weights, data and the random direction come from the port's
generators: the bench's distributions, other samples.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional, Sequence

import torch

from repro_torch import checkpoint
from repro_torch import device as _device
from repro_torch.core import build_optimizer
from repro_torch.data.synthetic import batch_iterator
from repro_torch.diagnostics import landscape
from repro_torch.diagnostics import sink as sink_lib
from repro_torch.launch import paper_io
from repro_torch.launch.classify import BASE_BATCH, DATA, IN_DIM
from repro_torch.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch.training import (TrainState, classifier_task, fit,
                                  make_train_step)

BATCH = 256
LR = 1.0
STEPS = 40
ALPHAS = torch.linspace(-0.5, 1.5, 9)   # 0 = WA-LARS, 1 = TVLARS ckpt
BETAS = torch.linspace(-1.0, 1.0, 7)
OPTS = ("wa-lars", "tvlars")


def _init(dev):
    return init_mlp_classifier(0, in_dim=IN_DIM, num_classes=32,
                               hidden=128, device=dev)


def train_and_checkpoint(opt_name: str, out_dir: str, *, steps: int,
                         dev: torch.device) -> str:
    """Train ``opt_name`` from the shared init; returns the checkpoint
    directory of its final params."""
    params = _init(dev)
    opt = build_optimizer(opt_name, total_steps=steps, learning_rate=LR,
                          batch_size=BATCH, base_batch_size=BASE_BATCH)
    state = TrainState.create(params, opt)
    task = classifier_task(apply_mlp_classifier)
    state, _ = fit(make_train_step(task, opt), state,
                   batch_iterator(DATA, BATCH, device=dev), steps)
    ckpt = os.path.join(out_dir, f"landscape_ckpt_{opt_name}")
    shutil.rmtree(ckpt, ignore_errors=True)
    checkpoint.save(ckpt, state.params, step=steps)
    return ckpt


def run(argv: Optional[Sequence[str]] = None, *, log_fn=print) -> dict:
    """Run the bench as the flags say; returns ``{"grid" ([9, 7] f32 on
    the host), "endpoints": (loss at WA-LARS, loss at TVLARS),
    "barrier", "csv", "checkpoints": {opt: dir}, "params": {opt:
    restored params}}``."""
    args = paper_io.parser(__doc__, steps=STEPS,
                           use_kernel=False).parse_args(argv)
    dev = _device.resolve(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    ckpts = {o: train_and_checkpoint(o, args.out_dir, steps=args.steps,
                                     dev=dev) for o in OPTS}
    template = _init(dev)
    params = {o: checkpoint.restore(ckpts[o], template, device=dev)
              for o in OPTS}

    task = classifier_task(apply_mlp_classifier)
    batch = DATA.batch(torch.Generator(device=dev).manual_seed(777), 256)
    d1 = landscape.direction_between(params["wa-lars"], params["tvlars"])
    d2 = landscape.filter_normalized_direction(
        torch.Generator(device=dev).manual_seed(7), params["wa-lars"])
    grid = landscape.loss_slice_2d(task, params["wa-lars"], d1, d2, batch,
                                   ALPHAS.tolist(), BETAS.tolist()).cpu()

    path = os.path.join(args.out_dir, "landscape_2d.csv")
    with sink_lib.CsvSink(path) as sink:
        i = 0
        for ai, a in enumerate(ALPHAS.tolist()):
            for bi, b in enumerate(BETAS.tolist()):
                sink.write(i, {"alpha": a, "beta": b,
                               "loss": float(grid[ai, bi])},
                           last=(ai == len(ALPHAS) - 1
                                 and bi == len(BETAS) - 1))
                i += 1

    # the β = 0 row is the 1-D WA-LARS -> TVLARS slice; its interior
    # maximum is the barrier between the two basins
    b0 = int(torch.argmin(BETAS.abs()))
    a0 = int(torch.argmin(ALPHAS.abs()))
    a1 = int(torch.argmin((ALPHAS - 1.0).abs()))
    line = grid[min(a0, a1): max(a0, a1) + 1, b0]
    barrier = float(line.max() - max(line[0], line[-1]))
    endpoints = (float(grid[a0, b0]), float(grid[a1, b0]))
    paper_io.emit(log_fn, "landscape/endpoints", 0.0,
                  f"loss(wa-lars)={endpoints[0]:.4f} "
                  f"loss(tvlars)={endpoints[1]:.4f}")
    paper_io.emit(log_fn, "landscape/barrier", 0.0,
                  f"{barrier:.4f} (max ridge above the higher endpoint "
                  f"on the WA-LARS->TVLARS segment) "
                  f"grid={tuple(grid.shape)} -> {path}")
    return {"grid": grid, "endpoints": endpoints, "barrier": barrier,
            "csv": path, "checkpoints": ckpts, "params": params}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
