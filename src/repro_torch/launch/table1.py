"""Table 1, classification half: the port of ``benchmarks/bench_table1.py``.

    PYTHONPATH=src python -m repro_torch.launch.table1 --device cpu \\
        --steps 10

trains the paper's MLP classifier (``launch.classify.run_classification``)
for every (batch, target LR) of :data:`GRID` with each optimizer of
:data:`OPTS`, writes ``table1.csv`` (optimizer, batch, lr, accuracy,
final_loss) and prints one line per run and the cells where TVLARS is
within 0.005 of WA-LARS or above it. With ``--use-kernel per_tensor``
only the optimizers of ``paper_io.PER_TENSOR_OPTS`` run, all through
the per-tensor LARS kernels. Samples come from the port's generators.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

from repro_torch import device as _device
from repro_torch.launch import classify, paper_io

GRID = {256: [0.3, 0.6], 512: [0.5, 1.0], 1024: [0.7, 1.4]}
# the paper's baselines and two extensions: NOWA-LARS (§3 ablation) and
# trust-clipped LARS (Fong et al. 2020)
OPTS = ["wa-lars", "nowa-lars", "lambc-lars", "lamb", "tvlars"]
STEPS = 80
COLUMNS = ["optimizer", "batch", "lr", "accuracy", "final_loss"]


def run(argv: Optional[Sequence[str]] = None, *, log_fn=print) -> dict:
    """Returns ``{"rows": [(optimizer, batch, lr, accuracy,
    final_loss)], "path", "wins", "cells"}`` (``wins`` None when the
    grid lacks TVLARS or WA-LARS)."""
    args = paper_io.parser(__doc__, steps=STEPS).parse_args(argv)
    dev = _device.resolve(args.device)
    opts = [o for o in OPTS if args.use_kernel != "per_tensor"
            or o in paper_io.PER_TENSOR_OPTS]
    rows = []
    for batch, lrs in GRID.items():
        for lr in lrs:
            for opt in opts:
                t0 = time.perf_counter()
                acc, hist, _ = classify.run_classification(
                    opt, batch, lr, steps=args.steps,
                    use_kernel=paper_io.kernel_for(opt, args.use_kernel),
                    device=dev)
                dt = (time.perf_counter() - t0) * 1e6
                rows.append((opt, batch, lr, round(acc, 4),
                             round(hist[-1]["loss"], 4)))
                paper_io.emit(log_fn, f"table1/{opt}/B{batch}/lr{lr}", dt,
                              f"acc={acc:.4f}")
    path = paper_io.write_csv(args.out_dir, "table1", COLUMNS, rows)
    by_cell: dict = {}
    for opt, b, lr, acc, _ in rows:
        by_cell.setdefault((b, lr), {})[opt] = acc
    wins = None
    if {"tvlars", "wa-lars"} <= set(opts):
        wins = sum(1 for cell in by_cell.values()
                   if cell["tvlars"] >= cell["wa-lars"] - 0.005)
        paper_io.emit(log_fn, "table1/summary", 0.0,
                      f"tvlars>=lars in {wins}/{len(by_cell)} cells -> "
                      f"{path}")
    return {"rows": rows, "path": path, "wins": wins,
            "cells": len(by_cell)}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
