"""Figures 1 and 4: the warm-up and polynomial LR curves and TVLARS's
φ_t family; the port of ``benchmarks/bench_schedules.py``.

    PYTHONPATH=src python -m repro_torch.launch.schedules --device cpu

Evaluates ``core.schedules`` on ``--device`` every 10 steps of
``--steps`` (default 1000, delay 200) and writes
``schedules_fig1_fig4.csv`` (step, warmup_cosine, polynomial,
tvlars_1e-2 .. tvlars_1e-5); prints the mean LR of the first 20 steps
under warm-up and under TVLARS (λ 1e-3), the contrast of Fig. 1. It
trains nothing, so it takes no ``--use-kernel``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch import device as _device
from repro_torch.core import schedules
from repro_torch.launch import paper_io

TOTAL = 1000
DELAY = 200
LAMBDAS = (1e-2, 5e-3, 1e-3, 1e-4, 1e-5)
COLUMNS = ["step", "warmup_cosine", "polynomial", "tvlars_1e-2",
           "tvlars_5e-3", "tvlars_1e-3", "tvlars_1e-4", "tvlars_1e-5"]


def run(argv: Optional[Sequence[str]] = None, *, log_fn=print) -> dict:
    """Returns ``{"rows", "path", "warmup_head_lr", "tvlars_head_lr"}``."""
    args = paper_io.parser(__doc__, steps=TOTAL,
                           use_kernel=False).parse_args(argv)
    dev = _device.resolve(args.device)
    total = args.steps

    def at(f, t: int) -> float:
        return float(f(torch.tensor(t, dtype=torch.int32, device=dev)))

    wa = schedules.warmup_cosine(1.0, DELAY, total)
    poly = schedules.polynomial(1.0, total)
    phis = [schedules.tvlars_phi(lam, DELAY, 1.0, 1e-3) for lam in LAMBDAS]
    rows = []
    for t in range(0, total + 1, 10):
        rows.append(tuple([t, at(wa, t), at(poly, t)]
                          + [at(f, t) for f in phis]))
    path = paper_io.write_csv(args.out_dir, "schedules_fig1_fig4", COLUMNS,
                              rows)
    wa_head = sum(at(wa, t) for t in range(20)) / 20
    tv = schedules.tvlars_phi(1e-3, DELAY, 1.0, 1e-3)
    tv_head = sum(at(tv, t) for t in range(20)) / 20
    paper_io.emit(log_fn, "schedules/warmup_head_lr", 0.0, f"{wa_head:.4f}")
    paper_io.emit(log_fn, "schedules/tvlars_head_lr", 0.0,
                  f"{tv_head:.4f} -> {path}")
    return {"rows": rows, "path": path, "warmup_head_lr": wa_head,
            "tvlars_head_lr": tv_head}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
