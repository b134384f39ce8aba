"""What the paper's experiment launchers share: their command line, the
kernel path each optimizer may take, and their output (the port of
``emit`` and ``write_csv`` in ``benchmarks/common.py``).

Every one of them takes ``--device`` (default ``cuda``), ``--steps``
(the training steps of each run, so a short run is one flag away),
``--use-kernel`` where it trains, and ``--out-dir`` (default
``experiments/torch``, relative to the working directory), where it
writes its CSV files with the reference's columns.
"""
from __future__ import annotations

import argparse
import csv
import os
from typing import Iterable

DEFAULT_OUT_DIR = os.path.join("experiments", "torch")
#: the launchers' optimizers that ``build_optimizer(...,
#: use_kernel="per_tensor")`` accepts: heavy-ball LARS without a trust
#: clip (``lambc-lars`` clips, ``lamb`` and ``tvlars``'s paper momentum
#: are other update rules)
PER_TENSOR_OPTS = ("wa-lars", "nowa-lars")


def parser(description: str, *, steps: int,
           use_kernel: bool = True) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=steps,
                    help=f"training steps of each run (default {steps})")
    if use_kernel:
        ap.add_argument("--use-kernel", default="off",
                        choices=("off", "per_tensor"),
                        help="per_tensor: the optimizers of "
                             f"{PER_TENSOR_OPTS} through the per-tensor "
                             "LARS kernels, the others plain")
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR)
    return ap


def kernel_for(opt_name: str, use_kernel: str):
    """The ``use_kernel`` argument of ``opt_name``'s run:
    ``"per_tensor"`` for an optimizer of :data:`PER_TENSOR_OPTS` when
    asked for, else ``False``."""
    if use_kernel == "per_tensor" and opt_name in PER_TENSOR_OPTS:
        return "per_tensor"
    return False


def emit(log_fn, name: str, us_per_call: float, derived: str = "") -> None:
    """The reference's ``name,us_per_call,derived`` line."""
    log_fn(f"{name},{us_per_call:.1f},{derived}")


def write_csv(out_dir: str, name: str, header: list[str],
              rows: Iterable[tuple]) -> str:
    """``out_dir/name.csv`` with ``header`` and ``rows``; returns the
    path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for r in rows:
            w.writerow(r)
    return path
