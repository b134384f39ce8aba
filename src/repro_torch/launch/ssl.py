"""Table 1, SSL half: the port of ``benchmarks/bench_ssl.py``.

    PYTHONPATH=src python -m repro_torch.launch.ssl --device cpu \\
        --steps 10 --clf-steps 10

Barlow-Twins pre-training of the paper's MLP with each optimizer of
:data:`OPTS` at every batch of :data:`BATCHES` (LR 0.8), then a linear
probe trained with SGD (``launch.classify.run_ssl``); writes
``table1_ssl.csv`` (optimizer, batch, probe_acc). ``--steps`` is the
pre-training's length, ``--clf-steps`` the probe's.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch import device as _device
from repro_torch.launch import classify, paper_io

BATCHES = (256, 512)
OPTS = ("wa-lars", "lamb", "tvlars")
LR = 0.8
SSL_STEPS, CLF_STEPS = 80, 60
COLUMNS = ["optimizer", "batch", "probe_acc"]


def run(argv: Optional[Sequence[str]] = None, *, log_fn=print) -> dict:
    """Returns ``{"rows": [(optimizer, batch, probe_acc)], "path"}``."""
    ap = paper_io.parser(__doc__, steps=SSL_STEPS)
    ap.add_argument("--clf-steps", type=int, default=CLF_STEPS)
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    rows = []
    for batch in BATCHES:
        for opt in OPTS:
            acc = classify.run_ssl(
                opt, batch, LR, ssl_steps=args.steps,
                clf_steps=args.clf_steps,
                use_kernel=paper_io.kernel_for(opt, args.use_kernel),
                device=dev)
            rows.append((opt, batch, round(acc, 4)))
            paper_io.emit(log_fn, f"ssl/{opt}/B{batch}", 0.0,
                          f"probe_acc={acc:.4f}")
    path = paper_io.write_csv(args.out_dir, "table1_ssl", COLUMNS, rows)
    paper_io.emit(log_fn, "ssl/summary", 0.0, path)
    return {"rows": rows, "path": path}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
