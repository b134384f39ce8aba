"""§5.2 ablations: TVLARS's decay coefficient λ (Fig. 5), the target LR
(Fig. 6) and the weight initialisation (Fig. 7); the port of
``benchmarks/bench_ablations.py``.

    PYTHONPATH=src python -m repro_torch.launch.ablations --device cpu \\
        --steps 10

Writes ``fig5_lambda.csv`` (batch, lambda, accuracy, loss),
``fig6_lr.csv`` (batch, lr, accuracy, loss) and ``fig7_init.csv``
(init, optimizer, accuracy).
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch import device as _device
from repro_torch.launch import classify, paper_io
from repro_torch.models.cnn import INITS

LAMBDA_BATCHES = (256, 1024)       # stand-ins for the paper's 1K / 16K
LAMBDAS = (1e-2, 5e-3, 1e-3, 1e-4, 1e-5)
LRS = (0.1, 0.3, 0.6, 1.0, 1.5)
LR_BATCH = 512
INIT_OPTS = ("wa-lars", "tvlars")
INIT_BATCH, INIT_LR = 512, 0.8
STEPS = 80


def run(argv: Optional[Sequence[str]] = None, *, log_fn=print) -> dict:
    """Returns ``{"lambda": rows, "lr": rows, "init": rows, "paths":
    [three CSV paths]}``."""
    args = paper_io.parser(__doc__, steps=STEPS).parse_args(argv)
    dev = _device.resolve(args.device)

    def train(opt, batch, lr, **kw):
        return classify.run_classification(
            opt, batch, lr, steps=args.steps,
            use_kernel=paper_io.kernel_for(opt, args.use_kernel),
            device=dev, **kw)

    out: dict = {"lambda": [], "lr": [], "init": []}
    for batch in LAMBDA_BATCHES:
        for lam in LAMBDAS:
            acc, hist, _ = train("tvlars", batch, 1.0, lam=lam)
            out["lambda"].append((batch, lam, round(acc, 4),
                                  round(hist[-1]["loss"], 4)))
            paper_io.emit(log_fn, f"fig5/lambda/B{batch}/lam{lam}", 0.0,
                          f"acc={acc:.4f}")
    for lr in LRS:
        acc, hist, _ = train("tvlars", LR_BATCH, lr)
        out["lr"].append((LR_BATCH, lr, round(acc, 4),
                          round(hist[-1]["loss"], 4)))
        paper_io.emit(log_fn, f"fig6/lr{lr}", 0.0, f"acc={acc:.4f}")
    for method in INITS:
        for opt in INIT_OPTS:
            acc, _, _ = train(opt, INIT_BATCH, INIT_LR, init_method=method)
            out["init"].append((method, opt, round(acc, 4)))
            paper_io.emit(log_fn, f"fig7/{method}/{opt}", 0.0,
                          f"acc={acc:.4f}")
    out["paths"] = [
        paper_io.write_csv(args.out_dir, "fig5_lambda",
                           ["batch", "lambda", "accuracy", "loss"],
                           out["lambda"]),
        paper_io.write_csv(args.out_dir, "fig6_lr",
                           ["batch", "lr", "accuracy", "loss"], out["lr"]),
        paper_io.write_csv(args.out_dir, "fig7_init",
                           ["init", "optimizer", "accuracy"], out["init"])]
    return out


def main() -> None:
    run()


if __name__ == "__main__":
    main()
