"""End-to-end example on the PyTorch port: the paper's core experiment,
the twin of ``examples/large_batch_classification.py``.

Trains the same classifier at LARGE batch with WA-LARS, NOWA-LARS, LAMB
and TVLARS, prints the Table-1-style comparison and the Fig.-2 LNR
telemetry. A few hundred steps.

    PYTHONPATH=src python examples/torch_large_batch_classification.py \\
        [--device cpu]

Runs on CUDA unless ``--device cpu``. :func:`run` takes the initial
params, the batch stream and the eval set, so a caller can feed the JAX
package's own (the port's generators draw other samples than the JAX
PRNG). ``build_optimizer``'s default ``use_kernel=False``, as in the JAX
script: the optimizers take the tree path and launch no kernel.
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence

import torch

from repro_torch import device as _device
from repro_torch.core import NormRecorder, build_optimizer
from repro_torch.data.synthetic import ClassificationData, batch_iterator
from repro_torch.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch.training import (FitOptions, TrainState, fit,
                                  make_classifier_step)

BATCH, BASE, STEPS, LR = 1024, 64, 200, 1.0
DATA = ClassificationData(num_classes=32, noise_scale=4.0,
                          label_noise=0.15, image_size=8, seed=42)
OPTIMIZERS = ("wa-lars", "nowa-lars", "lamb", "tvlars")


def run(device="cuda", *, steps: int = STEPS,
        params: Optional[Callable[[], dict]] = None,
        stream: Optional[Callable[[], object]] = None,
        eval_set: Optional[tuple] = None, log_fn=print) -> dict:
    """Train one classifier per optimizer; returns ``{name: (eval acc,
    NormRecorder summary, history)}``. ``params`` / ``stream`` are
    factories called once per optimizer (default: ``init_mlp_classifier``
    from seed 0, ``batch_iterator(DATA, BATCH)``); ``eval_set`` is
    ``(images, labels)`` (default ``DATA.eval_set(2048)``)."""
    dev = _device.resolve(device)
    xe, ye = DATA.eval_set(2048, device=dev) if eval_set is None \
        else eval_set
    results = {}
    for opt_name in OPTIMIZERS:
        p0 = init_mlp_classifier(0, in_dim=8 * 8 * 3, num_classes=32,
                                 hidden=128, device=dev) \
            if params is None else params()
        opt = build_optimizer(opt_name, total_steps=steps, learning_rate=LR,
                              batch_size=BATCH, base_batch_size=BASE,
                              device=dev)
        state = TrainState.create(p0, opt)
        step = make_classifier_step(apply_mlp_classifier, opt,
                                    record_norms=True)
        rec = NormRecorder(p0)
        log_fn(f"\n=== {opt_name} (B={BATCH}, γ_target={LR}) ===")
        batches = batch_iterator(DATA, BATCH, device=dev) if stream is None \
            else stream()
        state, hist = fit(step, state, batches, steps,
                          options=FitOptions(recorder=rec, log_every=50,
                                             log_fn=log_fn))
        with torch.no_grad():
            acc = float(torch.mean((torch.argmax(
                apply_mlp_classifier(state.params, xe), -1) == ye).float()))
        s = rec.summary()
        results[opt_name] = (acc, s, hist)
        log_fn(f"eval acc={acc:.4f}  max_init_LNR="
               f"{s['max_initial_lnr']:.3f}  "
               f"LNR decline={s['lnr_decline']:.3f}")
    return results


def report(results: dict, log_fn=print) -> str:
    """Print the Table-1-style summary; returns the best optimizer."""
    log_fn("\n=== Table-1-style summary ===")
    for name, (acc, s, _) in sorted(results.items(),
                                    key=lambda kv: -kv[1][0]):
        log_fn(f"{name:10s} acc={acc:.4f}  "
               f"max_init_LNR={s['max_initial_lnr']:.3f}")
    best = max(results, key=lambda k: results[k][0])
    log_fn(f"\nbest optimizer at B={BATCH}: {best}")
    return best


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    report(run(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
