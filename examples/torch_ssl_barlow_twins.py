"""Barlow-Twins SSL with large-batch optimizers on the PyTorch port
(Table 1, SSL half), the twin of ``examples/ssl_barlow_twins.py``.

Two-stage protocol per Appendix B: redundancy-reduction pre-training
with the LBT optimizer, then a linear probe trained with SGD + cosine.

    PYTHONPATH=src python examples/torch_ssl_barlow_twins.py [--device cpu]

Runs on CUDA unless ``--device cpu``. :func:`run` takes the backbone's
initial params, both batch streams and the eval set, so a caller can
feed the JAX package's own (the port's generators draw other samples
than the JAX PRNG).
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence

import torch

from repro_torch import device as _device
from repro_torch.core import build_optimizer
from repro_torch.data.synthetic import (ClassificationData, batch_iterator,
                                        two_view_batch)
from repro_torch.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch.training import (FitOptions, TrainState, fit,
                                  make_classifier_step, make_ssl_step)

BATCH, STEPS = 512, 120
PROBE_BATCH, PROBE_STEPS = 256, 80
DATA = ClassificationData(num_classes=32, noise_scale=4.0, image_size=8,
                          seed=42)
OPTIMIZERS = ("wa-lars", "tvlars")


def views(device):
    """The JAX script's stream: step i's two views drawn from seed
    ``1000 + i``."""
    i = 0
    while True:
        gen = torch.Generator(device=device).manual_seed(1000 + i)
        yield two_view_batch(DATA, gen, BATCH)
        i += 1


def run(device="cuda", *, steps: int = STEPS, probe_steps: int = PROBE_STEPS,
        params: Optional[Callable[[], dict]] = None,
        view_stream: Optional[Callable[[], object]] = None,
        probe_stream: Optional[Callable[[], object]] = None,
        eval_set: Optional[tuple] = None, log_fn=print) -> dict:
    """Pre-train one backbone per optimizer and probe it; returns
    ``{name: (probe accuracy, SSL history, probe history)}``. The
    factories are called once per optimizer (default: the backbone
    ``init_mlp_classifier`` from seed 0, :func:`views`,
    ``batch_iterator(DATA, 256)``); ``eval_set`` is ``(images, labels)``
    (default ``DATA.eval_set(2048)``)."""
    dev = _device.resolve(device)
    xe, ye = DATA.eval_set(2048, device=dev) if eval_set is None \
        else eval_set
    results = {}
    for opt_name in OPTIMIZERS:
        log_fn(f"\n=== Barlow Twins with {opt_name} ===")
        backbone = init_mlp_classifier(0, in_dim=8 * 8 * 3, num_classes=64,
                                       hidden=128, device=dev) \
            if params is None else params()
        opt = build_optimizer(opt_name, total_steps=steps, learning_rate=0.8,
                              batch_size=BATCH, base_batch_size=64,
                              weight_decay=1e-5,   # λ=1e-5 (Table 1 SSL)
                              device=dev)
        state = TrainState.create(backbone, opt)
        ssl_step = make_ssl_step(apply_mlp_classifier, opt)
        state, hist = fit(ssl_step, state,
                          views(dev) if view_stream is None
                          else view_stream(), steps,
                          options=FitOptions(log_every=40, log_fn=log_fn))
        frozen = {k: {n: t.detach() for n, t in v.items()}
                  for k, v in state.params.items()}

        # linear probe (CLF stage: SGD + cosine, Appendix B)
        probe = {"w": torch.zeros((64, 32), device=dev),
                 "b": torch.zeros((32,), device=dev)}

        def probe_apply(p, x, frozen=frozen):
            return apply_mlp_classifier(frozen, x) @ p["w"] + p["b"]

        popt = build_optimizer("sgd", total_steps=probe_steps,
                               learning_rate=0.5, device=dev)
        pstate = TrainState.create(probe, popt)
        pstate, phist = fit(make_classifier_step(probe_apply, popt), pstate,
                            batch_iterator(DATA, PROBE_BATCH, device=dev)
                            if probe_stream is None else probe_stream(),
                            probe_steps)
        with torch.no_grad():
            acc = float(torch.mean((torch.argmax(
                probe_apply(pstate.params, xe), -1) == ye).float()))
        results[opt_name] = (acc, hist, phist)
        log_fn(f"{opt_name}: linear-probe accuracy = {acc:.4f}")
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
