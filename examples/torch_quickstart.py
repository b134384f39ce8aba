"""Quickstart on the PyTorch port: train a small LM with TVLARS, the
twin of ``examples/quickstart.py`` on ``repro_torch``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on CUDA unless ``--device cpu``. :func:`run` takes the params and
the batch stream, so a caller can feed the JAX package's own (the
port's generators draw other samples than the JAX PRNG).
"""
from __future__ import annotations

import argparse
from typing import Iterator, Optional, Sequence

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import build_optimizer
from repro_torch.data.synthetic import lm_batch
from repro_torch.models import get_model
from repro_torch.training import FitOptions, TrainState, fit, make_train_step

STEPS = 30

# 1. pick a model (any assigned arch via repro_torch.configs.get_config /
#    get_smoke_config; here a hand-rolled tiny dense LM)
CFG = ModelConfig(family="dense", num_layers=2, d_model=64, num_heads=4,
                  num_kv_heads=2, d_ff=128, vocab_size=256, remat=False)


def batches(device) -> Iterator[dict]:
    """The JAX script's stream: batch i drawn from seed ``i % 8``."""
    i = 0
    while True:
        toks, labels = lm_batch(torch.Generator().manual_seed(i % 8), 16,
                                64, CFG.vocab_size, device=device)
        yield {"tokens": toks, "labels": labels}
        i += 1


def run(device="cuda", *, params=None, stream=None, log_fn=print
        ) -> list[dict]:
    """Train :data:`CFG` for :data:`STEPS` steps; returns the history.
    ``params`` default to ``model.init(0)``, ``stream`` to
    :func:`batches`."""
    dev = _device.resolve(device)
    model = get_model(CFG)
    if params is None:
        params = model.init(0, device=dev)

    # 2. pick the paper's optimizer (γ_target, λ, d_e, γ_min per §4);
    #    an LM tree takes one trust ratio per stacked leaf of the JAX
    #    package (model.segments)
    opt = build_optimizer("tvlars", total_steps=STEPS, learning_rate=2.0,
                          batch_size=16 * 64 // 128,
                          segments=model.segments, device=dev)
    state = TrainState.create(params, opt)

    # 3. the train step (CE fused with the unembed; MoE-aux aware)
    train_step = make_train_step(model, opt)

    state, history = fit(train_step, state,
                         batches(dev) if stream is None else stream, STEPS,
                         options=FitOptions(log_every=5, log_fn=log_fn))
    assert history[-1]["loss"] < history[0]["loss"]
    return history


def summary(history: list[dict]) -> str:
    return (f"\nloss {history[0]['loss']:.3f} -> {history[-1]['loss']:.3f} "
            f"in {STEPS} steps — quickstart OK")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(summary(run(args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
