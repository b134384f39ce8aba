"""The paper's classifier and Barlow-Twins loops: the port of
``benchmarks/paper_runs.py`` (``run_classification`` / ``run_ssl``) and
of the two examples that drive them.

    PYTHONPATH=src python -m repro_torch.launch.classify --device cpu \\
        --steps 40 --ssl-steps 20 --clf-steps 20

trains the same MLP classifier at large batch with WA-LARS, NOWA-LARS,
LAMB and TVLARS on the synthetic class-mean images (32 classes, SNR
1/4, 15% label noise), prints each optimizer's eval accuracy with its
Fig.-2 LNR summary, the Table-1-style ranking, and the Barlow-Twins
two-stage protocol: SSL pre-training with the optimizer, then a linear
probe trained with SGD. Defaults are the examples' setting: B = 1024,
200 steps, γ_target 1.0; SSL B = 512, 120 steps, LR 0.8. Runs on CUDA
unless ``--device cpu``. ``run_classification`` / ``run_ssl`` take
``use_kernel="per_tensor"`` to send the ADAPT leaves through the
per-tensor LARS kernels (lars-family optimizers only, as in the
reference).

The data and weights come from the port's own generators: the same
distributions as the JAX package's, other samples.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch import device as _device
from repro_torch.core import NormRecorder, build_optimizer
from repro_torch.data.synthetic import (ClassificationData, batch_iterator,
                                        two_view_iterator)
from repro_torch.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch.training import (FitOptions, TrainState, fit,
                                  make_classifier_step, make_ssl_step)

BASE_BATCH = 64
DATA = ClassificationData(num_classes=32, noise_scale=4.0,
                          label_noise=0.15, image_size=8, seed=42)
IN_DIM = 8 * 8 * 3
OPTIMIZERS = ("wa-lars", "nowa-lars", "lamb", "tvlars")
CLF_LR, SSL_LR = 1.0, 0.8     # the examples' γ_target


def _accuracy(apply_fn, params, device) -> float:
    xe, ye = DATA.eval_set(2048, device=device)
    with torch.no_grad():
        pred = torch.argmax(apply_fn(params, xe), -1)
    return float(torch.mean((pred == ye).float()))


def run_classification(opt_name: str, batch_size: int, lr: float, *,
                       steps: int = 80, lam: float = 1e-4,
                       init_method: str = "xavier_uniform",
                       record_norms: bool = False, seed: int = 0,
                       use_kernel=False, device="cuda"):
    """Returns ``(final eval accuracy, history, recorder or None)``."""
    dev = _device.resolve(device)
    params = init_mlp_classifier(seed, in_dim=IN_DIM, num_classes=32,
                                 hidden=128, init_method=init_method,
                                 device=dev)
    opt = build_optimizer(opt_name, total_steps=steps, learning_rate=lr,
                          batch_size=batch_size, base_batch_size=BASE_BATCH,
                          lam=lam, use_kernel=use_kernel, device=dev)
    state = TrainState.create(params, opt)
    step = make_classifier_step(apply_mlp_classifier, opt,
                                record_norms=record_norms)
    rec = NormRecorder(params) if record_norms else None
    state, hist = fit(step, state, batch_iterator(DATA, batch_size,
                                                  device=dev), steps,
                      options=FitOptions(recorder=rec))
    return _accuracy(apply_mlp_classifier, state.params, dev), hist, rec


def run_ssl(opt_name: str, batch_size: int, lr: float, *,
            ssl_steps: int = 80, clf_steps: int = 60, lam: float = 1e-4,
            seed: int = 0, use_kernel=False, device="cuda") -> float:
    """Barlow-Twins two-stage protocol (Appendix B): SSL pre-training
    with the optimizer, then a LINEAR probe on the frozen embeddings
    trained with SGD. Returns the probe's eval accuracy."""
    dev = _device.resolve(device)
    embed_dim = 64
    params = init_mlp_classifier(seed, in_dim=IN_DIM, num_classes=embed_dim,
                                 hidden=128, device=dev)
    opt = build_optimizer(opt_name, total_steps=ssl_steps,
                          learning_rate=lr, batch_size=batch_size,
                          base_batch_size=BASE_BATCH, lam=lam,
                          weight_decay=1e-5, use_kernel=use_kernel,
                          device=dev)
    state = TrainState.create(params, opt)
    step = make_ssl_step(apply_mlp_classifier, opt)
    state, _ = fit(step, state, two_view_iterator(DATA, batch_size,
                                                  seed=1000, device=dev),
                   ssl_steps)
    backbone = {k: {n: t.detach() for n, t in v.items()}
                for k, v in state.params.items()}

    def probe_apply(p, x):
        with torch.no_grad():
            e = apply_mlp_classifier(backbone, x)
        return e @ p["w"] + p["b"]

    probe = {"w": torch.zeros((embed_dim, DATA.num_classes), device=dev),
             "b": torch.zeros((DATA.num_classes,), device=dev)}
    popt = build_optimizer("sgd", total_steps=clf_steps, learning_rate=0.5)
    pstate = TrainState.create(probe, popt)
    pstate, _ = fit(make_classifier_step(probe_apply, popt), pstate,
                    batch_iterator(DATA, 256, device=dev), clf_steps)
    return _accuracy(probe_apply, pstate.params, dev)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--optimizers", default=",".join(OPTIMIZERS))
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ssl-batch", type=int, default=512)
    ap.add_argument("--ssl-steps", type=int, default=120)
    ap.add_argument("--clf-steps", type=int, default=80)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def run(argv: Optional[Sequence[str]] = None, *, log_fn=print) -> dict:
    """Run the comparison as the flags say; returns ``{"classification":
    {name: {"accuracy", "summary", "final_loss"}}, "ssl": {name:
    accuracy}, "ranking": [names by accuracy]}``."""
    args = parser().parse_args(argv)
    dev = _device.resolve(args.device)
    names = [n for n in args.optimizers.split(",") if n]
    out: dict = {"classification": {}, "ssl": {}}
    for name in names:
        acc, hist, rec = run_classification(
            name, args.batch, CLF_LR, steps=args.steps, record_norms=True,
            device=dev)
        s = rec.summary()
        out["classification"][name] = {"accuracy": acc, "summary": s,
                                       "final_loss": hist[-1]["loss"]}
        log_fn(f"{name:10s} B={args.batch} γ_target={CLF_LR}: eval "
               f"acc={acc:.4f}  max_init_LNR={s['max_initial_lnr']:.3f}  "
               f"LNR decline={s['lnr_decline']:.3f}")
    ranking = sorted(out["classification"],
                     key=lambda k: -out["classification"][k]["accuracy"])
    out["ranking"] = ranking
    log_fn("Table-1-style summary (by eval accuracy): "
           + " > ".join(f"{k} {out['classification'][k]['accuracy']:.4f}"
                        for k in ranking))
    for name in names:
        acc = run_ssl(name, args.ssl_batch, SSL_LR, ssl_steps=args.ssl_steps,
                      clf_steps=args.clf_steps, device=dev)
        out["ssl"][name] = acc
        log_fn(f"{name:10s} Barlow Twins B={args.ssl_batch}: linear-probe "
               f"accuracy={acc:.4f}")
    return out


def main() -> None:
    run()


if __name__ == "__main__":
    main()
