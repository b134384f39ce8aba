"""``launch.sharpness``'s loop against ``benchmarks/bench_sharpness.py``'s,
on the reference's own samples, on the CPU.

The two packages draw the MLP's weights, the data and the Lanczos seed
from other generators, so their benches report other λ_max ratios.
Here the port's loop (its optimizer, trainer and ``LanczosProbe``,
with the bench's constants) runs on the reference's initial weights,
its batches and its held probe batch, for the first 6 of the bench's
40 steps: the probes at steps 0 and 5 are the bench's early window
(the first fifth of its 8 probes, plus one), so their mean is the
bench's early-phase λ_max. The Lanczos seeds still differ (8
iterations, not converged), so each λ_max and the WA-LARS / TVLARS
ratio are held to 1% of the reference's.
"""
from __future__ import annotations

import jax
import numpy as np
import torch

from repro.core import build_optimizer as jbuild
from repro.data.synthetic import ClassificationData as JData
from repro.data.synthetic import batch_iterator as jbatch_iterator
from repro.diagnostics import LanczosProbe as JLanczosProbe
from repro.diagnostics import MemorySink as JMemorySink
from repro.models.cnn import apply_mlp_classifier as japply
from repro.models.cnn import init_mlp_classifier as jinit
from repro.training import FitOptions as JFitOptions
from repro.training import TrainState as JTrainState
from repro.training import classifier_task as jclassifier_task
from repro.training import fit as jfit
from repro.training.trainer import make_train_step as jmake_train_step
from repro_torch.core import build_optimizer
from repro_torch.diagnostics import LanczosProbe, MemorySink
from repro_torch.launch import classify, sharpness
from repro_torch.models.cnn import apply_mlp_classifier
from repro_torch.models.convert import classifier_params_from_jax
from repro_torch.training import (FitOptions, TrainState, classifier_task,
                                  fit, make_train_step)

EARLY_STEPS = sharpness.PROBE_EVERY + 1     # probes at steps 0 and 5


def _torch_batch(b):
    return (torch.tensor(np.asarray(b[0])),
            torch.tensor(np.asarray(b[1]).astype(np.int64)))


def test_early_lambda_max_on_reference_samples():
    d = classify.DATA
    jdata = JData(num_classes=d.num_classes, image_size=d.image_size,
                  noise_scale=d.noise_scale, label_noise=d.label_noise,
                  seed=d.seed)
    jparams = jinit(jax.random.PRNGKey(0), in_dim=classify.IN_DIM,
                    num_classes=32, hidden=128)
    jprobe = jdata.batch(jax.random.PRNGKey(777), 128)
    it = jbatch_iterator(jdata, sharpness.BATCH)
    jbatches = [next(it) for _ in range(EARLY_STEPS)]
    hyper = dict(total_steps=sharpness.STEPS,
                 learning_rate=sharpness.LR, batch_size=sharpness.BATCH,
                 base_batch_size=classify.BASE_BATCH)
    early = {}
    for opt_name in sharpness.OPTS:
        jopt = jbuild(opt_name, **hyper)
        jtask = jclassifier_task(japply)
        jsink = JMemorySink()
        jfit(jmake_train_step(jtask, jopt),
             JTrainState.create(jparams, jopt), iter(jbatches), EARLY_STEPS,
             options=JFitOptions(sink=jsink, callbacks=[JLanczosProbe(
                 jtask, jprobe, every=sharpness.PROBE_EVERY,
                 num_iters=sharpness.LANCZOS_ITERS)]))
        want = [v for _, v in jsink.by_key("lanczos/lambda_max")]

        params = classifier_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        opt = build_optimizer(opt_name, **hyper)
        task = classifier_task(apply_mlp_classifier)
        sink = MemorySink()
        fit(make_train_step(task, opt), TrainState.create(params, opt),
            (_torch_batch(b) for b in jbatches), EARLY_STEPS,
            options=FitOptions(sink=sink, callbacks=[LanczosProbe(
                task, _torch_batch(jprobe), every=sharpness.PROBE_EVERY,
                num_iters=sharpness.LANCZOS_ITERS)]))
        got = [v for _, v in sink.by_key("lanczos/lambda_max")]
        assert len(got) == len(want) == 2
        np.testing.assert_allclose(got, want, rtol=1e-2, err_msg=opt_name)
        early[opt_name] = (float(np.mean(got)), float(np.mean(want)))
    ratio = early["wa-lars"][0] / early["tvlars"][0]
    ref_ratio = early["wa-lars"][1] / early["tvlars"][1]
    print(f"early lambda_max on the reference's samples: port {early}, "
          f"ratio port {ratio:.4f} reference {ref_ratio:.4f}")
    np.testing.assert_allclose(ratio, ref_ratio, rtol=1e-2)
