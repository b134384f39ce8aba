"""The JAX package's side of the data-parallel parity tests
(``test_torch_mesh.py``, ``test_torch_mesh_probes.py``).

Not collected: each test file runs one function of this module in a
subprocess whose environment fabricates 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, set before jax
is imported, as ``tests/test_sharding_multidevice.py`` does) and
writes every result the port is held against to one ``.npz`` file:

    python -c "import torch_mesh_ref as r; r.main('steps', OUT)"

The inputs are made here and in the test process from the same keys
(the reference's own params and batches; the tests compare the two
copies). Keys of the output: ``{case}/{what}/{i}`` for leaf lists,
``{case}/{what}`` for arrays and scalars, and ``json`` for the text
results (error messages, checkpoint metadata, the launcher's line).
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import tempfile

MLP = dict(in_dim=8 * 8 * 3, num_classes=8, hidden=32)
LM = dict(family="dense", num_layers=2, d_model=64, num_heads=4,
          num_kv_heads=2, d_ff=128, vocab_size=128, remat=False)
STEP_CASES = [(w, k, d) for w in ("mlp", "lm") for k in (1, 2)
              for d in (2, 4)]
PER_TENSOR_CASE = ("mlp", 1, 2)
MB = 2                                    # the controller's microbatch
READINGS = {0: float(MB), 2: 8.0 * MB, 4: 8.0 * MB, 6: float(MB),
            8: 8.0 * MB}
CONTROLLER_STEPS = 10
CONTROLLER_SAMPLES = 90                   # sum of the scenario's batches


def data():
    from repro.data.synthetic import ClassificationData
    return ClassificationData(num_classes=8, image_size=8, seed=0)


def mlp_params():
    import jax
    from repro.models.cnn import init_mlp_classifier
    return init_mlp_classifier(jax.random.PRNGKey(0), **MLP)


def lm_model():
    from repro.configs.base import ModelConfig
    from repro.models import get_model
    return get_model(ModelConfig(**LM))


def lm_params():
    import jax
    return lm_model().init(jax.random.PRNGKey(0))


def mlp_batch(n):
    import jax
    return data().batch(jax.random.PRNGKey(1), n)


def lm_batch_of(n):
    import jax
    from repro.data.synthetic import lm_batch
    toks, labels = lm_batch(jax.random.PRNGKey(1), n, 32, LM["vocab_size"])
    return {"tokens": toks, "labels": labels}


def controller_samples():
    """The reference's sample stream of the controller scenario."""
    from repro.data.synthetic import classification_sample_source
    return classification_sample_source(data())(0, CONTROLLER_SAMPLES)


def _np_leaves(tree):
    """The leaves as numpy arrays; bf16 ones as their uint16 bits (npz
    holds no bfloat16)."""
    import jax
    import numpy as np
    out = [np.asarray(jax.device_get(x)) for x in
           jax.tree_util.tree_leaves(tree)]
    return [a.view(np.uint16) if str(a.dtype) == "bfloat16" else a
            for a in out]


def _put(out, key, tree):
    for i, leaf in enumerate(_np_leaves(tree)):
        out[f"{key}/{i}"] = leaf


def _step_case(out, workload, k, d, use_kernel="fused"):
    import jax
    import numpy as np
    from repro.core import build_optimizer
    from repro.data import pipeline
    from repro.launch.mesh import make_data_mesh
    from repro.models.cnn import apply_mlp_classifier
    from repro.training import tasks
    from repro.training.train_state import TrainState, replicate
    from repro.training.trainer import make_train_step
    name = "tvlars" if use_kernel == "fused" else "wa-lars"
    opt = build_optimizer(name, total_steps=10, learning_rate=1.0,
                          use_kernel=use_kernel)
    if workload == "mlp":
        task = tasks.classifier_task(apply_mlp_classifier)
        params, batch = mlp_params(), mlp_batch(8 * k)
    else:
        task = tasks.lm_task(lm_model())
        params, batch = lm_params(), lm_batch_of(8 * k)
    if k > 1:
        batch = pipeline.stack_microbatches(batch, k)
    mesh = make_data_mesh(d)
    step = jax.jit(make_train_step(task, opt, accum_steps=k, mesh=mesh,
                                   record_norms=True, layerwise=True))
    state, m = step(replicate(TrainState.create(params, opt), mesh),
                    pipeline.shard_batch(mesh, batch,
                                         batch_dim=1 if k > 1 else 0))
    key = f"{workload}-K{k}-D{d}-{use_kernel}"
    _put(out, f"{key}/params", state.params)
    _put(out, f"{key}/opt_state", state.opt_state)
    for name_ in ("loss", "grad_norm"):
        out[f"{key}/{name_}"] = np.asarray(m[name_])
    for name_ in ("w_norm", "g_norm", "trust_ratio"):
        out[f"{key}/layerwise/{name_}"] = np.asarray(m[f"layerwise/"
                                                      f"{name_}"])
    for name_ in ("lwn", "lgn", "lnr"):
        out[f"{key}/{name_}"] = np.asarray(getattr(m["layer_norms"], name_))


def _checkpoints(out, texts, tmp):
    """A state saved from a (2, 1) mesh after one step there, f32 and
    bf16_master: its metadata, and the state itself."""
    import jax
    from repro.checkpoint.checkpoint import save
    from repro.core import build_optimizer
    from repro.data import pipeline
    from repro.launch.mesh import make_data_mesh
    from repro.models.cnn import apply_mlp_classifier
    from repro.training import tasks
    from repro.training.train_state import TrainState, replicate
    from repro.training.trainer import make_train_step
    mesh2 = make_data_mesh(2)
    task = tasks.classifier_task(apply_mlp_classifier)
    for precision in ("f32", "bf16_master"):
        opt = build_optimizer("tvlars", total_steps=10, learning_rate=1.0,
                              use_kernel="fused", precision=precision)
        step = jax.jit(make_train_step(task, opt, mesh=mesh2))
        state, _ = step(replicate(TrainState.create(mlp_params(), opt),
                                  mesh2),
                        pipeline.shard_batch(mesh2, mlp_batch(8)))
        path = os.path.join(tmp, precision)
        save(path, replicate(state, mesh2), step=1)
        with open(os.path.join(path, "meta.json")) as f:
            texts[f"ckpt-{precision}"] = json.load(f)
        _put(out, f"ckpt-{precision}/state", state)


def _messages(texts):
    import jax
    import numpy as np
    from repro.core import build_optimizer
    from repro.data import pipeline
    from repro.launch.mesh import make_data_mesh
    from repro.models.cnn import apply_mlp_classifier
    from repro.training import tasks
    from repro.training.train_state import TrainState
    from repro.training.trainer import make_train_step
    try:
        pipeline.shard_batch(make_data_mesh(2), {"x": np.zeros((3, 4))})
    except ValueError as e:
        texts["shard_batch"] = str(e)
    task = tasks.classifier_task(apply_mlp_classifier)
    opt = build_optimizer("tvlars", total_steps=10, learning_rate=1.0,
                          use_kernel="fused")
    step = make_train_step(task, opt, mesh=make_data_mesh(4))
    try:
        jax.eval_shape(step, TrainState.create(mlp_params(), opt),
                       mlp_batch(6))
    except ValueError as e:
        texts["check_divisible"] = str(e)


def _launcher_line(texts):
    """The reference launcher's batch-arithmetic line at --mesh-data 2."""
    from repro.launch import train
    argv = sys.argv
    sys.argv = ["train", "--smoke", "--mesh-data", "2", "--global-batch",
                "8", "--microbatch", "2", "--steps", "1", "--seq", "16"]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            train.main()
    finally:
        sys.argv = argv
    texts["launcher"] = [line for line in buf.getvalue().splitlines()
                         if line.startswith("global_batch=")]


def steps(out, texts):
    with tempfile.TemporaryDirectory() as tmp:
        _put(out, "inputs/mlp", mlp_params())
        _put(out, "inputs/lm", lm_params())
        for case in STEP_CASES:
            _step_case(out, *case)
        _step_case(out, *PER_TENSOR_CASE, use_kernel="per_tensor")
        _checkpoints(out, texts, tmp)
    _messages(texts)
    _launcher_line(texts)


def _controller(out, texts):
    """``test_controller_retargets_data_axis``'s scenario (world of 4)."""
    from repro.core import build_optimizer, schedules
    from repro.data import pipeline
    from repro.data.synthetic import classification_sample_source
    from repro.diagnostics import sink as sink_lib
    from repro.models.cnn import apply_mlp_classifier
    from repro.training import tasks
    from repro.training.controller import (AdaptiveBatchController,
                                           ControllerConfig)
    from repro.training.train_state import TrainState
    from repro.training.trainer import fit, make_train_step
    cfg = ControllerConfig(microbatch=MB, batch_min=MB, batch_max=64 * MB,
                           every=2, deadband=0.0, ema=0.0, data_max=4)
    task = tasks.classifier_task(apply_mlp_classifier)

    def opt_for(b):
        return build_optimizer("tvlars", total_steps=20, learning_rate=1.0,
                               batch_size=b, base_batch_size=64,
                               use_kernel="fused")

    ctl = AdaptiveBatchController(
        lambda opt, k, mesh: make_train_step(task, opt, accum_steps=k,
                                             mesh=mesh),
        opt_for, lambda step, state: {
            "grad_noise_scale": READINGS.get(step, float("nan"))},
        cfg, init_batch=MB, base_lr=1.0, base_batch_size=64)
    state = TrainState.create(mlp_params(), ctl.optimizer())
    stream = pipeline.MicrobatchedStream(
        classification_sample_source(data()), MB)
    sink = sink_lib.MemorySink()
    state, _ = fit(None, state, stream, CONTROLLER_STEPS, controller=ctl,
                   sink=sink)
    _put(out, "controller/state", state)
    texts["controller"] = {
        "records": sink.records, "compiles": ctl.compiles,
        "switches": ctl.switches,
        "visited": [list(t) for t in ctl.visited_targets],
        "lr_of": {str(b): schedules.batch_scaled_lr(1.0, b, 64, "sqrt")
                  for b in (2, 16)}}


def probes(out, texts):
    import jax
    import numpy as np
    from repro.data import pipeline
    from repro.diagnostics import hvp, sharpness
    from repro.diagnostics.lanczos import lanczos_top_k
    from repro.launch.mesh import make_data_mesh
    from repro.models.cnn import apply_mlp_classifier
    from repro.training import tasks
    task = tasks.classifier_task(apply_mlp_classifier)
    params = mlp_params()
    _put(out, "inputs/mlp", params)
    batch = mlp_batch(16)
    mesh2, mesh4 = make_data_mesh(2), make_data_mesh(4)
    # the noise scale at D = 2, K = 1, and its single-device K = 2 twin
    for key, kw in (("gns-D2-K1", dict(accum_steps=1, mesh=mesh2)),
                    ("gns-D1-K2", dict(accum_steps=2))):
        b = batch if kw["accum_steps"] == 1 else \
            pipeline.stack_microbatches(batch, kw["accum_steps"])
        got = sharpness.gradient_noise_scale(task, params, b, **kw)
        for name, v in got.items():
            out[f"{key}/{name}"] = np.asarray(v)
    stacked = pipeline.stack_microbatches(batch, 2)
    op = hvp.make_flat_hvp(task, params, stacked, accum_steps=2,
                           mesh=mesh4)
    v0 = hvp.padding_mask(op.spec) * jax.random.normal(
        jax.random.PRNGKey(0), op.w2d.shape)
    out["lanczos/v0"] = np.asarray(v0)
    out["lanczos/lambda_max"] = np.asarray(
        jax.jit(lambda: lanczos_top_k(op.matvec, v0, 8, 1))()[0])
    out["lanczos/hv0"] = np.asarray(op.matvec(v0))
    sam = sharpness.sam_sharpness(task, params, stacked, accum_steps=2,
                                  mesh=mesh4)
    for name, v in sam.items():
        out[f"sam/{name}"] = np.asarray(v)
    _controller(out, texts)


def main(which: str, path: str) -> None:
    import numpy as np
    out, texts = {}, {}
    {"steps": steps, "probes": probes}[which](out, texts)
    out["json"] = np.asarray(json.dumps(texts))
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
