"""The port's four examples (``examples/torch_*.py``) against their JAX
twins (``examples/*.py``), on the CPU, on the reference's own params and
batches (the port's generators draw other samples than the JAX PRNG).

* quickstart: the JAX script run whole (in this process), the port's
  ``run`` on its initial params and its 30 ``lm_batch`` batches: the
  printed ``loss a -> b`` line equal, each step's loss within
  ``ref.parity_tolerance("f32")``.
* classification and SSL at reduced steps (20 classification steps for
  the four optimizers; 12 SSL and 8 probe steps for the two), the
  reference side by the same ``repro`` calls the scripts make: each
  step's loss within ``ref.parity_tolerance("f32")`` up to the step
  where the reference diverges (LAMB at γ_target 1.0, ROADMAP F13: the
  same step in the port), eval accuracies within 2 of 2048.
* serve_lm: gemma3-12b through the engine (the JAX script run whole on
  its ``RandomState(0)`` prompts) and mamba2-1.3b through ``generate``
  (the script's prompt): the tokens equal, and no kernel launch on the
  CPU.
* the examples import nothing of ``repro`` or ``jax``, their constants
  are the JAX scripts', and without ``--device cpu`` they raise on a
  host with no CUDA.
"""
from __future__ import annotations

import ast
import contextlib
import io
import math
import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401  (autouse)
from torch_repo_file import ROOT, load
from repro.kernels import ref as jax_ref
from repro_torch.models import convert

EXAMPLES = ("quickstart", "large_batch_classification", "ssl_barlow_twins",
            "serve_lm")
TOOLS = ("torch_validate_metrics", "torch_buffers")
F32 = jax_ref.parity_tolerance("f32")
CLF_STEPS, SSL_STEPS, PROBE_STEPS = 20, 12, 8
ACC_TOL = 2 / 2048
DIVERGED = 10.0      # a loss this many times the first: the run diverged


def twin(name: str):
    return load(f"examples/torch_{name}.py", f"torch_{name}")


def run_script(name: str, argv=()) -> tuple:
    """The JAX example run whole in this process: its globals and what
    it printed."""
    out = io.StringIO()
    saved = sys.argv
    sys.argv = [f"{name}.py", *argv]
    try:
        with contextlib.redirect_stdout(out):
            env = runpy.run_path(os.path.join(ROOT, "examples", f"{name}.py"),
                                 run_name="__main__")
    finally:
        sys.argv = saved
    return env, out.getvalue()


def tensors(tree):
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tensors(v) for v in tree)
    x = np.asarray(tree)
    return torch.from_numpy(x.astype(np.int64) if x.dtype.kind in "iu"
                            else x.astype(np.float32))


def assert_losses(got: list, want: list, label: str) -> None:
    """Each step's loss within the f32 tolerance model where the
    reference's is finite, non-finite where it is not, up to and
    including the step where the reference's loss first exceeds
    :data:`DIVERGED` times its first: from there on the run is chaotic
    (LAMB at γ_target 1.0, F13: the loss jumps 60-fold in one step and
    every later rounding gap is amplified), so the later steps are held
    by the eval accuracy alone."""
    assert len(got) == len(want), label
    for i, (g, w) in enumerate(zip(got, want)):
        if i and abs(want[i - 1]) > DIVERGED * abs(want[0]):
            break
        if math.isfinite(w):
            assert math.isfinite(g), (label, i, g, w)
            np.testing.assert_allclose(g, w, err_msg=f"{label} step {i}",
                                       **F32)
        else:
            assert not math.isfinite(g), (label, i, g, w)


# ------------------------------------------------------------ quickstart
def test_quickstart_prints_the_reference_line():
    import jax
    from repro.data.synthetic import lm_batch
    env, printed = run_script("quickstart")
    want_line = next(line for line in printed.splitlines()
                     if line.startswith("loss "))
    qs = twin("quickstart")
    batches = []
    for i in range(qs.STEPS):
        toks, labels = lm_batch(jax.random.PRNGKey(i % 8), 16, 64,
                                env["cfg"].vocab_size)
        batches.append(tensors({"tokens": toks, "labels": labels}))
    params = convert.params_from_jax(
        qs.CFG, jax.tree_util.tree_map(np.asarray, env["params"]),
        device="cpu")
    lines = []
    history = qs.run("cpu", params=params, stream=iter(batches),
                     log_fn=lines.append)
    assert qs.summary(history).strip() == want_line
    assert_losses([h["loss"] for h in history],
                  [float(h["loss"]) for h in env["history"]], "quickstart")
    assert any(line.startswith("step ") for line in lines)


# ------------------------------------------------- classification and SSL
@pytest.fixture(scope="module")
def classification():
    """Both packages' classification runs at :data:`CLF_STEPS` on the
    reference's params, batches and eval set."""
    import jax
    import jax.numpy as jnp
    from repro.core import NormRecorder, build_optimizer
    from repro.data.synthetic import batch_iterator
    from repro.models.cnn import apply_mlp_classifier, init_mlp_classifier
    from repro.training.train_state import TrainState
    from repro.training.trainer import FitOptions, fit, make_classifier_step
    ex = twin("large_batch_classification")
    data = jax_data(ex.DATA)
    it = batch_iterator(data, ex.BATCH)
    batches = [tuple(np.asarray(a) for a in next(it))
               for _ in range(CLF_STEPS)]
    xe, ye = (np.asarray(a) for a in data.eval_set(2048))
    params = init_mlp_classifier(jax.random.PRNGKey(0), in_dim=8 * 8 * 3,
                                 num_classes=32, hidden=128)
    ref = {}
    for opt_name in ex.OPTIMIZERS:
        opt = build_optimizer(opt_name, total_steps=CLF_STEPS,
                              learning_rate=ex.LR, batch_size=ex.BATCH,
                              base_batch_size=ex.BASE)
        state = TrainState.create(params, opt)
        step = make_classifier_step(apply_mlp_classifier, opt,
                                    record_norms=True)
        rec = NormRecorder(params)
        state, hist = fit(step, state, iter(batches), CLF_STEPS,
                          options=FitOptions(recorder=rec, log_every=0))
        acc = float(jnp.mean(jnp.argmax(
            apply_mlp_classifier(state.params, xe), -1) == ye))
        ref[opt_name] = (acc, [float(h["loss"]) for h in hist])
    params_np = jax.tree_util.tree_map(np.asarray, params)
    got = ex.run("cpu", steps=CLF_STEPS,
                 params=lambda: convert.classifier_params_from_jax(
                     params_np, device="cpu"),
                 stream=lambda: iter(tensors(batches)),
                 eval_set=tensors((xe, ye)), log_fn=lambda *a: None)
    return ref, got


def jax_data(data):
    """The JAX package's ``ClassificationData`` of the port's."""
    from repro.data.synthetic import ClassificationData
    return ClassificationData(
        num_classes=data.num_classes, image_size=data.image_size,
        channels=data.channels, mean_scale=data.mean_scale,
        noise_scale=data.noise_scale, label_noise=data.label_noise,
        seed=data.seed)


@pytest.mark.parametrize("opt_name", ("wa-lars", "nowa-lars", "lamb",
                                      "tvlars"))
def test_classification_matches_the_reference(classification, opt_name):
    ref, got = classification
    acc, s, hist = got[opt_name]
    want_acc, want_losses = ref[opt_name]
    assert_losses([h["loss"] for h in hist], want_losses, opt_name)
    assert abs(acc - want_acc) <= ACC_TOL, (acc, want_acc)
    assert set(s) >= {"max_initial_lnr", "lnr_decline"}


@pytest.fixture(scope="module")
def ssl():
    """Both packages' Barlow-Twins runs at :data:`SSL_STEPS` +
    :data:`PROBE_STEPS` on the reference's params, views, probe batches
    and eval set."""
    import jax
    import jax.numpy as jnp
    from repro.core import build_optimizer
    from repro.data.synthetic import batch_iterator, two_view_batch
    from repro.models.cnn import apply_mlp_classifier, init_mlp_classifier
    from repro.training.train_state import TrainState
    from repro.training.trainer import (FitOptions, fit,
                                        make_classifier_step, make_ssl_step)
    ex = twin("ssl_barlow_twins")
    data = jax_data(ex.DATA)
    views = [tuple(np.asarray(a) for a in two_view_batch(
        data, jax.random.PRNGKey(1000 + i), ex.BATCH))
        for i in range(SSL_STEPS)]
    it = batch_iterator(data, ex.PROBE_BATCH)
    probes = [tuple(np.asarray(a) for a in next(it))
              for _ in range(PROBE_STEPS)]
    xe, ye = (np.asarray(a) for a in data.eval_set(2048))
    params = init_mlp_classifier(jax.random.PRNGKey(0), in_dim=8 * 8 * 3,
                                 num_classes=64, hidden=128)
    ref = {}
    for opt_name in ex.OPTIMIZERS:
        opt = build_optimizer(opt_name, total_steps=SSL_STEPS,
                              learning_rate=0.8, batch_size=ex.BATCH,
                              base_batch_size=64, weight_decay=1e-5)
        state = TrainState.create(params, opt)
        state, hist = fit(make_ssl_step(apply_mlp_classifier, opt), state,
                          iter(views), SSL_STEPS,
                          options=FitOptions(log_every=0))
        backbone = state.params

        def probe_apply(p, x, backbone=backbone):
            return apply_mlp_classifier(backbone, x) @ p["w"] + p["b"]

        popt = build_optimizer("sgd", total_steps=PROBE_STEPS,
                               learning_rate=0.5)
        pstate = TrainState.create(
            {"w": jnp.zeros((64, 32)), "b": jnp.zeros((32,))}, popt)
        pstate, phist = fit(make_classifier_step(probe_apply, popt), pstate,
                            iter(probes), PROBE_STEPS)
        acc = float(jnp.mean(jnp.argmax(probe_apply(pstate.params, xe), -1)
                             == ye))
        ref[opt_name] = (acc, [float(h["loss"]) for h in hist],
                         [float(h["loss"]) for h in phist])
    params_np = jax.tree_util.tree_map(np.asarray, params)
    got = ex.run("cpu", steps=SSL_STEPS, probe_steps=PROBE_STEPS,
                 params=lambda: convert.classifier_params_from_jax(
                     params_np, device="cpu"),
                 view_stream=lambda: iter(tensors(views)),
                 probe_stream=lambda: iter(tensors(probes)),
                 eval_set=tensors((xe, ye)), log_fn=lambda *a: None)
    return ref, got


@pytest.mark.parametrize("opt_name", ("wa-lars", "tvlars"))
def test_ssl_matches_the_reference(ssl, opt_name):
    ref, got = ssl
    acc, hist, phist = got[opt_name]
    want_acc, want_ssl, want_probe = ref[opt_name]
    assert_losses([h["loss"] for h in hist], want_ssl, opt_name)
    assert_losses([h["loss"] for h in phist], want_probe,
                  f"{opt_name} probe")
    assert abs(acc - want_acc) <= ACC_TOL, (acc, want_acc)


# -------------------------------------------------------------- serve_lm
def test_serve_lm_engine_tokens_equal_the_scripts():
    import jax
    env, printed = run_script("serve_lm")
    assert "engine == per-request generate" in printed
    want = [env["eng"].result(rid).tokens for rid in env["ids"]]
    ex = twin("serve_lm")
    params = convert.params_from_jax(
        env["cfg"], jax.tree_util.tree_map(np.asarray, env["params"]),
        device="cpu")
    lines = []
    got = ex.run("gemma3-12b", device="cpu", params=params,
                 prompts=env["prompts"], log_fn=lines.append)
    assert got["tokens"] == want
    assert got["launches"] == got["expected"] == 0
    assert got["stats"]["decode_steps"] > 0
    assert any("engine == per-request generate" in line for line in lines)


def test_serve_lm_generate_tokens_equal_the_references():
    """mamba2-1.3b has no batched prefill: the script's ``generate``
    branch, on its own prompt (``PRNGKey(1)``)."""
    import jax
    from repro import serving
    from repro.configs import get_smoke_config
    from repro.models import get_model
    cfg = get_smoke_config("mamba2-1.3b")
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    prompt = jax.random.randint(jax.random.PRNGKey(1), (4, 8), 0,
                                cfg.vocab_size)
    want = np.asarray(serving.generate(model, params, prompt,
                                       num_tokens=16)).tolist()
    ex = twin("serve_lm")
    got = ex.run("mamba2-1.3b", device="cpu", params=convert.params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu"),
        prompts=np.array(prompt), log_fn=lambda *a: None)
    assert got["tokens"] == want
    assert got["stats"] is None and got["launches"] == 0


# ------------------------------------------------- imports, constants, CPU
@pytest.mark.parametrize("path", [f"examples/torch_{n}.py" for n in EXAMPLES]
                         + [f"tools/{n}.py" for n in TOOLS])
def test_imports_nothing_of_the_jax_package(path, monkeypatch):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert not [n for n in names if re.match(r"(repro|jax)(\.|$)", n)]
    # and it imports with both packages blocked
    for key in [k for k in sys.modules if re.match(r"(repro|jax)(\.|$)", k)]:
        monkeypatch.setitem(sys.modules, key, None)
    monkeypatch.setitem(sys.modules, "repro", None)
    monkeypatch.setitem(sys.modules, "jax", None)
    load(path, "blocked_" + os.path.basename(path)[:-3])


def _constants(path: str) -> dict:
    """The module-level constants (upper-case names) a script assigns
    from literals."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            try:
                value = ast.literal_eval(node.value)
            except ValueError:
                continue
            for target in node.targets:
                names = target.elts if isinstance(target, ast.Tuple) \
                    else [target]
                values = value if isinstance(target, ast.Tuple) \
                    else [value]
                for n, v in zip(names, values):
                    if n.id.isupper():
                        out[n.id] = v
    return out


@pytest.mark.parametrize("name", EXAMPLES)
def test_constants_are_the_scripts(name):
    want = _constants(f"examples/{name}.py")
    ex = twin(name)
    for key, value in want.items():
        assert getattr(ex, key) == value, key
    if hasattr(ex, "DATA"):
        with open(os.path.join(ROOT, "examples", f"{name}.py")) as f:
            src = f.read()
        d = ex.DATA
        for field in ("num_classes", "noise_scale", "image_size", "seed"):
            assert f"{field}={getattr(d, field)}" in src, field
        assert (f"label_noise={d.label_noise}" in src) == (d.label_noise > 0)


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []), ("serve_lm", ["--arch", "qwen2.5-3b"]),
    ("serve_lm", ["--arch", "zamba2-1.2b", "--requests", "2"])])
def test_example_runs_on_the_cpu_when_asked(name, argv, capsys):
    assert twin(name).main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "quickstart OK" in out or "generate" in out


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_raises_without_cuda(name):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twin(name).main([])
