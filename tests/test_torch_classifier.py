"""The paper's classifier loop in ``repro_torch`` against the JAX
package, on the reference's own weights (``classifier_params_from_jax``)
and the same numpy batches, in f32 on the CPU.

* ``apply_cnn`` / ``apply_mlp_classifier`` on converted weights, for
  the shapes of all four inits and even and odd image sizes (the
  stride-2 "SAME" padding): relative 1e-4 at the logits' scale (two
  libraries summing the same products in other orders through 13
  convolutions; the LM forward tests use the same 1e-4). The padding
  alone is checked against XLA's convolution at 1e-5.
* One ``make_classifier_step`` (MLP with per-tensor WA-LARS, CNN with
  tree WA-LARS, both with ``record_norms``) and one ``make_ssl_step``
  against the reference's jitted step: loss relative 1e-5, params after
  the step and the recorded LWN / LGN / LNR relative 1e-4 at each
  leaf's scale (gradients through the network, as above).
* In the port alone: K × (B/K) ≡ 1 × B (1e-6, the reference's own
  accumulation bound).
* ``barlow_twins_loss`` and ``NormRecorder.summary`` on the same inputs:
  relative 1e-5 / 1e-6.
* The four init distributions by their moments (the PRNGs differ).
* The data stream, and ``launch.classify`` end to end on the CPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import NormRecorder as JNormRecorder
from repro.core import build_optimizer as jbuild
from repro.core.instrumentation import LayerNorms as JLayerNorms
from repro.models import cnn as jcnn
from repro.training import losses as jlosses
from repro.training.train_state import TrainState as JTrainState
from repro.training.trainer import make_classifier_step as jmake_clf
from repro.training.trainer import make_ssl_step as jmake_ssl
from repro_torch import core
from repro_torch.core.base import tree_leaves
from repro_torch.core.instrumentation import LayerNorms, NormRecorder
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.launch import classify
from repro_torch.models import cnn
from repro_torch.models.convert import classifier_params_from_jax
from repro_torch.training import (TrainState, make_classifier_step,
                                  make_ssl_step)
from repro_torch.training import losses


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _close(got, want, rtol, what=""):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * scale, err_msg=what)


def _images(seed, b, h, c=3):
    return np.random.default_rng(seed).normal(size=(b, h, h, c)) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("init", cnn.INITS)
@pytest.mark.parametrize("size", [8, 7])
def test_cnn_forward_matches_reference(init, size):
    jp = jcnn.init_cnn(jax.random.PRNGKey(1), num_classes=10, width=16,
                       init_method=init)
    tp = classifier_params_from_jax(_tree(jp), device="cpu")
    # the same tree and leaf shapes, conv weights OIHW
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        want = (b.shape[3], b.shape[2], b.shape[0], b.shape[1]) \
            if b.ndim == 4 else b.shape
        assert tuple(a.shape) == want
    x = _images(size, 4, size)
    want = jcnn.apply_cnn(jp, jnp.asarray(x))
    got = cnn.apply_cnn(tp, torch.from_numpy(x))
    assert got.shape == (4, 10)
    _close(got.detach().numpy(), want, 1e-4, what=init)


@pytest.mark.parametrize("size", [8, 7, 6, 5])
@pytest.mark.parametrize("k,stride", [(3, 2), (1, 2), (3, 1)])
def test_same_padding_matches_xla(size, k, stride):
    rng = np.random.default_rng(size * 10 + k)
    x = rng.normal(size=(2, size, size, 4)).astype(np.float32)
    w = rng.normal(size=(k, k, 4, 6)).astype(np.float32)
    want = jcnn._conv(jnp.asarray(x), jnp.asarray(w), stride)
    got = cnn._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(w).permute(3, 2, 0, 1), stride)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    _close(got, want, 1e-5)


@pytest.mark.parametrize("init", cnn.INITS)
def test_mlp_forward_matches_reference(init):
    jp = jcnn.init_mlp_classifier(jax.random.PRNGKey(2), in_dim=192,
                                  num_classes=32, hidden=64,
                                  init_method=init)
    tp = classifier_params_from_jax(_tree(jp), device="cpu")
    x = _images(3, 5, 8)
    _close(cnn.apply_mlp_classifier(tp, torch.from_numpy(x)).detach()
           .numpy(), jcnn.apply_mlp_classifier(jp, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("init", cnn.INITS)
def test_init_distributions_by_moments(init):
    shape = (96, 64, 3, 3)                    # OIHW: fan_in 576
    fan_in, fan_out = 64 * 9, 96 * 9
    std = {"xavier_uniform": np.sqrt(2.0 / (fan_in + fan_out)),
           "xavier_normal": np.sqrt(2.0 / (fan_in + fan_out)),
           "kaiming_uniform": np.sqrt(2.0 / fan_in),
           "kaiming_normal": np.sqrt(2.0 / fan_in)}[init]
    gen = torch.Generator().manual_seed(0)
    x = cnn.make_initializer(init)(gen, shape).numpy()
    jx = np.asarray(jcnn.make_initializer(init)(
        jax.random.PRNGKey(0), (3, 3, 64, 96)))
    for sample in (x, jx):
        assert abs(sample.mean()) < 0.02 * std
        assert abs(sample.std() / std - 1) < 0.02
    if init.endswith("uniform"):
        lim = std * np.sqrt(3.0)
        assert np.abs(x).max() <= lim and np.abs(x).max() > 0.99 * lim
    else:
        # the normal's kurtosis, not the uniform's 1.8
        assert abs(((x / x.std()) ** 4).mean() - 3.0) < 0.15
    # the initialisers' defaults: the card unless asked
    p = cnn.init_cnn(0, init_method=init, device="cpu")
    assert p["stem"]["w"].shape == (32, 3, 3, 3)
    assert p["stage1"][0]["proj"].shape == (64, 32, 1, 1)


def test_classifier_inits_refuse_cuda_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cnn.init_cnn(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        cnn.init_mlp_classifier(0, in_dim=4, num_classes=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(synthetic.batch_iterator(synthetic.ClassificationData(), 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        classify.run_classification("wa-lars", 8, 1.0, steps=1)


# ---------------------------------------------------------------------------
# one step against the reference
# ---------------------------------------------------------------------------

def _one_step(jstep_fn, tstep_fn, jparams, jopt, topt, batch):
    tp = classifier_params_from_jax(_tree(jparams), device="cpu")
    jstate = JTrainState.create(jparams, jopt)
    tstate = TrainState.create(tp, topt)
    jstate, jm = jax.jit(jstep_fn)(jstate, *[jnp.asarray(b) for b in batch])
    tstate, tm = tstep_fn(tstate, tuple(torch.from_numpy(b) for b in batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    want = classifier_params_from_jax(_tree(jstate.params), device="cpu")
    for a, b in zip(tree_leaves(tstate.params), tree_leaves(want)):
        _close(a.detach().numpy(), b.numpy(), 1e-4, what="params")
    return jm, tm


def test_classifier_step_mlp_per_tensor_matches_reference():
    jp = jcnn.init_mlp_classifier(jax.random.PRNGKey(0), in_dim=192,
                                  num_classes=32, hidden=128)
    hyper = dict(total_steps=20, learning_rate=1.0, batch_size=64,
                 base_batch_size=64, use_kernel="per_tensor")
    jopt = jbuild("wa-lars", **hyper)
    topt = core.build_optimizer("wa-lars", device="cpu", **hyper)
    rng = np.random.default_rng(0)
    batch = (_images(0, 64, 8), rng.integers(0, 32, 64).astype(np.int32))
    jm, tm = _one_step(
        jmake_clf(jcnn.apply_mlp_classifier, jopt, record_norms=True),
        make_classifier_step(cnn.apply_mlp_classifier, topt,
                             record_norms=True), jp, jopt, topt, batch)
    np.testing.assert_allclose(float(tm["accuracy"]),
                               float(jm["accuracy"]), rtol=1e-6)
    for a, b in zip(tm["layer_norms"], jm["layer_norms"]):
        _close(a.numpy(), b, 1e-4, what="layer_norms")


def test_classifier_step_cnn_matches_reference():
    jp = jcnn.init_cnn(jax.random.PRNGKey(0), num_classes=10, width=16)
    hyper = dict(total_steps=20, learning_rate=1.0, batch_size=16,
                 base_batch_size=64)
    jopt = jbuild("wa-lars", **hyper)
    topt = core.build_optimizer("wa-lars", device="cpu", **hyper)
    rng = np.random.default_rng(1)
    batch = (_images(1, 16, 8), rng.integers(0, 10, 16).astype(np.int32))
    _one_step(jmake_clf(jcnn.apply_cnn, jopt),
              make_classifier_step(cnn.apply_cnn, topt), jp, jopt, topt,
              batch)


def test_ssl_step_matches_reference():
    jp = jcnn.init_mlp_classifier(jax.random.PRNGKey(0), in_dim=192,
                                  num_classes=64, hidden=128)
    hyper = dict(total_steps=20, learning_rate=0.8, batch_size=32,
                 base_batch_size=64, weight_decay=1e-5,
                 use_kernel="per_tensor")
    jopt = jbuild("wa-lars", **hyper)
    topt = core.build_optimizer("wa-lars", device="cpu", **hyper)
    batch = (_images(5, 32, 8), _images(6, 32, 8))
    _one_step(jmake_ssl(jcnn.apply_mlp_classifier, jopt),
              make_ssl_step(cnn.apply_mlp_classifier, topt), jp, jopt, topt,
              batch)


def test_accumulation_k_by_b_over_k_equals_one_by_b():
    data = synthetic.ClassificationData(num_classes=8, image_size=8, seed=3)
    batch = next(synthetic.batch_iterator(data, 32, device="cpu"))
    out = []
    for k in (1, 2):
        params = cnn.init_mlp_classifier(0, in_dim=192, num_classes=8,
                                         hidden=32, device="cpu")
        opt = core.build_optimizer("wa-lars", total_steps=10,
                                   learning_rate=1.0, batch_size=32,
                                   device="cpu")
        step = make_classifier_step(cnn.apply_mlp_classifier, opt,
                                    accum_steps=k)
        state = TrainState.create(params, opt)
        losses_ = []
        for _ in range(3):
            state, m = step(state, synthetic.stack_microbatches(batch, k))
            losses_.append(float(m["loss"]))
        out.append((losses_, state.params))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    for a, b in zip(tree_leaves(out[1][1]), tree_leaves(out[0][1])):
        _close(a.detach().numpy(), b.detach().numpy(), 1e-6)


# ---------------------------------------------------------------------------
# losses and telemetry
# ---------------------------------------------------------------------------

def test_barlow_twins_loss_matches_reference():
    rng = np.random.default_rng(9)
    z1, z2 = rng.normal(size=(16, 8)), rng.normal(size=(16, 8))
    z1, z2 = z1.astype(np.float32), (z1 + 0.3 * z2).astype(np.float32)
    for lam in (5e-3, 0.1):
        want = jlosses.barlow_twins_loss(jnp.asarray(z1), jnp.asarray(z2),
                                         lam)
        got = losses.barlow_twins_loss(torch.from_numpy(z1),
                                       torch.from_numpy(z2), lam)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 7, 23])
def test_norm_recorder_summary_matches_reference(n):
    rng = np.random.default_rng(n)
    params = {"a": {"w": np.zeros((3, 4)), "b": np.zeros(4)},
              "z": np.zeros((2, 2))}
    jrec = JNormRecorder(params)
    trec = NormRecorder({"a": {"w": torch.zeros(3, 4), "b": torch.zeros(4)},
                         "z": torch.zeros(2, 2)})
    assert trec.names == jrec.names
    assert trec.summary() == jrec.summary() == {}
    for i in range(n):
        lwn, lgn = rng.uniform(0.5, 2, 3), rng.uniform(1e-3, 1, 3)
        vals = [x.astype(np.float32) for x in (lwn, lgn, lwn / lgn)]
        jrec.record(i, JLayerNorms(*map(jnp.asarray, vals)))
        trec.record(i, LayerNorms(*map(torch.from_numpy, vals)))
    assert trec.steps == jrec.steps
    want = jrec.summary()
    got = trec.summary()
    assert set(got) == set(want) and got["window"] == want["window"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    for k, v in jrec.as_arrays().items():
        np.testing.assert_allclose(trec.as_arrays()[k], v, rtol=1e-7)


# ---------------------------------------------------------------------------
# data and the launcher
# ---------------------------------------------------------------------------

def test_classification_data_stream():
    data = synthetic.ClassificationData(num_classes=32, noise_scale=4.0,
                                        label_noise=0.15, image_size=8,
                                        seed=42)
    it = synthetic.batch_iterator(data, 64, accum_steps=2, device="cpu")
    x, y = next(it)
    assert x.shape == (2, 32, 8, 8, 3) and y.shape == (2, 32)
    assert x.dtype == torch.float32 and 0 <= int(y.min()) \
        and int(y.max()) < 32
    e1, l1 = data.eval_set(256, device="cpu")
    e2, l2 = data.eval_set(256, device="cpu")
    assert torch.equal(e1, e2) and torch.equal(l1, l2)
    # labels follow the class means up to the label noise
    means = data.class_means("cpu").reshape(32, -1)
    nearest = torch.cdist(e1.reshape(256, -1), means).argmin(-1)
    agree = float((nearest == l1).float().mean())
    assert 0.6 < agree < 0.95
    v1, v2 = next(synthetic.two_view_iterator(data, 16, device="cpu"))
    assert v1.shape == v2.shape == (16, 8, 8, 3)
    assert not torch.equal(v1, v2)
    shift = torch.tensor(3)
    t = torch.arange(10.0)
    assert torch.equal(t[synthetic._roll_index(10, shift)],
                       torch.roll(t, 3))


def test_classify_launcher_runs_on_cpu():
    before = dict(ops.launches)
    lines = []
    out = classify.run(["--device", "cpu", "--steps", "3", "--batch", "64",
                        "--ssl-steps", "2", "--ssl-batch", "32",
                        "--clf-steps", "2", "--optimizers",
                        "wa-lars,tvlars"], log_fn=lines.append)
    assert ops.launches == before
    assert set(out["classification"]) == {"wa-lars", "tvlars"}
    assert sorted(out["ranking"]) == ["tvlars", "wa-lars"]
    for r in out["classification"].values():
        assert 0.0 <= r["accuracy"] <= 1.0
        assert np.isfinite(r["summary"]["max_initial_lnr"])
    assert all(0.0 <= a <= 1.0 for a in out["ssl"].values())
    assert any("Table-1" in line for line in lines)
    acc, hist, rec = classify.run_classification(
        "nowa-lars", 64, 1.0, steps=2, use_kernel="per_tensor",
        device="cpu")
    assert rec is None and len(hist) == 2 and 0.0 <= acc <= 1.0
