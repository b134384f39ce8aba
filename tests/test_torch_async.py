"""The port's asynchronous metrics (``MetricRing``, ``fit(options=
FitOptions(async_metrics=W))``, ``launch.train --async-metrics``)
against its synchronous path and the JAX package's ring, on the CPU.

* ``MetricRing``: window, FIFO order, ``last`` and validation, as
  ``tests/test_async_pipeline.py`` holds the reference's, and the same
  emission sequence as the reference's ring for the same appends.
* ``fit`` with W in {1, 2, 8, True}, on the fused and per-tensor paths
  with layer-wise telemetry, K > 1, a dispatch/resolve probe, the norm
  recorder and a ``LayerwiseHistory``: history, sink records, final
  params and probe records bitwise equal to the synchronous run. On the
  CPU every step runs before the next is dispatched, so a metric that
  aliased a buffer a later step writes in place would read the later
  value here: bitwise equality also shows no metric does.
* ``async_metrics=True`` resolves ``max(log_every, 1)`` or 8 steps late.
* ``launch.train --async-metrics 4 --metrics-out`` writes the same JSONL
  bytes as the synchronous run, with K > 1 and layer-wise records, and
  with the adaptive-batch controller the same records but for the
  wall time of its noise probe (``controller/probe_seconds``).
"""
from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401  (autouse)
from repro.training.trainer import MetricRing as JMetricRing
from repro_torch.core import build_optimizer
from repro_torch.core.base import tree_leaves
from repro_torch.core.instrumentation import NormRecorder
from repro_torch.core.labels import leaf_names
from repro_torch.data.synthetic import ClassificationData, batch_iterator
from repro_torch.diagnostics import sink as sink_lib
from repro_torch.launch import train as launch_train
from repro_torch.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch.obs import LayerwiseHistory, Tracer
from repro_torch.training import (FitOptions, MetricRing, TrainState,
                                  classifier_task, fit, make_train_step)

DATA = ClassificationData(num_classes=4, image_size=8, seed=0)
TASK = classifier_task(apply_mlp_classifier)


class _SquareProbe:
    """Minimal dispatch/resolve probe: sum of squared params."""
    name = "sq"
    every = 3

    def __init__(self):
        self.dispatched: list[int] = []

    def dispatch(self, step, state):
        self.dispatched.append(step)
        return sum(torch.sum(x.detach().float() ** 2)
                   for x in tree_leaves(state.params))

    def resolve(self, raw):
        return {"param_sq": float(raw)}

    def __call__(self, step, state):
        return self.resolve(self.dispatch(step, state))


# ------------------------------------------------------------ MetricRing
def test_metric_ring_window_and_fifo_order():
    ring = MetricRing(3)
    got = []
    for i in range(5):
        ring.append(i, torch.tensor(float(i)),
                    lambda s, v, l: got.append((s, float(v), l)),
                    last=i == 4)
    # window=3: entries 0 and 1 already resolved, in append order
    assert [g[0] for g in got] == [0, 1]
    ring.drain()
    assert [g[0] for g in got] == [0, 1, 2, 3, 4]
    assert got[-1][2] is True and got[0][2] is False
    assert [g[1] for g in got] == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert len(ring) == 0


@pytest.mark.parametrize("window", [1, 2, 5])
def test_metric_ring_emits_as_the_reference_ring(window):
    """The same appends give the same (step, value, last) sequence at
    the same points of the append stream as the JAX package's ring."""
    logs = {"port": [], "jax": []}
    rings = {"port": MetricRing(window), "jax": JMetricRing(window)}
    for i in range(7):
        for name, ring in rings.items():
            x = torch.tensor(float(i)) if name == "port" \
                else jnp.asarray(float(i))
            ring.append(i, {"v": x},
                        lambda s, v, l, _n=name: logs[_n].append(
                            (s, float(v["v"]), l, i)),
                        last=i == 6)
    for ring in rings.values():
        ring.drain()
    assert logs["port"] == logs["jax"]


def test_metric_ring_validates_window_and_traces_resolve():
    with pytest.raises(ValueError, match="window"):
        MetricRing(0)
    tracer = Tracer()
    ring = MetricRing(1, tracer=tracer)
    for i in range(3):
        ring.append(i, torch.ones(2), lambda *a: None)
    ring.drain()
    spans = [e for e in tracer.events() if e["name"] == "resolve"]
    assert [e["step"] for e in spans] == [0, 1, 2]


# -------------------------------------------------- async fit bit-parity
def _opt(use_kernel, batch=16):
    return build_optimizer("wa-lars" if use_kernel == "per_tensor"
                           else "tvlars", total_steps=50, learning_rate=0.4,
                           batch_size=batch, base_batch_size=256,
                           use_kernel=use_kernel, device="cpu")


def _fit_once(async_metrics, *, use_kernel="fused", probe=True, steps=10,
              accum_steps=1, log_every=0):
    params = init_mlp_classifier(0, in_dim=8 * 8 * 3, num_classes=4,
                                 hidden=16, device="cpu")
    opt = _opt(use_kernel)
    step = make_train_step(TASK, opt, accum_steps=accum_steps,
                           record_norms=True, layerwise=True)
    state = TrainState.create(params, opt)
    sink = sink_lib.MemorySink()
    rec = NormRecorder(params)
    hist_lw = LayerwiseHistory(capacity=2)
    sq = _SquareProbe() if probe else None
    state, hist = fit(step, state,
                      batch_iterator(DATA, 16, accum_steps=accum_steps,
                                     device="cpu"),
                      steps, options=FitOptions(
                          sink=sink, callbacks=[sq] if sq else [],
                          recorder=rec, layerwise_every=2,
                          layerwise_names=leaf_names(params),
                          layerwise_history=hist_lw, log_every=log_every,
                          async_metrics=async_metrics))
    return state, hist, sink, rec, hist_lw, sq


def _assert_same(a, b):
    (sa, ha, ka, ra, la, _), (sb, hb, kb, rb, lb, _) = a, b
    assert len(ha) == len(hb) == 10
    assert ha == hb                     # floats compared exactly
    assert ka.records == kb.records
    assert ra.steps == rb.steps == list(range(10))
    for k, v in ra.as_arrays().items():
        np.testing.assert_array_equal(v, rb.as_arrays()[k], err_msg=k)
    assert la.steps == lb.steps and la.snapshots == lb.snapshots
    _assert_states_equal(sa, sb)


def _assert_states_equal(a, b):
    assert a.step == b.step
    for x, y in zip(tree_leaves((a.params, a.opt_state)),
                    tree_leaves((b.params, b.opt_state))):
        assert torch.equal(x, y)


@pytest.mark.parametrize("use_kernel", ["fused", "per_tensor"])
@pytest.mark.parametrize("window", [1, 2, 8, True])
def test_async_fit_bit_identical_to_sync(use_kernel, window):
    _assert_same(_fit_once(False, use_kernel=use_kernel),
                 _fit_once(window, use_kernel=use_kernel))


def test_async_fit_bit_identical_with_accumulation():
    _assert_same(_fit_once(False, accum_steps=2),
                 _fit_once(3, accum_steps=2))


def test_async_fit_probe_records_at_dispatch_step():
    *_, sink, _, _, probe = _fit_once(4, steps=10)
    # probe results land under the step they measured, not the step
    # they were read at
    assert probe.dispatched == [0, 3, 6, 9]
    assert [s for s, _ in sink.by_key("sq/param_sq")] == [0, 3, 6, 9]
    steps_seq = [r["step"] for r in sink.records]
    assert steps_seq == sorted(steps_seq)


@pytest.mark.parametrize("log_every,window", [(0, 8), (3, 3), (1, 1)])
def test_async_true_picks_window(log_every, window):
    """A record is written once ``window`` later steps are in flight."""
    params = init_mlp_classifier(0, in_dim=8 * 8 * 3, num_classes=4,
                                 hidden=16, device="cpu")
    opt = _opt("fused")
    inner = make_train_step(TASK, opt)
    dispatched, seen = [], []

    def step(state, batch):
        dispatched.append(len(dispatched))
        return inner(state, batch)

    class _Sink(sink_lib.MetricsSink):
        def write(self, s, metrics, *, last=False):
            seen.append((s, len(dispatched)))

    fit(step, TrainState.create(params, opt),
        batch_iterator(DATA, 16, device="cpu"), 12,
        options=FitOptions(sink=_Sink(), log_every=log_every,
                           async_metrics=True))
    for s, n in seen:
        assert n == min(s + window + 1, 12), (s, n)


# ----------------------------------------------------------- the launcher
@pytest.mark.parametrize("argv", [
    ["--global-batch", "8", "--microbatch", "4", "--layerwise-every", "2",
     "--use-kernel", "fused"],
    ["--batch", "4", "--use-kernel", "per_tensor", "--optimizer",
     "wa-lars", "--layerwise-every", "1"],
])
def test_launch_train_async_jsonl_is_byte_identical(tmp_path, argv):
    out = _launch_pair(tmp_path, argv)
    a, b = (tmp_path / "m0.jsonl").read_bytes(), \
        (tmp_path / "m4.jsonl").read_bytes()
    assert a == b and a.count(b"\n") >= 5
    assert out["0"]["history"] == out["4"]["history"]
    _assert_states_equal(out["0"]["state"], out["4"]["state"])


def _launch_pair(tmp_path, argv):
    out = {}
    for w in ("0", "4"):
        out[w] = launch_train.run(
            ["--smoke", "--device", "cpu", "--steps", "5", "--seq", "16",
             "--async-metrics", w, "--metrics-out",
             str(tmp_path / f"m{w}.jsonl")] + argv, log_fn=lambda *_: None)
    return out


def test_launch_train_async_with_the_controller(tmp_path):
    """The controller's records ride the ring in order; they equal the
    synchronous run's but for its noise probe's wall time."""
    out = _launch_pair(tmp_path, [
        "--global-batch", "2", "--microbatch", "1", "--batch-max", "16",
        "--controller-every", "2", "--adaptive-batch", "--use-kernel",
        "fused"])

    def records(w):
        lines = (tmp_path / f"m{w}.jsonl").read_text().splitlines()
        recs = [json.loads(ln) for ln in lines]
        for r in recs:
            r.pop("controller/probe_seconds", None)
        return recs

    assert records("0") == records("4")
    assert sum("controller/changed" in r for r in records("4")) == 3
    assert out["0"]["history"] == out["4"]["history"]
    _assert_states_equal(out["0"]["state"], out["4"]["state"])


def test_launch_train_batch_alias_and_async_flag_checks():
    run = launch_train.run(["--smoke", "--device", "cpu", "--steps", "1",
                            "--seq", "16", "--batch", "4"],
                           log_fn=lambda *_: None)
    assert run["history"][0]["loss"] > 0
    assert launch_train.parser().parse_args(
        ["--batch", "4"]).global_batch is None
    with pytest.raises(SystemExit):
        launch_train.run(["--smoke", "--device", "cpu",
                          "--async-metrics", "-1"])


def test_launch_pipeline_on_cpu(tmp_path):
    """The bench's loops at a few steps: the async metrics equal the
    sync ones, both JSONL files pass both packages' validators, and
    bucketing pads less than pad-to-max."""
    from repro.diagnostics.sink import validate_jsonl as jvalidate
    from repro_torch.launch import pipeline
    out = pipeline.run(["--device", "cpu", "--steps", "12", "--quick",
                        "--out-dir", str(tmp_path)], log_fn=lambda *_: None)
    sync_h, async_h = out["histories"]
    assert out["max_abs_diff"] == 0.0 and sync_h == async_h
    assert len(sync_h) == 12
    for name in ("sync", "async"):
        path = str(tmp_path / f"pipeline_{name}.jsonl")
        assert sink_lib.validate_jsonl(path) == jvalidate(path) > 12
    assert out["launches_per_step"] == {"seg_norm_lars": 0.0,
                                        "seg_apply_lars": 0.0}
    b = out["bucketing"]
    assert 0 <= b["pad_waste_bucketed"] < b["pad_waste_flat"] < 1
    with pytest.raises(SystemExit):
        pipeline.run(["--device", "cpu", "--steps", "5"])
