"""The adaptive-batch controller of the port
(``repro_torch.training.controller``) against the JAX package's, on the
CPU.

* ``snap_accum_steps`` / ``snap_targets`` / ``decide_targets`` /
  ``decide_global_batch`` equal the reference's exactly on a grid of
  (B_noise, current batch, config), ``data_max > 1`` and both snaps
  included (plain arithmetic on both sides).
* ``ControllerConfig`` rejects exactly what the reference rejects, with
  the same message.
* Driven by the same stub noise readings and the same stub clock, the
  two controllers give equal ``controller/*`` records at every
  boundary, static and adaptive cadence, with and without a probe
  dispatched ahead.
* ``schedules.batch_scaled_lr``, static and stateful, equals the
  reference's.
* In the port: a K switch mid-run equals a fresh run at the new K from
  the same state and stream position (≤ 1e-6, the reference's own
  bound); the deadband switches nothing and builds no step; ``fit``
  refuses a ``train_step`` beside a controller; ``fit(controller=)``
  streams ``controller/*`` with the re-scaled LR, also through a
  prefetching stream; the fused optimizer launches its two kernels per
  step at every K (their plain versions here, counted).
* On the reference's own samples: an MLP classifier, 6 steps with a
  scripted retarget at step 3 in both packages, on the reference's
  params and ``classification_sample_source`` output. Each port step
  starts from the reference's state (ROADMAP F4), and its params are
  held to ``ref.parity_tolerance("f32")`` at each leaf's scale.
"""
from __future__ import annotations

import itertools
import math

import jax
import numpy as np
import pytest
import torch

from repro.core import build_optimizer as jbuild
from repro.core import schedules as jschedules
from repro.data.pipeline import MicrobatchedStream as JStream
from repro.data.synthetic import ClassificationData as JData
from repro.data.synthetic import classification_sample_source as jsource
from repro.models.cnn import apply_mlp_classifier as japply
from repro.models.cnn import init_mlp_classifier as jinit
from repro.training import controller as jcontroller
from repro.training import TrainState as JTrainState
from repro.training import classifier_task as jclassifier_task
from repro.training.trainer import make_train_step as jmake_train_step
from repro_torch.core import build_optimizer, schedules
from repro_torch.core.base import tree_leaves, tree_map
from repro_torch.core.tvlars import TVLarsState
from repro_torch.data import pipeline, synthetic
from repro_torch.diagnostics import sink as sinks
from repro_torch.kernels import ops, ref
from repro_torch.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch.models.convert import classifier_params_from_jax
from repro_torch.training import (AdaptiveBatchController, ControllerConfig,
                                  FitOptions, TrainState, classifier_task,
                                  controller, fit, make_train_step)

DATA = synthetic.ClassificationData(num_classes=4, image_size=8, seed=0)
TASK = classifier_task(apply_mlp_classifier)
BASE_LR = 0.4
BASE_BATCH = 256


def _params():
    return init_mlp_classifier(0, in_dim=8 * 8 * 3, num_classes=4,
                               hidden=16, device="cpu")


def _factory(use_kernel=False):
    return lambda b: build_optimizer(
        "tvlars", total_steps=50, learning_rate=BASE_LR, batch_size=b,
        base_batch_size=BASE_BATCH, use_kernel=use_kernel, device="cpu")


def _stub_probe(value):
    return lambda step, state: {"grad_noise_scale": float(value)}


def _controller(probe, *, micro=4, bmin=4, bmax=64, every=2, init=None,
                use_kernel=False, **cfg_kw):
    cfg = ControllerConfig(microbatch=micro, batch_min=bmin,
                           batch_max=bmax, every=every, **cfg_kw)
    return AdaptiveBatchController(
        lambda opt, k: make_train_step(TASK, opt, accum_steps=k),
        _factory(use_kernel), probe, cfg, init_batch=init,
        base_lr=BASE_LR, base_batch_size=BASE_BATCH)


def _stream(micro=4, k=1):
    return pipeline.MicrobatchedStream(
        synthetic.classification_sample_source(DATA, device="cpu"),
        microbatch=micro, accum_steps=k)


# ---------------------------------------------------------- decision rule
CONFIGS = [dict(microbatch=m, batch_min=lo, batch_max=hi, snap=snap,
                data_max=d, deadband=db)
           for (m, lo, hi), snap, d, db in itertools.product(
               [(4, 4, 64), (1, 1, 16), (3, 6, 96), (4, 12, 200)],
               ["pow2", "linear"], [1, 2, 8], [0.0, 0.25])]
NOISE = [float("nan"), float("inf"), -3.0, 0.0, 1e-3, 0.5, 3.0, 6.0, 7.9,
         12.0, 25.0, 36.0, 44.0, 64.0, 100.0, 257.0, 1e9]


@pytest.mark.parametrize("cfg_kw", CONFIGS,
                         ids=[f"m{c['microbatch']}-{c['batch_min']}-"
                              f"{c['batch_max']}-{c['snap']}-d"
                              f"{c['data_max']}-db{c['deadband']}"
                              for c in CONFIGS])
def test_snap_and_decide_equal_the_reference(cfg_kw):
    cfg = ControllerConfig(**cfg_kw)
    jcfg = jcontroller.ControllerConfig(**cfg_kw)
    currents = sorted({cfg.batch_min, cfg.batch_max,
                       cfg.microbatch * max(cfg.k_min, 2),
                       cfg.microbatch * cfg.k_max // 2 or cfg.batch_min})
    for b in NOISE:
        if math.isfinite(b):
            assert controller.snap_accum_steps(b, cfg) \
                == jcontroller.snap_accum_steps(b, jcfg), b
            assert controller.snap_targets(b, cfg) \
                == jcontroller.snap_targets(b, jcfg), b
        for cur in currents:
            assert controller.decide_targets(b, cur, cfg) \
                == jcontroller.decide_targets(b, cur, jcfg), (b, cur)
            assert controller.decide_global_batch(b, cur, cfg) \
                == jcontroller.decide_global_batch(b, cur, jcfg), (b, cur)
    assert (cfg.k_min, cfg.k_max) == (jcfg.k_min, jcfg.k_max)


BAD_CONFIGS = [
    dict(microbatch=8, batch_min=4, batch_max=64),
    dict(microbatch=4, batch_min=6, batch_max=64),
    dict(microbatch=4, batch_min=4, batch_max=66),
    dict(microbatch=4, batch_min=32, batch_max=16),
    dict(microbatch=0, batch_min=4, batch_max=64),
    dict(microbatch=4, batch_min=4, batch_max=64, snap="cubic"),
    dict(microbatch=4, batch_min=4, batch_max=64, ema=1.0),
    dict(microbatch=4, batch_min=4, batch_max=64, ema=-0.1),
    dict(microbatch=4, batch_min=4, batch_max=64, every=0),
    dict(microbatch=4, batch_min=4, batch_max=64, deadband=-0.1),
    dict(microbatch=4, batch_min=4, batch_max=64, data_max=3),
    dict(microbatch=4, batch_min=4, batch_max=64, data_max=0),
    dict(microbatch=4, batch_min=4, batch_max=64, cadence="sometimes"),
    dict(microbatch=4, batch_min=4, batch_max=64, every=4, min_every=5),
    dict(microbatch=4, batch_min=4, batch_max=64, min_every=0),
    dict(microbatch=4, batch_min=4, batch_max=64, drift_threshold=-1.0),
    dict(microbatch=4, batch_min=4, batch_max=64, probe_budget=0.0),
    dict(microbatch=4, batch_min=4, batch_max=64, probe_budget=1.5),
    # accepted by both
    dict(microbatch=4, batch_min=4, batch_max=64, data_max=4),
    dict(microbatch=4, batch_min=4, batch_max=64, cadence="adaptive",
         every=8, min_every=8, probe_budget=1.0, ema=0.0),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS)
def test_config_rejects_what_the_reference_rejects(kw):
    def outcome(cls):
        try:
            cls(**kw)
        except ValueError as e:
            return str(e)
        return None
    assert outcome(ControllerConfig) == outcome(jcontroller.ControllerConfig)


def test_data_parallel_knob_waits_for_data_parallelism():
    """The D knob, now ported: ``data_max > 1`` and a ``mesh_factory``
    are accepted as by the reference, (D, K) retargets move both
    controllers alike and refuse the same widths with the same message,
    the step of a (D, K) pair is built on its mesh, and in a world of
    one rank a mesh of two raises the mesh-size error naming both
    numbers."""
    from repro_torch.distributed import make_data_mesh
    cfg = dict(microbatch=4, batch_min=4, batch_max=64, data_max=2)
    made = []

    def make_step(opt, k, mesh):
        made.append((k, mesh))
        return lambda state, batch: (state, {})

    ctrl = AdaptiveBatchController(make_step, _factory(), _stub_probe(1.0),
                                   ControllerConfig(**cfg),
                                   mesh_factory=lambda d: f"mesh{d}")
    jctrl = jcontroller.AdaptiveBatchController(
        lambda opt, k, mesh: None, lambda b: None, _stub_probe(1.0),
        jcontroller.ControllerConfig(**cfg),
        mesh_factory=lambda d: f"mesh{d}")
    assert ctrl.targets == jctrl.targets == (1, 1)
    for target, d in ((16, 2), (8, None), (32, 1)):
        assert ctrl.retarget(target, data_parallel=d) == \
            jctrl.retarget(target, data_parallel=d)
        assert ctrl.targets == jctrl.targets
        ctrl.step_fn()
    assert made == [(2, "mesh2"), (1, "mesh2"), (8, None)]
    for bad in ((8, 4), (12, 2)):
        msgs = []
        for c in (ctrl, jctrl):
            with pytest.raises(ValueError) as e:
                c.retarget(bad[0], data_parallel=bad[1])
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="needs 2 ranks but only 1"):
        make_data_mesh(2)


class _Clock:
    """A stub ``time`` module: the test moves it between steps, and every
    read advances it by ``tick`` (what a probe takes)."""

    def __init__(self, tick=1e-3):
        self.t, self.tick = 100.0, tick

    def perf_counter(self):
        self.t += self.tick
        return self.t


class _Readings:
    """A stub noise probe with dispatch / resolve, replaying readings."""

    def __init__(self, values):
        self.values = list(values)
        self.n = 0

    def dispatch(self, step, state):
        v = self.values[self.n % len(self.values)]
        self.n += 1
        return v

    def resolve(self, raw):
        return {"grad_noise_scale": float(raw)}

    def __call__(self, step, state):
        return self.resolve(self.dispatch(step, state))


DRIVE_CASES = {
    "static-pow2": (dict(every=2, ema=0.5, deadband=0.25), 0),
    "static-linear-ema0": (dict(every=3, ema=0.0, deadband=0.0,
                                snap="linear"), 0),
    "adaptive": (dict(every=8, cadence="adaptive", min_every=1,
                      drift_threshold=0.25, ema=0.5, deadband=0.1), 0),
    "adaptive-budget": (dict(every=8, cadence="adaptive", min_every=2,
                             probe_budget=0.05, ema=0.3), 0),
    "static-lead2": (dict(every=4, ema=0.5, deadband=0.0), 2),
}
READINGS = [20.0, 150.0, -1e9, float("nan"), 400.0, 10.0, 10.0, 80.0,
            1e6, 0.0, 33.0, 33.0, 33.0, 33.0, 520.0, 16.0]


@pytest.mark.parametrize("case", list(DRIVE_CASES))
def test_controller_records_equal_the_reference(case, monkeypatch):
    cfg_kw, lead = DRIVE_CASES[case]
    clocks = (_Clock(), _Clock())
    monkeypatch.setattr(jcontroller, "time", clocks[0])
    monkeypatch.setattr(controller, "time", clocks[1])
    base = dict(microbatch=4, batch_min=4, batch_max=512, **cfg_kw)
    common = dict(init_batch=16, base_lr=0.7, base_batch_size=64,
                  probe_lead=lead)
    jc = jcontroller.AdaptiveBatchController(
        lambda opt, k: (lambda state: (opt, k)), lambda b: ("opt", b),
        _Readings(READINGS), jcontroller.ControllerConfig(**base),
        **common)
    tc = AdaptiveBatchController(
        lambda opt, k: (lambda state: (opt, k)), lambda b: ("opt", b),
        _Readings(READINGS), ControllerConfig(**base), **common)
    records = 0
    for step in range(60):
        for clock in clocks:
            clock.t += 0.05 * (1 + step % 3)
        assert jc.global_batch == tc.global_batch
        jc.step_fn()
        assert tc.step_fn()(None) == (("opt", tc.global_batch),
                                      tc.accum_steps)
        jc.prepare(step, None)
        tc.prepare(step, None)
        assert jc.due(step) == tc.due(step)
        if tc.due(step):
            want, got = jc(step, None), tc(step, None)
            assert got == want, (step, got, want)
            records += 1
    assert records >= 8
    assert (tc.switches, tc.compiles, tc.visited_ks) == \
        (jc.switches, jc.compiles, jc.visited_ks)
    assert tc.switches >= 2


def test_batch_scaled_lr_equals_the_reference():
    for rule, lr, b, base in itertools.product(
            ("sqrt", "linear"), (0.1, 2.0), (1, 16, 256, 4096), (64, 256)):
        assert schedules.batch_scaled_lr(lr, b, base, rule) \
            == jschedules.batch_scaled_lr(lr, b, base, rule)
    box = {"b": 64}
    mine = schedules.batch_scaled_lr(2.0, base_batch_size=256, rule="sqrt",
                                     batch_size_fn=lambda: box["b"])
    theirs = jschedules.batch_scaled_lr(2.0, base_batch_size=256,
                                        rule="sqrt",
                                        batch_size_fn=lambda: box["b"])
    for b in (64, 256, 1024):
        box["b"] = b              # re-read on every call
        assert mine() == theirs() == schedules.batch_scaled_lr(2.0, b, 256)
    for kw in (dict(), dict(batch_size=64, batch_size_fn=lambda: 4)):
        with pytest.raises(ValueError, match="exactly one"):
            schedules.batch_scaled_lr(2.0, **kw)
    with pytest.raises(ValueError, match="rule"):
        schedules.batch_scaled_lr(2.0, 64, rule="cubic")


# ------------------------------------------------------- the closed loop
def test_k_switch_parity_with_fresh_run():
    """Params after a mid-run K switch equal a fresh run started at the
    new K from the same state and stream position, to <= 1e-6."""
    ctrl = _controller(_stub_probe(1.0), micro=4, init=8, every=100)
    state = TrainState.create(_params(), ctrl.optimizer())
    stream = _stream()
    ctrl.attach(stream)
    assert stream.accum_steps == 2       # attach syncs K to init_batch
    for _ in range(3):
        state, _ = ctrl.step_fn()(state, next(stream))
    switch_params = tree_map(lambda t: t.detach().clone(), state.params)
    switch_opt = tree_map(lambda t: t.clone(), state.opt_state)
    switch_step, switch_pos = state.step, stream.position

    assert ctrl.retarget(16)             # B 8 -> 16: K 2 -> 4
    cont = state
    for _ in range(3):
        cont, _ = ctrl.step_fn()(cont, next(stream))

    opt2 = _factory()(16)
    step2 = make_train_step(TASK, opt2, accum_steps=4)
    fresh_stream = pipeline.MicrobatchedStream(
        synthetic.classification_sample_source(DATA, device="cpu"),
        microbatch=4, accum_steps=4, position=switch_pos)
    fresh = TrainState(switch_step, switch_params, switch_opt)
    for _ in range(3):
        fresh, _ = step2(fresh, next(fresh_stream))
    for a, b in zip(tree_leaves(cont.params), tree_leaves(fresh.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6, rtol=0)
    assert ctrl.visited_ks == (2, 4) and ctrl.compiles == 2


def test_invalid_reading_holds_and_spares_the_ema():
    vals = iter([200.0, -1e9, float("nan"), 200.0])
    ctrl = _controller(lambda s, st: {"grad_noise_scale": next(vals)},
                       micro=4, bmax=256, init=4, every=1, ema=0.5,
                       deadband=0.0, snap="linear")
    out = ctrl(0, None)
    assert out["changed"] == 1.0 and out["global_batch"] == 200.0
    for i in (1, 2):
        out = ctrl(i, None)
        assert out["changed"] == 0.0 and out["b_noise_ema"] == 200.0
    out = ctrl(3, None)
    assert out["b_noise_ema"] == 200.0 and out["global_batch"] == 200.0


def test_deadband_switches_nothing_and_builds_no_step():
    ctrl = _controller(_stub_probe(36.0), micro=4, init=32, every=1,
                       deadband=0.25, ema=0.0, snap="linear")
    state = TrainState.create(_params(), ctrl.optimizer())
    stream = _stream(k=8)
    ctrl.attach(stream)
    for i in range(4):
        state, _ = ctrl.step_fn()(state, next(stream))
        out = ctrl(i, state)
        assert out["changed"] == 0.0 and out["step_cached"] == 1.0
    assert (ctrl.compiles, ctrl.switches, ctrl.visited_ks) == (1, 0, (8,))


def test_fit_rejects_train_step_with_controller():
    ctrl = _controller(_stub_probe(1.0))
    state = TrainState.create(_params(), ctrl.optimizer())
    with pytest.raises(ValueError, match="train_step=None"):
        fit(make_train_step(TASK, ctrl.optimizer()), state, _stream(), 1,
            options=FitOptions(controller=ctrl))
    with pytest.raises(ValueError, match="train_step or a controller"):
        fit(None, state, _stream(), 1)


def test_attach_and_retarget_validation():
    ctrl = _controller(_stub_probe(1.0), micro=4, bmin=4, bmax=64, init=8)
    with pytest.raises(TypeError, match="set_accum_steps"):
        ctrl.attach(iter([]))
    with pytest.raises(ValueError, match="microbatch"):
        ctrl.attach(_stream(micro=8))
    with pytest.raises(ValueError, match="multiple"):
        ctrl.retarget(10)
    with pytest.raises(ValueError, match="outside"):
        ctrl.retarget(128)
    assert not ctrl.retarget(8)
    with pytest.raises(ValueError, match="probe_lead"):
        _controller(_stub_probe(1.0)).__class__(
            lambda o, k: None, _factory(), _stub_probe(1.0),
            ControllerConfig(microbatch=4, batch_min=4, batch_max=8),
            probe_lead=-1)


@pytest.mark.parametrize("prefetch", [False, True])
def test_fit_controller_streams_metrics(prefetch, tmp_path):
    """A forced switch at step 2 lands in the sink with the re-scaled LR;
    every step's record carries the batch it trained at; prefetching
    changes no number."""
    def run(prefetch):
        vals = iter([4.0, 64.0, 64.0])
        ctrl = _controller(lambda s, st: {"grad_noise_scale": next(vals)},
                           micro=4, init=4, every=2, ema=0.0, deadband=0.0)
        state = TrainState.create(_params(), ctrl.optimizer())
        stream = _stream()
        if prefetch:
            stream = pipeline.PrefetchingStream(stream, size=2)
        path = str(tmp_path / f"ctrl{int(prefetch)}.jsonl")
        mem = sinks.MemorySink()
        try:
            with sinks.JsonlSink(path) as jsonl:
                state, hist = fit(None, state, stream, 6,
                                  options=FitOptions(
                                      sink=sinks.MultiSink(jsonl, mem),
                                      controller=ctrl))
        finally:
            if prefetch:
                stream.close()
        return ctrl, state, hist, mem, path

    ctrl, state, hist, mem, path = run(prefetch)
    assert sinks.validate_jsonl(path) > 0
    switches = [r for r in mem.records if r.get("controller/changed") == 1.0]
    assert len(switches) == 1 and switches[0]["step"] == 2
    assert switches[0]["controller/global_batch"] == 64.0
    assert switches[0]["controller/lr"] == schedules.batch_scaled_lr(
        BASE_LR, 64, BASE_BATCH)
    per_step = dict(mem.by_key("global_batch"))
    assert per_step[0] == 4.0 and per_step[5] == 64.0
    assert [h["global_batch"] for h in hist] == [4.0] * 3 + [64.0] * 3
    assert ctrl.visited_ks == (1, 16)
    if prefetch:
        _, state0, hist0, _, _ = run(False)
        assert [h["loss"] for h in hist] == [h["loss"] for h in hist0]
        for a, b in zip(tree_leaves(state.params),
                        tree_leaves(state0.params)):
            assert torch.equal(a, b)


def test_fused_kernels_twice_per_step_at_every_k():
    """The fused optimizer's two launches per step hold at every visited K
    (on the CPU the wrapper runs the plain versions; its calls are
    counted through a stand-in)."""
    ctrl = _controller(_stub_probe(1.0), micro=4, init=4, every=100,
                       use_kernel="fused")
    state = TrainState.create(_params(), ctrl.optimizer())
    stream = _stream()
    ctrl.attach(stream)
    real = ops.segmented_update
    calls = []

    def counting(*args, **kw):
        calls.append(ctrl.accum_steps)
        return real(*args, **kw)

    ops.segmented_update = counting
    try:
        for target in (4, 16, 64, 16):
            ctrl.retarget(target)
            state, _ = ctrl.step_fn()(state, next(stream))
    finally:
        ops.segmented_update = real
    assert calls == [1, 4, 16, 4]
    assert ctrl.visited_ks == (1, 4, 16) and ctrl.compiles == 3


# ------------------------------------------- on the reference's samples
def _state_from_jax(jstate) -> TrainState:
    tree = lambda t: classifier_params_from_jax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, t), device="cpu")
    step = torch.tensor(int(jstate.opt_state.step), dtype=torch.int32)
    return TrainState(int(jstate.step), tree(jstate.params),
                      TVLarsState(step, tree(jstate.opt_state.momentum)))


def test_retarget_matches_the_reference_on_its_samples():
    jdata = JData(num_classes=4, image_size=8, seed=0)
    jparams = jinit(jax.random.PRNGKey(0), in_dim=8 * 8 * 3, num_classes=4,
                    hidden=16)
    jtask = jclassifier_task(japply)
    cfg_kw = dict(microbatch=4, batch_min=4, batch_max=64, every=100)
    jfactory = lambda b: jbuild(  # noqa: E731
        "tvlars", total_steps=50, learning_rate=BASE_LR, batch_size=b,
        base_batch_size=BASE_BATCH)
    jctrl = jcontroller.AdaptiveBatchController(
        lambda opt, k: jmake_train_step(jtask, opt, accum_steps=k),
        jfactory, _stub_probe(1.0), jcontroller.ControllerConfig(**cfg_kw),
        init_batch=8, base_lr=BASE_LR, base_batch_size=BASE_BATCH)
    ctrl = AdaptiveBatchController(
        lambda opt, k: make_train_step(TASK, opt, accum_steps=k),
        _factory(), _stub_probe(1.0), ControllerConfig(**cfg_kw),
        init_batch=8, base_lr=BASE_LR, base_batch_size=BASE_BATCH)
    jsrc = jsource(jdata, seed=0)

    def tsrc(start, count):
        x, y = jsrc(start, count)
        return (torch.from_numpy(np.array(x)),
                torch.from_numpy(np.array(y).astype(np.int64)))

    jstream = JStream(jsrc, microbatch=4)
    stream = pipeline.MicrobatchedStream(tsrc, microbatch=4)
    jctrl.attach(jstream)
    ctrl.attach(stream)
    jstate = JTrainState.create(jparams, jctrl.optimizer())
    tol = ref.parity_tolerance("f32")
    for i in range(6):
        if i == 3:
            assert jctrl.retarget(32) and ctrl.retarget(32)
        assert ctrl.accum_steps == jctrl.accum_steps == (2 if i < 3 else 8)
        state = _state_from_jax(jstate)
        jstate, jm = jctrl.step_fn()(jstate, *next(jstream))
        state, m = ctrl.step_fn()(state, next(stream))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        want = _state_from_jax(jstate)
        for a, b in zip(tree_leaves(state.params), tree_leaves(want.params)):
            scale = float(b.abs().max())
            np.testing.assert_allclose(a.detach().numpy(), b.numpy(),
                                       rtol=tol["rtol"],
                                       atol=tol["atol"] * scale,
                                       err_msg=f"step {i}")
    assert stream.position == jstream.position == 3 * 8 + 3 * 32
    assert ctrl.lr == jctrl.lr
