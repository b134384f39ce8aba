"""The port's profiler window and layer-wise history against the JAX
package's, on the CPU.

* ``StepProfiler`` with injected start/stop calls them at the same
  steps as the reference's for the same windows (a window that outruns
  the loop is stopped by ``close``; one that starts after it never
  starts), and validates as the reference does.
* Its default ``torch.profiler`` window writes a Chrome trace on the
  CPU, from a plain loop, from ``fit(options=FitOptions(profiler=))``
  (closed even when a step raises) and from ``launch.train
  --profile-dir``.
* ``LayerwiseHistory`` keeps the same steps and snapshots as the
  reference's for the same offers.
"""
from __future__ import annotations

import json

import pytest
import torch

from repro.obs import LayerwiseHistory as JLayerwiseHistory
from repro.obs import StepProfiler as JStepProfiler
from repro_torch.core import build_optimizer
from repro_torch.data.synthetic import ClassificationData, batch_iterator
from repro_torch.launch import train as launch_train
from repro_torch.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch.obs import LayerwiseHistory, StepProfiler, profile
from repro_torch.obs.profiler import TRACE_NAME
from repro_torch.training import (FitOptions, TrainState, classifier_task,
                                  fit, make_train_step)


def _calls(cls, start, steps, n):
    log = []
    prof = cls("dir", start=start, steps=steps,
               start_fn=lambda d: log.append(("start", d)),
               stop_fn=lambda: log.append(("stop",)))
    for i in range(n):
        prof.step(i)
        log.append(("step", i, prof.running))
    prof.close()
    prof.close()
    return log


@pytest.mark.parametrize("start,steps,n", [
    (0, 1, 5), (2, 3, 10), (3, 5, 5), (10, 2, 5), (1, 1, 2)])
def test_step_profiler_matches_reference_windows(start, steps, n):
    assert _calls(StepProfiler, start, steps, n) == \
        _calls(JStepProfiler, start, steps, n)


def test_step_profiler_validates_as_reference():
    for kw in ({"steps": 0}, {"start": -1}):
        for cls in (StepProfiler, JStepProfiler):
            with pytest.raises(ValueError):
                cls("d", **kw)
    assert profile("d", start=2, steps=3).start == 2


def _trace_events(logdir):
    with open(logdir / TRACE_NAME) as f:
        return json.load(f)["traceEvents"]


def test_default_window_writes_a_chrome_trace(tmp_path):
    prof = StepProfiler(str(tmp_path / "p"), start=1, steps=2)
    x = torch.randn(64, 64)
    for i in range(5):
        prof.step(i)
        x = torch.tanh(x @ x)
    prof.close()
    names = {e.get("name") for e in _trace_events(tmp_path / "p")}
    assert "aten::mm" in names or "aten::matmul" in names


@pytest.mark.parametrize("fail_at", [None, 2])
def test_fit_drives_and_closes_the_profiler(fail_at):
    log = []
    prof = StepProfiler("d", start=1, steps=10,
                        start_fn=lambda d: log.append("start"),
                        stop_fn=lambda: log.append("stop"))
    params = init_mlp_classifier(0, in_dim=192, num_classes=4, hidden=16,
                                 device="cpu")
    opt = build_optimizer("tvlars", total_steps=10, learning_rate=0.4,
                          batch_size=16, use_kernel="fused", device="cpu")
    inner = make_train_step(classifier_task(apply_mlp_classifier), opt)

    def step(state, batch):
        if state.step == fail_at:
            raise RuntimeError("step failed")
        return inner(state, batch)

    data = ClassificationData(num_classes=4, image_size=8)
    run = lambda: fit(step, TrainState.create(params, opt),  # noqa: E731
                      batch_iterator(data, 16, device="cpu"), 4,
                      options=FitOptions(profiler=prof))
    if fail_at is None:
        run()
    else:
        with pytest.raises(RuntimeError, match="step failed"):
            run()
    assert log == ["start", "stop"] and not prof.running


def test_launch_train_profile_dir_writes_a_trace(tmp_path):
    out = launch_train.run(["--smoke", "--device", "cpu", "--steps", "3",
                            "--seq", "16", "--use-kernel", "fused",
                            "--profile-dir", str(tmp_path),
                            "--profile-start", "1", "--profile-steps",
                            "1"], log_fn=lambda *_: None)
    assert len(out["losses"]) == 3
    names = {e.get("name") for e in _trace_events(tmp_path)}
    assert any(str(n).startswith("aten::") for n in names)


@pytest.mark.parametrize("capacity,offers", [(2, 9), (3, 20), (4, 37)])
def test_layerwise_history_matches_reference(capacity, offers):
    ours, ref = LayerwiseHistory(capacity), JLayerwiseHistory(capacity)
    for i in range(offers):
        snap = {"layerwise/w/trust_ratio": float(i) / 7}
        assert ours.add(3 * i, snap) == ref.add(3 * i, snap)
    assert ours.steps == ref.steps and ours.snapshots == ref.snapshots
    assert ours.stride == ref.stride and len(ours) == len(ref)
    with pytest.raises(ValueError, match="capacity"):
        LayerwiseHistory(1)
