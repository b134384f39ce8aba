"""``torch.profiler`` windowing hooks for the training loops: the port
of ``repro.obs.profiler``.

A :class:`StepProfiler` starts a profiler trace at a chosen step and
stops it a fixed number of steps later, so a bounded window can be
captured from an arbitrarily long run: ``fit(..., options=FitOptions(
profiler=...))`` and the launcher's ``--profile-dir / --profile-start /
--profile-steps`` drive it, or::

    prof = obs.profile(logdir="/tmp/prof", start=10, steps=5)
    fit(step_fn, state, batches, 100, options=FitOptions(profiler=prof))

The default start and stop run ``torch.profiler.profile`` over the CPU
and, where CUDA is available, the card, and export the window as a
Chrome trace (``trace.json``) into ``logdir``. ``close()`` (called by
the loops in their ``finally``) stops a still-open window, so a crash
mid-window still writes the trace.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

TRACE_NAME = "trace.json"


def _torch_window() -> tuple[Callable[[str], None], Callable[[], None]]:
    """A (start, stop) pair around one ``torch.profiler.profile``."""
    held: dict = {}

    def start(logdir: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        prof = profile(activities=activities)
        prof.start()
        held["prof"], held["logdir"] = prof, logdir

    def stop() -> None:
        prof = held.pop("prof")
        prof.stop()
        prof.export_chrome_trace(os.path.join(held.pop("logdir"),
                                              TRACE_NAME))

    return start, stop


class StepProfiler:
    """Start/stop a profiler trace over the step window
    ``[start, start + steps)``.

    ``start_fn`` / ``stop_fn`` default to a ``torch.profiler`` window
    that exports a Chrome trace into ``logdir``, and are injectable for
    tests (and for other backends). ``step(i)`` is called once per loop
    iteration *before* the step's work; the window triggers at most
    once per profiler instance.
    """

    def __init__(self, logdir: str, *, start: int = 0, steps: int = 1,
                 start_fn: Optional[Callable[[str], None]] = None,
                 stop_fn: Optional[Callable[[], None]] = None):
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        if start < 0:
            raise ValueError(f"start must be >= 0, got {start}")
        self.logdir = logdir
        self.start = int(start)
        self.steps = int(steps)
        default_start, default_stop = _torch_window()
        self._start_fn = start_fn or default_start
        self._stop_fn = stop_fn or default_stop
        self._running = False
        self._done = False

    @property
    def running(self) -> bool:
        return self._running

    def step(self, i: int) -> None:
        """Advance the window: arm at ``start``, disarm after the
        window's last step."""
        if not self._done and not self._running and i >= self.start:
            self._start_fn(self.logdir)
            self._running = True
        elif self._running and i >= self.start + self.steps:
            self._stop()

    def _stop(self) -> None:
        self._running = False
        self._done = True
        self._stop_fn()

    def close(self) -> None:
        """Stop a still-open window (idempotent; loops call this in
        their ``finally`` so short runs and crashes still write)."""
        if self._running:
            self._stop()


def profile(logdir: str, *, start: int = 0, steps: int = 1,
            **kw) -> StepProfiler:
    """Programmatic window: ``obs.profile(logdir, start=, steps=)``."""
    return StepProfiler(logdir, start=start, steps=steps, **kw)
