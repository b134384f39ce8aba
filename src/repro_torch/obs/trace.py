"""Low-overhead span tracer: the port's copy of ``repro.obs.trace``.

One :class:`Tracer` per run records where host time goes (the serving
engine's ``admit`` / ``prefill`` / ``decode`` / ``sample`` /
``finish`` phases). Events live in a bounded in-memory ring (old
events drop first) and are timestamped on the monotonic
``perf_counter_ns`` clock relative to the tracer's epoch. They come
out as **trace-v1** records:

    {"step": int, "trace": "v1", "kind": "span"|"instant"|"counter",
     "name": str, "ts_us": float, "dur_us": float (span only),
     "value": number (counter only), "tid": str, ...scalar attrs}

which ``tools/render_trace.py`` and ``tools/obs_report.py`` read
unchanged (``launch/serve.py --trace-out`` writes them as JSONL).

Overhead: a disabled tracer (or the shared :data:`NULL`) returns one
shared ``nullcontext`` from :meth:`span` — no allocation, no clock
read. An enabled span costs two ``perf_counter_ns`` calls and one
deque append.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Iterable, Optional

TRACE_VERSION = "v1"
KINDS = ("span", "instant", "counter")

_NULL_CTX = contextlib.nullcontext()


class _Span:
    """Context manager recording one span event on exit."""

    __slots__ = ("_tracer", "_name", "_step", "_attrs", "_start")

    def __init__(self, tracer: "Tracer", name: str, step, attrs):
        self._tracer = tracer
        self._name = name
        self._step = step
        self._attrs = attrs

    def __enter__(self) -> "_Span":
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        t = self._tracer
        t._ring.append((
            "span", self._name, self._step,
            (self._start - t._t0) / 1e3, (end - self._start) / 1e3,
            threading.current_thread().name, self._attrs))


class Tracer:
    """Bounded-ring span/instant/counter recorder on a monotonic clock.

    ``capacity`` bounds the in-memory event count (FIFO eviction);
    ``enabled=False`` turns every :meth:`span` into the shared no-op
    context manager, so call sites never branch.  Thread-compat: the
    ring is a ``deque`` (append is atomic under the GIL); each event
    carries its recording thread's name as ``tid``.
    """

    def __init__(self, capacity: int = 65536, *, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._t0 = time.perf_counter_ns()

    # ------------------------------------------------------- recording
    def span(self, name: str, *, step: Optional[int] = None, **attrs):
        """Context manager timing a phase; records on exit."""
        if not self.enabled:
            return _NULL_CTX
        return _Span(self, name, step, attrs)

    def instant(self, name: str, *, step: Optional[int] = None,
                **attrs) -> None:
        """Zero-duration marker (e.g. a controller switch decision)."""
        if not self.enabled:
            return
        self._ring.append((
            "instant", name, step,
            (time.perf_counter_ns() - self._t0) / 1e3, None,
            threading.current_thread().name, attrs))

    def counter(self, name: str, value: float, *,
                step: Optional[int] = None) -> None:
        """Sampled scalar series (renders as a counter track)."""
        if not self.enabled:
            return
        self._ring.append((
            "counter", name, step,
            (time.perf_counter_ns() - self._t0) / 1e3, None,
            threading.current_thread().name, {"value": float(value)}))

    # ------------------------------------------------------- consuming
    def __len__(self) -> int:
        return len(self._ring)

    def __bool__(self) -> bool:
        # "is this tracer recording" — NOT len(ring): an enabled tracer
        # with no events yet must survive ``tracer or NULL``
        return self.enabled

    def events(self) -> list[dict]:
        """Snapshot of the ring as trace-v1 record dicts (oldest
        first); does not drain."""
        return [self._record(e) for e in list(self._ring)]

    def drain(self) -> list[dict]:
        """Pop every buffered event as trace-v1 records."""
        out = []
        while True:
            try:
                out.append(self._record(self._ring.popleft()))
            except IndexError:
                return out

    @staticmethod
    def _record(event: tuple) -> dict:
        kind, name, step, ts_us, dur_us, tid, attrs = event
        rec = {"trace": TRACE_VERSION, "kind": kind, "name": name,
               "ts_us": round(ts_us, 3), "tid": tid}
        if step is not None:
            rec["step"] = int(step)
        if kind == "span":
            rec["dur_us"] = round(dur_us, 3)
        if attrs:
            rec.update(attrs)
        return rec

    def export(self, sink, *, drain: bool = True) -> int:
        """Stream buffered events through a ``MetricsSink`` as trace-v1
        records (the record's ``step`` defaults to 0 for step-less
        events, keeping the JSONL contract's int-``step`` invariant).
        Returns the number of records written."""
        records = self.drain() if drain else self.events()
        for i, rec in enumerate(records):
            step = rec.pop("step", 0)
            sink.write(step, rec, last=i == len(records) - 1)
        return len(records)


#: Shared disabled tracer — call sites default a ``tracer=None``
#: argument to this and trace unconditionally; the null path costs one
#: attribute check.
NULL = Tracer(capacity=1, enabled=False)


def phase_summary(records: Iterable[dict]) -> dict[str, dict[str, Any]]:
    """Aggregate span records into a per-phase breakdown:
    ``{name: {count, total_ms, mean_us, max_us}}`` — the number
    ``tools/obs_report.py`` prints.  Non-span records are ignored."""
    acc: dict[str, list[float]] = {}
    for rec in records:
        if rec.get("trace") != TRACE_VERSION or rec.get("kind") != "span":
            continue
        acc.setdefault(rec["name"], []).append(float(rec["dur_us"]))
    return {
        name: {"count": len(durs),
               "total_ms": round(sum(durs) / 1e3, 3),
               "mean_us": round(sum(durs) / len(durs), 1),
               "max_us": round(max(durs), 1)}
        for name, durs in sorted(acc.items())
    }
