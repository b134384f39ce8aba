"""Streaming metrics sinks: the port's copy of ``repro.diagnostics.sink``.

One write path for the trainer and the probes: the fit loop (and the
launcher) push one ``write(step, metrics)`` per global step, probes
push their results on their own schedule, and the sink decides the
representation:

* :class:`ConsoleSink` — the trainer's ``step  NNN k=v.vvvv ...`` line,
  gated by ``every``;
* :class:`JsonlSink` — one JSON object per write (``{"step": int,
  ...}``), streamed and flushed per record, the machine-readable
  probe trace (schema checked by :func:`validate_jsonl`). For the same
  records it writes the same bytes as the JAX package's sink, so
  ``tools/validate_metrics.py`` reads the port's files unchanged;
* :class:`CsvSink` — header from the first row, for flat tables like
  the Fig. 2 LNR traces;
* :class:`MemorySink` — in-memory record list, for tests;
* :class:`MultiSink` — fan-out to several sinks;
* :class:`BufferedSink` — wraps any sink and moves its writes onto a
  dedicated writer thread behind a bounded queue; record order is
  preserved exactly and ``close()`` drains the queue before closing
  the wrapped sink.

:func:`export_recorder` streams a ``NormRecorder``'s per-step
leaf-mean LWN/LGN/LNR through any sink.

Values may be Python scalars, numpy scalars and arrays, or 0-d and
1-d torch tensors on any device (a CUDA tensor is copied to the host
first, a bf16 one widened to f32); they are encoded as the reference
encodes the same numpy values.
"""
from __future__ import annotations

import csv
import json
import numbers
import os
import queue
import threading
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

Metrics = Mapping[str, Any]


def _finite(x: float) -> Optional[float]:
    # NaN/inf have no valid JSON encoding (json.dumps would emit the
    # spec-invalid NaN/Infinity tokens) -> null, which validate_jsonl
    # and downstream parsers both accept
    return x if np.isfinite(x) else None


def _host_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _jsonify(v: Any) -> Any:
    if isinstance(v, (str, bool)) or v is None:
        return v
    if isinstance(v, torch.Tensor):
        v = _host_array(v)
    if isinstance(v, numbers.Integral):
        return int(v)
    if isinstance(v, numbers.Real):
        return _finite(float(v))
    arr = np.asarray(v)
    if arr.ndim == 0:
        return _finite(float(arr))
    return [_finite(x) if isinstance(x, float) else x
            for x in arr.tolist()]


class MetricsSink:
    """write(step, metrics) stream; context-manager closeable.

    ``last=True`` marks the final step of a run so rate-limited sinks
    (console) can force a flush of the closing line.
    """

    def write(self, step: int, metrics: Metrics, *,
              last: bool = False) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self) -> "MetricsSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NullSink(MetricsSink):
    def write(self, step: int, metrics: Metrics, *,
              last: bool = False) -> None:
        pass


class MemorySink(MetricsSink):
    """In-memory record list (``{"step": int, **metrics}`` per write) —
    inspect the exact stream a file sink would have received without
    touching disk."""

    def __init__(self):
        self.records: list[dict] = []

    def write(self, step: int, metrics: Metrics, *,
              last: bool = False) -> None:
        self.records.append({"step": int(step),
                             **{k: _jsonify(v) for k, v in metrics.items()}})

    def by_key(self, key: str) -> list[tuple[int, Any]]:
        """``(step, value)`` pairs of the records carrying ``key``."""
        return [(r["step"], r[key]) for r in self.records if key in r]


class ConsoleSink(MetricsSink):
    """The trainer's historical console line, verbatim.

    Prints ``step {i:5d} k=v.vvvv ...`` for float-valued metrics when
    ``step % every == 0`` or on the last/probe write; ``every=0``
    silences it.
    """

    def __init__(self, every: int = 1, log_fn: Callable = print):
        self.every = every
        self.log_fn = log_fn

    def write(self, step: int, metrics: Metrics, *,
              last: bool = False) -> None:
        if not (self.every and (step % self.every == 0 or last)):
            return
        self.log_fn(f"step {step:5d} " + " ".join(
            f"{k}={v:.4f}" for k, v in metrics.items()
            if isinstance(v, float)))


class JsonlSink(MetricsSink):
    """Streamed JSONL: one ``{"step": int, **static, **metrics}``
    object per write, flushed immediately (tail -f friendly).

    The file is truncated on open by default so re-running a command
    with the same ``--metrics-out`` never interleaves stale records
    from a previous run; pass ``mode="a"`` to append deliberately
    (e.g. resuming a run).  Non-finite floats are written as ``null``
    — bare ``NaN`` tokens would make the file invalid JSON.
    """

    def __init__(self, path: str, *, static: Optional[Metrics] = None,
                 mode: str = "w"):
        if mode not in ("w", "a"):
            raise ValueError(f"mode must be 'w' or 'a', got {mode!r}")
        self.path = path
        self.static = dict(static or {})
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(path, mode)

    def write(self, step: int, metrics: Metrics, *,
              last: bool = False) -> None:
        record = {"step": int(step), **self.static,
                  **{k: _jsonify(v) for k, v in metrics.items()}}
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class CsvSink(MetricsSink):
    """Streaming CSV table for *homogeneous* rows; the header is
    ``step`` + the first row's keys, later rows drop unknown keys and
    blank missing ones.  A row sharing NO metric key with the header
    raises — a heterogeneous stream (e.g. training metrics + probe
    results from ``fit``) belongs in :class:`JsonlSink`, and dropping
    it silently would lose the probe trace."""

    def __init__(self, path: str,
                 fieldnames: Optional[list[str]] = None):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(path, "w", newline="")
        self._writer: Optional[csv.DictWriter] = None
        self._fieldnames = fieldnames

    def write(self, step: int, metrics: Metrics, *,
              last: bool = False) -> None:
        if self._writer is None:
            names = self._fieldnames or ["step"] + list(metrics)
            if "step" not in names:
                names = ["step"] + names
            self._writer = csv.DictWriter(self._f, fieldnames=names,
                                          restval="",
                                          extrasaction="ignore")
            self._writer.writeheader()
        if metrics and not set(metrics) & set(self._writer.fieldnames):
            raise ValueError(
                f"CsvSink({self.path!r}): row keys {sorted(metrics)} "
                f"share nothing with the header "
                f"{self._writer.fieldnames}; use JsonlSink for "
                f"heterogeneous metric streams")
        self._writer.writerow(
            {"step": int(step),
             **{k: _jsonify(v) for k, v in metrics.items()}})

    def close(self) -> None:
        self._f.close()


class MultiSink(MetricsSink):
    def __init__(self, *sinks: MetricsSink):
        self.sinks = sinks

    def write(self, step: int, metrics: Metrics, *,
              last: bool = False) -> None:
        for s in self.sinks:
            s.write(step, metrics, last=last)

    def close(self) -> None:
        for s in self.sinks:
            s.close()


class BufferedSink(MetricsSink):
    """Move a sink's writes onto a writer thread behind a bounded queue.

    ``write`` enqueues ``(step, metrics, last)`` and returns
    immediately; a single daemon thread drains the FIFO into the
    wrapped sink, so the output is byte-identical to (and in the same
    order as) writing the wrapped sink directly — only the *caller's*
    stall is removed.  The queue is bounded (``capacity``): if the
    writer falls behind, ``write`` blocks instead of buffering without
    limit, so a slow disk applies backpressure rather than OOM.

    The metrics mapping is shallow-copied at enqueue time — callers
    may mutate or reuse their dict after ``write`` returns.  A writer
    exception is captured and re-raised on the next ``write``/
    ``flush``/``close`` (on the caller's thread, where it is
    actionable).  ``close()`` drains everything already enqueued, joins
    the thread, then closes the wrapped sink; it is idempotent.
    """

    _CLOSE = object()

    def __init__(self, sink: MetricsSink, capacity: int = 1024):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.sink = sink
        self._q: queue.Queue = queue.Queue(maxsize=capacity)
        self._err: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="BufferedSink-writer", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is self._CLOSE:
                    return
                step, metrics, last = item
                if self._err is None:
                    self.sink.write(step, metrics, last=last)
            except BaseException as e:   # surfaced on the caller thread
                self._err = e
            finally:
                self._q.task_done()

    def _check(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def write(self, step: int, metrics: Metrics, *,
              last: bool = False) -> None:
        self._check()
        if self._closed:
            raise ValueError("write to a closed BufferedSink")
        self._q.put((int(step), dict(metrics), bool(last)))

    def flush(self) -> None:
        """Block until every record enqueued so far has been written."""
        self._q.join()
        self._check()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(self._CLOSE)
        self._thread.join()
        self.sink.close()
        self._check()


def export_recorder(recorder, sink: MetricsSink, *,
                    extra: Optional[Any] = None) -> int:
    """Stream ``NormRecorder`` history through ``sink``, one row per
    recorded step with leaf-mean ``lwn``/``lgn``/``lnr``.

    ``extra``: static dict of additional columns, or a callable
    ``(idx, step) -> dict`` for per-row columns (e.g. the loss trace).
    Returns the number of rows written.
    """
    arrs = recorder.as_arrays()
    for idx, step in enumerate(recorder.steps):
        if callable(extra):
            row = dict(extra(idx, step))
        else:
            row = dict(extra or {})
        row.update(lwn=float(arrs["lwn"][idx].mean()),
                   lgn=float(arrs["lgn"][idx].mean()),
                   lnr=float(arrs["lnr"][idx].mean()))
        sink.write(step, row, last=idx == len(recorder.steps) - 1)
    return len(recorder.steps)


#: trace-v1 ``kind`` vocabulary (mirrors ``repro_torch.obs.trace.KINDS``).
TRACE_KINDS = ("span", "instant", "counter")


def _validate_trace(rec: dict, where: str) -> None:
    """trace-v1 record rules, on top of the base metrics schema:
    ``kind`` in :data:`TRACE_KINDS`, non-empty str ``name``, numeric
    ``ts_us >= 0``; spans carry ``dur_us >= 0``, counters a numeric
    ``value``."""
    if rec["trace"] != "v1":
        raise ValueError(
            f"{where}: unknown trace version {rec['trace']!r} "
            f"(expected 'v1')")
    if rec.get("kind") not in TRACE_KINDS:
        raise ValueError(
            f"{where}: trace 'kind' is {rec.get('kind')!r}, expected "
            f"one of {TRACE_KINDS}")
    name = rec.get("name")
    if not isinstance(name, str) or not name:
        raise ValueError(f"{where}: trace 'name' must be a non-empty "
                         f"string, got {name!r}")
    ts = rec.get("ts_us")
    if isinstance(ts, bool) or not isinstance(ts, (int, float)) or ts < 0:
        raise ValueError(f"{where}: trace 'ts_us' must be a number "
                         f">= 0, got {ts!r}")
    if rec["kind"] == "span":
        dur = rec.get("dur_us")
        if isinstance(dur, bool) or not isinstance(dur, (int, float)) \
                or dur < 0:
            raise ValueError(f"{where}: span 'dur_us' must be a number "
                             f">= 0, got {dur!r}")
    if rec["kind"] == "counter":
        value = rec.get("value")
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ValueError(f"{where}: counter 'value' must be a "
                             f"number, got {value!r}")


def validate_jsonl(path: str, *, counts: bool = False):
    """Schema-check a metrics JSONL: every line a JSON object with an
    int ``step`` and only scalar/str/bool/list values.  Lines carrying
    ``"trace": "v1"`` (a :class:`repro_torch.obs.trace.Tracer` export) are
    additionally held to the trace-v1 rules — valid kind, non-empty
    name, non-negative ``ts_us`` (plus ``dur_us`` for spans and a
    numeric ``value`` for counters).

    Returns the record count, or with ``counts=True`` a
    ``(total, trace)`` pair so callers can assert a run actually
    exported its timeline; raises ``ValueError`` on any violation."""
    n = n_trace = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{path}:{lineno}: not valid JSON: {e}") from e
            if not isinstance(rec, dict):
                raise ValueError(f"{path}:{lineno}: record is "
                                 f"{type(rec).__name__}, expected object")
            if not isinstance(rec.get("step"), int) \
                    or isinstance(rec.get("step"), bool):
                raise ValueError(
                    f"{path}:{lineno}: missing/non-int 'step' field")
            for k, v in rec.items():
                if not isinstance(v, (int, float, str, bool, list,
                                      type(None))):
                    raise ValueError(
                        f"{path}:{lineno}: field {k!r} has "
                        f"non-scalar type {type(v).__name__}")
            if "trace" in rec:
                _validate_trace(rec, f"{path}:{lineno}")
                n_trace += 1
            n += 1
    return (n, n_trace) if counts else n
