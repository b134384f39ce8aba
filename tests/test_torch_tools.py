"""The port's two tools against the JAX package's, on the CPU.

* ``tools/torch_validate_metrics.py`` gives ``tools/validate_metrics.py``'s
  exit code and OK / FAIL lines on the same files: a port launcher run's
  ``--metrics-out`` and ``--trace-out``, an empty file, a record with a
  non-int step, a malformed trace-v1 record, a missing literal path, a
  glob that matches nothing (with and without ``--allow-empty``), and the
  record-count floors.
* ``tools/render_trace.py`` and ``tools/obs_report.py`` (which import no
  JAX) read the port's trace and metrics as they are.
* ``tools/torch_buffers.py`` on qwen2.5-3b × prefill_32k: the top buffer
  live at the peak is the rank's whole [B, S, V] logits block, and
  ``temp + arg`` is the dry run's ``peak_bytes``; the live-buffer
  bookkeeping (``dryrun.trace(buffers=True)``) changes no number of the
  default trace.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re

import pytest

from torch_threads import one_thread  # noqa: F401  (autouse)
from torch_repo_file import ROOT, load
import torch_sp_ref as sp
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch import train as launch_train



def tool(name: str):
    return load(f"tools/{name}.py", f"tool_{name}")


def call(mod, argv: list) -> tuple:
    """``mod.main(argv)``: its exit code and its stdout and stderr lines."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(argv)
    return rc, out.getvalue().splitlines(), err.getvalue().splitlines()


@pytest.fixture(scope="module")
def run_files(tmp_path_factory):
    """A port launcher run's metrics (with the layer-wise stream) and
    trace."""
    tmp = tmp_path_factory.mktemp("launcher")
    metrics, trace = str(tmp / "m.jsonl"), str(tmp / "t.jsonl")
    launch_train.run(["--smoke", "--device", "cpu", "--steps", "2",
                      "--seq", "16", "--global-batch", "4",
                      "--layerwise-every", "1", "--metrics-out", metrics,
                      "--trace-out", trace], log_fn=lambda *_: None)
    return metrics, trace


def _write(path, lines) -> str:
    with open(path, "w") as f:
        f.write("".join(line + "\n" for line in lines))
    return str(path)


CASES = {
    "metrics": lambda d, m, t: [m, "--min-records", "1"],
    "trace": lambda d, m, t: [t, "--min-trace-records", "1"],
    "both, glob": lambda d, m, t: [os.path.join(os.path.dirname(m),
                                                "*.jsonl")],
    "metrics without a trace": lambda d, m, t: [m, "--min-trace-records",
                                                "1"],
    "too few records": lambda d, m, t: [m, "--min-records", "1000"],
    "empty file": lambda d, m, t: [_write(d / "empty.jsonl", [])],
    "empty file allowed none": lambda d, m, t: [
        _write(d / "empty.jsonl", []), "--min-records", "0"],
    "non-int step": lambda d, m, t: [_write(
        d / "step.jsonl", ['{"step": 0, "loss": 1.0}',
                           '{"step": "1", "loss": 1.0}'])],
    "malformed trace-v1": lambda d, m, t: [_write(
        d / "bad_trace.jsonl", ['{"step": 0, "trace": "v1", "kind": '
                                '"span", "name": "x", "ts_us": 1.0}'])],
    "missing literal path": lambda d, m, t: [str(d / "nope.jsonl")],
    "glob matching nothing": lambda d, m, t: [str(d / "none_*.jsonl")],
    "glob matching nothing, --allow-empty": lambda d, m, t: [
        str(d / "none_*.jsonl"), "--allow-empty"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_validate_twin_gives_the_reference_verdicts(case, run_files,
                                                    tmp_path):
    argv = CASES[case](tmp_path, *run_files)
    want = call(tool("validate_metrics"), argv)
    got = call(tool("torch_validate_metrics"), argv)
    assert got == want
    assert any("validate_metrics: " in line for line in got[1] + got[2])


def test_validate_twin_accepts_the_launchers_files(run_files):
    rc, out, err = call(tool("torch_validate_metrics"),
                        [*run_files, "--min-records", "1"])
    assert rc == 0 and not err
    assert [line.split()[1] for line in out] == ["OK", "OK"]


def test_render_trace_reads_the_ports_trace(run_files, tmp_path):
    _, trace = run_files
    out = str(tmp_path / "t.perfetto.json")
    rc, _, _ = call(tool("render_trace"), [trace, "-o", out])
    assert rc == 0
    with open(out) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e["ph"] == "X"}
    assert {"data_wait", "dispatch", "loss_grad", "optimizer"} <= names


def test_obs_report_reads_the_ports_trace_and_metrics(run_files):
    metrics, trace = run_files
    rc, out, _ = call(tool("obs_report"), ["--trace", trace, "--metrics",
                                           metrics, "--top-k", "3"])
    assert rc == 0
    text = "\n".join(out)
    assert "loss_grad" in text and "optimizer" in text
    sharpest = text.split("sharpest")[1]
    assert len(re.findall(r"^\s*\S+/\S+", sharpest, re.M)) >= 3


def test_buffers_twin_names_the_logits_block(monkeypatch):
    """qwen2.5-3b × prefill_32k on the (16, 16) mesh: a rank's 2 rows of
    32768 positions over the whole vocabulary, gathered over the model
    row, are the largest buffer live at the peak (their 16 gathered
    blocks are live beside them)."""
    tb = tool("torch_buffers")
    seen = []
    real = dryrun.dryrun_one

    def recording(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(tb.dryrun, "dryrun_one", recording)
    rc, out, _ = call(tb, ["qwen2.5-3b", "prefill_32k"])
    assert rc == 0
    got = seen[0]
    cfg = get_config("qwen2.5-3b")
    arg, peak = got["argument_bytes"], got["peak_bytes"]
    assert out[0] == (f"temp {(peak - arg) / 2**30:.2f} "
                      f"arg {arg / 2**30:.2f} GiB")
    top = tb.top_buffers(got["peak_buffers"])
    n, count, shape, dtype, _ = top[0]
    assert shape == (32 // 16, 32768, cfg.vocab_size)
    assert n == 2 * 32768 * cfg.vocab_size * 2 and dtype == "bfloat16"
    assert f"{dtype}[{','.join(map(str, shape))}]" in out[1]
    # the peak is what the buffers live at it add up to
    assert sum(b[0] for b in got["peak_buffers"]) == peak - arg


@pytest.mark.parametrize("shape", list(sp.TINY_SHAPES))
def test_buffer_bookkeeping_changes_no_dry_run_number(shape):
    """With and without ``buffers``, the same trace's numbers (the
    tests' tiny shapes on a (2, 4) dry mesh), after a first trace: a
    process's first train step also counts what it caches on first use
    (7,652 bytes more at tiny_train)."""
    def traced(buffers):
        with sp.tiny_shapes() as dr:
            try:
                mesh = dr.DryMesh(2, 4)
                return dr.trace(dr.build_step("qwen2.5-3b", shape, mesh),
                                mesh, buffers=buffers)
            finally:
                dryrun.L.set_batch_sharding(None)
    traced(False)
    plain, flagged = traced(False), traced(True)
    held = flagged.pop("peak_buffers")
    assert flagged == plain
    assert sum(b[0] for b in held) == plain["peak_bytes"] \
        - plain["argument_bytes"]
