"""The paper's experiment launchers in ``repro_torch.launch``
(``table1``, ``ssl``, ``fig2_lnr``, ``ablations``, ``schedules``,
``adaptive_batch``) against the JAX package's ``benchmarks/bench_*.py``,
on the CPU.

* Each launcher runs with a few steps and writes its files with the
  reference's columns.
* Table 1 (one grid cell, all five optimizers) and Fig. 2 (all three
  optimizers) at 3 steps on the reference's weights, batches and eval
  set, against the reference's ``run_classification``: each step's loss
  within ``ref.parity_tolerance("f32")`` relative (1e-6, summation
  order), accuracy within 0.005 absolute (the reference's own
  tie band in ``bench_table1.py``), and Fig. 2's per-step LWN / LGN /
  LNR within 1e-5 relative (norms of the same params and gradients).
* The schedules CSV against ``bench_schedules.py``'s, to rtol 1e-6 with
  an absolute floor of one f32 unit at the curves' scale (2^-23: the
  warm-up cosine's 1 + cos(πt) cancels near its end, where the two
  libraries' f32 cosines differ in the last bit).
* ``models.cnn.INITS`` equal across the two packages; the launchers'
  constants equal the benches'.
"""
from __future__ import annotations

import csv
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.models import cnn as jcnn
from repro.models.cnn import init_mlp_classifier as jinit
from repro_torch.core import build_optimizer
from repro_torch.kernels import ref
from repro_torch.launch import (ablations, adaptive_batch, classify,
                                fig2_lnr, paper_io, schedules, ssl, table1)
from repro_torch.models import cnn
from repro_torch.models.convert import classifier_params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def benches():
    """The reference's benchmark modules (the repository root on the
    import path for the duration of the import)."""
    sys.path.insert(0, ROOT)
    try:
        from benchmarks import (bench_ablations, bench_adaptive_batch,
                                bench_fig2_lnr, bench_schedules, bench_ssl,
                                bench_table1, common, paper_runs)
    finally:
        sys.path.remove(ROOT)
    return dict(table1=bench_table1, ssl=bench_ssl, fig2=bench_fig2_lnr,
                ablations=bench_ablations, schedules=bench_schedules,
                adaptive=bench_adaptive_batch, common=common,
                paper_runs=paper_runs)


def _header(path):
    with open(path, newline="") as f:
        return next(csv.reader(f))


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))[1:]


# the reference's CSV columns: benchmarks/bench_*.py, write_csv / CsvSink
COLUMNS = {
    "table1": ["optimizer", "batch", "lr", "accuracy", "final_loss"],
    "table1_ssl": ["optimizer", "batch", "probe_acc"],
    "fig2_lnr_traces": ["step", "optimizer", "lwn", "lgn", "lnr", "loss"],
    "fig5_lambda": ["batch", "lambda", "accuracy", "loss"],
    "fig6_lr": ["batch", "lr", "accuracy", "loss"],
    "fig7_init": ["init", "optimizer", "accuracy"],
    "schedules_fig1_fig4": ["step", "warmup_cosine", "polynomial",
                            "tvlars_1e-2", "tvlars_5e-3", "tvlars_1e-3",
                            "tvlars_1e-4", "tvlars_1e-5"],
}
LAUNCHERS = {
    "table1": (table1, ["--steps", "2"], ["table1"]),
    "ssl": (ssl, ["--steps", "2", "--clf-steps", "2"], ["table1_ssl"]),
    "fig2": (fig2_lnr, ["--steps", "2"], ["fig2_lnr_traces"]),
    "ablations": (ablations, ["--steps", "2"],
                  ["fig5_lambda", "fig6_lr", "fig7_init"]),
    "schedules": (schedules, ["--steps", "100"], ["schedules_fig1_fig4"]),
}


@pytest.mark.parametrize("name", list(LAUNCHERS))
def test_launcher_writes_the_reference_columns(name, benches, tmp_path):
    module, argv, files = LAUNCHERS[name]
    lines = []
    module.run(["--device", "cpu", "--out-dir", str(tmp_path)] + argv,
               log_fn=lines.append)
    with open(benches[name].__file__) as f:
        bench_source = f.read()
    for stem in files:
        path = tmp_path / f"{stem}.csv"
        assert _header(path) == COLUMNS[stem]
        assert _rows(path)
        for col in COLUMNS[stem]:
            assert f'"{col}"' in bench_source, (stem, col)
    assert all(line.count(",") >= 2 for line in lines)


def test_launcher_constants_equal_the_benches(benches):
    assert table1.GRID == benches["table1"].GRID
    assert table1.OPTS == benches["table1"].OPTS
    assert cnn.INITS == jcnn.INITS
    assert (schedules.TOTAL, schedules.DELAY) == (
        benches["schedules"].TOTAL, benches["schedules"].DELAY)
    assert (fig2_lnr.BATCH, fig2_lnr.LR) == (benches["fig2"].BATCH,
                                             benches["fig2"].LR)
    a = benches["adaptive"]
    assert (adaptive_batch.MICROBATCH, adaptive_batch.BATCH_MAX,
            adaptive_batch.LR, adaptive_batch.STEPS, adaptive_batch.EVERY,
            adaptive_batch.PROBE_K) == (a.MICROBATCH, a.BATCH_MAX, a.LR,
                                        a.STEPS, a.EVERY, a.PROBE_K)
    assert classify.BASE_BATCH == benches["paper_runs"].BASE_BATCH
    d, jd = classify.DATA, benches["paper_runs"].DATA
    assert (d.num_classes, d.image_size, d.channels, d.mean_scale,
            d.noise_scale, d.label_noise, d.seed) == (
        jd.num_classes, jd.image_size, jd.channels, jd.mean_scale,
        jd.noise_scale, jd.label_noise, jd.seed)


def test_per_tensor_optimizers_are_those_build_optimizer_accepts():
    for name in table1.OPTS:
        build = lambda: build_optimizer(  # noqa: E731
            name, total_steps=4, use_kernel="per_tensor", device="cpu")
        if name in paper_io.PER_TENSOR_OPTS:
            build()
        else:
            with pytest.raises(ValueError, match="per_tensor"):
                build()
    assert paper_io.kernel_for("lamb", "per_tensor") is False
    assert paper_io.kernel_for("wa-lars", "per_tensor") == "per_tensor"
    assert paper_io.kernel_for("wa-lars", "off") is False


def test_table1_per_tensor_runs_the_accepting_optimizers(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(table1, "GRID", {256: [0.3]})
    out = table1.run(["--device", "cpu", "--steps", "2", "--use-kernel",
                      "per_tensor", "--out-dir", str(tmp_path)],
                     log_fn=lambda *_: None)
    assert [r[0] for r in out["rows"]] == list(paper_io.PER_TENSOR_OPTS)
    assert out["wins"] is None


def test_adaptive_batch_launcher_switches(tmp_path):
    out = adaptive_batch.run(["--device", "cpu", "--steps", "7",
                              "--out-dir", str(tmp_path)],
                             log_fn=lambda *_: None)
    assert out["switches"] and out["switches"][0]["step"] == 5
    assert out["compiles"] == len(out["visited_ks"]) == 2
    for name in ("wa-lars", "tvlars", "adaptive"):
        path = tmp_path / f"adaptive_batch_{name}.jsonl"
        recs = [json.loads(line) for line in path.read_text().splitlines()]
        assert len([r for r in recs if "loss" in r]) == 7
    assert all(0.0 <= a <= 1.0 for a in out["accuracy"].values())


# ----------------------------------- on the reference's weights and data
class _RefData:
    """Stands in for ``classify.DATA``: the reference's eval set."""

    def __init__(self, jdata):
        x, y = jdata.eval_set(2048)
        self.xe = torch.from_numpy(np.array(x))
        self.ye = torch.from_numpy(np.array(y).astype(np.int64))

    def eval_set(self, n, device="cuda"):
        assert n == 2048
        return self.xe, self.ye


def _on_reference_samples(monkeypatch, paper_runs):
    """Route the port's ``run_classification`` through the reference's
    initial weights, batches and eval set; returns the record of its
    results by (optimizer, batch, lr)."""
    jdata = paper_runs.DATA

    def init(seed, *, in_dim, num_classes, hidden, init_method, device):
        jp = jinit(jax.random.PRNGKey(seed), in_dim=in_dim,
                   num_classes=num_classes, hidden=hidden,
                   init_method=init_method)
        return classifier_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), device=device)

    def batches(data, batch_size, device="cuda"):
        from repro.data.synthetic import batch_iterator as jbatches
        for x, y in jbatches(jdata, batch_size):
            yield (torch.from_numpy(np.array(x)),
                   torch.from_numpy(np.array(y).astype(np.int64)))

    monkeypatch.setattr(classify, "init_mlp_classifier", init)
    monkeypatch.setattr(classify, "batch_iterator", batches)
    monkeypatch.setattr(classify, "DATA", _RefData(jdata))
    seen = {}
    real = classify.run_classification

    def spy(opt, batch, lr, **kw):
        out = real(opt, batch, lr, **kw)
        seen[(opt, batch, lr)] = out
        return out

    monkeypatch.setattr(classify, "run_classification", spy)
    return seen


def _hold(got, want, what):
    acc, hist, rec = got
    jacc, jhist, jrec = want
    tol = ref.parity_tolerance("f32")
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [float(h["loss"]) for h in jhist],
                               rtol=tol["rtol"], err_msg=what)
    assert abs(acc - jacc) <= 0.005, (what, acc, jacc)
    if rec is not None:
        arrs, jarrs = rec.as_arrays(), jrec.as_arrays()
        for key in ("lwn", "lgn", "lnr"):
            np.testing.assert_allclose(np.asarray(arrs[key]),
                                       np.asarray(jarrs[key]), rtol=1e-5,
                                       err_msg=f"{what} {key}")


def test_table1_on_reference_samples(benches, monkeypatch, tmp_path):
    seen = _on_reference_samples(monkeypatch, benches["paper_runs"])
    monkeypatch.setattr(table1, "GRID", {512: [1.0]})
    out = table1.run(["--device", "cpu", "--steps", "3", "--out-dir",
                      str(tmp_path)], log_fn=lambda *_: None)
    assert len(out["rows"]) == len(table1.OPTS)
    for opt in table1.OPTS:
        want = benches["paper_runs"].run_classification(opt, 512, 1.0,
                                                        steps=3)
        _hold(seen[(opt, 512, 1.0)], want, opt)


def test_fig2_on_reference_samples(benches, monkeypatch, tmp_path):
    seen = _on_reference_samples(monkeypatch, benches["paper_runs"])
    out = fig2_lnr.run(["--device", "cpu", "--steps", "3", "--out-dir",
                        str(tmp_path)], log_fn=lambda *_: None)
    rows = _rows(out["path"])
    assert len(rows) == 3 * len(fig2_lnr.OPTS)
    for opt in fig2_lnr.OPTS:
        want = benches["paper_runs"].run_classification(
            opt, fig2_lnr.BATCH, fig2_lnr.LR, steps=3, record_norms=True)
        _hold(seen[(opt, fig2_lnr.BATCH, fig2_lnr.LR)], want, opt)
        np.testing.assert_allclose(
            out["summaries"][opt]["max_initial_lnr"],
            want[2].summary()["max_initial_lnr"], rtol=1e-5)


def test_schedules_csv_equals_the_bench(benches, monkeypatch, tmp_path):
    ref_dir = tmp_path / "ref"
    monkeypatch.setattr(benches["common"], "RESULTS_DIR", str(ref_dir))
    benches["schedules"].main()
    out = schedules.run(["--device", "cpu", "--out-dir",
                         str(tmp_path / "port")], log_fn=lambda *_: None)
    want_path = ref_dir / "schedules_fig1_fig4.csv"
    assert _header(out["path"]) == _header(want_path)
    got = np.array(_rows(out["path"]), dtype=np.float64)
    want = np.array(_rows(want_path), dtype=np.float64)
    assert got.shape == want.shape == (101, 8)
    # 1e-6 relative, with a floor of one f32 unit at the curves' scale
    # (the peak LR 1.0): the cosine's 1 + cos(πt) cancels near t = 1,
    # where the two libraries' f32 cos differ in the last bit
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=2.0 ** -23)
