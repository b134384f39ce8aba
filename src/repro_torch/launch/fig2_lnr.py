"""Figure 2 / Appendix F-H: the LWN, LGN and LNR traces of WA-LARS,
NOWA-LARS and TVLARS on a large-batch run; the port of
``benchmarks/bench_fig2_lnr.py``.

    PYTHONPATH=src python -m repro_torch.launch.fig2_lnr --device cpu \\
        --steps 10

Each run records its layer norms (``NormRecorder``) and streams them
through ``diagnostics.sink.CsvSink`` with ``export_recorder`` into
``fig2_lnr_traces.csv`` (step, optimizer, lwn, lgn, lnr, loss); prints
each optimizer's largest initial LNR and whether warm-up caps it
(§3.2, observation 3: WA-LARS's at most 1.1 × NOWA-LARS's).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

from repro_torch import device as _device
from repro_torch.diagnostics import sink as sink_lib
from repro_torch.launch import classify, paper_io

BATCH = 1024
LR = 1.0
OPTS = ("wa-lars", "nowa-lars", "tvlars")
STEPS = 80
COLUMNS = ["step", "optimizer", "lwn", "lgn", "lnr", "loss"]


def run(argv: Optional[Sequence[str]] = None, *, log_fn=print) -> dict:
    """Returns ``{"summaries": {optimizer: NormRecorder.summary()},
    "accuracy": {optimizer: acc}, "warmup_caps_lnr", "path"}``."""
    args = paper_io.parser(__doc__, steps=STEPS).parse_args(argv)
    dev = _device.resolve(args.device)
    path = os.path.join(args.out_dir, "fig2_lnr_traces.csv")
    summaries, accuracy = {}, {}
    with sink_lib.CsvSink(path, fieldnames=COLUMNS) as sink:
        for opt in OPTS:
            acc, hist, rec = classify.run_classification(
                opt, BATCH, LR, steps=args.steps, record_norms=True,
                use_kernel=paper_io.kernel_for(opt, args.use_kernel),
                device=dev)
            sink_lib.export_recorder(
                rec, sink,
                extra=lambda idx, step, _o=opt, _h=hist: {
                    "optimizer": _o, "loss": _h[idx]["loss"]})
            summaries[opt] = rec.summary()
            accuracy[opt] = acc
            paper_io.emit(
                log_fn, f"fig2/{opt}", 0.0,
                f"max_init_lnr={summaries[opt]['max_initial_lnr']:.3f} "
                f"acc={acc:.3f}")
    ok = (summaries["wa-lars"]["max_initial_lnr"]
          <= summaries["nowa-lars"]["max_initial_lnr"] * 1.1)
    paper_io.emit(log_fn, "fig2/warmup_caps_lnr", 0.0, f"{ok} -> {path}")
    return {"summaries": summaries, "accuracy": accuracy,
            "warmup_caps_lnr": ok, "path": path}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
