"""CI guard for the JSONL metrics contract of the PyTorch port: the
twin of ``tools/validate_metrics.py`` (the same flags, messages and exit
codes) on ``repro_torch``.

Runs ``repro_torch.diagnostics.sink.validate_jsonl`` over metrics files
(or globs) so schema drift in ``MetricsSink`` fails the build instead of a
downstream notebook: every line must be a JSON object with an int
``step`` and only scalar/str/bool/list values.  Lines carrying
``"trace": "v1"`` (a ``repro_torch.obs.trace.Tracer`` export) are
additionally held to the trace-v1 span/instant/counter rules;
``--min-trace-records`` asserts a file actually contains a timeline
(e.g. the launcher's ``--trace-out`` output in CI).

Usage (from the repo root, after the smoke runs have written traces):

    PYTHONPATH=src python tools/torch_validate_metrics.py \
        "experiments/bench/*.jsonl" --min-records 1

Exit codes: 0 = every matched file validates; 1 = a file failed the
schema check or (without ``--allow-empty``) no file matched at all.

It is a copy, not an import, because the port imports nothing of the
JAX package: keep it in step with ``tools/validate_metrics.py``
(``tests/test_torch_tools.py`` holds the two to the same verdicts).
"""
from __future__ import annotations

import argparse
import glob
import sys

from repro_torch.diagnostics.sink import validate_jsonl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+",
                    help="JSONL files or glob patterns to validate")
    ap.add_argument("--min-records", type=int, default=1,
                    help="fail any file with fewer records (default 1)")
    ap.add_argument("--min-trace-records", type=int, default=0,
                    help="fail any file with fewer trace-v1 records "
                         "(default 0 = no trace requirement)")
    ap.add_argument("--allow-empty", action="store_true",
                    help="exit 0 when no file matches any pattern")
    args = ap.parse_args(argv)

    files: list[str] = []
    for pattern in args.paths:
        matched = sorted(glob.glob(pattern))
        if not matched and not glob.has_magic(pattern):
            # a literal path that doesn't exist is always an error
            print(f"validate_metrics: FAIL {pattern}: no such file",
                  file=sys.stderr)
            return 1
        files.extend(matched)
    if not files:
        msg = f"validate_metrics: no files matched {args.paths}"
        if args.allow_empty:
            print(msg + " (--allow-empty)")
            return 0
        print(msg, file=sys.stderr)
        return 1

    failed = False
    for path in files:
        try:
            n, n_trace = validate_jsonl(path, counts=True)
        except ValueError as e:
            print(f"validate_metrics: FAIL {e}", file=sys.stderr)
            failed = True
            continue
        if n < args.min_records:
            print(f"validate_metrics: FAIL {path}: {n} records "
                  f"< --min-records {args.min_records}", file=sys.stderr)
            failed = True
        elif n_trace < args.min_trace_records:
            print(f"validate_metrics: FAIL {path}: {n_trace} trace "
                  f"records < --min-trace-records "
                  f"{args.min_trace_records}", file=sys.stderr)
            failed = True
        else:
            print(f"validate_metrics: OK {path} ({n} records, "
                  f"{n_trace} trace)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
