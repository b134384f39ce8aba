"""Debug tool: the largest buffers of one (arch, shape) dry run of the
PyTorch port, the twin of ``tools/hlo_buffers.py``.

    PYTHONPATH=src python tools/torch_buffers.py qwen2.5-3b prefill_32k

Traces rank 0's step of (arch, shape) on the reference's production
mesh, (16, 16) over (data, model), on ``meta`` tensors
(``repro_torch.launch.dryrun``: nothing is allocated and no card is
needed), then prints

* ``temp X arg Y GiB``: the peak of the bytes the step creates (the
  peak less the arguments) and the rank's argument bytes; their sum is
  ``dryrun_one``'s ``peak_bytes``;
* the buffers of at least 0.2 GiB that are live at that peak, grouped
  by shape and dtype, the 20 largest buffers' groups, as ``size GiB
  xcount dtype[shape]`` (with the op that made them).

``hlo_buffers.py`` lists every HLO buffer over 0.2 GiB wherever it is
live in the compiled program. This one lists only what is held at the
peak, which is what sets the peak: the buffers to cut when a step does
not fit.
"""
from __future__ import annotations

import argparse
import collections
import sys
from typing import Optional, Sequence

from repro_torch.launch import dryrun

GIB = 2 ** 30
THRESHOLD = 0.2 * GIB
TOP = 20


def top_buffers(buffers: list, threshold: float = THRESHOLD,
                top: int = TOP) -> list:
    """``[(bytes, count, shape, dtype, op)]``: the buffers of at least
    ``threshold`` bytes grouped by (shape, dtype), the largest buffer
    first (then the most of them)."""
    groups = collections.defaultdict(lambda: [0, 0, ""])
    for n, shape, dtype, op in buffers:
        if n >= threshold:
            g = groups[(tuple(shape), dtype)]
            g[0], g[1] = n, g[1] + 1
            g[2] = g[2] or op
    rows = [(n, c, shape, dtype, op)
            for (shape, dtype), (n, c, op) in groups.items()]
    return sorted(rows, key=lambda r: (-r[0], -r[1]))[:top]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=(
        argparse.RawDescriptionHelpFormatter))
    ap.add_argument("arch")
    ap.add_argument("shape")
    args = ap.parse_args(argv)
    got = dryrun.dryrun_one(args.arch, args.shape, save_dir=None,
                            verbose=False, buffers=True)
    if got["status"] != "ok":
        print(f"{args.arch} × {args.shape}: {got['status']} "
              f"({got['reason']})")
        return 1
    arg = got["argument_bytes"]
    print(f"temp {(got['peak_bytes'] - arg) / GIB:.2f} "
          f"arg {arg / GIB:.2f} GiB")
    for n, count, shape, dtype, op in top_buffers(got["peak_buffers"]):
        dims = ",".join(str(d) for d in shape)
        print(f"{n / GIB:7.2f} GiB x{count:3d}  {dtype}[{dims}]  ({op})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
