#!/usr/bin/env python3
"""Time the port's decode-attention and RMSNorm kernels, or its
per-tensor LARS kernels, of several checkouts on one GPU, in turns.

    python3 tools/chip_compare.py archive/parent . . archive/parent
    python3 tools/chip_compare.py --serving archive/parent . . archive/parent
    python3 tools/chip_compare.py --lars archive/parent . . archive/parent

Each ROOT is the root of a checkout of this repository (for example a
``git archive`` of the parent commit unpacked into ``archive/``, which
``.gitignore`` lists). For every ROOT in the order given, a fresh Python
process builds that checkout's ``attention_decode`` and ``rmsnorm``
kernels and runs its own ``chip_smoke.py`` phases 3 (decode attention at
gemma3-12b's shapes) and 3d (RMSNorm), checks included; with
``--serving`` also its phase 4 (gemma3-12b serving at full width). Give
the roots as A, B, B, A so that drift of the card over the run shows.

Prints each process's own lines, then one JSON line per run:
``{"root", "run", "decode": {shape: {ms, eager_ms, library_ms,
library_eager_ms, bound_ms}}, "rmsnorm": [{...}, ...], "serving":
{...}}``, and the card's ``nvidia-smi`` name and power limit. ``ms``
and ``library_ms`` are the card's time per call (a CUDA graph of the
calls, replayed); ``eager_ms`` the time of back-to-back calls, the
host's cost included. A tree whose ``chip_smoke.py`` times eagerly
runs its phases a second time with the kernel's and the library
call's timings through the graph.

With ``--lars`` each process builds that checkout's ``lars_update``
kernels and times one optimizer step's norm and apply over three sets
of kernel segments, random members made from a seed as in
``chip_smoke.py`` phase 3c: (a) qwen2.5-3b at full width and depth,
bf16; (b) whisper-large-v3 at full width and depth, f32; (c) the CNN's
leaves, f32. The timer, the members and the bound are THIS checkout's
(``chip_smoke.lars_step_times``), so every root is timed alike; the
only difference is the call: a checkout whose wrappers take a pass
(``lars_norm2_cuda(segments)``) makes one launch of each a step, an
older one loops over the segments. Prints one JSON line per run,
``{"root", "run", "lars": {size: {"norm": {...}, "apply": {...}}}}``.

Needs a CUDA GPU; exits non-zero if any run fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import gc, json, sys
import torch
root = sys.argv[1]
serving_too = sys.argv[2] == "1"
sys.path.insert(0, root + "/src")
sys.path.insert(0, root)
import chip_smoke as cs
from repro_torch import serving
from repro_torch.configs import get_config
from repro_torch.kernels import _build, ops
from repro_torch.kernels import attention_decode as tad
from repro_torch.kernels import ref as sref
from repro_torch.kernels import rmsnorm as rms
from repro_torch.models import get_model
from repro_torch.obs import Tracer, phase_summary
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build(["attention_decode", "rmsnorm"])
eager = cs.time_ms


def graph_ms(fn, iters=50, replays=3):
    # the card's time per call: iters calls in a CUDA graph, replayed
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def run_phases():
    return cs.phase_kernel(tad, ops), cs.phase_rmsnorm(rms, sref, ops)


keys = ("ms", "eager_ms", "library_ms", "library_eager_ms", "bound_ms")
kernel, rmsn = run_phases()
if not hasattr(cs, "device_ms"):
    # a tree that timed eagerly: its own readings are the eager ones;
    # run its phases again with the kernel's and the library call's
    # timings (50 calls each; the plain version's take 10) in a graph
    for row in list(kernel["rows"].values()) + rmsn["rows"]:
        row["eager_ms"] = row["ms"]
        row["library_eager_ms"] = row["library_ms"]
    cs.time_ms = lambda fn, iters: (graph_ms(fn, iters) if iters >= 50
                                    else eager(fn, iters))
    gkernel, grmsn = run_phases()
    cs.time_ms = eager
    for row, grow in zip(list(kernel["rows"].values()) + rmsn["rows"],
                         list(gkernel["rows"].values()) + grmsn["rows"]):
        row["ms"], row["library_ms"] = grow["ms"], grow["library_ms"]
out = {"decode": {f"{kind} {str(dt).split('.')[-1]}":
                  {k: row[k] for k in keys}
                  for (kind, dt), row in kernel["rows"].items()},
       "rmsnorm": [{k: row[k] for k in keys} for row in rmsn["rows"]]}
if serving_too:
    gc.collect()
    torch.cuda.empty_cache()
    main = cs.phase_serving(ops, serving, get_config, get_model, Tracer,
                            phase_summary,
                            tad.decode_parity_tolerance(torch.bfloat16))
    spans = main["spans"]
    steps = main["launches"] // 48
    out["serving"] = {
        "tok_per_s": main["generated"] / main["elapsed"],
        "decode_steps": steps,
        "step_ms": (spans["decode"]["total_ms"]
                    + spans["sample"]["total_ms"]) / steps,
        "decode_span_mean_ms": spans["decode"]["mean_us"] / 1e3}
print("RESULT " + json.dumps(out), flush=True)
"""


LARS_CHILD = r"""
import gc, json, sys
root, tool_root = sys.argv[1], sys.argv[2]
sys.path.insert(0, tool_root)
import chip_smoke as cs                   # this checkout's timer
sys.path.insert(0, root + "/src")         # the timed checkout's port
import torch
from repro_torch.configs import get_config
from repro_torch.core import flatten, layerwise
from repro_torch.core.base import tree_leaves
from repro_torch.kernels import _build
from repro_torch.kernels import lars_update as lu
from repro_torch.models import cnn
_build.build(["lars_update"])
one_pass = hasattr(lu, "TILE")
lr = torch.tensor(0.35, device=cs.DEV)
if one_pass:
    norm = lu.lars_norm2_cuda
    apply = lambda segs, sums: lu.lars_apply_cuda(segs, sums, base_lr=lr,
                                                  **cs.LARS_HYPER)
else:
    norm = lambda wg: [lu.lars_norm2_cuda(ws, gs) for ws, gs in wg]
    apply = lambda segs, sums: [
        lu.lars_apply_cuda(ws, gs, ms, s, base_lr=lr, **cs.LARS_HYPER)
        for (ws, gs, ms), s in zip(segs, sums)]
gen = torch.Generator(device=cs.DEV).manual_seed(3)
out = {}
for size, shapes, dt in (
        ("a", cs.model_kernel_segments("qwen2.5-3b", flatten, layerwise,
                                       get_config), torch.bfloat16),
        ("b", cs.model_kernel_segments("whisper-large-v3", flatten,
                                       layerwise, get_config),
         torch.float32),
        ("c", cs.cnn_kernel_leaves(cnn, tree_leaves), torch.float32)):
    segs = cs.lars_members(shapes, dt, dt, gen)
    out[size] = cs.lars_step_times(norm, apply, segs)
    for t in out[size].values():
        t["launches"] = 1 if one_pass else len(segs)
    print(f"{size}: {json.dumps(out[size])}", flush=True)
    del segs
    gc.collect()
    torch.cuda.empty_cache()
print("RESULT " + json.dumps({"one_pass": one_pass, "lars": out}),
      flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+", help="checkout roots, in turn")
    ap.add_argument("--serving", action="store_true",
                    help="also run phase 4 (gemma3-12b serving)")
    ap.add_argument("--lars", action="store_true",
                    help="time the per-tensor LARS kernels instead")
    args = ap.parse_args()
    tool_root = str(Path(__file__).resolve().parents[1])
    import torch
    if not torch.cuda.is_available():
        print("chip_compare: CUDA is not available", file=sys.stderr)
        return 2
    results = []
    for run, root in enumerate(args.roots):
        root = str(Path(root).resolve())
        print(f"=== run {run}: {root}", flush=True)
        env = dict(os.environ, PYTHONPATH=str(Path(root) / "src"))
        cmd = [sys.executable, "-c", LARS_CHILD, root, tool_root] \
            if args.lars else [sys.executable, "-c", CHILD, root,
                               "1" if args.serving else "0"]
        proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                              text=True)
        result = None
        for line in proc.stdout.splitlines():
            if line.startswith("RESULT "):
                result = json.loads(line[len("RESULT "):])
            else:
                print(line, flush=True)
        if proc.returncode != 0 or result is None:
            print(proc.stderr[-4000:], file=sys.stderr)
            print(f"chip_compare: run {run} ({root}) failed "
                  f"(exit {proc.returncode})", file=sys.stderr)
            return 1
        results.append(dict(result, root=root, run=run))
    for r in results:
        print(json.dumps(r))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
