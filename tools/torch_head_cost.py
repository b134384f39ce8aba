#!/usr/bin/env python3
"""Time phase 18's training step over the model axis in several
checkouts on one GPU, in turns, and the vocabulary-parallel head's
backward product beside it.

    python3 tools/torch_head_cost.py archive/parent . . archive/parent

Each ROOT is the root of a checkout of this repository (for example a
``git archive`` of the parent commit unpacked into ``archive/``, which
``.gitignore`` lists). For every ROOT in the order given, a fresh Python
process builds that checkout's ``segmented_update`` kernels and runs
its own ``chip_smoke.py`` phase 18 training path: qwen2.5-3b at full
width cut to ``TT_LAYERS`` layers, bf16, fused TVLARS, ``TT_BATCH`` x
512 tokens, ``--steps`` steps through ``launch.train.run --mesh-model
2`` on a (1, 2) mesh of two gloo ranks sharing the card. Give the roots
as A, B, B, A so that drift of the card over the run shows.

Each process then times its own head alone: one forward and backward
of ``fused_ce_from_hidden`` at phase 18's shapes on rank 0's columns of
a (1, 2) mesh whose collectives do nothing (``DryMesh``), by CUDA
events, and lists the card kernels of one such call (``torch.profiler``).

Last, in the calling process, the head's backward product at phase 18's
shapes (a chunk of ``TT_BATCH`` x 256 positions, d_model 2048, a
rank's 75,968 of 151,936 words): the gradient of the hidden state as
a bf16 product (``g @ wᵀ``) and as an f32 one
(``torch.mm(..., out_dtype=torch.float32)``), card time by CUDA events.

Prints each process's own lines, then one JSON line per run:
``{"root", "run", "loss_grad_ms": [...], "optimizer_ms": [...],
"loss": [...], "row_sum_s", "row_sum_calls", "head_ms",
"head_kernels_ms"}`` (rank 0; ``row_sum_s`` the ``model_sum``
collectives' host seconds over all steps), one
``{"product": ...}`` line, and the card's ``nvidia-smi`` name and power
limit. Needs a CUDA GPU; exits non-zero if any run fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path


def rank_steps(steps: int) -> dict:
    """Phase 18's fused TVLARS run on this rank of a (1, 2) world."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.launch import train as train_launch
    with cs.depth_cut(train_launch, cs.TT_ARCH, cs.TT_LAYERS):
        out = train_launch.run(cs.TT_ARGV + ["--mesh-model", "2", "--steps",
                                             str(steps)],
                               log_fn=lambda line: None)
    sums = out["collectives"].get("model_sum", {})
    return {"loss_grad_ms": [x * 1e3 for x in out["loss_grad_seconds"]],
            "optimizer_ms": [x * 1e3 for x in out["optimizer_seconds"]],
            "loss": [float(h["loss"]) for h in out["history"]],
            "row_sum_s": sums.get("seconds", 0.0),
            "row_sum_calls": sums.get("calls", 0)}


def head_ms(iters: int = 20) -> dict:
    """Card ms of one forward and backward of this checkout's
    ``fused_ce_from_hidden`` at phase 18's shapes on rank 0's columns
    of a (1, 2) mesh whose collectives do nothing
    (``launch.dryrun.DryMesh``), and the card kernels of one such call
    by total time (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.dryrun import DryMesh
    from repro_torch.training import losses
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(18)
    b, s, d, v = 4, 512, 2048, 151936
    h = (torch.randn(b, s, d, generator=gen, device="cuda")
         .to(torch.bfloat16).requires_grad_())
    w = (torch.randn(d, v // 2, generator=gen, device="cuda") * 0.02) \
        .to(torch.bfloat16).requires_grad_()
    labels = torch.randint(0, v, (b, s), generator=gen, device="cuda")
    mesh = DryMesh(1, 2)

    def call():
        losses.fused_ce_from_hidden(h, w, labels, mesh=mesh,
                                    vocab=v).backward()
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    end.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.count, e.device_time_total / 1e3)
                      for e in prof.key_averages()
                      if e.device_time_total > 0),
                     key=lambda k: -k[2])
    return {"head_ms": start.elapsed_time(end) / iters,
            "head_kernels_ms": kernels[:12]}


def child(root: str, steps: int) -> int:
    sys.path[:0] = [os.path.join(root, "src"), root]
    os.chdir(root)
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    _build.build(["segmented_update"])
    ranks = mesh_lib.spawn(rank_steps, 2, "gloo", "cuda", args=(steps,),
                           timeout=900)
    print("RESULT " + json.dumps({**ranks[0], **head_ms()}), flush=True)
    return 0


def product_ms(iters: int = 50) -> dict:
    """Card ms of the head's backward product at phase 18's shapes, as
    a bf16 product and as an f32 one."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(18)
    n, d, v = 4 * 256, 2048, 151936 // 2
    g = torch.randn(n, v, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(d, v, generator=gen, device="cuda").to(torch.bfloat16)
    calls = {"bf16": lambda: g.mm(w.t()),
             "f32": lambda: torch.mm(g, w.t(), out_dtype=torch.float32)}
    out = {"shape": [n, v, d]}
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        out[f"{name}_ms"] = start.elapsed_time(end) / iters
    exact = g.float().mm(w.float().t())
    out["bf16_max_rel_err"] = ((calls["bf16"]().float() - exact).abs().max()
                               / exact.abs().max()).item()
    out["f32_max_rel_err"] = ((calls["f32"]() - exact).abs().max()
                              / exact.abs().max()).item()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*", help="checkout roots, in turn")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.steps)
    import torch
    if not torch.cuda.is_available():
        print("torch_head_cost: CUDA is not available", file=sys.stderr)
        return 2
    failed = 0
    for run, root in enumerate(args.roots):
        root = str(Path(root).resolve())
        print(f"=== run {run}: {root}", flush=True)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root,
             "--steps", str(args.steps)],
            cwd=root, capture_output=True, text=True)
        result = None
        for line in proc.stdout.splitlines():
            if line.startswith("RESULT "):
                result = json.loads(line[len("RESULT "):])
            else:
                print(line, flush=True)
        if proc.returncode or result is None:
            print(proc.stderr[-4000:], file=sys.stderr, flush=True)
            failed += 1
            continue
        print(json.dumps({"root": root, "run": run, **result}), flush=True)
    print(json.dumps({"product": product_ms()}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
