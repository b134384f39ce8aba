"""Serving launcher: the port's continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \
        --requests 8 --prompt-len 512 --num-tokens 64 --slots 8

Builds a :class:`repro_torch.serving.Engine` (fixed-slot decode batch,
paged KV cache, batched prefill admission) on random weights drawn from
seed 0, submits an open set of requests — half up front, half injected
mid-flight to exercise continuous batching — and reports throughput
plus the engine's kernel-launch and page accounting. ``--smoke`` takes
the architecture's reduced test config; ``--cache-dtype bfloat16``
stores the KV pool in bf16; ``--trace-out PATH`` writes the engine's
phase spans (admit/prefill/decode/sample/finish) as trace-v1 JSONL.
``--restore DIR`` serves the params of a checkpoint in the JAX
package's LM layout (written by either package's ``checkpoint.save``;
``Engine.from_checkpoint``) instead of random ones. Runs on CUDA unless ``--device cpu`` is given.
Dense, MoE and vlm archs serve (llama-3.2-vision-11b on the stubbed
frontend: zeros of ``extra_embed_shape`` in the compute dtype, as the
reference launcher feeds it); ssm, hybrid and encdec archs
(mamba2-1.3b, zamba2-1.2b, whisper-large-v3) have no batched prefill
and the engine refuses them with the reference's ``ValueError``.

``--data-parallel D --model-parallel M`` serves on a ``(D, M)`` mesh of
D × M ranks (``make_host_mesh(D, M)``, as the reference launcher does):
the slots split over the D data rows (row j decodes slots ``[j·S/D,
(j+1)·S/D)``, the sampled tokens gathered over the data column; every
slot on every row when D does not divide ``--slots``), each row
tensor-parallel over its M model ranks (the heads, d_ff and vocabulary
split by ``launch.sharding``; the KV pool as ``cache_pspecs`` places
it: over the KV heads, else over T, the decode kernel then in its
partial mode, else over the head dim, the decode kernel's scores and
apply modes with the scores summed over the row between them).
Without ``--restore`` each rank draws its blocks of the seed-0
weights (``Model.init(0, mesh=)``; at M = 1 rank 0's draw is broadcast);
with it every rank restores the whole params through
``Engine.from_checkpoint(mesh=)``, replicated, as the reference
launcher does. Rank 0 prints, and the run fails unless every rank
produced the same tokens. Without a ``torchrun`` world the launcher
spawns the D × M ranks itself; ``--dist-backend`` picks ``gloo`` or
``nccl`` (default: ``nccl`` when every rank has a card of its own, else
``gloo``; printed). The MoE family's experts split over the model
axis where M divides their count (each rank runs its experts' entries
and the row sums the output; whole on every rank otherwise). Where M
does not divide the heads (whisper-large-v3's 20, the smoke configs'
4 at M = 8) the attention stays whole on every rank and only its KV
cache splits.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import serving
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.diagnostics.sink import JsonlSink
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import extra_embed_shape, get_model
from repro_torch.obs import trace as obs_trace
from repro_torch.training.train_state import replicate


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2.5-3b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--num-tokens", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--cache-dtype", default=None,
                    choices=("float32", "bfloat16"),
                    help="KV pool storage dtype (default: compute dtype)")
    ap.add_argument("--trace-out", default=None,
                    help="write engine phase spans (trace-v1 JSONL)")
    ap.add_argument("--restore", default=None, metavar="DIR",
                    help="checkpoint dir to restore params from")
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="split the slots over D data rows of ranks")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--dist-backend", default=None,
                    choices=mesh_lib.BACKENDS,
                    help="collective backend of the D ranks (default: "
                         "nccl with a card per rank, else gloo)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.data_parallel < 1 or args.model_parallel < 1:
        raise SystemExit(f"--data-parallel {args.data_parallel} and "
                         f"--model-parallel {args.model_parallel} must be "
                         f">= 1")
    d = args.data_parallel * args.model_parallel
    if d > 1 and not mesh_lib.joined():
        backend = args.dist_backend or mesh_lib.default_backend(
            args.device, d)
        if not mesh_lib.in_torchrun():
            print(f"data_parallel={args.data_parallel} model_parallel="
                  f"{args.model_parallel} backend={backend}: spawning {d} "
                  f"ranks", flush=True)
            mesh_lib.spawn(_serve, d, backend, args.device, args=(args,))
            return
        mesh_lib.join(backend, args.device)
        try:
            _serve(args)
        finally:
            mesh_lib.leave()
        return
    _serve(args)


def _serve(args) -> list:
    """Serve the launcher's requests on this rank; returns the tokens."""
    mesh = mesh_lib.make_host_mesh(args.data_parallel, args.model_parallel) \
        if args.data_parallel * args.model_parallel > 1 else None
    dev = mesh_lib.placement_device(mesh, args.device)
    log = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = get_model(cfg)
    max_len = args.prompt_len + args.num_tokens
    pages = -(-max_len // args.page_size)
    sc = serving.ServeConfig(
        slots=args.slots, max_len=pages * args.page_size,
        page_size=args.page_size, prefill_batch=args.slots,
        sampling=serving.SamplingParams(temperature=args.temperature),
        cache_dtype=args.cache_dtype)
    tracer = obs_trace.Tracer() if args.trace_out else obs_trace.NULL

    extra = None
    es = extra_embed_shape(cfg, sc.slots)
    if es is not None:                    # stubbed modality frontend
        extra = torch.zeros(es, dtype=cfg.cdtype, device=dev)

    if args.restore:
        eng = serving.Engine.from_checkpoint(args.restore, model, sc,
                                             device=dev, mesh=mesh,
                                             tracer=tracer, extra=extra)
    elif args.model_parallel > 1:
        eng = serving.Engine(model, model.init(0, device=dev, mesh=mesh),
                             sc, device=dev, tracer=tracer, extra=extra,
                             mesh=mesh)
    else:
        params = replicate(model.init(0, device=dev), mesh)
        eng = serving.Engine(model, params, sc, device=dev, tracer=tracer,
                             extra=extra, mesh=mesh)

    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, size=args.prompt_len)
               for _ in range(args.requests)]
    head, tail = prompts[:len(prompts) // 2], prompts[len(prompts) // 2:]

    t0 = time.perf_counter()
    for p in head:
        eng.submit(p, max_new_tokens=args.num_tokens)
    results = []
    for _ in range(3):                    # in-flight injection
        results.extend(eng.step())
    for p in tail:
        eng.submit(p, max_new_tokens=args.num_tokens)
    results.extend(eng.drain())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0

    toks = sum(len(r.tokens) for r in results)
    stats = eng.stats()
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peak = f", peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} " \
        f"GiB" if dev.type == "cuda" else ""
    log(f"{args.arch}: {len(results)} requests, {toks} tokens in "
        f"{elapsed:.2f}s ({toks / elapsed:.1f} tok/s) on {name}{peak} — "
        f"slots={sc.slots} max_len={sc.max_len} "
        f"page_size={sc.page_size}")
    log(f"decode steps {stats['decode_steps']}, attention_decode kernel "
        f"launches {stats['kernel_launches']}; pages: "
        f"{stats['allocations']} allocs, {stats['reused_pages']} "
        f"reused")
    log("sample:", results[0].tokens[:16])
    tokens = [list(map(int, r.tokens)) for r in
              sorted(results, key=lambda r: r.id)]
    if mesh is not None:
        # over the mesh's ranks: a rank past a mesh narrower than the
        # world serves nothing and takes no part
        if not mesh_lib.all_equal(mesh, tokens):
            raise RuntimeError(f"data_parallel={mesh.data} model_parallel="
                               f"{mesh.model}: the ranks served different "
                               f"tokens")
        log(f"data_parallel={mesh.data} model_parallel={mesh.model} "
            f"backend={mesh.backend}: tokens equal on {mesh.world} ranks")
    if args.trace_out and (mesh is None or mesh.rank == 0):
        summary = obs_trace.phase_summary(tracer.events())
        for span, row in summary.items():
            log(f"  span {span}: n={row['count']} "
                f"total={row['total_ms']:.1f}ms "
                f"mean={row['mean_us']:.0f}us")
        with JsonlSink(args.trace_out) as sink:
            n = tracer.export(sink)
        log(f"trace -> {args.trace_out} ({n} records)")
    return tokens


if __name__ == "__main__":
    main()
