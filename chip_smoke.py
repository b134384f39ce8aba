#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU (written for an H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing its own lines; a failing phase raises and the
script exits non-zero:

1. device: the card's name and its ``nvidia-smi`` name and power limit;
2. build: ``nvcc`` builds every kernel source of the serving and
   training paths from ``src/repro_torch/kernels/csrc``, all at once
   (timed);
3. decode attention against its plain version at gemma3-12b's
   full-width decode shapes (8 slots, 16 heads, 8 KV heads, head_dim
   256): a windowed ring of T=1024 with positions several laps past the
   window and a global cache of T=2048, bf16 and f32 pools. Outputs
   within ``decode_parity_tolerance``, updated caches bitwise equal.
   Times the kernel, the plain version and one
   ``scaled_dot_product_attention`` call over the same cache (a
   yardstick only: the port never calls it), beside the bound;
3b. the four segmented optimizer kernels against their plain versions
   at qwen2.5-3b's widths with the group axis cut to 4 layers
   (0.93e9 elements) and on a tree of 309 tiny segments (smaller than
   a row, straddling 128-row chunks): lars ±nesterov ±trust_clip,
   paper and lamb ±trust_clip, each at f32, bf16_master and
   bf16_master_sr. Pass-1 tables within ``NORM_RTOL`` of the plain
   version and bitwise equal over two launches; pass 2 fed the
   kernel's own table bitwise equal to the plain version. Times both
   passes, kernel and plain, beside their bounds;
4. serving at full width: gemma3-12b, all 48 layers, bf16, random
   weights from seed 0 on the card, ``ServeConfig(slots=8,
   max_len=2048, page_size=16)``; 12 requests (more than the slots)
   with prompts of 256-1536 tokens and 32-96 new tokens each, drained
   through the engine. Checks every request's token count, that the
   decode-attention kernel launched 48 times per decode step, and that
   two requests re-run alone through ``generate`` give the same greedy
   tokens up to bf16 ties;
5. the same traffic through gemma3-12b at full width and depth in f32:
   engine and ``generate`` give exactly the same greedy tokens;
6. the same engine at smoke size in f32 on the card against the CPU's
   plain path on the same weights, token for token;
7. training at full width through ``repro_torch.launch.train.run``:
   qwen2.5-3b, all 36 layers, bf16 weights from seed 0, (a) fused
   TVLARS with f32 state, global batch 8 x 512 tokens, 3 steps; (b)
   fused LAMB with bf16 stochastically rounded state, 2 microbatches
   of 4, 3 steps. Counts set to 0 before each run must read exactly
   one norm and one apply launch per step; losses finite; at the last
   step the kernel's per-segment norms are held against
   ``torch.linalg.vector_norm`` of the same members and 4,096 random
   rows of its delta and state against the plain apply on the same
   table (bitwise). Prints the per-step loss+grad / optimizer split
   and peak memory, then times both kernels and their plain versions
   on the run's own buffers (the main path's shapes);
8. the qwen2.5-3b smoke LM in f32: 3 fused TVLARS and 3 fused LAMB
   steps on the card against the CPU's plain path, same weights and
   batches.

The last lines are the ``nvidia-smi`` line, one JSON object describing
each kernel, and ``{"ok": true, "device": {...}}``. Without CUDA, or
without the rest of the repository beside it, the script fails before
printing any result.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores

# gemma3-12b decode attention at the serving path's shapes
SLOTS, HEADS, KV_HEADS, HEAD_DIM = 8, 16, 8, 256
WINDOW, MAX_LEN = 1024, 2048
LOCAL_PER_STEP, GLOBAL_PER_STEP = 40, 8        # launches per decode step
POS = {"local": [0, 5, 1023, 1024, 2500, 3071, 4100, 6143],
       "global": [0, 300, 700, 1023, 1024, 1400, 1536, 2047]}


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernel(tad, ops) -> dict:
    """Kernel vs plain version at full width; returns the timings."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = {}
    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        tol = tad.decode_parity_tolerance(dtype)
        for kind in ("local", "global"):
            t = WINDOW if kind == "local" else MAX_LEN
            window = WINDOW if kind == "local" else None

            def randn(*shape):
                return torch.randn(shape, generator=gen, device=dev,
                                   dtype=torch.float32).to(dtype)

            q = randn(SLOTS, 1, HEADS, HEAD_DIM)
            nk, nv = randn(SLOTS, 1, KV_HEADS, HEAD_DIM), \
                randn(SLOTS, 1, KV_HEADS, HEAD_DIM)
            kc, vc = randn(SLOTS, t, KV_HEADS, HEAD_DIM), \
                randn(SLOTS, t, KV_HEADS, HEAD_DIM)
            pos = torch.tensor(POS[kind], dtype=torch.int32, device=dev)
            kk, vk, kp, vp = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            out_k = ops.attention_decode(q, nk, nv, kk, vk, pos,
                                         window=window)
            out_p = tad.attention_decode_ref(q, nk, nv, kp, vp, pos,
                                             window=window)
            torch.cuda.synchronize()
            err = (out_k.float() - out_p.float()).abs().max().item()
            max_err = max(max_err, err)
            torch.testing.assert_close(out_k.float(), out_p.float(), **tol)
            if not (torch.equal(kk, kp) and torch.equal(vk, vp)):
                raise AssertionError(f"{kind} {dtype}: updated caches "
                                     f"differ between kernel and plain")
            if not torch.isfinite(out_k.float()).all():
                raise AssertionError(f"{kind} {dtype}: non-finite output")

            # the yardstick: one SDPA call over the same (already
            # appended) cache with a boolean validity mask
            posl = pos.long()[:, None]
            kpos = torch.arange(t, device=dev)[None, :]
            if window is None:
                ok = kpos <= posl
            else:
                slot = posl % t
                wraps = (posl // t) * t
                a = kpos + torch.where(kpos <= slot, wraps, wraps - t)
                ok = (a >= 0) & (a <= posl) & (a > posl - window)
            mask = ok[:, None, None, :]
            qs, ks, vs = q.transpose(1, 2), kk.transpose(1, 2), \
                vk.transpose(1, 2)

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, enable_gqa=True)

            sdpa_err = (sdpa().transpose(1, 2).float()
                        - out_p.float()).abs().max().item()

            # least time: the bytes the function must move (the valid
            # K/V rows read once, q read and out written, new K/V read
            # and appended, pos) and its f32 operations (QK and PV:
            # 4 flops per head-dim element per valid key per head)
            csize = kc.element_size()
            valid_keys = int(ok.sum().item())   # (row, key) pairs needed
            bytes_moved = (2 * valid_keys * KV_HEADS * HEAD_DIM * csize
                           + 2 * q.numel() * q.element_size()
                           + 4 * nk.numel() * csize + 4 * SLOTS)
            flops = 4 * valid_keys * HEADS * HEAD_DIM
            bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / F32_FLOP_PER_S * 1e3
            row = {
                "ms": time_ms(lambda: ops.attention_decode(
                    q, nk, nv, kk, vk, pos, window=window), 50),
                "plain_ms": time_ms(lambda: tad.attention_decode_ref(
                    q, nk, nv, kp, vp, pos, window=window), 10),
                "library_ms": time_ms(sdpa, 50),
                "bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
                "ops_ms": ops_ms,
                "bound_by": "bytes" if bytes_ms >= ops_ms
                else "operations",
                "max_abs_err": err}
            rows[(kind, dtype)] = row
            print(f"kernel attention_decode {kind} T={t} "
                  f"{str(dtype).split('.')[-1]} pool: max|err|={err:.3e} "
                  f"(rtol=atol={tol['rtol']:.2e}); kernel "
                  f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                  f"sdpa {row['library_ms']:.4f} ms (max|err| "
                  f"{sdpa_err:.3e}), bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
                  f"{bytes_moved} B, {flops} flop)", flush=True)
    return {"rows": rows, "max_abs_err": max_err}


def traffic(vocab_size: int):
    """Phase 4's requests: prompts of 256-1536 tokens, 32-96 new."""
    rng = np.random.RandomState(0)
    lens = rng.randint(256, 1537, size=12)
    new = rng.randint(32, 97, size=12)
    prompts = [rng.randint(1, vocab_size, size=n).astype(np.int32)
               for n in lens]
    return prompts, lens, new


def serve(serving, model, params, ops, tracer):
    """Drain phase 4's traffic through one engine: half submitted up
    front, the rest admitted mid-flight. Returns (results, stats,
    seconds, kernel launches during the run)."""
    prompts, _, new = traffic(model.cfg.vocab_size)
    sc = serving.ServeConfig(slots=SLOTS, max_len=MAX_LEN, page_size=16)
    eng = serving.Engine(model, params, sc, device="cuda", tracer=tracer)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=int(m))
           for p, m in zip(prompts[:6], new[:6])]
    for _ in range(3):
        eng.step()
    ids += [eng.submit(p, max_new_tokens=int(m))
            for p, m in zip(prompts[6:], new[6:])]
    eng.drain()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = ops.launches["attention_decode"]
    results = [eng.result(i) for i in ids]
    for r, m in zip(results, new):
        if not r.finished or len(r.tokens) != m:
            raise AssertionError(f"request {r.id}: finished={r.finished} "
                                 f"with {len(r.tokens)} of {m} tokens")
        if not all(0 <= t < model.cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.id}: token out of range")
    return results, eng.stats(), elapsed, launches


def picks(lens) -> list:
    """The requests re-run alone: the first longer than the window
    (ring packing at prefill) and the first not longer."""
    return [int(np.argmax(lens > WINDOW)), int(np.argmax(lens <= WINDOW))]


def init_checked(model):
    t0 = time.perf_counter()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for layer in params["layers"]
                   for part in layer.values() for x in part.values()) \
        + sum(x.numel() for x in params["embed"].values()) \
        + params["final_norm"]["scale"].numel()
    if n_params != model.cfg.param_count():
        raise AssertionError(f"{n_params} params, config says "
                             f"{model.cfg.param_count()}")
    print(f"serving: gemma3-12b {model.cfg.num_layers} layers, {n_params} "
          f"params ({model.cfg.param_dtype}) initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return params


def tie_gaps(serving, model, params, prompt, tokens, tol) -> list:
    """Feed the engine's tokens through the request-alone path (what
    ``generate`` runs: prefill of the bare prompt, then one-row decode
    steps) and return per position (best logit - logit of the engine's
    token, allowed gap rtol * |best| + atol)."""
    x = torch.tensor(prompt[None], dtype=torch.int64, device="cuda")
    logits, cache = serving.prefill(model, params, x, MAX_LEN)
    rows = []
    for j, tok in enumerate(tokens):
        lg = logits[0, -1].float()
        best = lg.max()
        rows.append(((best - lg[tok]).item(),
                     (tol["rtol"] * best.abs() + tol["atol"]).item()))
        if j + 1 < len(tokens):
            nxt = torch.tensor([[tok]], dtype=torch.int32, device="cuda")
            logits, cache = model.decode_step(params, cache, nxt,
                                              int(prompt.size) + j)
    return rows


def phase_serving(ops, serving, get_config, get_model, Tracer,
                  phase_summary, bf16_tol) -> dict:
    """The main path: bf16 gemma3-12b at full width and depth."""
    model = get_model(get_config("gemma3-12b"))
    params = init_checked(model)
    tracer = Tracer()
    torch.cuda.reset_peak_memory_stats()
    results, stats, elapsed, launches = serve(serving, model, params, ops,
                                              tracer)
    want = model.cfg.num_layers * stats["decode_steps"]
    if launches != want or stats["kernel_launches"] != launches:
        raise AssertionError(f"attention_decode launched {launches} times, "
                             f"expected {want} = {model.cfg.num_layers} "
                             f"layers x {stats['decode_steps']} decode "
                             f"steps")
    prompts, lens, new = traffic(model.cfg.vocab_size)
    generated = stats["tokens_generated"]
    spans = phase_summary(tracer.events())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"serving: {len(results)} requests (prompts {lens.min()}-"
          f"{lens.max()}, {int(sum(lens > WINDOW))} longer than the "
          f"window), {generated} tokens in {elapsed:.3f} s = "
          f"{generated / elapsed:.2f} tok/s; {stats['decode_steps']} decode "
          f"steps, {launches} attention_decode launches; peak memory "
          f"{peak:.1f} GiB", flush=True)
    for name in ("prefill", "decode", "sample", "admit", "finish"):
        row = spans.get(name)
        if row:
            print(f"  span {name}: n={row['count']} "
                  f"total={row['total_ms']:.1f} ms "
                  f"mean={row['mean_us']:.0f} us", flush=True)

    # engine == generate in bf16, up to bf16 ties: the engine pads and
    # batches (prefill [4, 2048], decode [8, 1]) where generate runs the
    # bare request ([1, S], [1, 1]), so the matrix products round
    # differently and a near-tie in the argmax may go either way. Where
    # the tokens differ, the engine's tokens are fed through the alone
    # path and each must be its argmax within bf16 tolerance.
    for i in picks(lens):
        alone = serving.generate(model, params, prompts[i][None],
                                 num_tokens=int(new[i]), max_len=MAX_LEN,
                                 device="cuda")[0].tolist()
        eng_tokens = results[i].tokens
        if alone == eng_tokens:
            print(f"serving: request {i} (prompt {lens[i]}) alone through "
                  f"generate: same {len(alone)} greedy tokens", flush=True)
            continue
        first = next(j for j, (a, b) in enumerate(zip(alone, eng_tokens))
                     if a != b)
        rows = tie_gaps(serving, model, params, prompts[i], eng_tokens,
                        bf16_tol)
        ties = [(j, g, lim) for j, (g, lim) in enumerate(rows) if g > 0]
        worst = max(ties, key=lambda r: r[1] / r[2],
                    default=(first, 0.0, rows[first][1]))
        print(f"serving: request {i} (prompt {lens[i]}) alone through "
              f"generate: tokens differ from token {first}; the engine's "
              f"tokens fed through the alone path are its argmax at "
              f"{len(rows) - len(ties)} of {len(rows)} positions, and "
              f"within {worst[1]:.4f} of the best logit at token "
              f"{worst[0]} (allowed {worst[2]:.4f}, rtol=atol="
              f"{bf16_tol['rtol']:.4f}); gaps at the first ties: "
              f"{[round(g, 4) for _, g, _ in ties[:5]]}", flush=True)
        if any(g > lim for _, g, lim in ties):
            raise AssertionError(f"request {i}: an engine token is not "
                                 f"the alone path's argmax within bf16 "
                                 f"tolerance")
    return {"launches": launches, "elapsed": elapsed,
            "generated": generated, "spans": spans}


def phase_f32_full_width(ops, serving, get_config, get_model):
    """Engine == generate exactly: the same traffic through gemma3-12b
    at full width and depth in f32 (no bf16 rounding to break ties)."""
    model = get_model(get_config("gemma3-12b").replace(
        param_dtype="float32", compute_dtype="float32"))
    params = init_checked(model)
    results, stats, elapsed, launches = serve(serving, model, params, ops,
                                              None)
    if launches != model.cfg.num_layers * stats["decode_steps"]:
        raise AssertionError(f"f32: {launches} launches for "
                             f"{stats['decode_steps']} decode steps")
    prompts, lens, new = traffic(model.cfg.vocab_size)
    print(f"f32: {len(results)} requests, {stats['tokens_generated']} "
          f"tokens in {elapsed:.3f} s", flush=True)
    for i in picks(lens):
        alone = serving.generate(model, params, prompts[i][None],
                                 num_tokens=int(new[i]), max_len=MAX_LEN,
                                 device="cuda")[0].tolist()
        if alone != results[i].tokens:
            first = next(j for j, (a, b) in enumerate(
                zip(alone, results[i].tokens)) if a != b)
            raise AssertionError(
                f"f32 request {i}: engine and generate differ from token "
                f"{first}: engine {results[i].tokens[first:first + 8]} "
                f"generate {alone[first:first + 8]}")
        print(f"f32: request {i} (prompt {lens[i]}) alone through "
              f"generate: same {len(alone)} greedy tokens", flush=True)


def phase_small_against_cpu(serving, get_smoke_config, get_model):
    """The same engine at smoke size in f32: kernel path on the card vs
    the plain path on the CPU, same weights, token for token."""
    model = get_model(get_smoke_config("gemma3-12b"))
    cpu_params = model.init(0, device="cpu")
    gpu_params = {
        "embed": {k: v.cuda() for k, v in cpu_params["embed"].items()},
        "layers": [{part: {k: v.cuda() for k, v in d.items()}
                    for part, d in layer.items()}
                   for layer in cpu_params["layers"]],
        "final_norm": {"scale": cpu_params["final_norm"]["scale"].cuda()}}
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 512, size=n) for n in (5, 9, 3, 12, 7)]
    sc = serving.ServeConfig(slots=3, max_len=64, page_size=8,
                             prefill_batch=2)
    out = []
    for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        eng = serving.Engine(model, params, sc, device=dev)
        ids = [eng.submit(p, max_new_tokens=12) for p in prompts]
        eng.drain()
        out.append([eng.result(i).tokens for i in ids])
    if out[0] != out[1]:
        raise AssertionError(f"smoke-size engine: card {out[1]} != "
                             f"cpu {out[0]}")
    print(f"small: gemma3-12b smoke config f32, {len(prompts)} requests, "
          f"card (kernel) == cpu (plain) token for token", flush=True)


# --------------------------------------------------------------------------
# the training slice: the four segmented optimizer kernels
# --------------------------------------------------------------------------

SEG_KERNELS = {
    "seg_norm_lars": "src/repro/kernels/segmented_update.py:89",
    "seg_norm_lamb": "src/repro/kernels/segmented_update.py:103",
    "seg_apply_lars": "src/repro/kernels/segmented_update.py:136",
    "seg_apply_lamb": "src/repro/kernels/segmented_update.py:152",
}
SEG_SOURCE = "src/repro_torch/kernels/csrc/segmented_update.cu"
DEV = "cuda"               # the card (the training phases' device)
KERNEL_GROUPS = 4          # qwen2.5-3b's group axis, cut for the check
# Pass 1 against the plain version: both sum the same f32 squares in
# other orders (kernel: 4 per lane, a 32-lane butterfly, runs of <= 128
# rows, then <= ceil(chunks / 32) partials per lane; plain: PyTorch's
# row sums and index_add_). Positive terms, so each sum's relative error
# is at most its depth times 2^-24: about 2^-24 * 800 = 5e-5 for the
# 151936 x 2048 embeddings. Stated bound:
NORM_RTOL = 1e-4
OPT_HYPER = dict(eta=1e-3, weight_decay=5e-4, momentum=0.9, b1=0.9,
                 b2=0.999, eps=1e-6)
# mode cases of the kernel check: (name, mode, nesterov, trust_clip)
SEG_CASES = [("lars", "lars", False, None), ("lars-nesterov", "lars",
                                               True, None),
             ("lars-clip", "lars", False, 10.0),
             ("lars-nesterov-clip", "lars", True, 10.0),
             ("paper", "paper", False, None),
             ("lamb", "lamb", False, None), ("lamb-clip", "lamb", False,
                                              10.0)]
SEG_PRECISIONS = ("f32", "bf16_master", "bf16_master_sr")
FLOPS_PER_ELEMENT = {("norm", "lars"): 4, ("norm", "paper"): 4,
                     ("norm", "lamb"): 16, ("apply", "lars"): 8,
                     ("apply", "paper"): 7, ("apply", "lamb"): 17}


def seg_bound(which: str, mode: str, rows: int, itemsize: int,
              nseg: int) -> dict:
    """Least time of one pass over ``rows`` x 128 elements: every input
    read once, every output written once (in-place state counts a read
    and a write), against the f32 operations it does."""
    n = rows * 128
    nbuf = 2 if mode == "lamb" else 1
    ids = rows * 4
    if which == "norm":
        moved = (2 + (nbuf if mode == "lamb" else 0)) * n * itemsize \
            + ids + 2 * nseg * 4
    else:
        moved = (2 + nbuf) * n * itemsize + ids + 2 * nseg * 4 \
            + nbuf * n * itemsize + 4 * n
    flops = FLOPS_PER_ELEMENT[(which, mode)] * n
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOP_PER_S * 1e3
    return {"bytes": moved, "flops": flops, "bound_ms": max(bytes_ms,
                                                            ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def qwen_tree(cfg, groups: int) -> dict:
    """qwen2.5-3b's parameter tree at its full widths, ``groups``
    layers deep, as meta tensors (shapes only)."""
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim_
    f, v = cfg.d_ff, cfg.vocab_size

    def t(*shape):
        return torch.empty(shape, device="meta")

    layer = {"norm1": {"scale": (d,)}, "norm2": {"scale": (d,)},
             "attn": {"wq": (d, h, hd), "wk": (d, hkv, hd),
                      "wv": (d, hkv, hd), "wo": (h, hd, d),
                      "bq": (h, hd), "bk": (hkv, hd), "bv": (hkv, hd)},
             "mlp": {"wi": (d, f), "wg": (d, f), "wo": (f, d)}}
    return {"embed": {"table": t(v, d), "head": t(d, v)},
            "final_norm": {"scale": t(d)},
            "layers": [{k: {n: t(*s) for n, s in part.items()}
                        for k, part in layer.items()}
                       for _ in range(groups)]}


def flat_problem(spec, mode: str, dtype, gen) -> tuple:
    """Random (w, g, bufs) flat buffers on the card with zero padding."""
    dev = torch.device(DEV)

    def rand(scale, positive=False):
        x = torch.randn((spec.num_rows, 128), generator=gen, device=dev,
                        dtype=torch.float32).mul_(scale)
        if positive:
            x.square_()
        x = x.to(dtype)
        flat = x.view(-1)
        used = 0
        for off, size, srows in zip(spec.row_offset, spec.sizes,
                                    spec.seg_rows):
            flat[off * 128 + size:(off + srows) * 128] = 0
            used = off + srows
        flat[used * 128:] = 0
        return x

    w, g = rand(0.02), rand(1e-3)
    bufs = (rand(1e-3), rand(1e-3, positive=True)) if mode == "lamb" \
        else (rand(1e-3),)
    return w, g, bufs


def seg_case(su, sref, spec, w, g, bufs, ids, adapt, mode, nesterov,
             trust_clip, sr: bool) -> dict:
    """One kernel-vs-plain case: table within NORM_RTOL and repeated
    bitwise; pass 2 on the kernel's table bitwise equal to the plain
    version. Returns the errors."""
    nseg = spec.num_segments
    h = OPT_HYPER
    dev = w.device
    bc1 = torch.tensor(0.271, device=dev)
    bc2 = torch.tensor(0.0039, device=dev)
    seed = torch.tensor(3, dtype=torch.int32, device=dev)
    lr = torch.tensor(0.35, device=dev)
    common = dict(b1=h["b1"], b2=h["b2"], eps=h["eps"], bc1=bc1, bc2=bc2)
    t1 = su.seg_norm_cuda(w, g, bufs, ids, nseg, mode=mode,
                          weight_decay=h["weight_decay"], **common)
    t2 = su.seg_norm_cuda(w, g, bufs, ids, nseg, mode=mode,
                          weight_decay=h["weight_decay"], **common)
    tp = su.seg_norm_ref(w, g, bufs, ids, nseg, mode=mode,
                         weight_decay=h["weight_decay"], **common)
    torch.cuda.synchronize()
    if not torch.equal(t1, t2):
        raise AssertionError(f"{mode}: pass-1 table differs between two "
                             f"launches")
    if not torch.isfinite(t1).all():
        raise AssertionError(f"{mode}: non-finite norms")
    norm_abs = (t1 - tp).abs().max().item()
    norm_rel = ((t1 - tp).abs() / tp.abs().clamp_min(1e-30)).max().item()
    if norm_rel > NORM_RTOL:
        raise AssertionError(f"{mode}: norms {norm_rel:.3e} relative from "
                             f"the plain version (bound {NORM_RTOL})")
    _, _, ratio = sref.trust_ratio(t1[0], t1[1], adapt, mode=mode,
                                   eta=h["eta"],
                                   weight_decay=h["weight_decay"],
                                   eps=h["eps"], trust_clip=trust_clip)
    table = sref.scales_from_ratio(ratio, adapt, lr, h["weight_decay"])
    apply_kw = dict(mode=mode, momentum=h["momentum"], nesterov=nesterov,
                    stochastic_round=sr, seed=seed, **common)
    kbufs = tuple(b.clone() for b in bufs)
    _, kdelta = su.seg_apply_cuda(w, g, kbufs, ids, table, **apply_kw)
    pbufs, pdelta = su.seg_apply_ref(w, g, bufs, ids, table, **apply_kw)
    torch.cuda.synchronize()
    apply_abs = (kdelta - pdelta).abs().max().item()
    for k, (a, b) in enumerate(zip(kbufs, pbufs)):
        apply_abs = max(apply_abs, (a.float() - b.float()).abs().max()
                        .item())
        if not torch.equal(a, b):
            raise AssertionError(f"{mode}: state {k} of pass 2 differs "
                                 f"from the plain version")
    if not torch.equal(kdelta, pdelta):
        raise AssertionError(f"{mode}: pass-2 delta differs from the "
                             f"plain version ({apply_abs:.3e})")
    del kbufs, pbufs, kdelta, pdelta
    return {"norm_abs": norm_abs, "norm_rel": norm_rel,
            "apply_abs": apply_abs, "table": table, "t": t1}


def phase_seg_kernels(su, sref, flatten, convert, get_config) -> dict:
    """The four kernels against their plain version: qwen2.5-3b's
    widths with the group axis cut to KERNEL_GROUPS layers, and a tree
    of many tiny segments (smaller than a row, straddling chunks)."""
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(5)
    cfg = get_config("qwen2.5-3b").replace(num_layers=KERNEL_GROUPS)
    big = qwen_tree(cfg, KERNEL_GROUPS)
    rng = np.random.RandomState(2)
    sizes = list(rng.randint(1, 200, size=300)) + [127, 128, 129, 256,
                                                   16383, 16385, 40000,
                                                   70001]
    tiny = {f"s{i:03d}": torch.empty((int(n),), device="meta")
            for i, n in enumerate(sizes)}
    tiny["m0"] = torch.empty((37, 29), device="meta")
    errs = {k: 0.0 for k in SEG_KERNELS}
    norm_rel = 0.0
    timings = {}
    for label, tree, segmenter in (
            ("qwen2.5-3b x4", big,
             lambda p: convert.segment_paths(cfg, p)),
            ("tiny segments", tiny, None)):
        for precision in SEG_PRECISIONS:
            dtype = torch.float32 if precision == "f32" else torch.bfloat16
            spec = flatten.build_spec(tree, dtype=dtype,
                                      segments=segmenter)
            ids = spec.segment_ids(dev)
            adapt = spec.adapt_mask(dev)
            sr = precision.endswith("_sr")
            for lamb in (False, True):
                w, g, bufs = flat_problem(spec, "lamb" if lamb else "lars",
                                          dtype, gen)
                case_rel = 0.0
                for name, mode, nesterov, clip in SEG_CASES:
                    if (mode == "lamb") != lamb:
                        continue
                    r = seg_case(su, sref, spec, w, g, bufs, ids, adapt,
                                 mode, nesterov, clip, sr)
                    norm_k, apply_k = su.KERNELS[mode]
                    errs[norm_k] = max(errs[norm_k], r["norm_abs"])
                    errs[apply_k] = max(errs[apply_k], r["apply_abs"])
                    norm_rel = max(norm_rel, r["norm_rel"])
                    case_rel = max(case_rel, r["norm_rel"])
                    if label.startswith("qwen") and name in ("lars",
                                                             "lamb"):
                        timings[(mode, precision)] = time_seg(
                            su, spec, w, g, bufs, ids, r["table"], mode,
                            sr)
                print(f"kernel segmented {label} {precision} "
                      f"{'lamb' if lamb else 'lars/paper'}: "
                      f"{spec.num_segments} segments, {spec.num_rows} "
                      f"rows; tables repeat bitwise (within "
                      f"{case_rel:.3e} of plain), pass 2 bitwise equal "
                      f"to plain", flush=True)
                del w, g, bufs
                torch.cuda.empty_cache()
    print(f"kernel segmented: pass-1 tables within {norm_rel:.3e} "
          f"relative of the plain version (bound {NORM_RTOL}); max abs "
          f"err {errs}", flush=True)
    for (mode, precision), t in sorted(timings.items()):
        for which in ("norm", "apply"):
            b = t[which]
            print(f"  {su.KERNELS[mode][which == 'apply']} "
                  f"{precision} at {KERNEL_GROUPS} layers: kernel "
                  f"{b['ms']:.4f} ms, plain {b['plain_ms']:.4f} ms, "
                  f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
                  f"{b['bytes']} B)", flush=True)
    return {"max_abs_err": errs, "norm_rel": norm_rel,
            "timings": timings}


def time_seg(su, spec, w, g, bufs, ids, table, mode, sr,
             iters: int = 10, plain_iters: int = 2) -> dict:
    """Kernel and plain times of both passes on these buffers (pass 2 in
    place on copies of the state), beside their bounds."""
    h = OPT_HYPER
    common = dict(b1=h["b1"], b2=h["b2"], eps=h["eps"], bc1=0.5, bc2=0.01)
    nseg = spec.num_segments
    kbufs = tuple(b.clone() for b in bufs)
    delta = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    apply_kw = dict(mode=mode, momentum=h["momentum"], stochastic_round=sr,
                    seed=1, **common)
    out = {}
    for which, kfn, pfn in (
            ("norm",
             lambda: su.seg_norm_cuda(w, g, bufs, ids, nseg, mode=mode,
                                      weight_decay=h["weight_decay"],
                                      **common),
             lambda: su.seg_norm_ref(w, g, bufs, ids, nseg, mode=mode,
                                     weight_decay=h["weight_decay"],
                                     **common)),
            ("apply",
             lambda: su.seg_apply_cuda(w, g, kbufs, ids, table,
                                       out_delta=delta, **apply_kw),
             lambda: su.seg_apply_ref(w, g, kbufs, ids, table,
                                      out_bufs=kbufs, out_delta=delta,
                                      **apply_kw))):
        b = seg_bound(which, mode, spec.num_rows, w.element_size(), nseg)
        b["ms"] = time_ms(kfn, iters)
        b["plain_ms"] = time_ms(pfn, plain_iters)
        out[which] = b
    return out


class LastStepCheck:
    """Stands in for ``ops.segmented_update`` during a training run and,
    at the run's last optimizer step, checks the kernels on the real
    buffers: the telemetry's per-segment w_norm / g_norm against
    ``torch.linalg.vector_norm`` in f32 of the same members, and the
    delta and new state of 4,096 random rows against the plain apply
    on the same table. Keeps the last call's buffers for timing."""

    def __init__(self, real, su, sref, steps: int):
        self.real, self.su, self.sref = real, su, sref
        self.steps = steps
        self.calls = 0
        self.report: dict = {}

    def _segment_norms(self, w2d, g2d, bufs, ids, kw):
        """f32 vector norms of every segment's w and b (b = g, or the
        wd-augmented Adam direction for lamb), chunked over rows."""
        counts = torch.bincount(ids.long(), minlength=len(kw["adapt_mask"]))
        ends = torch.cumsum(counts, 0).tolist()
        starts = [0] + ends[:-1]
        chunk = 1 << 20
        wn, bn = [], []
        for r0, r1 in zip(starts, ends):
            wsq = bsq = 0.0
            for c0 in range(r0, r1, chunk):
                c1 = min(r1, c0 + chunk)
                w = w2d[c0:c1].float()
                if kw["mode"] == "lamb":
                    d, _ = self.sref.direction(
                        "lamb", w, g2d[c0:c1].float(),
                        tuple(b[c0:c1].float() for b in bufs),
                        b1=kw["b1"], b2=kw["b2"], bc1=kw["bc1"],
                        bc2=kw["bc2"], eps=kw["eps"])
                    b = d + kw["weight_decay"] * w
                else:
                    b = g2d[c0:c1].float()
                wsq = wsq + torch.linalg.vector_norm(w) ** 2
                bsq = bsq + torch.linalg.vector_norm(b) ** 2
            wn.append(torch.sqrt(torch.as_tensor(wsq)))
            bn.append(torch.sqrt(torch.as_tensor(bsq)))
        return torch.stack(wn), torch.stack(bn)

    def __call__(self, w2d, g2d, bufs, *, delta=None, **kw):
        self.calls += 1
        if self.calls < self.steps:
            return self.real(w2d, g2d, bufs, delta=delta, **kw)
        torch.cuda.synchronize()
        self.report["peak_before_last_step"] = \
            torch.cuda.max_memory_allocated()
        ids = kw["seg_ids"]
        wn, bn = self._segment_norms(w2d, g2d, bufs, ids, kw)
        gen = torch.Generator(device=w2d.device).manual_seed(7)
        rows = torch.randint(0, w2d.shape[0], (4096,), generator=gen,
                             device=w2d.device)
        snap = (w2d[rows].clone(), g2d[rows].clone(),
                tuple(b[rows].clone() for b in bufs), ids[rows].clone())
        out = self.real(w2d, g2d, bufs, delta=delta, **kw)
        tel = out[2]
        torch.cuda.synchronize()
        rel = max(((tel["w_norm"] - wn).abs() / wn.clamp_min(1e-30))
                  .max().item(),
                  ((tel["g_norm"] - bn).abs() / bn.clamp_min(1e-30))
                  .max().item())
        if not rel <= NORM_RTOL:
            raise AssertionError(f"last step: telemetry norms {rel:.3e} "
                                 f"relative from vector_norm")
        table = self.sref.scales_from_ratio(
            tel["trust_ratio"], kw["adapt_mask"], kw["base_lr"],
            kw["weight_decay"])
        pbufs, pdelta = self.su.seg_apply_ref(
            snap[0], snap[1], snap[2], snap[3], table, rows=rows,
            mode=kw["mode"], momentum=kw["momentum"],
            nesterov=kw["nesterov"], b1=kw["b1"], b2=kw["b2"],
            eps=kw["eps"], bc1=kw["bc1"], bc2=kw["bc2"],
            stochastic_round=kw["stochastic_round"], seed=kw["seed"])
        err = (pdelta - out[1][rows]).abs().max().item()
        same = torch.equal(pdelta, out[1][rows]) and all(
            torch.equal(a, b[rows]) for a, b in zip(pbufs, out[0]))
        if not same:
            raise AssertionError(f"last step: the delta / state of 4096 "
                                 f"rows differ from the plain apply "
                                 f"({err:.3e})")
        self.report.update(norm_rel=rel, rows_abs_err=err,
                           buffers=(w2d, g2d, out[0], out[1], ids,
                                    table), kw=kw)
        return out


def phase_train_full(run, ops, su, sref, tree_leaves, argv: list,
                     label: str, want_layers: int = 36) -> dict:
    """One full-width qwen2.5-3b run through ``launch.train.run`` with
    the last step checked, then both kernels timed on its buffers."""
    steps = int(argv[argv.index("--steps") + 1])
    check = LastStepCheck(ops.segmented_update, su, sref, steps)
    ops.reset_launches()
    ops.segmented_update = check
    try:
        out = run(argv + ["--device", DEV, "--layerwise-every", "1"],
                  log_fn=lambda line: print(f"  {label}: {line}",
                                            flush=True))
    finally:
        ops.segmented_update = check.real
    launches = dict(ops.launches)
    mode = check.report["kw"]["mode"]
    norm_k, apply_k = su.KERNELS[mode]
    want = {k: 0 for k in launches}
    want.update({norm_k: steps, apply_k: steps})
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want} (1 norm + 1 apply per step)")
    if not np.all(np.isfinite(out["losses"])):
        raise AssertionError(f"{label}: losses {out['losses']}")
    cfg = out["model"].cfg
    n_params = sum(x.numel() for x in tree_leaves(out["state"].params))
    # ModelConfig.param_count leaves out the QKV biases
    bias = cfg.num_layers * (cfg.num_heads + 2 * cfg.num_kv_heads) \
        * cfg.head_dim_ if cfg.qkv_bias else 0
    if cfg.num_layers != want_layers \
            or n_params != cfg.param_count() + bias:
        raise AssertionError(f"{label}: {cfg.num_layers} layers, "
                             f"{n_params} params")
    peak = out["peak_memory_bytes"] or 0
    print(f"train {label}: qwen2.5-3b {cfg.num_layers} layers, {n_params} "
          f"params ({cfg.param_dtype}); losses "
          f"{[round(x, 4) for x in out['losses']]}; per step loss+grad "
          f"{[round(x * 1e3, 1) for x in out['loss_grad_seconds']]} ms, "
          f"optimizer {[round(x * 1e3, 1) for x in out['optimizer_seconds']]}"
          f" ms; peak {peak / 2**30:.2f} GiB ({peak} B; before the "
          f"checked step {check.report['peak_before_last_step']} B); "
          f"launches {norm_k}={launches[norm_k]} "
          f"{apply_k}={launches[apply_k]}; last step: telemetry norms "
          f"within {check.report['norm_rel']:.3e} of vector_norm, 4096 "
          f"rows bitwise equal to the plain apply", flush=True)

    # the two kernels at the main path's shapes, on its buffers (the
    # run is over: pass 2 may overwrite the state)
    w2d, g2d, bufs, delta, ids, table = check.report["buffers"]
    kw = check.report["kw"]
    nseg = len(kw["adapt_mask"])
    common = dict(b1=kw["b1"], b2=kw["b2"], eps=kw["eps"], bc1=kw["bc1"],
                  bc2=kw["bc2"])
    apply_kw = dict(mode=mode, momentum=kw["momentum"],
                    nesterov=kw["nesterov"],
                    stochastic_round=kw["stochastic_round"],
                    seed=kw["seed"], **common)
    rows = w2d.shape[0]
    res = {}
    for which, name, kfn, pfn in (
            ("norm", norm_k,
             lambda: su.seg_norm_cuda(w2d, g2d, bufs, ids, nseg, mode=mode,
                                      weight_decay=kw["weight_decay"],
                                      **common),
             lambda: su.seg_norm_ref(w2d, g2d, bufs, ids, nseg, mode=mode,
                                     weight_decay=kw["weight_decay"],
                                     **common)),
            ("apply", apply_k,
             lambda: su.seg_apply_cuda(w2d, g2d, bufs, ids, table,
                                       out_delta=delta, **apply_kw),
             lambda: su.seg_apply_ref(w2d, g2d, bufs, ids, table,
                                      out_bufs=bufs, out_delta=delta,
                                      **apply_kw))):
        b = seg_bound(which, mode, rows, w2d.element_size(), nseg)
        b["ms"] = time_ms(kfn, 5)
        b["plain_ms"] = time_ms(pfn, 1)
        b["launches"] = launches[name]
        res[name] = b
        print(f"  {name} at the main path's shapes ({rows} rows, "
              f"{w2d.dtype}): kernel {b['ms']:.4f} ms, plain "
              f"{b['plain_ms']:.4f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}, {b['bytes']} B)", flush=True)
    res[apply_k]["rows_abs_err"] = check.report["rows_abs_err"]
    return res


def phase_train_small_against_cpu(get_smoke_config, get_model,
                                  build_optimizer, training, lm_iterator,
                                  tree_leaves, tree_map, ops, su):
    """The qwen2.5-3b smoke LM in f32: 3 fused TVLARS and 3 fused LAMB
    steps on the card (kernels) against the CPU (plain versions), same
    weights and batches. Stated bounds, at each leaf's scale: TVLARS
    1e-5 on losses and params (the CPU tests' bound against the JAX
    package); LAMB 1e-4 on losses and 1e-3 on params, because its Adam
    direction m/(sqrt(v) + eps) turns a last-bit gradient difference at
    |g| ~ eps into a visible one (the port and the JAX package on the
    CPU already differ by 9.6e-5 after 3 steps)."""
    model = get_model(get_smoke_config("qwen2.5-3b"))
    for name in ("tvlars", "lamb"):
        cpu = model.init(0, device="cpu")
        results = []
        for dev, params in (("cpu", cpu),
                            (DEV, tree_map(lambda t: t.to(DEV), cpu))):
            params = tree_map(lambda t: t.detach().clone(), params)
            opt = build_optimizer(name, total_steps=10, learning_rate=2.0,
                                  batch_size=8, use_kernel="fused",
                                  segments=model.segments, device=dev)
            state = training.TrainState.create(params, opt)
            step = training.make_train_step(training.lm_task(model), opt)
            batches = lm_iterator(8, 64, model.cfg.vocab_size, seed=1,
                                  device=dev)
            ops.reset_launches()
            losses = []
            for _ in range(3):
                state, m = step(state, next(batches))
                losses.append(float(m["loss"]))
            results.append((losses, state.params, dict(ops.launches)))
        (lc, pc, kc), (lg, pg, kg) = results
        norm_k, apply_k = su.KERNELS["lamb" if name == "lamb" else "lars"]
        if kg[norm_k] != 3 or kg[apply_k] != 3 or any(kc.values()):
            raise AssertionError(f"small {name}: launches cpu {kc} card "
                                 f"{kg}")
        loss_rtol, param_rtol = (1e-4, 1e-3) if name == "lamb" \
            else (1e-5, 1e-5)
        np.testing.assert_allclose(lg, lc, rtol=loss_rtol)
        worst = 0.0
        for a, b in zip(tree_leaves(pg), tree_leaves(pc)):
            a, b = a.detach().cpu().numpy(), b.detach().numpy()
            scale = float(np.abs(b).max())
            worst = max(worst, float(np.abs(a - b).max()) / scale)
            np.testing.assert_allclose(a, b, rtol=param_rtol,
                                       atol=param_rtol * scale)
        print(f"small train: qwen2.5-3b smoke f32 fused {name}, 3 steps: "
              f"card (kernels) == cpu (plain) within {param_rtol} (losses "
              f"{[round(x, 6) for x in lg]}, worst param gap "
              f"{worst:.3e} of its leaf's scale)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch import serving, training
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import build_optimizer, flatten
    from repro_torch.core.base import tree_leaves, tree_map
    from repro_torch.data.synthetic import lm_iterator
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import attention_decode as tad
    from repro_torch.kernels import ref as sref
    from repro_torch.kernels import segmented_update as su
    from repro_torch.launch.train import run as train_run
    from repro_torch.models import convert, get_model
    from repro_torch.obs import Tracer, phase_summary

    # full-f32 matmuls and convolutions wherever f32 is computed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    report = _build.build(["attention_decode", "segmented_update"])
    for name, r in report.items():
        print(f"build: {name} in {r['seconds']:.1f} s -> {r['path']}")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build: total {time.perf_counter() - t0:.1f} s", flush=True)

    kernel = phase_kernel(tad, ops)
    seg = phase_seg_kernels(su, sref, flatten, convert, get_config)
    gc.collect()
    torch.cuda.empty_cache()
    main_path = phase_serving(ops, serving, get_config, get_model, Tracer,
                              phase_summary,
                              tad.decode_parity_tolerance(torch.bfloat16))
    gc.collect()
    torch.cuda.empty_cache()
    phase_f32_full_width(ops, serving, get_config, get_model)
    gc.collect()
    torch.cuda.empty_cache()
    phase_small_against_cpu(serving, get_smoke_config, get_model)

    # the training path at full width: (a) fused TVLARS in f32, (b) fused
    # LAMB with bf16 stochastic-rounded state and 2 microbatches
    train = {}
    for label, argv in (
            ("tvlars-f32", ["--optimizer", "tvlars", "--use-kernel",
                            "fused", "--precision", "f32",
                            "--global-batch", "8", "--seq", "512",
                            "--steps", "3"]),
            ("lamb-bf16sr-K2", ["--optimizer", "lamb", "--use-kernel",
                                "fused", "--precision", "bf16_master_sr",
                                "--global-batch", "8", "--microbatch",
                                "4", "--seq", "512", "--steps", "3"])):
        train.update(phase_train_full(train_run, ops, su, sref,
                                      tree_leaves, argv, label))
        gc.collect()
        torch.cuda.empty_cache()
    phase_train_small_against_cpu(get_smoke_config, get_model,
                                  build_optimizer, training, lm_iterator,
                                  tree_leaves, tree_map, ops, su)

    # the serving path's mix: 40 local and 8 global launches per decode
    # step (bf16 pool); per-launch means weighted by that mix
    rows = kernel["rows"]
    n = LOCAL_PER_STEP + GLOBAL_PER_STEP

    def mix(key):
        return (LOCAL_PER_STEP * rows[("local", torch.bfloat16)][key]
                + GLOBAL_PER_STEP * rows[("global", torch.bfloat16)][key]) \
            / n

    entries = [{"name": "attention_decode", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/attention_decode.cu",
                "replaces": "src/repro/kernels/attention_decode.py:63",
                "launches": main_path["launches"],
                "max_abs_err": kernel["max_abs_err"],
                "ms": mix("ms"), "plain_ms": mix("plain_ms"),
                "bound_ms": mix("bound_ms"),
                "bound_by": "bytes" if mix("bytes_ms") >= mix("ops_ms")
                else "operations",
                "library_ms": mix("library_ms")}]
    # the segmented kernels: times at the main path's shapes (the
    # training runs' own buffers); no single PyTorch call computes
    # either pass, so library_ms is null
    for name, replaces in SEG_KERNELS.items():
        t = train[name]
        entries.append({
            "name": name, "route": "cuda", "source": SEG_SOURCE,
            "replaces": replaces, "launches": t["launches"],
            "max_abs_err": max(seg["max_abs_err"][name],
                               t.get("rows_abs_err", 0.0)),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    print(smi_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
