#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU (written for an H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing its own lines; a failing phase raises and the
script exits non-zero:

1. device: the card's name and its ``nvidia-smi`` name and power limit;
2. build: ``nvcc`` builds every kernel of the serving path from
   ``src/repro_torch/kernels/csrc`` (timed);
3. kernel against its plain version at gemma3-12b's full-width decode
   shapes (8 slots, 16 heads, 8 KV heads, head_dim 256): a windowed
   ring of T=1024 with positions several laps past the window and a
   global cache of T=2048, bf16 and f32 pools. Outputs within
   ``decode_parity_tolerance``, updated caches bitwise equal. Times the
   kernel, the plain version and one ``scaled_dot_product_attention``
   call over the same cache (a yardstick only: the port never calls
   it), beside the least time the card could take (the bound);
4. serving at full width: gemma3-12b, all 48 layers, bf16, random
   weights from seed 0 on the card, ``ServeConfig(slots=8,
   max_len=2048, page_size=16)``; 12 requests (more than the slots)
   with prompts of 256-1536 tokens (some longer than the 1024-token
   window) and 32-96 new tokens each, drained through the engine.
   Checks every request's token count, that the decode-attention
   kernel launched 48 times per decode step, and that two requests
   re-run alone through ``generate`` give the same greedy tokens up to
   bf16 ties (the two paths multiply matrices of other shapes, so they
   round differently; where tokens differ, every engine token must be
   the alone path's argmax within bf16 tolerance);
5. the same traffic through gemma3-12b at full width and depth in f32:
   engine and ``generate`` give exactly the same greedy tokens;
6. the same engine at smoke size in f32 on the card against the CPU's
   plain path on the same weights, token for token.

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch import serving
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import attention_decode as tad
    from repro_torch.models import get_model
    from repro_torch.obs import Tracer, phase_summary

    # full-f32 matmuls and convolutions wherever f32 is computed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    report = _build.build(["attention_decode"])
    for name, r in report.items():
        print(f"build: {name} in {r['seconds']:.1f} s -> {r['path']}")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build: total {time.perf_counter() - t0:.1f} s", flush=True)

    kernel = phase_kernel(tad, ops)
    main_path = phase_serving(ops, serving, get_config, get_model, Tracer,
                              phase_summary,
                              tad.decode_parity_tolerance(torch.bfloat16))
    gc.collect()
    torch.cuda.empty_cache()
    phase_f32_full_width(ops, serving, get_config, get_model)
    gc.collect()
    torch.cuda.empty_cache()
    phase_small_against_cpu(serving, get_smoke_config, get_model)

    # the main path's mix: 40 local and 8 global launches per decode step
    # (bf16 pool); per-launch means weighted by that mix
    rows = kernel["rows"]
    n = LOCAL_PER_STEP + GLOBAL_PER_STEP

    def mix(key):
        return (LOCAL_PER_STEP * rows[("local", torch.bfloat16)][key]
                + GLOBAL_PER_STEP * rows[("global", torch.bfloat16)][key]) \
            / n

    entry = {"name": "attention_decode", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/attention_decode.cu",
             "replaces": "src/repro/kernels/attention_decode.py:63",
             "launches": main_path["launches"],
             "max_abs_err": kernel["max_abs_err"],
             "ms": mix("ms"), "plain_ms": mix("plain_ms"),
             "bound_ms": mix("bound_ms"),
             "bound_by": "bytes" if mix("bytes_ms") >= mix("ops_ms")
             else "operations",
             "library_ms": mix("library_ms")}
    print(smi_line())
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
