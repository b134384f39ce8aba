"""Serving example on the PyTorch port: the continuous-batching engine vs
per-request generate, on a reduced assigned architecture. The twin of
``examples/serve_lm.py``.

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch gemma3-12b] \\
        [--device cpu]

Submits a few greedy requests with staggered arrivals to a
:class:`repro_torch.serving.Engine` and checks the multiplexed decode
reproduces per-request ``generate`` token-for-token. The JAX script
checks that its decode step compiled once; the port compiles nothing,
so this one checks what its decode step launches instead: on CUDA,
one decode-attention kernel launch per attention layer per decode step
(``Engine.stats()["kernel_launches"]``), on the CPU none (the plain
PyTorch version). Runs on CUDA unless ``--device cpu``. :func:`run`
takes the params and the prompts, so a caller can feed the JAX
package's own.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import serving
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import extra_embed_shape, get_model


def attention_layers(cfg) -> int:
    """Decode-attention kernel launches per decode step: one per self-
    attention layer (the vlm's gated cross layers and the encoder-decoder's
    cross attention are plain PyTorch), one per call site of zamba2's
    shared block, none for mamba2."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    return cfg.num_layers


def run(arch: str = "gemma3-12b", num_tokens: int = 16, requests: int = 4,
        device="cuda", *, params=None, prompts=None, log_fn=print) -> dict:
    """Serve ``requests`` greedy requests of ``arch``'s smoke config;
    returns ``{"tokens": [per request], "stats": engine stats or None,
    "launches": decode-kernel launches, "expected": what they must
    be}``. ``params`` default to ``model.init(0)``; ``prompts`` to the
    JAX script's (``RandomState(0)`` rows of 8 for the engine;
    ``requests`` x 8 ints for ``generate``, from ``RandomState(1)``
    here, the JAX PRNG's key 1 there)."""
    dev = _device.resolve(device)
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    if params is None:
        params = model.init(0, device=dev)
    on_card = dev.type == "cuda"
    per_step = attention_layers(cfg) if on_card else 0
    log_fn(f"{arch} (reduced: {cfg.num_layers}L d={cfg.d_model}) — "
           f"family={cfg.family}")

    sc = serving.ServeConfig(slots=max(2, requests // 2), max_len=64,
                             page_size=8)
    extra = None
    es = extra_embed_shape(cfg, sc.slots)
    if es is not None:
        extra = torch.zeros(es, dtype=torch.float32, device=dev)
        log_fn(f"modality frontend stub: embeddings {es}")

    if model.prefill is None:
        # ssm / hybrid / encdec: no batched-prefill lowering — the
        # per-request generate path the engine parity targets
        prompt = np.random.RandomState(1).randint(
            0, cfg.vocab_size, (requests, 8)) if prompts is None \
            else np.asarray(prompts)
        if extra is not None:
            extra = torch.zeros((requests,) + es[1:], dtype=torch.float32,
                                device=dev)
        before = ops.decode_launches()
        with torch.no_grad():
            out = serving.generate(model, params, prompt,
                                   num_tokens=num_tokens,
                                   extra_embeds=extra, device=dev)
            out2 = serving.generate(model, params, prompt,
                                    num_tokens=num_tokens,
                                    extra_embeds=extra, device=dev)
        launches = ops.decode_launches() - before
        assert (out == out2).all(), "greedy decode must be deterministic"
        # each call prefills the prompt token by token, then decodes
        expected = 2 * per_step * (prompt.shape[1] + num_tokens)
        assert launches == expected, (launches, expected)
        log_fn(f"(no engine for family={cfg.family}; generate path OK: "
               f"{tuple(prompt.shape)} -> {tuple(out.shape)}; "
               f"{launches} decode-kernel launches)")
        return {"tokens": out.cpu().numpy().tolist(), "stats": None,
                "launches": launches, "expected": expected}

    eng = serving.Engine(model, params, sc, extra=extra, device=dev)
    if prompts is None:
        rng = np.random.RandomState(0)
        prompts = [rng.randint(1, cfg.vocab_size, size=8)
                   for _ in range(requests)]

    ids = [eng.submit(p, max_new_tokens=num_tokens)
           for p in prompts[: requests // 2]]
    eng.step()                      # staggered: inject the rest mid-flight
    ids += [eng.submit(p, max_new_tokens=num_tokens)
            for p in prompts[requests // 2:]]
    eng.drain()

    tokens = []
    for i, (rid, p) in enumerate(zip(ids, prompts)):
        got = eng.result(rid).tokens
        with torch.no_grad():
            ref = serving.generate(
                model, params, np.asarray(p)[None],
                num_tokens=num_tokens, max_len=sc.max_len,
                extra_embeds=None if extra is None else extra[:1],
                device=dev)
        want = [int(x) for x in ref.cpu().numpy()[0]]
        assert got == want, f"req {i}: engine {got} != generate {want}"
        tokens.append(got)
        if i < 2:
            log_fn(f"  req {i}: {got}")

    stats = eng.stats()
    expected = per_step * stats["decode_steps"]
    assert stats["kernel_launches"] == expected, (stats, expected)
    log_fn(f"engine == per-request generate on {len(ids)} staggered "
           f"requests; {stats['kernel_launches']} decode-kernel launches "
           f"= {per_step} attention layers x {stats['decode_steps']} decode "
           f"steps (prefill {stats['prefills']}x, {stats['reused_pages']} "
           f"pages reused)")
    return {"tokens": tokens, "stats": stats,
            "launches": stats["kernel_launches"], "expected": expected}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gemma3-12b", choices=ARCH_IDS)
    ap.add_argument("--num-tokens", type=int, default=16)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(args.arch, args.num_tokens, args.requests, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
