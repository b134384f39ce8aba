#!/usr/bin/env python3
"""Time the decode-attention kernel's design choices on one GPU.

    python3 tools/decode_sweep.py

Builds the shipped ``csrc/attention_decode.cu`` and copies of it with
one thing changed, each into ``build/decode_sweep/`` (gitignored under
``build/``), and times every build at gemma3-12b's four phase-3 shapes
of ``chip_smoke.py`` (8 slots, 16 / 8 heads of 256; local T=1024 and
global T=2048, bf16 and f32 pools, the same positions) for splits of
64 KB, 128 KB (the shipped ``SPLIT_BYTES``) and 256 KB of K rows. The
copies:

* ``copy-only``: the chunk loop keeps its ``cp.async`` ring and waits
  but does no arithmetic, so its time is what moving the bytes costs in
  this design (its outputs are not attention and are not checked);
* ``4-warps``: 4 warps a block of 3 stages of 2 KB chunks (the first
  design tried);
* ``16-warps``: 16 warps a block, 3 stages;
* ``expf-fast``: ``__expf`` in place of ``expf``.

Every build but ``copy-only`` is checked against the plain version
(``decode_parity_tolerance``). Times are the card's (a CUDA graph of
50 launches, replayed; ``chip_smoke.device_ms``), printed beside the
byte bound and one ``scaled_dot_product_attention`` call, then the
``nvidia-smi`` name and power limit. Needs a CUDA GPU.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "decode_sweep"
SPLITS = (64 * 1024, 128 * 1024, 256 * 1024)
# name -> (warps, stages, chunk bytes, edit of the source or None)
NO_MATH = ("      acc[0][0][0] += reinterpret_cast<const float*>(st)[lane];\n"
           "      (void)r0;\n    }\n    cp_async_wait<0>();")
VARIANTS = {
    "shipped": (8, 4, 1024, None),
    "copy-only": (8, 4, 1024, lambda s: _sub(
        r"      float s\[kRows \* G\];.*?\n    \}\n    cp_async_wait<0>\(\);",
        NO_MATH, s)),
    "4-warps": (4, 3, 2048, None),
    "16-warps": (16, 3, 1024, None),
    "expf-fast": (8, 4, 1024, lambda s: s.replace("expf(", "__expf(")),
}


def _sub(pattern: str, repl: str, s: str) -> str:
    out, n = re.subn(pattern, lambda _: repl, s, flags=re.S)
    if n != 1:
        raise RuntimeError(f"pattern matched {n} times")
    return out


def build_all(_build) -> dict:
    src = (_build.CSRC / "attention_decode.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (warps, stages, chunk, edit) in VARIANTS.items():
        s = _sub(r"constexpr int kWarps = \d+;",
                 f"constexpr int kWarps = {warps};", src)
        s = _sub(r"constexpr int kStages = \d+;",
                 f"constexpr int kStages = {stages};", s)
        s = _sub(r"constexpr int kChunkBytes = \d+;",
                 f"constexpr int kChunkBytes = {chunk};", s)
        if edit is not None:
            s = edit(s)
        cu = OUT / f"{name}.cu"
        cu.write_text(s)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        regs = sorted({int(x) for x in re.findall(r"Used (\d+) registers",
                                                   log)})
        spill = max([int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                                log)] or [0])
        print(f"build {name}: registers {regs}, spill stores at most "
              f"{spill} B", flush=True)
    return {name: OUT / f"{name}.so" for name in VARIANTS}


def use(tad, path: Path, warps: int, stages: int, chunk: int) -> None:
    """Point the wrapper at one build and its shape constants."""
    lib = ctypes.CDLL(str(path))
    fn = lib.repro_attention_decode
    fn.argtypes = tad.C_ARGTYPES
    fn.restype = ctypes.c_int
    tad._lib = lambda: lib
    tad.WARPS, tad.STAGES = warps, stages
    tad.ROWS = {dt: chunk // (tad.MAX_HEAD_DIM * size)
                for dt, size in tad._ITEMSIZE.items()}
    tad.decode_plan.cache_clear()
    tad._plans.clear()


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_sweep: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import attention_decode as tad

    libs = build_all(_build)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = []
    for dtype in (torch.bfloat16, torch.float32):
        for kind in ("local", "global"):
            t = cs.WINDOW if kind == "local" else cs.MAX_LEN
            window = cs.WINDOW if kind == "local" else None

            def randn(*shape):
                return torch.randn(shape, generator=gen, device=dev).to(dtype)

            ops_in = (randn(cs.SLOTS, 1, cs.HEADS, cs.HEAD_DIM),
                      randn(cs.SLOTS, 1, cs.KV_HEADS, cs.HEAD_DIM),
                      randn(cs.SLOTS, 1, cs.KV_HEADS, cs.HEAD_DIM),
                      randn(cs.SLOTS, t, cs.KV_HEADS, cs.HEAD_DIM),
                      randn(cs.SLOTS, t, cs.KV_HEADS, cs.HEAD_DIM),
                      torch.tensor(cs.POS[kind], dtype=torch.int32,
                                   device=dev))
            q, _, _, kc, vc, pos = ops_in
            posl = pos.long()[:, None]
            kpos = torch.arange(t, device=dev)[None, :]
            if window is None:
                ok = kpos <= posl
            else:
                wraps = (posl // t) * t
                a = kpos + torch.where(kpos <= posl % t, wraps, wraps - t)
                ok = (a >= 0) & (a <= posl) & (a > posl - window)
            mask = ok[:, None, None, :]
            qs, ks, vs = (x.transpose(1, 2) for x in (q, kc, vc))
            sdpa_ms = cs.device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, enable_gqa=True))
            bound = 2 * int(ok.sum()) * cs.KV_HEADS * cs.HEAD_DIM \
                * kc.element_size() / cs.HBM_BYTES_PER_S * 1e3
            label = f"{kind} T={t} {str(dtype).split('.')[-1]}"
            print(f"{label}: K/V byte bound {bound:.4f} ms, sdpa "
                  f"{sdpa_ms:.4f} ms", flush=True)
            shapes.append((label, window, ops_in))
    shipped = tad.SPLIT_BYTES
    for name, (warps, stages, chunk, _) in VARIANTS.items():
        use(tad, libs[name], warps, stages, chunk)
        for label, window, (q, nk, nv, kc, vc, pos) in shapes:
            cells = []
            for split in SPLITS:
                tad.SPLIT_BYTES = split
                tad.decode_plan.cache_clear()
                tad._plans.clear()
                keys = tad.split_keys(kc.shape[1], kc.shape[3], kc.dtype)

                def kernel():
                    return ops.attention_decode(q, nk, nv, kc, vc, pos,
                                                window=window)

                if name != "copy-only":
                    kp, vp = kc.clone(), vc.clone()
                    want = tad.attention_decode_ref(q, nk, nv, kp, vp, pos,
                                                    window=window)
                    torch.testing.assert_close(
                        kernel().float(), want.float(),
                        **tad.decode_parity_tolerance(kc.dtype))
                cells.append(f"L={keys}: {cs.device_ms(kernel):.4f}")
            print(f"  {name:9s} {label}: " + ", ".join(cells) + " ms",
                  flush=True)
    tad.SPLIT_BYTES = shipped
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
