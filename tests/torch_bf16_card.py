"""How far bf16 rounding alone moves the layer-wise ``g_norm`` that
phase 19a of ``chip_smoke.py`` holds on the card (not collected).

    python tests/torch_bf16_card.py       # one CUDA card

Phase 19a trains whisper-large-v3 and llama-3.2-vision-11b at full
width, cut in depth (``chip_smoke.FT_CUTS``), one tree-TVLARS step on a
``(1, 2)`` mesh against one device, in f32. In bf16 the vlm's cross
gate and whisper's final norm scale miss ``TT_BOUNDS``' 1e-2 on
``g_norm``. This script asks whether bf16 alone moves those numbers as
far, on 19a's own launcher path (its seeded extra embeddings, the vlm's
opened gates), with the same cut in bf16:

* ``m1``: one device (19a's reference run);
* ``k2``: one device, the batch in 2 microbatches summed in f32: the
  same sums in another order, no mesh;
* ``f32``: one device in f32 on the bf16 run's weights and embeddings
  (rounded to bf16): the value the bf16 runs round;
* ``m2``: the ``(1, 2)`` mesh on two gloo ranks sharing the card;
* ``m2h``: ``m2`` with the vocabulary-parallel head's input gradient
  reduced in f32 on each rank and rounded once after the row sum
  (:func:`chunk_ce_head_f32` in place of the port's
  ``losses._chunk_ce_vocab_parallel``, whose bf16 product rounds each
  rank's partial first): whether that rounding makes ``m2``'s gap.

For the held segments (a vlm gate, the final norms) and for the segment
where ``m2`` is farthest from ``m1`` it prints each ``g_norm`` and its
gap to ``f32``, and ``m2``'s to ``m1``, and writes them to
``chiprun_out/bf16_card.json``. The verdict: the ``(1, 2)`` gap is
rounding where ``m2`` lies no farther from ``f32`` than twice the farther
of the two one-device bf16 runs (``m1``, ``k2``); otherwise the mesh
adds an error of its own.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.base import (path_name, tree_flatten_with_path,  # noqa
                                   tree_leaves)

ARCHS = ("whisper-large-v3", "llama-3.2-vision-11b")


def bf16_cut(arch: str) -> dict:
    return {k: v for k, v in cs.FT_CUTS[arch].items() if k not in cs.FT_F32}


@contextlib.contextmanager
def bf16_rounded(launcher):
    """Inside the block the launcher's model starts from its params
    rounded to bf16 and its extra embeddings are rounded to bf16: the
    f32 run on the bf16 run's values."""
    real_stub, real_get_model = launcher._stub_frontend, launcher.get_model

    def stub(cfg, batch):
        out = real_stub(cfg, batch)
        e = out.get("extra_embeds")
        if e is not None:
            out["extra_embeds"] = e.to(torch.bfloat16).to(e.dtype)
        return out

    def get_model(cfg):
        model = real_get_model(cfg)

        def init(seed=0, *, device="cuda", **kw):
            params = model.init(seed, device=device, **kw)
            with torch.no_grad():
                for t in tree_leaves(params):
                    if t.is_floating_point():
                        t.copy_(t.to(torch.bfloat16).to(t.dtype))
            return params
        return model._replace(init=init)

    launcher._stub_frontend, launcher.get_model = stub, get_model
    try:
        yield
    finally:
        launcher._stub_frontend, launcher.get_model = real_stub, \
            real_get_model


def ref_path(arch: str) -> str:
    return os.path.join(tempfile.gettempdir(), f"bf16_card_{arch}.pt")


def one_device(train_launch, arch: str, cut: dict, extra=(),
               rounded=False) -> dict:
    """The first step's history record of one device's run; the bf16
    run without ``extra`` saves its params for ``ft_rank``'s gap."""
    with cs.config_cut(train_launch, arch, **cut), \
            cs.ft_live(train_launch, arch), \
            (bf16_rounded(train_launch) if rounded
             else contextlib.nullcontext()):
        out = train_launch.run(cs.ft_argv(arch) + list(extra),
                               log_fn=lambda line: None)
    if not rounded and not extra:
        torch.save({path_name(p): t.detach().cpu() for p, t in
                    tree_flatten_with_path(out["state"].params)},
                   ref_path(arch))
    rec = out["history"][0]
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return rec


class _HeadF32Grad(torch.autograd.Function):
    """``h32 @ w`` in ``w``'s dtype for an f32 ``h32`` that holds values
    of that dtype; the backward returns ``h32``'s gradient in f32."""

    @staticmethod
    def forward(ctx, h32, w):
        ctx.save_for_backward(h32, w)
        return h32.to(w.dtype) @ w

    @staticmethod
    def backward(ctx, g):
        h32, w = ctx.saved_tensors
        h = h32.to(w.dtype)
        dw = h.reshape(-1, h.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        return g.float() @ w.float().t(), dw


def chunk_ce_head_f32(h_blk, unembed_w, y_blk, mesh):
    """``losses._chunk_ce_vocab_parallel`` with the logits' product
    through :class:`_HeadF32Grad`: the same forward, and each rank's
    partial of ``h_blk``'s gradient summed over the row in f32."""
    from repro_torch.distributed import copy_to_row, sum_over_row
    HEAD_F32_CALLS[0] += 1
    logits = _HeadF32Grad.apply(copy_to_row(h_blk.float(), mesh),
                                unembed_w).float()
    local = logits.shape[-1]
    m = mesh.row_max_(logits.detach().amax(dim=-1))
    sumexp = sum_over_row(torch.exp(logits - m[..., None]).sum(dim=-1),
                          mesh)
    loc = y_blk.long() - mesh.coords["model"] * local
    mine = (loc >= 0) & (loc < local)
    gold = torch.gather(logits, -1,
                        torch.where(mine, loc, 0)[..., None])[..., 0]
    gold = sum_over_row(torch.where(mine, gold, torch.zeros_like(gold)),
                        mesh)
    return torch.sum(torch.log(sumexp) + m - gold)


HEAD_F32_CALLS = [0]


def ft_rank_head_f32(arch: str, cut: dict, mesh_shape: tuple,
                     ref_path: str) -> dict:
    """``chip_smoke.ft_rank`` with :func:`chunk_ce_head_f32` as the
    head's loss; its calls under ``head_f32_calls``."""
    from repro_torch.training import losses
    real = losses._chunk_ce_vocab_parallel
    losses._chunk_ce_vocab_parallel = chunk_ce_head_f32
    HEAD_F32_CALLS[0] = 0
    try:
        res = cs.ft_rank(arch, cut, mesh_shape, ref_path)
    finally:
        losses._chunk_ce_vocab_parallel = real
    res["head_f32_calls"] = HEAD_F32_CALLS[0]
    return res


def held(key: str) -> bool:
    seg = key[len("layerwise/"):-len("/g_norm")]
    return seg.endswith("gate") or seg.startswith("final_norm")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_bf16_card: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch import train as train_launch
    out = {}
    for arch in ARCHS:
        cut = bf16_cut(arch)
        runs = {"m1": one_device(train_launch, arch, cut),
                "k2": one_device(train_launch, arch, cut,
                                 ["--microbatch", str(cs.TT_BATCH // 2)]),
                "f32": one_device(train_launch, arch,
                                  dict(cut, **cs.FT_F32), rounded=True)}
        ranks = cs.on_ranks(cs.ft_rank, 2, args=(arch, cut, (1, 2),
                                                 ref_path(arch)), timeout=600)
        runs["m2"] = ranks[0]["history"][0]
        ranks = cs.on_ranks(ft_rank_head_f32, 2, args=(
            arch, cut, (1, 2), ref_path(arch)), timeout=600)
        if not ranks[0]["head_f32_calls"]:
            raise AssertionError(f"{arch}: the head is not split at (1, 2)")
        runs["m2h"] = ranks[0]["history"][0]
        os.remove(ref_path(arch))
        norms = [k for k in runs["m1"] if k.endswith("/g_norm")]
        worst = max(norms, key=lambda k: abs(runs["m2"][k] - runs["m1"][k])
                    / abs(runs["m1"][k]))
        rows = {}
        for key in sorted({worst, *filter(held, norms)}):
            v = {r: float(runs[r][key]) for r in runs}
            exact = v["f32"]
            gap = {r: abs(v[r] - exact) / abs(exact)
                   for r in ("m1", "k2", "m2", "m2h")}
            gap["m2 to m1"] = abs(v["m2"] - v["m1"]) / abs(v["m1"])
            gap["rounding"] = gap["m2"] <= 2 * max(gap["m1"], gap["k2"])
            rows[key] = {"g_norm": v, "gaps": gap}
            print(f"{arch} {key}: g_norm " + ", ".join(
                f"{r} {x:.6e}" for r, x in v.items()) + "; to f32: " +
                ", ".join(f"{r} {gap[r]:.4%}"
                          for r in ("m1", "k2", "m2", "m2h"))
                + f"; m2 to m1 {gap['m2 to m1']:.4%}; rounding: "
                f"{gap['rounding']}" + (" (worst m2 to m1)"
                                        if key == worst else ""),
                flush=True)
        out[arch] = {"cut": cut, "loss": {r: float(runs[r]["loss"])
                                          for r in runs}, "segments": rows}
        print(f"{arch} loss: " + ", ".join(
            f"{r} {x:.6f}" for r, x in out[arch]["loss"].items()),
            flush=True)
    cs.close_pools()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "bf16_card.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
