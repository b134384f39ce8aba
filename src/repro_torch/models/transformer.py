"""Decoder-only transformer LM: the dense, MoE and vlm families and
the gemma3 local:global pattern.

The port of ``repro.models.transformer``. The reference scans over
groups of stacked layers; here the layers are a Python list of
``G × len(kinds)`` per-layer parameter dicts, layer ``g * len(kinds) +
i`` being kind ``kinds[i]`` of group ``g``. Each layer is pre-norm:
h += attn(norm(h)); h += mlp|moe(norm(h)). An MoE layer
(``cfg.num_experts``) returns its aux losses, which ``apply_lm_hidden``
sums over the layers; prefill and decode drop them.

vlm (``cross_attn_every`` = N): a group is N self-attention layers and
one gated cross layer, a full attention + MLP block whose attention
reads the image embeddings (``extra_embeds`` [B, T_img, D], no RoPE,
no mask) and is scaled by tanh(gate), a 0-d f32 leaf that starts at 0
(closed: the image is ignored until training opens it).

The KV cache is a list with one dict per layer: ``{"k", "v"}`` of
``[B, T, Hkv, Dh]`` (``T = min(window, max_len)`` for local layers),
which decode appends into in place, or for a cross layer ``{"ck",
"cv"}`` of ``[B, T_img, Hkv, Dh]``, the image's K/V, which decode only
reads. On a mesh with a model axis each leaf is the rank's block
(``layers.cache_block``, ``cache_pspecs``' rule): its KV heads, else
block r of T, else block r of the head dim, of every KV head.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M


def _group_spec(cfg: ModelConfig) -> tuple[int, list[str]]:
    """Returns (num_groups, [kind per layer-in-group])."""
    if cfg.family == "vlm" and cfg.cross_attn_every:
        n = cfg.cross_attn_every
        if cfg.num_layers % n:
            raise ValueError(f"num_layers {cfg.num_layers} is not a "
                             f"multiple of cross_attn_every {n}")
        return cfg.num_layers // n, ["attn"] * n + ["cross"]
    if cfg.global_every and cfg.sliding_window:
        n = cfg.global_every
        if cfg.num_layers % n:
            raise ValueError(f"num_layers {cfg.num_layers} is not a "
                             f"multiple of global_every {n}")
        return cfg.num_layers // n, ["local"] * (n - 1) + ["attn"]
    return cfg.num_layers, ["attn"]


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """The kind ("local" | "attn" | "cross") of every layer, in
    order."""
    groups, kinds = _group_spec(cfg)
    return kinds * groups


def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    return cfg.sliding_window if kind == "local" else None


def _cache_len(cfg: ModelConfig, kind: str, max_len: int) -> int:
    if kind == "local" and cfg.sliding_window:
        return min(cfg.sliding_window, max_len)
    return max_len


def _masks(cfg: ModelConfig) -> dict:
    return {"attn": ("causal", None),
            "local": ("causal", cfg.sliding_window)
            if cfg.sliding_window else None,
            "cross": None}


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def init_layer(cfg: ModelConfig, gen, device, kind: str = "attn") -> dict:
    """kind: attn | local | cross, all attention + FFN blocks; a cross
    layer has an MLP (never experts) and a closed ``gate``."""
    p = {"norm1": L.init_norm(cfg, cfg.d_model, device),
         "attn": L.init_attention(cfg, gen, device),
         "norm2": L.init_norm(cfg, cfg.d_model, device)}
    if cfg.num_experts and kind != "cross":
        p["moe"] = M.init_moe(cfg, gen, device)
    else:
        p["mlp"] = L.init_mlp(cfg, gen, device)
    if kind == "cross":
        p["gate"] = torch.zeros((), dtype=torch.float32, device=device)
    return p


def init_lm(cfg: ModelConfig, gen: torch.Generator,
            device: torch.device) -> dict:
    """Random weights drawn from ``gen`` on ``device``: normal(0.02),
    out-projections normal(0.02 / sqrt(2L)), zero norm scales."""
    return {"embed": L.init_embedding(cfg, gen, device),
            "layers": [init_layer(cfg, gen, device, kind)
                       for kind in layer_kinds(cfg)],
            "final_norm": L.init_norm(cfg, cfg.d_model, device)}


def _device(params: dict) -> torch.device:
    return params["embed"]["table"].device


# --------------------------------------------------------------------------
# full-sequence forward
# --------------------------------------------------------------------------

def _ffn(p: dict, cfg: ModelConfig, x: torch.Tensor, seq=None):
    """The layer's MLP or MoE on x: (y, MoE aux or None)."""
    if "moe" in p:
        return M.moe_apply(p["moe"], cfg, x, seq)
    return L.mlp(p["mlp"], cfg, x, seq), None


def _gated(p: dict, a: torch.Tensor, seq=None) -> torch.Tensor:
    """A cross layer's attention output scaled by tanh(gate) (the gate's
    gradient summed over the row when ``a`` is the rank's block of the
    sequence)."""
    return torch.tanh(L.seq_params(p["gate"], seq)).to(a.dtype) * a


def layer_apply(p: dict, cfg: ModelConfig, h: torch.Tensor,
                positions: torch.Tensor, mask, return_kv: bool = False,
                kind: str = "attn",
                kv_src: Optional[torch.Tensor] = None, seq=None):
    """One layer over a full sequence: (h, aux), aux the MoE losses
    (None for an MLP layer); with ``return_kv``, (h, (k, v)) and the
    aux dropped, as the reference's prefill forward does. A cross layer
    attends to ``kv_src`` through its gate. ``seq`` (sequence
    parallelism, ``layers.seq_mesh``): ``h`` is the rank's block of the
    sequence, ``positions`` the whole sequence's."""
    out = L.attention(p["attn"], cfg, L.norm(cfg, p["norm1"], h, seq),
                      positions, mask, return_kv=return_kv,
                      kv_src=kv_src, use_rope=kind != "cross", seq=seq)
    a, kv = out if return_kv else (out, None)
    if kind == "cross":
        a = _gated(p, a, seq)
    h = h + a
    y, aux = _ffn(p, cfg, L.norm(cfg, p["norm2"], h, seq), seq)
    h = h + y
    return (h, kv) if return_kv else (h, aux)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device)[None].expand(b, s)


class LMAux(NamedTuple):
    """MoE auxiliary losses summed over the layers; zero for the dense,
    ssm and hybrid families (the reference's ``zero_aux``)."""
    load_balance_loss: torch.Tensor
    router_z_loss: torch.Tensor


def zero_aux(device) -> LMAux:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return LMAux(z, z)


def _kv_src(cfg: ModelConfig, extra: Optional[torch.Tensor],
            dtype: torch.dtype) -> Optional[torch.Tensor]:
    """The cross layers' source: ``extra`` in the activations' dtype;
    a vlm without it raises."""
    if extra is None:
        if "cross" in _group_spec(cfg)[1]:
            raise ValueError("vlm needs image embeddings: pass extra "
                             "[B, num_image_tokens, d_model]")
        return None
    return extra.to(dtype)


def _gathered_layer(p: dict, i: int, cfg: ModelConfig, h: torch.Tensor,
                    positions: torch.Tensor, mask, kind: str,
                    kv: Optional[torch.Tensor], seq=None):
    """Layer ``i`` on its leaves all-gathered over the data column first
    when a training placement splits them (``layers.gathered``; a no-op
    otherwise), so under remat the gather is redone in the
    recomputation and freed after each use."""
    return layer_apply(L.gathered(p, ("layers", i)), cfg, h, positions,
                       mask, kind=kind, kv_src=kv, seq=seq)


def apply_lm_hidden(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                    extra: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, LMAux]:
    """Backbone forward up to the final norm (no unembed): h [B,S,D]
    and the MoE aux, each loss SUMMED over the layers (zero without
    experts). ``extra`` [B,T,D] is the vlm's image embeddings. With
    ``cfg.remat`` and gradients enabled, each layer (cross layers
    included) is checkpointed (its activations recomputed in the
    backward), the counterpart of the reference's ``scan_layers``
    remat; it changes no value. Under a training placement
    (``layers.training``) each layer's fsdp leaves are gathered inside
    its checkpoint. Under sequence parallelism (``layers.seq_mesh``)
    the residual between layers is the rank's block of the sequence
    and h is gathered whole at the end, for the head."""
    seq = L.seq_mesh(tokens.shape[1])
    h = L.embed(L.gathered(params["embed"], ("embed",)), cfg, tokens, seq)
    positions = _positions(tokens)
    masks = _masks(cfg)
    src = _kv_src(cfg, extra, h.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = zero_aux(h.device)
    for i, (p, kind) in enumerate(zip(params["layers"], layer_kinds(cfg))):
        kv = src if kind == "cross" else None
        if remat:
            h, a = checkpoint(_gathered_layer, p, i, cfg, h, positions,
                              masks[kind], kind, kv, seq,
                              use_reentrant=False)
        else:
            h, a = _gathered_layer(p, i, cfg, h, positions, masks[kind],
                                   kind, kv, seq)
        if a is not None:
            aux = LMAux(aux.load_balance_loss + a.load_balance_loss,
                        aux.router_z_loss + a.router_z_loss)
    final = L.gathered(params["final_norm"], ("final_norm",))
    return L.seq_whole(L.norm(cfg, final, h, seq), seq), aux


def apply_lm(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
             extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward. tokens: [B,S] -> logits [B,S,V]. Under
    sequence parallelism the layers run on the rank's block of the
    sequence and the head on the gathered whole."""
    seq = L.seq_mesh(tokens.shape[1])
    h = L.embed(params["embed"], cfg, tokens, seq)
    positions = _positions(tokens)
    masks = _masks(cfg)
    src = _kv_src(cfg, extra, h.dtype)
    for p, kind in zip(params["layers"], layer_kinds(cfg)):
        h, _ = layer_apply(p, cfg, h, positions, masks[kind], kind=kind,
                           kv_src=src if kind == "cross" else None,
                           seq=seq)
    h = L.seq_whole(L.norm(cfg, params["final_norm"], h, seq), seq)
    return L.unembed(params["embed"], cfg, h)


# --------------------------------------------------------------------------
# KV cache, prefill, decode
# --------------------------------------------------------------------------

def cross_kv_from_embeds(p: dict, cfg: ModelConfig,
                         embeds: torch.Tensor):
    """A cross layer's K/V [B,T,Hkv,Dh] from (image or encoder)
    embeddings [B,T,D], in the embeddings' dtype."""
    dt = embeds.dtype
    a = p["attn"]
    k = torch.einsum("btd,dhk->bthk", embeds, a["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", embeds, a["wv"].to(dt))
    if cfg.qkv_bias:
        k = k + L._head_rows(a["bk"], k.shape[2]).to(dt)
        v = v + L._head_rows(a["bv"], v.shape[2]).to(dt)
    return k, v


def init_lm_cache(cfg: ModelConfig, params: dict, batch: int,
                  max_len: int, extra: Optional[torch.Tensor] = None
                  ) -> list:
    """Zeroed pool at ``cfg.kv_dtype`` on the params' device (decode
    accumulates in f32 whatever the storage dtype), each layer's the
    rank's block (``layers.cache_block`` over the layer's model split:
    its KV heads, or block r of T or of the head dim); a vlm's cross
    layers hold the K/V of ``extra`` [batch, T_img, D], computed from it
    at ``cfg.kv_dtype`` as the reference does (their block, on the
    declared mesh)."""
    dev = _device(params)
    src = _kv_src(cfg, extra, cfg.kv_dtype)
    cache = []
    for p, kind in zip(params["layers"], layer_kinds(cfg)):
        m = L.model_split(cfg, p)
        if kind == "cross":
            ck, cv = cross_kv_from_embeds(p, cfg, src)
            cache.append({"ck": L.cache_slice(cfg, ck, m),
                          "cv": L.cache_slice(cfg, cv, m)})
            continue
        shape = (batch,) + L.cache_block(
            cfg, _cache_len(cfg, kind, max_len), m)
        cache.append({
            "k": torch.zeros(shape, dtype=cfg.kv_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.kv_dtype, device=dev)})
    return cache


def _prefill_cache_layout(cfg: ModelConfig, kind: str, k: torch.Tensor,
                          v: torch.Tensor, max_len: int,
                          lens: Optional[torch.Tensor] = None) -> dict:
    """[B,S,...] prefill K/V -> the ``init_lm_cache`` layout at
    ``max_len``: global layers zero-pad the sequence axis to max_len;
    local layers gather each ROW's last ``min(lens[b], window)`` tokens
    into their ring slots (p % T) — what streaming that row's prompt
    through decode leaves behind. ``lens`` [B] gives per-row prompt
    lengths of a right-padded batch (None = every row is the full S)."""
    b, s, hkv, hd = k.shape
    k = k.to(cfg.kv_dtype)
    v = v.to(cfg.kv_dtype)
    if kind == "local" and cfg.sliding_window:
        t = min(cfg.sliding_window, max_len)
        if lens is None:
            last = torch.full((b, 1), s - 1, device=k.device)
        else:
            last = lens.to(device=k.device, dtype=torch.int64)[:, None] - 1
        # ring slot q holds the LARGEST position p <= last with
        # p % t == q (exactly what decode's abs_pos arithmetic assumes)
        q = torch.arange(t, device=k.device)[None, :]            # [1,T]
        p = last - torch.remainder(last - q, t)                   # [B,T]
        valid = (p >= 0)[:, :, None, None]
        idx = p.clamp(0, s - 1)
        rows = torch.arange(b, device=k.device)[:, None]
        zero = torch.zeros((), dtype=k.dtype, device=k.device)
        return {"k": torch.where(valid, k[rows, idx], zero),
                "v": torch.where(valid, v[rows, idx], zero)}
    kc = torch.zeros((b, max_len, hkv, hd), dtype=k.dtype, device=k.device)
    vc = torch.zeros_like(kc)
    kc[:, :s] = k
    vc[:, :s] = v
    return {"k": kc, "v": vc}


def apply_lm_prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                     max_len: int, lens: Optional[torch.Tensor] = None,
                     logits_at: Optional[torch.Tensor] = None,
                     extra: Optional[torch.Tensor] = None):
    """Single-shot batched prefill: ONE full-sequence forward that also
    dumps a decode-ready KV cache. tokens: [B,S]. Returns (logits,
    cache) where ``cache`` matches ``init_lm_cache(..., max_len)`` after
    streaming the prompt through ``decode_lm`` (where the KV heads are
    whole every rank computes the whole K/V and keeps its block of T or
    of the head dim). Right-padded prompts are
    safe: pass ``lens`` [B] so local layers ring-pack each row's own
    last ``window`` tokens.

    ``logits_at`` [B] unembeds only one position per row (logits
    [B,1,V]); the serving paths sample one token per row, and at
    gemma3-12b's 262144-word vocabulary the full [B,S,V] logits of a
    long prompt batch are gigabytes. None gives all positions [B,S,V].
    A vlm's cross layers dump the K/V of ``extra`` computed in the
    compute dtype, as the reference's prefill does (the engine's pool
    stores them at its own dtype).
    """
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds cache max_len "
                         f"{max_len}")
    h = L.embed(params["embed"], cfg, tokens)
    positions = _positions(tokens)
    masks = _masks(cfg)
    src = _kv_src(cfg, extra, h.dtype)
    cache = []
    for p, kind in zip(params["layers"], layer_kinds(cfg)):
        cross = kind == "cross"
        h, (k, v) = layer_apply(p, cfg, h, positions, masks[kind],
                                return_kv=True, kind=kind,
                                kv_src=src if cross else None)
        c = {"ck": k, "cv": v} if cross else \
            _prefill_cache_layout(cfg, kind, k, v, max_len, lens)
        m = L.model_split(cfg, p)
        cache.append({n: L.cache_slice(cfg, x, m) for n, x in c.items()})
    if logits_at is not None:
        rows = torch.arange(b, device=h.device)
        h = h[rows, logits_at.to(device=h.device,
                                 dtype=torch.int64)][:, None]
    h = L.norm(cfg, params["final_norm"], h)
    return L.unembed(params["embed"], cfg, h), cache


def _blocks(params: dict):
    """(label, attention dicts, MLP dict) of every attention + MLP block
    of an LM, encoder-decoder or hybrid tree (an ssm tree has none)."""
    for i, p in enumerate(params.get("layers", ())):
        yield f"layer {i}", [p["attn"]], p.get("mlp")
    for top in ("encoder", "decoder"):
        for i, p in enumerate(params.get(top, ())):
            attn = [p[k] for k in ("attn", "self_attn", "cross_attn")
                    if k in p]
            yield f"{top} layer {i}", attn, p["mlp"]
    if "shared_attn" in params:
        p = params["shared_attn"]
        yield "shared block", [p["attn"]], p["mlp"]


def check_model_axis(cfg: ModelConfig, params: dict, mesh) -> None:
    """Refuse, before any step, a leaf left whole on ``mesh`` while a
    partner is split, with this rank's ``params`` (its blocks of the
    leaves, or meta tensors of their shapes): ``wq`` / ``wo`` split
    alike, ``wk`` / ``wv`` alike (a whole ``wk`` / ``wv`` beside a split
    ``wq`` / ``wo`` is served: the KV cache follows ``cache_pspecs``
    over T or the head dim, ``layers.cache_block``), the MLP's ``wi`` /
    ``wg`` / ``wo`` alike, and an MoE layer's router and experts split
    over the experts alike."""
    if mesh is None or mesh.shape["model"] == 1:
        return
    for label, attns, f in _blocks(params):
        for a in attns:
            split = {"wq": a["wq"].shape[1] != cfg.num_heads,
                     "wk": a["wk"].shape[1] != cfg.num_kv_heads,
                     "wv": a["wv"].shape[1] != cfg.num_kv_heads,
                     "wo": a["wo"].shape[0] != cfg.num_heads}
            if split["wq"] != split["wo"] or split["wk"] != split["wv"] \
                    or (split["wk"] and not split["wq"]):
                on = sorted(k for k, v in split.items() if v)
                off = sorted(k for k, v in split.items() if not v)
                raise ValueError(f"{label} attention: {on} split but {off} "
                                 f"whole; a row-parallel product needs its "
                                 f"partners split alike (a whole wk / wv "
                                 f"beside a split wq / wo is served)")
        if f is None:
            continue
        split = {name: f[name].shape[dim] != cfg.d_ff
                 for name, dim in (("wi", 1), ("wg", 1), ("wo", 0))
                 if name in f}
        if len(set(split.values())) > 1:
            on = sorted(k for k, v in split.items() if v)
            off = sorted(k for k, v in split.items() if not v)
            raise ValueError(f"{label} mlp: {on} split but {off} whole; a "
                             f"row-parallel product needs its partners "
                             f"split alike")
    for i, p in enumerate(params.get("layers", ())):
        if "moe" not in p:
            continue
        e = cfg.num_experts
        split = {name: p["moe"][name].shape[dim] != e
                 for name, dim in (("router", 1), ("wi", 0), ("wg", 0),
                                   ("wo", 0))}
        if len(set(split.values())) > 1:
            on = sorted(k for k, v in split.items() if v)
            off = sorted(k for k, v in split.items() if not v)
            raise ValueError(f"layer {i} moe: {on} split but {off} whole; "
                             f"the router's logits and the experts need "
                             f"the same block of the experts")


def layer_decode(p: dict, cfg: ModelConfig, h: torch.Tensor, c: dict,
                 pos, *, window: Optional[int] = None,
                 kind: str = "attn") -> torch.Tensor:
    """One-token layer step on the layer's cache ``c``: a self-attention
    layer appends to ``c["k"]`` / ``c["v"]`` in place (the decode
    kernel on CUDA); a cross layer attends to ``c["ck"]`` / ``c["cv"]``
    in plain PyTorch through its gate and leaves them alone. An MoE
    layer routes the step's one token per row (capacity >= 1) and drops
    its aux."""
    x = L.norm(cfg, p["norm1"], h)
    m = L.model_split(cfg, p)
    if kind == "cross":
        a = _gated(p, L.cross_attention_decode(p["attn"], x, c["ck"],
                                               c["cv"], cfg, m))
    else:
        a = L.attention_decode(p["attn"], cfg, x, c["k"], c["v"], pos,
                               window=window, split=m)
    h = h + a
    return h + _ffn(p, cfg, L.norm(cfg, p["norm2"], h))[0]


def decode_lm(cfg: ModelConfig, params: dict, cache: list,
              tokens: torch.Tensor, pos) -> tuple[torch.Tensor, list]:
    """One-token step. tokens: [B,1]; pos: an int (tokens cached so far)
    or a [B] int32 tensor of per-row depths. The cache is updated in
    place and returned. Returns (logits [B,1,V], cache)."""
    h = L.embed(params["embed"], cfg, tokens)
    for p, c, kind in zip(params["layers"], cache, layer_kinds(cfg)):
        h = layer_decode(p, cfg, h, c, pos, window=_window(cfg, kind),
                         kind=kind)
    h = L.norm(cfg, params["final_norm"], h)
    return L.unembed(params["embed"], cfg, h), cache
