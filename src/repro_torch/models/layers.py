"""Transformer building blocks on plain dicts of tensors.

The port of ``repro.models.layers``. Parameter layouts are the
reference's (``wq [D,H,Dh]``, ``wo [H,Dh,D]``, ``wi [D,F]``, ...), so
carrying weights across is a copy. Activations flow in ``cfg.cdtype``;
norms, softmax and RoPE compute in f32 and round where the reference
rounds. Attention is grouped-query.

The model axis (tensor parallelism, Megatron-style): a rank may hold a
block of a leaf, as ``launch.sharding`` splits it. Head counts and
widths come from the local weights' shapes, and whether a leaf is split
is read from its own shape against the config's full size, never from
the mesh: ``wq`` / ``wk`` / ``wv`` / ``wo`` over the heads, ``wi`` /
``wg`` / MLP ``wo`` over d_ff, ``table`` and ``head`` over the
vocabulary, the MoE router and experts over the experts
(``models.moe``). A row-parallel product (``wo`` over split heads or d_ff) is
a partial that ``distributed.sum_over_row`` sums over the model row; a
replicated leaf is computed whole and never summed. The QKV biases are
replicated (no rule splits them): each rank adds its heads' rows. A
split table embeds through :func:`_vocab_parallel_embed`, and split
logits are gathered over the row. The mesh is the one a serving entry
point declared with :func:`set_batch_sharding` (or
:func:`batch_sharding`); unset, none of this runs and the code path is
the single-rank one.

The row's collectives are autograd functions
(``distributed.copy_to_row`` / ``sum_over_row`` / ``gather_row``), so
serving and training over the mesh (:func:`training`) run the same
forward: every column-parallel input passes through ``copy_to_row``,
and so does every replicated leaf a rank uses only in part (the QKV
biases' rows of its heads; a whole ``wk`` / ``wv`` and their biases
when the rank reads only its heads' KV groups), so each rank's partial
gradient of those is summed over the row. A split table's embedding
has a local backward. Under fsdp a leaf may also be split over the data
axis: :func:`gathered` all-gathers a subtree's such leaves over the
data column (``distributed.fsdp_gather``) right before they are used,
so the layers only ever see tensor-parallel blocks.

The KV cache follows ``launch.sharding.cache_pspecs`` on the cache's
own shape over the layer's model split (:func:`model_split`,
:func:`cache_axis`): the model axis goes to the KV heads where it
divides them (``wk`` / ``wv`` are split alike), else to T, else to the
head dim. Where the KV heads stay whole, prefill computes the whole
K/V and keeps its block. Over T, decode runs the kernel in its partial
mode over the rank's block on every head (q gathered over the row
where the heads are split, whole where they are not), gathers every
rank's (out, lse) and merges its own heads
(``attention_decode.merge_partials``). Over the head dim, each rank's
scores are partial sums: decode runs the kernel's scores mode on the
block of the rope'd q and K, sums the f32 scores over the row, runs
the apply mode over the block of V and gathers the outputs along the
head dim. Cross layers do the same in plain PyTorch.

Sequence parallelism (``set_batch_sharding(..., seq_axis="model")``,
:func:`seq_mesh`): a full-sequence pass whose length the model axis
divides keeps the residual stream as this rank's block of the sequence
between blocks; each block's column-parallel entry gathers the sequence
(``distributed.gather_seq``) and its row-parallel exit reduce-scatters
(``distributed.scatter_seq``), so the block's inside is unchanged. A
layer whose leaves are whole computes its rows only (q against the
gathered K/V), and the head gathers the sequence back. Decode never
splits.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.attention_decode import merge_partials

NEG_INF = -2.0e38  # f32-safe mask value

# query-chunk size of the prefill path: bounds the live scores buffer to
# [B, H, Q_CHUNK, T] instead of [B, H, S, T]
Q_CHUNK = 512


# --------------------------------------------------------------------------
# the model axis
# --------------------------------------------------------------------------

_MESH = None                          # the declared mesh (None: unset)
_SEQ_AXIS = None                      # "model": sequence parallelism


def set_batch_sharding(batch_axes: Optional[tuple],
                       seq_axis: Optional[str] = None,
                       model_size: int = 1, mesh=None) -> None:
    """Declare the mesh whose model rows sum the row-parallel partials,
    embed a split table and gather split logits (the reference's
    signature). ``batch_axes`` says the batch is split over the data
    axis (the train step shards it, ``data.pipeline.shard_batch``;
    serving splits slots with ``Mesh.data_block``); the model code reads
    the model rows only. ``seq_axis="model"`` declares sequence
    parallelism (:func:`seq_mesh`); it stays declared inside
    :func:`batch_sharding` and :func:`training`.
    ``set_batch_sharding(None)`` clears both."""
    global _MESH, _SEQ_AXIS
    if seq_axis not in (None, "model"):
        raise ValueError(f"seq_axis={seq_axis!r}: the sequence splits over "
                         f"the model axis only")
    if mesh is not None and int(mesh.shape["model"]) != model_size:
        raise ValueError(f"model_size {model_size} but the mesh's model "
                         f"axis is {mesh.shape['model']}")
    keep = batch_axes is not None or seq_axis is not None
    _MESH = mesh if keep and model_size > 1 else None
    _SEQ_AXIS = seq_axis if _MESH is not None else None


@contextlib.contextmanager
def batch_sharding(mesh):
    """:func:`set_batch_sharding` for ``mesh`` inside the block (nothing
    for ``None`` or a mesh without a model axis), the previous state
    after; a declared sequence axis stays declared."""
    global _MESH
    saved = _MESH
    if mesh is not None:
        _MESH = mesh if mesh.shape["model"] > 1 else None
    try:
        yield
    finally:
        _MESH = saved


def seq_mesh(s: int):
    """The mesh whose model row splits a full-sequence pass of ``s``
    positions (sequence parallelism), or None: a sequence axis is
    declared (``set_batch_sharding(..., seq_axis="model")``), the
    declared mesh has a model axis of M > 1, ``s`` > 1 and M divides
    ``s`` (the reference's condition, ``launch/dryrun.py``). The
    reference pads a sequence M does not divide (whisper's 1500 encoder
    frames at M = 16); that stack runs here without the split, which
    computes the same function.

    Under sequence parallelism the residual stream between blocks is
    this rank's block ``[B, S/M, D]`` of the sequence: norms and
    residual adds run on those rows, and the tensor a layer saves for
    its backward (the remat boundary) is 1/M of the unsplit one. At a
    block's column-parallel entry the sequence is gathered
    (``distributed.gather_seq``, where the unsplit pass has
    ``copy_to_row``), and its row-parallel exit is reduce-scattered
    (``distributed.scatter_seq``, where it has ``sum_over_row``); inside
    the block nothing changes. A block whose leaves are whole (no model
    split) has no partial: its attention computes q for the rank's rows
    against the gathered K/V, at their global positions (the
    reference's ``shard_seq_q``), its MLP runs on the rank's rows; a
    whole MoE or Mamba2 block, which route and scan over the whole
    sequence, runs replicated on the gathered sequence and keeps the
    rank's rows. Every leaf a rank then uses on its rows only (norm
    scales, a cross layer's gate, a whole block's weights and table)
    passes through ``copy_to_row``, so its gradient is summed over the
    row. The head gathers the sequence before ``unembed`` and the loss.
    Decode (``s == 1``) never splits."""
    mesh = _MESH
    if _SEQ_AXIS is None or mesh is None or s <= 1:
        return None
    m = int(mesh.shape["model"])
    return mesh if m > 1 and s % m == 0 else None


def seq_rows(x: torch.Tensor, seq, dim: int = 1) -> torch.Tensor:
    """This rank's block of the sequence dim of ``x``, a tensor whole on
    every rank that needs no gradient (tokens, frames); ``x`` when
    ``seq`` is None."""
    if seq is None:
        return x
    n = x.shape[dim] // seq.shape["model"]
    return x.narrow(dim, seq.coords["model"] * n, n)


def seq_whole(x: torch.Tensor, seq) -> torch.Tensor:
    """The whole sequence of a residual ``x`` [B, S/M, ...] for
    consumers that run replicated over the row (the head, the
    encoder's output as a cross source, a whole MoE or Mamba2 block):
    gathered (``gather_row``, counted as ``model_gather``), the backward
    keeping the rank's block."""
    if seq is None:
        return x
    from repro_torch.distributed import gather_row
    return gather_row(x, seq, 1)


def seq_replicated(fn, x: torch.Tensor, seq):
    """``fn`` of the whole sequence, replicated over the row, and this
    rank's rows of its output (the first of a tuple): a block whose
    leaves are whole and which reads the whole sequence at once (MoE
    capacity, the Mamba2 scan). ``fn(x)`` when ``seq`` is None."""
    if seq is None:
        return fn(x)
    from repro_torch.distributed import row_block
    out = fn(seq_whole(x, seq))
    if isinstance(out, tuple):
        return (row_block(out[0], seq, 1),) + out[1:]
    return row_block(out, seq, 1)


def seq_params(tree, seq):
    """``tree`` with every tensor leaf through ``copy_to_row`` when
    ``seq`` is set: leaves a rank uses on its rows of the sequence only,
    whose gradients are partials summed over the row."""
    if seq is None:
        return tree
    from repro_torch.distributed import copy_to_row
    if isinstance(tree, dict):
        return {k: seq_params(v, seq) for k, v in tree.items()}
    return copy_to_row(tree, seq)


_FSDP = None                          # the declared training Placement
_COLUMN = None                        # the training step's data column


def declared_mesh():
    """The mesh declared by :func:`set_batch_sharding` (None: unset)."""
    return _MESH


def data_column():
    """The mesh whose data column splits the batch of the training step
    declared by :func:`training` (None: unset, or a data axis of 1):
    a statistic of the global batch is the column mean of each data
    row's statistic of its block."""
    return _COLUMN


@contextlib.contextmanager
def training(mesh, place=None):
    """Inside the block a step trains over ``mesh``: its model rows as
    :func:`batch_sharding` declares them, its data column as
    :func:`data_column` names it, and ``place`` (a
    ``launch.sharding.Placement`` with fsdp) names the leaves split over
    the data axis, which :func:`gathered` all-gathers. A declared
    sequence axis stays declared. The previous state after."""
    global _MESH, _FSDP, _COLUMN
    saved = _MESH, _FSDP, _COLUMN
    _MESH = mesh if mesh.shape["model"] > 1 else None
    _FSDP = place if place is not None and mesh.shape["data"] > 1 \
        else None
    _COLUMN = mesh if mesh.shape["data"] > 1 else None
    try:
        yield
    finally:
        _MESH, _FSDP, _COLUMN = saved


def gathered(tree, prefix: tuple):
    """The subtree ``tree`` at path ``prefix`` of the params with every
    leaf the declared training placement splits over the data axis
    all-gathered over the data column (``fsdp_gather``: one gather in
    the forward, a column sum of the gradient in the backward); the
    tree itself outside :func:`training` or without fsdp. Called inside
    a layer's remat, the gather is redone in the recomputation and the
    gathered leaves are freed after each use."""
    place = _FSDP
    if place is None:
        return tree
    from repro_torch.distributed import fsdp_gather

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        dim = place.data_dim(path)
        return node if dim is None else fsdp_gather(node, place.mesh, dim)

    return walk(tree, tuple(prefix))


def _row_mesh(local: int, full: int, what: str):
    """The declared mesh, for a leaf dim of ``local`` rows that is a
    block of ``full``; raises unless it is this mesh's model block."""
    mesh = _MESH
    if mesh is None or local * mesh.shape["model"] != full:
        raise ValueError(
            f"{what} holds {local} of {full} rows: not a block of the "
            f"declared mesh's model axis ({None if mesh is None else mesh})"
            f"; serve a split model through a mesh (set_batch_sharding)")
    return mesh


def _row_sum(y: torch.Tensor, local: int, full: int, what: str
             ) -> torch.Tensor:
    """``y`` when the contracted dim was whole; else its sum over the
    model row (a row-parallel partial, ``sum_over_row``)."""
    if local == full:
        return y
    from repro_torch.distributed import sum_over_row
    return sum_over_row(y, _row_mesh(local, full, what))


def _row_exit(y: torch.Tensor, local: int, full: int, what: str,
              seq=None) -> torch.Tensor:
    """A row-parallel output: :func:`_row_sum`, or under sequence
    parallelism (``seq``) the sum's block of the sequence
    (``scatter_seq``)."""
    if seq is None or local == full:
        return _row_sum(y, local, full, what)
    from repro_torch.distributed import scatter_seq
    return scatter_seq(y, _row_mesh(local, full, what))


def _col_in(x: torch.Tensor, local: int, full: int, what: str,
            seq=None) -> torch.Tensor:
    """A column-parallel input (the leaf holds ``local`` of ``full``
    output rows): ``copy_to_row``, whose backward sums this rank's
    partial gradient of ``x`` over the row, or under sequence
    parallelism (``seq``: ``x`` is the rank's block of the sequence)
    ``gather_seq``, whose backward reduce-scatters it; ``x`` when the
    leaf is whole."""
    if local == full:
        return x
    from repro_torch.distributed import copy_to_row, gather_seq
    mesh = _row_mesh(local, full, what)
    return copy_to_row(x, mesh) if seq is None else gather_seq(x, mesh)


def _partial_use(w: torch.Tensor, local: int, full: int, what: str
                 ) -> torch.Tensor:
    """A replicated leaf this rank uses only in part (its heads'
    rows, its heads' KV groups): ``copy_to_row``, so its partial
    gradient is summed over the row."""
    return _col_in(w, local, full, what)


CACHE_AXES = ("heads", "t", "dh")     # cache_pspecs' order


def cache_axis(cfg: ModelConfig, t: int, m: int) -> Optional[str]:
    """The axis ``launch.sharding.cache_pspecs`` gives the model axis of
    ``m`` ranks on a [B, T, Hkv, Dh] KV cache leaf of ``t`` keys: the KV
    heads when ``m`` divides them, else T, else the head dim, else None
    (the leaf stays whole)."""
    if m > 1:
        for axis, n in zip(CACHE_AXES, (cfg.num_kv_heads, t, cfg.head_dim_)):
            if n % m == 0 and n >= m:
                return axis
    return None


def model_split(cfg: ModelConfig, layer: dict) -> int:
    """The model axis's size a layer's blocks show (1: every leaf
    whole): the split of its query heads, else of its MLP's d_ff, else
    of its experts. A layer whose leaves are all whole (replicated
    params) keeps a whole cache and runs no collective; a split layer's
    caches follow ``cache_pspecs`` over this many ranks, its heads whole
    or not."""
    for key in ("attn", "self_attn"):
        if key in layer and layer[key]["wq"].shape[1] != cfg.num_heads:
            return cfg.num_heads // layer[key]["wq"].shape[1]
    if "mlp" in layer and layer["mlp"]["wi"].shape[1] != cfg.d_ff:
        return cfg.d_ff // layer["mlp"]["wi"].shape[1]
    if "moe" in layer and layer["moe"]["router"].shape[1] != cfg.num_experts:
        return cfg.num_experts // layer["moe"]["router"].shape[1]
    return 1


def cache_block(cfg: ModelConfig, t: int, m: int) -> tuple[int, int, int]:
    """(keys, KV heads, head dims) of a rank's block of a KV cache of
    ``t`` keys over ``m`` model ranks (:func:`cache_axis`). A cache the
    rule leaves whole beside a model axis (``m`` divides none of its
    dims: only at a head dim below ``m`` or not a multiple of it) is
    refused: decode could not tell it from a block of T."""
    axis = cache_axis(cfg, t, m)
    if axis is None and m > 1:
        raise ValueError(
            f"a KV cache of {t} keys, {cfg.num_kv_heads} KV heads and head "
            f"dim {cfg.head_dim_}: {m} model ranks divide none of them, so "
            f"cache_pspecs keeps it whole, which decode cannot tell from a "
            f"block of T")
    return (t // m if axis == "t" else t,
            cfg.num_kv_heads // m if axis == "heads" else cfg.num_kv_heads,
            cfg.head_dim_ // m if axis == "dh" else cfg.head_dim_)


def _split_mesh(m: int, what: str):
    """The declared mesh, whose model axis must have ``m`` ranks."""
    mesh = _MESH
    if mesh is None or int(mesh.shape["model"]) != m:
        raise ValueError(f"{what} over {m} model ranks needs a declared "
                         f"mesh with that model axis (set_batch_sharding); "
                         f"declared: {mesh}")
    return mesh


def cache_slice(cfg: ModelConfig, x: torch.Tensor, m: int) -> torch.Tensor:
    """This rank's block (a copy) of a [B, T, Hkv, Dh] K or V that the
    layer computed (every KV head, or the rank's own where ``wk`` is
    split), as :func:`cache_block` cuts a cache of T = ``x.shape[1]``
    over ``m`` ranks; ``x`` itself when it already is the block."""
    cache_block(cfg, x.shape[1], m)
    axis = cache_axis(cfg, x.shape[1], m)
    if axis is None or (axis == "heads"
                        and x.shape[2] != cfg.num_kv_heads):
        return x
    dim = {"heads": 2, "t": 1, "dh": 3}[axis]
    n = x.shape[dim] // m
    r = _split_mesh(m, f"a KV cache over {axis}").coords["model"]
    return x.narrow(dim, r * n, n).contiguous()


def _cache_split(cfg: ModelConfig, cache: torch.Tensor, m: int
                 ) -> Optional[str]:
    """The axis a rank's cache block was cut along, read from its shape
    (the head dim, the KV heads), else T at ``m`` > 1
    (:func:`cache_block` refuses a whole cache there), else None."""
    if cache.shape[3] != cfg.head_dim_:
        return "dh"
    if cache.shape[2] != cfg.num_kv_heads:
        return "heads"
    return "t" if m > 1 else None


def _head_rows(b: torch.Tensor, heads: int, partial: bool = False
               ) -> torch.Tensor:
    """A replicated [H, Dh] bias's rows of this rank's ``heads`` (its
    gradient summed over the row, ``copy_to_row``; ``partial``: every
    row is kept but the rank reads only some, the KV groups of its
    query heads)."""
    if b.shape[0] == heads and not partial:
        return b
    mesh = _row_mesh(heads, b.shape[0], "a QKV bias's heads") \
        if b.shape[0] != heads else _MESH
    from repro_torch.distributed import copy_to_row
    b = copy_to_row(b, mesh)
    if b.shape[0] == heads:
        return b
    i = mesh.coords["model"]
    return b[i * heads:(i + 1) * heads]


# --------------------------------------------------------------------------
# initialisers
# --------------------------------------------------------------------------

_ON_DRAW = None                       # see on_draw


def normal_init(gen: torch.Generator, shape, dtype, device,
                scale: float = 0.02) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=device,
                    dtype=torch.float32)
    x = (x * scale).to(dtype)
    return x if _ON_DRAW is None else _ON_DRAW(x)


@contextlib.contextmanager
def on_draw(hook):
    """Inside the block every :func:`normal_init` draw is passed through
    ``hook`` and the init keeps what it returns (``Model.init(mesh=)``
    keeps a rank's block of each leaf as it is drawn)."""
    global _ON_DRAW
    saved, _ON_DRAW = _ON_DRAW, hook
    try:
        yield
    finally:
        _ON_DRAW = saved


def init_rmsnorm(d: int, dtype, device) -> dict:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def init_attention(cfg: ModelConfig, gen, device) -> dict:
    d = cfg.d_model
    hd, h, hkv = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
    dt = cfg.pdtype
    p = {
        "wq": normal_init(gen, (d, h, hd), dt, device),
        "wk": normal_init(gen, (d, hkv, hd), dt, device),
        "wv": normal_init(gen, (d, hkv, hd), dt, device),
        "wo": normal_init(gen, (h, hd, d), dt, device,
                          scale=0.02 / math.sqrt(2 * cfg.num_layers)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((hkv, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((hkv, hd), dtype=dt, device=device)
    return p


def init_mlp(cfg: ModelConfig, gen, device) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.pdtype
    out_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    p = {"wi": normal_init(gen, (d, f), dt, device)}
    if cfg.act == "silu":
        p["wg"] = normal_init(gen, (d, f), dt, device)
    p["wo"] = normal_init(gen, (f, d), dt, device, out_scale)
    return p


def init_embedding(cfg: ModelConfig, gen, device) -> dict:
    p = {"table": normal_init(gen, (cfg.vocab_size, cfg.d_model),
                              cfg.pdtype, device)}
    if not cfg.tie_embeddings:
        p["head"] = normal_init(gen, (cfg.d_model, cfg.vocab_size),
                                cfg.pdtype, device)
    return p


# --------------------------------------------------------------------------
# norms / rotary embeddings
# --------------------------------------------------------------------------

def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """x / rms(x) * (1 + scale): f32-accumulated sum of squares, the
    normalised activations in x's dtype (the reference's rounding)."""
    ss = x.float().square().sum(dim=-1, keepdim=True)
    inv = torch.rsqrt(ss / x.shape[-1] + eps)
    y = x * inv.to(x.dtype)
    return y * (1.0 + params["scale"]).to(x.dtype)


def init_layernorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-6
              ) -> torch.Tensor:
    """(x - mean) / std * scale + bias with the reference's rounding:
    the mean and E[x²] accumulated in f32, the one-pass variance
    max(E[x²] - mean², 0), the mean and rsqrt(var + eps) cast to x's
    dtype BEFORE (x - mean) * inv, then the affine in x's dtype.
    ``F.layer_norm`` (a two-pass variance, one rounding at the end)
    differs from it in bf16."""
    d = x.shape[-1]
    x32 = x.float()
    mu = x32.sum(dim=-1, keepdim=True) / d
    ss = x32.square().sum(dim=-1, keepdim=True) / d
    var = torch.clamp_min(ss - mu.square(), 0.0)
    inv = torch.rsqrt(var + eps)
    y = (x - mu.to(x.dtype)) * inv.to(x.dtype)
    return y * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)


def init_norm(cfg: ModelConfig, d: int, device) -> dict:
    """The config's norm: LayerNorm's ``{"scale", "bias"}`` (whisper)
    or RMSNorm's ``{"scale"}``."""
    if cfg.norm == "layernorm":
        return init_layernorm(d, cfg.pdtype, device)
    return init_rmsnorm(d, cfg.pdtype, device)


def norm(cfg: ModelConfig, params: dict, x: torch.Tensor, seq=None
         ) -> torch.Tensor:
    """The reference's dispatch: LayerNorm when the params carry a
    ``bias``, else RMSNorm. ``seq``: ``x`` is the rank's block of the
    sequence, so the params' gradients are summed over the row
    (:func:`seq_params`)."""
    params = seq_params(params, seq)
    if "bias" in params:
        return layernorm(params, x, cfg.norm_eps)
    return rmsnorm(params, x, cfg.norm_eps)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: [B, S, H, Dh]; positions: [B, S] (int). f32 math, x-dtype out.
    Frequencies as ``exp(-log(theta) * i / half)``, as the reference
    computes them (``theta ** (-2i/d)`` rounds differently)."""
    half = x.shape[-1] // 2
    freq = torch.exp(-math.log(theta)
                     * torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freq             # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _qkv(params: dict, x: torch.Tensor, cfg: ModelConfig,
         kv_src: Optional[torch.Tensor] = None, seq=None):
    """Q from x, K and V from ``kv_src`` (x itself for self-attention),
    the weights cast to x's dtype. Over split heads, x
    (and ``kv_src``) pass through ``copy_to_row`` (x through
    ``gather_seq`` under sequence parallelism); so do a whole ``wk``
    / ``wv`` and their biases beside a split ``wq`` (the rank reads its
    heads' KV groups only)."""
    dt = x.dtype
    local, full = params["wq"].shape[1], cfg.num_heads
    x = _col_in(x, local, full, "attention wq", seq)
    kv_in = x if kv_src is None else _col_in(kv_src, local, full,
                                             "attention wq")
    wk, wv = params["wk"], params["wv"]
    partial = local != full and wk.shape[1] == cfg.num_kv_heads
    if partial:
        wk = _partial_use(wk, local, full, "attention wk")
        wv = _partial_use(wv, local, full, "attention wv")
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("btd,dhk->bthk", kv_in, wk.to(dt))
    v = torch.einsum("btd,dhk->bthk", kv_in, wv.to(dt))
    if cfg.qkv_bias:
        q = q + _head_rows(params["bq"], q.shape[2]).to(dt)
        k = k + _head_rows(params["bk"], k.shape[2], partial).to(dt)
        v = v + _head_rows(params["bv"], v.shape[2], partial).to(dt)
    return q, k, v


def _query_kv(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor):
    """K and V for this rank's query heads: where the heads are split
    and the KV heads whole (a block of the heads, every KV head), each
    local head's KV head, picked per head; else ``k`` / ``v``."""
    local = q.shape[2]
    if local == cfg.num_heads or k.shape[2] != cfg.num_kv_heads:
        return k, v
    r = _row_mesh(local, cfg.num_heads, "query heads").coords["model"]
    grp = cfg.num_heads // cfg.num_kv_heads
    idx = torch.div(r * local + torch.arange(local, device=k.device), grp,
                    rounding_mode="floor")
    return k.index_select(2, idx), v.index_select(2, idx)


def _merge_row(q: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
               mesh) -> torch.Tensor:
    """This rank's heads (every head where the heads are whole) of the
    attention whose blocks of T the model row's ranks computed for every
    head: ``out`` [B,1,H,Dh] and ``lse`` [B,H] gathered over the row
    (one gather) and merged in rank order, in f32; returns
    [B,1,H_local,Dh] in q's dtype."""
    b, _, h, dh = out.shape
    packed = torch.cat([out.float().reshape(b, h, dh), lse[..., None]],
                       dim=-1)[None]
    rows = mesh.model_gather(packed, 0, "partial_gather")  # [M,B,H,Dh+1]
    mine = _own_heads(rows, q.shape[2], h, mesh, 2)
    merged = merge_partials([x[:, None, :, :dh] for x in mine],
                            [x[..., dh] for x in mine])
    return merged.to(q.dtype)


def _own_heads(x: torch.Tensor, local: int, h: int, mesh, dim: int
               ) -> torch.Tensor:
    """This rank's ``local`` of the ``h`` heads along ``dim`` of ``x``
    (every head when they are whole)."""
    if local == h:
        return x
    return x.narrow(dim, mesh.coords["model"] * local, local)


def _all_heads(q: torch.Tensor, cfg: ModelConfig, mesh) -> torch.Tensor:
    """Every head's q: ``q`` where the heads are whole, else gathered
    over the row (``q_gather``)."""
    if q.shape[2] == cfg.num_heads:
        return q
    return mesh.model_gather(q, 2, "q_gather")


def _dh_gathered(cfg: ModelConfig, q: torch.Tensor, out: torch.Tensor,
                 mesh) -> torch.Tensor:
    """[B,1,H,Dl] outputs over the rank's block of the head dim ->
    this rank's heads [B,1,H_local,Dh]: one gather over the row along
    the head dim (``dh_gather``)."""
    whole = mesh.model_gather(out, 3, "dh_gather")
    return _own_heads(whole, q.shape[2], cfg.num_heads, mesh, 2)


def _block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """One query against every key of a block, no mask: (out [B,1,H,Dh]
    in q's dtype, lse [B,H] f32), f32 scores, as ``gqa_scores_apply``'s
    one-query path computes them."""
    b, _, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, 1, hkv, h // hkv, dh).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(dh)
    lse = torch.logsumexp(s, dim=-1)                       # [B,Hkv,G,1]
    probs = torch.exp(s - lse[..., None])
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, 1, h, dh).to(q.dtype), lse.reshape(b, h)


def _out_proj(params: dict, cfg: ModelConfig, out: torch.Tensor,
              dt, seq=None) -> torch.Tensor:
    """Attention's output projection over this rank's heads, summed
    over the model row when the heads are split (reduce-scattered over
    the sequence under ``seq``)."""
    wo = params["wo"]
    y = torch.einsum("bshk,hkd->bsd", out, wo.to(dt))
    return _row_exit(y, wo.shape[0], cfg.num_heads, "attention wo", seq)


def gqa_scores_apply(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask, q0: int = 0) -> torch.Tensor:
    """q: [B,S,H,Dh], k/v: [B,T,Hkv,Dh]. ``mask`` is None, an additive
    tensor broadcastable to [B,1,S,T], or the lazy ``("causal",
    window)`` predicate of the prefill path. ``q0`` is the position of
    q's first row among the keys (a rank's block of the sequence).
    Returns [B,S,H,Dh]."""
    b, s, h, dh = q.shape
    hkv = k.shape[2]

    if s == 1 and not isinstance(mask, tuple):
        # one query: grouped contraction, f32 scores/softmax/probs·V (a
        # lazy mask, one row of a split sequence, takes the general path)
        grp = h // hkv
        qg = q.reshape(b, 1, hkv, grp, dh).float()
        scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) \
            / math.sqrt(dh)
        if mask is not None:
            scores = scores + mask[:, :, None]
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
        return out.reshape(b, 1, h, dh).to(q.dtype)

    if hkv != h:
        rep = h // hkv
        t = k.shape[1]
        k = k[:, :, :, None, :].expand(b, t, hkv, rep, dh) \
            .reshape(b, t, h, dh)
        v = v[:, :, :, None, :].expand(b, t, hkv, rep, dh) \
            .reshape(b, t, h, dh)

    def full(qq, mm, q_offset):
        scores = torch.einsum("bshd,bthd->bhst", qq, k).float()
        scores = scores / math.sqrt(dh)
        if isinstance(mm, tuple):
            # lazy causal/window mask: a bool predicate for this chunk's
            # rows only, never a materialised [S, T] additive tensor
            _, window = mm
            qpos = q_offset + torch.arange(qq.shape[1],
                                           device=qq.device)[:, None]
            kpos = torch.arange(k.shape[1], device=qq.device)[None, :]
            ok = kpos <= qpos
            if window is not None:
                ok = ok & (kpos > qpos - window)
            scores = torch.where(ok[None, None], scores, NEG_INF)
        elif mm is not None:
            scores = scores + mm
        probs = torch.softmax(scores, dim=-1).to(qq.dtype)
        return torch.einsum("bhst,bthd->bshd", probs, v)

    if mask is not None and not isinstance(mask, tuple) and q0 \
            and mask.shape[2] > 1:
        mask = mask[:, :, q0:q0 + s]
    if s <= Q_CHUNK or s % Q_CHUNK != 0:
        return full(q, mask, q0)

    # long sequences: loop over query chunks (exact, bounded memory)
    out = []
    for off in range(0, s, Q_CHUNK):
        mi = mask
        if mask is not None and not isinstance(mask, tuple) \
                and mask.shape[2] > 1:
            mi = mask[:, :, off:off + Q_CHUNK]
        out.append(full(q[:, off:off + Q_CHUNK], mi, q0 + off))
    return torch.cat(out, dim=1)


def attention(params: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, mask, return_kv: bool = False, *,
              kv_src: Optional[torch.Tensor] = None,
              use_rope: bool = True, seq=None):
    """Self-attention over a full sequence, or cross-attention to
    ``kv_src`` [B,T,D] (no RoPE; pass ``mask=None``). ``return_kv=True``
    also returns K and V [B,T,Hkv,Dh] (rope'd for self-attention):
    exactly what decode writes into its cache, so a prefill forward can
    dump a decode-ready cache. ``seq`` (sequence parallelism,
    :func:`seq_mesh`): ``x`` and the output are the rank's block of the
    sequence, ``positions`` [B, S] the whole sequence's, ``kv_src``
    whole."""
    if seq is not None and params["wq"].shape[1] == cfg.num_heads:
        return _attention_seq_rows(params, cfg, x, positions, mask,
                                   kv_src, use_rope, seq)
    q, k, v = _qkv(params, x, cfg, kv_src, seq)
    if use_rope and kv_src is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    kq, vq = _query_kv(cfg, q, k, v)
    out = _out_proj(params, cfg, gqa_scores_apply(q, kq, vq, mask),
                    x.dtype, seq)
    if return_kv:
        return out, (k, v)
    return out


def _attention_seq_rows(params: dict, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor, mask,
                        kv_src: Optional[torch.Tensor], use_rope: bool,
                        seq) -> torch.Tensor:
    """Attention whose heads are whole on every rank, under sequence
    parallelism: q for this rank's rows of the sequence against the
    whole sequence's K/V (the reference's ``shard_seq_q``), at the rows'
    global positions for RoPE and the causal mask. K/V read the gathered
    sequence (``gather_seq``: each rank's gradient of it is its rows'
    partial) or the whole ``kv_src`` (``copy_to_row``); every leaf is
    used on the rank's rows only, so its gradient is summed over the
    row (:func:`seq_params`)."""
    from repro_torch.distributed import copy_to_row, gather_seq
    p = seq_params(params, seq)
    dt, s = x.dtype, x.shape[1]
    q0 = seq.coords["model"] * s
    kv_in = gather_seq(x, seq) if kv_src is None else copy_to_row(kv_src,
                                                                   seq)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("btd,dhk->bthk", kv_in, p["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", kv_in, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if use_rope and kv_src is None:
        q = rope(q, positions[:, q0:q0 + s], cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = gqa_scores_apply(q, k, v, mask, q0)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))


def attention_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor, pos, *,
                     window: Optional[int] = None,
                     split: Optional[int] = None) -> torch.Tensor:
    """One-token decode. x: [B,1,D]; caches [B,T,Hkv,Dh], updated in
    place; pos: an int (every row at the same depth) or a [B] int32
    tensor of per-row depths (the engine's continuous batching).
    ``pos`` is the index to write (= tokens already cached). Windowed
    layers keep a ring of length T (write slot pos % T) and RoPE uses
    absolute positions. Projections and RoPE are here; the append,
    mask and contraction are ``ops.attention_decode`` (the Hopper
    kernel on CUDA). ``split`` is the layer's model split
    (:func:`model_split`; None: the split of these heads, which a layer
    whose heads stay whole must pass); the caches are the rank's block
    of :func:`cache_block`:

    * its KV heads: the kernel on the rank's heads;
    * block r of T: the kernel in its partial mode on every head (q
      gathered over the row where the heads are split), the row's
      partials merged for this rank's heads;
    * block r of the head dim: the scores mode on every head's block of
      the rope'd q and K, the f32 scores summed over the row
      (``score_sum``), the apply mode over the block of V, the outputs
      gathered along the head dim.

    Returns out [B,1,D]."""
    b = x.shape[0]
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        posv = pos
    else:
        posv = torch.full((b,), int(pos), dtype=torch.int32,
                          device=x.device)
    q, k, v = _qkv(params, x, cfg)
    posb = posv[:, None]
    # RoPE on the whole head dim before any block of it is taken: it
    # pairs dim i with dim i + Dh/2
    q = rope(q, posb, cfg.rope_theta)
    k = rope(k, posb, cfg.rope_theta)
    if split is None:
        split = model_split(cfg, {"attn": params})
    axis = _cache_split(cfg, k_cache, split)
    if axis == "t":
        mesh = _split_mesh(split, "a KV cache over T")
        t = k_cache.shape[1]
        full, lse = ops.attention_decode(
            _all_heads(q, cfg, mesh), k, v, k_cache, v_cache, posv,
            window=window, t0=mesh.coords["model"] * t, t_total=t * split,
            return_lse=True)
        out = _merge_row(q, full, lse, mesh)
    elif axis == "dh":
        mesh = _split_mesh(split, "a KV cache over the head dim")
        dl = k_cache.shape[3]
        blk = slice(mesh.coords["model"] * dl, (mesh.coords["model"] + 1)
                    * dl)
        s = ops.attention_decode_scores(
            _all_heads(q, cfg, mesh)[..., blk], k[..., blk], v[..., blk],
            k_cache, v_cache, posv, window=window)
        mesh.model_sum_(s, "score_sum")
        out = _dh_gathered(cfg, q, ops.attention_decode_apply(
            s, v_cache, posv, head_dim=cfg.head_dim_, dtype=q.dtype,
            window=window), mesh)
    else:
        if k.shape[2] != k_cache.shape[2]:
            # a whole wk beside a cache of the rank's KV heads
            mesh = _split_mesh(split, "a KV cache over the KV heads")
            k, v = (_own_heads(y, k_cache.shape[2], cfg.num_kv_heads, mesh,
                               2) for y in (k, v))
        out = ops.attention_decode(q, k, v, k_cache, v_cache, posv,
                                   window=window)
    return _out_proj(params, cfg, out, x.dtype)


# --------------------------------------------------------------------------
# MLP / embeddings
# --------------------------------------------------------------------------

def cross_attention_decode(params: dict, x: torch.Tensor, ck: torch.Tensor,
                           cv: torch.Tensor, cfg: ModelConfig,
                           split: Optional[int] = None) -> torch.Tensor:
    """One query token against precomputed cross K/V [B,T,Hkv,Dh]: no
    RoPE, no mask, plain PyTorch (f32 scores and softmax), as the
    reference computes it outside any kernel. The cross K/V are the
    rank's block of :func:`cache_block` (``split`` as
    :func:`attention_decode`'s): over T, every head's attention over
    the block, the row's partials merged as decode's are; over the head
    dim, every head's partial f32 scores over the block summed over the
    row (``score_sum``), the softmax, probs · the block of V, and the
    outputs gathered along the head dim. x: [B,1,D] -> [B,1,D]."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + _head_rows(params["bq"], q.shape[2]).to(x.dtype)
    if split is None:
        split = model_split(cfg, {"attn": params})
    axis = _cache_split(cfg, ck, split)
    ck, cv = ck.to(q.dtype), cv.to(q.dtype)
    if axis == "t":
        mesh = _split_mesh(split, "cross K/V over T")
        full, lse = _block_attention(_all_heads(q, cfg, mesh), ck, cv)
        out = _merge_row(q, full, lse, mesh)
    elif axis == "dh":
        mesh = _split_mesh(split, "cross K/V over the head dim")
        dl = ck.shape[3]
        r = mesh.coords["model"]
        qa = _all_heads(q, cfg, mesh)[..., r * dl:(r + 1) * dl]
        b, _, h, _ = qa.shape
        hkv = ck.shape[2]
        qg = qa.reshape(b, 1, hkv, h // hkv, dl).float()
        s = torch.einsum("bskgd,btkd->bkgst", qg, ck.float()).contiguous()
        mesh.model_sum_(s, "score_sum")
        probs = torch.softmax(s / math.sqrt(cfg.head_dim_), dim=-1)
        blk = torch.einsum("bkgst,btkd->bskgd", probs, cv.float())
        out = _dh_gathered(cfg, q, blk.reshape(b, 1, h, dl).to(q.dtype),
                           mesh)
    else:
        out = gqa_scores_apply(q, ck, cv, None)
    return _out_proj(params, cfg, out, x.dtype)


def mlp(params: dict, cfg: ModelConfig, x: torch.Tensor, seq=None
        ) -> torch.Tensor:
    """Column-parallel ``wi`` / ``wg``, row-parallel ``wo`` over this
    rank's d_ff block, summed over the model row when split. ``seq``:
    ``x`` is the rank's block of the sequence, gathered at the entry
    and reduce-scattered at the exit of a split MLP; a whole MLP runs on
    the rank's rows (:func:`seq_params`)."""
    if seq is not None and params["wi"].shape[1] == cfg.d_ff:
        params = seq_params(params, seq)
    x = _col_in(x, params["wi"].shape[1], cfg.d_ff, "mlp wi", seq)
    h = x @ params["wi"].to(x.dtype)
    if cfg.act == "silu":
        g = x @ params["wg"].to(x.dtype)
        h = F.silu(g) * h
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    wo = params["wo"]
    return _row_exit(h @ wo.to(x.dtype), wo.shape[0], cfg.d_ff, "mlp wo",
                     seq)


def _vocab_parallel_embed(table: torch.Tensor, tokens: torch.Tensor,
                          vocab: int, seq=None) -> torch.Tensor:
    """Megatron-style vocab-parallel embedding: this rank gathers the
    tokens in its row range of the table, puts -0.0 (the exact additive
    identity) everywhere else, and the model row sums. Tokens are
    replicated over the row (every rank embeds the same positions), so
    the sum holds one row and -0.0s: the M = 1 embedding bit for bit.
    Under sequence parallelism (``seq``) the sum is reduce-scattered:
    the rank keeps its block of the sequence."""
    rows = table.shape[0]
    mesh = _row_mesh(rows, vocab, "embed table")
    loc = tokens - mesh.coords["model"] * rows
    ok = (loc >= 0) & (loc < rows)
    x = table[torch.where(ok, loc, torch.zeros_like(loc))]
    x = torch.where(ok[..., None], x,
                    torch.full((), -0.0, dtype=x.dtype, device=x.device))
    # the backward is local: each rank scatters the whole gradient into
    # the rows of its tokens
    from repro_torch.distributed import scatter_seq, sum_over_row
    return sum_over_row(x, mesh) if seq is None else scatter_seq(x, mesh)


def embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor, seq=None
          ) -> torch.Tensor:
    """Token embeddings [B, S, D] in the compute dtype, scaled by
    sqrt(d_model). ``seq`` (sequence parallelism): the rank's block of
    the sequence, [B, S/M, D]: a split table's sum reduce-scattered, a
    whole table's rows of the rank's tokens (its gradient summed over
    the row)."""
    table = params["table"]
    if table.shape[0] == cfg.vocab_size:
        x = seq_params(table, seq)[seq_rows(tokens, seq)]
    else:
        x = _vocab_parallel_embed(table, tokens, cfg.vocab_size, seq)
    x = x.to(cfg.cdtype)
    return x * math.sqrt(cfg.d_model)


def unembed(params: dict, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    """Logits [..., V]; over a split vocabulary this rank's [..., V/M]
    block is gathered over the model row in rank order (``gather_row``,
    its input through ``copy_to_row``)."""
    if cfg.tie_embeddings:
        w = params["table"].to(x.dtype).T
    else:
        w = params["head"].to(x.dtype)
    x = _col_in(x, w.shape[1], cfg.vocab_size, "unembed")
    logits = x @ w
    if w.shape[1] == cfg.vocab_size:
        return logits
    from repro_torch.distributed import gather_row
    return gather_row(logits, _row_mesh(w.shape[1], cfg.vocab_size,
                                        "unembed"), logits.dim() - 1)
