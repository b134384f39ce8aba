"""Mamba2, the State Space Duality (SSD) block (Dao & Gu,
arXiv:2405.21060): the port of ``repro.models.ssm``.

A full sequence runs the chunked dual form: the sequence splits into
chunks of Q tokens; inside a chunk the terms are attention-like batched
products, across chunks a recurrence over per-chunk states. Decode is
the O(1)-state recurrence. All decays are <= 1 (A < 0, dt > 0 through
softplus), so the chunked exponentials are safe in f32.

Shapes: heads H = (expand·d) / head_dim, state N = ``cfg.ssm_state``,
head dim P = ``cfg.ssm_head_dim``, one B/C group shared by the heads.

On a mesh with a model axis a rank holds the blocks
``launch.sharding`` gives: ``in_proj``'s and ``conv_w`` / ``conv_b``'s
columns (cut across the z | x | B | C | dt boundaries), ``out_proj``'s
rows, and a decode cache of its conv channels and, where the heads
divide, its heads of the state (``cache_pspecs``). A step gathers the
projection and the conv output over the model row, updates the rank's
heads of the state, gathers y, and sums ``out_proj``'s partials. The
full-sequence block (:func:`mamba_apply`, training) does the same
through the row's autograd functions (``distributed.copy_to_row`` /
``gather_row`` / ``sum_over_row``), so its gradients and
Hessian-vector products are summed over the row where a rank uses a
tensor only in part; decode keeps the in-place collectives.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


class SSMCache(NamedTuple):
    state: torch.Tensor     # [B, H, P, N] f32
    conv: torch.Tensor      # [B, W-1, di + 2N]  (the last conv inputs)


def init_mamba(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    d, di, n = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    h, w = cfg.ssm_num_heads, cfg.ssm_conv_width
    out_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    # dt bias such that softplus(dt_bias) spans [1e-3, 1e-1] (mamba2)
    u = torch.rand((h,), generator=gen, device=device)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))   # inverse softplus
    return {
        "in_proj": L.normal_init(gen, (d, 2 * di + 2 * n + h), cfg.pdtype,
                                 device),
        "conv_w": L.normal_init(gen, (w, di + 2 * n), cfg.pdtype, device,
                                0.1),
        "conv_b": torch.zeros((di + 2 * n,), dtype=cfg.pdtype,
                              device=device),
        "a_log": torch.zeros((h,), dtype=torch.float32, device=device),
        "dt_bias": dt_bias.float(),
        "D": torch.ones((h,), dtype=torch.float32, device=device),
        "norm": L.init_rmsnorm(di, cfg.pdtype, device),
        "out_proj": L.normal_init(gen, (di, d), cfg.pdtype, device,
                                  out_scale),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv by tap shifts, added one tap at a time in
    x's dtype as the reference does (``F.conv1d`` would accumulate in
    f32 and round bf16 otherwise). x: [B,S,C], w: [W,C]."""
    taps = w.shape[0]
    out = torch.zeros_like(x)
    for i in range(taps):
        shift = taps - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :x.shape[1]]
        out = out + xi * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    """in_proj's output -> (z [.., di], xBC [.., di + 2N], dt [.., H])."""
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_num_heads
    return torch.split(proj, [di, di + 2 * n, h], dim=-1)


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor, chunk: int
                 ) -> torch.Tensor:
    """Chunked SSD. xh: [B,S,H,P]; dt: [B,S,H] f32; a: [H] (negative);
    bmat/cmat: [B,S,N]. Returns y: [B,S,H,P] in xh's dtype.

    The reference's three-operand einsums are written as the two
    products its contraction path (opt_einsum, at mamba2-1.3b's and
    zamba2-1.2b's widths) takes; torch has no path optimiser here and
    would contract left to right. Bytes of each f32 intermediate per
    block at mamba2-1.3b, batch 8 x 512 (b 8, c 2 chunks, i = j = 256,
    h 64, p 64, n 128): ``diff`` / ``exp`` / ``decay`` / ``m`` [b,c,i,j,h]
    268 MB each; ``y_diag``, ``y_off`` [b,c,i,h,p] 67 MB; ``s_c``
    [b,c,h,p,n] 34 MB. A product over all of (i, j, h, p) at once
    would be [b,c,i,j,h,p]: 17.2 GB."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    nc = s // q

    xc = xh.reshape(b, nc, q, h, p).float()
    dtc = dt.reshape(b, nc, q, h)
    bc = bmat.reshape(b, nc, q, n).float()
    cc = cmat.reshape(b, nc, q, n).float()

    da = dtc * a                                    # [b,c,q,h] (<= 0)
    cum = torch.cumsum(da, dim=2)                   # [b,c,q,h]
    xdt = xc * dtc[..., None]                       # dt·x

    # intra-chunk (attention-like): L[i,j] = exp(cum_i - cum_j), i >= j;
    # masked after the exp, as the reference does
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [b,c,i,j,h]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                device=xh.device))
    decay = torch.where(tri[None, None, :, :, None], torch.exp(diff),
                        torch.zeros((), device=xh.device))
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)       # [b,c,i,j]
    # "bcij,bcijh,bcjhp->bcihp": (scores · decay), then contract j
    m = scores[..., None] * decay                          # [b,c,i,j,h]
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", m, xdt)

    # per-chunk end states S_c = Σ_j B_j ⊗ (exp(cum_last - cum_j)·dt_j·x_j)
    # "bcjn,bcjh,bcjhp->bchpn": (dte · x), then contract j with B
    dte = torch.exp(cum[:, :, -1:, :] - cum) * dtc         # [b,c,q,h]
    s_c = torch.einsum("bcjhp,bcjn->bchpn", dte[..., None] * xc, bc)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])              # [b,c,h]
    state = torch.zeros((b, h, p, n), dtype=torch.float32,
                        device=xh.device)
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = state * chunk_decay[:, c, :, None, None] + s_c[:, c]
    s_in = torch.stack(s_in, dim=1)                        # [b,c,h,p,n]

    # "bcin,bchpn,bcih->bcihp": contract n, then scale by exp(cum)
    y_off = torch.einsum("bcin,bchpn->bcihp", cc, s_in) \
        * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(xh.dtype)


def mamba_apply(params: dict, cfg: ModelConfig, x: torch.Tensor,
                seq=None) -> torch.Tensor:
    """Full-sequence Mamba2 block. x: [B,S,d] -> [B,S,d].

    ``seq`` (sequence parallelism): ``x`` and the output are the rank's
    block of the sequence. Where both ``in_proj`` and ``out_proj`` are
    split, the sequence is gathered at the projection
    (``gather_seq``) and ``out_proj``'s partial reduce-scattered
    (``scatter_seq``); the scan in between is unchanged. Otherwise the
    block runs replicated on the gathered sequence
    (``layers.seq_replicated``).

    On the model row (this rank's blocks of ``in_proj``'s columns,
    ``conv_w`` / ``conv_b``'s channels and ``out_proj``'s rows) the
    projection is gathered (``gather_row``): its column blocks cut
    across z | xBC | dt, so every part is whole on every rank. Each
    part a rank uses only in part goes through ``copy_to_row`` before
    the rank's slice, so its partial gradients are summed over the row:
    the conv input (the rank's channels, gathered after the silu),
    x, B, C and dt of the SSD (the rank's heads, where the heads divide
    as ``cache_block`` splits the state; y gathered), the replicated
    ``dt_bias`` / ``a_log`` / ``D`` at the rank's heads, and the gated,
    normed y feeding ``out_proj``'s rows (a partial summed over the row,
    ``sum_over_row``)."""
    from repro_torch import distributed as dist_lib
    di, n, h, p = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_num_heads,
                   cfg.ssm_head_dim)
    w_in, conv_w = params["in_proj"], params["conv_w"]
    width = 2 * di + 2 * n + h
    if seq is not None and (w_in.shape[1] == width
                            or params["out_proj"].shape[0] == di):
        return L.seq_replicated(lambda xs: mamba_apply(params, cfg, xs),
                                x, seq)
    x = L._col_in(x, w_in.shape[1], width, "in_proj", seq)
    bsz, s = x.shape[0], x.shape[1]
    proj = x @ w_in.to(x.dtype)
    if w_in.shape[1] != width:
        proj = dist_lib.gather_row(
            proj, L._row_mesh(w_in.shape[1], width, "in_proj"), -1)
    z, xbc, dt = _split_proj(cfg, proj)

    # the causal conv on the rank's channels
    chans = conv_w.shape[1]
    if chans == di + 2 * n:
        xbc = F.silu(_causal_conv(xbc, conv_w, params["conv_b"]))
    else:
        mesh = L._row_mesh(chans, di + 2 * n, "conv_w")
        r = mesh.coords["model"]
        mine = dist_lib.copy_to_row(xbc, mesh)[..., r * chans:
                                               (r + 1) * chans]
        xbc = dist_lib.gather_row(
            F.silu(_causal_conv(mine, conv_w, params["conv_b"])), mesh, -1)
    xin, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)

    # the SSD on the rank's heads where the state splits
    _, hs = cache_block(cfg, params)
    dt_bias, a_log, d_skip = params["dt_bias"], params["a_log"], params["D"]
    head_mesh = None
    if hs != h:
        head_mesh = L._row_mesh(hs, h, "the SSD heads")
        heads = slice(head_mesh.coords["model"] * hs,
                      (head_mesh.coords["model"] + 1) * hs)

        def mine(t, dim=-1):
            t = dist_lib.copy_to_row(t, head_mesh)
            return t[heads] if dim == 0 else t.narrow(
                dim, heads.start, hs)

        xh = mine(xin.reshape(bsz, s, h, p), 2)
        dt, dt_bias, a_log, d_skip = (mine(dt), mine(dt_bias, 0),
                                      mine(a_log, 0), mine(d_skip, 0))
        bmat = dist_lib.copy_to_row(bmat, head_mesh)
        cmat = dist_lib.copy_to_row(cmat, head_mesh)
    else:
        xh = xin.reshape(bsz, s, h, p)
    dt32 = F.softplus(dt.float() + dt_bias)
    a = -torch.exp(a_log)
    y = _ssd_chunked(xh, dt32, a, bmat, cmat, cfg.ssm_chunk)
    y = y + d_skip.to(y.dtype)[None, None, :, None] * xh
    if head_mesh is not None:
        y = dist_lib.gather_row(y, head_mesh, 2)
    y = y.reshape(bsz, s, di)
    y = y * F.silu(z)
    y = L.rmsnorm(params["norm"], y, cfg.norm_eps)

    # out_proj over the rank's rows, summed over the row
    w_out = params["out_proj"]
    rows = w_out.shape[0]
    if rows == di:
        return y @ w_out.to(x.dtype)
    mesh = L._row_mesh(rows, di, "out_proj")
    r = mesh.coords["model"]
    part = dist_lib.copy_to_row(y, mesh)[..., r * rows:(r + 1) * rows] \
        @ w_out.to(x.dtype)
    if seq is not None:
        return dist_lib.scatter_seq(part, mesh)
    return dist_lib.sum_over_row(part, mesh)


def cache_block(cfg: ModelConfig, params=None) -> tuple[int, int]:
    """(conv channels, SSM heads) of a rank's decode cache for a block
    with ``params`` (this rank's blocks of its leaves): the conv cache's
    channels are ``conv_w``'s, the state's heads split by the model axis
    that split ``out_proj`` where it divides them (``cache_pspecs``'
    rule); whole without params."""
    c, h = cfg.ssm_d_inner + 2 * cfg.ssm_state, cfg.ssm_num_heads
    if params is None:
        return c, h
    m = cfg.ssm_d_inner // params["out_proj"].shape[0]
    return params["conv_w"].shape[1], h // m if h % m == 0 else h


def mamba_init_cache(cfg: ModelConfig, batch: int, dtype, device,
                     params=None) -> SSMCache:
    c, h = cache_block(cfg, params)
    return SSMCache(
        state=torch.zeros((batch, h, cfg.ssm_head_dim, cfg.ssm_state),
                          dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, c), dtype=dtype,
                         device=device))


def mamba_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: SSMCache) -> tuple[torch.Tensor, SSMCache]:
    """One-token recurrent step. x: [B,1,d]. The cache's state and conv
    window are updated in place and returned. On the model axis the
    rank computes its conv channels and its heads of the state from the
    gathered projection, and sums ``out_proj``'s partials."""
    di, n, h, p = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_num_heads,
                   cfg.ssm_head_dim)
    bsz = x.shape[0]
    w_in = params["in_proj"]
    proj = x @ w_in.to(x.dtype)
    if w_in.shape[1] != 2 * di + 2 * n + h:
        proj = L._row_mesh(w_in.shape[1], 2 * di + 2 * n + h,
                           "in_proj").model_gather(proj, -1)
    z, xbc, dt = _split_proj(cfg, proj)

    # conv over (the cached W-1 inputs, the current one), on the
    # channels of the rank's conv cache
    chans = cache.conv.shape[2]
    conv_mesh = None
    if chans != di + 2 * n:
        conv_mesh = L._row_mesh(chans, di + 2 * n, "the conv cache")
        r = conv_mesh.coords["model"]
        xbc = xbc[..., r * chans:(r + 1) * chans]
    conv_in = torch.cat([cache.conv, xbc], dim=1)          # [B, W, C]
    w = params["conv_w"].to(x.dtype)
    out = torch.einsum("bwc,wc->bc", conv_in, w) \
        + params["conv_b"].to(x.dtype)
    xbc1 = F.silu(out)[:, None, :]
    if conv_mesh is not None:
        xbc1 = conv_mesh.model_gather(xbc1, -1)

    xin, bmat, cmat = torch.split(xbc1, [di, n, n], dim=-1)
    heads, state_mesh = slice(None), None
    if cache.state.shape[1] != h:
        hs = cache.state.shape[1]
        state_mesh = L._row_mesh(hs, h, "the SSM state")
        r = state_mesh.coords["model"]
        heads = slice(r * hs, (r + 1) * hs)
    xh = xin.reshape(bsz, h, p)[:, heads].float()
    bvec = bmat[:, 0].float()                              # [B, N]
    cvec = cmat[:, 0].float()
    dt32 = F.softplus(dt[:, 0, heads].float() + params["dt_bias"][heads])
    a = -torch.exp(params["a_log"][heads])
    da = torch.exp(dt32 * a)                               # [B, H]
    # "bh,bhp,bn->bhpn": (dt · x), then the outer product with B
    state = cache.state * da[:, :, None, None] \
        + (dt32[:, :, None] * xh)[..., None] * bvec[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", state, cvec) \
        + params["D"][heads][None, :, None] * xh
    if state_mesh is not None:
        y = state_mesh.model_gather(y, 1)
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = y * F.silu(z)
    y = L.rmsnorm(params["norm"], y, cfg.norm_eps)
    cache.state.copy_(state)
    cache.conv.copy_(conv_in[:, 1:, :])
    w_out = params["out_proj"]
    rows = w_out.shape[0]
    if rows == di:
        return y @ w_out.to(x.dtype), cache
    out_mesh = L._row_mesh(rows, di, "out_proj")
    r = out_mesh.coords["model"]
    part = y[..., r * rows:(r + 1) * rows] @ w_out.to(x.dtype)
    return out_mesh.model_sum_(part), cache
