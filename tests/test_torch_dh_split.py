"""The KV cache split over the head dim (``cache_pspecs``' Dh fallback)
and the cache rule itself, in the port against the JAX package, on the
CPU. Decode over meshes where the rule picks Dh or T beside whole heads
runs in ``test_torch_tp_fallback.py``'s worlds.

* The decode kernel's scores and apply modes in their plain versions
  (what ``kernels.ops`` runs for CPU tensors): a cache cut into M in
  {2, 4, 8} blocks of the head dim (32, down to blocks of 4), each
  block's partial scores summed in rank order, each block's apply on
  the sum, the outputs put together along the head dim, give the JAX
  package's oracle (``ref_attention_decode``) on the whole cache within
  ``decode_parity_tolerance``, on global layers and on rings past
  several laps; the blocks of the appended caches put together are the
  oracle's; a score past a row's last needed key is 0. The control,
  each block applied on its own scores left unsummed, misses the bound.
* The rule, leaf by leaf: for every KV cache leaf of the reference's
  ``init_cache`` of the ten arch ids and their smoke configs, at M in
  {2, 4, 8, 16} and several lengths, ``layers.cache_axis`` names the
  dim ``cache_pspecs`` gives the model axis, and ``cache_block`` is the
  block it leaves a rank (whisper-large-v3's cross K/V go over Dh at
  16, its 20 heads and 1500 frames dividing neither).
* Both modes' wrappers refuse what they do not take before building.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.configs.registry import ARCH_IDS
from repro.kernels.ref import decode_parity_tolerance, ref_attention_decode
from repro.launch import sharding
from repro.models import extra_embed_shape
from repro.models import get_model as jget_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import attention_decode as tad
from repro_torch.kernels import ops
from repro_torch.models import layers as L

F32 = decode_parity_tolerance("float32")
B, H, HKV, DH, T = 4, 8, 2, 32, 16
CASES = {  # window, positions
    "global": (None, [0, 3, 7, 15]),
    "ring-first-lap": (T, [0, 3, 7, 15]),
    "ring-laps": (T, [16, 21, 33, 4 * T + 5]),
    "short-window": (6, [2, 9, 30, 3 * T + 1]),
}
MODELS = (2, 4, 8)


def _operands(seed: int):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for shape in (
        (B, 1, H, DH), (B, 1, HKV, DH), (B, 1, HKV, DH), (B, T, HKV, DH),
        (B, T, HKV, DH))]


def _blocks(arrays, pos, window, m: int, summed: bool = True):
    """Each rank's block of the head dim through the scores mode, the
    row's sum (or, ``summed=False``, each block's own scores), then the
    apply mode: (outputs put together along the head dim, the blocks'
    appended caches put together, the blocks' scores)."""
    q, nk, nv, kc, vc = (torch.from_numpy(a) for a in arrays)
    dl = DH // m
    parts = []
    for r in range(m):
        blk = slice(r * dl, (r + 1) * dl)
        kb, vb = kc[..., blk].clone(), vc[..., blk].clone()
        s = ops.attention_decode_scores(q[..., blk], nk[..., blk],
                                        nv[..., blk], kb, vb, pos,
                                        window=window)
        parts.append((s, kb, vb))
    total = sum(s for s, _, _ in parts)
    outs = [ops.attention_decode_apply(total if summed else s, vb, pos,
                                       head_dim=DH, dtype=q.dtype,
                                       window=window)
            for s, _, vb in parts]
    return (torch.cat(outs, -1), torch.cat([kb for _, kb, _ in parts], -1),
            torch.cat([vb for _, _, vb in parts], -1),
            [s for s, _, _ in parts])


def _oracle(arrays, positions, window):
    out, k, v = ref_attention_decode(
        *(jnp.asarray(a) for a in arrays),
        jnp.asarray(positions, jnp.int32), window=window)
    return np.array(out), np.array(k), np.array(v)


@pytest.mark.parametrize("m", MODELS)
@pytest.mark.parametrize("case", list(CASES))
def test_summed_block_scores_give_the_oracle(case, m):
    window, positions = CASES[case]
    arrays = _operands(m)
    pos = torch.tensor(positions, dtype=torch.int32)
    launches = dict(ops.launches)
    out, kc, vc, _ = _blocks(arrays, pos, window, m)
    assert ops.launches == launches        # the CPU runs the plain modes
    want, wk, wv = _oracle(arrays, positions, window)
    np.testing.assert_allclose(out.numpy(), want, rtol=F32["rtol"],
                               atol=F32["atol"])
    assert np.array_equal(kc.numpy(), wk) and np.array_equal(vc.numpy(), wv)


@pytest.mark.parametrize("m", MODELS)
def test_unsummed_scores_miss_the_bound(m):
    """The control: each rank's apply on its own partial scores (the
    row sum left out) is not the attention."""
    window, positions = CASES["ring-laps"]
    arrays = _operands(10 + m)
    pos = torch.tensor(positions, dtype=torch.int32)
    out, _, _, _ = _blocks(arrays, pos, window, m, summed=False)
    want, _, _ = _oracle(arrays, positions, window)
    gap = np.abs(out.numpy() - want)
    assert (gap > F32["atol"] + F32["rtol"] * np.abs(want)).any()
    assert gap.max() > 100 * F32["atol"], gap.max()


@pytest.mark.parametrize("case", list(CASES))
def test_scores_stop_at_the_last_needed_key(case):
    """A block's scores past each row's last needed key are 0 (the
    kernel reads no K there); up to it they are the block's dot
    products, whose sum over the blocks is the whole head dim's."""
    window, positions = CASES[case]
    arrays = _operands(20)
    pos = torch.tensor(positions, dtype=torch.int32)
    _, _, _, scores = _blocks(arrays, pos, window, 4)
    last = [tad.last_key(p, T, window) for p in positions]
    q = torch.from_numpy(arrays[0]).reshape(B, HKV, H // HKV, DH)
    _, kj, _ = _oracle(arrays, positions, window)
    whole = torch.einsum("bkgd,btkd->bkgt", q, torch.from_numpy(kj)) \
        .reshape(B, H, T)
    total = sum(scores)
    for b, k in enumerate(last):
        for s in scores:
            assert not s[b, :, k + 1:].any()
        torch.testing.assert_close(total[b, :, :k + 1], whole[b, :, :k + 1],
                                   rtol=1e-5, atol=1e-5)


def test_the_modes_refuse_what_they_do_not_take():
    """Before building: shapes that do not fit, and tensors off the
    current CUDA device (every CPU tensor here)."""
    q, nk, nv, kc, vc = (torch.from_numpy(a) for a in _operands(0))
    pos = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(ValueError, match="caches must"):
        tad.attention_decode_scores_cuda(q, nk, nv, kc[..., :8], vc, pos)
    with pytest.raises(ValueError, match="current CUDA device"):
        tad.attention_decode_scores_cuda(q, nk, nv, kc, vc, pos)
    s = torch.zeros(B, H, T)
    with pytest.raises(ValueError, match="do not fit"):
        tad.attention_decode_apply_cuda(s, vc[:, :8], pos, head_dim=DH,
                                        dtype=torch.float32)
    with pytest.raises(ValueError, match="current CUDA device"):
        tad.attention_decode_apply_cuda(s, vc, pos, head_dim=DH,
                                        dtype=torch.float32)
    assert tad.piece_bytes(8, torch.bfloat16, 0) == 16
    assert tad.piece_bytes(4, torch.bfloat16, 0) == 2
    assert tad.piece_bytes(4, torch.float32, 0, 8) == 4
    assert tad.piece_bytes(4, torch.float32, 0, 16) == 16


# ------------------------------------------------------------------ the rule
LENGTHS = (16, 18, 24, 1021, 4096)
SIZES = (2, 4, 8, 16)
AXIS_OF_DIM = {-2: "heads", -3: "t", -1: "dh"}


def _kv_leaves(cfg, batch: int, max_len: int) -> list:
    """(name, shape) of every KV cache leaf of the reference's
    ``init_cache`` (shapes only)."""
    m = jget_model(cfg)
    params = jax.eval_shape(m.init, jax.random.PRNGKey(0))
    es = extra_embed_shape(cfg, batch)
    extra = None if es is None else jax.ShapeDtypeStruct(es, np.float32)
    cache = jax.eval_shape(lambda p, e: m.init_cache(p, batch, max_len, e),
                           params, extra)
    out = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(cache):
        name = str(getattr(path[-1], "key", getattr(path[-1], "name", "")))
        if name in ("k", "v", "ck", "cv"):
            out.append((name, leaf))
    return out


class _MeshShape:
    def __init__(self, model: int):
        self.shape = {"data": 1, "model": model}


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_axis_is_cache_pspecs_leaf_by_leaf(arch, smoke):
    jcfg = (jget_smoke if smoke else jget_config)(arch)
    cfg = (get_smoke_config if smoke else get_config)(arch)
    seen = set()
    for length in LENGTHS:
        leaves = _kv_leaves(jcfg, 2, length)
        if not leaves:
            assert cfg.family == "ssm"
            return
        for m in SIZES:
            tree = [{name: leaf} for name, leaf in leaves]
            specs = jax.tree_util.tree_leaves(
                sharding.cache_pspecs(_MeshShape(m), tree),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            for (name, leaf), spec in zip(leaves, specs):
                entries = tuple(spec)
                dims = [i - len(entries) for i, e in enumerate(entries)
                        if e == "model"]
                want = AXIS_OF_DIM[dims[0]] if dims else None
                t = leaf.shape[-3]
                assert L.cache_axis(cfg, t, m) == want, (name, t, m, spec)
                block = list(leaf.shape[-3:])
                if dims:
                    block[dims[0] + 3] //= m
                if want is not None or m == 1:
                    assert L.cache_block(cfg, t, m) == tuple(block)
                seen.add(want)
    if not smoke and arch == "whisper-large-v3":
        assert L.cache_axis(cfg, 1500, 16) == "dh"
        assert {"t", "dh"} <= seen
