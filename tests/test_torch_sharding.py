"""The port's model-axis rules (``repro_torch.launch.sharding``) against
the reference's (``repro.launch.sharding``), leaf by leaf, with no
world: every rule takes a stand-in mesh of axis sizes, as the
reference's ``test_pspec_rules_divisibility_guard`` does.

For all ten arch ids at full size (shapes only: the reference's
``jax.eval_shape`` of its init, the port's meta tensors) on the meshes
(1, 2), (2, 4) and (16, 16):

* ``state_pspecs`` with fsdp off and on over the reference's stacked
  layout (``convert.jax_template``) equals the reference's spec of every
  leaf;
* over the port's per-layer tree, through ``convert.segment_paths``:
  every member's spec is its stacked leaf's with the stacked dims
  dropped; with fsdp the reference may put the data axes on a stacked
  dim, which a per-layer leaf does not have, and the test names those
  leaves (:data:`STACKED_DIM_PICKS`) instead of skipping them;
* ``cache_pspecs`` over the reference's cache shapes, and over the
  port's per-layer caches through the same stacking, and
  ``batch_pspecs`` over batches that do and do not divide the data
  axis;
* the reference's three guard cases, ``local_block`` and ``named``.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import sharding as jsh
from repro.models import get_model as jget_model
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.base import tree_flatten_with_path, tree_get
from repro_torch.distributed import NamedSharding, PartitionSpec as P
from repro_torch.launch import sharding as sh
from repro_torch.models import convert, extra_embed_shape, get_model
from repro_torch.models.transformer import _group_spec

MESHES = [(1, 2), (2, 4), (16, 16)]
MESH_IDS = ["1x2", "2x4", "16x16"]
CACHE_B, CACHE_T = 32, 4096

# With fsdp the reference gives the data axes to the largest unsharded
# dim that divides by them, and on its stacked leaves that may be the
# stacked (layer or group) dim itself. A port leaf holds one layer, so
# its spec drops that entry: these are every such leaf, by arch and
# mesh (reference leaf names).
STACKED_DIM_PICKS = {
    # 48 mamba blocks: conv_w [48, 4, C] and conv_b [48, C] keep C for
    # the model axis, and 48 is the largest dim left
    ("mamba2-1.3b", "2x4"): ["blocks/mamba/conv_b", "blocks/mamba/conv_w"],
    ("mamba2-1.3b", "16x16"): ["blocks/mamba/conv_b",
                               "blocks/mamba/conv_w"],
    # 6 groups of 6 blocks, 2 trailing blocks
    ("zamba2-1.2b", "2x4"): ["groups/mamba/conv_b", "groups/mamba/conv_w",
                             "trailing/mamba/conv_b"],
    # the cross layers' gate: [8] f32 stacked, a 0-d leaf per layer
    ("llama-3.2-vision-11b", "2x4"): ["groups/l5_cross/gate"],
}


class FakeMesh:
    """Axis sizes only (the reference test's stand-in)."""

    def __init__(self, data: int, model: int):
        self.shape = {"data": data, "model": model}


def _norm(spec) -> tuple:
    """Entries as the reference's ``PartitionSpec`` normalises them: a
    one-axis tuple is that axis."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    return jax.eval_shape(jget_model(jget_config(arch)).init,
                          jax.random.PRNGKey(0))


def _ref_named(tree, mesh, fsdp) -> dict:
    specs = jsh.state_pspecs(mesh, tree, fsdp=fsdp)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(jsh._path_names(p)): _norm(s) for p, s in flat[0]}


def _port_named(tree, mesh, fsdp) -> dict:
    specs = sh.state_pspecs(mesh, tree, fsdp=fsdp)
    out = {}

    def walk(node, path):
        if isinstance(node, P):
            out["/".join(str(p) for p in path)] = _norm(node)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
    walk(specs, ())
    return out


@functools.lru_cache(maxsize=None)
def _port_meta(arch: str):
    cfg = get_config(arch)
    from repro_torch.models.registry import FAMILIES
    return FAMILIES[cfg.family][0](cfg, torch.Generator(),
                                   torch.device("meta"))


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_pspecs_on_the_reference_layout(arch, mesh, fsdp):
    fake = FakeMesh(*mesh)
    want = _ref_named(_ref_params(arch), fake, fsdp)
    got = _port_named(convert.jax_template(get_config(arch)), fake, fsdp)
    assert got == want


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_pspecs_through_convert_paths(arch, mesh, fsdp):
    fake = FakeMesh(*mesh)
    cfg = get_config(arch)
    want = _ref_named(_ref_params(arch), fake, fsdp)
    params = _port_meta(arch)
    specs = sh.state_pspecs(fake, params, fsdp=fsdp)
    picks = []
    for seg in convert.segment_paths(cfg, params):
        ref = want[seg.name]
        for path in seg.paths:
            got = _norm(tree_get(specs, path))
            lead = len(ref) - len(got)
            assert lead == (len(ref) - tree_get(params, path).dim())
            if any(e is not None for e in ref[:lead]):
                picks.append(seg.name)
                assert "model" not in ref[:lead]
                continue
            assert got == ref[lead:], (seg.name, path)
    key = (arch, MESH_IDS[MESHES.index(mesh)])
    assert sorted(set(picks)) == \
        (STACKED_DIM_PICKS.get(key, []) if fsdp else [])


def _ref_cache_shapes(arch: str):
    cfg = jget_config(arch)
    m = jget_model(cfg)
    es = extra_embed_shape(get_config(arch), CACHE_B)
    extra = None if es is None else jax.ShapeDtypeStruct(es, cfg.cdtype)
    return jax.eval_shape(lambda p, e: m.init_cache(p, CACHE_B, CACHE_T, e),
                          _ref_params(arch), extra)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_on_the_reference_cache(arch, mesh):
    fake = FakeMesh(*mesh)
    shapes = _ref_cache_shapes(arch)
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    want = jax.tree_util.tree_leaves(jsh.cache_pspecs(fake, shapes),
                                     is_leaf=is_spec)
    # the same tree with shape-only leaves, NamedTuples kept (their
    # fields name the leaves, as the reference's GetAttrKey does)
    port_tree = jax.tree_util.tree_map(
        lambda x: torch.empty(x.shape, device="meta"), shapes)
    got = []

    def walk(node):
        if isinstance(node, P):
            got.append(_norm(node))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
    walk(sh.cache_pspecs(fake, port_tree))
    assert got == [_norm(s) for s in want]


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if get_config(a).family
                                  in ("dense", "moe", "vlm")])
def test_cache_pspecs_on_the_port_cache(arch, mesh):
    """The port's per-layer pool: layer g * n + i holds member g of the
    reference's ``l{i}_{kind}`` stack, so its spec is the stack's with
    the group dim dropped."""
    fake = FakeMesh(*mesh)
    cfg = get_config(arch)
    model = get_model(cfg)
    es = extra_embed_shape(cfg, CACHE_B)
    extra = None if es is None else torch.empty(es, device="meta")
    cache = model.init_cache(_port_meta(arch), CACHE_B, CACHE_T, extra)
    got = sh.cache_pspecs(fake, cache)
    want = jsh.cache_pspecs(fake, _ref_cache_shapes(arch))
    _, group = _group_spec(cfg)
    n = len(group)
    names = [f"l{i}_{k}" for i, k in enumerate(group)]
    for j, layer in enumerate(got):
        ref = want[names[j % n]]
        for key, spec in layer.items():
            r = _norm(ref[key])
            assert r[0] is None                # the group dim
            assert _norm(spec) == r[1:], (j, key)


@pytest.mark.parametrize("b", [1, 3, 8, 256])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_batch_pspecs(mesh, b):
    fake = FakeMesh(*mesh)
    ref_batch = {"tokens": jax.ShapeDtypeStruct((b, 64), np.int32),
                 "labels": jax.ShapeDtypeStruct((b, 64), np.int32),
                 "scale": jax.ShapeDtypeStruct((), np.float32)}
    port_batch = {k: torch.empty(v.shape, device="meta")
                  for k, v in ref_batch.items()}
    want = jsh.batch_pspecs(fake, ref_batch)
    got = sh.batch_pspecs(fake, port_batch)
    assert {k: _norm(v) for k, v in got.items()} == \
        {k: _norm(v) for k, v in want.items()}


def test_pspec_rules_divisibility_guard():
    """The reference's three guard cases: whisper's 20 heads on a
    16-way model axis stay replicated; 32 heads split; fsdp puts the
    data axis on the remaining dim."""
    fake = FakeMesh(16, 16)
    meta = torch.device("meta")
    assert sh.leaf_pspec(("attn", "wq"), torch.empty(1280, 20, 64,
                                                     device=meta),
                         fake) == P(None, None, None)
    assert sh.leaf_pspec(("attn", "wq"), torch.empty(4096, 32, 128,
                                                     device=meta),
                         fake) == P(None, "model", None)
    assert _norm(sh.leaf_pspec(("mlp", "wi"), torch.empty(
        4096, 14336, device=meta), fake, fsdp=True)) == ("data", "model")


class Rank:
    """A stand-in rank: axis sizes and its coordinates."""

    def __init__(self, data, model, di, mi):
        self.shape = {"data": data, "model": model}
        self.coords = {"data": di, "model": mi}


def test_local_block_tiles_a_leaf_in_rank_order():
    x = torch.arange(4 * 6 * 8).reshape(4, 6, 8)
    spec = P(("data",), None, "model")
    blocks = {(d, m): x[sh.local_block(spec, Rank(2, 4, d, m), x.shape)]
              for d in range(2) for m in range(4)}
    for (d, m), blk in blocks.items():
        assert torch.equal(blk, x[2 * d:2 * d + 2, :, 2 * m:2 * m + 2])
    rows = [torch.cat([blocks[(d, m)] for m in range(4)], dim=2)
            for d in range(2)]
    assert torch.equal(torch.cat(rows, dim=0), x)
    assert sh.local_block(P(), Rank(2, 4, 1, 3), x.shape) == \
        (slice(None),) * 3
    with pytest.raises(ValueError, match="does not split into 4 blocks"):
        sh.local_block(P("model"), Rank(1, 4, 0, 0), (6,))


def test_named_wraps_every_spec_and_keeps_the_tree():
    fake = FakeMesh(1, 2)
    params = {"embed": {"table": torch.empty(8, 4, device="meta")},
              "layers": [{"attn": {"wq": torch.empty(4, 2, 3,
                                                     device="meta")}}]}
    placed = sh.named(fake, sh.state_pspecs(fake, params))
    assert placed["embed"]["table"] == NamedSharding(fake, P("model", None))
    assert placed["layers"][0]["attn"]["wq"] == \
        NamedSharding(fake, P(None, "model", None))
    assert [p for p, _ in tree_flatten_with_path(placed)] == \
        [p for p, _ in tree_flatten_with_path(params)]
