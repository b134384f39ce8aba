"""The port's training placement (``convert.placement``: a
``launch.sharding.Placement`` with the stacked-dim rule) against the
reference's rules on its stacked tree, leaf by leaf, with no world: for
all ten arch ids at full size (shapes only) on the meshes (1, 2), (2,
4) and (16, 16), fsdp on and off.

* Every member of a stacked leaf of the reference takes the
  reference's spec of that leaf with the stacked dims dropped, also
  where the reference gives the data axes to a stacked dim (the member
  then stays whole over the data column): never a pick of the port's
  own over the per-layer leaf.
* ``Placement.stacked_picks`` names exactly those members:
  ``test_torch_sharding.STACKED_DIM_PICKS``'s leaves (mamba2's and
  zamba2's ``conv_w`` / ``conv_b``, the vlm cross layers' ``gate``).
* ``counts_once`` follows: a stacked-dim member counts on data index 0
  only, once over the model axis as its model split says.
* ``convert.shard_params`` and ``convert.init_sharded`` keep the
  placement's block of each leaf (a smoke config with mamba2's stacked
  picks, 6 blocks, on a stand-in rank).
"""
from __future__ import annotations

import pytest
import torch

import test_torch_sharding as rules
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.base import tree_flatten_with_path, tree_get
from repro_torch.distributed import Mesh
from repro_torch.launch import sharding as sh
from repro_torch.models import convert, get_model


class _At:
    """A stand-in rank of a mesh: its axis sizes and coordinates, and the
    mesh's own ``counts_once``."""
    counts_once = Mesh.counts_once

    def __init__(self, mesh: tuple, data: int = 0, model: int = 0):
        self.shape = {"data": mesh[0], "model": mesh[1]}
        self.coords = {"data": data, "model": model}



@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", rules.MESHES, ids=rules.MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placement_is_the_reference_leafs_spec_without_stacked_dims(
        arch, mesh, fsdp):
    cfg = get_config(arch)
    want = rules._ref_named(rules._ref_params(arch), rules.FakeMesh(*mesh),
                            fsdp)
    params = rules._port_meta(arch)
    place = convert.placement(cfg, rules.FakeMesh(*mesh), fsdp=fsdp)
    picks = set()
    for seg in convert.segment_paths(cfg, params):
        ref = want[seg.name]
        for path in seg.paths:
            lead = len(ref) - tree_get(params, path).dim()
            assert rules._norm(place.spec(path)) == ref[lead:], \
                (seg.name, path)
            if any(e is not None for e in ref[:lead]):
                picks.add(seg.name)
                assert path in place.stacked_picks
            else:
                assert path not in place.stacked_picks
    key = (arch, rules.MESH_IDS[rules.MESHES.index(mesh)])
    assert sorted(picks) == (rules.STACKED_DIM_PICKS.get(key, [])
                             if fsdp else [])


@pytest.mark.parametrize("coords,counted", [
    ((0, 0), True), ((0, 1), True), ((1, 0), False), ((1, 3), False)])
def test_a_stacked_dim_pick_counts_once(coords, counted):
    """mamba2-1.3b on (2, 4): the reference puts data on conv_b's
    stacked [48] dim and model on its channels; the member is split
    over the model axis only, so only data index 0 counts its block
    (every model index holds a block of its own)."""
    cfg = get_config("mamba2-1.3b")
    place = convert.placement(cfg, _At((2, 4), *coords))
    path = ("blocks", 0, "mamba", "conv_b")
    assert path in place.stacked_picks
    assert place.spec(path) == sh.P("model")
    assert place.counts_once(path) == counted


@pytest.mark.parametrize("coords", [(0, 0), (1, 2)])
def test_shard_params_and_init_sharded_keep_the_placements_blocks(coords):
    cfg = get_smoke_config("mamba2-1.3b").replace(num_layers=6)
    mesh = _At((2, 4), *coords)
    model = get_model(cfg)
    whole = model.init(0, device="cpu")
    place = convert.placement(cfg, mesh)
    assert {p[-1] for p in place.stacked_picks} == {"conv_w", "conv_b"}
    want = {p: place.block(p, x) for p, x in tree_flatten_with_path(whole)}
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.registry import FAMILIES
    for got in (convert.shard_params(cfg, whole, mesh, fsdp=True),
                convert.init_sharded(cfg, FAMILIES["ssm"][0], gen,
                                     torch.device("cpu"), mesh,
                                     fsdp=True)):
        pairs = dict(tree_flatten_with_path(got))
        assert pairs.keys() == want.keys()
        for p, x in pairs.items():
            assert torch.equal(x, want[p]), p
