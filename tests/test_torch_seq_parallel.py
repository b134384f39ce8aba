"""Sequence parallelism in the port (``layers.set_batch_sharding(...,
seq_axis="model")``: the residual stream split over the model row
between blocks, gathered at each block's entry and reduce-scattered at
its exit) against the JAX package's own GSPMD step with the sequence
over the model axis, and against the port's unsplit step, on the CPU.

The reference side runs once, in a subprocess that fabricates 8 host
devices (``torch_sp_ref.main``), while the port's side runs in one gloo
world of 8 ranks (``torch_sp_ref.world``); inputs are the reference's
own smoke params and seeded batches (``torch_tp_train_families_ref
.inputs``).

* For qwen2.5-3b, olmoe-1b-7b (experts over the model axis),
  mamba2-1.3b, zamba2-1.2b, whisper-large-v3 and llama-3.2-vision-11b:
  the port's ``(2, 4)`` tree-TVLARS step gives the reference's own
  ``(2, 4)`` step within that test's bounds
  (``torch_tp_train_families_ref.BOUNDS``), and ``Model.apply``'s
  last-position logits the reference's within
  ``ref.parity_tolerance("f32")``.
* At ``(2, 2)`` the split step gives the unsplit one's loss bit for bit
  (the gloo reduce-scatter is the unsplit all-reduce and the rank's
  block) and every metric and param within 1e-6 relative (a norm
  scale's gradient sums its rows' partials over the row: another order).
* At ``(1, 8)``, where the heads (whisper, the vlm) or experts (olmoe)
  stay whole, the split step gives the single-rank step within 1e-5.
* A control that must miss: a ``scatter_seq`` that keeps the rank's
  block of its own partial without summing.
* On meta (the dry run's live-bytes tracker), the residual a layer
  saves for its backward under the split is 1/M of the unsplit one's.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401  (autouse)
import torch_sp_ref as sp
import torch_tp_train_families_ref as fam
from repro.kernels import ref as jax_ref
from repro_torch.configs import get_smoke_config
from repro_torch.core.base import tree_leaves
from repro_torch.launch.dryrun import DryMesh, LiveBytes
from repro_torch.models import convert, get_model
from repro_torch.models import layers as L

SAME = 1e-6          # the split step against the unsplit one, relative
PARAM_FLOOR = 1e-9   # an absolute floor for params that are near zero


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return sp.collect(str(tmp_path_factory.mktemp("seq_parallel")))


@pytest.mark.parametrize("arch", sp.ARCHS)
def test_split_step_matches_the_references_split_step(runs, arch):
    got = runs["world"][f"{arch}/2x4/sp"]
    ref, key = runs["ref"], f"{arch}/tree"
    b = fam.BOUNDS
    np.testing.assert_allclose(got["loss"], ref[f"{key}/loss"],
                               rtol=b["loss"])
    np.testing.assert_allclose(got["load_balance"],
                               ref[f"{key}/load_balance"],
                               rtol=b["load_balance"])
    theirs = fam.leaves(ref, f"{key}/params")
    assert len(got["params"]) == len(theirs)
    for a, w in zip(got["params"], theirs):
        np.testing.assert_allclose(a, w, rtol=b["params_rtol"],
                                   atol=b["params_atol"])
    for name in fam.NORMS:
        np.testing.assert_allclose(got[name], ref[f"{key}/{name}"],
                                   rtol=b["norms"], err_msg=name)


@pytest.mark.parametrize("arch", sp.ARCHS)
def test_split_prefill_logits_match_the_references(runs, arch):
    got = runs["world"][f"{arch}/2x4/logits"]
    want = runs["ref"][f"{arch}/logits"]
    assert got.shape == want.shape == (8, 1, get_smoke_config(arch)
                                       .vocab_size)
    np.testing.assert_allclose(got, want, **jax_ref.parity_tolerance("f32"))


@pytest.mark.parametrize("arch", sp.ARCHS)
def test_split_step_equals_the_unsplit_step(runs, arch):
    got = runs["world"][f"{arch}/2x2/sp"]
    want = runs["world"][f"{arch}/2x2/plain"]
    assert np.array_equal(got["loss"], want["loss"])
    for name in sp.METRICS:
        np.testing.assert_allclose(got[name], want[name], rtol=SAME,
                                   atol=0, err_msg=name)
    for a, w in zip(got["params"], want["params"]):
        np.testing.assert_allclose(a, w, rtol=SAME, atol=PARAM_FLOOR)


@pytest.mark.parametrize("arch", sp.ARCHS)
def test_split_step_records_the_sequence_collectives(runs, arch):
    """The split step gathers and reduce-scatters the sequence
    (``seq_gather`` / ``seq_scatter``) where the unsplit one has neither;
    both sum row-parallel partials elsewhere only where the split has no
    sequence to cut (the CE head's row statistics)."""
    got = runs["world"][f"{arch}/2x2/sp"]["collectives"]
    plain = runs["world"][f"{arch}/2x2/plain"]["collectives"]
    assert got["seq_gather"][0] > 0 and got["seq_scatter"][0] > 0
    assert "seq_gather" not in plain and "seq_scatter" not in plain


@pytest.mark.parametrize("arch", sp.WHOLE)
def test_whole_heads_or_experts_split_step_matches_the_single_rank(
        runs, arch):
    gaps = fam.single_gaps(runs["world"][f"{arch}/1x8/sp"],
                           runs["single"][arch])
    assert all(v <= fam.F32 for v in gaps.values()), gaps


def test_unsummed_scatter_control_misses(runs):
    arch = sp.ARCHS[0]
    got = runs["world"][f"{arch}/2x4/no-sum"]
    ref = runs["ref"]
    assert fam.rel_gap(got["loss"], ref[f"{arch}/tree/loss"]) \
        > fam.BOUNDS["loss"]
    assert fam.rel_gap(got["layerwise/g_norm"],
                       ref[f"{arch}/tree/layerwise/g_norm"]) \
        > fam.BOUNDS["norms"]


def _saved(layers: int, m: int, seq: bool) -> int:
    """The bytes the forward of a remat'd loss holds for its backward on
    a rank of a (1, m) dry mesh (meta tensors), with the sequence split
    or not."""
    cfg = get_smoke_config("qwen2.5-3b").replace(num_layers=layers,
                                                 remat=True)
    mesh = DryMesh(1, m)
    model = get_model(cfg)
    params = model.init(0, device="meta", mesh=mesh, fsdp=True)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    batch = {k: torch.empty((8, 32), dtype=torch.int64, device="meta")
             for k in ("tokens", "labels")}
    L.set_batch_sharding(("data",), "model" if seq else None,
                         model_size=m, mesh=mesh)
    try:
        with L.training(mesh, convert.placement(cfg, mesh)), \
                LiveBytes() as live:
            loss, _ = model.loss(params, batch)
            return live.live
    finally:
        L.set_batch_sharding(None)


@pytest.mark.parametrize("m", [2, 4])
def test_saved_residual_is_one_mth_under_the_split(m):
    """Two more layers add their saved residual [B, S, D] unsplit and
    [B, S/M, D] split: the remat boundary is 1/M."""
    per = {seq: _saved(4, m, seq) - _saved(2, m, seq)
           for seq in (True, False)}
    assert per[False] == 2 * 8 * 32 * 128 * 4
    assert per[True] * m == per[False]
