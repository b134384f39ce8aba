"""Training the MoE family with its experts over the model axis (expert
parallelism: each rank of a model row holds E/M experts and the
router's E/M columns, routes every token of its data block with the
row's gathered logits, runs its own experts' entries and the row sums
the output) in the port, against the JAX package's own GSPMD step and
the port's single-rank step, on the CPU.

The reference side runs once, in a subprocess that fabricates 8 host
devices before jax is imported (``torch_ep_ref.main("train", ...)``),
while the port's side runs in one gloo world of 8 ranks
(``torch_ep_ranks.train_world``). Inputs are the reference's own smoke
params (4 experts, top-2) and a seeded batch, made here and in the
subprocess alike.

* The port's ``(2, 4)`` step (one expert a rank) gives the reference's
  own ``(2, 4)`` step on ``make_data_mesh(2, 4)`` (tree TVLARS for both
  archs, fused for olmoe) within the reference test's MoE bound (loss
  rtol 5e-3: routing ties may flip under sharding,
  ``tests/test_sharding_multidevice.py``), and ``load_balance`` within
  rtol 1e-4.
* The port's ``(1, 2)``, ``(2, 2)`` and ``(2, 4)`` f32 steps give its
  single-rank step within 1e-5 on the loss, every param, ``grad_norm``
  and the layer-wise norms, after the routing decisions (``topk_idx``,
  ``keep``) of every layer are asserted equal to the single-rank
  step's.
* Three controls exceed those bounds: the router's gradient block
  taken without the row sum of the combine path, the aux losses'
  gradient summed over the row (counted M times), and the experts'
  output left unsummed over the row.
* Experts whole: at M = 8 (olmoe's smoke config with 8 heads), 4
  experts stay whole on every rank and the step equals M = 1.
* The ``(2, 2)`` fused state saved with its placement
  (``checkpoint.save_train_state``) restores at M = 1 in
  the port (bitwise the gathered state, then served) and in the JAX
  package with the reference's provenance for the same state on the
  same mesh.
* ``launch.train --mesh-model 4 --mesh-data 2`` trains olmoe on the
  world's 8 ranks and prints the single-rank run's losses.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

import torch_ep_ranks as ranks
import torch_ep_ref as ref_side
import torch_tp_train_families_ref as families_ref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train

MESHES = ((1, 2), (2, 2), (2, 4))
CASES = {arch: cases for arch, _, cases in ref_side.TRAIN}
PORT_CASES = ("tree", "fused")
CONTROLS = tuple(ranks.CONTROLS)
LAUNCH = ["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
          "--steps", "2", "--seq", "16", "--global-batch", "8",
          "--use-kernel", "fused"]
MESH_ARGV = ["--mesh-model", "4", "--mesh-data", "2"]
LOSS_RTOL = 5e-3                 # the reference test's MoE bound
PROBE_ARCH = "olmoe-1b-7b"
PROBE_RTOL = 1e-4
F32 = families_ref.F32


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ep_train"))
    out = f"{tmp}/ref.npz"
    proc = ref_side.start("train", out)
    try:
        inp = {arch: families_ref.inputs(arch) for arch in CASES}
        single = {arch: {case: ranks.step(arch, *inp[arch], case)
                         for case in PORT_CASES} for arch in CASES}
        jobs = tuple(
            (arch, *inp[arch], mesh, PORT_CASES,
             CONTROLS if arch == "olmoe-1b-7b" and mesh == (2, 4) else (),
             mesh == (2, 2))
            for arch in CASES for mesh in MESHES)
        probes = ((PROBE_ARCH, *inp[PROBE_ARCH], (2, 2),
                   ("first-order-row",)),)
        world = mesh_lib.spawn(
            ranks.train_world, 8, "gloo", "cpu",
            args=(jobs, tmp, probes, (LAUNCH + MESH_ARGV,)),
            timeout=ref_side.TIMEOUT_S)
        whole = ranks.whole_step()
        probe = ranks.fam.probe(PROBE_ARCH, *inp[PROBE_ARCH])
        one = train.run(LAUNCH, log_fn=lambda *a: None)["losses"]
    finally:
        reference = ref_side.finish(proc, out)
    return {"ref": reference, "inputs": inp, "single": single,
            "world": world, "whole": whole, "one": one, "root": tmp,
            "probe": probe}


def _got(runs, arch, mesh, case="tree", rank=0):
    return runs["world"][rank][f"{arch}/{mesh[0]}x{mesh[1]}"][case]


@pytest.mark.parametrize("arch", list(CASES))
def test_reference_inputs_are_the_tests(runs, arch):
    families_ref.check_inputs(runs, arch)


@pytest.mark.parametrize("arch,case", [(a, c) for a, cs in CASES.items()
                                       for c in cs])
def test_2x4_step_matches_the_references_2x4_step(runs, arch, case):
    got, ref = _got(runs, arch, (2, 4), case), runs["ref"]
    np.testing.assert_allclose(got["loss"], ref[f"{arch}/{case}/loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["load_balance"],
                               ref[f"{arch}/{case}/load_balance"],
                               rtol=families_ref.BOUNDS["load_balance"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch,case", [(a, c) for a in CASES
                                       for c in PORT_CASES])
def test_mesh_step_matches_the_single_rank_step(runs, arch, case, mesh):
    want = runs["single"][arch][case]
    for rank in range(mesh[0] * mesh[1]):
        got = _got(runs, arch, mesh, case, rank)
        rows = slice(*got["rows"])
        assert len(got["routing"]) == len(want["routing"]) > 0
        for layer, ((idx, keep), (idx1, keep1)) in enumerate(
                zip(got["routing"], want["routing"])):
            assert np.array_equal(idx, idx1[rows]), \
                f"rank {rank}: layer {layer}'s top-k experts differ"
            assert np.array_equal(keep, keep1[rows]), \
                f"rank {rank}: layer {layer}'s kept entries differ"
        assert got["replicas_equal"]
    gaps = families_ref.single_gaps(_got(runs, arch, mesh, case), want)
    assert all(v <= F32 for v in gaps.values()), gaps


@pytest.mark.parametrize("control", CONTROLS)
def test_each_fault_exceeds_the_single_rank_bound(runs, control):
    got = _got(runs, "olmoe-1b-7b", (2, 4), control)
    want = runs["single"]["olmoe-1b-7b"]["tree"]
    metric = ranks.CONTROLS[control]
    gap = families_ref.rel_gap(got[metric], want[metric])
    assert gap > F32, (control, metric, gap)


def test_the_load_balance_is_live(runs):
    """Each layer's load balance is E · Σ me · ce of a routed batch (≈ 1
    at a near-uniform router), so its bound holds a real value."""
    got = float(_got(runs, "olmoe-1b-7b", (2, 4))["load_balance"])
    assert 1.0 < got < 4.0, got


def test_whole_experts_at_m8_equal_m1(runs):
    want = runs["whole"]
    for r in runs["world"]:
        got = r["whole"]
        assert got["experts"] == 4 and got["heads"] == 1
        for (idx, keep), (idx1, keep1) in zip(got["routing"],
                                             want["routing"]):
            assert np.array_equal(idx, idx1) and np.array_equal(keep, keep1)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=F32)
        for a, b in zip(got["params"], want["params"]):
            np.testing.assert_allclose(a, b, atol=F32)


@pytest.mark.parametrize("arch", list(CASES))
def test_2x2_checkpoint_restores_at_m1_in_both_packages(runs, arch):
    import jax
    from repro import checkpoint as jck
    from repro.core import build_optimizer as jopt
    from repro.training.train_state import TrainState as JState
    from repro_torch import checkpoint, serving
    from repro_torch.core import build_optimizer
    from repro_torch.core.base import tree_leaves
    from repro_torch.models import convert, get_model
    from repro_torch.training import TrainState
    path = os.path.join(runs["root"], arch, "2x2", "fused")
    params_np, _ = runs["inputs"][arch]
    want = _got(runs, arch, (2, 2), "fused")["params"]
    # the port, at M = 1: bitwise the (2, 2) state gathered whole
    cfg = ranks.fam.config(arch)
    model = get_model(cfg)
    like = TrainState.create(
        convert.params_from_jax(cfg, params_np, device="cpu"),
        build_optimizer("tvlars", **families_ref.HYPER, use_kernel="fused",
                        segments=model.segments, device="cpu"))
    restored = checkpoint.restore_train_state(path, like, cfg=cfg,
                                              device="cpu")
    got = [x.numpy() for x in tree_leaves(
        convert.params_to_jax(cfg, restored.params))]
    assert restored.step == 1 and len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    eng = serving.Engine(model, restored.params, serving.ServeConfig(
        slots=2, max_len=32, page_size=8), device="cpu")
    eng.submit(np.arange(1, 9), max_new_tokens=4)
    (res,) = eng.drain()
    assert len(res.tokens) == 4
    # the JAX package: the same params, the reference's provenance
    jlike = JState.create(jax.tree_util.tree_map(np.asarray, params_np),
                          jopt("tvlars", **families_ref.HYPER,
                               use_kernel="fused"))
    jleaves = jax.tree_util.tree_leaves(jck.restore(path, jlike))
    for a, b in zip(jleaves[1:1 + len(want)], want):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert jck.saved_shardings(path) == json.loads(
        str(runs["ref"][f"{arch}/provenance-2x2"]))


def test_2x2_probe_gives_the_single_rank_lambda_max(runs):
    """A 4-iteration Lanczos probe from the same seed vector (each
    rank's blocks of the single-rank ``v0``): its Hessian-vector product
    differentiates the loss twice through the row's gather of the
    router logits, their ``copy_to_row`` and the experts' row sum."""
    got = runs["world"][0][f"probe/{PROBE_ARCH}/2x2"]["probe"]
    np.testing.assert_allclose(got, runs["probe"], rtol=PROBE_RTOL)


def test_first_order_row_backwards_exceed_the_probe_bound(runs):
    """The row's backwards as first-order code (an in-place sum,
    the gradient itself, a plain slice): right for a gradient, wrong
    for the probe's second order."""
    got = runs["world"][0][f"probe/{PROBE_ARCH}/2x2"]["first-order-row"]
    gap = abs(got - runs["probe"]) / abs(runs["probe"])
    assert gap > PROBE_RTOL, gap


def test_launcher_trains_over_the_2x4_mesh(runs):
    got = runs["world"][0]["launch/0"]
    assert got["losses"] == pytest.approx(runs["one"], rel=1e-5)
    assert any("replicas bitwise equal: 8 ranks" in line
               for line in got["lines"])
    assert any("mesh=(('data', 2), ('model', 4))" in line
               for line in got["lines"])
