"""Training the ssm and hybrid families over the model axis in the port
(fsdp over the data axis, tensor parallelism over the model axis, on a
``(D, M)`` mesh over ``torch.distributed``) against the JAX package's
own GSPMD step and the port's single-rank step, on the CPU.

The reference side runs once, in a subprocess that fabricates 8 host
devices before jax is imported (``torch_tp_train_families_ref.main``),
while the port's side runs in one gloo world of 8 ranks
(``torch_tp_train_families_ranks.world``). Inputs are the reference's
own smoke params (mamba2 at 6 blocks, so that fsdp gives the data axis
to the stacked dim of its ``conv_w`` / ``conv_b`` as at full size) and
a seeded batch, made here and in the subprocess alike.

* The port's ``(2, 4)`` step gives the reference's own ``(2, 4)`` step
  on ``make_data_mesh(2, 4)`` (tree TVLARS for both archs, fused for
  mamba2) within that test's bounds (loss rtol 1e-3; params rtol 2e-2,
  atol 2e-3), ``grad_norm`` and the layer-wise norms within rtol 1e-3.
* The port's ``(2, 2)`` step on the world's first 4 ranks gives its
  single-rank f32 step within 1e-5.
* Two controls exceed their bounds: one ``copy_to_row`` left out
  before a rank-split Mamba2 input (the conv's: ``g_norm``), and a
  leaf whose data axis the reference put on a stacked dim counted by
  every data row in the norm table (``w_norm``).
* The ranks that hold the same block hold the same bits; a state saved
  at ``(2, 4)`` restores in the JAX package with the reference's
  provenance, the stacked-dim leaves included.
* ``launch.train`` trains both archs on a ``(2, 4)`` mesh of the world
  and prints the single-rank run's losses.
"""
from __future__ import annotations

import pytest

import torch_tp_train_families_ref as ref_side
from repro_torch.launch import train

GROUP = "families"
ARCHS = [arch for arch, _, _ in ref_side.FILES[GROUP]]
CONTROLS = {"mamba2-1.3b": ("ssm-copy-missing", "stacked-dim-counted")}
LAUNCH = ["--smoke", "--device", "cpu", "--steps", "2", "--seq", "16",
          "--global-batch", "8", "--use-kernel", "fused"]
MESH = ["--mesh-model", "4", "--mesh-data", "2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ref_side.collect(
        GROUP, str(tmp_path_factory.mktemp("tp_families")), CONTROLS,
        tuple(["--arch", arch] + LAUNCH + MESH for arch in ARCHS))


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_inputs_are_the_tests(runs, arch):
    ref_side.check_inputs(runs, arch)


@pytest.mark.parametrize("arch,case", ref_side.cases(GROUP))
def test_mesh_step_matches_the_references_mesh_step(runs, arch, case):
    ref_side.check_mesh_step(runs, arch, case)


@pytest.mark.parametrize("arch,mesh,case", ref_side.single_cases(GROUP))
def test_mesh_step_matches_the_single_rank_step(runs, arch, mesh, case):
    ref_side.check_single(runs, arch, mesh, case)


@pytest.mark.parametrize("control,metric,bound", [
    ("ssm-copy-missing", "layerwise/g_norm", ref_side.BOUNDS["norms"]),
    ("stacked-dim-counted", "layerwise/w_norm", ref_side.BOUNDS["norms"])])
def test_each_fault_exceeds_its_bound(runs, control, metric, bound):
    gap = ref_side.control_gap(runs, "mamba2-1.3b", control, metric)
    assert gap > bound, (control, gap)


def test_ranks_hold_equal_replicas(runs):
    for r in runs["worlds"]:
        for key, got in r.items():
            if "/" in key and not key.startswith("launch/"):
                for case in ("tree", "fused"):
                    if case in got:
                        assert got[case]["replicas_equal"], (key, case, r)


def test_stacked_dim_leaves_are_the_conv_leaves(runs):
    """Where the reference's fsdp rule picks a stacked dim (mamba2's
    [6, 4, 288] conv_w and [6, 288] conv_b, zamba2's groups' [2, 2,
    288] conv_b, at D = 2), the port's per-block leaf stays whole over
    the data column; zamba2's trailing [1, 288] conv_b has no such
    pick."""
    picks = runs["worlds"][0]["mamba2-1.3b/2x4"]["tree"]["stacked_picks"]
    assert picks == sorted(f"blocks/{i}/mamba/{leaf}" for i in range(6)
                           for leaf in ("conv_b", "conv_w"))
    assert runs["worlds"][0]["zamba2-1.2b/2x4"]["tree"][
        "stacked_picks"] == [f"blocks/{i}/mamba/conv_b" for i in range(4)]


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_restores_in_jax_with_the_references_provenance(
        runs, arch):
    ref_side.check_checkpoint(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_over_the_mesh(runs, arch):
    one = train.run(["--arch", arch] + LAUNCH,
                    log_fn=lambda *a: None)["losses"]
    got = runs["worlds"][0][f"launch/{ARCHS.index(arch)}"]
    assert got["losses"] == pytest.approx(one, rel=1e-5)
    assert any("replicas bitwise equal: 8 ranks" in line
               for line in got["lines"])
