"""Training the encdec, vlm and MoE families over the reference's GSPMD
mesh in the port against the JAX package's own GSPMD step and the
port's single-rank step, on the CPU: whisper-large-v3 and
llama-3.2-vision-11b over ``(2, 4)`` (fsdp over the data axis, tensor
parallelism over the model axis), olmoe-1b-7b over ``(8, 1)`` (fsdp
only; its experts over the model axis are ``test_torch_ep_train.py``'s).

The reference side runs once, in a subprocess that fabricates 8 host
devices before jax is imported (``torch_tp_train_families_ref.main``),
while the port's side runs in one gloo world of 8 ranks
(``torch_tp_train_families_ranks.world``). Inputs are the reference's
own smoke params (the vlm's cross gates opened to 0.5: closed, the image
would change nothing) and a seeded batch with seeded normal frames and
image embeddings (zero frames overflow whisper's LayerNorm backward,
F11), made here and in the subprocess alike.

* The port's step on the reference's mesh gives the reference's own
  step there (tree TVLARS for every arch, fused for the vlm) within
  that test's bounds (loss rtol 1e-3; params rtol 2e-2, atol 2e-3),
  ``grad_norm`` and the layer-wise norms within rtol 1e-3, and the MoE
  ``load_balance`` within rtol 1e-4: its two means are the global
  batch's, as the reference's GSPMD step takes them.
* The port's ``(2, 2)`` step on the world's first 4 ranks (the MoE's
  ``(8, 1)`` one) gives its single-rank f32 step within 1e-5.
* A control exceeds the ``load_balance`` bound: each data row's means
  of its block, averaged over the rows (the mesh-native data axis's
  rule), differ from the global batch's.
* The ranks that hold the same block hold the same bits; a state saved
  on the reference's mesh restores in the JAX package with the
  reference's provenance.
* ``launch.train`` trains the three archs on the world's 8 ranks
  (``--mesh-model 4 --mesh-data 2``; the MoE ``--data-parallel 8``)
  and prints the single-rank run's losses.
"""
from __future__ import annotations

import pytest

import torch_tp_train_families_ref as ref_side
from repro_torch.launch import train

GROUP = "cross"
ARCHS = [arch for arch, _, _ in ref_side.FILES[GROUP]]
MOE = "olmoe-1b-7b"
CONTROLS = {MOE: ("moe-per-shard",)}
LAUNCH = ["--smoke", "--device", "cpu", "--steps", "2", "--seq", "16",
          "--global-batch", "8", "--use-kernel", "fused"]
MESH = {arch: ["--data-parallel", "8"] if arch == MOE
        else ["--mesh-model", "4", "--mesh-data", "2"] for arch in ARCHS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ref_side.collect(
        GROUP, str(tmp_path_factory.mktemp("tp_cross")), CONTROLS,
        tuple(["--arch", arch] + LAUNCH + MESH[arch] for arch in ARCHS))


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_inputs_are_the_tests(runs, arch):
    ref_side.check_inputs(runs, arch)


@pytest.mark.parametrize("arch,case", ref_side.cases(GROUP))
def test_mesh_step_matches_the_references_mesh_step(runs, arch, case):
    ref_side.check_mesh_step(runs, arch, case)


@pytest.mark.parametrize("arch,mesh,case", ref_side.single_cases(GROUP))
def test_mesh_step_matches_the_single_rank_step(runs, arch, mesh, case):
    ref_side.check_single(runs, arch, mesh, case)


def test_per_shard_moe_means_exceed_the_load_balance_bound(runs):
    gap = ref_side.control_gap(runs, MOE, "moe-per-shard", "load_balance")
    assert gap > ref_side.BOUNDS["load_balance"], gap


def test_moe_load_balance_is_live(runs):
    """The MoE step's load balance is the aux loss of a routed batch
    (E · Σ me · ce ≈ 1 a layer at a uniform router), not a zero that
    would pass any bound."""
    got = runs["worlds"][0][f"{MOE}/8x1"]["tree"]["load_balance"]
    assert 1.0 < float(got) < 4.0, got


def test_ranks_hold_equal_replicas(runs):
    for r in runs["worlds"]:
        for key, got in r.items():
            if "/" in key and not key.startswith("launch/"):
                for case in ("tree", "fused"):
                    if case in got:
                        assert got[case]["replicas_equal"], (key, case)


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
