"""The port's data-parallel probes and the controller's data axis against
the JAX package's ``shard_map`` results, on the CPU.

The reference side runs once, in a subprocess that fabricates 8 host
devices before jax is imported (``torch_mesh_ref.probes``); the port's
side in one gloo world of 4 ranks (``torch_mesh_ranks.probes_world``),
on the reference's own params, batches, Lanczos seed and samples.

* ``gradient_noise_scale`` at D = 2, K = 1 (a mesh of the world's first
  two ranks; ranks 2 and 3 take part and are ignored) against the
  reference's ``(2, 1)`` result and its single-device K = 2 twin, both
  within the reference's own 1e-4 (a ratio of differences of squared
  norms), every rank holding the same numbers.
* Lanczos and SAM at D = 4, K = 2: λ_max from the reference's ``v0``
  (the port's own draws differ, ROADMAP F5) within the reference's
  1e-4, the Hessian product of ``v0`` within ``parity_tolerance("f32")``
  at its scale and bitwise equal on every rank, SAM within the
  reference's 1e-6.
* ``test_controller_retargets_data_axis``'s scenario on a world of 4:
  global batches ``[2, 2, 2, 16, 16, 16, 16, 2, 2, 16]``, every
  switch's ``controller/lr`` equal to ``batch_scaled_lr``, steps built
  for (1, 1) and (4, 2) only, three switches, one optimizer call per
  rank per step, the ranks bitwise equal after every step, and the
  final state against the reference's run.
"""
from __future__ import annotations

import math

import jax
import numpy as np
import pytest

import torch_mesh_ranks as ranks
import torch_mesh_ref as ref_side
from repro.core import flatten as jflatten
from repro.diagnostics import hvp as jhvp
from repro_torch.core import schedules
from repro_torch.kernels import ref
from repro_torch.launch import mesh as mesh_lib
from test_torch_mesh import (TIMEOUT_S, f64, finish_reference, leaves,
                             np_tree, start_reference)

F32 = ref.parity_tolerance("f32")


def inputs() -> dict:
    params = ref_side.mlp_params()
    spec = jflatten.build_spec(params)
    v0 = jhvp.padding_mask(spec) * jax.random.normal(
        jax.random.PRNGKey(0), (spec.num_rows, jflatten.LANES))
    return {"mlp": np_tree(params),
            "mlp-batch-16": np_tree(ref_side.mlp_batch(16)),
            "v0": np.asarray(v0),
            "samples": np_tree(ref_side.controller_samples()),
            "mb": ref_side.MB, "readings": ref_side.READINGS,
            "steps": ref_side.CONTROLLER_STEPS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh_probes") / "ref.npz")
    proc = start_reference("probes", out)
    try:
        ins = inputs()
        world = mesh_lib.spawn(ranks.probes_world, 4, "gloo", "cpu",
                               args=(ins,), timeout=TIMEOUT_S)
        reference = finish_reference(proc, out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return {"ref": reference, "world": world, "inputs": ins}


def test_reference_inputs_are_the_tests(runs):
    for a, b in zip(leaves(runs["ref"], "inputs/mlp"),
                    jax.tree_util.tree_leaves(runs["inputs"]["mlp"])):
        assert np.array_equal(a, b)
    assert np.array_equal(runs["ref"]["lanczos/v0"], runs["inputs"]["v0"])


@pytest.mark.parametrize("twin", ["gns-D2-K1", "gns-D1-K2"])
def test_gradient_noise_scale_at_two_ranks_matches_the_reference(runs,
                                                                 twin):
    got = runs["world"][0]["gns"]
    for name in ("grad_noise_scale", "grad_sq", "trace_cov"):
        np.testing.assert_allclose(got[name],
                                   float(runs["ref"][f"{twin}/{name}"]),
                                   rtol=1e-4, err_msg=name)
    assert all(r["gns_equal"] for r in runs["world"])


def test_lanczos_under_the_mesh_matches_the_reference(runs):
    got = runs["world"][0]
    np.testing.assert_allclose(got["lambda_max"],
                               float(runs["ref"]["lanczos/lambda_max"]),
                               rtol=1e-4)
    want = runs["ref"]["lanczos/hv0"]
    np.testing.assert_allclose(f64(got["hv0"]), f64(want), rtol=F32["rtol"],
                               atol=F32["atol"] * float(np.abs(want).max()))
    assert all(r["hv0_equal"] for r in runs["world"])


def test_sam_under_the_mesh_matches_the_reference(runs):
    got = runs["world"][0]["sam"]
    for name in ("sam_sharpness", "loss", "perturbed_loss"):
        np.testing.assert_allclose(got[name],
                                   float(runs["ref"][f"sam/{name}"]),
                                   atol=1e-6, err_msg=name)
    assert all(r["sam_equal"] for r in runs["world"])


def _records(records: list, train: bool) -> list:
    return [r for r in records if ("loss" in r) == train]


def test_controller_retargets_the_data_axis_like_the_reference(runs):
    got = runs["world"][0]["controller"]
    want = runs["ref"]["json"]["controller"]
    batches = [r["global_batch"] for r in _records(got["records"], True)]
    assert batches == [2.0, 2.0, 2.0, 16.0, 16.0, 16.0, 16.0, 2.0, 2.0,
                       16.0]
    assert batches == [r["global_batch"]
                       for r in _records(want["records"], True)]
    ours = _records(got["records"], False)
    theirs = _records(want["records"], False)
    assert len(ours) == len(theirs) == 5
    for a, b in zip(ours, theirs):
        for key in ("b_noise", "global_batch", "accum_steps",
                    "data_parallel", "changed", "step_cached"):
            assert a[f"controller/{key}"] == b[f"controller/{key}"], key
        gb = int(a["controller/global_batch"])
        assert math.isclose(a["controller/lr"], schedules.batch_scaled_lr(
            1.0, gb, 64, "sqrt"), rel_tol=1e-12)
        assert math.isclose(a["controller/lr"], b["controller/lr"],
                            rel_tol=1e-12)
        assert gb == a["controller/data_parallel"] * \
            a["controller/accum_steps"] * ref_side.MB
    assert got["visited"] == want["visited"] == [[1, 1], [4, 2]]
    assert got["compiles"] == want["compiles"] == 2
    assert got["switches"] == want["switches"] == 3


def test_controller_keeps_the_ranks_equal_with_one_optimizer_call(runs):
    per_rank = [r["controller"] for r in runs["world"]]
    assert all(r["equal"] for r in per_rank)
    for r in per_rank:
        assert r["calls"] == list(range(1, ref_side.CONTROLLER_STEPS + 1))


def test_controller_final_state_matches_the_reference(runs):
    got = runs["world"][0]["controller"]["state"]
    want = leaves(runs["ref"], "controller/state")
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        b = f64(b)
        np.testing.assert_allclose(f64(a), b, rtol=F32["rtol"],
                                   atol=F32["atol"] * float(np.abs(b).max()),
                                   err_msg=f"leaf {i}")
