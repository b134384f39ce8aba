"""Training over the model axis in the port (fsdp over the data axis,
tensor parallelism over the model axis, on a ``(D, M)`` mesh over
``torch.distributed``) against the JAX package's own GSPMD step and the
port's single-rank step, on the CPU.

The reference side runs once, in a subprocess that fabricates 8 host
devices before jax is imported (``torch_tp_train_ref.main``), while the
port's side runs in gloo worlds of 8 and 4 ranks, spawned once each
(``torch_tp_train_ranks``). Inputs are the reference's own params (the
reference test's ``SCRIPT`` model with seeded QKV biases) and batch,
made here and in the subprocess from the same keys.

* The port's ``(2, 4)`` step on 8 ranks gives the reference's own
  ``(2, 4)`` step on ``make_data_mesh(2, 4)``, tree and fused TVLARS,
  within that test's bounds (loss rtol 1e-3; params rtol 2e-2, atol
  2e-3), and ``grad_norm`` and the layer-wise ``w_norm`` / ``g_norm`` /
  ``trust_ratio`` within rtol 1e-3.
* The port's ``(2, 4)`` and ``(2, 2)`` steps give its single-rank f32
  step (loss rtol 1e-5, params atol 1e-5; the norms rtol 1e-5), tree,
  fused and per-tensor WA-LARS; four controls, each with one fault put
  in, exceed those bounds: the QKV biases' or the whole ``wk`` /
  ``wv``'s gradient left unsummed over the row, the norm table summed
  with every rank counted, the fsdp gather's backward not divided by D.
* The ranks that hold the same block of a leaf hold the same bits, and
  the step makes one collective for the optimizer's norm table.
* A state saved at ``(2, 4)`` and at ``(2, 2)`` (``checkpoint
  .save_train_state``) restores in the JAX package to the gathered
  state, and its provenance is the reference's for the same state on
  the same mesh.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import torch_tp_train_ranks as ranks
import torch_tp_train_ref as ref_side
from repro_torch.launch import mesh as mesh_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
WORLDS = {(2, 4): (("tree", "fused"), ranks.CONTROLS),
          (2, 2): (("tree", "fused", "per_tensor"), ())}
F32 = dict(loss=1e-5, params=1e-5, norms=1e-5)


def _start_reference(out: str) -> subprocess.Popen:
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
        + " --xla_cpu_multi_thread_eigen=false").strip(),
        OMP_NUM_THREADS="1",
        PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                    os.path.join(ROOT, "tests")]))
    return subprocess.Popen(
        [sys.executable, "-c",
         f"import torch_tp_train_ref as r; r.main({out!r})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    out = str(tmp / "ref.npz")
    proc = _start_reference(out)
    try:
        params, batch = ref_side.inputs()
        single = {case: ranks.step(params, batch, case)
                  for case in ranks.CASES}
        worlds = {mesh: mesh_lib.spawn(
            ranks.world, mesh[0] * mesh[1], "gloo", "cpu",
            args=(*mesh, params, batch, cases, controls, str(tmp)),
            timeout=TIMEOUT_S)
            for mesh, (cases, controls) in WORLDS.items()}
        log, _ = proc.communicate(timeout=TIMEOUT_S)
        assert proc.returncode == 0, log.decode()[-4000:]
        with np.load(out) as z:
            reference = {k: z[k] for k in z.files}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return {"ref": reference, "worlds": worlds, "single": single,
            "params": params, "batch": batch, "root": str(tmp)}


def _leaves(res: dict, key: str) -> list:
    n = sum(1 for k in res if k.startswith(key + "/")
            and k[len(key) + 1:].isdigit())
    return [res[f"{key}/{i}"] for i in range(n)]


def test_reference_inputs_are_the_tests(runs):
    """The subprocess and the test process made the same params and
    tokens, and the biases are not zero."""
    ref = runs["ref"]
    mine = jax.tree_util.tree_leaves(runs["params"])
    theirs = _leaves(ref, "inputs/params")
    assert len(mine) == len(theirs) == 15
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(runs["batch"]["tokens"],
                                  ref["inputs/tokens"])
    bq = runs["params"]["groups"]["l0_attn"]["attn"]["bq"]
    assert np.abs(bq).min() > 0


@pytest.mark.parametrize("case", ["tree", "fused"])
def test_mesh_step_matches_the_references_mesh_step(runs, case):
    """(2, 4): the port on 8 gloo ranks against the reference's own GSPMD
    step on make_data_mesh(2, 4), within the reference test's bounds;
    grad_norm and the layer-wise norms within rtol 1e-3."""
    got = runs["worlds"][(2, 4)][0][case]
    ref = runs["ref"]
    key = f"{case}/mesh"
    np.testing.assert_allclose(got["loss"], ref[f"{key}/loss"], rtol=1e-3)
    theirs = _leaves(ref, f"{key}/params")
    assert len(got["params"]) == len(theirs) == 15
    for a, b in zip(got["params"], theirs):
        np.testing.assert_allclose(a, b, rtol=2e-2, atol=2e-3)
    for name in ranks.METRICS[1:]:
        np.testing.assert_allclose(got[name], ref[f"{key}/{name}"],
                                   rtol=1e-3, err_msg=name)


def _gaps(got: dict, want: dict) -> dict:
    """The largest gaps of a run to the single-rank run: the loss's
    relative gap, the params' absolute gap, the norms' relative gap."""
    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
                            * (np.abs(a - b) > 0)))
    return {"loss": rel(got["loss"], want["loss"]),
            "params": max(float(np.abs(a - b).max())
                          for a, b in zip(got["params"], want["params"])),
            "norms": max(rel(got[n], want[n]) for n in ranks.METRICS[1:])}


@pytest.mark.parametrize("mesh,case", [
    ((2, 4), "tree"), ((2, 4), "fused"), ((2, 2), "tree"),
    ((2, 2), "fused"), ((2, 2), "per_tensor")],
    ids=["2x4-tree", "2x4-fused", "2x2-tree", "2x2-fused",
         "2x2-per_tensor"])
def test_mesh_step_matches_the_single_rank_step(runs, mesh, case):
    gaps = _gaps(runs["worlds"][mesh][0][case], runs["single"][case])
    for name, bound in F32.items():
        assert gaps[name] <= bound, (name, gaps)


@pytest.mark.parametrize("control", ranks.CONTROLS)
def test_each_fault_exceeds_the_bounds(runs, control):
    """A fault in the reductions shows against the single-rank step: the
    unsummed bias / wk gradient and the undivided fsdp gradient in the
    params, the norm table without once-only weighting in the norms
    (the trust ratio hides it: both norms scale alike)."""
    gaps = _gaps(runs["worlds"][(2, 4)][0][control], runs["single"]["tree"])
    watched = "norms" if control == "table-unweighted" else "params"
    assert gaps[watched] > F32[watched], (control, gaps)
    assert gaps["norms"] > 1e3 * F32["norms"], (control, gaps)


def test_ranks_hold_equal_replicas_and_one_table_collective(runs):
    for mesh, (cases, _) in WORLDS.items():
        for r in runs["worlds"][mesh]:
            for case in cases:
                assert r[case]["replicas_equal"], (mesh, case, r["rank"])
                calls = r[case]["collectives"]
                assert calls["norm_table"] == 1, calls
                assert calls["grad_norm"] == 1, calls
                assert calls["column_reduce"] == 1, calls


def _jax_state(runs, case):
    from repro.configs.base import ModelConfig
    from repro.core import build_optimizer
    from repro.training.train_state import TrainState
    opt = build_optimizer("tvlars", **ref_side.HYPER,
                          use_kernel=ref_side.CASES[case])
    return TrainState.create(jax.tree_util.tree_map(np.asarray,
                                                    runs["params"]), opt)


@pytest.mark.parametrize("mesh", list(WORLDS), ids=["2x4", "2x2"])
@pytest.mark.parametrize("case", ["tree", "fused"])
def test_checkpoint_restores_in_jax_with_the_references_provenance(
        runs, case, mesh):
    from repro import checkpoint as jck
    path = os.path.join(runs["root"], f"{mesh[0]}x{mesh[1]}", case)
    like = _jax_state(runs, case)
    restored = jck.restore(path, like)
    saved = runs["worlds"][mesh][0][case]["saved"]
    leaves = jax.tree_util.tree_leaves(restored)
    assert len(leaves) == len(saved) == len(jax.tree_util.tree_leaves(like))
    for a, b in zip(leaves, saved):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    # the saved params are the single-rank step's
    n = len(runs["single"][case]["params"])
    for a, b in zip(leaves[1:1 + n], runs["single"][case]["params"]):
        np.testing.assert_allclose(np.asarray(a), b, atol=1e-5)
    want = json.loads(str(runs["ref"][f"{case}/provenance/"
                                      f"{mesh[0]}x{mesh[1]}"]))
    assert jck.saved_shardings(path) == want
