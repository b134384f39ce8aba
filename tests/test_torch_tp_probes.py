"""The Lanczos probe over the reference's GSPMD mesh in the port
(``LanczosProbe(placement=)``: the state and the Lanczos vectors hold
each rank's blocks, the Hessian-vector product differentiates the loss
twice through the row's and the column's autograd collectives), against
the port's single-rank probe, on the CPU.

Inputs are the reference's own params and batch of the tensor-parallel
training tests (``torch_tp_train_ref.inputs``: the reference test's
``SCRIPT`` model with seeded QKV biases, 4 heads and 2 KV heads). A
world of 4 gloo ranks runs the probe on a ``(2, 2)`` mesh.

* The ``(2, 2)`` probe's λ_max gives the single-rank one from the same
  seed vector (each rank's blocks of the single-rank ``v0``) within rtol
  1e-4: after 4 iterations λ_max still depends on ``v0`` (F5), so only
  the same ``v0`` makes the two comparable; what is left is the two
  orders of summation of f32 products.
* The same on mamba2 at ``(2, 2)`` (its second order through the
  gathered projection and the rank's blocks) and olmoe at ``(4, 1)``
  (through the MoE aux's column means), from the reference's smoke
  params.
* A control with the row's backwards as first-order code
  (``copy_to_row``'s an in-place sum over the row, ``sum_over_row``'s
  the gradient itself, ``gather_row``'s a plain slice) exceeds that
  bound: ``sum_over_row``'s identity drops the sum over the row that
  the second order needs where the product passes back through it
  (``copy_to_row``'s in-place sum alone does not show on an f32 CPU
  tensor: its second order is the identity, which is right).
* ``launch.train --smoke --device cpu --mesh-model 2 --probe-every 1``
  (spawning its 2 ranks) and ``--mesh-model 2 --mesh-data 2`` (in the
  world) print the single-rank run's probe lines.
"""
from __future__ import annotations

import re

import numpy as np
import pytest

import torch_tp_train_families_ranks as ranks
import torch_tp_train_families_ref as families_ref
import torch_tp_train_ref as ref_side
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train

RTOL = 1e-4
TIMEOUT_S = 180
SMOKE = ["--smoke", "--device", "cpu", "--steps", "2", "--seq", "32",
         "--global-batch", "4", "--probe-every", "1", "--probe-iters",
         "4"]


# families whose second order passes other functions: mamba2's gathered
# projection and rank blocks (gather_row's backward and its own), the
# MoE aux's column means
FAMILIES = {"mamba2-1.3b": (2, 2), "olmoe-1b-7b": (4, 1)}


@pytest.fixture(scope="module")
def runs():
    params, batch = ref_side.inputs()
    single = {"dense": ranks.probe("dense", params, batch)}
    jobs = [("dense", params, batch, (2, 2), ("probe",),
             ("first-order-row",))]
    for arch, mesh in FAMILIES.items():
        p, b = families_ref.inputs(arch)
        single[arch] = ranks.probe(arch, p, b)
        jobs.append((arch, p, b, mesh, ("probe",), ()))
    world = mesh_lib.spawn(
        ranks.world, 4, "gloo", "cpu",
        args=(tuple(jobs), "",
              (SMOKE + ["--mesh-model", "2", "--mesh-data", "2"],)),
        timeout=TIMEOUT_S)
    one = train.run(SMOKE, log_fn=lambda *a: None)
    return {"single": single, "world": world, "one": one}


def test_2x2_probe_gives_the_single_rank_lambda_max(runs):
    got = [r["dense/2x2"]["probe"] for r in runs["world"]]
    assert len(set(got)) == 1, got            # every rank the same
    np.testing.assert_allclose(got[0], runs["single"]["dense"], rtol=RTOL)
    assert runs["single"]["dense"] > 0


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_family_probe_gives_the_single_rank_lambda_max(runs, arch):
    d, m = FAMILIES[arch]
    got = [r[f"{arch}/{d}x{m}"]["probe"] for r in runs["world"]]
    assert len(set(got)) == 1, got
    np.testing.assert_allclose(got[0], runs["single"][arch], rtol=RTOL)


def test_first_order_row_backwards_exceed_the_bound(runs):
    got = runs["world"][0]["dense/2x2"]["first-order-row"]
    want = runs["single"]["dense"]
    assert abs(got - want) / abs(want) > RTOL, (got, want)


def _probe_lines(text: str) -> list:
    return re.findall(r"step +\d+ probe lanczos/lambda_max=[-\d.]+", text)


def test_launcher_probes_the_2x2_mesh_as_one_rank(runs):
    got = runs["world"][0]["launch/0"]
    want = [r["lanczos/lambda_max"] for r in runs["one"]["probes"]]
    np.testing.assert_allclose(
        [r["lanczos/lambda_max"] for r in got["probes"]], want, rtol=RTOL)
    assert _probe_lines("\n".join(got["lines"])) == [
        f"step {i:4d} probe lanczos/lambda_max={x:.4f}"
        for i, x in enumerate(want)]


def test_launcher_probe_lines_on_the_model_axis(runs, capfd):
    """The CLI spelling: the ranks spawned by the launcher, rank 0's
    console."""
    got = train.run(SMOKE + ["--mesh-model", "2"])
    out = capfd.readouterr().out
    want = [r["lanczos/lambda_max"] for r in runs["one"]["probes"]]
    np.testing.assert_allclose(
        [r["lanczos/lambda_max"] for r in got["probes"]], want, rtol=RTOL)
    assert _probe_lines(out) == [
        f"step {i:4d} probe lanczos/lambda_max={x:.4f}"
        for i, x in enumerate(want)]
