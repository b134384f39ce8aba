"""Training over the model axis in the port on the smallest meshes and
through the launcher, against the port's own single-rank runs, on the
CPU (the reference's ``(2, 4)`` step and checkpoints are
``test_torch_tp_train.py``'s).

* A ``(1, 2)`` world of gloo ranks (``torch_tp_train_ranks``) steps
  tree and fused TVLARS, per-tensor WA-LARS and fused TVLARS over K = 2
  microbatches: each gives the single-rank f32 step (loss rtol 1e-5,
  params atol 1e-5, the norms rtol 1e-5), and the ranks that hold the
  same block hold the same bits.
* ``launch.train --mesh-model 2 --mesh-data 2`` (spawning its 4 ranks)
  and the reference's GSPMD ``--data-parallel 2`` (joining the ``(1,
  2)`` world's 2 ranks) print the single-rank run's losses within 1e-5
  and check their replicas.
* The MoE family trains at model > 1 (expert parallelism, ROADMAP
  item 11d, no longer refused) in each spelling of the model axis,
  with the single-rank run's losses (``test_torch_ep_train.py`` holds
  it against the reference's own step); the adaptive batch on the
  GSPMD path is refused with the reference's message.
"""
from __future__ import annotations

import re

import numpy as np
import pytest

import torch_tp_train_ranks as ranks
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train

TIMEOUT_S = 180
CASES = ("tree", "fused", "per_tensor", "fused-k2")
SMOKE = ["--smoke", "--device", "cpu", "--steps", "2", "--seq", "32",
         "--global-batch", "8", "--microbatch", "4", "--use-kernel",
         "fused"]


JOINED = ["--data-parallel", "2"]       # run inside the (1, 2) world
# the MoE family in each spelling of the model axis: one step, against
# the single-rank run; the 2-rank spellings run inside the (1, 2) world
MOE_SMOKE = ["--smoke", "--device", "cpu", "--steps", "1", "--seq", "16",
             "--global-batch", "8", "--use-kernel", "fused"]
MOE_SPELLINGS = [
    ("olmoe-1b-7b", ["--mesh-model", "2"], "11d"),
    ("olmoe-1b-7b", ["--model-parallel", "2"], "11d"),
    ("qwen3-moe-30b-a3b", ["--mesh-model", "2", "--mesh-data", "2"],
     "11d"),
    ("olmoe-1b-7b", ["--data-parallel", "2", "--mesh-model", "4"],
     "11d")]
IN_WORLD = [["--arch", arch] + MOE_SMOKE + argv
            for arch, argv, _ in MOE_SPELLINGS[:2]]


@pytest.fixture(scope="module")
def runs():
    params, batch = ranks.port_inputs()
    single = {case: ranks.step(params, batch, case) for case in CASES}
    world = mesh_lib.spawn(ranks.world, 2, "gloo", "cpu",
                           args=(1, 2, params, batch, CASES, (), "", 1,
                                 (SMOKE + JOINED, *IN_WORLD)),
                           timeout=TIMEOUT_S)
    one = train.run(SMOKE, log_fn=lambda *a: None)["losses"]
    return {"single": single, "world": world, "one": one}


def _gaps(got: dict, want: dict) -> dict:
    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
                            * (np.abs(a - b) > 0)))
    return {"loss": rel(got["loss"], want["loss"]),
            "params": max(float(np.abs(a - b).max())
                          for a, b in zip(got["params"], want["params"])),
            "norms": max(rel(got[n], want[n]) for n in ranks.METRICS[1:])}


@pytest.mark.parametrize("case", CASES)
def test_1x2_step_matches_the_single_rank_step(runs, case):
    gaps = _gaps(runs["world"][0][case], runs["single"][case])
    assert gaps["loss"] <= 1e-5 and gaps["params"] <= 1e-5 \
        and gaps["norms"] <= 1e-5, gaps
    for r in runs["world"]:
        assert r[case]["replicas_equal"]
        calls = r[case]["collectives"]
        # one table, one grad norm; no data column at D = 1
        assert calls["norm_table"] == 1 and calls["grad_norm"] == 1
        assert "fsdp_gather" not in calls and "column_reduce" not in calls


def _losses(text: str) -> list:
    return [float(x) for x in re.findall(r"step +\d+ loss=([-\d.]+)", text)]


@pytest.mark.parametrize("argv,ranks_", [
    (["--mesh-model", "2", "--mesh-data", "2"], 4),
    (JOINED, 2)], ids=["mesh-2x2", "data-parallel-2"])
def test_launcher_prints_the_single_rank_losses(runs, capfd, argv, ranks_):
    """The 2x2 run spawns its ranks; the data-parallel one runs on the
    ranks of the module's (1, 2) world, its console rank 0's lines."""
    one = runs["one"]
    if argv is JOINED:
        got = runs["world"][0]["launch/0"]
        out = "\n".join(got["lines"])
    else:
        got = train.run(SMOKE + argv)
        out = capfd.readouterr().out
    np.testing.assert_allclose(got["losses"], one, rtol=1e-5)
    np.testing.assert_allclose(_losses(out), np.round(one, 4), atol=1e-4)
    assert got["world"] == ranks_
    assert f"replicas bitwise equal: {ranks_} ranks" in out
    d = 2 if "--data-parallel" in argv else int(argv[3])
    m = 2 if "--mesh-model" in argv else 1
    assert f"mesh=(('data', {d}), ('model', {m}))" in out


@pytest.mark.parametrize("arch,argv,item", MOE_SPELLINGS)
def test_unported_families_name_their_roadmap_item(runs, capfd, arch, argv,
                                                  item):
    """Item 11d (expert parallelism) is ported: the MoE family trains at
    model > 1 in each spelling of the model axis, one step with the
    single-rank run's loss (rtol 1e-5) and its replicas checked. The
    2-rank spellings run in the module's (1, 2) world; the others spawn
    their ranks."""
    line = ["--arch", arch] + MOE_SMOKE + argv
    one = train.run(["--arch", arch] + MOE_SMOKE,
                    log_fn=lambda *a: None)["losses"]
    if line in IN_WORLD:
        got = runs["world"][0][f"launch/{1 + IN_WORLD.index(line)}"]
        lines = got["lines"]
    else:
        capfd.readouterr()
        got = train.run(line)
        lines = capfd.readouterr().out.splitlines()
    np.testing.assert_allclose(got["losses"], one, rtol=1e-5)
    ranks_ = 1
    for flag in ("--mesh-model", "--model-parallel", "--mesh-data",
                 "--data-parallel"):
        if flag in argv:
            ranks_ *= int(argv[argv.index(flag) + 1])
    assert any(f"replicas bitwise equal: {ranks_} ranks" in ln
               for ln in lines), lines


def test_adaptive_batch_on_the_gspmd_path_is_refused_as_the_reference():
    with pytest.raises(SystemExit, match="GSPMD fsdp\\+TP path has no "
                                         "re-stack boundary"):
        train.run(SMOKE + ["--mesh-model", "2", "--adaptive-batch"])
