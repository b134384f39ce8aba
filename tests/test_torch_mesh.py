"""The port's data-parallel training (``make_train_step(mesh=)`` over
``torch.distributed``) against the JAX package's own ``shard_map`` step,
on the CPU.

The reference side runs once, in a subprocess that fabricates 8 host
devices before jax is imported (``torch_mesh_ref.steps``), while the
port's side runs in gloo worlds of 2 and 4 ranks, spawned once each
(``torch_mesh_ranks.steps_world``); both start from the reference's own
params and batches.

* The D-rank step against the reference's ``(D, 1)`` mesh step, for the
  classifier MLP and the dense smoke LM at D ∈ {2, 4}, K ∈ {1, 2} with
  fused TVLARS, and the MLP at D = 2 with per-tensor WA-LARS: params,
  momentum, loss, ``grad_norm``, ``layerwise/*`` and (MLP) LWN / LGN /
  LNR within ``parity_tolerance("f32")``, relative (ROADMAP F1), at
  each leaf's scale for params and momentum.
* Every rank's state is bitwise equal to rank 0's after the step, and
  the optimizer ran once per rank (its plain call counted: the 1 + 1
  kernel launches on the card).
* The mesh step equals the port's single-device step on the same global
  batch (the reference's ``test_shard_map_step_matches_single_device``
  statement, its 1e-6).
* A checkpoint saved from D = 2 (f32 and bf16_master state) has the
  reference's metadata from a ``(2, 1)`` mesh, restores bitwise at
  D = 1, at D = 4 on every rank, and into the JAX package's
  ``checkpoint.restore``; the restored state's next D = 4 step equals
  the single-device step from it.
* In process: ``shard_batch``'s and ``_check_divisible``'s messages equal
  the reference's, the mesh-size error, backend / device pairings that
  cannot work, ``snap_targets`` / ``decide_targets`` at D and
  ``ControllerConfig(data_max=4)``.
* ``launch.train --mesh-data 2`` (it spawns its ranks) prints the
  reference launcher's batch-arithmetic line; ``launch.serve
  --data-parallel 2`` gives equal tokens on both ranks.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401  (autouse)
import torch_mesh_ranks as ranks
import torch_mesh_ref as ref_side
from repro import checkpoint as jck
from repro.core import build_optimizer as jbuild
from repro.training import controller as jcontroller
from repro.training.train_state import TrainState as JTrainState
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.data import pipeline
from repro_torch.kernels import ref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.training import controller, trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
CASES = [(w, k, d, "fused") for w, k, d in ref_side.STEP_CASES] \
    + [(*ref_side.PER_TENSOR_CASE, "per_tensor")]
IDS = [f"{w}-K{k}-D{d}-{uk}" for w, k, d, uk in CASES]
F32 = ref.parity_tolerance("f32")


def start_reference(which: str, out: str) -> subprocess.Popen:
    """The reference's side in a fabricated-8-device subprocess, its
    compute on one thread: it shares the host with the other test
    workers and the port's ranks."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
        + " --xla_cpu_multi_thread_eigen=false").strip(),
        OMP_NUM_THREADS="1",
        PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                    os.path.join(ROOT, "tests")]))
    return subprocess.Popen(
        [sys.executable, "-c", f"import torch_mesh_ref as r; "
                               f"r.main({which!r}, {out!r})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def finish_reference(proc: subprocess.Popen, out: str) -> dict:
    try:
        log, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, log.decode()[-4000:]
    with np.load(out) as z:
        res = {k: z[k] for k in z.files}
    res["json"] = json.loads(str(res["json"]))
    return res


def leaves(res: dict, key: str) -> list:
    n = sum(1 for k in res if k.startswith(key + "/")
            and k[len(key) + 1:].isdigit())
    return [res[f"{key}/{i}"] for i in range(n)]


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def inputs() -> dict:
    """The reference's own params and batches, as numpy trees."""
    out = {"mlp": np_tree(ref_side.mlp_params()),
           "lm": np_tree(ref_side.lm_params())}
    for k in (1, 2):
        out[f"mlp-batch-{k}"] = np_tree(ref_side.mlp_batch(8 * k))
        out[f"lm-batch-{k}"] = np_tree(ref_side.lm_batch_of(8 * k))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    out = str(tmp / "ref.npz")
    proc = start_reference("steps", out)
    try:
        ins = inputs()
        ckpt = str(tmp / "ckpt")
        worlds = {d: mesh_lib.spawn(
            ranks.steps_world, d, "gloo", "cpu",
            args=(d, [c for c in CASES if c[2] == d], ins, ckpt),
            timeout=TIMEOUT_S) for d in (2, 4)}
        reference = finish_reference(proc, out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return {"ref": reference, "worlds": worlds, "inputs": ins,
            "ckpt": ckpt}


def f64(a) -> np.ndarray:
    """``a`` in f64; bf16 (or its uint16 bits) widened exactly."""
    a = np.asarray(a)
    if a.dtype == np.uint16 or str(a.dtype) == "bfloat16":
        bits = a.view(np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).astype(np.float64)
    return a.astype(np.float64)


def _close(got, want, tol, msg=""):
    """Within ``tol`` relative, with its atol at ``want``'s scale."""
    got, want = f64(got), f64(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * max(scale, 1e-30),
                               err_msg=msg)


def test_reference_inputs_are_the_tests(runs):
    """The subprocess and the test process made the same inputs."""
    for w in ("mlp", "lm"):
        for a, b in zip(leaves(runs["ref"], f"inputs/{w}"),
                        jax.tree_util.tree_leaves(runs["inputs"][w])):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mesh_step_matches_the_reference_shard_map_step(runs, case):
    w, k, d, uk = case
    key = f"{w}-K{k}-D{d}-{uk}"
    got = runs["worlds"][d][0][key]
    want = runs["ref"]
    _close(got["loss"], want[f"{key}/loss"], F32, msg="loss")
    _close(got["grad_norm"], want[f"{key}/grad_norm"], F32, msg="grad_norm")
    for name in ("w_norm", "g_norm", "trust_ratio"):
        _close(got[name], want[f"{key}/layerwise/{name}"], F32, msg=name)
    if w == "mlp":
        for name in ("lwn", "lgn", "lnr"):
            _close(got[name], want[f"{key}/{name}"], F32, msg=name)
    for i, (a, b) in enumerate(zip(got["params"],
                                   leaves(want, f"{key}/params"))):
        _close(a, b, F32, msg=f"param {i}")
    ref_opt = leaves(want, f"{key}/opt_state")
    assert len(got["opt_state"]) == len(ref_opt)
    for i, (a, b) in enumerate(zip(got["opt_state"], ref_opt)):
        _close(a, b, F32, msg=f"opt_state {i}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ranks_bitwise_equal_and_one_optimizer_call_per_rank(runs, case):
    w, k, d, uk = case
    per_rank = [r[f"{w}-K{k}-D{d}-{uk}"] for r in runs["worlds"][d]]
    assert len(per_rank) == d
    assert all(r["equal"] for r in per_rank)
    single = per_rank[0]["single_calls"]
    assert single == 1          # fused, and the per-tensor pass
    assert [r["calls"] for r in per_rank] == [single] * d


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mesh_step_equals_the_single_device_step(runs, case):
    w, k, d, uk = case
    got = runs["worlds"][d][0][f"{w}-K{k}-D{d}-{uk}"]
    np.testing.assert_allclose(got["loss"], got["single_loss"], rtol=1e-6)
    for a, b in zip(got["params"], got["single_params"]):
        np.testing.assert_allclose(a, b, atol=1e-6)


PRECISIONS = ["f32", "bf16_master"]


@pytest.mark.parametrize("precision", PRECISIONS)
def test_checkpoint_from_two_ranks_has_the_reference_metadata(runs,
                                                             precision):
    want = runs["ref"]["json"][f"ckpt-{precision}"]
    with open(os.path.join(runs["ckpt"], precision, "meta.json")) as f:
        got = json.load(f)
    for key in ("num_leaves", "step", "dtypes", "shapes", "shardings"):
        assert got[key] == want[key], key
    assert got["shardings"]["leaf_0"] == {
        "spec": "PartitionSpec()", "mesh": {"data": 2, "model": 1}}
    # the saved state is the reference's (2, 1) state after the step
    saved = runs["worlds"][2][0][f"saved-{precision}"]["state"]
    ref_state = leaves(runs["ref"], f"ckpt-{precision}/state")
    assert len(saved) == len(ref_state)
    for i, (a, b) in enumerate(zip(saved, ref_state)):
        _close(a, b, ref.parity_tolerance(precision), msg=f"leaf {i}")


@pytest.mark.parametrize("precision", PRECISIONS)
def test_checkpoint_restores_at_one_and_four_ranks(runs, precision):
    from repro_torch.training.train_state import fingerprint
    saved = runs["worlds"][2][0][f"saved-{precision}"]
    path = os.path.join(runs["ckpt"], precision)
    task, opt, params = ranks._setup("mlp", runs["inputs"], "fused",
                                     precision)
    got = ck.restore_train_state(path, ranks.TrainState.create(params, opt),
                                 device="cpu")
    assert fingerprint(got) == saved["fingerprint"]
    four = [r[f"restored-{precision}"] for r in runs["worlds"][4]]
    assert all(r["equal"] and r["step"] == 1 for r in four)
    assert four[0]["fingerprint"] == saved["fingerprint"]
    assert four[0]["device"] == "cpu"
    # a gloo world on the CPU does not take a request for the card
    for r in runs["worlds"][4]:
        assert "device 'cuda' requested" in r[f"refused-cuda-{precision}"]
        assert "computes on 'cpu'" in r[f"refused-cuda-{precision}"]
    # the restored state's next step at D = 4 equals the single-device
    # step from it
    nxt, _ = trainer.make_train_step(task, opt)(
        got, ranks._batch(runs["inputs"]["mlp-batch-1"]))
    for a, b in zip(four[0]["next"], ranks._np(nxt.params)):
        np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_checkpoint_from_two_ranks_restores_into_the_jax_package(
        runs, precision):
    jopt = jbuild("tvlars", total_steps=10, learning_rate=1.0,
                  use_kernel="fused", precision=precision)
    like = JTrainState.create(ref_side.mlp_params(), jopt)
    back = jck.restore(os.path.join(runs["ckpt"], precision), like)
    saved = runs["worlds"][2][0][f"saved-{precision}"]["state"]
    jleaves = jax.tree_util.tree_leaves(back)
    assert len(jleaves) == len(saved)
    for a, b in zip(saved, jleaves):
        b = np.asarray(b)
        if str(b.dtype) == "bfloat16":
            b = b.view(np.uint16)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_mean_sums_the_mesh_ranks_and_nothing_past_them(runs, world):
    """``Mesh.mean_`` at D = 2 is bitwise (x0 + x1) / 2 on every rank,
    in a world of 2 and in a world of 4 whose ranks 2 and 3 add -0.0
    (so -0.0 sums stay -0.0), with buckets that split and join leaves;
    at D = 4 every rank holds the same average."""
    x0, x1 = ranks.mean_draws(0), ranks.mean_draws(1)
    want = [(a + b) / 2 for a, b in zip(x0, x1)]
    for r in runs["worlds"][world]:
        got = r["mean"][2]
        assert got["equal"]
        for g, w in zip(got["values"], want):
            assert g.tobytes() == w.numpy().tobytes()
    if world == 4:
        draws = [ranks.mean_draws(i) for i in range(4)]
        for r in runs["worlds"][4]:
            assert r["mean"][4]["equal"]
            for i, g in enumerate(r["mean"][4]["values"]):
                w = sum(d[i].double() for d in draws) / 4
                np.testing.assert_allclose(g, w.numpy(), rtol=1e-6,
                                           atol=1e-7)


# ------------------------------------------------------------ in process
def _fake_mesh(d: int):
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": d, "model": 1}, shard=0)


def test_error_messages_equal_the_reference(runs):
    texts = runs["ref"]["json"]
    with pytest.raises(ValueError) as e:
        pipeline.shard_batch(_fake_mesh(2), {"x": torch.zeros(3, 4)})
    assert str(e.value) == texts["shard_batch"]
    with pytest.raises(ValueError) as e:
        trainer._check_divisible((torch.zeros(6, 8, 8, 3),
                                  torch.zeros(6, dtype=torch.long)),
                                 1, 4, ("data",))
    assert str(e.value) == texts["check_divisible"]


def test_shard_batch_takes_the_rank_rows_in_mesh_order():
    x = torch.arange(8 * 3).reshape(8, 3)
    stacked = x.reshape(2, 4, 3)
    for shard in range(4):
        mesh = _fake_mesh(4)
        mesh.shard = shard
        assert torch.equal(pipeline.shard_batch(mesh, x),
                           x[2 * shard:2 * shard + 2])
        assert torch.equal(pipeline.shard_batch(mesh, stacked, batch_dim=1),
                           stacked[:, shard:shard + 1])
    assert str(pipeline.microbatch_pspec(_fake_mesh(2))) == \
        "PartitionSpec(None, 'data')"


def test_mesh_needs_the_ranks_it_names():
    with pytest.raises(ValueError, match="needs 4 ranks but only 1"):
        mesh_lib.make_data_mesh(4)
    with pytest.raises(ValueError, match="needs 2 ranks but only 1"):
        mesh_lib.make_host_mesh(1, 2)
    mesh = mesh_lib.make_data_mesh(1)
    assert (mesh.shape, mesh.world, mesh.rank) == (
        {"data": 1, "model": 1}, 1, 0)


def test_mean_refuses_a_tensor_it_could_not_write():
    mesh = mesh_lib.make_data_mesh(1)
    with pytest.raises(ValueError, match="contiguous tensors only"):
        mesh.mean_([torch.zeros(3, 4).t()])


def test_restore_places_leaves_on_the_callers_device(tmp_path):
    """Outside a joined world a mesh has no device of its own: the
    leaves go where ``device`` says, and a request for the card is
    never served from the CPU."""
    like = {"w": torch.zeros(3, 2), "b": torch.zeros(2)}
    tree = {"w": torch.randn(3, 2), "b": torch.randn(2)}
    ck.save(str(tmp_path), tree, step=1)
    mesh = mesh_lib.make_data_mesh(1)
    assert mesh.device is None
    got = ck.restore(str(tmp_path), like, device="cpu", mesh=mesh)
    assert got["w"].device.type == "cpu" and torch.equal(got["w"],
                                                         tree["w"])
    got = ck.restore(str(tmp_path), like, device="cpu",
                     shardings=mesh_lib.replicated(mesh))
    assert got["b"].device.type == "cpu"
    if torch.cuda.is_available():
        got = ck.restore(str(tmp_path), like, device="cuda", mesh=mesh)
        assert got["w"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ck.restore(str(tmp_path), like, device="cuda", mesh=mesh)


def test_spawn_raises_a_failed_rank_and_a_world_that_hangs():
    """No fallback: a rank's exception, or a world past its timeout,
    raises in the caller after every rank was stopped."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"
                       "(.|\n)*rank 1 fails on purpose"):
        mesh_lib.spawn(ranks.fail_on_rank, 2, "gloo", "cpu", args=(1,),
                       timeout=TIMEOUT_S)
    with pytest.raises(RuntimeError, match="did not finish in 2 s"):
        mesh_lib.spawn(ranks.sleep_for, 2, "gloo", "cpu", args=(60.0,),
                       timeout=2.0)


def test_backend_pairings_that_cannot_work_raise():
    with pytest.raises(ValueError, match="nccl needs CUDA"):
        mesh_lib.check_backend("nccl", "cpu", 2)
    with pytest.raises(ValueError, match="one card per rank"):
        mesh_lib.check_backend("nccl", "cuda", torch.cuda.device_count()
                               + 1)
    with pytest.raises(ValueError, match="backend 'mpi'"):
        mesh_lib.check_backend("mpi", "cpu", 2)
    with pytest.raises(ValueError, match="nccl needs CUDA"):
        mesh_lib.spawn(print, 2, "nccl", "cpu")
    mesh_lib.check_backend("gloo", "cpu", 4)
    assert mesh_lib.default_backend("cpu", 2) == "gloo"


@pytest.mark.parametrize("target", [2, 4, 8, 16, 64, 10 ** 9])
def test_snap_and_decide_targets_fill_the_data_axis_first(target):
    kw = dict(microbatch=2, batch_min=2, batch_max=128, data_max=4)
    cfg, jcfg = controller.ControllerConfig(**kw), \
        jcontroller.ControllerConfig(**kw)
    assert controller.snap_targets(target, cfg) == \
        jcontroller.snap_targets(target, jcfg)
    for current in (2, 8, 16):
        assert controller.decide_targets(float(target), current, cfg) == \
            jcontroller.decide_targets(float(target), current, jcfg)


def test_controller_config_accepts_data_max():
    cfg = controller.ControllerConfig(microbatch=2, batch_min=2,
                                      batch_max=128, data_max=4)
    assert cfg.data_max == 4
    assert controller.snap_targets(16, cfg) == (4, 2)


# --------------------------------------------------------------- launchers
def _run_cli(module: str, args: list) -> str:
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_launch_train_mesh_data_spawns_and_prints_the_reference_line(runs):
    out = _run_cli("repro_torch.launch.train", [
        "--smoke", "--device", "cpu", "--mesh-data", "2", "--global-batch",
        "8", "--microbatch", "2", "--steps", "2", "--seq", "16"])
    assert "backend=gloo: spawning 2 ranks" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("global_batch=")]
    assert lines == runs["ref"]["json"]["launcher"]
    assert out.count("step    1 loss=") == 1        # rank 0 prints
    assert "ranks bitwise equal: 2 ranks" in out


def test_launch_serve_data_parallel_gives_equal_tokens():
    args = ["--smoke", "--device", "cpu", "--requests", "4",
            "--prompt-len", "8", "--num-tokens", "8", "--slots", "2",
            "--page-size", "8"]
    out = _run_cli("repro_torch.launch.serve", args + ["--data-parallel",
                                                       "2"])
    assert "tokens equal on 2 ranks" in out
    one = _run_cli("repro_torch.launch.serve", args)
    sample = [ln for ln in one.splitlines() if ln.startswith("sample:")]
    assert sample and sample[0] in out.splitlines()


def test_model_axis_raises_naming_the_roadmap_item():
    """Training over the model axis (ROADMAP item 11c) is ported: the
    launcher's three flags for it take the GSPMD path and train on their
    ranks, with the single-rank run's losses (``test_torch_tp_train
    _mesh.py`` holds them closer); the probe over it (ROADMAP item
    11c-2, ported) gives the single-rank run's λ_max. The MoE family
    trains at model > 1 too (item 11d, ported:
    ``test_torch_tp_train_mesh.py``, ``test_torch_ep_train.py``)."""
    from repro_torch.launch import train
    base = ["--smoke", "--device", "cpu", "--steps", "1", "--seq", "16",
            "--global-batch", "4"]
    one = train.run(base, log_fn=lambda *a: None)["losses"]
    for argv in (["--mesh-model", "2"], ["--data-parallel", "2"],
                 ["--model-parallel", "2"]):
        got = train.run(base + argv, log_fn=lambda *a: None)
        np.testing.assert_allclose(got["losses"], one, rtol=1e-5)
        assert got["world"] == 2
    probe = ["--probe-every", "1", "--probe-iters", "2"]
    want = train.run(base + probe, log_fn=lambda *a: None)["probes"]
    got = train.run(base + ["--mesh-model", "2"] + probe,
                    log_fn=lambda *a: None)["probes"]
    np.testing.assert_allclose([r["lanczos/lambda_max"] for r in got],
                               [r["lanczos/lambda_max"] for r in want],
                               rtol=1e-4)
