"""The port's dry run (``repro_torch.launch.dryrun``) against a real run
of the same step and against the JAX package's own dry run, on the
smoke configs and small shapes (``torch_sp_ref.TINY_SHAPES``), on the
CPU.

The reference side runs once, in a subprocess that fabricates 8 host
devices (``torch_sp_ref.main(OUT, "dryrun")``): its ``build_lowerable``
lowered and compiled on ``make_data_mesh(2, 4)``, giving the argument
bytes a device (``memory_analysis``) and the structural dot FLOPs a
device (``hlo_analysis.analyze``). The real runs are one gloo world of
4 ranks on the CPU (``torch_sp_ref.dry_world``).

* The dry mesh's collective records equal the real ``(2, 2)`` run's,
  name by name, count and bytes, on rank 0 and the last rank; so do the
  FLOPs (``FlopCounterMode`` on the real run, the decode kernel's own
  counted by its meta branch).
* The argument bytes a rank equal the reference's exactly, once two
  named terms are taken out: the train state's step counter (a host int
  in the port, an int32 on the device in the reference) and the leaves
  whose data axis the reference gives to a stacked dim (whole over the
  data column in the port: ``Placement.stacked_picks``).
* The dot FLOPs are within 5% of the reference's once one named op is
  taken out: the K/V projections of a whole ``wk`` / ``wv`` beside split
  heads, which the port computes on every position of the gathered
  sequence and the reference on the rank's positions only.
* The skipped pairs carry the reference's reasons; the CLI writes a
  JSON file; the last rank gives rank 0's bytes; the multi-pod mesh's
  ``(pod, data)`` axes cut every leaf as one data axis of 32 does.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

from torch_threads import one_thread  # noqa: F401  (autouse)
import torch_sp_ref as sp
from repro import configs as ref_configs
from repro_torch import configs
from repro_torch.core.base import tree_get
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.models import convert
from repro_torch.training.train_state import block_trees

PAIRS = list(sp.DRY_PAIRS)
IDS = [f"{a}-{s}" for a, s in PAIRS]
REAL_MESH = (2, 2)
FLOPS_RTOL = 0.05


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun") / "ref.npz")
    proc = sp.start(out, "dryrun")
    try:
        real = mesh_lib.spawn(sp.dry_world, 4, "gloo", "cpu",
                              args=(sp.DRY_PAIRS, REAL_MESH),
                              timeout=sp.TIMEOUT_S)
        dry = {}
        for arch, shape in PAIRS:
            for r in (0, 3):
                dry[(arch, shape, REAL_MESH, r)] = sp.dry_trace(
                    arch, shape, dryrun.DryMesh(*REAL_MESH, rank=r))
            for r in (0, 7):
                dry[(arch, shape, sp.MESH, r)] = sp.dry_trace(
                    arch, shape, dryrun.DryMesh(*sp.MESH, rank=r),
                    use_kernel=False)
        log, _ = proc.communicate(timeout=sp.TIMEOUT_S)
        assert proc.returncode == 0, log.decode()[-4000:]
        with np.load(out) as z:
            ref = {k: z[k] for k in z.files}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return {"real": real, "dry": dry, "ref": ref}


@pytest.mark.parametrize("arch,shape", PAIRS, ids=IDS)
def test_dry_records_and_flops_equal_a_real_runs(runs, arch, shape):
    for r in (0, 3):
        got = runs["dry"][(arch, shape, REAL_MESH, r)]
        want = runs["real"][r][f"{arch}/{shape}"]
        assert got["collectives"] == want["collectives"], r
        assert got["flops"] == want["flops"], r
    assert got["collectives"], "no collective traced"


def _stacked_pick_bytes(arch: str, shape: str) -> int:
    """The bytes a rank holds beyond the reference's block of the leaves
    whose data axis the reference gives to a stacked dim: each such
    member stays whole over the data column, of which the reference
    keeps 1/D (the params and the optimizer state, tree path)."""
    mesh = dryrun.DryMesh(*sp.MESH)
    with sp.tiny_shapes() as dr:
        step = dr.build_step(arch, shape, mesh, use_kernel=False)
    dryrun.L.set_batch_sharding(None)
    if step.kind != "train":
        return 0
    cfg = configs.get_smoke_config(arch)
    place = convert.placement(cfg, mesh)
    d = mesh.shape["data"]
    total = 0
    for tree in block_trees(step.args[0]):
        for path in place.stacked_picks:
            t = tree_get(tree, path)
            total += t.numel() * t.element_size() * (d - 1) // d
    return total


@pytest.mark.parametrize("arch,shape", PAIRS, ids=IDS)
def test_argument_bytes_are_the_references(runs, arch, shape):
    got = runs["dry"][(arch, shape, sp.MESH, 0)]["argument_bytes"]
    want = int(runs["ref"][f"dry/{arch}/{shape}/argument_bytes"])
    step_counter = 4 if shape.endswith("train") else 0
    picks = _stacked_pick_bytes(arch, shape)
    assert got + step_counter - picks == want, (got, step_counter, picks)
    if arch in ("mamba2-1.3b", "llama-3.2-vision-11b"):
        assert picks > 0          # conv_b / the cross gates
    else:
        assert picks == 0


def _whole_kv_flops(arch: str, shape: str) -> int:
    """The K/V projections a rank computes beyond the reference's: a
    self-attention layer with a whole ``wk`` / ``wv`` beside split
    heads projects every position of the gathered sequence, the
    reference the rank's 1/M of them (forward, and twice that in a
    train step's backward)."""
    cfg = configs.get_smoke_config(arch)
    spec = sp.TINY_SHAPES[shape]
    d, m = sp.MESH
    if spec["kind"] == "decode" or cfg.num_kv_heads % m == 0 \
            or cfg.num_heads % m:
        return 0
    layers = cfg.num_layers if cfg.family in ("dense", "vlm") else 0
    b, s = spec["global_batch"] // d, spec["seq_len"]
    fwd = 2 * 2 * b * s * cfg.d_model * cfg.num_kv_heads * cfg.head_dim_
    factor = 3 if spec["kind"] == "train" else 1
    return factor * layers * fwd * (m - 1) // m


@pytest.mark.parametrize("arch,shape", PAIRS, ids=IDS)
def test_dot_flops_near_the_references(runs, arch, shape):
    got = runs["dry"][(arch, shape, sp.MESH, 0)]["flops"]
    want = float(runs["ref"][f"dry/{arch}/{shape}/flops"])
    extra = _whole_kv_flops(arch, shape)
    assert abs(got - extra - want) <= FLOPS_RTOL * want, (got, extra, want)


@pytest.mark.parametrize("arch,shape", PAIRS, ids=IDS)
def test_last_rank_gives_rank_zeros_bytes(runs, arch, shape):
    first = runs["dry"][(arch, shape, sp.MESH, 0)]
    last = runs["dry"][(arch, shape, sp.MESH, 7)]
    for key in ("argument_bytes", "peak_bytes", "flops", "collectives",
                "launches"):
        assert first[key] == last[key], key


@pytest.mark.parametrize("arch", sorted(ref_configs.LONG_CONTEXT_SKIP))
def test_skipped_pairs_carry_the_references_reasons(arch):
    got = dryrun.dryrun_one(arch, "long_500k", save_dir=None, verbose=False)
    assert got["status"] == "skipped"
    assert got["reason"] == ref_configs.supports_shape(
        ref_configs.get_config(arch), "long_500k")[1]


def test_cli_writes_a_json_file_for_one_pair(tmp_path):
    assert dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k",
                        "--save-dir", str(tmp_path)]) == 0
    files = list(tmp_path.iterdir())
    assert [f.name for f in files] == ["qwen2.5-3b__decode_32k__single.json"]
    got = json.loads(files[0].read_text())
    assert got["status"] == "ok" and got["num_devices"] == 256
    assert got["launches"] == {"attention_decode": 36}
    assert got["peak_bytes"] >= got["argument_bytes"] > 0


class _Pod:
    shape = {"pod": 2, "data": 16, "model": 16}

    def __init__(self, pod, data, model):
        self.coords = {"pod": pod, "data": data, "model": model}


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_pod_and_data_cut_leaves_as_one_data_axis(arch):
    """The multi-pod mesh (2, 16, 16) over (pod, data, model) places every
    leaf of the training state as the dry run's (32, 16) mesh does: the
    spec's ``("pod", "data")`` is its ``"data"``, and a rank at (p, d,
    m) holds the block of data index 16 p + d."""
    cfg = configs.get_config(arch)
    pod = convert.placement(cfg, _Pod(0, 0, 0))
    flat = convert.placement(cfg, dryrun.DryMesh(32, 16))
    assert set(pod.whole) == set(flat.whole)
    assert pod.stacked_picks == flat.stacked_picks
    merged = 0
    def data_as_one(spec):
        return tuple("data" if e in (("pod", "data"), ("data",)) else e
                     for e in spec)

    for path, shape in pod.whole.items():
        assert data_as_one(pod.spec(path)) == data_as_one(flat.spec(path)), \
            path
        merged += ("pod", "data") in tuple(pod.spec(path))
        for p, d, m in ((0, 0, 0), (1, 5, 3), (1, 15, 15)):
            at = dryrun.DryMesh(32, 16, rank=(16 * p + d) * 16 + m)
            assert sharding.local_block(pod.spec(path), _Pod(p, d, m),
                                        shape) == \
                sharding.local_block(flat.spec(path), at, shape), path
    assert merged > 0
