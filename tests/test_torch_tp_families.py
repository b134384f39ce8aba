"""The vlm, encdec, ssm and hybrid families on a ``(D, M)`` mesh in the
port, against the JAX package and the port's single-rank path, on the
CPU.

The reference side runs once, in a subprocess
(``torch_tp_more_ref.main("families", ...)``), while the port's ranks
run in gloo worlds of 2 and 4 ranks, spawned once each
(``torch_tp_ranks.families_world``) on ``(1, 2)`` and ``(2, 2)`` meshes.

* llama-3.2-vision's smoke config through the engine (cross gates
  opened, seeded image rows; F10's row i of ``extra``), whisper's,
  mamba2's and zamba2's through ``generate(mesh=)``, on the reference's
  params (``shard_params``) give the reference's tokens, and the last
  three on each rank's blocks of the seed-0 draw (``Model.init(mesh=)``,
  mamba's undrawn ``conv_b`` included) the port's single-rank tokens;
  at D = 2 each data row holds half the slots or rows.
* A rank's cache leaves have the shapes of its blocks of the
  reference's cache leaves under ``cache_pspecs``, leaf name by leaf
  name: KV caches over the KV heads, the SSM state over its heads, the
  conv cache over its channels, the batch over the data axis.
* Mamba2's step gathers the projection, the conv output and y over the
  model row and sums ``out_proj`` once per block.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest

import torch_tp_more_ref as ref_side
import torch_tp_ranks as ranks
from repro_torch import serving
from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import convert, get_model
from test_torch_tp_fallback import TIMEOUT_S, finish_reference, \
    start_reference

VLM = "llama-3.2-vision-11b"
ARCHS = (VLM,) + ref_side.GENERATE
MESHES = {(1, 2): 2, (2, 2): 4}
IDS = ["1x2", "2x2"]


def _single(arch: str, params) -> list:
    """The port's M = 1 tokens on ``params``."""
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    if arch == VLM:
        return ranks.drain(model, params, extra=ranks._extra(
            cfg, ranks.SERVE["slots"]))["tokens"]
    return serving.generate(
        model, params, ranks.gen_prompts(cfg.vocab_size),
        num_tokens=ranks.GEN_N, extra_embeds=ranks._extra(cfg, ranks.GEN_B),
        device="cpu").numpy().tolist()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tpfam") / "ref.npz")
    proc = start_reference("families", out)
    try:
        ref_params = {a: ref_side.reference_params(a) for a in ARCHS}
        single = {}
        for arch in ARCHS:
            cfg = get_smoke_config(arch)
            model = get_model(cfg)
            single[arch] = {"ref": _single(arch, convert.params_from_jax(
                cfg, ref_params[arch], device="cpu"))}
            if arch != VLM:
                single[arch]["init"] = _single(
                    arch, model.init(0, device="cpu"))
        worlds = {mesh: mesh_lib.spawn(
            ranks.families_world, n, "gloo", "cpu",
            args=(*mesh, ref_params), timeout=TIMEOUT_S)
            for mesh, n in MESHES.items()}
    finally:
        reference = finish_reference(proc, out)
    return {"ref": reference, "worlds": worlds, "single": single,
            "ref_params": ref_params}


def _tokens(res) -> list:
    return res["tokens"] if isinstance(res, dict) else res.tolist()


def _reference_tokens(ref: dict, arch: str) -> list:
    if arch == VLM:
        return [list(ref[f"engine/{arch}/tokens/{j}"])
                for j in range(len(ranks.PROMPTS))]
    return ref[f"generate/{arch}/tokens"].tolist()


def test_reference_inputs_are_the_tests(runs):
    for arch in ARCHS:
        key = "engine" if arch == VLM else "generate"
        n = sum(1 for k in runs["ref"]
                if k.startswith(f"{key}/{arch}/params/"))
        want = jax.tree_util.tree_leaves(runs["ref_params"][arch])
        assert n == len(want) > 0
        for i, b in enumerate(want):
            assert np.array_equal(runs["ref"][f"{key}/{arch}/params/{i}"],
                                  np.asarray(b))


@pytest.mark.parametrize("arch,source", [(a, "ref") for a in ARCHS] + [
    (a, "init") for a in ref_side.GENERATE])
@pytest.mark.parametrize("mesh", list(MESHES), ids=IDS)
def test_family_tokens_equal_the_reference_and_single_rank(runs, mesh,
                                                          arch, source):
    want = runs["single"][arch][source]
    if source == "ref":
        assert want == _reference_tokens(runs["ref"], arch)
    for r in runs["worlds"][mesh]:
        assert _tokens(r[arch][source]) == want
        assert r["equal"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES), ids=IDS)
def test_cache_leaves_are_the_cache_pspecs_blocks(runs, mesh, arch):
    d, m = mesh
    prefix = f"cache/{arch}/{d}x{m}/"
    want = {k[len(prefix):]: sorted(tuple(int(x) for x in row)
                                    for row in runs["ref"][k])
            for k in runs["ref"] if k.startswith(prefix)}
    assert want
    for r in runs["worlds"][mesh]:
        got = {k: [tuple(s) for s in v] for k, v in r[arch]["cache"].items()}
        assert got == want


@pytest.mark.parametrize("mesh", list(MESHES), ids=IDS)
def test_ssm_step_gathers_and_sums_once_a_block(runs, mesh):
    """Per mamba2 block and step: the projection, the conv output and y
    gathered, out_proj summed; then the embedding's sum and the logits'
    gather (prefill streams the prompt through the same step)."""
    cfg = get_smoke_config("mamba2-1.3b")
    steps = ranks.GEN_S + ranks.GEN_N
    calls = {"model_sum": steps * (cfg.num_layers + 1),
             "model_gather": steps * (3 * cfg.num_layers + 1)}
    if mesh[0] > 1:
        calls["data_gather"] = 1
    for r in runs["worlds"][mesh]:
        assert r["mamba2-1.3b"]["ref/collectives"] == calls


@pytest.mark.parametrize("mesh", list(MESHES), ids=IDS)
def test_vlm_engine_rows_follow_the_data_axis(runs, mesh):
    """Each data row's pool holds its slots; a row that held none of an
    admission batch's slots ran no prefill for it."""
    d = mesh[0]
    slots = ranks.SERVE["slots"]
    for r in runs["worlds"][mesh]:
        stats = r[VLM]["ref"]["stats"]
        assert stats["row_slots"] == slots // d
        assert r[VLM]["ref"]["pool"][0] == slots // d
        assert 0 < stats["row_prefills"] <= stats["prefills"]
