"""Serving the MoE family with its experts over the model axis in the
port (each rank of a model row holds E/M experts and the router's E/M
columns; the logits are gathered over the row, every rank routes alike
and the row sums the experts' partial output), against the JAX
package's own ``(2, 4)`` decode and the port's single-rank engine, on
the CPU.

The reference side runs once, in a subprocess that fabricates 8 host
devices before jax is imported (``torch_ep_ref.main("serve", ...)``),
while the port's side runs in gloo worlds of 8, 4 and 2 ranks
(``torch_ep_ranks``).

* The reference test's decode loop (``make_serve_step`` and
  ``decode_step``) on a ``(2, 4)`` mesh, for both MoE smoke configs
  (one expert a rank; qwen3-moe's 2 KV heads put its cache over T) on
  the reference's seed-0 params: the port's greedy tokens equal the
  reference's ``(2, 4)`` tokens and its logits are within
  ``decode_parity_tolerance("float32")``; the reference's placement of
  the experts and the router is the port's blocks; the collectives a
  step are counted.
* ``Engine(mesh=)`` and ``generate(mesh=)`` at ``(1, 2)`` and ``(2,
  2)`` on the ranks' blocks of the seed-0 draw give the single-rank
  tokens.
* ``launch.serve --arch olmoe-1b-7b --model-parallel 2`` prints the
  single-rank run's ``sample:`` line and ``tokens equal on 2 ranks``.
"""
from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import pytest

import torch_ep_ranks as ranks
import torch_ep_ref as ref_side
from repro.kernels.ref import decode_parity_tolerance
from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as serve_launch

ARCHS = ref_side.SERVE_ARCHS
F32 = decode_parity_tolerance("float32")
ENGINE_MESHES = ((1, 2), (2, 2))
SERVE_ARGV = ["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
              "--requests", "4", "--prompt-len", "8", "--num-tokens", "8",
              "--slots", "2", "--page-size", "8"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ep_serving") / "ref.npz")
    proc = ref_side.start("serve", out)
    try:
        params = {arch: ref_side.serve_params(arch) for arch in ARCHS}
        starts = {arch: ref_side.start_tokens(
            get_smoke_config(arch).vocab_size) for arch in ARCHS}
        step = mesh_lib.spawn(ranks.step_world, 8, "gloo", "cpu",
                              args=(params, starts),
                              timeout=ref_side.TIMEOUT_S)
        engine = {
            mesh: mesh_lib.spawn(
                ranks.engine_world, mesh[0] * mesh[1], "gloo", "cpu",
                args=(*mesh, ARCHS, (SERVE_ARGV + ["--model-parallel",
                                                   "2"],)
                      if mesh == (1, 2) else ()),
                timeout=ref_side.TIMEOUT_S)
            for mesh in ENGINE_MESHES}
        single = {arch: ranks.single_serving(arch) for arch in ARCHS}
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            serve_launch.main(SERVE_ARGV)
    finally:
        reference = ref_side.finish(proc, out)
    return {"ref": reference, "params": params, "step": step,
            "engine": engine, "single": single,
            "launch": text.getvalue().splitlines()}


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_inputs_are_the_tests(runs, arch):
    import jax
    mine = jax.tree_util.tree_leaves(runs["params"][arch])
    key = f"serve/{arch}/params"
    n = sum(1 for k in runs["ref"] if k.startswith(key + "/"))
    assert n == len(mine) > 0
    for i, a in enumerate(mine):
        np.testing.assert_array_equal(runs["ref"][f"{key}/{i}"], a)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_places_experts_as_the_port_does(runs, arch):
    """The reference's specs of the stacked MoE leaves put "model" on
    the expert axis (the router's last dim), and each port rank holds
    that block: 1 of 4 experts at M = 4; the KV cache over its KV heads
    (olmoe) or over T (qwen3-moe: 2 KV heads do not divide 4)."""
    cfg = get_smoke_config(arch)
    specs = json.loads(str(runs["ref"][f"serve/{arch}/specs"]))
    assert specs["router"] == "(None, None, 'model')"
    for name in ("wi", "wg", "wo"):
        assert specs[name] == "(None, 'model', None, None)"
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    for r in runs["step"]:
        got = r[f"{arch}/shapes"]
        assert got["router"] == (d, e // 4)
        assert got["wi"] == (e // 4, d, f) and got["wo"] == (e // 4, f, d)
        if cfg.num_kv_heads % 4:
            assert specs["k"] == "(None, 'data', 'model', None, None)"
            assert got["k"] == (4, ref_side.STEP_LEN // 4,
                                cfg.num_kv_heads, cfg.head_dim_)
        else:
            assert specs["k"] == "(None, 'data', None, 'model', None)"
            assert got["k"] == (4, ref_side.STEP_LEN,
                                cfg.num_kv_heads // 4, cfg.head_dim_)


@pytest.mark.parametrize("arch", ARCHS)
def test_2x4_decode_gives_the_references_2x4_tokens(runs, arch):
    ref = runs["ref"]
    key = f"serve/{arch}"
    np.testing.assert_array_equal(ref[f"{key}/mesh/tokens"],
                                  ref[f"{key}/single/tokens"])
    for r in runs["step"]:
        np.testing.assert_array_equal(r[f"{arch}/tokens"],
                                      ref[f"{key}/mesh/tokens"])
        np.testing.assert_allclose(r[f"{arch}/logits"],
                                   ref[f"{key}/mesh/logits"],
                                   rtol=F32["rtol"], atol=F32["atol"])
        assert r["equal"]


@pytest.mark.parametrize("arch", ARCHS)
def test_2x4_decode_collectives_a_step(runs, arch):
    """Per decode and layer: attention's wo and the experts' output
    summed over the row, the router logits gathered (qwen3-moe also
    gathers q and the partials: its cache over T); then the embedding's
    sum and the logits' gather. Each step decodes twice (the logits
    read, then the step)."""
    cfg = get_smoke_config(arch)
    n, layers = 2 * ref_side.STEPS, cfg.num_layers
    want = {"model_sum": n * (2 * layers + 1),
            "model_gather": n * (layers + 1)}
    if cfg.num_kv_heads % 4:
        want.update(q_gather=n * layers, partial_gather=n * layers)
    for r in runs["step"]:
        assert r[f"{arch}/collectives"] == want


@pytest.mark.parametrize("mesh", ENGINE_MESHES,
                         ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_and_generate_give_the_single_rank_tokens(runs, arch, mesh):
    want = runs["single"][arch]
    e = get_smoke_config(arch).num_experts
    for r in runs["engine"][mesh]:
        got = r[arch]
        assert got["experts"] == e // mesh[1]
        assert got["tokens"] == want["tokens"]
        np.testing.assert_array_equal(got["generate"], want["generate"])
        assert r["equal"]


def test_launcher_serves_moe_over_the_model_axis(runs):
    sample = [ln for ln in runs["launch"] if ln.startswith("sample:")]
    got = runs["engine"][(1, 2)][0]["launch/0"]
    assert sample and sample[0] in got
    assert "data_parallel=1 model_parallel=2 backend=gloo: tokens equal " \
           "on 2 ranks" in got


@pytest.mark.parametrize("leaf", ["router", "wo"])
def test_a_whole_moe_leaf_beside_split_experts_is_refused(leaf):
    """A placement that leaves the router (or one expert leaf) whole
    beside experts split over the model axis, as a hand-made
    ``shardings=`` could, is refused before a step: the logits' block
    and the rank's experts must be the same experts."""
    from repro_torch.models import convert, get_model
    from repro_torch.models.transformer import check_model_axis

    class StandIn:
        shape = {"data": 1, "model": 2}
        coords = {"data": 0, "model": 0}

    cfg = get_smoke_config("olmoe-1b-7b")
    whole = get_model(cfg).init(0, device="cpu")
    params = convert.shard_params(cfg, whole, StandIn)
    params["layers"][1]["moe"][leaf] = whole["layers"][1]["moe"][leaf]
    with pytest.raises(ValueError, match=f"layer 1 moe: .* split but "
                                         f"\\['{leaf}'\\] whole"):
        check_model_axis(cfg, params, StandIn)
