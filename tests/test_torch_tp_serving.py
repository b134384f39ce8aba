"""Tensor-parallel serving in the port (the model axis of a ``(D, M)``
mesh over ``torch.distributed``) against the JAX package and the port's
own single-rank path, on the CPU.

The reference side runs once, in a subprocess that fabricates 8 host
devices before jax is imported (``torch_tp_ref.main``), while the port's
side runs in gloo worlds of 2, 4 and 8 ranks, spawned once each
(``torch_tp_ranks``). Inputs are the reference's own params, made here
and in the subprocess from the same keys.

* The reference test's ``DECODE_SCRIPT`` step on a ``(2, 4)`` mesh of 8
  ranks (params placed by ``convert.shard_params``, the reference's
  ``state_pspecs``) gives the reference's own ``(2, 4)`` tokens
  (``make_data_mesh(2, 4)``) at every one of 4 steps, and logits within
  ``decode_parity_tolerance("float32")``.
* The engine on ``(1, 2)`` and ``(2, 2)`` meshes, for the gemma3 and
  qwen2 smoke configs (the windowed ring past T, QKV biases, both
  axes): on ``Model.init(0, mesh=)``, on the reference's params, and
  restored from a checkpoint replicated (``mesh=``) and split
  (``shardings=``), the tokens of the port's M = 1 engine on the same
  weights, and on the reference's params the reference engine's. A
  rank's blocks are the whole draw's; its KV pool holds its KV heads
  and its data row's slots; the row-parallel sums and logit gathers
  happen once per layer and step (none on replicated params), the
  sampled tokens' gather over the data column once per step; the
  vocab-parallel embedding is M = 1's bit for bit; every rank holds the
  same tokens. Sampled at ``temperature > 0`` the engine draws as the
  single-rank engine does, whatever the data split.
* ``launch.serve --model-parallel 2`` prints M = 1's sample line.
* The cases once refused (the MoE family's, item 11d, and the model
  axis dividing neither the heads nor the KV heads, item 11b-4) give
  the rules' blocks, the KV caches ``cache_pspecs``'; the data
  column's ``mean_`` /
  ``broadcast_`` and a save of split leaves work over the model axis.
"""
from __future__ import annotations

import contextlib
import io
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_tp_ranks as ranks
import torch_tp_ref as ref_side
from repro.kernels.ref import decode_parity_tolerance
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.base import tree_leaves
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import convert, extra_embed_shape, get_model
from repro_torch.models import layers as L
from repro_torch.models.transformer import check_model_axis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180
ARCHS = ref_side.ENGINE_ARCHS
WORLDS = {(1, 2): 2, (2, 2): 4}
SOURCES = ("init", "ref", "restored", "split")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _step_params():
    from repro.configs.base import ModelConfig as JConfig
    from repro.models import get_model as jget
    return _np(jget(JConfig(**ref_side.DECODE_LM)).init(
        jax.random.PRNGKey(0)))


def _start_reference(out: str) -> subprocess.Popen:
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
        + " --xla_cpu_multi_thread_eigen=false").strip(),
        OMP_NUM_THREADS="1",
        PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                    os.path.join(ROOT, "tests")]))
    return subprocess.Popen(
        [sys.executable, "-c", f"import torch_tp_ref as r; r.main({out!r})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _drain_m1(model, params) -> list:
    return ranks.drain(model, params)["tokens"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    out = str(tmp / "ref.npz")
    proc = _start_reference(out)
    try:
        ref_params = {a: ref_side.engine_params(a) for a in ARCHS}
        step_params = _step_params()
        single = {}
        for arch in ARCHS:
            cfg = get_smoke_config(arch)
            model = get_model(cfg)
            params = model.init(0, device="cpu")
            ck.save(str(tmp / arch), convert.params_to_jax(cfg, params))
            single[arch] = {
                "init": _drain_m1(model, params),
                "sampled": ranks.drain(
                    model, params,
                    temperature=ranks.SAMPLE_TEMPERATURE)["tokens"]
                if arch == ranks.SAMPLED_ARCH else None,
                "ref": _drain_m1(model, convert.params_from_jax(
                    cfg, ref_params[arch], device="cpu")),
                "params": params}
        worlds = {mesh: mesh_lib.spawn(
            ranks.engine_world, n, "gloo", "cpu",
            args=(*mesh, ref_params, str(tmp)), timeout=TIMEOUT_S)
            for mesh, n in WORLDS.items()}
        step = mesh_lib.spawn(ranks.step_world, 8, "gloo", "cpu",
                              args=(step_params,), timeout=TIMEOUT_S)
        log, _ = proc.communicate(timeout=TIMEOUT_S)
        assert proc.returncode == 0, log.decode()[-4000:]
        with np.load(out) as z:
            reference = {k: z[k] for k in z.files}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return {"ref": reference, "worlds": worlds, "step": step,
            "single": single, "ref_params": ref_params,
            "step_params": step_params}


def _leaves(res: dict, key: str) -> list:
    n = sum(1 for k in res if k.startswith(key + "/")
            and k[len(key) + 1:].isdigit())
    return [res[f"{key}/{i}"] for i in range(n)]


def test_reference_inputs_are_the_tests(runs):
    """The subprocess and the test process made the same params."""
    pairs = [("step/params", runs["step_params"])] + [
        (f"engine/{a}/params", runs["ref_params"][a]) for a in ARCHS]
    for key, tree in pairs:
        got = _leaves(runs["ref"], key)
        want = jax.tree_util.tree_leaves(tree)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            b = np.asarray(b)
            assert np.array_equal(a, b.view(np.uint16)
                                  if str(b.dtype) == "bfloat16" else b)


@pytest.mark.parametrize("start", ["", "-varied"])
def test_step_on_2x4_gives_the_reference_2x4_tokens(runs, start):
    ref = runs["ref"]
    # the reference's own (2, 4) step agrees with its single device
    np.testing.assert_array_equal(ref[f"step/mesh{start}/tokens"],
                                  ref[f"step/single{start}/tokens"])
    tol = decode_parity_tolerance("float32")
    for r in runs["step"]:
        np.testing.assert_array_equal(r[f"tokens{start}"],
                                      ref[f"step/mesh{start}/tokens"])
        np.testing.assert_allclose(r[f"logits{start}"],
                                   ref[f"step/mesh{start}/logits"],
                                   rtol=tol["rtol"], atol=tol["atol"])
        assert r["equal"]
    # each rank held one of the 4 heads and 32 of the 128 vocab rows
    assert {r["wq"] for r in runs["step"]} == {(64, 1, 16)}
    assert {r["table"] for r in runs["step"]} == {(32, 64)}
    assert sorted((r["coords"]["data"], r["coords"]["model"])
                  for r in runs["step"]) == [(d, m) for d in range(2)
                                             for m in range(4)]


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(WORLDS), ids=["1x2", "2x2"])
def test_engine_tokens_equal_the_single_rank_engine(runs, mesh, arch,
                                                    source):
    want = runs["single"][arch]["ref" if source == "ref" else "init"]
    for r in runs["worlds"][mesh]:
        assert r[arch][source]["tokens"] == want
        assert r["equal"]
    if source == "ref":
        got = [list(runs["ref"][f"engine/{arch}/tokens/{j}"])
               for j in range(len(ref_side.PROMPTS))]
        assert want == got


@pytest.mark.parametrize("mesh", list(WORLDS), ids=["1x2", "2x2"])
def test_sampled_engine_tokens_do_not_depend_on_the_split(runs, mesh):
    """At temperature > 0 every data row draws for all slots as the
    single-rank engine does and keeps its own: the same tokens
    (gemma3's smoke config: the windowed ring, both axes)."""
    arch = ranks.SAMPLED_ARCH
    want = runs["single"][arch]["sampled"]
    assert want != runs["single"][arch]["init"]
    for r in runs["worlds"][mesh]:
        assert r[arch]["sampled"]["tokens"] == want


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(WORLDS), ids=["1x2", "2x2"])
def test_rank_blocks_are_the_whole_draws_blocks(runs, mesh, arch):
    cfg = get_smoke_config(arch)
    whole = runs["single"][arch]["params"]
    m = mesh[1]
    h, f, v = cfg.num_heads // m, cfg.d_ff // m, cfg.vocab_size // m
    for r in runs["worlds"][mesh]:
        i = r["coords"]["model"]
        got = r[arch]
        assert got["init_shapes"] == {
            "wq": (cfg.d_model, h, cfg.head_dim_), "wi": (cfg.d_model, f),
            "table": (v, cfg.d_model)}
        wq, table = got["init_leaves"]
        assert np.array_equal(wq, whole["layers"][0]["attn"]["wq"][
            :, i * h:(i + 1) * h].numpy())
        assert np.array_equal(table, whole["embed"]["table"][
            i * v:(i + 1) * v].numpy())
        assert got["split_table"] == (v, cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(WORLDS), ids=["1x2", "2x2"])
def test_pool_and_collectives_follow_the_split(runs, mesh, arch):
    """A rank's KV pool holds its KV heads and its data row's slots; a
    split model sums twice a layer plus once for the embedding, and
    gathers the logits once, per prefill this rank ran and per decode
    step; replicated params do neither. Over a data axis of 2 the
    sampled tokens are gathered over the data column once per decode
    step and per admission."""
    cfg = get_smoke_config(arch)
    sc = ref_side.SERVE
    t_first = min(cfg.sliding_window or sc["max_len"], sc["max_len"])
    d = mesh[0]
    for r in runs["worlds"][mesh]:
        for source in SOURCES:
            got = r[arch][source]
            split = source != "restored"
            hkv = cfg.num_kv_heads // (mesh[1] if split else 1)
            assert got["pool"] == (sc["slots"] // d, t_first, hkv,
                                   cfg.head_dim_)
            stats = got["stats"]
            calls = {k: v["calls"] for k, v in got["collectives"].items()}
            want = {}
            if d > 1:
                want["data_gather"] = stats["decode_steps"] \
                    + stats["prefills"]
            if split:
                passes = stats["decode_steps"] + stats["row_prefills"]
                want.update({
                    "model_sum": (2 * cfg.num_layers + 1) * passes,
                    "model_gather": passes})
            assert calls == want
            assert 0 < stats["row_prefills"] <= stats["prefills"]


@pytest.mark.parametrize("arch", ARCHS)
def test_vocab_parallel_embedding_is_the_single_rank_one_bit_for_bit(
        runs, arch):
    cfg = get_smoke_config(arch)
    want = L.embed(runs["single"][arch]["params"]["embed"], cfg,
                   torch.from_numpy(ranks.EMBED_TOKENS)).numpy()
    for mesh in WORLDS:
        for r in runs["worlds"][mesh]:
            assert r[arch]["embed"].tobytes() == want.tobytes()


def _sample(argv) -> list:
    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(argv)
    return [ln for ln in out.getvalue().splitlines()
            if ln.startswith("sample:")]


def test_launch_serve_model_parallel_prints_the_single_rank_sample():
    args = ["--smoke", "--device", "cpu", "--requests", "4",
            "--prompt-len", "12", "--num-tokens", "8", "--slots", "2",
            "--page-size", "8"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args,
         "--model-parallel", "2"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "model_parallel=2 backend=gloo: tokens equal on 2 ranks" \
        in out.stdout
    sample = _sample(args)
    assert sample and sample[0] in out.stdout.splitlines()


@pytest.mark.parametrize("mesh", list(WORLDS), ids=["1x2", "2x2"])
def test_training_collectives_and_split_saves_name_11c(runs, mesh):
    """What item 11c ported (they raised before it): ``mean_`` and
    ``broadcast_`` run over each data column, so every model rank keeps
    its own values (the column's mean, the column's data index 0's), and
    ``save`` of a leaf split over the model row writes it whole with its
    spec as provenance."""
    d, m = mesh
    for rank, r in enumerate(runs["worlds"][mesh]):
        col = r["column"]
        model_index = rank % m
        column = [j * m + model_index for j in range(d)]
        assert col["mean_"] == [sum(column) / d] * 4
        assert col["broadcast_"] == [float(column[0])] * 4
        assert col["save"]
        assert col["provenance"] == {"leaf_0": {
            "spec": "PartitionSpec(None, 'model')",
            "mesh": {"data": d, "model": m}}}


class StandIn:
    """The axis sizes and coordinates of one rank of a mesh, for the
    checks made before any collective."""

    def __init__(self, data: int, model: int):
        self.shape = {"data": data, "model": model}
        self.coords = {"data": 0, "model": 0}


@pytest.mark.parametrize("arch,model,item", [
    ("olmoe-1b-7b", 2, "11d"), ("qwen3-moe-30b-a3b", 2, "11d"),
    ("whisper-large-v3", 8, "11b-4"), ("qwen2.5-3b", 8, "11b-4"),
    ("llama-3.2-vision-11b", 8, "11b-4")])
def test_refusals_name_their_roadmap_item(arch, model, item):
    """The cases of items 11d and 11b-4, which both used to be refused,
    give this rank the rules' blocks from ``Model.init(mesh=)`` and
    ``shard_params`` alike, the same bits (every leaf the whole draw's
    block at model coordinate 0). Item 11d, expert parallelism: the
    router's [d, E/M] and the experts' [E/M, ...]. Item 11b-4, the
    model axis dividing neither the heads nor the KV heads (4 of them
    at M = 8): the attention whole, d_ff split, and the KV caches
    ``cache_pspecs``' blocks, over T where 8 divides their length, else
    over the head dim (32 in blocks of 4)."""
    m = get_model(get_smoke_config(arch))
    cfg = m.cfg
    mesh = StandIn(1, model)
    whole = m.init(0, device="cpu")
    local = m.init(0, device="cpu", mesh=mesh)
    split = convert.shard_params(cfg, whole, mesh)
    for a, b, c in zip(tree_leaves(local), tree_leaves(split),
                       tree_leaves(whole)):
        assert torch.equal(a, b)
        assert torch.equal(a, c[tuple(slice(0, n) for n in a.shape)])
    if item == "11d":
        e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        for i, layer in enumerate(local["layers"]):
            got = {k: tuple(v.shape) for k, v in layer["moe"].items()}
            assert got == {"router": (d, e // model),
                           "wi": (e // model, d, f),
                           "wg": (e // model, d, f),
                           "wo": (e // model, f, d)}, (i, got)
        return
    layers = local.get("layers") or local["decoder"]
    attn = layers[0].get("attn") or layers[0]["self_attn"]
    assert tuple(attn["wq"].shape) == (cfg.d_model, cfg.num_heads,
                                       cfg.head_dim_)
    assert layers[0]["mlp"]["wi"].shape[1] == cfg.d_ff // model
    dh, hkv = cfg.head_dim_, cfg.num_kv_heads
    cross = {"encdec": cfg.encoder_seq,
             "vlm": cfg.num_image_tokens}.get(cfg.family)
    for length, want in ((16, (2, 16 // model, hkv, dh)),
                         (18, (2, 18, hkv, dh // model))):
        assert (2,) + L.cache_block(cfg, length, model) == want
        if cfg.family == "encdec":
            # its cache runs the encoder, whose row sums need the ranks
            # (test_torch_tp_fallback.py serves it on them)
            continue
        es = extra_embed_shape(cfg, 2)
        with L.batch_sharding(mesh):
            cache = m.init_cache(local, 2, length,
                                 None if es is None else torch.ones(es))
        got = ranks._cache_shapes(cache)
        assert got["k"] == got["v"] == [want], (length, got)
        if cross is not None:
            block = (2, cross // model, hkv, dh) if cross % model == 0 \
                else (2, cross, hkv, dh // model)
            assert got["ck"] == got["cv"] == [block], got


@pytest.mark.parametrize("leaf", ["wo", "wk", "mlp-wg"])
def test_a_whole_leaf_beside_a_split_partner_is_refused(leaf):
    """A placement that splits one of a row-parallel group and leaves
    a partner whole (as a hand-made ``shardings=`` could) is refused
    before a step: ``wo`` whole beside a split ``wq``, ``wk`` whole
    beside a split ``wv``, ``wg`` beside split ``wi`` / ``wo``."""
    cfg = get_smoke_config("qwen2-72b")
    mesh = StandIn(1, 2)
    params = convert.shard_params(
        cfg, get_model(cfg).init(0, device="cpu"), mesh)
    whole = get_model(cfg).init(0, device="cpu")["layers"][1]
    if leaf == "mlp-wg":
        params["layers"][1]["mlp"]["wg"] = whole["mlp"]["wg"]
        match = r"layer 1 mlp: \['wi', 'wo'\] split but \['wg'\] whole"
    else:
        params["layers"][1]["attn"][leaf] = whole["attn"][leaf]
        match = "layer 1 attention"
    with pytest.raises(ValueError, match=match):
        check_model_axis(cfg, params, mesh)


def test_a_whole_wk_and_wv_beside_a_split_wq_is_the_t_fallback():
    """A whole ``wk`` / ``wv`` beside split ``wq`` / ``wo`` is served,
    and the KV cache follows ``cache_pspecs`` on its own shape: at M = 4
    the rules leave the 2 KV heads whole beside 2 of 8 heads a rank, so
    the cache goes over T (16 keys), or over the head dim (32 in blocks
    of 8) where 4 does not divide T (18); at M = 2, where the rules
    would split them, a ``wk`` / ``wv`` left whole by hand still gives
    a cache of the rank's KV heads (test_torch_tp_fallback.py serves
    the rules' layouts)."""
    cfg = get_smoke_config("qwen2-72b")
    model = get_model(cfg)
    whole = model.init(0, device="cpu")
    dh, hkv = cfg.head_dim_, cfg.num_kv_heads
    mesh = StandIn(1, 4)
    params = convert.shard_params(cfg, whole, mesh)
    assert params["layers"][0]["attn"]["wk"].shape[1] == hkv
    check_model_axis(cfg, params, mesh)
    for length, want in ((16, (3, 4, hkv, dh)), (18, (3, 18, hkv, dh // 4))):
        assert [L.cache_axis(cfg, length, L.model_split(cfg, p))
                for p in params["layers"]] == [
            "t" if length == 16 else "dh"] * 2
        with L.batch_sharding(mesh):
            cache = model.init_cache(params, 3, length)
        assert [tuple(c["k"].shape) for c in cache] == [want, want]
    mesh = StandIn(1, 2)
    params = convert.shard_params(cfg, whole, mesh)
    for leaf in ("wk", "wv", "bk", "bv"):
        params["layers"][1]["attn"][leaf] = whole["layers"][1]["attn"][leaf]
    check_model_axis(cfg, params, mesh)
    assert [L.model_split(cfg, p) for p in params["layers"]] == [2, 2]
    cache = model.init_cache(params, 3, 16)
    assert [tuple(c["k"].shape) for c in cache] == [(3, 16, hkv // 2, dh)] * 2


def test_whisper_at_model_8_names_11b_4_before_drawing():
    """whisper-large-v3's 20 heads and 1500 cross frames do not divide
    8 (nor 16): before drawing, its rank blocks pass the partner checks
    (attention whole, d_ff split), and ``cache_pspecs``' rule puts its
    448-position self caches over T and its cross K/V over the head dim
    (64 in blocks of 8, of 4 at M = 16)."""
    from repro_torch.models.encdec import init_encdec
    cfg = get_config("whisper-large-v3")
    meta = init_encdec(cfg, torch.Generator(), torch.device("meta"))
    for model in (8, 16):
        mesh = StandIn(1, model)
        local = convert._local_meta(meta, mesh)
        check_model_axis(cfg, local, mesh)
        layer = local["decoder"][0]
        assert layer["self_attn"]["wq"].shape[1] == 20
        assert L.model_split(cfg, layer) == model
        assert L.cache_axis(cfg, 448, model) == "t"
        assert L.cache_axis(cfg, cfg.encoder_seq, model) == "dh"
        assert L.cache_block(cfg, cfg.encoder_seq, model) == (
            1500, 20, 64 // model)


def test_training_and_sequence_parallelism_over_the_model_axis_name_11c():
    """Sequence parallelism (item 10) and training over the model axis
    are ported (``test_torch_seq_parallel.py``,
    ``test_torch_tp_train*.py``): a sequence axis without a mesh
    declares nothing, and only the model axis splits the sequence; the
    model axis still needs its ranks and its declared mesh."""
    L.set_batch_sharding(("data",), "model", model_size=2)
    assert L.seq_mesh(32) is None and L.declared_mesh() is None
    with pytest.raises(ValueError, match="over the model axis only"):
        L.set_batch_sharding(("data",), "data", model_size=2)
    L.set_batch_sharding(None)
    with pytest.raises(ValueError, match="needs 2 ranks but only 1"):
        mesh_lib.make_host_mesh(1, 2)
    cfg = ModelConfig(**ranks.DECODE_LM)
    with pytest.raises(ValueError, match="not a block of the declared"):
        L.embed({"table": torch.zeros(32, 64)}, cfg,
                torch.zeros(1, 1, dtype=torch.int64))
