"""The port's side of the tensor-parallel serving tests: functions that
run on every rank of a gloo world on the CPU (``launch.mesh.spawn``).

Not collected, and imports torch, numpy and ``repro_torch`` only (a
spawned rank imports this module afresh). Inputs arrive as numpy trees
(the reference's own params) or as a checkpoint directory; every
function returns, from every rank, its tokens and logits as numpy
arrays, what it saw of its blocks and collectives, and whether every
rank of the world held the same results (``all_equal``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import checkpoint, serving
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.models import convert, extra_embed_shape, get_model
from repro_torch.models import layers as L

# the reference side's constants (torch_tp_ref), repeated here: a rank
# must not import jax
DECODE_LM = dict(family="dense", num_layers=2, d_model=64, num_heads=4,
                 num_kv_heads=4, d_ff=128, vocab_size=128, remat=False)
STEP_BATCH, STEP_LEN, STEPS = 8, 16, 4
ENGINE_ARCHS = ("gemma3-12b", "qwen2-72b")
SERVE = dict(slots=4, max_len=48, page_size=8, prefill_batch=4)
PROMPTS = [(0, 5, 12), (1, 19, 9), (2, 3, 16), (3, 11, 7), (4, 26, 10),
           (5, 8, 14)]
EMBED_TOKENS = np.random.RandomState(5).randint(0, 512, size=(3, 7))
SAMPLE_TEMPERATURE, SAMPLE_SEED = 0.8, 3
SAMPLED_ARCH = "gemma3-12b"    # the windowed ring, both axes
# torch_tp_more_ref's constants
FALLBACK_LM = dict(DECODE_LM, num_kv_heads=2)
RING_T = 4
RING_LM = dict(FALLBACK_LM, sliding_window=RING_T, global_every=2)
FALLBACK_STEPS = {"": STEPS, "-ring": 3 * RING_T}
FALLBACK_ENGINES = ("qwen2.5-3b", "gemma3-12b", "llama-3.2-vision-11b")
GENERATE = ("whisper-large-v3", "mamba2-1.3b", "zamba2-1.2b")
GEN_B, GEN_S, GEN_N = 4, 8, 6
DH_CASES = (("whisper-t", "whisper-large-v3", {}, (1, 8), 16),
            ("whisper-dh", "whisper-large-v3", {}, (1, 8), 14),
            ("whisper-cross-dh", "whisper-large-v3", {"encoder_seq": 20},
             (1, 8), 14),
            ("qwen-1x4", "qwen2.5-3b", {}, (1, 4), 18),
            ("qwen-2x4", "qwen2.5-3b", {}, (2, 4), 18))
DH_BATCH, DH_STEPS = 4, 8
DH_CONTROL = "whisper-dh"       # the case run again with the row sum left out
# the engine of case B: qwen2.5-3b's pool of 42 keys (pages of 6) at
# (1, 4), over the head dim
DH_SERVE = dict(slots=4, max_len=42, page_size=6, prefill_batch=4)
DH_TRAIN_MESH = (1, 8)


def dh_start(vocab: int) -> np.ndarray:
    return np.random.RandomState(31).randint(
        1, vocab, size=(DH_BATCH, 1)).astype(np.int32)


def prompts(vocab: int) -> list:
    return [(np.random.RandomState(s).randint(1, vocab, size=n), new)
            for s, n, new in PROMPTS]


def varied_tokens() -> np.ndarray:
    return np.random.RandomState(11).randint(
        1, DECODE_LM["vocab_size"], size=(STEP_BATCH, 1)).astype(np.int32)


def drain(model, params, mesh=None, eng=None, extra=None,
          temperature: float = 0.0, serve: dict = SERVE) -> dict:
    """Serve :data:`PROMPTS` through an engine (``eng``, or one on
    ``params`` and ``mesh``, greedy or sampled at ``temperature``); its
    tokens per request, its stats, its KV pool's shape (and a cross
    layer's) and the mesh's collective counts."""
    if eng is None:
        sc = serving.ServeConfig(**serve, sampling=serving.SamplingParams(
            temperature=temperature, seed=SAMPLE_SEED))
        eng = serving.Engine(model, params, sc, device="cpu", mesh=mesh,
                             extra=extra)
    if mesh is not None:
        mesh.collectives.clear()
    ids = [eng.submit(p, max_new_tokens=n)
           for p, n in prompts(model.cfg.vocab_size)]
    got = {r.id: r.tokens for r in eng.drain()}
    cross = [tuple(c["ck"].shape) for c in eng._kv.cache if "ck" in c]
    return {"tokens": [got[i] for i in ids], "stats": eng.stats(),
            "pool": tuple(eng._kv.cache[0]["k"].shape),
            "cross_pool": cross[0] if cross else None,
            "collectives": {k: dict(v) for k, v in
                            (mesh.collectives.items() if mesh else ())}}


def _serve_step_run(model, params, mesh, start, steps: int = STEPS,
                    cache=None) -> tuple:
    """``steps`` steps of ``make_serve_step(model, mesh)`` from
    ``start`` (its rows), each step's logits read first by
    ``decode_step`` on a copy of the cache (``cache``, or a new one of
    :data:`STEP_LEN`)."""
    step = serving.make_serve_step(model, mesh)
    if cache is None:
        cache = model.init_cache(params, start.shape[0], STEP_LEN)
    tok = torch.from_numpy(start)
    toks, logits = [], []
    for i in range(steps):
        copy = [{k: v.clone() for k, v in c.items()} for c in cache]
        with L.batch_sharding(mesh):
            logits.append(model.decode_step(params, copy, tok, i)[0]
                          .numpy())
        tok, cache = step(params, cache, tok, i)
        toks.append(tok.numpy())
    return np.stack(toks), np.stack(logits)


def step_world(ref_params) -> dict:
    """The reference's ``DECODE_SCRIPT`` step on a (2, 4) mesh of this
    world's 8 ranks, on the reference's params placed by
    ``shard_params``."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_host_mesh(2, 4)
    cfg = ModelConfig(**DECODE_LM)
    model = get_model(cfg)
    params = convert.shard_params(
        cfg, convert.params_from_jax(cfg, ref_params, device="cpu"), mesh)
    out = {"coords": dict(mesh.coords),
           "wq": tuple(params["layers"][0]["attn"]["wq"].shape),
           "table": tuple(params["embed"]["table"].shape)}
    for tag, start in (("", np.ones((STEP_BATCH, 1), np.int32)),
                       ("-varied", varied_tokens())):
        out[f"tokens{tag}"], out[f"logits{tag}"] = _serve_step_run(
            model, params, mesh, start)
    out["equal"] = mesh_lib.all_equal(
        mesh, [out[k].tobytes() for k in ("tokens", "logits",
                                          "tokens-varied",
                                          "logits-varied")])
    return out


def engine_world(data: int, model_axis: int, ref_params: dict,
                 ckpt: str) -> dict:
    """The engine on a (data, model) mesh of this world, for each arch
    of :data:`ENGINE_ARCHS`: on its blocks of the seed-0 draw
    (``Model.init(0, mesh=)``), on the reference's params
    (``params_from_jax`` then ``shard_params``), and restored from the
    seed-0 draw's checkpoint replicated (``mesh=``) and split
    (``shardings=``); then the vocab-parallel embedding of
    :data:`EMBED_TOKENS`."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_host_mesh(data, model_axis)
    out = {"coords": dict(mesh.coords)}
    for arch in ENGINE_ARCHS:
        cfg = get_smoke_config(arch)
        model = get_model(cfg)
        params = model.init(0, device="cpu", mesh=mesh)
        res = {"init": drain(model, params, mesh),
               "sampled": drain(model, params, mesh,
                                temperature=SAMPLE_TEMPERATURE)
               if arch == SAMPLED_ARCH else None,
               "init_shapes": {
                   "wq": tuple(params["layers"][0]["attn"]["wq"].shape),
                   "wi": tuple(params["layers"][0]["mlp"]["wi"].shape),
                   "table": tuple(params["embed"]["table"].shape)},
               "init_leaves": [t.numpy().copy() for t in
                               (params["layers"][0]["attn"]["wq"],
                                params["embed"]["table"])]}
        res["ref"] = drain(model, convert.shard_params(
            cfg, convert.params_from_jax(cfg, ref_params[arch],
                                         device="cpu"), mesh), mesh)
        path = f"{ckpt}/{arch}"
        sc = serving.ServeConfig(**SERVE)
        res["restored"] = drain(model, None, mesh, serving.Engine
                                .from_checkpoint(path, model, sc,
                                                 device="cpu", mesh=mesh))
        split = sharding.named(mesh, sharding.state_pspecs(
            mesh, convert.jax_template(cfg)))
        eng = serving.Engine.from_checkpoint(path, model, sc, device="cpu",
                                             shardings=split)
        res["split"] = drain(model, None, mesh, eng)
        res["split_table"] = tuple(eng.params["embed"]["table"].shape)
        with L.batch_sharding(mesh):
            res["embed"] = L.embed(params["embed"], cfg, torch.from_numpy(
                EMBED_TOKENS)).numpy()
        out[arch] = res
    out["equal"] = mesh_lib.all_equal(mesh, [
        [out[a][k]["tokens"] for k in ("init", "ref", "restored", "split")]
        for a in ENGINE_ARCHS])
    # the data column's collectives and a save of split leaves, which
    # training over the model axis uses (each model rank keeps its own)
    mine = torch.full((4,), float(mesh.rank))
    mesh.mean_([mine])
    copied = torch.full((4,), float(mesh.rank))
    mesh.broadcast_([copied])
    whole = torch.arange(8 * mesh.shape["model"], dtype=torch.float32) \
        .reshape(2, -1)
    spec = sharding.P(None, "model")
    block = whole[sharding.local_block(spec, mesh, whole.shape)]
    path = f"{ckpt}/split-save"
    checkpoint.save(path, {"a": block}, mesh=mesh,
                    shardings=sharding.named(mesh, {"a": spec}))
    back = checkpoint.restore(path, {"a": whole}, device="cpu")["a"]
    out["column"] = {"mean_": mine.tolist(), "broadcast_": copied.tolist(),
                     "save": bool(torch.equal(back, whole)),
                     "provenance": checkpoint.saved_shardings(path)}
    return out


def gen_prompts(vocab: int) -> np.ndarray:
    return np.random.RandomState(21).randint(1, vocab, size=(GEN_B, GEN_S))


def extra_rows(shape) -> np.ndarray:
    return np.random.RandomState(23).normal(size=shape).astype(np.float32)


def _extra(cfg, batch: int):
    es = extra_embed_shape(cfg, batch)
    return None if es is None else torch.from_numpy(extra_rows(es))


def _cache_shapes(cache) -> dict:
    """A cache's leaf shapes by leaf name (dict keys, SSMCache
    fields)."""
    out: dict = {}

    def walk(node, name=None):
        if isinstance(node, torch.Tensor):
            out.setdefault(name, set()).add(tuple(node.shape))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif hasattr(node, "_fields"):
            for k, v in zip(node._fields, node):
                walk(v, k)
        else:
            for v in node:
                walk(v, name)

    walk(cache)
    return {k: sorted(v) for k, v in out.items()}


def dh_step(case: tuple, ref_params: dict, mesh) -> dict:
    """One case of :data:`DH_CASES` on ``mesh`` (this rank a member), on
    the reference's params placed by ``shard_params``: the decode from
    :func:`dh_start` for :data:`DH_STEPS` steps, each data row on its
    block of the batch, the tokens and logits gathered over the data
    column; the cache's leaf shapes, the row's collectives and whether
    the mesh's ranks hold the same tokens and logits."""
    _, arch, edits, _, length = case
    cfg = get_smoke_config(arch).replace(**edits)
    model = get_model(cfg)
    params = convert.shard_params(cfg, convert.params_from_jax(
        cfg, ref_params, device="cpu"), mesh)
    rows = mesh.data_block(DH_BATCH)
    extra = _extra(cfg, DH_BATCH)
    with L.batch_sharding(mesh):
        cache = model.init_cache(params, rows.stop - rows.start, length,
                                 *(() if extra is None else (extra[rows],)))
    shapes = _cache_shapes(cache)
    mesh.collectives.clear()
    toks, logits = _serve_step_run(model, params, mesh,
                                   dh_start(cfg.vocab_size)[rows], DH_STEPS,
                                   cache)
    out = {"cache": shapes,
           "collectives": {k: v["calls"] for k, v in
                           mesh.collectives.items()},
           "tokens": mesh.data_gather(torch.from_numpy(toks), 1).numpy(),
           "logits": mesh.data_gather(torch.from_numpy(logits), 1).numpy()}
    # over the case mesh's ranks (the ranks past a narrower mesh sit out)
    out["equal"] = mesh_lib.all_equal(mesh, [out["tokens"].tobytes(),
                                             out["logits"].tobytes()])
    return out


def unsummed_scores():
    """The Dh split's fault: ``Mesh.model_sum_`` leaves the partial
    scores (``score_sum``) unsummed, each rank applying its own."""
    import contextlib
    from repro_torch.distributed import Mesh
    real = Mesh.model_sum_

    def model_sum_(self, t, name="model_sum"):
        return t if name == "score_sum" else real(self, t, name)

    @contextlib.contextmanager
    def patched():
        Mesh.model_sum_ = model_sum_
        try:
            yield
        finally:
            Mesh.model_sum_ = real
    return patched()


def dh_world(dh_params: dict, train_jobs: tuple) -> dict:
    """Every case of :data:`DH_CASES` on its mesh of this world's first
    ranks (the :data:`DH_CONTROL` case again under
    :func:`unsummed_scores`), then one tree TVLARS step of each
    ``(arch, params, batch)`` of ``train_jobs`` on a
    :data:`DH_TRAIN_MESH` mesh (``torch_tp_train_families_ranks.step``:
    the heads whole). A rank past a mesh sits its case out."""
    import torch_tp_train_families_ranks as train_ranks
    out: dict = {}
    for case in DH_CASES:
        mesh = mesh_lib.make_host_mesh(*case[3])
        if not mesh.member:
            continue
        out[case[0]] = dh_step(case, dh_params[case[1]], mesh)
        if case[0] == DH_CONTROL:
            with unsummed_scores():
                out["control"] = dh_step(case, dh_params[case[1]], mesh)
    mesh = mesh_lib.make_host_mesh(*DH_TRAIN_MESH)
    for arch, params_np, batch_np in train_jobs:
        out[f"train/{arch}"] = train_ranks.step(arch, params_np, batch_np,
                                                "tree", mesh)
    return out


def fallback_step_world(ref_params: dict, dh_params: dict,
                        train_jobs: tuple) -> dict:
    """The ``FALLBACK_LM`` step (2 KV heads: the cache over T) and its
    windowed twin on a (2, 4) mesh of this world's 8 ranks, on the
    reference's params placed by ``shard_params``: each data row steps
    its half of the batch, the tokens and logits gathered over the data
    column. Then :func:`dh_world` (under ``"dh"``)."""
    torch.set_num_threads(1)
    out = {"dh": dh_world(dh_params, train_jobs)}
    mesh = mesh_lib.make_host_mesh(2, 4)
    out["coords"] = dict(mesh.coords)
    rows = mesh.data_block(STEP_BATCH)
    for tag, lm in (("", FALLBACK_LM), ("-ring", RING_LM)):
        cfg = ModelConfig(**lm)
        model = get_model(cfg)
        params = convert.shard_params(cfg, convert.params_from_jax(
            cfg, ref_params[tag], device="cpu"), mesh)
        with L.batch_sharding(mesh):
            cache = model.init_cache(params, rows.stop - rows.start,
                                     STEP_LEN)
        out[f"{tag}/cache"] = [tuple(c["k"].shape) for c in cache]
        out[f"{tag}/wk"] = tuple(params["layers"][0]["attn"]["wk"].shape)
        out[f"{tag}/wq"] = tuple(params["layers"][0]["attn"]["wq"].shape)
        for start, tok in (("", np.ones((STEP_BATCH, 1), np.int32)),
                           ("-varied", varied_tokens())):
            mesh.collectives.clear()
            toks, logits = _serve_step_run(model, params, mesh, tok[rows],
                                           FALLBACK_STEPS[tag])
            out[f"{tag}{start}/collectives"] = {
                k: v["calls"] for k, v in mesh.collectives.items()}
            out[f"{tag}{start}/tokens"] = mesh.data_gather(
                torch.from_numpy(toks), 1).numpy()
            out[f"{tag}{start}/logits"] = mesh.data_gather(
                torch.from_numpy(logits), 1).numpy()
    out["equal"] = mesh_lib.all_equal(mesh, [
        out[k].tobytes() for k in sorted(out) if k.endswith(("tokens",
                                                             "logits"))])
    return out


def fallback_engine_world(ref_params: dict) -> dict:
    """The engine on a (1, 4) mesh (the cache over T for every arch of
    ``FALLBACK_ENGINES``) on the reference's params, placed by
    ``shard_params``; qwen2.5-3b's again on a pool of :data:`DH_SERVE`
    (42 keys: over the head dim, case B)."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_host_mesh(1, 4)
    out = {"coords": dict(mesh.coords)}
    for arch in FALLBACK_ENGINES:
        cfg = get_smoke_config(arch)
        model = get_model(cfg)
        ref = convert.shard_params(cfg, convert.params_from_jax(
            cfg, ref_params[arch], device="cpu"), mesh)
        out[arch] = {"ref": drain(model, ref, mesh,
                                  extra=_extra(cfg, SERVE["slots"]))}
        if arch == "qwen2.5-3b":
            out["dh"] = drain(model, ref, mesh, serve=DH_SERVE)
    out["equal"] = mesh_lib.all_equal(
        mesh, [out[a]["ref"]["tokens"] for a in FALLBACK_ENGINES]
        + [out["dh"]["tokens"]])
    return out


def families_world(data: int, model_axis: int, ref_params: dict) -> dict:
    """The vlm engine and ``generate`` for the encdec, ssm and hybrid
    smoke configs on a (data, model) mesh, on the reference's params
    and on this rank's blocks of the seed-0 draw; each one's cache
    leaves by name as this rank holds them."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_host_mesh(data, model_axis)
    out = {"coords": dict(mesh.coords)}
    arch = "llama-3.2-vision-11b"
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    extra = _extra(cfg, SERVE["slots"])
    ref = convert.shard_params(cfg, convert.params_from_jax(
        cfg, ref_params[arch], device="cpu"), mesh)
    eng = serving.Engine(model, ref, serving.ServeConfig(**SERVE),
                         device="cpu", mesh=mesh, extra=extra)
    out[arch] = {"ref": drain(model, ref, mesh, eng),
                 "cache": _cache_shapes(eng._kv.cache)}
    for arch in GENERATE:
        cfg = get_smoke_config(arch)
        model = get_model(cfg)
        extra = _extra(cfg, GEN_B)
        prompt = gen_prompts(cfg.vocab_size)
        res = {}
        for source, params in (
                ("ref", convert.shard_params(cfg, convert.params_from_jax(
                    cfg, ref_params[arch], device="cpu"), mesh)),
                ("init", model.init(0, device="cpu", mesh=mesh))):
            mesh.collectives.clear()
            res[source] = serving.generate(
                model, params, prompt, num_tokens=GEN_N, extra_embeds=extra,
                device="cpu", mesh=mesh).numpy()
            res[f"{source}/collectives"] = {
                k: v["calls"] for k, v in mesh.collectives.items()}
        rows = mesh.data_block(GEN_B)
        with L.batch_sharding(mesh):
            cache = model.init_cache(
                params, rows.stop - rows.start, GEN_S + GEN_N,
                *(() if extra is None else (extra[rows],)))
        res["cache"] = _cache_shapes(cache)
        out[arch] = res
    out["equal"] = mesh_lib.all_equal(mesh, [
        out["llama-3.2-vision-11b"]["ref"]["tokens"]] + [
        [out[a][s].tolist() for s in ("ref", "init")] for a in GENERATE])
    return out


PREFIX_ARCH, PREFIX_MESH = "qwen2.5-3b", (1, 2)
PREFIX_SERVE = dict(slots=2, max_len=32, page_size=8, prefill_batch=2)
PREFIX_PROMPTS = [(0, 5, 4), (1, 9, 3), (2, 3, 5)]


def prefix_drain(mesh=None) -> list:
    """The tokens of :data:`PREFIX_PROMPTS` through an engine on this
    rank's blocks of the seed-0 draw of :data:`PREFIX_ARCH` (whole
    without a mesh)."""
    model = get_model(get_smoke_config(PREFIX_ARCH))
    params = model.init(0, device="cpu", mesh=mesh)
    eng = serving.Engine(model, params, serving.ServeConfig(**PREFIX_SERVE),
                         device="cpu", mesh=mesh)
    ids = [eng.submit(np.random.RandomState(s).randint(
        1, model.cfg.vocab_size, size=n), max_new_tokens=new)
        for s, n, new in PREFIX_PROMPTS]
    got = {r.id: r.tokens for r in eng.drain()}
    return [got[i] for i in ids]


def prefix_engine_world():
    """An engine on a :data:`PREFIX_MESH` mesh of this world's first
    ranks; a rank past the mesh builds the mesh (its groups are made
    over the world) and serves nothing (None)."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_host_mesh(*PREFIX_MESH)
    if not mesh.member:
        return None
    return prefix_drain(mesh)
