"""The KV cache split over T (``cache_pspecs``' T fallback: the model
axis divides the heads but not the KV heads) in the port, against the
JAX package and the port's single-rank path, on the CPU.

The reference side runs once, in a subprocess that fabricates 8 host
devices before jax is imported (``torch_tp_more_ref.main("fallback",
...)``), while the port's ranks run in gloo worlds of 8 and 4 ranks,
spawned once each (``torch_tp_ranks``).

* The decode kernel's partial mode, in its plain version (the CPU's):
  the caches' blocks of T launched with their offsets and merged
  (``merge_partials``) equal the unsplit launch and the JAX package's
  oracle, on global and ring layers past several laps, rows with no
  key in a block give out 0 and lse -inf and no NaN, and an append
  lands in the owning block only.
* The reference test's ``DECODE_SCRIPT`` model with 2 KV heads on a
  ``(2, 4)`` mesh (``cache_pspecs`` puts T on "model"), and its twin
  with a sliding-window ring of 4 keys (1 a rank) run 3 laps: the
  port's ``(2, 4)`` step, each data row on its half of the batch, gives
  the reference's own ``(2, 4)`` tokens every step, and logits within
  ``decode_parity_tolerance("float32")``.
* The engine at ``(1, 4)`` for the qwen2.5-3b, gemma3 and vlm smoke
  configs, on the reference's params, gives the reference engine's
  tokens and the port's M = 1 engine's; a rank's pool is its block of
  T of every KV head (the vlm's cross K/V too).
"""
from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_more_ref as ref_side
import torch_tp_ranks as ranks
import torch_tp_train_families_ref as train_ref
from repro.kernels.ref import decode_parity_tolerance, ref_attention_decode
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import attention_decode as tad
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import convert, get_model
from repro_torch.models import layers as L

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
ENGINES = ref_side.FALLBACK_ENGINES
DH_ENGINE = "qwen2.5-3b"
DH_TAGS = [case[0] for case in ref_side.DH_CASES]
TAGS = ("", "-ring")
F32 = decode_parity_tolerance("float32")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _step_params(lm: dict):
    from repro.configs.base import ModelConfig as JConfig
    from repro.models import get_model as jget
    return _np(jget(JConfig(**lm)).init(jax.random.PRNGKey(0)))


def start_reference(what: str, out: str) -> subprocess.Popen:
    """``torch_tp_more_ref.main(what, out)`` in a subprocess with 8
    fabricated host devices."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
        + " --xla_cpu_multi_thread_eigen=false").strip(),
        OMP_NUM_THREADS="1",
        PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                    os.path.join(ROOT, "tests")]))
    return subprocess.Popen(
        [sys.executable, "-c",
         f"import torch_tp_more_ref as r; r.main({what!r}, {out!r})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def finish_reference(proc: subprocess.Popen, out: str) -> dict:
    try:
        log, _ = proc.communicate(timeout=TIMEOUT_S)
        assert proc.returncode == 0, log.decode()[-4000:]
        with np.load(out) as z:
            return {k: z[k] for k in z.files}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tpf") / "ref.npz")
    proc = start_reference("fallback", out)
    try:
        step_params = {tag: _step_params(lm) for tag, lm in
                       (("", ref_side.FALLBACK_LM),
                        ("-ring", ref_side.RING_LM))}
        engine_params = {a: ref_side.reference_params(a) for a in ENGINES}
        dh_params = {a: ref_side.reference_params(a)
                     for a in {case[1] for case in ref_side.DH_CASES}}
        train_inputs = {arch: train_ref.inputs(arch)
                        for arch, _, _ in ref_side.DH_TRAIN}
        single = {}
        for arch in ENGINES:
            cfg = get_smoke_config(arch)
            model = get_model(cfg)
            extra = ranks._extra(cfg, ranks.SERVE["slots"])
            single[arch] = ranks.drain(model, convert.params_from_jax(
                cfg, engine_params[arch], device="cpu"),
                extra=extra)["tokens"]
        cfg = get_smoke_config(DH_ENGINE)
        single["dh"] = ranks.drain(get_model(cfg), convert.params_from_jax(
            cfg, engine_params[DH_ENGINE], device="cpu"),
            serve=ranks.DH_SERVE)["tokens"]
        jobs = tuple((arch,) + train_inputs[arch]
                     for arch, _, _ in ref_side.DH_TRAIN)
        step = mesh_lib.spawn(ranks.fallback_step_world, 8, "gloo", "cpu",
                              args=(step_params, dh_params, jobs),
                              timeout=TIMEOUT_S)
        engine = mesh_lib.spawn(ranks.fallback_engine_world, 4, "gloo",
                                "cpu", args=(engine_params,),
                                timeout=TIMEOUT_S)
    finally:
        reference = finish_reference(proc, out)
    return {"ref": reference, "step": step, "engine": engine,
            "single": single, "step_params": step_params,
            "engine_params": engine_params, "dh_params": dh_params,
            "train_inputs": train_inputs}


def _leaves(res: dict, key: str) -> list:
    n = sum(1 for k in res if k.startswith(key + "/")
            and k[len(key) + 1:].isdigit())
    return [res[f"{key}/{i}"] for i in range(n)]


def test_reference_inputs_are_the_tests(runs):
    pairs = [(f"step{t}/params", runs["step_params"][t]) for t in TAGS] + [
        (f"engine/{a}/params", runs["engine_params"][a]) for a in ENGINES]
    for key, tree in pairs:
        got = _leaves(runs["ref"], key)
        want = jax.tree_util.tree_leaves(tree)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            b = np.asarray(b)
            assert np.array_equal(a, b.view(np.uint16)
                                  if str(b.dtype) == "bfloat16" else b)


@pytest.mark.parametrize("tag", TAGS, ids=["global", "ring"])
def test_reference_puts_the_kv_cache_over_t(runs, tag):
    """The layout under test: cache_pspecs gives the first K cache
    ('data' on B, 'model' on T), 2 KV heads not dividing 4."""
    assert str(runs["ref"][f"step{tag}/kspec"]) == \
        "(None, 'data', 'model', None, None)"
    for r in runs["step"]:
        t = [ref_side.RING_T if tag and i == 0 else ranks.STEP_LEN
             for i in range(2)]
        assert r[f"{tag}/cache"] == [(ranks.STEP_BATCH // 2, n // 4, 2, 16)
                                     for n in t]
        assert r[f"{tag}/wq"] == (64, 1, 16) and r[f"{tag}/wk"] == (64, 2, 16)


@pytest.mark.parametrize("start", ["", "-varied"])
@pytest.mark.parametrize("tag", TAGS, ids=["global", "ring"])
def test_step_on_2x4_gives_the_reference_2x4_tokens(runs, tag, start):
    ref = runs["ref"]
    np.testing.assert_array_equal(ref[f"step{tag}/mesh{start}/tokens"],
                                  ref[f"step{tag}/single{start}/tokens"])
    for r in runs["step"]:
        np.testing.assert_array_equal(r[f"{tag}{start}/tokens"],
                                      ref[f"step{tag}/mesh{start}/tokens"])
        np.testing.assert_allclose(r[f"{tag}{start}/logits"],
                                   ref[f"step{tag}/mesh{start}/logits"],
                                   rtol=F32["rtol"], atol=F32["atol"])
        assert r["equal"]


@pytest.mark.parametrize("tag", TAGS, ids=["global", "ring"])
def test_step_gathers_q_and_the_partials_once_a_layer(runs, tag):
    """Per step and layer: q and the (out, lse) partials gathered (2),
    wo and the MLP summed (2); then the embedding's sum and the logits'
    gather."""
    steps = ranks.FALLBACK_STEPS[tag]
    layers = ranks.DECODE_LM["num_layers"]
    for r in runs["step"]:
        # each step decodes twice: the logits read, then the step
        assert r[f"{tag}/collectives"] == {
            "model_sum": 2 * steps * (2 * layers + 1),
            "q_gather": 2 * steps * layers,
            "partial_gather": 2 * steps * layers,
            "model_gather": 2 * steps}


@pytest.mark.parametrize("arch", ENGINES)
def test_engine_on_1x4_gives_the_single_rank_tokens(runs, arch):
    want = runs["single"][arch]
    for r in runs["engine"]:
        assert r[arch]["ref"]["tokens"] == want
        assert r["equal"]
    got = [list(runs["ref"][f"engine/{arch}/tokens/{j}"])
           for j in range(len(ranks.PROMPTS))]
    assert want == got


@pytest.mark.parametrize("arch", ENGINES)
def test_engine_pool_is_a_block_of_t_of_every_kv_head(runs, arch):
    cfg = get_smoke_config(arch)
    sc = ranks.SERVE
    t = min(cfg.sliding_window or sc["max_len"], sc["max_len"])
    for r in runs["engine"]:
        got = r[arch]["ref"]
        assert got["pool"] == (sc["slots"], t // 4, cfg.num_kv_heads,
                               cfg.head_dim_)
        if cfg.family == "vlm":
            assert got["cross_pool"] == (sc["slots"],
                                         cfg.num_image_tokens // 4,
                                         cfg.num_kv_heads, cfg.head_dim_)


# ------------------------------------------------- the partial mode, plain
B, H, HKV, DH, T, M = 4, 8, 2, 32, 16, 4
CASES = {  # window, positions (rows whose block holds no key included)
    "global": (None, [0, 3, 7, 15]),
    "ring-first-lap": (T, [0, 3, 7, 15]),
    "ring-laps": (T, [16, 21, 33, 4 * T + 5]),
    "short-window": (6, [2, 9, 30, 3 * T + 1]),
}


def _operands(seed: int = 0):
    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g)

    return (randn(B, 1, H, DH), randn(B, 1, HKV, DH), randn(B, 1, HKV, DH),
            randn(B, T, HKV, DH), randn(B, T, HKV, DH))


def _split(q, nk, nv, kc, vc, pos, window):
    """Each block of T launched in the partial mode on a copy of its
    block: (outs, lses, blocks of K, blocks of V)."""
    n = T // M
    outs, lses, ks, vs = [], [], [], []
    for r in range(M):
        kb = kc[:, r * n:(r + 1) * n].clone()
        vb = vc[:, r * n:(r + 1) * n].clone()
        o, lse = ops.attention_decode(q, nk, nv, kb, vb, pos, window=window,
                                      t0=r * n, t_total=T, return_lse=True)
        outs.append(o)
        lses.append(lse)
        ks.append(kb)
        vs.append(vb)
    return outs, lses, ks, vs


@pytest.mark.parametrize("case", list(CASES))
def test_partials_merged_equal_the_unsplit_launch_and_the_oracle(case):
    window, positions = CASES[case]
    q, nk, nv, kc, vc = _operands()
    pos = torch.tensor(positions, dtype=torch.int32)
    kw, vw = kc.clone(), vc.clone()
    whole = ops.attention_decode(q, nk, nv, kw, vw, pos, window=window)
    outs, lses, ks, vs = _split(q, nk, nv, kc, vc, pos, window)
    merged = tad.merge_partials(outs, lses)
    torch.testing.assert_close(merged, whole, rtol=F32["rtol"],
                               atol=F32["atol"])
    o, kj, vj = ref_attention_decode(
        jnp.asarray(q.numpy()), jnp.asarray(nk.numpy()),
        jnp.asarray(nv.numpy()), jnp.asarray(kc.numpy()),
        jnp.asarray(vc.numpy()), jnp.asarray(pos.numpy()), window=window)
    np.testing.assert_allclose(merged.numpy(), np.asarray(o),
                               rtol=F32["rtol"], atol=F32["atol"])
    # the blocks, put together, are the oracle's appended caches
    assert np.array_equal(torch.cat(ks, 1).numpy(), np.asarray(kj))
    assert np.array_equal(torch.cat(vs, 1).numpy(), np.asarray(vj))


@pytest.mark.parametrize("case", list(CASES))
def test_a_block_with_no_needed_key_gives_zero_and_minus_inf(case):
    window, positions = CASES[case]
    q, nk, nv, kc, vc = _operands(1)
    pos = torch.tensor(positions, dtype=torch.int32)
    outs, lses, _, _ = _split(q, nk, nv, kc, vc, pos, window)
    n = T // M
    for r, (o, lse) in enumerate(zip(outs, lses)):
        assert torch.isfinite(o).all() and not torch.isnan(lse).any()
        for b, p in enumerate(positions):
            # global layers need keys <= pos; a ring the slots of the
            # window's positions
            if window is None:
                keys = range(min(p, T - 1) + 1)
            else:
                keys = [(p - j) % T for j in range(min(window, T))
                        if p - j >= 0]
            empty = not any(r * n <= k < (r + 1) * n for k in keys)
            assert bool(torch.isneginf(lse[b]).all()) == empty, (r, b)
            if empty:
                assert not o[b].any()
    assert any(torch.isneginf(x).any() for x in lses) or case == "ring-laps"


@pytest.mark.parametrize("case", list(CASES))
def test_only_the_owning_block_takes_the_append(case):
    window, positions = CASES[case]
    q, nk, nv, kc, vc = _operands(2)
    pos = torch.tensor(positions, dtype=torch.int32)
    _, _, ks, vs = _split(q, nk, nv, kc, vc, pos, window)
    n = T // M
    for b, p in enumerate(positions):
        slot = p % T if window is not None else min(p, T - 1)
        for r in range(M):
            changed = ~torch.isclose(ks[r][b], kc[b, r * n:(r + 1) * n])
            rows = changed.any(-1).any(-1).nonzero().flatten().tolist()
            assert rows == ([slot - r * n] if r * n <= slot < (r + 1) * n
                            else []), (b, r)
            assert torch.equal(vs[r][b].ne(vc[b, r * n:(r + 1) * n])
                               .any(-1).any(-1),
                               changed.any(-1).any(-1))


def test_the_wrapper_refuses_a_block_outside_its_sequence():
    q, nk, nv, kc, vc = _operands()
    pos = torch.zeros(B, dtype=torch.int32)
    for t0, total in ((-1, T), (1, T), (T, T + 1)):
        with pytest.raises(ValueError, match="does not fit"):
            tad.attention_decode_cuda(q, nk, nv, kc, vc, pos, t0=t0,
                                      t_total=total)
        with pytest.raises(ValueError, match="does not fit"):
            tad.attention_decode_ref(q, nk, nv, kc.clone(), vc.clone(), pos,
                                     t0=t0, t_total=total)


def test_merge_weighs_each_block_by_its_lse():
    """The fault a chip phase must catch: blocks averaged without their
    lse weights give another result than the merge."""
    q, nk, nv, kc, vc = _operands(3)
    pos = torch.tensor([15, 9, 12, 6], dtype=torch.int32)
    outs, lses, _, _ = _split(q, nk, nv, kc, vc, pos, None)
    merged = tad.merge_partials(outs, lses)
    unweighted = sum(o for o in outs) / M
    assert (merged - unweighted).abs().max() > 0.1


def test_the_t_fallback_needs_the_kv_cache_to_divide():
    """The T fallback needs the KV cache's length to divide: the model
    axis (4) divides the 4 heads but not the 2 KV heads, so a cache of
    16 keys goes over T (4 a rank) and one of 18 over the head dim (16
    in blocks of 4, every key a rank); at 2 the KV heads take it, and
    on one rank the cache is whole."""
    cfg = ModelConfig(**ranks.FALLBACK_LM)
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_) == (4, 2, 16)
    assert L.cache_axis(cfg, 16, 4) == "t"
    assert L.cache_block(cfg, 16, 4) == (4, 2, 16)
    assert L.cache_axis(cfg, 18, 4) == "dh"
    assert L.cache_block(cfg, 18, 4) == (18, 2, 4)
    assert L.cache_axis(cfg, 18, 2) == "heads"
    assert L.cache_block(cfg, 18, 2) == (18, 1, 16)
    assert L.cache_axis(cfg, 18, 1) is None
    assert L.cache_block(cfg, 18, 1) == (18, 2, 16)
    narrow = ModelConfig(**dict(ranks.FALLBACK_LM, d_model=48, num_heads=12,
                                num_kv_heads=6))
    assert narrow.head_dim_ == 4 and L.cache_axis(narrow, 18, 8) is None
    with pytest.raises(ValueError, match="divide none of them"):
        L.cache_block(narrow, 18, 8)


# ------------------------------- the cache over Dh, and over T beside whole
# heads, on the reference's own mesh
def _dh_case(tag: str) -> tuple:
    return next(c for c in ref_side.DH_CASES if c[0] == tag)


def _dh_runs(runs, tag: str) -> list:
    """Every rank's result of case ``tag`` (the ranks of its mesh)."""
    return [r["dh"][tag] for r in runs["step"] if tag in r["dh"]]


def test_reference_dh_inputs_are_the_tests(runs):
    for arch, tree in runs["dh_params"].items():
        got = _leaves(runs["ref"], f"dh/{arch}/params")
        want = jax.tree_util.tree_leaves(tree)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            b = np.asarray(b)
            assert np.array_equal(a, b.view(np.uint16)
                                  if str(b.dtype) == "bfloat16" else b)
    for arch, (params, batch) in runs["train_inputs"].items():
        got = _leaves(runs["ref"], f"{arch}/inputs/params")
        want = jax.tree_util.tree_leaves(params)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        for k, v in batch.items():
            np.testing.assert_array_equal(v, runs["ref"][f"{arch}/inputs/{k}"])


@pytest.mark.parametrize("tag", DH_TAGS)
def test_reference_puts_the_caches_where_the_port_does(runs, tag):
    """``cache_pspecs``' specs of the first self and cross K caches on
    the case's mesh, and each rank's cache blocks: over T where the
    length divides, else over the head dim, the heads whole."""
    _, arch, edits, (d, m), length = _dh_case(tag)
    cfg = get_smoke_config(arch).replace(**edits)
    data = "'data'"            # B over the data axis, at D = 1 too
    axis = L.cache_axis(cfg, length, m)
    assert axis in ("t", "dh")
    spec = ["None", data, "None", "None", "None"]
    spec[2 if axis == "t" else 4] = "'model'"
    assert str(runs["ref"][f"dh/{tag}/kspec"]) == f"({', '.join(spec)})"
    b = ranks.DH_BATCH // d
    want = {"k": [(b,) + L.cache_block(cfg, length, m)]}
    if cfg.family == "encdec":
        cross = cfg.encoder_seq
        want["ck"] = [(b,) + L.cache_block(cfg, cross, m)]
        cspec = ["None", data, "None", "None", "None"]
        cspec[2 if cross % m == 0 else 4] = "'model'"
        assert str(runs["ref"][f"dh/{tag}/ckspec"]) == f"({', '.join(cspec)})"
    for r in _dh_runs(runs, tag):
        for name, shapes in want.items():
            assert r["cache"][name] == shapes, (name, r["cache"])


@pytest.mark.parametrize("tag", DH_TAGS)
def test_decode_gives_the_references_mesh_tokens(runs, tag):
    """The port's step on the case's mesh gives the reference's own
    tokens on that mesh every step, and its logits within
    ``decode_parity_tolerance("float32")``; the reference's mesh gives
    its one-device tokens."""
    ref = runs["ref"]
    key = f"dh/{tag}"
    np.testing.assert_array_equal(ref[f"{key}/mesh/tokens"],
                                  ref[f"{key}/single/tokens"])
    got = _dh_runs(runs, tag)
    assert len(got) == int(np.prod(_dh_case(tag)[3]))
    for r in got:
        np.testing.assert_array_equal(r["tokens"], ref[f"{key}/mesh/tokens"])
        np.testing.assert_allclose(r["logits"], ref[f"{key}/mesh/logits"],
                                   rtol=F32["rtol"], atol=F32["atol"])
        assert r["equal"]


@pytest.mark.parametrize("tag", DH_TAGS)
def test_decode_collectives_follow_the_cache_axis(runs, tag):
    """Per step and layer, over T: the (out, lse) partials gathered
    (and q where the heads are split); over the head dim: the scores
    summed and the outputs gathered along it (and q gathered where the
    heads are split). Each step decodes twice (the logits read, then
    the step)."""
    _, arch, edits, (d, m), length = _dh_case(tag)
    cfg = get_smoke_config(arch).replace(**edits)
    n = 2 * ranks.DH_STEPS * cfg.num_layers
    split_heads = cfg.num_heads % m == 0
    self_axis = L.cache_axis(cfg, length, m)
    axes = [self_axis]
    if cfg.family == "encdec":
        axes.append(L.cache_axis(cfg, cfg.encoder_seq, m))
    want = {"partial_gather": n * axes.count("t"),
            "score_sum": n * axes.count("dh"),
            "dh_gather": n * axes.count("dh")}
    if split_heads:
        want["q_gather"] = n * len(axes)
    for r in _dh_runs(runs, tag):
        got = {k: v for k, v in r["collectives"].items() if k in want}
        assert got == {k: v for k, v in want.items() if v}, got


def test_unsummed_scores_miss_the_bound(runs):
    """The control: the same decode with each rank applying its own
    partial scores (``score_sum`` left out) misses the bound the port
    meets."""
    key = f"dh/{ranks.DH_CONTROL}"
    want = runs["ref"][f"{key}/mesh/logits"]
    for r in runs["step"]:
        if "control" not in r["dh"]:
            continue
        gap = np.abs(r["dh"]["control"]["logits"] - want)
        assert (gap > F32["atol"] + F32["rtol"] * np.abs(want)).any()
        assert gap.max() > 100 * F32["atol"], gap.max()


def test_engine_pool_over_the_head_dim_gives_the_single_rank_tokens(runs):
    """Case B through the engine: qwen2.5-3b's pool of 42 keys at (1, 4)
    goes over the head dim (32 in blocks of 8); the tokens are the
    port's M = 1 engine's on the same params."""
    cfg = get_smoke_config(DH_ENGINE)
    sc = ranks.DH_SERVE
    for r in runs["engine"]:
        got = r["dh"]
        assert got["pool"] == (sc["slots"], sc["max_len"], cfg.num_kv_heads,
                               cfg.head_dim_ // 4)
        assert got["tokens"] == runs["single"]["dh"]
        assert got["stats"]["kernel_launches"] == 0
        assert got["collectives"]["score_sum"]["calls"] > 0


@pytest.mark.parametrize("arch", [a for a, _, _ in ref_side.DH_TRAIN])
def test_training_with_whole_heads_matches_the_gspmd_step(runs, arch):
    """One tree TVLARS step at (1, 8), where neither smoke config's 4
    heads divide 8 (every rank computes the same whole attention, d_ff
    split), against the reference's own GSPMD step on ``make_data_mesh(1,
    8)``, within ``test_torch_tp_train_families.py``'s bounds; the ranks
    holding one block hold the same bits."""
    ref, key = runs["ref"], f"{arch}/tree"
    bounds = train_ref.BOUNDS
    for r in runs["step"]:
        got = r["dh"][f"train/{arch}"]
        assert got["replicas_equal"]
        np.testing.assert_allclose(got["loss"], ref[f"{key}/loss"],
                                   rtol=bounds["loss"])
        theirs = train_ref.leaves(ref, f"{key}/params")
        assert len(got["params"]) == len(theirs)
        for a, b in zip(got["params"], theirs):
            np.testing.assert_allclose(a, b, rtol=bounds["params_rtol"],
                                       atol=bounds["params_atol"])
        for name in train_ref.NORMS:
            np.testing.assert_allclose(got[name], ref[f"{key}/{name}"],
                                       rtol=bounds["norms"], err_msg=name)
