"""Checkpoints of the port against the JAX package's, on the CPU.

* The port's ``save`` / ``restore`` round-trip (``latest_step``
  included), bf16 bitwise, and every mismatch ``restore`` must refuse:
  shape, dtype, leaf count (naming the per-leaf and fused layouts) and
  a byte count that disagrees with ``meta.json``.
* Both directions bitwise: a JAX ``save`` restored by the port and a
  port ``save`` restored by JAX, for the smoke LM (through
  ``params_to_jax`` / ``params_from_jax``) and the MLP classifier; the
  ``arrays.npz`` members of one tree are byte-identical across the
  packages; ``saved_shardings`` reads a reference ``meta.json`` that
  records provenance.
* A fused ``TrainState`` at f32, ``bf16_master`` and ``bf16_master_sr``:
  the restored state's next step equals the uninterrupted run bitwise,
  and the state crosses packages leaf for leaf (the fused substrate's
  ``opt_state`` leaves coincide with the reference's).
* ``Engine.from_checkpoint`` and ``launch.serve --restore`` on a
  reference checkpoint serve the JAX engine's greedy tokens.
* ``launch.landscape`` at a few steps: its checkpoints restore into the
  JAX template bitwise.
* The new entry points default to the card and raise without it.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import zipfile

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro import serving as jax_serving
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import build_optimizer as jbuild
from repro.launch import serve as jax_launch_serve
from repro.models import get_model as jax_get_model
from repro.models.cnn import init_mlp_classifier as jinit_mlp
from repro.training.train_state import TrainState as JTrainState
from repro.training.trainer import make_train_step as jmake_train_step
from repro_torch import checkpoint as ck
from repro_torch import serving
from repro_torch.configs import get_smoke_config
from repro_torch.core import build_optimizer
from repro_torch.core.base import tree_flatten_with_path, tree_leaves
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (get_model, jax_template, params_from_jax,
                                params_to_jax)
from repro_torch.models.convert import classifier_params_from_jax
from repro_torch.training import TrainState, lm_task, make_train_step


def _bits(x) -> np.ndarray:
    """A leaf's bytes as an integer array (bf16 included), for bitwise
    comparison across packages."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        return t.reshape(-1).view(torch.uint8).numpy() if t.dim() \
            else t.reshape(1).view(torch.uint8).numpy()
    a = np.ascontiguousarray(np.asarray(x))
    return a.reshape(-1).view(np.uint8)


def _assert_trees_bitwise(port_leaves, jax_leaves):
    assert len(port_leaves) == len(jax_leaves)
    for i, (a, b) in enumerate(zip(port_leaves, jax_leaves)):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"leaf {i}")


def _lm_pair(arch="qwen2.5-3b", dtype="bfloat16"):
    jcfg = jax_smoke_config(arch).replace(param_dtype=dtype)
    cfg = get_smoke_config(arch).replace(param_dtype=dtype)
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    return cfg, jparams, params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _mlp_pair():
    jparams = jinit_mlp(jax.random.PRNGKey(0), in_dim=192, num_classes=32,
                        hidden=128)
    return jparams, classifier_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _mixed_tree():
    g = torch.Generator().manual_seed(0)
    bits = torch.randint(0, 1 << 16, (5, 7), generator=g,
                         dtype=torch.int32).to(torch.int16)
    return {"w": torch.randn(3, 4, generator=g),
            "bf": bits.view(torch.bfloat16),
            "n": [torch.arange(6, dtype=torch.int32).reshape(2, 3),
                  torch.tensor([True, False])],
            "s": torch.zeros((), dtype=torch.int32)}


def test_round_trip_and_latest_step(tmp_path):
    tree = _mixed_tree()
    assert ck.latest_step(str(tmp_path / "none")) is None
    ck.save(str(tmp_path / "c"), tree, step=7)
    assert ck.latest_step(str(tmp_path / "c")) == 7
    got = ck.restore(str(tmp_path / "c"), tree, device="cpu")
    assert list(got) == list(tree) and isinstance(got["n"], list)
    for (pa, a), (pb, b) in zip(tree_flatten_with_path(tree),
                                tree_flatten_with_path(got)):
        assert pa == pb and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    meta = json.load(open(tmp_path / "c" / "meta.json"))
    assert meta["dtypes"]["leaf_0"] == "bfloat16"
    assert meta["shardings"] == {}
    assert sorted(os.listdir(tmp_path / "c")) == ["arrays.npz",
                                                  "meta.json"]


def test_bf16_round_trips_bitwise_every_pattern(tmp_path):
    """All 65,536 bf16 bit patterns (NaNs, infinities, subnormals)."""
    pat = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32) \
        .to(torch.int16).view(torch.bfloat16).reshape(256, 256)
    ck.save(str(tmp_path), {"x": pat})
    got = ck.restore(str(tmp_path), {"x": pat}, device="cpu")["x"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), pat.view(torch.int16))


@pytest.mark.parametrize("fault", ["shape", "dtype", "leaf_count",
                                   "byte_count", "mesh"])
def test_restore_refuses_mismatch(tmp_path, fault):
    tree = {"a": torch.zeros(2, 3), "b": torch.zeros(4, 2,
                                                    dtype=torch.bfloat16)}
    path = str(tmp_path)
    ck.save(path, tree)
    like, match, exc = dict(tree), None, ValueError
    if fault == "shape":
        like["a"] = torch.zeros(3, 2)
        match = "leaf 0: checkpoint shape"
    elif fault == "dtype":
        like["a"] = torch.zeros(2, 3, dtype=torch.float64)
        match = "leaf 0: checkpoint dtype float32 != template float64"
    elif fault == "leaf_count":
        like["c"] = torch.zeros(1)
        match = "per-leaf momentum trees vs the fused flat substrate"
    elif fault == "byte_count":
        # meta and template agree on a shape the payload's bytes cannot
        # hold: refused before the bytes are viewed
        meta = json.load(open(tmp_path / "meta.json"))
        meta["shapes"]["leaf_1"] = [4, 3]
        json.dump(meta, open(tmp_path / "meta.json", "w"))
        like["b"] = torch.zeros(4, 3, dtype=torch.bfloat16)
        match = "leaf 1: byte payload is 16B"
    else:
        # a placement naming more dims than the leaf has cannot tile it
        match = "sharding mismatch between checkpoint and restore target"
    from repro_torch.distributed import (NamedSharding, PartitionSpec,
                                         make_data_mesh)
    split = NamedSharding(make_data_mesh(1),
                          PartitionSpec(None, None, "model")) \
        if fault == "mesh" else None
    with pytest.raises(exc, match=match):
        ck.restore(path, like, device="cpu", shardings=split)


@pytest.mark.parametrize("model", ["lm", "mlp"])
def test_jax_save_port_restore_bitwise(tmp_path, model):
    if model == "lm":
        cfg, jparams, _ = _lm_pair()
        jck.save(str(tmp_path), jparams, step=3)
        got = params_from_jax(cfg, ck.restore(str(tmp_path),
                                              jax_template(cfg),
                                              device="cpu"), device="cpu")
        leaves = tree_leaves(params_to_jax(cfg, got))
    else:
        jparams, port = _mlp_pair()
        jck.save(str(tmp_path), jparams, step=3)
        leaves = tree_leaves(ck.restore(str(tmp_path), port, device="cpu"))
    assert ck.latest_step(str(tmp_path)) == 3
    _assert_trees_bitwise(leaves, jax.tree_util.tree_leaves(jparams))


@pytest.mark.parametrize("model", ["lm", "mlp"])
def test_port_save_jax_restore_bitwise(tmp_path, model):
    if model == "lm":
        cfg, jparams, params = _lm_pair()
        ck.save(str(tmp_path), params_to_jax(cfg, params), step=5)
        ours = tree_leaves(params_to_jax(cfg, params))
    else:
        jparams, params = _mlp_pair()
        ck.save(str(tmp_path), params, step=5)
        ours = tree_leaves(params)
    back = jck.restore(str(tmp_path), jparams)
    assert jck.latest_step(str(tmp_path)) == 5
    _assert_trees_bitwise(ours, jax.tree_util.tree_leaves(back))


@pytest.mark.parametrize("model", ["lm", "mlp"])
def test_npz_members_byte_identical(tmp_path, model):
    if model == "lm":
        cfg, jparams, params = _lm_pair()
        ours = params_to_jax(cfg, params)
    else:
        jparams, ours = _mlp_pair()
    jck.save(str(tmp_path / "jax"), jparams)
    ck.save(str(tmp_path / "port"), ours)
    za = zipfile.ZipFile(tmp_path / "jax" / "arrays.npz")
    zb = zipfile.ZipFile(tmp_path / "port" / "arrays.npz")
    assert za.namelist() == zb.namelist()
    for name in za.namelist():
        assert za.read(name) == zb.read(name), name
    ma = json.load(open(tmp_path / "jax" / "meta.json"))
    mb = json.load(open(tmp_path / "port" / "meta.json"))
    for key in ("num_leaves", "dtypes", "shapes", "shardings", "step"):
        assert ma[key] == mb[key], key


def test_saved_shardings_reads_reference_provenance(tmp_path):
    ck.save(str(tmp_path), {"w": torch.zeros(4, 2)})
    meta = json.load(open(tmp_path / "meta.json"))
    prov = {"leaf_0": {"spec": "PartitionSpec('data',)",
                       "mesh": {"data": 4, "model": 1}}}
    meta["shardings"] = prov
    json.dump(meta, open(tmp_path / "meta.json", "w"))
    assert ck.saved_shardings(str(tmp_path)) == prov
    assert jck.saved_shardings(str(tmp_path)) == prov
    # provenance does not stop a single-device restore
    assert ck.restore(str(tmp_path), {"w": torch.zeros(4, 2)},
                      device="cpu")["w"].shape == (4, 2)


def _lm_batches(steps, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 512, (4, 32)),
             "labels": rng.integers(0, 512, (4, 32))}
            for _ in range(steps)]


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("precision",
                         ["f32", "bf16_master", "bf16_master_sr"])
def test_fused_train_state_resume_is_bitwise(tmp_path, precision):
    cfg, _, params = _lm_pair(dtype="float32")
    model = get_model(cfg)
    opt = build_optimizer("tvlars", total_steps=10, learning_rate=1.0,
                          batch_size=4, use_kernel="fused",
                          precision=precision, segments=model.segments,
                          device="cpu")
    step = make_train_step(lm_task(model), opt)
    batches = [_torch_batch(b) for b in _lm_batches(3)]

    state = TrainState.create(params, opt)
    for b in batches[:2]:
        state, _ = step(state, b)
    ck.save(str(tmp_path), ck.train_state_tree(state, cfg=cfg),
            step=state.step)
    resumed = ck.restore_train_state(str(tmp_path), state, cfg=cfg,
                                     device="cpu")
    assert resumed.step == state.step == 2
    _assert_trees_bitwise(tree_leaves(resumed.params),
                          tree_leaves(state.params))
    state, m1 = step(state, batches[2])
    resumed, m2 = step(resumed, batches[2])
    assert torch.equal(m1["loss"], m2["loss"])
    _assert_trees_bitwise(tree_leaves(resumed), tree_leaves(state))


@pytest.mark.parametrize("precision", ["f32", "bf16_master_sr"])
def test_fused_train_state_crosses_packages(tmp_path, precision):
    """The fused substrate's ``opt_state`` leaves have the reference's
    layout: a reference ``TrainState`` after two steps restores into
    the port leaf for leaf, and the port's state into the reference."""
    cfg, jparams, params = _lm_pair(dtype="float32")
    jmodel = jax_get_model(jax_smoke_config("qwen2.5-3b"))
    kw = dict(total_steps=10, learning_rate=1.0, batch_size=4,
              use_kernel="fused", precision=precision)
    jopt = jbuild("tvlars", **kw)
    jstate = JTrainState.create(jparams, jopt)
    jstep = jax.jit(jmake_train_step(jmodel, jopt))
    for b in _lm_batches(2):
        jstate, _ = jstep(jstate, {k: jax.numpy.asarray(v, jax.numpy.int32)
                                   for k, v in b.items()})
    jck.save(str(tmp_path / "jax"), jstate, step=2)

    model = get_model(cfg)
    opt = build_optimizer("tvlars", segments=model.segments, device="cpu",
                          **kw)
    like = TrainState.create(params, opt)
    got = ck.restore_train_state(str(tmp_path / "jax"), like, cfg=cfg,
                                 device="cpu")
    assert got.step == 2 and type(got.opt_state) is type(like.opt_state)
    jleaves = jax.tree_util.tree_leaves(jstate)
    _assert_trees_bitwise(tree_leaves(ck.train_state_tree(got, cfg=cfg)),
                          jleaves)

    ck.save(str(tmp_path / "port"), ck.train_state_tree(got, cfg=cfg),
            step=2)
    back = jck.restore(str(tmp_path / "port"), jstate)
    _assert_trees_bitwise(jax.tree_util.tree_leaves(back), jleaves)


def _serve_kw():
    return dict(slots=3, max_len=64, page_size=8, prefill_batch=2)


def test_engine_from_reference_checkpoint_serves_jax_tokens(tmp_path):
    arch = "qwen2.5-3b"
    jmodel = jax_get_model(jax_smoke_config(arch))
    jck.save(str(tmp_path), jmodel.init(jax.random.PRNGKey(3)))
    prompts = [np.random.RandomState(s).randint(1, 512, size=n)
               for s, n in ((0, 5), (1, 9), (2, 3))]

    def drain(eng):
        ids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        got = {r.id: r.tokens for r in eng.drain()}
        return [got[i] for i in ids]

    want = drain(jax_serving.Engine.from_checkpoint(
        str(tmp_path), jmodel, jax_serving.ServeConfig(**_serve_kw())))
    model = get_model(get_smoke_config(arch))
    eng = serving.Engine.from_checkpoint(
        str(tmp_path), model, serving.ServeConfig(**_serve_kw()),
        device="cpu")
    assert drain(eng) == want


def _sample_line(fn) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    lines = [ln for ln in out.getvalue().splitlines()
             if ln.startswith("sample:")]
    assert len(lines) == 1, out.getvalue()
    return lines[0]


def test_launch_serve_restore_matches_jax_launcher(tmp_path, monkeypatch):
    arch = "qwen2.5-3b"
    jck.save(str(tmp_path), jax_get_model(jax_smoke_config(arch)).init(
        jax.random.PRNGKey(5)))
    flags = ["--arch", arch, "--smoke", "--requests", "4", "--prompt-len",
             "8", "--num-tokens", "8", "--slots", "3", "--page-size", "8",
             "--restore", str(tmp_path)]
    monkeypatch.setattr(sys, "argv", ["serve", *flags])
    want = _sample_line(jax_launch_serve.main)
    got = _sample_line(lambda: launch_serve.main([*flags, "--device",
                                                  "cpu"]))
    assert got == want


def test_launch_landscape_checkpoints_restore_in_jax(tmp_path):
    from repro_torch.launch import landscape
    out = landscape.run(["--device", "cpu", "--steps", "3", "--out-dir",
                         str(tmp_path)], log_fn=lambda *_: None)
    assert tuple(out["grid"].shape) == (9, 7)
    assert torch.isfinite(out["grid"]).all()
    lines = open(out["csv"]).read().splitlines()
    assert lines[0] == "step,alpha,beta,loss" and len(lines) == 64
    template = jinit_mlp(jax.random.PRNGKey(0), in_dim=192, num_classes=32,
                         hidden=128)
    for opt, ckpt in out["checkpoints"].items():
        assert jck.latest_step(ckpt) == 3
        back = jck.restore(ckpt, template)
        _assert_trees_bitwise(tree_leaves(out["params"][opt]),
                              jax.tree_util.tree_leaves(back))
    assert out["endpoints"][0] == pytest.approx(
        float(out["grid"][2, 3])) and out["barrier"] >= 0.0


def test_new_entry_points_refuse_cuda_without_it(tmp_path, monkeypatch):
    """``restore``, ``Engine.from_checkpoint`` and the two bench
    launchers default to the card and raise without it."""
    from repro_torch.launch import landscape, pipeline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ck.save(str(tmp_path), {"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="CUDA"):
        ck.restore(str(tmp_path), {"w": torch.zeros(2)})
    model = get_model(get_smoke_config("qwen2.5-3b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.Engine.from_checkpoint(str(tmp_path), model,
                                       serving.ServeConfig())
    for launcher in (pipeline, landscape):
        with pytest.raises(RuntimeError, match="CUDA"):
            launcher.run(["--out-dir", str(tmp_path)])
