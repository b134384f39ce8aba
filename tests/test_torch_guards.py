"""Boundary guards of the port.

* ``repro_torch`` imports neither ``jax`` nor anything of ``repro``
  (checked in a fresh interpreter and by an AST scan of every module
  and of ``chip_smoke.py``);
* every entry point asked for CUDA on a host without it raises instead
  of running on the CPU;
* ``kernels.ops`` dispatches by the tensors' device and counts only
  kernel launches; the CUDA wrapper refuses what the kernel does not
  take before building anything.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import serving
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import _build
from repro_torch.kernels import attention_decode as tad
from repro_torch.kernels import ops
from repro_torch.models import get_model, params_from_jax

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_import_leaves_jax_out():
    code = ("import sys, pkgutil, importlib, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module)
    return names


def test_no_module_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for name in _imported_modules(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{f.relative_to(ROOT)} imports {name}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_cuda_without_it(no_cuda):
    model = get_model(get_smoke_config("gemma3-12b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0)                               # default device
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0, device="cuda")
    params = model.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.Engine(model, params, serving.ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.Engine(model, params, serving.ServeConfig(),
                       device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.generate(model, params, np.ones((1, 3), np.int32),
                         num_tokens=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax(model.cfg, {"groups": {}})


def test_launcher_refuses_cuda_without_it(no_cuda, monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "gemma3-12b",
                                      "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main()


def test_engine_refuses_params_on_another_device():
    model = get_model(get_smoke_config("qwen2.5-3b"))
    params = model.init(0, device="cpu")
    params["embed"]["table"] = params["embed"]["table"].to("meta")
    with pytest.raises(ValueError, match="params lie on"):
        serving.Engine(model, params, serving.ServeConfig(), device="cpu")


def _decode_operands(device="cpu"):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 1, 4, 16, generator=g)
    nk, nv = torch.randn(2, 2, 1, 2, 16, generator=g)
    kc, vc = torch.randn(2, 2, 8, 2, 16, generator=g)
    return [x.to(device) for x in (q, nk, nv, kc, vc)] \
        + [torch.tensor([3, 11], dtype=torch.int32, device=device)]


def test_ops_dispatch_by_device_counts_only_kernel_launches():
    before = dict(ops.launches)
    operands = _decode_operands()
    out = ops.attention_decode(*operands, window=8)
    want = tad.attention_decode_ref(*_decode_operands(), window=8)
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    assert ops.launches == before                 # plain path: no launch
    # meta tensors (the dry run): out of q's shape and dtype, the launch
    # and its q·K, p·V FLOPs counted apart
    meta, flops = ops.meta_launches["attention_decode"], \
        ops.meta_flops["attention_decode"]
    got = ops.attention_decode(*_decode_operands("meta"), window=8)
    assert got.device.type == "meta" and got.shape == out.shape
    assert got.dtype == out.dtype and ops.launches == before
    assert ops.meta_launches["attention_decode"] == meta + 1
    assert ops.meta_flops["attention_decode"] == flops + 4 * out.numel() * 8


def test_cuda_wrapper_refuses_cpu_tensors_before_building(monkeypatch):
    def no_build(name):
        raise AssertionError("must not build for a refused call")
    monkeypatch.setattr(_build, "load", no_build)
    with pytest.raises(ValueError, match="CUDA device"):
        tad.attention_decode_cuda(*_decode_operands(), window=8)


def test_library_is_keyed_on_source_hash(tmp_path, monkeypatch):
    first = _build.library_path("attention_decode")
    assert first.parent == _build.BUILD_DIR
    assert first == _build.library_path("attention_decode")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "attention_decode.cu").write_text("// edited\n")
    assert _build.library_path("attention_decode").name != first.name


def test_unported_archs_and_families_raise():
    """Every reference arch id resolves in the port, full and smoke, to
    a family ``get_model`` builds; an unknown arch id or family raises
    ``ValueError``."""
    from repro.configs.registry import ARCH_IDS as JAX_ARCH_IDS
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)
    for arch in JAX_ARCH_IDS:
        for cfg in (get_config(arch), get_smoke_config(arch)):
            assert cfg.arch_id == arch
            assert get_model(cfg).cfg is cfg
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no-such-arch")
    with pytest.raises(ValueError, match="unknown arch"):
        get_smoke_config("no-such-arch")
    with pytest.raises(ValueError, match="unknown family"):
        get_model(get_config("gemma3-12b").replace(family="no-such"))


# ---------------------------------------------------------------------------
# the training slice
# ---------------------------------------------------------------------------

TRAINING_MODULES = [
    "core/api.py", "core/base.py", "core/flatten.py",
    "core/instrumentation.py", "core/labels.py", "core/lamb.py",
    "core/lars.py", "core/layerwise.py", "core/schedules.py",
    "core/sgd.py", "core/tvlars.py", "data/synthetic.py",
    "kernels/ref.py", "kernels/segmented_update.py", "launch/train.py",
    "obs/layerwise.py", "training/losses.py", "training/tasks.py",
    "training/train_state.py", "training/trainer.py"]


def test_import_scan_covers_training_modules():
    scanned = {f.relative_to(PORT).as_posix() for f in PORT.rglob("*.py")}
    assert set(TRAINING_MODULES) <= scanned
    for rel in TRAINING_MODULES:
        for name in _imported_modules(PORT / rel):
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{rel} imports {name}"


def test_train_launcher_refuses_cuda_without_it(no_cuda):
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.run(["--smoke", "--steps", "1"])          # default device
    with pytest.raises(RuntimeError, match="CUDA"):
        train.run(["--smoke", "--steps", "1", "--device", "cuda"])


def test_lm_stream_refuses_cuda_without_it(no_cuda):
    """The synthetic LM stream defaults to the card like every other
    entry point, and raises without CUDA instead of staying on the CPU."""
    from repro_torch.data import synthetic
    with pytest.raises(RuntimeError, match="CUDA"):
        next(synthetic.lm_iterator(8, 16, 97))          # default device
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic.lm_batch(torch.Generator().manual_seed(0), 4, 16, 97)
    tokens, _ = synthetic.lm_batch(torch.Generator().manual_seed(0), 4, 16,
                                   97, device="cpu")
    assert tokens.device.type == "cpu"


def test_fused_optimizer_refuses_cuda_without_it(no_cuda):
    from repro_torch.core import build_optimizer
    for name in ("tvlars", "lamb", "wa-lars"):
        with pytest.raises(RuntimeError, match="CUDA"):
            build_optimizer(name, total_steps=4, use_kernel="fused")
    # the tree path runs on the params' device and builds anywhere
    build_optimizer("tvlars", total_steps=4)


def _seg_operands(device="cpu"):
    g = torch.Generator().manual_seed(0)
    w = torch.randn(16, 128, generator=g)
    grad = torch.randn(16, 128, generator=g)
    m = torch.zeros(16, 128)
    ids = torch.tensor([0] * 5 + [1] * 11, dtype=torch.int32)
    return [x.to(device) for x in (w, grad, m, ids)]


def _seg_kwargs(ids, device="cpu"):
    return dict(seg_ids=ids, adapt_mask=torch.tensor([True, False],
                                                     device=device),
                base_lr=0.5, mode="lars", eta=1e-3, weight_decay=5e-4,
                momentum=0.9, b1=0.9, b2=0.999, eps=1e-9)


def test_segmented_update_dispatch_counts_only_kernel_launches():
    from repro_torch.kernels import segmented_update as su
    before = dict(ops.launches)
    w, g, m, ids = _seg_operands()
    want = su.segmented_update_ref(w, g, (m.clone(),), **_seg_kwargs(ids))
    bufs, delta = ops.segmented_update(w, g, (m,), **_seg_kwargs(ids))
    assert torch.equal(delta, want[1]) and torch.equal(m, want[0][0])
    assert ops.launches == before                 # plain path: no launch
    # meta tensors (the dry run): the state in place, an f32 delta of
    # the flat shape, both launches counted apart
    w, g, m, ids = _seg_operands("meta")
    meta = dict(ops.meta_launches)
    bufs, got = ops.segmented_update(w, g, (m,), **_seg_kwargs(ids, "meta"))
    assert bufs[0] is m and got.device.type == "meta"
    assert got.shape == delta.shape and got.dtype == torch.float32
    assert ops.launches == before
    for name in ("seg_norm_lars", "seg_apply_lars"):
        assert ops.meta_launches[name] == meta[name] + 1


def test_segmented_cuda_wrappers_refuse_cpu_tensors_before_building(
        monkeypatch):
    from repro_torch.kernels import segmented_update as su

    def no_build(name):
        raise AssertionError("must not build for a refused call")
    monkeypatch.setattr(_build, "load", no_build)
    w, g, m, ids = _seg_operands()
    with pytest.raises(ValueError, match="CUDA device"):
        su.seg_norm_cuda(w, g, (m,), ids, 2, mode="lars",
                         weight_decay=5e-4)
    with pytest.raises(ValueError, match="CUDA device"):
        su.seg_apply_cuda(w, g, (m,), ids, torch.ones(2, 2), mode="lars")
    with pytest.raises(ValueError, match="CUDA device"):
        su.segmented_update_cuda(w, g, (m,), **_seg_kwargs(ids))


def test_segmented_library_is_keyed_on_source_hash(tmp_path, monkeypatch):
    first = _build.library_path("segmented_update")
    assert first != _build.library_path("attention_decode")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "segmented_update.cu").write_text("// edited\n")
    assert _build.library_path("segmented_update").name != first.name
