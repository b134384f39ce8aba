"""``ops.rmsnorm`` of ``repro_torch`` against the JAX package.

The port's plain version (the CPU path) against JAX's
``repro.kernels.ops.rmsnorm`` (the Pallas kernel in interpret mode) on
the same numpy input: ranks 2 and 3, d in {128, 2048, 3840}, f32 and
bf16, within ``rmsnorm_tolerance`` (f32: 1e-5 relative, summation order
and rsqrt; bf16: one storage ulp). The kernel wrapper refuses what the
CUDA kernel does not take before building, and the CPU path launches
nothing.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build, ops
from repro_torch.kernels import rmsnorm as trms

SHAPES = {2: lambda d: (6, d), 3: lambda d: (2, 3, d)}


@pytest.mark.parametrize("rank", [2, 3])
@pytest.mark.parametrize("d", [128, 2048, 3840])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_matches_reference(rank, d, dtype):
    rng = np.random.default_rng(d + rank)
    shape = SHAPES[rank](d)
    x = (rng.normal(size=shape) * 3.0).astype(np.float32)
    w = (rng.normal(size=(d,)) * 0.2).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    want = np.asarray(jops.rmsnorm(jx, jw).astype(jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(tdt)
    before = dict(ops.launches)
    got = ops.rmsnorm(tx, tw)
    assert ops.launches == before
    assert got.dtype == tdt and got.shape == tx.shape
    np.testing.assert_allclose(got.float().numpy(), want,
                               **trms.rmsnorm_tolerance(tdt))


def test_rmsnorm_follows_the_kernel_not_the_oracle():
    """The plain version is the TPU kernel's formula, rsqrt of the mean
    of squares, and its default eps is the kernel's (1e-6)."""
    x = torch.tensor([[3.0, 4.0] * 64])
    w = torch.zeros(128)
    y = ops.rmsnorm(x, w)
    want = x * torch.rsqrt(torch.tensor(12.5) + 1e-6)
    assert torch.equal(y, want)
    assert torch.equal(ops.rmsnorm(x, w, eps=0.5),
                       x * torch.rsqrt(torch.tensor(13.0)))


def test_rmsnorm_cuda_wrapper_refuses_before_building(monkeypatch):
    def no_build(name):
        raise AssertionError("must not build for a refused call")
    monkeypatch.setattr(_build, "load", no_build)
    with pytest.raises(ValueError, match="CUDA device"):
        trms.rmsnorm_cuda(torch.ones(2, 128), torch.ones(128))
    # meta tensors (the dry run): the output's shape, counted apart
    before, meta = dict(ops.launches), ops.meta_launches["rmsnorm"]
    out = ops.rmsnorm(torch.ones(2, 128, device="meta", dtype=torch.bfloat16),
                      torch.ones(128, device="meta"))
    assert out.device.type == "meta" and out.shape == (2, 128)
    assert out.dtype == torch.bfloat16 and ops.launches == before
    assert ops.meta_launches["rmsnorm"] == meta + 1
    first = _build.library_path("rmsnorm")
    assert first.parent == _build.BUILD_DIR
    assert first != _build.library_path("lars_update")


def test_rmsnorm_launch_takes_narrow_rows_a_warp_each():
    """Rows of d <= NARROW_MAX_D with 16-byte aligned operands go to the
    warp-per-row kernel, whose blocks cover the rows exactly; wider or
    unaligned rows keep the block-per-row kernel."""
    for d in range(128, trms.NARROW_MAX_D + 1, 128):
        for rows in (1, 3, 4, 5, 4096):
            plan = trms.rmsnorm_launch(rows, d, aligned=True)
            assert plan["narrow"] and plan["threads"] == 32 * \
                trms.ROWS_PER_BLOCK
            covered = plan["blocks"] * trms.ROWS_PER_BLOCK
            assert rows <= covered < rows + trms.ROWS_PER_BLOCK
    wide = trms.rmsnorm_launch(16384, 3840, aligned=True)
    assert wide == {"narrow": False, "blocks": 16384, "threads": 256}
    assert not trms.rmsnorm_launch(4096, 2048, aligned=False)["narrow"]
    assert trms.rmsnorm_launch(2, 128, aligned=False)["threads"] == 32


def _narrow_kernel_order(x: np.ndarray, w: np.ndarray, eps: float,
                         vec: int) -> np.ndarray:
    """The warp-per-row kernel's arithmetic in numpy f32: lane l sums
    the squares of its vectors l, l + 32, ... in order (``vec``
    elements each), a butterfly over the 32 lanes, then rsqrt of the
    mean plus eps and (x·r)·(1 + w)."""
    rows, d = x.shape
    f32 = np.float32
    out = np.empty_like(x)
    for i in range(rows):
        lanes = np.zeros(32, f32)
        for c in range(d // vec):
            for v in x[i, c * vec:(c + 1) * vec]:
                lanes[c % 32] = f32(lanes[c % 32] + f32(v * v))
        for off in (16, 8, 4, 2, 1):
            lanes = (lanes + lanes[np.arange(32) ^ off]).astype(f32)
        r = f32(1) / np.sqrt(f32(f32(lanes[0] / f32(d)) + f32(eps)))
        out[i] = (x[i] * r).astype(f32) * (f32(1) + w).astype(f32)
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_narrow_kernel_sum_order_matches_reference(dtype):
    """qwen2.5-3b's width (2048): the narrow kernel's fixed order of the
    sum of squares (emulated) stays within ``rmsnorm_tolerance`` of the
    JAX kernel, and repeats bit for bit."""
    rng = np.random.default_rng(7)
    d = 2048
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    x = jnp.asarray((rng.normal(size=(3, d)) * 3.0).astype(np.float32), jdt)
    w = jnp.asarray((rng.normal(size=(d,)) * 0.2).astype(np.float32), jdt)
    want = np.asarray(jops.rmsnorm(x, w).astype(jnp.float32))
    xf = np.asarray(x.astype(jnp.float32))
    wf = np.asarray(w.astype(jnp.float32))
    vec = 8 if dtype == "bf16" else 4
    got = _narrow_kernel_order(xf, wf, 1e-6, vec)
    assert np.array_equal(got, _narrow_kernel_order(xf, wf, 1e-6, vec))
    got = torch.from_numpy(got).to(tdt).float().numpy()
    np.testing.assert_allclose(got, want, **trms.rmsnorm_tolerance(tdt))


def test_rmsnorm_cuda_wrapper_refuses_bad_operands_before_building(
        monkeypatch):
    def no_build(name):
        raise AssertionError("must not build for a refused call")
    monkeypatch.setattr(_build, "load", no_build)
    cases = [((torch.ones(2, 96), torch.ones(96)), "multiple of 128"),
             ((torch.ones(2, 8320), torch.ones(8320)), "multiple of 128"),
             ((torch.ones(2, 128, dtype=torch.int32), torch.ones(128)),
              "not supported"),
             ((torch.ones(2, 128), torch.ones(128, dtype=torch.float64)),
              "not supported"),
             ((torch.ones(2, 256), torch.ones(128)), "w must be"),
             ((torch.ones(2, 256), torch.ones(256)), "CUDA device")]
    for (x, w), match in cases:
        with pytest.raises(ValueError, match=match):
            trms.rmsnorm_cuda(x, w)
