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
    with pytest.raises(RuntimeError, match="no implementation"):
        ops.rmsnorm(torch.ones(2, 128, device="meta"),
                    torch.ones(128, device="meta"))
    first = _build.library_path("rmsnorm")
    assert first.parent == _build.BUILD_DIR
    assert first != _build.library_path("lars_update")
