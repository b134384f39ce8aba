"""The vocabulary-parallel head's gradient of the hidden state
(``training.losses._chunk_ce_vocab_parallel``), on the CPU.

A head split over the model row gives each rank the logits of its
``V/M`` columns, and ``h``'s gradient is the row's sum of each rank's
partial ``g @ wᵀ``. The port forms each partial as an f32 product,
sums the row's partials in f32 and rounds the sum to bf16 once, as one
device's head rounds its single product once. One gloo world of 4
ranks runs every case (``torch_vocab_head_ranks.world``), at ``(1, 2)``
on its first two ranks and ``(1, 4)`` on all four.

* In bf16, at M = 2 and 4, with the head as a tied table's transpose
  (a column-major operand) and as a head of its own: ``h``'s gradient
  from ``fused_ce_from_hidden`` (two 256-position chunks, each a
  strided slice of ``h``) lies within one bf16 rounding of the exact
  gradient, element by element: ``2⁻⁸·|exact|`` plus the f32 sums'
  own error, ``(V/M + M)·2⁻²⁴·Σ|g|·|w|``. The exact gradient is the
  f64 sum of the products of the very bf16 values each rank's product
  read (the logits' gradient ``g`` and ``wᵀ``, recorded as it ran).
* The control that rounds each rank's partial to bf16 before the row
  sums it (the head before the fix, ``parent_chunk_ce``) misses that
  bound, and gives the port's loss and gradient of ``w`` bit for bit.
* A Hessian-vector product through the split head (the Lanczos
  probe's product, ``make_flat_hvp(placement=)``) on the two-layer
  smoke LM at ``(1, 2)`` gives the single-rank one within
  :data:`HVP_RTOL` (relative, over all leaves), in bf16 and f32, with
  and without the sequence over the model axis; a head whose backward
  autograd does not differentiate misses the bf16 bound.
* On meta (the dry run) a bf16 partial is ``mm``'s ``out_dtype`` form:
  its f32 output is held by ``LiveBytes`` and its FLOPs counted.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401  (autouse)
import torch_vocab_head_ranks as ranks
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.dryrun import LiveBytes
from repro_torch.training import losses

TIMEOUT_S = 120
# the HVP at (1, 2) against one rank's, relative over all leaves: bf16
# as the repo's bf16 HVP against the reference's (4·2⁻⁸, F5), f32 near
# the f32 sums' own error
HVP_RTOL = {True: 4 * 2.0 ** -8, False: 1e-5}
CASES = [(m, tied) for _, m in ranks.HEAD_MESHES for tied in (True, False)]


@pytest.fixture(scope="module")
def runs():
    inputs = ranks.head_inputs()
    world = mesh_lib.spawn(ranks.world, 4, "gloo", "cpu", args=(inputs,),
                           timeout=TIMEOUT_S)
    single = {bf16: ranks.hvp_whole(bf16) for bf16 in (True, False)}
    return {"world": world, "single": single}


def _exact(world, m: int, tied: bool, control: bool) -> tuple:
    """The exact gradient of ``h`` (f64) from each rank's recorded
    partial products, and the f32 sums' error bound's Σ|g|·|w|."""
    b, s, d = (ranks.HEAD[k] for k in ("B", "S", "D"))
    c = losses.CE_CHUNK
    exact = np.zeros((b, s, d))
    absum = np.zeros((b, s, d))
    for r in range(m):
        parts = world[r][(m, tied, control)]["partials"]
        assert sorted(k for k, _, _ in parts) == list(range(s // c))
        for k, g, wt in parts:
            g, wt = g.astype(np.float64), wt.astype(np.float64)
            exact[:, k * c:(k + 1) * c] += (g @ wt).reshape(b, c, d)
            absum[:, k * c:(k + 1) * c] += (np.abs(g) @ np.abs(wt)) \
                .reshape(b, c, d)
    return exact, absum


def _over(world, m: int, tied: bool, control: bool) -> np.ndarray:
    """|h's gradient − exact| over the one-rounding bound, elementwise,
    after checking every rank of the row holds the same gradient."""
    grads = [world[r][(m, tied, control)]["h_grad"] for r in range(m)]
    for g in grads[1:]:
        np.testing.assert_array_equal(g, grads[0])
    exact, absum = _exact(world, m, tied, control)
    local = ranks.HEAD["V"] // m
    bound = 2.0 ** -8 * np.abs(exact) + (local + m) * 2.0 ** -24 * absum
    return np.abs(grads[0] - exact) / bound


@pytest.mark.parametrize("m,tied", CASES)
def test_h_grad_lies_within_one_bf16_rounding_of_exact(runs, m, tied):
    ratio = _over(runs["world"], m, tied, False)
    assert ratio.max() <= 1.0, ratio.max()


@pytest.mark.parametrize("m,tied", CASES)
def test_per_rank_rounding_misses_the_bound(runs, m, tied):
    ratio = _over(runs["world"], m, tied, True)
    assert ratio.max() > 10.0, ratio.max()


@pytest.mark.parametrize("m,tied", CASES)
def test_loss_and_w_grad_are_the_per_rank_roundings_bits(runs, m, tied):
    for r in range(m):
        port = runs["world"][r][(m, tied, False)]
        control = runs["world"][r][(m, tied, True)]
        np.testing.assert_array_equal(port["loss"], control["loss"])
        np.testing.assert_array_equal(port["w_grad"], control["w_grad"])


def _hvp_gap(got: list, want: list) -> float:
    assert [g.shape for g in got] == [w.shape for w in want]
    num = sum(float(((g - w).astype(np.float64) ** 2).sum())
              for g, w in zip(got, want))
    den = sum(float((w.astype(np.float64) ** 2).sum()) for w in want)
    return (num / den) ** 0.5


@pytest.mark.parametrize("seq", [False, True], ids=["unsplit", "seq"])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_hvp_through_the_split_head_gives_the_single_ranks(runs, bf16,
                                                           seq):
    want = runs["single"][bf16]
    got = [runs["world"][r][("hvp", bf16, seq)] for r in range(2)]
    for leaves in got[1:]:
        for a, b in zip(leaves, got[0]):
            np.testing.assert_array_equal(a, b)
    assert _hvp_gap(got[0], want) <= HVP_RTOL[bf16]


def test_first_order_head_misses_the_hvp_bound(runs):
    got = runs["world"][0][("hvp-first-order", True, False)]
    assert _hvp_gap(got, runs["single"][True]) > 10 * HVP_RTOL[True]


def test_meta_partial_is_an_f32_product_the_dry_run_counts():
    from torch.utils.flop_counter import FlopCounterMode
    n, k, d = 8, 24, 16
    g = torch.empty(n, k, dtype=torch.bfloat16, device="meta")
    wt = torch.empty(k, d, dtype=torch.bfloat16, device="meta")
    # the recorder outermost: its copies reach no mode below it
    with ranks.Products() as rec, FlopCounterMode(display=False) as flops, \
            LiveBytes(buffers=True) as live:
        out = losses._mm_f32(g, wt)
        held = list(live.held.values())
    assert out.dtype == torch.float32 and tuple(out.shape) == (n, d)
    assert flops.get_total_flops() == 2 * n * k * d
    assert (n * d * 4, (n, d), "float32", "aten.mm") in held
    # bf16 operands, no f32 copy of either (the card's route)
    assert [(a.shape, b.shape) for a, b, _ in rec.calls] \
        == [((n, k), (k, d))]
    assert live.peak == n * d * 4
