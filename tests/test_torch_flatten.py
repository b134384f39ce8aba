"""The flat substrate of ``repro_torch`` against the JAX package's.

* ``FlatSpec`` / ``pack`` of the port's per-layer LM tree, grouped by
  ``model.segments`` (``models.convert.segment_paths``), against JAX
  ``build_spec`` / ``pack_tree`` of the reference's stacked tree, on
  the qwen2.5-3b and gemma3-12b smoke configs: the same segment names
  in the same order, adapt flags, shapes, ``num_rows``, block rows,
  segment ids, and bitwise-equal buffers at f32 and bf16.
* Plain trees (no ``layers`` list) take the reference's flatten order.
* The stochastic-rounding hash and element index, bitwise, including
  element indices at and past 2^31 and 2^32.
Exact equality throughout: packing and hashing do no arithmetic that
could round differently.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import flatten as jflatten
from repro.core import labels as jlabels
from repro.kernels import ref as jref
from repro.models import get_model as jax_get_model
from repro_torch.configs import get_smoke_config
from repro_torch.core import flatten
from repro_torch.core.base import tree_map
from repro_torch.kernels import ref
from repro_torch.models import get_model, params_from_jax
from repro_torch.models.convert import jax_segments

ARCHS = ["qwen2.5-3b", "gemma3-12b"]
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def _pair(arch):
    jparams = jax_get_model(jax_smoke_config(arch)).init(
        jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    model = get_model(get_smoke_config(arch))
    return jparams, model, params_from_jax(model.cfg, tree, device="cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jnp_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_segments_follow_reference_leaves(arch):
    jparams, model, params = _pair(arch)
    jnames = jlabels.leaf_names(jparams)
    segs = model.segments(params)
    assert [s.name for s in segs] == jnames
    jleaves = jax.tree_util.tree_leaves(jparams)
    for (name, members), jleaf in zip(jax_segments(model.cfg, params),
                                      jleaves):
        stacked = torch.stack(members) if name.startswith("groups/") \
            else members[0]
        np.testing.assert_array_equal(stacked.numpy(), np.asarray(jleaf),
                                      err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tdt,jdt", DTYPES, ids=["f32", "bf16"])
def test_lm_spec_and_pack_equal_reference(arch, tdt, jdt):
    jparams, model, params = _pair(arch)
    jspec = jflatten.build_spec(jparams, dtype=jdt)
    spec = flatten.build_spec(params, dtype=tdt, segments=model.segments)
    assert spec.num_segments == jspec.num_segments
    if arch == "qwen2.5-3b":
        assert spec.num_segments == 15
    assert spec.shapes == jspec.shapes
    assert spec.sizes == jspec.sizes
    assert spec.row_offset == jspec.row_offset
    assert spec.seg_rows == jspec.seg_rows
    assert spec.adapt == jspec.adapt
    assert spec.num_rows == jspec.num_rows
    assert spec.block_rows == jspec.block_rows
    assert spec.nseg_pad == jspec.nseg_pad
    np.testing.assert_array_equal(spec.segment_ids().numpy(),
                                  np.asarray(jspec.segment_ids())[:, 0])
    np.testing.assert_array_equal(spec.adapt_mask().numpy(),
                                  np.asarray(jspec.adapt_mask()))
    buf = flatten.pack(params, spec)
    assert buf.dtype == tdt
    np.testing.assert_array_equal(
        _np(buf), _jnp_bits(jflatten.pack_tree(jparams, jspec)))


@pytest.mark.parametrize("arch", ARCHS)
def test_norm_scales_are_adapt_once_stacked(arch):
    _, model, params = _pair(arch)
    spec = flatten.build_spec(params, segments=model.segments)
    flags = dict(zip(spec.names, spec.adapt))
    assert flags["final_norm/scale"] is False
    norm_names = [n for n in spec.names if n.endswith("norm1/scale")]
    assert norm_names and all(flags[n] for n in norm_names)


def test_unpack_roundtrips_views_into_buffer():
    _, model, params = _pair("qwen2.5-3b")
    spec = flatten.build_spec(params, segments=model.segments)
    buf = flatten.pack(params, spec)
    back = flatten.unpack(buf, spec, params)
    tree_map(lambda a, b: np.testing.assert_array_equal(a.numpy(),
                                                        b.numpy()),
             back, params)
    back["layers"][1]["mlp"]["wi"].fill_(7.0)
    assert bool((buf == 7.0).any())             # a view, not a copy


def test_pack_into_buffer_keeps_padding_zero():
    _, model, params = _pair("gemma3-12b")
    spec = flatten.build_spec(params, dtype=torch.bfloat16,
                              segments=model.segments)
    out = torch.zeros((spec.num_rows, flatten.LANES),
                      dtype=torch.bfloat16)
    flatten.pack(params, spec, out=out)
    flatten.pack(params, spec, out=out)
    np.testing.assert_array_equal(_np(out), _np(flatten.pack(params, spec)))
    with pytest.raises(ValueError, match="spec wants"):
        flatten.pack(params, spec, out=out.float())


MIXED = {"dense": {"w": (8, 16), "b": (16,)}, "odd": (7,),
         "t3": (3, 5, 13), "head": (33, 65), "list": [(4, 3), (2,)]}


def test_plain_tree_takes_reference_flatten_order():
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s).astype(np.float32), MIXED,
        is_leaf=lambda x: isinstance(x, tuple))
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = jax.tree_util.tree_map(torch.from_numpy, tree)
    jspec = jflatten.build_spec(jtree)
    spec = flatten.build_spec(ttree)
    assert list(spec.names) == jlabels.leaf_names(jtree)
    assert spec.adapt == jspec.adapt and spec.num_rows == jspec.num_rows
    np.testing.assert_array_equal(
        flatten.pack(ttree, spec).numpy(),
        np.asarray(jflatten.pack_tree(jtree, jspec)))


def test_plain_segmenter_refuses_lm_tree():
    _, _, params = _pair("qwen2.5-3b")
    with pytest.raises(ValueError, match="model.segments"):
        flatten.build_spec(params)


IDX = np.array([0, 1, 5, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 17, 2 ** 32 - 1,
                3_397_103_615, 123456789], np.int64)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1, -3])
def test_hash_bits_bitwise(seed):
    want = np.asarray(jref.hash_bits(jnp.asarray(IDX.astype(np.uint32)),
                                     jnp.asarray(seed).astype(jnp.uint32)))
    got = ref.hash_bits(torch.from_numpy(IDX), seed).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("buf", [0, 1])
def test_buf_bits_bitwise_with_tensor_seed(buf):
    seed = torch.tensor(11, dtype=torch.int32)
    want = np.asarray(jref.buf_bits(jnp.asarray(IDX.astype(np.uint32)),
                                    jnp.int32(11), buf))
    got = ref.buf_bits(torch.from_numpy(IDX), seed, buf).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_element_index_wraps_like_reference():
    # a row past 2^31 / 128: the reference's int32 iota wraps, and read
    # as uint32 it is the index mod 2^32
    row0 = (2 ** 31) // 128 - 2
    want = np.asarray(jref.element_index(4, 128, row0=row0)) \
        .astype(np.uint32).astype(np.int64)
    got = ref.element_index(4, 128, row0).numpy()
    np.testing.assert_array_equal(got, want)
    rows = torch.tensor([row0, row0 + 3, (2 ** 32) // 128 + 5])
    got = ref.element_index(3, 128, rows).numpy()
    assert got[2, 0] == 5 * 128
    assert got[1, 127] == ((row0 + 3) * 128 + 127) % 2 ** 32
