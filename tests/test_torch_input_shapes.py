"""The port's input shapes (``repro_torch.configs``: ``INPUT_SHAPES``,
``LONG_CONTEXT_SKIP``, ``supports_shape``, ``input_specs``) against
the JAX package's, in-process: the same four shapes, the same (ok,
reason) for every (arch, shape) pair, and meta-device stand-ins of the
reference's shapes and dtypes for all 40 pairs."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro_torch import configs

PAIRS = [(arch, shape) for arch in configs.ARCH_IDS
         for shape in configs.INPUT_SHAPES]


def test_input_shapes_and_skip_reasons_are_the_references():
    assert configs.INPUT_SHAPES == ref_configs.INPUT_SHAPES
    assert configs.LONG_CONTEXT_SKIP == ref_configs.LONG_CONTEXT_SKIP
    assert set(configs.ARCH_IDS) == set(ref_configs.ARCH_IDS)


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_supports_shape_is_the_references(arch, shape):
    got = configs.supports_shape(configs.get_config(arch), shape)
    want = ref_configs.supports_shape(ref_configs.get_config(arch), shape)
    assert got == want


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_input_specs_are_the_references(arch, shape):
    got = configs.input_specs(configs.get_config(arch), shape)
    want = ref_configs.input_specs(ref_configs.get_config(arch), shape)
    assert list(got) == list(want)
    for name, spec in want.items():
        t = got[name]
        assert t.device.type == "meta", name
        assert tuple(t.shape) == tuple(spec.shape), name
        want_dtype = torch.bfloat16 if spec.dtype.name == "bfloat16" \
            else torch.from_numpy(np.zeros((), spec.dtype)).dtype
        assert t.dtype == want_dtype, (name, t.dtype, spec.dtype)
