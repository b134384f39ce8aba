"""The paper's image classifiers: the port of ``repro.models.cnn``.

A small ResNet-style CNN (3 stages of residual 3×3-conv blocks with
GroupNorm) and an MLP, with the four weight initialisations of the
paper's §5.2.3 ablation (xavier / kaiming, uniform / normal).

Layouts: images enter as NHWC ``[B, H, W, C]``, as in the reference;
the convolutions run in NCHW with OIHW weights (PyTorch's layout), and
``models.convert.classifier_params_from_jax`` maps the reference's
HWIO weights onto them. Dense weights are ``[in, out]`` in both
packages. The parameter tree has the reference's keys, so it flattens
to the same leaves in the same order (``core.base``).

Convolutions pad as XLA's ``"SAME"``: the total padding of a dimension
is ``max((out - 1)·stride + k - size, 0)`` with ``out = ceil(size /
stride)``, the smaller half before. A stride-2 3×3 convolution of an
even size pads 0 before and 1 after (PyTorch's ``padding=1`` would pad
one on each side and shift every output).

Initialisers draw from an explicit ``torch.Generator``: the same
distributions as the reference's ``jax.random`` draws, other samples.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch import device as _device

INITS = ("xavier_uniform", "xavier_normal", "kaiming_uniform",
         "kaiming_normal")


def _fans(shape) -> tuple[float, float]:
    if len(shape) == 4:   # OIHW conv
        rf = shape[2] * shape[3]
        return shape[1] * rf, shape[0] * rf
    return shape[0], shape[1]


def make_initializer(method: str) -> Callable:
    """``init(gen, shape) -> f32 tensor`` on the generator's device for
    one of :data:`INITS`; fans follow the reference (OIHW here, HWIO
    there: the same numbers)."""
    if method not in INITS:
        raise ValueError(f"unknown init {method!r}; one of {INITS}")

    def init(gen: torch.Generator, shape) -> torch.Tensor:
        fan_in, fan_out = _fans(shape)
        dev = gen.device
        if method.endswith("uniform"):
            lim = math.sqrt(6.0 / (fan_in + fan_out)) \
                if method == "xavier_uniform" else math.sqrt(6.0 / fan_in)
            u = torch.rand(shape, generator=gen, device=dev)
            return u * (2.0 * lim) - lim
        std = math.sqrt(2.0 / (fan_in + fan_out)) \
            if method == "xavier_normal" else math.sqrt(2.0 / fan_in)
        return torch.randn(shape, generator=gen, device=dev) * std

    return init


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """XLA "SAME" padding of an NCHW tensor for a k×k window."""
    pads = []
    for size in (x.shape[3], x.shape[2]):       # F.pad: last dim first
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    return F.conv2d(_same_pad(x, w.shape[-1], stride), w, stride=stride)


def _groupnorm(p: dict, x: torch.Tensor, groups: int = 8,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of NCHW ``x`` over (C/groups, H, W) with the population
    variance, as the reference; returns f32."""
    b, c, h, w = x.shape
    xg = x.reshape(b, groups, c // groups, h, w).float()
    mu = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = xg.var(dim=(2, 3, 4), keepdim=True, unbiased=False)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    x = xg.reshape(b, c, h, w)
    return (x * p["scale"][None, :, None, None]
            + p["bias"][None, :, None, None]).float()


def init_cnn(seed: int = 0, *, num_classes: int = 10, width: int = 32,
             blocks_per_stage: int = 2, in_channels: int = 3,
             init_method: str = "xavier_uniform", device="cuda") -> dict:
    """3-stage residual CNN (a ResNet18-shaped scaled-down sibling);
    conv weights OIHW, on ``device`` (the card unless asked)."""
    device = _device.resolve(device)
    wi = make_initializer(init_method)
    gen = _generator(seed, device)

    def gn(c):
        return {"scale": torch.ones(c, device=device),
                "bias": torch.zeros(c, device=device)}

    params: dict = {"stem": {"w": wi(gen, (width, in_channels, 3, 3))},
                    "stem_gn": gn(width)}
    c = width
    for s in range(3):
        c_out = width * (2 ** s)
        stage = []
        for b in range(blocks_per_stage):
            blk = {"w1": wi(gen, (c_out, c if b == 0 else c_out, 3, 3)),
                   "gn1": gn(c_out),
                   "w2": wi(gen, (c_out, c_out, 3, 3)),
                   "gn2": gn(c_out)}
            if b == 0 and c != c_out:
                blk["proj"] = wi(gen, (c_out, c, 1, 1))
            stage.append(blk)
        params[f"stage{s}"] = stage
        c = c_out
    params["head"] = {"w": wi(gen, (c, num_classes)),
                      "b": torch.zeros(num_classes, device=device)}
    return params


def apply_cnn(params: dict, images: torch.Tensor) -> torch.Tensor:
    """images: [B, H, W, C] -> logits [B, num_classes]."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(_groupnorm(params["stem_gn"], _conv(x, params["stem"]["w"])))
    for s in range(3):
        for b, blk in enumerate(params[f"stage{s}"]):
            stride = 2 if (s > 0 and b == 0) else 1
            res = x
            if "proj" in blk:
                res = _conv(x, blk["proj"], stride)
            elif stride != 1:
                res = x[:, :, ::stride, ::stride]
            y = F.relu(_groupnorm(blk["gn1"], _conv(x, blk["w1"], stride)))
            y = _groupnorm(blk["gn2"], _conv(y, blk["w2"]))
            x = F.relu(y + res)
    x = x.mean(dim=(2, 3))
    return x @ params["head"]["w"] + params["head"]["b"]


def init_mlp_classifier(seed: int = 0, *, in_dim: int, num_classes: int,
                        hidden: int = 256, depth: int = 3,
                        init_method: str = "xavier_uniform",
                        device="cuda") -> dict:
    device = _device.resolve(device)
    wi = make_initializer(init_method)
    gen = _generator(seed, device)
    dims = [in_dim] + [hidden] * (depth - 1) + [num_classes]
    return {f"fc{i}": {"w": wi(gen, (dims[i], dims[i + 1])),
                       "b": torch.zeros(dims[i + 1], device=device)}
            for i in range(depth)}


def apply_mlp_classifier(params: dict, x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(x.shape[0], -1)
    n = len(params)
    for i in range(n):
        p = params[f"fc{i}"]
        x = x @ p["w"] + p["b"]
        if i < n - 1:
            x = F.relu(x)
    return x
