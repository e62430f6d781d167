"""VGG-16 feature trunk truncated at block3_conv3, port of ssd_object_detection_tpu/models/vgg.py.

Layers keep the Keras/flax names (`block{b}_conv{i}`), so converted flax parameters
load by name (models/convert.py). For a 300x300 input the trunk output is 75x75x256.

The JAX package's `s2d_stem` is an exact space-to-depth rewrite of block1 for the
TPU's matrix unit (same parameters, same outputs); the port accepts the flag and always
runs the plain stem, which tests/test_torch_model.py holds equal to JAX's
`s2d_stem=True` output.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def same_padding(size: int, kernel: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """flax/XLA `SAME` padding (before, after) of one spatial dim: the odd pixel goes
    AFTER. E.g. a stride-2 3x3 conv on an even input pads (0, 1), where PyTorch's
    symmetric `padding=1` would shift every output pixel."""
    out = -(-size // stride)
    effective = (kernel - 1) * dilation + 1
    total = max((out - 1) * stride + effective - size, 0)
    return total // 2, total - total // 2


def conv_pads(x: torch.Tensor, conv: nn.Module, padding: str) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) padding of `conv` on NCHW `x`: flax `SAME` (the odd
    pixel after) or `VALID`."""
    if padding == "VALID":
        return 0, 0, 0, 0
    if padding != "SAME":
        raise ValueError(f"unknown padding {padding!r}")
    h_pad = same_padding(x.shape[2], conv.kernel_size[0], conv.stride[0], conv.dilation[0])
    w_pad = same_padding(x.shape[3], conv.kernel_size[1], conv.stride[1], conv.dilation[1])
    return (*h_pad, *w_pad)


def conv_nchw(x: torch.Tensor, conv: nn.Module, padding: str, dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Conv(dtype=dtype, param_dtype=float32)` on an NCHW tensor: the one
    funnel of every conv of the port's models.

    flax casts the input, the kernel and the bias to the compute dtype; the casts are
    explicit here, so the parameters (and their gradients) stay float32 while bf16
    compute matches flax's. `padding` is "SAME" (flax convention) or "VALID". A conv
    may have no bias and may be grouped (depthwise). A module that is not exactly an
    `nn.Conv2d` (the int8 conv of ops/quant.py, or its calibration observer) computes
    the conv itself through its `conv_nchw(x, pads, dtype)`.
    """
    pads = conv_pads(x, conv, padding)
    if type(conv) is not nn.Conv2d:
        return conv.conv_nchw(x, pads, dtype)
    return float_conv(x, conv, pads, dtype)


def float_conv(x: torch.Tensor, conv: nn.Conv2d, pads: Tuple[int, int, int, int],
               dtype: torch.dtype) -> torch.Tensor:
    """`conv` in `dtype` with explicit (top, bottom, left, right) padding."""
    weight = conv.weight.to(dtype)
    bias = conv.bias.to(dtype) if conv.bias is not None else None
    x = x.to(dtype)
    top, bottom, left, right = pads
    if top != bottom or left != right:
        x = F.pad(x, (left, right, top, bottom))
        pad = (0, 0)
    else:
        pad = (top, left)
    return F.conv2d(x, weight, bias, stride=conv.stride, padding=pad, dilation=conv.dilation,
                    groups=conv.groups)


class VGG16Trunk(nn.Module):
    """conv3-64 x2, pool, conv3-128 x2, pool, conv3-256 x3 (through block3_conv3).

    Works on NCHW tensors; pools are 2x2/s2 VALID, as in the JAX trunk.
    """

    STAGES = ((1, 3, 64, 2), (2, 64, 128, 2), (3, 128, 256, 3))

    def __init__(self, dtype: torch.dtype = torch.float32, s2d_stem: bool = False):
        super().__init__()
        self.dtype = dtype
        self.s2d_stem = s2d_stem  # accepted for config compatibility; plain stem runs
        for block, in_ch, features, n_convs in self.STAGES:
            for i in range(1, n_convs + 1):
                self.add_module(
                    f"block{block}_conv{i}",
                    nn.Conv2d(in_ch if i == 1 else features, features, 3),
                )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block, _, _, n_convs in self.STAGES:
            if block > 1:
                x = F.max_pool2d(x, 2, 2)
            for i in range(1, n_convs + 1):
                x = F.relu(conv_nchw(x, getattr(self, f"block{block}_conv{i}"), "SAME", self.dtype))
        return x
