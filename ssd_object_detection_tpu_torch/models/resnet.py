"""ResNet-34 detection trunk (GroupNorm), port of ssd_object_detection_tpu/models/resnet.py.

MLPerf SSD-R34 shape: ResNet-34 through layer3 with layer3 at stride 1, so a 300x300
input gives a 38x38x256 tap-0 feature (512x512 gives 64x64x256):

    conv1 7x7/2 64 (no bias) -> GroupNorm(32) -> relu -> max-pool 3x3/2 SAME
    layer1: 3 basic blocks,  64 ch, stride 1
    layer2: 4 basic blocks, 128 ch, stride 2
    layer3: 6 basic blocks, 256 ch, stride 1

Numerics carried over from flax, on NCHW tensors with channels-last memory:
  - `SAME` puts the odd padding after: conv1 on 300 pads (2, 3), the stride-2 convs
    of layer2 on 75 pad (1, 1) (models/vgg.py::same_padding);
  - the max-pool pads with -inf after: (0, 1) on 150 and 256;
  - GroupNorm uses flax's epsilon 1e-6 (torch's default is 1e-5) and runs in float32,
    its output cast to the compute dtype, as flax promotes the statistics;
  - module names are the flax paths (`layer2_block0.proj`, `.proj_norm`, ...), so
    models/convert.py maps them one to one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ssd_object_detection_tpu_torch.models.vgg import conv_nchw, same_padding

GN_EPS = 1e-6  # flax nn.GroupNorm's epsilon

# (n_blocks, features, first_stride); layer3 keeps stride 1 (MLPerf SSD-R34)
LAYERS = ((3, 64, 1), (4, 128, 2), (6, 256, 1))


def group_norm(x: torch.Tensor, norm: nn.GroupNorm, dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.GroupNorm(dtype=dtype, param_dtype=float32)`: statistics and the affine
    map in float32, the result cast to `dtype`. On the card F.group_norm returns NCHW
    memory for a channels-last input; casting back to channels-last cost more device
    time than cuDNN's own transposes at the next conv (PERF.md)."""
    return F.group_norm(x.float(), norm.num_groups, norm.weight, norm.bias, norm.eps).to(dtype)


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """flax `nn.max_pool(padding="SAME")`: the padding is -inf, the odd pixel after."""
    h_pad = same_padding(x.shape[2], window, stride)
    w_pad = same_padding(x.shape[3], window, stride)
    x = F.pad(x, (w_pad[0], w_pad[1], h_pad[0], h_pad[1]), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


class BasicBlock(nn.Module):
    """3x3 conv -> GN -> relu -> 3x3 conv -> GN -> add -> relu; a 1x1 conv + GN
    projection on the shortcut when the stride or the width changes."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        groups = min(32, features)
        self.conv1 = nn.Conv2d(in_ch, features, 3, stride=stride, bias=False)
        self.norm1 = nn.GroupNorm(groups, features, eps=GN_EPS)
        self.conv2 = nn.Conv2d(features, features, 3, bias=False)
        self.norm2 = nn.GroupNorm(groups, features, eps=GN_EPS)
        if stride != 1 or in_ch != features:
            self.proj = nn.Conv2d(in_ch, features, 1, stride=stride, bias=False)
            self.proj_norm = nn.GroupNorm(groups, features, eps=GN_EPS)
        else:
            self.proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        y = F.relu(group_norm(conv_nchw(x, self.conv1, "SAME", d), self.norm1, d))
        y = group_norm(conv_nchw(y, self.conv2, "SAME", d), self.norm2, d)
        residual = x
        if self.proj is not None:  # after conv2, as in flax: the execution order
            residual = group_norm(conv_nchw(x, self.proj, "SAME", d), self.proj_norm, d)
        return F.relu(y + residual)


class ResNet34Trunk(nn.Module):
    """ResNet-34 through layer3 (stride-1 layer3): 300^2 -> 38^2 x 256, NCHW."""


    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, bias=False)
        self.norm1 = nn.GroupNorm(32, 64, eps=GN_EPS)
        in_ch = 64
        for li, (n_blocks, features, stride) in enumerate(LAYERS, start=1):
            for bi in range(n_blocks):
                self.add_module(f"layer{li}_block{bi}", BasicBlock(
                    in_ch, features, stride=stride if bi == 0 else 1, dtype=dtype))
                in_ch = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(group_norm(conv_nchw(x, self.conv1, "SAME", self.dtype), self.norm1, self.dtype))
        x = max_pool_same(x, 3, 2)
        for li, (n_blocks, _, _) in enumerate(LAYERS, start=1):
            for bi in range(n_blocks):
                x = getattr(self, f"layer{li}_block{bi}")(x)
        return x
