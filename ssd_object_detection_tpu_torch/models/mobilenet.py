"""MobileNetV2 detection trunk (GroupNorm), port of ssd_object_detection_tpu/models/mobilenet.py.

The SSDLite trunk with the last strided stage at stride 1, so a 300x300 input gives a
38x38x96 tap-0 feature (512x512 gives 64x64x96):

    stem conv 3x3/2 32 (no bias) -> GroupNorm(8) -> relu6
    stages (expand t, channels c, repeats n, first stride s):
      (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 1), (6, 96, 3, 1)

An inverted residual is 1x1 expand (when t != 1) -> 3x3 depthwise (`groups` = its
channels) -> 1x1 linear project, each followed by GroupNorm(8) and relu6 but the last;
the input is added when the stride is 1 and the width is unchanged. `SAME` padding as
flax: (0, 1) on 300->150, 150->75, 512->256, 256->128, 128->64; (1, 1) on 75->38.
GroupNorm as models/resnet.py::group_norm (epsilon 1e-6, float32, cast back).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ssd_object_detection_tpu_torch.models.resnet import GN_EPS, group_norm
from ssd_object_detection_tpu_torch.models.vgg import conv_nchw

STAGES = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 1), (6, 96, 3, 1))


def relu6(x: torch.Tensor) -> torch.Tensor:
    """flax's `jnp.minimum(nn.relu(x), 6.0)`, gradient included: 0 at x = 0 and 0.5 at
    x = 6 (a clamp would pass 1 at both)."""
    return torch.minimum(F.relu(x), x.new_full((), 6.0))


class InvertedResidual(nn.Module):
    """MobileNetV2 bottleneck: 1x1 expand -> 3x3 depthwise -> 1x1 linear project."""

    def __init__(self, in_ch: int, features: int, expand: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.residual = stride == 1 and in_ch == features
        mid = in_ch * expand
        if expand != 1:
            self.expand = nn.Conv2d(in_ch, mid, 1, bias=False)
            self.expand_norm = nn.GroupNorm(8, mid, eps=GN_EPS)
        else:
            self.expand = None
        self.depthwise = nn.Conv2d(mid, mid, 3, stride=stride, groups=mid, bias=False)
        self.dw_norm = nn.GroupNorm(8, mid, eps=GN_EPS)
        self.project = nn.Conv2d(mid, features, 1, bias=False)
        self.project_norm = nn.GroupNorm(8, features, eps=GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        y = x
        if self.expand is not None:
            y = relu6(group_norm(conv_nchw(y, self.expand, "SAME", d), self.expand_norm, d))
        y = relu6(group_norm(conv_nchw(y, self.depthwise, "SAME", d), self.dw_norm, d))
        y = group_norm(conv_nchw(y, self.project, "SAME", d), self.project_norm, d)
        return y + x if self.residual else y


class MobileNetV2Trunk(nn.Module):
    """MobileNetV2 through the 96-channel stage (stride-1 tap): 300^2 -> 38^2 x 96, NCHW."""


    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem = nn.Conv2d(3, 32, 3, stride=2, bias=False)
        self.stem_norm = nn.GroupNorm(8, 32, eps=GN_EPS)
        in_ch = 32
        for si, (t, c, n, s) in enumerate(STAGES):
            for bi in range(n):
                self.add_module(f"stage{si}_block{bi}", InvertedResidual(
                    in_ch, c, expand=t, stride=s if bi == 0 else 1, dtype=dtype))
                in_ch = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = relu6(group_norm(conv_nchw(x, self.stem, "SAME", self.dtype), self.stem_norm, self.dtype))
        for si, (_, _, n, _) in enumerate(STAGES):
            for bi in range(n):
                x = getattr(self, f"stage{si}_block{bi}")(x)
        return x
