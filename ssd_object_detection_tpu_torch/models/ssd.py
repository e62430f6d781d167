"""SSD300 / SSD512 network, port of ssd_object_detection_tpu/models/ssd.py.

Trunk -> extra conv pyramid -> per-tap loc/conf heads. The trunk is VGG-16 (then a 2x2
SAME max-pool), ResNet-34 (models/resnet.py) or MobileNetV2 (models/mobilenet.py),
whose outputs are tap 0 (`blocks[0]` is empty), or the "micro" stem of two 3x3/2 SAME
convs (32, 64 wide, bias, ReLU) that small tests use.
Public layout is the JAX package's: input (B, S, S, 3) NHWC in [-1, 1]; output loc
(B, D, 4) float32 and conf logits (B, D, C), background LAST. Inside, tensors are NCHW
with channels-last memory, which cuDNN takes as is.

Numerics carried over from flax:
  - `SAME` puts the odd padding after: extra1_conv0 (38->19) and extra3_conv1 (10->5)
    pad (0, 1), extra2_conv1 (19->10) pads (1, 1) (models/vgg.py::same_padding);
  - the pre-pyramid `SAME` max-pool (75->38) is a 2x2/s2 pool with ceil_mode;
  - head outputs are permuted NCHW -> NHWC before the (B, H*W*n, k) reshape, which is
    the anchor order of ops/anchors.py;
  - parameters are float32, compute runs in `dtype` (inputs, kernels and biases cast
    explicitly, ReLU in `dtype`); loc comes out float32, conf per `conf_f32`;
  - `remat=True` recomputes the trunk in the backward pass
    (torch.utils.checkpoint, while grad is enabled), as flax's nn.remat does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ssd_object_detection_tpu_torch.models.mobilenet import MobileNetV2Trunk
from ssd_object_detection_tpu_torch.models.resnet import ResNet34Trunk
from ssd_object_detection_tpu_torch.models.vgg import VGG16Trunk, conv_nchw
from ssd_object_detection_tpu_torch.ops.anchors import SSD300_SPEC, SSD512_SPEC, AnchorSpec

# One extra-pyramid conv: (features, kernel, stride, padding[, dilation]).
ConvSpec = Tuple[int, int, int, str]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static architecture description; `blocks[i]` ends at feature-map tap i."""

    name: str
    anchor_spec: AnchorSpec
    blocks: Tuple[Tuple[ConvSpec, ...], ...]
    trunk: str = "vgg16"

    @property
    def image_size(self) -> int:
        return self.anchor_spec.image_size


SSD300_SPEC_MODEL = ModelSpec(
    name="ssd300",
    anchor_spec=SSD300_SPEC,
    blocks=(
        ((512, 3, 1, "SAME"), (512, 3, 1, "SAME"), (512, 1, 1, "SAME")),
        ((1024, 3, 2, "SAME"), (1024, 1, 1, "SAME")),
        ((256, 1, 1, "SAME"), (512, 3, 2, "SAME")),
        ((128, 1, 1, "SAME"), (256, 3, 2, "SAME")),
        ((128, 1, 1, "SAME"), (256, 3, 1, "VALID")),
        ((128, 1, 1, "SAME"), (256, 3, 1, "VALID")),
    ),
)

# SSD512 with the dilated pyramid of the JAX package (same parameter shapes as the
# undilated stack; see ssd_object_detection_tpu/models/ssd.py for why).
SSD512_SPEC_MODEL = ModelSpec(
    name="ssd512",
    anchor_spec=SSD512_SPEC,
    blocks=(
        ((512, 3, 1, "SAME", 2), (512, 3, 1, "SAME", 3), (512, 1, 1, "SAME")),
        ((1024, 3, 2, "SAME", 6), (1024, 1, 1, "SAME")),
        ((256, 1, 1, "SAME"), (512, 3, 2, "SAME", 2)),
        ((128, 1, 1, "SAME"), (256, 3, 2, "SAME")),
        ((128, 1, 1, "SAME"), (256, 3, 2, "SAME")),
        ((128, 1, 1, "SAME"), (256, 3, 2, "SAME")),
        ((128, 1, 1, "SAME"), (256, 3, 2, "SAME")),
    ),
)

# ResNet-34 family: the trunk emits 38x38x256 (SSD300) or 64x64x256 (SSD512), which
# is tap 0; the rest of the pyramid is SSD300's strided blocks.
SSD300_R34_SPEC_MODEL = ModelSpec(
    name="ssd300_r34",
    anchor_spec=SSD300_SPEC,
    trunk="resnet34",
    blocks=(
        (),  # tap 0 = trunk output (38x38x256)
        ((256, 1, 1, "SAME"), (512, 3, 2, "SAME")),
        ((256, 1, 1, "SAME"), (512, 3, 2, "SAME")),
        ((128, 1, 1, "SAME"), (256, 3, 2, "SAME")),
        ((128, 1, 1, "SAME"), (256, 3, 1, "VALID")),
        ((128, 1, 1, "SAME"), (256, 3, 1, "VALID")),
    ),
)

# The undilated 512 pyramid tail of the non-VGG trunks (their trunks already have the
# receptive field that the dilated VGG pyramid adds).
_SSD512_PLAIN_TAIL = (
    ((1024, 3, 2, "SAME"), (1024, 1, 1, "SAME")),
    ((256, 1, 1, "SAME"), (512, 3, 2, "SAME")),
    ((128, 1, 1, "SAME"), (256, 3, 2, "SAME")),
    ((128, 1, 1, "SAME"), (256, 3, 2, "SAME")),
    ((128, 1, 1, "SAME"), (256, 3, 2, "SAME")),
    ((128, 1, 1, "SAME"), (256, 3, 2, "SAME")),
)

SSD512_R34_SPEC_MODEL = ModelSpec(
    name="ssd512_r34", anchor_spec=SSD512_SPEC, trunk="resnet34",
    blocks=((),) + _SSD512_PLAIN_TAIL,
)

# MobileNetV2 family: 38x38x96 (SSD300) or 64x64x96 (SSD512) trunk output as tap 0.
SSD300_MNV2_SPEC_MODEL = ModelSpec(
    name="ssd300_mnv2", anchor_spec=SSD300_SPEC, trunk="mobilenetv2",
    blocks=SSD300_R34_SPEC_MODEL.blocks,
)

SSD512_MNV2_SPEC_MODEL = ModelSpec(
    name="ssd512_mnv2", anchor_spec=SSD512_SPEC, trunk="mobilenetv2",
    blocks=((),) + _SSD512_PLAIN_TAIL,
)

MODEL_SPECS = {
    "ssd300": SSD300_SPEC_MODEL,
    "ssd512": SSD512_SPEC_MODEL,
    "ssd300_r34": SSD300_R34_SPEC_MODEL,
    "ssd512_r34": SSD512_R34_SPEC_MODEL,
    "ssd300_mnv2": SSD300_MNV2_SPEC_MODEL,
    "ssd512_mnv2": SSD512_MNV2_SPEC_MODEL,
}

_TRUNK_CHANNELS = {"vgg16": 256, "resnet34": 256, "mobilenetv2": 96, "micro": 64}
MICRO_CHANNELS = (32, 64)


def _lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """flax's default conv kernel init: truncated normal (+-2 std), variance 1/fan_in."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


class SSD(nn.Module):
    """Full SSD detector. Input: (B, S, S, 3) in [-1, 1]. Output: (loc, conf_logits)."""

    def __init__(
        self,
        num_classes: int = 81,  # INCLUDING background, which is the LAST channel
        spec: ModelSpec = SSD300_SPEC_MODEL,
        dtype: torch.dtype = torch.float32,
        s2d_stem: bool = False,
        conf_f32: bool = True,
        remat: bool = False,
    ):
        super().__init__()
        if spec.trunk not in _TRUNK_CHANNELS:
            raise ValueError(f"unknown trunk {spec.trunk!r}; expected one of {sorted(_TRUNK_CHANNELS)}")
        self.num_classes = num_classes
        self.spec = spec
        self.dtype = dtype
        self.conf_f32 = conf_f32
        self.remat = remat
        if spec.trunk == "vgg16":
            self.vgg = VGG16Trunk(dtype=dtype, s2d_stem=s2d_stem)
        elif spec.trunk == "resnet34":  # s2d_stem is a VGG conv1 rewrite; ignored here
            self.resnet = ResNet34Trunk(dtype=dtype)
        elif spec.trunk == "mobilenetv2":
            self.mobilenet = MobileNetV2Trunk(dtype=dtype)
        else:
            in_ch = 3
            for i, ch in enumerate(MICRO_CHANNELS):
                self.add_module(f"micro_conv{i}", nn.Conv2d(in_ch, ch, 3, stride=2))
                in_ch = ch

        in_ch = _TRUNK_CHANNELS[spec.trunk]
        tap_channels = []
        for bi, block in enumerate(spec.blocks):
            for ci, conv in enumerate(block):
                features, kernel, stride = conv[:3]
                dilation = conv[4] if len(conv) > 4 else 1
                self.add_module(
                    f"extra{bi}_conv{ci}",
                    nn.Conv2d(in_ch, features, kernel, stride=stride, dilation=dilation),
                )
                in_ch = features
            tap_channels.append(in_ch)
        n_priors = spec.anchor_spec.anchors_per_cell
        if len(tap_channels) != len(n_priors):
            raise ValueError(f"{spec.name}: {len(tap_channels)} taps, {len(n_priors)} anchor maps")
        for i, (ch, n) in enumerate(zip(tap_channels, n_priors)):
            self.add_module(f"loc_head{i}", nn.Conv2d(ch, n * 4, 3))
            self.add_module(f"conf_head{i}", nn.Conv2d(ch, n * num_classes, 3))

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "SSD":
        """flax's default init (lecun-normal kernels, zero biases, GroupNorm scale 1 and
        bias 0), from `generator`."""
        for module in self.modules():
            if isinstance(module, nn.Conv2d):
                _lecun_normal_(module.weight, generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.GroupNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)
        return self

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """The trunk on NCHW `x` in the compute dtype -> the pyramid's input."""
        if self.spec.trunk == "vgg16":
            return self.vgg(x)
        if self.spec.trunk == "resnet34":
            return self.resnet(x)  # 38x38x256: tap-0 resolution
        if self.spec.trunk == "mobilenetv2":
            return self.mobilenet(x)  # 38x38x96
        for i in range(len(MICRO_CHANNELS)):
            x = F.relu(conv_nchw(x, getattr(self, f"micro_conv{i}"), "SAME", self.dtype))
        return x

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # NHWC -> NCHW kept channels-last in memory whatever the caller's strides (a
        # planar canvas resize hands over an NCHW-strided view): cuDNN's NHWC kernels
        # then run without layout transposes, and the cast is the one copy either way
        x = images.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        if self.remat and torch.is_grad_enabled():
            x = checkpoint(self.trunk, x, use_reentrant=False)
        else:
            x = self.trunk(x)
        if self.spec.trunk == "vgg16":
            x = F.max_pool2d(x, 2, 2, ceil_mode=True)  # flax SAME: the odd edge pools alone

        feature_maps = []
        for bi, block in enumerate(self.spec.blocks):
            for ci, conv in enumerate(block):
                x = F.relu(conv_nchw(x, getattr(self, f"extra{bi}_conv{ci}"), conv[3], self.dtype))
            feature_maps.append(x)

        locs, confs = [], []
        for i, (fm, (fh, fw)) in enumerate(zip(feature_maps, self.spec.anchor_spec.feature_sizes)):
            if tuple(fm.shape[2:]) != (fh, fw):
                raise ValueError(
                    f"feature map {i} is {tuple(fm.shape[2:])}, anchor spec expects {(fh, fw)}"
                )
            loc = conv_nchw(fm, getattr(self, f"loc_head{i}"), "SAME", self.dtype)
            conf = conv_nchw(fm, getattr(self, f"conf_head{i}"), "SAME", self.dtype)
            locs.append(loc.permute(0, 2, 3, 1).reshape(loc.shape[0], -1, 4))
            confs.append(conf.permute(0, 2, 3, 1).reshape(conf.shape[0], -1, self.num_classes))

        loc_out = torch.cat(locs, dim=1).float()
        conf_out = torch.cat(confs, dim=1)
        if self.conf_f32:
            conf_out = conf_out.float()
        return loc_out, conf_out
