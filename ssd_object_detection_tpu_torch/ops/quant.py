"""Post-training int8 quantization (PTQ) for serving, port of ssd_object_detection_tpu/ops/quant.py.

The scheme is the JAX package's: weights symmetric per output channel (scale =
absmax / 127, computed once from the float weights), activations symmetric per tensor
with static scales calibrated offline (max |x| over calibration batches), int32
accumulation, then dequantize + bias in the compute dtype. Only the convs that
`eligible` accepts run int8: exactly an `nn.Conv2d`, no dilation, no groups, at least
`min_in_ch` input channels, and not a loc/conf head unless `include_heads`. So SSD512's
dilated convs and MobileNetV2's depthwise convs stay float, as in JAX.

Every conv of the port's models goes through models/vgg.py::conv_nchw, which hands a
module that is not exactly an `nn.Conv2d` its own `conv_nchw`. Calibration and
discovery swap each conv for an `_Observer` for one forward and back; the quantized
model is a copy with each quantized conv replaced by a `QuantConv2d`, which holds the
int8 weights and scales and no float kernel, and runs `torch.ops.ssd_torch.int8_conv`
(ops/cuda_int8.py: the CUDA kernels on the card, the plain version on the CPU).

QuantSpec keys are the flax paths (`vgg/block3_conv1`, `resnet/layer3_block0/proj`,
`extra0_conv0`), in the JAX package's execution order, and its arrays are JAX's layout
(w_q HWIO), computed with the same numpy arithmetic, so a QuantSpec of the port equals
the JAX one key by key and bit for bit.
"""

from __future__ import annotations

import copy
import contextlib
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ssd_object_detection_tpu_torch.models.vgg import float_conv
from ssd_object_detection_tpu_torch.ops import cuda_int8  # registers ssd_torch::int8_conv
from ssd_object_detection_tpu_torch.ops.cuda_int8 import Pads

QuantSpec = Dict[str, Dict[str, torch.Tensor]]  # path -> {w_q, w_scale, bias, x_scale}


def _is_head(path: str) -> bool:
    leaf = path.rsplit("/", 1)[-1]
    return leaf.startswith("loc_head") or leaf.startswith("conf_head")


def _path(name: str) -> str:
    """torch module name -> flax path: `resnet.layer2_block0.proj` -> `resnet/layer2_block0/proj`."""
    return name.replace(".", "/")


def _eligible(conv: nn.Module, path: str, x: torch.Tensor, min_in_ch: int,
              include_heads: bool) -> bool:
    """Whether the conv at `path`, called on NCHW `x`, runs int8 (quant.py::_eligible)."""
    if type(conv) is not nn.Conv2d:
        return False
    if any(d != 1 for d in conv.dilation) or conv.groups != 1:
        return False
    if x.dim() != 4 or x.shape[1] < min_in_ch:
        return False
    return include_heads or not _is_head(path)


class _Observer(nn.Module):
    """Stands in for one conv during a forward: records (path, max |x| in float32) when
    the conv is eligible, then runs the float conv."""

    def __init__(self, conv: nn.Conv2d, path: str, sink: Callable, min_in_ch: int,
                 include_heads: bool):
        super().__init__()
        self.conv, self.path, self.sink = conv, path, sink
        self.min_in_ch, self.include_heads = min_in_ch, include_heads
        self.kernel_size, self.stride, self.dilation = conv.kernel_size, conv.stride, conv.dilation

    def conv_nchw(self, x: torch.Tensor, pads: Pads, dtype: torch.dtype) -> torch.Tensor:
        if _eligible(self.conv, self.path, x, self.min_in_ch, self.include_heads):
            self.sink(self.path, x)
        return float_conv(x, self.conv, pads, dtype)


@contextlib.contextmanager
def _observing(model: nn.Module, sink: Callable, min_in_ch: int,
               include_heads: bool) -> Iterator[None]:
    """Every exact `nn.Conv2d` of `model` swapped for an `_Observer` inside the block."""
    convs = [(name, m) for name, m in model.named_modules() if type(m) is nn.Conv2d]
    try:
        for name, conv in convs:
            _set_module(model, name, _Observer(conv, _path(name), sink, min_in_ch, include_heads))
        yield
    finally:
        for name, conv in convs:
            _set_module(model, name, conv)


def _set_module(model: nn.Module, name: str, module: nn.Module) -> None:
    parent, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, leaf, module)


def discover_eligible(model: nn.Module, input_shape: Tuple[int, ...], min_in_ch: int = 128,
                      include_heads: bool = False) -> Tuple[str, ...]:
    """Eligible conv paths in execution order, from one forward of a copy of `model` on
    the meta device (shapes only: no weights are read, no FLOPs run)."""
    found: List[str] = []
    meta = copy.deepcopy(model).to("meta")
    with _observing(meta, lambda path, x: found.append(path), min_in_ch, include_heads), \
            torch.no_grad():
        meta(torch.empty(input_shape, device="meta"))
    return tuple(dict.fromkeys(found))


def calibrate(model: nn.Module, batches: Iterable, min_in_ch: int = 128,
              include_heads: bool = False) -> Dict[str, float]:
    """Per-eligible-conv activation absmax over `batches` of model INPUTS (normalized as
    the serving path feeds them, (x - 0.5) * 2), in execution order: {path: absmax}.
    One float forward per batch on the model's device, under no_grad."""
    device = next(model.parameters()).device
    stats: Dict[str, float] = {}

    def record(path, x):
        amax = float(x.float().abs().max())
        stats[path] = max(stats.get(path, 0.0), amax)

    with _observing(model, record, min_in_ch, include_heads), torch.no_grad():
        for images in batches:
            model(torch.as_tensor(images).to(device))
    return stats


def quantize_weights(model: nn.Module, stats: Dict[str, float]) -> QuantSpec:
    """int8 weights, per-channel weight scales, float biases and activation scales for
    every calibrated conv path, with JAX's numpy arithmetic (quant.py:165-189) on the
    flax layout: w_q (KH, KW, IC, OC) int8, w_scale (OC,), bias (OC,), x_scale ()."""
    qspec: QuantSpec = {}
    for path, amax in stats.items():
        conv = model.get_submodule(path.replace("/", "."))
        kernel = conv.weight.detach().cpu().numpy().astype(np.float32).transpose(2, 3, 1, 0)
        bias = (conv.bias.detach().cpu().numpy().astype(np.float32) if conv.bias is not None
                else np.zeros(kernel.shape[-1], np.float32))
        w_scale = np.abs(kernel).reshape(-1, kernel.shape[-1]).max(axis=0) / 127.0
        w_scale = np.maximum(w_scale, 1e-12)
        w_q = np.clip(np.round(kernel / w_scale), -127, 127).astype(np.int8)
        x_scale = max(float(amax), 1e-12) / 127.0
        qspec[path] = {
            "w_q": torch.from_numpy(w_q),
            "w_scale": torch.from_numpy(np.asarray(w_scale, np.float32)),
            "bias": torch.from_numpy(bias),
            "x_scale": torch.tensor(np.float32(x_scale)),
        }
    return qspec


def int8_conv(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              bias: Optional[torch.Tensor], x_scale: torch.Tensor, stride: Tuple[int, int],
              pads: Pads) -> torch.Tensor:
    """The counterpart of quant.py::_int8_conv on NHWC x: quantize, int8 conv with
    w_q (OC, KH, KW, IC), dequantize (+ bias) into x's dtype -> NHWC. The CUDA kernels
    for CUDA tensors, the plain version for CPU tensors."""
    return torch.ops.ssd_torch.int8_conv(x, w_q, w_scale, bias, x_scale, stride[0], stride[1],
                                         *pads)


class QuantConv2d(nn.Module):
    """An int8 conv in place of an `nn.Conv2d`: buffers w_q (OC, KH, KW, IC) int8,
    w_scale (OC,), bias (OC,) or none, x_scale (); no float kernel."""

    def __init__(self, conv: nn.Conv2d, q: Dict[str, torch.Tensor]):
        super().__init__()
        if any(d != 1 for d in conv.dilation) or conv.groups != 1:
            raise ValueError("the int8 conv takes no dilation and no groups")
        self.kernel_size, self.stride, self.dilation = conv.kernel_size, conv.stride, conv.dilation
        device = conv.weight.device
        w_q = torch.as_tensor(q["w_q"]).permute(3, 0, 1, 2).contiguous()  # HWIO -> (OC, KH, KW, IC)
        if tuple(w_q.shape) != (conv.out_channels, *conv.kernel_size, conv.in_channels):
            raise ValueError(f"w_q {tuple(q['w_q'].shape)} does not fit the conv {conv}")
        self.register_buffer("w_q", w_q.to(device))
        self.register_buffer("w_scale", torch.as_tensor(q["w_scale"], dtype=torch.float32).to(device))
        self.register_buffer("bias", torch.as_tensor(q["bias"], dtype=torch.float32).to(device)
                             if conv.bias is not None else None)
        self.register_buffer("x_scale", torch.as_tensor(q["x_scale"], dtype=torch.float32).to(device))

    def conv_nchw(self, x: torch.Tensor, pads: Pads, dtype: torch.dtype) -> torch.Tensor:
        """NCHW (channels-last) x in the compute dtype -> NCHW with channels-last memory."""
        out = int8_conv(x.to(dtype).permute(0, 2, 3, 1).contiguous(), self.w_q, self.w_scale,
                        self.bias, self.x_scale, self.stride, pads)
        return out.permute(0, 3, 1, 2)


def quantize_model(model: nn.Module, qspec: QuantSpec) -> nn.Module:
    """A copy of `model` whose convs in `qspec` run int8 (the counterpart of
    make_quantized_apply); every other layer runs the float path of the copy."""
    quantized = copy.deepcopy(model)
    for path, q in qspec.items():
        name = path.replace("/", ".")
        _set_module(quantized, name, QuantConv2d(quantized.get_submodule(name), q))
    return quantized


def quantized_convs(model: nn.Module) -> int:
    """How many convs of `model` run int8."""
    return sum(isinstance(m, QuantConv2d) for m in model.modules())


def quantize_synthetic(model: nn.Module, input_shape: Tuple[int, ...], min_in_ch: int = 128,
                       include_heads: bool = False) -> Tuple[nn.Module, int]:
    """PTQ with unit activation scales, for timing only (int8 throughput does not
    depend on the scales; the outputs mean nothing): (quantized model, convs)."""
    stats = {path: 1.0 for path in discover_eligible(model, input_shape, min_in_ch, include_heads)}
    return quantize_model(model, quantize_weights(model, stats)), len(stats)


def quantize_ssd(model: nn.Module, calib_batches: Iterable, min_in_ch: int = 128,
                 include_heads: bool = False) -> Tuple[nn.Module, QuantSpec]:
    """calibrate -> quantize_weights -> quantize_model: (quantized model, QuantSpec).
    `calib_batches` are model inputs in the serving normalization ([-1, 1])."""
    stats = calibrate(model, calib_batches, min_in_ch=min_in_ch, include_heads=include_heads)
    qspec = quantize_weights(model, stats)
    return quantize_model(model, qspec), qspec
