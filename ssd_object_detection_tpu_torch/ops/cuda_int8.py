"""The int8 conv of post-training quantization: CUDA kernels (csrc/int8_conv.cu), their
plain PyTorch versions, and the `ssd_torch::int8_conv` operator over both.

Counterpart of ssd_object_detection_tpu/ops/quant.py::_int8_conv, which XLA lowers (no
Pallas kernel): quantize x per tensor, an int8 x int8 -> int32 conv, dequantize by
x_scale * w_scale[oc], add the bias, cast to the compute dtype. Layouts are NHWC
activations and (OC, KH, KW, IC) int8 weights; padding is explicit (top, bottom, left,
right), so flax's `SAME` (odd pixel after) and `VALID` are both cases of it.

`torch.ops.ssd_torch.int8_conv` is a `torch.library.custom_op`: its CUDA implementation
is the kernel pair (`int8_conv_cuda`), its CPU implementation the plain version
(`int8_conv_plain`), and a fake implementation gives `torch.export` the output's shape,
so a quantized detect program exports and reloads. Importing this module registers the
operator; it builds nothing. The kernels are compiled at their first launch
(ops/_cuda_build.py: nvcc for sm_90a, -fmad=false, into `build/kernels/`).
`int8_conv_cuda.launches` counts calls that launched the pair (CPU calls do not count).

The plain version quantizes with torch ops (a true division by the scale tensor,
round half to even, clip), convolves the int8 values in float64 (every partial sum is
an integer below 2^53, so the result is exact in any order) and dequantizes as separate
float32 ops: the kernel is held bit-equal to it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ssd_object_detection_tpu_torch.ops import _cuda_build

SOURCE = _cuda_build.CSRC / "int8_conv.cu"
NVCC_FLAGS = _cuda_build.BASE_FLAGS + ("-fmad=false",)
K_CHUNK = 64  # input channels per K stage of the conv kernel (csrc/int8_conv.cu kBK)
OUT_MODES = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}

Pads = Tuple[int, int, int, int]  # (top, bottom, left, right)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "ssd_int8_quantize": ([_P, _I, _P, _P, _L, _I, _I, _I, _P], _I),
    "ssd_int8_conv": ([_P] * 6 + [_I] * 15 + [_P], _I),
}


def build():
    """Compile csrc/int8_conv.cu unless the library for this source already exists."""
    return _cuda_build.build(SOURCE, NVCC_FLAGS)


def _lib():
    return _cuda_build.load(SOURCE, NVCC_FLAGS, _SIGNATURES)


def padded_channels(ic: int) -> int:
    """The channel pitch of the kernels' int8 buffers: IC rounded up to K_CHUNK."""
    return -(-ic // K_CHUNK) * K_CHUNK


def out_size(size: int, kernel: int, stride: int, before: int, after: int) -> int:
    return (size + before + after - kernel) // stride + 1


# --- the plain version ---------------------------------------------------------------


def quantize_plain(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """clip(round(float32(x) / x_scale), -127, 127) as int8, elementwise (JAX's order)."""
    return torch.clamp(torch.round(x.float() / x_scale), -127, 127).to(torch.int8)


def accumulate_plain(xq: torch.Tensor, w_q: torch.Tensor, stride: Tuple[int, int],
                     pads: Pads) -> torch.Tensor:
    """int32 accumulators (B, Ho, Wo, OC) of int8 xq (B, H, W, IC) and w_q (OC, KH, KW, IC),
    from a float64 conv (exact: every partial sum is an integer below 2^53)."""
    top, bottom, left, right = pads
    x = F.pad(xq.permute(0, 3, 1, 2).double(), (left, right, top, bottom))
    acc = F.conv2d(x, w_q.permute(0, 3, 1, 2).double(), stride=stride)
    return acc.to(torch.int32).permute(0, 2, 3, 1).contiguous()


def dequantize_plain(acc: torch.Tensor, x_scale: torch.Tensor, w_scale: torch.Tensor,
                     bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """float32(acc) * (x_scale * w_scale) [+ bias], cast to `dtype`: quant.py:214-217."""
    y = acc.float() * (x_scale * w_scale)
    if bias is not None:
        y = y + bias
    return y.to(dtype)


def int8_conv_plain(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                    bias: Optional[torch.Tensor], x_scale: torch.Tensor,
                    stride: Tuple[int, int], pads: Pads) -> torch.Tensor:
    """The whole int8 conv in plain PyTorch: NHWC x -> NHWC output in x's dtype."""
    acc = accumulate_plain(quantize_plain(x, x_scale), w_q, stride, pads)
    return dequantize_plain(acc, x_scale, w_scale, bias, x.dtype)


# --- the kernels -----------------------------------------------------------------------


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device,
           dim: Optional[int] = None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if dim is not None and t.dim() != dim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {dim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def quantize_cuda(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """One launch of the quantize kernel: x (B, H, W, IC) float32 or bf16 on the card ->
    int8 (B, H, W, ICp), zero in the channels past IC (ICp = padded_channels(IC))."""
    if x.device.type != "cuda":
        raise ValueError(f"the quantize kernel takes CUDA tensors, x is on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x has dtype {x.dtype}, the kernel takes float32 or bfloat16")
    _check("x", x, x.dtype, x.device, dim=4)
    _check("x_scale", x_scale, torch.float32, x.device)
    if x_scale.numel() != 1:
        raise ValueError("x_scale must hold one value")
    *lead, ic = x.shape
    icp = padded_channels(ic)
    xq = torch.empty((*lead, icp), dtype=torch.int8, device=x.device)
    pixels = xq.numel() // icp
    if pixels:
        lib = _lib()
        index = _device_index(x)
        err = lib.ssd_int8_quantize(x.data_ptr(), int(x.dtype == torch.bfloat16), x_scale.data_ptr(),
                                    xq.data_ptr(), pixels, ic, icp, index,
                                    torch._C._cuda_getCurrentRawStream(index))
        _cuda_build.check_launch(lib, err, "int8 quantize kernel launch")
    return xq


def pack_weights(w_q: torch.Tensor) -> torch.Tensor:
    """(OC, KH, KW, IC) int8 -> (OC, KH, KW, ICp), zero past IC (a no-op when IC % 64 == 0)."""
    ic = w_q.shape[3]
    icp = padded_channels(ic)
    return w_q.contiguous() if icp == ic else F.pad(w_q, (0, icp - ic)).contiguous()


def conv_cuda(xq: torch.Tensor, w_packed: torch.Tensor, ic: int, stride: Tuple[int, int],
              pads: Pads, out_dtype: torch.dtype = torch.int32,
              w_scale: Optional[torch.Tensor] = None, x_scale: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the conv kernel: xq (B, H, W, ICp) from `quantize_cuda`, w_packed
    from `pack_weights` -> (B, Ho, Wo, OC): the int32 accumulators (out_dtype int32) or
    the dequantized output in float32 or bf16 (then w_scale and x_scale are needed)."""
    if out_dtype not in OUT_MODES:
        raise TypeError(f"out_dtype {out_dtype}: the kernel writes int32, float32 or bfloat16")
    device = xq.device
    _check("xq", xq, torch.int8, device, dim=4)
    _check("w", w_packed, torch.int8, device, dim=4)
    batch, h, w, icp = xq.shape
    oc, kh, kw, w_icp = w_packed.shape
    if icp % K_CHUNK or w_icp != icp or not 0 < ic <= icp:
        raise ValueError(f"xq {tuple(xq.shape)} and w {tuple(w_packed.shape)} do not share a "
                         f"channel pitch that is a multiple of {K_CHUNK} holding IC={ic}")
    dequant = out_dtype != torch.int32
    if dequant:
        if w_scale is None or x_scale is None:
            raise ValueError("a dequantized output needs w_scale and x_scale")
        _check("w_scale", w_scale, torch.float32, device, dim=1)
        _check("x_scale", x_scale, torch.float32, device)
        if w_scale.shape[0] != oc:
            raise ValueError(f"w_scale has {w_scale.shape[0]} entries, OC is {oc}")
    if bias is not None:
        _check("bias", bias, torch.float32, device, dim=1)
        if bias.shape[0] != oc:
            raise ValueError(f"bias has {bias.shape[0]} entries, OC is {oc}")
    top, bottom, left, right = pads
    if min(pads) < 0 or min(stride) < 1:
        raise ValueError(f"pads {pads} and stride {stride} must be >= 0 and >= 1")
    ho = out_size(h, kh, stride[0], top, bottom)
    wo = out_size(w, kw, stride[1], left, right)
    if ho < 1 or wo < 1:
        raise ValueError(f"a {kh}x{kw} kernel does not fit {h}x{w} with pads {pads}")
    out = torch.empty((batch, ho, wo, oc), dtype=out_dtype, device=device)
    if out.numel() == 0:
        return out
    lib = _lib()
    index = _device_index(xq)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = lib.ssd_int8_conv(
        xq.data_ptr(), w_packed.data_ptr(), ptr(w_scale if dequant else None),
        ptr(x_scale if dequant else None), ptr(bias if dequant else None), out.data_ptr(),
        OUT_MODES[out_dtype], batch, h, w, icp, ho, wo, oc, kh, kw, stride[0], stride[1], top,
        left, index, torch._C._cuda_getCurrentRawStream(index))
    _cuda_build.check_launch(lib, err, "int8 conv kernel launch")
    return out


def int8_conv_cuda(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                   bias: Optional[torch.Tensor], x_scale: torch.Tensor,
                   stride: Tuple[int, int], pads: Pads) -> torch.Tensor:
    """The kernel pair on the card: quantize x (B, H, W, IC), then the int8 conv with
    w_q (OC, KH, KW, IC) dequantized into x's dtype -> (B, Ho, Wo, OC)."""
    if x.device.type != "cuda":
        raise ValueError(f"the int8 conv kernels take CUDA tensors, x is on {x.device}")
    if w_q.dim() != 4 or w_q.shape[3] != x.shape[-1]:
        raise ValueError(f"w_q {tuple(w_q.shape)} does not fit x {tuple(x.shape)} (OC, KH, KW, IC)")
    xq = quantize_cuda(x, x_scale)
    out = conv_cuda(xq, pack_weights(w_q), x.shape[-1], stride, pads, x.dtype,
                    w_scale=w_scale, x_scale=x_scale, bias=bias)
    int8_conv_cuda.launches += 1
    return out


int8_conv_cuda.launches = 0


# --- the operator ------------------------------------------------------------------------


@torch.library.custom_op("ssd_torch::int8_conv", mutates_args=(), device_types="cpu")
def int8_conv_op(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                 bias: Optional[torch.Tensor], x_scale: torch.Tensor, stride_h: int,
                 stride_w: int, pad_top: int, pad_bottom: int, pad_left: int,
                 pad_right: int) -> torch.Tensor:
    """The int8 conv (NHWC x, (OC, KH, KW, IC) int8 w_q): the plain version on the CPU."""
    return int8_conv_plain(x, w_q, w_scale, bias, x_scale, (stride_h, stride_w),
                           (pad_top, pad_bottom, pad_left, pad_right))


@int8_conv_op.register_kernel("cuda")
def _int8_conv_on_card(x, w_q, w_scale, bias, x_scale, stride_h, stride_w, pad_top,
                       pad_bottom, pad_left, pad_right):
    return int8_conv_cuda(x, w_q, w_scale, bias, x_scale, (stride_h, stride_w),
                          (pad_top, pad_bottom, pad_left, pad_right))


@int8_conv_op.register_fake
def _int8_conv_shape(x, w_q, w_scale, bias, x_scale, stride_h, stride_w, pad_top, pad_bottom,
                     pad_left, pad_right):
    batch, h, w, _ = x.shape
    oc, kh, kw, _ = w_q.shape
    return x.new_empty((batch, out_size(h, kh, stride_h, pad_top, pad_bottom),
                        out_size(w, kw, stride_w, pad_left, pad_right), oc))
