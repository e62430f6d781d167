"""Wrapper of the hand-written CUDA fused conv3x3 + bias + ReLU + pool (csrc/conv3x3.cu).

Counterpart of the forward of ssd_object_detection_tpu/ops/pallas_conv.py::_conv3x3_pallas.
`conv3x3_forward_cuda` takes CUDA tensors only: it checks them, allocates the output,
launches the kernel on PyTorch's current stream and raises on a nonzero CUDA error.
ops/conv3x3.py picks it for CUDA tensors and the plain version for CPU tensors.

The kernel is compiled at its first launch, never at import (ops/_cuda_build.py: nvcc
for sm_90a into `build/kernels/`, loaded with ctypes). `conv3x3_forward_cuda.launches`
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ssd_object_detection_tpu_torch.ops import _cuda_build

SOURCE = _cuda_build.CSRC / "conv3x3.cu"
NVCC_FLAGS = _cuda_build.BASE_FLAGS
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ssd_conv3x3_forward": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
}


def build():
    """Compile csrc/conv3x3.cu unless the library for this source already exists."""
    return _cuda_build.build(SOURCE, NVCC_FLAGS)


def conv3x3_forward_cuda(
    x: torch.Tensor,  # (B, H, W, IC) float32 or bfloat16, contiguous, on the card
    kernel: torch.Tensor,  # (3, 3, IC, OC), cast to x.dtype here
    bias: torch.Tensor,  # (OC,), cast to float32 here
    relu: bool = True,
    pool: bool = False,
) -> torch.Tensor:
    """One launch of the fused kernel -> (B, H, W, OC), or (B, H/2, W/2, OC) with pool."""
    if x.device.type != "cuda":
        raise ValueError(f"the conv kernel takes CUDA tensors, x is on {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x has dtype {x.dtype}, the kernel takes float32 or bfloat16")
    if x.dim() != 4 or kernel.dim() != 4 or tuple(kernel.shape[:2]) != (3, 3):
        raise ValueError(f"expected x (B, H, W, IC) and kernel (3, 3, IC, OC), got "
                         f"{tuple(x.shape)} and {tuple(kernel.shape)}")
    batch, h, w, ic = x.shape
    oc = kernel.shape[3]
    if kernel.shape[2] != ic or tuple(bias.shape) != (oc,):
        raise ValueError(f"kernel {tuple(kernel.shape)} / bias {tuple(bias.shape)} do not fit "
                         f"x with {ic} channels")
    if kernel.device != x.device or bias.device != x.device:
        raise ValueError(f"kernel ({kernel.device}) and bias ({bias.device}) must be on {x.device}")
    if pool and (h % 2 or w % 2):
        raise ValueError(f"2x2/s2 pool needs even H and W, got {h}x{w}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NHWC)")
    kernel = kernel.to(x.dtype).contiguous()
    bias = bias.to(torch.float32).contiguous()
    out = torch.empty((batch, h // 2, w // 2, oc) if pool else (batch, h, w, oc),
                      dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _cuda_build.load(SOURCE, NVCC_FLAGS, _SIGNATURES)
    device = x.device.index if x.device.index is not None else torch.cuda.current_device()
    err = lib.ssd_conv3x3_forward(
        x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), out.data_ptr(),
        batch, h, w, ic, oc, int(relu), int(pool), DTYPES[x.dtype], device,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _cuda_build.check_launch(lib, err, "conv3x3 kernel launch")
    conv3x3_forward_cuda.launches += 1
    return out


conv3x3_forward_cuda.launches = 0
