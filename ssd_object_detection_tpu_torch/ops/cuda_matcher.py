"""Wrapper of the hand-written CUDA greedy matcher (csrc/matcher.cu).

Counterpart of ssd_object_detection_tpu/ops/pallas_matcher.py::match_anchors_pallas:
same arguments and result, batched. For CUDA tensors `match_anchors_cuda` launches the
kernel or raises; for CPU tensors it runs the plain matcher (ops/plain_matcher.py),
which is also the yardstick the kernel is held to on the card. There is no other route.

The kernel is compiled at its first launch, never at import: ops/_cuda_build.py builds
csrc/matcher.cu for sm_90a (-O3 -fmad=false, no fast math) into a shared library with a
plain C entry point under `build/kernels/` at the checkout root, named by a hash of the
source and the flags, and ctypes loads it. `match_anchors_cuda.launches` counts kernel
launches (CPU calls do not count).
"""

from __future__ import annotations

import ctypes

import torch

from ssd_object_detection_tpu_torch.ops import _cuda_build
from ssd_object_detection_tpu_torch.ops.plain_matcher import MatchResult, match_anchors

SOURCE = _cuda_build.CSRC / "matcher.cu"
NVCC_FLAGS = _cuda_build.BASE_FLAGS + ("-fmad=false",)
# A CTA's shared memory on Hopper (232,448 bytes) less the kernel's static buffers.
_MAX_DYNAMIC_SMEM = 232_448 - 1_024


def build():
    """Compile csrc/matcher.cu unless the library for this source already exists."""
    return _cuda_build.build(SOURCE, NVCC_FLAGS)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ssd_match_anchors": ([_P, _P, _P, _P, _I, _I, _I, ctypes.c_float,
                           _P, _P, _P, _P, _P, _P, _P, _I, _P], _I),
    "ssd_match_anchors_smem_bytes": ([_I, _I], ctypes.c_size_t),
}


def _library() -> ctypes.CDLL:
    return _cuda_build.load(SOURCE, NVCC_FLAGS, _SIGNATURES)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device: torch.device,
           align: int = 1) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def match_anchors_cuda(
    gt_cls: torch.Tensor,  # (B, G) int32
    gt_boxes: torch.Tensor,  # (B, G, 4) float32 cxcywh
    gt_valid: torch.Tensor,  # (B, G) bool
    anchors: torch.Tensor,  # (D, 4) float32 cxcywh
    thresh: float = 0.5,
) -> MatchResult:
    """Batched greedy matching: the CUDA kernel for CUDA tensors, the plain matcher
    for CPU tensors. Inputs must be finite."""
    if gt_boxes.device.type == "cpu":
        return match_anchors(gt_cls, gt_boxes, gt_valid, anchors, thresh)
    if gt_boxes.device.type != "cuda":
        raise ValueError(f"no matcher for device {gt_boxes.device}")
    device = gt_boxes.device
    if gt_boxes.dim() != 3 or anchors.dim() != 2:
        raise ValueError("expected gt_boxes (B, G, 4) and anchors (D, 4)")
    batch, max_gt = gt_boxes.shape[:2]
    num_anchors = anchors.shape[0]
    _check("gt_cls", gt_cls, torch.int32, (batch, max_gt), device)
    _check("gt_boxes", gt_boxes, torch.float32, (batch, max_gt, 4), device, align=16)
    _check("gt_valid", gt_valid, torch.bool, (batch, max_gt), device)
    _check("anchors", anchors, torch.float32, (num_anchors, 4), device, align=16)
    if max_gt < 1 or num_anchors < 1:
        raise ValueError(f"the kernel needs G >= 1 and D >= 1, got G={max_gt}, D={num_anchors}")
    if max_gt * num_anchors >= 2**31:
        raise ValueError(f"G*D = {max_gt * num_anchors} overflows the kernel's int32 flat index")

    lib = _library()
    smem = lib.ssd_match_anchors_smem_bytes(max_gt, num_anchors)
    if smem > _MAX_DYNAMIC_SMEM:
        raise ValueError(
            f"G={max_gt}, D={num_anchors} needs {smem} bytes of shared memory per CTA; "
            f"the kernel has {_MAX_DYNAMIC_SMEM}"
        )

    iou = torch.empty((batch, max_gt, num_anchors), dtype=torch.float32, device=device)
    cache_v = torch.empty((batch, num_anchors), dtype=torch.float32, device=device)
    cache_r = torch.empty((batch, num_anchors), dtype=torch.int32, device=device)
    gt_index = torch.empty((batch, num_anchors), dtype=torch.int32, device=device)
    cls = torch.empty((batch, num_anchors), dtype=torch.int32, device=device)
    box = torch.empty((batch, num_anchors, 4), dtype=torch.float32, device=device)
    mask = torch.empty((batch, num_anchors), dtype=torch.bool, device=device)
    if batch == 0:
        return MatchResult(cls=cls, box=box, mask=mask, gt_index=gt_index)

    # the library links its own CUDA runtime, so it is told the device explicitly
    err = lib.ssd_match_anchors(
        gt_boxes.data_ptr(), gt_cls.data_ptr(), gt_valid.data_ptr(), anchors.data_ptr(),
        batch, max_gt, num_anchors, float(thresh),
        iou.data_ptr(), cache_v.data_ptr(), cache_r.data_ptr(),
        gt_index.data_ptr(), cls.data_ptr(), box.data_ptr(), mask.data_ptr(),
        device.index if device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _cuda_build.check_launch(lib, err, "matcher kernel launch")
    match_anchors_cuda.launches += 1
    return MatchResult(cls=cls, box=box, mask=mask, gt_index=gt_index)


match_anchors_cuda.launches = 0
