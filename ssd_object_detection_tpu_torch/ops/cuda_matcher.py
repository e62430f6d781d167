"""Wrapper of the hand-written CUDA greedy matcher (csrc/matcher.cu).

Counterpart of ssd_object_detection_tpu/ops/pallas_matcher.py::match_anchors_pallas:
same arguments and result, batched. For CUDA tensors `match_anchors_cuda` launches the
kernel or raises; for CPU tensors it runs the plain matcher (ops/plain_matcher.py),
which is also the yardstick the kernel is held to on the card. There is no other route.

The kernel runs one thread-block cluster per image and keeps its whole state (a key per
ground-truth row, the pick list, a bit per consumed column) in shared memory. `plan`
chooses the cluster size, the threads, the column slices and the shared-memory bytes;
it is plain Python, tested on the CPU, and handed to the C entry point as ints. A call
allocates the four outputs and nothing else, and takes the current stream's raw handle
(no Stream object is built on the launch path). ops/matcher_model.py is a plain PyTorch
model of the kernel's algorithm for the CPU tests.

The kernel is compiled at its first launch, never at import: ops/_cuda_build.py builds
csrc/matcher.cu for sm_90a (-O3 -fmad=false, no fast math) into a shared library with a
plain C entry point under `build/kernels/` at the checkout root, named by a hash of the
source and the flags, and ctypes loads it. `match_anchors_cuda.launches` counts kernel
launches (CPU calls do not count).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ssd_object_detection_tpu_torch.ops import _cuda_build
from ssd_object_detection_tpu_torch.ops.plain_matcher import MatchResult, match_anchors

SOURCE = _cuda_build.CSRC / "matcher.cu"
NVCC_FLAGS = _cuda_build.BASE_FLAGS + ("-fmad=false",)
# A CTA's shared memory on Hopper (232,448 bytes) less the kernel's static buffers.
SMEM_LIMIT = 232_448 - 1_024
COLS_PER_THREAD = 4  # columns a thread holds in registers (csrc/matcher.cu kColsPerThread)
CLUSTER_SIZES = (8, 4, 2, 1)  # 8 is the largest portable cluster
MIN_THREADS, MAX_THREADS = 128, 1024
# Threads of this kernel that one SM holds at once: 64 registers each (its launch bound)
# of the SM's 65,536. CTAs of fewer threads share an SM.
RESIDENT_THREADS = 1024


@dataclasses.dataclass(frozen=True)
class MatcherPlan:
    """One launch: `batch` clusters of `cluster` CTAs of `threads` threads. CTA `rank`
    of an image takes columns [rank * slice_cols, (rank + 1) * slice_cols), cut at D
    (`column_slices`); `smem_bytes` is each CTA's dynamic shared memory."""

    cluster: int
    threads: int
    slice_cols: int
    smem_bytes: int
    ctas: int


def column_slices(num_anchors: int, cluster: int) -> list[tuple[int, int]]:
    """[start, stop) of each rank's columns: ceil(D / cluster) each, cut at D, so the
    last may be ragged and, where D < cluster, some are empty."""
    width = -(-num_anchors // cluster)
    starts = [min(num_anchors, rank * width) for rank in range(cluster)]
    return [(start, min(num_anchors, start + width)) for start in starts]


def smem_bytes(max_gt: int, num_anchors: int, cluster: int) -> int:
    """Dynamic shared memory of one CTA: per ground truth a key, one inbox key per rank,
    a pick, five corner floats and three ints; a bit per column (as csrc/matcher.cu)."""
    return max_gt * (8 * (1 + cluster) + 8 + 5 * 4 + 2 * 4) + 4 * -(-num_anchors // 32)


def _threads(num_anchors: int, cluster: int) -> int:
    slice_cols = -(-num_anchors // cluster)
    warps = -(-slice_cols // (32 * COLS_PER_THREAD))
    return min(MAX_THREADS, max(MIN_THREADS, 32 * warps))


@functools.lru_cache(maxsize=256)
def plan(batch: int, max_gt: int, num_anchors: int, sm_count: int = 132) -> MatcherPlan:
    """The launch for a (batch, max_gt) x num_anchors problem on a card of `sm_count` SMs.

    A thread holds COLS_PER_THREAD columns of its slice, so a CTA's threads are the
    slice over that, rounded up to warps, within [128, 1024]; a longer slice is walked
    in chunks. The cluster is the largest whose CTAs the card holds all at once
    (batch * cluster <= SMs * CTAs of that size per SM) and whose keys fit shared
    memory: an image's work then lies on as many SMs as can be, a second wave of CTAs
    never waits for the first, and small CTAs of several images share an SM, which evens
    out images of few and many ground truths. At SSD300's 8,732 anchors on 132 SMs:
    8 CTAs of 288 threads per image up to batch 49, then 2 up to 66, then 1. The count
    is an estimate: a cluster lies within one GPC, so an H100 holds 45 such clusters
    where this rule counts 49 (`max_active_clusters` asks the card), and the last few
    images of a batch of 46 to 49 start when the first have ended.
    """
    def fits(cluster):
        resident = sm_count * (RESIDENT_THREADS // _threads(num_anchors, cluster))
        return (batch * cluster <= resident
                and smem_bytes(max_gt, num_anchors, cluster) <= SMEM_LIMIT)

    cluster = next((c for c in CLUSTER_SIZES if fits(c)), 1)
    return MatcherPlan(cluster=cluster, threads=_threads(num_anchors, cluster),
                       slice_cols=-(-num_anchors // cluster),
                       smem_bytes=smem_bytes(max_gt, num_anchors, cluster), ctas=batch * cluster)


def build():
    """Compile csrc/matcher.cu unless the library for this source already exists."""
    return _cuda_build.build(SOURCE, NVCC_FLAGS)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ssd_match_anchors": ([_P, _P, _P, _P, _I, _I, _I, ctypes.c_float,
                           _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "ssd_match_empty_launch": ([_I, _I, _I, _I, _P], _I),
    "ssd_match_max_active_clusters": ([_I, _I, _I, _I], _I),
}


def _library() -> ctypes.CDLL:
    return _cuda_build.load(SOURCE, NVCC_FLAGS, _SIGNATURES)


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def empty_launch(launch: MatcherPlan, device: torch.device) -> None:
    """Launch an empty kernel with `launch`'s grid, cluster and block shape on the
    current stream: what a launch of that shape costs before any work."""
    lib = _library()
    err = lib.ssd_match_empty_launch(launch.ctas, launch.cluster, launch.threads,
                                     _device_index(device),
                                     torch.cuda.current_stream(device).cuda_stream)
    _cuda_build.check_launch(lib, err, "empty cluster launch")


def max_active_clusters(launch: MatcherPlan, device: torch.device) -> int:
    """How many of `launch`'s clusters the card holds at once (0: not schedulable)."""
    lib = _library()
    n = lib.ssd_match_max_active_clusters(launch.cluster, launch.threads, launch.smem_bytes,
                                          _device_index(device))
    if n < 0:
        _cuda_build.check_launch(lib, -n, "cudaOccupancyMaxActiveClusters")
    return n


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
    if num_anchors >= 2**31 - 1:
        raise ValueError(f"D = {num_anchors} does not fit the 31-bit column of the kernel's keys")

    index = _device_index(device)
    launch = plan(batch, max_gt, num_anchors, _sm_count(index))
    if launch.smem_bytes > SMEM_LIMIT:
        raise ValueError(
            f"G={max_gt}, D={num_anchors} needs {launch.smem_bytes} bytes of shared memory per "
            f"CTA; the kernel has {SMEM_LIMIT}"
        )

    # the outputs are all a call allocates: the kernel keeps its state in shared memory
    gt_index = torch.empty((batch, num_anchors), dtype=torch.int32, device=device)
    cls = torch.empty((batch, num_anchors), dtype=torch.int32, device=device)
    box = torch.empty((batch, num_anchors, 4), dtype=torch.float32, device=device)
    mask = torch.empty((batch, num_anchors), dtype=torch.bool, device=device)
    if batch == 0:
        return MatchResult(cls=cls, box=box, mask=mask, gt_index=gt_index)

    # the library links its own CUDA runtime, so it is told the device explicitly
    lib = _library()
    err = lib.ssd_match_anchors(
        gt_boxes.data_ptr(), gt_cls.data_ptr(), gt_valid.data_ptr(), anchors.data_ptr(),
        batch, max_gt, num_anchors, float(thresh),
        gt_index.data_ptr(), cls.data_ptr(), box.data_ptr(), mask.data_ptr(),
        launch.cluster, launch.threads, launch.slice_cols, launch.smem_bytes,
        index, torch._C._cuda_getCurrentRawStream(index),  # no Stream object on the launch path
    )
    _cuda_build.check_launch(lib, err, "matcher kernel launch")
    match_anchors_cuda.launches += 1
    return MatchResult(cls=cls, box=box, mask=mask, gt_index=gt_index)


match_anchors_cuda.launches = 0
