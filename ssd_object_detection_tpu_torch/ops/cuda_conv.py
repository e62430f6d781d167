"""Wrapper of the hand-written CUDA fused conv3x3 + bias + ReLU + pool (csrc/conv3x3.cu).

Counterpart of the forward of ssd_object_detection_tpu/ops/pallas_conv.py::_conv3x3_pallas.
`conv3x3_forward_cuda` takes CUDA tensors only: it checks them, allocates the output,
launches the kernel on PyTorch's current stream and raises on a nonzero CUDA error.
ops/conv3x3.py picks it for CUDA tensors and the plain version for CPU tensors.

bf16 goes to the wgmma kernel, float32 to the FMA kernel (the source's note says why).
For bf16 the wrapper plans the tiles (`plan_conv`), lays the weights out in the wgmma
operand order (`pack_weights`), pads x's channels with zeros to a multiple of 8 when IC is
not one (the tensor map needs 16-byte strides), and copies x when its data pointer is
not 16-byte aligned (the tensor map needs an aligned base). These are plain Python and
PyTorch, tested on the CPU.

The kernel is compiled at its first launch, never at import (ops/_cuda_build.py: nvcc
for sm_90a into `build/kernels/`, loaded with ctypes). `conv3x3_forward_cuda.launches`
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from ssd_object_detection_tpu_torch.ops import _cuda_build

SOURCE = _cuda_build.CSRC / "conv3x3.cu"
NVCC_FLAGS = _cuda_build.BASE_FLAGS

TILE_M = 256  # pixels per tile, the N of one wgmma (csrc/conv3x3.cu kTileM)
CHUNK = 16  # input channels per ring stage (kChunk)
N_BLOCK = 64  # output channels per tile, the M of one wgmma (kNBlock)
SMEM_LIMIT = 232_448  # dynamic shared memory a block can have on Hopper
MAX_STAGES = 6

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ssd_conv3x3_f32": ([_P, _P, _P, _P] + [_I] * 8 + [_P], _I),
    "ssd_conv3x3_bf16": ([_P, _P, _P, _P] + [_I] * 14 + [_P], _I),
    "ssd_conv3x3_encode_us": ([_P] + [_I] * 7, ctypes.c_double),
}


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """Tiles of the bf16 kernel. A tile is `rows` output rows x `pitch - 2` columns of
    one image for N_BLOCK output channels; its halo is (rows + 2) x pitch pixels, held
    in `halo_pixels` per 8-channel group (the box plus zeroed slack that the junk
    pixels of the last taps read) and, per stage, one 16-channel chunk's weights;
    `stages` ring stages fit beside the two consumer warpgroups' staging tiles in
    `smem_bytes`."""

    pitch: int
    rows: int
    halo_pixels: int
    stages: int
    smem_bytes: int

    @property
    def cols(self) -> int:
        return self.pitch - 2

    def grid(self, h: int, w: int) -> tuple[int, int]:
        """(tiles_h, tiles_w) of one image, as the kernel computes them."""
        return -(-h // self.rows), -(-w // self.cols)


def _halo_pixels(pitch: int, rows: int) -> int:
    # tile pixel m < TILE_M reads halo pixel m + 2 * pitch + 2 at the last tap
    need = max((rows + 2) * pitch, TILE_M + 2 * pitch + 2)
    return -(-need // 8) * 8


@functools.lru_cache(maxsize=256)
def plan_conv(h: int, w: int, pool: bool) -> ConvPlan:
    """The bf16 kernel's tiles for an (h, w) image (any channel counts).

    With the pool, pitch 32 and 8 rows: windows align (even origins and extents).
    Without it, the pitch is the full row (w + 2) when that gives fewer tiles than
    pitch 32 (block3's 75-wide rows: 25 tiles of 3 rows against 30 of 8 x 30), else 32.
    The ring is as deep as shared memory allows, up to MAX_STAGES.
    """
    options = [(32, 8)]
    if not pool and w + 2 <= TILE_M:
        options.insert(0, (w + 2, TILE_M // (w + 2)))

    def tiles(option):
        pitch, rows = option
        return -(-h // rows) * -(-w // (pitch - 2))

    pitch, rows = min(options, key=tiles)
    halo = _halo_pixels(pitch, rows)
    staging = 2 * TILE_M * (N_BLOCK + 8) * 2  # one tile per consumer warpgroup
    stage = 2 * halo * 16 + 9 * CHUNK * N_BLOCK * 2  # two 8-channel halo groups, the weights
    stages = min(MAX_STAGES, (SMEM_LIMIT - 1024 - staging) // stage)  # 1 KB: barriers
    if stages < 2:
        raise ValueError(f"no two ring stages fit for a {h}x{w} image (pitch {pitch})")
    smem = staging + stages * stage + (2 * stages + 2) * 8
    return ConvPlan(pitch=pitch, rows=rows, halo_pixels=halo, stages=stages, smem_bytes=smem)


def pack_weights(kernel: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """HWIO (3, 3, IC, OC) -> the wgmma operand order (NB, KC, 9, 8, 2, 8, 8), in `dtype`
    (default the kernel's; the cast rounds as `Tensor.to` does).

    Element [nb, kc, tap, ng, kg, n, k] is kernel[tap // 3, tap % 3, 16 kc + 8 kg + k,
    64 nb + 8 ng + n]: per 64-channel N-block and 16-channel chunk, 9 taps of a K-major
    16 x 64 block of 8x8 core matrices (128 bytes each, K-adjacent ones 128 bytes apart,
    N-adjacent ones 256). Zero where the input channel is >= IC (up to KC = ceil(IC/16)
    chunks) or the output channel is >= OC (up to NB = ceil(OC/64) blocks).
    """
    _, _, ic, oc = kernel.shape
    bn = N_BLOCK
    kc, nb = -(-ic // CHUNK), -(-oc // bn)
    if ic % CHUNK or oc % bn:
        kernel = F.pad(kernel, (0, nb * bn - oc, 0, kc * CHUNK - ic))
    packed = torch.empty((nb, kc, 9, bn // 8, 2, 8, 8), dtype=dtype or kernel.dtype,
                         device=kernel.device)
    # one copy (and cast) through the packed tensor's view in the kernel's dim order
    packed.permute(2, 1, 4, 6, 0, 3, 5).copy_(kernel.reshape(9, kc, 2, 8, nb, bn // 8, 8))
    return packed


def build():
    """Compile csrc/conv3x3.cu unless the library for this source already exists."""
    return _cuda_build.build(SOURCE, NVCC_FLAGS)


def _lib():
    return _cuda_build.load(SOURCE, NVCC_FLAGS, _SIGNATURES)


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def tensor_map_encode_us(x: torch.Tensor, plan: ConvPlan, iters: int = 1000) -> float:
    """Host microseconds of one tensor-map encode for bf16 x (B, H, W, IC), IC % 8 == 0."""
    batch, h, w, ic = x.shape
    return _lib().ssd_conv3x3_encode_us(x.data_ptr(), batch, h, w, ic, plan.pitch, plan.rows,
                                        iters)


def conv3x3_forward_cuda(
    x: torch.Tensor,  # (B, H, W, IC) float32 or bfloat16, contiguous, on the card
    kernel: torch.Tensor,  # (3, 3, IC, OC), cast to x.dtype here
    bias: torch.Tensor,  # (OC,), cast to float32 here
    relu: bool = True,
    pool: bool = False,
) -> torch.Tensor:
    """One launch of the fused kernel -> (B, H, W, OC), or (B, H/2, W/2, OC) with pool.

    bf16 x with IC % 8 != 0 is zero-padded to a multiple of 8 channels, and bf16 x whose
    data pointer is not 16-byte aligned is copied, never refused: the tensor map needs
    16-byte strides and an aligned base."""
    if x.device.type != "cuda":
        raise ValueError(f"the conv kernel takes CUDA tensors, x is on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
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
    bias = bias.to(torch.float32).contiguous()
    out = torch.empty((batch, h // 2, w // 2, oc) if pool else (batch, h, w, oc),
                      dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    device = x.device.index if x.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.float32:
        kernel = kernel.float().contiguous()
        err = lib.ssd_conv3x3_f32(x.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
                                  out.data_ptr(), batch, h, w, ic, oc, int(relu), int(pool),
                                  device, stream)
    else:
        if ic % 8:
            x = F.pad(x, (0, 8 - ic % 8))  # zero channels: 16-byte tensor-map strides
        elif x.data_ptr() % 16:
            x = x.clone()  # the tensor map needs a 16-byte aligned base
        plan = plan_conv(h, w, pool)
        packed = pack_weights(kernel, x.dtype)
        err = lib.ssd_conv3x3_bf16(
            x.data_ptr(), packed.data_ptr(), bias.data_ptr(), out.data_ptr(), batch, h, w,
            x.shape[3], oc, int(relu), int(pool), plan.pitch, plan.rows,
            plan.halo_pixels, plan.stages, plan.smem_bytes,
            _sm_count(device), device, stream,
        )
    _cuda_build.check_launch(lib, err, "conv3x3 kernel launch")
    conv3x3_forward_cuda.launches += 1
    return out


conv3x3_forward_cuda.launches = 0
