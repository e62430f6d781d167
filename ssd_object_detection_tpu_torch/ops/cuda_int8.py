"""The int8 conv of post-training quantization: CUDA kernels (csrc/int8_conv.cu), their
plain PyTorch versions, the kernels' tile planner, and the `ssd_torch::int8_conv`
operator over both.

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

Which kernel runs is decided by shape and type alone, in `plan_int8`:
  - the quantize kernel reads x with 16-byte loads when IC % 32 == 0 (every SSD conv),
    else one 16-channel group a thread with scalar loads;
  - the conv kernel is one wgmma kernel in two modes. Stride-1 3x3 and 1x1 convs load
    one halo per chunk of input channels (32 for a 3x3, 128 for a 1x1) and reach every
    tap by moving the operand's start address ("halo" mode; a 1x1 stride-1 unpadded
    conv runs on its pixels flattened into one row). Every other conv (stride 2, or
    another kernel size) loads one box per tap and chunk of 128 channels with the
    tensor map's element strides set to the conv's stride ("tap" mode).
Both modes accumulate the same exact int32 sums; there is no other kernel and no
fallback. `ops/int8_conv_model.py` replays the plan's address arithmetic on the CPU.

The weights go to the kernel in the order of its ring stages, swizzled as shared memory
holds them (`pack_weights`), so a stage's weights are one bulk copy. The packing runs
once per weight tensor and row width and is kept on the tensor (`kernel_weights`): no
weight re-layout runs per call. The PTQ bundle keeps the operator's own (OC, KH, KW,
IC) weights.

The plain version quantizes with torch ops (a true division by the scale tensor,
round half to even, clip), convolves the int8 values in float64 (every partial sum is
an integer below 2^53, so the result is exact in any order) and dequantizes as separate
float32 ops: the kernels are held bit-equal to it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ssd_object_detection_tpu_torch.ops import _cuda_build

SOURCE = _cuda_build.CSRC / "int8_conv.cu"
NVCC_FLAGS = _cuda_build.BASE_FLAGS + ("-fmad=false",)
TILE_M = 256  # GEMM columns (output pixels) per tile: the N of one wgmma (kTileM)
N_BLOCK = 64  # output channels per tile: the M of one wgmma (kNBlock)
CHUNK = 32  # input channels of one wgmma's K (kChunk)
ALIGN = 1024  # the ring starts on this boundary, the swizzle's phase 0 (kAlign)
ROWS = (128, 64, 32)  # bytes of a pixel's or a weight's row in a stage, widest first
# (taps a stage, row bytes) the kernel is compiled for (csrc/int8_conv.cu launch_shape)
STAGE_SHAPES = ((9, 32), (1, 32), (1, 64), (1, 128))
MIN_STAGES = 3
SMEM_LIMIT = 232_448  # dynamic shared memory a block can have on Hopper
MAX_STAGES = 8
MAX_BOX = 256  # the largest TMA box extent in any dimension
MAX_TAPS = 9  # taps a ring stage may hold (kMaxTaps)
OUT_MODES = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
OUT_BYTES = {torch.int32: 4, torch.float32: 4, torch.bfloat16: 2}

Pads = Tuple[int, int, int, int]  # (top, bottom, left, right)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "ssd_int8_quantize": ([_P, _I, _P, _P, _L, _I, _I, _I, _P], _I),
    "ssd_int8_conv": ([_P] * 6 + [_I, ctypes.POINTER(_I), _I, _I, _P], _I),
}
# The integers of the kernel's launch, named and ordered as csrc/int8_conv.cu's struct
# Plan; "shift" is MAX_TAPS entries.
KERNEL_FIELDS = ("B", "H", "W", "ICp", "Ho", "Wo", "OC", "KW", "SH", "SW", "PT", "PL", "row",
                 "P", "R", "cols", "box_rows", "taps", "taps_per_stage", "k_taps", "chunks",
                 "tiles_w", "tiles_h", "n_blocks", "num_tiles", "k_steps", "halo_pixels",
                 "box_pixels", "stages", "smem", "grid", "shift")


def build():
    """Compile csrc/int8_conv.cu unless the library for this source already exists."""
    return _cuda_build.build(SOURCE, NVCC_FLAGS)


def _lib():
    return _cuda_build.load(SOURCE, NVCC_FLAGS, _SIGNATURES)


def padded_channels(ic: int) -> int:
    """The channel pitch of the kernels' int8 buffers: IC rounded up to CHUNK."""
    return -(-ic // CHUNK) * CHUNK


def out_size(size: int, kernel: int, stride: int, before: int, after: int) -> int:
    return (size + before + after - kernel) // stride + 1


def out_shape(h: int, w: int, kernel: Tuple[int, int], stride: Tuple[int, int],
              pads: Pads) -> Tuple[int, int]:
    """(Ho, Wo) of a conv of an h x w image."""
    return (out_size(h, kernel[0], stride[0], pads[0], pads[1]),
            out_size(w, kernel[1], stride[1], pads[2], pads[3]))


# --- the tile plan ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Int8Plan:
    """The conv kernel's launch, computed from shapes alone.

    The kernel sees xq as `view` (B, H, W) and writes the output as `out_view`
    (B, Ho, Wo): the tensors' own shapes, or for a 1x1 stride-1 unpadded conv all
    pixels in one row (1, 1, B*H*W). A tile is `rows` output rows x `cols` output
    columns of one image for N_BLOCK output channels; GEMM column m of its TILE_M is
    output pixel (m // pitch, m % pitch), and columns past `cols` or rows past `rows`
    are computed and dropped.

    A ring stage holds `row` input channels (`chunks` stages of K per tap step): the x
    box of `box_rows` x `pitch` pixels, each a swizzled row of `row` bytes, in a
    buffer of `halo_pixels` rows whose slack is zero, then the weights of
    `taps_per_stage` taps x N_BLOCK output channels x `row` bytes. Each tap takes
    row / CHUNK products of K = 32.

    halo mode (taps_per_stage = KH*KW, stride 1): one box per chunk; tap (kh, kw) reads
    pixel m + kh*pitch + kw of it. tap mode (taps_per_stage = 1): one box per chunk and
    tap, whose TMA element strides are the conv's strides.
    """

    view: Tuple[int, int, int]
    out_view: Tuple[int, int, int]
    kernel: Tuple[int, int]
    stride: Tuple[int, int]
    pads: Pads
    oc: int
    icp: int  # xq's channels, padded_channels(IC)
    row: int
    chunks: int
    pitch: int
    rows: int
    cols: int
    box_rows: int
    taps_per_stage: int
    halo_pixels: int
    stages: int
    smem_bytes: int
    staging_pitch: int  # output elements per staged pixel row (N_BLOCK + 16 bytes)
    out_bytes: int

    @property
    def taps(self) -> int:
        return self.kernel[0] * self.kernel[1]

    @property
    def k_taps(self) -> int:
        """Ring stages per chunk: 1 in halo mode, the taps in tap mode."""
        return self.taps // self.taps_per_stage

    @property
    def k_steps(self) -> int:
        """Ring stages per tile."""
        return self.chunks * self.k_taps

    @property
    def shifts(self) -> Tuple[int, ...]:
        """Halo rows the stage's tap s reads ahead of GEMM column m: (s // KW) * P + s % KW."""
        kw = self.kernel[1]
        return tuple((s // kw) * self.pitch + s % kw for s in range(self.taps_per_stage))

    @property
    def tiles_h(self) -> int:
        return -(-self.out_view[1] // self.rows)

    @property
    def tiles_w(self) -> int:
        return -(-self.out_view[2] // self.cols)

    @property
    def n_blocks(self) -> int:
        return -(-self.oc // N_BLOCK)

    @property
    def num_tiles(self) -> int:
        return self.out_view[0] * self.tiles_h * self.tiles_w * self.n_blocks

    @property
    def box_extent(self) -> Tuple[int, int]:
        """The x box's extent (W, H) in elements of xq (TMA boxDim[1:3]); its element
        strides are the conv's, so it lands as box_rows x pitch pixels."""
        return self.pitch * self.stride[1], self.box_rows * self.stride[0]

    def grid(self, sm_count: int) -> int:
        """Persistent CTAs: one per SM, or one per tile when there are fewer tiles."""
        return min(self.num_tiles, sm_count)

    def kernel_fields(self, sm_count: int) -> dict:
        """What the kernel's launch receives, by KERNEL_FIELDS name: the C host copies
        these and works out nothing of its own."""
        (b, h, w), (_, ho, wo) = self.view, self.out_view
        (sh, sw), (top, _, left, _) = self.stride, self.pads
        fields = dict(
            B=b, H=h, W=w, ICp=self.icp, Ho=ho, Wo=wo, OC=self.oc, KW=self.kernel[1], SH=sh,
            SW=sw, PT=top, PL=left, row=self.row, P=self.pitch, R=self.rows, cols=self.cols,
            box_rows=self.box_rows, taps=self.taps, taps_per_stage=self.taps_per_stage,
            k_taps=self.k_taps, chunks=self.chunks, tiles_w=self.tiles_w, tiles_h=self.tiles_h,
            n_blocks=self.n_blocks, num_tiles=self.num_tiles, k_steps=self.k_steps,
            halo_pixels=self.halo_pixels, box_pixels=self.box_rows * self.pitch,
            stages=self.stages, smem=self.smem_bytes, grid=self.grid(sm_count),
            shift=self.shifts + (0,) * (MAX_TAPS - len(self.shifts)))
        return fields

    def kernel_ints(self, sm_count: int) -> Tuple[int, ...]:
        """kernel_fields flattened in struct Plan's order."""
        fields = self.kernel_fields(sm_count)
        return (*(fields[name] for name in KERNEL_FIELDS[:-1]), *fields["shift"])


def _staging_bytes(out_bytes: int) -> Tuple[int, int]:
    """(pitch in elements, bytes) of the two consumer warpgroups' staging tiles."""
    pitch = N_BLOCK + 16 // out_bytes
    return pitch, 2 * TILE_M * pitch * out_bytes


def _fit(stage: int, staging: int) -> Tuple[int, int]:
    # ALIGN: the slack to start the ring on a swizzle boundary; 1 KB more: barriers
    stages = min(MAX_STAGES, (SMEM_LIMIT - ALIGN - 1024 - staging) // stage)
    return stages, ALIGN + staging + stages * stage + (2 * stages + 2) * 8


@functools.lru_cache(maxsize=512)
def plan_int8(batch: int, h: int, w: int, ic: int, oc: int, kernel: Tuple[int, int],
              stride: Tuple[int, int], pads: Pads, out_bytes: int) -> Int8Plan:
    """The conv kernel's tiles and ring for xq (batch, h, w, padded_channels(ic)), weights
    (oc, *kernel, ic) and an output of `out_bytes` per element (4: int32 or float32,
    2: bf16).

    The pitch minimises the tile count (then the halo's bytes): in halo mode over
    pitch in [KW, min(256, Wo + KW - 1)] with rows = min(256 // pitch, Ho); in tap mode
    over pitch in [1, min(256 // SW, Wo)] with rows = min(256 // pitch, Ho, 256 // SH).
    The row is the widest of 128, 64 and 32 bytes (fewer TMA rows per product) among the
    STAGE_SHAPES the kernel is compiled for that leaves MIN_STAGES ring stages beside
    the staging tiles; halo mode needs stride 1, a compiled shape and at least two
    stages, else tap mode. The ring is as deep as shared memory allows, up to MAX_STAGES.
    """
    kh, kw = kernel
    sh, sw = stride
    top, bottom, left, right = pads
    ho, wo = out_shape(h, w, kernel, stride, pads)
    if ho < 1 or wo < 1:
        raise ValueError(f"a {kh}x{kw} kernel does not fit {h}x{w} with pads {pads}")
    if kh * kw > MAX_BOX:
        raise ValueError(f"a {kh}x{kw} kernel has more than {MAX_BOX} taps")
    view, out_view = (batch, h, w), (batch, ho, wo)
    if (kh, kw) == (1, 1) and stride == (1, 1) and pads == (0, 0, 0, 0):
        view = out_view = (1, 1, batch * h * w)
    ho, wo = out_view[1], out_view[2]
    icp = padded_channels(ic)
    staging_pitch, staging = _staging_bytes(out_bytes)

    def tiles(rows: int, cols: int) -> int:
        return -(-ho // rows) * -(-wo // cols)

    def with_ring(pitch, rows, cols, box_rows, taps, need, least):
        """The plan of the widest row with `least` stages, or None."""
        for row in ROWS:
            if (row > icp and row != CHUNK) or (taps, row) not in STAGE_SHAPES:
                continue
            halo = -(-need // (ALIGN // row)) * (ALIGN // row)  # regions stay aligned
            stages, smem = _fit(row * halo + taps * N_BLOCK * row, staging)
            if stages >= least:
                return Int8Plan(view=view, out_view=out_view, kernel=kernel, stride=stride,
                                pads=pads, oc=oc, icp=icp, row=row, chunks=-(-icp // row),
                                pitch=pitch,
                                rows=rows, cols=cols, box_rows=box_rows, taps_per_stage=taps,
                                halo_pixels=halo, stages=stages, smem_bytes=smem,
                                staging_pitch=staging_pitch, out_bytes=out_bytes)
        return None

    if stride == (1, 1):
        best = None
        for pitch in range(kw, min(TILE_M, wo + kw - 1) + 1):
            rows = min(TILE_M // pitch, ho, MAX_BOX - kh + 1)
            need = TILE_M + (kh - 1) * pitch + kw - 1  # the last tap's reach
            key = (tiles(rows, pitch - kw + 1), need)
            if best is None or key < best[0]:
                best = (key, pitch, rows, need)
        _, pitch, rows, need = best
        args = (pitch, rows, pitch - kw + 1, rows + kh - 1, kh * kw, need)
        plan = with_ring(*args, MIN_STAGES) or with_ring(*args, 2)
        if plan is not None:
            return plan
    best = None
    for pitch in range(1, min(MAX_BOX // sw, wo) + 1):
        rows = min(TILE_M // pitch, ho, MAX_BOX // sh)
        key = (tiles(rows, pitch), pitch)
        if best is None or key < best[0]:
            best = (key, pitch, rows)
    _, pitch, rows = best
    return with_ring(pitch, rows, pitch, rows, 1, TILE_M, MIN_STAGES)


def swizzle_units(rows: torch.Tensor, row: int) -> torch.Tensor:
    """The 16-byte unit that logical unit 0 of a `row`-byte row lands on, XORed with the
    logical unit, for rows at offsets rows * row from a 1024-byte boundary: the
    shared-memory swizzle of that width (address bits [7, 7 + log2(row / 16)) into bits
    [4, ...)), which TMA writes and wgmma reads."""
    return ((rows * row) >> 7) & (row // 16 - 1)


def pack_weights(w_q: torch.Tensor, row: int) -> torch.Tensor:
    """(OC, KH, KW, IC) int8 -> (NB, chunks, KH*KW, N_BLOCK, row) int8: per 64-channel
    N-block, `row`-channel chunk and tap, the rows of its output channels as one stage
    of the ring holds them, zero past OC and IC, each row's 16-byte units swizzled
    (`swizzle_units`). A stage's weights are then one contiguous bulk copy."""
    oc, kh, kw, ic = w_q.shape
    nb, chunks = -(-oc // N_BLOCK), -(-padded_channels(ic) // row)
    w = F.pad(w_q.reshape(oc, kh * kw, ic), (0, chunks * row - ic, 0, 0, 0, nb * N_BLOCK - oc))
    w = w.reshape(nb, N_BLOCK, kh * kw, chunks, row // 16, 16).permute(0, 3, 2, 1, 4, 5)
    units = torch.arange(row // 16, device=w_q.device)
    dest = units[None, :] ^ swizzle_units(torch.arange(N_BLOCK, device=w_q.device), row)[:, None]
    packed = torch.empty_like(w)
    packed.scatter_(4, dest.view(1, 1, 1, N_BLOCK, row // 16, 1).expand_as(w), w)
    return packed.reshape(nb, chunks, kh * kw, N_BLOCK, row).contiguous()


def kernel_weights(w_q: torch.Tensor, row: int) -> torch.Tensor:
    """`pack_weights(w_q, row)`, made once and kept on the tensor until it changes in
    place: no weight re-layout runs per call."""
    key = (w_q._version, w_q.data_ptr())
    cache = getattr(w_q, "_ssd_int8_packed", None)
    if cache is None:
        cache = w_q._ssd_int8_packed = {}
    if row not in cache or cache[row][0] != key:
        cache[row] = (key, pack_weights(w_q, row))
    return cache[row][1]


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


def conv_cuda(xq: torch.Tensor, w_q: torch.Tensor, stride: Tuple[int, int], pads: Pads,
              out_dtype: torch.dtype = torch.int32, w_scale: Optional[torch.Tensor] = None,
              x_scale: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the conv kernel: xq (B, H, W, ICp) from `quantize_cuda`, w_q
    (OC, KH, KW, IC) int8 -> (B, Ho, Wo, OC): the int32 accumulators (out_dtype int32) or
    the dequantized output in float32 or bf16 (then w_scale and x_scale are needed)."""
    if out_dtype not in OUT_MODES:
        raise TypeError(f"out_dtype {out_dtype}: the kernel writes int32, float32 or bfloat16")
    device = xq.device
    _check("xq", xq, torch.int8, device, dim=4)
    if w_q.device != device or w_q.dtype != torch.int8 or w_q.dim() != 4:
        raise ValueError(f"w_q must be a 4-D int8 tensor on {device}")
    batch, h, w, icp = xq.shape
    oc, kh, kw, ic = w_q.shape
    if icp != padded_channels(ic):
        raise ValueError(f"xq has {icp} channels; weights with IC={ic} need "
                         f"{padded_channels(ic)} (quantize_cuda's pitch)")
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
    if min(pads) < 0 or min(stride) < 1:
        raise ValueError(f"pads {pads} and stride {stride} must be >= 0 and >= 1")
    ho, wo = out_shape(h, w, (kh, kw), stride, pads)
    if ho < 1 or wo < 1:
        raise ValueError(f"a {kh}x{kw} kernel does not fit {h}x{w} with pads {pads}")
    out = torch.empty((batch, ho, wo, oc), dtype=out_dtype, device=device)
    if out.numel() == 0:
        return out
    index = _device_index(xq)
    row, ints = _launch(batch, h, w, ic, oc, kh, kw, tuple(stride), tuple(pads), out_dtype,
                        _sm_count(index))
    weights = kernel_weights(w_q, row)
    lib = _lib()
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = lib.ssd_int8_conv(
        xq.data_ptr(), weights.data_ptr(), ptr(w_scale if dequant else None),
        ptr(x_scale if dequant else None), ptr(bias if dequant else None), out.data_ptr(),
        OUT_MODES[out_dtype], ints, len(ints), index, torch._C._cuda_getCurrentRawStream(index))
    _cuda_build.check_launch(lib, err, "int8 conv kernel launch")
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=512)
def _launch(batch: int, h: int, w: int, ic: int, oc: int, kh: int, kw: int,
            stride: Tuple[int, int], pads: Pads, out_dtype: torch.dtype,
            sm_count: int) -> Tuple[int, ctypes.Array]:
    """(row width, the plan's kernel_ints as a C array) of one conv shape: worked out
    once, so a call only checks, allocates and launches."""
    plan = plan_int8(batch, h, w, ic, oc, (kh, kw), stride, pads, OUT_BYTES[out_dtype])
    ints = plan.kernel_ints(sm_count)
    return plan.row, (ctypes.c_int * len(ints))(*ints)


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
    out = conv_cuda(xq, w_q, stride, pads, x.dtype, w_scale=w_scale, x_scale=x_scale, bias=bias)
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
