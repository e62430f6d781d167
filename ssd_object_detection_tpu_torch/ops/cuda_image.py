"""Wrappers of the hand-written image kernels: JPEG decode (csrc/jpeg_decode.cu: K1
entropy decode of the scans that first send their coefficients, K2 + K3 fused:
dequantise + IDCT, upsample + colour + orientation; csrc/jpeg_progressive.cu: K6 entropy
decode of progressive refinement scans; csrc/jpeg_smooth.cu: K7 block smoothing), resize
(csrc/resize.cu: K4), PNG (csrc/png_unfilter.cu: K5), GIF and TIFF LZW (csrc/gif_lzw.cu:
K9), the TIFF predictor and byte swap (csrc/tiff_assemble.cu: K10), TIFF's CCITT and
ThunderScan chunks (csrc/ccitt_decode.cu: K11), TIFF's SGILog chunks (csrc/sgilog_decode.cu:
K12) and BMP, PxM, PAM, Sun raster, PFM, HDR and TIFF pixels and GIF palette indices
(csrc/raw_image.cu: K8).

None replaces a Pallas kernel: the JAX package decodes and resizes with cv2 on the host
(ssd_object_detection_tpu/data/pipeline.py:70-125, eval/serve.py:248-260 and :374-381).
For CUDA tensors each wrapper launches its kernel or raises; for CPU tensors it runs
the kernel's plain version (ops/plain_image.py), which is also what the kernel is held
to on the card. There is no other route. Each wrapper's `launches` counts its kernel
launches (CPU calls do not count). The kernels are compiled at their first launch,
never at import (ops/_cuda_build.py: nvcc, sm_90a, -fmad=false, into `build/kernels/`),
and a launch allocates its outputs and scratch and nothing else, on the current stream.

What bounds them on an H100 (ops/cuda_image.py::bound_bytes gives the byte counts):
  K1 is latency-bound: Huffman decoding is a serial walk of bits. A restart segment is
     cut into subsequences of SUBSEQ_BITS, which synchronise their start states in
     rounds (self-synchronising decoding from one guess for each block of the MCU; the
     numpy model is ops/jpeg_sync_model.py), count and scan their blocks, decode again
     writing the coefficients, then scan the DC differences: five kernels, the three
     decoding passes spread over the card a thread a subsequence, the repair and the
     scans a block a segment. Its tables sit in shared memory. An AC first scan's EOB
     run completes its blocks at once, so its states carry no run.
  K6 walks each refinement scan's restart segment serially (a refinement block's bits
     depend on its history, so a guessed start must guess its block too, and such
     guesses rarely converge: ops/jpeg_sync_model.py::refine_report), but the walk
     touches no coefficient: one launch a round of the batch's refinement scans, three
     kernels (each block's nonzero history as 64 bits, the walk recording where each
     block starts, a thread a block replaying and writing it).
  K2 + K3 is one CTA a tile of MCUs of one image: the tile's component blocks (and the
     halo fancy upsampling reads) through the IDCT into shared memory, 8 threads a block,
     then every pixel upsampled, converted and staged in the output's orientation, and
     written out a row at a time with 16-byte stores; the coefficients in and the RGB out
     bound it, with an estimate of its integer operations at the peak issue rate just under.
  K7 is one CTA a tile of 8 x 32 blocks of a component, a thread a block, each block's
     first 64 bytes staged through shared memory 16 bytes a lane with the DCs of a
     two-block halo, the changed 16-byte pieces stored back; one launch a call (two where
     a component's own DCs may change: they are copied aside first); the estimates'
     arithmetic bounds it (PERF.md §6). K11 is a CTA a chunk, one launch a call: each CCITT
     chunk decoded from the state libtiff gives a chunk (its guess, checked by what it
     read; ops/fax_schedule_model.py), a lane walking the codes with the tables, run
     arrays and staged bytes in shared memory while two warps fill the rows, the image's
     last CTA decoding again, in order, from the first chunk whose guess failed; the walks
     bound it. K12 is a warp an SGILog chunk, one launch a call, lane 0 reading each row's
     control bytes and the warp expanding their runs; the byte walk bounds it. K8 is one launch a decode
     call (codec.raw_batch: the call's descriptors and bytes in one upload, read as they
     are), a CTA a tile of 8 x 128 output pixels of one image, a warp a row, a lane every
     32nd pixel (four a lane, their loads together), the row staged in shared memory and
     stored 16 bytes a lane; a TIFF's
     samples read straight from its chunks (YCbCr and CIELab by libtiff's tables, built on
     the host). K10 is one launch a call where a chunk has a predictor or a byte swap, a
     warp a row of every such chunk, in place: the predictor's prefix sum by shuffles. The
     bytes they move bound both.
  K4 is one launch a batch of images, a CTA a tile of 128 x 8 output pixels of one
     image (its x table in shared memory), a warp an output row, a lane every 32nd pixel
     of it, the per-image arguments by value and each shape pair's plan cached on the card.
  K5 is a row wavefront: a CTA a pass of a batch's pass table, a warp 32 rows, a lane a
     row, a pixel a step (W + H - 1 dependent steps a pass; a warp's first row waits on
     the warp above's last, pixel by pixel, in shared memory), on a scratch the first
     kernel fills by step so that a warp's loads and stores coalesce, then one thread per
     output pixel of every image for the expansion; three launches a batch.
  K9 is one CTA of 1,024 threads a GIF (or TIFF LZW chunk) of the batch, a window of 4,096 codes at a time,
     four a thread (the numpy replay is ops/gif_lzw_model.py): each code's bit position in
     closed form from its segment's start (the width of a segment's k-th code depends on k
     alone), the first Clear, EOI or fault by a block min, pointer jumping over the
     window's new table entries for their lengths and first bytes, binary lifting tables,
     a block scan of the lengths for the output offsets and the stop, then equal pixel
     ranges a thread, each walked backwards along the prefix chains into shared memory
     and copied out coalesced; each window's barriers and chain walks bound it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ssd_object_detection_tpu_torch.data import codec
from ssd_object_detection_tpu_torch.data.codec import GifBatch, GifImage, JpegBatch, PngBatch, PngImage
from ssd_object_detection_tpu_torch.ops import _cuda_build, plain_image

NVCC_FLAGS = _cuda_build.BASE_FLAGS + ("-fmad=false",)
JPEG_SOURCE = _cuda_build.CSRC / "jpeg_decode.cu"
PROGRESSIVE_SOURCE = _cuda_build.CSRC / "jpeg_progressive.cu"
RESIZE_SOURCE = _cuda_build.CSRC / "resize.cu"
PNG_SOURCE = _cuda_build.CSRC / "png_unfilter.cu"
SMOOTH_SOURCE = _cuda_build.CSRC / "jpeg_smooth.cu"
RAW_SOURCE = _cuda_build.CSRC / "raw_image.cu"
GIF_SOURCE = _cuda_build.CSRC / "gif_lzw.cu"
TIFF_SOURCE = _cuda_build.CSRC / "tiff_assemble.cu"
CCITT_SOURCE = _cuda_build.CSRC / "ccitt_decode.cu"
SGILOG_SOURCE = _cuda_build.CSRC / "sgilog_decode.cu"
SOURCES = (JPEG_SOURCE, PROGRESSIVE_SOURCE, RESIZE_SOURCE, PNG_SOURCE, SMOOTH_SOURCE, RAW_SOURCE, GIF_SOURCE,
           TIFF_SOURCE, CCITT_SOURCE, SGILOG_SOURCE)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    JPEG_SOURCE: {
        "ssd_jpeg_entropy": ([_P, _L, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P], _I),
        "ssd_jpeg_idct_color": ([_P, _P, _P, _P, _I, _P, _P], _I),
    },
    PROGRESSIVE_SOURCE: {
        "ssd_jpeg_refine": ([_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P], _I),
    },
    SMOOTH_SOURCE: {
        "ssd_jpeg_smooth": ([_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P], _I),
    },
    RAW_SOURCE: {
        "ssd_raw_expand": ([_P, _P, _I, _I, _I, _P, _P], _I),
    },
    RESIZE_SOURCE: {
        "ssd_resize_batch": ([_I, _I, _P, _I, _I, _P], _I),
    },
    PNG_SOURCE: {
        "ssd_png_decode": ([_P, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P], _I),
    },
    GIF_SOURCE: {
        "ssd_gif_lzw": ([_P, _P, _I, _P, _P, _P, _P], _I),
    },
    TIFF_SOURCE: {
        "ssd_tiff_assemble": ([_P, _I, _I, _I, _I, _P, _P], _I),
    },
    CCITT_SOURCE: {
        "ssd_ccitt_decode": ([_P, _I, _I, _P, _P, _P, _I, _P], _I),
    },
    SGILOG_SOURCE: {
        "ssd_sgilog_decode": ([_P, _I, _I, _P], _I),
    },
}


def build() -> None:
    """Compile the sources (each unless its library exists), one nvcc each, at once."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        for f in [pool.submit(_cuda_build.build, s, NVCC_FLAGS) for s in SOURCES]:
            f.result()


def _library(source) -> ctypes.CDLL:
    return _cuda_build.load(source, NVCC_FLAGS, _SIGNATURES[source])


def _stream(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no image kernel for device {t.device}")


# ---------------------------------------------------------------------------- K1, K6, K7
def entropy_outputs(batch: JpegBatch) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """New coefficients, warning counts and stops (NO_STOP) of a batch's segments."""
    device = batch.data.device
    return (torch.zeros((batch.total_blocks, 64), dtype=torch.int16, device=device),
            torch.zeros((batch.segments.shape[0],), dtype=torch.int32, device=device),
            torch.full((batch.segments.shape[0],), plain_image.NO_STOP, dtype=torch.int32, device=device))


def entropy_decode(batch: JpegBatch, out: Optional[Tuple[torch.Tensor, ...]] = None, step: int = 0,
                   sync: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """K1: the int16 (total_blocks, 64) coefficients, the int32 (S,) warning counts and
    the int32 (S,) stops (the MCU of its scan in which a segment's data ran out, else
    NO_STOP) of the segments of the scans that first send their coefficients
    (sequential scans, progressive DC first and AC first ones) at `step`, written into
    `out` (coef, status, stops) in place, else into new tensors; the other segments
    keep their values.
    Launches nothing for a batch without such segments. On the card, `sync` (int32
    (S, 2), where given) receives for each segment the rounds its subsequences took to
    synchronise and the subsequences one thread decoded one after another to repair
    them (ops/jpeg_sync_model.py::synchronise returns both; the segments K1 skips keep
    their values)."""
    coef, status, stops = out if out is not None else entropy_outputs(batch)
    if _route(batch.data) == "cpu":
        plain_image.entropy_decode(batch.data.numpy(), batch.segments.numpy(), batch.jobs.numpy(),
                                   batch.tables.numpy(), coef.numpy(), status.numpy(), stops.numpy(), step)
        return coef, status, stops
    device = batch.data.device
    for name in ("data", "segments", "jobs", "tables"):
        _check(name, getattr(batch, name), torch.uint8 if name == "data" else torch.int32, device)
    for name, t, dtype in (("coef", coef, torch.int16), ("status", status, torch.int32), ("stops", stops, torch.int32)):
        _check(name, t, dtype, device)
    if batch.total_subseqs == 0:
        return coef, status, stops
    # per subsequence: start bit, start (unit << 6 | k), end bit, end (unit << 6 | k),
    # blocks completed, its first block in decode order
    scratch = torch.empty((batch.total_subseqs, 6), dtype=torch.int32, device=device)
    guesses = torch.empty((batch.total_subseqs, 10, 2), dtype=torch.int32, device=device)  # end of each guess
    dcdiff = torch.empty((batch.total_blocks,), dtype=torch.int32, device=device)
    if sync is None:
        sync = torch.empty((batch.segments.shape[0], 2), dtype=torch.int32, device=device)
    _check("sync", sync, torch.int32, device)
    if sync.shape != (batch.segments.shape[0], 2):
        raise ValueError(f"sync has shape {tuple(sync.shape)}, expected ({batch.segments.shape[0]}, 2)")
    lib = _library(JPEG_SOURCE)
    err = lib.ssd_jpeg_entropy(
        batch.data.data_ptr(), batch.data.numel(), batch.segments.data_ptr(), batch.segments.shape[0],
        batch.jobs.data_ptr(), batch.tables.data_ptr(), codec.SUBSEQ_BITS, batch.max_guesses, batch.max_subseqs,
        step, scratch.data_ptr(), guesses.data_ptr(), dcdiff.data_ptr(), stops.data_ptr(), coef.data_ptr(),
        status.data_ptr(), sync.data_ptr(), _stream(device))
    _cuda_build.check_launch(lib, err, "JPEG entropy kernel launch")
    entropy_decode.launches += 1
    return coef, status, stops


def progressive_entropy(batch: JpegBatch, out: Optional[Tuple[torch.Tensor, ...]] = None, step: int = 0
                        ) -> Tuple[torch.Tensor, ...]:
    """K6: the refinement scans of progressive images at `step` (DC and AC
    refinement), round by round, into `out` (entropy_decode's coef, status and stops)
    in place, else into new tensors. One launch a round: the r-th refinement scan of
    every image. Launches nothing for a batch without refinement scans."""
    coef, status, stops = out if out is not None else entropy_outputs(batch)
    if _route(batch.data) == "cpu":
        plain_image.progressive_decode(batch.data.numpy(), batch.segments.numpy(), batch.jobs.numpy(),
                                       batch.tables.numpy(), coef.numpy(), status.numpy(), stops.numpy(), step)
        return coef, status, stops
    device = batch.data.device
    for name in ("data", "segments", "jobs", "tables", "k6_segs"):
        _check(name, getattr(batch, name), torch.uint8 if name == "data" else torch.int32, device)
    for name, t, dtype in (("coef", coef, torch.int16), ("status", status, torch.int32), ("stops", stops, torch.int32)):
        _check(name, t, dtype, device)
    rounds = [r for r in batch.k6_rounds if r[0] == step]
    if not rounds:
        return coef, status, stops
    # per block of a round: the nonzero history of its band (zig-zag bits) and the bit
    # its walk starts at
    most = max(r[3] for r in rounds)
    masks = torch.empty((max(most, 1),), dtype=torch.int64, device=device)
    starts = torch.empty((max(most, 1),), dtype=torch.int32, device=device)
    lib = _library(PROGRESSIVE_SOURCE)
    for _, first, rows, blocks in rounds:
        err = lib.ssd_jpeg_refine(
            batch.data.data_ptr(), batch.segments.data_ptr(), batch.jobs.data_ptr(), batch.tables.data_ptr(),
            batch.k6_segs.data_ptr(), first, rows, blocks, masks.data_ptr(), starts.data_ptr(), stops.data_ptr(),
            coef.data_ptr(), status.data_ptr(), _stream(device))
        _cuda_build.check_launch(lib, err, "JPEG refinement kernel launch")
        progressive_entropy.launches += 1
    return coef, status, stops


def block_smooth(batch: JpegBatch, coef: torch.Tensor, stops: torch.Tensor) -> torch.Tensor:
    """K7: libjpeg-turbo's block smoothing (jdcoefct.c decompress_smooth_data) of the
    components in `batch.smooth` (codec.SMOOTH_INTS a row), in `coef` in place: the
    first nine AC coefficients estimated from the 5x5 neighbourhood of DC values where
    they are still zero and not known to full precision, and, for a component without AC
    data, the DC too; `stops` (the entropy kernels') tell which iMCU rows take the
    coefficient bits from before the last scan. One launch, a CTA a tile of
    codec.SMOOTH_TILE blocks of a component; a second before it (counted) copies aside the
    DCs of the components whose own DCs may change. Launches nothing for a batch without
    such components."""
    if _route(coef) == "cpu":
        plain_image.block_smooth(coef.numpy(), batch.qtables.numpy(), batch.smooth.numpy(), batch.segments.numpy(),
                                 batch.jobs.numpy(), stops.numpy())
        return coef
    device = coef.device
    for name, t, dtype in (("coef", coef, torch.int16), ("stops", stops, torch.int32),
                           ("qtables", batch.qtables, torch.int32), ("smooth", batch.smooth, torch.int32),
                           ("segments", batch.segments, torch.int32), ("jobs", batch.jobs, torch.int32)):
        _check(name, t, dtype, device)
    if batch.smooth_tiles == 0:
        return coef
    dc = torch.empty((batch.smooth_dc,), dtype=torch.int16, device=device) if batch.smooth_dc else None
    lib = _library(SMOOTH_SOURCE)
    err = lib.ssd_jpeg_smooth(coef.data_ptr(), batch.qtables.data_ptr(), batch.smooth.data_ptr(),
                              batch.smooth.shape[0], batch.smooth_tiles, batch.smooth_dc, batch.segments.data_ptr(),
                              batch.jobs.data_ptr(), stops.data_ptr(), None if dc is None else dc.data_ptr(),
                              _stream(device))
    _cuda_build.check_launch(lib, err, "JPEG block smoothing kernel launch")
    block_smooth.launches += 1 + int(dc is not None)
    return coef


def decode_entropy(batch: JpegBatch, sync: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 and K6 step by step, then K7 where libjpeg smooths: the batch's coefficients
    as K2 reads them, and the segments' warning counts."""
    out = entropy_outputs(batch)
    for step in range(batch.steps):
        entropy_decode(batch, out, step, sync)
        progressive_entropy(batch, out, step)
    if batch.smooth.shape[0]:
        block_smooth(batch, out[0], out[2])
    return out[:2]


# ---------------------------------------------------------------------------- K2 + K3
def idct_color(coef: torch.Tensor, batch: JpegBatch) -> torch.Tensor:
    """K2 + K3, one fused kernel: the batch's int16 (blocks, 64) coefficients -> uint8
    (total_bytes,) RGB, each image at its byte offset (a SPACE_RAW image, a JPEG-in-TIFF
    chunk, its components unconverted, a byte each a pixel): dequantisation and the islow
    IDCT, upsampling, colour conversion and the Exif orientation, a CTA a tile of the
    batch's tile table, the component planes in shared memory. Its plain version is
    plain_image.color(plain_image.idct(...))."""
    if _route(coef) == "cpu":
        planes = plain_image.idct(coef.numpy(), batch.qtables.numpy(), batch.comps.numpy())
        return torch.from_numpy(plain_image.color(planes, batch.images.numpy(), batch.total_bytes))
    device = coef.device
    _check("coef", coef, torch.int16, device)
    for name in ("qtables", "images", "tiles"):
        _check(name, getattr(batch, name), torch.int32, device)
    out = torch.empty((batch.total_bytes,), dtype=torch.uint8, device=device)
    if batch.tiles.shape[0] == 0:
        return out
    lib = _library(JPEG_SOURCE)
    err = lib.ssd_jpeg_idct_color(coef.data_ptr(), batch.qtables.data_ptr(), batch.images.data_ptr(),
                                  batch.tiles.data_ptr(), batch.tiles.shape[0], out.data_ptr(), _stream(device))
    _cuda_build.check_launch(lib, err, "JPEG IDCT and colour kernel launch")
    idct_color.launches += 1
    return out


def decode_jpeg_batch(batch: JpegBatch) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """K1, K6 and K7 (each where the batch needs it), then the fused K2 + K3, over a batch:
    per image a uint8 (H, W, 3) RGB view, and the segments' warning counts."""
    coef, status = decode_entropy(batch)
    return rgb_views(idct_color(coef, batch), batch.out_shapes), status


def rgb_views(rgb: torch.Tensor, shapes: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """A flat RGB buffer of images back to back -> an (h, w, 3) view of each."""
    out, at = [], 0
    for h, w in shapes:
        out.append(rgb[at:at + h * w * 3].view(h, w, 3))
        at += h * w * 3
    return out


# ---------------------------------------------------------------------------- K4
RESIZE_MODES = {("linear", torch.uint8): 0, ("linear", torch.float32): 1, ("area", torch.uint8): 2}
RESIZE_TILE = (8, 128)  # csrc/resize.cu: kTileH x kTileW output pixels a CTA
RESIZE_MAX_ITEMS = 128  # csrc/resize.cu kMaxItems: images a launch
RESIZE_PLAN_INTS = 16  # csrc/resize.cu enum Plan


@functools.lru_cache(maxsize=64)
def _resize_plan(src_hw: Tuple[int, int], dst_hw: Tuple[int, int], mode: str, dtype: torch.dtype):
    """(plain version, host tables) of one resize; the tables are built as cv2 builds
    them, once for each pair of shapes (None: area at whole-number factors)."""
    if mode == "linear" and dtype == torch.uint8:
        return plain_image.resize_linear_u8, plain_image.linear_u8_tables(src_hw, dst_hw)
    if mode == "linear" and dtype == torch.float32:
        return plain_image.resize_linear_f32, plain_image.linear_f32_tables(src_hw, dst_hw)
    if mode == "area" and dtype == torch.uint8:
        if dst_hw[0] > src_hw[0] or dst_hw[1] > src_hw[1]:
            raise ValueError(f"area resize is for downscales, got {src_hw} -> {dst_hw}")
        if plain_image.area_is_integer(src_hw, dst_hw):
            return plain_image.resize_area_u8, None
        return plain_image.resize_area_u8, (*plain_image.area_tables(src_hw[1], dst_hw[1]),
                                            *plain_image.area_tables(src_hw[0], dst_hw[0]))
    raise ValueError(f"no {mode} resize for {dtype}")


@functools.lru_cache(maxsize=1024)
def _device_plan(src_hw, dst_hw, mode: str, dtype: torch.dtype, device: torch.device):
    """(the int64 (RESIZE_PLAN_INTS,) plan of one shape pair on the card, as
    csrc/resize.cu's enum Plan reads it: shapes, area factors or table widths, the IPP
    flag, tiles a row, then the pointers of its tables; the tables, which it points into;
    the tiles of an output), uploaded once and complete before any stream reads it."""
    _, tables = _resize_plan(src_hw, dst_hw, mode, dtype)
    (H, W), (h, w) = src_hw, dst_hw
    dev = tuple(torch.from_numpy(np.ascontiguousarray(t, np.int32 if t.dtype.kind in "iu" else np.float32))
                .to(device) for t in (tables or ()))
    kx = ky = nx = ny = ipp = 0
    ptr = [0] * 6  # xi, xc, xf, yi, yc, yf
    if mode == "linear":
        ipp = int(dtype == torch.float32 and H > 1 and W > 1)
        x_table, y_table = (1, 4) if dtype == torch.uint8 else (2, 5)
        ptr[0], ptr[x_table], ptr[3], ptr[y_table] = (t.data_ptr() for t in dev)
    elif tables is None:
        kx, ky = W // w, H // h
    else:
        nx, ny = tables[0].shape[1], tables[2].shape[1]
        ptr[0], ptr[2], ptr[3], ptr[5] = (t.data_ptr() for t in dev)
    tiles_x = -(-w // RESIZE_TILE[1])
    plan = torch.tensor([H, W, h, w, kx, ky, nx, ny, ipp, tiles_x, *ptr], dtype=torch.int64).to(device)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return plan, dev, tiles_x * -(-h // RESIZE_TILE[0])


def resize(img: torch.Tensor, size_hw: Tuple[int, int], mode: str = "linear") -> torch.Tensor:
    """K4: cv2.resize of an (H, W, C) image to `size_hw` = (h, w). `mode` "linear"
    (uint8 or float32) or "area" (uint8, a downscale)."""
    return resize_batch([img], [size_hw], mode)[0]


@functools.lru_cache(maxsize=256)
def _resize_pack(shapes: Tuple[Tuple[int, int, int, int], ...], channels: int, mode: str, dtype: torch.dtype,
                 device: torch.device):
    """A batch's launches, cached for each tuple of (H, W, h, w): ([(first image, images,
    their plans' pointers, their outputs' byte offsets in the batch's buffer, the most
    tiles of one of them, the plans themselves)] a launch of up to RESIZE_MAX_ITEMS
    images, the buffer's elements). A call fills in the sources and the buffer's address.
    Each launch holds the `_device_plan` tuples its pointers point into, so that no
    pointer outlives its tensors when that cache drops them (a hit here does not touch
    it) or when two threads build the same plan at once and one of them is not cached."""
    launches, at = [], 0
    element = torch.empty((), dtype=dtype).element_size()
    for first in range(0, len(shapes), RESIZE_MAX_ITEMS):
        plans, offsets, tiles = [], [], 1
        for H, W, h, w in shapes[first:first + RESIZE_MAX_ITEMS]:
            plans.append(_device_plan((H, W), (h, w), mode, dtype, device))
            offsets.append(at * element)
            at += h * w * channels
            tiles = max(tiles, plans[-1][2])
        launches.append((first, len(plans), [p[0].data_ptr() for p in plans], offsets, tiles, tuple(plans)))
    return launches, at


def _batch_views(out: torch.Tensor, shapes, channels: int) -> List[torch.Tensor]:
    """The outputs of a batch as (h, w, C) views of its buffer, in order."""
    h, w = shapes[0][2:]
    if all(s[2:] == (h, w) for s in shapes):
        return list(out.view(len(shapes), h, w, channels).unbind(0))
    parts = out.split([s[2] * s[3] * channels for s in shapes])
    return [p.view(s[2], s[3], channels) for p, s in zip(parts, shapes)]


def resize_batch(images: Sequence[torch.Tensor], sizes: Sequence[Tuple[int, int]], mode: str = "linear",
                 out: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """K4 over a batch: cv2.resize of each (H_i, W_i, C) image to its (h_i, w_i), one
    launch for up to RESIZE_MAX_ITEMS images. The outputs are views, in order, of one
    buffer: `out` where given (1-D, contiguous, of the images' dtype, sum h_i w_i C
    elements), else a new one. Every image of one dtype, channel count (1, 3 or 4 on the
    card) and device; `mode` as `resize`'s. The launches' arguments are cached for each
    tuple of shapes (`_resize_pack`): a call checks the images, allocates the buffer and
    makes one ctypes call a launch."""
    if len(images) != len(sizes):
        raise ValueError(f"{len(images)} images and {len(sizes)} sizes")
    if not images:
        return []
    dtype, device = images[0].dtype, images[0].device
    C = images[0].shape[-1]
    shapes = []
    for img, (h, w) in zip(images, sizes):
        shape = img.shape
        if len(shape) != 3 or h < 1 or w < 1:
            raise ValueError(f"expected an (H, W, C) image and a positive size, got {tuple(shape)} -> {(h, w)}")
        if shape[2] != C or img.dtype is not dtype or img.device != device:
            raise ValueError("a resize batch takes images of one dtype, channel count and device")
        shapes.append((shape[0], shape[1], int(h), int(w)))
    shapes = tuple(shapes)
    if _route(images[0]) == "cuda":
        if C not in (1, 3, 4):
            raise ValueError(f"the resize kernel takes 1, 3 or 4 channels, got {C}")
        if (mode, dtype) not in RESIZE_MODES:
            _resize_plan(shapes[0][:2], shapes[0][2:], mode, dtype)  # raises, naming what it lacks
        if any(max(W, w) * C >= 2 ** 31 or max(H, h) >= 2 ** 31 for H, W, h, w in shapes):
            raise ValueError("the resize kernel takes rows of fewer than 2^31 elements (32-bit offsets within a row)")
        launches, total = _resize_pack(shapes, C, mode, dtype, device)
    else:
        total = sum(h * w for _, _, h, w in shapes) * C
    single = out is None and len(shapes) == 1
    if out is None:
        out = torch.empty(shapes[0][2:] + (C,) if single else (total,), dtype=dtype, device=device)
    else:
        _check("out", out, dtype, device)
        if out.shape != (total,):
            raise ValueError(f"out has shape {tuple(out.shape)}, the batch writes ({total},)")
    views = [out] if single else _batch_views(out, shapes, C)
    if _route(images[0]) == "cpu":
        for img, (H, W, h, w), view in zip(images, shapes, views):
            plain, tables = _resize_plan((H, W), (h, w), mode, dtype)
            view.copy_(torch.from_numpy(plain(img.contiguous().numpy(), (h, w), tables)))
        return views
    lib = _library(RESIZE_SOURCE)
    kind, base, stream = RESIZE_MODES[(mode, dtype)], out.data_ptr(), _stream(device)
    for first, count, plans, offsets, tiles, _ in launches:
        items = []
        for img, plan, offset in zip(images[first:first + count], plans, offsets):
            if not img.is_contiguous():
                raise ValueError("img must be contiguous")
            items += (img.data_ptr(), base + offset, plan)
        err = lib.ssd_resize_batch(kind, C, (ctypes.c_longlong * len(items))(*items), count, tiles, stream)
        _cuda_build.check_launch(lib, err, f"{mode} resize kernel launch")
        resize.launches += 1
    return views


# ---------------------------------------------------------------------------- K5
def png_decode(batch: PngBatch) -> torch.Tensor:
    """K5: a batch of PNGs -> uint8 (total_pixels * 3,) RGB, each image oriented at its
    pixel offset: one launch moves every pass's filtered pixels to a scratch kept by
    wavefront step, one unfilters them there (a row wavefront, a CTA a pass, its warps
    pipelined 32 rows apart), one expands every pixel."""
    if _route(batch.inflated) == "cpu":
        return torch.from_numpy(plain_image.png_decode(
            batch.inflated.numpy(), batch.passes.numpy(), batch.images.numpy(), batch.palettes.numpy(),
            batch.total_pixels))
    device = batch.inflated.device
    _check("inflated", batch.inflated, torch.uint8, device)
    _check("passes", batch.passes, torch.int32, device)
    _check("images", batch.images, torch.int32, device)
    _check("palettes", batch.palettes, torch.uint8, device)
    out = torch.empty((batch.total_pixels * 3,), dtype=torch.uint8, device=device)
    if not batch.out_shapes:
        return out
    diag = torch.empty((max(batch.diag_elements, 1), 2), dtype=torch.int32, device=device)  # 8 bytes a pixel
    lib = _library(PNG_SOURCE)
    err = lib.ssd_png_decode(batch.inflated.data_ptr(), batch.passes.data_ptr(), batch.passes.shape[0],
                             batch.max_pass_pixels, diag.data_ptr(), batch.images.data_ptr(), batch.images.shape[0],
                             max(h * w for h, w in batch.out_shapes), batch.palettes.data_ptr(), out.data_ptr(),
                             _stream(device))
    _cuda_build.check_launch(lib, err, "PNG kernel launch")
    png_decode.launches += 1
    return out


def decode_png_batch(pngs: List[PngImage], device: torch.device) -> List[torch.Tensor]:
    """Parsed PNGs -> uint8 (H, W, 3) RGB views on `device`, through one K5 call."""
    batch = codec.png_batch(pngs)
    if device.type == "cuda":
        batch = batch.to(device)
    return rgb_views(png_decode(batch), batch.out_shapes)


def decode_png(png: PngImage, device: torch.device) -> torch.Tensor:
    """A parsed PNG -> uint8 (H, W, 3) RGB on `device` through K5."""
    return decode_png_batch([png], device)[0]


# ---------------------------------------------------------------------------- K9
# K9's counters a GIF (csrc/gif_lzw.cu kStats): clock64 cycles thread 0 spent in each phase,
# then what ops/gif_lzw_model.Stats counts
LZW_STATS = ("positions_cycles", "lengths_cycles", "scan_cycles", "pixels_cycles", "windows", "segments", "codes",
             "rounds", "levels")


def lzw_decode(batch: GifBatch, stats: Optional[torch.Tensor] = None, out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9: every GIF's first frame and TIFF LZW chunk -> (uint8 (total_indices,) output:
    each frame's palette indices at its offset in row order, each TIFF chunk's bytes at
    its offset, written into `out` where given (a TIFF chunk keeps `out`'s zeros past what
    decoded); int32 (G,) status, codec.GIF_*). One launch, a CTA a stream. `stats`, an
    int64 (G, len(LZW_STATS)) tensor beside the batch on the card, takes the kernel's
    counters (the plain version leaves it as it is)."""
    if _route(batch.data) == "cpu":
        indices, status = plain_image.lzw_decode(batch.data.numpy(), batch.gifs.numpy(), batch.total_indices,
                                                 None if out is None else out.numpy())
        return torch.from_numpy(indices), torch.from_numpy(status)
    device = batch.data.device
    _check("data", batch.data, torch.uint8, device)
    _check("gifs", batch.gifs, torch.int32, device)
    if out is None:
        indices = torch.empty((max(batch.total_indices, 1),), dtype=torch.uint8, device=device)
    else:
        _check("out", out, torch.uint8, device)
        if out.numel() < batch.total_indices:
            raise ValueError(f"out holds {out.numel()} bytes, the batch writes {batch.total_indices}")
        indices = out
    status = torch.empty((batch.gifs.shape[0],), dtype=torch.int32, device=device)
    if batch.gifs.shape[0] == 0:
        return indices, status
    if stats is not None:
        _check("stats", stats, torch.int64, device)
        if tuple(stats.shape) != (batch.gifs.shape[0], len(LZW_STATS)) or not stats.is_contiguous():
            raise ValueError(f"stats must be a contiguous ({batch.gifs.shape[0]}, {len(LZW_STATS)}) tensor")
    lib = _library(GIF_SOURCE)
    err = lib.ssd_gif_lzw(batch.data.data_ptr(), batch.gifs.data_ptr(), batch.gifs.shape[0], indices.data_ptr(),
                          status.data_ptr(), None if stats is None else stats.data_ptr(), _stream(device))
    _cuda_build.check_launch(lib, err, "GIF LZW kernel launch")
    lzw_decode.launches += 1
    return indices, status


def decode_raw_batch(gifs: Sequence[GifImage], tiffs: Sequence[codec.TiffImage], raws: Sequence[codec.RawImage],
                     device: torch.device, jpeg_pixels: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """Parsed GIFs, TIFFs and raw images (BMP, PxM, PAM, Sun raster, PFM, HDR) -> uint8
    (H, W, 3) RGB views on `device`, in that order, through one upload (codec.raw_batch),
    one K9 call for every GIF frame and TIFF LZW chunk (where there are any), one K11 call
    for every CCITT and ThunderScan chunk and one K12 call for every SGILog chunk (where
    there are any), one K10 call
    for the TIFF chunks with a predictor or a byte swap (where there are any) and one K8
    call for every image. `jpeg_pixels`: the TIFFs' JPEG chunks as the JPEG kernels decoded
    them (1-D uint8, back to back in codec.tiff_jpeg_chunks' order), which K8 reads in
    place. Waits for K9's status only where the batch holds GIFs, and raises ValueError
    where cv2's GIF decoder returns None (a TIFF chunk that fails decodes in part, as
    libtiff leaves it, on the device)."""
    batch = codec.raw_batch(gifs, tiffs, raws)
    held = 0 if jpeg_pixels is None else jpeg_pixels.numel()
    need = sum(c.jpeg.height * c.jpeg.width * codec.pixel_bytes(c.jpeg.space, len(c.jpeg.comps))
               for t in tiffs for c in t.chunks if c.jpeg is not None)
    if held < need:
        raise ValueError(f"{held} bytes of decoded JPEG chunks for the batch's {need}")
    if not batch.images:
        return []
    buffer = upload(batch, device)
    status = None
    if batch.lzw.gifs.shape[0]:
        _, status = lzw_decode(batch.lzw.to(device) if device.type == "cuda" else batch.lzw,
                               out=buffer[batch.lzw_at:])
    ccitt_decode(buffer, batch)
    sgilog_decode(buffer, batch)
    if batch.gifs:
        for st in status[:batch.gifs].cpu().tolist():
            if st != codec.GIF_OK:
                raise ValueError(f"corrupt GIF: {codec.GIF_FAULTS[st]}")
    tiff_assemble(buffer, batch, status)
    out = raw_expand(buffer, batch, jpeg_pixels)
    return [out[at:at + h * w * 3].view(h, w, 3) for at, h, w in batch.out]


def upload(batch: codec.RawBatch, device: torch.device) -> torch.Tensor:
    """The call's device buffer: `batch.host` in one copy, K9's TIFF chunks and K11's and
    K12's output zeroed (they leave a chunk's bytes past what decoded as they were)."""
    buffer = torch.empty((max(batch.total, 1),), dtype=torch.uint8, device=device)
    buffer[:batch.host.size].copy_(torch.from_numpy(batch.host), non_blocking=True)
    if batch.lzw.tiff_bytes or batch.fax_bytes or batch.sgi_bytes:
        buffer[batch.lzw_at + batch.lzw.frame_indices:batch.total].zero_()
    return buffer


# ---------------------------------------------------------------------------- K11
def ccitt_decode(buffer: torch.Tensor, batch: codec.RawBatch, records: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """K11, in a decode call's device `buffer` (`upload`'s): every CCITT and ThunderScan
    chunk of the call (codec.RawBatch's K11 streams) decoded into its rows at `fax_out`,
    as libtiff 4.7's tif_fax3.c and tif_thunder.c decode them. One launch, a CTA a chunk:
    each CCITT chunk from the state libtiff gives a chunk, the image's last CTA decoding
    again from the first chunk whose guess failed (ops/fax_schedule_model.py replays it);
    none where the call has no such chunk. `records`: an optional int32 (faxes,
    codec.FAX_RECORD_INTS) tensor on the card, zero, into which the kernel writes what each
    chunk's guess relied on and where each image's repair started."""
    if _route(buffer) == "cpu":
        if batch.faxes:
            plain_image.ccitt_decode(buffer.numpy(), batch.fax_streams, buffer.numpy())
        return buffer
    device = buffer.device
    _check("buffer", buffer, torch.uint8, device)
    if batch.faxes == 0:
        return buffer
    if records is None:
        records = torch.zeros((batch.faxes, codec.FAX_RECORD_INTS), dtype=torch.int32, device=device)
    _check("records", records, torch.int32, device)
    if tuple(records.shape) != (batch.faxes, codec.FAX_RECORD_INTS):
        raise ValueError(f"records of shape {tuple(records.shape)} for {batch.faxes} streams")
    runs = torch.empty((max(batch.fax_runs, 1),), dtype=torch.int32, device=device)  # saved arrays, read by prefix
    lib = _library(CCITT_SOURCE)
    err = lib.ssd_ccitt_decode(buffer.data_ptr(), batch.fax_at, batch.faxes, _fax_tables(device).data_ptr(),
                               runs.data_ptr(), records.data_ptr(), batch.fax_runs_max, _stream(device))
    _cuda_build.check_launch(lib, err, "CCITT and ThunderScan kernel launch")
    ccitt_decode.launches += 1
    return buffer


@functools.lru_cache(maxsize=None)
def _fax_tables(device: torch.device) -> torch.Tensor:
    """libtiff's three CCITT state tables (plain_image.fax_tables) on `device`, uploaded once."""
    return torch.from_numpy(plain_image.fax_tables()).to(device)


# ---------------------------------------------------------------------------- K12
def sgilog_decode(buffer: torch.Tensor, batch: codec.RawBatch) -> torch.Tensor:
    """K12, in a decode call's device `buffer` (`upload`'s): every SGILog chunk of the
    call (codec.RawBatch's K12 streams) decoded into its words at `sgi_out`, as libtiff
    4.7's tif_luv.c LogL16Decode and LogLuvDecode32 undo their run-length byte planes. One
    launch, a warp a chunk; none where the call has no such chunk."""
    if _route(buffer) == "cpu":
        if batch.sgis:
            plain_image.sgilog_decode(buffer.numpy(), batch.sgi_streams, buffer.numpy())
        return buffer
    device = buffer.device
    _check("buffer", buffer, torch.uint8, device)
    if batch.sgis == 0:
        return buffer
    lib = _library(SGILOG_SOURCE)
    err = lib.ssd_sgilog_decode(buffer.data_ptr(), batch.sgi_at, batch.sgis, _stream(device))
    _cuda_build.check_launch(lib, err, "SGILog kernel launch")
    sgilog_decode.launches += 1
    return buffer


# ---------------------------------------------------------------------------- K10
def tiff_assemble(buffer: torch.Tensor, batch: codec.RawBatch, status: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """K10, in place in a decode call's device `buffer` (`upload`'s): the horizontal
    predictor undone and big-endian 16-bit samples swapped in each TIFF chunk that needs
    it, a chunk whose K9 stream failed (`status`, K9's) left as it decoded. One launch, a
    warp a row of every such chunk; none where no chunk of the call needs it."""
    if _route(buffer) == "cpu":
        plain_image.tiff_assemble(buffer.numpy(), batch.chunk_at, batch.work_at, batch.works,
                                  np.zeros(0, np.int32) if status is None else status.numpy())
        return buffer
    device = buffer.device
    _check("buffer", buffer, torch.uint8, device)
    if status is not None:
        _check("status", status, torch.int32, device)
    if batch.works == 0:
        return buffer
    lib = _library(TIFF_SOURCE)
    err = lib.ssd_tiff_assemble(buffer.data_ptr(), batch.chunk_at, batch.work_at, batch.works, batch.k10_rows,
                                None if status is None else status.data_ptr(), _stream(device))
    _cuda_build.check_launch(lib, err, "TIFF predictor kernel launch")
    tiff_assemble.launches += 1
    return buffer


# ---------------------------------------------------------------------------- K8
def raw_expand(buffer: torch.Tensor, batch: codec.RawBatch, jpeg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8: every image of a decode call (`batch`; its device `buffer`, after K9 and K10;
    `jpeg`, the JPEG kernels' output holding the TIFFs' JPEG chunks, None: they read as
    zero) -> uint8 (batch.out_bytes,) RGB, each image turned by its orientation at its
    byte offset (`batch.out`). One launch, a CTA a tile of codec.RAW_TILE output pixels."""
    if _route(buffer) == "cpu":
        return torch.from_numpy(plain_image.raw_expand(buffer.numpy(), batch.images, batch.chunk_at,
                                                       None if jpeg is None else jpeg.numpy(), batch.out_bytes))
    device = buffer.device
    _check("buffer", buffer, torch.uint8, device)
    if jpeg is not None:
        _check("jpeg", jpeg, torch.uint8, device)
    out = torch.empty((max(batch.out_bytes, 1),), dtype=torch.uint8, device=device)
    lib = _library(RAW_SOURCE)
    err = lib.ssd_raw_expand(buffer.data_ptr(), None if jpeg is None else jpeg.data_ptr(), batch.images,
                             batch.chunk_at, batch.tiles, out.data_ptr(), _stream(device))
    _cuda_build.check_launch(lib, err, "raw image kernel launch")
    raw_expand.launches += 1
    return out


def decode_raw(raw: codec.RawImage, device: torch.device) -> torch.Tensor:
    """A parsed BMP, PxM, PAM, Sun raster, PFM or HDR -> uint8 (H, W, 3) RGB on `device` through K8."""
    return decode_raw_batch([], [], [raw], device)[0]


# ---------------------------------------------------------------------------- accounting
KERNELS = (entropy_decode, idct_color, resize, png_decode, progressive_entropy, block_smooth, raw_expand,
           lzw_decode, tiff_assemble, ccitt_decode, sgilog_decode)
for _k in KERNELS:
    _k.launches = 0


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def refinement_work(batch: JpegBatch) -> Tuple[int, int]:
    """(bytes, blocks) of K6's work on `batch`: its refinement scans' entropy-coded bytes,
    and the distinct blocks of the components some refinement scan touches (a block
    that several refinements touch counts once)."""
    segs, jobs = batch.segments.numpy(), batch.jobs.numpy()
    refine = jobs[segs[:, 2], 33] != codec.ROUTE_K1
    comps = {int(j[6 + 6 * k]) for j in jobs[jobs[:, 33] != codec.ROUTE_K1] for k in range(int(j[0]))}
    blocks = sum(int(bw * bh) for first, bw, bh, _ in batch.comps.tolist() if first in comps)
    return int(segs[refine, 1].sum()) // 8, blocks


def bound_bytes(kernel: str, **shape) -> int:
    """The bytes a kernel must move (each input read once, each output written once)."""
    if kernel == "entropy":
        return shape["entropy_bytes"] + shape["blocks"] * 64 * 2
    if kernel == "idct_color":  # the coefficients in, RGB out
        return shape["blocks"] * 64 * 2 + shape["pixels"] * 3
    if kernel == "resize":
        return shape["in_bytes"] + shape["out_bytes"]
    if kernel == "png":
        return shape["inflated"] + shape["pixels"] * 3
    if kernel == "progressive_entropy":  # the refinement scans' bytes in, each refined block in and out
        return shape["entropy_bytes"] + shape["blocks"] * 64 * 2 * 2
    if kernel == "block_smooth":  # a smoothed block's DC and zig-zag 1-9 in and out
        return shape["blocks"] * codec.SMOOTHING_COEFS * 2 * 2
    if kernel == "block_smooth_sectors":  # the 32-byte sectors holding them: a block's first 64 bytes in and out
        return shape["blocks"] * 64 * 2
    if kernel in ("ccitt", "sgilog"):  # the coded chunks in, the decoded rows (words) out
        return shape["in_bytes"] + shape["out_bytes"]
    if kernel == "raw_expand":  # the rows in, RGB out
        return shape["in_bytes"] + shape["pixels"] * 3
    if kernel == "lzw":  # the LZW data in, a palette index a pixel (a TIFF chunk's byte) out
        return shape["in_bytes"] + shape["pixels"]
    if kernel == "tiff_assemble":  # the predicted or swapped chunks' rows read and written in place
        return 2 * shape["chunk_bytes"]
    raise ValueError(kernel)
