"""Image decoding without cv2: host parsing here, pixel work in kernels on the card.

Counterpart of what the JAX package asks of `cv2.imread` / `cv2.imdecode(...,
IMREAD_COLOR)` followed by its BGR->RGB step (ssd_object_detection_tpu/data/pipeline.py:70-87,
eval/serve.py:374-381): the same pixels, as RGB.

What the host does, per image, before anything reaches the device:
  - JPEG: walks the markers (SOI, APPn, DQT, SOF0/SOF1/SOF2, DHT, DRI, SOS, RSTn, EOI),
    reads the Exif orientation (APP1) and the Adobe transform flag (APP14), checks each
    progressive scan's spectral selection and successive approximation as libjpeg does,
    and turns each scan's entropy-coded data into restart segments with the byte
    stuffing (FF 00), the fill bytes and the RSTn markers removed, in numpy; intervals
    the data never reaches (it ends at another marker) become empty segments. The
    Huffman tables become lookup tables for the entropy kernels, each scan bound to the
    tables defined before it. It decides, as libjpeg-turbo's smoothing_ok does, whether
    libjpeg smooths a progressive image's blocks.
  - PNG: checks the chunk CRCs and inflates IDAT with the standard library's zlib.
  - GIF: walks the blocks as cv2's GifDecoder does (every one to the trailer), reads the
    colour tables, the graphic control extension and the first frame's descriptor, and
    joins the frame's LZW data sub-blocks.
  - BMP, PBM/PGM/PPM, PAM, Sun raster, PFM, HDR: reads the header as cv2's readers do,
    expands a BMP's RLE4/RLE8 or an HDR's RLE scanlines and parses text samples.
What the device does (ops/cuda_image.py and csrc/): Huffman decoding of the scans that
first send their coefficients (K1: sequential, progressive DC first and AC first) and of
progressive refinement scans (K6), block smoothing (K7), dequantisation and the islow
IDCT (K2), libjpeg-turbo's upsampling, YCbCr->RGB, CMYK/YCCK->RGB as cv2 converts them
and the Exif orientation (K3), PNG unfiltering with the expansion to 8-bit RGB (K5), GIF
LZW decoding to palette indices (K9; TIFF LZW chunks, new- and old-style, to bytes),
TIFF CCITT and ThunderScan chunks to their samples (K11), TIFF SGILog chunks' run-length
planes to their words (K12), the TIFF predictor and byte swap (K10), and the other
formats' pixels (and K9's indices) to RGB (K8). On CPU tensors the same calls run the
plain versions (ops/plain_image.py).

Corrupt JPEG data decodes as libjpeg-turbo 3.1.2 decodes it: where a segment's data ends
at a marker before its MCUs do, the MCU being decoded finishes on zero bits and the rest
of the interval is left as it was (zero, or what earlier scans wrote); a code longer than
16 bits reads as symbol 0 after 17 bits. The kernels count these warnings a segment
(`decode_images_with_warnings`); nothing raises for them.

Supported: baseline, extended-sequential and progressive Huffman JPEGs, 8-bit, 1, 3 or
4 components (grey, YCbCr, RGB, CMYK, YCCK), sampling factors 1-4 in each direction
at integral ratios, any restart interval, one or several scans, smoothed or not; PNGs of
every colour type and bit depth, interlaced or not; GIF87a and GIF89a (the first frame on
its logical screen, LZW minimum code sizes 2-11, interlaced or not, transparency);
TIFF and BigTIFF as cv2 5.0 reads them through libtiff 4.7 (parse_tiff: strips, tiles
(uncompressed ones as cv2 reads them: _tiled_none_reads), separate planes, uncompressed,
PackBits, Deflate, LZW (old-style codes too), CCITT (modified Huffman, RLEW, Group 3 1-D
and 2-D, Group 4) on 1-bit samples, ThunderScan on 4-bit ones, SGILog and SGILog24 on
LogL and LogLuv (K12, then K8 by libtiff's 8-bit conversions) and JPEG (each chunk an
image of the batch's JPEG launches), the predictor,
1- to 16-bit gray, palette, RGB(A), CMYK, YCbCr
(every subsampling libtiff puts) and CIELab samples, the orientation; a compression code
no codec claims as zero samples); BMPs (core and info headers,
1/4/8-bit palettes, RLE4/RLE8, 16-bit 555/565, 24 and 32 bits, either row order), P1-P6
with any maxval, PAM (P7: gray and RGB of 8 or 16 bits,
and MAXVAL 1 bits, as cv2 5.0 reads them), Sun rasters of 1, 8, 24 and 32 bits (the
old and the standard type), 3-channel PFMs of either byte order, Radiance HDRs (`-Y H +X
W`, RLE or flat scanlines). Refused with `UnsupportedImage` (cv2 reads them):
YCbCr TIFFs of
4 x 4 data units that are no whole number of scanlines (cv2 reads memory libtiff never
wrote), 12-bit JPEG-in-TIFFs, WebP, JPEG 2000, AVIF (by any
brand of its `ftyp` box), lossless, hierarchical
and arithmetic-coded JPEGs, 12-bit ones, a 1-channel PFM (cv2 returns it with one
channel, which the JAX package's decode paths do not take) and a PAM with alpha past
MAXVAL 1 (cv2 fills most of it from memory it never wrote). Bytes cv2 returns None for
raise ValueError: a JPEG whose entropy-coded data has no marker after it (cut), a
2-component JPEG, a byte-encoded or RGB-type Sun raster, a BMP, PxM or PAM whose pixels
end early, a PAM whose TUPLTYPE and DEPTH disagree, a GIF whose LZW data does not give
its frame's pixels exactly, an HDR of another orientation, a TIFF of a codec cv2's
libtiff lacks (LZMA, ZSTD, WebP, JBIG, LERC, PixarLog, NeXT, old-style JPEG) or whose
setup refuses its samples, a JPEG-in-TIFF chunk libtiff cannot start, and the like.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ssd_object_detection_tpu_torch.utils.device import resolve_device


class UnsupportedImage(Exception):
    """An image that cv2 reads but this decoder refuses (an AVIF, a lossless JPEG, ...).
    Not a ValueError: a feed that skips undecodable bytes must not skip these."""


# ---------------------------------------------------------------------------- tables
# Row k of the zig-zag scan -> index in the natural (row-major) 8x8 order, with 16
# extra entries of 63 as libjpeg has: a corrupt run may step past 63.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16, np.int32)

# One Huffman table as the entropy kernel reads it (int32): a 9-bit lookahead
# ((length << 8) | symbol, 0 where the code is longer), maxcode[0..17] (maxcode[17] a
# sentinel), valoffset[0..17] and the 256 symbols.
LOOK_BITS = 9
T_LOOK, T_MAXCODE, T_VALOFF, T_VALS = 0, 512, 530, 548
TABLE_INTS = 804
# One scan ("job") as the entropy kernels read it: [ncomp, mcus_per_row, then per scan
# component: dc table, ac table, h, v, first block, blocks per row; at 26 and 27 its
# first segment and its number of segments; at 28-31 Ss, Se, Ah, Al; at 32 1 for a
# progressive scan; at 33 the kernel that decodes it (ROUTE_*); at 34 its step; at 35
# its MCUs, at 36 its MCU rows an iMCU row, at 37 its restart interval in MCUs].
JOB_INTS = 40
# Which kernel decodes a scan: K1 the scans that first send their coefficients
# (sequential, progressive DC first and AC first), K6 the refinement scans.
ROUTE_K1, ROUTE_DC_REFINE, ROUTE_AC_REFINE = 0, 1, 2
# One restart segment: [byte offset, bit count, job, first MCU, MCUs (0 for an interval
# the scan's data never reached after the one below), K1's first subsequence, 1 for the
# first interval past the scan's data, decoded only where its predecessor's data did not
# run out (libjpeg's insufficient_data flag survives the failed restart)].
SEG_INTS = 7
MAX_SCAN_COMPS = 4
# One image as the fused IDCT and colour kernel reads it: [output byte offset, out h,
# out w, decoded h, decoded w, orientation, ncomp, colour space, then per component:
# plane offset (its first block x 64), plane stride (its blocks a row x 8), downsampled
# w, downsampled h, h factor, v factor, upsampling mode, its quantisation table's row].
IMG_INTS = 40
# One tile of the fused kernel: [image, first row, first column, rows, columns] in
# decoded pixels; a whole number of MCUs, at most JPEG_TILE_H x JPEG_TILE_W pixels
# (csrc/jpeg_decode.cu kTileH, kTileW), whose component blocks, halo included, fit in
# JPEG_POOL_BLOCKS blocks of shared memory (kPoolBlocks).
TILE_INTS = 5
JPEG_TILE_W, JPEG_TILE_H, JPEG_POOL_BLOCKS = 128, 32, 256
SPACE_GRAY, SPACE_YCC, SPACE_RGB, SPACE_CMYK, SPACE_YCCK = 0, 1, 2, 3, 4
# the components as they are, a byte each a pixel (a JPEG-in-TIFF chunk but YCbCr's)
SPACE_RAW = 5
UP_COPY, UP_H2V1, UP_H1V2, UP_H2V2, UP_BOX = 0, 1, 2, 3, 4
# Bits of each subsequence of a restart segment that the entropy kernel K1 synchronises
# (csrc/jpeg_decode.cu; ops/jpeg_sync_model.py models it): 3072 bits cut a 640x480 COCO
# JPEG (~240k bits) into 79 subsequences. On the COCO-sized fixtures it takes the fewest
# bits decoded one after another (guess round, round 2, the repairing thread's
# subsequences, the writing decode) of 1024, 2048, 3072 and 4096 bits.
SUBSEQ_BITS = 3072
# libjpeg's coefficients whose coef_bits decide block smoothing (jdcoefct.c SAVED_COEFS),
# the first ten in zig-zag order
SMOOTHING_COEFS = 10


def huffman_table(bits: Sequence[int], vals: Sequence[int]) -> np.ndarray:
    """libjpeg's derived table (jdhuff.c jpeg_make_d_derived_tbl) in the kernel's layout."""
    out = np.zeros(TABLE_INTS, np.int32)
    maxcode = np.full(18, -1, np.int64)
    valoff = np.zeros(18, np.int64)
    code, p = 0, 0
    for length in range(1, 17):
        n = bits[length - 1]
        if n:
            valoff[length] = p - code
            code += n
            p += n
            maxcode[length] = code - 1
            if code - 1 >= (1 << length):
                raise ValueError("corrupt JPEG: bad Huffman table")
            # the lookahead entries of the codes of this length
            if length <= LOOK_BITS:
                for c in range(code - n, code):
                    lo = c << (LOOK_BITS - length)
                    hi = (c + 1) << (LOOK_BITS - length)
                    out[T_LOOK + lo:T_LOOK + hi] = (length << 8) | vals[c + valoff[length]]
        code <<= 1
    maxcode[17] = 0x7FFFFFFF
    out[T_MAXCODE:T_MAXCODE + 18] = maxcode
    out[T_VALOFF:T_VALOFF + 18] = valoff
    out[T_VALS:T_VALS + len(vals)] = vals
    return out


# ---------------------------------------------------------------------------- JPEG
_SOF_NAMES = {
    0xC3: "lossless (SOF3)", 0xC5: "differential sequential (SOF5)",
    0xC6: "differential progressive (SOF6)", 0xC7: "differential lossless (SOF7)",
    0xC9: "arithmetic-coded sequential (SOF9)", 0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)", 0xCD: "arithmetic-coded differential (SOF13)",
    0xCE: "arithmetic-coded differential progressive (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)",
}


@dataclasses.dataclass
class _Scan:
    comps: List[int]  # frame component indices
    tables: List[Tuple[int, int]]  # (dc, ac) global table index per scan component (-1: unused)
    segments: List[Tuple[bytes, int, int]]  # (unstuffed bytes, MCUs, 1 for the first missing interval)
    mcus_per_row: int
    spectral: Tuple[int, int, int, int] = (0, 63, 0, 0)  # Ss, Se, Ah, Al
    route: int = ROUTE_K1
    mcus: int = 0
    interval: int = 0  # MCUs a restart segment
    step: int = 0  # scans of one step: K1's at once, then K6's in order


@dataclasses.dataclass
class JpegImage:
    """A parsed JPEG: frame, quantisation tables, scans, and the colour handling."""

    height: int
    width: int
    comps: List[Tuple[int, int, int, int]]  # (id, h, v, qtable slot)
    qtables: List[np.ndarray]  # (64,) natural order, one per component
    huffman: List[np.ndarray]  # derived tables (TABLE_INTS,)
    scans: List[_Scan]
    space: int
    orientation: int
    progressive: bool = False
    smooth: bool = False  # libjpeg smooths the blocks (jdcoefct.c decompress_smooth_data)
    # (components, 2 * SMOOTHING_COEFS): coef_bits (-1 unsent, else the last Al) after the
    # last scan and before each component's last scan, as libjpeg latches them
    coef_bits: Optional[np.ndarray] = None
    sampling: Optional[List[Tuple[int, int]]] = None  # the frame's (h, v) factors as written

    @property
    def hmax(self) -> int:
        return max(c[1] for c in self.comps)

    @property
    def vmax(self) -> int:
        return max(c[2] for c in self.comps)

    def blocks_wh(self, ci: int) -> Tuple[int, int]:
        """The component's coefficient array in blocks: whole MCUs of the interleaved
        layout (libjpeg's width_in_blocks rounded up to the MCU)."""
        _, h, v, _ = self.comps[ci]
        return (-(-self.width // (8 * self.hmax)) * h, -(-self.height // (8 * self.vmax)) * v)

    def downsampled_wh(self, ci: int) -> Tuple[int, int]:
        _, h, v, _ = self.comps[ci]
        return (-(-self.width * h // self.hmax), -(-self.height * v // self.vmax))


def _entropy_end(d: np.ndarray, start: int) -> int:
    """Index of the marker that ends the entropy-coded data from `start`: the first FF
    followed by neither 00 (stuffing), an RSTn nor another FF (fill)."""
    seg = d[start:]
    if seg.size < 2:
        return d.size
    nxt = seg[1:]
    hit = (seg[:-1] == 0xFF) & (nxt != 0) & (nxt != 0xFF) & ((nxt < 0xD0) | (nxt > 0xD7))
    where = np.flatnonzero(hit)
    return start + int(where[0]) if where.size else d.size


def _split_entropy(d: np.ndarray) -> List[bytes]:
    """Entropy-coded bytes -> restart segments with the stuffing and the RSTn markers
    (and fill bytes before them and before the marker that ends the data) removed."""
    tail = d.size
    while tail and d[tail - 1] == 0xFF:
        tail -= 1
    d = d[:tail]
    if d.size == 0:
        return [b""]
    ff = d == 0xFF
    nxt = np.zeros_like(d)
    nxt[:-1] = d[1:]
    rst = ff & (nxt >= 0xD0) & (nxt <= 0xD7)
    drop = np.zeros(d.size, bool)
    drop[1:] |= (ff[:-1] & (d[1:] == 0))  # the 00 of FF 00
    drop |= ff & (nxt == 0xFF)  # fill bytes
    rst_at = np.flatnonzero(rst)
    drop[rst_at] = True
    drop[np.minimum(rst_at + 1, d.size - 1)] = True
    keep = ~drop
    # segment boundaries in the kept-byte numbering
    bounds = np.cumsum(keep)[rst_at] if rst_at.size else np.zeros(0, np.int64)
    data = d[keep].tobytes()
    cuts = [0] + [int(b) for b in bounds] + [len(data)]
    return [data[a:b] for a, b in zip(cuts[:-1], cuts[1:])]


def _ifd(data: bytes, order: str, at: int, big: bool):
    """The entries of the TIFF image file directory at `at`, in order: (tag, type, count,
    offset of its value field) each, for a classic TIFF (12-byte entries) or a BigTIFF
    (20-byte entries, 8-byte counts). struct.error at the first entry past the data."""
    if big:
        (n,) = struct.unpack_from(order + "Q", data, at)
        entry, head, fmt = 20, 8, "HHQ"
    else:
        (n,) = struct.unpack_from(order + "H", data, at)
        entry, head, fmt = 12, 2, "HHI"
    for i in range(n):
        e = at + head + entry * i
        tag, typ, count = struct.unpack_from(order + fmt, data, e)
        yield tag, typ, count, e + (12 if big else 8)


def _exif_orientation(payload: bytes) -> int:
    """The orientation tag (0x0112) of IFD0 of an Exif APP1 payload, as cv2's ExifReader
    reads it; 1 where there is none, its value is not 1-8 or the block is malformed."""
    try:
        if payload[:6] != b"Exif\0\0":
            return 1
        tiff = payload[6:]
        order = {b"II": "<", b"MM": ">"}[bytes(tiff[:2])]
        if struct.unpack(order + "H", tiff[2:4])[0] != 42:
            return 1
        for tag, _, _, field in _ifd(tiff, order, struct.unpack(order + "I", tiff[4:8])[0], False):
            if tag == 0x0112:  # cv2 reads 16 bits of the value field, whatever the type
                value = struct.unpack_from(order + "H", tiff, field)[0]
                return value if 1 <= value <= 8 else 1
    except (KeyError, struct.error, IndexError):
        return 1
    return 1


def _check_progression(ss: int, se: int, ah: int, al: int, ns: int) -> None:
    """libjpeg's checks of a progressive scan (jdphuff.c start_pass_phuff_decoder) that
    end the decode (ERREXIT: cv2 returns None); its checks of the order between scans
    only warn, and cv2 reads those files."""
    bad = se != 0 if ss == 0 else (ss > se or se > 63 or ns != 1)
    if bad or (ah != 0 and al != ah - 1) or al > 13:
        raise ValueError(f"corrupt JPEG: bad progression (Ss={ss} Se={se} Ah={ah} Al={al})")


def parse_jpeg(data: bytes, raw: bool = False) -> JpegImage:
    """Walk the markers of a JPEG; raises UnsupportedImage or ValueError. `raw`: its
    components come out as they are (libjpeg's JCS_UNKNOWN, as libtiff's JPEG codec asks
    for them), so two components are a frame like any other (SPACE_RAW)."""
    d = np.frombuffer(data, np.uint8)
    if d.size < 4 or d[0] != 0xFF or d[1] != 0xD8:
        raise ValueError("not a JPEG")
    pos = 2
    qt: Dict[int, np.ndarray] = {}
    dc: Dict[int, int] = {}
    ac: Dict[int, int] = {}
    huffman: List[np.ndarray] = []
    frame = None
    progressive = False
    coef_bits = None  # per component, libjpeg's coef_bits: -1 unsent, else the last Al
    latched: Dict[int, np.ndarray] = {}
    restart = 0
    jfif = adobe = False
    transform = -1
    orientation = 1
    scans: List[_Scan] = []
    n = d.size
    while True:
        # next marker (skipping fill bytes)
        while pos < n and d[pos] != 0xFF:
            pos += 1  # garbage between segments: libjpeg warns and skips
        while pos < n and d[pos] == 0xFF:
            pos += 1
        if pos >= n:
            # no EOI: a one-scan image is written out at its last MCU row; one of several
            # scans (progressive, or a first scan without every component) waits for EOI,
            # and cv2 gets no image
            if scans and not (progressive or len(scans[0].comps) < len(frame[2])):
                break
            raise ValueError("corrupt JPEG: no EOI after the scans" if scans else "corrupt JPEG: no scan")
        marker = int(d[pos])
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > n:
            raise ValueError("corrupt JPEG: truncated marker")
        length = (int(d[pos]) << 8) | int(d[pos + 1])
        body = data[pos + 2:pos + length]
        if length < 2 or len(body) != length - 2:
            raise ValueError("corrupt JPEG: truncated segment")
        pos += length
        if marker in _SOF_NAMES:
            raise UnsupportedImage(f"{_SOF_NAMES[marker]} JPEGs are not supported (unchecked against cv2)")
        if marker == 0xCC:
            raise UnsupportedImage("arithmetic-coded (DAC) JPEGs are not supported (unchecked against cv2)")
        if marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError("corrupt JPEG: two frames")
            precision, height, width, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise UnsupportedImage(f"{precision}-bit JPEGs are not supported (8-bit only; unchecked against cv2)")
            if nc == 2 and not raw:  # libjpeg has no colour conversion for it: cv2 returns None
                raise ValueError("corrupt JPEG: 2 components (no colour conversion)")
            if nc not in (1, 2, 3, 4):
                raise UnsupportedImage(f"{nc}-component JPEGs are not supported (unchecked against cv2)")
            if height == 0 or width == 0:
                raise ValueError("corrupt JPEG: empty frame (or DNL-defined height)")
            if len(body) < 6 + 3 * nc:
                raise ValueError("corrupt JPEG: short SOF")
            comps = []
            for i in range(nc):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4):
                    raise ValueError(f"corrupt JPEG: sampling factors {h}x{v} (libjpeg reads 1-4)")
                if tq > 3:
                    raise ValueError("corrupt JPEG: bad quantisation table slot")
                comps.append((cid, h, v, tq))
            sampling = [(c[1], c[2]) for c in comps]
            if nc == 1:
                comps = [(comps[0][0], 1, 1, comps[0][3])]  # libjpeg ignores a lone component's factors
            hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
            if any(hmax % c[1] or vmax % c[2] for c in comps):
                raise ValueError("corrupt JPEG: a fractional sampling ratio (libjpeg refuses it)")
            frame = (height, width, comps)
            progressive = marker == 0xC2
            coef_bits = np.full((nc, 64), -1, np.int64)
            prev_bits = np.full((nc, 64), -1, np.int64)
        elif marker == 0xDB:
            at = 0
            while at < len(body):
                pq, tq = body[at] >> 4, body[at] & 15
                size = 128 if pq else 64
                if tq > 3 or at + 1 + size > len(body):
                    raise ValueError("corrupt JPEG: bad DQT")
                vals = np.frombuffer(body[at + 1:at + 1 + size], ">u2" if pq else np.uint8).astype(np.int32)
                table = np.zeros(64, np.int32)
                table[ZIGZAG[:64]] = vals
                qt[tq] = table
                at += 1 + size
        elif marker == 0xC4:
            at = 0
            while at < len(body):
                tc, th = body[at] >> 4, body[at] & 15
                bits = list(body[at + 1:at + 17])
                total = sum(bits)
                if tc > 1 or th > 3 or len(bits) != 16 or total > 256 or at + 17 + total > len(body):
                    raise ValueError("corrupt JPEG: bad DHT")
                huffman.append(huffman_table(bits, list(body[at + 17:at + 17 + total])))
                (ac if tc else dc)[th] = len(huffman) - 1
                at += 17 + total
        elif marker == 0xDD:
            if len(body) < 2:
                raise ValueError("corrupt JPEG: bad DRI")
            restart = struct.unpack(">H", body[:2])[0]
        elif marker == 0xE0 and body[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xE1 and body[:6] == b"Exif\0\0" and orientation == 1:
            orientation = _exif_orientation(body)
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe, transform = True, body[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("corrupt JPEG: scan before frame")
            height, width, comps = frame
            ns = body[0] if body else 0
            if not 1 <= ns <= min(len(comps), MAX_SCAN_COMPS) or len(body) < 1 + 2 * ns + 3:
                raise ValueError("corrupt JPEG: bad SOS")
            ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
            ah, al = ahal >> 4, ahal & 15
            if progressive:
                _check_progression(ss, se, ah, al, ns)
            # else: libjpeg only warns about Ss, Se, Ah, Al in a sequential scan
            need_dc = not progressive or (ss == 0 and ah == 0)
            need_ac = not progressive or ss > 0
            ids = [c[0] for c in comps]
            members, tables = [], []
            for i in range(ns):
                cs, tdta = body[1 + 2 * i:3 + 2 * i]
                if cs not in ids:
                    raise ValueError("corrupt JPEG: scan names an unknown component")
                ci = ids.index(cs)
                if (need_dc and tdta >> 4 not in dc) or (need_ac and tdta & 15 not in ac):
                    raise ValueError("corrupt JPEG: scan uses an undefined Huffman table")
                if comps[ci][3] not in qt:
                    raise ValueError("corrupt JPEG: component uses an undefined quantisation table")
                latched.setdefault(ci, qt[comps[ci][3]])
                members.append(ci)
                tables.append((dc[tdta >> 4] if need_dc else -1, ac[tdta & 15] if need_ac else -1))
                if progressive:  # jdphuff.c start_pass_phuff_decoder
                    at = slice(min(ss, 1), max(se, SMOOTHING_COEFS - 1) + 1)
                    prev_bits[ci, at] = coef_bits[ci, at] if scans else 0
                    coef_bits[ci, ss:se + 1] = al
            end = _entropy_end(d, pos)
            if end >= n:  # libjpeg's read-ahead meets the end of the bytes: it suspends, cv2 gets None
                raise ValueError("corrupt JPEG: entropy-coded data ends without a marker")
            hmax = max(c[1] for c in comps)
            vmax = max(c[2] for c in comps)
            if ns == 1:  # non-interleaved: one block per MCU over the component's own size
                _, h, v, _ = comps[members[0]]
                per_row = -(-(-(-width * h // hmax)) // 8)
                rows = -(-(-(-height * v // vmax)) // 8)
            else:
                if sum(comps[ci][1] * comps[ci][2] for ci in members) > 10:
                    raise ValueError("corrupt JPEG: more than 10 blocks in an MCU")
                per_row = -(-width // (8 * hmax))
                rows = -(-height // (8 * vmax))
            total = per_row * rows
            pieces = _split_entropy(d[pos:end])
            interval = restart or total
            want = -(-total // interval)
            # intervals the data never reaches (it ends at a marker other than RSTn): the
            # first decodes on zero bits unless its predecessor ran out, the rest not at all
            segs = [(pieces[i] if i < len(pieces) else b"",
                     min(interval, total - i * interval) if i <= len(pieces) else 0, int(i == len(pieces)))
                    for i in range(want)]
            route = (ROUTE_K1 if not progressive or ah == 0 else
                     ROUTE_DC_REFINE if ss == 0 else ROUTE_AC_REFINE)
            scans.append(_Scan(members, tables, segs, per_row,
                               (ss, se, ah, al) if progressive else (0, 63, 0, 0), route, total, interval))
            pos = end
    if frame is None or not scans:
        raise ValueError("corrupt JPEG: no frame or scan")
    height, width, comps = frame
    if len(latched) != len(comps):
        raise ValueError("corrupt JPEG: a component appears in no scan")
    qtables = [latched[i] for i in range(len(comps))]
    _steps(scans)
    if raw:
        space = SPACE_RAW
    elif len(comps) == 1:
        space = SPACE_GRAY
    elif len(comps) == 4:  # libjpeg: Adobe transform 2 (or unknown) YCCK, else CMYK
        space = SPACE_YCCK if adobe and transform != 0 else SPACE_CMYK
    elif jfif:
        space = SPACE_YCC
    elif adobe:
        space = SPACE_RGB if transform == 0 else SPACE_YCC
    else:
        ids = [c[0] for c in comps]
        space = SPACE_RGB if ids == [82, 71, 66] else SPACE_YCC
    smooth = progressive and _smoothing(coef_bits, qtables)
    if len(scans) < 2:  # smoothing_ok latches -1 before the last scan of a one-scan image
        prev_bits[:] = -1
    return JpegImage(height, width, comps, qtables, huffman, scans, space, orientation, progressive, smooth,
                     np.concatenate([coef_bits[:, :SMOOTHING_COEFS], prev_bits[:, :SMOOTHING_COEFS]], 1)
                     if smooth else None, sampling)


def _steps(scans: List[_Scan]) -> None:
    """Number the scans' steps. K1 decodes a step's first scans at once, then K6 its
    refinement scans in order: that is the file's order wherever no first scan meets a
    coefficient an earlier scan of its step sent (libjpeg warns about such a progression
    and decodes it in order; a new step keeps that order)."""
    step, touched = 0, set()
    for scan in scans:
        ss, se = scan.spectral[:2]
        keys = {(ci, k) for ci in scan.comps for k in range(ss, se + 1)}
        if scan.route == ROUTE_K1 and keys & touched:
            step, touched = step + 1, set()
        touched |= keys
        scan.step = step


def _smoothing(coef_bits: np.ndarray, qtables: List[np.ndarray]) -> bool:
    """libjpeg-turbo's smoothing_ok (jdcoefct.c) after the last scan: every component's
    DC sent, the ten quantisers it divides by non-zero, and some of the first nine AC
    coefficients of some component unsent or not refined to the last bit."""
    if any((q[ZIGZAG[:SMOOTHING_COEFS]] == 0).any() for q in qtables) or (coef_bits[:, 0] < 0).any():
        return False
    return bool((coef_bits[:, 1:SMOOTHING_COEFS] != 0).any())


def oriented_hw(height: int, width: int, orientation: int) -> Tuple[int, int]:
    return (width, height) if orientation >= 5 else (height, width)


@dataclasses.dataclass
class JpegBatch:
    """Everything the JPEG kernels read, for a batch of parsed images (CPU tensors)."""

    data: torch.Tensor  # uint8: every segment's bytes, each from a 16-byte boundary, 16 zero bytes after
    segments: torch.Tensor  # (S, SEG_INTS) int32
    jobs: torch.Tensor  # (J, JOB_INTS) int32
    tables: torch.Tensor  # (T, TABLE_INTS) int32
    comps: torch.Tensor  # (C, 4) int32: first block, blocks per row, block rows, qtable
    qtables: torch.Tensor  # (C, 64) int32, natural order
    images: torch.Tensor  # (N, IMG_INTS) int32
    progressive: torch.Tensor  # (P, 2) int32: first job and job count of each progressive image
    # K6's rounds, one launch each: a refinement scan of an image's step runs one round
    # after the latest earlier refinement of its step that shares a (component,
    # coefficient) with it, so the refinements of different components or bands share
    # a round. k6_segs (R, 2) int32: a round's segments, each with the blocks before it
    # in the round; k6_rounds: (step, first row, rows, blocks) of each round, in launch
    # order
    k6_segs: torch.Tensor
    k6_rounds: List[Tuple[int, int, int, int]]
    tiles: torch.Tensor  # (T, TILE_INTS) int32: the fused IDCT and colour kernel's tiles
    # K7's components (those of the images libjpeg smooths), (M, SMOOTH_INTS) int32
    smooth: torch.Tensor
    smooth_blocks: int
    smooth_tiles: int  # K7's CTAs (SMOOTH_TILE blocks each)
    smooth_dc: int  # int16 DCs copied aside before K7 (SMOOTH_THREADS-aligned), 0: no copy pass
    steps: int
    total_blocks: int
    total_subseqs: int
    # the most subsequences of one K1 segment, and of K1's round-1 decodes
    # (subsequence 0, then one a block of the MCU for each but the first and the last)
    max_subseqs: int
    max_guesses: int
    out_shapes: List[Tuple[int, int]]

    out_channels: List[int] = dataclasses.field(default_factory=list)  # bytes a pixel of each image's output

    @property
    def total_pixels(self) -> int:
        return sum(h * w for h, w in self.out_shapes)

    @property
    def total_bytes(self) -> int:
        return sum(h * w * c for (h, w), c in zip(self.out_shapes, self.out_channels))

    def to(self, device: torch.device) -> "JpegBatch":
        """The batch on `device`. ValueError for a tile table with a tile of more than
        JPEG_TILE_H rows or JPEG_TILE_W columns, which the fused kernel's shared stage
        cannot hold (the kernel itself stops with an error on such a tile)."""
        if self.tiles.device.type == "cpu" and self.tiles.shape[0]:
            rows, cols = (int(v) for v in self.tiles[:, 3:5].amax(0))
            if rows > JPEG_TILE_H or cols > JPEG_TILE_W:
                raise ValueError(f"a JPEG tile of {rows} x {cols} pixels: the fused kernel holds at most "
                                 f"{JPEG_TILE_H} x {JPEG_TILE_W}")
        move = {f.name: getattr(self, f.name).to(device, non_blocking=True)
                for f in dataclasses.fields(self) if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **move)


# One smoothed component as K7 reads it (csrc/jpeg_smooth.cu enum Smooth): [first block,
# blocks per row, block rows (both whole MCUs), width and height in blocks (libjpeg's
# width_in_blocks and height_in_blocks), v factor, iMCU rows of the image, its qtable row,
# then coef_bits of zig-zag 0-9 after the last scan and before the component's last scan
# (libjpeg's coef_bits_latch), its image's first job and job count, its first CTA and
# CTAs a row of SMOOTH_TILE blocks, the first of its DCs copied aside (-1: its DCs do not
# change, none copied)].
SMOOTH_INTS = 33
(S_FIRST, S_BW, S_BH, S_WB, S_HB, S_V, S_IMCU_ROWS, S_QTABLE, S_BITS, S_PREV, S_JOB, S_JOBS, S_TILE, S_TILES_X,
 S_DC) = (0, 1, 2, 3, 4, 5, 6, 7, 8, 18, 28, 29, 30, 31, 32)
SMOOTH_TILE = (8, 32)  # csrc/jpeg_smooth.cu kTileRows x kTileCols blocks a CTA, a thread a block
SMOOTH_THREADS = SMOOTH_TILE[0] * SMOOTH_TILE[1]


def smooth_changes_dc(bits: Sequence[int]) -> bool:
    """Whether K7 estimates a block's DC under these coef_bits (zig-zag 0-9): the
    component has no AC data (jdcoefct.c's change_dc)."""
    return all(b == -1 for b in bits[1:10])


def _upsample_mode(fh: int, fv: int, dw: int) -> int:
    """libjpeg-turbo's choice (jdsample.c jinit_upsampler) with fancy upsampling on, for
    the integral ratio (fh, fv) of the largest factors to the component's: h2v1 and
    h2v2 are fancy where the downsampled width exceeds 2, h1v2 always; every other
    ratio is int_upsample (a box)."""
    if (fh, fv) == (1, 1):
        return UP_COPY
    if (fh, fv) == (2, 1):
        return UP_H2V1 if dw > 2 else UP_BOX
    if (fh, fv) == (1, 2):
        return UP_H1V2
    if (fh, fv) == (2, 2):
        return UP_H2V2 if dw > 2 else UP_BOX
    return UP_BOX


def pixel_bytes(space: int, ncomp: int) -> int:
    """Bytes a pixel of the fused kernel's output: RGB, or the raw components."""
    return ncomp if space == SPACE_RAW else 3


def tile_shape(hmax: int, vmax: int, channels: int = 3) -> Tuple[int, int]:
    """(rows, columns) of an image's tiles: the most whole MCUs (8 hmax x 8 vmax pixels)
    that fit in JPEG_TILE_H x JPEG_TILE_W, the fused kernel's shared stage of 3 bytes a
    pixel, fewer rows where its output takes 4."""
    rows = JPEG_TILE_H * 3 // max(channels, 3)
    return 8 * vmax * (rows // (8 * vmax)), 8 * hmax * (JPEG_TILE_W // (8 * hmax))


def image_tiles(index: int, height: int, width: int, shape: Tuple[int, int]) -> np.ndarray:
    """(T, TILE_INTS) tiles of image `index`, row-major."""
    th, tw = shape
    ys, xs = np.meshgrid(np.arange(0, height, th), np.arange(0, width, tw), indexing="ij")
    n = ys.size
    return np.stack([np.full(n, index), ys.ravel(), xs.ravel(), np.full(n, th), np.full(n, tw)], 1)


def tile_blocks(im: "JpegImage", shape: Tuple[int, int]) -> int:
    """The most component blocks a tile of `shape` holds, the halo fancy upsampling reads
    included: a whole MCU's samples start on a block, so each component's tile columns
    take columns / (8 fh) blocks, and one more each side where it upsamples fancily across."""
    total = 0
    for ci in range(len(im.comps)):
        _, h, v, _ = im.comps[ci]
        fh, fv = im.hmax // h, im.vmax // v
        mode = _upsample_mode(fh, fv, im.downsampled_wh(ci)[0])
        hh, hv = int(mode in (UP_H2V1, UP_H2V2)), int(mode in (UP_H1V2, UP_H2V2))
        total += (shape[1] // (8 * fh) + 2 * hh) * (shape[0] // (8 * fv) + 2 * hv)
    return total


def jpeg_batch(images: Sequence[JpegImage]) -> JpegBatch:
    """Lay out a batch of parsed JPEGs for the kernels (host work, numpy)."""
    seg_rows, job_rows, comp_rows, qts, img_rows, pieces, tables, prog = [], [], [], [], [], [], [], []
    tile_rows = []
    smooth_rows, rounds = [], {}  # rounds: (step, r) -> segment ids
    smooth_tiles, smooth_dc = 0, 0
    block, byte, table_base, out_at, subseq, max_subseqs, max_guesses = 0, 0, 0, 0, 0, 0, 0
    out_shapes, out_channels = [], []
    for im in images:
        first = []
        for ci in range(len(im.comps)):
            bw, bh = im.blocks_wh(ci)
            first.append(block)
            comp_rows.append([block, bw, bh, len(comp_rows)])
            qts.append(im.qtables[ci])
            if im.smooth:
                dw, dh = im.downsampled_wh(ci)
                wb, hb = -(-dw // 8), -(-dh // 8)
                tiles_x = -(-wb // SMOOTH_TILE[1])
                # the DCs are copied aside where a block's own DC may change (after the last
                # scan, or, in the rows past the last good one, before the component's last)
                bits = np.asarray(im.coef_bits[ci]).reshape(2, 10)
                dc_at = smooth_dc if smooth_changes_dc(bits[0]) or smooth_changes_dc(bits[1]) else -1
                smooth_rows.append([block, bw, bh, wb, hb, im.comps[ci][2], -(-im.height // (8 * im.vmax)),
                                    len(comp_rows) - 1, *im.coef_bits[ci], len(job_rows), len(im.scans),
                                    smooth_tiles, tiles_x, dc_at])
                smooth_tiles += tiles_x * -(-hb // SMOOTH_TILE[0])
                if dc_at >= 0:
                    smooth_dc += -(-bw * bh // SMOOTH_THREADS) * SMOOTH_THREADS
            block += bw * bh
        if im.progressive:
            prog.append([len(job_rows), len(im.scans)])
        rounds_of = []  # (step, round, the (component, coefficient) pairs) of the image's K6 scans so far
        for scan in im.scans:
            job = np.zeros(JOB_INTS, np.int32)
            job[0], job[1] = len(scan.comps), scan.mcus_per_row
            for k, (ci, (dct, act)) in enumerate(zip(scan.comps, scan.tables)):
                _, h, v, _ = im.comps[ci]
                if len(scan.comps) == 1:
                    h = v = 1
                job[2 + 6 * k:8 + 6 * k] = (table_base + dct if dct >= 0 else -1,
                                            table_base + act if act >= 0 else -1, h, v, first[ci],
                                            im.blocks_wh(ci)[0])
            job[26], job[27] = len(seg_rows), len(scan.segments)
            job[28:32] = scan.spectral
            job[32], job[33], job[34] = int(im.progressive), scan.route, scan.step
            job[35], job[37] = scan.mcus, scan.interval
            job[36] = im.comps[scan.comps[0]][2] if len(scan.comps) == 1 else 1
            units = sum(int(job[4 + 6 * k] * job[5 + 6 * k]) for k in range(len(scan.comps)))
            if scan.route != ROUTE_K1:  # one round after the latest earlier refinement it overlaps
                keys = {(ci, k) for ci in scan.comps for k in range(scan.spectral[0], scan.spectral[1] + 1)}
                r = 1 + max((r0 for st, r0, k0 in rounds_of if st == scan.step and k0 & keys), default=-1)
                rounds_of.append((scan.step, r, keys))
                rounds.setdefault((scan.step, r), []).extend(range(len(seg_rows), len(seg_rows) + len(scan.segments)))
            mcu = 0
            for seg, count, missing in scan.segments:
                seg_rows.append([byte, 8 * len(seg), len(job_rows), mcu, count, subseq, missing])
                if scan.route == ROUTE_K1:  # at least one: K1 decodes an empty segment too
                    n = max(1, -(-8 * len(seg) // SUBSEQ_BITS))
                    subseq += n
                    max_subseqs = max(max_subseqs, n)
                    max_guesses = max(max_guesses, 1 + (n - 2) * units if n > 1 else 0)
                pieces.append(seg + bytes(-len(seg) % 16))
                byte += len(pieces[-1])
                mcu += count
            job_rows.append(job)
        tables.extend(im.huffman)
        table_base += len(im.huffman)
        oh, ow = oriented_hw(im.height, im.width, im.orientation)
        row = np.zeros(IMG_INTS, np.int32)
        row[:8] = (out_at, oh, ow, im.height, im.width, im.orientation, len(im.comps), im.space)
        for ci in range(len(im.comps)):
            _, h, v, _ = im.comps[ci]
            bw, _ = im.blocks_wh(ci)
            dw, dh = im.downsampled_wh(ci)
            fh, fv = im.hmax // h, im.vmax // v
            row[8 + 8 * ci:16 + 8 * ci] = (first[ci] * 64, bw * 8, dw, dh, fh, fv, _upsample_mode(fh, fv, dw),
                                           len(comp_rows) - len(im.comps) + ci)
        channels = pixel_bytes(im.space, len(im.comps))
        shape = tile_shape(im.hmax, im.vmax, channels)
        if tile_blocks(im, shape) > JPEG_POOL_BLOCKS:
            raise ValueError(f"a JPEG tile of {shape} holds more than {JPEG_POOL_BLOCKS} blocks")
        tile_rows.append(image_tiles(len(img_rows), im.height, im.width, shape))
        img_rows.append(row)
        out_shapes.append((oh, ow))
        out_channels.append(channels)
        out_at += oh * ow * channels
    data = np.frombuffer(b"".join(pieces) + bytes(16), np.uint8).copy()
    k6_segs, k6_rounds = [], []
    for key in sorted(rounds):
        at, before = len(k6_segs), 0
        for s in rounds[key]:
            k6_segs.append([s, before])
            job = job_rows[seg_rows[s][2]]
            before += seg_rows[s][4] * sum(int(job[4 + 6 * k] * job[5 + 6 * k]) for k in range(int(job[0])))
        k6_rounds.append((key[0], at, len(k6_segs) - at, before))
    steps = 1 + max((int(j[34]) for j in job_rows), default=0)

    def t(rows, width, dtype=np.int32):
        return torch.from_numpy(np.asarray(rows, dtype).reshape(-1, width))

    return JpegBatch(
        data=torch.from_numpy(data), segments=t(seg_rows, SEG_INTS), jobs=t(job_rows, JOB_INTS),
        tables=t(tables, TABLE_INTS), comps=t(comp_rows, 4), qtables=t(qts, 64),
        images=t(img_rows, IMG_INTS), progressive=t(prog, 2), k6_segs=t(k6_segs, 2), k6_rounds=k6_rounds,
        tiles=t(np.concatenate(tile_rows) if tile_rows else [], TILE_INTS),
        smooth=t(smooth_rows, SMOOTH_INTS), smooth_blocks=sum(r[1] * r[2] for r in smooth_rows),
        smooth_tiles=smooth_tiles, smooth_dc=smooth_dc, steps=steps,
        total_blocks=block, total_subseqs=subseq, max_subseqs=max_subseqs, max_guesses=max_guesses,
        out_shapes=out_shapes, out_channels=out_channels,
    )


# ---------------------------------------------------------------------------- PNG
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7: (first row, first column, row step, column step) of each pass
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
# One pass as the PNG kernels read it: [offset of its first filter byte, rows, bytes per
# row (without the filter byte), bytes per pixel (at least 1), offset of its unfiltered
# rows (the plain versions'), its first row, first column, row step, column step, its
# width, the first element of its diagonal scratch (the kernels')]. K5 keeps a pass's
# pixels (bpp bytes, one 8-byte element each) by wavefront step: bands of PNG_ROWS rows,
# pixel i of row r of a band of R rows at element (r + i) * R + r of the band, whose
# (pixels a row + R - 1) * R elements follow the band before.
PASS_INTS = 11
PNG_ROWS = 512  # csrc/png_unfilter.cu kRows


def png_diag_elements(rows: int, pixels: int) -> int:
    """The diagonal scratch of a pass of `rows` rows of `pixels` pixels: its bands'."""
    full, last = divmod(rows, PNG_ROWS)
    return full * (pixels + PNG_ROWS - 1) * PNG_ROWS + (last and (pixels + last - 1) * last)


@dataclasses.dataclass
class PngImage:
    height: int
    width: int
    color_type: int
    bit_depth: int
    interlaced: bool
    palette: np.ndarray  # (256, 3) uint8
    inflated: bytes
    orientation: int

    def passes(self) -> np.ndarray:
        """(P, PASS_INTS) int64: the image's passes (one, or Adam7's non-empty ones), scratch offsets from 0."""
        bits = _CHANNELS[self.color_type] * self.bit_depth
        rows, at, raw, diag = [], 0, 0, 0
        layout = ADAM7 if self.interlaced else ((0, 0, 1, 1),)
        for y0, x0, dy, dx in layout:
            h = max(0, -(-(self.height - y0) // dy))
            w = max(0, -(-(self.width - x0) // dx))
            if h == 0 or w == 0:
                continue
            row_bytes = -(-w * bits // 8)
            bpp = max(1, bits // 8)
            rows.append([at, h, row_bytes, bpp, raw, y0, x0, dy, dx, w, diag])
            at += h * (row_bytes + 1)
            raw += h * row_bytes
            diag += png_diag_elements(h, row_bytes // bpp)
        return np.asarray(rows, np.int64).reshape(-1, PASS_INTS)


def parse_png(data: bytes) -> PngImage:
    """Chunks, CRCs and the inflated image data of a PNG; raises ValueError."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, header = 8, [], None
    palette = np.zeros((256, 3), np.uint8)
    orientation = 1
    while True:
        if pos + 8 > len(data):
            raise ValueError("corrupt PNG: truncated chunk")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("corrupt PNG: truncated chunk")
        if kind[0] & 0x20 == 0 and zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"corrupt PNG: bad CRC in {kind.decode('latin-1')}")
        pos += 12 + length
        if kind == b"IHDR":
            if length != 13:
                raise ValueError("corrupt PNG: bad IHDR")
            width, height, depth, ctype, method, filt, interlace = struct.unpack(">IIBBBBB", body)
            if (ctype not in _CHANNELS or depth not in (1, 2, 4, 8, 16) or method or filt
                    or interlace > 1 or (ctype in (2, 4, 6) and depth < 8) or (ctype == 3 and depth > 8)
                    or width == 0 or height == 0):
                raise ValueError("corrupt PNG: bad IHDR")
            header = (height, width, ctype, depth, bool(interlace))
        elif kind == b"PLTE":
            n = length // 3
            if length % 3 or n > 256:
                raise ValueError("corrupt PNG: bad PLTE")
            palette[:n] = np.frombuffer(body, np.uint8).reshape(n, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf":
            orientation = _exif_orientation(b"Exif\0\0" + body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("corrupt PNG: no IHDR or IDAT")
    try:
        inflated = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG: {e}") from None
    png = PngImage(*header, palette=palette, inflated=inflated, orientation=orientation)
    passes = png.passes().astype(np.int64)
    if len(inflated) < int(passes[:, 1] @ (passes[:, 2] + 1)):
        raise ValueError("corrupt PNG: image data ends early")
    starts = np.concatenate([at + np.arange(rows) * (rb + 1) for at, rows, rb in passes[:, :3]])
    if (np.frombuffer(inflated, np.uint8)[starts] > 4).any():
        raise ValueError("corrupt PNG: unknown filter type")
    return png


# One PNG of a batch as K5's expansion reads it: [offset of its first output pixel, height,
# width, colour type, bit depth, Exif orientation, its first pass in the batch's pass
# table, its passes].
PNG_INTS = 8


@dataclasses.dataclass
class PngBatch:
    """Everything K5 reads for a batch of parsed PNGs (CPU tensors until `to`)."""

    inflated: torch.Tensor  # uint8: every image's inflated IDAT bytes, one after another
    passes: torch.Tensor  # (P, PASS_INTS) int32, offsets into `inflated` and the unfiltered rows
    images: torch.Tensor  # (N, PNG_INTS) int32
    palettes: torch.Tensor  # (N, 256, 3) uint8 RGB
    diag_elements: int  # K5's diagonal scratch for every pass (8 bytes each)
    max_pass_pixels: int  # the most pixels of one pass
    out_shapes: List[Tuple[int, int]]

    @property
    def total_pixels(self) -> int:
        return sum(h * w for h, w in self.out_shapes)

    def to(self, device: torch.device) -> "PngBatch":
        move = {f.name: getattr(self, f.name).to(device, non_blocking=True)
                for f in dataclasses.fields(self) if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **move)


def png_batch(images: Sequence[PngImage]) -> PngBatch:
    """The batch's pass table (every image's passes, Adam7's seven or the one, in order)
    and image table, for one launch of each K5 kernel."""
    passes, rows, at, raw, pixel, diag = [], [], 0, 0, 0, 0
    shapes = []
    for png in images:
        p = png.passes()
        p[:, 0] += at
        p[:, 4] += raw
        p[:, 10] += diag
        oh, ow = oriented_hw(png.height, png.width, png.orientation)
        rows.append([pixel, png.height, png.width, png.color_type, png.bit_depth, png.orientation,
                     sum(len(q) for q in passes), len(p)])
        passes.append(p)
        at += len(png.inflated)
        raw += int((p[:, 1] * p[:, 2]).sum())
        diag += sum(png_diag_elements(int(h), int(rb // bpp)) for h, rb, bpp in p[:, 1:4])
        pixel += oh * ow
        shapes.append((oh, ow))
    inflated = np.frombuffer(b"".join(png.inflated for png in images) or b"\0", np.uint8)
    palettes = np.stack([png.palette for png in images]) if images else np.zeros((0, 256, 3), np.uint8)
    if pixel >= 2 ** 31 or at >= 2 ** 31 or raw >= 2 ** 31 or diag >= 2 ** 31:
        raise ValueError("PNG batch too large for one launch")
    return PngBatch(
        inflated=torch.from_numpy(inflated.copy()),
        passes=torch.from_numpy(np.concatenate(passes).astype(np.int32) if passes
                                else np.zeros((0, PASS_INTS), np.int32)),
        images=torch.from_numpy(np.asarray(rows, np.int32).reshape(-1, PNG_INTS)),
        palettes=torch.from_numpy(np.ascontiguousarray(palettes)), diag_elements=diag,
        max_pass_pixels=max((int(h * (rb // bpp)) for p in passes for h, rb, bpp in p[:, 1:4]), default=0),
        out_shapes=shapes)


# ---------------------------------------------------------------------------- BMP, PxM, PAM, Sun raster, PFM, HDR
# Pixel formats of the raw kernel K8, which turns a raw image's rows into RGB as cv2's
# readers (grfmt_bmp.cpp, grfmt_pxm.cpp, grfmt_sunras.cpp, grfmt_pfm.cpp, grfmt_hdr.cpp,
# grfmt_gif.cpp, grfmt_pam.cpp) do with IMREAD_COLOR: palette indices of 1, 4 or 8 bits
# (MSB first), 16-bit BGR 555 and 565 (little-endian, shifted up, no bit replication),
# BGR, BGRX, RGB and gray bytes, big-endian 16-bit RGB, BGR and gray (the high byte),
# 16-bit samples read as text (clamped to maxval, then scaled by 255 / maxval, or >> 8
# past 255), 32-bit floats, and Radiance RGBE quadruples (rgbe.cpp's rgbe2float, then
# x255 as convertTo rounds).
(RAW_PAL1, RAW_PAL4, RAW_PAL8, RAW_BGR555, RAW_BGR565, RAW_BGR, RAW_BGRX, RAW_RGB, RAW_GRAY, RAW_RGB16,
 RAW_GRAY16, RAW_TEXT, RAW_FLOAT, RAW_RGBE, RAW_BGR16) = range(15)
# K8's image rows: see RAW_INTS (with the TIFF and GIF views, below).
RAW_KINDS = ("bmp", "pxm", "pam", "sunras", "pfm", "hdr")


def _palette() -> np.ndarray:
    return np.zeros((257, 3), np.uint8)


@dataclasses.dataclass
class RawImage:
    """A BMP, PxM, PAM, Sun raster, PFM or HDR after its header (and any RLE) is undone on
    the host, or a GIF's frame (its palette indices come from K9 on the device)."""

    height: int
    width: int
    fmt: int
    data: bytes
    offset: int
    stride: int
    channels: int = 1
    maxval: int = 255
    big_endian: int = 0
    scale: float = 1.0  # PFM: samples are multiplied by this (float32)
    palette: np.ndarray = dataclasses.field(default_factory=_palette)  # (257, 3) RGB
    window: Optional[Tuple[int, int, int, int]] = None  # (top, left, height, width); None: the image
    orientation: int = 1
    colour_channels: int = 3
    alpha: int = -1
    planar: int = 0  # a TIFF of separate planes: sample s in plane s
    mirror: int = 0

    @property
    def out_hw(self) -> Tuple[int, int]:
        return oriented_hw(self.height, self.width, self.orientation)




def _need(data: bytes, end: int, what: str) -> None:
    if end > len(data):
        raise ValueError(f"corrupt {what}: pixel data ends early")


def _rows(data: bytes, at: int, height: int, pitch: int, bottom_up: bool, what: str) -> Tuple[bytes, int, int]:
    """(bytes, offset, stride) of `height` rows of `pitch` bytes from `at`, the first
    output row first."""
    _need(data, at + height * pitch, what)
    body = data[at:at + height * pitch]
    return (body, (height - 1) * pitch, -pitch) if bottom_up else (body, 0, pitch)


def _bmp_rle(data: bytes, at: int, width: int, height: int, four: bool) -> bytes:
    """RLE4/RLE8 pixel data -> one palette index a pixel, rows in file order, as cv2's
    BmpDecoder expands it: skipped pixels take index 0; a run past its row, or data
    that ends before the last row, and cv2 returns None."""
    out = np.zeros((height, width), np.uint8)
    x = y = 0
    pos, n = at, len(data)
    run_ended_row = False  # the last run filled its row and moved on (RLE8's line_end_flag)

    def advance(count: int) -> None:  # FillUniColor: `count` pixels of index 0, across rows
        nonlocal x, y
        while True:
            take = min(count, width - x)
            x += take
            count -= take
            if x >= width:
                x, y = 0, y + 1
                if y >= height:
                    return
            if count <= 0:
                return

    while y < height:
        if pos + 2 > n:
            raise ValueError("corrupt BMP: RLE data ends early")
        length, code = data[pos], data[pos + 1]
        pos += 2
        if length:  # encoded mode
            if x + length > width:
                raise ValueError("corrupt BMP: RLE run past its row")
            if four:
                out[y, x:x + length] = np.where(np.arange(length) % 2 == 0, code >> 4, code & 15)
            else:
                out[y, x:x + length] = code
            x += length
            run_ended_row = False
            if not four and x >= width:
                x, y, run_ended_row = 0, y + 1, True
        elif code > 2:  # absolute mode
            if x + code > width:
                raise ValueError("corrupt BMP: RLE run past its row")
            size = ((((code + 1) >> 1) + 1) & ~1) if four else ((code + 1) & ~1)
            if pos + size > n:
                raise ValueError("corrupt BMP: RLE data ends early")
            body = np.frombuffer(data[pos:pos + size], np.uint8)
            pos += size
            if four:
                body = np.stack([body >> 4, body & 15], 1).reshape(-1)
            out[y, x:x + code] = body[:code]
            x += code
            run_ended_row = False
            if not four and x >= width:
                x, y, run_ended_row = 0, y + 1, True
        else:
            if four:
                shift = width - x
                if code == 2:
                    if pos + 2 > n:
                        raise ValueError("corrupt BMP: RLE data ends early")
                    shift = data[pos]
                    pos += 2
                advance(shift)
                continue
            shift, down = width - x, height - y
            if code or not run_ended_row or shift < width:
                if code == 2:
                    if pos + 2 > n:
                        raise ValueError("corrupt BMP: RLE data ends early")
                    shift, down = data[pos], data[pos + 1]
                    pos += 2
                if code:
                    shift += down * width
                advance(shift)
            run_ended_row = False
    return out.tobytes()


def parse_bmp(data: bytes) -> RawImage:
    """A BMP as cv2's BmpDecoder reads it (core and info headers, 1/4/8-bit palettes,
    RLE4/RLE8, 16-bit 555 and 565 (BI_RGB, BITFIELDS with those masks), 24 and 32 bits,
    bottom-up or top-down rows); ValueError where cv2 returns None."""
    if len(data) < 26:
        raise ValueError("corrupt BMP: truncated header")
    offset, size = struct.unpack("<II", data[10:18])
    palette = _palette()
    if size >= 36:
        if len(data) < 14 + 36:
            raise ValueError("corrupt BMP: truncated header")
        width, height, _, bpp, comp = struct.unpack("<iiHHI", data[18:34])
        clrused = struct.unpack("<i", data[46:50])[0]
        at = 14 + size
        ok = width > 0 and height != 0 and (
            (bpp in (1, 4, 8, 24, 32) and comp == 0) or (bpp in (16, 32) and comp in (0, 3))
            or (bpp == 4 and comp == 2) or (bpp == 8 and comp == 1))
        if not ok:
            raise ValueError(f"BMP with {bpp} bits and compression {comp} (cv2 reads none)")
        if bpp <= 8:
            if not 0 <= clrused <= 256:
                raise ValueError("corrupt BMP: colour count")
            n = clrused or 1 << bpp
            entries = np.frombuffer(data[at:at + 4 * n].ljust(4 * n, b"\0"), np.uint8).reshape(n, 4)
            palette[:n] = entries[:, 2::-1]
        elif bpp == 16 and comp == 3:
            red, green, blue = struct.unpack("<III", data[at:at + 12].ljust(12, b"\0"))
            if (blue, green, red) == (0x1F, 0x3E0, 0x7C00):
                bpp = 15
            elif (blue, green, red) != (0x1F, 0x7E0, 0xF800):
                raise ValueError("BMP with 16-bit masks other than 555 and 565 (cv2 reads none)")
        elif bpp == 16:
            bpp = 15
    elif size == 12:
        width, height, _, bpp = struct.unpack("<HHHH", data[18:26])
        comp = 0
        if not (width > 0 and height != 0 and bpp in (1, 4, 8, 24, 32)):
            raise ValueError(f"BMP with {bpp} bits (cv2 reads none)")
        if bpp <= 8:
            n = 1 << bpp
            entries = np.frombuffer(data[26:26 + 3 * n].ljust(3 * n, b"\0"), np.uint8).reshape(n, 3)
            palette[:n] = entries[:, ::-1]
    else:
        raise ValueError("corrupt BMP: unknown header size")
    bottom_up = height > 0
    height = abs(height)
    if comp in (1, 2):
        body = _bmp_rle(data, offset, width, height, comp == 2)
        start, step = ((height - 1) * width, -width) if bottom_up else (0, width)
        return RawImage(height, width, RAW_PAL8, body, start, step, palette=palette)
    pitch = ((width * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
    fmt = {1: RAW_PAL1, 4: RAW_PAL4, 8: RAW_PAL8, 15: RAW_BGR555, 16: RAW_BGR565, 24: RAW_BGR, 32: RAW_BGRX}[bpp]
    body, start, step = _rows(data, offset, height, pitch, bottom_up, "BMP")
    return RawImage(height, width, fmt, body, start, step, palette=palette)


_SPACE = b" \t\n\v\f\r"


def _pxm_number(data: bytes, pos: int, maxdigits: int = 0) -> Tuple[int, int]:
    """cv2's ReadNumber: skip white space and # comments, read digits (at most
    `maxdigits`), and the one byte after them; (value, position after)."""
    n = len(data)

    def byte(i):
        if i >= n:
            raise ValueError("corrupt PxM: data ends early")
        return data[i]

    c = byte(pos)
    pos += 1
    while not 48 <= c <= 57:
        if c == 35:  # '#': to the end of the line
            while c not in (10, 13):
                c = byte(pos)
                pos += 1
            c = byte(pos)
            pos += 1
        elif c in _SPACE:
            while c in _SPACE:
                c = byte(pos)
                pos += 1
        else:
            raise ValueError("corrupt PxM: a byte that is not part of a number")
    value, digits = 0, 0
    while True:
        value = value * 10 + c - 48
        if value > 2 ** 31 - 1:
            raise ValueError("corrupt PxM: number too large")
        digits += 1
        if maxdigits and digits >= maxdigits:
            return value, pos
        c = data[pos] if pos < n else -1
        pos += 1
        if not 48 <= c <= 57:
            return value, pos


def parse_pxm(data: bytes) -> RawImage:
    """A PBM, PGM or PPM (P1-P6) as cv2's PxMDecoder reads it: comments, any maxval up
    to 65535; binary samples as they are (8 bits) or their high byte (16 bits), text
    samples clamped to maxval and scaled by 255 / maxval (or >> 8 past 255); PBM 1 is
    black. ValueError where cv2 returns None."""
    code = data[1:2]
    bpp = {b"1": 1, b"4": 1, b"2": 8, b"5": 8, b"3": 24, b"6": 24}[code]
    binary = code in b"456"
    width, pos = _pxm_number(data, 2)
    height, pos = _pxm_number(data, pos)
    maxval = 1
    if code not in b"14":
        maxval, pos = _pxm_number(data, pos)
        if maxval > 65535:
            raise ValueError("corrupt PxM: maxval past 65535")
    if width <= 0 or height <= 0 or maxval <= 0:
        raise ValueError("corrupt PxM: empty image")
    channels = 3 if bpp == 24 else 1
    pbm = _palette()
    pbm[0] = 255  # FillGrayPalette(palette, 1, negative): 0 white, 1 black
    if bpp == 1 and binary:
        pitch = -(-width // 8)
        body, start, step = _rows(data, pos, height, pitch, False, "PBM")
        return RawImage(height, width, RAW_PAL1, body, start, step, palette=pbm)
    if bpp == 1:
        values = np.zeros(width * height, np.uint8)
        for i in range(values.size):
            v, pos = _pxm_number(data, pos, 1)
            values[i] = v != 0
        return RawImage(height, width, RAW_PAL8, values.tobytes(), 0, width, palette=pbm)
    if binary:
        wide = maxval > 255
        pitch = width * channels * (2 if wide else 1)
        body, start, step = _rows(data, pos, height, pitch, False, "PxM")
        fmt = {(1, False): RAW_GRAY, (3, False): RAW_RGB, (1, True): RAW_GRAY16, (3, True): RAW_RGB16}[channels, wide]
        return RawImage(height, width, fmt, body, start, step, channels, maxval)
    values = np.zeros(width * height * channels, np.uint16)
    for i in range(values.size):
        v, pos = _pxm_number(data, pos)
        values[i] = min(v, maxval)
    return RawImage(height, width, RAW_TEXT, values.astype("<u2").tobytes(), 0, 2 * width * channels, channels, maxval)


_PAM_FIELDS = (b"ENDHDR", b"HEIGHT", b"WIDTH", b"DEPTH", b"MAXVAL", b"TUPLTYPE")
# grfmt_pam.cpp's formats: TUPLTYPE -> the DEPTH cv2 5.0 reads it at ("": none chosen)
_PAM_TUPLTYPES = {b"": 0, b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"GRAYSCALE_ALPHA": 2, b"RGB": 3, b"RGB_ALPHA": 4}


def _pam_line(data: bytes, pos: int) -> Tuple[Optional[bytes], bytes, int]:
    """cv2's ReadPAMHeaderLine from `pos`: (field name, or None for a comment; its value,
    trailing white space removed; position after). White space before the name, a name
    of up to 8 bytes ended by white space, a value of up to 255 bytes ended by CR or LF
    (white space before it skipped, line breaks included); ValueError where cv2 fails."""
    n = len(data)

    def byte(i):
        if i >= n:
            raise ValueError("corrupt PAM: header ends early")
        return data[i]

    c = byte(pos)
    pos += 1
    while c in _SPACE:
        c = byte(pos)
        pos += 1
    if c == 35:  # '#': to the end of the line
        while c not in (10, 13):
            c = byte(pos)
            pos += 1
        return None, b"", pos
    ident = bytearray()
    while len(ident) < 8 and c not in _SPACE:
        ident.append(c)
        c = byte(pos)
        pos += 1
    if c not in _SPACE:
        raise ValueError("corrupt PAM: a header field name past 8 bytes")
    name = bytes(ident).split(b"\0")[0]  # compared as a C string
    if name not in _PAM_FIELDS:
        raise ValueError("corrupt PAM: an unknown header field")
    if c in (10, 13):
        return name, b"", pos
    c = byte(pos)
    pos += 1
    while c in _SPACE:
        c = byte(pos)
        pos += 1
    value = bytearray()
    while len(value) < 255 and c not in (10, 13):
        value.append(c)
        c = byte(pos)
        pos += 1
    if c not in (10, 13):
        raise ValueError("corrupt PAM: a header value past 255 bytes")
    return name, bytes(value).rstrip(_SPACE).split(b"\0")[0], pos


def _pam_int(s: bytes) -> int:
    """cv2's ParseInt: an optional '-', digits, nothing after them; below 2^31 - 1."""
    pos = int(s[:1] == b"-")
    if pos and not s[1:2].isdigit():
        raise ValueError("corrupt PAM: a number")
    number = 0
    while pos < len(s) and 48 <= s[pos] <= 57:
        number = number * 10 + s[pos] - 48
        if number >= 2 ** 31 - 1:
            raise ValueError("corrupt PAM: number too large")
        pos += 1
    if pos < len(s):
        raise ValueError("corrupt PAM: a number")
    return -number if s[:1] == b"-" else number


def parse_pam(data: bytes) -> RawImage:
    """A PAM (`P7`) as cv2 5.0's PAMDecoder reads it: the header's WIDTH, HEIGHT, DEPTH
    and MAXVAL once each, TUPLTYPE any number of times (the last counts), comments, to
    ENDHDR; rows of WIDTH x DEPTH samples of one byte, or two past MAXVAL 255 (their
    high byte), never scaled by MAXVAL. DEPTH 1 reads as gray, DEPTH 3 as BGR; at MAXVAL
    1 each row's first bytes are bits, MSB first, a set bit white, whatever the DEPTH.
    With no TUPLTYPE, DEPTH 1 or 3 below MAXVAL 256 only; a TUPLTYPE must match the
    DEPTH. ValueError where cv2 returns None (or raises, for an empty image).
    GRAYSCALE_ALPHA and RGB_ALPHA past MAXVAL 1 raise UnsupportedImage: cv2 converts a
    few pixels of each row and leaves the rest as memory it never wrote."""
    if data[2:3] not in (b"\n", b"\r"):
        raise ValueError("corrupt PAM: no line break after P7")
    fields, pos, depth_of = {}, 3, 0
    while True:
        name, value, pos = _pam_line(data, pos)
        if name is None:
            continue
        if name == b"ENDHDR":
            break
        if name == b"TUPLTYPE":
            if value not in _PAM_TUPLTYPES:
                raise ValueError("corrupt PAM: an unknown TUPLTYPE")
            depth_of = _PAM_TUPLTYPES[value]
            continue
        if name in fields:
            raise ValueError(f"corrupt PAM: {name.decode()} given twice")
        fields[name] = _pam_int(value)
        if name == b"MAXVAL" and fields[name] > 65535:
            raise ValueError("corrupt PAM: MAXVAL past 65535")
    if len(fields) < 4:
        raise ValueError("corrupt PAM: WIDTH, HEIGHT, DEPTH or MAXVAL missing")
    width, height, depth, maxval = (fields[k] for k in (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL"))
    if not depth_of:  # grfmt_pam.cpp picks a format
        if depth not in (1, 3) or maxval > 255:
            raise ValueError("corrupt PAM: no TUPLTYPE, and DEPTH and MAXVAL choose none")
        depth_of = depth
    if depth != depth_of:
        raise ValueError("corrupt PAM: the TUPLTYPE does not match DEPTH")
    if width <= 0 or height <= 0:
        raise ValueError("corrupt PAM: empty image")
    _check_size(height, width, "PAM")
    wide = maxval > 255
    body, start, step = _rows(data, pos, height, width * depth * (1 + wide), False, "PAM")
    if maxval == 1:
        palette = _palette()
        palette[1] = 255
        return RawImage(height, width, RAW_PAL1, body, start, step, palette=palette)
    if depth in (2, 4):
        raise UnsupportedImage("PAM images with alpha past MAXVAL 1 are not supported (cv2 converts a few "
                               "pixels of each row and fills the rest from memory it did not write)")
    fmt = {(1, False): RAW_GRAY, (3, False): RAW_BGR, (1, True): RAW_GRAY16, (3, True): RAW_BGR16}[depth, wide]
    return RawImage(height, width, fmt, body, start, step, depth, maxval)


def parse_sunras(data: bytes) -> RawImage:
    """A Sun raster as cv2's SunRasterDecoder reads it: 1, 8, 24 or 32 bits, with an RGB
    colour map or without, 24 and 32 bits as BGR (XBGR); ValueError where cv2 returns
    None, which it does for every type but the old and the standard one (cv2 5.0.0
    reads no byte-encoded and no RGB-type raster: its test of the type compares the
    image's matrix type)."""
    if len(data) < 32:
        raise ValueError("corrupt Sun raster: truncated header")
    _, width, height, bpp, _, encoding, maptype, maplength = struct.unpack(">8i", data[:32])
    if not (width > 0 and height > 0 and bpp in (1, 8, 24, 32)):
        raise ValueError(f"Sun raster with {bpp} bits (cv2 reads none)")
    palsize = (1 << bpp) * 3 if bpp <= 8 else 0
    if encoding not in (0, 1) or not ((maptype == 0 and maplength == 0) or (
            maptype == 1 and 0 < maplength <= palsize and bpp <= 8)):
        raise ValueError("Sun raster with an encoding or colour map cv2 reads none of")
    palette = _palette()
    if maplength:
        _need(data, 32 + maplength, "Sun raster")
        n = maplength // 3
        cmap = np.frombuffer(data[32:32 + 3 * n], np.uint8).reshape(3, n)
        palette[:n] = cmap.T  # red, green, blue planes
    elif bpp <= 8:
        levels = 1 << bpp
        palette[:levels] = (np.arange(levels) * 255 // (levels - 1))[:, None]
    pitch = ((width * bpp + 7) // 8 + 1) & -2
    fmt = {1: RAW_PAL1, 8: RAW_PAL8, 24: RAW_BGR, 32: RAW_BGRX}[bpp]
    body, start, step = _rows(data, 32 + maplength, height, pitch, False, "Sun raster")
    return RawImage(height, width, fmt, body, start + (bpp == 32), step, palette=palette)  # XBGR: skip X


def parse_pfm(data: bytes) -> RawImage:
    """A 3-channel PFM (`PF`) as cv2's PFMDecoder reads it: rows bottom-up, the scale's
    sign giving the byte order (negative: little-endian), samples multiplied by
    1 / |scale| and rounded to 8 bits (not scaled by 255); ValueError where cv2 returns
    None. A 1-channel one (`Pf`) raises UnsupportedImage: cv2 returns it with one
    channel, which no decode path of the JAX package takes."""
    channels = {b"PF": 3, b"Pf": 1}[data[:2]]
    if channels == 1:  # cv2 gives it one channel, and the JAX package's BGR->RGB step fails on it
        raise UnsupportedImage("1-channel PFM images are not supported (cv2 reads them with one channel)")
    if data[2:3] != b"\n":
        raise ValueError("corrupt PFM: no line break after the magic")
    fields, pos = [], 3
    for _ in range(3):
        while pos < len(data) and data[pos] in _SPACE:
            pos += 1
        end = pos
        while end < len(data) and data[end] not in _SPACE:
            end += 1
        fields.append(data[pos:end].decode("latin-1"))
        pos = end + 1
    try:
        width, height, scale = int(fields[0]), int(fields[1]), float(fields[2])
    except ValueError:
        raise ValueError("corrupt PFM: header") from None
    if width <= 0 or height <= 0 or scale == 0:
        raise ValueError("corrupt PFM: header")
    body, start, step = _rows(data, pos, height, 4 * channels * width, True, "PFM")
    return RawImage(height, width, RAW_FLOAT, body, start, step, channels, big_endian=int(scale > 0),
                    scale=float(np.float32(1.0 / abs(scale))))


# cv2's imdecode refuses an image wider or taller than 2^20 or of more than 2^30 pixels
# (loadsave.cpp validateInputImageSize)
MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30


def _check_size(height: int, width: int, what: str) -> None:
    if width > MAX_SIDE or height > MAX_SIDE or width * height > MAX_PIXELS:
        raise ValueError(f"{what} of {width}x{height} pixels is larger than cv2 reads")


def _fgets(data: bytes, pos: int) -> Tuple[Optional[bytes], int]:
    """C's fgets(buf, 128, file) on `data` from `pos`: up to 127 bytes, through the first
    newline; None at the end of the data."""
    if pos >= len(data):
        return None, pos
    end = data.find(b"\n", pos, pos + 127)
    end = min(len(data), pos + 127 if end < 0 else end + 1)
    return data[pos:end], end


def _scan_int(s: bytes, i: int) -> Tuple[Optional[int], int]:
    """scanf's %d at s[i:]: white space, a sign, digits; the value wrapped to 32 bits as
    glibc stores a long into an int."""
    while i < len(s) and s[i] in _SPACE:
        i += 1
    j = i + (i < len(s) and s[i] in b"+-")
    k = j
    while k < len(s) and 48 <= s[k] <= 57:
        k += 1
    if k == j:
        return None, i
    v = max(min(int(s[i:k]), 2 ** 63 - 1), -2 ** 63)
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31, k


def _hdr_size(line: bytes) -> Optional[Tuple[int, int]]:
    """sscanf(line, "-Y %d +X %d", &height, &width) == 2, as (height, width); else None."""
    s = line.split(b"\0", 1)[0]
    if not s.startswith(b"-Y"):
        return None
    height, i = _scan_int(s, 2)
    if height is None:
        return None
    while i < len(s) and s[i] in _SPACE:
        i += 1
    if s[i:i + 2] != b"+X":
        return None
    width, _ = _scan_int(s, i + 2)
    return None if width is None else (height, width)


def _hdr_pixels(data: bytes, pos: int, width: int, height: int) -> bytes:
    """RGBE_ReadPixels_RLE (cv2's rgbe.cpp): the RGBE quadruples of every pixel, rows in
    file order. A row that does not start with 2 2 and its width is read flat with every
    row after it; an image narrower than 8 or wider than 32767 pixels is flat."""
    n, total = len(data), width * height

    def flat(at: int, count: int, pos: int) -> bytes:
        if pos + 4 * count > n:
            raise ValueError("corrupt HDR: pixel data ends early")
        return data[pos:pos + 4 * count]

    if width < 8 or width > 0x7FFF:
        return flat(0, total, pos)
    rows = []
    for row in range(height):
        if pos + 4 > n:
            raise ValueError("corrupt HDR: pixel data ends early")
        head = data[pos:pos + 4]
        pos += 4
        if head[0] != 2 or head[1] != 2 or head[2] & 0x80:
            rows.append(head + flat(row * width + 1, width * (height - row) - 1, pos))
            return b"".join(rows)
        if (head[2] << 8 | head[3]) != width:
            raise ValueError("corrupt HDR: wrong scanline width")
        line = bytearray(4 * width)
        p = 0
        for end in range(width, 5 * width, width):  # the four channels, one after another
            while p < end:
                if pos + 2 > n:
                    raise ValueError("corrupt HDR: pixel data ends early")
                count, value = data[pos], data[pos + 1]
                pos += 2
                if count > 128:  # a run
                    count -= 128
                    if count > end - p:
                        raise ValueError("corrupt HDR: bad scanline data")
                    line[p:p + count] = bytes((value,)) * count
                    p += count
                else:
                    if count == 0 or count > end - p:
                        raise ValueError("corrupt HDR: bad scanline data")
                    line[p] = value
                    if count > 1:
                        if pos + count - 1 > n:
                            raise ValueError("corrupt HDR: pixel data ends early")
                        line[p + 1:p + count] = data[pos:pos + count - 1]
                        pos += count - 1
                    p += count
        rows.append(np.frombuffer(bytes(line), np.uint8).reshape(4, width).T.tobytes())
    return b"".join(rows)


def parse_hdr(data: bytes) -> RawImage:
    """A Radiance HDR as cv2's HdrDecoder reads it (rgbe.cpp RGBE_ReadHeader and
    RGBE_ReadPixels_RLE): the first line skipped, header lines to the blank line (`#`
    lines skipped, FORMAT=32-bit_rle_rgbe required, others ignored), then `-Y H +X W`
    (cv2 reads no other orientation), then new-style RLE or flat scanlines; ValueError
    where cv2 returns None."""
    line, pos = _fgets(data, 0)
    has_format = False
    while line is not None:
        line, pos = _fgets(data, pos)
        if line is None or line[:1] == b"\n":
            break
        if line[:1] != b"#" and line == b"FORMAT=32-bit_rle_rgbe\n":
            has_format = True
    if line is None:
        raise ValueError("corrupt HDR: the header ends early")
    if not has_format:
        raise ValueError("HDR without FORMAT=32-bit_rle_rgbe (cv2 reads none)")
    line, pos = _fgets(data, pos)
    size = _hdr_size(line) if line is not None else None
    if size is None:
        raise ValueError("HDR without a -Y H +X W resolution line (cv2 reads no other orientation)")
    height, width = size
    if height <= 0 or width <= 0:
        raise ValueError("corrupt HDR: empty image")
    _check_size(height, width, "HDR")
    return RawImage(height, width, RAW_RGBE, _hdr_pixels(data, pos, width, height), 0, 4 * width)


def parse_raw(data: bytes, kind: str) -> RawImage:
    return {"bmp": parse_bmp, "pxm": parse_pxm, "pam": parse_pam, "sunras": parse_sunras, "pfm": parse_pfm,
            "hdr": parse_hdr}[kind](data)


# ---------------------------------------------------------------------------- GIF
# One LZW stream as the kernel K9 reads it: [offset of its data (a GIF's first frame's
# data sub-blocks joined, a TIFF chunk's bytes), its bytes, the LZW minimum code size,
# frame width, frame height, 1 if interlaced, offset of its output in K9's output, the
# transparent index or -1, then 8 words: the indices a pixel may take, bit i & 31 of word
# i >> 5; then its flavour: LZW_GIF, LZW_TIFF (a TIFF chunk of `width` bytes, height 1:
# MSB-first codes from 9 bits with libtiff's early change, EOI ends it) or LZW_TIFF_OLD (the
# same with LSB-first codes and a GIF's width schedule: libtiff's LZWDecodeCompat)].
GIF_INTS = 17
# K9's status of an image: decoded; cv2's lzwDecode returned false (a code past the
# table, pixels left over or missing, data after the last pixel); a string ran past the
# frame (cv2 raises); a pixel took an index no colour table has
GIF_OK, GIF_LZW_FAILED, GIF_OVERFLOW, GIF_BAD_INDEX = 0, 1, 2, 3
GIF_FAULTS = {GIF_LZW_FAILED: "the LZW data does not give the frame's pixels",
              GIF_OVERFLOW: "an LZW string runs past the frame",
              GIF_BAD_INDEX: "a pixel's index is past its colour table"}


class _Stream:
    """cv2's RBaseStream over bytes: reading past the end raises; skip does not check."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError("corrupt GIF: data ends early")
        self.pos += 1
        return self.data[self.pos - 1]

    def word(self) -> int:
        return self.byte() | self.byte() << 8

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("corrupt GIF: data ends early")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def blocks(self) -> None:  # skip data sub-blocks through their terminator
        n = self.byte()
        while n:
            self.pos += n
            n = self.byte()


def _gif_walk(s: _Stream) -> None:
    """cv2's GifDecoder::getFrameCount_, run as the header is read: every block to the
    trailer must parse, or cv2 returns None. Its application-extension reader skips 2 of
    the 3 bytes of a sub-block that does not follow a NETSCAPE2.0 one (kept here)."""
    b = s.byte()
    while b != 0x3B:
        if b == 0x21:
            kind = s.byte()
            if kind == 0xFF:
                netscape = False
                n = s.byte()
                while n:
                    if n == 11:
                        netscape = s.take(11) == b"NETSCAPE2.0"
                    elif n == 3 and netscape and s.byte() == 1:
                        s.word()
                    elif n == 3:
                        s.pos += 2
                    else:
                        s.pos += n
                    n = s.byte()
            elif kind == 0xF9:
                n = s.byte()
                while n:
                    if n == 4:
                        s.byte()
                    s.pos += 3 if n == 4 else n
                    n = s.byte()
            else:
                s.blocks()
        elif b == 0x2C:
            s.pos += 8
            flags = s.byte()
            if flags & 0x80:
                s.pos += 3 << ((flags & 7) + 1)
            s.pos += 1
            s.blocks()
        else:
            raise ValueError(f"corrupt GIF: unknown block 0x{b:02x}")
        b = s.byte()


@dataclasses.dataclass
class GifImage:
    """A GIF's first frame as cv2's GifDecoder composes it: the frame's LZW data for K9,
    and K8's view of K9's palette indices (`raw`)."""

    height: int  # the logical screen
    width: int
    top: int
    left: int
    frame_height: int
    frame_width: int
    interlaced: bool
    min_code_size: int
    lzw: bytes  # the frame's data sub-blocks, joined
    transparent: int  # -1: none
    valid: np.ndarray  # (256,) bool: the indices a pixel may take
    palette: np.ndarray  # (257, 3) RGB: each index's colour, the transparent one's and [256] the canvas

    def raw(self) -> RawImage:
        """K8's view of the frame's indices (K9's output, on the device)."""
        return RawImage(self.height, self.width, RAW_PAL8, b"", 0, self.frame_width, palette=self.palette,
                        window=(self.top, self.left, self.frame_height, self.frame_width))


def parse_gif(data: bytes) -> GifImage:
    """A GIF87a or GIF89a as cv2's GifDecoder reads it with IMREAD_COLOR: the logical
    screen, filled with the global table's background colour (black without a global
    table), under the first frame; the graphic control extensions before it (the last
    one's transparent index shows the screen; disposal past 3 raises); the frame's local
    table, else the global one, an index past the local table taking the global table's
    colour; with no table at all index 1 is white and every other index its own gray.
    ValueError where cv2 returns None; whether the LZW data gives the frame's pixels is
    known once K9 has run (`decode_images` raises then)."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("corrupt GIF: signature")
    s = _Stream(data, 6)
    width, height = s.word(), s.word()
    if width == 0 or height == 0:
        raise ValueError("corrupt GIF: empty logical screen")
    flags, bg = s.byte(), s.byte()
    s.byte()
    global_table = np.zeros((0, 3), np.uint8)
    if flags & 0x80:
        global_table = np.frombuffer(s.take(3 << ((flags & 7) + 1)), np.uint8).reshape(-1, 3)
        if bg >= len(global_table):
            raise ValueError("corrupt GIF: background index past the global table")
    _check_size(height, width, "GIF")
    after_header = s.pos
    _gif_walk(s)
    s.pos = after_header
    transparent = -1
    while s.byte() == 0x21:  # GifDecoder::readExtensions
        if s.byte() == 0xF9:
            transparent = -1
            if s.byte() != 4:
                raise ValueError("corrupt GIF: graphic control extension of other than 4 bytes")
            gce = s.byte()
            if gce & 0x10:
                raise ValueError(f"GIF with disposal method {(gce >> 2) & 7} (cv2 reads none past 3)")
            s.word()
            index = s.byte()
            transparent = index if gce & 1 else -1
        s.blocks()
    s.pos -= 1
    if s.byte() != 0x2C:
        raise ValueError("corrupt GIF: no image descriptor")
    left, top, fw, fh = s.word(), s.word(), s.word(), s.word()
    if fw == 0 or fh == 0 or left + fw > width or top + fh > height:
        raise ValueError("corrupt GIF: the frame is empty or leaves the logical screen")
    local_flags = s.byte()
    table = global_table
    if local_flags & 0x80:
        table = np.frombuffer(s.take(3 << ((local_flags & 7) + 1)), np.uint8).reshape(-1, 3)
    min_code_size = s.byte()
    if not 2 <= min_code_size <= 11:
        raise ValueError(f"GIF with LZW minimum code size {min_code_size} (cv2 reads 2-11)")
    chunks = []
    n = s.byte()
    while n:
        chunks.append(s.take(n))
        n = s.byte()
    canvas = global_table[bg] if len(global_table) else np.zeros(3, np.uint8)
    palette = _palette()
    index = np.arange(256)
    valid = index < max(len(table), len(global_table))
    palette[:len(global_table)] = global_table[:256]
    palette[:len(table)] = table[:256]
    if not len(table) and not len(global_table):
        valid[:] = True
        palette[:256] = np.where(index == 1, 255, index)[:, None]
    if transparent >= 0:
        valid[transparent] = True
        palette[transparent] = canvas
    palette[256] = canvas
    return GifImage(height, width, top, left, fh, fw, bool(local_flags & 0x40), min_code_size, b"".join(chunks),
                    transparent, valid, palette)


@dataclasses.dataclass
class GifBatch:
    """Everything K9 reads for a batch of parsed GIFs and TIFF LZW chunks (CPU tensors
    until `to`)."""

    data: torch.Tensor  # uint8: every stream's LZW data, one after another
    gifs: torch.Tensor  # (G, GIF_INTS) int32: the GIFs' streams, then the TIFF chunks'
    total_indices: int  # the bytes of K9's output: the frames' pixels, then `tiff_bytes`
    tiff_bytes: int = 0  # the TIFF LZW chunks' decoded bytes, after the frames

    @property
    def frame_indices(self) -> int:
        return self.total_indices - self.tiff_bytes

    def to(self, device: torch.device) -> "GifBatch":
        return dataclasses.replace(self, data=self.data.to(device, non_blocking=True),
                                   gifs=self.gifs.to(device, non_blocking=True))


def gif_batch(images: Sequence[GifImage], lzw: Sequence[Tuple[bytes, int, int]] = ()) -> GifBatch:
    """The batch's LZW table: one K9 launch decodes every GIF frame and every TIFF LZW
    chunk (`lzw`: its stored bytes, the bytes it fills and its flavour, LZW_TIFF or
    LZW_TIFF_OLD), the chunks back to back after the frames' indices."""
    rows, at, out, pieces = [], 0, 0, []
    for g in images:
        mask = np.packbits(g.valid.reshape(8, 32)[:, ::-1], axis=1, bitorder="big").view(">u4").reshape(8)
        rows.append([at, len(g.lzw), g.min_code_size, g.frame_width, g.frame_height, int(g.interlaced), out,
                     g.transparent, *mask.astype(np.int64).astype(np.uint32).view(np.int32).tolist(), LZW_GIF])
        pieces.append(g.lzw)
        at += len(g.lzw)
        out += g.frame_width * g.frame_height
    tiff_bytes = 0
    for raw, size, flavour in lzw:
        rows.append([at, len(raw), 8, size, 1, 0, out + tiff_bytes, -1, *[-1] * 8, flavour])
        pieces.append(raw)
        at += len(raw)
        tiff_bytes += size
    if at >= 2 ** 31 or out + tiff_bytes >= 2 ** 31:
        raise ValueError("LZW batch too large for one launch")
    data = np.frombuffer(b"".join(pieces) or b"\0", np.uint8)
    return GifBatch(torch.from_numpy(data.copy()),
                    torch.from_numpy(np.asarray(rows, np.int64).astype(np.int32).reshape(-1, GIF_INTS)),
                    out + tiff_bytes, tiff_bytes)


# ---------------------------------------------------------------------------- TIFF
# cv2 5.0 reads a TIFF's first directory through libtiff 4.7's RGBA interface
# (grfmt_tiff.cpp: TIFFRGBAImageOK, then TIFFReadRGBAStrip / TIFFReadRGBATile a strip or
# tile at a time, tif_getimage.c's put routines, then its own Orientation transform).
# The host here walks the directory, checks it as cv2 and libtiff do, cuts the image
# into chunks (a strip or a tile of one plane) and inflates or unpacks the Deflate,
# PackBits and uncompressed ones; LZW chunks go to K9 (its TIFF flavour), K10 undoes the
# horizontal predictor and the byte swap in place, and K8 reads every sample through its
# chunk and turns the samples into RGB by libtiff's put routine.
TIFF_MAGICS = {b"II*\0": ("<", False), b"MM\0*": (">", False), b"II+\0": ("<", True), b"MM\0+": (">", True)}
_TIFF_TYPES = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 16: "Q", 17: "q"}  # the integer types
TIFF_NONE, TIFF_LZW, TIFF_DEFLATE, TIFF_ADOBE_DEFLATE, TIFF_PACKBITS, TIFF_JPEG = 1, 5, 8, 32946, 32773, 7
_TIFF_COMPRESSIONS = (TIFF_NONE, TIFF_LZW, TIFF_DEFLATE, TIFF_ADOBE_DEFLATE, TIFF_PACKBITS, TIFF_JPEG)
# What cv2 5.0 makes of every other compression code (the committed probe of each code
# 0-65535 on several kinds of image: data/tiff_compressions.json, written by
# tools/make_image_fixtures.py). A codec that cv2's libtiff lacks (not configured) fails
# TIFFRGBAImageOK, and one whose setup refuses the samples fails the first read of a chunk:
# cv2 returns None. A code no codec claims passes both, decodes no chunk, and libtiff's put
# routine reads the zero samples it allocated.
_TIFF_NONE_CODECS = {6: "old-style JPEG", 32766: "NeXT", 32909: "PixarLog", 34661: "JBIG", 34887: "LERC",
                     34925: "LZMA", 50000: "ZSTD", 50001: "WebP"}
# codecs cv2 decodes on some samples (None elsewhere): the CCITT codecs on 1-bit samples and
# ThunderScan on 4-bit ones (K11), SGILog on LogL and LogLuv (K12 for its run-length
# planes; SGILog24's raw pixels on the host)
TIFF_CCITT = {2: "CCITT modified Huffman", 3: "CCITT Group 3", 4: "CCITT Group 4", 32771: "CCITT RLEW"}
TIFF_THUNDERSCAN = 32809
TIFF_SGILOG, TIFF_SGILOG24 = 34676, 34677
_TIFF_SOME = {**TIFF_CCITT, TIFF_THUNDERSCAN: "ThunderScan", TIFF_SGILOG: "SGILog", TIFF_SGILOG24: "SGILog24"}
_TIFF_UNCLAIMED = {0: "compression 0", 9: "JBIG T.85", 10: "JBIG T.43", 32895: "IT8CTPAD", 32896: "IT8LW",
                   32897: "IT8MP", 32898: "IT8BL", 32908: "PixarFilm", 34712: "JPEG 2000", 50002: "JPEG XL"}
TIFF_LOGL, TIFF_LOGLUV = 32844, 32845


def tiff_compression_outcome(compression: int, bits: int, photometric: int) -> Tuple[str, str]:
    """What cv2 5.0 makes of a TIFF's compression code, for samples it otherwise reads:
    ("decode", name) for this decoder's codecs (the CCITT codecs on 1-bit samples,
    ThunderScan on 4-bit ones and SGILog on LogL and LogLuv among them), ("none", name)
    where cv2 returns None, ("zero", name) for a code no codec claims (every chunk reads as
    zero samples). A LogL or LogLuv image is "none" but for SGILog."""
    if photometric in (TIFF_LOGL, TIFF_LOGLUV) and compression not in (TIFF_SGILOG, TIFF_SGILOG24):
        return "none", "LogL or LogLuv without SGILog"  # libtiff reads them through SGILog only
    if compression in _TIFF_COMPRESSIONS:
        return "decode", {TIFF_NONE: "no compression", TIFF_LZW: "LZW", TIFF_DEFLATE: "Deflate",
                          TIFF_ADOBE_DEFLATE: "Deflate", TIFF_PACKBITS: "PackBits", TIFF_JPEG: "JPEG"}[compression]
    if compression in _TIFF_NONE_CODECS:
        return "none", _TIFF_NONE_CODECS[compression]
    if compression in _TIFF_SOME:
        name = _TIFF_SOME[compression]
        takes = (bits == 1 if compression in TIFF_CCITT else bits == 4 if compression == TIFF_THUNDERSCAN else
                 photometric == TIFF_LOGLUV or (photometric == TIFF_LOGL and compression == TIFF_SGILOG))
        return ("decode" if takes else "none"), name
    return "zero", _TIFF_UNCLAIMED.get(compression, f"compression {compression}")
# K8's view of a TIFF's samples (codec.RawImage.fmt): through a 256-entry table (gray
# contig, palette: libtiff's BWmap and PALmap), as RGB (RGB, and gray planes, which
# tif_getimage.c treats as RGB), as CMYK, as YCbCr (TIFFYCbCrtoRGB through the tables of
# TIFFYCbCrToRGBInit, contiguous samples in their subsampled data units) or as CIELab
# (TIFFCIELabToXYZ, then TIFFXYZToRGB through the tables of TIFFCIELabToRGBInit)
TIFF_LUT_FORMAT, TIFF_RGB_FORMAT, TIFF_CMYK_FORMAT, TIFF_YCBCR_FORMAT, TIFF_LAB_FORMAT = 15, 16, 17, 18, 19
# SGILog as libtiff's RGBA interface reads it (SGILOGDATAFMT_8BIT: tif_luv.c's L16toGry,
# Luv32toRGB, Luv24toRGB): K8 turns each pixel's word into bytes, LogL's 16 bits and
# LogLuv's 32 as K12 decoded them (little-endian), SGILog24's 3 raw bytes as stored
TIFF_LOGL_FORMAT, TIFF_LOGLUV_FORMAT, TIFF_LOGLUV24_FORMAT = 20, 21, 22
SGILOG_WORD = {TIFF_LOGL_FORMAT: 2, TIFF_LOGLUV_FORMAT: 4, TIFF_LOGLUV24_FORMAT: 3}
# One chunk (a strip or a tile of one plane) as K10 and K8 read it: [byte of its decoded
# rows in the batch's byte buffer (or, for a JPEG chunk, of its frame in the JPEG kernels'
# output), 1 for a JPEG chunk, bytes from one row of pixels to the next as libtiff's put
# routine reads them (a decoded row's bytes, but where it skews a tile cut at the image's
# right edge: see _tile_pitch; a YCbCr data-unit row's), rows it holds (0: a later
# plane's chunk libtiff could not read, zero samples), bytes a row holds (a JPEG chunk's
# frame may be smaller than its chunk: what it lacks reads as zero, as libtiff leaves
# it), then K10's view: rows the predictor walks, bytes a row, pixels a row, samples a
# pixel, predictor (0, or the bits a sample: 8, 16), 1 to swap 16-bit samples' bytes (a
# big-endian file), its K9 stream (-1: none; a stream whose status is not OK skips the
# predictor and the swap, as libtiff does after a decoding error)].
TIFF_CHUNK_INTS = 12
(C_SRC, C_JPEG, C_PITCH, C_ROWS_HELD, C_BYTES_HELD, C_ROWS, C_ROW_BYTES, C_WIDTH, C_SAMPLES, C_PREDICTOR, C_SWAB,
 C_STREAM) = range(TIFF_CHUNK_INTS)
# K9's flavours (GIF_INTS row, field 16): GIF, a TIFF's LZWDecode, its LZWDecodeCompat (old-style codes)
LZW_GIF, LZW_TIFF, LZW_TIFF_OLD = 0, 1, 2
# K11's flavours (csrc/ccitt_decode.cu enum Mode): tif_fax3.c's Fax3DecodeRLE byte-aligned
# (compression 2) and word-aligned (32771), Fax3Decode1D and Fax3Decode2D (3, T4Options bit
# 0), Fax4Decode (4); tif_thunder.c's ThunderDecodeRow (32809)
FAX_RLE, FAX_RLEW, FAX_G3_1D, FAX_G3_2D, FAX_G4, FAX_THUNDER = range(6)
# One K11 stream, a CCITT or ThunderScan chunk (csrc/ccitt_decode.cu enum Stream): [byte of
# its coded data in the call's buffer (16-byte aligned: the kernel stages it with
# cp.async), coded bytes, flavour, rows, pixels a row, bytes a row, byte of its decoded
# rows in the buffer, 1 where its first byte lies at an odd address in the file (RLEW's
# word alignment reads it), its first int in the run scratch (fax_area ints: where it
# saves its run arrays), the stream of its image's first chunk, its image's chunks
# (libtiff's CCITT decoder keeps its run arrays and FAXMODE_NOEOL from one chunk to the
# next: the kernel decodes each chunk from a guess of them and repairs from the first
# chunk whose guess failed, ops/fax_schedule_model.py)]
FAX_INTS = 11
F_SRC, F_BYTES, F_MODE, F_ROWS, F_WIDTH, F_ROW_BYTES, F_OUT, F_ODD, F_RUNS, F_FIRST, F_CHUNKS = range(FAX_INTS)
# One chunk's record, which K11 writes (csrc/ccitt_decode.cu enum Record): flags (FAX_FOREIGN:
# its guess read a run-array entry it had not written; FAX_NOEOL: it leaves FAXMODE_NOEOL
# on), the high-water marks of its two run arrays, and on an image's first chunk the
# count of its chunks done and the chunk (1-based, 0 none) its repair started from
FAX_RECORD_INTS = 5
FR_FLAGS, FR_HIGH0, FR_HIGH1, FR_DONE, FR_REPAIR_FROM = range(FAX_RECORD_INTS)
FAX_FOREIGN, FAX_NOEOL = 1, 2
# One K12 stream, an SGILog chunk (csrc/sgilog_decode.cu enum Stream): [byte of its coded
# data in the call's buffer, coded bytes, bytes a decoded word (2: LogL's 16 bits, 4:
# LogLuv's 32), rows, pixels a row, byte of its decoded words in the buffer]
SGI_INTS = 6
G_SRC, G_BYTES, G_WORD, G_ROWS, G_WIDTH, G_OUT = range(SGI_INTS)
TIFF_LZW_CLEAR, TIFF_LZW_EOI = 256, 257


@dataclasses.dataclass
class TiffChunk:
    """A strip or a tile of one plane: its stored bytes (fill order undone) and where its
    decoded rows go. `decoded` holds the host's decode (None for an LZW chunk: K9's)."""

    raw: bytes
    rows: int  # rows the decoder fills (a YCbCr chunk's: scanlines, as libtiff's predictor walks them)
    row_bytes: int
    width: int  # pixels a decoded row (as the predictor walks them)
    y0: int
    byte0: int  # the byte of its first column in an image row
    plane: int
    placed_rows: int
    placed_bytes: int
    pitch: int  # bytes from one row of pixels to the next as the put routine reads them
    decoded: Optional[bytes] = None
    ok: bool = True  # the host's decode filled the chunk (else no predictor and no swap)
    jpeg: Optional[JpegImage] = None  # a JPEG-in-TIFF chunk's abbreviated stream, tables loaded
    missing: bool = False  # a later plane's chunk libtiff reads without checking: zero samples
    lzw: int = LZW_TIFF  # an LZW chunk's K9 flavour (LZW_TIFF_OLD: the file's first chunk is old-style)
    fax: int = -1  # a CCITT or ThunderScan chunk's K11 flavour (FAX_*), -1 none
    sgi: int = 0  # an SGILog chunk's word bytes where K12 decodes it (2: LogL, 4: LogLuv), 0 none
    odd: int = 0  # 1 where its first byte lies at an odd offset in the file

    @property
    def size(self) -> int:
        """The bytes the decoder fills."""
        return self.rows * self.row_bytes


@dataclasses.dataclass
class TiffImage:
    height: int
    width: int
    orientation: int
    bits: int
    samples: int  # a pixel of a decoded row: SamplesPerPixel, 1 for separate planes
    planes: int  # planes read
    predictor: int  # 0, or the bits of a sample the horizontal predictor adds
    swab: bool
    fmt: int
    colour_channels: int
    alpha: int  # the sample libtiff premultiplies by (unassociated alpha), -1 none
    palette: np.ndarray
    chunks: List[TiffChunk]  # plane by plane, each plane's chunks row-major
    mirror: int = 0  # the width of the tiles whose shown columns libtiff mirrors (0: none)
    chunk_hw: Tuple[int, int] = (0, 0)  # rows and pixels a chunk covers (a strip's rows and the width, or a tile)
    subsampling: Tuple[int, int] = (1, 1)  # YCbCr's data unit (horizontal, vertical)
    # the conversion's tables: ("ycbcr", YCbCrCoefficients, ReferenceBlackWhite) or ("lab", WhitePoint)
    tables: Optional[tuple] = None

    @property
    def across(self) -> int:
        """Chunks a row of chunks."""
        return -(-self.width // self.chunk_hw[1])

    @property
    def per_plane(self) -> int:
        return len(self.chunks) // self.planes

    def raw(self) -> RawImage:
        """K8's view of the image: the samples read through its chunks (K10 has undone the
        predictor and the byte swap in place)."""
        return RawImage(self.height, self.width, self.fmt, b"", 0, self.chunk_hw[0], channels=self.samples,
                        maxval=self.bits, palette=self.palette, orientation=self.orientation,
                        colour_channels=self.colour_channels, alpha=self.alpha, planar=int(self.planes > 1),
                        mirror=self.mirror)


def _tiff_values(data: bytes, order: str, big: bool, entry: Tuple[int, int, int]) -> List[int]:
    typ, count, field = entry
    if typ not in _TIFF_TYPES or count > len(data):
        raise ValueError(f"corrupt TIFF: a field of type {typ} and count {count}")
    size = struct.calcsize(_TIFF_TYPES[typ]) * count
    at = field if size <= (8 if big else 4) else struct.unpack_from(order + ("Q" if big else "I"), data, field)[0]
    if at + size > len(data):
        raise ValueError("corrupt TIFF: a field's values run past the data")
    return list(struct.unpack_from(order + _TIFF_TYPES[typ] * count, data, at))


_TIFF_FLOAT_TYPES = {5: "II", 10: "ii", 11: "f", 12: "d"}  # RATIONAL, SRATIONAL, FLOAT, DOUBLE


def _tiff_floats(data: bytes, order: str, big: bool, entry: Tuple[int, int, int]) -> List[np.float32]:
    """A RATIONAL, SRATIONAL, FLOAT or DOUBLE field as libtiff reads it into floats: a
    rational as float32(numerator) / float32(denominator), 0 for a zero denominator."""
    typ, count, field = entry
    if typ not in _TIFF_FLOAT_TYPES or count > len(data):
        raise ValueError(f"corrupt TIFF: a field of type {typ} and count {count} where floats belong")
    size = struct.calcsize(_TIFF_FLOAT_TYPES[typ]) * count
    at = field if size <= (8 if big else 4) else struct.unpack_from(order + ("Q" if big else "I"), data, field)[0]
    if at + size > len(data):
        raise ValueError("corrupt TIFF: a field's values run past the data")
    v = struct.unpack_from(order + _TIFF_FLOAT_TYPES[typ] * count, data, at)
    if typ in (5, 10):
        return [np.float32(n) / np.float32(d) if d else np.float32(0) for n, d in zip(v[::2], v[1::2])]
    return [np.float32(x) for x in v]


# tif_aux.c's defaults: CCIR 601-1 luma; a YCbCr image's ReferenceBlackWhite; CIE D50
TIFF_LUMA = (np.float32(0.299), np.float32(0.587), np.float32(0.114))
TIFF_YCBCR_REFERENCE = tuple(np.float32(v) for v in (0, 255, 128, 255, 128, 255))
_D50 = (np.float32(96.4250), np.float32(100.0), np.float32(82.4680))
TIFF_D50_WHITE = (_D50[0] / (_D50[0] + _D50[1] + _D50[2]), _D50[1] / (_D50[0] + _D50[1] + _D50[2]))
YCBCR_TABLE_INTS = 5 * 256
# tif_getimage.c display_sRGB: the XYZ -> luminance matrix, light output for reference
# white, pixel values for it, residual light for black, the guns' gamma
_SRGB_MATRIX = ((3.2410, -1.5374, -0.4986), (-0.9692, 1.8760, 0.0416), (0.0556, -0.2040, 1.0570))
_SRGB_YC, _SRGB_VRW, _SRGB_Y0, _SRGB_GAMMA = 100.0, 255, 1.0, 2.4
LAB_RANGE = 1500  # tif_color.h CIELABTORGB_TABLE_RANGE
LAB_HEADER = 24  # floats before the three tables: X0, Y0, Z0, then a gun's matrix row, Y0, YC, step, Vrw each
LAB_TABLE_INTS = LAB_HEADER + 3 * (LAB_RANGE + 1)


def _fix(x: np.float32) -> int:
    """tif_color.c FIX: (int32_t)(x * (1L << 16) + 0.5), the product in float."""
    return int(np.float64(np.float32(x) * np.float32(65536)) + 0.5)


def _clampw(v: np.float32, lo: float, hi: float) -> np.float32:
    return np.float32(lo) if v < np.float32(lo) else np.float32(hi) if v > np.float32(hi) else v


def _code2v(c: int, rb: np.float32, rw: np.float32, cr: int) -> np.float32:
    """tif_color.c Code2V in float: (c - (int32)RB) * CR / (RW - RB, 1 where that is 0)."""
    den = np.float32(rw - rb)
    return np.float32(np.float32(np.float32(c - int(rb)) * np.float32(cr)) / (den if den != 0 else np.float32(1)))


def ycbcr_tables(luma: Sequence[np.float32], reference: Sequence[np.float32]) -> np.ndarray:
    """TIFFYCbCrToRGBInit's tables, step by step in its float and integer arithmetic: int32
    (5, 256) Cr_r, Cb_b, Cr_g, Cb_g and Y, as TIFFYCbCrtoRGB indexes them."""
    red, green, blue = (np.float32(v) for v in luma)
    rbw = [np.float32(v) for v in reference]
    f1 = np.float32(2) - np.float32(2) * red
    d1 = _fix(min(max(f1, np.float32(0)), np.float32(2)))
    f2 = np.float32(red * f1) / green
    d2 = -_fix(min(max(f2, np.float32(0)), np.float32(2)))
    f3 = np.float32(2) - np.float32(2) * blue
    d3 = _fix(min(max(f3, np.float32(0)), np.float32(2)))
    f4 = np.float32(blue * f3) / green
    d4 = -_fix(min(max(f4, np.float32(0)), np.float32(2)))
    t = np.zeros((5, 256), np.int64)
    half = np.float32(128)
    for i in range(256):
        cr = int(_clampw(_code2v(i - 128, rbw[4] - half, rbw[5] - half, 127), -4096.0, 4096.0))
        cb = int(_clampw(_code2v(i - 128, rbw[2] - half, rbw[3] - half, 127), -4096.0, 4096.0))
        t[:, i] = ((d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16, d2 * cr, d4 * cb + 32768,
                   int(_clampw(_code2v(i, rbw[0], rbw[1], 255), -4096.0, 4096.0)))
    return t.astype(np.int32)


def lab_tables(white: Sequence[np.float32]) -> np.ndarray:
    """initCIELabConversion and TIFFCIELabToRGBInit for libtiff's sRGB display, in float:
    float32 (LAB_TABLE_INTS,) [X0, Y0, Z0 of the reference white; for each gun its matrix
    row, residual light for black, light for reference white, table step and pixel value
    for reference white; then each gun's LAB_RANGE + 1 entries of Yr2r, Yg2g, Yb2b]."""
    w0, w1 = np.float32(white[0]), np.float32(white[1])
    head = [np.float32(w0 / w1) * np.float32(100), np.float32(100),
            np.float32(np.float32(np.float32(1) - w0) - w1) / w1 * np.float32(100)]
    tables = []
    for row in _SRGB_MATRIX:
        step = np.float32(np.float32(_SRGB_YC) - np.float32(_SRGB_Y0)) / np.float32(LAB_RANGE)
        head += [*(np.float32(m) for m in row), np.float32(_SRGB_Y0), np.float32(_SRGB_YC), step,
                 np.float32(_SRGB_VRW)]
        gamma = 1.0 / np.float64(np.float32(_SRGB_GAMMA))
        tables.append([np.float32(_SRGB_VRW) * np.float32(np.power(i / LAB_RANGE, gamma))
                       for i in range(LAB_RANGE + 1)])
    return np.asarray(head + [v for t in tables for v in t], np.float32)


# tif_luv.c's SGILog decoding (libtiff 4.7): UVSCALE, and uvcode.h's (u', v') grid for
# LogLuv24's 14-bit colour index, uv_row: each row's first u' (a float), its squares, the
# squares before it
SGILOG_UVSCALE = 410.0
SGILOG_U_NEU, SGILOG_V_NEU = 0.210526316, 0.473684211
SGILOG_UV_SQSIZ, SGILOG_UV_VSTART, SGILOG_UV_NDIVS = np.float32(0.0035), np.float32(0.016940), 16289
_SGILOG_UV_ROW = (
    (0.247663, 4, 0), (0.243779, 6, 4), (0.241684, 7, 10), (0.237874, 9, 17), (0.235906, 10, 26),
    (0.232153, 12, 36), (0.228352, 14, 48), (0.226259, 15, 62), (0.222371, 17, 77), (0.22041, 18, 94),
    (0.21471, 21, 112), (0.212714, 22, 133), (0.210721, 23, 155), (0.204976, 26, 178), (0.202986, 27, 204),
    (0.199245, 29, 231), (0.195525, 31, 260), (0.19356, 32, 291), (0.189878, 34, 323), (0.186216, 36, 357),
    (0.186216, 36, 393), (0.182592, 38, 429), (0.179003, 40, 467), (0.175466, 42, 507), (0.172001, 44, 549),
    (0.172001, 44, 593), (0.168612, 46, 637), (0.168612, 46, 683), (0.163575, 49, 729), (0.158642, 52, 778),
    (0.158642, 52, 830), (0.158642, 52, 882), (0.153815, 55, 934), (0.153815, 55, 989), (0.149097, 58, 1044),
    (0.149097, 58, 1102), (0.142746, 62, 1160), (0.142746, 62, 1222), (0.142746, 62, 1284), (0.13827, 65, 1346),
    (0.13827, 65, 1411), (0.13827, 65, 1476), (0.132166, 69, 1541), (0.132166, 69, 1610), (0.126204, 73, 1679),
    (0.126204, 73, 1752), (0.126204, 73, 1825), (0.120381, 77, 1898), (0.120381, 77, 1975), (0.120381, 77, 2052),
    (0.120381, 77, 2129), (0.112962, 82, 2206), (0.112962, 82, 2288), (0.112962, 82, 2370), (0.10745, 86, 2452),
    (0.10745, 86, 2538), (0.10745, 86, 2624), (0.10745, 86, 2710), (0.100343, 91, 2796), (0.100343, 91, 2887),
    (0.100343, 91, 2978), (0.095126, 95, 3069), (0.095126, 95, 3164), (0.095126, 95, 3259), (0.095126, 95, 3354),
    (0.088276, 100, 3449), (0.088276, 100, 3549), (0.088276, 100, 3649), (0.088276, 100, 3749),
    (0.081523, 105, 3849), (0.081523, 105, 3954), (0.081523, 105, 4059), (0.081523, 105, 4164),
    (0.074861, 110, 4269), (0.074861, 110, 4379), (0.074861, 110, 4489), (0.074861, 110, 4599),
    (0.06829, 115, 4709), (0.06829, 115, 4824), (0.06829, 115, 4939), (0.06829, 115, 5054), (0.063573, 119, 5169),
    (0.063573, 119, 5288), (0.063573, 119, 5407), (0.063573, 119, 5526), (0.057219, 124, 5645),
    (0.057219, 124, 5769), (0.057219, 124, 5893), (0.057219, 124, 6017), (0.050985, 129, 6141),
    (0.050985, 129, 6270), (0.050985, 129, 6399), (0.050985, 129, 6528), (0.050985, 129, 6657),
    (0.044859, 134, 6786), (0.044859, 134, 6920), (0.044859, 134, 7054), (0.044859, 134, 7188),
    (0.040571, 138, 7322), (0.040571, 138, 7460), (0.040571, 138, 7598), (0.040571, 138, 7736),
    (0.036339, 142, 7874), (0.036339, 142, 8016), (0.036339, 142, 8158), (0.036339, 142, 8300),
    (0.032139, 146, 8442), (0.032139, 146, 8588), (0.032139, 146, 8734), (0.032139, 146, 8880),
    (0.027947, 150, 9026), (0.027947, 150, 9176), (0.027947, 150, 9326), (0.023739, 154, 9476),
    (0.023739, 154, 9630), (0.023739, 154, 9784), (0.023739, 154, 9938), (0.019504, 158, 10092),
    (0.019504, 158, 10250), (0.019504, 158, 10408), (0.016976, 161, 10566), (0.016976, 161, 10727),
    (0.016976, 161, 10888), (0.016976, 161, 11049), (0.012639, 165, 11210), (0.012639, 165, 11375),
    (0.012639, 165, 11540), (0.009991, 168, 11705), (0.009991, 168, 11873), (0.009991, 168, 12041),
    (0.009016, 170, 12209), (0.009016, 170, 12379), (0.009016, 170, 12549), (0.006217, 173, 12719),
    (0.006217, 173, 12892), (0.005097, 175, 13065), (0.005097, 175, 13240), (0.005097, 175, 13415),
    (0.003909, 177, 13590), (0.003909, 177, 13767), (0.00234, 177, 13944), (0.002389, 170, 14121),
    (0.001068, 164, 14291), (0.001653, 157, 14455), (0.000717, 150, 14612), (0.001614, 143, 14762),
    (0.00027, 136, 14905), (0.000484, 129, 15041), (0.001103, 123, 15170), (0.001242, 115, 15293),
    (0.001188, 109, 15408), (0.001011, 103, 15517), (0.000709, 97, 15620), (0.000301, 89, 15717),
    (0.002416, 82, 15806), (0.003251, 76, 15888), (0.003246, 69, 15964), (0.004141, 62, 16033),
    (0.005963, 55, 16095), (0.008839, 47, 16150), (0.01049, 40, 16197), (0.016994, 31, 16237),
    (0.023659, 21, 16268),)
SGILOG_TABLE_INTS = 2 * (32768 + 1024) + 2 * len(_SGILOG_UV_ROW)


@functools.lru_cache(maxsize=None)
def sgilog_tables() -> np.ndarray:
    """K8's SGILog tables as int32 (doubles as two ints each): tif_luv.c's LogL16toY of
    each 15-bit magnitude (32,768 doubles) and LogL10toY of each 10-bit L (1,024 doubles),
    computed with the C library's exp (math.exp, not numpy's, which may differ in the last
    place), then uv_row's first u' (float32 bits) and squares before it, a pair a row."""
    ln2 = math.log(2.0)  # M_LN2
    y16 = np.array([0.0] + [math.exp(ln2 / 256. * (le + .5) - ln2 * 64.) for le in range(1, 32768)])
    y10 = np.array([0.0] + [math.exp(ln2 / 64. * (p + .5) - ln2 * 12.) for p in range(1, 1024)])
    uv = np.array([(np.float32(u).view(np.int32), cum) for u, _, cum in _SGILOG_UV_ROW], np.int32)
    return np.concatenate([y16.view(np.int32), y10.view(np.int32), uv.reshape(-1)])


_BIT_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))  # FillOrder 2: each byte's bits reversed


def packbits_decode(raw: bytes, size: int) -> Tuple[bytes, bool]:
    """libtiff's PackBitsDecode into `size` bytes: (the bytes, the rest zero where the data
    ran short, and whether it filled them). Walks the run headers in Python."""
    out, i, n = bytearray(), 0, len(raw)
    while i < n and len(out) < size:
        h = raw[i]
        i += 1
        if h == 128:
            continue
        if h > 128:  # a run of 257 - h copies of the next byte
            run = min(257 - h, size - len(out))
            if i >= n:
                break
            out += raw[i:i + 1] * run
            i += 1
        else:  # h + 1 literal bytes
            count = min(h + 1, size - len(out))
            if n - i < count:
                break
            out += raw[i:i + count]
            i += count
    return bytes(out) + bytes(size - len(out)), len(out) == size


def inflate(raw: bytes, size: int) -> Tuple[bytes, bool]:
    """libtiff's ZIPDecode into `size` bytes: (what zlib gave before the data ended or
    failed, the rest zero, and whether it filled them)."""
    d = zlib.decompressobj()
    try:
        out = d.decompress(raw, size)
    except zlib.error:  # what came before the fault: a byte at a time
        d, out = zlib.decompressobj(), b""
        for i in range(len(raw)):
            try:
                out += d.decompress(raw[i:i + 1], size - len(out))
            except zlib.error:
                break
            if len(out) == size:
                break
    return out + bytes(size - len(out)), len(out) == size


def _tile_pitch(fmt: int, bits: int, spp: int, planar: int, tile_width: int, shown: int) -> int:
    """The bytes from one row to the next that libtiff's put routine reads in a tile cut at
    the image's right edge (`shown` of its `tile_width` pixels in the image): it steps
    over the tile's hidden pixels (fromskew) counted in samples where it should count
    pixels for gray and 8-bit palette samples of several samples a pixel (putgreytile,
    putagreytile, put8bitcmaptile), and in bytes for 16-bit gray (put16bitbwtile)."""
    hidden = tile_width - shown
    if fmt != TIFF_LUT_FORMAT or planar != 1:
        return -(-tile_width * (spp if planar == 1 else 1) * bits // 8)
    if bits < 8:  # whole bytes a row, then the hidden pixels' whole bytes
        return -(-shown * bits // 8) + hidden * bits // 8
    return shown * spp * bits // 8 + hidden


def _ycbcr_units(cols: int, sub: Tuple[int, int]) -> Tuple[int, int]:
    """(bytes of a row of YCbCr data units, bytes of a scanline: TIFFScanlineSize's share
    of a unit row) across `cols` pixels of 8-bit contiguous samples."""
    hs, vs = sub
    unit_row = -(-cols // hs) * (hs * vs + 2)
    return unit_row, unit_row // vs


def _tiff_layout(tags: dict, get, one, data: bytes, height: int, width: int, spp: int, bits: int, planar: int,
                 compression: int, read_planes: List[int], fmt: int, sub: Tuple[int, int] = (1, 1),
                 from_file: bool = False) -> Tuple[List[TiffChunk], Tuple[int, int]]:
    """The chunks of the planes read (a later plane's unreadable chunk kept as `missing`),
    and the rows and pixels a chunk covers.
    ValueError where libtiff fails to read the directory or cv2's first read of a plane's
    chunk. `sub`: a YCbCr image's subsampling (its contiguous samples come in data units
    of sub[0] x sub[1] Y samples, then Cb and Cr). `from_file`: the bytes are a file's, which
    cv2.imread has libtiff map into memory (a chunk's first byte then lies at the parity of
    its offset; cv2.imdecode's chunks are read into buffers of their own)."""
    samples = spp if planar == 1 else 1
    stride = -(-width * samples * bits // 8)
    nplanes = spp if planar == 2 else 1
    tiled = 322 in tags or 323 in tags
    units = fmt == TIFF_YCBCR_FORMAT and planar == 1
    if tiled:
        tw, th = one(322, 0), one(323, 0)
        if tw < 1 or th < 1:
            raise ValueError("corrupt TIFF: tile width or length of 0")
        if tw * samples * bits % 8:
            raise UnsupportedImage(f"TIFF tiles {tw} pixels wide at {samples * bits} bits a pixel "
                                   f"(not a whole number of bytes; {_READ})")
        boxes = [(y, x, th, tw) for y in range(0, height, th) for x in range(0, width, tw)]
        off_tag, count_tag = 324, 325
        chunk_hw = (th, tw)
    else:
        rps = min(one(278, 2 ** 32 - 1) or height, height)
        boxes = [(y, 0, min(rps, height - y), width) for y in range(0, height, rps)]
        off_tag, count_tag = 273, 279
        chunk_hw = (rps, width)
    scanline = stride  # TIFFScanlineSize, which libtiff's byte count estimates take
    if units:
        unit_row, scanline = _ycbcr_units(width, sub)
        if _ycbcr_units(chunk_hw[1], sub)[0] % sub[1]:  # libtiff reads a strip's last bytes from memory it never wrote
            raise UnsupportedImage(f"YCbCr TIFF of {sub[0]} x {sub[1]} data units whose row of units is no whole "
                                   f"number of scanlines (cv2 reads bytes past what it decoded; {_READ})")
        stride = unit_row
    per_plane = len(boxes)
    total = per_plane * nplanes
    offsets = get(off_tag)
    if offsets is None:
        raise ValueError("corrupt TIFF: no chunk offsets")
    counts = get(count_tag)
    if counts is None and (total > 1 or tiled):
        raise ValueError("corrupt TIFF: no chunk byte counts")
    # libtiff pads short offset and count arrays with zeros (an unreadable chunk)
    offsets = list(offsets[:total]) + [0] * (total - len(offsets))
    counts = list((counts or [0])[:total]) + [0] * (total - len(counts or [0]))
    if total == 1 and not tiled:  # libtiff estimates a single strip's bogus byte count
        need = scanline * height
        c, o = counts[0], offsets[0]
        if (c == 0 and o != 0) or count_tag not in tags or (compression == TIFF_NONE and (
                (o <= len(data) and c > len(data) - o) or c < need)):
            counts[0] = need if compression == TIFF_NONE else max(0, len(data) - o)
    tile_size = -(-chunk_hw[0] // sub[1]) * _ycbcr_units(chunk_hw[1], sub)[0] if units else \
        chunk_hw[0] * -(-chunk_hw[1] * samples * bits // 8)  # TIFFTileSize
    if (total == 1 and not tiled) or one(284, 1) != 1 or total <= 2 or compression != TIFF_NONE:
        pass
    elif counts[0] != counts[1] and counts[0] and counts[1]:  # uncompressed, contiguous, the first two counts differ:
        # libtiff estimates every count (EstimateStripByteCounts), a tile's its size
        counts = [tile_size if tiled else scanline * (height // total)] * total
    reverse = one(266, 1) == 2 and compression != TIFF_JPEG  # libtiff's JPEG codec sets TIFF_NOBITREV
    if tiled and compression == TIFF_NONE:
        _tiled_none_reads(offsets, counts, per_plane, read_planes, tile_size, from_file and not reverse, len(data))
    chunks = []
    for plane in read_planes:
        for i, (y0, x0, rows, cols) in enumerate(boxes):
            k = plane * per_plane + i
            o, c = offsets[k], counts[k]
            placed_rows = min(rows, height - y0)
            if c == 0 or o + c > len(data):
                if plane == read_planes[0]:
                    raise ValueError("corrupt TIFF: a chunk's bytes lie past the data")
                # libtiff reads the later planes without checking: the chunk reads as zero
                chunks.append(TiffChunk(b"", 0, 0, cols, y0, 0, plane, 0, 0, 0, b"", False, missing=True))
                continue
            raw = data[o:o + c]
            if units:  # rows of data units, read a unit row at a time
                unit_row, scanline = _ycbcr_units(cols, sub)
                shown = min(cols, width - x0)
                pitch = unit_row if shown == cols else (-(-shown // sub[0]) * (sub[0] * sub[1] + 2) + (cols - shown)
                                                        // sub[0] * (10 if sub == (4, 4) else sub[0] * sub[1] + 2))
                # putcontig8bitYCbCr44tile skips a cut tile's hidden units as 10 bytes each. The
                # predictor walks rows of TIFFScanlineSize (a unit row / vs) or, in a tile, of
                # TIFFTileRowSize (which ignores the subsampling), 3 samples a pixel; where
                # the chunk is no whole number of them (or a row no whole number of pixels)
                # horAcc8 fails and the chunk reads as decoded: rows of no pixels here
                size, line = -(-rows // sub[1]) * unit_row, cols * 3 if tiled else scanline
                walks = size % line == 0 and line % 3 == 0
                chunks.append(TiffChunk(raw, size // line if walks else 1, line if walks else size,
                                        line // 3 if walks else 0, y0, 0, plane, placed_rows, unit_row, pitch))
                continue
            row_bytes = -(-cols * samples * bits // 8)
            byte0 = x0 * samples * bits // 8
            pitch = row_bytes if x0 + cols <= width else _tile_pitch(fmt, bits, spp, planar, cols, width - x0)
            chunks.append(TiffChunk(raw.translate(_BIT_REVERSED) if reverse else raw, rows, row_bytes, cols, y0,
                                    byte0, plane, placed_rows, min(row_bytes, stride - byte0), pitch,
                                    odd=o & 1 if from_file else 0))
    return chunks, chunk_hw


def _tiled_none_reads(offsets: List[int], counts: List[int], per_plane: int, planes: List[int], tile_size: int,
                      mapped: bool, n: int) -> None:
    """ValueError where cv2 returns None for an uncompressed tiled TIFF. cv2 reads each tile
    through TIFFReadRGBATile, whose first read of a tile (of its first plane) goes through
    libtiff 4.7's _TIFFReadEncodedTileAndAllocBuffer, which fails an uncompressed tile
    unless libtiff's raw buffer is exactly TIFFTileSize bytes. A file that cv2.imread maps
    (FillOrder 1) points the buffer at the tile's own bytes: its byte count must be the
    tile size. Bytes (cv2.imdecode), or a file whose bits are reversed, are read into
    libtiff's own buffer, which grows to the next multiple of 1,024 bytes of the largest
    byte count read so far (a later plane's too): that must be the tile size. A tile that
    passes with fewer bytes than its size reads as zero (its decode fails after the buffer
    was zeroed, and cv2 goes on: TiffChunk.ok). Pinned by probes of cv2 5.0.0 and by the
    fixtures tiff_tiles_*."""
    size = 0
    for i in range(per_plane):
        for j, plane in enumerate(planes):
            k = plane * per_plane + i
            count = counts[k]
            if count == 0:  # TIFFFillTile fails before it reads (the first plane's raises below)
                continue
            if not mapped and count > size:
                size = -(-count // 1024) * 1024
            if j == 0 and offsets[k] + count <= n and (count if mapped else size) != tile_size:
                raise ValueError(f"uncompressed tiled TIFF whose tile {i} libtiff reads into a buffer of "
                                 f"{count if mapped else size} bytes for its {tile_size} (cv2 returns None)")


def _lzw_clear(raw: bytes, old: bool) -> bool:
    """Whether an LZW chunk starts with a Clear: its first 9 bits MSB first, or LSB first
    for old-style codes."""
    return len(raw) >= 2 and (raw[0] | (raw[1] & 1) << 8 if old else raw[0] << 1 | raw[1] >> 7) == TIFF_LZW_CLEAR


def _tiff_directory(data: bytes) -> Tuple[str, bool, dict]:
    """(byte order, BigTIFF, {tag: (type, count, offset of its value field)}) of a TIFF's
    first directory, the first entry of each tag kept. ValueError where the header or the
    directory runs past the data."""
    order, big = TIFF_MAGICS[data[:4]]
    try:
        if big:
            if struct.unpack_from(order + "HH", data, 4) != (8, 0):
                raise ValueError("corrupt BigTIFF: offsets of other than 8 bytes")
            (at,) = struct.unpack_from(order + "Q", data, 8)
        else:
            (at,) = struct.unpack_from(order + "I", data, 4)
        tags = {}
        for tag, typ, count, field in _ifd(data, order, at, big):
            tags.setdefault(tag, (typ, count, field))
    except struct.error:
        raise ValueError("corrupt TIFF: the header or the first directory runs past the data") from None
    return order, big, tags


def _tiff_bytes(data: bytes, order: str, big: bool, entry: Tuple[int, int, int]) -> bytes:
    """The bytes of a BYTE or UNDEFINED field (JPEGTables)."""
    typ, count, field = entry
    if typ not in (1, 7):
        raise ValueError(f"corrupt TIFF: a byte field of type {typ}")
    at = field if count <= (8 if big else 4) else struct.unpack_from(order + ("Q" if big else "I"), data, field)[0]
    if at + count > len(data):
        raise ValueError("corrupt TIFF: a field's values run past the data")
    return data[at:at + count]


def _tiff_jpeg_chunk(raw: bytes, tables: bytes, rows: int, cols: int, spp: int,
                     ycbcr: Optional[Tuple[int, int]], last_strip: bool) -> JpegImage:
    """A JPEG-in-TIFF chunk as libtiff 4.7's JPEG codec reads it (tif_jpeg.c): tag 347's
    tables first, then the chunk's own stream, which its source manager ends with a fake
    EOI where the data runs out. The components come out as they are (JCS_UNKNOWN), or, for
    YCbCr, converted to RGB by libjpeg with its own upsampling, within the chunk. ValueError
    where JPEGPreDecode fails, which fails the chunk's first read (cv2 returns None): a
    stream libjpeg cannot start, a component count other than the samples a pixel, sampling
    factors other than YCbCrSubsampling's on the first component (1 x 1 where not YCbCr)
    and 1 x 1 on the rest, a frame wider or taller than the chunk (but for a last strip as
    wide as the image, which libtiff cuts to its rows)."""
    if raw[:2] != b"\xff\xd8":
        raise ValueError("corrupt TIFF: a JPEG chunk that does not start with SOI (cv2 returns None)")
    head = tables[:-2] if tables[-2:] == b"\xff\xd9" else tables
    if tables and head[:2] != b"\xff\xd8":
        raise ValueError("corrupt TIFF: JPEGTables that do not start with SOI (cv2 returns None)")
    im = parse_jpeg((head + raw[2:] if tables else raw) + b"\xff\xd9", raw=not ycbcr)
    if len(im.comps) != spp:
        raise ValueError(f"corrupt TIFF: a JPEG chunk of {len(im.comps)} components for {spp} samples a pixel")
    if im.sampling != [ycbcr or (1, 1)] + [(1, 1)] * (spp - 1):
        raise ValueError(f"corrupt TIFF: JPEG sampling factors {im.sampling} (libtiff wants "
                         f"{ycbcr or (1, 1)} then 1 x 1)")
    if im.width > cols or (im.height > rows and not (last_strip and im.width == cols)):
        raise ValueError(f"corrupt TIFF: a {im.width} x {im.height} JPEG in a {cols} x {rows} chunk")
    im.space = SPACE_YCC if ycbcr else SPACE_RAW
    im.orientation = 1  # the TIFF's own orientation applies, after the chunks are placed
    return im


def parse_tiff(data: bytes, from_file: bool = False) -> TiffImage:
    """A TIFF's or BigTIFF's first directory as cv2 5.0 reads it with IMREAD_COLOR through
    libtiff's RGBA interface: strips or tiles, one plane or separate ones; uncompressed,
    PackBits, Deflate (decoded here), LZW (K9), CCITT or ThunderScan (K11) or JPEG (8-bit
    samples of any photometric below, one plane or separate ones: each chunk a JPEG of the
    batch, through K1 and the fused K2 + K3, its components unconverted but for YCbCr in
    one plane, which libjpeg converts to RGB); a compression code no codec claims as zero
    samples; 1-, 4-, 8- or
    16-bit samples; gray (MinIsBlack, MinIsWhite), RGB, palette and CMYK, with or without
    extra samples (an unassociated alpha premultiplies, as libtiff does), 8-bit YCbCr
    (contiguous data units at the subsamplings libtiff's put routines take, or separate
    planes at 1 x 1; YCbCrCoefficients and ReferenceBlackWhite or their defaults) and 8-
    or 16-bit CIELab (WhitePoint or D50); the horizontal predictor; the Orientation tag as
    cv2 applies it; the CCITT codecs (modified Huffman, RLEW, Group 3 1-D and 2-D, Group
    4) on 1-bit samples and ThunderScan on 4-bit ones (K11), and old-style LZW codes (K9's
    third flavour), SGILog and SGILog24 on LogL and LogLuv (_sgilog_tiff). ValueError
    where cv2 returns None (tiff_compression_outcome's "none" codecs among them, ICCLab,
    ITULab, YCbCr or CIELab samples no put routine takes, uncompressed tiles whose bytes
    libtiff refuses: _tiled_none_reads); UnsupportedImage for what cv2 reads and this
    decoder does not (YCbCr of 4 x 4 units no whole number of scanlines, 12-bit
    JPEG-in-TIFF). `from_file`: as cv2.imread reads the bytes of a file (they differ from
    cv2.imdecode's in RLEW's word alignment and in which uncompressed tiles read, see
    _tiff_layout)."""
    order, big, tags = _tiff_directory(data)

    def get(tag, default=None):
        return _tiff_values(data, order, big, tags[tag]) if tag in tags else default

    def one(tag, default=None):
        v = get(tag)
        return v[0] if v else default

    width, height = one(256, 0), one(257, 0)
    if width < 1 or height < 1:
        raise ValueError("corrupt TIFF: no width or height")
    _check_size(height, width, "TIFF")
    spp = one(277, 1)
    bps = get(258, [1])
    if not bps or len(set(bps[:spp])) > 1:
        raise ValueError("TIFF with different bits for each sample")
    bits, photometric = bps[0], one(262)
    if photometric is None:
        raise ValueError("TIFF without PhotometricInterpretation")
    if spp < 1 or spp > 4:
        raise ValueError(f"TIFF with {spp} samples a pixel (cv2 reads 1-4)")
    formats = get(339, [1])
    if any(f not in (1, 2) for f in formats[:spp]):
        raise ValueError(f"TIFF of sample format {formats[0]} (cv2 reads unsigned and signed integers: it "
                         f"returns None for floating-point samples)")
    compression = one(259, TIFF_NONE)
    if photometric in (TIFF_LOGL, TIFF_LOGLUV):
        return _sgilog_tiff(tags, get, one, data, height, width, spp, bits, compression, photometric, from_file)
    jpeg = compression == TIFF_JPEG
    if jpeg and bits == 12:
        raise UnsupportedImage(f"12-bit JPEG-in-TIFF ({_READ})")
    if jpeg and bits != 8:  # libtiff's JPEG codec fails its first read: the data precision is 8 or 12
        raise ValueError(f"JPEG-in-TIFF of {bits}-bit samples (cv2 returns None)")
    if bits not in (1, 4, 8, 16) or (bits == 4 and photometric != 3):
        raise ValueError(f"TIFF of {bits}-bit samples (cv2 reads 1, 8 and 16 bits, 4 in a palette image)")
    outcome, codec_name = tiff_compression_outcome(compression, bits, photometric)
    if outcome == "none":
        raise ValueError(f"TIFF with {codec_name} compression of these samples (cv2 returns None)")
    planar = one(284, 1)
    if planar not in (1, 2):
        raise ValueError(f"TIFF with PlanarConfiguration {planar}")
    planar = planar if spp > 1 else 1
    ycbcr = None
    if jpeg:
        if photometric == 6 and planar == 1:  # the RGBA interface has libjpeg convert to RGB (JPEGCOLORMODE_RGB)
            if spp != 3:
                raise ValueError(f"JPEG-in-TIFF of YCbCr in {spp} samples (libjpeg converts 3; cv2 returns None)")
            sub = get(530, [2, 2])
            ycbcr, photometric = (sub[0], sub[1] if len(sub) > 1 else 2), 2
        elif photometric not in (0, 1, 2, 3, 5, 6, 8):
            raise ValueError(f"TIFF of photometric {photometric}")
    extras = get(338, [])
    if len(extras) > spp or any(v > 2 for v in extras):
        raise ValueError("TIFF with ExtraSamples libtiff refuses")
    colour = spp - len(extras)
    alpha = {0: 1 if spp > 3 else 0, 1: 1, 2: 2}[extras[0]] if extras else 0
    palette = _palette()
    fmt, channels, alpha_sample, read_planes = TIFF_RGB_FORMAT, 3, -1, [0]
    gray = photometric in (0, 1)
    sub, tables = (1, 1), None
    if photometric == 6:  # tif_getimage.c: 8-bit YCbCr of 3 samples, the subsamplings it has put routines for
        sub = get(530, [2, 2])
        sub = (sub[0], sub[1] if len(sub) > 1 else 2)
        if spp != 3 or bits != 8 or sub not in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)) or (
                planar == 2 and sub != (1, 1)):
            raise ValueError(f"YCbCr TIFF of {spp} {bits}-bit samples, subsampling {sub[0]} x {sub[1]}"
                             f"{', separate planes' if planar == 2 else ''} (no put routine: cv2 returns None)")
        luma = [np.float32(v) for v in (_tiff_floats(data, order, big, tags[529]) if 529 in tags else ())]
        luma = tuple(luma) if len(luma) >= 3 else TIFF_LUMA
        reference = [np.float32(v) for v in (_tiff_floats(data, order, big, tags[532]) if 532 in tags else ())]
        reference = tuple(reference) if len(reference) >= 6 else TIFF_YCBCR_REFERENCE
        if any(np.isnan(luma[:3])) or abs(luma[1]) < 1e-7:
            raise ValueError("YCbCr TIFF of invalid YCbCrCoefficients (cv2 returns None)")
        fmt, tables = TIFF_YCBCR_FORMAT, ("ycbcr", luma[:3], reference[:6])
        read_planes = [0, 1, 2] if planar == 2 else [0]
    elif photometric == 8:  # tif_getimage.c: CIELab of 3 samples (no extras), 8 or 16 bits, one plane
        if spp != 3 or colour != 3 or bits not in (8, 16) or planar != 1:
            raise ValueError(f"CIELab TIFF of {spp} {bits}-bit samples{', separate planes' if planar == 2 else ''} "
                             f"(cv2 returns None)")
        white = [np.float32(v) for v in (_tiff_floats(data, order, big, tags[318]) if 318 in tags else ())]
        white = tuple(white[:2]) if len(white) >= 2 else TIFF_D50_WHITE
        if white[1] == 0:
            raise ValueError("CIELab TIFF of WhitePoint y 0 (cv2 returns None)")
        fmt, tables = TIFF_LAB_FORMAT, ("lab", white)
    elif planar == 1:
        if photometric in (0, 1, 3) and spp != 1 and bits < 8:
            raise ValueError("TIFF of contiguous samples under 8 bits with more than one a pixel")
        if gray:
            if bits not in (1, 8, 16):
                raise ValueError(f"gray TIFF of {bits}-bit samples")
            top = (1 << min(bits, 8)) - 1
            v = np.arange(top + 1)
            palette[:top + 1] = (((top - v) if photometric == 0 else v) * 255 // top)[:, None]
            fmt = TIFF_LUT_FORMAT
        elif photometric == 3:
            if bits == 16:
                raise ValueError("palette TIFF of 16-bit samples (cv2 returns None)")
            cmap = get(320)
            n = 1 << bits
            if cmap is None or len(cmap) < 3 * n:
                raise ValueError("palette TIFF without a whole colour map")
            cmap = np.asarray(cmap[:3 * n], np.int64).reshape(3, n)
            palette[:n] = (cmap >> 8 if (cmap >= 256).any() else cmap).T  # libtiff's checkcmap
            fmt = TIFF_LUT_FORMAT
        elif photometric == 2:
            if colour < 3 or bits not in (8, 16):
                raise ValueError(f"RGB TIFF of {colour} colour samples of {bits} bits")
            if alpha == 2 and spp >= 4:
                alpha_sample = 3
        elif photometric == 5:
            if one(332, 1) != 1 or spp < 4 or bits != 8:
                raise ValueError("separated TIFF other than 8-bit CMYK")
            fmt = TIFF_CMYK_FORMAT
        else:
            raise ValueError(f"TIFF of photometric {photometric}")
    else:
        if gray or photometric == 2:
            if bits not in (8, 16) or (photometric == 2 and colour < 3):
                raise ValueError(f"TIFF of separate planes of {bits}-bit samples")
            channels = 1 if gray else 3
            read_planes = list(range(channels))
            if alpha:
                read_planes.append(channels)
                if alpha == 2:
                    alpha_sample = channels
        elif photometric == 5:
            if one(332, 1) != 1 or spp != 4 or bits != 8:
                raise ValueError("separated TIFF other than 8-bit CMYK")
            fmt, read_planes = TIFF_CMYK_FORMAT, [0, 1, 2, 3]
        else:
            raise ValueError(f"TIFF of photometric {photometric} in separate planes")
    predictor = 0
    if compression in (TIFF_LZW, TIFF_DEFLATE, TIFF_ADOBE_DEFLATE):
        p = one(317, 1)
        if p == 2 and bits in (8, 16):
            predictor = bits
        elif p != 1:
            raise ValueError(f"TIFF with predictor {p} on {bits}-bit samples (libtiff fails to set it up)")
    orientation, mirror = _tiff_orientation(tags, one)
    chunks, chunk_hw = _tiff_layout(tags, get, one, data, height, width, spp, bits, planar, compression,
                                    read_planes, fmt, sub, from_file)
    tiled = 322 in tags or 323 in tags
    tables_347 = _tiff_bytes(data, order, big, tags[347]) if jpeg and 347 in tags else b""
    samples = spp if planar == 1 else 1
    # libtiff takes a file's LZW codes as old-style (LZWDecodeCompat, every chunk) where the
    # first chunk it decodes starts with an LSB-first Clear (LZWPreDecode)
    old_lzw = compression == TIFF_LZW and _lzw_clear(chunks[0].raw, True)
    fax = {2: FAX_RLE, 32771: FAX_RLEW, 4: FAX_G4, TIFF_THUNDERSCAN: FAX_THUNDER,
           3: FAX_G3_2D if one(292, 0) & 1 else FAX_G3_1D}.get(compression)
    for c in chunks:
        if c.missing:
            continue
        size = c.size
        if compression == TIFF_NONE:
            c.ok = len(c.raw) >= size
            c.decoded = c.raw[:size] if c.ok else bytes(size)
        elif compression == TIFF_PACKBITS:
            c.decoded, c.ok = packbits_decode(c.raw, size)
        elif compression == TIFF_LZW:
            c.lzw = LZW_TIFF_OLD if old_lzw else LZW_TIFF
            if not _lzw_clear(c.raw, old_lzw):
                c.decoded, c.ok = bytes(size), False  # libtiff decodes nothing before a Clear
        elif fax == FAX_THUNDER and tiled:  # libtiff has no ThunderScan tile decoder: zero samples
            c.decoded, c.ok = bytes(size), False
        elif fax is not None:
            c.fax = fax  # K11 decodes it
        elif compression in (TIFF_DEFLATE, TIFF_ADOBE_DEFLATE):
            c.decoded, c.ok = inflate(c.raw, size)
        elif jpeg:
            c.jpeg = _tiff_jpeg_chunk(c.raw, tables_347, c.rows, c.width, samples, ycbcr,
                                      last_strip=not tiled and c.y0 + c.rows >= height)
            frame_w = c.jpeg.width
            c.placed_rows = min(c.placed_rows, c.jpeg.height)
            c.placed_bytes = min(c.placed_bytes, frame_w * samples)
            c.pitch = frame_w * samples if c.pitch == c.row_bytes or frame_w != c.width else c.pitch
        else:  # no codec claims the code: libtiff decodes nothing
            c.decoded, c.ok = bytes(size), False
    return TiffImage(height, width, orientation, bits, samples, max(read_planes) + 1, predictor,
                     bits == 16 and order == ">", fmt, channels, alpha_sample, palette, chunks, mirror, chunk_hw, sub,
                     tables)


def _tiff_orientation(tags: dict, one) -> Tuple[int, int]:
    """(the orientation cv2 turns the image by, the width of the tiles whose columns
    libtiff mirrors or 0)."""
    orientation = one(274, 1)
    if not 1 <= orientation <= 8:
        orientation = 1
    if (322 in tags or 323 in tags) and orientation in (2, 3, 6, 7):
        # libtiff mirrors each tile it reads where the orientation flips columns, and cv2
        # then turns the image by the orientation without that flip
        return {2: 1, 3: 4, 6: 7, 7: 6}[orientation], one(322, 0)
    return orientation, 0


def _sgilog_tiff(tags: dict, get, one, data: bytes, height: int, width: int, spp: int, bits: int,
                 compression: int, photometric: int, from_file: bool) -> TiffImage:
    """A LogL or LogLuv TIFF as cv2 5.0 reads it: libtiff's RGBA interface sets
    SGILOGDATAFMT_8BIT, so its SGILog codec decodes each row (tif_luv.c: LogL16Decode's two
    run-length byte planes, LogLuvDecode32's four, LogLuvDecode24's 3 raw bytes a pixel)
    and turns it into bytes (L16toGry, Luv32toRGB, Luv24toRGB); a row whose data runs out,
    and the rest of its chunk, stay zero. K12 undoes the run-length planes into words
    (TiffChunk.sgi), SGILog24's whole rows are its raw bytes here, and K8 does the
    conversion (TIFF_LOGL_FORMAT ...). ValueError where cv2 returns None (probed on cv2
    5.0.0): another codec, SGILog24 on LogL, LogL of other than one sample of 1, 8 or 16
    bits, LogLuv of other than three contiguous samples of 1, 2, 4, 8 or 16 bits."""
    outcome, name = tiff_compression_outcome(compression, bits, photometric)
    kind = "LogL" if photometric == TIFF_LOGL else "LogLuv"
    if outcome != "decode":
        raise ValueError(f"{kind} TIFF with {name} compression (cv2 returns None)")
    if photometric == TIFF_LOGL:
        if spp != 1 or bits not in (1, 8, 16):
            raise ValueError(f"LogL TIFF of {spp} {bits}-bit samples (cv2 returns None)")
        fmt = TIFF_LOGL_FORMAT
    else:
        if spp != 3 or bits not in (1, 2, 4, 8, 16) or one(284, 1) != 1:
            raise ValueError(f"LogLuv TIFF of {spp} {bits}-bit samples{', separate planes' if one(284, 1) != 1 else ''}"
                             f" (cv2 returns None)")
        fmt = TIFF_LOGLUV24_FORMAT if compression == TIFF_SGILOG24 else TIFF_LOGLUV_FORMAT
    word = SGILOG_WORD[fmt]
    orientation, mirror = _tiff_orientation(tags, one)
    chunks, chunk_hw = _tiff_layout(tags, get, one, data, height, width, 1, 8 * word, 1, compression, [0], fmt,
                                    from_file=from_file)
    for c in chunks:
        if fmt == TIFF_LOGLUV24_FORMAT:  # LogLuvDecode24: whole rows while 3 bytes a pixel remain
            whole = min(c.rows, len(c.raw) // c.row_bytes) * c.row_bytes
            c.decoded = c.raw[:whole] + bytes(c.size - whole)
        else:
            c.sgi = word
    return TiffImage(height, width, orientation, 8, 1, 1, 0, False, fmt, 3, -1, _palette(), chunks, mirror, chunk_hw,
                     tables=("sgilog",))


# ---------------------------------------------------------------------------- K8's batch
# One image as K8 reads it (csrc/raw_image.cu enum Raw): [byte of its RGB in the call's
# output, height, width (as decoded), format (RAW_*, TIFF_*_FORMAT), then for the raw
# formats the byte of its first output row in the call's byte buffer and the signed
# bytes from one row to the next (a bottom-up file steps backwards), for a TIFF its first
# chunk in the chunk table and the rows a chunk covers; samples a pixel (RAW_TEXT,
# RAW_FLOAT, a TIFF's decoded rows), maxval (RAW_TEXT; a TIFF's bits a sample), 1 for
# big-endian floats, the window the rows cover (first row, first column, height, width;
# palette entry 256 outside it: a GIF frame smaller than its screen), the orientation
# (1-8) the output takes, a TIFF's colour samples read (1: gray planes, R = G = B), the
# sample its unassociated alpha premultiplies by (-1: none), 1 for separate planes, the
# width of the tiles whose columns are read mirrored (0: none), the byte of its 257 RGB
# palette entries in the byte buffer, the PFM scale (float32 bits), a TIFF's chunks a row
# of chunks, pixels a chunk covers, chunks a plane, the int of its YCbCr or CIELab tables
# in the descriptor ints (-1: none), its YCbCr subsampling (horizontal, vertical), its
# first CTA and CTAs a row of RAW_TILE, the output's height and width]. Every field is
# the host's: the kernel derives none of them.
RAW_INTS = 32
(R_OUT, R_HEIGHT, R_WIDTH, R_FMT, R_OFFSET, R_STRIDE, R_CHANNELS, R_MAXVAL, R_BIG_ENDIAN, R_TOP, R_LEFT, R_WIN_H,
 R_WIN_W, R_ORIENTATION, R_COLOUR, R_ALPHA, R_PLANAR, R_MIRROR, R_PALETTE, R_SCALE, R_ACROSS, R_CHUNK_W,
 R_PER_PLANE, R_TABLE, R_HS, R_VS, R_TILE, R_TILES_X, R_OUT_H, R_OUT_W) = range(30)
RAW_TILE = (8, 128)  # csrc/raw_image.cu kTileRows x kTileCols output pixels a CTA: a warp a row
K10_WORK_INTS = 2  # one K10 chunk: its chunk, K10's rows (a warp each) before it
# and after the list, each K10 row's chunk and its row there (a warp finds its row in one load)
K10_ROW_INTS = 2


@dataclasses.dataclass
class RawBatch:
    """One decode call's GIFs, TIFFs and raw images (BMP, PxM, PAM, Sun raster, PFM, HDR)
    as K9, K11, K10 and K8 read them. `host` is the one upload: the descriptor ints (the
    image table at int 0, the chunk table at `chunk_at`, K10's chunks at `work_at` and each
    of its rows' chunk and row there at `work_at + works * K10_WORK_INTS`, K11's streams
    at `fax_at`, the YCbCr and CIELab tables) then the bytes (palettes, the raw images'
    rows, the TIFFs' host-decoded chunks, K11's coded chunks). The device buffer holds
    `host`, then K9's output (`lzw`'s: the GIF frames' indices, then the TIFF LZW chunks,
    zero before K9 writes them) from `lzw_at`, then K11's (zero before it writes) from
    `fax_out`, then K12's (K12's streams at `sgi_at` in the descriptor ints; zero before it
    writes) from `sgi_out`."""

    host: np.ndarray  # uint8
    images: int
    chunk_at: int
    work_at: int
    works: int
    k10_rows: int
    tiles: int
    out_bytes: int
    out: List[Tuple[int, int, int]]  # each image's (byte of its RGB, height, width)
    lzw: GifBatch
    lzw_at: int
    gifs: int  # the first `gifs` images are GIFs, the first `gifs` K9 streams their frames
    fax_at: int = 0  # K11's stream table (FAX_INTS a stream) in the descriptor ints
    faxes: int = 0
    fax_out: int = 0  # K11's output in the device buffer
    fax_bytes: int = 0
    fax_runs: int = 0  # ints of run scratch the CCITT chunks take (fax_area each)
    fax_runs_max: int = 0  # the most one chunk takes
    sgi_at: int = 0  # K12's stream table (SGI_INTS a stream) in the descriptor ints
    sgis: int = 0
    sgi_out: int = 0  # K12's output in the device buffer
    sgi_bytes: int = 0

    @property
    def total(self) -> int:
        return self.sgi_out + self.sgi_bytes

    @property
    def fax_streams(self) -> np.ndarray:
        return self.desc[self.fax_at:self.fax_at + self.faxes * FAX_INTS].reshape(self.faxes, FAX_INTS)

    @property
    def sgi_streams(self) -> np.ndarray:
        return self.desc[self.sgi_at:self.sgi_at + self.sgis * SGI_INTS].reshape(self.sgis, SGI_INTS)

    @property
    def desc(self) -> np.ndarray:
        """The descriptor ints."""
        return self.host[:self.host.size // 4 * 4].view(np.int32)

    @property
    def image_rows(self) -> np.ndarray:
        return self.desc[:self.images * RAW_INTS].reshape(self.images, RAW_INTS)

    @property
    def chunks(self) -> np.ndarray:
        n = (self.work_at - self.chunk_at) // TIFF_CHUNK_INTS
        return self.desc[self.chunk_at:self.work_at].reshape(n, TIFF_CHUNK_INTS)


def raw_batch(gifs: Sequence[GifImage], tiffs: Sequence[TiffImage], raws: Sequence[RawImage]) -> RawBatch:
    """Lay out a decode call's GIFs, TIFFs and raw images for K9, K11, K10 and K8 (host
    work, numpy): one K8 launch expands them all, the GIFs first, then the TIFFs, then the
    rest. A TIFF's JPEG chunks are read from the JPEG kernels' output (tiff_jpeg_chunks'
    order, back to back, `pixel_bytes` each a pixel)."""
    images = [(g.raw(), "gif", g) for g in gifs] + [(t.raw(), "tiff", t) for t in tiffs] + \
        [(r, "raw", None) for r in raws]
    frames, lzw, at = [], [], 0
    for g in gifs:
        frames.append(at)
        at += g.frame_width * g.frame_height
    n_chunks = sum(len(t.chunks) for t in tiffs)
    chunk_rows: List[List[int]] = []  # TIFF_CHUNK_INTS a chunk
    # descriptor ints: the images, the tables (each distinct one once), the chunks, K10's chunks
    table_at = len(images) * RAW_INTS
    tables: Dict[tuple, int] = {}
    table_parts: List[np.ndarray] = []
    for t in tiffs:
        if t.tables is not None and t.tables not in tables:
            first = table_at + sum(p.size for p in table_parts)
            if first & 1:  # each table from an even int: the SGILog tables hold doubles
                table_parts.append(np.zeros(1, np.int32))
                first += 1
            tables[t.tables] = first
            table_parts.append(ycbcr_tables(*t.tables[1:]).reshape(-1) if t.tables[0] == "ycbcr" else
                               lab_tables(t.tables[1]).view(np.int32) if t.tables[0] == "lab" else sgilog_tables())
    chunk_at = table_at + sum(p.size for p in table_parts)
    work_at = chunk_at + n_chunks * TIFF_CHUNK_INTS
    most_rows = sum(c.rows for t in tiffs for c in t.chunks)  # K10's rows at most
    fax_at = work_at + n_chunks * K10_WORK_INTS + most_rows * K10_ROW_INTS
    n_fax = sum(c.fax >= 0 for t in tiffs for c in t.chunks)
    sgi_at = fax_at + n_fax * FAX_INTS
    n_sgi = sum(c.sgi > 0 for t in tiffs for c in t.chunks)
    byte0 = -(-4 * (sgi_at + n_sgi * SGI_INTS) // 16) * 16
    pieces: List[Tuple[int, bytes]] = []
    byte_at = byte0

    def put(b: bytes, align: int = 1) -> int:
        nonlocal byte_at
        if byte_at % align:
            pieces.append((byte_at, bytes(-byte_at % align)))
            byte_at += -byte_at % align
        at = byte_at
        pieces.append((at, b))
        byte_at += len(b)
        return at

    palettes: Dict[bytes, int] = {}

    def palette(p: np.ndarray) -> int:
        b = np.ascontiguousarray(p, np.uint8).tobytes()
        if b not in palettes:
            palettes[b] = put(b)
        return palettes[b]

    rows: List[List[int]] = []
    host_chunks = []  # (chunk row, bytes): the TIFFs' host-decoded chunks, placed after the raw rows
    faxes: List[Tuple[int, TiffChunk, int]] = []  # (chunk row, chunk, image): K11's streams
    sgis: List[Tuple[int, TiffChunk]] = []  # (chunk row, chunk): K12's streams
    jpeg_at, out_at, tile, lzw_bytes = 0, 0, 0, 0
    for i, (raw, kind, src) in enumerate(images):
        oh, ow = raw.out_hw
        tiles_x = -(-ow // RAW_TILE[1])
        r = [out_at, raw.height, raw.width, raw.fmt, 0, raw.stride, raw.channels, raw.maxval, raw.big_endian,
             *(raw.window or (0, 0, raw.height, raw.width)), raw.orientation, raw.colour_channels, raw.alpha,
             raw.planar, raw.mirror, palette(raw.palette), int(np.float32(raw.scale).view(np.int32)), 0, 0, 0, -1, 1,
             1, tile, tiles_x, oh, ow, 0, 0]  # R_* order
        rows.append(r)
        out_at += -(-oh * ow * 3 // 16) * 16  # each image's RGB from a 16-byte boundary
        tile += tiles_x * -(-oh // RAW_TILE[0])
        if kind == "gif":
            r[R_OFFSET] = frames[i]  # in K9's output, after the host bytes: fixed up below
        elif kind == "raw":
            r[R_OFFSET] = put(raw.data) + raw.offset
        else:
            t = src
            r[R_OFFSET], r[R_ACROSS], r[R_CHUNK_W] = len(chunk_rows), t.across, t.chunk_hw[1]
            r[R_PER_PLANE] = t.per_plane
            r[R_HS], r[R_VS] = t.subsampling
            if t.tables is not None:
                r[R_TABLE] = tables[t.tables]
            for c in t.chunks:  # [src, jpeg, pitch, rows held, bytes held, rows, row bytes, width, samples,
                #                  predictor, swab, stream]
                row = [0, 0, c.pitch, c.placed_rows, c.placed_bytes,
                       c.placed_rows if t.fmt != TIFF_YCBCR_FORMAT else c.rows, c.row_bytes, c.width, t.samples, 0, 0,
                       -1]
                if c.jpeg is not None:
                    row[C_SRC], row[C_JPEG] = jpeg_at, 1
                    jpeg_at += c.jpeg.height * c.jpeg.width * pixel_bytes(c.jpeg.space, len(c.jpeg.comps))
                elif not c.missing:
                    if c.ok:
                        row[C_PREDICTOR], row[C_SWAB] = t.predictor, int(t.swab)
                    if c.fax >= 0:  # K11 decodes it into its output (offset fixed up below)
                        faxes.append((len(chunk_rows), c, i))
                    elif c.sgi:  # K12 decodes it into its output (offset fixed up below)
                        sgis.append((len(chunk_rows), c))
                    elif c.decoded is None:  # K9 decodes it into its output after the frames (offset fixed up below)
                        # K9's streams: the GIFs' first
                        row[C_SRC], row[C_STREAM] = at + lzw_bytes, len(gifs) + len(lzw)
                        lzw.append((c.raw, c.size, c.lzw))
                        lzw_bytes += c.size
                    else:
                        host_chunks.append((len(chunk_rows), c.decoded))
                chunk_rows.append(row)
    for k, b in host_chunks:
        chunk_rows[k][C_SRC] = put(b)
    fax_rows, fax_bytes, fax_runs, fax_runs_max = [], 0, 0, 0
    for j, (k, c, image) in enumerate(faxes):  # [src, bytes, flavour, rows, width, row bytes, out (fixed up
        #                                        below), odd, runs, first, chunks]
        chunk_rows[k][C_SRC] = fax_bytes
        if j == 0 or faxes[j - 1][2] != image:
            first, count = j, sum(f[2] == image for f in faxes)
        area = fax_area(c.fax, c.width) if c.fax != FAX_THUNDER else 0
        fax_rows.append([put(c.raw, 16), len(c.raw), c.fax, c.rows, c.width, c.row_bytes, fax_bytes, c.odd,
                         fax_runs, first, count])
        fax_runs, fax_runs_max = fax_runs + area, max(fax_runs_max, area)
        fax_bytes += c.size
    sgi_rows, sgi_bytes = [], 0
    for k, c in sgis:  # [src, bytes, word, rows, width, out (fixed up below)]
        chunk_rows[k][C_SRC] = sgi_bytes
        sgi_rows.append([put(c.raw), len(c.raw), c.sgi, c.rows, c.width, sgi_bytes])
        sgi_bytes += c.size
    lzw_at = -(-byte_at // 16) * 16
    for i, (_, kind, _) in enumerate(images):
        if kind == "gif":
            rows[i][R_OFFSET] += lzw_at
    rows = np.asarray(rows, np.int64).reshape(-1, RAW_INTS)
    chunk_rows = np.asarray(chunk_rows, np.int64).reshape(-1, TIFF_CHUNK_INTS)
    chunk_rows[chunk_rows[:, C_STREAM] >= 0, C_SRC] += lzw_at
    k10 = (chunk_rows[:, C_JPEG] == 0) & ((chunk_rows[:, C_PREDICTOR] > 0) | (chunk_rows[:, C_SWAB] > 0)) & (
        chunk_rows[:, C_ROWS] > 0)
    ids = np.flatnonzero(k10)
    before = np.concatenate([[0], np.cumsum(chunk_rows[ids, C_ROWS])])
    work = np.stack([ids, before[:-1]], 1) if ids.size else np.zeros((0, 2), np.int64)
    batch_lzw = gif_batch(gifs, lzw)
    fax_out = lzw_at + batch_lzw.total_indices
    for k, _, _ in faxes:
        chunk_rows[k, C_SRC] += fax_out
    fax_rows = np.asarray(fax_rows, np.int64).reshape(-1, FAX_INTS)
    fax_rows[:, F_OUT] += fax_out
    sgi_out = fax_out + fax_bytes
    for k, _ in sgis:
        chunk_rows[k, C_SRC] += sgi_out
    sgi_rows = np.asarray(sgi_rows, np.int64).reshape(-1, SGI_INTS)
    sgi_rows[:, G_OUT] += sgi_out
    if max(sgi_out + sgi_bytes, out_at, jpeg_at, tile, fax_runs) >= 2 ** 31:
        raise ValueError("raw image batch too large for one launch")
    host = np.empty(lzw_at, np.uint8)  # up to K9's output, no byte left unwritten: the pieces cover the rest
    host[:byte0] = 0
    host[byte_at:] = 0
    desc = host[:byte0].view(np.int32)
    desc[:table_at] = rows.reshape(-1)
    if table_parts:
        desc[table_at:chunk_at] = np.concatenate(table_parts)
    desc[chunk_at:work_at] = chunk_rows.reshape(-1)
    desc[work_at:work_at + work.size] = work.reshape(-1)
    k10_rows = int(before[-1])
    rows_of = np.diff(before)
    desc[work_at + work.size:work_at + work.size + K10_ROW_INTS * k10_rows] = np.stack(
        [np.repeat(ids, rows_of), np.arange(k10_rows) - np.repeat(before[:-1], rows_of)], 1).reshape(-1)
    desc[fax_at:fax_at + fax_rows.size] = fax_rows.reshape(-1)
    desc[sgi_at:sgi_at + sgi_rows.size] = sgi_rows.reshape(-1)
    for at, b in pieces:
        host[at:at + len(b)] = np.frombuffer(b, np.uint8)
    return RawBatch(host, len(images), chunk_at, work_at, len(work), int(before[-1]), tile, out_at,
                    [(int(r[R_OUT]), int(r[R_OUT_H]), int(r[R_OUT_W])) for r in rows], batch_lzw, lzw_at, len(gifs),
                    fax_at, len(faxes), fax_out, fax_bytes, fax_runs, fax_runs_max, sgi_at, len(sgis), sgi_out,
                    sgi_bytes)


def fax_scratch(mode: int, width: int) -> int:
    """Ints of run scratch K11 takes for a CCITT image of chunks `width` pixels wide:
    tif_fax3.c's two rows of runs (Fax3SetupState's nruns each, which is doubled for a
    reference line), and room for the zero runs CLEANUP_RUNS and the fill append past a
    full row."""
    n = -(-(width + 1) // 32) * 32
    return 2 * (2 * n if mode in (FAX_G3_2D, FAX_G4) else n) + 8


def fax_span(mode: int, width: int) -> int:
    """Ints of run arrays K11 walks a chunk in: libtiff's two (fax_scratch) for the 2-D
    flavours, two slots of them for the 1-D ones (a slot a row parity, so that a row's
    fill can run while the next row decodes; 1-D rows read no other row's runs)."""
    return fax_scratch(mode, width) * (1 if mode in (FAX_G3_2D, FAX_G4) else 2)


def fax_row_ints(width: int) -> int:
    """Ints of a K11 fill warp's row of bytes (a 1-bit row of `width` pixels, rounded to
    16 bytes, and 16 more)."""
    return (-(-(-(-width // 8)) // 16) * 16 + 16) // 4


def fax_area(mode: int, width: int) -> int:
    """Ints of K11's scratch a CCITT chunk takes: its run arrays (fax_span), then each fill
    warp's row (fax_row_ints). The kernel keeps them in shared memory and saves the run
    arrays here; an image too wide for shared memory works here."""
    return fax_span(mode, width) + 2 * fax_row_ints(width)


def tiff_jpeg_chunks(images: Sequence[TiffImage]) -> List[JpegImage]:
    """The JPEG chunks of a batch of TIFFs, in raw_batch's order."""
    return [c.jpeg for im in images for c in im.chunks if c.jpeg is not None]


# ---------------------------------------------------------------------------- formats
_OTHER_FORMATS = ((b"\0\0\0\x0cjP  ", "JPEG 2000"), (b"\xff\x4f\xff\x51", "JPEG 2000"))
_READ = "JPEG, PNG, GIF, TIFF, BMP, PxM, PAM, Sun raster, PFM and HDR only"


def _avif_brands(data: bytes) -> bool:
    """Whether the file starts with an ISO BMFF `ftyp` box that names `avif` or `avis` as
    its major brand or among its compatible brands, as libavif's file-type check asks (a
    box of size 1 gives a 64-bit size after its type). A box that runs past the data,
    whose brands are no whole 4-byte words, or of size 0 (to the end of the data, so
    that no image follows it: cv2 returns None) is not one."""
    if len(data) < 8 or data[4:8] != b"ftyp":
        return False
    size, at = int.from_bytes(data[:4], "big"), 8
    if size == 1:
        if len(data) < 16:
            return False
        size, at = int.from_bytes(data[8:16], "big"), 16
    if size > len(data) or size - at < 8 or (size - at - 8) % 4:
        return False
    brands = [data[at:at + 4]] + [data[i:i + 4] for i in range(at + 8, size, 4)]
    return b"avif" in brands or b"avis" in brands


def image_kind(data: bytes) -> str:
    """'jpeg', 'png', 'gif', 'tiff' (TIFF and BigTIFF), 'bmp', 'pxm', 'pam', 'sunras',
    'pfm' or 'hdr'; UnsupportedImage for another format cv2 reads (WebP, JPEG 2000, AVIF);
    ValueError else."""
    if data[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if data[:8] == PNG_SIGNATURE:
        return "png"
    if data[:3] == b"GIF":
        return "gif"
    if data[:4] in TIFF_MAGICS:
        return "tiff"
    if data[:2] == b"BM":
        return "bmp"
    if len(data) > 2 and data[0] == 0x50 and data[1] in b"123456" and data[2] in _SPACE:
        return "pxm"
    if len(data) > 2 and data[:2] == b"P7" and data[2] in _SPACE:
        return "pam"
    if data[:4] == b"\x59\xa6\x6a\x95":
        return "sunras"
    if data[:2] in (b"PF", b"Pf"):
        return "pfm"
    if data[:6] == b"#?RGBE" or data[:10] == b"#?RADIANCE":
        return "hdr"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        raise UnsupportedImage(f"WebP images are not supported ({_READ})")
    if _avif_brands(data):
        raise UnsupportedImage(f"AVIF images are not supported ({_READ})")
    for magic, name in _OTHER_FORMATS:
        if data.startswith(magic):
            raise UnsupportedImage(f"{name} images are not supported ({_READ})")
    raise ValueError("could not decode image bytes")


# ---------------------------------------------------------------------------- entry points
def decode_images(blobs: Sequence[bytes], device: str | torch.device = "cuda") -> List[torch.Tensor]:
    """Encoded images -> uint8 (H, W, 3) RGB tensors on `device`, as
    cv2.imdecode(..., IMREAD_COLOR) gives them (BGR there). The JPEGs of the batch go
    through each JPEG kernel once, the PNGs through each PNG kernel once, the GIFs and the
    TIFFs' LZW chunks through the LZW kernel once, the TIFFs through the chunk assembly
    kernel once, and each GIF and TIFF then through the raw kernel, as each BMP, PxM, PAM,
    Sun raster, PFM or HDR does. Raises UnsupportedImage or ValueError (for the first image
    at fault) on the host; corrupt entropy-coded data that libjpeg decodes with warnings
    decodes here as there, without waiting for the device, as does a TIFF chunk that
    libtiff decodes in part. A batch with GIFs waits for K9's status, since only the LZW
    data tells whether cv2 reads the frame."""
    return decode_images_with_warnings(blobs, device)[0]


def decode_images_with_warnings(blobs: Sequence[bytes], device: str | torch.device = "cuda",
                                from_file: bool = False) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """`decode_images`, and the entropy kernels' per-segment count of libjpeg's
    warnings (int32 (S,) on `device`, None without JPEGs): the codes no table has, and 1
    where a segment's data ran out at its marker."""
    from ssd_object_detection_tpu_torch.ops import cuda_image

    device = resolve_device(device)
    kinds = [image_kind(b) for b in blobs]
    out: List[Optional[torch.Tensor]] = [None] * len(blobs)
    jpegs = [(i, parse_jpeg(b)) for i, (b, k) in enumerate(zip(blobs, kinds)) if k == "jpeg"]
    pngs = [(i, parse_png(b)) for i, (b, k) in enumerate(zip(blobs, kinds)) if k == "png"]
    gifs = [(i, parse_gif(b)) for i, (b, k) in enumerate(zip(blobs, kinds)) if k == "gif"]
    tiffs = [(i, parse_tiff(b, from_file)) for i, (b, k) in enumerate(zip(blobs, kinds)) if k == "tiff"]
    raws = [(i, parse_raw(b, k)) for i, (b, k) in enumerate(zip(blobs, kinds)) if k in RAW_KINDS]
    status = None
    tiff_jpegs = tiff_jpeg_chunks([t for _, t in tiffs])
    chunk_pixels: Optional[torch.Tensor] = None
    if jpegs or tiff_jpegs:  # the JPEGs and the TIFFs' JPEG chunks, in one batch
        batch = jpeg_batch([im for _, im in jpegs] + tiff_jpegs)
        if device.type == "cuda":
            batch = batch.to(device)
        coef, status = cuda_image.decode_entropy(batch)
        rgb = cuda_image.idct_color(coef, batch)
        for (i, _), img in zip(jpegs, cuda_image.rgb_views(rgb, batch.out_shapes[:len(jpegs)])):
            out[i] = img
        chunk_pixels = rgb[sum(h * w * 3 for h, w in batch.out_shapes[:len(jpegs)]):]
    if pngs:
        for (i, _), img in zip(pngs, cuda_image.decode_png_batch([p for _, p in pngs], device)):
            out[i] = img
    if gifs or tiffs or raws:
        decoded = cuda_image.decode_raw_batch([g for _, g in gifs], [t for _, t in tiffs], [r for _, r in raws],
                                              device, chunk_pixels)
        for (i, _), img in zip(gifs + tiffs + raws, decoded):
            out[i] = img
    return out, status


def decode_image(data: bytes, device: str | torch.device = "cuda", from_file: bool = False) -> torch.Tensor:
    """One encoded image -> uint8 (H, W, 3) RGB tensor on `device` (`from_file`: the
    bytes of a file, as cv2.imread reads them)."""
    return decode_images_with_warnings([data], device, from_file)[0][0]


def check_file_read(data: bytes) -> None:
    """Where cv2.imread of a file differs from cv2.imdecode of its bytes. ValueError where
    imread returns None though imdecode decodes: a TIFF whose orientation (tag 274) is 5-8
    and whose width is not its height, whatever else it holds (cv2 5.0's imread decodes
    into the image it allocated from the header and checks that the decoder kept it,
    `original_ptr == real_mat.data`; the TIFF decoder turns the image itself, and so
    allocates it anew). An uncompressed tiled TIFF, which imread can read where imdecode
    returns None (data/tiff_compressions.json, "imread_differs"), decodes by its own rule
    with `from_file` (_tiled_none_reads)."""
    if data[:4] not in TIFF_MAGICS:
        return
    try:
        order, big, tags = _tiff_directory(data)
        value = {t: _tiff_values(data, order, big, tags[t]) for t in (256, 257, 259, 274) if t in tags}
        width, height, compression, orientation = (value.get(t, [d])[0] for t, d in
                                                   ((256, 0), (257, 0), (259, TIFF_NONE), (274, 1)))
    except (ValueError, struct.error, IndexError):
        return  # the decode tells what cv2 makes of it
    if 5 <= orientation <= 8 and width != height:
        raise ValueError(f"a {width} x {height} TIFF of orientation {orientation}: cv2.imread returns None "
                         f"for it")


def imread(path: str, device: str | torch.device = "cuda") -> torch.Tensor:
    """cv2.imread(path, IMREAD_COLOR) as RGB, on `device`: `decode_image` of the file's
    bytes, after `check_file_read`."""
    with open(path, "rb") as f:
        data = f.read()
    check_file_read(data)
    return decode_image(data, device, from_file=True)
