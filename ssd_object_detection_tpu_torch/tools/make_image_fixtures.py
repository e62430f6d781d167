"""Write the encoded-image fixtures of the cv2-free decoder, and cv2's digests of them.

`python -m ssd_object_detection_tpu_torch.tools.make_image_fixtures [--out DIR]` (needs
cv2) writes JPEGs and PNGs into `ssd_object_detection_tpu_torch/data/fixtures/` and
`digests.json` beside them: for every image, the SHA-256 of cv2.imdecode(...,
IMREAD_COLOR) as RGB, of its 300x300 INTER_LINEAR resize and, where it exceeds the
serving canvas (640x640), of its INTER_AREA fit into it; or the refusal the port must
give. The card has no cv2: chip_smoke.py holds the decoder on the card to these digests.

Images are drawn as tools/make_fake_coco.py draws them (shapes over smooth gradients):
  - COCO-sized JPEGs: 640x480 4:2:0 at cv2's default quality, 427x640 4:2:2, 500x333
    4:4:4, a 333x500 grayscale, 612x612 with a restart interval, 641x479 at quality 75
    with optimised Huffman tables, 480x640 with an Exif orientation-6 segment, 640x480
    progressive, 640x427 4:1:1 and a 500x333 CMYK one (PIL);
  - seams: widths and heights 1, 7, 8, 9, 15, 16, 17 at each sampling (4:4:4, 4:2:2,
    4:2:0, 4:4:0, 4:1:1) and progressive at 4:2:0, 1, 9, 17 and 33 at 4:1:0, restart
    intervals of 1 MCU and of more MCUs than the image has, and Exif orientations 1-8;
  - progressive (cv2's script) at each sampling, grayscale, with a restart interval and
    with optimised tables (redefined between scans); CMYK (PIL, baseline and
    progressive); and from the small baseline encoder here, which writes any sampling
    factors 1-4 and four components: YCCK (Adobe transform 2), 4:1:0, 3x1, 4x1 over 2x1
    and 2x4 over 1x2;
  - corrupt JPEGs that libjpeg decodes with warnings (cut and ended by EOI, an FF 00
    run, restart intervals cut, a progressive scan cut short), progressive ones that it
    smooths, and BMP, PxM, Sun raster and PFM variants;
  - progressive ones whose first scans repeat coefficients sent and refined before
    (a DC first scan after the DC refinement, with and without restart intervals, and
    an AC first scan after its refinement);
  - refused (UnsupportedImage, cv2 reads them): an AVIF body (cv2's encoder), the same
    with its major brand `mif1` (`avif` only among the compatible brands), PAMs with
    alpha (cv2 fills most of their pixels from memory it never wrote), a 1-channel PFM
    and a YCbCr TIFF of 4 x 4 units that are no whole number of scanlines;
  - TIFFs (PIL's libtiff writer, cv2's, and a small writer here) of every kind the
    reader reads, and JPEG-in-TIFFs: PIL's one-strip RGB, YCbCr and gray, and strips or
    tiles written here from cv2's JPEG streams with their tables moved into tag 347 (4:2:0,
    4:2:2, 4:4:4, RGB, gray, tiles cut at the edges, a restart interval, progressive
    strips, orientation 6, a cut strip, a last strip encoded taller than its rows, one
    640x480 file of 16-row strips; and what cv2 returns None for among them); the CCITT
    codecs (PIL's libtiff writer and a writer here: modified Huffman, RLEW, Group 3 1-D
    and 2-D, with fill bits, without EOLs, in tiles, Group 4, a 1728 x 2200 fax page),
    ThunderScan and old-style LZW codes (fax_fixtures);
  - SGILog TIFFs from encoders here (tif_luv.c's LogL16Encode, LogLuvEncode32 and
    LogLuvEncode24): LogL and LogLuv in strips and tiles, every sign of L and L zero, runs
    at the run-length coder's thresholds, out-of-gamut colour indices, a cut strip, 8-bit
    tags and an orientation (sgilog_fixtures); uncompressed tiles whose bytes fill
    libtiff's read buffer or not, read from bytes and from files;
  - `data/tiff_compressions.json` (`--table`): cv2.imdecode (and cv2.imread) of eleven small
    TIFFs at every compression code 0-65535 (compression_table; `--skip-compressions`
    leaves it);
  - PAMs (P7) as cv2 5.0 reads them: cv2's own (RGB, no TUPLTYPE), RGB, GRAYSCALE and
    BLACKANDWHITE with and without TUPLTYPE, MAXVAL 1 bits at DEPTH 1, 3 and 4 on a width
    not a multiple of 8, MAXVAL 100, 1000 and 65535, a header with comments, CR line
    ends, a value on its own line, a repeated TUPLTYPE and a value after ENDHDR;
  - PNGs: RGB, RGBA, gray, 16-bit (cv2's encoder), and from a small encoder here that
    cycles all five row filters: palette, Adam7, gray at 1, 2 and 4 bits, 16-bit gray +
    alpha interlaced;
  - GIFs: cv2's (GIF89a, one dithered 256-entry global table), and from an LZW encoder
    here: a frame smaller than its screen, transparency over a background whose entry 0
    is not black, a local table only, no table, a local table shorter than the global
    one, KwKwK codes, a full table without a Clear, Clears every few hundred codes,
    minimum code sizes 2-8 and 11, data ending without EOI, a code after the last pixel,
    decoding past an EOI, a second frame, interlacing, GIF87a and extension blocks, one
    colour at 640x480 (the longest strings) and minimum code size 2 with Clears every
    few dozen codes;
  - HDRs: cv2's (RLE, flat, narrower than 8), and from a writer here: flat scanlines
    with exponent 0, 1, 136 and 255 and mantissas past 1.0, `#?RGBE` with comments and
    header lines after FORMAT, RLE runs, RLE rows then flat ones;
  - what cv2 returns None for (INVALID, the port raises ValueError): GIFs whose LZW data
    leaves pixels short or codes over, a code past the table or a string past the frame,
    an index past the colour table, a 5-byte graphic control extension, disposal 4, a
    frame off the screen, minimum code size 12, no trailer, an application extension
    cv2 misreads; HDRs without FORMAT, of orientation +Y, with a zero RLE count, a wrong
    scanline width or pixels cut short; PAMs of DEPTH 4 with no TUPLTYPE, a header cut
    short, TUPLTYPE RGB at DEPTH 1, cv2's own 16-bit PAM (MAXVAL 65535, no TUPLTYPE) and
    pixels cut short.
Sizes are in width x height, as COCO lists them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct
import zlib

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "fixtures")
COMPRESSION_TABLE = os.path.join(os.path.dirname(FIXTURES), "tiff_compressions.json")
CANVAS = (640, 640)
SAMPLINGS = ("444", "422", "420", "440")
SEAMS = (1, 7, 8, 9, 15, 16, 17)
NEW_SEAMS = (1, 9, 17, 33)  # widths at 4:1:1 and 4:1:0 (MCUs 32 wide); heights but 33
# fixtures the port refuses though cv2 reads them: name -> what the refusal names
REFUSED = {"other_8x6.avif": "AVIF", "other_gray_8x6.pfm": "1-channel PFM", "other_mif1_8x6.avif": "AVIF",
           "pam_rgb_alpha_37x23.pam": "alpha", "pam_gray_alpha_37x23.pam": "alpha",
           "tiff_refused_ycbcr44_odd_units_33x17.tif": "no whole number of scanlines"}
# fixtures cv2 returns None for, where the port raises ValueError: name -> what is wrong
INVALID = {
    "gif_invalid_short_37x23.gif": "the LZW data ends a pixel short of the frame",
    "gif_invalid_extra_codes_37x23.gif": "two codes after the frame's last pixel",
    "gif_invalid_code_past_table_37x23.gif": "a code past the LZW table",
    "gif_invalid_string_past_frame_37x23.gif": "an LZW string past the frame",
    "gif_invalid_index_37x23.gif": "an index past the 16-entry colour table",
    "gif_invalid_gce_length_37x23.gif": "a graphic control extension of 5 bytes",
    "gif_invalid_disposal_37x23.gif": "disposal method 4",
    "gif_invalid_frame_outside_37x23.gif": "a frame past the logical screen",
    "gif_invalid_min_code_12_37x23.gif": "LZW minimum code size 12",
    "gif_invalid_no_trailer_37x23.gif": "no trailer",
    "gif_invalid_background_37x23.gif": "a background index past the global table",
    "gif_invalid_app_extension_37x23.gif": "an application extension of 3 bytes cv2 misreads",
    "hdr_invalid_no_format_9x6.hdr": "no FORMAT line",
    "hdr_invalid_orientation_9x6.hdr": "orientation +Y",
    "hdr_invalid_zero_count_12x5.hdr": "an RLE count of 0",
    "hdr_invalid_scanline_width_12x5.hdr": "an RLE scanline of the wrong width",
    "hdr_invalid_cut_12x5.hdr": "pixels cut short",
    "pam_invalid_depth4_37x23.pam": "DEPTH 4 with no TUPLTYPE",
    "pam_invalid_cut_header_37x23.pam": "a header cut short",
    "pam_invalid_tupltype_depth_37x23.pam": "TUPLTYPE RGB at DEPTH 1",
    "pam_invalid_16bit_no_tupltype_37x23.pam": "cv2's own 16-bit PAM: MAXVAL 65535 with no TUPLTYPE",
    "pam_invalid_short_37x23.pam": "pixels cut short",
    "tiff_invalid_float_37x23.tif": "float32 samples",
    "tiff_invalid_int32_37x23.tif": "32-bit samples",
    "tiff_invalid_2bit_37x23.tif": "2-bit gray samples",
    "tiff_invalid_strip_past_end_37x23.tif": "a strip whose bytes run past the file",
    "tiff_jpeg_invalid_garbage_67x45.tif": "a JPEG strip of bytes that are no JPEG",
    "tiff_jpeg_invalid_subsampling_67x45.tif": "4:2:0 JPEG strips under YCbCrSubsampling 1 x 1",
    "tiff_jpeg_invalid_rgb_420_67x45.tif": "4:2:0 JPEG strips in an RGB TIFF",
    "tiff_jpeg_invalid_components_67x45.tif": "gray JPEG strips in an RGB TIFF",
    "tiff_jpeg_invalid_tall_strip_67x45.tif": "a JPEG taller than its strip, not the last",
    "tiff_invalid_lzma_37x23.tif": "LZMA compression (not configured in cv2's libtiff)",
    "tiff_invalid_icclab_37x23.tif": "ICCLab (photometric 9): no RGBA put routine",
    "tiff_invalid_itulab_37x23.tif": "ITULab (photometric 10): no RGBA put routine",
    "tiff_invalid_lab_alpha_37x23.tif": "CIELab with an alpha sample",
    "tiff_invalid_lab_planar_37x23.tif": "CIELab in separate planes",
    "tiff_invalid_ycbcr24_37x23.tif": "YCbCr subsampling 2 x 4",
    "tiff_invalid_ycbcr_planar22_37x23.tif": "YCbCr in separate planes at 2 x 2",
    "tiff_invalid_ycbcr_alpha_37x23.tif": "YCbCr with an alpha sample",
    "tiff_jpeg_invalid_ycbcr_alpha_37x23.tif": "JPEG-in-TIFF of YCbCr and an alpha sample in one plane",
    "tiff_invalid_tiles_rgb_37x23.tif": "uncompressed tiles of 768 bytes (libtiff's read buffer holds 1,024)",
    "tiff_invalid_tiles_gray_37x23.tif": "uncompressed tiles of 256 bytes (libtiff's read buffer holds 1,024)",
    "tiff_invalid_sgilog24_logl_37x23.tif": "SGILog24 on LogL",
    "tiff_invalid_sgilog_planar_37x23.tif": "LogLuv in separate planes",
    "tiff_invalid_sgilog_logl_2bit_37x23.tif": "LogL of 2-bit samples",
}
# fixtures cv2.imread reads otherwise than cv2.imdecode (a TIFF file is mapped into
# memory): their file reads go into digests.json's "file_reads"
FILE_READS = ("tiff_invalid_tiles_rgb_37x23.tif", "tiff_invalid_tiles_gray_37x23.tif", "tiff_tiles_rgba_short_37x23.tif")


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def draw(h: int, w: int, seed: int, cv2) -> np.ndarray:
    """BGR uint8: a smooth two-axis gradient with a few filled and hollow shapes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    c0, c1, c2 = rng.uniform(40, 200, 3)
    img = np.stack([c0 + 50 * np.sin(xx / max(w, 1) * 3.1 + seed),
                    c1 + 50 * np.cos(yy / max(h, 1) * 2.3),
                    c2 + 30 * np.sin((xx + yy) / max(h + w, 1) * 5.0)], -1)
    img = np.clip(img, 0, 255).astype(np.uint8)
    for _ in range(6):
        x0, y0 = int(rng.integers(0, w)), int(rng.integers(0, h))
        x1, y1 = int(rng.integers(x0, w + 1)), int(rng.integers(y0, h + 1))
        col = tuple(int(c) for c in rng.integers(0, 256, 3))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            cv2.rectangle(img, (x0, y0), (x1, y1), col, -1)
        elif kind == 1:
            cv2.ellipse(img, ((x0 + x1) // 2, (y0 + y1) // 2), (max(1, (x1 - x0) // 2), max(1, (y1 - y0) // 2)),
                        0, 0, 360, col, -1)
        else:
            cv2.rectangle(img, (x0, y0), (x1, y1), col, max(1, min(w, h) // 40))
    return img


def jpeg(img: np.ndarray, cv2, quality: int = 95, sampling: str = "420", restart: int = 0,
         optimize: bool = False, progressive: bool = False) -> bytes:
    flags = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
              cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize), cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flags[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def jpeg_segments(data: bytes):
    """[(marker, start, end)] of a JPEG's segments up to EOI; an SOS segment's end is
    the end of its entropy-coded data."""
    out, pos = [], 2
    while pos + 1 < len(data) and data[pos + 1] != 0xD9:
        marker = data[pos + 1]
        end = pos + 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in (0x00, *range(0xD0, 0xD8))):
                end += 1
        out.append((marker, pos, end))
        pos = end
    return out


def std_huffman(cv2):
    """libjpeg's standard tables (Annex K) as (bits, values) for DC 0, AC 0, DC 1, AC 1,
    read from a cv2 JPEG without optimised tables."""
    data = jpeg(np.zeros((8, 8, 3), np.uint8), cv2)
    tables = {}
    for marker, start, end in jpeg_segments(data):
        if marker == 0xC4:
            at = start + 4
            while at < end:
                bits = list(data[at + 1:at + 17])
                tables[data[at]] = (bits, list(data[at + 17:at + 17 + sum(bits)]))
                at += 17 + sum(bits)
    return [tables[k] for k in (0x00, 0x10, 0x01, 0x11)]


def encode_baseline(planes, factors, cv2, adobe: int | None = None, quality: int = 90) -> bytes:
    """A baseline JPEG of full-size uint8 (H, W) component `planes` at sampling
    `factors` [(h, v)] (any 1-4, subsampled by the nearest sample), one interleaved scan
    with libjpeg's standard Huffman tables (component 0 on tables 0, the others on 1),
    and an Adobe APP14 with transform `adobe` when given. It writes what libjpeg refuses
    too (more than 10 blocks an MCU, fractional ratios), for the tests."""
    height, width = planes[0].shape
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    scale = max(1, 200 - 2 * quality) / 100
    base = np.full(64, 16.0) * (1 + np.add.outer(np.arange(8), np.arange(8)).reshape(-1) / 4)
    qts = [np.clip(np.round(base * scale * (1 + i)), 1, 255).astype(np.int64) for i in range(2)]
    zz = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20,
          13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52,
          45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
    u = np.arange(8)
    dct = np.sqrt(np.where(u == 0, 1, 2) / 8)[:, None] * np.cos((2 * u[None] + 1) * u[:, None] * np.pi / 16)
    huff = std_huffman(cv2)

    def codes(bits, vals):
        out, code, i = {}, 0, 0
        for length, n in enumerate(bits, 1):
            for _ in range(n):
                out[vals[i]] = (code, length)
                code, i = code + 1, i + 1
            code <<= 1
        return out

    enc = [codes(*t) for t in huff]
    mcu_w, mcu_h = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    coefs = []
    for plane, (h, v) in zip(planes, factors):
        ys = np.minimum(np.arange(mcu_h * v * 8) * vmax // v, height - 1)
        xs = np.minimum(np.arange(mcu_w * h * 8) * hmax // h, width - 1)
        dh, dw = -(-height * v // vmax), -(-width * h // hmax)  # replicate past the component's edge
        comp = plane[ys][:, xs].astype(np.float64)
        comp[dh:] = comp[dh - 1]
        comp[:, dw:] = comp[:, dw - 1:dw]
        blocks = (comp - 128).reshape(mcu_h * v, 8, mcu_w * h, 8).transpose(0, 2, 1, 3)
        coefs.append(np.round(dct @ blocks @ dct.T).reshape(mcu_h * v, mcu_w * h, 64))
    bits: list = []

    def put(value: int, n: int):
        bits.extend((value >> (n - 1 - i)) & 1 for i in range(n))

    def put_value(x: int):
        size = abs(x).bit_length()
        return size, (x if x >= 0 else x + (1 << size) - 1)

    pred = [0] * len(planes)
    for my in range(mcu_h):
        for mx in range(mcu_w):
            for ci, (h, v) in enumerate(factors):
                dc_t, ac_t = enc[0 if ci == 0 else 2], enc[1 if ci == 0 else 3]
                q = qts[0 if ci == 0 else 1]
                for by in range(v):
                    for bx in range(h):
                        blk = np.round(coefs[ci][my * v + by, mx * h + bx] / q).astype(np.int64)[zz]
                        size, bits_ = put_value(int(blk[0]) - pred[ci])
                        pred[ci] = int(blk[0])
                        put(*dc_t[size])
                        put(bits_, size)
                        run = 0
                        for k in range(1, 64):
                            if blk[k] == 0:
                                run += 1
                                continue
                            while run > 15:
                                put(*ac_t[0xF0])
                                run -= 16
                            size, bits_ = put_value(int(blk[k]))
                            put(*ac_t[(run << 4) | size])
                            put(bits_, size)
                            run = 0
                        if run:
                            put(*ac_t[0x00])
    bits.extend([1] * (-len(bits) % 8))
    raw = np.packbits(np.asarray(bits, np.uint8)).tobytes().replace(b"\xff", b"\xff\x00")

    def segment(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    out = b"\xff\xd8"
    if adobe is not None:
        out += segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    out += segment(0xDB, b"".join(bytes([i]) + bytes(q[zz].tolist()) for i, q in enumerate(qts)))
    out += segment(0xC0, struct.pack(">BHHB", 8, height, width, len(planes)) + b"".join(
        bytes([ci + 1, (h << 4) | v, 0 if ci == 0 else 1]) for ci, (h, v) in enumerate(factors)))
    out += segment(0xC4, b"".join(bytes([cls]) + bytes(b) + bytes(vals)
                                   for cls, (b, vals) in zip((0x00, 0x10, 0x01, 0x11), huff)))
    out += segment(0xDA, bytes([len(planes)]) + b"".join(
        bytes([ci + 1, 0x00 if ci == 0 else 0x11]) for ci in range(len(planes))) + b"\x00\x3f\x00")
    return out + raw + b"\xff\xd9"


def ycc_planes(bgr: np.ndarray):
    """Y, Cb, Cr (JFIF) of a BGR image as uint8 planes."""
    b, g, r = (bgr[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128 + 0.5 * r - 0.418688 * g - 0.081312 * b
    return [np.clip(np.round(c), 0, 255).astype(np.uint8) for c in (y, cb, cr)]


def without_refinement(data: bytes) -> bytes:
    """A progressive JPEG without its refinement scans (SOS with Ah > 0)."""
    out, last = b"", 0
    for marker, start, end in jpeg_segments(data):
        if marker == 0xDA:
            ns = data[start + 4]
            if data[start + 7 + 2 * ns] >> 4:
                out += data[last:start]
                last = end
    return out + data[last:]


def pil_cmyk(bgr: np.ndarray, progressive: bool = False) -> bytes:
    """A CMYK JPEG as PIL writes it (Adobe transform 0)."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(bgr[..., ::-1])).convert("CMYK").save(
        buf, "JPEG", quality=90, progressive=progressive)
    return buf.getvalue()


def with_orientation(data: bytes, orientation: int) -> bytes:
    """The JPEG with an Exif APP1 (IFD0: one orientation entry) after SOI."""
    tiff = b"II*\0" + struct.pack("<I", 8) + struct.pack("<H", 1)
    tiff += struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0)
    payload = b"Exif\0\0" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload + data[2:]


def png(rows_hw: np.ndarray, color_type: int, depth: int, interlace: bool = False,
        palette: np.ndarray | None = None) -> bytes:
    """A PNG of `rows_hw` ((H, W, channels) samples at `depth`), its rows filtered with
    filter r % 5, for Adam7 per pass."""
    from ssd_object_detection_tpu_torch.data.codec import ADAM7

    h, w = rows_hw.shape[:2]
    ch = rows_hw.shape[2]

    def pack_rows(a: np.ndarray) -> list:
        out = []
        for row in a:
            flat = row.reshape(-1).astype(np.int64)
            if depth == 16:
                out.append(np.stack([flat >> 8, flat & 255], 1).reshape(-1).astype(np.uint8))
            elif depth == 8:
                out.append(flat.astype(np.uint8))
            else:
                per = 8 // depth
                padded = np.concatenate([flat, np.zeros((-len(flat)) % per, np.int64)]).reshape(-1, per)
                shifts = 8 - depth * (np.arange(per) + 1)
                out.append((padded << shifts).sum(1).astype(np.uint8))
        return out

    def filtered(lines: list, bpp: int) -> bytes:
        out, prev = bytearray(), np.zeros(len(lines[0]), np.int64)
        for r, line in enumerate(lines):
            x = line.astype(np.int64)
            a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
            c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
            b = prev
            kind = r % 5
            if kind == 0:
                f = x
            elif kind == 1:
                f = x - a
            elif kind == 2:
                f = x - b
            elif kind == 3:
                f = x - ((a + b) >> 1)
            else:
                pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
                f = x - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            out.append(kind)
            out += (f & 255).astype(np.uint8).tobytes()
            prev = x
        return bytes(out)

    bpp = max(1, ch * depth // 8)
    body = b""
    for y0, x0, dy, dx in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = rows_hw[y0::dy, x0::dx]
        if sub.size:
            body += filtered(pack_rows(sub), bpp)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(body, 9)) + chunk(b"IEND", b"")


def bmp(pixels: np.ndarray, bpp: int, palette=None, rle: bool = False, top_down: bool = False,
        core: bool = False, masks=None) -> bytes:
    """A BMP: `pixels` are palette indices (bpp 1, 4, 8), 16-bit words (16) or BGR(X)
    bytes (24, 32). `rle` writes RLE8 or RLE4 (`rle_encode`); `core` the 12-byte
    OS/2 header; `masks` (red, green, blue) BITFIELDS; `top_down` a negative height."""
    h, w = pixels.shape[:2]
    rows = pixels[::-1] if not top_down else pixels
    if rle:
        body = rle_encode(rows, bpp)
    else:
        pitch = ((w * bpp + 7) // 8 + 3) & -4
        out = []
        for row in rows:
            if bpp < 8:
                v = np.zeros(w * bpp, np.uint8)
                for b in range(bpp):
                    v[b::bpp] = (row.astype(np.int64) >> (bpp - 1 - b)) & 1
                line = np.packbits(v).tobytes()
            elif bpp == 16:
                line = row.astype("<u2").tobytes()
            else:
                line = row.astype(np.uint8).tobytes()
            out.append(line.ljust(pitch, b"\0"))
        body = b"".join(out)
    colours = b""
    if palette is not None:
        colours = b"".join(bytes([int(c[2]), int(c[1]), int(c[0])]) + (b"" if core else b"\0") for c in palette)
    if core:
        header = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        comp = (2 if bpp == 4 else 1) if rle else (3 if masks else 0)
        header = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp, comp, len(body), 2835, 2835,
                             len(palette) if palette is not None else 0, 0)
        if masks:
            header += struct.pack("<III", *masks)
    offset = 14 + len(header) + len(colours)
    return b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + header + colours + body


def rle_encode(rows: np.ndarray, bpp: int) -> bytes:
    """RLE8 (bpp 8) or RLE4 (bpp 4) of palette-index rows: runs of equal pixels, absolute
    runs of others, an end of line after each row and an end of bitmap; every third
    row ends early (the rest of it index 0, which the reader fills in) and one row
    starts with a delta of 2 pixels (also index 0 there)."""
    out = bytearray()
    for y, row in enumerate(rows):
        row = [int(v) for v in row]
        if y % 3 == 2:
            row = row[:max(1, len(row) // 2)]
        x = 0
        if y == 1 and len(row) > 4:
            out += bytes([0, 2, 2, 0])
            x = 2
        while x < len(row):
            run = 1
            while x + run < len(row) and run < 255 and row[x + run] == row[x]:
                run += 1
            if bpp == 4 and run < 2 and x + 1 < len(row):  # a two-colour run: alternate pixels
                a, b = row[x], row[x + 1]
                run = 2
                while x + run < len(row) and run < 255 and row[x + run] == (a if run % 2 == 0 else b):
                    run += 1
                out += bytes([run, (a << 4) | b])
            elif run >= 3 or x + run >= len(row) or bpp == 4:
                out += bytes([run, (row[x] << 4) | row[x] if bpp == 4 else row[x]])
            else:  # absolute: at least three pixels
                n = min(len(row) - x, 255)
                if n < 3:
                    out += bytes([1, row[x]])
                    x += 1
                    continue
                out += bytes([0, n])
                chunk = row[x:x + n]
                if bpp == 4:
                    data = bytes((chunk[i] << 4) | (chunk[i + 1] if i + 1 < n else 0) for i in range(0, n, 2))
                else:
                    data = bytes(chunk)
                out += data + bytes(len(data) % 2)
                run = n
            x += run
        out += bytes([0, 0])
    out += bytes([0, 1])
    return bytes(out)


def pxm_text(pixels: np.ndarray, code: str, maxval: int) -> bytes:
    """A P1, P2 or P3 with a comment in its header and a few values a line."""
    h, w = pixels.shape[:2]
    head = f"P{code}\n# written by make_image_fixtures\n{w} {h}\n" + (f"{maxval}\n" if code != "1" else "")
    values = [str(int(v)) for v in pixels.reshape(-1)]
    lines = [" ".join(values[i:i + 12]) for i in range(0, len(values), 12)]
    return (head + "\n".join(lines) + "\n").encode()


def pxm_binary(pixels: np.ndarray, code: str, maxval: int) -> bytes:
    """A P5 or P6 (16-bit big-endian samples past maxval 255), a comment in its header."""
    h, w = pixels.shape[:2]
    body = pixels.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return f"P{code}\n{w} # width\n{h}\n{maxval}\n".encode() + body


def sunras(pixels: np.ndarray, bpp: int, colormap=None, encoding: int = 1) -> bytes:
    """A Sun raster: `pixels` palette indices (1, 8 bits) or BGR(X) bytes (24, 32);
    `colormap` (n, 3) RGB; rows padded to 16 bits; `encoding` the type field (0 old,
    1 standard)."""
    h, w = pixels.shape[:2]
    pitch = ((w * bpp + 7) // 8 + 1) & -2
    rows = []
    for row in pixels:
        line = np.packbits(row.astype(np.uint8)).tobytes() if bpp == 1 else row.astype(np.uint8).tobytes()
        rows.append(line.ljust(pitch, b"\0"))
    body = b"".join(rows)
    cmap = b"" if colormap is None else np.asarray(colormap, np.uint8).T.tobytes()
    return struct.pack(">8i", 0x59A66A95, w, h, bpp, len(body), encoding, int(bool(len(cmap))), len(cmap)) + cmap + body


def pfm_big_endian(rgb: np.ndarray, scale: float) -> bytes:
    """A 3-channel PFM with big-endian floats (a positive scale), rows bottom-up."""
    h, w = rgb.shape[:2]
    return f"PF\n{w} {h}\n{scale}\n".encode() + rgb[::-1].astype(">f4").tobytes()


def pam(pixels: np.ndarray, maxval: int, tupltype: str | None = None, header: bytes | None = None) -> bytes:
    """A PAM (P7) of `pixels` ((h, w) or (h, w, depth) samples, big-endian 16 bits past
    maxval 255; at maxval 1, (h, w) bits packed MSB first at the start of each row of
    w x depth bytes, as cv2 reads them), its header `header` if given."""
    h, w = pixels.shape[:2]
    depth = 1 if pixels.ndim == 2 else pixels.shape[2]
    if maxval == 1:
        body = b"".join(np.packbits(row.astype(np.uint8)).tobytes().ljust(w * depth, b"\x5a") for row in pixels)
    else:
        body = pixels.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    if header is None:
        header = f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {depth}\nMAXVAL {maxval}\n".encode()
        header += (f"TUPLTYPE {tupltype}\n".encode() if tupltype else b"") + b"ENDHDR\n"
    return header + body


def bigtiff(pixels: np.ndarray, big_endian: bool = False) -> bytes:
    """A BigTIFF (version 43, 8-byte offsets) of 8-bit RGB (h, w, 3) pixels in one
    uncompressed strip."""
    e = ">" if big_endian else "<"
    h, w = pixels.shape[:2]
    body = pixels.astype(np.uint8).tobytes()
    entries = [(256, 3, 1, w), (257, 3, 1, h), (258, 3, 3, None), (259, 3, 1, 1), (262, 3, 1, 2), (273, 16, 1, 0),
               (277, 3, 1, 3), (278, 3, 1, h), (279, 16, 1, len(body)), (284, 3, 1, 1)]
    data_at = 16 + 8 + 20 * len(entries) + 8
    out = (b"MM" if big_endian else b"II") + struct.pack(e + "HHHQ", 43, 8, 0, 16) + struct.pack(e + "Q", len(entries))
    for tag, kind, count, value in entries:
        if tag == 258:
            raw = struct.pack(e + "4H", 8, 8, 8, 0)
        elif kind == 3:
            raw = struct.pack(e + "H", value) + bytes(6)
        else:
            raw = struct.pack(e + "Q", data_at if tag == 273 else value)
        out += struct.pack(e + "HHQ", tag, kind, count) + raw
    return out + struct.pack(e + "Q", 0) + body


_TIFF_TYPES = {3: "H", 4: "I", 5: "I", 7: "B", 16: "Q"}  # RATIONAL: numerator, denominator


def tiff(tags: dict, chunks: list, big_endian: bool = False, big: bool = False, tiled: bool = False,
         counts=None) -> bytes:
    """A TIFF (a BigTIFF where `big`) of one directory: `tags` {tag: (type, values)} of
    SHORT, LONG, RATIONAL (numerator, denominator pairs), UNDEFINED or LONG8 values, the
    chunks' bytes after the directory, their offsets and
    byte counts (`counts`, where given) in StripOffsets / StripByteCounts or the tile tags."""
    e = ">" if big_endian else "<"
    inline, entry = (8, "HHQ") if big else (4, "HHI")
    tags = dict(tags)
    long_type = 16 if big else 4
    off_tag, count_tag = (324, 325) if tiled else (273, 279)
    tags[off_tag] = (long_type, [0] * len(chunks))
    tags[count_tag] = (long_type, list(counts) if counts is not None else [len(c) for c in chunks])
    head = 16 if big else 8
    ifd = (8 if big else 2) + len(tags) * (20 if big else 12) + (8 if big else 4)
    sizes = {t: struct.calcsize(_TIFF_TYPES[k]) * len(v) for t, (k, v) in tags.items()}
    extra_at = head + ifd
    chunk_at = extra_at + sum(n + (n & 1) for n in sizes.values() if n > inline)
    offsets = np.cumsum([chunk_at] + [len(c) for c in chunks])[:-1].tolist()
    tags[off_tag] = (long_type, offsets)
    out = (b"MM" if big_endian else b"II") + (struct.pack(e + "HHHQ", 43, 8, 0, head) + struct.pack(e + "Q", len(tags))
                                             if big else struct.pack(e + "HI", 42, head) + struct.pack(e + "H", len(tags)))
    extra = b""
    for tag in sorted(tags):
        kind, values = tags[tag]
        raw = struct.pack(e + _TIFF_TYPES[kind] * len(values), *values)
        if len(raw) > inline:
            raw, extra = struct.pack(e + ("Q" if big else "I"), extra_at + len(extra)), extra + raw + bytes(len(raw) & 1)
        out += struct.pack(e + entry, tag, kind, len(values) // (2 if kind == 5 else 1)) + raw.ljust(inline, b"\0")
    return out + bytes(8 if big else 4) + extra + b"".join(chunks)


def tiff_tags(w: int, h: int, bits: int, spp: int, photometric: int, compression: int = 1, rows=None,
              **more) -> dict:
    """The tags of a w x h TIFF: `more` adds tag number: value(s) by name (see TIFF_TAGS)."""
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp]), 278: (4, [rows or h])}
    for name, value in more.items():
        tags[TIFF_TAGS[name]] = (3, list(np.atleast_1d(value).tolist()))
    return tags


TIFF_TAGS = {"orientation": 274, "planar": 284, "predictor": 317, "colormap": 320, "tile_width": 322,
             "tile_length": 323, "extra": 338, "sample_format": 339, "fill_order": 266}


def ycbcr_units(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, hs: int, vs: int) -> np.ndarray:
    """Contiguous subsampled YCbCr (TIFF 6.0 data units): (rows / vs, columns / hs, hs vs +
    2) of each unit's hs x vs Y samples (the image's edge repeated), then its Cb and Cr
    (`cb`, `cr` already subsampled, a sample a unit)."""
    h, w = y.shape
    full = np.pad(y, ((0, -h % vs), (0, -w % hs)), mode="edge")
    units = full.reshape(full.shape[0] // vs, vs, full.shape[1] // hs, hs).transpose(0, 2, 1, 3)
    return np.concatenate([units.reshape(units.shape[0], units.shape[1], vs * hs), cb[..., None], cr[..., None]],
                          -1).astype(np.uint8)


def rationals(values) -> tuple:
    """RATIONAL field values (type 5): each value as a numerator over 10,000."""
    return 5, [x for v in values for x in (int(round(v * 10000)), 10000)]


def colour_tiff_fixtures(cv2) -> dict:
    """YCbCr and CIELab TIFFs, and JPEG-in-TIFFs of 2 and 4 samples and of separate planes,
    as cv2 5.0 reads them through libtiff 4.7's put routines (and those cv2 returns None
    for): PIL's writer (YCbCr at 1 x 1, CIELab, CMYK, RGBA, gray + alpha) and this tool's
    for the subsamplings, tiles, tags and planes PIL does not write."""
    from PIL import Image

    files = {}
    bgr = draw(23, 37, 86, cv2)
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    gray = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    pil = Image.fromarray(rgb)
    for comp in ("raw", "packbits", "tiff_lzw", "tiff_deflate"):
        files[f"tiff_pil_ycbcr_{comp.replace('tiff_', '')}_37x23.tif"] = pil_tiff(pil.convert("YCbCr"), comp)
    lab_img = pil.convert("LAB")
    lab_img.info.pop("icc_profile", None)  # PIL's Lab profile carries its creation time: the files stay the same
    for comp in ("raw", "packbits", "tiff_lzw", "tiff_deflate", "jpeg"):
        files[f"tiff_pil_lab_{comp.replace('tiff_', '')}_37x23.tif"] = pil_tiff(lab_img, comp)
    for mode, img in (("cmyk", pil.convert("CMYK")), ("rgba", Image.fromarray(np.dstack([rgb, gray]))),
                      ("la", Image.fromarray(np.dstack([gray, 255 - gray // 2])).convert("LA"))):
        files[f"tiff_jpeg_pil_{mode}_37x23.tif"] = pil_tiff(img, "jpeg")
    ycc = np.asarray(pil.convert("YCbCr"))
    lzw = lambda b: tiff_lzw_pack(tiff_lzw_codes(b))  # noqa: E731
    codecs = {"none": (1, lambda b: b), "lzw": (5, lzw), "packbits": (32773, packbits), "deflate": (8, zlib.compress)}

    def subsampled(img, hs, vs, rows):
        """Strips of `rows` rows of contiguous YCbCr units of (h, w, 3) Y, Cb, Cr samples."""
        out = []
        for r in range(0, img.shape[0], rows):
            part = img[r:r + rows]
            out.append(ycbcr_units(part[..., 0], part[::vs, ::hs, 1], part[::vs, ::hs, 2], hs, vs).tobytes())
        return out

    def ycbcr_tags(sub, compression=1, rows=8, w=37, h=23, **more):
        tags = tiff_tags(w, h, 8, 3, 6, compression, rows=rows, **more)
        tags[530] = (3, list(sub))
        return tags

    for hs, vs in ((1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)):  # putcontig8bitYCbCr<hs><vs>tile
        for name, (code, enc) in codecs.items():
            files[f"tiff_ycbcr{hs}{vs}_{name}_37x23.tif"] = tiff(ycbcr_tags((hs, vs), code),
                                                                 [enc(c) for c in subsampled(ycc, hs, vs, 8)])
    files["tiff_ycbcr22_rows5_37x23.tif"] = tiff(ycbcr_tags((2, 2), 8, 5),
                                                 [zlib.compress(c) for c in subsampled(ycc, 2, 2, 5)])
    files["tiff_ycbcr22_orientation6_37x23.tif"] = tiff(ycbcr_tags((2, 2), 5, orientation=6),
                                                        [lzw(c) for c in subsampled(ycc, 2, 2, 8)])
    for (hs, vs), name in (((2, 2), "predictor"), ((2, 1), "predictor_fails")):
        # the predictor walks scanlines (a unit row's bytes / vs), 3 bytes a pixel; 37
        # pixels at 2 x 1 make scanlines of 76 bytes, which horAcc8 refuses
        units = ycbcr_units(ycc[..., 0], ycc[::vs, ::hs, 1], ycc[::vs, ::hs, 2], hs, vs).tobytes()
        lines = np.frombuffer(units, np.uint8).reshape(-1, len(units) // (-(-23 // vs) * vs))
        data = hdiff(lines, 3, 8).astype(np.uint8).tobytes() if lines.shape[1] % 3 == 0 else units
        files[f"tiff_ycbcr{hs}{vs}_{name}_37x23.tif"] = tiff(ycbcr_tags((hs, vs), 5, 23, predictor=2), [lzw(data)])
    for hs, vs in ((2, 2), (4, 4)):  # tiles cut at the right and bottom edges (4 x 4: libtiff's 10-byte skew)
        tiles = []
        for ty in range(0, 23, 16):
            for tx in range(0, 37, 16):
                t = np.pad(ycc[ty:ty + 16, tx:tx + 16], ((0, max(0, ty + 16 - 23)), (0, max(0, tx + 16 - 37)),
                                                           (0, 0)), mode="edge")
                tiles.append(zlib.compress(ycbcr_units(t[..., 0], t[::vs, ::hs, 1], t[::vs, ::hs, 2], hs,
                                                       vs).tobytes()))
        tags = ycbcr_tags((hs, vs), 8, tile_width=16, tile_length=16)
        del tags[278]
        files[f"tiff_ycbcr{hs}{vs}_tiles_37x23.tif"] = tiff(tags, tiles, tiled=True)
    files["tiff_ycbcr_planar_37x23.tif"] = tiff(ycbcr_tags((1, 1), 8, planar=2),
                                                [zlib.compress(ycc[..., c].tobytes()) for c in range(3)])
    tags = ycbcr_tags((1, 1), 1, 23)
    tags[529] = rationals((0.2126, 0.7152, 0.0722))
    tags[532] = rationals((16, 235, 128, 240, 128, 240))
    files["tiff_ycbcr_bt709_37x23.tif"] = tiff(tags, [ycc.tobytes()])
    odd = draw(17, 33, 87, cv2)[..., ::-1]  # 4 x 4 units 9 to a row: 162 bytes, no whole number of scanlines
    files["tiff_refused_ycbcr44_odd_units_33x17.tif"] = tiff(
        ycbcr_tags((4, 4), 1, 4, 33, 17), subsampled(np.asarray(Image.fromarray(odd).convert("YCbCr")), 4, 4, 4))
    lab = np.asarray(lab_img)
    lab16 = lab.astype(np.uint16) * 257 + np.arange(37, dtype=np.uint16)[None, :, None]
    lab16[..., 1:] = (lab[..., 1:].view(np.int8).astype(np.int16) * 256 + 77).view(np.uint16)
    files["tiff_lab16_37x23.tif"] = tiff(tiff_tags(37, 23, 16, 3, 8, 5, predictor=2),
                                         [lzw(hdiff(lab16.reshape(23, -1), 3, 16).astype("<u2").tobytes())])
    files["tiff_lab16_be_37x23.tif"] = tiff(tiff_tags(37, 23, 16, 3, 8), [lab16.astype(">u2").tobytes()],
                                            big_endian=True)
    tags = tiff_tags(37, 23, 8, 3, 8, 8)
    tags[318] = rationals((0.3127, 0.3290))  # D65
    files["tiff_lab_d65_37x23.tif"] = tiff(tags, [zlib.compress(lab.tobytes())])
    tags = tiff_tags(37, 23, 8, 3, 8, 8, tile_width=16, tile_length=16)
    del tags[278]
    files["tiff_lab_tiles_37x23.tif"] = tiff(tags, [zlib.compress(np.pad(
        lab[y:y + 16, x:x + 16], ((0, max(0, y + 16 - 23)), (0, max(0, x + 16 - 37)), (0, 0))).tobytes())
        for y in range(0, 23, 16) for x in range(0, 37, 16)], tiled=True)
    # JPEG-in-TIFF of separate planes (each plane's chunk a gray JPEG) and of 4 samples in tiles
    big = draw(45, 67, 88, cv2)
    for name, photometric, planes in (("rgb", 2, [big[..., c] for c in (2, 1, 0)]),
                                      ("ycbcr", 6, [np.ascontiguousarray(p) for p in np.moveaxis(np.asarray(
                                          Image.fromarray(big[..., ::-1]).convert("YCbCr")), -1, 0)])):
        streams = [jpeg(np.ascontiguousarray(p[y:y + 16]), cv2) for p in planes for y in range(0, 45, 16)]
        tables, chunks = jpeg_tables(streams)
        tags = tiff_tags(67, 45, 8, 3, photometric, 7, rows=16, planar=2)
        tags[347] = (7, list(tables))
        if photometric == 6:
            tags[530] = (3, [1, 1])
        files[f"tiff_jpeg_planar_{name}_67x45.tif"] = tiff(tags, chunks)
    cmyk = np.asarray(Image.fromarray(big[..., ::-1]).convert("CMYK"))
    pad = np.pad(cmyk, ((0, 3), (0, 29), (0, 0)), mode="edge")
    tables, chunks = jpeg_tables([encode_baseline([np.ascontiguousarray(pad[y:y + 16, x:x + 32, c]) for c in range(4)],
                                                  [(1, 1)] * 4, cv2)
                                  for y in range(0, 45, 16) for x in range(0, 67, 32)])
    tags = tiff_tags(67, 45, 8, 4, 5, 7, tile_width=32, tile_length=16)
    del tags[278]
    tags[347] = (7, list(tables))
    files["tiff_jpeg_cmyk_tiles_67x45.tif"] = tiff(tags, chunks, tiled=True)
    ga = np.pad(np.dstack([cv2.cvtColor(big, cv2.COLOR_BGR2GRAY), big[..., 0]]), ((0, 3), (0, 29), (0, 0)), mode="edge")
    tables, chunks = jpeg_tables([encode_baseline([np.ascontiguousarray(ga[y:y + 16, x:x + 32, c]) for c in range(2)],
                                                  [(1, 1)] * 2, cv2)
                                  for y in range(0, 45, 16) for x in range(0, 67, 32)])
    tags = tiff_tags(67, 45, 8, 2, 1, 7, tile_width=32, tile_length=16, extra=2)
    del tags[278]
    tags[347] = (7, list(tables))
    files["tiff_jpeg_gray_alpha_tiles_67x45.tif"] = tiff(tags, chunks, tiled=True)  # libtiff's skew at the edge
    # what cv2 returns None for
    for photometric, name in ((9, "icclab"), (10, "itulab")):
        files[f"tiff_invalid_{name}_37x23.tif"] = tiff(tiff_tags(37, 23, 8, 3, photometric), [lab.tobytes()])
    files["tiff_invalid_lab_alpha_37x23.tif"] = tiff(tiff_tags(37, 23, 8, 4, 8, extra=2),
                                                     [np.dstack([lab, gray]).tobytes()])
    files["tiff_invalid_lab_planar_37x23.tif"] = tiff(tiff_tags(37, 23, 8, 3, 8, planar=2),
                                                      [lab[..., c].tobytes() for c in range(3)])
    files["tiff_invalid_ycbcr24_37x23.tif"] = tiff(ycbcr_tags((2, 4), 1, 8), subsampled(ycc, 2, 4, 8))
    files["tiff_invalid_ycbcr_planar22_37x23.tif"] = tiff(ycbcr_tags((2, 2), 8, planar=2),
                                                          [zlib.compress(ycc[..., c].tobytes()) for c in range(3)])
    tags = tiff_tags(37, 23, 8, 4, 6, extra=2)
    tags[530] = (3, [1, 1])
    files["tiff_invalid_ycbcr_alpha_37x23.tif"] = tiff(tags, [np.dstack([ycc, gray]).tobytes()])
    files["tiff_jpeg_invalid_ycbcr_alpha_37x23.tif"] = set_tags(files["tiff_jpeg_pil_rgba_37x23.tif"], {262: 6})
    return files


def tiff_lzw_codes(data: bytes) -> list:
    """TIFF LZW codes of `data`: Clear first, EOI last, a Clear before the table's next
    entry would reach 4094 (as libtiff's encoder)."""
    fresh = {bytes([i]): i for i in range(256)}
    codes, table, nxt, w = [256], dict(fresh), 258, b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        codes.append(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt >= 4094:
            codes.append(256)
            table, nxt = dict(fresh), 258
        w = bytes([c])
    return codes + ([table[w]] if w else []) + [257]


def tiff_lzw_pack(codes: list, old: bool = False) -> bytes:
    """The codes as libtiff reads them: MSB first, 9 bits after a Clear, one bit more once
    the table's next entry reaches 511, 1023 and 2047 (early change); `old`: old-style
    codes (LZWDecodeCompat), LSB first, one bit more once it reaches 512, 1024 and 2048."""
    if old:
        acc = nbits = 0
        out = bytearray()
        free, first = 258, True
        for code in codes:
            size = min(12, free.bit_length())
            acc, nbits = acc | code << nbits, nbits + size
            while nbits >= 8:
                out.append(acc & 255)
                acc, nbits = acc >> 8, nbits - 8
            if code == 256:
                free, first = 258, True
            elif code != 257 and not first:
                free += 1
            elif code != 257:
                first = False
        return bytes(out + (bytearray([acc & 255]) if nbits else b""))
    acc = nbits = 0
    out = bytearray()
    free, first = 258, True
    for code in codes:
        size = 9 if free < 511 else 10 if free < 1023 else 11 if free < 2047 else 12
        acc, nbits = (acc << size) | code, nbits + size
        while nbits >= 8:
            out.append((acc >> (nbits - 8)) & 255)
            nbits -= 8
        acc &= (1 << nbits) - 1
        if code == 256:
            free, first = 258, True
        elif code != 257 and not first:
            free += 1
        elif code != 257:
            first = False
    return bytes(out + (bytearray([(acc << (8 - nbits)) & 255]) if nbits else b""))


def hdiff(rows: np.ndarray, spp: int, bits: int) -> np.ndarray:
    """TIFF's horizontal predictor over (rows, samples) of pixels of `spp` samples."""
    a = rows.astype(np.int64)
    out = a.copy()
    out[:, spp:] = a[:, spp:] - a[:, :-spp]
    return out & ((1 << bits) - 1)


def pil_tiff(img, compression: str) -> bytes:
    import io

    buf = io.BytesIO()
    img.save(buf, "TIFF", compression=compression)
    return buf.getvalue()


def tiff_fixtures(cv2) -> dict:
    """TIFFs as cv2 5.0 reads them through libtiff 4.7 (and refuses, and returns None for)."""
    from PIL import Image

    files = {}
    bgr = draw(23, 37, 80, cv2)
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    gray = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    files["tiff_cv2_37x23.tif"] = cv2.imencode(".tiff", bgr)[1].tobytes()  # LZW, predictor 2, one strip
    files["tiff_cv2_gray_37x23.tif"] = cv2.imencode(".tiff", gray)[1].tobytes()
    files["tiff_cv2_16bit_37x23.tif"] = cv2.imencode(".tiff", bgr.astype(np.uint16) * 257 + 5)[1].tobytes()
    for name, params in (("none", 1), ("packbits", 32773), ("deflate", 8)):
        files[f"tiff_cv2_{name}_37x23.tif"] = cv2.imencode(".tiff", bgr, [cv2.IMWRITE_TIFF_COMPRESSION, params])[
            1].tobytes()
    files["tiff_cv2_640x480.tif"] = cv2.imencode(".tiff", draw(480, 640, 81, cv2))[1].tobytes()
    modes = {"L": Image.fromarray(gray), "P": Image.fromarray(rgb).convert("P"), "1": Image.fromarray(gray > 120),
             "RGB": Image.fromarray(rgb), "RGBA": Image.fromarray(np.dstack([rgb, gray[..., None] // 2 + 100])),
             "CMYK": Image.fromarray(rgb).convert("CMYK"),
             "I;16": Image.fromarray((gray.astype(np.uint16) * 257 + np.arange(37, dtype=np.uint16)).astype(np.uint16))}
    for mode, img in modes.items():
        for comp in ("raw", "packbits", "tiff_lzw", "tiff_deflate"):
            files[f"tiff_pil_{mode.replace(';', '').lower()}_{comp.replace('tiff_', '')}_37x23.tif"] = pil_tiff(img, comp)
    rng = np.random.default_rng(82)
    lzw = lambda b: tiff_lzw_pack(tiff_lzw_codes(b))  # noqa: E731
    # tiles, 16 x 16 LZW with the predictor, cut at the right and bottom edges
    th = tw = 16
    tiles = []
    for y in range(0, 23, th):
        for x in range(0, 37, tw):
            t = np.zeros((th, tw, 3), np.uint8)
            part = rgb[y:y + th, x:x + tw]
            t[:part.shape[0], :part.shape[1]] = part
            tiles.append(lzw(hdiff(t.reshape(th, -1), 3, 8).astype(np.uint8).tobytes()))
    tile_tags = tiff_tags(37, 23, 8, 3, 2, 5, predictor=2, tile_width=tw, tile_length=th)
    del tile_tags[278]
    files["tiff_tiled_37x23.tif"] = tiff(tile_tags, tiles, tiled=True)
    for o in (2, 6):  # libtiff mirrors each tile where the orientation flips columns
        files[f"tiff_tiled_orientation{o}_37x23.tif"] = tiff({**tile_tags, 274: (3, [o])}, tiles, tiled=True)
    gtiles = []  # gray + alpha, 8-bit, tiles cut at the right edge: libtiff's skewed rows
    ga = np.dstack([gray, 255 - gray])
    for y in range(0, 23, th):
        for x in range(0, 37, tw):
            t = np.zeros((th, tw, 2), np.uint8)
            part = ga[y:y + th, x:x + tw]
            t[:part.shape[0], :part.shape[1]] = part
            gtiles.append(zlib.compress(t.tobytes()))
    gtags = tiff_tags(37, 23, 8, 2, 1, 8, tile_width=tw, tile_length=th, extra=2)
    del gtags[278]
    files["tiff_tiled_gray_alpha_37x23.tif"] = tiff(gtags, gtiles, tiled=True)
    planes = [lzw(hdiff(rgb[..., c], 1, 8).astype(np.uint8).tobytes()) for c in range(3)]
    files["tiff_planar_37x23.tif"] = tiff(tiff_tags(37, 23, 8, 3, 2, 5, predictor=2, planar=2), planes)
    cmyk = np.asarray(modes["CMYK"])
    files["tiff_cmyk_planar_37x23.tif"] = tiff(tiff_tags(37, 23, 8, 4, 5, 8, planar=2),
                                               [zlib.compress(cmyk[..., c].tobytes()) for c in range(4)])
    wide = bgr.astype(np.uint16) * 251 + np.arange(37, dtype=np.uint16)[None, :, None]
    files["tiff_be_16bit_37x23.tif"] = tiff(tiff_tags(37, 23, 16, 3, 2, 5, predictor=2),
                                            [lzw(hdiff(wide.reshape(23, -1), 3, 16).astype(">u2").tobytes())],
                                            big_endian=True)
    files["tiff_be_gray16_37x23.tif"] = tiff(tiff_tags(37, 23, 16, 1, 1), [wide[..., 0].astype(">u2").tobytes()],
                                             big_endian=True)
    for big_endian in (False, True):
        order = "be" if big_endian else "le"
        files[f"tiff_bigtiff_lzw_{order}_37x23.tif"] = tiff(tiff_tags(37, 23, 8, 3, 2, 5, rows=8),
                                                            [lzw(rgb[y:y + 8].tobytes()) for y in range(0, 23, 8)],
                                                            big_endian, big=True)
    files["tiff_miniswhite_37x23.tif"] = tiff(tiff_tags(37, 23, 8, 1, 0), [gray.tobytes()])
    files["tiff_miniswhite_1bit_37x23.tif"] = tiff(tiff_tags(37, 23, 1, 1, 0), [np.packbits(gray > 99, 1).tobytes()])
    for o in range(1, 9):
        files[f"tiff_orientation{o}_37x23.tif"] = tiff(tiff_tags(37, 23, 8, 3, 2, 5, rows=5, orientation=o),
                                                       [lzw(rgb[y:y + 5].tobytes()) for y in range(0, 23, 5)])
    index = (gray // 16).astype(np.uint8)
    cmap16 = rng.integers(0, 65536, (3, 256))
    cmap8 = rng.integers(0, 256, (3, 256))  # entries under 256: libtiff takes them as 8-bit
    for name, cmap in (("cmap16", cmap16), ("cmap8", cmap8)):
        files[f"tiff_palette_{name}_37x23.tif"] = tiff(tiff_tags(37, 23, 8, 1, 3, colormap=cmap.reshape(-1)),
                                                       [index.tobytes()])
    rgba = np.dstack([rgb, gray])
    for extra in (0, 1, 2):  # unspecified, associated and unassociated alpha (premultiplied)
        files[f"tiff_rgba_extra{extra}_37x23.tif"] = tiff(tiff_tags(37, 23, 8, 4, 2, 8, extra=extra),
                                                          [zlib.compress(rgba.tobytes())])
    rev = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
    files["tiff_fill_order2_37x23.tif"] = tiff(tiff_tags(37, 23, 8, 3, 2, fill_order=2),
                                               [rgb.tobytes().translate(rev)])
    files["tiff_packbits_cut_37x23.tif"] = tiff(tiff_tags(37, 23, 8, 3, 2, 32773), [packbits(rgb.tobytes())[:-40]])
    files["tiff_deflate_cut_37x23.tif"] = tiff(tiff_tags(37, 23, 8, 3, 2, 8), [zlib.compress(rgb.tobytes())[:600]])
    # libtiff's LZW stopping rules (a chunk that fails keeps what decoded, without the predictor)
    codes = tiff_lzw_codes(gray.tobytes())
    noise = rng.integers(0, 256, 100 * 100).astype(np.uint8)
    edge = {"eoi_early": codes[:300] + [257], "runout": codes[:300], "past_table": codes[:300] + [1000] + codes[300:],
            "extra_codes": codes[:-1] + [5, 6, 7, 257], "no_clear": codes[1:], "clear_eoi": [256, 257] + codes}
    for name, c in edge.items():
        files[f"tiff_lzw_{name}_37x23.tif"] = tiff(tiff_tags(37, 23, 8, 1, 1, 5, predictor=2),
                                                   [tiff_lzw_pack(c)] if name != "extra_codes" else
                                                   [tiff_lzw_pack(tiff_lzw_codes(hdiff(gray, 1, 8).astype(
                                                       np.uint8).tobytes())[:-1] + [5, 6, 7, 257])])
    # widths 9-12 (no Clear: the table fills, grows unreached past 4096 and fails at 5119)
    files["tiff_lzw_full_table_100x100.tif"] = tiff(tiff_tags(100, 100, 8, 1, 1, 5),
                                                    [tiff_lzw_pack([256] + noise.tolist() + [257])])
    files["tiff_lzw_widths_100x100.tif"] = tiff(tiff_tags(100, 100, 8, 1, 1, 5),
                                                [tiff_lzw_pack([256] + noise[:4000].tolist() + [256]
                                                               + noise[4000:].tolist() + [257])])
    for mode in ("RGB", "YCbCr", "L"):  # libtiff's JPEG codec through PIL: one strip each
        files[f"tiff_jpeg_pil_{mode.lower()}_37x23.tif"] = pil_tiff(modes["RGB"].convert(mode), "jpeg")
    files["tiff_group4_37x23.tif"] = pil_tiff(modes["1"], "group4")
    files["tiff_refused_ycbcr_37x23.tif"] = pil_tiff(modes["RGB"].convert("YCbCr"), "raw")
    files["tiff_invalid_float_37x23.tif"] = pil_tiff(Image.fromarray(gray.astype(np.float32)), "raw")
    files["tiff_invalid_int32_37x23.tif"] = pil_tiff(Image.fromarray(gray.astype(np.int32)), "raw")
    files["tiff_invalid_2bit_37x23.tif"] = tiff(tiff_tags(37, 23, 2, 1, 1), [bytes(23 * 10)])
    files["tiff_invalid_strip_past_end_37x23.tif"] = tiff(tiff_tags(37, 23, 8, 3, 2, 5, rows=12),
                                                          [lzw(rgb[:12].tobytes()), lzw(rgb[12:].tobytes())],
                                                          counts=[len(lzw(rgb[:12].tobytes())), 10 ** 6])
    return files


# ---------------------------------------------------------------------------- CCITT, ThunderScan, old-style LZW
def t4_run(run: int, black: bool) -> str:
    """A run's T.4 code words (first bit first), as libtiff's putspan writes them: 2560
    make-ups while 2624 or more are left, a make-up of the rest's multiple of 64, then the
    terminating code."""
    from ssd_object_detection_tpu_torch.ops import plain_image as pi

    term, makeup = (pi._BLACK_TERM, pi._BLACK_MAKEUP) if black else (pi._WHITE_TERM, pi._WHITE_MAKEUP)
    out = ""
    while run >= 2624:
        out, run = out + pi._EXT_MAKEUP[-1], run - 2560
    if run >= 64:
        m = run // 64
        out += makeup[m - 1] if m <= 27 else pi._EXT_MAKEUP[m - 28]
        run -= 64 * m
    return out + term[run]


def _changes(row: np.ndarray) -> list:
    """A row's changing elements (the pixels whose colour differs from the one before,
    white before the first), then the width twice."""
    w = len(row)
    return np.flatnonzero(np.diff(np.concatenate([[False], row]).astype(np.int8))).tolist() + [w, w]


def _code2d(row: np.ndarray, ref: np.ndarray) -> str:
    """A row's T.4 2-D codes (pass, horizontal and vertical modes) against `ref`."""
    w, a, r = len(row), _changes(row), _changes(ref)
    out, a0, black = [], -1, False
    while a0 < w:
        i = next(i for i, x in enumerate(a) if x > a0)
        a1, a2 = a[i], a[min(i + 1, len(a) - 1)]
        j = next(j for j, x in enumerate(r) if x > a0 and (j & 1) == black)
        b1, b2 = r[j], r[min(j + 1, len(r) - 1)]
        if b2 < a1:
            out.append("0001")
            a0 = b2
        elif abs(a1 - b1) <= 3:
            out.append({0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010", -2: "000010", -3: "0000010"}[a1 - b1])
            a0, black = a1, not black
        else:
            out.append("001" + t4_run(a1 - max(a0, 0), black) + t4_run(a2 - a1, not black))
            a0 = a2
    return "".join(out)


def fax_rows(bits: np.ndarray, mode: str, prefix: str = "") -> bytes:
    """CCITT coding of rows of bits (True black), 1-D (modified Huffman) but where said:
    "rle" each row byte-aligned (compression 2), "rlew" word-aligned (32771), "g3" each row
    after an EOL (compression 3), "g3fill" with fill bits before each EOL so that it ends a
    byte (T4Options bit 2), "noeol" the rows back to back (compression 3 without EOLs),
    "g3_2d" each row after an EOL and its tag bit, the first 1-D and the rest 2-D (T4Options
    bit 0), "g4" every row 2-D, no EOL (compression 4); `prefix`: code bits before them."""
    out = [prefix]
    ref = np.zeros(np.asarray(bits).shape[1:], bool)
    for k, row in enumerate(np.asarray(bits, bool)):
        if mode in ("g3", "g3fill", "g3_2d"):
            if mode == "g3fill":
                out.append("0" * (-(sum(map(len, out)) + 12) % 8))
            out.append("000000000001")
        if mode == "g3_2d":
            out.append("1" if k == 0 else "0")
        if mode == "g4" or (mode == "g3_2d" and k):
            out.append(_code2d(row, ref))
            ref = row
            continue
        ref = row
        edges = np.flatnonzero(np.diff(np.concatenate([[False], row, [not row[-1]]]).astype(np.int8))).tolist()
        runs = np.diff([0] + edges).tolist()  # white first (0 where the row starts black)
        out.extend(t4_run(r, i & 1 == 1) for i, r in enumerate(runs))
        if mode in ("rle", "rlew"):
            out.append("0" * (-sum(map(len, out)) % (8 if mode == "rle" else 16)))
    text = "".join(out)
    text += "0" * (-len(text) % 8)
    return int(text, 2).to_bytes(len(text) // 8, "big") if text else b""


def thunder_rows(index: np.ndarray, skips: bool = True) -> bytes:
    """ThunderScan (tif_thunder.c's format; libtiff has no encoder) of rows of 4-bit
    pixels: runs of the last pixel (0 at each row's start), three 2-bit or two 3-bit
    deltas a byte (with their skip codes where fewer follow, and, where `skips`, a skip
    in the middle now and then), raw nibbles."""
    two = {0: 0, 1: 1, -1: 3}
    three = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    out = bytearray()
    for row in np.asarray(index, np.int64):
        last, i, w = 0, 0, len(row)
        while i < w:
            n = 0
            while i + n < w and n < 63 and row[i + n] == last:
                n += 1
            if n >= 2:
                out.append(n)
                i += n
                continue
            d = []
            while i + len(d) < w and len(d) < 3 and row[i + len(d)] - (row[i + len(d) - 1] if d else last) in two:
                d.append(int(row[i + len(d)] - (row[i + len(d) - 1] if d else last)))
            if len(d) >= 2:
                codes = [two[x] for x in d] + [2] * (3 - len(d))
                if skips and len(d) == 2 and i % 3 == 0:
                    codes = [codes[0], 2, codes[1]]
                out.append(0x40 | codes[0] << 4 | codes[1] << 2 | codes[2])
                last, i = int(row[i + len(d) - 1]), i + len(d)
                continue
            d = []
            while i + len(d) < w and len(d) < 2 and row[i + len(d)] - (row[i + len(d) - 1] if d else last) in three:
                d.append(int(row[i + len(d)] - (row[i + len(d) - 1] if d else last)))
            if d:
                codes = [three[x] for x in d] + [4] * (2 - len(d))
                out.append(0x80 | codes[0] << 3 | codes[1])
                last, i = int(row[i + len(d) - 1]), i + len(d)
                continue
            out.append(0xC0 | int(row[i]))
            last, i = int(row[i]), i + 1
    return bytes(out)


def text_page(h: int, w: int, seed: int) -> np.ndarray:
    """A synthetic page of text (True black): lines of words of 5 x 7 glyphs drawn 3x, in
    margins, as a fax page holds them."""
    rng = np.random.default_rng(seed)
    glyphs = rng.random((64, 7, 5)) < 0.45
    page = np.zeros((h, w), bool)
    for y in range(h // 12, h - h // 12 - 21, 36):
        x = w // 12
        while x < w - w // 12 - 60:
            for _ in range(int(rng.integers(2, 10))):
                if x > w - w // 12 - 15:
                    break
                page[y:y + 21, x:x + 15] = np.kron(glyphs[rng.integers(0, 64)], np.ones((3, 3), bool))
                x += 18
            x += int(rng.integers(12, 24))
    return page


def fax_fixtures(cv2) -> dict:
    """The CCITT codecs on 1-bit samples (PIL's libtiff writer: modified Huffman, Group 3
    1-D, 2-D and 2-D with fill bits, Group 4, FillOrder 2, strips of 7 rows, MinIsBlack;
    the encoders here: RLEW, Group 3 1-D in tiles and without EOLs, and the latter beside a
    strip with them; the 1728 x 2200 Group 4 page of text), ThunderScan on 4-bit palettes
    (strips, cut and overfull rows, a run ending a row) and old-style LZW codes."""
    from PIL import Image

    files = {}
    bgr = draw(23, 37, 85, cv2)
    gray = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    bits = gray > 110
    img = Image.fromarray(bits)
    for comp, name, info in (("tiff_ccitt", "mh", {}), ("group3", "g3", {}), ("group3", "g3_2d", {292: 1}),
                             ("group3", "g3_2d_fill", {292: 5}), ("group4", "g4", {}),
                             ("group3", "g3_2d_fill_order2", {292: 1, 266: 2}), ("group4", "g4_fill_order2", {266: 2}),
                             ("group4", "g4_strips", {278: 7}), ("group3", "g3_2d_strips", {292: 1, 278: 7}),
                             ("tiff_ccitt", "mh_strips", {278: 7}), ("group3", "g3_uncompressed_option", {292: 3}),
                             ("group4", "g4_uncompressed_option", {293: 2})):
        buf = __import__("io").BytesIO()
        img.save(buf, "TIFF", compression=comp, tiffinfo=info)
        files[f"tiff_ccitt_{name}_37x23.tif"] = buf.getvalue()
    files["tiff_ccitt_g4_minisblack_37x23.tif"] = set_tags(files["tiff_ccitt_g4_37x23.tif"], {262: 1})
    files["tiff_ccitt_g3_2d_minisblack_37x23.tif"] = set_tags(files["tiff_ccitt_g3_2d_37x23.tif"], {262: 1})
    for mode, comp, opts in (("rlew", 32771, None), ("g3fill", 3, 4), ("noeol", 3, None)):
        tags = tiff_tags(37, 23, 1, 1, 0, comp, rows=8)
        if opts:
            tags[292] = (4, [opts])
        files[f"tiff_ccitt_{mode}_37x23.tif"] = tiff(tags, [fax_rows(bits[y:y + 8], mode) for y in range(0, 23, 8)])
    # a strip without EOLs, then strips with them: libtiff keeps FAXMODE_NOEOL for the image
    tags = tiff_tags(37, 23, 1, 1, 0, 3, rows=8)
    files["tiff_ccitt_noeol_then_eol_37x23.tif"] = tiff(tags, [fax_rows(bits[:8], "noeol")] +
                                                        [fax_rows(bits[y:y + 8], "g3") for y in (8, 16)])
    tw = th = 16  # modified Huffman and Group 3 1-D tiles, cut at the right and bottom edges
    for mode, comp in (("rle", 2), ("g3", 3)):
        tiles = []
        for y in range(0, 23, th):
            for x in range(0, 37, tw):
                t = np.zeros((th, tw), bool)
                part = bits[y:y + th, x:x + tw]
                t[:part.shape[0], :part.shape[1]] = part
                tiles.append(fax_rows(t, mode))
        tags = tiff_tags(37, 23, 1, 1, 0, comp, tile_width=tw, tile_length=th)
        del tags[278]
        files[f"tiff_ccitt_{mode}_tiled_37x23.tif"] = tiff(tags, tiles, tiled=True)
    buf = __import__("io").BytesIO()
    Image.fromarray(text_page(2200, 1728, 86)).save(buf, "TIFF", compression="group4")
    files["tiff_ccitt_g4_page_1728x2200.tif"] = buf.getvalue()
    # ThunderScan, 4-bit palette
    index = (gray // 16).astype(np.uint8)
    index[3, :] = 5  # a row of one value: a run that ends the row exactly
    index[4, 10:] = 9
    cmap = (np.random.default_rng(87).integers(0, 65536, (3, 16)))
    tags = tiff_tags(37, 23, 4, 1, 3, 32809, rows=6, colormap=cmap.reshape(-1))
    strips = [thunder_rows(index[y:y + 6]) for y in range(0, 23, 6)]
    files["tiff_thunderscan_37x23.tif"] = tiff(tags, strips)
    files["tiff_thunderscan_no_skips_37x23.tif"] = tiff(tags, [thunder_rows(index[y:y + 6], False)
                                                               for y in range(0, 23, 6)])
    files["tiff_thunderscan_cut_37x23.tif"] = tiff(tags, [strips[0][:-9]] + strips[1:])
    files["tiff_thunderscan_overfull_37x23.tif"] = tiff(tags, [bytes([0x3F]) + strips[0]] + strips[1:])
    one = tiff_tags(37, 23, 4, 1, 3, 32809, colormap=cmap.reshape(-1))
    files["tiff_thunderscan_one_strip_37x23.tif"] = tiff(one, [thunder_rows(index)])
    # old-style LZW codes (LZWDecodeCompat)
    old = lambda b: tiff_lzw_pack(tiff_lzw_codes(b), old=True)  # noqa: E731
    files["tiff_lzw_old_gray_37x23.tif"] = tiff(tiff_tags(37, 23, 8, 1, 1, 5, rows=8),
                                                [old(gray[y:y + 8].tobytes()) for y in range(0, 23, 8)])
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    files["tiff_lzw_old_rgb_predictor_37x23.tif"] = tiff(tiff_tags(37, 23, 8, 3, 2, 5, predictor=2),
                                                         [old(hdiff(rgb.reshape(23, -1), 3, 8).astype(
                                                             np.uint8).tobytes())])
    noise = np.random.default_rng(88).integers(0, 256, 100 * 100).astype(np.uint8)
    files["tiff_lzw_old_widths_100x100.tif"] = tiff(tiff_tags(100, 100, 8, 1, 1, 5),
                                                    [tiff_lzw_pack([256] + noise[:4000].tolist() + [256] +
                                                                   noise[4000:].tolist() + [257], old=True)])
    codes = tiff_lzw_codes(gray.tobytes())
    files["tiff_lzw_old_eoi_early_37x23.tif"] = tiff(tiff_tags(37, 23, 8, 1, 1, 5),
                                                     [tiff_lzw_pack(codes[:300] + [257], old=True)])
    # the first strip old-style, the next new-style: libtiff reads them all as the first
    files["tiff_lzw_old_then_new_37x23.tif"] = tiff(tiff_tags(37, 23, 8, 1, 1, 5, rows=12),
                                                    [old(gray[:12].tobytes()),
                                                     tiff_lzw_pack(tiff_lzw_codes(gray[12:].tobytes()))])
    files["tiff_lzw_new_then_old_37x23.tif"] = tiff(tiff_tags(37, 23, 8, 1, 1, 5, rows=12),
                                                    [tiff_lzw_pack(tiff_lzw_codes(gray[:12].tobytes())),
                                                     old(gray[12:].tobytes())])
    # the 1728 x 2200 page in one strip: the walk's cost a code word, with nothing to spread
    buf = __import__("io").BytesIO()
    Image.fromarray(text_page(2200, 1728, 86)).save(buf, "TIFF", compression="group4", tiffinfo={278: 2200})
    files["tiff_ccitt_g4_page_one_strip_1728x2200.tif"] = buf.getvalue()
    # a Group 4 strip whose first row (VL1, a horizontal pair of empty runs, a pass) walks its
    # reference line past the white line Fax3PreDecode sets: it reads the run arrays the
    # strip before left, as libtiff does
    strips = [fax_rows(bits[y:y + 8], "g4") for y in range(0, 23, 8)]
    strips[1] = fax_rows(bits[8:16], "g4", "010" + "001" + t4_run(0, True) + t4_run(0, False) + "0001")
    files["tiff_ccitt_g4_past_white_37x23.tif"] = tiff(tiff_tags(37, 23, 1, 1, 0, 4, rows=8), strips)
    files.update(uncompressed_tile_fixtures(rgb, gray))
    return files


def _tiles(pixels: np.ndarray, th: int, tw: int, planes: bool = False) -> list:
    """The tiles of (h, w, c) pixels, row by row, cut at the right and bottom edges and
    padded with zeros; `planes`: each sample's plane of tiles in turn."""
    h, w, c = pixels.shape
    pad = np.zeros((-(-h // th) * th, -(-w // tw) * tw, c), pixels.dtype)
    pad[:h, :w] = pixels
    cut = [pad[y:y + th, x:x + tw] for y in range(0, h, th) for x in range(0, w, tw)]
    return [t[..., k].tobytes() for k in range(c) for t in cut] if planes else [t.tobytes() for t in cut]


def uncompressed_tile_fixtures(rgb: np.ndarray, gray: np.ndarray) -> dict:
    """Uncompressed tiled TIFFs (codec._tiled_none_reads): tiles of 1,024 bytes, which
    cv2.imdecode reads (4-sample 16 x 16, gray 32 x 32, separate RGB planes of 32 x 32);
    tiles of 768 and 256 bytes, which only cv2.imread of the file reads; a 1,024-byte tile
    whose byte count is 1,000 (zero from bytes, None from a file)."""
    files = {}
    rgba = np.dstack([rgb, gray])
    for name, pixels, t, more in (("tiles_rgba", rgba, 16, {"extra": 2}), ("tiles_gray_32", gray[..., None], 32, {}),
                                  ("invalid_tiles_rgb", rgb, 16, {}), ("invalid_tiles_gray", gray[..., None], 16, {})):
        tags = tiff_tags(37, 23, 8, pixels.shape[2], 2 if pixels.shape[2] > 1 else 1, 1, tile_width=t,
                         tile_length=t, **more)
        del tags[278]
        files[f"tiff_{name}_37x23.tif"] = tiff(tags, _tiles(pixels, t, t), tiled=True)
    tags = tiff_tags(37, 23, 8, 3, 2, 1, tile_width=32, tile_length=32, planar=2)
    del tags[278]
    files["tiff_tiles_planar_rgb_37x23.tif"] = tiff(tags, _tiles(rgb, 32, 32, True), tiled=True)
    tags = tiff_tags(37, 23, 8, 4, 2, 1, tile_width=16, tile_length=16, extra=2)
    del tags[278]
    tiles = _tiles(rgba, 16, 16)
    files["tiff_tiles_rgba_short_37x23.tif"] = tiff(tags, tiles, tiled=True,
                                                    counts=[len(t) - 24 * (k == 2) for k, t in enumerate(tiles)])
    return files


# ---------------------------------------------------------------------------- SGILog
SGILOG_MINRUN = 4  # tif_luv.c MINRUN


def sgilog_planes(values: np.ndarray, word: int) -> bytes:
    """tif_luv.c LogL16Encode (word 2) or LogLuvEncode32 (word 4) of one row of words:
    each byte plane, the highest first, as runs of at least MINRUN equal bytes (128 + n -
    2, the byte; at most 129) and the bytes between (their count, then them; at most 127),
    a short run of 2-3 before a long one written as a run."""
    tp = [int(v) for v in values]
    n, op = len(tp), bytearray()
    for shft in range(8 * (word - 1), -1, -8):
        mask = 0xFF << shft
        i = 0
        while i < n:
            beg, rc = i, 0
            while beg < n:  # the next run of MINRUN or more
                b, rc = tp[beg] & mask, 1
                while rc < 127 + 2 and beg + rc < n and (tp[beg + rc] & mask) == b:
                    rc += 1
                if rc >= SGILOG_MINRUN:
                    break
                beg += rc
            if 1 < beg - i < SGILOG_MINRUN:  # a short run before it
                b, j = tp[i] & mask, i + 1
                while (tp[j] & mask) == b:
                    j += 1
                    if j == beg:
                        op += bytes([128 - 2 + j - i, b >> shft])
                        i = beg
                        break
            while i < beg:  # the bytes before it
                j = min(beg - i, 127)
                op.append(j)
                op += bytes((tp[i + k] >> shft) & 0xFF for k in range(j))
                i += j
            if rc >= SGILOG_MINRUN:
                op += bytes([128 - 2 + rc, (tp[beg] >> shft) & 0xFF])
                i = beg + rc
    return bytes(op)


def logl16(y: np.ndarray) -> np.ndarray:
    """tif_luv.c LogL16fromY (SGILOGENCODE_NODITHER): Y -> 16-bit LogL, negative Y with
    the sign bit, |Y| below 2^-64 (and 0) as 0."""
    a = np.abs(y)
    le = np.where(a >= 1.8371976e19, 0x7FFF, np.where(a <= -1.8371976e19, 0x8000,
                  np.where(a > 5.4136769e-20, (256 * (np.log2(np.maximum(a, 1e-30)) + 64)).astype(np.int64), 0)))
    return np.where(y < 0, 0x8000 | le, le).astype(np.int64) & 0xFFFF


def logluv32(xyz: np.ndarray) -> np.ndarray:
    """(h, w, 3) XYZ -> LogLuv32 words: LogL16 of Y, then u' and v' scaled by UVSCALE
    (410) to bytes (tif_luv.c LogLuv32fromXYZ without dithering)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    s = x + 15 * y + 3 * z
    u = np.where(s > 0, 4 * x / np.where(s > 0, s, 1), 4 / 19)
    v = np.where(s > 0, 9 * y / np.where(s > 0, s, 1), 9 / 19)
    ub = np.clip((410 * u).astype(np.int64), 0, 255)
    vb = np.clip((410 * v).astype(np.int64), 0, 255)
    return (logl16(y) << 16) | (ub << 8) | vb


def sgilog_fixtures(cv2) -> dict:
    """SGILog TIFFs (compression 34676 on LogL and LogLuv, 34677 on LogLuv) from the
    encoders here, as cv2 reads them through libtiff's 8-bit conversions: strips of 8 rows
    and 16 x 16 tiles cut at the edges, every L sign and zero, out-of-gamut colour indices,
    runs at the coder's thresholds, a cut strip, 8-bit tags, orientation 3; and those cv2
    returns None for."""
    rng = np.random.default_rng(2200)
    bgr = draw(23, 37, 2201, cv2).astype(np.float64) / 255
    rgb = bgr[..., ::-1] ** 2.2
    m = np.array([[0.4124, 0.3576, 0.1805], [0.2126, 0.7152, 0.0722], [0.0193, 0.1192, 0.9505]])
    xyz = rgb @ m.T * rng.uniform(0.5, 3.0)
    lum = logl16(xyz[..., 1])
    lum[0, :4] = [0, 0x8000, 0x8000 | 0x4123, 0x7FFF]  # L zero, minus zero, negative, the largest
    lum[1, :3] = [1, 0x3FFF, 0x4000 + 64 * 256]
    luv = (lum << 16) | (logluv32(xyz) & 0xFFFF)
    luv[2, :4] = (luv[2, :4] & ~0xFFFF) | np.array([0x0000, 0xFFFF, 0x00FF, 0xFF00])  # u', v' off the gamut
    le10 = np.clip(((np.log2(np.maximum(xyz[..., 1], 1e-9)) + 12) * 64).astype(np.int64), 0, 1023)
    uv = rng.integers(0, 16384, (23, 37))  # colour indices, 16,289 and past it out of gamut
    uv[3, :5] = [0, 16288, 16289, 16383, 8000]
    luv24 = (le10 << 14) | uv
    luv24[4, :2] = [0, 1 << 14]
    files = {}

    def rows(words, word):
        return [b"".join(sgilog_planes(r, word) for r in words[y:y + 8]) for y in range(0, words.shape[0], 8)]

    def raw24(words):
        return [b"".join(int(v).to_bytes(3, "big") for v in words[y:y + 8].reshape(-1))
                for y in range(0, words.shape[0], 8)]

    def tiles(words, encode):
        pad = np.zeros((32, 48), np.int64)
        pad[:23, :37] = words
        return [encode(pad[y:y + 16, x:x + 16]) for y in range(0, 23, 16) for x in range(0, 37, 16)]

    logl = tiff_tags(37, 23, 16, 1, 32844, 34676, rows=8)
    logluv = tiff_tags(37, 23, 16, 3, 32845, 34676, rows=8)
    files["tiff_sgilog_logl_37x23.tif"] = tiff(logl, rows(lum, 2))
    files["tiff_sgilog_logluv_37x23.tif"] = tiff(logluv, rows(luv, 4))
    files["tiff_sgilog24_logluv_37x23.tif"] = tiff(tiff_tags(37, 23, 16, 3, 32845, 34677, rows=8), raw24(luv24))
    for name, tags, words, word in (("logl", logl, lum, 2), ("logluv", logluv, luv, 4)):
        t = {**tags, 322: (3, [16]), 323: (3, [16])}
        del t[278]
        files[f"tiff_sgilog_{name}_tiles_37x23.tif"] = tiff(
            t, tiles(words, lambda p: b"".join(sgilog_planes(r, word) for r in p)), tiled=True)
    t = {**tiff_tags(37, 23, 16, 3, 32845, 34677), 322: (3, [16]), 323: (3, [16])}
    del t[278]
    files["tiff_sgilog24_logluv_tiles_37x23.tif"] = tiff(
        t, tiles(luv24, lambda p: b"".join(int(v).to_bytes(3, "big") for v in p.reshape(-1))), tiled=True)
    cut = rows(luv, 4)
    cut[1] = cut[1][:len(cut[1]) // 2]
    files["tiff_sgilog_logluv_cut_37x23.tif"] = tiff(logluv, cut)
    cut24 = raw24(luv24)
    cut24[2] = cut24[2][:3 * 37 * 3 + 5]
    files["tiff_sgilog24_logluv_cut_37x23.tif"] = tiff(tiff_tags(37, 23, 16, 3, 32845, 34677, rows=8), cut24)
    files["tiff_sgilog_logl_8bit_37x23.tif"] = tiff(tiff_tags(37, 23, 8, 1, 32844, 34676, rows=8), rows(lum, 2))
    files["tiff_sgilog_logluv_orientation3_37x23.tif"] = tiff({**logluv, 274: (3, [3])}, rows(luv, 4))
    # runs at the thresholds: 1-5 equal bytes, 127-130, literals of 127 and more
    row = []
    for k, n in enumerate((1, 2, 3, 4, 5, 127, 128, 129, 130, 1, 3, 2, 4)):
        row += [0x3F00 + 7 * k] * n
    row += (0x3E00 + np.arange(200) * 37 % 251).tolist()
    runs = np.array([row, row[::-1], [0x4000] * len(row), row[1:] + row[:1]], np.int64)
    files[f"tiff_sgilog_logl_runs_{runs.shape[1]}x4.tif"] = tiff(
        tiff_tags(runs.shape[1], 4, 16, 1, 32844, 34676), [b"".join(sgilog_planes(r, 2) for r in runs)])
    files["tiff_invalid_sgilog24_logl_37x23.tif"] = tiff(tiff_tags(37, 23, 16, 1, 32844, 34677, rows=8), raw24(lum))
    files["tiff_invalid_sgilog_planar_37x23.tif"] = tiff({**logluv, 284: (3, [2])}, rows(luv, 4))
    files["tiff_invalid_sgilog_logl_2bit_37x23.tif"] = tiff(tiff_tags(37, 23, 2, 1, 32844, 34676, rows=8),
                                                            rows(lum, 2))
    return files


# ---------------------------------------------------------------------------- JPEG-in-TIFF
def jpeg_tables(streams: list) -> tuple:
    """(JPEGTables, chunks): the DQT and DHT segments before the frame that every stream
    holds alike, moved out of the streams into an SOI ... EOI tables stream, as libtiff's
    encoder writes them (the rest, a progressive file's DHTs between scans among them,
    stay in each chunk)."""
    heads = []
    for data in streams:
        segs = jpeg_segments(data)
        sof = next(i for i, (m, _, _) in enumerate(segs) if m in (0xC0, 0xC1, 0xC2))
        heads.append([data[a:b] for m, a, b in segs[:sof] if m in (0xDB, 0xC4)])
    shared = [h for h in heads[0] if all(h in other for other in heads[1:])]
    chunks = []
    for data in streams:
        for h in shared:
            data = data.replace(h, b"", 1)
        chunks.append(data)
    return b"\xff\xd8" + b"".join(shared) + b"\xff\xd9", chunks


def set_tags(data: bytes, values: dict) -> bytes:
    """A little-endian classic TIFF with the one-value SHORT or LONG fields of `values` {tag:
    value} set in its first directory."""
    out = bytearray(data)
    at = struct.unpack_from("<I", out, 4)[0]
    for i in range(struct.unpack_from("<H", out, at)[0]):
        e = at + 2 + 12 * i
        tag, typ = struct.unpack_from("<HH", out, e)
        if tag in values:
            struct.pack_into("<I", out, e + 8, 0)
            struct.pack_into("<H" if typ == 3 else "<I", out, e + 8, values[tag])
    return bytes(out)


def set_chunk(data: bytes, index: int, fill: bytes) -> bytes:
    """A little-endian classic TIFF of strips with strip `index`'s bytes overwritten by
    `fill` (repeated to its length)."""
    at = struct.unpack_from("<I", data, 4)[0]
    fields = {}
    for i in range(struct.unpack_from("<H", data, at)[0]):
        tag, typ, count, value = struct.unpack_from("<HHII", data, at + 2 + 12 * i)
        fields[tag] = (count, value)

    def values(tag):
        count, value = fields[tag]
        return [value] if count == 1 else list(struct.unpack_from(f"<{count}I", data, value))

    o, c = values(273)[index], values(279)[index]
    return data[:o] + (fill * (c // len(fill) + 1))[:c] + data[o + c:]


def jpeg_tiff(bgr: np.ndarray, cv2, kind: str = "ycbcr", sampling: str = "420", rows: int | None = None,
              tile: tuple | None = None, restart: int = 0, progressive: bool = False, tall: int | None = None,
              cut: int | None = None, subsampling: tuple | None = None, quality: int = 90, **more) -> bytes:
    """A JPEG-in-TIFF (compression 7) of a BGR image: `kind` "ycbcr" (photometric 6, cv2's
    JPEGs at `sampling`, YCbCrSubsampling from it or `subsampling`), "rgb" (photometric 2,
    R, G and B as three 1 x 1 components without a colour transform) or "gray"; strips of
    `rows` rows (strip `tall` encoded taller, black rows below it: the last strip to `rows`
    rows, another to twice that) or (height, width) `tile`s padded by repeating the
    edge; the tables in
    tag 347; chunk `cut` cut inside its entropy-coded data, without EOI."""
    h, w = bgr.shape[:2]
    img = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY) if kind == "gray" else bgr
    if tile:
        th, tw = tile
        pad = np.pad(img, ((0, -h % th), (0, -w % tw)) + ((0, 0),) * (img.ndim - 2), mode="edge")
        parts = [pad[y:y + th, x:x + tw] for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        rows = rows or h
        parts = [img[y:y + rows] for y in range(0, h, rows)]
        if tall is not None:
            want = rows if tall in (-1, len(parts) - 1) else 2 * rows
            parts[tall] = np.pad(parts[tall], ((0, want - len(parts[tall])),) + ((0, 0),) * (img.ndim - 1))

    def encode(part):
        if kind == "rgb":
            return encode_baseline([part[..., c] for c in (2, 1, 0)], [(1, 1)] * 3, cv2, quality=quality)
        return jpeg(part, cv2, quality=quality, sampling=sampling, restart=restart, progressive=progressive)

    tables, chunks = jpeg_tables([encode(np.ascontiguousarray(p)) for p in parts])
    if cut is not None:
        sos = [(a, b) for m, a, b in jpeg_segments(chunks[cut]) if m == 0xDA][-1]
        chunks[cut] = chunks[cut][:sos[0] + (sos[1] - sos[0]) * 3 // 5]
    spp = 1 if kind == "gray" else 3
    tags = tiff_tags(w, h, 8, spp, {"ycbcr": 6, "rgb": 2, "gray": 1}[kind], 7, rows=rows, **more)
    tags[347] = (7, list(tables))
    if kind == "ycbcr":
        factors = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2), "411": (4, 1)}[sampling]
        tags[530] = (3, list(subsampling or factors))
    if tile:
        del tags[278]
        tags.update({322: (3, [tile[1]]), 323: (3, [tile[0]])})
    return tiff(tags, chunks, tiled=bool(tile))


def jpeg_tiff_fixtures(cv2) -> dict:
    """JPEG-in-TIFFs written here from cv2's JPEG streams (libtiff's layout: the tables in
    tag 347, a stream a chunk): strips at 4:2:0, 4:2:2 and 4:4:4, RGB and gray strips, tiles
    cut at the right and bottom edges (YCbCr and gray), a restart interval, progressive
    strips, orientation 6, a cut strip, a last strip as tall as the others, and one
    640x480 4:2:0 file of 16-row strips; and the ones cv2 returns None for."""
    bgr = draw(45, 67, 83, cv2)
    files = {}
    for s in ("420", "422", "444"):
        files[f"tiff_jpeg_strips_{s}_67x45.tif"] = jpeg_tiff(bgr, cv2, sampling=s, rows=16)
    files["tiff_jpeg_rgb_strips_67x45.tif"] = jpeg_tiff(bgr, cv2, "rgb", rows=16)
    files["tiff_jpeg_gray_strips_67x45.tif"] = jpeg_tiff(bgr, cv2, "gray", rows=8)
    files["tiff_jpeg_tiles_420_67x45.tif"] = jpeg_tiff(bgr, cv2, tile=(16, 32))
    files["tiff_jpeg_gray_tiles_67x45.tif"] = jpeg_tiff(bgr, cv2, "gray", tile=(32, 16))
    files["tiff_jpeg_restart_67x45.tif"] = jpeg_tiff(bgr, cv2, rows=32, restart=2)
    files["tiff_jpeg_progressive_67x45.tif"] = jpeg_tiff(bgr, cv2, rows=16, progressive=True)
    files["tiff_jpeg_orientation6_67x45.tif"] = jpeg_tiff(bgr, cv2, rows=16, orientation=6)
    files["tiff_jpeg_cut_67x45.tif"] = jpeg_tiff(bgr, cv2, rows=16, cut=1)
    # a last strip of 14 rows encoded 16 tall: its last row's chroma reads the black row below
    files["tiff_jpeg_tall_last_67x46.tif"] = jpeg_tiff(draw(46, 67, 85, cv2), cv2, rows=16, tall=-1)
    files["tiff_jpeg_640x480.tif"] = jpeg_tiff(draw(480, 640, 84, cv2), cv2, rows=16)
    strips = files["tiff_jpeg_strips_420_67x45.tif"]
    files["tiff_jpeg_invalid_garbage_67x45.tif"] = set_chunk(strips, 1, bytes(range(7, 250, 3)))
    files["tiff_jpeg_invalid_subsampling_67x45.tif"] = jpeg_tiff(bgr, cv2, rows=16, subsampling=(1, 1))
    files["tiff_jpeg_invalid_rgb_420_67x45.tif"] = set_tags(strips, {262: 2})
    files["tiff_jpeg_invalid_components_67x45.tif"] = set_tags(jpeg_tiff(bgr, cv2, "gray", rows=16), {277: 3, 262: 2})
    files["tiff_jpeg_invalid_tall_strip_67x45.tif"] = jpeg_tiff(bgr, cv2, rows=16, tall=0)
    files["tiff_invalid_lzma_37x23.tif"] = set_tags(tiff(tiff_tags(37, 23, 8, 3, 2), [bgr[:23, :37].tobytes()]),
                                            {259: 34925})
    return files


# ---------------------------------------------------------------------------- TIFF compressions
# libtiff 4.7's codecs (tif_codec.c): those cv2's build lacks fail TIFFRGBAImageOK
LIBTIFF_CODECS = {1: "None", 2: "CCITT RLE", 3: "CCITT Fax3", 4: "CCITT Fax4", 5: "LZW", 6: "OJPEG", 7: "JPEG",
                  8: "AdobeDeflate", 32766: "NeXT", 32771: "CCITT RLEW", 32773: "PackBits", 32809: "ThunderScan",
                  32909: "PixarLog", 32946: "Deflate", 34661: "JBIG", 34676: "SGILog", 34677: "SGILog24",
                  34887: "LERC", 34925: "LZMA", 50000: "ZSTD", 50001: "WEBP"}
PORT_CODECS = (1, 2, 3, 4, 5, 7, 8, 32771, 32773, 32809, 32946, 34676, 34677)  # the port's data/codec.py decodes these


def compression_bases() -> dict:
    """name -> a little-endian TIFF (seeded numpy samples, uncompressed) whose compression
    code the probe sets: 1-bit MinIsWhite, 8-bit gray, 8-bit and 4-bit palette, 8- and
    16-bit RGB, 16-bit RGBA (unassociated), 16-bit LogLuv and LogL, in strips of 8 rows; 8-bit RGB
    and gray in 16 x 16 tiles cut at the right and bottom edges."""
    rng = np.random.default_rng(1800)
    w, h = 37, 23
    bases = {}

    def strips(tags, pixels):
        rows = pixels.reshape(h, -1)
        return tiff({**tags, 278: (4, [8])}, [rows[y:y + 8].tobytes() for y in range(0, h, 8)])

    def tiles(tags, pixels):
        t = {**tags, 322: (3, [16]), 323: (3, [16])}
        del t[278]
        pad = np.zeros((32, 48) + pixels.shape[2:], pixels.dtype)
        pad[:h, :w] = pixels
        return tiff(t, [pad[y:y + 16, x:x + 16].tobytes() for y in range(0, h, 16) for x in range(0, w, 16)],
                    tiled=True)

    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    gray = rgb[..., 1]
    bases["miniswhite_1bit"] = tiff(tiff_tags(w, h, 1, 1, 0), [np.packbits(gray > 127, 1).tobytes()])
    bases["gray_8bit"] = strips(tiff_tags(w, h, 8, 1, 1), gray)
    bases["palette_8bit"] = strips(tiff_tags(w, h, 8, 1, 3, colormap=rng.integers(0, 65536, 768)), gray)
    nibbles = np.packbits(np.unpackbits((gray >> 4)[..., None], -1)[..., 4:].reshape(h, -1), 1)
    bases["palette_4bit"] = tiff(tiff_tags(w, h, 4, 1, 3, colormap=rng.integers(0, 65536, 48)), [nibbles.tobytes()])
    bases["rgb_8bit"] = strips(tiff_tags(w, h, 8, 3, 2), rgb)
    wide = rng.integers(0, 65536, (h, w, 4)).astype("<u2")
    bases["rgb_16bit"] = strips(tiff_tags(w, h, 16, 3, 2), wide[..., :3])
    bases["rgba_16bit"] = strips(tiff_tags(w, h, 16, 4, 2, extra=2), wide)
    bases["logluv_16bit"] = strips(tiff_tags(w, h, 16, 3, 32845), wide[..., :3])
    bases["logl_16bit"] = strips(tiff_tags(w, h, 16, 1, 32844), wide[..., 3])
    bases["rgb_8bit_tiles"] = tiles(tiff_tags(w, h, 8, 3, 2), rgb)
    bases["gray_8bit_tiles"] = tiles(tiff_tags(w, h, 8, 1, 1), gray)
    return bases


def _ranges(codes: list) -> list:
    out = []
    for c in codes:
        if out and out[-1][1] == c - 1:
            out[-1][1] = c
        else:
            out.append([c, c])
    return out


def compression_table(cv2, tmp: str) -> dict:
    """cv2.imdecode of each base at every compression code 0-65535: per base the code
    ranges cv2 returns None for ("none"), decodes to the image of zero samples ("zero": the
    digest of cv2's read of the base whose chunks are LZW data without a Clear, which
    libtiff decodes nothing of), or decodes to something else ("decodes", each code's
    digest); "lacks": the codes of a libtiff codec the port lacks, where cv2 does not
    return None (the port refuses them); and "imread_differs": {code: what cv2.imread of
    the bytes as a file in `tmp` gives where it differs from cv2.imdecode ("none", "zero",
    "decodes")}, every code probed."""
    path = os.path.join(tmp, "probe.tif")

    def decode(data):
        a = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        return None if a is None else np.ascontiguousarray(a[..., ::-1])

    def read(data):
        with open(path, "wb") as f:
            f.write(data)
        a = cv2.imread(path, cv2.IMREAD_COLOR)
        return None if a is None else np.ascontiguousarray(a[..., ::-1])

    out = {}
    for name, base in compression_bases().items():
        at = struct.unpack_from("<I", base, 4)[0]
        n = struct.unpack_from("<H", base, at)[0]
        entries = [struct.unpack_from("<HHII", base, at + 2 + 12 * i) for i in range(n)]
        fields = {tag: (count, value) for tag, _, count, value in entries}
        off_tag, count_tag = (324, 325) if 324 in fields else (273, 279)

        def values(tag):
            count, value = fields[tag]
            return [value] if count == 1 else list(struct.unpack_from(f"<{count}I", base, value))

        empty = bytearray(base)  # every chunk's first two bytes zero: LZW without a Clear
        for o in values(off_tag):
            empty[o:o + 2] = b"\0\0"
        zero = decode(set_tags(bytes(empty), {259: 5}))

        def outcome(img):
            return "none" if img is None else "zero" if np.array_equal(img, zero) else "decodes"

        classes = {"none": [], "zero": [], "decodes": []}
        decoded, differs = {}, {}
        for code in range(65536):
            data = set_tags(base, {259: code})
            img = decode(data)
            classes[outcome(img)].append(code)
            if outcome(img) == "decodes":
                decoded[str(code)] = sha(img)
            by_file = read(data)
            if outcome(by_file) != outcome(img) or (img is not None and not np.array_equal(img, by_file)):
                differs[str(code)] = outcome(by_file)
        lacks = [c for c in sorted(LIBTIFF_CODECS) if c not in PORT_CODECS and c not in classes["none"]]
        out[name] = {"zero_sha256": sha(zero), "decoded_sha256": decoded, "lacks": lacks, "imread_differs": differs,
                     **{k: _ranges(v) for k, v in classes.items()}}
    return out


def packbits(data: bytes) -> bytes:
    """PackBits runs of `data`: repeats of 2-128 bytes, literals of up to 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i)]) + data[i:i + 1]
            i = j
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def lzw_codes(indices: np.ndarray, min_code_size: int, clear_every: int = 0, deferred: bool = False) -> list:
    """GIF LZW codes of `indices` (Clear first, EOI last): a Clear when the table is
    full, or once it reaches `clear_every` entries; with `deferred`, no Clear when it is
    full (the table stays full)."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    fresh = {(i,): i for i in range(clear)}
    codes, table, nxt, w = [clear], dict(fresh), eoi + 1, ()
    for c in indices.reshape(-1).tolist():
        wc = w + (c,)
        if wc in table:
            w = wc
            continue
        codes.append(table[w])
        if nxt < 4096:
            table[wc] = nxt
            nxt += 1
        if (clear_every and nxt >= clear_every) or (nxt == 4096 and not deferred):
            codes.append(clear)
            table, nxt = dict(fresh), eoi + 1
        w = (c,)
    if w:
        codes.append(table[w])
    return codes + [eoi]


def lzw_pack(codes: list, min_code_size: int) -> bytes:
    """The codes as a GIF decoder reads them: LSB first, the width growing when the
    table's next entry reaches 2^width (up to 12), Clear and EOI resetting it."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    size, nxt, first = min_code_size + 1, eoi + 1, True
    acc = nbits = 0
    out = bytearray()
    for code in codes:
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
        if code in (clear, eoi):
            size, nxt, first = min_code_size + 1, eoi + 1, True
        elif first:
            first = False
        elif nxt < 4096:
            nxt += 1
            if nxt == 1 << size and size < 12:
                size += 1
    return bytes(out + (bytearray([acc & 255]) if nbits else b""))


def sub_blocks(data: bytes) -> bytes:
    """Data sub-blocks of up to 255 bytes and the terminator."""
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255] for i in range(0, len(data), 255)) + b"\0"


def gif_table(colors) -> tuple:
    """(table bytes padded to a power of two of at least 2 entries, its size field)."""
    colors = np.asarray(colors, np.uint8).reshape(-1, 3)
    size = max(2, 1 << int(np.ceil(np.log2(len(colors)))))
    table = np.zeros((size, 3), np.uint8)
    table[:len(colors)] = colors
    return table.tobytes(), size.bit_length() - 2


def gif(indices: np.ndarray, global_colors=None, local_colors=None, screen=None, pos=(0, 0), transparent=None,
        disposal: int = 0, interlace: bool = False, min_code_size: int = 8, version: bytes = b"89a", bg: int = 0,
        codes=None, data: bytes | None = None, before: bytes = b"", after: bytes = b"", trailer: bool = True,
        **lzw) -> bytes:
    """A GIF of one frame of palette `indices` ((h, w)), RGB colour tables, a graphic
    control extension (with `transparent` or `disposal`; none when both are None), the
    frame at `pos` = (x, y) on `screen` = (width, height); `codes` or `data` replace the
    LZW encoding, `before` and `after` are blocks written around the frame."""
    h, w = indices.shape
    sw, sh = screen or (w, h)
    flags, gtable = 0, b""
    if global_colors is not None:
        gtable, bits = gif_table(global_colors)
        flags = 0x80 | 0x70 | bits
    out = b"GIF" + version + struct.pack("<HHBBB", sw, sh, flags, bg, 0) + gtable + before
    if transparent is not None or disposal is not None:
        out += bytes([0x21, 0xF9, 4, ((disposal or 0) << 2) | (transparent is not None), 0, 0, transparent or 0, 0])
    lflags, ltable = 0, b""
    if local_colors is not None:
        ltable, bits = gif_table(local_colors)
        lflags = 0x80 | bits
    rows = indices
    if interlace:
        lflags |= 0x40
        rows = indices[np.concatenate([np.arange(a, h, b) for a, b in ((0, 8), (4, 8), (2, 4), (1, 2))])]
    if data is None:
        data = lzw_pack(codes if codes is not None else lzw_codes(rows, min_code_size, **lzw), min_code_size)
    out += b"\x2c" + struct.pack("<HHHHB", pos[0], pos[1], w, h, lflags) + ltable + bytes([min_code_size])
    return out + sub_blocks(data) + after + (b"\x3b" if trailer else b"")


def gif_fixtures(cv2) -> dict:
    """cv2's GIFs and the cases of grfmt_gif.cpp each written here."""
    files = {}
    files["gif_cv2_100x80.gif"] = cv2.imencode(".gif", draw(80, 100, 60, cv2))[1].tobytes()
    files["gif_cv2_37x23.gif"] = cv2.imencode(".gif", draw(23, 37, 61, cv2))[1].tobytes()
    rng = np.random.default_rng(62)
    pal = rng.integers(0, 256, (256, 3))
    pal[0] = (200, 50, 90)  # entry 0 not black: a pixel left at 0 or at the canvas shows
    pal[5] = (11, 22, 33)
    img = draw(23, 37, 63, cv2).astype(np.int64)
    idx = (img.sum(-1) // 3) % 256
    files["gif_frame_in_screen_37x23.gif"] = gif(idx[:15, :20], pal, screen=(37, 23), pos=(9, 5), bg=5,
                                                 disposal=1)
    t = idx.copy()
    t[3:9, 4:30] = 7
    files["gif_transparent_37x23.gif"] = gif(t[2:20, 3:33], pal, screen=(37, 23), pos=(3, 2), transparent=7, bg=0,
                                             disposal=2)
    files["gif_local_only_37x23.gif"] = gif(idx, local_colors=pal, disposal=None)
    gray = idx.copy()
    gray[0, :6] = [0, 1, 1, 2, 0, 255]  # no table: 0 black, 1 white, every other index its gray
    files["gif_no_table_37x23.gif"] = gif(gray, disposal=None)
    files["gif_local16_global_37x23.gif"] = gif(idx % 32, pal[::-1], local_colors=pal[:16])
    runs = np.repeat(np.repeat((np.arange(8)[:, None] * 3 + np.arange(6)) % 4, 3, 0), 7, 1)[:23, :37]
    files["gif_kwkwk_37x23.gif"] = gif(runs, pal)  # long runs: codes equal to the next free entry
    noise = rng.integers(0, 256, (80, 100))
    files["gif_full_table_no_clear_100x80.gif"] = gif(noise, pal, deferred=True)
    smooth = (np.add.outer(np.arange(80), np.arange(100)) // 3) % 7
    files["gif_clear_often_100x80.gif"] = gif(smooth, pal, clear_every=300)
    files["gif_interlaced_100x80.gif"] = gif((idx.repeat(4, 0).repeat(3, 1)[:80, :100] + smooth) % 256, pal,
                                             interlace=True)
    files["gif_interlaced_37x23.gif"] = gif(idx, pal, interlace=True, transparent=5)
    # the longest strings: one colour, no Clear (codes of 1 to 783 pixels)
    files["gif_solid_640x480.gif"] = gif(np.full((480, 640), 3), pal)
    files["gif_min_code_2_clear_often_100x80.gif"] = gif(smooth % 4, pal[:4], min_code_size=2, clear_every=40)
    for m in (2, 3, 4, 5, 6, 7, 8, 11):
        files[f"gif_min_code_{m}_37x23.gif"] = gif(idx % (1 << min(m, 8)), pal[:1 << min(m, 8)], min_code_size=m)
    codes = lzw_codes(idx, 8)
    files["gif_no_eoi_37x23.gif"] = gif(idx, pal, codes=codes[:-1])  # the data ends without EOI
    last = [256] + [int(v) for v in idx.reshape(-1)]  # literals only
    # one code after the last pixel, ending in the data's last byte: cv2 accepts it
    files["gif_code_after_last_pixel_37x23.gif"] = gif(idx, pal, data=lzw_pack(last + [9], 8))
    mid = lzw_codes(idx[:11], 8)[:-1] + [257] + lzw_codes(idx[11:], 8)[1:]
    files["gif_decoding_past_eoi_37x23.gif"] = gif(idx, pal, data=lzw_pack(mid, 8))
    second = (bytes([0x21, 0xF9, 4, 4, 0, 0, 0, 0]) + b"\x2c" + struct.pack("<HHHHB", 0, 0, 37, 23, 0) + b"\x08"
              + sub_blocks(lzw_pack(lzw_codes(np.zeros((23, 37), np.int64), 8), 8)))
    files["gif_second_frame_37x23.gif"] = gif(idx, pal, after=second)
    files["gif87a_37x23.gif"] = gif(idx, pal, version=b"87a", disposal=None)
    ext = (bytes([0x21, 0xFF, 11]) + b"NETSCAPE2.0" + bytes([3, 1, 0, 0, 0]) + bytes([0x21, 0xFE, 4]) + b"made"
           + b"\0" + bytes([0x21, 0x77, 2, 9, 9, 0]) + bytes([0x21, 0xFF, 11]) + b"XMP DataXMP" + bytes([2, 1, 2, 0]))
    files["gif_extensions_37x23.gif"] = gif(idx, pal, before=ext)
    # what cv2 returns None for
    files["gif_invalid_short_37x23.gif"] = gif(idx, pal, codes=lzw_codes(idx.reshape(-1)[:-1], 8))
    files["gif_invalid_extra_codes_37x23.gif"] = gif(idx, pal, data=lzw_pack(last + [9, 9, 9], 8))
    files["gif_invalid_code_past_table_37x23.gif"] = gif(idx, pal, codes=codes[:5] + [4000] + codes[5:])
    rep = np.tile(np.array([1, 2, 3]), 300)
    files["gif_invalid_string_past_frame_37x23.gif"] = gif(idx, pal, codes=lzw_codes(rep[:23 * 37 + 2], 8))
    files["gif_invalid_index_37x23.gif"] = gif(idx, pal[:16])
    files["gif_invalid_gce_length_37x23.gif"] = gif(idx, pal, disposal=None, before=bytes([0x21, 0xF9, 5, 0, 0, 0, 0, 0, 0]))
    files["gif_invalid_disposal_37x23.gif"] = gif(idx, pal, disposal=4)
    files["gif_invalid_frame_outside_37x23.gif"] = gif(idx, pal, screen=(37, 23), pos=(1, 0))
    files["gif_invalid_min_code_12_37x23.gif"] = gif(idx, pal, data=lzw_pack(codes, 11)).replace(
        b"\x2c" + struct.pack("<HHHHB", 0, 0, 37, 23, 0) + b"\x08", b"\x2c" + struct.pack("<HHHHB", 0, 0, 37, 23, 0) + b"\x0c")
    files["gif_invalid_no_trailer_37x23.gif"] = gif(idx, pal, trailer=False)
    files["gif_invalid_background_37x23.gif"] = gif(idx % 16, pal[:16], bg=20)
    files["gif_invalid_app_extension_37x23.gif"] = gif(idx, pal, before=bytes([0x21, 0xFF, 3, 1, 2, 3, 0]))
    return files


def hdr(rgbe: np.ndarray, header: bytes = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n", size: bytes | None = None,
        body: bytes | None = None) -> bytes:
    """A Radiance HDR of RGBE quadruples ((h, w, 4)): `header` through its blank line,
    the `-Y h +X w` line (or `size`), flat scanlines (or `body`)."""
    h, w = rgbe.shape[:2]
    size = b"-Y %d +X %d\n" % (h, w) if size is None else size
    return header + size + (rgbe.astype(np.uint8).tobytes() if body is None else body)


def hdr_rle_row(row: np.ndarray, runs: bool) -> bytes:
    """One new-style RLE scanline of RGBE quadruples ((w, 4)): each channel as runs of
    equal bytes (`runs`) or as literal spans of up to 128 bytes."""
    w = len(row)
    out = bytearray([2, 2, w >> 8, w & 255])
    for v in row.T.astype(np.int64).tolist():
        i = 0
        while i < w:
            if runs:
                j = i + 1
                while j < w and v[j] == v[i] and j - i < 127:
                    j += 1
                out += bytes([128 + j - i, v[i]])
            else:
                j = min(w, i + 128)
                out += bytes([j - i]) + bytes(v[i:j])
            i = j
    return bytes(out)


def hdr_fixtures(cv2) -> dict:
    """cv2's HDRs and the cases of rgbe.cpp each written here."""
    files = {}
    rgb = draw(23, 37, 70, cv2).astype(np.float32) / 160  # up to ~1.6: past 1.0 saturates
    files["hdr_cv2_rle_37x23.hdr"] = cv2.imencode(".hdr", rgb)[1].tobytes()
    files["hdr_cv2_flat_37x23.hdr"] = cv2.imencode(".hdr", rgb, [cv2.IMWRITE_HDR_COMPRESSION,
                                                                 cv2.IMWRITE_HDR_COMPRESSION_NONE])[1].tobytes()
    files["hdr_cv2_5x4.hdr"] = cv2.imencode(".hdr", rgb[:4, :5] * 0.5)[1].tobytes()  # narrower than 8: flat
    rng = np.random.default_rng(71)
    m = rng.integers(0, 256, (6, 9, 4))
    m[..., 3] = rng.integers(120, 140, (6, 9))
    m[0, :6, 3] = [0, 1, 136, 137, 255, 129]  # exponent 0 (black), the smallest, 1.0 x mantissa, past 1.0, huge
    m[1, :3, :3] = 255
    files["hdr_flat_exponents_9x6.hdr"] = hdr(m)
    files["hdr_rgbe_header_9x6.hdr"] = hdr(m, header=b"#?RGBE\n# written by hand\nEXPOSURE=2\nFORMAT=32-bit_rle_rgbe\n"
                                                  b"SOFTWARE=none\n\n", size=b"-Y  6   +X 9 \n")
    m2 = rng.integers(0, 256, (5, 12, 4))
    m2[..., 3] = rng.integers(125, 135, (5, 12))
    m2[2, :, :3] = 7
    m2[1, 3, 3] = 0
    files["hdr_rle_runs_12x5.hdr"] = hdr(m2, body=b"".join(hdr_rle_row(r, True) for r in m2))
    files["hdr_rle_then_flat_12x5.hdr"] = hdr(m2, body=hdr_rle_row(m2[0], False) + hdr_rle_row(m2[1], True)
                                              + m2[2:].astype(np.uint8).tobytes())
    rle = b"".join(hdr_rle_row(r, False) for r in m2)
    files["hdr_invalid_no_format_9x6.hdr"] = hdr(m, header=b"#?RADIANCE\nSOFTWARE=none\n\n")
    files["hdr_invalid_orientation_9x6.hdr"] = hdr(m, size=b"+Y 6 +X 9\n")
    files["hdr_invalid_zero_count_12x5.hdr"] = hdr(m2, body=rle[:4] + b"\0" + rle[5:])
    files["hdr_invalid_scanline_width_12x5.hdr"] = hdr(m2, body=rle[:3] + b"\x0b" + rle[4:])
    files["hdr_invalid_cut_12x5.hdr"] = hdr(m2, body=rle[:-3])
    return files


def entropy_span(data: bytes, scan: int):
    """(first byte, end) of the entropy-coded data of a JPEG's scan-th scan: from after
    its SOS header to the marker that ends it."""
    sos = [start for marker, start, _ in jpeg_segments(data) if marker == 0xDA][scan]
    start = sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]
    at = start
    while not (data[at] == 0xFF and data[at + 1] not in (0, 0xFF) and not 0xD0 <= data[at + 1] <= 0xD7):
        at += 1
    return start, at


def corrupt_fixtures(files: dict, cv2) -> dict:
    """JPEGs with corrupt entropy-coded data that libjpeg decodes with warnings, and
    progressive ones that libjpeg smooths (their scans cut or missing)."""
    out = {}
    base = files["coco_500x333_444.jpg"]
    start, end = entropy_span(base, 0)
    half = start + (end - start) // 2
    out["corrupt_cut_eoi_500x333.jpg"] = base[:half] + b"\xff\xd9"  # cut, then EOI
    out["corrupt_ff00_run_500x333.jpg"] = base[:half] + b"\xff\x00" * 12 + base[half + 24:]
    restart = jpeg(draw(61, 83, 60, cv2), cv2, restart=2)
    start, end = entropy_span(restart, 0)
    rst = [i for i in range(start, end - 1) if restart[i] == 0xFF and 0xD0 <= restart[i + 1] <= 0xD7]
    a, b = rst[len(rst) // 2], rst[len(rst) // 2 + 1]
    out["corrupt_restart_interval_83x61.jpg"] = restart[:a + 2 + (b - a - 2) // 3] + restart[b:]
    out["corrupt_restart_cut_eoi_83x61.jpg"] = restart[:a + 2 + (b - a - 2) // 2] + b"\xff\xd9"
    out["corrupt_restart_boundary_eoi_83x61.jpg"] = restart[:a] + b"\xff\xd9"  # the next interval decodes on zeros
    prog = files["progressive_420_83x61.jpg"]
    start, end = entropy_span(prog, 5)
    out["corrupt_progressive_scan_short_83x61.jpg"] = prog[:start + (end - start) // 2] + prog[end:]
    start, end = entropy_span(prog, 4)
    out["progressive_cut_eoi_83x61.jpg"] = prog[:start + (end - start) // 2] + b"\xff\xd9"  # smoothed
    start, end = entropy_span(prog, 0)
    out["progressive_dc_only_83x61.jpg"] = prog[:end] + b"\xff\xd9"  # smoothed, DC interpolated
    # restart-marked progressive files ended by EOI inside a refinement scan: at an RSTn
    # (the next interval decodes its first MCU on zero bits) or inside an interval (the
    # intervals after it are left)
    prog = files["progressive_restart_83x61.jpg"]
    for scan, name in ((6, "dc_refine_boundary"), (9, "refine_boundary")):
        start, end = entropy_span(prog, scan)
        rst = [i for i in range(start, end - 1) if prog[i] == 0xFF and 0xD0 <= prog[i + 1] <= 0xD7]
        out[f"progressive_restart_{name}_83x61.jpg"] = prog[:rst[len(rst) // 2]] + b"\xff\xd9"
    start, end = entropy_span(prog, 7)
    out["progressive_restart_refine_cut_83x61.jpg"] = prog[:start + (end - start) // 2] + b"\xff\xd9"
    return out


def repeated_scan(data: bytes, scan: int, after: int) -> bytes:
    """A progressive JPEG with its scan-th scan (and the tables defined just before it)
    sent again after its after-th scan."""
    segs = jpeg_segments(data)
    sos = [i for i, seg in enumerate(segs) if seg[0] == 0xDA]
    first = sos[scan]
    while first > 0 and segs[first - 1][0] == 0xC4:
        first -= 1
    at = segs[sos[after]][2]
    return data[:at] + data[segs[first][1]:segs[sos[scan]][2]] + data[at:]


def repeated_scan_fixtures(files: dict) -> dict:
    """Progressive JPEGs whose first scans repeat coefficients that earlier scans sent
    and refined (libjpeg decodes the scans in order: a repeated DC first scan overwrites
    the refined DC values, a repeated AC first scan the coefficients it sends)."""
    prog, restart = files["progressive_420_83x61.jpg"], files["progressive_restart_83x61.jpg"]
    return {"progressive_repeat_dc_83x61.jpg": repeated_scan(prog, 0, 6),  # after the DC refinement
            "progressive_repeat_ac_83x61.jpg": repeated_scan(prog, 2, 7),  # Cr's AC after its refinement
            "progressive_restart_repeat_dc_83x61.jpg": repeated_scan(restart, 0, 9)}


def raw_fixtures(cv2) -> dict:
    """BMP, PxM, Sun raster and PFM variants that cv2 reads (cv2's own encoders and the
    small writers above)."""
    files = {}
    bgr = draw(23, 37, 50, cv2)
    gray = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    rng = np.random.default_rng(51)
    pal = rng.integers(0, 256, (256, 3))
    idx8 = (bgr.astype(np.int64).sum(-1) // 3) % 256
    files["bmp_24_37x23.bmp"] = cv2.imencode(".bmp", bgr)[1].tobytes()
    files["bmp_gray_37x23.bmp"] = cv2.imencode(".bmp", gray)[1].tobytes()
    files["bmp_32_37x23.bmp"] = cv2.imencode(".bmp", np.dstack([bgr, gray]))[1].tobytes()
    files["bmp_pal1_37x23.bmp"] = bmp(idx8 & 1, 1, pal[:2])
    files["bmp_pal4_37x23.bmp"] = bmp(idx8 & 15, 4, pal[:16])
    files["bmp_pal8_topdown_37x23.bmp"] = bmp(idx8, 8, pal, top_down=True)
    files["bmp_core_pal8_37x23.bmp"] = bmp(idx8, 8, pal, core=True)
    files["bmp_core_24_37x23.bmp"] = bmp(bgr, 24, core=True)
    words = rng.integers(0, 1 << 16, (23, 37))
    files["bmp_555_37x23.bmp"] = bmp(words & 0x7FFF, 16)
    files["bmp_565_37x23.bmp"] = bmp(words, 16, masks=(0xF800, 0x7E0, 0x1F))
    files["bmp_555_bitfields_37x23.bmp"] = bmp(words & 0x7FFF, 16, masks=(0x7C00, 0x3E0, 0x1F))
    files["bmp_32_bitfields_37x23.bmp"] = bmp(np.dstack([bgr, gray]), 32, masks=(0xFF0000, 0xFF00, 0xFF))
    files["bmp_rle8_37x23.bmp"] = bmp(idx8 // 32, 8, pal, rle=True)
    files["bmp_rle4_37x23.bmp"] = bmp(idx8 % 5, 4, pal[:16], rle=True)
    files["pxm_p1_37x23.pbm"] = pxm_text((gray > 128).astype(np.int64), "1", 1)
    files["pxm_p2_37x23.pgm"] = pxm_text(gray.astype(np.int64) * 3, "2", 700)
    files["pxm_p2_max100_37x23.pgm"] = pxm_text(np.minimum(gray, 120), "2", 100)
    files["pxm_p3_37x23.ppm"] = pxm_text(bgr[..., ::-1], "3", 255)
    files["pxm_p4_37x23.pbm"] = cv2.imencode(".pbm", gray)[1].tobytes()
    files["pxm_p5_37x23.pgm"] = cv2.imencode(".pgm", gray)[1].tobytes()
    files["pxm_p5_max100_37x23.pgm"] = pxm_binary(gray // 3, "5", 100)
    files["pxm_p6_37x23.ppm"] = cv2.imencode(".ppm", bgr)[1].tobytes()
    files["pxm_p6_16bit_37x23.ppm"] = pxm_binary(bgr[..., ::-1].astype(np.int64) * 250 + 7, "6", 65000)
    files["pxm_p5_16bit_37x23.pgm"] = cv2.imencode(".pgm", gray.astype(np.uint16) * 257)[1].tobytes()
    files["ras_24_37x23.ras"] = cv2.imencode(".ras", bgr)[1].tobytes()
    files["ras_gray_37x23.ras"] = cv2.imencode(".ras", gray)[1].tobytes()
    files["ras_cmap8_37x23.ras"] = sunras(idx8, 8, pal)
    files["ras_bw1_37x23.ras"] = sunras(idx8 & 1, 1)
    files["ras_cmap1_37x23.ras"] = sunras(idx8 & 1, 1, pal[:2])
    files["ras_32_37x23.ras"] = sunras(np.dstack([gray, bgr]), 32)
    files["ras_old_cmap8_37x23.ras"] = sunras(idx8, 8, pal[:200], encoding=0)
    files["pfm_rgb_37x23.pfm"] = cv2.imencode(".pfm", bgr.astype(np.float32) * 1.25 - 20)[1].tobytes()
    files["pfm_big_endian_37x23.pfm"] = pfm_big_endian(bgr[..., ::-1].astype(np.float32) / 2 + 0.5, 0.5)
    return files


def pam_fixtures(cv2) -> dict:
    """PAMs as cv2 5.0's PAMDecoder reads them (and refuses them), BigTIFFs in both byte
    orders, and an AVIF whose major brand is not `avif`."""
    files = {}
    bgr = draw(23, 37, 70, cv2)
    gray = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    wide = bgr.astype(np.int64) * 257 + np.arange(37)[None, :, None]
    files["pam_rgb_37x23.pam"] = cv2.imencode(".pam", bgr)[1].tobytes()  # no TUPLTYPE
    files["pam_rgb_tupltype_37x23.pam"] = pam(bgr[..., ::-1], 255, "RGB")
    files["pam_gray_37x23.pam"] = pam(gray, 255, "GRAYSCALE")
    files["pam_gray_no_tupltype_37x23.pam"] = pam(gray, 255)
    files["pam_blackandwhite_37x23.pam"] = pam(gray, 255, "BLACKANDWHITE")
    files["pam_bits_37x23.pam"] = pam(gray > 100, 1, "BLACKANDWHITE")
    files["pam_bits_rgb_37x23.pam"] = pam(np.repeat((gray > 60)[..., None], 3, -1), 1)
    files["pam_bits_rgb_alpha_37x23.pam"] = pam(np.repeat((gray > 140)[..., None], 4, -1), 1, "RGB_ALPHA")
    files["pam_max100_37x23.pam"] = pam(bgr // 3, 100, "RGB")
    files["pam_16bit_37x23.pam"] = pam(wide, 65535, "RGB")
    files["pam_gray16_37x23.pam"] = pam(wide[..., 0] * 3 // 4, 1000, "GRAYSCALE")
    head = (b"P7\r\n# written by make_image_fixtures\n\n  WIDTH\t37 \n#HEIGHT 9\rHEIGHT \n23\nDEPTH 3\r"
            b"TUPLTYPE GRAYSCALE\nMAXVAL 0255\nTUPLTYPE RGB  \nENDHDR of the header\n")
    files["pam_comments_37x23.pam"] = pam(bgr, 255, header=head)
    files["pam_rgb_alpha_37x23.pam"] = pam(np.dstack([bgr, gray]), 255, "RGB_ALPHA")
    files["pam_gray_alpha_37x23.pam"] = pam(np.dstack([gray, 255 - gray]), 255, "GRAYSCALE_ALPHA")
    files["pam_invalid_depth4_37x23.pam"] = pam(np.dstack([bgr, gray]), 255)
    files["pam_invalid_cut_header_37x23.pam"] = pam(gray, 255, "GRAYSCALE")[:30]
    files["pam_invalid_tupltype_depth_37x23.pam"] = pam(gray, 255, "RGB")
    files["pam_invalid_16bit_no_tupltype_37x23.pam"] = cv2.imencode(".pam", wide.astype(np.uint16))[1].tobytes()
    files["pam_invalid_short_37x23.pam"] = pam(bgr, 255)[:-1]
    small = draw(6, 8, 71, cv2)
    files["bigtiff_le_8x6.tif"] = bigtiff(small)
    files["bigtiff_be_8x6.tif"] = bigtiff(small, big_endian=True)
    avif = cv2.imencode(".avif", draw(6, 8, 42, cv2))[1].tobytes()
    files["other_mif1_8x6.avif"] = avif[:8] + b"mif1" + avif[12:]  # `avif` only among the compatible brands
    return files


def fixture_set(cv2) -> dict:
    """name -> encoded bytes."""
    files = {}
    main = {
        "coco_640x480_420.jpg": jpeg(draw(480, 640, 1, cv2), cv2, sampling="420"),
        "coco_427x640_422.jpg": jpeg(draw(640, 427, 2, cv2), cv2, sampling="422"),
        "coco_500x333_444.jpg": jpeg(draw(333, 500, 3, cv2), cv2, sampling="444"),
        "coco_333x500_gray.jpg": jpeg(cv2.cvtColor(draw(500, 333, 4, cv2), cv2.COLOR_BGR2GRAY), cv2),
        "coco_612x612_restart.jpg": jpeg(draw(612, 612, 5, cv2), cv2, restart=7),
        "coco_641x479_q75_opt.jpg": jpeg(draw(479, 641, 6, cv2), cv2, quality=75, optimize=True),
        "coco_480x640_exif6.jpg": with_orientation(jpeg(draw(640, 480, 7, cv2), cv2), 6),
        "coco_640x480_progressive.jpg": jpeg(draw(480, 640, 11, cv2), cv2, progressive=True),
        "coco_640x427_411.jpg": jpeg(draw(427, 640, 12, cv2), cv2, sampling="411"),
        "coco_500x333_cmyk.jpg": pil_cmyk(draw(333, 500, 13, cv2)),
        "progressive_160x120.jpg": jpeg(draw(120, 160, 8, cv2), cv2, progressive=True),
    }
    files.update(main)
    for s in SAMPLINGS:
        for n in SEAMS:
            files[f"seam_w{n}_{s}.jpg"] = jpeg(draw(11, n, n, cv2), cv2, sampling=s)
            files[f"seam_h{n}_{s}.jpg"] = jpeg(draw(n, 13, 100 + n, cv2), cv2, sampling=s)
        files[f"restart1_{s}.jpg"] = jpeg(draw(37, 45, 9, cv2), cv2, sampling=s, restart=1)
        files[f"restart_long_{s}.jpg"] = jpeg(draw(37, 45, 10, cv2), cv2, sampling=s, restart=1000)
    for n in (1, 8, 9, 17):
        files[f"progressive_w{n}_420.jpg"] = jpeg(draw(11, n, 200 + n, cv2), cv2, progressive=True)
        files[f"progressive_h{n}_420.jpg"] = jpeg(draw(n, 13, 300 + n, cv2), cv2, progressive=True)
    img = draw(61, 83, 40, cv2)
    for s in SAMPLINGS + ("411",):
        files[f"progressive_{s}_83x61.jpg"] = jpeg(img, cv2, sampling=s, progressive=True)
    files["progressive_gray_61x83.jpg"] = jpeg(cv2.cvtColor(draw(83, 61, 41, cv2), cv2.COLOR_BGR2GRAY), cv2,
                                                progressive=True)
    files["progressive_restart_83x61.jpg"] = jpeg(img, cv2, restart=3, progressive=True)
    files["progressive_opt_83x61.jpg"] = jpeg(img, cv2, quality=75, optimize=True, progressive=True)
    files["progressive_incomplete_83x61.jpg"] = without_refinement(files["progressive_420_83x61.jpg"])
    files["cmyk_83x61.jpg"] = pil_cmyk(img)
    files["cmyk_progressive_83x61.jpg"] = pil_cmyk(img, progressive=True)
    y, cb, cr = ycc_planes(img)
    k = np.clip(255 - img.max(-1).astype(np.int64) + 40, 0, 255).astype(np.uint8)
    files["ycck_83x61.jpg"] = encode_baseline([y, cb, cr, k], [(2, 2), (1, 1), (1, 1), (2, 2)], cv2, adobe=2)
    for name, factors in (("410", [(4, 2), (1, 1), (1, 1)]), ("3x1", [(3, 1), (1, 1), (1, 1)]),
                          ("4x1_2x1", [(4, 1), (2, 1), (2, 1)]), ("1x4_1x2", [(1, 4), (1, 2), (1, 2)])):
        files[f"sampling_{name}_83x61.jpg"] = encode_baseline([y, cb, cr], factors, cv2)
    for n in NEW_SEAMS:
        files[f"seam_w{n}_411.jpg"] = jpeg(draw(11, n, 500 + n, cv2), cv2, sampling="411")
        files[f"seam_w{n}_410.jpg"] = encode_baseline(ycc_planes(draw(11, n, 400 + n, cv2)),
                                                      [(4, 2), (1, 1), (1, 1)], cv2)
        if n < 33:
            files[f"seam_h{n}_411.jpg"] = jpeg(draw(n, 13, 600 + n, cv2), cv2, sampling="411")
            files[f"seam_h{n}_410.jpg"] = encode_baseline(ycc_planes(draw(n, 13, 700 + n, cv2)),
                                                          [(4, 2), (1, 1), (1, 1)], cv2)
    small = draw(6, 8, 42, cv2)
    files["other_8x6.avif"] = cv2.imencode(".avif", small)[1].tobytes()
    files["other_gray_8x6.pfm"] = cv2.imencode(".pfm", small[..., 0].astype(np.float32))[1].tobytes()
    files["other_8x6.ras"] = cv2.imencode(".ras", small)[1].tobytes()
    files["other_8x6.pfm"] = cv2.imencode(".pfm", small.astype(np.float32) / 255)[1].tobytes()
    for o in range(1, 9):
        files[f"exif{o}_21x14.jpg"] = with_orientation(jpeg(draw(14, 21, 20 + o, cv2), cv2, sampling="420"), o)
    bgr = draw(150, 200, 30, cv2)
    ok, buf = cv2.imencode(".png", bgr)
    files["png_rgb_200x150.png"] = buf.tobytes()
    alpha = np.linspace(0, 255, 150 * 200).reshape(150, 200, 1).astype(np.uint8)
    files["png_rgba_200x150.png"] = cv2.imencode(".png", np.concatenate([bgr, alpha], -1))[1].tobytes()
    files["png_gray_200x150.png"] = cv2.imencode(".png", cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))[1].tobytes()
    files["png_rgb16_120x90.png"] = cv2.imencode(".png", draw(90, 120, 31, cv2).astype(np.uint16) * 257 + 3)[1].tobytes()
    rgb = draw(61, 83, 32, cv2)[..., ::-1]
    pal = np.random.default_rng(33).integers(0, 256, (256, 3))
    idx = (rgb.astype(np.int64).sum(-1) % 256)[..., None]
    files["png_palette_83x61.png"] = png(idx, 3, 8, palette=pal)
    files["png_palette4_adam7_29x23.png"] = png(idx[:23, :29] % 16, 3, 4, True, pal[:16])
    files["png_adam7_83x61.png"] = png(rgb, 2, 8, interlace=True)
    gray = rgb[..., :1].astype(np.int64)
    for depth in (1, 2, 4):
        files[f"png_gray{depth}_37x19.png"] = png(gray[:19, :37] >> (8 - depth), 0, depth)
    ga = np.concatenate([gray * 257, 65535 - gray * 257], -1)[:33, :45]
    files["png_ga16_adam7_45x33.png"] = png(ga, 4, 16, interlace=True)
    files.update(corrupt_fixtures(files, cv2))
    files.update(repeated_scan_fixtures(files))
    files.update(raw_fixtures(cv2))
    files.update(gif_fixtures(cv2))
    files.update(hdr_fixtures(cv2))
    files.update(pam_fixtures(cv2))
    files.update(tiff_fixtures(cv2))
    files.update(jpeg_tiff_fixtures(cv2))
    files.update(colour_tiff_fixtures(cv2))
    files.update(fax_fixtures(cv2))
    files.update(sgilog_fixtures(cv2))
    return files


def invalid_record(files: dict, cv2) -> dict:
    """INVALID's fixtures (what each is), each checked to give None from cv2."""
    for name in INVALID:
        if cv2.imdecode(np.frombuffer(files[name], np.uint8), cv2.IMREAD_COLOR) is not None:
            raise AssertionError(f"cv2 decodes {name}; it is listed as one cv2 returns None for")
    return dict(INVALID)


def file_reads(files: dict, cv2) -> dict:
    """FILE_READS' fixtures as cv2.imread reads each from a file: its RGB's shape and
    SHA-256, or null where imread returns None; each checked to differ from imdecode."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in FILE_READS:
            path = os.path.join(tmp, name)
            with open(path, "wb") as f:
                f.write(files[name])
            bgr = cv2.imread(path, cv2.IMREAD_COLOR)
            mem = cv2.imdecode(np.frombuffer(files[name], np.uint8), cv2.IMREAD_COLOR)
            if (bgr is None) == (mem is None) and (bgr is None or np.array_equal(bgr, mem)):
                raise AssertionError(f"cv2.imread reads {name} as cv2.imdecode does")
            rgb = None if bgr is None else np.ascontiguousarray(bgr[..., ::-1])
            out[name] = None if rgb is None else {"shape": list(rgb.shape), "rgb_sha256": sha(rgb)}
    return out


def digests(files: dict, cv2) -> dict:
    out = {}
    for name, data in sorted(files.items()):
        if name in INVALID:
            continue
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        entry = {"bytes": len(data)}
        if name in REFUSED:
            entry["refused"] = REFUSED[name]
        else:
            rgb = np.ascontiguousarray(bgr[..., ::-1])
            entry.update(shape=list(rgb.shape), rgb_sha256=sha(rgb),
                         resize300_sha256=sha(cv2.resize(rgb, (300, 300))))
            h, w = rgb.shape[:2]
            if h > CANVAS[0] or w > CANVAS[1]:
                scale = min(CANVAS[0] / h, CANVAS[1] / w)
                fit = cv2.resize(rgb, (max(1, int(w * scale)), max(1, int(h * scale))),
                                 interpolation=cv2.INTER_AREA)
                entry.update(area_shape=list(fit.shape), area_sha256=sha(fit))
        out[name] = entry
    return out


def libjpeg_turbo_version(cv2) -> str:
    for line in cv2.getBuildInformation().splitlines():
        if line.strip().startswith("JPEG:"):
            return line.split(":", 1)[1].strip()
    return "unknown"


def main(argv=None) -> None:
    import cv2

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=FIXTURES)
    p.add_argument("--table", default=COMPRESSION_TABLE, help="where the TIFF compression probe goes")
    p.add_argument("--skip-compressions", action="store_true",
                   help="leave the table (the probe of every TIFF compression code takes minutes)")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    files = fixture_set(cv2)
    for name, data in files.items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
    record = {"cv2": cv2.__version__, "libjpeg_turbo": libjpeg_turbo_version(cv2),
              "canvas": list(CANVAS), "images": digests(files, cv2), "invalid": invalid_record(files, cv2),
              "file_reads": file_reads(files, cv2)}
    with open(os.path.join(args.out, "digests.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
    if not args.skip_compressions:
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            table = {"cv2": cv2.__version__, "bases": compression_table(cv2, tmp)}
        with open(args.table, "w") as f:
            json.dump(table, f, indent=1, sort_keys=True)
    print(f"{len(files)} fixtures, {sum(map(len, files.values()))} bytes -> {args.out}")


if __name__ == "__main__":
    main()
