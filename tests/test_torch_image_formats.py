"""What cv2 reads and the port once refused or got wrong, decoded on the CPU (each
kernel's plain version) against cv2.imdecode(..., IMREAD_COLOR) as RGB, which is what the
JAX package's decode paths return (ssd_object_detection_tpu/data/pipeline.py:70-87,
eval/serve.py:374-381):

  - BMP, PBM/PGM/PPM (P1-P6), Sun raster and PFM variants, written here with the fixture
    tool's small writers (ssd_object_detection_tpu_torch/tools/make_image_fixtures.py)
    at the widths where row padding and bit packing have their edges;
  - what cv2 returns None for among them raises ValueError;
  - JPEGs whose entropy-coded data is corrupt (cut and ended by a marker, runs of FF
    bytes, a restart interval cut short, a progressive scan cut short), which libjpeg
    decodes with warnings, and progressive JPEGs libjpeg smooths (scans cut or left out);
  - progressive JPEGs whose first scans repeat coefficients sent and refined before;
  - GIF variants (cv2's GifDecoder: frames on a larger screen, transparency, colour
    tables, extension blocks, the LZW data's edges: EOI, a code after the last pixel,
    codes past the table, strings past the frame) and Radiance HDR variants (rgbe.cpp:
    header lines, resolution lines, RLE and flat scanlines, exponents), each written
    here with the fixture tool's writers; what cv2 returns None for raises ValueError;
  - PAM (P7) headers and samples at each rule of cv2 5.0's PAMDecoder (line breaks, white
    space, comments, name and value lengths, numbers, repeated fields, TUPLTYPE against
    DEPTH, MAXVAL 1 bits, 16-bit samples), pinned case by case and over seeded random
    headers; a PAM with alpha past MAXVAL 1 is refused (cv2 fills it from memory it never
    wrote); AVIF named by any brand of its `ftyp` box is refused, and every signature one
    of cv2's decoders accepts gives a kind or a refusal, never ValueError;
  - TIFF and BigTIFF as cv2 5.0 reads them through libtiff 4.7 (strips and tiles, separate
    planes, PackBits, Deflate, LZW and its stopping rules, the predictor, 1- to 16-bit
    samples, gray, palette, RGB(A) and CMYK, the orientation): every fixture against
    cv2's digests, each rule as a case, and seeded random directories whose outcome
    (decoded and equal, UnsupportedImage, ValueError) must be cv2's;
  - a COCO root holding a BMP, a PPM, a Sun raster, a PFM, a GIF, an HDR and corrupt
    JPEGs under .jpg names packs byte-equal to the JAX package's pack_dataset.

Tolerance: none. Inputs: the committed fixtures and images drawn from seeded numpy
generators.
"""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from ssd_object_detection_tpu.data import coco as jax_coco
from ssd_object_detection_tpu.data import packed as jax_packed
from ssd_object_detection_tpu_torch.data import codec, coco, packed
from ssd_object_detection_tpu_torch.tools import make_image_fixtures as fx

torch.set_num_threads(1)


def _bytes(name: str) -> bytes:
    with open(os.path.join(fx.FIXTURES, name), "rb") as f:
        return f.read()


def _cv2(data: bytes):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if img is None else img[..., ::-1]


def _assert_as_cv2(data: bytes):
    want = _cv2(data)
    assert want is not None
    np.testing.assert_array_equal(codec.decode_image(data, "cpu").numpy(), want)


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, 3)).astype(np.uint8), rng.integers(0, 256, (256, 3))


# ---------------------------------------------------------------------------- BMP
@pytest.mark.parametrize("width", [1, 2, 3, 5, 9])
@pytest.mark.parametrize("kind", ["pal1", "pal4", "pal8", "555", "565", "24", "32", "core8", "topdown4",
                                  "rle8", "rle4"])
def test_bmp_variants_decode_as_cv2(kind, width):
    bgr, pal = _image(7, width, width)
    idx = bgr[..., 0].astype(np.int64)
    words = bgr[..., 0].astype(np.int64) | (bgr[..., 1].astype(np.int64) << 8)
    data = {
        "pal1": lambda: fx.bmp(idx & 1, 1, pal[:2]),
        "pal4": lambda: fx.bmp(idx & 15, 4, pal[:16]),
        "pal8": lambda: fx.bmp(idx, 8, pal),
        "555": lambda: fx.bmp(words & 0x7FFF, 16),
        "565": lambda: fx.bmp(words, 16, masks=(0xF800, 0x7E0, 0x1F)),
        "24": lambda: fx.bmp(bgr, 24),
        "32": lambda: fx.bmp(np.dstack([bgr, bgr[..., :1]]), 32),
        "core8": lambda: fx.bmp(idx, 8, pal, core=True),
        "topdown4": lambda: fx.bmp(idx & 15, 4, pal[:16], top_down=True),
        "rle8": lambda: fx.bmp(idx // 64, 8, pal, rle=True),
        "rle4": lambda: fx.bmp(idx % 3, 4, pal[:16], rle=True),
    }[kind]()
    _assert_as_cv2(data)


def _rle8_body(words):
    """An 8-bit BMP of 6x4 index pixels over the palette fixture, with an RLE body."""
    pal = np.random.default_rng(1).integers(0, 256, (256, 3))
    base = fx.bmp(np.zeros((4, 6), np.int64), 8, pal, rle=True)
    offset = struct.unpack("<I", base[10:14])[0]
    return base[:offset] + bytes(words)


@pytest.mark.parametrize("case", ["delta_across_rows", "end_of_bitmap_early", "run_ends_row_then_eol",
                                  "absolute_odd"])
def test_bmp_rle8_codes_decode_as_cv2(case):
    """RLE8's escape codes where cv2's reader has its own ways: a delta moves across
    rows filling index 0, an end of bitmap fills the rest, an end of line right after a
    run that ended its row, an absolute run of odd length (padded to a word)."""
    body = {
        "delta_across_rows": [2, 7, 0, 2, 1, 1, 2, 9, 0, 0, 6, 3, 0, 0, 0, 1],
        "end_of_bitmap_early": [6, 5, 0, 0, 3, 2, 0, 1],
        "run_ends_row_then_eol": [6, 4, 0, 0, 6, 8, 0, 0, 2, 1, 0, 0, 0, 1],
        "absolute_odd": [0, 3, 9, 8, 7, 0, 3, 2, 0, 0, 0, 5, 1, 2, 3, 4, 5, 0, 1, 6, 0, 0, 0, 1],
    }[case]
    _assert_as_cv2(_rle8_body(body))


# ---------------------------------------------------------------------------- PxM
@pytest.mark.parametrize("case", ["p1_packed_digits", "p1_comments", "p2_maxval_1", "p2_clamped", "p2_maxval_256",
                                  "p3_maxval_65535", "p5_maxval_1", "p6_maxval_256", "p4_width_9", "p5_comment_tab"])
def test_pxm_variants_decode_as_cv2(case):
    bgr, _ = _image(5, 9, 3)
    gray = bgr[..., 0].astype(np.int64)
    data = {
        "p1_packed_digits": lambda: b"P1\n9 5\n" + b"".join(bytes(48 + (v & 1) for v in row) + b"\n" for row in gray),
        "p1_comments": lambda: b"P1 # a\n# b\n9\t5\n" + b" ".join(b"%d" % (v & 1) for v in gray.reshape(-1)),
        "p2_maxval_1": lambda: fx.pxm_text(gray & 1, "2", 1),
        "p2_clamped": lambda: fx.pxm_text(gray, "2", 200),  # values past maxval are clamped
        "p2_maxval_256": lambda: fx.pxm_text(gray, "2", 256),
        "p3_maxval_65535": lambda: fx.pxm_text(bgr.astype(np.int64) * 257, "3", 65535),
        "p5_maxval_1": lambda: fx.pxm_binary(gray & 1, "5", 1),  # binary samples are not scaled
        "p6_maxval_256": lambda: fx.pxm_binary(bgr.astype(np.int64), "6", 256),
        "p4_width_9": lambda: cv2.imencode(".pbm", bgr[..., 0])[1].tobytes(),
        "p5_comment_tab": lambda: b"P5\t# c\n9 5 255\n" + bgr[..., 0].tobytes(),
    }[case]()
    _assert_as_cv2(data)


# ---------------------------------------------------------------------------- Sun raster, PFM
@pytest.mark.parametrize("width", [1, 2, 3, 17])
@pytest.mark.parametrize("kind", ["bw1", "cmap1", "gray8", "cmap8", "short_cmap8", "24", "32"])
def test_sunras_variants_decode_as_cv2(kind, width):
    bgr, pal = _image(4, width, 40 + width)
    idx = bgr[..., 0].astype(np.int64)
    data = {
        "bw1": lambda: fx.sunras(idx & 1, 1),
        "cmap1": lambda: fx.sunras(idx & 1, 1, pal[:2]),
        "gray8": lambda: fx.sunras(idx, 8),
        "cmap8": lambda: fx.sunras(idx, 8, pal),
        "short_cmap8": lambda: fx.sunras(idx % 100, 8, pal[:100], encoding=0),
        "24": lambda: fx.sunras(bgr, 24),
        "32": lambda: fx.sunras(np.dstack([bgr[..., :1], bgr]), 32),
    }[kind]()
    _assert_as_cv2(data)


@pytest.mark.parametrize("case", ["little_endian_scaled", "big_endian", "out_of_range", "non_finite", "halves"])
def test_pfm_variants_decode_as_cv2(case):
    rng = np.random.default_rng(9)
    rgb = rng.uniform(-20, 300, (3, 5, 3)).astype(np.float32)
    if case == "out_of_range":
        rgb[0, :, 0] = [-1e9, 1e9, 3e9, -3e9, 255.5]
    elif case == "non_finite":
        rgb[1, :, 1] = [np.nan, np.inf, -np.inf, 0.5, 1.5]
    elif case == "halves":
        rgb[:] = np.arange(45, dtype=np.float32).reshape(3, 5, 3) + 0.5  # ties round to even
    if case in ("big_endian",):
        data = fx.pfm_big_endian(rgb, 1.0)
    else:
        data = cv2.imencode(".pfm", rgb[..., ::-1])[1].tobytes()
        if case == "little_endian_scaled":
            data = data.replace(b"\n-1", b"\n-2.5", 1)
    _assert_as_cv2(data)


# ---------------------------------------------------------------------------- what cv2 refuses
def _sun_type(data: bytes, kind: int) -> bytes:
    return data[:20] + struct.pack(">i", kind) + data[24:]


@pytest.mark.parametrize("case", ["sun_byte_encoded", "sun_rgb_type", "sun_4_bits", "bmp_masks_other",
                                  "bmp_pixels_cut", "bmp_rle_run_past_row", "pxm_maxval_past_65535", "pxm_cut",
                                  "pxm_letter", "pfm_cut", "pfm_no_line_break"])
def test_what_cv2_refuses_raises_value_error(case):
    bgr, pal = _image(4, 6, 5)
    idx = bgr[..., 0].astype(np.int64)
    sun = fx.sunras(idx, 8, pal)
    data = {
        "sun_byte_encoded": lambda: _sun_type(sun, 2),
        "sun_rgb_type": lambda: _sun_type(fx.sunras(bgr, 24), 3),
        "sun_4_bits": lambda: sun[:12] + struct.pack(">i", 4) + sun[16:],
        "bmp_masks_other": lambda: fx.bmp(idx, 16, masks=(0xF00, 0xF0, 0xF)),
        "bmp_pixels_cut": lambda: fx.bmp(bgr, 24)[:-10],
        "bmp_rle_run_past_row": lambda: _rle8_body([7, 1, 0, 0, 0, 1]),
        "pxm_maxval_past_65535": lambda: b"P5\n6 4\n70000\n" + bytes(48),
        "pxm_cut": lambda: fx.pxm_binary(idx, "5", 255)[:-3],
        "pxm_letter": lambda: b"P2\n6 4\n255\n1 2 x 4\n",
        "pfm_cut": lambda: cv2.imencode(".pfm", bgr.astype(np.float32))[1].tobytes()[:-4],
        "pfm_no_line_break": lambda: b"PF 6 4\n-1\n" + bytes(6 * 4 * 12),
    }[case]()
    assert _cv2(data) is None
    with pytest.raises(ValueError):
        codec.decode_image(data, "cpu")



# ---------------------------------------------------------------------------- PAM
def _pam(head: bytes, body: bytes = bytes(range(10, 16))) -> bytes:
    return b"P7" + head + body


_H = b"WIDTH 3\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\n"
PAM_CASES = {
    # the line break after P7, and line ends
    "p7_space": lambda: _pam(b" \n" + _H + b"ENDHDR\n"),
    "p7_cr": lambda: _pam(b"\r" + _H + b"ENDHDR\n"),
    "p7_crlf": lambda: _pam(b"\r\n" + _H + b"ENDHDR\n"),
    "cr_lines": lambda: _pam(b"\r" + _H.replace(b"\n", b"\r") + b"ENDHDR\r"),
    "endhdr_crlf": lambda: _pam(b"\n" + _H + b"ENDHDR\r\n"),  # the LF is the first sample
    "endhdr_value": lambda: _pam(b"\n" + _H + b"ENDHDR and more\n"),
    "endhdr_value_next_line": lambda: _pam(b"\n" + _H + b"ENDHDR\t\t\nxyz\n"),
    "endhdr_space_eats_samples": lambda: _pam(b"\n" + _H + b"ENDHDR \n", b"  abc\ndefghi"),
    "endhdr_last": lambda: _pam(b"\n" + _H + b"ENDHDR", b""),
    # white space and comments
    "leading_space_blank_lines": lambda: _pam(b"\n   WIDTH 3\n\n\n  HEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n"),
    "tabs_vt_ff": lambda: _pam(b"\nWIDTH\t\t3\nHEIGHT\v2\nDEPTH\f1\nMAXVAL 255\t \nENDHDR\n"),
    "value_on_next_line": lambda: _pam(b"\nWIDTH \n3\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n"),
    "name_then_line_break": lambda: _pam(b"\nWIDTH\n3\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n"),
    "comments": lambda: _pam(b"\n# a\nWIDTH 3\n  # b\n#HEIGHT 9\rHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n"),
    "comment_after_value": lambda: _pam(b"\nWIDTH 3\nHEIGHT 2 # two\nDEPTH 1\nMAXVAL 255\nENDHDR\n"),
    "hash_in_name": lambda: _pam(b"\nWID#TH 3\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n"),
    # names and values
    "lower_case_name": lambda: _pam(b"\nwidth 3\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n"),
    "unknown_name": lambda: _pam(b"\n" + _H + b"SIZE 4\nENDHDR\n"),
    "name_of_9": lambda: _pam(b"\n" + _H + b"TUPLTYPES GRAYSCALE\nENDHDR\n"),
    "nul_in_name": lambda: _pam(b"\nWIDTH\0 3\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n"),
    "nul_in_value": lambda: _pam(b"\nWIDTH 3\0 9\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n"),
    "value_of_255": lambda: _pam(b"\n" + _H + b"TUPLTYPE GRAYSCALE" + b" " * 246 + b"\nENDHDR\n"),
    "value_of_256": lambda: _pam(b"\n" + _H + b"TUPLTYPE GRAYSCALE" + b" " * 247 + b"\nENDHDR\n"),
    "zeros_255": lambda: _pam(b"\nWIDTH " + b"0" * 254 + b"3\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n"),
    "zeros_256": lambda: _pam(b"\nWIDTH " + b"0" * 255 + b"3\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n"),
    "plus_sign": lambda: _pam(b"\nWIDTH +3\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n"),
    "two_numbers": lambda: _pam(b"\nWIDTH 3 4\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n"),
    "minus_only": lambda: _pam(b"\nWIDTH 3\nHEIGHT 2\nDEPTH 1\nMAXVAL -\nENDHDR\n"),
    "width_int_max": lambda: _pam(b"\nWIDTH 2147483647\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n"),
    "width_zero": lambda: _pam(b"\nWIDTH 0\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n"),
    "width_negative": lambda: _pam(b"\nWIDTH -3\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n"),
    "width_past_2_20": lambda: _pam(b"\nWIDTH 1048577\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n", bytes(1048577)),
    # MAXVAL
    "maxval_0": lambda: _pam(b"\nWIDTH 3\nHEIGHT 2\nDEPTH 1\nMAXVAL 0\nENDHDR\n"),
    "maxval_empty": lambda: _pam(b"\nWIDTH 3\nHEIGHT 2\nDEPTH 1\nMAXVAL\nENDHDR\n"),
    "maxval_negative": lambda: _pam(b"\nWIDTH 3\nHEIGHT 2\nDEPTH 1\nMAXVAL -300\nENDHDR\n"),
    "maxval_2": lambda: _pam(b"\nWIDTH 3\nHEIGHT 2\nDEPTH 1\nMAXVAL 2\nENDHDR\n"),
    "maxval_256_no_tupltype": lambda: _pam(b"\nWIDTH 3\nHEIGHT 2\nDEPTH 1\nMAXVAL 256\nENDHDR\n", bytes(12)),
    "maxval_256_gray": lambda: _pam(b"\nWIDTH 3\nHEIGHT 2\nDEPTH 1\nMAXVAL 256\nTUPLTYPE GRAYSCALE\nENDHDR\n",
                                    bytes(range(1, 13))),
    "maxval_65536": lambda: _pam(b"\nWIDTH 3\nHEIGHT 2\nDEPTH 1\nMAXVAL 65536\nTUPLTYPE GRAYSCALE\nENDHDR\n",
                                 bytes(12)),
    "rgb16": lambda: _pam(b"\nWIDTH 2\nHEIGHT 2\nDEPTH 3\nMAXVAL 1000\nTUPLTYPE RGB\nENDHDR\n", bytes(range(1, 25))),
    # repeated fields, TUPLTYPE against DEPTH
    "width_twice": lambda: _pam(b"\nWIDTH 3\n" + _H + b"ENDHDR\n"),
    "tupltype_last_counts": lambda: _pam(b"\n" + _H + b"TUPLTYPE RGB\nTUPLTYPE GRAYSCALE\nENDHDR\n"),
    "tupltype_last_wrong": lambda: _pam(b"\n" + _H + b"TUPLTYPE GRAYSCALE\nTUPLTYPE RGB\nENDHDR\n"),
    "tupltype_empty": lambda: _pam(b"\n" + _H + b"TUPLTYPE\nENDHDR\n"),
    "tupltype_space_eats_endhdr": lambda: _pam(b"\n" + _H + b"TUPLTYPE \nENDHDR\n"),
    "tupltype_before_depth": lambda: _pam(b"\nTUPLTYPE RGB\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\n",
                                          bytes(range(18))),
    "tupltype_lower_case": lambda: _pam(b"\n" + _H + b"TUPLTYPE grayscale\nENDHDR\n"),
    "depth_0": lambda: _pam(b"\nWIDTH 3\nHEIGHT 2\nDEPTH 0\nMAXVAL 255\nENDHDR\n"),
    "depth_5": lambda: _pam(b"\nWIDTH 3\nHEIGHT 2\nDEPTH 5\nMAXVAL 255\nTUPLTYPE RGB\nENDHDR\n", bytes(30)),
    "depth_2_no_tupltype": lambda: _pam(b"\nWIDTH 3\nHEIGHT 2\nDEPTH 2\nMAXVAL 255\nENDHDR\n", bytes(12)),
    "depth_3_grayscale": lambda: _pam(b"\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nTUPLTYPE GRAYSCALE\nENDHDR\n",
                                      bytes(18)),
    "depth_1_rgb_alpha": lambda: _pam(b"\n" + _H + b"TUPLTYPE RGB_ALPHA\nENDHDR\n"),
    # MAXVAL 1: bits at the start of rows of WIDTH x DEPTH bytes
    "bits_3x2": lambda: _pam(b"\nWIDTH 3\nHEIGHT 2\nDEPTH 1\nMAXVAL 1\nENDHDR\n", bytes([0xA0, 0x40, 0x11, 0x22, 0x33,
                                                                                       0x44])),
    "bits_a_byte_short": lambda: _pam(b"\nWIDTH 3\nHEIGHT 2\nDEPTH 1\nMAXVAL 1\nENDHDR\n", bytes([0xA0, 0x40])),
    "bits_gray_alpha": lambda: _pam(b"\nWIDTH 9\nHEIGHT 3\nDEPTH 2\nMAXVAL 1\nTUPLTYPE GRAYSCALE_ALPHA\nENDHDR\n",
                                    bytes(range(200, 254))),
    "bits_rgb": lambda: _pam(b"\nWIDTH 10\nHEIGHT 3\nDEPTH 3\nMAXVAL 1\nTUPLTYPE RGB\nENDHDR\n", bytes(range(90, 180))),
    # what ends early
    "header_cut": lambda: _pam(b"\nWIDTH 3\nHEIG", b""),
    "comment_cut": lambda: _pam(b"\n# abc", b""),
    "field_missing": lambda: _pam(b"\nWIDTH 3\nHEIGHT 2\nMAXVAL 255\nENDHDR\n"),
    "samples_short": lambda: _pam(b"\n" + _H + b"ENDHDR\n", bytes(5)),
    "samples_longer": lambda: _pam(b"\n" + _H + b"ENDHDR\n", bytes(range(9))),
}


def _cv2_or_none(data: bytes):
    try:
        return _cv2(data)
    except cv2.error:  # imdecode raises for an empty image
        return None


def _port_or_none(data: bytes):
    try:
        return codec.decode_image(data, "cpu").numpy()
    except ValueError:
        return None


@pytest.mark.parametrize("case", sorted(PAM_CASES))
def test_pam_header_rules_as_cv2(case):
    """Each rule of cv2 5.0's PAM header and sample layout: the port decodes as cv2 does,
    or raises ValueError where cv2 returns None (or raises)."""
    data = PAM_CASES[case]()
    want, got = _cv2_or_none(data), _port_or_none(data)
    assert (want is None) == (got is None), case
    if want is not None:
        np.testing.assert_array_equal(got, want)


def _random_pam(rng) -> bytes:
    """A PAM of random fields and samples, with now and then white space, comments,
    NULs, a field missing, repeated or unknown, and samples cut or left over."""
    w, h = int(rng.integers(1, 12)), int(rng.integers(1, 5))
    depth = int(rng.choice([1, 2, 3, 4, 1, 3, 0, 5]))
    maxval = int(rng.choice([1, 255, 100, 0, 2, 256, 65535, -5, 65536, 1000]))
    tupltype = rng.choice([None, None, b"", b"GRAYSCALE", b"BLACKANDWHITE", b"RGB", b"RGB_ALPHA", b"GRAYSCALE_ALPHA",
                           b"rgb"])
    fields = [(b"WIDTH", b"%d" % w), (b"HEIGHT", b"%d" % h), (b"DEPTH", b"%d" % depth), (b"MAXVAL", b"%d" % maxval)]
    if tupltype is not None:
        fields.append((b"TUPLTYPE", tupltype))
    for extra in ((b"WIDTH", b"3"), (b"FOO", b"1"), (b"TUPLTYPE", rng.choice([b"RGB", b"GRAYSCALE", b""]))):
        if rng.random() < 0.05:
            fields.append(extra)
    if rng.random() < 0.05:
        fields.pop(int(rng.integers(len(fields))))
    junk = [b" ", b"\t", b"\n", b"\r", b"\v", b"\f", b"# c\n", b"#x\r", b"\0"]
    head = b"P7" + rng.choice([b"\n", b"\r", b"\n", b"\n", b" "])
    for i in rng.permutation(len(fields)):
        name, value = fields[i]
        if rng.random() < 0.05:
            head += rng.choice(junk)
        head += (b"".join(rng.choice(junk[:6], rng.integers(0, 3))) + name
                 + rng.choice([b" ", b"\t", b"  ", b" \n", b"\t\r"]) + value
                 + rng.choice([b"", b" ", b"\t", b"\0"]) + rng.choice([b"\n", b"\r"]))
    head += rng.choice([b"ENDHDR\n", b"ENDHDR\n", b"ENDHDR\r\n", b"ENDHDR x\n", b"  ENDHDR\n"])
    need = w * h * max(depth, 1) * (2 if maxval > 255 else 1)
    data = head + rng.integers(0, 256, max(0, need + int(rng.choice([0, 0, 0, 1, -1]))), np.uint8).tobytes()
    return data[:int(rng.integers(3, len(data)))] if rng.random() < 0.03 else data


@pytest.mark.parametrize("seed", range(8))
def test_random_pam_headers_as_cv2(seed):
    """400 random PAMs a seed: each decodes as cv2 decodes it, raises ValueError where
    cv2 returns None, or (alpha past MAXVAL 1) raises UnsupportedImage where cv2 returns
    pixels it partly never wrote."""
    rng = np.random.default_rng(1000 + seed)
    decoded = 0
    for _ in range(400):
        data = _random_pam(rng)
        want = _cv2_or_none(data)
        try:
            got = _port_or_none(data)
        except codec.UnsupportedImage as e:
            assert want is not None and "alpha" in str(e)
            continue
        assert (want is None) == (got is None), data[:80]
        if want is not None:
            np.testing.assert_array_equal(got, want)
            decoded += 1
    assert decoded > 20


@pytest.mark.parametrize("maxval", [2, 255, 1000, 65535])
@pytest.mark.parametrize("tupltype,depth", [(b"RGB_ALPHA", 4), (b"GRAYSCALE_ALPHA", 2)])
def test_pam_with_alpha_is_refused(tupltype, depth, maxval):
    """cv2 returns an image for a PAM with alpha, but converts only a few pixels of each
    row and leaves the rest as memory it never wrote: the port refuses it, naming why."""
    samples = np.random.default_rng(maxval).integers(0, 256, 9 * 4 * depth * (1 + (maxval > 255)), np.uint8)
    data = (b"P7\nWIDTH 9\nHEIGHT 4\nDEPTH %d\nMAXVAL %d\nTUPLTYPE %s\nENDHDR\n" % (depth, maxval, tupltype)
            + samples.tobytes())
    assert _cv2(data) is not None
    with pytest.raises(codec.UnsupportedImage, match="memory it did not write"):
        codec.decode_image(data, "cpu")


# ---------------------------------------------------------------------------- signatures
def _ftyp(major: bytes, compatible, size=None, large=False) -> bytes:
    body = major + bytes(4) + b"".join(compatible)
    if large:
        return struct.pack(">I", 1) + b"ftyp" + struct.pack(">Q", 16 + len(body)) + body
    return struct.pack(">I", size if size is not None else 8 + len(body)) + b"ftyp" + body


def _sequence() -> bytes:
    """cv2's AVIF of two frames: an image sequence, major brand `avis`, `avif` the first
    compatible one."""
    img = _image(32, 16, 11)[0]
    return cv2.imencodemulti(".avif", [img[:16], img[16:]])[1].tobytes()


@pytest.mark.parametrize("case", ["major_avif", "major_avis", "compatible_avif", "compatible_avis", "large_size",
                                  "no_avif_brand", "box_past_data", "brands_not_whole_words", "size_zero"])
def test_avif_is_refused_by_any_brand(case):
    """cv2 (libavif) takes a file whose `ftyp` box names `avif` or `avis` as its major
    brand or among its compatible brands; the port refuses each such file as AVIF. A
    box without either brand, or that runs past the data, is no AVIF: ValueError."""
    avif = _bytes("other_8x6.avif")
    size = struct.unpack(">I", avif[:4])[0]
    rest = avif[size:]
    data = {
        "major_avif": lambda: avif,
        "major_avis": _sequence,
        "compatible_avif": lambda: _bytes("other_mif1_8x6.avif"),
        "compatible_avis": lambda: _sequence()[:8] + b"msf1" + _sequence()[12:16] + b"iso8" + _sequence()[20:],
        "large_size": lambda: _ftyp(b"avif", [b"avif", b"mif1"], large=True) + rest,  # as long: iloc's offsets hold
        "no_avif_brand": lambda: _ftyp(b"mif1", [b"mif1", b"miaf", b"miaf", b"MA1B"]) + rest,
        "box_past_data": lambda: struct.pack(">I", len(avif) + 100) + avif[4:],
        "brands_not_whole_words": lambda: _ftyp(b"mif1", [b"mif1", b"avif", b"mi"]) + rest,
        "size_zero": lambda: struct.pack(">I", 0) + avif[4:],
    }[case]()
    if case in ("major_avif", "major_avis", "compatible_avif", "compatible_avis", "large_size"):
        assert _cv2(data) is not None
        with pytest.raises(codec.UnsupportedImage, match="AVIF"):
            codec.image_kind(data)
    else:
        assert _cv2_or_none(data) is None
        with pytest.raises(ValueError):
            codec.image_kind(data)


@pytest.mark.parametrize("name", ["bigtiff_le_8x6.tif", "bigtiff_be_8x6.tif", "tiff_bigtiff_lzw_le_37x23.tif",
                                  "tiff_bigtiff_lzw_be_37x23.tif"])
def test_bigtiff_is_read_as_cv2(name):
    """BigTIFF (8-byte offsets, LONG8 values) in both byte orders decodes as cv2 reads it."""
    data = _bytes(name)
    np.testing.assert_array_equal(codec.decode_image(data, "cpu").numpy(), _cv2(data))


SIGNATURES = {  # a body of each signature one of cv2 5.0's decoders (this build's) accepts
    "jpeg": "coco_500x333_444.jpg", "png": "png_rgb_200x150.png", "gif89a": "gif_cv2_37x23.gif",
    "gif87a": "gif87a_37x23.gif", "bmp": "bmp_24_37x23.bmp", "p1": "pxm_p1_37x23.pbm", "p2": "pxm_p2_37x23.pgm",
    "p3": "pxm_p3_37x23.ppm", "p4": "pxm_p4_37x23.pbm", "p5": "pxm_p5_37x23.pgm", "p6": "pxm_p6_37x23.ppm",
    "pam": "pam_rgb_37x23.pam", "sunras": "ras_24_37x23.ras", "pfm": "pfm_rgb_37x23.pfm",
    "pfm_gray": "other_gray_8x6.pfm", "hdr_radiance": "hdr_cv2_rle_37x23.hdr", "hdr_rgbe": "hdr_rgbe_header_9x6.hdr",
    "bigtiff_le": "bigtiff_le_8x6.tif", "bigtiff_be": "bigtiff_be_8x6.tif", "avif": "other_8x6.avif",
    "tiff_le": "tiff_cv2_37x23.tif", "tiff_be": "tiff_be_16bit_37x23.tif", "tiff_jpeg": "tiff_jpeg_pil_rgb_37x23.tif",
    "tiff_group4": "tiff_group4_37x23.tif", "avif_compatible": "other_mif1_8x6.avif",
}
ENCODED = {"tiff": ".tiff", "webp": ".webp", "jp2": ".jp2", "j2k": ".jp2"}  # cv2's encoders write these


@pytest.mark.parametrize("case", sorted(SIGNATURES) + sorted(ENCODED))
def test_every_signature_cv2_reads_gives_a_kind_or_a_refusal(case):
    """A body that cv2 decodes gives a kind the port decodes, or UnsupportedImage; never
    the ValueError that stands for cv2's None."""
    if case in ENCODED:
        data = cv2.imencode(ENCODED[case], _image(64, 64, 9)[0])[1].tobytes()
        if case == "j2k":  # the JP2 file's codestream alone
            data = data[data.find(b"jp2c") + 4:]
    else:
        data = _bytes(SIGNATURES[case])
    assert _cv2(data) is not None
    try:
        kind = codec.image_kind(data)
    except codec.UnsupportedImage:
        return
    assert kind in ("jpeg", "png", "gif", "tiff") + codec.RAW_KINDS

# ---------------------------------------------------------------------------- GIF
def _as_cv2_or_refused(data: bytes):
    """Decoded as cv2 decodes it, or ValueError where cv2 returns None."""
    want = _cv2(data)
    if want is None:
        with pytest.raises(ValueError):
            codec.decode_image(data, "cpu")
    else:
        np.testing.assert_array_equal(codec.decode_image(data, "cpu").numpy(), want)


def _gif_case(case: str) -> bytes:
    rng = np.random.default_rng(80)
    pal = rng.integers(0, 256, (256, 3))
    pal[0], pal[5] = (200, 50, 90), (11, 22, 33)
    idx = rng.integers(1, 256, (6, 7))
    flat = idx.reshape(-1).tolist()
    lits = [256] + flat  # Clear, then every pixel as a literal
    extra = rng.integers(1, 256, 8).tolist()
    ext_at = 13 + 768  # after the global table, where the frame's blocks start
    plain = fx.gif(idx, pal, disposal=None)
    t = idx.copy()
    t[0, :3] = 7
    gray = idx.copy()
    gray[0, :4] = [0, 1, 2, 1]
    return {
        "screen_bg_disposal_0": lambda: fx.gif(idx, pal, screen=(12, 10), pos=(3, 2), bg=5, disposal=0),
        "screen_bg_disposal_3": lambda: fx.gif(idx, pal, screen=(12, 10), pos=(3, 2), bg=5, disposal=3),
        "screen_no_gce": lambda: fx.gif(idx, pal, screen=(12, 10), pos=(3, 2), bg=5, disposal=None),
        "transparent_shows_bg": lambda: fx.gif(t, pal, screen=(12, 10), pos=(3, 2), transparent=7, bg=5),
        "transparent_is_bg": lambda: fx.gif(t, pal, screen=(12, 10), pos=(3, 2), transparent=5, bg=5),
        "transparent_past_table": lambda: fx.gif(np.where(t == 7, 200, t % 16), pal[:16], transparent=200, bg=5),
        "no_table_0_and_1": lambda: fx.gif(gray, disposal=None),
        "no_table_transparent": lambda: fx.gif(gray, transparent=2, screen=(9, 7), pos=(1, 1)),
        "local_only_on_screen": lambda: fx.gif(idx, local_colors=pal, screen=(12, 10), pos=(3, 2), bg=5),
        "local_16_past_16": lambda: fx.gif(idx, local_colors=pal[:16]),
        "literal_past_8_bits": lambda: fx.gif(idx, pal, min_code_size=9, data=fx.lzw_pack(
            [512] + [v + 256 * (i % 2) for i, v in enumerate(flat)] + [513], 9)),
        "min_code_10": lambda: fx.gif(idx % 4, pal, min_code_size=10),
        "interlaced_7_rows": lambda: fx.gif(rng.integers(0, 4, (7, 5)), pal, interlace=True),
        "no_first_clear": lambda: fx.gif(idx, pal, data=fx.lzw_pack(fx.lzw_codes(idx, 8)[1:], 8)),
        "eoi_then_more": lambda: fx.gif(idx, pal, data=fx.lzw_pack([256] + flat[:20] + [257] + flat[20:], 8)),
        "eoi_then_one_byte": lambda: fx.gif(idx, pal, data=fx.lzw_pack(lits + [257], 8) + b"\0"),
        "eoi_then_two_bytes": lambda: fx.gif(idx, pal, data=fx.lzw_pack(lits + [257], 8) + b"\0\0"),
        "one_byte_after": lambda: fx.gif(idx, pal, data=fx.lzw_pack(lits, 8) + b"\xff"),
        "two_bytes_after": lambda: fx.gif(idx, pal, data=fx.lzw_pack(lits, 8) + b"\xff\xff"),
        "pixel_short": lambda: fx.gif(idx, pal, data=fx.lzw_pack(lits[:-1] + [257], 8)),
        "pixel_over_no_eoi": lambda: fx.gif(idx, pal, data=fx.lzw_pack(lits + extra[:1], 8)),
        "pixel_over_with_eoi": lambda: fx.gif(idx, pal, data=fx.lzw_pack(lits + extra[:1] + [257], 8)),
        "pair_crosses_the_end": lambda: fx.gif(idx, pal, data=fx.lzw_pack(lits[:-1] + [258], 8)),
        "code_past_table": lambda: fx.gif(idx, pal, data=fx.lzw_pack(lits[:5] + [400] + lits[5:], 8)),
        "sub_blocks_split": lambda: plain[:ext_at + 11] + fx.sub_blocks(fx.lzw_pack(fx.lzw_codes(idx, 8), 8)[:7])[:-1]
        + fx.sub_blocks(fx.lzw_pack(fx.lzw_codes(idx, 8), 8)[7:]) + b"\x3b",
        "comment_and_unknown_extension": lambda: plain[:ext_at] + bytes([0x21, 0xFE, 2, 65, 66, 0, 0x21, 0x77, 1, 9, 0])
        + plain[ext_at:],
        "gce_sub_block_after": lambda: plain[:ext_at] + bytes([0x21, 0xF9, 4, 1, 0, 0, 9, 2, 7, 7, 0]) + plain[ext_at:],
        "netscape_loop_odd": lambda: plain[:ext_at] + bytes([0x21, 0xFF, 11]) + b"NETSCAPE2.0" + bytes([3, 2, 5, 0, 0])
        + plain[ext_at:],
        "app_extension_misread": lambda: plain[:ext_at] + bytes([0x21, 0xFF, 3, 1, 0, 0, 0]) + plain[ext_at:],
        "gce_of_5_bytes": lambda: plain[:ext_at] + bytes([0x21, 0xF9, 5, 0, 0, 0, 0, 0, 0]) + plain[ext_at:],
        "disposal_7": lambda: fx.gif(idx, pal, disposal=7),
        "unknown_block": lambda: plain[:-1] + b"\x99\x3b",
        "signature_89b": lambda: b"GIF89b" + plain[6:],
        "empty_screen": lambda: plain[:6] + b"\0\0" + plain[8:],
        "frame_past_screen": lambda: fx.gif(idx, pal, screen=(7, 6), pos=(0, 1)),
        "min_code_1": lambda: fx.gif(idx % 2, pal, data=fx.lzw_pack(fx.lzw_codes(idx % 2, 2), 2)).replace(
            b"\x2c" + struct.pack("<HHHHB", 0, 0, 7, 6, 0) + b"\x02", b"\x2c" + struct.pack("<HHHHB", 0, 0, 7, 6, 0) + b"\x01"),
        "no_data": lambda: fx.gif(idx, pal, data=b""),
    }[case]()


@pytest.mark.parametrize("case", [
    "screen_bg_disposal_0", "screen_bg_disposal_3", "screen_no_gce", "transparent_shows_bg", "transparent_is_bg",
    "transparent_past_table", "no_table_0_and_1", "no_table_transparent", "local_only_on_screen", "local_16_past_16",
    "literal_past_8_bits", "min_code_10", "interlaced_7_rows", "no_first_clear", "eoi_then_more",
    "eoi_then_one_byte", "eoi_then_two_bytes", "one_byte_after", "two_bytes_after", "pixel_short",
    "pixel_over_no_eoi", "pixel_over_with_eoi", "pair_crosses_the_end", "code_past_table", "sub_blocks_split",
    "comment_and_unknown_extension", "gce_sub_block_after", "netscape_loop_odd", "app_extension_misread",
    "gce_of_5_bytes", "disposal_7", "unknown_block", "signature_89b", "empty_screen", "frame_past_screen",
    "min_code_1", "no_data"])
def test_gif_variants_decode_as_cv2(case):
    _as_cv2_or_refused(_gif_case(case))


@pytest.mark.parametrize("shape", [(1, 1), (23, 37), (5, 300), (64, 3)])
def test_cv2_written_gifs_decode_as_cv2(shape):
    img = np.random.default_rng(shape[1]).integers(0, 256, shape + (3,), dtype=np.uint8)
    _assert_as_cv2(cv2.imencode(".gif", img)[1].tobytes())


# ---------------------------------------------------------------------------- HDR
def _hdr_case(case: str) -> bytes:
    rng = np.random.default_rng(81)
    m = rng.integers(0, 256, (6, 9, 4))
    m[..., 3] = rng.integers(120, 140, (6, 9))
    m[0, :6, 3] = [0, 1, 9, 10, 255, 160]
    m2 = rng.integers(0, 256, (5, 12, 4))
    m2[..., 3] = rng.integers(126, 134, (5, 12))
    rle = b"".join(fx.hdr_rle_row(r, False) for r in m2)
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
    return {
        "format_then_lines": lambda: fx.hdr(m, header=b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\nGAMMA=2.2\nX=1\n\n"),
        "comment_lines": lambda: fx.hdr(m, header=b"#?RGBE\n# one\n#FORMAT=x\nFORMAT=32-bit_rle_rgbe\n\n"),
        "first_line_any": lambda: fx.hdr(m, header=b"#?RADIANCE and more\nFORMAT=32-bit_rle_rgbe\n\n"),
        "line_of_127_bytes": lambda: fx.hdr(m, header=b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\nX" + b"a" * 126 + b"\n\n"),
        "line_of_300_bytes": lambda: fx.hdr(m, header=b"#?RADIANCE\nX" + b"a" * 300 + b"\nFORMAT=32-bit_rle_rgbe\n\n"),
        "format_xyze": lambda: fx.hdr(m, header=b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n"),
        "format_crlf": lambda: fx.hdr(m, header=b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\r\n\n"),
        "size_packed": lambda: fx.hdr(m, size=b"-Y6+X9\n"),
        "size_signed": lambda: fx.hdr(m, size=b"-Y +6 +X +9 and more\n"),
        "size_no_newline": lambda: fx.hdr(m, size=b"-Y 6 +X 9"),
        "size_leading_space": lambda: fx.hdr(m, size=b" -Y 6 +X 9\n"),
        "size_x_first": lambda: fx.hdr(m, size=b"+X 9 -Y 6\n"),
        "size_minus_x": lambda: fx.hdr(m, size=b"-Y 6 -X 9\n"),
        "size_zero": lambda: fx.hdr(m, size=b"-Y 0 +X 9\n"),
        "size_too_tall": lambda: fx.hdr(m, size=b"-Y 7 +X 9\n"),
        "trailing_bytes": lambda: fx.hdr(m) + b"tail",
        "rle_literals": lambda: fx.hdr(m2, body=rle),
        "rle_runs": lambda: fx.hdr(m2, body=b"".join(fx.hdr_rle_row(r, True) for r in m2)),
        "rle_run_of_128": lambda: fx.hdr(m2, body=rle[:4] + bytes([128, 5]) + rle[4:]),
        "rle_count_past_row": lambda: fx.hdr(m2, body=rle[:4] + bytes([13]) + rle[5:]),
        "rle_first_byte_high": lambda: fx.hdr(np.concatenate([[[2, 2, 0x80, 0]], m2.reshape(-1, 4)[1:]]).reshape(5, 12, 4)),
        "rle_cut_in_row": lambda: fx.hdr(m2, body=rle[:len(rle) // 2]),
        "flat_cut": lambda: fx.hdr(m)[:-3],
        "header_only": lambda: head,
        "no_blank_line": lambda: b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n",
    }[case]()


@pytest.mark.parametrize("case", [
    "format_then_lines", "comment_lines", "first_line_any", "line_of_127_bytes", "line_of_300_bytes",
    "format_xyze", "format_crlf", "size_packed", "size_signed", "size_no_newline", "size_leading_space",
    "size_x_first", "size_minus_x", "size_zero", "size_too_tall", "trailing_bytes", "rle_literals", "rle_runs",
    "rle_run_of_128", "rle_count_past_row", "rle_first_byte_high", "rle_cut_in_row", "flat_cut", "header_only",
    "no_blank_line"])
def test_hdr_variants_decode_as_cv2(case):
    _as_cv2_or_refused(_hdr_case(case))


@pytest.mark.parametrize("shape,flat", [((23, 37), False), ((23, 37), True), ((4, 5), False), ((3, 8), False),
                                        ((2, 40), True)])
def test_cv2_written_hdrs_decode_as_cv2(shape, flat):
    f = np.random.default_rng(shape[1]).random(shape + (3,)).astype(np.float32) * 2.5
    params = [cv2.IMWRITE_HDR_COMPRESSION, cv2.IMWRITE_HDR_COMPRESSION_NONE] if flat else []
    _assert_as_cv2(cv2.imencode(".hdr", f, params)[1].tobytes())


# ---------------------------------------------------------------------------- corrupt JPEGs
def _cut(data: bytes, scan: int, fraction: float, rest: bytes = None) -> bytes:
    start, end = fx.entropy_span(data, scan)
    at = start + int((end - start) * fraction)
    return data[:at] + (data[end:] if rest is None else rest)


@pytest.mark.parametrize("fraction", [0.1, 0.37, 0.5, 0.93])
@pytest.mark.parametrize("name", ["coco_500x333_444.jpg", "restart1_420.jpg", "restart_long_422.jpg",
                                  "seam_w17_411.jpg", "coco_333x500_gray.jpg"])
def test_sequential_cut_and_ended_by_eoi_decodes_as_cv2(name, fraction):
    """Cut inside the scan and ended by EOI: libjpeg finishes the MCU on zero bits and
    leaves the rest of the interval (and the intervals it never reached) flat."""
    _assert_as_cv2(_cut(_bytes(name), 0, fraction, b"\xff\xd9"))


@pytest.mark.parametrize("fraction", [0.2, 0.6])
@pytest.mark.parametrize("run", [2, 12, 40])
def test_ff_runs_decode_as_cv2(fraction, run):
    """Runs of FF data bytes (FF 00) over the scan: codes no table has, read as symbol 0
    after 17 bits, and the rest of the data read out of step."""
    data = _bytes("coco_500x333_444.jpg")
    start, end = fx.entropy_span(data, 0)
    at = start + int((end - start) * fraction)
    _assert_as_cv2(data[:at] + b"\xff\x00" * run + data[at + 2 * run:])


@pytest.mark.parametrize("interval", [0, 3, 7])
def test_restart_interval_cut_short_decodes_as_cv2(interval):
    """One restart interval cut short, the RST markers after it kept: that interval
    ends flat, the next ones decode."""
    data = _bytes("restart1_444.jpg")
    start, end = fx.entropy_span(data, 0)
    rst = [i for i in range(start, end - 1) if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
    a, b = rst[interval], rst[interval + 1]
    _assert_as_cv2(data[:a + 2 + (b - a - 2) // 2] + data[b:])


PROGRESSIVE = ["progressive_420_83x61.jpg", "progressive_restart_83x61.jpg", "progressive_gray_61x83.jpg",
               "cmyk_progressive_83x61.jpg"]


@pytest.mark.parametrize("fraction", [0.3, 0.75])
@pytest.mark.parametrize("scan", [0, 1, 3, 5, 6, 8])
@pytest.mark.parametrize("name", PROGRESSIVE)
def test_progressive_scan_cut_short_decodes_as_cv2(name, scan, fraction):
    """One scan's data cut short and the file kept after it: the scan's later blocks
    keep what the scans before it wrote, and the later scans decode."""
    data = _bytes(name)
    scans = sum(1 for m, _, _ in fx.jpeg_segments(data) if m == 0xDA)
    _assert_as_cv2(_cut(data, min(scan, scans - 1), fraction))


@pytest.mark.parametrize("fraction", [0.0, 0.4, 0.9])
@pytest.mark.parametrize("scan", [0, 2, 4, 7, 9])
@pytest.mark.parametrize("name", ["progressive_420_83x61.jpg", "progressive_restart_83x61.jpg",
                                  "progressive_444_83x61.jpg"])
def test_smoothed_progressive_decodes_as_cv2(name, scan, fraction):
    """Cut inside a scan and ended by EOI: the later scans never come, so libjpeg smooths
    the blocks (estimates of the coefficients still unknown from the DC neighbourhood,
    the DC too where a component has no AC data), with the bits from before the last
    scan for the rows after the one its data ran out in."""
    _assert_as_cv2(_cut(_bytes(name), scan, fraction, b"\xff\xd9"))


def _scan_headers(data: bytes):
    """[(component ids, Ss, Ah)] of a JPEG's scans."""
    out = []
    for marker, start, _ in fx.jpeg_segments(data):
        if marker == 0xDA:
            ns = data[start + 4]
            out.append((data[start + 5:start + 5 + 2 * ns:2], data[start + 5 + 2 * ns], data[start + 7 + 2 * ns] >> 4))
    return out


@pytest.mark.parametrize("case", ["dc_after_refine", "ac_after_refine", "ac_twice"])
@pytest.mark.parametrize("name", PROGRESSIVE)
def test_repeated_first_scans_decode_as_cv2(name, case):
    """A first scan sent again after later scans of the same coefficients: libjpeg
    decodes the scans in order, so a repeated DC first scan overwrites the refined DC
    values (zero ones too) and a repeated AC first scan the coefficients it sends; the
    port decodes such a file in steps (K1's first scans, then K6's refinements, again)."""
    data = _bytes(name)
    heads = _scan_headers(data)
    first = next(i for i, (ids, ss, ah) in enumerate(heads) if (ss > 0) == (case != "dc_after_refine") and ah == 0)
    ids, ss, _ = heads[first]
    later = [i for i, (ids2, ss2, ah2) in enumerate(heads) if i > first and set(ids2) & set(ids)
             and (ss2 > 0) == (ss > 0) and ah2 > 0]
    after = first if case == "ac_twice" or not later else later[-1]
    repeated = fx.repeated_scan(data, first, after)
    assert codec.jpeg_batch([codec.parse_jpeg(repeated)]).steps == 2
    _assert_as_cv2(repeated)


# ---------------------------------------------------------------------------- the packer
FORMATS = ["bmp_rle8_37x23.bmp", "pxm_p6_16bit_37x23.ppm", "ras_cmap8_37x23.ras", "pfm_rgb_37x23.pfm",
           "corrupt_cut_eoi_500x333.jpg", "corrupt_ff00_run_500x333.jpg", "corrupt_progressive_scan_short_83x61.jpg",
           "progressive_cut_eoi_83x61.jpg", "bmp_pal4_37x23.bmp", "pxm_p1_37x23.pbm", "gif_transparent_37x23.gif",
           "gif_interlaced_100x80.gif", "hdr_cv2_rle_37x23.hdr", "hdr_flat_exponents_9x6.hdr",
           "tiff_ycbcr42_packbits_37x23.tif", "tiff_pil_lab_lzw_37x23.tif", "tiff_jpeg_pil_cmyk_37x23.tif",
           "tiff_jpeg_planar_ycbcr_67x45.tif", "tiff_ccitt_g4_37x23.tif", "tiff_ccitt_g3_2d_strips_37x23.tif",
           "tiff_ccitt_rlew_37x23.tif", "tiff_thunderscan_37x23.tif", "tiff_lzw_old_rgb_predictor_37x23.tif"]


def test_a_root_of_every_format_packs_as_the_jax_package(tmp_path):
    """A COCO train split whose .jpg files hold a BMP, a PPM, a Sun raster, a PFM, GIFs,
    HDRs, corrupt JPEGs, a YCbCr and a CIELab TIFF, a CMYK JPEG-in-TIFF and one of
    separate planes, CCITT Group 4, Group 3 2-D and RLEW TIFFs, a ThunderScan one and one
    of old-style LZW codes: the port's pack_dataset (the decode feed, on the CPU) writes
    images.u8 and gt.npz byte-equal to the JAX package's, which reads them with cv2."""
    root = tmp_path / "root"
    os.makedirs(root / "annotations")
    os.makedirs(root / "train2017")
    rng = np.random.default_rng(17)
    images, annotations = [], []
    for i, name in enumerate(FORMATS):
        data = _bytes(name)
        h, w = _cv2(data).shape[:2]
        file_name = f"{7000 + i:012d}.jpg"
        (root / "train2017" / file_name).write_bytes(data)
        images.append({"id": 7000 + i, "file_name": file_name, "width": w, "height": h})
        for _ in range(int(rng.integers(1, 3))):
            bw, bh = rng.uniform(0.2, 0.6) * w, rng.uniform(0.2, 0.6) * h
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            annotations.append({"id": len(annotations) + 1, "image_id": 7000 + i, "category_id": 1 + i % 3,
                                "bbox": [round(x, 2), round(y, 2), round(bw, 2), round(bh, 2)],
                                "area": round(bw * bh, 2), "iscrowd": 0})
    with open(root / "annotations" / "instances_train2017.json", "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c, "name": f"class{c}"} for c in range(1, 4)]}, f)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    packed.pack_dataset(coco.open_split(str(root), "train"), port_dir, image_size=40, max_gt=3, num_workers=2,
                        device="cpu")
    jax_packed.pack_dataset(jax_coco.open_split(str(root), "train"), jax_dir, image_size=40, max_gt=3, num_workers=2)
    for name in ("images.u8", "gt.npz"):
        with open(os.path.join(port_dir, name), "rb") as a, open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    assert json.load(open(os.path.join(port_dir, "meta.json")))["count"] == len(FORMATS)


# ---------------------------------------------------------------------------- TIFF
TIFFS = sorted(n for n in os.listdir(fx.FIXTURES) if n.endswith(".tif"))


@pytest.mark.parametrize("name", TIFFS)
def test_tiff_fixtures_as_cv2(name):
    """Each TIFF fixture (cv2's writer, PIL's modes x compressions, tiles, planes, BigTIFF,
    big-endian 16-bit, MinIsWhite, orientations, palettes, alpha, fill order, cut chunks,
    LZW's stopping rules): equal to cv2, refused naming the feature, or ValueError where
    cv2 returns None."""
    data = _bytes(name)
    want = _cv2(data)
    if name in fx.REFUSED:
        assert want is not None
        with pytest.raises(codec.UnsupportedImage, match=fx.REFUSED[name]):
            codec.decode_image(data, "cpu")
    elif want is None:
        assert name in fx.INVALID
        with pytest.raises(ValueError):
            codec.decode_image(data, "cpu")
    else:
        np.testing.assert_array_equal(codec.decode_image(data, "cpu").numpy(), want)


def _tiff_case(case: str) -> bytes:
    """One rule of cv2's TIFF reading, as a TIFF written here."""
    rng = np.random.default_rng(len(case))
    rgb = rng.integers(0, 256, (23, 37, 3), dtype=np.uint8)
    gray = rgb[..., 0]
    tags = fx.tiff_tags(37, 23, 8, 3, 2)
    lzw = lambda b: fx.tiff_lzw_pack(fx.tiff_lzw_codes(b))  # noqa: E731
    if case == "rgb16_rounded":  # RGB 16-bit: (v + 128) / 257
        return fx.tiff(fx.tiff_tags(37, 23, 16, 3, 2), [rng.integers(0, 65536, (23, 37, 3)).astype("<u2").tobytes()])
    if case == "gray16_high_byte":
        return fx.tiff(fx.tiff_tags(37, 23, 16, 1, 1), [rng.integers(0, 65536, (23, 37)).astype("<u2").tobytes()])
    if case == "gray16_planes_rounded":  # gray planes go through libtiff's RGB path
        return fx.tiff(fx.tiff_tags(37, 23, 16, 2, 1, planar=2, extra=0),
                       [rng.integers(0, 65536, (23, 37)).astype("<u2").tobytes() for _ in range(2)])
    if case.startswith("rgba_extra"):
        return fx.tiff(fx.tiff_tags(37, 23, 16 if "16" in case else 8, 4, 2, extra=int(case[10])),
                       [rng.integers(0, 65536 if "16" in case else 256, (23, 37, 4)).astype(
                           "<u2" if "16" in case else np.uint8).tobytes()])
    if case == "gray_alpha_planes_premultiplied":
        return fx.tiff(fx.tiff_tags(37, 23, 8, 2, 0, planar=2, extra=2), [gray.tobytes(), rgb[..., 1].tobytes()])
    if case == "palette_4bit":
        return fx.tiff(fx.tiff_tags(37, 23, 4, 1, 3, colormap=rng.integers(0, 65536, 48)),
                       [np.packbits(np.unpackbits((gray // 16)[..., None], axis=-1)[..., 4:].reshape(23, -1), 1).tobytes()])
    if case == "palette_16bit_invalid":
        return fx.tiff(fx.tiff_tags(37, 23, 16, 1, 3, colormap=rng.integers(0, 65536, 3 * 65536)),
                       [gray.astype("<u2").tobytes()])
    if case == "gray_4bit_invalid":
        return fx.tiff(fx.tiff_tags(37, 23, 4, 1, 1), [bytes(23 * 19)])
    if case == "cmyk16_invalid":
        return fx.tiff(fx.tiff_tags(37, 23, 16, 4, 5), [bytes(23 * 37 * 8)])
    if case == "five_samples_invalid":
        return fx.tiff(fx.tiff_tags(37, 23, 8, 5, 2, extra=[0, 0]), [bytes(23 * 37 * 5)])
    if case == "no_photometric_invalid":
        t = dict(tags)
        del t[262]
        return fx.tiff(t, [rgb.tobytes()])
    if case == "predictor_ignored_uncompressed":
        return fx.tiff(fx.tiff_tags(37, 23, 8, 3, 2, predictor=2), [rgb.tobytes()])
    if case == "predictor_3_invalid":
        return fx.tiff(fx.tiff_tags(37, 23, 8, 3, 2, 5, predictor=3), [lzw(rgb.tobytes())])
    if case == "ycbcr_default_subsampling":  # no YCbCrSubsampling: libtiff's 2 x 2 data units
        return fx.tiff(fx.tiff_tags(37, 23, 8, 3, 6), [rgb.tobytes()])
    if case == "ycbcr44_odd_units_refused":  # cv2 reads bytes past what libtiff decoded
        t = fx.tiff_tags(33, 17, 8, 3, 6, rows=4)
        t[530] = (3, [4, 4])
        return fx.tiff(t, [rng.integers(0, 256, 162, dtype=np.uint8).tobytes() for _ in range(5)])
    if case == "ycbcr_luma_green_zero_invalid":
        t = fx.tiff_tags(37, 23, 8, 3, 6)
        t[530], t[529] = (3, [1, 1]), fx.rationals((0.5, 0, 0.5))
        return fx.tiff(t, [rgb.tobytes()])
    if case == "lab_white_y_zero_invalid":
        t = fx.tiff_tags(37, 23, 8, 3, 8)
        t[318] = fx.rationals((0.3, 0))
        return fx.tiff(t, [rgb.tobytes()])
    if case == "lab_every_value":  # 8-bit CIELab: every L, and a and b at random
        lab = np.stack([np.arange(23 * 37) % 256, rng.integers(0, 256, 23 * 37), rng.integers(0, 256, 23 * 37)], -1)
        return fx.tiff(fx.tiff_tags(37, 23, 8, 3, 8), [lab.astype(np.uint8).tobytes()])
    if case.startswith("uncompressed_tiles_"):  # libtiff's raw buffer must hold the tile's bytes exactly
        spp, counts = {"uncompressed_tiles_1024": (4, None), "uncompressed_tiles_768_invalid": (3, None),
                       "uncompressed_tiles_short_zeroed": (4, [1024, 1000])}[case]
        t = fx.tiff_tags(32, 16, 8, spp, 2, tile_width=16, tile_length=16)
        del t[278]
        return fx.tiff(t, [rng.integers(0, 256, 256 * spp, dtype=np.uint8).tobytes() for _ in range(2)], tiled=True,
                       counts=counts)
    if case.startswith("sgilog_"):  # what cv2 takes of SGILog's tags
        photometric, bits, spp = {"sgilog_logl_1bit": (32844, 1, 1), "sgilog_logl_4bit_invalid": (32844, 4, 1),
                                  "sgilog_logluv_4bit": (32845, 4, 3), "sgilog_logluv_32bit_invalid": (32845, 32, 3),
                                  "sgilog_logluv_4_samples_invalid": (32845, 16, 4)}[case]
        words = rng.integers(0, 1 << 16, (23, 37)) if photometric == 32844 else rng.integers(0, 1 << 32, (23, 37))
        return fx.tiff(fx.tiff_tags(37, 23, bits, spp, photometric, 34676),
                       [b"".join(fx.sgilog_planes(r, 2 if photometric == 32844 else 4) for r in words)])
    if case == "old_style_lzw":  # LSB-first codes (LZWDecodeCompat): a Clear, then zeros until the data runs out
        return fx.tiff(fx.tiff_tags(37, 23, 8, 3, 2, 5), [b"\0\x01" + bytes(50)])
    if case == "strips_short_count_zeroed":  # an uncompressed strip shorter than its rows: zeros
        chunks = [rgb[y:y + 5].tobytes() for y in range(0, 23, 5)]
        return fx.tiff(fx.tiff_tags(37, 23, 8, 3, 2, rows=5), chunks[:2] + [chunks[2][:-7]] + chunks[3:])
    if case == "strip_offsets_short_invalid":
        chunks = [rgb[y:y + 5].tobytes() for y in range(0, 23, 5)]
        return fx.tiff(fx.tiff_tags(37, 23, 8, 3, 2, rows=5), chunks[:4])
    if case == "lzw_tile_cut_at_edges":
        t = fx.tiff_tags(37, 23, 8, 1, 1, 5, tile_width=32, tile_length=16)
        del t[278]
        return fx.tiff(t, [lzw(rng.integers(0, 256, 512, dtype=np.uint8).tobytes()) for _ in range(4)], tiled=True)
    raise KeyError(case)


TIFF_CASES = ["rgb16_rounded", "gray16_high_byte", "gray16_planes_rounded", "rgba_extra0", "rgba_extra1",
              "rgba_extra2", "rgba_extra2_16", "gray_alpha_planes_premultiplied", "palette_4bit",
              "palette_16bit_invalid", "gray_4bit_invalid", "cmyk16_invalid", "five_samples_invalid",
              "no_photometric_invalid", "predictor_ignored_uncompressed", "predictor_3_invalid", "ycbcr_default_subsampling",
              "uncompressed_tiles_1024", "uncompressed_tiles_768_invalid", "uncompressed_tiles_short_zeroed",
              "sgilog_logl_1bit", "sgilog_logl_4bit_invalid", "sgilog_logluv_4bit", "sgilog_logluv_32bit_invalid",
              "sgilog_logluv_4_samples_invalid", "old_style_lzw", "strips_short_count_zeroed",
              "strip_offsets_short_invalid", "lzw_tile_cut_at_edges", "ycbcr44_odd_units_refused",
              "ycbcr_luma_green_zero_invalid", "lab_white_y_zero_invalid", "lab_every_value"]


@pytest.mark.parametrize("case", TIFF_CASES)
def test_tiff_rules_as_cv2(case):
    """Each rule found in cv2 5.0 / libtiff 4.7 by probing, as a case: decoded as cv2
    decodes it, ValueError where cv2 returns None, UnsupportedImage where cv2 reads what
    this decoder refuses."""
    data = _tiff_case(case)
    want = _cv2(data)
    if case.endswith("_refused"):
        assert want is not None
        with pytest.raises(codec.UnsupportedImage):
            codec.decode_image(data, "cpu")
    elif case.endswith("_invalid"):
        assert want is None
        with pytest.raises(ValueError):
            codec.decode_image(data, "cpu")
    else:
        np.testing.assert_array_equal(codec.decode_image(data, "cpu").numpy(), want)


def _random_tiff(rng) -> bytes:
    """A TIFF of random tags: byte order, BigTIFF, size, bits, samples, photometric,
    planes, compression, predictor, extra samples, sample format, strips or tiles,
    orientation, fill order, colour map, ink set, and now and then a chunk cut short,
    a zero or an overlong byte count, or a missing chunk (one-plane images only: a later
    plane's unreadable chunk is not pinned). JPEG-in-TIFF, YCbCr and uncompressed tiles
    are left to the cases above."""
    w, h = int(rng.integers(1, 40)), int(rng.integers(1, 30))
    bits = int(rng.choice([1, 2, 4, 8, 8, 8, 16, 16, 32]))
    spp = int(rng.choice([1, 1, 2, 3, 3, 4, 4, 5]))
    photometric = int(rng.choice([0, 1, 2, 2, 3, 5, 4]))
    comp = int(rng.choice([1, 5, 5, 8, 32773, 32946]))
    more = {}
    if rng.random() < 0.8:
        more["planar"] = int(rng.choice([1, 1, 2, 3]))
    if rng.random() < 0.6:
        more["predictor"] = int(rng.choice([1, 2, 2, 3, 0, 4]))
    if rng.random() < 0.5:
        more["extra"] = [int(rng.choice([0, 1, 2, 3])) for _ in range(int(rng.choice([1, 1, 2, 3])))]
    if rng.random() < 0.2:
        more["sample_format"] = [int(rng.choice([1, 2, 3, 4]))] * spp
    if rng.random() < 0.4:
        more["orientation"] = int(rng.choice([1, 2, 3, 4, 5, 6, 7, 8, 0, 9]))
    if rng.random() < 0.1:
        more["fill_order"] = 2
    if photometric == 3:
        more["colormap"] = rng.integers(0, 256 if rng.random() < 0.5 else 65536, 3 * (1 << min(bits, 16)))
    tiled = rng.random() < 0.25 and comp != 1
    rows = int(rng.integers(1, h + 3))
    tags = fx.tiff_tags(w, h, bits, spp, photometric, comp, rows=rows, **more)
    if photometric == 5 and rng.random() < 0.2:
        tags[332] = (3, [2])
    planar = more.get("planar", 1) == 2
    samples, planes = (1, spp) if planar else (spp, 1)
    if tiled:
        tw, th = int(rng.choice([16, 32])), int(rng.choice([8, 16]))
        tags.update({322: (3, [tw]), 323: (3, [th])})
        del tags[278]
        boxes = [(th, tw)] * (-(-h // th) * -(-w // tw))
    else:
        boxes = [(min(rows, h - y), w) for y in range(0, h, rows)]
    chunks = []
    for _ in range(planes):
        for r, c in boxes:
            n = r * -(-c * samples * bits // 8)
            raw = (rng.integers(0, 256, n) if rng.random() < 0.5 else np.cumsum(rng.integers(0, 3, n)) % 256)
            raw = raw.astype(np.uint8).tobytes()
            chunks.append({1: raw, 5: fx.tiff_lzw_pack(fx.tiff_lzw_codes(raw)), 8: zlib.compress(raw),
                           32946: zlib.compress(raw), 32773: fx.packbits(raw)}[comp])
    counts = None
    r = rng.random() if planes == 1 else 1.0
    if r < 0.08:
        i = int(rng.integers(len(chunks)))
        chunks[i] = chunks[i][:int(rng.integers(0, len(chunks[i]) + 1))]
    elif r < 0.12:
        counts = [len(c) for c in chunks]
        counts[int(rng.integers(len(counts)))] = 0
    elif r < 0.15:
        counts = [len(c) for c in chunks]
        counts[-1] += int(rng.integers(1, 50))
    elif r < 0.17 and len(chunks) > 1:
        chunks = chunks[:-1]
    return fx.tiff(tags, chunks, big_endian=bool(rng.random() < 0.4), big=bool(rng.random() < 0.3), tiled=tiled,
                   counts=counts)


@pytest.mark.parametrize("seed", range(4))
def test_random_tiffs_as_cv2(seed):
    """60 seeded random TIFFs a seed: the port decodes each as cv2 does, or raises
    ValueError exactly where cv2 returns None, or UnsupportedImage where cv2 reads it."""
    rng = np.random.default_rng(1700 + seed)
    for i in range(60):
        data = _random_tiff(rng)
        want = _cv2(data)
        try:
            got = codec.decode_image(data, "cpu").numpy()
        except codec.UnsupportedImage:
            assert want is not None, i
            continue
        except ValueError:
            assert want is None, i
            continue
        assert want is not None, i
        np.testing.assert_array_equal(got, want, err_msg=str(i))


def _random_fax_tiff(rng) -> bytes:
    """A TIFF of K11's and K9's newer codes at random: the CCITT codecs (modified Huffman,
    RLEW, Group 3 1-D with or without fill bits or EOLs, 2-D, Group 4) on 1-bit gray or
    palette samples, ThunderScan on 4-bit palettes, old-style LZW (now and then only its
    first chunk, or all but it), now and then on samples they do not take; strips of any
    height or tiles, byte order, BigTIFF, fill order, orientation; and now and then a chunk
    cut short or some of its coded bits flipped."""
    w, h = int(rng.integers(1, 60)), int(rng.integers(1, 30))
    comp = int(rng.choice([2, 3, 3, 4, 4, 32771, 32809, 32809, 5, 5]))
    bits = {32809: 4, 5: 8}.get(comp, 1) if rng.random() < 0.9 else int(rng.choice([1, 4, 8]))
    photometric = 3 if bits == 4 or rng.random() < 0.2 else int(rng.choice([0, 1]))
    more = {}
    if rng.random() < 0.15:
        more["fill_order"] = 2
    if rng.random() < 0.3:
        more["orientation"] = int(rng.choice([1, 2, 3, 4, 5, 6, 7, 8]))
    if photometric == 3:
        more["colormap"] = rng.integers(0, 65536, 3 * (1 << bits))
    tiled = rng.random() < 0.2
    rows = int(rng.integers(1, h + 3))
    tags = fx.tiff_tags(w, h, bits, 1, photometric, comp, rows=rows, **more)
    mode = {2: "rle", 32771: "rlew", 4: "g4", 3: str(rng.choice(["g3", "g3fill", "noeol", "g3_2d"]))}.get(comp)
    if mode in ("g3fill", "g3_2d"):
        tags[292] = (4, [{"g3fill": 4, "g3_2d": int(rng.choice([1, 5]))}[mode]])
    if tiled:
        tw, th = int(rng.choice([16, 32])), int(rng.choice([8, 16]))
        tags.update({322: (3, [tw]), 323: (3, [th])})
        del tags[278]
        boxes = [(th, tw)] * (-(-h // th) * -(-w // tw))
    else:
        boxes = [(min(rows, h - y), w) for y in range(0, h, rows)]
    old = rng.choice(["all", "all", "first", "rest"])
    chunks = []
    for k, (r, c) in enumerate(boxes):
        n = r * -(-c * bits // 8)
        raw = (rng.integers(0, 256, n) if rng.random() < 0.3 else np.cumsum(rng.integers(0, 3, n)) % 256)
        raw = raw.astype(np.uint8)
        if mode is not None and bits == 1:
            chunks.append(fx.fax_rows(np.unpackbits(raw).reshape(r, -1)[:, :c].astype(bool), mode))
        elif comp == 32809:
            chunks.append(fx.thunder_rows((raw.reshape(r, -1)[:, :(c + 1) // 2, None] >> [4, 0] & 15
                                           ).reshape(r, -1)[:, :c], bool(rng.random() < 0.5)))
        elif comp == 5:
            chunks.append(fx.tiff_lzw_pack(fx.tiff_lzw_codes(raw.tobytes()),
                                           old={"all": True, "first": k == 0, "rest": k > 0}[old]))
        else:
            chunks.append(raw.tobytes())
    r = rng.random()
    i = int(rng.integers(len(chunks)))
    if r < 0.25:
        chunks[i] = chunks[i][:int(rng.integers(0, len(chunks[i]) + 1))]
    elif r < 0.55 and chunks[i]:
        b = bytearray(chunks[i])
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(len(b)))] ^= 1 << int(rng.integers(8))
        chunks[i] = bytes(b)
    return fx.tiff(tags, chunks, big_endian=bool(rng.random() < 0.4), big=bool(rng.random() < 0.3), tiled=tiled)


@pytest.mark.parametrize("seed", range(4))
def test_random_fax_tiffs_as_cv2(seed):
    """60 seeded random CCITT, ThunderScan and old-style LZW TIFFs a seed, their chunks
    now and then cut or their coded bits flipped: the port decodes each as cv2 does, or
    raises ValueError exactly where cv2 returns None; none raises UnsupportedImage."""
    rng = np.random.default_rng(2100 + seed)
    for i in range(60):
        data = _random_fax_tiff(rng)
        want = _cv2(data)
        try:
            got = codec.decode_image(data, "cpu").numpy()
        except ValueError as e:
            assert want is None and not isinstance(e, codec.UnsupportedImage), i
            continue
        assert want is not None, i
        np.testing.assert_array_equal(got, want, err_msg=str(i))


def _random_colour_tiff(rng) -> bytes:
    """A YCbCr or CIELab TIFF (now and then ICCLab or ITULab) of random tags: byte order,
    BigTIFF, size, bits, samples, planes, compression, predictor, extra samples,
    YCbCrSubsampling (missing, valid, or one libtiff has no put routine for),
    YCbCrCoefficients, ReferenceBlackWhite, WhitePoint, strips of any height or tiles,
    orientation, and now and then a chunk cut short."""
    w, h = int(rng.integers(1, 40)), int(rng.integers(1, 30))
    photometric = int(rng.choice([6, 6, 6, 8, 8, 9, 10]))
    bits = int(rng.choice([8, 8, 8, 8, 16, 4]))
    spp = int(rng.choice([3, 3, 3, 3, 1, 4]))
    comp = int(rng.choice([1, 5, 5, 8, 32773]))
    more = {}
    if rng.random() < 0.3:
        more["planar"] = 2
    if rng.random() < 0.4:
        more["predictor"] = int(rng.choice([1, 2, 2]))
    if spp == 4 and rng.random() < 0.7:
        more["extra"] = [int(rng.choice([0, 1, 2]))]
    if rng.random() < 0.4:
        more["orientation"] = int(rng.choice([1, 2, 3, 4, 5, 6, 7, 8]))
    sub = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (2, 4), None][int(rng.integers(9))]
    tiled = rng.random() < 0.25 and comp != 1
    rows = int(rng.integers(1, h + 3))
    tags = fx.tiff_tags(w, h, bits, spp, photometric, comp, rows=rows, **more)
    if sub is not None:
        tags[530] = (3, list(sub))
    if rng.random() < 0.3:
        tags[529] = fx.rationals(rng.uniform(0.05, 0.9, 3).round(4))
    if rng.random() < 0.3:
        tags[532] = fx.rationals(np.sort(rng.uniform(0, 255, 6).round(2).reshape(3, 2), 1).reshape(-1))
    if rng.random() < 0.3:
        tags[318] = fx.rationals(rng.uniform(0.2, 0.45, 2).round(4))
    hs, vs = sub or (2, 2)
    planar = more.get("planar", 1) == 2
    units = photometric == 6 and not planar and spp == 3 and bits == 8
    samples, planes = (1, spp) if planar else (spp, 1)
    if tiled:
        tw, th = int(rng.choice([16, 32])), int(rng.choice([8, 16]))
        tags.update({322: (3, [tw]), 323: (3, [th])})
        del tags[278]
        boxes = [(th, tw)] * (-(-h // th) * -(-w // tw))
    else:
        boxes = [(min(rows, h - y), w) for y in range(0, h, rows)]
    chunks = []
    for _ in range(planes):
        for r, c in boxes:
            n = -(-r // vs) * -(-c // hs) * (hs * vs + 2) if units else r * -(-c * samples * bits // 8)
            raw = (rng.integers(0, 256, n) if rng.random() < 0.5 else np.cumsum(rng.integers(0, 3, n)) % 256)
            raw = raw.astype(np.uint8).tobytes()
            chunks.append({1: raw, 5: fx.tiff_lzw_pack(fx.tiff_lzw_codes(raw)), 8: zlib.compress(raw),
                           32773: fx.packbits(raw)}[comp])
    if planes == 1 and rng.random() < 0.1:
        i = int(rng.integers(len(chunks)))
        chunks[i] = chunks[i][:int(rng.integers(0, len(chunks[i]) + 1))]
    return fx.tiff(tags, chunks, big_endian=bool(rng.random() < 0.4), big=bool(rng.random() < 0.3), tiled=tiled)


@pytest.mark.parametrize("seed", range(4))
def test_random_colour_tiffs_as_cv2(seed):
    """60 seeded random YCbCr and CIELab TIFFs a seed: the port decodes each as cv2 does,
    or raises ValueError exactly where cv2 returns None, or UnsupportedImage where cv2
    reads it."""
    rng = np.random.default_rng(1900 + seed)
    for i in range(60):
        data = _random_colour_tiff(rng)
        want = _cv2(data)
        try:
            got = codec.decode_image(data, "cpu").numpy()
        except codec.UnsupportedImage:
            assert want is not None, i
            continue
        except ValueError:
            assert want is None, i
            continue
        assert want is not None, i
        np.testing.assert_array_equal(got, want, err_msg=str(i))


# ---------------------------------------------------------------------------- TIFF compressions
COMPRESSIONS = json.load(open(fx.COMPRESSION_TABLE))["bases"]
CODES = range(65536)


def _classes(entry: dict) -> dict:
    """code -> what cv2 makes of the base at that compression (tiff_compressions.json):
    "none", "zero", "decodes", or "lacks" (a libtiff codec the port lacks; the table's
    "lacks" lists those the port lacked when it was probed, the CCITT codecs and
    ThunderScan among them, which the port now decodes: cv2's class stands for them)."""
    out = {}
    for cls in ("none", "zero", "decodes"):
        for lo, hi in entry[cls]:
            out.update(dict.fromkeys(range(lo, hi + 1), cls))
    out.update(dict.fromkeys((c for c in entry["lacks"] if c not in fx.PORT_CODECS), "lacks"))
    return out


def _listed(entry: dict) -> set:
    """The codes the table names: libtiff's codecs, the port's, the codes of formats no
    codec claims, and the ends of every range."""
    ends = {c for cls in ("none", "zero", "decodes") for r in entry[cls] for c in r}
    return ends | set(fx.LIBTIFF_CODECS) | set(codec._TIFF_UNCLAIMED) | set(entry["lacks"])


def _bits_photometric(data: bytes):
    order, big, tags = codec._tiff_directory(data)
    return (codec._tiff_values(data, order, big, tags[258])[0], codec._tiff_values(data, order, big, tags[262])[0])


@pytest.mark.parametrize("base", sorted(COMPRESSIONS))
def test_tiff_compression_table_as_cv2(base):
    """Each base of the committed probe at every code the table lists and 24 seeded codes
    of the rest: ValueError where cv2 returns None, UnsupportedImage naming the codec
    where cv2's libtiff decodes and the port lacks the codec, else cv2's pixels (the zero
    samples' image, palette and MinIsWhite included, or the code's own digest); a file read
    of an uncompressed tiled TIFF, which cv2.imread reads where cv2.imdecode returns None,
    decodes from the file as cv2.imread reads it."""
    entry, data = COMPRESSIONS[base], fx.compression_bases()[base]
    classes = _classes(entry)
    rng = np.random.default_rng(1900 + sorted(COMPRESSIONS).index(base))
    for code in sorted(_listed(entry) | set(rng.integers(0, 65536, 24).tolist())):
        tiff = fx.set_tags(data, {259: code})
        cls = classes[code]
        if cls == "lacks":
            with pytest.raises(codec.UnsupportedImage, match=fx.LIBTIFF_CODECS[code].split()[0]):
                codec.decode_image(tiff, "cpu")
        elif cls == "none":
            with pytest.raises(ValueError):
                codec.decode_image(tiff, "cpu")
        else:
            got = codec.decode_image(tiff, "cpu").numpy()
            assert fx.sha(got) == (entry["zero_sha256"] if cls == "zero" else entry["decoded_sha256"][str(code)]), code
        codec.check_file_read(tiff)
        if str(code) in entry["imread_differs"]:  # cv2.imread maps the file: it reads uncompressed tiles otherwise
            want = _cv2_file(tiff)
            assert (want is None) == (entry["imread_differs"][str(code)] == "none"), code
            if want is None:
                with pytest.raises(ValueError):
                    codec.decode_image(tiff, "cpu", from_file=True)
            else:
                np.testing.assert_array_equal(codec.decode_image(tiff, "cpu", from_file=True).numpy(), want)


@pytest.mark.parametrize("base", sorted(COMPRESSIONS))
def test_tiff_compression_rule_is_the_table(base):
    """codec.tiff_compression_outcome at all 65,536 codes of each base agrees with the
    probe: "none", "lacks" and "zero" exactly; this decoder's own codecs are the previous
    test's (on the bases' bytes they decode, decode nothing, or fail as cv2 does)."""
    entry, data = COMPRESSIONS[base], fx.compression_bases()[base]
    classes = _classes(entry)
    bits, photometric = _bits_photometric(data)
    for code in CODES:
        got = codec.tiff_compression_outcome(code, bits, photometric)[0]
        if got != "decode":
            assert got == classes[code], (code, got, classes[code])
        else:
            assert code in fx.PORT_CODECS


@pytest.mark.parametrize("base", sorted(COMPRESSIONS))
def test_tiff_compression_table_is_this_cv2s(base):
    """The committed probe is this cv2's: cv2.imdecode of each base at the listed codes and
    48 seeded others gives the table's class and digest."""
    entry, data = COMPRESSIONS[base], fx.compression_bases()[base]
    classes = _classes(entry)
    rng = np.random.default_rng(2000 + sorted(COMPRESSIONS).index(base))
    for code in sorted(_listed(entry) | set(rng.integers(0, 65536, 48).tolist())):
        got = _cv2(fx.set_tags(data, {259: code}))
        cls = classes[code]
        if got is None:
            assert cls == "none", code
        elif fx.sha(got) == entry["zero_sha256"]:
            assert cls in ("zero", "lacks"), code
        else:
            assert cls in ("decodes", "lacks") and entry["decoded_sha256"][str(code)] == fx.sha(got), code


def test_tiff_compression_names():
    """The codes cv2 returns None for, reads as zero samples, or reads with a codec the
    port lacks are named as libtiff names them (32908 is PixarFilm; PixarLog is 32909);
    the CCITT codecs on 1-bit samples and ThunderScan on 4-bit ones decode (K11), and so
    does SGILog on LogL and LogLuv (K12, K8)."""
    assert codec.tiff_compression_outcome(32908, 8, 2) == ("zero", "PixarFilm")
    assert codec.tiff_compression_outcome(32909, 8, 2) == ("none", "PixarLog")
    assert codec.tiff_compression_outcome(34925, 8, 2) == ("none", "LZMA")
    assert codec.tiff_compression_outcome(4, 1, 0) == ("decode", "CCITT Group 4")
    assert codec.tiff_compression_outcome(4, 8, 1) == ("none", "CCITT Group 4")
    assert codec.tiff_compression_outcome(32809, 4, 3) == ("decode", "ThunderScan")
    assert codec.tiff_compression_outcome(34676, 16, codec.TIFF_LOGLUV) == ("decode", "SGILog")
    assert codec.tiff_compression_outcome(34677, 16, codec.TIFF_LOGLUV) == ("decode", "SGILog24")
    assert codec.tiff_compression_outcome(34676, 16, codec.TIFF_LOGL) == ("decode", "SGILog")
    assert codec.tiff_compression_outcome(34677, 16, codec.TIFF_LOGL)[0] == "none"
    assert codec.tiff_compression_outcome(1, 16, codec.TIFF_LOGLUV)[0] == "none"
    assert codec.tiff_compression_outcome(12345, 8, 2) == ("zero", "compression 12345")


JPEG_TIFFS = sorted(n for n in TIFFS if n.startswith("tiff_jpeg_"))


@pytest.mark.parametrize("name", JPEG_TIFFS)
def test_jpeg_in_tiff_fixtures_as_cv2(name):
    """Every JPEG-in-TIFF fixture (PIL's one-strip RGB, YCbCr and gray; strips at 4:2:0,
    4:2:2 and 4:4:4, RGB and gray strips, tiles cut at the edges, a restart interval,
    progressive strips, orientation 6, a cut strip, a last strip encoded taller than its
    rows, the 640x480 file) equal to cv2, or ValueError where cv2 returns None (a strip of
    no JPEG, sampling factors libtiff refuses, a component count other than the samples,
    a JPEG taller than a strip that is not the last)."""
    data = _bytes(name)
    want = _cv2(data)
    if "_invalid_" in name:
        assert want is None and name in fx.INVALID
        with pytest.raises(ValueError):
            codec.decode_image(data, "cpu")
        return
    np.testing.assert_array_equal(codec.decode_image(data, "cpu").numpy(), want)
    tiff = codec.parse_tiff(data)
    assert all(c.jpeg is not None and c.decoded is None for c in tiff.chunks)


def test_jpeg_in_tiff_chunks_join_the_jpeg_batch():
    """The JPEG chunks of the TIFFs of a batch are images of the batch's one JPEG batch,
    after its JPEGs: decode_images gives each TIFF and JPEG as cv2 does."""
    names = ["coco_500x333_444.jpg", "tiff_jpeg_strips_420_67x45.tif", "tiff_jpeg_gray_tiles_67x45.tif",
             "progressive_420_83x61.jpg", "tiff_cv2_37x23.tif", "tiff_jpeg_rgb_strips_67x45.tif"]
    blobs = [_bytes(n) for n in names]
    tiffs = [codec.parse_tiff(b) for b in blobs if codec.image_kind(b) == "tiff"]
    assert len(codec.tiff_jpeg_chunks(tiffs)) == 3 + 10 + 3  # strips of 16 rows; tiles 16 wide and 32 tall
    for name, data, got in zip(names, blobs, codec.decode_images(blobs, "cpu")):
        np.testing.assert_array_equal(got.numpy(), _cv2(data), err_msg=name)


def test_uncompressed_tiles_are_none_but_for_four_samples():
    """cv2.imdecode returns None for uncompressed 16 x 16 tiles of 8-bit samples but of 4
    samples a pixel: the rule is libtiff's, a tile's raw buffer (a multiple of 1,024 bytes)
    must be the tile's size (codec._tiled_none_reads). cv2.imread of the file reads them
    all; the port decodes both ways as cv2 does, and the feed's check_file_read passes
    them."""
    rng = np.random.default_rng(77)
    for spp, photometric in ((1, 1), (3, 2), (4, 2)):
        t = fx.tiff_tags(37, 23, 8, spp, photometric, tile_width=16, tile_length=16, **({"extra": 2} if spp == 4 else {}))
        del t[278]
        data = fx.tiff(t, [rng.integers(0, 256, 256 * spp, dtype=np.uint8).tobytes() for _ in range(6)], tiled=True)
        if spp == 4:
            np.testing.assert_array_equal(codec.decode_image(data, "cpu").numpy(), _cv2(data))
        else:
            assert _cv2(data) is None
            with pytest.raises(ValueError, match="1024 bytes for its"):
                codec.decode_image(data, "cpu")
        codec.check_file_read(data)
        np.testing.assert_array_equal(codec.decode_image(data, "cpu", from_file=True).numpy(), _cv2_file(data))


def _cv2_file(data: bytes, suffix: str = ".tif"):
    """cv2.imread (IMREAD_COLOR) of `data` written to a file, as RGB, or None."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "image" + suffix)
        with open(path, "wb") as f:
            f.write(data)
        img = cv2.imread(path, cv2.IMREAD_COLOR)
    return None if img is None else img[..., ::-1]


FILE_READS = sorted(json.load(open(os.path.join(fx.FIXTURES, "digests.json")))["file_reads"])


@pytest.mark.parametrize("name", FILE_READS)
def test_file_reads_as_cv2_imread(name):
    """The fixtures cv2.imread reads otherwise than cv2.imdecode (uncompressed tiles of 768
    and 256 bytes, a tile of 1,000 bytes for its 1,024): decode_image with from_file, and
    codec.imread of the file, equal the recorded digest of cv2.imread and cv2.imread
    itself, or raise ValueError where it returns None."""
    want = json.load(open(os.path.join(fx.FIXTURES, "digests.json")))["file_reads"][name]
    data = _bytes(name)
    live = _cv2_file(data)
    assert (live is None) == (want is None)
    if want is None:
        with pytest.raises(ValueError):
            codec.decode_image(data, "cpu", from_file=True)
        return
    assert fx.sha(np.ascontiguousarray(live)) == want["rgb_sha256"]
    np.testing.assert_array_equal(codec.decode_image(data, "cpu", from_file=True).numpy(), live)
    np.testing.assert_array_equal(codec.imread(os.path.join(fx.FIXTURES, name), "cpu").numpy(), live)


def _random_tiles(rng) -> bytes:
    """An uncompressed tiled TIFF at random: tile sizes whose bytes are and are not a
    multiple of 1,024, 1-4 samples of 8 or 16 bits, one plane or separate ones, fill
    order, byte counts now and then short, long or zero, a tile past the data."""
    w, h = int(rng.integers(1, 70)), int(rng.integers(1, 50))
    tw, th = int(rng.choice([16, 32, 48])), int(rng.choice([16, 32]))
    spp, bits = int(rng.choice([1, 2, 3, 4])), int(rng.choice([8, 8, 16]))
    planar = 2 if spp > 1 and rng.random() < 0.3 else 1
    photometric = 1 if spp < 3 else 2
    more = {"extra": 2} if spp in (2, 4) else {}
    if rng.random() < 0.15:
        more["fill_order"] = 2
    tags = fx.tiff_tags(w, h, bits, spp, photometric, tile_width=tw, tile_length=th, **more)
    if planar == 2:
        tags[284] = (3, [2])
    del tags[278]
    per = tw * th * (spp if planar == 1 else 1) * bits // 8
    n = (-(-w // tw)) * (-(-h // th)) * (spp if planar == 2 else 1)
    tiles = [rng.integers(0, 256, per, dtype=np.uint8).tobytes() for _ in range(n)]
    counts = [len(t) for t in tiles]
    for _ in range(int(rng.integers(0, 3))):
        k = int(rng.integers(n))
        counts[k] = max(0, counts[k] + int(rng.choice([-24, -1000, 1, 700, -counts[k]])))
    if rng.random() < 0.1:
        counts[-1] += 5000  # past the data
    return fx.tiff(tags, tiles, big_endian=bool(rng.random() < 0.3), tiled=True, counts=counts)


@pytest.mark.parametrize("seed", range(4))
def test_random_uncompressed_tiles_as_cv2(seed):
    """40 seeded random uncompressed tiled TIFFs a seed, from bytes (cv2.imdecode) and from a
    file (cv2.imread): decoded as cv2 decodes them, or ValueError exactly where cv2
    returns None; none refused."""
    rng = np.random.default_rng(2300 + seed)
    for i in range(40):
        data = _random_tiles(rng)
        for from_file, want in ((False, _cv2(data)), (True, _cv2_file(data))):
            try:
                got = codec.decode_image(data, "cpu", from_file=from_file).numpy()
            except ValueError as e:
                assert want is None and not isinstance(e, codec.UnsupportedImage), (i, from_file)
                continue
            assert want is not None, (i, from_file)
            np.testing.assert_array_equal(got, want, err_msg=str((i, from_file)))


def test_uncompressed_tiles_read_the_same_twice_and_in_two_processes():
    """cv2's read of uncompressed tiles is a function of the file's bytes: the tiles of
    1,024 bytes (one of them of 1,000: libtiff's buffer, zeroed when it was allocated,
    reads it as zero) give the same pixels read twice in one process and in another
    process, from bytes and from files, and the port's decode equals them."""
    import subprocess
    import sys

    names = ["tiff_tiles_rgba_37x23.tif", "tiff_tiles_rgba_short_37x23.tif", "tiff_tiles_planar_rgb_37x23.tif",
             "tiff_invalid_tiles_rgb_37x23.tif"]
    code = ("import sys, cv2, hashlib, numpy as np\n"
            "for p in sys.argv[1:]:\n"
            "    for img in (cv2.imdecode(np.fromfile(p, np.uint8), cv2.IMREAD_COLOR), cv2.imread(p)):\n"
            "        print('none' if img is None else hashlib.sha256(np.ascontiguousarray(img[..., ::-1])).hexdigest())\n")
    paths = [os.path.join(fx.FIXTURES, n) for n in names]
    other = subprocess.run([sys.executable, "-c", code, *paths], capture_output=True, text=True, check=True)
    lines = other.stdout.split()
    for k, (name, path) in enumerate(zip(names, paths)):
        data = _bytes(name)
        for j, (want, again, from_file) in enumerate(((_cv2(data), _cv2(data), False),
                                                     (_cv2_file(data), _cv2_file(data), True))):
            digest = "none" if want is None else fx.sha(np.ascontiguousarray(want))
            assert digest == lines[2 * k + j] == ("none" if again is None else fx.sha(np.ascontiguousarray(again)))
            if want is None:
                with pytest.raises(ValueError):
                    codec.decode_image(data, "cpu", from_file=from_file)
            else:
                np.testing.assert_array_equal(codec.decode_image(data, "cpu", from_file=from_file).numpy(), want)


# ---------------------------------------------------------------------------- SGILog
def _sgilog_scalar(kind: str, p: int):
    """tif_luv.c's 8-bit conversion of one pixel, a scalar transcription of the C
    (LogL16toY, LogLuv32toXYZ, LogLuv24toXYZ with uv_decode, XYZtoRGB24, L16toGry)."""
    import math

    ln2 = math.log(2.0)

    def y16(p16):
        le = p16 & 0x7FFF
        if not le:
            return 0.0
        y = math.exp(ln2 / 256. * (le + .5) - ln2 * 64.)
        return -y if p16 & 0x8000 else y

    def byte(v):
        return 0 if v <= 0. else 255 if v >= 1. else int(256. * math.sqrt(v))

    if kind == "logl":
        return (byte(y16(p)),) * 3
    if kind == "logluv":
        lum = y16((p >> 16) & 0xFFFF)
        u, v = 1. / 410. * (((p >> 8) & 0xFF) + .5), 1. / 410. * ((p & 0xFF) + .5)
    else:
        p10 = (p >> 14) & 0x3FF
        lum = 0.0 if p10 == 0 else math.exp(ln2 / 64. * (p10 + .5) - ln2 * 12.)
        c = p & 0x3FFF
        if c >= 16289:
            u, v = 0.210526316, 0.473684211
        else:
            lower, upper = 0, 163
            while upper - lower > 1:
                vi = (lower + upper) >> 1
                ui = c - codec._SGILOG_UV_ROW[vi][2]
                if ui > 0:
                    lower = vi
                elif ui < 0:
                    upper = vi
                else:
                    lower = vi
                    break
            ui = c - codec._SGILOG_UV_ROW[lower][2]
            sq = float(np.float32(0.0035))
            u = float(np.float32(codec._SGILOG_UV_ROW[lower][0])) + (ui + .5) * sq
            v = float(np.float32(0.016940)) + (lower + .5) * sq
    if lum <= 0.:
        return (0, 0, 0)
    s = 1. / (6. * u - 16. * v + 12.)
    x, y = 9. * u * s, 4. * v * s
    f32 = lambda t: float(np.float32(t))  # noqa: E731
    X, Y, Z = f32(x / y * lum), f32(lum), f32((1. - x - y) / y * lum)
    r = 2.690 * X + -1.276 * Y + -0.414 * Z
    g = -1.022 * X + 1.978 * Y + 0.044 * Z
    b = 0.061 * X + -0.224 * Y + 1.163 * Z
    return byte(r), byte(g), byte(b)


def test_sgilog_conversions_are_the_c():
    """K8's SGILog conversions (ops/plain_image.py::logl_gray and logluv_rgb, through
    codec.sgilog_tables' exp) equal a scalar transcription of tif_luv.c at every 16-bit
    LogL (negative L and L zero among them), and at 4,000 seeded LogLuv32 and LogLuv24
    words (colour bytes off the gamut, indices past uv_row, every L10 edge)."""
    from ssd_object_detection_tpu_torch.ops import plain_image

    table = codec.sgilog_tables()
    p16 = np.arange(1 << 16)
    want = np.array([_sgilog_scalar("logl", int(v))[0] for v in p16])
    np.testing.assert_array_equal(plain_image.logl_gray(table, p16), want)
    rng = np.random.default_rng(2400)
    w32 = rng.integers(0, 1 << 32, 4000, dtype=np.int64)
    w32[:6] = [0, 0x80000000, 0x7FFF0000, 0x0001FFFF, 0x4000FF00, 0x400000FF]
    w24 = rng.integers(0, 1 << 24, 4000, dtype=np.int64)
    w24[:6] = [0, 16288, 16289 | 1 << 14, 0x3FF << 14 | 16383, 1 << 14, 0xFFFFFF]
    for kind, words in (("logluv", w32), ("logluv24", w24)):
        got = plain_image.logluv_rgb(table, words, kind == "logluv24")
        want = np.array([_sgilog_scalar(kind, int(v)) for v in words])
        np.testing.assert_array_equal(got, want, err_msg=kind)


def _random_sgilog(rng) -> bytes:
    """A LogL or LogLuv TIFF of SGILog or SGILog24 at random: size, strips or tiles, byte
    order, BigTIFF, orientation, bits and samples tags (now and then ones cv2 refuses),
    words of every sign and colour, runs of equal bytes, and now and then a chunk cut
    short or some of its bytes' bits flipped."""
    w, h = int(rng.integers(1, 60)), int(rng.integers(1, 30))
    logl = rng.random() < 0.4
    comp = 34676 if logl or rng.random() < 0.6 else 34677
    if rng.random() < 0.05:
        comp = 34677 if logl else 34676
    word = 2 if logl else (3 if comp == 34677 else 4)
    spp = 1 if logl else 3
    if rng.random() < 0.05:
        spp = int(rng.choice([1, 2, 3, 4]))
    bits = 16 if rng.random() < 0.85 else int(rng.choice([1, 2, 4, 8, 32]))
    more = {"orientation": int(rng.integers(1, 9))} if rng.random() < 0.3 else {}
    tags = fx.tiff_tags(w, h, bits, spp, 32844 if logl else 32845, comp, rows=int(rng.integers(1, h + 3)), **more)
    tiled = rng.random() < 0.25
    if tiled:
        tw, th = int(rng.choice([16, 32])), int(rng.choice([8, 16]))
        tags.update({322: (3, [tw]), 323: (3, [th])})
        del tags[278]
        boxes = [(th, tw)] * (-(-h // th) * -(-w // tw))
    else:
        rows = tags[278][1][0]
        boxes = [(min(rows, h - y), w) for y in range(0, h, rows)]
    chunks = []
    for r, c in boxes:
        base = rng.integers(0, 1 << (8 * word), dtype=np.int64)
        words = np.where(rng.random((r, c)) < 0.5, base, rng.integers(0, 1 << (8 * word), (r, c), dtype=np.int64))
        if word == 3:
            chunks.append(b"".join(int(v).to_bytes(3, "big") for v in words.reshape(-1)))
        else:
            chunks.append(b"".join(fx.sgilog_planes(row, word) for row in words))
    i = int(rng.integers(len(chunks)))
    r = rng.random()
    if r < 0.25:
        chunks[i] = chunks[i][:int(rng.integers(0, len(chunks[i]) + 1))]
    elif r < 0.5 and chunks[i]:
        b = bytearray(chunks[i])
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(len(b)))] ^= 1 << int(rng.integers(8))
        chunks[i] = bytes(b)
    return fx.tiff(tags, chunks, big_endian=bool(rng.random() < 0.4), big=bool(rng.random() < 0.3), tiled=tiled)


@pytest.mark.parametrize("seed", range(4))
def test_random_sgilog_tiffs_as_cv2(seed):
    """60 seeded random SGILog TIFFs a seed (LogL and LogLuv, SGILog and SGILog24, strips
    and tiles, their chunks now and then cut or their bits flipped): the port decodes each
    as cv2 does, or raises ValueError exactly where cv2 returns None; none refused."""
    rng = np.random.default_rng(2200 + seed)
    for i in range(60):
        data = _random_sgilog(rng)
        want = _cv2(data)
        try:
            got = codec.decode_image(data, "cpu").numpy()
        except ValueError as e:
            assert want is None and not isinstance(e, codec.UnsupportedImage), i
            continue
        assert want is not None, i
        np.testing.assert_array_equal(got, want, err_msg=str(i))
