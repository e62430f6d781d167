"""The cv2-free decoder (data/codec.py and the plain kernels of ops/plain_image.py) on
the CPU, against cv2.imdecode(..., IMREAD_COLOR) as RGB, which is what the JAX package's
decode paths return (ssd_object_detection_tpu/data/pipeline.py:70-87,
eval/serve.py:374-381).

Tolerance: none; every decode is bit-equal to cv2's. Inputs: the committed fixtures
(ssd_object_detection_tpu_torch/data/fixtures, made by tools/make_image_fixtures.py:
baseline, progressive, CMYK, YCCK and sampling factors up to 4, and what the port
refuses), JPEGs that tools/make_fake_coco.py writes, and fixtures edited here or written
by the tool's baseline encoder to reach a marker path (an Adobe RGB transform, component
ids R G B, a malformed Exif block) or a refusal.
"""

import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from ssd_object_detection_tpu_torch.data import codec
from ssd_object_detection_tpu_torch.ops import cuda_image
from ssd_object_detection_tpu_torch.tools import make_image_fixtures

cv2 = pytest.importorskip("cv2")

FIXTURES = Path(make_image_fixtures.FIXTURES)
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
NAMES = sorted(DIGESTS["images"])


def _cv2_rgb(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]


def _decode(data: bytes) -> np.ndarray:
    return codec.decode_image(data, "cpu").numpy()


@pytest.mark.parametrize("name", NAMES)
def test_fixture_decodes_as_cv2(name):
    data = (FIXTURES / name).read_bytes()
    entry = DIGESTS["images"][name]
    if "refused" in entry:
        with pytest.raises(codec.UnsupportedImage, match=entry["refused"]):
            _decode(data)
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is not None
        return
    got = _decode(data)
    np.testing.assert_array_equal(got, _cv2_rgb(data))
    assert make_image_fixtures.sha(got) == entry["rgb_sha256"]  # the digests the card is held to


def test_fixture_record_is_this_cv2s():
    """digests.json was written by this cv2 and is what the fixtures give it; cv2
    returns None for each fixture listed as invalid."""
    assert DIGESTS["cv2"] == cv2.__version__
    assert DIGESTS["libjpeg_turbo"] == make_image_fixtures.libjpeg_turbo_version(cv2)
    files = {n: (FIXTURES / n).read_bytes() for n in NAMES}
    assert make_image_fixtures.digests(files, cv2) == DIGESTS["images"]
    files.update({n: (FIXTURES / n).read_bytes() for n in DIGESTS["invalid"]})
    assert make_image_fixtures.invalid_record(files, cv2) == DIGESTS["invalid"]


@pytest.mark.parametrize("name", sorted(DIGESTS["invalid"]))
def test_invalid_fixture_raises_value_error(name):
    """What cv2 returns None for (GIFs and HDRs at each edge of cv2's readers) raises
    ValueError, alone and in a batch with a decodable image of its format."""
    data = (FIXTURES / name).read_bytes()
    assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError):
        _decode(data)
    good = (FIXTURES / ("gif_cv2_37x23.gif" if name.endswith(".gif") else "hdr_cv2_rle_37x23.hdr")).read_bytes()
    with pytest.raises(ValueError):
        codec.decode_images([good, data], "cpu")


def test_one_batch_equals_one_by_one():
    """Every JPEG fixture through one launch of each JPEG kernel (and the PNGs beside
    them) equals decoding each alone."""
    blobs = [(FIXTURES / n).read_bytes() for n in NAMES if "refused" not in DIGESTS["images"][n]]
    together = codec.decode_images(blobs, "cpu")
    for data, got in zip(blobs, together):
        np.testing.assert_array_equal(got.numpy(), _decode(data))


def test_fake_coco_jpegs_decode_as_cv2(tmp_path):
    """Noise-textured JPEGs as the integration datasets are written (cv2 quality 95,
    4:2:0, one grayscale)."""
    from ssd_object_detection_tpu_torch.tools import make_fake_coco

    make_fake_coco.make_split(str(tmp_path), "train", 4, seed=11)
    for path in sorted((tmp_path / "train2017").glob("*.jpg")):
        got = codec.imread(str(path), "cpu").numpy()
        np.testing.assert_array_equal(got, cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1], err_msg=path.name)


def _segments(data: bytes):
    """[(marker, start of its length field, end)] of a JPEG's header segments."""
    out, pos = [], 2
    while pos < len(data) and data[pos + 1] != 0xDA:
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        out.append((data[pos + 1], pos, pos + 2 + length))
        pos += 2 + length
    return out


def _drop_app0(data: bytes) -> bytes:
    for marker, start, end in _segments(data):
        if marker == 0xE0:
            return data[:start] + data[end:]
    return data


def _with_app14(data: bytes, transform: int) -> bytes:
    body = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform)
    return data[:2] + b"\xff\xee" + struct.pack(">H", len(body) + 2) + body + data[2:]


def _replace_sof(data: bytes, fn) -> bytes:
    for marker, start, end in _segments(data):
        if marker in (0xC0, 0xC1):
            return data[:start] + fn(data[start:end]) + data[end:]
    raise AssertionError("no SOF")


@pytest.mark.parametrize("edit", ["adobe_rgb", "adobe_ycc", "rgb_ids", "no_markers"])
def test_colour_transform_markers_as_cv2(edit):
    """The Adobe APP14 transform flag (0: the components are RGB) and, without JFIF or
    Adobe markers, the component ids (R G B: RGB) choose the colour transform as
    libjpeg does."""
    data = _drop_app0((FIXTURES / "coco_500x333_444.jpg").read_bytes())
    if edit == "adobe_rgb":
        data = _with_app14(data, 0)
    elif edit == "adobe_ycc":
        data = _with_app14(data, 1)
    elif edit == "rgb_ids":
        def ids(seg):
            seg = bytearray(seg)
            for k, cid in enumerate(b"RGB"):
                seg[10 + 3 * k] = cid
            return bytes(seg)

        data = _replace_sof(data, ids)
        sos = data.index(b"\xff\xda")
        scan = bytearray(data[sos:])
        for k, cid in enumerate(b"RGB"):
            scan[5 + 2 * k] = cid
        data = data[:sos] + bytes(scan)
    np.testing.assert_array_equal(_decode(data), _cv2_rgb(data))


def _exif_payload(order: str, entries, ifd_offset: int = 8) -> bytes:
    tiff = (b"II*\0" if order == "<" else b"MM\0*") + struct.pack(order + "I", ifd_offset)
    tiff += struct.pack(order + "H", len(entries))
    for tag, typ, count, value in entries:
        tiff += struct.pack(order + "HHI", tag, typ, count) + struct.pack(order + "HH", value, 0)
    return b"Exif\0\0" + tiff + struct.pack(order + "I", 0)


@pytest.mark.parametrize("case", ["big_endian_6", "second_entry_3", "bad_value_9", "truncated",
                                  "bad_offset", "wrong_type"])
def test_exif_orientation_and_malformed_blocks_as_cv2(case):
    """Orientation from a big-endian block and from a later IFD0 entry; an invalid
    value, a truncated block and an IFD offset past the end leave the image as it is;
    a LONG-typed tag counts by its first 16 bits, as in cv2. The decoder never fails
    on Exif."""
    payload = {
        "big_endian_6": _exif_payload(">", [(0x0112, 3, 1, 6)]),
        "second_entry_3": _exif_payload("<", [(0x010F, 3, 1, 0), (0x0112, 3, 1, 3)]),
        "bad_value_9": _exif_payload("<", [(0x0112, 3, 1, 9)]),
        "truncated": _exif_payload("<", [(0x0112, 3, 1, 6)])[:16],
        "bad_offset": _exif_payload("<", [(0x0112, 3, 1, 6)], ifd_offset=4000),
        "wrong_type": _exif_payload("<", [(0x0112, 4, 1, 6)]),
    }[case]
    base = (FIXTURES / "exif1_21x14.jpg").read_bytes()
    base = base[:2] + base[2 + 2 + struct.unpack(">H", base[4:6])[0]:]  # drop the fixture's own APP1
    data = base[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload + base[2:]
    np.testing.assert_array_equal(_decode(data), _cv2_rgb(data))


@pytest.mark.parametrize("edit,match", [
    ("avif", "AVIF"), ("arithmetic", "SOF9"), ("lossless", "SOF3"), ("12bit", "12-bit"),
    ("sunraster", None), ("bmp", None), ("webp", "WebP"), ("pfm", None), ("tiff", None),
    ("gray_pfm", "1-channel PFM"), ("hdr", None), ("jpeg2000", "JPEG 2000"), ("gif", None),
])
def test_refusals_name_the_feature(edit, match):
    """What cv2 reads and the port still refuses raises UnsupportedImage, not ValueError;
    a Sun raster, a BMP, a PFM, an HDR, a GIF and a TIFF, once refused, now decode as cv2
    decodes them (match None)."""
    base = (FIXTURES / "coco_500x333_444.jpg").read_bytes()
    small = np.zeros((4, 4, 3), np.uint8)
    small[1:3, 1:3] = (10, 200, 60)
    if edit in ("arithmetic", "lossless"):
        sof = base.index(b"\xff\xc0")
        data = base[:sof + 1] + bytes([0xC9 if edit == "arithmetic" else 0xC3]) + base[sof + 2:]
    elif edit == "12bit":
        data = _replace_sof(base, lambda seg: seg[:4] + b"\x0c" + seg[5:])
    elif edit in ("bmp", "tiff", "avif", "sunraster", "gif"):
        data = cv2.imencode({"sunraster": ".ras"}.get(edit, "." + edit), small)[1].tobytes()
    elif edit == "jpeg2000":  # OpenJPEG wants more than 4x4 pixels
        data = cv2.imencode(".jp2", np.zeros((64, 64, 3), np.uint8))[1].tobytes()
    elif edit in ("pfm", "gray_pfm", "hdr"):
        f = small.astype(np.float32) / 7
        data = cv2.imencode(".hdr" if edit == "hdr" else ".pfm", f[..., 0] if edit == "gray_pfm" else f)[1].tobytes()
    else:
        data = b"RIFF\x10\0\0\0WEBPVP8 "
    if match is None:
        np.testing.assert_array_equal(_decode(data), _cv2_rgb(data))
        return
    with pytest.raises(codec.UnsupportedImage, match=match):
        _decode(data)
    if edit not in ("arithmetic", "lossless", "12bit", "webp"):  # edited bytes: unchecked against cv2
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is not None


def _sos_edit(data: bytes, scan: int, fn) -> bytes:
    """The JPEG with its scan-th SOS header's bytes edited by fn(bytearray, offset of Ss)."""
    sos = [start for marker, start, _ in make_image_fixtures.jpeg_segments(data) if marker == 0xDA][scan]
    out = bytearray(data)
    fn(out, sos + 5 + 2 * data[sos + 4])
    return bytes(out)


@pytest.mark.parametrize("case", ["empty", "garbage", "jpeg_header_only", "truncated_entropy",
                                  "png_bad_crc", "png_truncated", "png_bad_filter", "two_components",
                                  "dc_scan_past_dc", "ac_band_reversed", "refinement_al", "fractional_sampling",
                                  "mcu_over_10_blocks"])
def test_bytes_that_do_not_decode_raise_value_error(case):
    """cv2 returns None for all of these but empty bytes, where cv2.imdecode raises: a
    truncated file (cv2 5.0.0 reads no partial image), a 2-component JPEG (libjpeg has no
    colour conversion for it), progressive scans that libjpeg's
    start_pass_phuff_decoder refuses (a DC scan past coefficient 0, Ss > Se, a
    refinement with Al != Ah - 1), a fractional sampling ratio and an MCU of more than 10
    blocks (the last three written by the fixture tool's baseline encoder)."""
    jpeg = (FIXTURES / "coco_500x333_444.jpg").read_bytes()
    png = (FIXTURES / "png_palette_83x61.png").read_bytes()
    progressive = (FIXTURES / "progressive_420_83x61.jpg").read_bytes()
    img = cv2.imdecode(np.frombuffer((FIXTURES / "cmyk_83x61.jpg").read_bytes(), np.uint8), cv2.IMREAD_COLOR)
    planes = make_image_fixtures.ycc_planes(img)
    data = {
        "empty": b"",
        "garbage": b"not an image",
        "jpeg_header_only": jpeg[:jpeg.index(b"\xff\xda")],
        "truncated_entropy": jpeg[:len(jpeg) // 2],
        "png_bad_crc": png[:30] + bytes([png[30] ^ 1]) + png[31:],
        "png_truncated": png[:len(png) - 40],
        "png_bad_filter": None,
        "two_components": make_image_fixtures.encode_baseline(planes[:2], [(1, 1)] * 2, cv2),
        "dc_scan_past_dc": _sos_edit(progressive, 0, lambda b, at: b.__setitem__(at + 1, 1)),
        "ac_band_reversed": _sos_edit(progressive, 1, lambda b, at: b.__setitem__(at, 6)),
        "refinement_al": _sos_edit(progressive, 5, lambda b, at: b.__setitem__(at + 2, 0x20)),
        "fractional_sampling": make_image_fixtures.encode_baseline(planes, [(3, 1), (2, 1), (2, 1)], cv2),
        "mcu_over_10_blocks": make_image_fixtures.encode_baseline(planes, [(2, 4), (1, 2), (1, 2)], cv2),
    }[case]
    if case == "png_bad_filter":  # a PNG whose first row names filter type 7
        img = np.zeros((3, 4, 1), np.int64)
        data = make_image_fixtures.png(img, 0, 8)
        idat = data.index(b"IDAT")
        length = struct.unpack(">I", data[idat - 4:idat])[0]
        raw = bytearray(zlib.decompress(data[idat + 4:idat + 4 + length]))
        raw[0] = 7
        body = zlib.compress(bytes(raw))
        chunk = struct.pack(">I", len(body)) + b"IDAT" + body + struct.pack(">I", zlib.crc32(b"IDAT" + body))
        data = data[:idat - 4] + chunk + data[data.index(b"IEND") - 4:]
    with pytest.raises(ValueError):
        _decode(data)
    if case != "empty":
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None


@pytest.mark.parametrize("edit", ["sequential_spectral_fields", "four_components_no_adobe",
                                  "four_components_adobe_1"])
def test_what_libjpeg_only_warns_about_decodes_as_cv2(edit):
    """libjpeg warns, and cv2 reads the image: a sequential scan whose Ss, Se, Ah, Al are
    not 0, 63, 0, 0; a 4-component JPEG without an Adobe marker (CMYK) and one whose
    Adobe transform is 1 (taken as YCCK)."""
    if edit == "sequential_spectral_fields":
        data = _sos_edit((FIXTURES / "coco_500x333_444.jpg").read_bytes(), 0, lambda b, at: b.__setitem__(at + 1, 0))
    else:
        img = cv2.imdecode(np.frombuffer((FIXTURES / "cmyk_83x61.jpg").read_bytes(), np.uint8), cv2.IMREAD_COLOR)
        y, cb, cr = make_image_fixtures.ycc_planes(img)
        k = np.full_like(y, 200)
        data = make_image_fixtures.encode_baseline([y, cb, cr, k], [(1, 1)] * 4, cv2,
                                                   adobe=None if edit == "four_components_no_adobe" else 1)
    np.testing.assert_array_equal(_decode(data), _cv2_rgb(data))


def test_entry_points_default_to_the_card():
    """decode_image and imread run on cuda unless the CPU is asked for: without a card
    they raise; nothing drops to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    data = (FIXTURES / "exif1_21x14.jpg").read_bytes()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codec.decode_image(data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codec.imread(str(FIXTURES / "exif1_21x14.jpg"))


def test_cpu_calls_count_no_launches():
    cuda_image.reset_launches()
    codec.decode_images([(FIXTURES / n).read_bytes() for n in ("exif6_21x14.jpg", "png_gray1_37x19.png",
                                                                "progressive_420_83x61.jpg", "bmp_pal4_37x23.bmp",
                                                                "progressive_cut_eoi_83x61.jpg", "gif_kwkwk_37x23.gif",
                                                                "hdr_rle_runs_12x5.hdr")], "cpu")
    cuda_image.resize(torch.zeros(4, 4, 3, dtype=torch.uint8), (2, 2))
    assert [k.launches for k in cuda_image.KERNELS] == [0] * len(cuda_image.KERNELS) == [0] * 11


def test_progressive_and_sequential_share_one_coefficient_buffer():
    """A batch mixing sequential and progressive images: K1 decodes the sequential scans
    and the progressive images' first scans, K6 refines only the progressive images'
    blocks in the same buffer, and each image's pixels equal its decode alone."""
    names = ["coco_500x333_444.jpg", "progressive_restart_83x61.jpg", "cmyk_progressive_83x61.jpg",
             "restart1_420.jpg"]
    batch = codec.jpeg_batch([codec.parse_jpeg((FIXTURES / n).read_bytes()) for n in names])
    assert batch.progressive.shape[0] == 2 and batch.total_subseqs > 0 and batch.k6_rounds
    coef, status, stops = cuda_image.entropy_decode(batch)
    comps = batch.comps.numpy()
    prog_blocks = slice(int(comps[3, 0]), int(comps[10, 0]))  # components 3-9: the progressive images
    assert coef[prog_blocks].any() and not status.any()
    full, status, _ = cuda_image.progressive_entropy(batch, (coef.clone(), status, stops))
    assert not torch.equal(full[prog_blocks], coef[prog_blocks]) and not status.any()
    assert torch.equal(full[:prog_blocks.start], coef[:prog_blocks.start])
    assert torch.equal(full[prog_blocks.stop:], coef[prog_blocks.stop:])
    for data, got in zip([(FIXTURES / n).read_bytes() for n in names], cuda_image.decode_jpeg_batch(batch)[0]):
        np.testing.assert_array_equal(got.numpy(), _decode(data))

def test_refinement_bound_counts_each_refined_block_once():
    """K6's byte bound: its refinement scans' bytes in, and each block of a component
    some refinement touches read and written once however many refinements touch it
    (a 640x480 4:2:0 image: 4,800 Y and 2 x 1,200 chroma blocks); K7's: a smoothed
    block's DC and zig-zag 1-9, 20 bytes in and 20 out."""
    blob = (FIXTURES / "coco_640x480_progressive.jpg").read_bytes()
    batch = codec.jpeg_batch([codec.parse_jpeg(blob), codec.parse_jpeg((FIXTURES / "coco_500x333_444.jpg").read_bytes()),
                              codec.parse_jpeg(blob)])
    refine_bytes, blocks = cuda_image.refinement_work(batch)
    segs, jobs = batch.segments.numpy(), batch.jobs.numpy()
    refine = jobs[segs[:, 2], 33] != codec.ROUTE_K1
    assert blocks == 2 * 7200 and refine_bytes == int(segs[refine, 1].sum()) // 8 > 0
    assert cuda_image.bound_bytes("progressive_entropy", entropy_bytes=refine_bytes, blocks=blocks) == (
        refine_bytes + 2 * 7200 * 64 * 2 * 2)
    assert cuda_image.bound_bytes("block_smooth", blocks=3) == 3 * 40
