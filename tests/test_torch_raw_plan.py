"""The launch plan of K8 (csrc/raw_image.cu) and K10 (csrc/tiff_assemble.cu): every
integer the kernels read, as data/codec.py::raw_batch lays it out, named and ordered as
the kernels' enums; a decode call mixing BMP, GIF, PAM, HDR and TIFF (strips, tiles,
separate planes, the predictor, a big-endian swap, JPEG chunks) in one K8 launch against
each image alone and cv2's digests; and the plain pair that now splits the work (K10 the
predictor and the swap in place, K8 reading each TIFF sample through its chunk) bit-equal
to the composition it replaces (K10 placing every chunk in a zeroed image buffer, K8
reading that buffer) on every TIFF fixture that composition read. CPU only: the card's
own runs are in tests/test_torch_cuda_image.py.
"""

import hashlib
import json
import os
import re

import numpy as np
import pytest
import torch

from ssd_object_detection_tpu_torch.data import codec
from ssd_object_detection_tpu_torch.ops import cuda_image, plain_image
from ssd_object_detection_tpu_torch.tools.make_image_fixtures import FIXTURES, INVALID, REFUSED

CSRC = os.path.join(os.path.dirname(codec.__file__), os.pardir, "csrc")
DIGESTS = json.loads(open(os.path.join(FIXTURES, "digests.json")).read())["images"]
MIXED = ["bmp_rle8_37x23.bmp", "gif_interlaced_100x80.gif", "pam_rgb_37x23.pam", "hdr_cv2_rle_37x23.hdr",
         "tiff_cv2_37x23.tif", "tiff_tiled_37x23.tif", "tiff_planar_37x23.tif", "tiff_be_16bit_37x23.tif",
         "tiff_jpeg_strips_420_67x45.tif", "tiff_jpeg_gray_tiles_67x45.tif", "tiff_ycbcr44_tiles_37x23.tif",
         "tiff_lab16_be_37x23.tif", "tiff_jpeg_pil_cmyk_37x23.tif", "tiff_jpeg_planar_rgb_67x45.tif",
         "gif_transparent_37x23.gif", "tiff_lzw_runout_37x23.tif", "pxm_p3_37x23.ppm"]


def _bytes(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _enum(source: str, first: str) -> dict:
    """name -> value of the anonymous enum of `source` (csrc/) that starts with `first`."""
    text = open(os.path.join(CSRC, source)).read()
    body = re.search(r"enum \{\s*(" + first + r"\b[^}]*)\}", text).group(1)
    out, value = {}, -1
    for item in body.split(","):
        name, _, given = item.strip().partition("=")
        value = int(given) if given.strip() else value + 1
        out[name.strip()] = value
    return out


def _constant(source: str, name: str) -> int:
    text = open(os.path.join(CSRC, source)).read()
    return int(re.search(r"\b" + name + r" = (\d+)", text).group(1))


def _snake(name: str) -> str:
    """kBytesHeld -> BYTES_HELD."""
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name[1:]).upper()


def test_kernel_structures_are_the_hosts():
    """Every field K8 and K10 read has the index data/codec.py gives it (R_*, C_*), in the
    kernels' order, and the two sides agree on the widths and constants."""
    raw = _enum("raw_image.cu", "kOut")
    assert {_snake(k): v for k, v in raw.items()} == {n[2:]: getattr(codec, n) for n in dir(codec) if n.startswith("R_")}
    assert list(raw.values()) == list(range(len(raw))) and len(raw) <= codec.RAW_INTS
    chunk = {_snake(k): v for k, v in _enum("raw_image.cu", "kSrc").items()}
    chunk.update({_snake(k): v for k, v in _enum("tiff_assemble.cu", "kSrc").items()})
    assert chunk == {n[2:]: getattr(codec, n) for n in dir(codec) if n.startswith("C_")}
    formats = _enum("raw_image.cu", "kPal1")
    assert formats["kTiffLut"] == codec.TIFF_LUT_FORMAT and formats["kTiffYcbcr"] == codec.TIFF_YCBCR_FORMAT
    assert formats["kTiffLab"] == codec.TIFF_LAB_FORMAT and formats["kBgr16"] == codec.RAW_BGR16
    assert _constant("raw_image.cu", "kRawInts") == codec.RAW_INTS
    assert _constant("raw_image.cu", "kChunkInts") == _constant("tiff_assemble.cu", "kChunkInts") == codec.TIFF_CHUNK_INTS
    assert (_constant("raw_image.cu", "kTileRows"), _constant("raw_image.cu", "kTileCols")) == codec.RAW_TILE
    assert _constant("raw_image.cu", "kLabRange") == codec.LAB_RANGE
    assert _constant("raw_image.cu", "kLabHeader") == codec.LAB_HEADER
    assert _constant("tiff_assemble.cu", "kWorkInts") == codec.K10_WORK_INTS
    assert _constant("tiff_assemble.cu", "kRowInts") == codec.K10_ROW_INTS


def _parsed(names):
    gifs, tiffs, raws = [], [], []
    for n in names:
        data = _bytes(n)
        kind = codec.image_kind(data)
        if kind == "gif":
            gifs.append(codec.parse_gif(data))
        elif kind == "tiff":
            tiffs.append(codec.parse_tiff(data))
        else:
            raws.append(codec.parse_raw(data, kind))
    return gifs, tiffs, raws


def test_raw_batch_plan():
    """The mixed call's plan, integer by integer: the image table's rows (each image's
    RGB on a 16-byte boundary, its CTAs after the previous image's, a raw image's rows in
    the host bytes, a GIF frame in K9's output, a TIFF's first chunk and chunk geometry,
    each distinct YCbCr or CIELab table once), the chunk table (a host-decoded chunk's
    bytes in the host bytes, an LZW chunk in K9's output after the frames, a JPEG chunk's
    frame in the JPEG output, rows and bytes held) and K10's list (exactly the chunks
    with a predictor or a swap, their rows counted before them)."""
    gifs, tiffs, raws = _parsed(MIXED)
    batch = codec.raw_batch(gifs, tiffs, raws)
    rows = batch.image_rows
    images = [g.raw() for g in gifs] + [t.raw() for t in tiffs] + raws
    assert batch.images == len(images) == len(MIXED)
    tile = out = 0
    for row, raw in zip(rows, images):
        oh, ow = raw.out_hw
        assert (row[codec.R_OUT], row[codec.R_TILE]) == (out, tile)
        assert row[codec.R_OUT] % 16 == 0
        assert tuple(row[[codec.R_HEIGHT, codec.R_WIDTH, codec.R_FMT, codec.R_OUT_H, codec.R_OUT_W]]) == (
            raw.height, raw.width, raw.fmt, oh, ow)
        assert row[codec.R_TILES_X] == -(-ow // codec.RAW_TILE[1])
        assert tuple(row[codec.R_TOP:codec.R_WIN_W + 1]) == (raw.window or (0, 0, raw.height, raw.width))
        palette = batch.host[row[codec.R_PALETTE]:row[codec.R_PALETTE] + 257 * 3].reshape(257, 3)
        np.testing.assert_array_equal(palette, raw.palette)
        assert np.int32(row[codec.R_SCALE]).view(np.float32) == np.float32(raw.scale)
        tile += row[codec.R_TILES_X] * -(-oh // codec.RAW_TILE[0])
        out += -(-oh * ow * 3 // 16) * 16
    assert (batch.tiles, batch.out_bytes) == (tile, out)
    for row, raw in zip(rows[len(gifs) + len(tiffs):], raws):  # the raw rows in the host bytes
        first = row[codec.R_OFFSET] - raw.offset
        assert bytes(batch.host[first:first + len(raw.data)]) == raw.data
    frame = 0
    for row, g in zip(rows, gifs):  # the frames in K9's output, after the host bytes
        assert row[codec.R_OFFSET] == batch.lzw_at + frame
        frame += g.frame_width * g.frame_height
    assert batch.lzw.frame_indices == frame and batch.lzw_at >= batch.host.size and batch.lzw_at % 16 == 0
    chunks, k, jpeg_at, lzw_at, stream = batch.chunks, 0, 0, batch.lzw_at + frame, len(gifs)
    tables = set()
    for row, t in zip(rows[len(gifs):], tiffs):
        assert tuple(row[[codec.R_OFFSET, codec.R_STRIDE, codec.R_CHUNK_W, codec.R_ACROSS, codec.R_PER_PLANE,
                          codec.R_PLANAR]]) == (k, t.chunk_hw[0], t.chunk_hw[1], t.across, t.per_plane,
                                                int(t.planes > 1))
        if t.tables is not None:
            tables.add(int(row[codec.R_TABLE]))
            size = codec.YCBCR_TABLE_INTS if t.tables[0] == "ycbcr" else codec.LAB_TABLE_INTS
            want = codec.ycbcr_tables(*t.tables[1:]).reshape(-1) if t.tables[0] == "ycbcr" else \
                codec.lab_tables(t.tables[1]).view(np.int32)
            np.testing.assert_array_equal(batch.desc[row[codec.R_TABLE]:row[codec.R_TABLE] + size], want)
        else:
            assert row[codec.R_TABLE] == -1
        for c in t.chunks:
            cr = chunks[k]
            assert tuple(cr[[codec.C_PITCH, codec.C_ROWS_HELD, codec.C_BYTES_HELD]]) == (
                c.pitch, c.placed_rows, c.placed_bytes)
            if c.jpeg is not None:
                assert (cr[codec.C_JPEG], cr[codec.C_SRC]) == (1, jpeg_at)
                jpeg_at += c.jpeg.height * c.jpeg.width * codec.pixel_bytes(c.jpeg.space, len(c.jpeg.comps))
            elif c.decoded is None and not c.missing:
                assert (cr[codec.C_SRC], cr[codec.C_STREAM]) == (lzw_at, stream)
                lzw_at, stream = lzw_at + c.size, stream + 1
            elif not c.missing:
                assert cr[codec.C_STREAM] == -1
                assert bytes(batch.host[cr[codec.C_SRC]:cr[codec.C_SRC] + c.size]) == c.decoded
            k += 1
    assert len(tables) == 2  # one YCbCr and one CIELab table
    assert lzw_at == batch.total
    listed = set(batch.desc[batch.work_at:batch.work_at + 2 * batch.works:2].tolist())
    needs = {i for i, cr in enumerate(chunks) if cr[codec.C_JPEG] == 0 and cr[codec.C_ROWS] > 0
             and (cr[codec.C_PREDICTOR] or cr[codec.C_SWAB])}
    assert listed == needs and needs
    before = batch.desc[batch.work_at + 1:batch.work_at + 2 * batch.works:2]
    np.testing.assert_array_equal(np.diff(np.append(before, batch.k10_rows)), chunks[sorted(needs), codec.C_ROWS])
    at = batch.work_at + codec.K10_WORK_INTS * batch.works
    entries = batch.desc[at:at + codec.K10_ROW_INTS * batch.k10_rows].reshape(-1, codec.K10_ROW_INTS)
    for g in (0, 1, batch.k10_rows // 2, batch.k10_rows - 1):  # each K10 row's chunk and its row there
        k = np.searchsorted(before, g, side="right") - 1
        assert tuple(entries[g]) == (sorted(needs)[k], g - before[k])


def test_a_mixed_call_is_one_k8_launch_equal_to_each_alone():
    """BMP, GIF, PAM, HDR, PPM and TIFFs of every layout in one decode call: each image
    equals it decoded alone and cv2's digest (the plain K9, K10 and K8 here, the path the
    card's one launch of each takes)."""
    blobs = [_bytes(n) for n in MIXED]
    together = codec.decode_images(blobs, "cpu")
    for name, data, got in zip(MIXED, blobs, together):
        np.testing.assert_array_equal(got.numpy(), codec.decode_image(data, "cpu").numpy(), err_msg=name)
        assert _sha(got.numpy()) == DIGESTS[name]["rgb_sha256"], name


def test_k10_runs_only_where_a_chunk_needs_it():
    """A call of TIFFs without a predictor or a swap lists no K10 chunk (no K10 launch on
    the card); one with them lists each such chunk once."""
    plain = codec.raw_batch([], [codec.parse_tiff(_bytes(n)) for n in ("tiff_pil_rgb_deflate_37x23.tif",
                                                                       "tiff_ycbcr22_none_37x23.tif")], [])
    assert plain.works == 0 and plain.k10_rows == 0
    tif = codec.parse_tiff(_bytes("tiff_cv2_640x480.tif"))
    assert tif.predictor == 8
    batch = codec.raw_batch([], [tif], [])
    assert batch.works == len(tif.chunks) and batch.k10_rows == sum(c.placed_rows for c in tif.chunks)


# ---------------------------------------------------------------------------- the old composition
def _old_samples(buf, rows, x, channels, bits, plane_bytes, sample, rgb16):
    """The placing design's plain K8 reading a TIFF's placed image buffer (its tiff_samples)."""
    d = buf.astype(np.int64)
    base = rows + sample * plane_bytes if plane_bytes else rows
    i = x * channels + (0 if plane_bytes else sample)
    if bits == 1:
        return (d[base + (i >> 3)] >> (7 - (i & 7))) & 1
    if bits == 4:
        return np.where(i & 1, d[base + (i >> 1)] & 15, d[base + (i >> 1)] >> 4)
    if bits == 8:
        return d[base + i]
    v = d[base + 2 * i] | d[base + 2 * i + 1] << 8
    return (v + 128) // 257 if rgb16 else v >> 8


def _old_composition(tif: codec.TiffImage, jpeg: np.ndarray) -> np.ndarray:
    """The placing design's plain pair: K10 undoing the predictor and the swap in each chunk's rows and
    placing them in a zeroed image buffer (`pitch` bytes apart in the chunk, `stride` in
    the image, cut at its edge), then K8 reading the buffer."""
    stride = -(-tif.width * tif.samples * tif.bits // 8)
    buf = np.zeros(tif.planes * tif.height * stride, np.uint8)
    at = 0
    for c in tif.chunks:
        if c.missing:
            continue
        dst = (c.plane * tif.height + c.y0) * stride + c.byte0
        if c.jpeg is not None:
            n = c.jpeg.height * c.jpeg.width * codec.pixel_bytes(c.jpeg.space, len(c.jpeg.comps))
            src, pitch = jpeg[at:at + n], c.pitch
            at += n
        else:
            if c.decoded is None:
                decoded, status = plain_image.lzw_tiff(c.raw, c.size)
                ok = status == codec.GIF_OK
            else:
                decoded, ok = c.decoded, c.ok
            block = np.frombuffer(decoded, np.uint8).reshape(c.rows, c.row_bytes)[:c.placed_rows].copy()
            n = c.width * tif.samples
            predictor, swab = (tif.predictor, tif.swab) if ok else (0, False)
            if predictor == 8:
                v = block[:, :n].reshape(-1, c.width, tif.samples).astype(np.int64)
                block[:, :n] = (np.cumsum(v, 1) & 255).astype(np.uint8).reshape(-1, n)
            elif predictor == 16 or swab:
                pairs = block[:, :2 * n].reshape(-1, n, 2).astype(np.int64)
                v = pairs[..., 0] << 8 | pairs[..., 1] if swab else pairs[..., 0] | pairs[..., 1] << 8
                if predictor == 16:
                    v = np.cumsum(v.reshape(-1, c.width, tif.samples), 1).reshape(-1, n) & 0xFFFF
                block[:, :2 * n] = np.stack([v & 255, v >> 8], -1).astype(np.uint8).reshape(-1, 2 * n)
            src, pitch = np.concatenate([block.reshape(-1), np.zeros(c.row_bytes, np.uint8)]), c.pitch
        for r in range(c.placed_rows):
            buf[dst + r * stride:dst + r * stride + c.placed_bytes] = src[r * pitch:r * pitch + c.placed_bytes]
    x = np.arange(tif.width)
    rows = np.arange(tif.height)[:, None] * stride
    plane_bytes = tif.height * stride if tif.planes > 1 else 0

    def s(c, rgb16=True):
        return _old_samples(buf, rows, x, tif.samples, tif.bits, plane_bytes, c, rgb16)

    if tif.fmt == codec.TIFF_LUT_FORMAT:
        img = tif.palette[s(0, False)]
    elif tif.fmt == codec.TIFF_CMYK_FORMAT:
        k = 255 - s(3)
        img = np.stack([k * (255 - s(c)) // 255 for c in range(3)], -1).astype(np.uint8)
    else:
        rgb = [s(c if tif.colour_channels == 3 else 0) for c in range(3)]
        if tif.alpha >= 0:
            a = s(tif.alpha)
            rgb = [(v * a + 127) // 255 for v in rgb]
        img = np.stack(rgb, -1).astype(np.uint8)
    if tif.mirror:
        img = img[:, plain_image.mirrored_columns(tif.width, tif.mirror)]
    oh, ow = codec.oriented_hw(tif.height, tif.width, tif.orientation)
    return img[plain_image.orientation_source(oh, ow, tif.height, tif.width, tif.orientation)]


OLD_KINDS = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".tif") and n not in INVALID and n not in REFUSED
                   and codec.parse_tiff(_bytes(n)).fmt in (codec.TIFF_LUT_FORMAT, codec.TIFF_RGB_FORMAT,
                                                          codec.TIFF_CMYK_FORMAT))


@pytest.mark.parametrize("name", OLD_KINDS)
def test_new_plain_split_equals_the_old_composition(name):
    """On every TIFF fixture of the formats the old pair read (gray, palette, RGB, CMYK, as
    strips, tiles or planes, any compression, JPEG chunks included), the new plain K10 +
    K8 (the samples read through the chunk table) equal the old placing K10 + K8."""
    tif = codec.parse_tiff(_bytes(name))
    jpeg = np.zeros(0, np.uint8)
    chunks = codec.tiff_jpeg_chunks([tif])
    if chunks:
        batch = codec.jpeg_batch(chunks)
        coef, _ = cuda_image.decode_entropy(batch)
        jpeg = cuda_image.idct_color(coef, batch).numpy()
    got = cuda_image.decode_raw_batch([], [tif], [], torch.device("cpu"), torch.from_numpy(jpeg))[0].numpy()
    np.testing.assert_array_equal(got, _old_composition(tif, jpeg))
