"""The launch plans of K11 (csrc/ccitt_decode.cu), K12 (csrc/sgilog_decode.cu) and K7
(csrc/jpeg_smooth.cu): every integer the kernels read, named and ordered as in their
structures, against the host's layout (data/codec.py: raw_batch's K11 and K12 streams,
K11's records, jpeg_batch's smoothed components); the CCITT state tables against the
T.4 code words; K7's tile-to-component map and its warp's last good iMCU row (the
kernel's way, replayed in ops/plain_image.py) against the plain version on a batch of
mixed shapes, subsamplings and cuts. No GPU needed."""

import os
import re

import numpy as np
import pytest

from ssd_object_detection_tpu_torch.data import codec
from ssd_object_detection_tpu_torch.ops import cuda_image, plain_image
from ssd_object_detection_tpu_torch.tools import make_image_fixtures as fx
from ssd_object_detection_tpu_torch.tools.make_image_fixtures import FIXTURES

CSRC = os.path.join(os.path.dirname(codec.__file__), os.pardir, "csrc")


def _enum(source: str, name: str) -> dict:
    """name -> value of `enum name { ... }` in csrc/`source`."""
    text = open(os.path.join(CSRC, source)).read()
    body = re.search(r"enum " + name + r" \{([^}]*)\}", text).group(1)
    out, value = {}, -1
    for item in body.split(","):
        key, _, given = item.strip().partition("=")
        value = int(given) if given.strip() else value + 1
        out[key.strip()] = value
    return out


def _constant(source: str, name: str) -> int:
    text = open(os.path.join(CSRC, source)).read()
    return int(re.search(r"\b" + name + r" = (\d+)", text).group(1))


def _snake(name: str) -> str:
    """kRowBytes -> ROW_BYTES."""
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name[1:]).upper()


def _bytes(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def test_kernel_structures_are_the_hosts():
    """K11's stream fields (F_*), flavours (FAX_*) and libtiff's states, and K7's component
    fields (S_*) and tile, in the kernels' order, with the widths both sides use."""
    stream = _enum("ccitt_decode.cu", "Stream")
    assert stream.pop("kFaxInts") == codec.FAX_INTS == len(stream)
    assert {_snake(k): v for k, v in stream.items()} == {n[2:]: getattr(codec, n) for n in dir(codec)
                                                         if re.fullmatch(r"F_[A-Z_]+", n)}
    record = _enum("ccitt_decode.cu", "Record")
    assert record.pop("kRecordInts") == codec.FAX_RECORD_INTS == len(record)
    assert {_snake(k): v for k, v in record.items()} == {n[3:]: getattr(codec, n) for n in dir(codec)
                                                         if re.fullmatch(r"FR_[A-Z_0-9]+", n)}
    text = open(os.path.join(CSRC, "ccitt_decode.cu")).read()
    assert "constexpr int kForeign = %d, kNoEol = %d;" % (codec.FAX_FOREIGN, codec.FAX_NOEOL) in text
    sgi = _enum("sgilog_decode.cu", "Stream")
    assert sgi.pop("kSgiInts") == codec.SGI_INTS == len(sgi)
    assert {_snake(k): v for k, v in sgi.items()} == {n[2:]: getattr(codec, n) for n in dir(codec)
                                                      if re.fullmatch(r"G_[A-Z_]+", n)}
    modes = _enum("ccitt_decode.cu", "Mode")
    assert list(modes.values()) == [codec.FAX_RLE, codec.FAX_RLEW, codec.FAX_G3_1D, codec.FAX_G3_2D, codec.FAX_G4,
                                    codec.FAX_THUNDER]
    states = _enum("ccitt_decode.cu", "State")
    assert list(states.values()) == [plain_image.FAX_NULL, plain_image.FAX_PASS, plain_image.FAX_HORIZ,
                                     plain_image.FAX_V0, plain_image.FAX_VR, plain_image.FAX_VL, plain_image.FAX_EXT,
                                     plain_image.FAX_TERMW, plain_image.FAX_TERMB, plain_image.FAX_MAKEUPW,
                                     plain_image.FAX_MAKEUPB, plain_image.FAX_MAKEUP, plain_image.FAX_EOL]
    assert (_constant("ccitt_decode.cu", "kMainBits"), _constant("ccitt_decode.cu", "kWhiteBits"),
            _constant("ccitt_decode.cu", "kBlackBits")) == (plain_image.FAX_MAIN_BITS, plain_image.FAX_WHITE_BITS,
                                                            plain_image.FAX_BLACK_BITS)
    smooth = _enum("jpeg_smooth.cu", "Smooth")
    assert {_snake(k): v for k, v in smooth.items()} == {n[2:]: getattr(codec, n) for n in dir(codec)
                                                         if re.fullmatch(r"S_[A-Z_]+", n)}
    assert _constant("jpeg_smooth.cu", "kSmoothInts") == codec.SMOOTH_INTS == codec.S_DC + 1
    assert (_constant("jpeg_smooth.cu", "kTileRows"), _constant("jpeg_smooth.cu", "kTileCols")) == codec.SMOOTH_TILE
    assert codec.S_PREV - codec.S_BITS == codec.SMOOTHING_COEFS


def test_fax_tables_are_the_t4_codes():
    """Each T.4 code word (terminating and make-up codes of both colours, the extended
    make-ups, the 2-D modes, EOL) leads from its bits, read LSB first, to its state, width
    and run; the codes of a table are prefix-free, and every other entry is FAX_NULL of
    width 0 (libtiff's mkg3states)."""
    tab = plain_image.fax_tables()
    assert tab.size == 128 + 4096 + 8192
    cases = [(0, 7, c, s, p) for c, s, p in (("0001", plain_image.FAX_PASS, 0), ("001", plain_image.FAX_HORIZ, 0),
                                            ("1", plain_image.FAX_V0, 0), ("011", plain_image.FAX_VR, 1),
                                            ("000011", plain_image.FAX_VR, 2), ("0000011", plain_image.FAX_VR, 3),
                                            ("010", plain_image.FAX_VL, 1), ("000010", plain_image.FAX_VL, 2),
                                            ("0000010", plain_image.FAX_VL, 3), ("0000001", plain_image.FAX_EXT, 0),
                                            ("0000000", plain_image.FAX_EOL, 0))]
    for at, bits, term, makeup, ts, ms in ((plain_image.FAX_WHITE_AT, 12, plain_image._WHITE_TERM,
                                            plain_image._WHITE_MAKEUP, plain_image.FAX_TERMW,
                                            plain_image.FAX_MAKEUPW),
                                           (plain_image.FAX_BLACK_AT, 13, plain_image._BLACK_TERM,
                                            plain_image._BLACK_MAKEUP, plain_image.FAX_TERMB,
                                            plain_image.FAX_MAKEUPB)):
        codes = [(c, ts, r) for r, c in enumerate(term)] + [(c, ms, 64 * (k + 1)) for k, c in enumerate(makeup)] + \
            [(c, plain_image.FAX_MAKEUP, 1792 + 64 * k) for k, c in enumerate(plain_image._EXT_MAKEUP)] + \
            [("0" * 11, plain_image.FAX_EOL, 0)]
        cases += [(at, bits, c, s, p) for c, s, p in codes]
        words = [c for c, _, _ in codes]
        assert not any(a != b and b.startswith(a) for a in words for b in words)
        covered = sum(1 << (bits - len(c)) for c in words)
        nulls = int(((tab[at:at + (1 << bits)] & 15) == plain_image.FAX_NULL).sum())
        assert covered + nulls == 1 << bits and (tab[at:at + (1 << bits)][tab[at:at + (1 << bits)] == 0]).size == nulls
    for at, bits, code, state, param in cases:
        for fill in (0, (1 << (bits - len(code))) - 1):  # the bits after the code: any
            e = int(tab[at + (int(code[::-1], 2) | fill << len(code))])
            assert (e & 15, (e >> 4) & 15, e >> 8) == (state, len(code), param), code


def test_fax_stream_plan():
    """K11's streams of a mixed decode call (CCITT strips and tiles of several codes,
    ThunderScan, the Group 3 file of a strip without EOLs then strips with them, an
    old-style LZW TIFF, a GIF and a BMP), integer by integer: each chunk's coded bytes in
    the host bytes from a 16-byte boundary (the kernel stages them with cp.async), its
    flavour and geometry, its output after K9's, back to back, the chunk table pointing
    at it, its own run scratch (codec.fax_area ints, back to back), and its image's first
    stream and chunks."""
    names = ["tiff_ccitt_g4_strips_37x23.tif", "tiff_ccitt_rle_tiled_37x23.tif", "tiff_thunderscan_37x23.tif",
             "tiff_ccitt_noeol_then_eol_37x23.tif", "tiff_ccitt_rlew_37x23.tif", "tiff_ccitt_g3_2d_37x23.tif",
             "tiff_lzw_old_gray_37x23.tif", "tiff_ccitt_g3fill_37x23.tif"]
    tiffs = [codec.parse_tiff(_bytes(n)) for n in names]
    gif = codec.parse_gif(_bytes("gif_cv2_37x23.gif"))
    bmp = codec.parse_raw(_bytes("bmp_24_37x23.bmp"), "bmp")
    batch = codec.raw_batch([gif], tiffs, [bmp])
    streams, chunks = batch.fax_streams, batch.chunks
    modes = {2: codec.FAX_RLE, 32771: codec.FAX_RLEW, 4: codec.FAX_G4, 32809: codec.FAX_THUNDER}
    k, j, out, runs, most = 0, 0, batch.fax_out, 0, 0
    assert batch.fax_out == batch.lzw_at + batch.lzw.total_indices
    for name, t in zip(names, tiffs):
        data = _bytes(name)
        order, big, tags = codec._tiff_directory(data)
        comp = codec._tiff_values(data, order, big, tags[259])[0]
        t4 = codec._tiff_values(data, order, big, tags[292])[0] if 292 in tags else 0
        first = j
        for c in t.chunks:
            if comp == 5:
                assert c.fax < 0 and c.lzw == codec.LZW_TIFF_OLD
                k += 1
                continue
            s = streams[j]
            want_mode = modes.get(comp, codec.FAX_G3_2D if t4 & 1 else codec.FAX_G3_1D)
            assert (s[codec.F_MODE], s[codec.F_ROWS], s[codec.F_WIDTH], s[codec.F_ROW_BYTES]) == (
                want_mode, c.rows, c.width, c.row_bytes), name
            assert bytes(batch.host[s[codec.F_SRC]:s[codec.F_SRC] + s[codec.F_BYTES]]) == c.raw
            assert s[codec.F_SRC] % 16 == 0
            assert s[codec.F_OUT] == out == chunks[k, codec.C_SRC] and chunks[k, codec.C_STREAM] == -1
            assert s[codec.F_ODD] == 0  # bytes of a body, not a file's
            assert (s[codec.F_FIRST], s[codec.F_CHUNKS]) == (first, len(t.chunks))
            assert s[codec.F_RUNS] == runs
            if want_mode != codec.FAX_THUNDER:
                area = codec.fax_area(want_mode, c.width)
                assert area == codec.fax_span(want_mode, c.width) + 2 * codec.fax_row_ints(c.width)
                assert area % 4 == 0 and codec.fax_row_ints(c.width) * 4 >= c.row_bytes + 16
                runs, most = runs + area, max(most, area)
            out += c.size
            j, k = j + 1, k + 1
    assert j == batch.faxes and out == batch.total and (runs, most) == (batch.fax_runs, batch.fax_runs_max)
    assert batch.fax_bytes == out - batch.fax_out
    # a file's bytes: a chunk's first byte's parity is its offset's (RLEW's word alignment reads it)
    data = _bytes("tiff_ccitt_rlew_37x23.tif")
    order, big, tags = codec._tiff_directory(data)
    offsets = codec._tiff_values(data, order, big, tags[273])
    assert [c.odd for c in codec.parse_tiff(data, from_file=True).chunks] == [o & 1 for o in offsets]


def _smooth_batch():
    """A batch of progressive JPEGs libjpeg smooths: every sampling cut in several scans,
    the 640x480 fixture cut in its second, fifth and ninth scans and after its DC scan,
    and the smoothed fixtures (cut short, restart intervals, repeated scans)."""
    blobs = []
    for s in ("444", "422", "420", "440", "411"):
        blob = _bytes(f"progressive_{s}_83x61.jpg")
        for scan in (1, 3, 5):
            start, end = fx.entropy_span(blob, scan)
            blobs.append(blob[:start + (end - start) // 3] + b"\xff\xd9")
    big = _bytes("coco_640x480_progressive.jpg")
    for scan in (1, 4, 8):
        start, end = fx.entropy_span(big, scan)
        blobs.append(big[:start + (end - start) // 2] + b"\xff\xd9")
    blobs.append(big[:fx.entropy_span(big, 0)[1]] + b"\xff\xd9")
    blobs += [_bytes(n) for n in ("progressive_cut_eoi_83x61.jpg", "progressive_dc_only_83x61.jpg",
                                  "progressive_incomplete_83x61.jpg", "progressive_restart_refine_cut_83x61.jpg")]
    images = [codec.parse_jpeg(b) for b in blobs]
    return codec.jpeg_batch([im for im in images if im.smooth])


def test_smooth_plan_equals_plain():
    """Every integer of K7's component rows against the images' own geometry and coef
    bits; the kernel's tile-to-component map (its first warp's ballots, replayed) covers
    every real block of every component once, in the kernel's order; its warp's last good
    iMCU row equals plain_image.last_good_row for each component; the DCs copied aside
    are exactly those of the components whose own DCs may change, each from a
    SMOOTH_THREADS boundary."""
    batch = _smooth_batch()
    smooth = batch.smooth.numpy()
    assert smooth.shape[0] >= 30 and batch.smooth_dc > 0 and (smooth[:, codec.S_DC] < 0).any()
    comps = batch.comps.numpy()
    tile, dc = 0, 0
    for row in smooth:
        first, bw, bh = (int(v) for v in row[[codec.S_FIRST, codec.S_BW, codec.S_BH]])
        ci = int(row[codec.S_QTABLE])
        assert tuple(comps[ci, :3]) == (first, bw, bh)
        assert row[codec.S_WB] <= bw and row[codec.S_HB] <= bh and row[codec.S_V] >= 1
        assert row[codec.S_TILE] == tile
        assert row[codec.S_TILES_X] == -(-row[codec.S_WB] // codec.SMOOTH_TILE[1])
        tile += row[codec.S_TILES_X] * -(-row[codec.S_HB] // codec.SMOOTH_TILE[0])
        bits = row[codec.S_BITS:codec.S_BITS + 10], row[codec.S_PREV:codec.S_PREV + 10]
        if codec.smooth_changes_dc(bits[0]) or codec.smooth_changes_dc(bits[1]):
            assert row[codec.S_DC] == dc and dc % codec.SMOOTH_THREADS == 0
            dc += -(-bw * bh // codec.SMOOTH_THREADS) * codec.SMOOTH_THREADS
        else:
            assert row[codec.S_DC] == -1
    assert (batch.smooth_tiles, batch.smooth_dc) == (tile, dc)
    plan = plain_image.smooth_plan(smooth, batch.smooth_tiles)
    seen = np.zeros(batch.total_blocks, np.int64)
    for comp, by0, bx0 in plan.tolist():
        first, bw, wb, hb = (int(smooth[comp, f]) for f in (codec.S_FIRST, codec.S_BW, codec.S_WB, codec.S_HB))
        ys = np.arange(by0, min(by0 + codec.SMOOTH_TILE[0], hb))
        xs = np.arange(bx0, min(bx0 + codec.SMOOTH_TILE[1], wb))
        np.add.at(seen, (first + ys[:, None] * bw + xs[None, :]).reshape(-1), 1)
    for row in smooth:
        first, bw, wb, hb = (int(row[f]) for f in (codec.S_FIRST, codec.S_BW, codec.S_WB, codec.S_HB))
        real = (first + np.arange(hb)[:, None] * bw + np.arange(wb)[None, :]).reshape(-1)
        assert (seen[real] == 1).all()
    assert seen.sum() == sum(int(r[codec.S_WB] * r[codec.S_HB]) for r in smooth)
    assert (np.diff(plan[:, 0]) >= 0).all()
    coef, status, stops = cuda_image.entropy_outputs(batch)
    for step in range(batch.steps):
        cuda_image.entropy_decode(batch, (coef, status, stops), step)
        cuda_image.progressive_entropy(batch, (coef, status, stops), step)
    seg, jobs, st = batch.segments.numpy(), batch.jobs.numpy(), stops.numpy()
    goods = set()
    for row in smooth:
        last, rows = int(row[codec.S_JOB] + row[codec.S_JOBS] - 1), int(row[codec.S_IMCU_ROWS])
        good = plain_image.last_good_row(seg, jobs, st, last, rows)
        assert plain_image.last_good_row_warp(seg, jobs, st, last, rows) == good
        goods.add(good == rows - 1)
    assert goods == {True, False}  # some images cut short of their last row, some not


@pytest.mark.parametrize("tiles", [1, 31, 32, 33, 70])
def test_smooth_plan_over_many_components(tiles):
    """The ballots past 32 component rows: a table of 70 one-tile components, the map of
    the first `tiles` CTAs row by row."""
    smooth = np.zeros((70, codec.SMOOTH_INTS), np.int64)
    smooth[:, codec.S_TILE] = np.arange(70)
    smooth[:, codec.S_TILES_X] = 1
    plan = plain_image.smooth_plan(smooth, tiles)
    np.testing.assert_array_equal(plan[:, 0], np.arange(tiles))
    assert not plan[:, 1:].any()


def test_sgilog_stream_plan():
    """K12's streams of a mixed decode call (LogL and LogLuv strips and tiles, a cut
    strip, SGILog24, a CCITT TIFF and a BMP), integer by integer: each SGILog chunk's coded
    bytes in the host bytes, its word, rows and width, its words after K11's output, back
    to back, the chunk table pointing at it; SGILog24's chunks decoded on the host (whole
    rows, zero past them) and K12's output zero before it writes; the call's SGILog tables
    once, from an even int (they hold doubles)."""
    names = ["tiff_sgilog_logl_37x23.tif", "tiff_ccitt_g4_strips_37x23.tif", "tiff_sgilog_logluv_tiles_37x23.tif",
             "tiff_sgilog24_logluv_cut_37x23.tif", "tiff_lab16_37x23.tif", "tiff_sgilog_logluv_cut_37x23.tif"]
    tiffs = [codec.parse_tiff(_bytes(n)) for n in names]
    bmp = codec.parse_raw(_bytes("bmp_24_37x23.bmp"), "bmp")
    batch = codec.raw_batch([], tiffs, [bmp])
    streams, chunks = batch.sgi_streams, batch.chunks
    assert batch.sgi_out == batch.fax_out + batch.fax_bytes and batch.total == batch.sgi_out + batch.sgi_bytes
    j, k, out = 0, 0, batch.sgi_out
    tables = set()
    for name, t, row in zip(names, tiffs, batch.image_rows):
        if t.tables is not None:
            tables.add(int(row[codec.R_TABLE]))
        for c in t.chunks:
            if c.sgi:
                s = streams[j]
                assert name.startswith("tiff_sgilog_") and c.sgi == (2 if "logl_" in name else 4)
                assert (s[codec.G_WORD], s[codec.G_ROWS], s[codec.G_WIDTH]) == (c.sgi, c.rows, c.width)
                assert bytes(batch.host[s[codec.G_SRC]:s[codec.G_SRC] + s[codec.G_BYTES]]) == c.raw
                assert s[codec.G_OUT] == out == chunks[k, codec.C_SRC] and c.row_bytes == c.width * c.sgi
                out += c.size
                j += 1
            elif name.startswith("tiff_sgilog24"):
                whole = min(c.rows, len(c.raw) // c.row_bytes) * c.row_bytes
                assert c.decoded == c.raw[:whole] + bytes(c.size - whole) and c.row_bytes == 3 * c.width
            k += 1
    assert j == batch.sgis and out == batch.total
    sgi_tables = [int(r[codec.R_TABLE]) for n, r in zip(names, batch.image_rows) if n.startswith("tiff_sgilog")]
    assert len(set(sgi_tables)) == 1 and sgi_tables[0] % 2 == 0 and len(tables) == 2
    at = sgi_tables[0]
    np.testing.assert_array_equal(batch.desc[at:at + codec.SGILOG_TABLE_INTS], codec.sgilog_tables())
    buf = batch.host.copy()
    buf.resize(batch.total, refcheck=False)
    assert not buf[batch.sgi_out:].any()


def test_raw_formats_are_the_kernels():
    """K8's format enum names SGILog's three formats at the host's numbers."""
    text = open(os.path.join(CSRC, "raw_image.cu")).read()
    body = re.search(r"enum \{ kPal1([^}]*)\}", text).group(0)
    names = [x.strip() for x in body[body.index("{") + 1:body.index("}")].split(",")]
    assert names.index("kTiffLogL") == codec.TIFF_LOGL_FORMAT
    assert names.index("kTiffLogLuv") == codec.TIFF_LOGLUV_FORMAT
    assert names.index("kTiffLogLuv24") == codec.TIFF_LOGLUV24_FORMAT
    assert "constexpr int kY16 = 32768, kY10 = 1024, kUvRows = %d, kUvDivs = %d;" % (
        len(codec._SGILOG_UV_ROW), codec.SGILOG_UV_NDIVS) in text
