"""The schedules of K5's redesign and of K9, replayed in numpy on the CPU where no card
runs them, against the plain versions the kernels are held to on the card.

  - ops/png_wavefront_model.py: K5's row wavefront (a thread a row, a pixel a step, bands
    of rows, Adam7's passes and a batch's pass table, the diagonal scratch its loads and
    stores coalesce on, laid out as the host lays it out) equals ops/plain_image.py::
    png_unfilter on every PNG fixture, at the kernel's band height and at short bands
    that cut every pass;
  - ops/gif_lzw_model.py: K9's windows (a code a thread: closed-form bit positions, the
    first Clear, EOI or fault by a block min, pointer jumping over the window's new table
    entries, binary lifting, a scan of the lengths, equal pixel ranges walked backwards)
    equal ops/plain_image.py::lzw_decode on every GIF fixture, indices and status, at the
    kernel's window of 4,096 codes, at one shorter than a segment and at one shorter
    than a warp;
  - ops/fax_schedule_model.py: K11's schedule (every CCITT chunk from the state libtiff
    gives a chunk, what its guess relied on, the repair from the first chunk whose guess
    failed, the fill warps' rows) equals ops/plain_image.py::ccitt_decode on every CCITT
    and ThunderScan fixture, on 240 seeded random directories and on the cases built so
    that a guess fails.

Tolerance: none. Inputs: the committed fixtures.
"""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from ssd_object_detection_tpu_torch.data import codec
from ssd_object_detection_tpu_torch.ops import fax_schedule_model, gif_lzw_model, plain_image, png_wavefront_model
from ssd_object_detection_tpu_torch.tools.make_image_fixtures import FIXTURES

RECORD = json.loads((Path(FIXTURES) / "digests.json").read_text())
PNGS = sorted(n for n in RECORD["images"] if n.endswith(".png"))


def _parses(name: str) -> bool:
    try:
        codec.parse_gif((Path(FIXTURES) / name).read_bytes())
        return True
    except ValueError:  # refused before its LZW data is read
        return False


# every GIF fixture whose LZW data is read, those cv2 returns None for among them
GIFS = sorted(n for n in list(RECORD["images"]) + list(RECORD["invalid"]) if n.endswith(".gif") and _parses(n))


def _parsed_gifs(names):
    return [codec.parse_gif((Path(FIXTURES) / n).read_bytes()) for n in names]


@pytest.mark.parametrize("rows", [png_wavefront_model.ROWS, 7])
@pytest.mark.parametrize("name", PNGS)
def test_png_wavefront_equals_plain_unfilter(name, rows):
    batch = codec.png_batch([codec.parse_png((Path(FIXTURES) / name).read_bytes())])
    inflated, passes = batch.inflated.numpy(), batch.passes.numpy()
    np.testing.assert_array_equal(png_wavefront_model.unfilter(inflated, passes, rows),
                                  plain_image.png_unfilter(inflated, passes))


def test_png_wavefront_over_a_batch_pass_table():
    """Every PNG fixture in one pass table, as one K5 launch takes them, at bands of 3
    rows; and the batched plain decode equals each image decoded alone."""
    pngs = [codec.parse_png((Path(FIXTURES) / n).read_bytes()) for n in PNGS]
    batch = codec.png_batch(pngs)
    inflated, passes = batch.inflated.numpy(), batch.passes.numpy()
    assert len(passes) == sum(len(p.passes()) for p in pngs)
    offsets = png_wavefront_model.scratch_offsets(passes)  # the kernels' scratch, as the host lays it out
    np.testing.assert_array_equal(offsets[:-1], passes[:, 10])
    assert offsets[-1] == batch.diag_elements
    np.testing.assert_array_equal(png_wavefront_model.unfilter(inflated, passes, 3),
                                  plain_image.png_unfilter(inflated, passes))
    together = plain_image.png_decode(inflated, passes, batch.images.numpy(), batch.palettes.numpy(),
                                      batch.total_pixels)
    at = 0
    for png, (h, w) in zip(pngs, batch.out_shapes):
        alone = codec.png_batch([png])
        want = plain_image.png_decode(alone.inflated.numpy(), alone.passes.numpy(), alone.images.numpy(),
                                      alone.palettes.numpy(), alone.total_pixels)
        np.testing.assert_array_equal(together[at:at + h * w * 3], want)
        at += h * w * 3


def test_png_wavefront_past_a_band():
    """A PNG taller than the kernel's band (RGB, 16-bit RGBA, Adam7) at the kernel's band
    height: each band's first row takes the row above from the band before."""
    from ssd_object_detection_tpu_torch.tools import make_image_fixtures as fx

    rng = np.random.default_rng(7)
    pngs = [codec.parse_png(b) for b in (fx.png(rng.integers(0, 256, (600, 5, 3)), 2, 8),
                                         fx.png(rng.integers(0, 65536, (530, 3, 4)), 6, 16),
                                         fx.png(rng.integers(0, 256, (1040, 3, 3)), 2, 8, True))]
    batch = codec.png_batch(pngs)
    inflated, passes = batch.inflated.numpy(), batch.passes.numpy()
    assert passes[:, 1].max() > png_wavefront_model.ROWS
    np.testing.assert_array_equal(png_wavefront_model.unfilter(inflated, passes),
                                  plain_image.png_unfilter(inflated, passes))


def _assert_model_equals_plain(gifs, window):
    batch = codec.gif_batch(gifs)
    data, table = batch.data.numpy(), batch.gifs.numpy()
    want, want_status = plain_image.lzw_decode(data, table, batch.total_indices)
    got, status, stats = gif_lzw_model.decode(data, table, batch.total_indices, window)
    np.testing.assert_array_equal(status, want_status)
    for row, st in zip(table.tolist(), status.tolist()):
        if st == codec.GIF_OK:  # a failed frame's indices are unspecified
            span = slice(row[6], row[6] + row[3] * row[4])
            np.testing.assert_array_equal(got[span], want[span])
    return status, stats


WINDOWS = [gif_lzw_model.WINDOW, 100, 7]  # the kernel's; shorter than a segment; than a warp's codes


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("name", GIFS)
def test_gif_windows_equal_plain_lzw(name, window):
    status, stats = _assert_model_equals_plain(_parsed_gifs([name]), window)
    assert (status[0] == codec.GIF_OK) == (name in RECORD["images"])
    assert stats[0].windows >= stats[0].segments


@pytest.mark.parametrize("window", WINDOWS)
def test_gif_windows_over_a_batch(window):
    """Every GIF fixture in one table, as one K9 launch takes them, the failing frames
    among them."""
    status, _ = _assert_model_equals_plain(_parsed_gifs(GIFS), window)
    assert sorted(set(status.tolist())) == [codec.GIF_OK, codec.GIF_LZW_FAILED, codec.GIF_OVERFLOW,
                                            codec.GIF_BAD_INDEX]


def _serial_codes(gif) -> list:
    """The codes of a frame as a serial reader meets them, to the end of its data."""
    clear = 1 << gif.min_code_size
    codes, bits, k = [], 0, 0
    while True:
        _, w = gif_lzw_model.step_bits(np.array([k]), gif.min_code_size)
        if bits + int(w[0]) > 8 * len(gif.lzw):
            return codes
        codes.append(gif_lzw_model.read_code(gif.lzw, bits, int(w[0])))
        bits += int(w[0])
        k = 0 if codes[-1] in (clear, clear + 1) else k + 1


@pytest.mark.parametrize("name", ["gif_solid_640x480.gif", "gif_min_code_2_clear_often_100x80.gif",
                                  "gif_clear_often_100x80.gif", "gif_full_table_no_clear_100x80.gif"])
def test_gif_window_counters(name):
    """The counters the kernel reports: a segment more for each Clear or EOI, every code
    read once; the solid 640x480 GIF's strings (up to 783 pixels) take ten lifting
    levels, nine of them built."""
    gif, = _parsed_gifs([name])
    _, stats = _assert_model_equals_plain([gif], gif_lzw_model.WINDOW)
    codes = _serial_codes(gif)
    clear = 1 << gif.min_code_size
    assert stats[0].codes == len(codes)
    assert stats[0].segments == 1 + sum(c in (clear, clear + 1) for c in codes)
    if name == "gif_solid_640x480.gif":
        assert stats[0].levels == 9 and len(codes) == 786  # Clear, 783 strings, EOI, a pad code


# ---------------------------------------------------------------------------- K9's TIFF flavour
def _tiff_lzw_batch():
    """Every TIFF fixture's LZW chunks as K9's TIFF streams (the stopping rules' fixtures
    among them), with the GIF fixtures before them in one table."""
    names = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".tif") and "invalid" not in n
                   and "refused" not in n)
    tiffs = [codec.parse_tiff((Path(FIXTURES) / n).read_bytes()) for n in names]
    return codec.raw_batch(_parsed_gifs(GIFS[:3]), tiffs, []).lzw, tiffs


@pytest.mark.parametrize("window", WINDOWS)
def test_tiff_lzw_windows_equal_plain(window):
    """The model's TIFF flavour (MSB-first codes, early change, EOI ends a chunk, the
    string that fills it cut) equals plain_image.lzw_tiff on every TIFF fixture's LZW
    chunks, statuses and bytes, at each window size."""
    batch, tiff = _tiff_lzw_batch()
    data, table = batch.data.numpy(), batch.gifs.numpy()
    want, want_status = plain_image.lzw_decode(data, table, batch.total_indices)
    got, status, _ = gif_lzw_model.decode(data, table, batch.total_indices, window)
    np.testing.assert_array_equal(status, want_status)
    gifs = int((table[:, 16] == codec.LZW_GIF).sum())
    assert set(status[gifs:].tolist()) == {codec.GIF_OK, codec.GIF_LZW_FAILED}
    np.testing.assert_array_equal(got[batch.frame_indices:], want[batch.frame_indices:])


# ---------------------------------------------------------------------------- the fused K2 + K3
TILE_FIXTURES = ["seam_w17_420.jpg", "seam_h9_422.jpg", "seam_w9_440.jpg", "seam_w33_411.jpg", "seam_w17_410.jpg",
                 "sampling_3x1_83x61.jpg", "sampling_1x4_1x2_83x61.jpg", "sampling_4x1_2x1_83x61.jpg",
                 "cmyk_83x61.jpg", "ycck_83x61.jpg", "progressive_420_83x61.jpg", "progressive_incomplete_83x61.jpg",
                 "corrupt_restart_cut_eoi_83x61.jpg", "progressive_cut_eoi_83x61.jpg", "progressive_gray_61x83.jpg"] + [f"exif{o}_21x14.jpg" for o in range(1, 9)]


@pytest.fixture(scope="module")
def tile_inputs():
    from ssd_object_detection_tpu_torch.ops import cuda_image

    names = [n for n in TILE_FIXTURES if (Path(FIXTURES) / n).exists()]
    images = [codec.parse_jpeg((Path(FIXTURES) / n).read_bytes()) for n in names]
    batch = codec.jpeg_batch(images)
    coef, _ = cuda_image.decode_entropy(batch)
    planes = plain_image.idct(coef.numpy(), batch.qtables.numpy(), batch.comps.numpy())
    return images, coef.numpy(), plain_image.color(planes, batch.images.numpy(), batch.total_bytes)


@pytest.mark.parametrize("tile_hw", [(codec.JPEG_TILE_H, codec.JPEG_TILE_W), (8, 8), (16, 24), (40, 56)])
def test_tile_walk_equals_plain_composition(tile_inputs, tile_hw):
    """ops/jpeg_tile_model.py's replay of the fused kernel equals plain color(idct(...)) at
    several tile shapes (every sampling factor 1-4, each orientation, gray, CMYK, YCCK,
    progressive, smoothed and corrupt JPEGs, widths not a multiple of the tile), each
    output byte written once and every sample read inside its tile's planes; at the
    kernel's shape a tile holds at most JPEG_POOL_BLOCKS blocks."""
    from ssd_object_detection_tpu_torch.ops import jpeg_tile_model

    images, coef, want = tile_inputs
    batch = codec.jpeg_batch(images)
    tiles = jpeg_tile_model.tiles_at(images, tile_hw)
    if tile_hw == (codec.JPEG_TILE_H, codec.JPEG_TILE_W):
        np.testing.assert_array_equal(tiles, batch.tiles.numpy())
    got, writes, most = jpeg_tile_model.decode(coef, batch, tiles)
    np.testing.assert_array_equal(got, want)
    assert writes.min() == 1 and writes.max() == 1
    assert most <= codec.JPEG_POOL_BLOCKS or tile_hw != (codec.JPEG_TILE_H, codec.JPEG_TILE_W)


def test_a_tile_the_fused_kernel_cannot_hold_is_refused(tile_inputs):
    """jpeg_batch's tiles are at most JPEG_TILE_H x JPEG_TILE_W pixels; a batch whose tile
    table holds a wider tile (32 x 256 pixels: a gray JPEG's would fit the block pool, but
    its RGB is twice the kernel's stage) is refused on its way to a device."""
    from ssd_object_detection_tpu_torch.ops import jpeg_tile_model

    images = tile_inputs[0]
    batch = codec.jpeg_batch(images)
    assert int(batch.tiles[:, 3].max()) <= codec.JPEG_TILE_H and int(batch.tiles[:, 4].max()) <= codec.JPEG_TILE_W
    wide = dataclasses.replace(batch, tiles=torch.from_numpy(jpeg_tile_model.tiles_at(images, (32, 256))))
    with pytest.raises(ValueError, match="the fused kernel holds at most"):
        wide.to(torch.device("cpu"))


# ---------------------------------------------------------------------------- K11's schedule
def _fax_schedule(tiffs):
    """(plain_image.ccitt_decode's output, the replay's output, its report) on one batch."""
    batch = codec.raw_batch([], tiffs, [])
    want = batch.host.copy()
    want.resize(batch.total, refcheck=False)
    got = want.copy()
    plain_image.ccitt_decode(want, batch.fax_streams, want)
    report = fax_schedule_model.ccitt_schedule(got, batch.fax_streams, got)
    return want[batch.fax_out:], got[batch.fax_out:], report


FAX_FIXTURES = sorted(n for n in list(RECORD["images"]) + list(RECORD["invalid"])
                      if n.startswith(("tiff_ccitt_", "tiff_thunderscan_")) or n == "tiff_group4_37x23.tif")


@pytest.mark.parametrize("name", FAX_FIXTURES)
def test_fax_schedule_equals_plain_on_every_fixture(name):
    """Each CCITT and ThunderScan fixture through K11's schedule, bit-equal to the plain
    decoder; the pages and sound files need no repair."""
    want, got, report = _fax_schedule([codec.parse_tiff((Path(FIXTURES) / name).read_bytes())])
    np.testing.assert_array_equal(got, want)
    if "page" in name or name in ("tiff_ccitt_g4_strips_37x23.tif", "tiff_ccitt_g3_2d_strips_37x23.tif",
                                  "tiff_ccitt_mh_strips_37x23.tif", "tiff_ccitt_rlew_37x23.tif"):
        assert all(r["repair_from"] is None for r in report.values()), report


def test_fax_schedule_repairs_where_a_guess_fails():
    """The cases built so that a chunk's guess fails: a Group 3 strip without EOLs before
    strips with them (it leaves FAXMODE_NOEOL on: the repair starts at the second strip)
    and a Group 4 strip whose first row walks its reference line past the white line
    (a run array entry it did not write decides its row: the repair starts there); both
    in one call with a page that needs none, each still equal to the plain decoder."""
    names = ["tiff_ccitt_noeol_then_eol_37x23.tif", "tiff_ccitt_g4_page_1728x2200.tif",
             "tiff_ccitt_g4_past_white_37x23.tif"]
    want, got, report = _fax_schedule([codec.parse_tiff((Path(FIXTURES) / n).read_bytes()) for n in names])
    np.testing.assert_array_equal(got, want)
    reports = list(report.values())
    assert [r["repair_from"] for r in reports] == [1, None, 1]
    assert reports[0]["noeol"] == [0] and reports[0]["foreign"] == []
    assert reports[2]["foreign"] == [1] and reports[2]["noeol"] == []


@pytest.mark.parametrize("seed", range(4))
def test_fax_schedule_on_random_directories(seed):
    """The 240 seeded random CCITT, ThunderScan and old-style LZW directories of
    tests/test_torch_image_formats.py (cut chunks, flipped bits), 60 a seed, through K11's
    schedule: bit-equal to the plain decoder, and at least one repair among them."""
    from tests.test_torch_image_formats import _random_fax_tiff

    rng = np.random.default_rng(2100 + seed)
    tiffs = []
    for _ in range(60):
        try:
            tiffs.append(codec.parse_tiff(_random_fax_tiff(rng)))
        except ValueError:
            continue
    want, got, report = _fax_schedule(tiffs)
    np.testing.assert_array_equal(got, want)
    assert any(r["repair_from"] is not None for r in report.values())


def test_kernel_fill_equals_fill_runs():
    """K11's fill (a row of words, stored a 16-byte unit at a time at each phase of the
    buffer's grid) equals plain_image.fill_runs on seeded rows of runs: odd counts, runs
    of zero, rows whose runs sum past the width (cut and written back as fill_runs does)
    and rows that end short of it."""
    rng = np.random.default_rng(2500)
    for i in range(300):
        lastx = int(rng.integers(1, 300))
        m = int(rng.integers(1, 40))
        runs = rng.integers(0, 3 * lastx // max(m, 1) + 2, m).tolist() + [0] * 4
        if i % 7 == 0:
            runs[0] = 2 ** 32 - 5  # a wrapped run
        row_bytes = -(-lastx // 8)
        want_runs, got_runs = list(runs), list(runs)
        want = np.zeros(row_bytes, np.uint8)
        plain_image.fill_runs(want, want_runs, 0, m, lastx)
        got = np.full(row_bytes, 0xA5, np.uint8)  # the kernel stores every byte
        fax_schedule_model.kernel_fill(got, got_runs, 0, m, lastx, phase=i % 16)
        np.testing.assert_array_equal(got, want, err_msg=str(i))
        assert got_runs == want_runs, i
