"""The image kernels (csrc/jpeg_decode.cu, csrc/jpeg_progressive.cu, csrc/jpeg_smooth.cu,
csrc/resize.cu, csrc/png_unfilter.cu, csrc/raw_image.cu, csrc/gif_lzw.cu,
csrc/tiff_assemble.cu, csrc/ccitt_decode.cu, csrc/sgilog_decode.cu) on the card, against
their plain versions and cv2's recorded digests.

These tests need an NVIDIA GPU and skip elsewhere. The file imports no JAX and no cv2,
so the machine with the card runs it as
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_image.py`.
Tolerance: none (every kernel is integer, or float with the plain version's operation
order and no fused multiply-add but the ones it writes).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ssd_object_detection_tpu_torch.data import codec
from ssd_object_detection_tpu_torch.ops import cuda_image, fax_schedule_model, jpeg_sync_model, plain_image
from ssd_object_detection_tpu_torch.tools.make_image_fixtures import FIXTURES, REFUSED, sha

pytestmark = pytest.mark.cuda
RECORD = json.loads((Path(FIXTURES) / "digests.json").read_text())
DIGESTS = RECORD["images"]
DECODABLE = sorted(n for n, e in DIGESTS.items() if "refused" not in e)
PNGS = [n for n in DECODABLE if n.endswith(".png")]
GIFS = [n for n in DECODABLE if n.endswith(".gif")]
TIFFS = [n for n in DECODABLE if n.endswith(".tif")]


@pytest.fixture
def cuda_device():
    """The card; decided inside the fixture, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bytes(name):
    return (Path(FIXTURES) / name).read_bytes()


def test_jpeg_kernels_equal_plain_stage_by_stage(cuda_device):
    """K1, K6, K7 and the fused K2 + K3 on one batch of every JPEG fixture (sequential,
    progressive, smoothed and corrupt, every sampling, colour space and orientation),
    each fed the same inputs as its plain version."""
    batch = codec.jpeg_batch([codec.parse_jpeg(_bytes(n)) for n in DECODABLE if n.endswith(".jpg")])
    gpu = batch.to(cuda_device)
    sync = torch.zeros((batch.segments.shape[0], 2), dtype=torch.int32, device=cuda_device)
    out, out_p = cuda_image.entropy_outputs(gpu), cuda_image.entropy_outputs(batch)
    for step in range(batch.steps):
        cuda_image.entropy_decode(gpu, out, step, sync)
        cuda_image.entropy_decode(batch, out_p, step)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(out, out_p)), f"K1, step {step}"
        cuda_image.progressive_entropy(gpu, out, step)
        cuda_image.progressive_entropy(batch, out_p, step)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(out, out_p)), f"K6, step {step}"
    # the rounds and the serially repaired subsequences of each segment: the model's
    _, _, _, sync_model = jpeg_sync_model.decode(batch.data.numpy(), batch.segments.numpy(), batch.jobs.numpy(),
                                                 batch.tables.numpy(), batch.total_blocks, codec.SUBSEQ_BITS,
                                                 batch.steps)
    np.testing.assert_array_equal(sync.cpu().numpy(), sync_model)
    assert batch.smooth.shape[0] > 0
    before = cuda_image.block_smooth.launches
    cuda_image.block_smooth(gpu, out[0], out[2])
    cuda_image.block_smooth(batch, out_p[0], out_p[2])
    assert cuda_image.block_smooth.launches == before + 1 + int(batch.smooth_dc > 0)
    assert torch.equal(out[0].cpu(), out_p[0])
    before = cuda_image.idct_color.launches
    rgb = cuda_image.idct_color(out[0], gpu)
    assert cuda_image.idct_color.launches == before + 1
    assert torch.equal(rgb.cpu(), cuda_image.idct_color(out_p[0], batch))


def test_fused_kernel_on_32_large_jpegs(cuda_device):
    """The fused K2 + K3 on 32 640x480 4:2:0 JPEGs and the 500x333 CMYK one in one launch
    (the timing batch of chip_smoke.py's 5c), equal to plain_image.color(idct(...))."""
    blobs = [_bytes("coco_640x480_420.jpg")] * 32 + [_bytes("coco_500x333_cmyk.jpg"), _bytes("coco_480x640_exif6.jpg")]
    batch = codec.jpeg_batch([codec.parse_jpeg(b) for b in blobs])
    coef, _ = cuda_image.decode_entropy(batch.to(cuda_device))
    got = cuda_image.idct_color(coef, batch.to(cuda_device))
    assert torch.equal(got.cpu(), cuda_image.idct_color(coef.cpu(), batch))


@pytest.mark.parametrize("name", ["coco_640x480_420.jpg", "coco_612x612_restart.jpg", "seam_w1_420.jpg"])
def test_entropy_kernel_on_one_image(cuda_device, name):
    """K1 on one image (the HTTP case): one block a segment, the coefficients equal the
    plain decode's."""
    batch = codec.jpeg_batch([codec.parse_jpeg(_bytes(name))])
    before = cuda_image.entropy_decode.launches
    got = cuda_image.entropy_decode(batch.to(cuda_device))
    assert cuda_image.entropy_decode.launches == before + 1
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, cuda_image.entropy_decode(batch)))


@pytest.mark.parametrize("fault", ["data_ends_early", "invalid_code"])
def test_entropy_kernel_reports_faults_as_plain(cuda_device, fault):
    """Corrupt data decodes as libjpeg decodes it, on the card as in the plain version:
    the same coefficients, warning counts (1 where the data ran out, one a code no table
    has) and stops."""
    data = _bytes("coco_500x333_444.jpg")
    sos = data.index(b"\xff\xda")
    cut = sos + (len(data) - sos) // 2
    data = data[:cut] + (b"\xff\xd9" if fault == "data_ends_early" else b"\xff\x00" * 12 + data[cut + 24:])
    batch = codec.jpeg_batch([codec.parse_jpeg(data)])
    got = cuda_image.entropy_decode(batch.to(cuda_device))
    want = cuda_image.entropy_decode(batch)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    assert int(want[1][0]) >= 1


def test_refinement_kernel_by_round(cuda_device):
    """K6 on 32 of the 640x480 progressive fixture and on the restart-marked one: one
    launch a round, equal to the plain version after every round's scans."""
    blobs = [_bytes("coco_640x480_progressive.jpg")] * 2 + [_bytes("progressive_restart_83x61.jpg")]
    batch = codec.jpeg_batch([codec.parse_jpeg(b) for b in blobs])
    out, out_p = cuda_image.entropy_outputs(batch.to(cuda_device)), cuda_image.entropy_outputs(batch)
    gpu = batch.to(cuda_device)
    cuda_image.entropy_decode(gpu, out)
    cuda_image.entropy_decode(batch, out_p)
    before = cuda_image.progressive_entropy.launches
    cuda_image.progressive_entropy(gpu, out)
    cuda_image.progressive_entropy(batch, out_p)
    assert cuda_image.progressive_entropy.launches == before + len(batch.k6_rounds)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(out, out_p))


@pytest.mark.parametrize("name", [n for n in DECODABLE if not n.endswith((".jpg", ".png", ".gif", ".tif"))])
def test_raw_kernel_equals_plain(cuda_device, name):
    """K8 on every BMP, PxM, Sun raster, PFM and HDR fixture."""
    data = _bytes(name)
    raw = codec.parse_raw(data, codec.image_kind(data))
    before = cuda_image.raw_expand.launches
    got = cuda_image.decode_raw(raw, cuda_device)
    assert cuda_image.raw_expand.launches == before + 1
    assert torch.equal(got.cpu(), cuda_image.decode_raw(raw, torch.device("cpu")))


@pytest.mark.parametrize("name", DECODABLE)
def test_decode_matches_cv2_digests(cuda_device, name):
    entry = DIGESTS[name]
    img = codec.decode_image(_bytes(name), cuda_device)
    assert list(img.shape) == entry["shape"] and sha(img.cpu().numpy()) == entry["rgb_sha256"]
    assert sha(cuda_image.resize(img, (300, 300)).cpu().numpy()) == entry["resize300_sha256"]
    if "area_sha256" in entry:
        fit = cuda_image.resize(img, entry["area_shape"][:2], "area")
        assert sha(fit.cpu().numpy()) == entry["area_sha256"]


@pytest.mark.parametrize("src,dst,mode,dtype", [
    ((480, 640), (300, 300), "linear", torch.uint8), ((200, 150), (300, 300), "linear", torch.uint8),
    ((480, 640), (300, 300), "linear", torch.float32), ((1, 9), (300, 300), "linear", torch.float32),
    ((72, 96), (300, 300), "linear", torch.float32), ((960, 1280), (480, 640), "area", torch.uint8),
    ((90, 120), (30, 40), "area", torch.uint8), ((479, 641), (478, 640), "area", torch.uint8),
])
def test_resize_equals_plain(cuda_device, src, dst, mode, dtype):
    rng = np.random.default_rng(sum(src))
    img = torch.from_numpy(rng.integers(0, 256, src + (3,), dtype=np.uint8))
    if dtype == torch.float32:
        img = img.float() / 255
    before = cuda_image.resize.launches
    got = cuda_image.resize(img.to(cuda_device), dst, mode)
    assert cuda_image.resize.launches == before + 1
    assert torch.equal(got.cpu(), cuda_image.resize(img, dst, mode))


def test_resize_survives_its_plan_cache_turning_over(cuda_device):
    """A hot shape pair resized between 1,100 other pairs (more than `_device_plan`
    keeps) stays in the launch-pack cache while its plan falls out of the plan cache; its
    output still equals the plain version's, as does the first of the others again."""
    rng = np.random.default_rng(11)
    hot = torch.from_numpy(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    small = torch.from_numpy(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
    hot_gpu, small_gpu = hot.to(cuda_device), small.to(cuda_device)
    want = cuda_image.resize(hot, (30, 30))
    for i in range(1100):
        if i % 50 == 0:
            assert torch.equal(cuda_image.resize(hot_gpu, (30, 30)).cpu(), want), i
        cuda_image.resize(small_gpu, (1 + i % 40, 1 + i // 40))
    assert torch.equal(cuda_image.resize(hot_gpu, (30, 30)).cpu(), want)
    assert torch.equal(cuda_image.resize(small_gpu, (1, 1)).cpu(), cuda_image.resize(small, (1, 1)))


def test_resize_refuses_rows_past_32_bit_offsets(cuda_device):
    """A source row of 2^31 elements or more is refused before any launch (a row's offsets
    are 32-bit in the kernel; its row bases are 64-bit)."""
    wide = torch.zeros((1, 1, 3), dtype=torch.uint8, device=cuda_device).expand(2, 2 ** 30, 3)
    before = cuda_image.resize.launches
    with pytest.raises(ValueError, match="2\\^31"):
        cuda_image.resize(wide, (1, 300), "area")
    assert cuda_image.resize.launches == before


def test_png_kernel_equals_plain(cuda_device):
    """K5 (the row wavefront and the expansion) on each PNG fixture alone: one launch a call."""
    for name in PNGS:
        png = codec.parse_png(_bytes(name))
        before = cuda_image.png_decode.launches
        got = cuda_image.decode_png(png, cuda_device)
        assert cuda_image.png_decode.launches == before + 1
        assert torch.equal(got.cpu(), cuda_image.decode_png(png, torch.device("cpu"))), name


def test_png_kernel_batched_equals_plain(cuda_device):
    """Every PNG fixture in one K5 call (Adam7's passes and every colour type in one pass
    table), each image equal to its plain decode and to cv2's digest."""
    pngs = [codec.parse_png(_bytes(n)) for n in PNGS]
    before = cuda_image.png_decode.launches
    got = cuda_image.decode_png_batch(pngs, cuda_device)
    assert cuda_image.png_decode.launches == before + 1
    for name, img, want in zip(PNGS, got, cuda_image.decode_png_batch(pngs, torch.device("cpu"))):
        assert torch.equal(img.cpu(), want), name
        assert sha(img.cpu().numpy()) == DIGESTS[name]["rgb_sha256"], name


def test_png_kernel_on_passes_past_a_band(cuda_device):
    """PNGs taller than K5's band of 512 rows (RGB, 16-bit RGBA, 1-bit gray, Adam7), written
    with the fixture tool's encoder, in one call: each band's first row takes the row
    above from the band before."""
    from ssd_object_detection_tpu_torch.tools import make_image_fixtures as fx

    rng = np.random.default_rng(7)
    pngs = [codec.parse_png(b) for b in (
        fx.png(rng.integers(0, 256, (1100, 9, 3)), 2, 8), fx.png(rng.integers(0, 65536, (1030, 5, 4)), 6, 16),
        fx.png(rng.integers(0, 2, (1050, 11, 1)), 0, 1), fx.png(rng.integers(0, 256, (1090, 7, 3)), 2, 8, True))]
    for got, want in zip(cuda_image.decode_png_batch(pngs, cuda_device), cuda_image.decode_png_batch(pngs, torch.device("cpu"))):
        assert torch.equal(got.cpu(), want)


def _parsed_gifs():
    out = []
    for name in GIFS + sorted(n for n in RECORD["invalid"] if n.endswith(".gif")):
        try:
            out.append(codec.parse_gif(_bytes(name)))
        except ValueError:  # refused before its LZW data is read
            pass
    return out


def test_lzw_kernel_equals_plain_in_one_launch(cuda_device):
    """K9 on every GIF fixture in one launch, those whose LZW data cv2 rejects among
    them: the status of each equals the plain version's, the indices of each decoded
    frame too."""
    batch = codec.gif_batch(_parsed_gifs())
    before = cuda_image.lzw_decode.launches
    indices, status = cuda_image.lzw_decode(batch.to(cuda_device))
    assert cuda_image.lzw_decode.launches == before + 1
    want, want_status = cuda_image.lzw_decode(batch)
    assert torch.equal(status.cpu(), want_status)
    assert set(want_status.tolist()) == {codec.GIF_OK, codec.GIF_LZW_FAILED, codec.GIF_OVERFLOW, codec.GIF_BAD_INDEX}
    for row, st in zip(batch.gifs.tolist(), want_status.tolist()):
        if st == codec.GIF_OK:
            span = slice(row[6], row[6] + row[3] * row[4])
            assert torch.equal(indices[span].cpu(), want[span])


def _parses(name):
    try:
        codec.parse_gif(_bytes(name))
        return True
    except ValueError:  # refused before its LZW data is read
        return False


ALL_GIFS = sorted(n for n in GIFS + list(RECORD["invalid"]) if n.endswith(".gif") and _parses(n))


@pytest.mark.parametrize("name", ALL_GIFS)
def test_lzw_kernel_one_by_one_with_its_counters(cuda_device, name):
    """K9 on each GIF fixture alone, valid and invalid: status and indices equal the
    plain version's, and its counters (windows, segments, codes, pointer-jumping rounds,
    lifting levels) the CPU model's."""
    from ssd_object_detection_tpu_torch.ops import gif_lzw_model

    batch = codec.gif_batch([codec.parse_gif(_bytes(name))])
    stats = torch.zeros((1, len(cuda_image.LZW_STATS)), dtype=torch.int64, device=cuda_device)
    indices, status = cuda_image.lzw_decode(batch.to(cuda_device), stats)
    want, want_status = cuda_image.lzw_decode(batch)
    assert torch.equal(status.cpu(), want_status)
    if want_status[0] == codec.GIF_OK:
        assert torch.equal(indices.cpu(), want)
    _, _, model = gif_lzw_model.decode(batch.data.numpy(), batch.gifs.numpy(), batch.total_indices)
    got = dict(zip(cuda_image.LZW_STATS, stats[0].cpu().tolist()))
    assert {k: got[k] for k in ("windows", "segments", "codes", "rounds", "levels")} == dataclasses.asdict(model[0])


def test_lzw_kernel_on_32_large_gifs_in_one_launch(cuda_device):
    """32 640x480 GIFs of 256 colours (noise over a gradient, the table filling and
    clearing every few thousand codes) in one launch, equal to the plain version."""
    from ssd_object_detection_tpu_torch.tools import make_image_fixtures as fx

    rng = np.random.default_rng(16)
    gifs = []
    for i in range(32):
        index = (np.add.outer(np.arange(480), np.arange(640)) // (3 + i) + rng.integers(0, 4, (480, 640))) % 256
        gifs.append(codec.parse_gif(fx.gif(index, rng.integers(0, 256, (256, 3)), interlace=i % 4 == 0)))
    batch = codec.gif_batch(gifs)
    indices, status = cuda_image.lzw_decode(batch.to(cuda_device))
    want, want_status = cuda_image.lzw_decode(batch)
    assert want_status.tolist() == [codec.GIF_OK] * 32 and torch.equal(status.cpu(), want_status)
    assert torch.equal(indices.cpu(), want)


@pytest.mark.parametrize("name", GIFS)
def test_gif_kernels_equal_plain(cuda_device, name):
    """K9 then K8 on each GIF fixture: one launch each, equal to the plain versions."""
    gif = codec.parse_gif(_bytes(name))
    before = (cuda_image.lzw_decode.launches, cuda_image.raw_expand.launches)
    got = cuda_image.decode_raw_batch([gif], [], [], cuda_device)[0]
    assert (cuda_image.lzw_decode.launches, cuda_image.raw_expand.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got.cpu(), cuda_image.decode_raw_batch([gif], [], [], torch.device("cpu"))[0])


@pytest.mark.parametrize("name", sorted(RECORD["invalid"]))
def test_what_cv2_returns_none_for_raises_on_the_card(cuda_device, name):
    with pytest.raises(ValueError):
        codec.decode_image(_bytes(name), cuda_device)


def test_faults_raise_and_refusals_stand(cuda_device):
    """What is still refused raises UnsupportedImage; a JPEG cut with no marker after
    the cut raises ValueError (cv2 returns None); cut and ended by EOI it decodes; a
    kernel given the wrong dtype raises."""
    for name, text in REFUSED.items():
        with pytest.raises(codec.UnsupportedImage, match=text):
            codec.decode_image(_bytes(name), cuda_device)
    data = _bytes("coco_640x480_420.jpg")
    with pytest.raises(ValueError, match="without a marker"):
        codec.decode_image(data[:len(data) // 2], cuda_device)
    img = codec.decode_image(data[:len(data) // 2] + b"\xff\xd9", cuda_device)
    assert img.shape == (480, 640, 3)
    batch = codec.jpeg_batch([codec.parse_jpeg(data)]).to(cuda_device)
    with pytest.raises(TypeError):
        cuda_image.idct_color(torch.zeros(batch.total_blocks, 64, dtype=torch.int32, device=cuda_device), batch)


def _tiffs(names):
    return [codec.parse_tiff(_bytes(n)) for n in names]


def _jpeg_chunk_pixels(tif, device):
    """A TIFF's JPEG chunks through K1 and the fused K2 + K3 (their plain versions on the
    CPU), as decode_images feeds them to decode_raw_batch."""
    chunks = codec.tiff_jpeg_chunks([tif])
    if not chunks:
        return None
    batch = codec.jpeg_batch(chunks)
    batch = batch.to(device) if device.type == "cuda" else batch
    return cuda_image.idct_color(cuda_image.decode_entropy(batch)[0], batch)


@pytest.mark.parametrize("name", TIFFS)
def test_tiff_kernels_equal_plain(cuda_device, name):
    """K9 (its TIFF flavour, where the TIFF has LZW chunks), K11 (CCITT or ThunderScan
    chunks), K12 (SGILog chunks), K10 (where a chunk has a predictor or a byte swap) and K8
    on each TIFF fixture (a JPEG-in-TIFF's chunks decoded first by the JPEG kernels): one
    launch each, equal to the plain versions."""
    tif = codec.parse_tiff(_bytes(name))
    lzw = any(c.decoded is None and c.jpeg is None and not c.missing and c.fax < 0 and not c.sgi for c in tif.chunks)
    fax = any(c.fax >= 0 for c in tif.chunks)
    sgi = any(c.sgi > 0 for c in tif.chunks)
    k10 = codec.raw_batch([], [tif], []).works > 0
    pixels = _jpeg_chunk_pixels(tif, cuda_device)
    kernels = (cuda_image.lzw_decode, cuda_image.tiff_assemble, cuda_image.raw_expand, cuda_image.ccitt_decode,
               cuda_image.sgilog_decode)
    before = [k.launches for k in kernels]
    got = cuda_image.decode_raw_batch([], [tif], [], cuda_device, pixels)[0]
    after = [k.launches for k in kernels]
    assert after == [before[0] + lzw, before[1] + k10, before[2] + 1, before[3] + fax, before[4] + sgi]
    cpu = torch.device("cpu")
    assert torch.equal(got.cpu(), cuda_image.decode_raw_batch([], [tif], [], cpu, _jpeg_chunk_pixels(tif, cpu))[0])


def test_tiff_lzw_flavour_and_assembly_equal_plain_in_one_launch(cuda_device):
    """Every TIFF fixture's LZW chunks (the stopping rules' fixtures among them) and the
    GIF fixtures in one K9 launch, then every TIFF chunk with a predictor or a swap in
    one K10 launch, then every image in one K8 launch: statuses, the call's device
    buffer and the RGB equal the plain versions'."""
    tiffs = _tiffs(TIFFS)
    gifs = _parsed_gifs()
    batch = codec.raw_batch(gifs, tiffs, [])
    cpu = torch.device("cpu")
    buf, want_buf = cuda_image.upload(batch, cuda_device), cuda_image.upload(batch, cpu)
    _, status = cuda_image.lzw_decode(batch.lzw.to(cuda_device), out=buf[batch.lzw_at:])
    _, want_status = cuda_image.lzw_decode(batch.lzw, out=want_buf[batch.lzw_at:])
    assert torch.equal(status.cpu(), want_status)
    assert set(want_status[len(gifs):].tolist()) == {codec.GIF_OK, codec.GIF_LZW_FAILED}
    # the host's bytes and K9's TIFF chunks (a failed GIF frame's indices are unspecified)
    chunk_bytes = [slice(0, batch.host.size), slice(batch.lzw_at + batch.lzw.frame_indices, batch.total)]
    assert all(torch.equal(buf[r].cpu(), want_buf[r]) for r in chunk_bytes)
    before = (cuda_image.tiff_assemble.launches, cuda_image.raw_expand.launches)
    cuda_image.tiff_assemble(buf, batch, status)
    cuda_image.tiff_assemble(want_buf, batch, want_status)
    assert all(torch.equal(buf[r].cpu(), want_buf[r]) for r in chunk_bytes)
    jpeg = codec.jpeg_batch(codec.tiff_jpeg_chunks(tiffs))
    pixels = cuda_image.idct_color(cuda_image.decode_entropy(jpeg.to(cuda_device))[0], jpeg.to(cuda_device))
    got = cuda_image.raw_expand(buf, batch, pixels).cpu()
    assert (cuda_image.tiff_assemble.launches, cuda_image.raw_expand.launches) == (before[0] + 1, before[1] + 1)
    want = cuda_image.raw_expand(want_buf, batch, pixels.cpu())
    for i, (at, h, w) in enumerate(batch.out):  # each image's RGB (the bytes between them pad to 16)
        if i >= len(gifs) or want_status[i] == codec.GIF_OK:  # a failed GIF frame's indices are unspecified
            assert torch.equal(got[at:at + h * w * 3], want[at:at + h * w * 3])


def test_a_mixed_call_is_one_k8_launch(cuda_device):
    """BMP, PxM, PAM, Sun raster, PFM, HDR, GIF and TIFF fixtures of every layout (strips,
    tiles, planes, the predictor, big-endian swaps, JPEG chunks, YCbCr, CIELab) in one
    decode_images call: one launch each of K9, K10 and K8, every image equal to the plain
    versions' and to cv2's digest."""
    names = [n for n in DECODABLE if not n.endswith((".jpg", ".png"))]
    blobs = [_bytes(n) for n in names]
    before = (cuda_image.lzw_decode.launches, cuda_image.tiff_assemble.launches, cuda_image.raw_expand.launches)
    images = codec.decode_images(blobs, cuda_device)
    after = (cuda_image.lzw_decode.launches, cuda_image.tiff_assemble.launches, cuda_image.raw_expand.launches)
    assert after == (before[0] + 1, before[1] + 1, before[2] + 1)
    for name, img, want in zip(names, images, codec.decode_images(blobs, "cpu")):
        assert torch.equal(img.cpu(), want), name
        assert sha(img.cpu().numpy()) == DIGESTS[name]["rgb_sha256"], name


def test_32_large_bmps_and_tiffs_in_one_launch(cuda_device):
    """32 640x480 24-bit BMPs and 32 copies of cv2's 640x480 LZW TIFF (120 strips with the
    predictor) in one decode_images call: one K8 launch, one of K10, each image equal to
    its plain decode."""
    from ssd_object_detection_tpu_torch.tools import make_image_fixtures as fx

    rng = np.random.default_rng(19)
    bmps = [fx.bmp(rng.integers(0, 256, (480, 640, 3)), 24) for _ in range(2)] * 16
    tiff = _bytes("tiff_cv2_640x480.tif")
    before = (cuda_image.tiff_assemble.launches, cuda_image.raw_expand.launches)
    images = codec.decode_images(bmps + [tiff] * 32, cuda_device)
    assert (cuda_image.tiff_assemble.launches, cuda_image.raw_expand.launches) == (before[0] + 1, before[1] + 1)
    want = {id(b): codec.decode_image(b, "cpu") for b in bmps[:2] + [tiff]}
    for blob, img in zip(bmps + [tiff] * 32, images):
        assert torch.equal(img.cpu(), want[id(blob)])


def test_jpeg_in_tiffs_decode_in_the_jpeg_launches(cuda_device):
    """Every JPEG-in-TIFF fixture and the baseline JPEG fixtures in one decode_images call:
    the TIFFs' chunks are images of the one JPEG batch, so the fused K2 + K3 launches once
    and K1 once a step; every image equals cv2's digest."""
    names = [n for n in TIFFS if n.startswith("tiff_jpeg_")] + ["coco_640x480_420.jpg", "coco_500x333_444.jpg"]
    blobs = [_bytes(n) for n in names]
    tiffs = [codec.parse_tiff(b) for b in blobs if codec.image_kind(b) == "tiff"]
    steps = codec.jpeg_batch([codec.parse_jpeg(b) for b in blobs[-2:]] + codec.tiff_jpeg_chunks(tiffs)).steps
    before = (cuda_image.idct_color.launches, cuda_image.entropy_decode.launches)
    images = codec.decode_images(blobs, cuda_device)
    assert (cuda_image.idct_color.launches, cuda_image.entropy_decode.launches) == (before[0] + 1, before[1] + steps)
    for name, img in zip(names, images):
        assert sha(img.cpu().numpy()) == DIGESTS[name]["rgb_sha256"], name


@pytest.mark.parametrize("mode,dtype", [("linear", torch.uint8), ("linear", torch.float32), ("area", torch.uint8)],
                         ids=str)
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_resize_batch_equals_plain_in_one_launch(cuda_device, mode, dtype, channels):
    """resize_batch of images of mixed shapes (both scale directions for linear, whole and
    fractional factors for area) in one launch, each output equal to the plain version's;
    outputs misaligned for the wide stores (odd widths) included."""
    pairs = ([((480, 640), (300, 300)), ((7, 9), (20, 17)), ((333, 500), (300, 301)), ((1, 9), (5, 5)),
              ((612, 612), (300, 300))] if mode == "linear" else
             [((960, 1280), (480, 640)), ((1000, 700), (640, 448)), ((37, 53), (20, 17)), ((90, 120), (30, 40))])
    rng = np.random.default_rng(channels)
    images = [torch.from_numpy(rng.integers(0, 256, src + (channels,), dtype=np.uint8)) for src, _ in pairs]
    if dtype == torch.float32:
        images = [i.float() / 255 for i in images]
    sizes = [dst for _, dst in pairs]
    before = cuda_image.resize.launches
    got = cuda_image.resize_batch([i.to(cuda_device) for i in images], sizes, mode)
    assert cuda_image.resize.launches == before + 1
    for img, size, g in zip(images, sizes, got):
        assert torch.equal(g.cpu(), cuda_image.resize(img, size, mode))


FAX_TIFFS = [n for n in TIFFS if n.startswith(("tiff_ccitt_", "tiff_thunderscan_")) or n == "tiff_group4_37x23.tif"]


def test_ccitt_kernel_equals_plain_in_one_launch(cuda_device):
    """K11 on every CCITT and ThunderScan fixture's chunks in one launch (modified
    Huffman, RLEW, Group 3 1-D and 2-D, Group 4, strips and tiles, both fill orders, the
    Group 3 file without EOLs beside one with them, cut and overfull ThunderScan rows, the
    1728x2200 page), bit-equal to its plain version; each fixture alone is
    test_tiff_kernels_equal_plain's."""
    assert len(FAX_TIFFS) >= 20
    batch = codec.raw_batch([], [codec.parse_tiff(_bytes(n)) for n in FAX_TIFFS], [])
    buf, want = cuda_image.upload(batch, cuda_device), cuda_image.upload(batch, torch.device("cpu"))
    before = cuda_image.ccitt_decode.launches
    cuda_image.ccitt_decode(buf, batch)
    cuda_image.ccitt_decode(want, batch)
    assert cuda_image.ccitt_decode.launches == before + 1 and batch.faxes > len(FAX_TIFFS)
    assert torch.equal(buf.cpu(), want)


def test_old_style_lzw_flavour_equals_plain(cuda_device):
    """K9's old-style flavour (LSB-first codes, a GIF's width schedule) on every old-style
    LZW fixture's chunks in one launch, beside new-style chunks: status and bytes equal to
    plain_image.lzw_decode's."""
    names = [n for n in TIFFS if n.startswith("tiff_lzw_")]
    batch = codec.raw_batch([], [codec.parse_tiff(_bytes(n)) for n in names], []).lzw
    flavours = set(batch.gifs[:, 16].tolist())
    assert flavours == {codec.LZW_TIFF, codec.LZW_TIFF_OLD}
    zeros = torch.zeros(batch.total_indices, dtype=torch.uint8)  # a failed chunk keeps them past what decoded
    got, status = cuda_image.lzw_decode(batch.to(cuda_device), out=zeros.to(cuda_device))
    want, want_status = cuda_image.lzw_decode(batch, out=zeros.clone())
    assert torch.equal(status.cpu(), want_status) and torch.equal(got.cpu(), want)


def _smoothed(blobs):
    batch = codec.jpeg_batch([codec.parse_jpeg(b) for b in blobs])
    coef, _, stops = cuda_image.progressive_entropy(batch, cuda_image.entropy_decode(batch))
    return batch, coef, stops


def test_block_smooth_equals_plain_on_every_smoothed_fixture(cuda_device):
    """K7 on each JPEG fixture libjpeg smooths, alone: bit-equal to plain_image.block_smooth
    from the same coefficients, in one launch, or two where a component's own DCs may
    change (their copy first)."""
    smoothed = 0
    for n in DECODABLE:
        if not n.endswith(".jpg"):
            continue
        batch, coef, stops = _smoothed([_bytes(n)])
        if batch.steps != 1 or not batch.smooth.shape[0]:
            continue
        smoothed += 1
        gpu = batch.to(cuda_device)
        before = cuda_image.block_smooth.launches
        got = cuda_image.block_smooth(gpu, coef.to(cuda_device), stops.to(cuda_device))
        assert cuda_image.block_smooth.launches == before + 1 + int(batch.smooth_dc > 0), n
        assert torch.equal(got.cpu(), cuda_image.block_smooth(batch, coef.clone(), stops)), n
    assert smoothed >= 5


@pytest.mark.parametrize("scan,launches", [(4, 2), (8, 1), (None, 2)])
def test_block_smooth_on_32_images_in_one_call(cuda_device, scan, launches):
    """K7 on 32 640x480 progressive JPEGs in one call: cut in the fifth scan (the chroma
    components' DCs may change past the last good row: copied aside first, two launches),
    in the ninth (no component's DCs change: one launch), and after the DC scan (every
    component's change); bit-equal to the plain version."""
    from ssd_object_detection_tpu_torch.tools import make_image_fixtures as fx

    blob = _bytes("coco_640x480_progressive.jpg")
    if scan is None:
        cut = blob[:fx.entropy_span(blob, 0)[1]] + b"\xff\xd9"
    else:
        start, end = fx.entropy_span(blob, scan)
        cut = blob[:start + (end - start) // 2] + b"\xff\xd9"
    batch, coef, stops = _smoothed([cut] * 32)
    gpu = batch.to(cuda_device)
    before = cuda_image.block_smooth.launches
    got = cuda_image.block_smooth(gpu, coef.to(cuda_device), stops.to(cuda_device))
    assert cuda_image.block_smooth.launches == before + launches == before + 1 + int(batch.smooth_dc > 0)
    assert torch.equal(got.cpu(), cuda_image.block_smooth(batch, coef.clone(), stops))


def _k11(tiffs, device):
    """K11 over one call of `tiffs` on the card and its plain version: (the kernel's
    output region, the plain one's, the kernel's records, the batch)."""
    batch = codec.raw_batch([], tiffs, [])
    got, want = cuda_image.upload(batch, device), cuda_image.upload(batch, torch.device("cpu"))
    records = torch.zeros((batch.faxes, codec.FAX_RECORD_INTS), dtype=torch.int32, device=device)
    cuda_image.ccitt_decode(got, batch, records)
    cuda_image.ccitt_decode(want, batch)
    return got.cpu()[batch.fax_out:batch.total], want[batch.fax_out:batch.total], records.cpu(), batch


def test_ccitt_kernel_repairs_where_a_guess_fails(cuda_device):
    """K11's guesses and repairs on the card, beside ops/fax_schedule_model's: the Group 3
    strip without EOLs before strips with them and the Group 4 strip whose first row reads
    past the white reference line are repaired from their second chunk, the 8-strip page in
    the same launch needs none, and every chunk's flags are the model's; all bit-equal to
    the plain version."""
    names = ["tiff_ccitt_noeol_then_eol_37x23.tif", "tiff_ccitt_g4_page_1728x2200.tif",
             "tiff_ccitt_g4_past_white_37x23.tif"]
    got, want, records, batch = _k11([codec.parse_tiff(_bytes(n)) for n in names], cuda_device)
    assert torch.equal(got, want)
    buf = batch.host.copy()
    buf.resize(batch.total, refcheck=False)
    report = fax_schedule_model.ccitt_schedule(buf, batch.fax_streams, buf)
    for first, r in report.items():
        assert records[first, codec.FR_REPAIR_FROM] == (0 if r["repair_from"] is None else r["repair_from"] + 1)
        flags = records[first:first + r["chunks"], codec.FR_FLAGS].tolist()
        assert [j for j, f in enumerate(flags) if f & codec.FAX_FOREIGN] == r["foreign"]
        assert [j for j, f in enumerate(flags) if f & codec.FAX_NOEOL] == r["noeol"]
    assert [records[f, codec.FR_REPAIR_FROM].item() for f in report] == [2, 0, 2]


def test_ccitt_kernel_on_the_one_strip_page_and_a_wide_image(cuda_device):
    """K11 on the 1728x2200 page in one strip (its stage streamed through both halves) and
    on images too wide for shared memory (12,000 pixels: the image's first CTA walks its
    chunks in turn in global scratch), Group 4 and Group 3 without then with EOLs,
    bit-equal to the plain version."""
    from ssd_object_detection_tpu_torch.tools import make_image_fixtures as fx

    got, want, _, _ = _k11([codec.parse_tiff(_bytes("tiff_ccitt_g4_page_one_strip_1728x2200.tif"))], cuda_device)
    assert torch.equal(got, want)
    rng = np.random.default_rng(2600)
    bits = rng.random((48, 12000)) < np.linspace(0.02, 0.4, 12000)
    for mode in ("g4", "noeol"):
        tags = fx.tiff_tags(12000, 48, 1, 1, 0, 4 if mode == "g4" else 3, rows=16)
        strips = [fx.fax_rows(bits[y:y + 16], mode if mode == "g4" or y == 0 else "g3") for y in range(0, 48, 16)]
        got, want, _, batch = _k11([codec.parse_tiff(fx.tiff(tags, strips))], cuda_device)
        assert torch.equal(got, want), mode
        assert (plain_image.fax_tables().size + batch.fax_runs_max) * 4 > 227 * 1024  # past a CTA's shared memory


SGILOGS = [n for n in TIFFS if n.startswith(("tiff_sgilog_", "tiff_sgilog24_"))]


def test_sgilog_kernel_equals_plain_in_one_launch(cuda_device):
    """K12 on every SGILog fixture's run-length chunks in one launch (LogL and LogLuv,
    strips and tiles, a cut strip, runs at the coder's thresholds), bit-equal to its plain
    version, then K8's SGILog formats on them (and on SGILog24's raw pixels) bit-equal to
    theirs and to cv2's digests."""
    assert len(SGILOGS) >= 10
    tiffs = [codec.parse_tiff(_bytes(n)) for n in SGILOGS]
    batch = codec.raw_batch([], tiffs, [])
    buf, want = cuda_image.upload(batch, cuda_device), cuda_image.upload(batch, torch.device("cpu"))
    before = cuda_image.sgilog_decode.launches
    cuda_image.sgilog_decode(buf, batch)
    cuda_image.sgilog_decode(want, batch)
    assert cuda_image.sgilog_decode.launches == before + 1 and batch.sgis > len(SGILOGS)
    assert torch.equal(buf.cpu(), want)
    out, want_out = cuda_image.raw_expand(buf, batch), cuda_image.raw_expand(want, batch)
    for name, (at, h, w) in zip(SGILOGS, batch.out):
        img = out[at:at + h * w * 3].cpu()
        assert torch.equal(img, want_out[at:at + h * w * 3]), name
        assert sha(img.view(h, w, 3).numpy()) == DIGESTS[name]["rgb_sha256"], name
