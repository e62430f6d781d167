"""Progressive, CMYK/YCCK and high-sampling-factor JPEGs, and the formats the port
refuses, through the port's entry points against the JAX package's (which decode with
cv2.imdecode / cv2.imread): `decode_image_bytes`, and `pack_dataset` on a COCO-format
root (the decode feed). The port runs on the CPU, so each kernel's plain version
decodes.

Tolerance: none; pixels and packed caches must be bit-equal. Inputs: the committed
fixtures (ssd_object_detection_tpu_torch/data/fixtures), laid out as a COCO train split
with boxes drawn here from a seeded numpy generator.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from ssd_object_detection_tpu.data import coco as jax_coco
from ssd_object_detection_tpu.data import packed as jax_packed
from ssd_object_detection_tpu.eval.serve import decode_image_bytes as jax_decode
from ssd_object_detection_tpu_torch.data import codec, coco, packed
from ssd_object_detection_tpu_torch.eval.serve import decode_image_bytes
from ssd_object_detection_tpu_torch.tools.make_image_fixtures import FIXTURES, REFUSED

torch.set_num_threads(1)
DIGESTS = json.loads(open(os.path.join(FIXTURES, "digests.json")).read())["images"]
KINDS = sorted(n for n in DIGESTS if n.startswith(("progressive_", "cmyk_", "ycck_", "sampling_", "coco_640x480_p",
                                                    "coco_640x427_411", "coco_500x333_cmyk"))
               and n not in REFUSED)
MIXED = ["coco_500x333_444.jpg", "coco_640x480_progressive.jpg", "coco_500x333_cmyk.jpg", "coco_640x427_411.jpg",
         "progressive_restart_83x61.jpg", "progressive_opt_83x61.jpg", "cmyk_progressive_83x61.jpg",
         "ycck_83x61.jpg", "sampling_410_83x61.jpg", "progressive_gray_61x83.jpg", "gif_cv2_100x80.gif",
         "hdr_cv2_rle_37x23.hdr"]
GIFS_HDRS = sorted(n for n in DIGESTS if n.endswith((".gif", ".hdr")))
# YCbCr and CIELab TIFFs, and JPEG-in-TIFFs of 2 and 4 samples and of separate planes
COLOUR_TIFFS = sorted(n for n in DIGESTS if n.startswith(("tiff_ycbcr", "tiff_pil_ycbcr", "tiff_pil_lab", "tiff_lab",
                                                          "tiff_jpeg_pil_cmyk", "tiff_jpeg_pil_rgba",
                                                          "tiff_jpeg_pil_la", "tiff_jpeg_planar", "tiff_jpeg_cmyk",
                                                          "tiff_jpeg_gray_alpha")) and n not in REFUSED)


def _bytes(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


# CCITT and ThunderScan TIFFs (K11) and old-style LZW ones (K9's third flavour)
FAX_TIFFS = sorted(n for n in DIGESTS if n.startswith(("tiff_ccitt_", "tiff_thunderscan_", "tiff_lzw_old_",
                                                       "tiff_lzw_new_then_old")) or n == "tiff_group4_37x23.tif")


@pytest.mark.parametrize("name", FAX_TIFFS)
def test_fax_thunderscan_and_old_lzw_tiffs_decode_as_the_jax_package(name):
    """Every CCITT (modified Huffman, RLEW, Group 3 1-D and 2-D, Group 4, the 1728x2200
    page among them), ThunderScan and old-style LZW fixture through the port's
    decode_image_bytes (K11's and K9's plain versions here) against the JAX package's,
    which reads it with cv2, and against cv2's recorded digest."""
    import hashlib

    got = decode_image_bytes(_bytes(name), "cpu")
    np.testing.assert_array_equal(got, jax_decode(_bytes(name)))
    assert hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest() == DIGESTS[name]["rgb_sha256"]


def test_rlew_read_from_a_file_as_cv2_imread(tmp_path):
    """An RLEW TIFF whose strips lie at odd offsets: libtiff word-aligns each row by the
    address of the next byte, which cv2.imread's mapped file gives by the strip's offset
    and cv2.imdecode's buffer by the strip's own start; the port's file read
    (codec.imread, the decode feed) equals the first, its decode of the bytes the second,
    and the two differ."""
    from ssd_object_detection_tpu_torch.tools import make_image_fixtures as fx

    bits = np.random.default_rng(21).random((23, 37)) < 0.3
    strips = [fx.fax_rows(bits[y:y + 8], "rlew") for y in range(0, 23, 8)]
    strips[0] += b"\0"  # the later strips start at odd offsets
    data = fx.tiff(fx.tiff_tags(37, 23, 1, 1, 0, 32771, rows=8), strips)
    path = tmp_path / "odd.tif"
    path.write_bytes(data)
    want_file, want_bytes = cv2.imread(str(path))[..., ::-1], jax_decode(data)
    assert not np.array_equal(want_file, want_bytes)
    np.testing.assert_array_equal(codec.imread(str(path), "cpu").numpy(), want_file)
    np.testing.assert_array_equal(decode_image_bytes(data, "cpu"), want_bytes)


@pytest.mark.parametrize("name", KINDS)
def test_new_kinds_decode_as_the_jax_package(name):
    got = decode_image_bytes(_bytes(name), "cpu")
    np.testing.assert_array_equal(got, jax_decode(_bytes(name)))


@pytest.mark.parametrize("name", GIFS_HDRS)
def test_gif_and_hdr_decode_as_the_jax_package(name):
    """Every GIF and HDR fixture through the port's decode_image_bytes (K9 and K8's plain
    versions here) against the JAX package's, which reads it with cv2."""
    got = decode_image_bytes(_bytes(name), "cpu")
    np.testing.assert_array_equal(got, jax_decode(_bytes(name)))


@pytest.mark.parametrize("name", COLOUR_TIFFS)
def test_colour_tiffs_decode_as_the_jax_package(name):
    """Every YCbCr and CIELab TIFF fixture (each subsampling under none, LZW, PackBits and
    Deflate; CIELab under each compression cv2 reads it in, JPEG among them) and every
    JPEG-in-TIFF of CMYK, RGB plus alpha, gray plus alpha and separate planes, through the
    port's decode_image_bytes (K8's plain version reading the chunks) against the JAX
    package's, which reads it with cv2, and against cv2's recorded digest."""
    import hashlib

    got = decode_image_bytes(_bytes(name), "cpu")
    np.testing.assert_array_equal(got, jax_decode(_bytes(name)))
    assert hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest() == DIGESTS[name]["rgb_sha256"]


def _root(path, names, blobs=None):
    """A COCO-format train split of the named fixtures (or of `blobs`, {name: bytes}) under
    distinct ids, 1-3 boxes each (an image cv2 returns None for listed as 64 x 48)."""
    os.makedirs(os.path.join(path, "annotations"))
    os.makedirs(os.path.join(path, "train2017"))
    rng = np.random.default_rng(7)
    images, annotations = [], []
    for i, name in enumerate(names):
        data = (blobs or {}).get(name) or _bytes(name)
        image = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        h, w = (48, 64) if image is None else image.shape[:2]
        file_name = f"{9000 + i:012d}.jpg"
        with open(os.path.join(path, "train2017", file_name), "wb") as f:
            f.write(data)
        images.append({"id": 9000 + i, "file_name": file_name, "width": w, "height": h})
        for _ in range(int(rng.integers(1, 4))):
            bw, bh = rng.uniform(0.2, 0.6) * w, rng.uniform(0.2, 0.6) * h
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            annotations.append({"id": len(annotations) + 1, "image_id": 9000 + i, "category_id": 1 + i % 5,
                                "bbox": [round(x, 2), round(y, 2), round(bw, 2), round(bh, 2)],
                                "area": round(bw * bh, 2), "iscrowd": 0})
    with open(os.path.join(path, "annotations", "instances_train2017.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c, "name": f"class{c}"} for c in range(1, 6)]}, f)
    return str(path)


def test_mixed_root_packs_as_the_jax_package(tmp_path):
    """Baseline, progressive, CMYK, YCCK, 4:1:1 and 4:1:0 JPEGs, a GIF and an HDR under
    .jpg names in one root: the two packages' caches are byte-equal."""
    root = _root(tmp_path / "root", MIXED)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    packed.pack_dataset(coco.open_split(root, "train"), port_dir, image_size=48, max_gt=4, num_workers=2,
                        device="cpu")
    jax_packed.pack_dataset(jax_coco.open_split(root, "train"), jax_dir, image_size=48, max_gt=4, num_workers=2)
    for name in ("images.u8", "gt.npz"):
        with open(os.path.join(port_dir, name), "rb") as a, open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    assert json.load(open(os.path.join(port_dir, "meta.json")))["count"] == len(MIXED)


@pytest.mark.parametrize("body", ["other_8x6.avif", "other_8x6.ras", "other_8x6.pfm", "other_gray_8x6.pfm"])
def test_a_refused_format_in_a_root_raises_naming_the_file(tmp_path, body):
    """An AVIF, Sun raster, PFM or 1-channel PFM body under a .jpg name. The Sun raster
    and the PFM, once refused, now decode as cv2 reads them, and the root packs
    byte-equal to the JAX package's. What the port still refuses (AVIF; the 1-channel
    PFM, which cv2 returns with one channel and the JAX feed's BGR->RGB step rejects)
    raises UnsupportedImage naming the file rather than skipping the image, which would
    change the data (ROADMAP queue C, C3)."""
    root = _root(tmp_path / "root", ["progressive_420_83x61.jpg", "cmyk_83x61.jpg"])
    victim = os.path.join(root, "train2017", f"{9001:012d}.jpg")
    shutil.copy(os.path.join(FIXTURES, body), victim)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    if body not in REFUSED:
        packed.pack_dataset(coco.open_split(root, "train"), port_dir, image_size=48, max_gt=4, num_workers=2,
                            device="cpu")
        jax_packed.pack_dataset(jax_coco.open_split(root, "train"), jax_dir, image_size=48, max_gt=4, num_workers=2)
        for name in ("images.u8", "gt.npz"):
            with open(os.path.join(port_dir, name), "rb") as a, open(os.path.join(jax_dir, name), "rb") as b:
                assert a.read() == b.read(), name
        return
    with pytest.raises(codec.UnsupportedImage, match=REFUSED[body]) as e:
        packed.pack_dataset(coco.open_split(root, "train"), port_dir, image_size=48, max_gt=4, num_workers=2,
                            device="cpu")
    assert victim in str(e.value)
    if body == "other_8x6.avif":  # cv2 reads it, so the JAX package packs it
        jax_packed.pack_dataset(jax_coco.open_split(root, "train"), jax_dir, image_size=48, max_gt=4, num_workers=2)
        assert json.load(open(os.path.join(jax_dir, "meta.json")))["count"] == 2


@pytest.mark.parametrize("body", ["pam_rgb_37x23.pam", "pam_gray16_37x23.pam", "pam_bits_37x23.pam"])
def test_a_root_holding_a_pam_packs_it(tmp_path, body):
    """A PAM body under a .jpg name in a root: the decode feed packs it (it once raised
    ValueError there and the feed skipped it, where the JAX package, reading it with cv2,
    trains on it); the caches are byte-equal to the JAX package's, the PAM counted."""
    root = _root(tmp_path / "root", ["progressive_420_83x61.jpg", "cmyk_83x61.jpg", body])
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    packed.pack_dataset(coco.open_split(root, "train"), port_dir, image_size=48, max_gt=4, num_workers=2,
                        device="cpu")
    jax_packed.pack_dataset(jax_coco.open_split(root, "train"), jax_dir, image_size=48, max_gt=4, num_workers=2)
    assert json.load(open(os.path.join(port_dir, "meta.json")))["count"] == 3
    for name in ("images.u8", "gt.npz"):
        with open(os.path.join(port_dir, name), "rb") as a, open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("bodies", [["tiff_cv2_37x23.tif", "tiff_bigtiff_lzw_be_37x23.tif"],
                                    ["tiff_planar_37x23.tif", "tiff_pil_cmyk_deflate_37x23.tif",
                                     "tiff_orientation3_37x23.tif", "bigtiff_le_8x6.tif"],
                                    ["tiff_jpeg_strips_420_67x45.tif", "tiff_jpeg_pil_ycbcr_37x23.tif",
                                     "tiff_jpeg_gray_tiles_67x45.tif", "tiff_jpeg_cut_67x45.tif"],
                                    ["tiff_ycbcr22_lzw_37x23.tif", "tiff_pil_lab_jpeg_37x23.tif",
                                     "tiff_jpeg_pil_cmyk_37x23.tif", "tiff_jpeg_planar_rgb_67x45.tif",
                                     "tiff_lab16_be_37x23.tif", "tiff_jpeg_pil_rgba_37x23.tif"],
                                    ["tiff_sgilog_logl_37x23.tif", "tiff_sgilog_logluv_tiles_37x23.tif",
                                     "tiff_sgilog24_logluv_37x23.tif", "tiff_sgilog_logluv_cut_37x23.tif"],
                                    ["tiff_tiles_rgba_37x23.tif", "tiff_invalid_tiles_rgb_37x23.tif",
                                     "tiff_invalid_tiles_gray_37x23.tif", "tiff_tiles_planar_rgb_37x23.tif"]])
def test_a_root_holding_tiffs_packs_them(tmp_path, bodies):
    """TIFF, BigTIFF and JPEG-in-TIFF bodies under .jpg names in a root (SGILog ones, and
    uncompressed tiles that cv2.imread reads from the file where cv2.imdecode returns None
    for their bytes, among them): the decode feed packs them, the caches byte-equal to
    the JAX package's (which reads them with cv2.imread). Orientations 5-8 are the next
    test's."""
    root = _root(tmp_path / "root", ["progressive_420_83x61.jpg"] + bodies)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    packed.pack_dataset(coco.open_split(root, "train"), port_dir, image_size=48, max_gt=4, num_workers=2,
                        device="cpu")
    jax_packed.pack_dataset(jax_coco.open_split(root, "train"), jax_dir, image_size=48, max_gt=4, num_workers=2)
    assert json.load(open(os.path.join(port_dir, "meta.json")))["count"] == 1 + len(bodies)
    for name in ("images.u8", "gt.npz"):
        with open(os.path.join(port_dir, name), "rb") as a, open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("orientation", [5, 6, 7, 8])
def test_a_root_holding_turned_tiffs_packs_as_cv2_imread(tmp_path, orientation):
    """TIFFs of orientation 5-8 under .jpg names: cv2 5.0's imread returns None for one
    that is not square (the decoder turns it and allocates it anew, and imread's own check
    fails), so the JAX feed skips it, and reads a square one. The port's feed does the
    same (codec.check_file_read), so the caches are byte-equal, the non-square TIFFs not
    counted; cv2.imdecode, and so `decode_image_bytes`, reads them all."""
    from ssd_object_detection_tpu_torch.tools import make_image_fixtures as fx

    pixels = np.random.default_rng(orientation).integers(0, 256, (16, 16, 3), np.uint8)
    square = fx.tiff(fx.tiff_tags(16, 16, 8, 3, 2, orientation=orientation), [pixels.tobytes()])
    turned = [f"tiff_orientation{orientation}_37x23.tif"] + (["tiff_tiled_orientation6_37x23.tif"]
                                                            if orientation == 6 else [])
    root = _root(tmp_path / "root", ["progressive_420_83x61.jpg", "square.tif"] + turned, {"square.tif": square})
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    packed.pack_dataset(coco.open_split(root, "train"), port_dir, image_size=48, max_gt=4, num_workers=2,
                        device="cpu")
    jax_packed.pack_dataset(jax_coco.open_split(root, "train"), jax_dir, image_size=48, max_gt=4, num_workers=2)
    assert json.load(open(os.path.join(port_dir, "meta.json")))["count"] == 2
    for name in ("images.u8", "gt.npz"):
        with open(os.path.join(port_dir, name), "rb") as a, open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    for i, data in enumerate([_bytes("progressive_420_83x61.jpg"), square] + [_bytes(n) for n in turned]):
        path = os.path.join(root, "train2017", f"{9000 + i:012d}.jpg")
        if cv2.imread(path, cv2.IMREAD_COLOR) is None:
            with pytest.raises(ValueError, match="cv2.imread returns None"):
                codec.imread(path, "cpu")
        else:
            np.testing.assert_array_equal(codec.imread(path, "cpu").numpy(), cv2.imread(path)[..., ::-1])
        np.testing.assert_array_equal(decode_image_bytes(data, "cpu"), jax_decode(data))
    assert sum(cv2.imread(os.path.join(root, "train2017", f)) is None
               for f in os.listdir(os.path.join(root, "train2017"))) == len(turned)


@pytest.mark.parametrize("body", ["tiff_refused_ycbcr44_odd_units_33x17.tif", "other_mif1_8x6.avif",
                                  "pam_rgb_alpha_37x23.pam"])
def test_a_refused_tiff_avif_or_alpha_pam_in_a_root_raises_naming_the_file(tmp_path, body):
    """An uncompressed YCbCr TIFF, an AVIF whose major brand is `mif1`, or a PAM with
    alpha under a .jpg name: cv2 reads each (the JAX package packs it), the port refuses
    it, and the feed raises UnsupportedImage naming the file rather than skipping it."""
    root = _root(tmp_path / "root", ["progressive_420_83x61.jpg", "cmyk_83x61.jpg"])
    victim = os.path.join(root, "train2017", f"{9001:012d}.jpg")
    shutil.copy(os.path.join(FIXTURES, body), victim)
    with pytest.raises(codec.UnsupportedImage, match=REFUSED[body]) as e:
        packed.pack_dataset(coco.open_split(root, "train"), str(tmp_path / "port"), image_size=48, max_gt=4,
                            num_workers=2, device="cpu")
    assert victim in str(e.value)
    jax_dir = str(tmp_path / "jax")
    jax_packed.pack_dataset(jax_coco.open_split(root, "train"), jax_dir, image_size=48, max_gt=4, num_workers=2)
    assert json.load(open(os.path.join(jax_dir, "meta.json")))["count"] == 2


@pytest.mark.parametrize("body", ["tiff_invalid_lzma_37x23.tif", "tiff_jpeg_invalid_garbage_67x45.tif"])
def test_a_root_holding_a_tiff_cv2_returns_none_for_skips_it(tmp_path, body):
    """An LZMA TIFF (a codec cv2's libtiff lacks) or a JPEG-in-TIFF with a strip of no
    JPEG under a .jpg name: cv2.imread returns None, so the JAX feed skips it, and the
    port's feed skips it too (ValueError, not UnsupportedImage): the caches are
    byte-equal, the TIFF not counted; decode_image_bytes raises ValueError as the JAX
    package's does."""
    root = _root(tmp_path / "root", ["progressive_420_83x61.jpg", "cmyk_83x61.jpg", body])
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    packed.pack_dataset(coco.open_split(root, "train"), port_dir, image_size=48, max_gt=4, num_workers=2,
                        device="cpu")
    jax_packed.pack_dataset(jax_coco.open_split(root, "train"), jax_dir, image_size=48, max_gt=4, num_workers=2)
    assert json.load(open(os.path.join(port_dir, "meta.json")))["count"] == 2
    for name in ("images.u8", "gt.npz"):
        with open(os.path.join(port_dir, name), "rb") as a, open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    with pytest.raises(ValueError):
        decode_image_bytes(_bytes(body), "cpu")
    with pytest.raises(ValueError):
        jax_decode(_bytes(body))


@pytest.mark.parametrize("name", ["tiff_jpeg_strips_422_67x45.tif", "tiff_jpeg_orientation6_67x45.tif",
                                  "tiff_jpeg_pil_l_37x23.tif", "tiff_jpeg_tall_last_67x46.tif"])
def test_jpeg_in_tiff_decodes_as_the_jax_package(name):
    """JPEG-in-TIFF bodies through the port's decode_image_bytes (K1 and the fused K2 + K3's
    plain versions for the chunks, K10 and K8's for the placement) against the JAX
    package's, which reads them with cv2."""
    got = decode_image_bytes(_bytes(name), "cpu")
    np.testing.assert_array_equal(got, jax_decode(_bytes(name)))
