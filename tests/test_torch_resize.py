"""The K4 resize's plain version (ops/plain_image.py, through ops/cuda_image.py::resize on
CPU tensors) against cv2.resize, which the JAX package calls (data/pipeline.py:123-125 on
the feed, eval/serve.py:248-260 to fit the serving canvas).

Tolerance: none. Every case is bit-equal to cv2: uint8 INTER_LINEAR at the COCO-sized
downscales and at upscales (the border rows of an upscale included), float32
INTER_LINEAR (cv2's IPP path) at the shapes the host-augmented feed gives it, and uint8
INTER_AREA at whole-number and fractional factors. Not covered, and logged in ROADMAP
queue C: float32 upscales of sources under 36 px a side to 300, where a few border
columns differ from IPP's by up to 15 ulp.
"""

import numpy as np
import pytest
import torch

from ssd_object_detection_tpu_torch.ops import cuda_image

cv2 = pytest.importorskip("cv2")

DOWNSCALES = [(480, 640), (427, 640), (640, 480), (333, 500), (612, 612), (300, 300), (301, 299),
              (1024, 768)]
UPSCALES = [(200, 150), (150, 200), (64, 64), (7, 9), (1, 1), (3, 700), (1, 9), (9, 1)]


def _image(hw, seed, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    return img if dtype == np.uint8 else (img.astype(np.float32) / 255.0)


@pytest.mark.parametrize("src", DOWNSCALES + UPSCALES, ids=str)
@pytest.mark.parametrize("dst", [(300, 300), (64, 48)], ids=str)
def test_linear_u8_is_cv2(src, dst):
    img = _image(src, sum(src))
    got = cuda_image.resize(torch.from_numpy(img), dst).numpy()
    np.testing.assert_array_equal(got, cv2.resize(img, dst[::-1]))


@pytest.mark.parametrize("src", [(480, 640), (333, 500), (301, 299), (612, 612), (72, 96),
                                 (36, 40), (200, 150), (1, 9), (9, 1), (1, 1)], ids=str)
def test_linear_f32_is_cv2(src):
    """The host-augmented feed's resize: crops and expansions at the original resolution
    (at least 72 px a side after a crop of COCO images) to 300 x 300; a source one pixel
    wide or high takes cv2's own float path rather than IPP's."""
    img = _image(src, sum(src), np.float32)
    got = cuda_image.resize(torch.from_numpy(img), (300, 300)).numpy()
    np.testing.assert_array_equal(got, cv2.resize(img, (300, 300)))


@pytest.mark.parametrize("src,dst", [
    ((960, 1280), (480, 640)), ((96, 128), (48, 64)), ((90, 120), (30, 40)), ((128, 64), (32, 16)),
    ((479, 641), (478, 640)), ((100, 70), (64, 44)), ((1000, 700), (640, 448)), ((37, 53), (20, 17)),
    ((641, 641), (640, 640)),
], ids=str)
def test_area_u8_is_cv2(src, dst):
    """Whole-number factors (2x: (s + 2) >> 2; 3x and 4x: the float mean rounded to
    even) and fractional ones (cv2's area tables)."""
    img = _image(src, sum(src) + 1)
    got = cuda_image.resize(torch.from_numpy(img), dst, "area").numpy()
    np.testing.assert_array_equal(got, cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA))


def test_fit_canvas_is_cv2():
    """eval/serve.py::fit_to_canvas of one image: the aspect-preserving INTER_AREA fit into
    the canvas."""
    from ssd_object_detection_tpu_torch.eval.serve import fit_to_canvas

    for hw in [(1280, 960), (700, 1000), (641, 479)]:
        img = _image(hw, hw[0])
        h, w = hw
        scale = min(640 / h, 640 / w)
        want = cv2.resize(img, (max(1, int(w * scale)), max(1, int(h * scale))), interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(fit_to_canvas([img], (640, 640), torch.device("cpu"))[0], want)


@pytest.mark.parametrize("bad", ["area_upscale", "float_area", "int16", "flat"])
def test_resize_refuses_what_it_does_not_compute(bad):
    img = torch.zeros(8, 8, 3, dtype=torch.uint8)
    with pytest.raises(ValueError):
        if bad == "area_upscale":
            cuda_image.resize(img, (16, 16), "area")
        elif bad == "float_area":
            cuda_image.resize(img.float(), (4, 4), "area")
        elif bad == "int16":
            cuda_image.resize(img.to(torch.int16), (4, 4))
        else:
            cuda_image.resize(img[..., 0], (4, 4))


BATCH = [((480, 640), (300, 300)), ((333, 500), (300, 300)), ((7, 9), (20, 17)), ((300, 300), (300, 300)),
         ((200, 150), (64, 48)), ((612, 612), (300, 300))]
AREA_BATCH = [((960, 1280), (480, 640)), ((1000, 700), (640, 448)), ((90, 120), (30, 40)), ((37, 53), (20, 17))]


@pytest.mark.parametrize("mode,dtype", [("linear", np.uint8), ("linear", np.float32), ("area", np.uint8)], ids=str)
def test_resize_batch_equals_one_resize_each(mode, dtype):
    """cuda_image.resize_batch (one K4 launch a batch on the card) of images of mixed
    shapes equals one resize an image, views of one buffer in order (or of `out`)."""
    pairs = AREA_BATCH if mode == "area" else BATCH
    images = [torch.from_numpy(_image(src, i, dtype)) for i, (src, _) in enumerate(pairs)]
    sizes = [dst for _, dst in pairs]
    got = cuda_image.resize_batch(images, sizes, mode)
    for img, size, g in zip(images, sizes, got):
        assert torch.equal(g, cuda_image.resize(img, size, mode))
    out = torch.zeros(sum(h * w * 3 for h, w in sizes), dtype=images[0].dtype)
    again = cuda_image.resize_batch(images, sizes, mode, out=out)
    assert torch.equal(torch.cat([g.reshape(-1) for g in got]), out)
    assert all(a.data_ptr() == out.data_ptr() + sum(h * w * 3 for h, w in sizes[:i]) * out.element_size()
               for i, a in enumerate(again))


def test_resize_batch_refuses_mixed_batches():
    a = torch.zeros(8, 8, 3, dtype=torch.uint8)
    with pytest.raises(ValueError):
        cuda_image.resize_batch([a, a.float()], [(4, 4), (4, 4)])
    with pytest.raises(ValueError):
        cuda_image.resize_batch([a, a[..., :1].contiguous()], [(4, 4), (4, 4)])
    with pytest.raises(ValueError):
        cuda_image.resize_batch([a], [(4, 4), (4, 4)])
    with pytest.raises(ValueError):
        cuda_image.resize_batch([a], [(4, 4)], out=torch.zeros(7, dtype=torch.uint8))


def test_resize_pack_holds_the_plans_it_points_into():
    """Every plan pointer a cached launch pack carries points into a tensor the pack
    itself holds, so the pack stays sound after `_device_plan`'s cache drops the plan
    (a hit in the pack's cache does not touch that one) or never caches it (two threads
    building the same plan at once). Built here on CPU tensors, as on the card."""
    import gc

    cpu = torch.device("cpu")
    shapes = tuple((H, W, h, w) for (H, W), (h, w) in BATCH)
    try:
        launches, _ = cuda_image._resize_pack(shapes, 3, "linear", torch.uint8, cpu)
        cuda_image._device_plan.cache_clear()
        gc.collect()
        churn = [torch.full((16,), 7, dtype=torch.int64) for _ in range(256)]  # would reuse freed blocks
        for _, count, pointers, _, _, plans in launches:
            assert len(plans) == count == len(pointers)
            for pointer, (plan, tables, _) in zip(pointers, plans):
                assert plan.data_ptr() == pointer
                held = {t.data_ptr() for t in tables}
                assert {int(p) for p in plan[-6:].tolist() if p} == held
        del churn
    finally:
        cuda_image._resize_pack.cache_clear()
        cuda_image._device_plan.cache_clear()


def test_fit_to_canvas_batch_is_cv2():
    """eval/serve.py::fit_to_canvas over a dispatched batch (one upload, one launch, one
    fetch): the images past the canvas fitted as cv2's INTER_AREA fits them, the rest
    untouched."""
    from ssd_object_detection_tpu_torch.eval.serve import fit_to_canvas

    images = [_image(hw, hw[0] + 5) for hw in [(1280, 960), (300, 400), (700, 1000), (641, 479)]]
    got = fit_to_canvas(images, (640, 640), torch.device("cpu"))
    assert got[1] is images[1]
    for img, g in zip(images, got):
        h, w = img.shape[:2]
        if h <= 640 and w <= 640:
            continue
        scale = min(640 / h, 640 / w)
        want = cv2.resize(img, (max(1, int(w * scale)), max(1, int(h * scale))), interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(g, want)
