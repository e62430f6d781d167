"""Port on-device augmentation (ops/augment.py) against the JAX package, from JAX's own
draws.

The port splits the random draws from the arithmetic, so each test derives the draws
the way the JAX module derives them from its key (split per image; fold_in 1 for the
photometric uniforms; fold_in 2, split 4 for expand, crop option, crop rects and flip)
and feeds them to the port's `augment_batch`.

Tolerances: `valid`, `cls`, the crop rect chosen and the flip bit-equal; boxes within
1e-6 absolute; pixels within 2e-5 absolute (the per-image means and the float32 products
sum in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_object_detection_tpu.ops import augment as jax_aug
from ssd_object_detection_tpu_torch.data.augment import random_expand, random_min_iou_crop
from ssd_object_detection_tpu_torch.ops.augment import (
    AugConfig,
    AugDraws,
    apply_geometry,
    augment_batch,
    draw_augment,
    geometry_from_draws,
    photometric,
)

torch.set_num_threads(1)

B, S, G, ATTEMPTS = 4, 64, 8, 50


def jax_draws(key, batch: int, cfg: AugConfig) -> AugDraws:
    """The draws the JAX augment_batch makes from `key`, as the port's AugDraws."""
    keys = jax.random.split(key, batch)

    def geometry(k):
        ke, kc_opt, kc_rect, kf = jax.random.split(jax.random.fold_in(k, 2), 4)
        return (jax.random.uniform(ke, (4,)),
                jax.random.randint(kc_opt, (), 0, len(jax_aug._CROP_MIN_IOUS)),
                jax.random.uniform(kc_rect, (cfg.crop_attempts, 4)),
                jax.random.uniform(kf))

    photo = jax.vmap(lambda k: jax.random.uniform(jax.random.fold_in(k, 1), (6,)))(keys)
    expand, option, rects, flip = jax.vmap(geometry)(keys)
    return AugDraws(photometric=torch.from_numpy(np.array(photo)),
                    expand=torch.from_numpy(np.array(expand)),
                    crop_option=torch.from_numpy(np.array(option)).long(),
                    crop_rects=torch.from_numpy(np.array(rects)),
                    flip=torch.from_numpy(np.array(flip)))


def jax_config(cfg: AugConfig):
    return jax_aug.AugConfig(**{f.name: getattr(cfg, f.name) for f in
                                jax_aug.dataclasses.fields(jax_aug.AugConfig)})


def make_batch(seed: int, uint8: bool = True):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (B, S, S, 3), np.uint8)
    if not uint8:
        image = image.astype(np.float32) / np.float32(255.0)
    wh = rng.uniform(0.05, 0.6, (B, G, 2))
    centers = rng.uniform(wh / 2, 1 - wh / 2)
    boxes = np.concatenate([centers, wh], -1).astype(np.float32)
    cls = rng.integers(0, 8, (B, G)).astype(np.int32)
    valid = rng.uniform(size=(B, G)) < 0.6
    valid[:, 0] = True
    valid[-1, 1:] = False  # one image with a single GT
    boxes[~valid] = 0.0
    return image, boxes, cls, valid


COMPONENTS = {
    "photometric": AugConfig(photometric=True, expand=False, crop=False, flip=False,
                             crop_attempts=ATTEMPTS),
    "expand": AugConfig(photometric=False, expand=True, crop=False, flip=False,
                        crop_attempts=ATTEMPTS),
    "crop": AugConfig(photometric=False, expand=False, crop=True, flip=False,
                      crop_attempts=ATTEMPTS),
    "flip": AugConfig(photometric=False, expand=False, crop=False, flip=True,
                      crop_attempts=ATTEMPTS),
    "full": AugConfig(crop_attempts=ATTEMPTS),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", list(COMPONENTS))
def test_augment_batch_matches_jax_from_its_draws(name, seed):
    cfg = COMPONENTS[name]
    image, boxes, cls, valid = make_batch(seed)
    key = jax.random.PRNGKey(100 + seed)
    want = jax_aug.augment_batch(key, jnp.asarray(image), jnp.asarray(boxes), jnp.asarray(cls),
                                 jnp.asarray(valid), jax_config(cfg))
    draws = jax_draws(key, B, cfg)
    got = augment_batch(*(torch.from_numpy(x) for x in (image, boxes, cls, valid)), cfg, draws)
    img, bx, cl, va = (np.asarray(x) for x in want)
    assert got[0].dtype == torch.float32 and got[0].shape == (B, S, S, 3)
    np.testing.assert_array_equal(got[3].numpy(), va)
    np.testing.assert_array_equal(got[2].numpy(), cl)
    np.testing.assert_allclose(got[1].numpy(), bx, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[0].numpy(), img, atol=2e-5, rtol=0)

    if cfg.any_geometry:  # the geometry chosen: crop rect and flip bit-equal
        geo_keys = jax.vmap(lambda k: jax.random.fold_in(k, 2))(jax.random.split(key, B))
        window, rect, flip = jax.vmap(lambda k, b, v: jax_aug._draw_geometry(k, b, v, jax_config(cfg)))(
            geo_keys, jnp.asarray(boxes), jnp.asarray(valid))
        p_window, p_rect, p_flip = geometry_from_draws(torch.from_numpy(boxes),
                                                       torch.from_numpy(valid), cfg, draws)
        np.testing.assert_array_equal(p_rect.numpy(), np.asarray(rect))
        np.testing.assert_array_equal(p_flip.numpy(), np.asarray(flip))
        np.testing.assert_allclose(p_window.numpy(), np.asarray(window), atol=1e-6, rtol=0)


def test_full_recipe_exercises_every_branch():
    """Over the seeds of the test above the full recipe expands, crops, flips and keeps
    the identity at least once, so each branch is compared with JAX."""
    cfg = COMPONENTS["full"]
    seen = set()
    for seed in range(3):
        image, boxes, cls, valid = make_batch(seed)
        draws = jax_draws(jax.random.PRNGKey(100 + seed), B, cfg)
        window, rect, flip = geometry_from_draws(torch.from_numpy(boxes), torch.from_numpy(valid),
                                                 cfg, draws)
        expanded = (window[:, 2] - window[:, 0]) < 1.0
        cropped = (rect != torch.tensor([0.0, 0.0, 1.0, 1.0])).any(-1)
        seen |= {"expand"} if bool(expanded.any()) else set()
        seen |= {"no-expand"} if bool((~expanded).any()) else set()
        seen |= {"crop"} if bool(cropped.any()) else set()
        seen |= {"no-crop"} if bool((~cropped).any()) else set()
        seen |= {"flip"} if bool(flip.any()) else set()
        seen |= {"no-flip"} if bool((~flip).any()) else set()
    assert seen == {"expand", "no-expand", "crop", "no-crop", "flip", "no-flip"}, seen


def test_float_input_equals_uint8_input():
    cfg = COMPONENTS["full"]
    u8 = make_batch(3, uint8=True)
    f32 = make_batch(3, uint8=False)
    draws = jax_draws(jax.random.PRNGKey(7), B, cfg)
    a = augment_batch(*(torch.from_numpy(x) for x in u8), cfg, draws)
    b = augment_batch(*(torch.from_numpy(x) for x in f32), cfg, draws)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_out_size_matches_jax():
    cfg = COMPONENTS["full"]
    image, boxes, cls, valid = make_batch(4)
    key = jax.random.PRNGKey(9)
    want = jax_aug.augment_batch(key, jnp.asarray(image), jnp.asarray(boxes), jnp.asarray(cls),
                                 jnp.asarray(valid), jax_config(cfg), out_size=48)
    got = augment_batch(*(torch.from_numpy(x) for x in (image, boxes, cls, valid)), cfg,
                        jax_draws(key, B, cfg), out_size=48)
    assert got[0].shape == (B, 48, 48, 3)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-5, rtol=0)


def test_draw_augment_shapes_and_determinism():
    cfg = AugConfig(crop_attempts=ATTEMPTS)

    def draw(seed):
        return draw_augment(torch.Generator().manual_seed(seed), B, cfg, torch.device("cpu"))

    a, b, c = draw(0), draw(0), draw(1)
    assert [tuple(x.shape) for x in a] == [(B, 6), (B, 4), (B,), (B, ATTEMPTS, 4), (B,)]
    assert a.crop_option.dtype == torch.int64
    assert int(a.crop_option.min()) >= 0 and int(a.crop_option.max()) < 6
    for x in a:
        if x.is_floating_point():
            assert float(x.min()) >= 0.0 and float(x.max()) < 1.0
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.crop_rects, c.crop_rects)


# --- the cases of tests/test_augment_device.py -----------------------------------------


def _sample_image(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (S, S, 3)).astype(np.float32)
    boxes = np.array([[0.5, 0.5, 0.5, 0.5], [0.2, 0.2, 0.1, 0.1]], np.float32)
    labels = np.array([3, 5], np.int32)
    return img, boxes, labels


def _geometry(img, boxes, labels, window, rect, flip):
    return apply_geometry(
        torch.from_numpy(img[None]), torch.from_numpy(boxes[None]), torch.from_numpy(labels[None]),
        torch.ones((1, len(boxes)), dtype=torch.bool), torch.tensor([window]), torch.tensor([rect]),
        torch.tensor([flip]),
    )


def test_identity_geometry_is_exact():
    img, boxes, labels = _sample_image()
    out_img, out_boxes, out_cls, out_valid = _geometry(
        img, boxes, labels, [0.0, 0.0, 1.0, 1.0], [0.0, 0.0, 1.0, 1.0], False)
    np.testing.assert_array_equal(out_img[0].numpy(), img)  # 0/1 weights: exact
    np.testing.assert_allclose(out_boxes[0].numpy(), boxes, atol=1e-6)
    assert bool(out_valid.all())
    np.testing.assert_array_equal(out_cls[0].numpy(), labels)


def test_flip_geometry_matches_numpy_mirror():
    img, boxes, labels = _sample_image(1)
    out_img, out_boxes, _, out_valid = _geometry(
        img, boxes, labels, [0.0, 0.0, 1.0, 1.0], [0.0, 0.0, 1.0, 1.0], True)
    np.testing.assert_array_equal(out_img[0].numpy(), img[:, ::-1])  # pixel centers: exact
    want = boxes.copy()
    want[:, 0] = 1.0 - want[:, 0]
    np.testing.assert_allclose(out_boxes[0].numpy(), want, atol=1e-6)
    assert bool(out_valid.all())


class ScriptedRng:
    """Replays a fixed script of draws through the numpy Generator calls that
    data/augment.py makes, so the host's rejection loops land on a chosen geometry."""

    def __init__(self, script):
        self._script = list(script)

    def _next(self):
        assert self._script, "script exhausted"
        return self._script.pop(0)

    def uniform(self, low=0.0, high=1.0):
        v = self._next()
        assert low <= v <= high, (v, low, high)
        return v

    def integers(self, low, high):
        v = self._next()
        assert low <= v < high, (v, low, high)
        return int(v)


def test_expand_crop_golden_vs_host_recipe():
    """Expand ratio 2 at integer offsets, then a 0.5x min-IoU crop at integer pixel
    boundaries, through the host recipe (scripted rng) and apply_geometry: boxes equal,
    pixels within the bilinear and fill tolerance of the JAX test."""
    img, boxes, labels = _sample_image(2)
    h_img, h_boxes = random_expand(img, boxes, ScriptedRng([0.0, 2.0, 32.0, 16.0]), p=0.5)
    assert h_img.shape == (128, 128, 3)
    cropped = random_min_iou_crop(h_img, h_boxes, labels, ScriptedRng([1, 0.5, 0.5, 0.25, 0.25]))
    assert cropped is not None
    h_patch, h_cboxes, h_clabels = cropped
    assert h_patch.shape == (S, S, 3)

    window = [16 / 128, 32 / 128, (16 + S) / 128, (32 + S) / 128]
    out_img, out_boxes, out_cls, out_valid = _geometry(
        img, boxes, labels, window, [0.25, 0.25, 0.75, 0.75], False)
    kept = out_valid[0].numpy()
    assert kept.tolist() == [True, False]  # the corner box's center is outside the crop
    assert h_clabels.tolist() == out_cls[0].numpy()[kept].tolist()
    np.testing.assert_allclose(out_boxes[0].numpy()[kept], h_cboxes, atol=1e-5)
    np.testing.assert_allclose(out_img[0].numpy(), h_patch, atol=2.5 / 255)


def test_fill_region_is_image_mean():
    img, boxes, labels = _sample_image(3)
    # the window maps the image to the left half; the right half of the output is fill
    out_img, *_ = _geometry(img, boxes, labels, [0.0, 0.0, 0.5, 1.0], [0.0, 0.0, 1.0, 1.0], False)
    fill = img.mean(axis=(0, 1))
    np.testing.assert_allclose(out_img[0, :, -16:, :].numpy(), np.broadcast_to(fill, (S, 16, 3)),
                               atol=2.5 / 255)


def test_photometric_matches_host_ops():
    img, _, _ = _sample_image(4)
    u = torch.tensor([[0.1, 0.75, 0.2, 0.5, 0.3, 0.25]])
    got = photometric(torch.from_numpy(img[None]), u, 0.5)[0].numpy()
    want = np.clip(img + (0.75 * 0.24 - 0.12), 0, 1)
    want = np.clip((want - 0.5) * (0.7 + 0.5 * 0.6) + 0.5, 0, 1)
    gray = want.mean(axis=2, keepdims=True)
    want = np.clip(gray + (want - gray) * (0.7 + 0.25 * 0.6), 0, 1)
    np.testing.assert_allclose(got, want, atol=1e-6)
