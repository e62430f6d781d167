"""Port predict path (eval/predict.py) against the JAX package on identical inputs.

Tolerances: `valid` and `classes` bit-equal everywhere (keep sets and their order);
from the same logits, scores atol 1e-6 and boxes atol 1e-6 (softmax, exp and log may
differ by an ulp between XLA and PyTorch); through the networks (same weights, float32)
scores and boxes rtol 2e-4 / atol 2e-5, the forward tolerance of
tests/test_torch_model.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_object_detection_tpu.eval import predict as jax_predict
from ssd_object_detection_tpu.models.ssd import SSD as JaxSSD
from ssd_object_detection_tpu.ops import preprocess as jax_pre
from ssd_object_detection_tpu.ops.anchors import generate_anchors
from ssd_object_detection_tpu_torch.eval.predict import (
    detect_from_logits,
    make_fused_predict_fn,
    make_predict_fn,
)
from ssd_object_detection_tpu_torch.models.convert import from_flax_params
from ssd_object_detection_tpu_torch.models.ssd import SSD
from ssd_object_detection_tpu_torch.ops import boxes as box_ops
from ssd_object_detection_tpu_torch.ops.nms import batched_nms, nms_on_pool_merged
from tests.test_torch_train_step import PORT_TINY
from tests.test_train_step import NUM_CLASSES, TINY_ANCHORS, TINY_MODEL

torch.set_num_threads(1)


def _anchors(rng, d, wh=(0.05, 0.3)):
    return np.concatenate(
        [rng.uniform(0.1, 0.9, (d, 2)), rng.uniform(*wh, (d, 2))], -1
    ).astype(np.float32)


def _assert_same(got, want, atol=1e-6, rtol=0.0):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=atol, rtol=rtol)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=atol, rtol=rtol)


def _t(a):
    return torch.from_numpy(np.array(a))


# --- detect_from_logits against JAX, from the same logits -----------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nms_mode", ["per_class", "merged", "merged_top2"])
def test_detect_from_logits_matches_jax(nms_mode, dtype):
    rng = np.random.default_rng(0)
    b, d, c = 2, 500, 9  # C includes background (last)
    anchors = _anchors(rng, d)
    pred_loc = (rng.normal(size=(b, d, 4)) * 0.1).astype(np.float32)
    logits = (rng.normal(size=(b, d, c)) * 2).astype(np.float32)
    logits[..., -1] += 2.0
    kw = dict(pre_nms_top_k=100, top_k_per_class=50, max_detections=60, nms_mode=nms_mode,
              merged_top_k=128, score_thresh=0.05)
    jax_logits = jnp.asarray(logits, jnp.dtype(dtype))
    want = jax_predict.detect_from_logits(jnp.asarray(pred_loc), jax_logits, jnp.asarray(anchors), **kw)
    port_logits = _t(np.asarray(jax_logits.astype(jnp.float32))).to(getattr(torch, dtype))
    got = detect_from_logits(_t(pred_loc), port_logits, _t(anchors), **kw)
    assert int(got.valid.sum()) > 10
    _assert_same(got, want)


def test_detect_from_logits_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown nms_mode"):
        detect_from_logits(torch.zeros(1, 4, 4), torch.zeros(1, 4, 3), torch.zeros(4, 4),
                           nms_mode="greedy")


# --- the cases of tests/test_fused_predict.py ------------------------------------------


def test_fused_predict_matches_reference_path():
    rng = np.random.default_rng(0)
    b, d, c = 2, 500, 9
    anchors = _anchors(rng, d)
    pred_loc = torch.from_numpy((rng.normal(size=(b, d, 4)) * 0.1).astype(np.float32))
    logits = torch.from_numpy((rng.normal(size=(b, d, c)) * 2).astype(np.float32))
    kw = dict(pre_nms_top_k=100, top_k_per_class=50, max_detections=60)
    fused = detect_from_logits(pred_loc, logits, _t(anchors), nms_mode="per_class", **kw)
    probs = torch.softmax(logits, dim=-1)[..., :-1]
    ref = batched_nms(box_ops.decode_boxes(pred_loc, _t(anchors)[None]), probs, **kw)
    np.testing.assert_array_equal(fused.valid.numpy(), ref.valid.numpy())
    np.testing.assert_array_equal(fused.classes.numpy(), ref.classes.numpy())
    np.testing.assert_allclose(fused.scores.numpy(), ref.scores.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(fused.boxes.numpy(), ref.boxes.numpy(), rtol=1e-4, atol=1e-6)


def test_fused_predict_empty_scene():
    anchors = _anchors(np.random.default_rng(1), 100)
    logits = torch.zeros(1, 100, 5)
    logits[..., -1] = 20.0  # everything confidently background
    det = detect_from_logits(torch.zeros(1, 100, 4), logits, _t(anchors))
    assert not det.valid.any()
    assert (det.classes == -1).all() and (det.scores == 0).all() and (det.boxes == 0).all()


def test_merged_mode_matches_per_class_on_sparse_scene():
    rng = np.random.default_rng(2)
    b, d, c = 2, 300, 9
    anchors = _anchors(rng, d, wh=(0.05, 0.2))
    logits = np.full((b, d, c), -8.0, np.float32)
    logits[..., -1] = 8.0
    for i, cls in ((5, 0), (50, 3), (120, 7), (200, 1)):
        logits[:, i, cls] = 9.0
        logits[:, i, -1] = -9.0
    kw = dict(pre_nms_top_k=100, max_detections=20, score_thresh=0.2)
    merged = detect_from_logits(torch.zeros(b, d, 4), _t(logits), _t(anchors), nms_mode="merged", **kw)
    per_class = detect_from_logits(torch.zeros(b, d, 4), _t(logits), _t(anchors),
                                   nms_mode="per_class", **kw)
    np.testing.assert_array_equal(merged.valid.numpy(), per_class.valid.numpy())
    np.testing.assert_array_equal(merged.classes.numpy(), per_class.classes.numpy())
    np.testing.assert_allclose(merged.boxes.numpy(), per_class.boxes.numpy(), atol=1e-6)


def test_merged_mode_suppresses_within_class_only():
    boxes = torch.tensor([[[0.5, 0.5, 0.2, 0.2], [0.52, 0.5, 0.2, 0.2], [0.9, 0.9, 0.1, 0.1]]])
    scores = torch.zeros(1, 3, 2)
    scores[0, 0, 0] = 0.9
    scores[0, 1, 0] = 0.8  # same class, heavy overlap -> suppressed
    scores[0, 1, 1] = 0.7  # different class, same box -> survives
    scores[0, 2, 1] = 0.6
    det = nms_on_pool_merged(boxes, scores, iou_thresh=0.5)
    got = sorted((round(float(s), 2), int(c))
                 for s, c, v in zip(det.scores[0], det.classes[0], det.valid[0]) if v)
    assert got == [(0.6, 1), (0.7, 1), (0.9, 0)], got


def test_merged_top2_matches_merged_on_trained_like_scores():
    rng = np.random.default_rng(7)
    b, d, c = 2, 600, 9
    anchors = _anchors(rng, d)
    pred_loc = _t((rng.normal(size=(b, d, 4)) * 0.1).astype(np.float32))
    logits = rng.normal(size=(b, d, c)).astype(np.float32)
    logits[..., -1] += 6.0
    for i in range(b):
        fg = rng.choice(d, 40, replace=False)
        logits[i, fg, rng.integers(0, c - 1, 40)] += 12.0
    kw = dict(pre_nms_top_k=200, max_detections=50, score_thresh=0.01)
    full = detect_from_logits(pred_loc, _t(logits), _t(anchors), nms_mode="merged", **kw)
    top2 = detect_from_logits(pred_loc, _t(logits), _t(anchors), nms_mode="merged_top2", **kw)
    np.testing.assert_array_equal(full.valid.numpy(), top2.valid.numpy())
    np.testing.assert_array_equal(full.classes.numpy(), top2.classes.numpy())
    np.testing.assert_allclose(full.scores.numpy(), top2.scores.numpy(), atol=1e-7)
    np.testing.assert_allclose(full.boxes.numpy(), top2.boxes.numpy(), atol=1e-7)


def test_merged_top2_drops_third_class_of_same_anchor():
    boxes = torch.tensor([[[0.3, 0.3, 0.1, 0.1], [0.8, 0.8, 0.1, 0.1]]])
    scores = torch.zeros(1, 2, 4)
    scores[0, 0] = torch.tensor([0.9, 0.8, 0.7, 0.0])  # one anchor, three classes
    scores[0, 1, 3] = 0.5

    def kept(det):
        return sorted(round(float(s), 2) for s, v in zip(det.scores[0], det.valid[0]) if v)

    assert kept(nms_on_pool_merged(boxes, scores, iou_thresh=0.5)) == [0.5, 0.7, 0.8, 0.9]
    top2 = nms_on_pool_merged(boxes, scores, iou_thresh=0.5, per_anchor_top2=True)
    assert kept(top2) == [0.5, 0.8, 0.9]  # class 2 (0.7) dropped


def test_bf16_logits_detect_exactly_as_their_f32_cast():
    rng = np.random.default_rng(3)
    b, d, c = 2, 400, 9
    anchors = _t(_anchors(rng, d))
    loc = _t((rng.normal(size=(b, d, 4)) * 0.1).astype(np.float32))
    low = _t((rng.normal(size=(b, d, c)) * 3).astype(np.float32)).bfloat16()
    det16 = detect_from_logits(loc, low, anchors, pre_nms_top_k=50)
    det32 = detect_from_logits(loc, low.float(), anchors, pre_nms_top_k=50)
    for a, w in zip(det16, det32):
        assert torch.equal(a, w)


# --- the factories on a tiny network, against the JAX factories -------------------------


@pytest.fixture(scope="module")
def tiny_pair():
    """A JAX tiny SSD and the port's, with identical float32 weights whose class logits
    are spread wide (conf heads x8), so the candidates' scores are well separated."""
    model = JaxSSD(num_classes=NUM_CLASSES, spec=TINY_MODEL)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 8.0 if "conf_head" in jax.tree_util.keystr(path) else x, params)
    port = SSD(num_classes=NUM_CLASSES, spec=PORT_TINY)
    port.load_state_dict(from_flax_params(params))
    return model, params, port, generate_anchors(TINY_ANCHORS)


def test_make_predict_fn_matches_jax(tiny_pair):
    model, params, port, anchors = tiny_pair
    images = np.random.default_rng(4).integers(0, 256, (2, 64, 64, 3), np.uint8)
    kw = dict(score_thresh=0.2, pre_nms_top_k=100, max_detections=30)
    want = jax.jit(jax_predict.make_predict_fn(model.apply, anchors, **kw))(params, images)
    got = make_predict_fn(port, anchors, **kw)(images)
    assert int(got.valid.sum()) > 5
    _assert_same(got, want, atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("resize_method", ["matmul", "gather"])
def test_make_fused_predict_fn_matches_jax(tiny_pair, resize_method):
    model, params, port, anchors = tiny_pair
    rng = np.random.default_rng(5)
    images = [rng.integers(0, 256, hw + (3,), np.uint8) for hw in ((80, 96), (64, 64), (33, 90))]
    canvas, sizes = jax_pre.pack_canvas(images, (96, 96))
    kw = dict(image_size=64, score_thresh=0.2, pre_nms_top_k=100, max_detections=30,
              nms_mode="merged_top2", resize_method=resize_method)
    want = jax.jit(jax_predict.make_fused_predict_fn(model.apply, anchors, **kw))(params, canvas, sizes)
    got = make_fused_predict_fn(port, anchors, **kw)(canvas, sizes)
    assert int(got.valid.sum()) > 5
    _assert_same(got, want, atol=2e-5, rtol=2e-4)
