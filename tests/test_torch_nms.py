"""Port NMS (ops/nms.py) against the JAX package on identical numpy inputs.

Tolerances: `valid` and `classes` bit-equal (keep sets and their order decide them, and
both packages break every tie toward the lower index); scores and boxes atol 1e-6
(they are copied or gathered exactly, so in practice they are equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_object_detection_tpu.ops import nms as jax_nms
from ssd_object_detection_tpu_torch.ops import boxes as box_ops
from ssd_object_detection_tpu_torch.ops import nms

torch.set_num_threads(1)


def _assert_same(got: nms.Detections, want) -> None:
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    assert got.classes.dtype == torch.int32 and got.scores.dtype == torch.float32
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-6, rtol=0)


def _dets(boxes_cxcywh, class_scores):
    boxes = torch.tensor(boxes_cxcywh, dtype=torch.float32)[None]
    scores = torch.tensor(class_scores, dtype=torch.float32)[None]
    return nms.batched_nms(boxes, scores, iou_thresh=0.5, score_thresh=0.05,
                           top_k_per_class=8, max_detections=8)


# --- the cases of tests/test_nms.py -------------------------------------------------


def test_suppresses_overlapping_keeps_best():
    boxes = [[0.5, 0.5, 0.2, 0.2], [0.51, 0.5, 0.2, 0.2], [0.1, 0.1, 0.1, 0.1]]
    det = _dets(boxes, [[0.9], [0.8], [0.7]])
    assert int(det.valid[0].sum()) == 2
    np.testing.assert_allclose(det.scores[0, :2].numpy(), [0.9, 0.7], atol=1e-6)
    np.testing.assert_allclose(det.boxes[0, 0].numpy(), boxes[0], atol=1e-6)


def test_classes_do_not_suppress_each_other():
    det = _dets([[0.5, 0.5, 0.2, 0.2], [0.5, 0.5, 0.2, 0.2]], [[0.9, 0.0], [0.0, 0.8]])
    assert int(det.valid[0].sum()) == 2
    assert sorted(det.classes[0][det.valid[0]].tolist()) == [0, 1]


def test_score_threshold_filters():
    det = _dets([[0.5, 0.5, 0.2, 0.2], [0.1, 0.1, 0.1, 0.1]], [[0.9], [0.01]])
    assert int(det.valid[0].sum()) == 1


def test_chain_suppression_revives_third_box():
    """B overlaps A and C; A and C don't overlap. Greedy NMS keeps A and C, which
    takes the fixpoint more than one iteration."""
    a, b, c = [0.30, 0.5, 0.20, 0.2], [0.35, 0.5, 0.20, 0.2], [0.40, 0.5, 0.20, 0.2]
    assert float(box_ops.iou_pair(torch.tensor(a), torch.tensor(b))) > 0.5
    assert float(box_ops.iou_pair(torch.tensor(a), torch.tensor(c))) < 0.5
    calls, iters = nms.suppress_fixpoint.calls, nms.suppress_fixpoint.iterations
    det = _dets([a, b, c], [[0.9], [0.8], [0.7]])
    assert nms.suppress_fixpoint.calls == calls + 1
    assert nms.suppress_fixpoint.iterations - iters == 3  # alive changes twice, then stops
    assert int(det.valid[0].sum()) == 2
    np.testing.assert_allclose(det.boxes[0][det.valid[0]].numpy(), [a, c], atol=1e-6)
    want = jax_nms.batched_nms(jnp.float32([[a, b, c]]), jnp.float32([[[0.9], [0.8], [0.7]]]),
                               iou_thresh=0.5, score_thresh=0.05, top_k_per_class=8,
                               max_detections=8)
    _assert_same(det, want)


def test_batched_and_static_shapes():
    rng = np.random.default_rng(0)
    boxes = np.concatenate(
        [rng.uniform(0.2, 0.8, (3, 50, 2)), rng.uniform(0.05, 0.2, (3, 50, 2))], -1
    ).astype(np.float32)
    scores = rng.uniform(0, 1, (3, 50, 4)).astype(np.float32)
    det = nms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                          max_detections=10, top_k_per_class=16)
    assert det.boxes.shape == (3, 10, 4)
    assert det.scores.shape == (3, 10) and det.classes.shape == (3, 10)
    assert (np.diff(det.scores.numpy(), axis=1) <= 1e-6).all()


# --- against JAX on random and tie-heavy inputs --------------------------------------


def _pool(seed: int, batch: int, n: int, c: int, ties: bool):
    """Pooled candidates: cxcywh boxes (B, N, 4) and thresholded scores (B, N, C).
    Tie-heavy pools quantize scores to 1/64 and repeat boxes, so the keep sets depend
    on the tie order of every sort."""
    rng = np.random.default_rng(seed)
    boxes = np.concatenate(
        [rng.uniform(0.2, 0.8, (batch, n, 2)), rng.uniform(0.05, 0.4, (batch, n, 2))], -1
    ).astype(np.float32)
    scores = rng.uniform(0, 1, (batch, n, c)).astype(np.float32)
    if ties:
        scores = np.floor(scores * 64) / 64
        boxes[:, n // 2:] = boxes[:, : n - n // 2]
        scores[:, ::3] = scores[:, 1::3][:, : scores[:, ::3].shape[1]].max()
    scores = np.where(scores >= 0.3, scores, 0.0).astype(np.float32)
    return boxes, scores


CASES = [(seed, ties) for seed in range(2) for ties in (False, True)]


@pytest.mark.parametrize("seed,ties", CASES)
def test_nms_on_pool_matches_jax(seed, ties):
    boxes, scores = _pool(seed, 2, 60, 5, ties)
    got = nms.nms_on_pool(torch.from_numpy(boxes), torch.from_numpy(scores),
                          top_k_per_class=20, max_detections=30)
    want = jax_nms.nms_on_pool(jnp.asarray(boxes), jnp.asarray(scores),
                               top_k_per_class=20, max_detections=30)
    _assert_same(got, want)


@pytest.mark.parametrize("per_anchor_top2", [False, True])
@pytest.mark.parametrize("seed,ties", CASES)
def test_nms_on_pool_merged_matches_jax(seed, ties, per_anchor_top2):
    boxes, scores = _pool(seed + 10, 2, 60, 5, ties)
    kw = dict(merged_top_k=64, max_detections=30, per_anchor_top2=per_anchor_top2)
    got = nms.nms_on_pool_merged(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    want = jax_nms.nms_on_pool_merged(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    _assert_same(got, want)


@pytest.mark.parametrize("seed,ties", CASES)
def test_batched_nms_matches_jax(seed, ties):
    boxes, scores = _pool(seed + 20, 2, 120, 4, ties)
    kw = dict(iou_thresh=0.45, score_thresh=0.35, pre_nms_top_k=50, top_k_per_class=16,
              max_detections=20)
    got = nms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    want = jax_nms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    _assert_same(got, want)


def test_suppress_fixpoint_stops_at_its_cap():
    """A chain of 20 boxes, each suppressing only the next: greedy keeps every other
    box, which needs more than 16 iterations, so both packages stop at the cap."""
    k = 20
    tri = np.zeros((1, k, k), bool)
    tri[0, np.arange(k - 1), np.arange(1, k)] = True
    got = nms.suppress_fixpoint(torch.from_numpy(tri))
    want = jax_nms._suppress_fixpoint(jnp.asarray(tri, jnp.bfloat16))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
