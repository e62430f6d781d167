"""Evaluation runner: stream batches through a predict function into the mAP evaluator,
port of ssd_object_detection_tpu/eval/runner.py (single device).

The predict function closes over its model (eval/predict.py), so there is no `params`
argument. The four detection tensors come to the host in one copy per batch: they are
packed into one float32 tensor on the device (classes and validity are small integers,
exact in float32) and fetched with a single `.cpu()`, instead of one synchronizing
fetch per field or per image.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ssd_object_detection_tpu_torch.eval.coco_map import DetectionEvaluator

logger = logging.getLogger(__name__)


def _cxcywh_to_xyxy(boxes: np.ndarray) -> np.ndarray:
    """numpy float32 cxcywh -> xyxy, in the operation order of ops/boxes.py."""
    half = boxes[..., 2:] * np.float32(0.5)
    return np.concatenate([boxes[..., :2] - half, boxes[..., :2] + half], axis=-1)


def _fetch_detections(det):
    """(boxes, scores, classes, valid) as numpy arrays, in one device-to-host copy."""
    packed = torch.cat([
        det.boxes.float(), det.scores.float()[..., None],
        det.classes.float()[..., None], det.valid.float()[..., None],
    ], dim=-1).cpu().numpy()
    return (packed[..., :4], packed[..., 4], packed[..., 5].astype(np.int32),
            packed[..., 6] > 0.5)


def evaluate_batches(
    predict_fn: Callable,
    batches: Iterable[Dict[str, np.ndarray]],
    num_classes: int = 80,
    max_batches: Optional[int] = None,
    mesh=None,
) -> Dict[str, float]:
    """Run prediction over batches and compute COCO-style mAP.

    Batches carry relative-cxcywh GTs and optionally `orig_size` (h, w); predictions
    and GTs are both scaled to original-pixel xyxy before matching, so the numbers are
    COCO-comparable. Without `orig_size` the image side is the scale.
    """
    if mesh is not None:
        raise NotImplementedError("data-parallel evaluation is not ported yet (ROADMAP A12)")
    evaluator = DetectionEvaluator(num_classes=num_classes)
    n = 0
    for batch in batches:
        det_boxes, det_scores, det_classes, det_valid = _fetch_detections(predict_fn(batch["image"]))
        for b in range(det_boxes.shape[0]):
            if "orig_size" in batch:
                h, w = (int(x) for x in batch["orig_size"][b])
            else:
                h = w = batch["image"].shape[1]
            scale = np.array([w, h, w, h], np.float32)

            keep = det_valid[b]
            g_valid = np.asarray(batch["gt_valid"][b]).astype(bool)
            # crowd GTs are matchable-but-ignored (COCOeval semantics); pipelines
            # without the flag (synthetic) evaluate every GT as real
            g_crowd = (
                np.asarray(batch["gt_crowd"][b]).astype(bool)[g_valid]
                if "gt_crowd" in batch else None
            )
            evaluator.add_image(
                det_boxes=_cxcywh_to_xyxy(det_boxes[b][keep] * scale),
                det_scores=det_scores[b][keep],
                det_classes=det_classes[b][keep],
                gt_boxes=_cxcywh_to_xyxy(np.asarray(batch["gt_boxes"][b])[g_valid] * scale),
                gt_classes=np.asarray(batch["gt_cls"][b])[g_valid],
                gt_ignore=g_crowd,
            )
        n += 1
        if max_batches is not None and n >= max_batches:
            break
    metrics = evaluator.summarize()
    logger.info("evaluated %d batches: %s", n, metrics)
    return metrics
