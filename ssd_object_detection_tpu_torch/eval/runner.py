"""Evaluation runner: stream batches through a predict function into the mAP evaluator,
port of ssd_object_detection_tpu/eval/runner.py.

The predict function closes over its model (eval/predict.py), so there is no `params`
argument. The four detection tensors come to the host in one copy per batch: they are
packed into one float32 tensor on the device (classes and validity are small integers,
exact in float32) and fetched with a single `.cpu()`, instead of one synchronizing
fetch per field or per image.

With a data-parallel `mesh` (parallel/mesh.py) every rank reads the same batches and
predicts its rows of each. A batch that does not split evenly over the ranks (the
epoch's remainder) is padded with zero images, to the steady batch size where one has
been seen, else to the next multiple of the ranks. The packed detections are all-gathered
in rank order, the padding's are sliced off, and every rank scores the whole batch, so
the metrics are those of one process.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ssd_object_detection_tpu_torch.eval.coco_map import DetectionEvaluator

logger = logging.getLogger(__name__)


def _cxcywh_to_xyxy(boxes: np.ndarray) -> np.ndarray:
    """numpy float32 cxcywh -> xyxy, in the operation order of ops/boxes.py."""
    half = boxes[..., 2:] * np.float32(0.5)
    return np.concatenate([boxes[..., :2] - half, boxes[..., :2] + half], axis=-1)


def _fetch_detections(det, mesh=None):
    """(boxes, scores, classes, valid) as numpy arrays, in one device-to-host copy; with
    a mesh, every rank's in rank order."""
    packed = torch.cat([
        det.boxes.float(), det.scores.float()[..., None],
        det.classes.float()[..., None], det.valid.float()[..., None],
    ], dim=-1)
    if mesh is not None:
        parts = [torch.empty_like(packed) for _ in range(mesh.size)]
        dist.all_gather(parts, packed.contiguous(), group=mesh.data_group)
        packed = torch.cat(parts)
    packed = packed.cpu().numpy()
    return (packed[..., :4], packed[..., 4], packed[..., 5].astype(np.int32),
            packed[..., 6] > 0.5)


def _rank_images(images, mesh, steady: Optional[int]):
    """This rank's rows of `images`, zero-padded first to a size that splits evenly."""
    images = torch.as_tensor(np.asarray(images) if not isinstance(images, torch.Tensor) else images)
    true_b = images.shape[0]
    if true_b % mesh.size:
        pad_to = steady if steady is not None and steady > true_b else -(-true_b // mesh.size) * mesh.size
        images = torch.cat([images, images.new_zeros((pad_to - true_b,) + tuple(images.shape[1:]))])
    return mesh.shard().take(images)


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
    COCO-comparable. Without `orig_size` the image side is the scale. With `mesh`, see
    the module's docstring.
    """
    evaluator = DetectionEvaluator(num_classes=num_classes)
    steady = None  # the first batch size that splits over the mesh: remainders pad to it
    n = 0
    for batch in batches:
        images = batch["image"]
        true_b = images.shape[0]
        if mesh is not None:
            if steady is None and true_b % mesh.size == 0:
                steady = true_b
            images = _rank_images(images, mesh, steady)
        det = _fetch_detections(predict_fn(images), mesh)
        det_boxes, det_scores, det_classes, det_valid = (x[:true_b] for x in det)
        for b in range(true_b):
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
