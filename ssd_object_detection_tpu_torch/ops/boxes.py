"""Box geometry primitives (cxcywh-centric), port of ssd_object_detection_tpu/ops/boxes.py.

Conventions:
  - "cxcywh": [center_x, center_y, width, height]; may be absolute pixels or relative.
  - "xyxy":   [x_min, y_min, x_max, y_max].
  - `legacy_clamp=True` reproduces the reference's IoU quirks bit-for-bit in float32:
    intersection side lengths clamped to a 1e-10 floor instead of 0, and a +1e-10
    union-denominator guard. The operation order below is the JAX package's, op for op
    (corners `c - w*0.5`, `((area_a + area_b) - inter) + 1e-10`, one IEEE division),
    because the matcher's integer outputs must be bit-equal to it and to the CUDA
    matcher (csrc/matcher.cu), which repeats the same order.

All functions are shape-polymorphic over leading batch dims.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ssd_object_detection_tpu_torch.utils.device import true_divide

_EPS = 1e-10


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] cxcywh -> xyxy."""
    cxy = boxes[..., :2]
    half = boxes[..., 2:] * 0.5
    return torch.cat([cxy - half, cxy + half], dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] xyxy -> cxcywh."""
    wh = boxes[..., 2:] - boxes[..., :2]
    cxy = (boxes[..., :2] + boxes[..., 2:]) * 0.5
    return torch.cat([cxy, wh], dim=-1)


def xywh_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """COCO [x_min, y_min, w, h] -> cxcywh."""
    cxy = boxes[..., :2] + boxes[..., 2:] * 0.5
    return torch.cat([cxy, boxes[..., 2:]], dim=-1)


def iou_pair(boxes_a: torch.Tensor, boxes_b: torch.Tensor, legacy_clamp: bool = False) -> torch.Tensor:
    """Elementwise IoU of two broadcast-compatible [..., 4] cxcywh tensors."""
    min_a = boxes_a[..., :2] - boxes_a[..., 2:] * 0.5
    max_a = boxes_a[..., :2] + boxes_a[..., 2:] * 0.5
    min_b = boxes_b[..., :2] - boxes_b[..., 2:] * 0.5
    max_b = boxes_b[..., :2] + boxes_b[..., 2:] * 0.5

    side = torch.minimum(max_a, max_b) - torch.maximum(min_a, min_b)
    side = torch.clamp(side, min=_EPS if legacy_clamp else 0.0)
    inter = side[..., 0] * side[..., 1]

    area_a = boxes_a[..., 2] * boxes_a[..., 3]
    area_b = boxes_b[..., 2] * boxes_b[..., 3]
    return inter / (area_a + area_b - inter + _EPS)


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor, legacy_clamp: bool = False) -> torch.Tensor:
    """Full [..., N, M] IoU matrix of cxcywh boxes [..., N, 4] x [..., M, 4]."""
    return iou_pair(boxes_a[..., :, None, :], boxes_b[..., None, :, :], legacy_clamp=legacy_clamp)


def encode_boxes(
    gt_boxes: torch.Tensor,
    anchors: torch.Tensor,
    variances: Optional[Tuple[float, float]] = None,
) -> torch.Tensor:
    """SSD offset encoding of cxcywh gt boxes against cxcywh anchors:
    xy = (gt_xy - a_xy) / a_wh, wh = log(max(gt_wh, 1e-5) / max(a_wh, 1e-5)), each
    divided by its variance when `variances` is given."""
    xy = (gt_boxes[..., :2] - anchors[..., :2]) / anchors[..., 2:]
    wh = torch.log(torch.clamp(gt_boxes[..., 2:], min=1e-5) / torch.clamp(anchors[..., 2:], min=1e-5))
    if variances is not None:
        xy = true_divide(xy, variances[0])
        wh = true_divide(wh, variances[1])
    return torch.cat([xy, wh], dim=-1)


def decode_boxes(
    pred: torch.Tensor,
    anchors: torch.Tensor,
    variances: Optional[Tuple[float, float]] = None,
    scale: float = 1.0,
) -> torch.Tensor:
    """Inverse of `encode_boxes` -> cxcywh boxes (optionally scaled to pixels)."""
    if variances is not None:
        pred = torch.cat([pred[..., :2] * variances[0], pred[..., 2:] * variances[1]], dim=-1)
    xy = (pred[..., :2] * anchors[..., 2:] + anchors[..., :2]) * scale
    wh = torch.exp(pred[..., 2:]) * anchors[..., 2:] * scale
    return torch.cat([xy, wh], dim=-1)
