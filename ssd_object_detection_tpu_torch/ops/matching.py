"""Anchor <-> ground-truth targets, port of ssd_object_detection_tpu/ops/matching.py.

`match_anchors` and `MatchResult` (the plain matcher, ops/plain_matcher.py) are
re-exported here, where the JAX package keeps them. `build_targets` matches and
encodes: CUDA tensors go to the hand-written kernel (ops/cuda_matcher.py), all others
(the CPU) to the plain matcher. There is no fallback from the kernel to the plain one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ssd_object_detection_tpu_torch.ops import boxes as box_ops
from ssd_object_detection_tpu_torch.ops.cuda_matcher import match_anchors_cuda
from ssd_object_detection_tpu_torch.ops.plain_matcher import MatchResult, match_anchors

__all__ = ["MatchResult", "build_targets", "match_anchors"]


def build_targets(
    gt_cls: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    anchors: torch.Tensor,
    thresh: float = 0.5,
    variances: Optional[Tuple[float, float]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched match + encode: (cls (B, D) int32, loc (B, D, 4), mask (B, D) bool).

    As in the JAX package, the encoder runs over ALL anchors, unmatched ones included
    (their target box is 0); the loss masks them.
    """
    matcher = match_anchors_cuda if gt_boxes.is_cuda else match_anchors
    matched = matcher(gt_cls, gt_boxes, gt_valid, anchors, thresh)
    loc = box_ops.encode_boxes(matched.box, anchors[None], variances=variances)
    return matched.cls, loc, matched.mask
