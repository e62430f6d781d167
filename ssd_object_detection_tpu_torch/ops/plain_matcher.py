"""The plain PyTorch greedy anchor matcher, batched over images.

`match_anchors` is the port of ssd_object_detection_tpu/ops/matching.py::match_anchors:

  phase 1 — `num_valid` greedy picks per image: the flat row-major first maximum of
    the masked (G, D) IoU matrix (lowest row, then lowest column), each pick consuming
    its row and its column (consumed cells read -2, invalid GT rows -1);
  phase 2 — every anchor that phase 1 did not consume takes its best GT when that IoU
    is strictly greater than `thresh` (lowest row wins ties).

It is the CPU route and the yardstick that the CUDA kernel (ops/cuda_matcher.py,
csrc/matcher.cu) is held to on the card. ops/matching.py re-exports it beside
`build_targets`, where the JAX package keeps both.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ssd_object_detection_tpu_torch.ops import boxes as box_ops


class MatchResult(NamedTuple):
    """Per-anchor targets, batched: (B, D) / (B, D, 4)."""

    cls: torch.Tensor  # (B, D) int32, class id of matched GT, 0 where unmatched
    box: torch.Tensor  # (B, D, 4) float32, matched GT cxcywh, 0 where unmatched
    mask: torch.Tensor  # (B, D) bool, True where the anchor is matched (positive)
    gt_index: torch.Tensor  # (B, D) int32, index of matched GT, -1 where unmatched


def match_anchors(
    gt_cls: torch.Tensor,  # (B, G) int32
    gt_boxes: torch.Tensor,  # (B, G, 4) cxcywh
    gt_valid: torch.Tensor,  # (B, G) bool
    anchors: torch.Tensor,  # (D, 4) cxcywh
    thresh: float = 0.5,
) -> MatchResult:
    """Batched plain matcher; bit-equal to vmap(JAX match_anchors) on every image."""
    batch, max_gt = gt_cls.shape
    num_anchors = anchors.shape[0]
    device = gt_boxes.device

    iou = box_ops.pairwise_iou(gt_boxes, anchors, legacy_clamp=True)  # (B, G, D)
    iou = torch.where(gt_valid[:, :, None], iou, torch.full_like(iou, -1.0))
    num_valid = gt_valid.sum(dim=1)  # (B,)

    # Phase 1: one step per valid GT; an image whose GTs are all placed sits out the
    # remaining steps. The IoU matrix stays read-only; removal lives in masks.
    row_removed = torch.zeros((batch, max_gt), dtype=torch.bool, device=device)
    col_removed = torch.zeros((batch, num_anchors), dtype=torch.bool, device=device)
    anchor_gt = torch.full((batch, num_anchors), -1, dtype=torch.int32, device=device)
    images = torch.arange(batch, device=device)
    minus_two = torch.tensor(-2.0, dtype=iou.dtype, device=device)
    for t in range(int(num_valid.max()) if batch else 0):
        active = num_valid > t
        masked = torch.where(row_removed[:, :, None] | col_removed[:, None, :], minus_two, iou)
        flat = torch.argmax(masked.reshape(batch, -1), dim=1)  # first maximum: lowest (row, col)
        row = torch.div(flat, num_anchors, rounding_mode="floor")
        col = flat - row * num_anchors
        row_removed[images, row] |= active
        col_removed[images, col] |= active
        anchor_gt[images, col] = torch.where(active, row.to(torch.int32), anchor_gt[images, col])

    # Phase 2: per-anchor best GT with IoU strictly > thresh, on columns phase 1 left.
    col_best = iou.amax(dim=1)
    col_row = torch.argmax(iou, dim=1).to(torch.int32)  # first maximum: lowest row
    thresh_t = torch.tensor(thresh, dtype=iou.dtype, device=device)
    hit = (anchor_gt < 0) & (col_best > thresh_t) & ~col_removed
    anchor_gt = torch.where(hit, col_row, anchor_gt)

    mask = anchor_gt >= 0
    safe_idx = torch.clamp(anchor_gt, min=0).long()
    matched_cls = torch.where(mask, torch.gather(gt_cls, 1, safe_idx).to(torch.int32), 0)
    matched_box = torch.gather(gt_boxes, 1, safe_idx[:, :, None].expand(-1, -1, 4))
    matched_box = torch.where(mask[:, :, None], matched_box, torch.zeros_like(matched_box))
    return MatchResult(cls=matched_cls, box=matched_box, mask=mask, gt_index=anchor_gt)
