"""Batched inference: forward -> candidate pool -> softmax/decode on the pool -> NMS,
port of ssd_object_detection_tpu/eval/predict.py.

Anchors are ranked in logit space: max_c p_c = exp(max_fg_logit - logsumexp) is
monotone in (max_fg_logit - logsumexp), so the class-agnostic pool of
`pre_nms_top_k` anchors is chosen from two (B, D) passes, and softmax, box decode and
NMS then run on the pooled candidates only. With nms_mode="per_class" the result is
that of ops/nms.batched_nms on fully materialized scores; the default "merged" examines
only the global top-M (anchor, class) pairs (ops/nms.nms_on_pool_merged).

Each path is an nn.Module (`Detector`, `FusedDetector`) around the port's SSD module and
its anchors, returning the four Detections tensors as a tuple: eval/serve.py exports
these modules with torch.export. The factories wrap them as `predict(images)` /
`predict(canvas_u8, sizes)`, which run under torch.inference_mode() on the model's
device (the model is already there).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ssd_object_detection_tpu_torch.ops import boxes as box_ops
from ssd_object_detection_tpu_torch.ops.nms import (
    Detections,
    nms_on_pool,
    nms_on_pool_merged,
    top_k_stable,
)
from ssd_object_detection_tpu_torch.ops.preprocess import normalize01, resize_bilinear_planar
from ssd_object_detection_tpu_torch.utils.device import true_divide

NMS_MODES = ("per_class", "merged", "merged_top2")


def detect_from_logits(
    pred_loc: torch.Tensor,  # (B, D, 4)
    pred_logits: torch.Tensor,  # (B, D, C) raw, background LAST
    anchors: torch.Tensor,  # (D, 4)
    variances: Optional[Tuple[float, float]] = None,
    iou_thresh: float = 0.45,
    score_thresh: float = 0.01,
    pre_nms_top_k: int = 400,
    top_k_per_class: int = 100,
    max_detections: int = 100,
    # "merged" (torchvision-style) | "merged_top2" (merged with per-anchor top-2 class
    # candidates; see ops/nms.nms_on_pool_merged) | "per_class"
    nms_mode: str = "merged",
    merged_top_k: Optional[int] = None,  # merged mode's global pool; None = auto
) -> Detections:
    """Logits -> Detections, the heavy work restricted to the candidate pool.

    `top_k_per_class` applies to nms_mode="per_class"; `merged_top_k` (None = a 2.56x
    max_detections margin) to the merged modes."""
    if nms_mode not in NMS_MODES:
        raise ValueError(f"unknown nms_mode {nms_mode!r}: "
                         "expected 'per_class', 'merged' or 'merged_top2'")
    _, num_anchors, num_ch = pred_logits.shape

    # Stage 1 in logit space. The max reductions are exact in any dtype; the
    # logsumexp runs in float32, so bf16 logits rank exactly as their float32 casts.
    amax = pred_logits.max(dim=-1).values.float()  # (B, D)
    lse = torch.log(torch.exp(pred_logits.float() - amax[..., None]).sum(dim=-1)) + amax
    fg_max = pred_logits[..., :-1].max(dim=-1).values.float()
    n_pool = min(pre_nms_top_k, num_anchors)
    _, pool_idx = top_k_stable(fg_max - lse, n_pool)  # (B, N)

    # Pooled softmax + decode; the gather reads the logits in their stored dtype.
    pool_logits = torch.gather(
        pred_logits, 1, pool_idx[..., None].expand(*pool_idx.shape, num_ch)
    ).float()  # (B, N, C)
    pool_probs = torch.softmax(pool_logits, dim=-1)[..., :-1]  # strip background
    pool_probs = torch.where(pool_probs >= score_thresh, pool_probs, 0.0)
    pool_loc = torch.gather(pred_loc, 1, pool_idx[..., None].expand(*pool_idx.shape, 4))
    pool_boxes = box_ops.decode_boxes(pool_loc, anchors[pool_idx], variances=variances)

    # Stages 2-4: the pooled-candidate core (ops/nms.py).
    if nms_mode in ("merged", "merged_top2"):
        return nms_on_pool_merged(
            pool_boxes, pool_probs,
            iou_thresh=iou_thresh, merged_top_k=merged_top_k,
            max_detections=max_detections,
            per_anchor_top2=(nms_mode == "merged_top2"),
        )
    return nms_on_pool(
        pool_boxes, pool_probs,
        iou_thresh=iou_thresh, top_k_per_class=top_k_per_class,
        max_detections=max_detections,
    )


def _model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


class _DetectHead(nn.Module):
    """The SSD module, its anchors (a buffer on the model's device) and the keyword
    arguments of detect_from_logits (its defaults where one is left out)."""

    def __init__(self, model: nn.Module, anchors, detect_kw: Dict):
        super().__init__()
        self.model = model
        anchors_t = torch.as_tensor(np.asarray(anchors, np.float32))
        self.register_buffer("anchors", anchors_t.to(_model_device(model)), persistent=False)
        self.detect_kw = detect_kw

    def detect(self, images01: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        pred_loc, pred_logits = self.model(normalize01(images01))
        return tuple(detect_from_logits(pred_loc, pred_logits, self.anchors, **self.detect_kw))


class Detector(_DetectHead):
    """images (B, S, S, 3), float32 in [0, 1] or uint8 (scaled on the device) ->
    (boxes, scores, classes, valid)."""

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if images.dtype == torch.uint8:  # device-side scaling, 4x less host-to-device
            images = true_divide(images.float(), 255.0)
        return self.detect(images)


class FusedDetector(_DetectHead):
    """planar uint8 canvas (B, 3, Hc, Wc) + per-image (h, w) sizes (B, 2) int32 ->
    on-device resize -> normalize -> forward -> decode -> NMS ->
    (boxes, scores, classes, valid)."""

    def __init__(self, model: nn.Module, anchors, image_size: int, resize_method: str,
                 detect_kw: Dict):
        super().__init__(model, anchors, detect_kw)
        self.image_size = image_size
        self.resize_method = resize_method

    def forward(self, canvas_u8: torch.Tensor, sizes: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.detect(resize_bilinear_planar(canvas_u8, sizes, self.image_size,
                                                  method=self.resize_method))


def make_predict_fn(
    model: nn.Module,
    anchors,
    variances: Optional[Tuple[float, float]] = None,
    iou_thresh: float = 0.45,
    score_thresh: float = 0.01,
    pre_nms_top_k: int = 400,
    top_k_per_class: int = 100,
    max_detections: int = 100,
    nms_mode: str = "merged",
    merged_top_k: Optional[int] = None,
) -> Callable:
    """Returns predict(images) -> Detections (boxes relative cxcywh).

    `images` (B, S, S, 3) are float32 in [0, 1] or uint8 in [0, 255] (scaled on the
    device), as numpy arrays or tensors; normalization to [-1, 1] happens inside."""
    detector = Detector(model, anchors, dict(
        variances=variances, iou_thresh=iou_thresh, score_thresh=score_thresh,
        pre_nms_top_k=pre_nms_top_k, top_k_per_class=top_k_per_class,
        max_detections=max_detections, nms_mode=nms_mode, merged_top_k=merged_top_k))
    device = detector.anchors.device

    @torch.inference_mode()
    def predict(images) -> Detections:
        return Detections(*detector(torch.as_tensor(images).to(device, non_blocking=True)))

    return predict


def make_fused_predict_fn(
    model: nn.Module,
    anchors,
    image_size: int = 300,
    variances: Optional[Tuple[float, float]] = None,
    iou_thresh: float = 0.45,
    score_thresh: float = 0.01,
    pre_nms_top_k: int = 400,
    top_k_per_class: int = 100,
    max_detections: int = 100,
    nms_mode: str = "merged",
    merged_top_k: Optional[int] = None,
    resize_method: str = "matmul",
) -> Callable:
    """Fully on-device inference: the host only decodes images; resize, normalization,
    forward, softmax, decode and NMS run on the model's device.

    Returns predict(canvas_u8, sizes) -> Detections, where `canvas_u8` is a planar
    (B, 3, Hc, Wc) uint8 canvas and `sizes` the per-image (h, w) extents (both from
    ops/preprocess.pack_canvas). `resize_method`: "matmul" (bf16 weight rounding,
    ops/preprocess.py) or "gather" (exact float32 arithmetic)."""
    detector = FusedDetector(model, anchors, image_size, resize_method, dict(
        variances=variances, iou_thresh=iou_thresh, score_thresh=score_thresh,
        pre_nms_top_k=pre_nms_top_k, top_k_per_class=top_k_per_class,
        max_detections=max_detections, nms_mode=nms_mode, merged_top_k=merged_top_k))
    device = detector.anchors.device

    @torch.inference_mode()
    def predict(canvas_u8, sizes) -> Detections:
        return Detections(*detector(torch.as_tensor(canvas_u8).to(device, non_blocking=True),
                                    torch.as_tensor(sizes).to(device, non_blocking=True)))

    return predict
