"""Batched, class-aware NMS with fixed shapes, port of ssd_object_detection_tpu/ops/nms.py.

Stages as in the JAX package: (1) a class-agnostic candidate pool of `pre_nms_top_k`
anchors per image (`batched_nms`), (2) a per-class top-K (`nms_on_pool`) or one global
top-M over (anchor, class) pairs (`nms_on_pool_merged`), (3) greedy suppression as a
fixpoint, (4) a final top-`max_detections`.

Greedy NMS as a fixpoint: the keep set is the unique solution of
    alive[j]  <=>  no i < j (score-descending order) with alive[i] and IoU(i, j) > t,
reached by iterating alive' = ~(alive @ tri > 0.5) for min(K, 16) iterations. `tri`
holds 0/1 and the products are summed in float32, so the sums are exact integers
whether or not TF32 is on (0 and 1 are exact in TF32). The JAX package stops its
`lax.while_loop` once alive stops changing; here the loop always runs its capped count
with no convergence test, which reads nothing on the host (the detect path can be
captured by `torch.export`) and keeps the same keep set: once alive equals its
previous value, every further iteration computes that value again.
`suppress_fixpoint` counts its calls and iterations (`.calls`, `.iterations`) so a run
can report them.

Tie order: `lax.top_k` and the stable `lax.sort` of the JAX package put the lower index
first among equal scores. `torch.topk` promises no tie order on CUDA, so every top-k
here is a stable descending sort sliced to k, and every per-row argmax takes the lowest
index explicitly. The JAX package's one-hot matmul at HIGHEST precision is an exact
gather; here it is `torch.gather`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ssd_object_detection_tpu_torch.ops import boxes as box_ops


class Detections(NamedTuple):
    boxes: torch.Tensor  # (..., max_detections, 4) cxcywh, same units as input boxes
    scores: torch.Tensor  # (..., max_detections) float32; padding entries are 0
    classes: torch.Tensor  # (..., max_detections) int32; padding entries are -1
    valid: torch.Tensor  # (..., max_detections) bool


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` over the last axis: the k largest, ties to the lower index."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def _argmax_lowest(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max, lowest index of the max) over the last axis, as `jnp.argmax` breaks ties."""
    best = x.max(dim=-1).values
    iota = torch.arange(x.shape[-1], device=x.device, dtype=torch.int32)
    index = torch.where(x == best[..., None], iota, x.shape[-1]).amin(dim=-1)
    return best, index


def _suppression_matrix(x1, y1, x2, y2, iou_thresh: float) -> torch.Tensor:
    """Score-ordered suppression matrix (..., K, K) bool: [i, j] where i < j and
    IoU(i, j) > thresh, evaluated as inter > thresh * union (no division)."""
    area = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    ix = torch.clamp(
        torch.minimum(x2[..., :, None], x2[..., None, :])
        - torch.maximum(x1[..., :, None], x1[..., None, :]),
        min=0.0,
    )
    iy = torch.clamp(
        torch.minimum(y2[..., :, None], y2[..., None, :])
        - torch.maximum(y1[..., :, None], y1[..., None, :]),
        min=0.0,
    )
    inter = ix * iy
    union = area[..., :, None] + area[..., None, :] - inter
    k = x1.shape[-1]
    upper = torch.ones((k, k), dtype=torch.bool, device=x1.device).triu(diagonal=1)
    return (inter > iou_thresh * union) & upper


def suppress_fixpoint(tri: torch.Tensor, max_iters: int = 16) -> torch.Tensor:
    """Keep-mask (..., K) from a score-ordered suppression matrix tri (..., K, K) bool,
    tri[i, j] where candidate i (higher-scored) would suppress j."""
    iterations = min(tri.shape[-1], max_iters)
    tri_f = tri.float()
    alive = torch.ones(tri.shape[:-1], dtype=torch.bool, device=tri.device)
    for _ in range(iterations):
        alive = ~(torch.matmul(alive.float().unsqueeze(-2), tri_f).squeeze(-2) > 0.5)
    suppress_fixpoint.calls += 1
    suppress_fixpoint.iterations += iterations
    return alive


suppress_fixpoint.calls = 0
suppress_fixpoint.iterations = 0


def _finish(final_scores, final_boxes, final_classes) -> Detections:
    valid = final_scores > 0.0
    return Detections(
        boxes=torch.where(valid[..., None], final_boxes, 0.0),
        scores=final_scores,
        classes=torch.where(valid, final_classes.to(torch.int32), -1),
        valid=valid,
    )


def _gather_boxes(boxes: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """boxes (B, N, 4) at index (B, M) -> (B, M, 4)."""
    return torch.gather(boxes, 1, index[..., None].expand(*index.shape, 4))


def nms_on_pool(
    pool_boxes: torch.Tensor,  # (B, N, 4) cxcywh candidate boxes
    pool_scores: torch.Tensor,  # (B, N, C) per-class scores, sub-threshold already 0
    iou_thresh: float = 0.45,
    top_k_per_class: int = 100,
    max_detections: int = 100,
) -> Detections:
    """Stages 2-4 on a pooled candidate set: per-class top-K -> greedy suppression
    (fixpoint) -> cross-class merge."""
    batch, n_pool, num_classes = pool_scores.shape

    # Stage 2: per-class top-K within the pool; the xyxy planes follow the sort order.
    k = min(top_k_per_class, n_pool)
    xyxy = box_ops.cxcywh_to_xyxy(pool_boxes)  # (B, N, 4)
    top_scores, top_pos = top_k_stable(pool_scores.transpose(1, 2), k)  # (B, C, K)
    planes = [torch.gather(xyxy[:, None, :, i].expand(batch, num_classes, n_pool), 2, top_pos)
              for i in range(4)]

    # Stage 3: per-class greedy suppression.
    alive = suppress_fixpoint(_suppression_matrix(*planes, iou_thresh))
    kept_scores = torch.where(alive & (top_scores > 0.0), top_scores, 0.0)

    # Stage 4: merge classes with one global top-k.
    merge_pool = num_classes * k
    n_out = min(max_detections, merge_pool)
    final_scores, final_pos = top_k_stable(kept_scores.reshape(batch, merge_pool), n_out)
    cand_pos = torch.gather(top_pos.reshape(batch, merge_pool), 1, final_pos)
    return _finish(final_scores, _gather_boxes(pool_boxes, cand_pos), final_pos // k)


def nms_on_pool_merged(
    pool_boxes: torch.Tensor,  # (B, N, 4) cxcywh candidate boxes
    pool_scores: torch.Tensor,  # (B, N, C) per-class scores, sub-threshold already 0
    iou_thresh: float = 0.45,
    merged_top_k: Optional[int] = None,
    max_detections: int = 100,
    per_anchor_top2: bool = False,
) -> Detections:
    """Merged-candidate class-aware NMS: one global top-M over all (anchor, class)
    pairs, one class-masked suppression fixpoint, then top-max_detections of the
    survivors. `merged_top_k=None` takes max(256, 2.56 * max_detections).

    `per_anchor_top2` first restricts each anchor to its two best classes (the lowest
    class index wins ties; the winner is masked with 0.0 for the runner-up), which
    differs from the exhaustive set only when 3+ classes of one anchor belong in the
    global top-M."""
    batch, n_pool, num_classes = pool_scores.shape
    if merged_top_k is None:
        merged_top_k = max(256, (max_detections * 256) // 100)

    if per_anchor_top2:
        m = min(merged_top_k, 2 * n_pool)
        s1, c1 = _argmax_lowest(pool_scores)  # (B, N)
        cls_iota = torch.arange(num_classes, device=pool_scores.device, dtype=torch.int32)
        masked = torch.where(cls_iota == c1[..., None], 0.0, pool_scores)
        s2, c2 = _argmax_lowest(masked)
        t2_scores = torch.stack([s1, s2], dim=-1).reshape(batch, 2 * n_pool)
        anchor_iota = torch.arange(n_pool, device=pool_scores.device, dtype=torch.int32)
        flat_idx_all = (anchor_iota[None, :, None] * num_classes
                        + torch.stack([c1, c2], dim=-1)).reshape(batch, 2 * n_pool).long()
        top_scores, pos = top_k_stable(t2_scores, m)
        flat_idx = torch.gather(flat_idx_all, 1, pos)
    else:
        m = min(merged_top_k, n_pool * num_classes)
        top_scores, flat_idx = top_k_stable(pool_scores.reshape(batch, n_pool * num_classes), m)
    cand_pool = flat_idx // num_classes
    cand_class = flat_idx % num_classes

    # candidate geometry: an exact gather of the xyxy planes
    xyxy = box_ops.cxcywh_to_xyxy(pool_boxes)  # (B, N, 4)
    planes = [torch.gather(xyxy[..., i], 1, cand_pool) for i in range(4)]

    # class-masked suppression: a candidate only suppresses same-class candidates
    same = cand_class[..., :, None] == cand_class[..., None, :]
    alive = suppress_fixpoint(_suppression_matrix(*planes, iou_thresh) & same)
    kept_scores = torch.where(alive & (top_scores > 0.0), top_scores, 0.0)

    n_out = min(max_detections, m)
    final_scores, pos = top_k_stable(kept_scores, n_out)  # (B, n_out)
    final_pool = torch.gather(cand_pool, 1, pos)
    return _finish(final_scores, _gather_boxes(pool_boxes, final_pool),
                   torch.gather(cand_class, 1, pos))


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_thresh: float = 0.45,
    score_thresh: float = 0.01,
    pre_nms_top_k: Optional[int] = 400,
    top_k_per_class: int = 100,
    max_detections: int = 100,
) -> Detections:
    """Class-aware NMS over SSD outputs.

    Args:
      boxes: (B, D, 4) decoded cxcywh boxes (class-agnostic, as SSD predicts).
      scores: (B, D, C) per-class foreground probabilities (background stripped).
      pre_nms_top_k: class-agnostic candidate pool per image (None = all D anchors).
    Returns `Detections` with fixed shape (B, max_detections, ...).
    """
    _, num_boxes, _ = scores.shape
    s = torch.where(scores >= score_thresh, scores, 0.0)

    # Stage 1: class-agnostic candidate pool.
    n_pool = min(pre_nms_top_k or num_boxes, num_boxes)
    if n_pool < num_boxes:
        _, pool_idx = top_k_stable(s.max(dim=-1).values, n_pool)  # (B, N)
        pool_boxes = _gather_boxes(boxes, pool_idx)
        pool_scores = torch.gather(s, 1, pool_idx[..., None].expand(*pool_idx.shape, s.shape[-1]))
    else:
        pool_boxes, pool_scores = boxes, s

    return nms_on_pool(
        pool_boxes, pool_scores,
        iou_thresh=iou_thresh, top_k_per_class=top_k_per_class,
        max_detections=max_detections,
    )
