"""MultiBox loss with hard-negative mining, port of ssd_object_detection_tpu/losses.py.

`reference` mode (default) is the reference-exact loss:
  - positive cls loss: softmax CE at matched anchors, mean over positives;
  - hard-negative mining: background CE (background is the LAST channel) of every
    negative anchor; threshold = sorted_desc[max(k - 1, 0)] with k = int32(3 * num_pos)
    over the WHOLE flattened batch; negatives = {CE >= threshold}, so ties at the
    threshold admit more than k negatives, as in the reference; mean over them;
  - loc loss: plain L1 summed over the 4 coords, mean over positives;
  - total = unweighted sum. With num_pos == 0 every term is 0.

`canonical` mode is the SSD-paper loss: smooth-L1 loc and per-image 3:1 mining by
rank. The rank is a double argsort; JAX's argsort is stable, so both sorts here are
`stable=True` (PyTorch's default sort is not).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LossInfo(NamedTuple):
    """Scalar diagnostics, keyed like the reference's TensorBoard tags."""

    total: torch.Tensor
    loc: torch.Tensor
    cls_pos: torch.Tensor
    cls_neg: torch.Tensor
    num_positive: torch.Tensor


def _softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sparse softmax cross-entropy in float32."""
    logits = logits.float()
    log_z = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return log_z - label_logit


def multibox_loss(
    gt_cls: torch.Tensor,  # (B, D) int32
    gt_loc: torch.Tensor,  # (B, D, 4) encoded offsets
    gt_mask: torch.Tensor,  # (B, D) bool positives
    pred_loc: torch.Tensor,  # (B, D, 4)
    pred_logits: torch.Tensor,  # (B, D, C), background last
    neg_pos_ratio: float = 3.0,
    canonical: bool = False,
) -> LossInfo:
    pos = gt_mask.float()
    num_pos = pos.sum()
    safe_pos = torch.clamp(num_pos, min=1.0)

    ce_pos = _softmax_ce(pred_logits, gt_cls) * pos
    loss_cls_pos = ce_pos.sum() / safe_pos

    # background CE = logsumexp(logits) - logits[..., -1], masked to negatives
    logits32 = pred_logits.float()
    ce_bg = (torch.logsumexp(logits32, dim=-1) - logits32[..., -1]) * (1.0 - pos)

    if canonical:
        num_pos_img = pos.sum(dim=1)  # (B,)
        num_neg_img = torch.minimum(neg_pos_ratio * num_pos_img, pos.shape[1] - num_pos_img)
        order = torch.argsort(-ce_bg, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True).float()
        neg_mask = (rank < num_neg_img[:, None]) & ~gt_mask
    else:
        flat = ce_bg.reshape(-1)
        k = (neg_pos_ratio * num_pos).to(torch.int32)
        k = torch.clamp(k, 0, flat.shape[0])
        sorted_desc = torch.sort(flat.detach(), descending=True).values
        thresh = sorted_desc[torch.clamp(k - 1, min=0).long()]
        neg_mask = (ce_bg >= thresh) & ~gt_mask & (k > 0)

    neg = neg_mask.float()
    loss_cls_neg = (ce_bg * neg).sum() / torch.clamp(neg.sum(), min=1.0)

    diff = pred_loc.float() - gt_loc
    if canonical:
        absd = diff.abs()
        per_coord = torch.where(absd < 1.0, 0.5 * absd * absd, absd - 0.5)  # smooth-L1
    else:
        per_coord = diff.abs()  # plain L1
    loss_loc = (per_coord.sum(dim=-1) * pos).sum() / safe_pos

    has_pos = (num_pos > 0).float()
    loss_cls_pos = loss_cls_pos * has_pos
    loss_loc = loss_loc * has_pos

    total = loss_loc + loss_cls_pos + loss_cls_neg
    return LossInfo(
        total=total, loc=loss_loc, cls_pos=loss_cls_pos, cls_neg=loss_cls_neg,
        num_positive=num_pos,
    )
