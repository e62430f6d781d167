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

With a data-parallel `mesh` (parallel/mesh.py) each rank holds some rows of the batch,
and the loss is still the JAX loss of the whole (global) batch, whose GSPMD sort is global:
  - the number of positives, the count of mined negatives and `has_pos` are global
    (all-reduced);
  - in reference mode the threshold is taken over the background CE of every rank,
    all-gathered in rank order (each rank's shard padded with -inf, which never reaches
    the top k), so a rank's negatives are mined against the global threshold;
  - each rank's differentiable term is its local sums over the global normalisers; the
    sum of those terms over the ranks is the global loss, so summing the gradients over
    the ranks gives the global gradient (train/step.py);
  - the returned LossInfo holds the global values, equal on every rank, and carries the
    gradient of this rank's term.
Canonical mode mines per image, so it needs only the global normalisers. Every collective
runs on the mesh's data group: on a 2-D mesh (parallel/shardings.py) the model ranks of a
data rank hold the same rows, and over the default group they would count tp times.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ssd_object_detection_tpu_torch.parallel.collectives import all_gather_padded, all_reduce_sum


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


class _GlobalValue(torch.autograd.Function):
    """The global value of a loss term in the forward, the gradient of this rank's term
    in the backward."""

    @staticmethod
    def forward(ctx, local, global_value):
        return global_value.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def multibox_loss(
    gt_cls: torch.Tensor,  # (B, D) int32
    gt_loc: torch.Tensor,  # (B, D, 4) encoded offsets
    gt_mask: torch.Tensor,  # (B, D) bool positives
    pred_loc: torch.Tensor,  # (B, D, 4)
    pred_logits: torch.Tensor,  # (B, D, C), background last
    neg_pos_ratio: float = 3.0,
    canonical: bool = False,
    mesh=None,
    global_batch: Optional[int] = None,
) -> LossInfo:
    """The MultiBox loss of the batch; with `mesh`, of the global batch of `global_batch`
    rows (default: B rows on every rank), of which this rank holds its share (B may be 0)."""
    pos = gt_mask.float()
    num_pos = pos.sum()
    if mesh is not None:
        if global_batch is None:
            global_batch = gt_mask.shape[0] * mesh.size
        if mesh.shard().count(global_batch) != gt_mask.shape[0]:
            raise ValueError(f"rank {mesh.rank} of {mesh.size} holds {gt_mask.shape[0]} rows; "
                             f"its share of a global batch of {global_batch} is "
                             f"{mesh.shard().count(global_batch)}")
    global_num_pos = num_pos if mesh is None or canonical else all_reduce_sum(num_pos, mesh.data_group)

    ce_pos_sum = (_softmax_ce(pred_logits, gt_cls) * pos).sum()

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
        flat = ce_bg.reshape(-1).detach()
        if mesh is None:
            total = flat.shape[0]
        else:
            total = global_batch * ce_bg.shape[1]
            flat = all_gather_padded(flat, math.ceil(global_batch / mesh.size) * ce_bg.shape[1],
                                     fill=-math.inf, group=mesh.data_group)
        k = (neg_pos_ratio * global_num_pos).to(torch.int32)
        k = torch.clamp(k, 0, total)
        sorted_desc = torch.sort(flat, descending=True).values
        thresh = sorted_desc[torch.clamp(k - 1, min=0).long()]
        neg_mask = (ce_bg >= thresh) & ~gt_mask & (k > 0)

    neg = neg_mask.float()
    neg_sum = (ce_bg * neg).sum()
    num_neg = neg.sum()

    diff = pred_loc.float() - gt_loc
    if canonical:
        absd = diff.abs()
        per_coord = torch.where(absd < 1.0, 0.5 * absd * absd, absd - 0.5)  # smooth-L1
    else:
        per_coord = diff.abs()  # plain L1
    loc_sum = (per_coord.sum(dim=-1) * pos).sum()

    sums = (num_pos, ce_pos_sum, loc_sum, num_neg, neg_sum)
    if mesh is not None:
        sums = all_reduce_sum(torch.stack([x.detach() for x in sums]), mesh.data_group).unbind()
    g_num_pos, g_pos_sum, g_loc_sum, g_num_neg, g_neg_sum = sums
    safe_pos = torch.clamp(g_num_pos, min=1.0)
    safe_neg = torch.clamp(g_num_neg, min=1.0)
    has_pos = (g_num_pos > 0).float()

    # this rank's term: its own sums over the global normalisers
    loss_cls_pos = ce_pos_sum / safe_pos * has_pos
    loss_loc = loc_sum / safe_pos * has_pos
    loss_cls_neg = neg_sum / safe_neg
    total = loss_loc + loss_cls_pos + loss_cls_neg
    if mesh is None:
        return LossInfo(total=total, loc=loss_loc, cls_pos=loss_cls_pos, cls_neg=loss_cls_neg,
                        num_positive=num_pos)
    g_cls_pos = g_pos_sum / safe_pos * has_pos
    g_loc = g_loc_sum / safe_pos * has_pos
    g_cls_neg = g_neg_sum / safe_neg
    g_total = g_loc + g_cls_pos + g_cls_neg
    return LossInfo(
        total=_GlobalValue.apply(total, g_total), loc=_GlobalValue.apply(loss_loc, g_loc),
        cls_pos=_GlobalValue.apply(loss_cls_pos, g_cls_pos),
        cls_neg=_GlobalValue.apply(loss_cls_neg, g_cls_neg), num_positive=g_num_pos,
    )
