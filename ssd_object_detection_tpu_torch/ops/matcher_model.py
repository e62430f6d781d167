"""A plain PyTorch model of the CUDA matcher's algorithm (csrc/matcher.cu), for the CPU.

The kernel does not compute the greedy matching as ops/plain_matcher.py writes it down
(num_valid first maxima of a masked (G, D) matrix). It keeps one 64-bit key per valid
ground-truth row, the row's best (value, lowest column) over the unconsumed columns;
builds those keys per column slice, one slice per CTA of a cluster, and merges them by
the key's own order; runs the greedy steps on the keys alone; and rescans a row only
when another row has just consumed its cached column. `match_anchors_model` does the
same steps with tensors and Python integers, so the CPU tests can hold the algorithm
bit-equal to the plain matcher, and it counts the row rescans a batch needs. It is
never on the main path: the wrapper (ops/cuda_matcher.py) launches the kernel for CUDA
tensors and takes the plain matcher for CPU tensors.

`stress_cases` makes the inputs that strain this design (conflicts at every step, more
ground truths than anchors, empty and ragged column slices, every cluster size); the
CPU tests run them through the model at small sizes, the card tests and chip_smoke.py
through the kernel at full size.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ssd_object_detection_tpu_torch.ops import boxes as box_ops
from ssd_object_detection_tpu_torch.ops.cuda_matcher import column_slices
from ssd_object_detection_tpu_torch.ops.plain_matcher import MatchResult

COLUMN_FIELD = 0x7FFFFFFF  # low 31 bits of a key (csrc/matcher.cu kColumnField)


def ordered_bits(values: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in [1, 2**32): the float's bits mapped so that the integer order
    is the float order (csrc/matcher.cu ordered_bits)."""
    bits = values.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return bits ^ torch.where(bits >> 31 != 0, 0xFFFFFFFF, 0x80000000)


def make_keys(values: torch.Tensor, columns: torch.Tensor) -> torch.Tensor:
    """int64 keys: a larger key is a larger value, then a lower column; never 0."""
    return (ordered_bits(values) << 31) | (COLUMN_FIELD - columns.to(torch.int64))


def key_column(key: int) -> int:
    return COLUMN_FIELD - (key & COLUMN_FIELD)


def _match_image(gt_boxes, gt_valid, anchors, thresh, cluster) -> Tuple[torch.Tensor, int]:
    """(gt_index (D,) int32, rescans) of one image."""
    num_anchors = anchors.shape[0]
    rows = torch.nonzero(gt_valid).flatten()  # the valid rows, ascending
    num_valid = rows.numel()
    iou = box_ops.pairwise_iou(gt_boxes[rows], anchors, legacy_clamp=True)  # (num_valid, D)

    # Build, phase 2's part: each column's best over the valid rows (lowest row), then
    # the invalid rows' candidate (-1, first_invalid); it wins a column only with no
    # valid row, or never, unless thresh is below -1.
    if num_valid:
        best_k = torch.argmax(iou, dim=0)  # first maximum: lowest row
        best_v = torch.gather(iou, 0, best_k[None])[0]
        best_r = rows[best_k]
    else:
        best_v = torch.full((num_anchors,), float("-inf"))
        best_r = torch.zeros(num_anchors, dtype=torch.int64)
    invalid = torch.nonzero(~gt_valid).flatten()
    if invalid.numel():
        first_invalid = int(invalid[0])
        take = (best_v < -1.0) | ((best_v == -1.0) & (best_r > first_invalid))
        best_v = torch.where(take, torch.tensor(-1.0), best_v)
        best_r = torch.where(take, torch.tensor(first_invalid), best_r)
    gt_index = torch.where(best_v > torch.tensor(thresh, dtype=torch.float32), best_r, -1)
    gt_index = gt_index.to(torch.int32)

    # Build, phase 1's part: per slice each row's best key, merged by the key's order.
    keys = make_keys(iou, torch.arange(num_anchors)[None, :])  # (num_valid, D)
    per_rank = [keys[:, a:b].amax(dim=1) if b > a else torch.zeros(num_valid, dtype=torch.int64)
                for a, b in column_slices(num_anchors, cluster)]
    row_key: List[int] = torch.stack(per_rank).amax(dim=0).tolist() if num_valid else []

    # Phase 1 on the keys alone. 0 = the row is placed, or has no column left.
    consumed = torch.zeros(num_anchors, dtype=torch.bool)
    picks: List[Tuple[int, int]] = []
    rescans, last_col, all_consumed = 0, -1, False
    while len(picks) < num_valid:
        flagged = [k for k, key in enumerate(row_key) if key and key_column(key) == last_col]
        last_col = -1
        if flagged:  # their cached column was just consumed: look again, then retake the step
            for k in flagged:
                left = keys[k][~consumed]  # the kernel recomputes these IoUs, bit for bit
                row_key[k] = int(left.max()) if left.numel() else 0
            rescans += len(flagged)
            continue
        top = max(key >> 31 for key in row_key)
        if top == 0:
            # every column is consumed: the masked matrix is all -2 and its first maximum
            # is flat index 0 in this step and all that follow
            all_consumed = True
            break
        k = next(i for i, key in enumerate(row_key) if key >> 31 == top)  # lowest row
        col = key_column(row_key[k])
        picks.append((int(rows[k]), col))
        row_key[k] = 0
        consumed[col] = True
        last_col = col
    for row, col in picks:
        gt_index[col] = 0 if all_consumed and col == 0 else row
    return gt_index, rescans


def match_anchors_model(
    gt_cls: torch.Tensor,  # (B, G) int32
    gt_boxes: torch.Tensor,  # (B, G, 4) cxcywh
    gt_valid: torch.Tensor,  # (B, G) bool
    anchors: torch.Tensor,  # (D, 4) cxcywh
    thresh: float = 0.5,
    cluster: int = 1,
) -> Tuple[MatchResult, int]:
    """The kernel's algorithm with `cluster` column slices per image, on CPU tensors:
    (the plain matcher's result, the number of row rescans the batch needed)."""
    batch, num_anchors = gt_cls.shape[0], anchors.shape[0]
    gt_index = torch.empty((batch, num_anchors), dtype=torch.int32)
    rescans = 0
    for b in range(batch):
        gt_index[b], n = _match_image(gt_boxes[b], gt_valid[b], anchors, thresh, cluster)
        rescans += n
    mask = gt_index >= 0
    safe = torch.clamp(gt_index, min=0).long()
    cls = torch.where(mask, torch.gather(gt_cls, 1, safe).to(torch.int32), 0)
    box = torch.gather(gt_boxes, 1, safe[:, :, None].expand(-1, -1, 4))
    box = torch.where(mask[:, :, None], box, torch.zeros_like(box))
    return MatchResult(cls=cls, box=box, mask=mask, gt_index=gt_index), rescans


def stress_cases(anchors: np.ndarray, anchors_large: np.ndarray, max_gt: int = 100,
                 many: int = 160, seed: int = 0) -> Dict[str, tuple]:
    """{name: (gt_cls, gt_boxes, gt_valid, anchors, thresh)} numpy inputs that strain
    the kernel's design. `anchors` is the main path's set, `anchors_large` a larger one,
    `many` a batch of more images than the card has SMs (one CTA per image)."""
    rng = np.random.default_rng(seed)

    def case(batch, gts, valid_p, anchor_set=anchors, thresh=0.5):
        boxes = np.concatenate([rng.uniform(0, 1, (batch, gts, 2)),
                                rng.uniform(0.02, 0.6, (batch, gts, 2))], -1).astype(np.float32)
        cls = rng.integers(0, 80, (batch, gts)).astype(np.int32)
        valid = rng.uniform(size=(batch, gts)) < valid_p
        return [cls, boxes, valid, anchor_set, thresh]

    cases = {}
    # every GT of image 0 identical (each pick consumes every other row's cached column:
    # a rescan of all remaining rows at every step); image 1 two groups of identical GTs
    same = case(2, max_gt, 1.0)
    same[1][0, :] = same[1][0, 0]
    same[1][1, : max_gt // 2] = same[1][1, 0]
    same[1][1, max_gt // 2:] = same[1][1, -1]
    cases["identical_gts"] = same
    few = min(5, max_gt - 1)
    cases["more_gts_than_anchors"] = case(2, max_gt, 1.0, anchors[:few])
    cases["fewer_anchors_than_ranks"] = case(1, min(4, max_gt), 1.0, anchors[:3])
    ragged = len(anchors) - len(anchors) % 8 - 3  # no multiple of 2, 4 or 8
    cases["ragged_slices"] = case(2, max_gt, 0.3, anchors[:ragged])
    cases["batch1"] = case(1, max_gt, 0.5)
    cases["batch_many"] = case(many, max_gt, 0.1)
    one = case(4, 1, 1.0)
    one[2][1] = False
    cases["one_gt"] = one
    low = case(3, max_gt, 0.5, thresh=-1.5)  # invalid rows (-1) pass this threshold
    low[2][1] = False
    low[2][2] = True
    cases["thresh_below_minus_one"] = low
    cases["large_anchor_set_b32"] = case(32, max_gt, 0.3, anchors_large)
    return {name: tuple(c) for name, c in cases.items()}
