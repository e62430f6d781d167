"""COCO-style mAP evaluator (own implementation — pycocotools is not in this image).

Implements the COCOeval bbox protocol: greedy score-ordered matching per (image,
class, IoU threshold, area range) with crowd-ignore handling, 101-point interpolated
AP averaged over IoU thresholds 0.50:0.95:0.05 and over classes, the standard area
ranges (all / small < 32^2 / medium / large > 96^2), and average recall at
maxDets 1/10/100 — the full 12-number COCO summary. The reference repo has no
evaluation at all (SURVEY.md section 2: "NMS, mAP/COCOeval evaluation ... absent");
BASELINE.json's mAP-parity gate requires one.

Matching rules (mirroring pycocotools cocoeval.py evaluateImg/accumulate):
  - detections sorted by descending score, truncated to maxDets; each claims the
    unclaimed non-ignored GT with the highest IoU >= thresh;
  - a detection may fall back to a crowd/ignored GT (matching it marks the detection
    ignored — neither TP nor FP); crowd IoU uses intersection/det_area;
  - per area range, GTs outside the range are ignored; unmatched detections whose
    own area falls outside the range are also ignored (cocoeval.py:
    `dtIg = dtIg | (dtm==0 & outside)`);
  - AP: precision envelope (monotone from the right) sampled at 101 recall points,
    averaged over classes that have GTs; AR: best recall per class/IoU.

Deviation from pycocotools: GT "area" here is the BOX area; COCO annotations carry a
segmentation-mask area that can be smaller. Size-bucket metrics on real COCO shift
slightly; all/AP/AR metrics are unaffected.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)  # 0.50 ... 0.95
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def _iou_xyxy(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU matrix (n_det, n_gt); crowd GT columns use intersection/det_area."""
    lt = np.maximum(dets[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dets[:, None, 2:], gts[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    det_area = np.clip(dets[:, 2] - dets[:, 0], 0, None) * np.clip(dets[:, 3] - dets[:, 1], 0, None)
    gt_area = np.clip(gts[:, 2] - gts[:, 0], 0, None) * np.clip(gts[:, 3] - gts[:, 1], 0, None)
    union = det_area[:, None] + gt_area[None, :] - inter
    union = np.where(iscrowd[None, :].astype(bool), det_area[:, None], union)
    return inter / np.maximum(union, 1e-10)


def _box_area(xyxy: np.ndarray) -> np.ndarray:
    return np.clip(xyxy[:, 2] - xyxy[:, 0], 0, None) * np.clip(xyxy[:, 3] - xyxy[:, 1], 0, None)


@dataclasses.dataclass
class _RawImage:
    """Raw per (image, class) inputs; matching is deferred to summarize() because it
    must be repeated per area range with different ignore sets."""

    det_boxes: np.ndarray  # (n_d, 4) xyxy, already score-sorted desc
    det_scores: np.ndarray  # (n_d,) descending
    gt_boxes: np.ndarray  # (n_g, 4) xyxy
    gt_crowd: np.ndarray  # (n_g,) bool
    _iou_cache: Optional[Tuple[int, np.ndarray]] = None  # (max_dets, matrix)

    def iou(self, max_dets: int) -> np.ndarray:
        """IoU of the first max_dets detections vs all GTs, cached (the matrix is
        area-range independent, so the 4 range passes share one computation)."""
        if self._iou_cache is None or self._iou_cache[0] != max_dets:
            self._iou_cache = (
                max_dets,
                _iou_xyxy(self.det_boxes[:max_dets], self.gt_boxes, self.gt_crowd),
            )
        return self._iou_cache[1]


@dataclasses.dataclass
class _ImageEval:
    det_scores: np.ndarray  # (n_d,)
    det_matched: np.ndarray  # (T, n_d) bool: matched a non-ignored GT
    det_ignored: np.ndarray  # (T, n_d) bool: ignored (crowd match / out-of-range)
    num_gt: int  # non-ignored GTs


def _match_image(raw: _RawImage, area_rng: Tuple[float, float], max_dets: int) -> _ImageEval:
    """Greedy COCOeval matching for one (image, class) under one area range."""
    lo, hi = area_rng
    d_boxes = raw.det_boxes[:max_dets]
    d_scores = raw.det_scores[:max_dets]
    g_area = _box_area(raw.gt_boxes)
    g_ign = raw.gt_crowd | (g_area < lo) | (g_area > hi)

    n_d, n_g = len(d_boxes), len(raw.gt_boxes)
    T = len(IOU_THRESHOLDS)
    matched = np.zeros((T, n_d), bool)
    ignored = np.zeros((T, n_d), bool)
    if n_d and n_g:
        iou = raw.iou(max_dets)
        real = ~g_ign
        for ti, t in enumerate(IOU_THRESHOLDS):
            thr = min(t, 1 - 1e-10)
            gt_taken = np.zeros((n_g,), bool)
            # greedy over score-sorted detections; the per-detection GT pick is
            # vectorized: prefer the best AVAILABLE non-ignored GT with IoU >= thr,
            # else fall back to the best available ignored GT (pycocotools
            # semantics: every NON-crowd GT — ignored or not — is claimable once
            # (cocoeval's `gtm > 0 and not iscrowd` skip); only crowd GTs absorb
            # any number of detections. Ties resolve to the lowest index here
            # where pycocotools takes the highest — identical up to exact float
            # ties.)
            for di in range(n_d):
                row = iou[di]
                cand = real & ~gt_taken & (row >= thr)
                if cand.any():
                    best_g = int(np.argmax(np.where(cand, row, -1.0)))
                    gt_taken[best_g] = True
                    matched[ti, di] = True
                    continue
                cand = g_ign & (raw.gt_crowd | ~gt_taken) & (row >= thr)
                if cand.any():
                    best_g = int(np.argmax(np.where(cand, row, -1.0)))
                    gt_taken[best_g] = True
                    ignored[ti, di] = True
    if n_d:
        # unmatched detections outside the area range are ignored, not FPs
        d_area = _box_area(d_boxes)
        outside = (d_area < lo) | (d_area > hi)
        ignored |= (~matched) & outside[None, :]
    return _ImageEval(
        det_scores=d_scores, det_matched=matched, det_ignored=ignored,
        num_gt=int((~g_ign).sum()),
    )


class DetectionEvaluator:
    """Accumulate per-image detections + ground truths, then compute the COCO
    12-metric summary. Boxes are xyxy in any consistent unit (typically
    original-image pixels; the 32^2/96^2 size buckets assume pixels)."""

    def __init__(self, num_classes: int = 80, max_dets: int = 100):
        self.num_classes = num_classes
        self.max_dets = max_dets
        self._per_class: Dict[int, List[_RawImage]] = defaultdict(list)

    def add_image(
        self,
        det_boxes: np.ndarray,  # (N, 4) xyxy
        det_scores: np.ndarray,  # (N,)
        det_classes: np.ndarray,  # (N,) int
        gt_boxes: np.ndarray,  # (M, 4) xyxy
        gt_classes: np.ndarray,  # (M,) int
        gt_ignore: Optional[np.ndarray] = None,  # (M,) bool (e.g. iscrowd)
    ) -> None:
        if gt_ignore is None:
            gt_ignore = np.zeros((len(gt_boxes),), bool)
        gt_ignore = np.asarray(gt_ignore).astype(bool)

        # Score-sort once, then truncate to max_dets PER (image, class) after the
        # split — pycocotools' evaluateImg applies maxDets per category (dt[0:maxDet]
        # on the per-(img, cat) list), not across classes. The built-in predict
        # paths emit <= 100 detections total so both readings coincide there, but
        # external callers feeding more now get COCOeval-exact behavior.
        order = np.argsort(-det_scores, kind="stable")
        det_boxes, det_scores, det_classes = det_boxes[order], det_scores[order], det_classes[order]

        classes = set(np.unique(gt_classes).tolist()) | set(np.unique(det_classes).tolist())
        for c in classes:
            d_sel = det_classes == c
            g_sel = gt_classes == c
            self._per_class[int(c)].append(_RawImage(
                det_boxes=det_boxes[d_sel][: self.max_dets],
                det_scores=det_scores[d_sel][: self.max_dets],
                gt_boxes=gt_boxes[g_sel], gt_crowd=gt_ignore[g_sel],
            ))

    @staticmethod
    def _accumulate(evals: List[_ImageEval]) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """One class, one area range -> ((T,) AP, (T,) recall), or None if no GTs."""
        num_gt = sum(e.num_gt for e in evals)
        if num_gt == 0:
            return None
        T = len(IOU_THRESHOLDS)
        scores = np.concatenate([e.det_scores for e in evals]) if evals else np.zeros((0,))
        matched = (
            np.concatenate([e.det_matched for e in evals], axis=1)
            if evals else np.zeros((T, 0), bool)
        )
        ignored = (
            np.concatenate([e.det_ignored for e in evals], axis=1)
            if evals else np.zeros((T, 0), bool)
        )
        order = np.argsort(-scores, kind="mergesort")
        matched, ignored = matched[:, order], ignored[:, order]

        aps = np.zeros((T,))
        recalls = np.zeros((T,))
        for ti in range(T):
            keep = ~ignored[ti]
            tp = np.cumsum(matched[ti][keep])
            fp = np.cumsum(~matched[ti][keep])
            if len(tp) == 0:
                continue  # GTs exist but nothing was detected: AP = recall = 0
            recall = tp / num_gt
            precision = tp / np.maximum(tp + fp, 1e-10)
            recalls[ti] = recall[-1]
            # precision envelope, then 101-point sampling
            for i in range(len(precision) - 1, 0, -1):
                precision[i - 1] = max(precision[i - 1], precision[i])
            idx = np.searchsorted(recall, RECALL_POINTS, side="left")
            prec_at = np.where(
                idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0
            )
            aps[ti] = prec_at.mean()
        return aps, recalls

    @staticmethod
    def _truncate(e: _ImageEval, k: int) -> _ImageEval:
        """The match restricted to the top-k detections: greedy matching of a
        score-sorted prefix is exactly the prefix of the full match (later
        detections never influence earlier rows), so AR@1/AR@10 need no
        re-matching — mirrors pycocotools, which matches once per area range and
        truncates in accumulate()."""
        return _ImageEval(
            det_scores=e.det_scores[:k], det_matched=e.det_matched[:, :k],
            det_ignored=e.det_ignored[:, :k], num_gt=e.num_gt,
        )

    def _range_stats(self, area_rng: Tuple[float, float], max_dets_list: Tuple[int, ...]):
        """{max_dets: (mean AP (T,), mean recall (T,)) or None} over classes with
        GTs; one greedy match per (image, class), truncated per maxDets entry."""
        per_md = {md: ([], []) for md in max_dets_list}
        for c, raws in self._per_class.items():
            evals = [_match_image(r, area_rng, self.max_dets) for r in raws]
            for md in max_dets_list:
                e_md = evals if md >= self.max_dets else [self._truncate(e, md) for e in evals]
                acc = self._accumulate(e_md)
                if acc is not None:
                    per_md[md][0].append(acc[0])
                    per_md[md][1].append(acc[1])
        return {
            md: (np.stack(aps), np.stack(recs)) if aps else None
            for md, (aps, recs) in per_md.items()
        }

    def summarize(self) -> Dict[str, float]:
        """The COCO 12-metric summary (plus class count)."""
        out: Dict[str, float] = {}
        all_stats = self._range_stats(AREA_RANGES["all"], (self.max_dets, 1, 10))
        stats = all_stats[self.max_dets]
        if stats is None:
            return {
                "mAP": 0.0, "mAP@0.5": 0.0, "mAP@0.75": 0.0,
                "mAP_small": 0.0, "mAP_medium": 0.0, "mAP_large": 0.0,
                "AR@1": 0.0, "AR@10": 0.0, "AR@100": 0.0,
                "AR_small": 0.0, "AR_medium": 0.0, "AR_large": 0.0,
                "num_classes_evaluated": 0,
            }
        ap_all, rec_all = stats
        i75 = IOU_THRESHOLDS.tolist().index(0.75)
        out["mAP"] = float(ap_all.mean())
        out["mAP@0.5"] = float(ap_all[:, 0].mean())
        out["mAP@0.75"] = float(ap_all[:, i75].mean())
        out["AR@100"] = float(rec_all.mean())
        for md, key in ((1, "AR@1"), (10, "AR@10")):
            s = all_stats[md]
            out[key] = float(s[1].mean()) if s else 0.0
        for rng, ap_key, ar_key in (
            ("small", "mAP_small", "AR_small"),
            ("medium", "mAP_medium", "AR_medium"),
            ("large", "mAP_large", "AR_large"),
        ):
            s = self._range_stats(AREA_RANGES[rng], (self.max_dets,))[self.max_dets]
            out[ap_key] = float(s[0].mean()) if s else 0.0
            out[ar_key] = float(s[1].mean()) if s else 0.0
        out["num_classes_evaluated"] = int(ap_all.shape[0])
        return out
