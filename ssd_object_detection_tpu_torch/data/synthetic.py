"""Hermetic synthetic detection dataset: colored rectangles on noise backgrounds.

The reference has no hermetic data path — every integration test needs a real COCO
download (SURVEY.md section 4). This generator gives deterministic images + boxes with
learnable structure (class == rectangle color), so end-to-end train/overfit tests and
benchmarks run with zero external data.

Yields the same contract as the COCO pipeline: images float32 [0,1] (S,S,3), padded
GT arrays (max_gt,), (max_gt, 4) relative cxcywh, (max_gt,) validity.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# distinct, saturated colors; class id = index
_CLASS_COLORS = np.array(
    [
        [1.0, 0.1, 0.1], [0.1, 1.0, 0.1], [0.1, 0.1, 1.0], [1.0, 1.0, 0.1],
        [1.0, 0.1, 1.0], [0.1, 1.0, 1.0], [1.0, 0.6, 0.1], [0.6, 0.1, 1.0],
    ],
    dtype=np.float32,
)


@dataclasses.dataclass
class SyntheticDetectionDataset:
    num_images: int = 64
    image_size: int = 300
    max_gt: int = 8
    num_classes: int = 8  # <= len(_CLASS_COLORS)
    seed: int = 0

    def __post_init__(self):
        assert self.num_classes <= len(_CLASS_COLORS)

    def sample(self, index: int):
        """Deterministic per-index sample: (image, gt_cls, gt_boxes, gt_valid).

        Objects are rejection-sampled to be mutually non-overlapping: rectangles are
        drawn by overwriting pixels, so an overlapping earlier box would keep its GT
        while losing its appearance — an unlearnable target that caps achievable
        recall (~0.35 measured) and would make the mAP convergence gate
        (tools/eval_synthetic.py) meaningless.
        """
        rng = np.random.default_rng(self.seed * 100003 + index)
        s = self.image_size
        image = rng.uniform(0.35, 0.45, (s, s, 3)).astype(np.float32)
        n_obj = int(rng.integers(1, self.max_gt + 1))
        gt_cls = np.zeros((self.max_gt,), np.int32)
        gt_boxes = np.zeros((self.max_gt, 4), np.float32)
        gt_valid = np.zeros((self.max_gt,), bool)
        placed = 0
        for _ in range(n_obj * 25):
            if placed >= n_obj:
                break
            cls = int(rng.integers(0, self.num_classes))
            w = float(rng.uniform(0.12, 0.5))
            h = float(rng.uniform(0.12, 0.5))
            cx = float(rng.uniform(w / 2, 1 - w / 2))
            cy = float(rng.uniform(h / 2, 1 - h / 2))
            x0, x1 = int((cx - w / 2) * s), int((cx + w / 2) * s)
            y0, y1 = int((cy - h / 2) * s), int((cy + h / 2) * s)
            clear = True
            for j in range(placed):
                pcx, pcy, pw, ph = gt_boxes[j]
                # reject any intersection (with a 2-px moat so boxes stay crisp)
                if (
                    abs(cx - pcx) * s < (w + pw) / 2 * s + 2
                    and abs(cy - pcy) * s < (h + ph) / 2 * s + 2
                ):
                    clear = False
                    break
            if not clear:
                continue
            image[y0:y1, x0:x1] = _CLASS_COLORS[cls]
            gt_cls[placed], gt_boxes[placed], gt_valid[placed] = cls, (cx, cy, w, h), True
            placed += 1
        return image, gt_cls, gt_boxes, gt_valid

    def batches(self, batch_size: int, epochs: int = 1, shuffle: bool = False,
                order_rng=None):
        """Yield dict batches matching the train-step contract; drops the remainder
        (the reference batches with drop_remainder=True, models/ssd_model.py:225).

        Pass a persistent `order_rng` to advance the shuffle across separate calls
        (the Trainer pulls one epoch per call; a fresh rng per call would replay
        the same permutation every epoch)."""
        if order_rng is None:
            order_rng = np.random.default_rng(self.seed)
        for _ in range(epochs):
            order = np.arange(self.num_images)
            if shuffle:
                order_rng.shuffle(order)
            for start in range(0, self.num_images - batch_size + 1, batch_size):
                idx = order[start : start + batch_size]
                samples = [self.sample(int(i)) for i in idx]
                yield {
                    "image": np.stack([x[0] for x in samples]),
                    "gt_cls": np.stack([x[1] for x in samples]),
                    "gt_boxes": np.stack([x[2] for x in samples]),
                    "gt_valid": np.stack([x[3] for x in samples]),
                }
