"""Anchor (prior/default box) generation for SSD variants.

Replaces the reference's per-cell python loop (models/ssd_model.py:173-194,
`_build_prior_box` with itertools.product) with a vectorized builder. Anchor ordering
is identical to the reference: feature maps in head order; within a map, cells iterate
y-major then x (matching a row-major NHWC reshape of the head outputs,
models/ssd_model.py:166-167); within a cell: the s_k square, the sqrt(s_k*s_{k+1})
square, then per aspect ratio r the (s_k*sqrt(r), s_k/sqrt(r)) box followed by its
transpose (models/ssd_model.py:185-192).

Anchors are cxcywh, relative to image size, and are NOT clipped to [0, 1]
(the reference does not clip).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class AnchorSpec:
    """Static description of an SSD anchor grid (one entry per feature map)."""

    image_size: int
    feature_sizes: Tuple[Tuple[int, int], ...]  # (h, w) per map
    scale_refs: Tuple[int, ...]  # len == len(feature_sizes) + 1, in pixels
    aspect_ratios: Tuple[Tuple[int, ...], ...]

    def __post_init__(self):
        assert len(self.scale_refs) == len(self.feature_sizes) + 1
        assert len(self.aspect_ratios) == len(self.feature_sizes)

    @property
    def anchors_per_cell(self) -> Tuple[int, ...]:
        """Reference num_priors (models/ssd_model.py:153): 2 squares + 2 per ratio."""
        return tuple(2 + 2 * len(r) for r in self.aspect_ratios)

    @property
    def num_anchors(self) -> int:
        return sum(h * w * n for (h, w), n in zip(self.feature_sizes, self.anchors_per_cell))


# Reference SSD300 spec: scales [21,...,315]/300, ratios per map, grids 38..1
# (models/ssd_model.py:176-177 and the conv stack at :84-151) -> 8,732 anchors.
SSD300_SPEC = AnchorSpec(
    image_size=300,
    feature_sizes=((38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)),
    scale_refs=(21, 45, 99, 153, 207, 261, 315),
    aspect_ratios=((2,), (2, 3), (2, 3), (2, 3), (2,), (2,)),
)

# SSD512 variant (BASELINE.json config #4): 7 feature maps, canonical-SSD512-style
# scales (rounded to ints), 24,564 anchors.
SSD512_SPEC = AnchorSpec(
    image_size=512,
    feature_sizes=((64, 64), (32, 32), (16, 16), (8, 8), (4, 4), (2, 2), (1, 1)),
    scale_refs=(36, 77, 154, 230, 307, 384, 461, 538),
    aspect_ratios=((2,), (2, 3), (2, 3), (2, 3), (2, 3), (2,), (2,)),
)


def _cell_templates(spec: AnchorSpec, level: int) -> np.ndarray:
    """(A, 2) width/height templates for one feature map, in reference per-cell order."""
    s_k = spec.scale_refs[level] / spec.image_size
    s_k_next = spec.scale_refs[level + 1] / spec.image_size
    s_k_prime = math.sqrt(s_k * s_k_next)
    wh = [(s_k, s_k), (s_k_prime, s_k_prime)]
    for ratio in spec.aspect_ratios[level]:
        root = math.sqrt(ratio)
        wh.append((s_k * root, s_k / root))
        wh.append((s_k / root, s_k * root))
    return np.asarray(wh, dtype=np.float32)


def generate_anchors(spec: AnchorSpec = SSD300_SPEC, dtype=np.float32) -> np.ndarray:
    """All anchors for `spec` as a (num_anchors, 4) cxcywh array.

    Runs once at model-build time on the host (it is static data); the result is closed
    over by the jitted train/predict steps as a constant.
    """
    levels = []
    for level, (h, w) in enumerate(spec.feature_sizes):
        wh = _cell_templates(spec, level)  # (A, 2)
        num_per_cell = wh.shape[0]
        cx = (np.arange(w, dtype=np.float64) + 0.5) / w
        cy = (np.arange(h, dtype=np.float64) + 0.5) / h
        # y-major, x-minor grid to match the reference's product(range(h), range(w))
        centers = np.stack(np.meshgrid(cy, cx, indexing="ij"), axis=-1)[..., ::-1]  # (h, w, 2) = (cx, cy)
        centers = np.broadcast_to(centers[:, :, None, :], (h, w, num_per_cell, 2))
        whs = np.broadcast_to(wh[None, None, :, :], (h, w, num_per_cell, 2))
        levels.append(np.concatenate([centers, whs], axis=-1).reshape(-1, 4))
    anchors = np.concatenate(levels, axis=0).astype(dtype)
    assert anchors.shape == (spec.num_anchors, 4)
    return anchors
