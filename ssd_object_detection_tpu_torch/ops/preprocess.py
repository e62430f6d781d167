"""On-device preprocessing: uint8 canvas -> per-image resize -> normalize, port of
ssd_object_detection_tpu/ops/preprocess.py.

The host keeps only image decode; each decoded image is pasted into a fixed planar
uint8 canvas (B, 3, Hc, Wc) with its (h, w) extent (`pack_canvas`), and the device
resizes every image to S x S with the cv2 INTER_LINEAR sample grid:
src = (dst + 0.5) * scale - 0.5, clamped to the valid region (replicate border).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ssd_object_detection_tpu_torch.utils.device import true_divide


def _axis_grid(valid: torch.Tensor, out_size: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bilinear sample grid along one axis.

    Args:
      valid: (B,) int32, the valid extent of each image along this axis.
      out_size: output extent S.
    Returns (i0, i1, frac): (B, S) int64, int64, float32 with i0 <= i1 < valid.
    """
    pos = torch.arange(out_size, dtype=torch.float32, device=valid.device) + 0.5  # (S,)
    extent = valid.to(torch.float32)
    scale = true_divide(extent, out_size)  # (B,)
    src = pos[None, :] * scale[:, None] - 0.5  # (B, S)
    src = torch.minimum(torch.clamp(src, min=0.0), extent[:, None] - 1.0)
    i0 = torch.floor(src).long()
    i1 = torch.minimum(i0 + 1, valid[:, None].long() - 1)
    return i0, i1, src - i0.to(torch.float32)


def _axis_matrix(valid: torch.Tensor, out_size: int, in_size: int) -> torch.Tensor:
    """Dense per-image interpolation matrix (B, S, in_size) float32: row s holds weight
    (1 - frac) at column i0[s] and frac at i1[s] (a single 1.0 where i0 == i1)."""
    i0, i1, frac = _axis_grid(valid, out_size)
    cols = torch.arange(in_size, device=valid.device)
    m0 = torch.where(i0[..., None] == cols, 1.0 - frac[..., None], 0.0)
    m1 = torch.where(i1[..., None] == cols, frac[..., None], 0.0)
    return m0 + m1  # (B, S, in_size)


def resize_bilinear_planar(
    canvas_u8: torch.Tensor,  # (B, 3, Hc, Wc) uint8, image in the top-left (h, w) region
    sizes: torch.Tensor,  # (B, 2) int32: (h, w) valid extents
    out_size: int,
    method: str = "matmul",
) -> torch.Tensor:
    """Per-image bilinear resize of the valid canvas region -> (B, S, S, 3) float32 [0, 1].

    method="matmul" (default): separable resize as two batched products against
    per-image interpolation matrices, out = R @ img @ C^T, with the JAX package's
    rounding: the weights and the row-pass intermediate are rounded to bf16, and both
    products multiply and sum in float32 (a product of two bf16 values is exact in
    float32, and each output sums at most two nonzero terms, so the float32 results do
    not depend on TF32 or on the summation order). Identity-size sampling is exact.

    method="gather": two gathers and lerps, full float32 arithmetic.
    """
    if method == "matmul":
        hc, wc = canvas_u8.shape[2], canvas_u8.shape[3]
        r = _axis_matrix(sizes[:, 0], out_size, hc).to(torch.bfloat16).float()  # (B, S, Hc)
        c = _axis_matrix(sizes[:, 1], out_size, wc).to(torch.bfloat16).float()  # (B, S, Wc)
        rows = torch.matmul(r[:, None], canvas_u8.float())  # (B, 3, S, Wc)
        rows = rows.to(torch.bfloat16).float()
        out = torch.matmul(rows, c[:, None].transpose(-1, -2))  # (B, 3, S, S)
    elif method == "gather":
        batch, ch, _, wc = canvas_u8.shape
        y0, y1, wy = _axis_grid(sizes[:, 0], out_size)
        x0, x1, wx = _axis_grid(sizes[:, 1], out_size)
        # rows: gather along Hc -> (B, 3, S, Wc); lerp in float32
        row_index = lambda i: i[:, None, :, None].expand(batch, ch, out_size, wc)  # noqa: E731
        r0 = torch.gather(canvas_u8, 2, row_index(y0)).float()
        r1 = torch.gather(canvas_u8, 2, row_index(y1)).float()
        rows = r0 + (r1 - r0) * wy[:, None, :, None]
        # cols: gather along Wc -> (B, 3, S, S)
        col_index = lambda i: i[:, None, None, :].expand(batch, ch, out_size, out_size)  # noqa: E731
        c0 = torch.gather(rows, 3, col_index(x0))
        c1 = torch.gather(rows, 3, col_index(x1))
        out = c0 + (c1 - c0) * wx[:, None, None, :]
    else:
        raise ValueError(f"unknown resize method {method!r}")

    return true_divide(out.permute(0, 2, 3, 1), 255.0)  # (B, S, S, 3) in [0, 1]


def normalize01(images01: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> [-1, 1], the reference's (x - 0.5) * 2."""
    return (images01 - 0.5) * 2.0


def pack_canvas(images, canvas_hw: Tuple[int, int] = (640, 640)):
    """HOST helper: list of HWC uint8 arrays -> (planar canvas (B, 3, Hc, Wc), sizes (B, 2)).

    Raises if an image exceeds the canvas; COCO's max side is 640, so the default
    canvas fits every COCO image. Larger sources must be shrunk by the caller.
    """
    hc, wc = canvas_hw
    b = len(images)
    canvas = np.zeros((b, 3, hc, wc), np.uint8)
    sizes = np.zeros((b, 2), np.int32)
    for i, img in enumerate(images):
        h, w = img.shape[:2]
        if h > hc or w > wc:
            raise ValueError(f"image {i} ({h}x{w}) exceeds canvas {hc}x{wc}")
        canvas[i, :, :h, :w] = img.transpose(2, 0, 1)
        sizes[i] = (h, w)
    return canvas, sizes
