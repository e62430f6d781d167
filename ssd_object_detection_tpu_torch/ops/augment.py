"""On-device SSD augmentation: photometric + expand + min-IoU crop + flip inside the train
step, port of ssd_object_detection_tpu/ops/augment.py.

Expand (zoom out onto a fill canvas), min-IoU crop (zoom in), resize and flip compose
into one affine resample of the stored S x S image,

    out(s_y, s_x) = img(a_y * (s_y + .5) + b_y, a_x * (s_x + .5) + b_x),  fill outside,

so the geometric recipe costs one bilinear sampling: two batched float32 products
against per-image (B, S_out, S_in) interpolation matrices, with out-of-range taps given
zero weight and the residual coverage assigned to the per-image fill color (the image
mean). Photometric jitter is elementwise. The crop's rejection sampling is vectorized:
`crop_attempts` candidate rects are evaluated at once and the first valid one wins.

The random draws are split from the arithmetic: `draw_augment` makes every uniform and
integer draw of a batch from a `torch.Generator` (`AugDraws`), and `augment_batch`
computes the rest with no randomness of its own, so a test can feed it the JAX
package's own draws.

Deviations from the host recipe (data/augment.py), deliberate and copied from the JAX
package as they are:
  - geometry is continuous (no int() truncation of canvas sizes or crop pixels);
  - photometric applies to the stored (already resized) image;
  - expand and crop resample the stored S x S pixels;
  - the first valid crop attempt wins (the lowest index, as `jnp.argmax` over bools).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ssd_object_detection_tpu_torch.utils.device import true_divide

# SSD-paper crop options (data/augment.py:22); index 0 = no crop. The -1 sentinel makes
# "max IoU >= min_iou" trivially true so the math stays branch-free.
_CROP_MIN_IOUS = (-1.0, 0.1, 0.3, 0.5, 0.7, 0.9)


@dataclasses.dataclass(frozen=True)
class AugConfig:
    """Static augmentation knobs of the train step (the JAX AugConfig's fields)."""

    photometric: bool = True
    expand: bool = True
    crop: bool = True
    flip: bool = True
    photometric_p: float = 0.5
    expand_p: float = 0.5
    expand_max_ratio: float = 4.0
    crop_attempts: int = 50

    @property
    def any_geometry(self) -> bool:
        return self.expand or self.crop or self.flip


class AugDraws(NamedTuple):
    """Every random draw of one batch's augmentation, uniforms in [0, 1)."""

    photometric: torch.Tensor  # (B, 6): coin and magnitude of brightness, contrast, saturation
    expand: torch.Tensor  # (B, 4): coin, ratio, top, left
    crop_option: torch.Tensor  # (B,) int64 in [0, 6): index into the min-IoU options
    crop_rects: torch.Tensor  # (B, crop_attempts, 4): width, height, left, top
    flip: torch.Tensor  # (B,): coin


def draw_augment(generator: torch.Generator, batch: int, cfg: AugConfig,
                 device: torch.device) -> AugDraws:
    """One batch's draws from `generator` (which lives on `device`), in a fixed order."""
    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return AugDraws(
        photometric=uniform(batch, 6),
        expand=uniform(batch, 4),
        crop_option=torch.randint(0, len(_CROP_MIN_IOUS), (batch,), generator=generator,
                                  device=device),
        crop_rects=uniform(batch, cfg.crop_attempts, 4),
        flip=uniform(batch),
    )


def photometric(img01: torch.Tensor, u: torch.Tensor, p: float) -> torch.Tensor:
    """Brightness, contrast and saturation jitter of (B, S, S, 3) [0, 1] images, each
    gated by its own coin (the ops and ranges of data/augment.py:107-117)."""
    def col(i):
        return u[:, i].reshape(-1, 1, 1, 1)

    img01 = torch.where(col(0) < p, torch.clamp(img01 + (col(1) * 0.24 - 0.12), 0.0, 1.0), img01)
    img01 = torch.where(
        col(2) < p, torch.clamp((img01 - 0.5) * (0.7 + col(3) * 0.6) + 0.5, 0.0, 1.0), img01
    )
    gray = img01.mean(dim=3, keepdim=True)
    return torch.where(
        col(4) < p, torch.clamp(gray + (img01 - gray) * (0.7 + col(5) * 0.6), 0.0, 1.0), img01
    )


def geometry_from_draws(
    boxes: torch.Tensor,  # (B, G, 4) relative cxcywh
    valid: torch.Tensor,  # (B, G) bool
    cfg: AugConfig,
    draws: AugDraws,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-image geometry -> (org_window (B, 4) xyxy, crop_rect (B, 4) xyxy, flip (B,) bool).

    `org_window` is where the original image sits inside the (conceptual) expanded
    frame; `crop_rect` is the chosen patch in that same frame. Both relative."""
    batch, device = boxes.shape[0], boxes.device
    if cfg.expand:  # isotropic ratio, uniform placement (data/augment.py:25-42)
        ue = draws.expand
        ratio = torch.where(ue[:, 0] < cfg.expand_p,
                            1.0 + ue[:, 1] * (cfg.expand_max_ratio - 1.0), 1.0)
        osz = 1.0 / ratio
        oy0 = ue[:, 2] * (1.0 - osz)
        ox0 = ue[:, 3] * (1.0 - osz)
    else:
        osz = torch.ones(batch, device=device)
        oy0 = ox0 = torch.zeros(batch, device=device)
    org_window = torch.stack([ox0, oy0, ox0 + osz, oy0 + osz], dim=1)

    # boxes in the expanded frame (cxcywh)
    ecx = boxes[..., 0] * osz[:, None] + ox0[:, None]
    ecy = boxes[..., 1] * osz[:, None] + oy0[:, None]
    ew = boxes[..., 2] * osz[:, None]
    eh = boxes[..., 3] * osz[:, None]

    # built on the device: a tensor made from a Python list would be a blocking copy
    crop_rect = torch.zeros(batch, 4, device=device)
    crop_rect[:, 2:] = 1.0
    if cfg.crop:  # min-IoU crop (data/augment.py:54-104), every attempt at once
        opt = draws.crop_option
        min_iou = torch.full((batch,), _CROP_MIN_IOUS[0], device=device)
        for i, value in enumerate(_CROP_MIN_IOUS[1:], 1):
            min_iou = torch.where(opt == i, value, min_iou)
        u = draws.crop_rects
        cw = 0.3 + 0.7 * u[..., 0]
        ch = 0.3 + 0.7 * u[..., 1]
        aspect_ok = (cw / ch >= 0.5) & (cw / ch <= 2.0)
        x0 = u[..., 2] * (1.0 - cw)
        y0 = u[..., 3] * (1.0 - ch)
        rects = torch.stack([x0, y0, x0 + cw, y0 + ch], dim=-1)  # (B, A, 4)

        bx0, by0 = ecx - ew / 2, ecy - eh / 2
        bx1, by1 = ecx + ew / 2, ecy + eh / 2
        r = rects[..., None, :]  # (B, A, 1, 4) against (B, 1, G) boxes
        ix0 = torch.maximum(r[..., 0], bx0[:, None, :])
        iy0 = torch.maximum(r[..., 1], by0[:, None, :])
        ix1 = torch.minimum(r[..., 2], bx1[:, None, :])
        iy1 = torch.minimum(r[..., 3], by1[:, None, :])
        inter = torch.clamp(ix1 - ix0, min=0.0) * torch.clamp(iy1 - iy0, min=0.0)  # (B, A, G)
        area_b = torch.clamp(bx1 - bx0, min=0.0) * torch.clamp(by1 - by0, min=0.0)
        area_r = cw * ch
        iou = inter / torch.clamp(area_b[:, None, :] + area_r[..., None] - inter, min=1e-10)
        iou = torch.where(valid[:, None, :], iou, -1.0)
        centers_in = (
            (ecx[:, None, :] > r[..., 0]) & (ecx[:, None, :] < r[..., 2])
            & (ecy[:, None, :] > r[..., 1]) & (ecy[:, None, :] < r[..., 3])
            & valid[:, None, :]
        )
        ok = aspect_ok & (iou.max(dim=-1).values >= min_iou[:, None]) & centers_in.any(dim=-1)
        do_crop = (opt > 0) & ok.any(dim=-1)
        # the first valid attempt, like the host's loop: the lowest index among the valid
        attempts = ok.shape[-1]
        iota = torch.arange(attempts, device=device)
        first = torch.where(ok, iota, attempts).amin(dim=-1).clamp(max=attempts - 1)
        chosen = torch.gather(rects, 1, first[:, None, None].expand(batch, 1, 4))[:, 0]
        crop_rect = torch.where(do_crop[:, None], chosen, crop_rect)

    if cfg.flip:
        flip = draws.flip < 0.5
    else:
        flip = torch.zeros(batch, dtype=torch.bool, device=device)
    return org_window, crop_rect, flip


def axis_matrix(a: torch.Tensor, b: torch.Tensor, s_out: int, s_in: int) -> torch.Tensor:
    """(B, S_out, S_in) bilinear weights of src = a * (s + .5) + b - .5; taps outside
    [0, S_in) get zero weight."""
    pos = torch.arange(s_out, dtype=torch.float32, device=a.device) + 0.5
    src = a[:, None] * pos[None, :] + b[:, None] - 0.5  # (B, S_out) pixel index
    i0 = torch.floor(src)
    frac = src - i0
    i0 = i0.to(torch.int32)[..., None]
    cols = torch.arange(s_in, dtype=torch.int32, device=a.device)
    m0 = torch.where(i0 == cols, (1.0 - frac)[..., None], 0.0)
    m1 = torch.where(i0 + 1 == cols, frac[..., None], 0.0)
    return m0 + m1


def apply_geometry(
    img01: torch.Tensor,  # (B, S, S, 3) float32 [0, 1]
    boxes: torch.Tensor,  # (B, G, 4) relative cxcywh
    cls: torch.Tensor,  # (B, G) int32
    valid: torch.Tensor,  # (B, G) bool
    org_window: torch.Tensor,  # (B, 4) xyxy: the original image in the expanded frame
    crop_rect: torch.Tensor,  # (B, 4) xyxy: the patch in the expanded frame
    flip: torch.Tensor,  # (B,) bool
    out_size: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deterministic core: one affine bilinear resample + the box transform."""
    s_in = img01.shape[1]
    s_out = out_size or s_in
    fill = img01.mean(dim=(1, 2))  # (B, 3): the expand fill color (data/augment.py:35)

    ox0, oy0 = org_window[:, 0], org_window[:, 1]
    ow = org_window[:, 2] - org_window[:, 0]
    oh = org_window[:, 3] - org_window[:, 1]
    cx0, cy0 = crop_rect[:, 0], crop_rect[:, 1]
    cw = crop_rect[:, 2] - crop_rect[:, 0]
    ch = crop_rect[:, 3] - crop_rect[:, 1]

    # output pixel s -> source coordinate: u = c0 + (s + .5) / S * csz (expanded frame)
    # -> v = (u - o0) / osz (original, relative) -> src = v * S_in
    a_y = ch / (oh * s_out) * s_in
    b_y = (cy0 - oy0) / oh * s_in
    a_x = cw / (ow * s_out) * s_in
    b_x = (cx0 - ox0) / ow * s_in
    # the horizontal flip mirrors the output: s -> S-1-s  <=>  a' = -a, b' = a*S + b
    a_xf = torch.where(flip, -a_x, a_x)
    b_xf = torch.where(flip, a_x * s_out + b_x, b_x)

    # float32 products, as in the JAX package: photometric'd pixels are arbitrary floats,
    # so the exactness argument of ops/preprocess.py's bf16 resize does not hold here
    ry = axis_matrix(a_y, b_y, s_out, s_in)  # (B, S_out, S_in)
    rx = axis_matrix(a_xf, b_xf, s_out, s_in)
    planar = img01.permute(0, 3, 1, 2).float()  # (B, 3, S_in, S_in)
    rows = torch.matmul(ry[:, None], planar)  # (B, 3, S_out, S_in)
    out = torch.matmul(rows, rx[:, None].transpose(-1, -2))  # (B, 3, S_out, S_out)
    # fill: the sampled weights sum to cov_y * cov_x; the residual mass is fill color
    cov = ry.sum(-1)[:, :, None] * rx.sum(-1)[:, None, :]
    out = out + fill[:, :, None, None] * (1.0 - cov[:, None])
    out_img = torch.clamp(out.permute(0, 2, 3, 1), 0.0, 1.0)  # (B, S_out, S_out, 3)

    # boxes: original relative -> expanded frame -> crop frame, clip, keep, flip
    zeros = torch.zeros_like(ox0)
    eb = boxes * torch.stack([ow, oh, ow, oh], dim=1)[:, None, :] \
        + torch.stack([ox0, oy0, zeros, zeros], dim=1)[:, None, :]
    ex0 = eb[..., 0] - eb[..., 2] / 2
    ey0 = eb[..., 1] - eb[..., 3] / 2
    ex1 = eb[..., 0] + eb[..., 2] / 2
    ey1 = eb[..., 1] + eb[..., 3] / 2
    lo_x, hi_x = crop_rect[:, None, 0], crop_rect[:, None, 2]
    lo_y, hi_y = crop_rect[:, None, 1], crop_rect[:, None, 3]
    keep = (eb[..., 0] > lo_x) & (eb[..., 0] < hi_x) & (eb[..., 1] > lo_y) & (eb[..., 1] < hi_y)
    kx0 = (torch.clamp(ex0, lo_x, hi_x) - cx0[:, None]) / cw[:, None]
    kx1 = (torch.clamp(ex1, lo_x, hi_x) - cx0[:, None]) / cw[:, None]
    ky0 = (torch.clamp(ey0, lo_y, hi_y) - cy0[:, None]) / ch[:, None]
    ky1 = (torch.clamp(ey1, lo_y, hi_y) - cy0[:, None]) / ch[:, None]
    ncx = (kx0 + kx1) / 2
    ncx = torch.where(flip[:, None], 1.0 - ncx, ncx)
    new_boxes = torch.stack([ncx, (ky0 + ky1) / 2, kx1 - kx0, ky1 - ky0], dim=-1)
    new_valid = valid & keep
    new_boxes = torch.where(new_valid[..., None], new_boxes, 0.0)
    new_cls = torch.where(new_valid, cls, 0)
    return out_img, new_boxes.float(), new_cls, new_valid


def augment_batch(
    image: torch.Tensor,  # (B, S, S, 3) uint8 or float32 [0, 1]
    gt_boxes: torch.Tensor,
    gt_cls: torch.Tensor,
    gt_valid: torch.Tensor,
    cfg: AugConfig,
    draws: AugDraws,
    out_size: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The full recipe on a batch from its draws: photometric -> expand -> crop -> flip
    (the host order, data/augment.py:120-132 and the pipeline's flip). Returns float32
    [0, 1] images and the transformed (boxes, cls, valid)."""
    if image.dtype == torch.uint8:
        image = true_divide(image.float(), 255.0)
    if cfg.photometric:
        image = photometric(image, draws.photometric, cfg.photometric_p)
    if not cfg.any_geometry:
        return image, gt_boxes, gt_cls, gt_valid
    org_window, crop_rect, flip = geometry_from_draws(gt_boxes, gt_valid, cfg, draws)
    return apply_geometry(image, gt_boxes, gt_cls, gt_valid, org_window, crop_rect, flip,
                          out_size=out_size)
