"""A numpy replay of the fused IDCT and colour kernel's tile walk (csrc/jpeg_decode.cu,
idct_color_kernel).

The kernel decodes a batch's JPEG pixels with one CTA a tile of the batch's tile table
(data/codec.py::jpeg_batch): a whole number of MCUs of one image, at most
JPEG_TILE_H x JPEG_TILE_W pixels. A tile:
  1. takes, for each component, the rectangle of blocks under it, widened by one sample
     each side where the component is upsampled fancily in that direction (the rows
     above and below for h1v2 and h2v2, the columns left and right for h2v1 and h2v2)
     and cut at the component's edge; these blocks (the halo ones decoded again by every
     tile that needs them) go through the islow IDCT into planes in shared memory, at
     most JPEG_POOL_BLOCKS blocks a tile;
  2. upsamples and converts every pixel of the tile from those planes alone, staging
     the RGB in the output's orientation (the tile's rows and columns swap for
     orientations 5-8); 4:2:0 YCbCr at orientation 1 goes a 2 x 2 quad of pixels at a
     time, each chroma component's four samples from one 3 x 3 neighbourhood
     (`chroma_quads`);
  3. writes each staged row to its row of the oriented image.
`decode(coef, batch)` replays that and returns the RGB and how many times each output
byte was written; it must equal plain_image.color(plain_image.idct(...)) with every byte
written once, over the batch's own tiles and over the tiles of any other shape
(`tiles_at`). A sample read outside a tile's planes raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ssd_object_detection_tpu_torch.data import codec
from ssd_object_detection_tpu_torch.data.codec import JpegBatch, UP_BOX, UP_COPY, UP_H1V2, UP_H2V1, UP_H2V2
from ssd_object_detection_tpu_torch.ops.plain_image import _i16, _idct_1d, orientation_source, to_rgb


def _blocks(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(n, 8, 8) uint8 samples of n coefficient blocks (int16 (n, 64)): pass 1 a column,
    pass 2 a row, as the kernel's 8 threads a block compute them."""
    c = _i16(coef.astype(np.int64) * q.astype(np.int64)).reshape(-1, 8, 8)
    cols = _idct_1d(np.swapaxes(c, 1, 2), 11)
    rows = _idct_1d(np.swapaxes(cols, 1, 2), 18)
    return (np.clip(rows, -128, 127) + 128).astype(np.uint8)


def _upsample(plane: np.ndarray, ly0: int, lx0: int, y: np.ndarray, x: np.ndarray, dw: int, dh: int, fh: int,
              fv: int, mode: int) -> np.ndarray:
    """The kernel's upsample over a tile's plane (samples from (ly0, lx0))."""
    p = plane.astype(np.int32)

    def at(i, j):
        i, j = np.asarray(i) - ly0, np.asarray(j) - lx0
        if (i < 0).any() or (j < 0).any() or (i >= p.shape[0]).any() or (j >= p.shape[1]).any():
            raise IndexError("a sample outside the tile's planes")
        return p[i, j]

    if mode == UP_COPY:
        return at(y, x)
    if mode == UP_BOX:
        return at(y // fv, x // fh)
    if mode == UP_H1V2:
        i = y >> 1
        odd = (y & 1) == 1
        return (3 * at(i, x) + at(np.where(odd, np.minimum(i + 1, dh - 1), np.maximum(i - 1, 0)), x)
                + np.where(odd, 2, 1)) >> 2
    j = x >> 1
    xodd = (x & 1) == 1
    edge = np.where(xodd, j == dw - 1, j == 0)
    jj = np.where(edge, j, np.where(xodd, j + 1, j - 1))  # not read at the edge
    if mode == UP_H2V1:
        near = at(y, j)
        return np.where(edge, near, (3 * near + at(y, jj) + np.where(xodd, 2, 1)) >> 2)
    i = y >> 1
    i1 = np.where((y & 1) == 1, np.minimum(i + 1, dh - 1), np.maximum(i - 1, 0))
    here = 3 * at(i, j) + at(i1, j)
    there = 3 * at(i, jj) + at(i1, jj)
    return np.where(edge, (4 * here + np.where(xodd, 7, 8)) >> 4, (3 * here + there + np.where(xodd, 7, 8)) >> 4)


def chroma_quads(plane: np.ndarray, ly0: int, lx0: int, i: np.ndarray, j: np.ndarray, dw: int,
                 dh: int) -> np.ndarray:
    """The kernel's chroma_quad: fancy h2v2's four samples (even row: even, odd column;
    odd row: even, odd column) of the quads at chroma sample (i, j), from rows i - 1 ..
    i + 1 and columns j - 1 .. j + 1 of the tile's plane, clamped to the component."""
    p = plane.astype(np.int32)

    def at(a, b):
        a, b = a - ly0, b - lx0
        if (a < 0).any() or (b < 0).any() or (a >= p.shape[0]).any() or (b >= p.shape[1]).any():
            raise IndexError("a sample outside the tile's planes")
        return p[a, b]

    up, down = np.maximum(i - 1, 0), np.minimum(i + 1, dh - 1)
    cols = [np.clip(j - 1 + k, 0, dw - 1) for k in range(3)]
    even = [3 * at(i, b) + at(up, b) for b in cols]
    odd = [3 * at(i, b) + at(down, b) for b in cols]
    left, right = j == 0, j == dw - 1
    return np.stack([np.where(left, (4 * even[1] + 8) >> 4, (3 * even[1] + even[0] + 8) >> 4),
                     np.where(right, (4 * even[1] + 7) >> 4, (3 * even[1] + even[2] + 7) >> 4),
                     np.where(left, (4 * odd[1] + 8) >> 4, (3 * odd[1] + odd[0] + 8) >> 4),
                     np.where(right, (4 * odd[1] + 7) >> 4, (3 * odd[1] + odd[2] + 7) >> 4)])


def tile_corner(orientation: int, h: int, w: int, y0: int, x0: int, th: int, tw: int) -> Tuple[int, int]:
    """Where a tile of decoded rows [y0, y0 + th) and columns [x0, x0 + tw) lands in the
    oriented image: its first row and column there."""
    return {1: (y0, x0), 2: (y0, w - x0 - tw), 3: (h - y0 - th, w - x0 - tw), 4: (h - y0 - th, x0),
            5: (x0, y0), 6: (x0, h - y0 - th), 7: (w - x0 - tw, h - y0 - th), 8: (w - x0 - tw, y0)}[orientation]


def tiles_at(images: Sequence[codec.JpegImage], tile_hw: Tuple[int, int]) -> np.ndarray:
    """A tile table of the batch of `images` (codec.jpeg_batch's order) at another tile
    shape than the kernel's: the most whole MCUs that fit in `tile_hw`, at least one."""
    rows = []
    for index, im in enumerate(images):
        shape = (8 * im.vmax * max(1, tile_hw[0] // (8 * im.vmax)), 8 * im.hmax * max(1, tile_hw[1] // (8 * im.hmax)))
        rows.append(codec.image_tiles(index, im.height, im.width, shape))
    return np.concatenate(rows)


def decode(coef: np.ndarray, batch: JpegBatch, tiles: Optional[np.ndarray] = None
           ) -> Tuple[np.ndarray, np.ndarray, int]:
    """The kernel's walk over `tiles` (the batch's own by default): (uint8
    (total_bytes,) RGB or raw components, int (total_bytes,) writes a byte, the most blocks
    a tile held)."""
    qt, images = batch.qtables.numpy(), batch.images.numpy()
    out = np.zeros(batch.total_bytes, np.uint8)
    writes = np.zeros(batch.total_bytes, np.int64)
    most = 0
    for index, y0, x0, th, tw in (batch.tiles.numpy() if tiles is None else tiles).tolist():
        im = images[index].tolist()
        off, oh, ow, h, w, orient, ncomp, space = im[:8]
        th, tw = min(th, h - y0), min(tw, w - x0)
        planes, held = [], 0
        for c in range(ncomp):  # 1. the blocks under the tile and its halo, through the IDCT
            poff, stride, dw, dh, fh, fv, mode, q = im[8 + 8 * c:16 + 8 * c]
            hh, hv = int(mode in (UP_H2V1, UP_H2V2)), int(mode in (UP_H1V2, UP_H2V2))
            bx0, bx1 = max(0, x0 // fh - hh) >> 3, min(dw - 1, (x0 + tw - 1) // fh + hh) >> 3
            by0, by1 = max(0, y0 // fv - hv) >> 3, min(dh - 1, (y0 + th - 1) // fv + hv) >> 3
            bw = stride // 8
            ids = poff // 64 + np.arange(by0, by1 + 1)[:, None] * bw + np.arange(bx0, bx1 + 1)[None, :]
            px = _blocks(coef[ids.reshape(-1)], qt[q])
            nby, nbx = ids.shape
            planes.append((px.reshape(nby, nbx, 8, 8).transpose(0, 2, 1, 3).reshape(nby * 8, nbx * 8), by0 * 8,
                           bx0 * 8))
            held += nby * nbx
        most = max(most, held)
        # 2. every pixel from the planes, staged in the output's orientation
        rows, cols = (tw, th) if orient >= 5 else (th, tw)
        oy0, ox0 = tile_corner(orient, h, w, y0, x0, th, tw)
        y, x = orientation_source(oh, ow, h, w, orient)
        y, x = y[oy0:oy0 + rows, ox0:ox0 + cols], x[oy0:oy0 + rows, ox0:ox0 + cols]
        modes = [im[14 + 8 * c] for c in range(ncomp)]
        if ncomp == 3 and space == codec.SPACE_YCC and orient == 1 and modes == [UP_COPY, UP_H2V2, UP_H2V2]:
            # the quad path: quad (r2, q2) covers staged rows 2 r2, 2 r2 + 1 and columns 2 q2, 2 q2 + 1
            r2, q2 = np.meshgrid(np.arange(0, rows, 2), np.arange(0, cols, 2), indexing="ij")
            i, j = (y0 + r2) >> 1, (x0 + q2) >> 1
            comp = [_upsample(planes[0][0], planes[0][1], planes[0][2], y, x, *im[10:15])]
            for c in (1, 2):
                quads = chroma_quads(planes[c][0], planes[c][1], planes[c][2], i, j, im[10 + 8 * c], im[11 + 8 * c])
                full = np.zeros((2 * r2.shape[0], 2 * r2.shape[1]), np.int64)
                for k in range(4):
                    full[k >> 1::2, k & 1::2] = quads[k]
                comp.append(full[:rows, :cols])
        else:
            comp = [_upsample(plane, ly0, lx0, y, x, *im[10 + 8 * c:15 + 8 * c])
                    for c, (plane, ly0, lx0) in enumerate(planes)]
        stage = to_rgb(comp, space)
        n = stage.shape[-1]
        # 3. each staged row to its row of the oriented image
        for r in range(rows):
            at = off + n * ((oy0 + r) * ow + ox0)
            out[at:at + n * cols] = stage[r].reshape(-1)
            writes[at:at + n * cols] += 1
    return out, writes, most
