"""A plain PyTorch model of the int8 conv kernel's tile walk (csrc/int8_conv.cu), for the CPU.

The kernel does not compute the conv as ops/cuda_int8.py::accumulate_plain writes it
down (one float64 conv). A persistent CTA walks tiles t = blockIdx.x, + gridDim.x, ...
with the N-block innermost; its two consumer warpgroups take every other tile. Per
tile and ring stage the producer asks TMA for a box of `row` channels of xq at the
origin (w0 * SW - PL + kw, h0 * SH - PT + kh), zero outside the tensor, landing as
box_rows x pitch pixels in a buffer of `halo_pixels` rows whose slack is zero (TMA's
swizzle permutes the 16-byte units inside a row and moves no value between rows, so
the model leaves it out), and copies the stage's weights in bulk from the packed
tensor (ops/cuda_int8.py::pack_weights), whose swizzle the model undoes as wgmma's
reads do. A consumer then issues, per tap of the stage and 32-channel slice of the
row, one product of 64 channels x 256 pixels x 32 input channels, the pixel operand's
start moved by (kh * pitch + kw) rows in halo mode. The epilogue keeps GEMM column m
when m // pitch < rows and m % pitch < cols and the pixel and channel lie in the output.

`conv_model` does the same steps with int32 tensors and Python integers, from the
integers the kernel's launch receives (`cuda_int8.Int8Plan.kernel_fields`, which the C
host copies into its Params and derives nothing from), so the CPU tests can hold the
kernel's address arithmetic bit-equal to `accumulate_plain` and check that every output
pixel and channel is written exactly once. It is never on the main path.

`SEAMS` lists the shapes that strain the tiles; the CPU tests run them through the
model, the card tests and chip_smoke.py through the kernel. `named_cases` joins them
with other shape lists and refuses a name or a shape given twice.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ssd_object_detection_tpu_torch.ops import cuda_int8
from ssd_object_detection_tpu_torch.ops.cuda_int8 import CHUNK, N_BLOCK, TILE_M

# (name, B, H, W, IC, OC, kernel, stride, padding)
SEAMS = (
    ("halo_overhangs_every_side", 1, 6, 7, 32, 64, 3, 1, "SAME"),  # one tile, box past all 4 edges
    ("rows_pitch_ragged", 2, 19, 23, 64, 64, 3, 1, "SAME"),  # R, P divide neither H nor W
    ("oc72_ic48", 2, 9, 10, 48, 72, 3, 1, "SAME"),  # IC off the chunk, OC off the N-block
    ("oc200_ic40", 1, 12, 12, 40, 200, 3, 1, "SAME"),  # OC off 64 and 256, a padded K chunk
    ("ic3_stride2", 1, 7, 9, 3, 5, 3, 2, "SAME"),  # 3 channels of a 32-byte row, tap mode
    ("stride2_even", 2, 16, 16, 64, 64, 3, 2, "SAME"),  # pads (0, 1)
    ("stride2_odd_ic96", 1, 19, 17, 96, 128, 3, 2, "SAME"),  # pads (1, 1) and (0, 1)
    ("stride2_1x1", 2, 9, 8, 128, 64, 1, 2, "SAME"),  # a 1x1 conv in tap mode
    ("pointwise_flat", 2, 9, 11, 128, 136, 1, 1, "SAME"),  # 198 pixels in one row
    ("valid_5_to_3", 2, 5, 5, 128, 256, 3, 1, "VALID"),
    ("valid_3_to_1_c64", 3, 3, 3, 64, 64, 3, 1, "VALID"),
    # 336 tiles on 132 SMs: three rounds, the last partly empty; 6 chunks a tile against a
    # ring of 5 stages, so the two consumer warpgroups' turns order the ring
    ("pingpong_last_round_partial", 12, 38, 38, 192, 256, 3, 1, "SAME"),
    ("batch1_wide_row", 1, 4, 300, 32, 64, 3, 1, "SAME"),  # rows wider than a tile
)


def named_cases(*groups) -> Dict[str, Tuple]:
    """{name: (B, H, W, IC, OC, kernel, stride, padding)} of (name, ...) tuples from
    `groups`; a name or a shape given twice is an error, so no case replaces another."""
    cases: Dict[str, Tuple] = {}
    for name, *case in (c for group in groups for c in group):
        if name in cases:
            raise ValueError(f"two shapes are named {name!r}")
        if tuple(case) in cases.values():
            raise ValueError(f"{name!r} repeats the shape {tuple(case)}")
        cases[name] = tuple(case)
    return cases


def seam_args(name, b, h, w, ic, oc, k, s, padding) -> Tuple:
    """(x shape, w_q shape, stride, pads) of one SEAMS entry."""
    from ssd_object_detection_tpu_torch.models.vgg import same_padding

    pads = (0, 0, 0, 0) if padding == "VALID" else (*same_padding(h, k, s), *same_padding(w, k, s))
    return (b, h, w, ic), (oc, k, k, ic), (s, s), pads


def tile_coords(k: dict, t: int) -> Tuple[int, int, int, int]:
    """(N-block, image, first output row, first output column) of tile t, as the kernel
    decodes it from its launch's integers `k` (Int8Plan.kernel_fields): the N-block
    innermost, then the tile column, the tile row, the image."""
    nb, u = t % k["n_blocks"], t // k["n_blocks"]
    tw, u = u % k["tiles_w"], u // k["tiles_w"]
    th, b = u % k["tiles_h"], u // k["tiles_h"]
    return nb, b, th * k["R"], tw * k["cols"]


def cta_tiles(k: dict) -> List[List[Tuple[int, int]]]:
    """Per CTA of the persistent grid of `k`, its (tile, consumer warpgroup) in walking
    order."""
    return [[(t, i % 2) for i, t in enumerate(range(cta, k["num_tiles"], k["grid"]))]
            for cta in range(k["grid"])]


def tma_box(src: torch.Tensor, origin: Tuple[int, ...], extent: Tuple[int, ...],
            strides: Tuple[int, ...]) -> torch.Tensor:
    """What one TMA load lands: src's elements at origin[d] + j * strides[d] for
    j < ceil(extent[d] / strides[d]) in every dimension d (torch order, outermost first),
    zero where an index lies outside src."""
    index = []
    for size, o, e, s in zip(src.shape, origin, extent, strides):
        idx = o + s * torch.arange(-(-e // s))
        index.append((idx, (idx >= 0) & (idx < size)))
    grids = torch.meshgrid(*[i.clamp(0, size - 1) for (i, _), size in zip(index, src.shape)],
                           indexing="ij")
    inside = torch.ones(grids[0].shape, dtype=torch.bool)
    for d, (_, ok) in enumerate(index):
        inside &= ok.view([-1 if j == d else 1 for j in range(len(index))])
    return torch.where(inside, src[grids], torch.zeros((), dtype=src.dtype))


def conv_model(xq: torch.Tensor, w_q: torch.Tensor, stride: Tuple[int, int], pads,
               out_bytes: int = 4, sm_count: int = 132) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int32 accumulators (B, Ho, Wo, OC), how often each output element was written)
    of xq (B, H, W, ICp) as the quantize kernel leaves it and w_q (OC, KH, KW, IC), by
    the kernel's tile walk on `sm_count` SMs, from the integers its launch receives."""
    batch, h, w, icp = xq.shape
    oc, kh, kw, ic = w_q.shape
    plan = cuda_int8.plan_int8(batch, h, w, ic, oc, (kh, kw), tuple(stride), tuple(pads),
                               out_bytes)
    k = plan.kernel_fields(sm_count)
    if icp != k["ICp"]:
        raise ValueError(f"xq has {icp} channels, the kernel's pitch for IC={ic} is {k['ICp']}")
    row, pitch, units = k["row"], k["P"], k["row"] // 16
    xv = xq.reshape(k["B"], k["H"], k["W"], k["ICp"]).to(torch.int32)  # the x map
    # the packed weights as the kernel addresses them: a flat array of `row`-byte rows
    wpack = cuda_int8.kernel_weights(w_q, row).to(torch.int32).reshape(-1, row)
    # wgmma reads logical unit u of weight row n from unit u ^ swizzle(n)
    unswizzle = (torch.arange(units)[None, :]
                 ^ cuda_int8.swizzle_units(torch.arange(N_BLOCK), row)[:, None])
    out = torch.zeros(k["B"], k["Ho"], k["Wo"], k["OC"], dtype=torch.int32)
    cover = torch.zeros_like(out)
    m = torch.arange(TILE_M)
    r, c = m // pitch, m % pitch

    for tiles in cta_tiles(k):
        for t, _consumer in tiles:
            nb, b, h0, w0 = tile_coords(k, t)
            wsrc = nb * k["chunks"] * k["taps"] * N_BLOCK  # in rows
            acc = torch.zeros(N_BLOCK, TILE_M, dtype=torch.int32)  # D^T: channels x pixels
            for step in range(k["k_steps"]):
                chunk = step // k["k_taps"]
                tap = step - chunk * k["k_taps"]  # 0 in halo mode: the stage holds all taps
                ky, kx = tap // k["KW"], tap % k["KW"]
                box = tma_box(xv, (b, h0 * k["SH"] - k["PT"] + ky, w0 * k["SW"] - k["PL"] + kx,
                                   chunk * row),
                              (1, k["box_rows"] * k["SH"], pitch * k["SW"], row),
                              (1, k["SH"], k["SW"], 1))
                halo = torch.zeros(k["halo_pixels"], row, dtype=torch.int32)  # slack is zero
                halo[:k["box_pixels"]] = box.reshape(-1, row)
                first = wsrc + (chunk * k["taps"] + tap) * N_BLOCK  # the bulk copy
                stage_w = wpack[first:first + k["taps_per_stage"] * N_BLOCK]
                stage_w = stage_w.reshape(-1, N_BLOCK, units, 16)
                wts = torch.gather(stage_w, 2, unswizzle.view(1, N_BLOCK, units, 1).expand_as(stage_w))
                wts = wts.reshape(-1, N_BLOCK, row)
                for s in range(k["taps_per_stage"]):
                    shift = k["shift"][s]
                    for q in range(0, row, CHUNK):  # the K slices of a row
                        acc += wts[s, :, q:q + CHUNK] @ halo[shift:shift + TILE_M, q:q + CHUNK].T
            keep = (r < k["R"]) & (c < k["cols"]) & (h0 + r < k["Ho"]) & (w0 + c < k["Wo"])
            n0 = nb * N_BLOCK
            n = min(N_BLOCK, k["OC"] - n0)
            rr, cc = h0 + r[keep], w0 + c[keep]
            out[b, rr, cc, n0:n0 + n] = acc[:n, keep].T
            cover[b, rr, cc, n0:n0 + n] += 1
    shape = (batch, *cuda_int8.out_shape(h, w, (kh, kw), stride, pads), oc)
    return out.reshape(shape), cover.reshape(shape)


def quantized_input(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """What the quantize kernel writes: quantize_plain's int8 values, zero channels up
    to padded_channels(IC)."""
    xq = cuda_int8.quantize_plain(x, x_scale)
    return F.pad(xq, (0, cuda_int8.padded_channels(x.shape[-1]) - x.shape[-1]))
