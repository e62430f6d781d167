"""The int8 conv kernel's tile plan and the plain model of its tile walk, on the CPU.

The kernel itself (csrc/int8_conv.cu) runs only on the card (tests/test_torch_cuda_int8.py).
What the CPU can hold: the model of its address arithmetic (ops/int8_conv_model.py: the
planner's tiles, TMA boxes with their zero fill and element strides, the start-address
shift per tap, the persistent tile order) is bit-equal to the plain int32 accumulators
at every seam shape and writes each output pixel and channel exactly once; every plan,
at the seams and at SSD300-VGG16's 17 int8 convs, fits shared memory and the TMA box
limits; the weight operand needs no re-layout where IC % 32 == 0 and is padded once
otherwise. Tolerance: none, the sums are integers.
"""

import re

import pytest
import torch
import torch.nn.functional as F

from ssd_object_detection_tpu_torch.ops import cuda_int8
from ssd_object_detection_tpu_torch.ops.cuda_int8 import (
    ALIGN, CHUNK, MAX_BOX, MAX_STAGES, N_BLOCK, SMEM_LIMIT, TILE_M, plan_int8,
)
from ssd_object_detection_tpu_torch.ops.int8_conv_model import (
    SEAMS, conv_model, cta_tiles, named_cases, quantized_input, seam_args, tile_coords,
    tma_box,
)

torch.set_num_threads(1)

# SSD300-VGG16's int8 convs at batch 32 (ops/quant.py::discover_eligible, min_in_ch 128):
# (name, B, H, W, IC, OC, kernel, stride, padding)
SSD300 = (
    ("block2_conv2", 32, 150, 150, 128, 128, 3, 1, "SAME"),
    ("block3_conv1", 32, 75, 75, 128, 256, 3, 1, "SAME"),
    ("block3_conv2", 32, 75, 75, 256, 256, 3, 1, "SAME"),
    ("block3_conv3", 32, 75, 75, 256, 256, 3, 1, "SAME"),
    ("extra0_conv0", 32, 38, 38, 256, 512, 3, 1, "SAME"),
    ("extra0_conv1", 32, 38, 38, 512, 512, 3, 1, "SAME"),
    ("extra0_conv2", 32, 38, 38, 512, 512, 1, 1, "SAME"),
    ("extra1_conv0", 32, 38, 38, 512, 1024, 3, 2, "SAME"),
    ("extra1_conv1", 32, 19, 19, 1024, 1024, 1, 1, "SAME"),
    ("extra2_conv0", 32, 19, 19, 1024, 256, 1, 1, "SAME"),
    ("extra2_conv1", 32, 19, 19, 256, 512, 3, 2, "SAME"),
    ("extra3_conv0", 32, 10, 10, 512, 128, 1, 1, "SAME"),
    ("extra3_conv1", 32, 10, 10, 128, 256, 3, 2, "SAME"),
    ("extra4_conv0", 32, 5, 5, 256, 128, 1, 1, "SAME"),
    ("extra4_conv1", 32, 5, 5, 128, 256, 3, 1, "VALID"),
    ("extra5_conv0", 32, 3, 3, 256, 128, 1, 1, "SAME"),
    ("extra5_conv1", 32, 3, 3, 128, 256, 3, 1, "VALID"),
)
ALL = {case[0]: case for case in SSD300 + SEAMS}
assert len(ALL) == len(SSD300) + len(SEAMS)  # no case replaces another


def _plan(case, out_bytes=2):
    x_shape, w_shape, stride, pads = seam_args(*case)
    return plan_int8(*x_shape, w_shape[0], w_shape[1:3], stride, pads, out_bytes)


def _inputs(case, seed=0):
    x_shape, w_shape, stride, pads = seam_args(*case)
    g = torch.Generator().manual_seed(seed)
    xq = torch.randint(-127, 128, x_shape, generator=g, dtype=torch.int8)
    w_q = torch.randint(-127, 128, w_shape, generator=g, dtype=torch.int8)
    return xq, w_q, stride, pads


@pytest.mark.parametrize("name", [s[0] for s in SEAMS])
def test_model_bit_equal_to_plain_at_the_seams(name):
    xq, w_q, stride, pads = _inputs(ALL[name])
    padded = F.pad(xq, (0, cuda_int8.padded_channels(xq.shape[-1]) - xq.shape[-1]))
    got, cover = conv_model(padded, w_q, stride, pads)
    assert torch.equal(got, cuda_int8.accumulate_plain(xq, w_q, stride, pads))
    assert bool((cover == 1).all())  # every output pixel and channel written exactly once


@pytest.mark.parametrize("sm_count", [1, 3, 5])
@pytest.mark.parametrize("name", ["rows_pitch_ragged", "stride2_odd_ic96", "pointwise_flat"])
def test_model_on_few_sms(name, sm_count):
    """Grids of 1-5 persistent CTAs: many tiles a CTA, both consumer warpgroups, a last
    round partly empty."""
    xq, w_q, stride, pads = _inputs(ALL[name], seed=sm_count)
    padded = F.pad(xq, (0, cuda_int8.padded_channels(xq.shape[-1]) - xq.shape[-1]))
    got, cover = conv_model(padded, w_q, stride, pads, sm_count=sm_count)
    assert torch.equal(got, cuda_int8.accumulate_plain(xq, w_q, stride, pads))
    assert bool((cover == 1).all())


@pytest.mark.parametrize("out_bytes", [2, 4])
@pytest.mark.parametrize("name", list(ALL))
def test_plan_fits_the_kernel(name, out_bytes):
    plan = _plan(ALL[name], out_bytes)
    kh, kw = plan.kernel
    assert plan.rows * plan.pitch <= TILE_M and 1 <= plan.cols <= plan.pitch
    assert max(plan.box_extent) <= MAX_BOX and plan.box_rows <= MAX_BOX and plan.taps_per_stage <= MAX_BOX
    assert (plan.taps_per_stage, plan.row) in cuda_int8.STAGE_SHAPES
    assert plan.row in (32, 64, 128) and plan.chunks * plan.row >= cuda_int8.padded_channels(
        seam_args(*ALL[name])[0][3])
    assert (plan.halo_pixels * plan.row) % ALIGN == 0  # the weights start on a swizzle boundary
    assert plan.halo_pixels >= plan.box_rows * plan.pitch
    # the last tap of GEMM column 255 reads pixel 255 + shift: inside the halo buffer
    last_shift = ((plan.taps_per_stage - 1) // kw) * plan.pitch + (plan.taps_per_stage - 1) % kw
    assert TILE_M + last_shift <= plan.halo_pixels
    if plan.taps_per_stage > 1:  # halo mode: stride 1, all taps from one box
        assert plan.stride == (1, 1) and plan.taps_per_stage == kh * kw
        assert plan.box_rows == plan.rows + kh - 1 and plan.cols == plan.pitch - kw + 1
    else:
        assert plan.box_rows == plan.rows and plan.cols == plan.pitch
    assert 2 <= plan.stages <= MAX_STAGES and plan.smem_bytes <= SMEM_LIMIT
    staging = 2 * TILE_M * plan.staging_pitch * out_bytes  # one tile per consumer warpgroup
    stage = plan.row * plan.halo_pixels + plan.taps_per_stage * plan.row * N_BLOCK
    assert stage % ALIGN == 0 and staging % ALIGN == 0
    assert (plan.staging_pitch * out_bytes) % 16 == 0
    assert plan.smem_bytes == ALIGN + staging + plan.stages * stage + (2 * plan.stages + 2) * 8


@pytest.mark.parametrize("name", [s[0] for s in SSD300])
def test_plan_covers_every_output_once_at_ssd300(name):
    """The tile decode at batch 32: each (N-block, image, output pixel) in one tile."""
    k = _plan(ALL[name]).kernel_fields(132)
    b, ho, wo = k["B"], k["Ho"], k["Wo"]
    count = torch.zeros(k["n_blocks"], b, ho, wo, dtype=torch.int32)
    seen = []
    for tiles in cta_tiles(k):
        assert [wg for _, wg in tiles] == [i % 2 for i in range(len(tiles))]
        for t, _ in tiles:
            seen.append(t)
            nb, img, h0, w0 = tile_coords(k, t)
            assert h0 < ho and w0 < wo  # no tile lies wholly outside the output
            count[nb, img, h0:h0 + k["R"], w0:w0 + k["cols"]] += 1
    assert sorted(seen) == list(range(k["num_tiles"]))
    assert bool((count == 1).all())


def test_plan_modes_at_ssd300():
    """3x3 stride 1 in halo mode (9 taps a stage), 1x1 stride 1 on one flattened row,
    stride 2 in tap mode (boxes with element strides 2)."""
    block3 = _plan(ALL["block3_conv2"])
    assert block3.taps_per_stage == 9 and block3.view == (32, 75, 75)
    assert block3.num_tiles == 32 * 25 * 4  # 15 x 15 outputs a tile, 4 N-blocks
    pointwise = _plan(ALL["extra0_conv2"])
    assert pointwise.view == pointwise.out_view == (1, 1, 32 * 38 * 38)
    assert (pointwise.pitch, pointwise.rows) == (TILE_M, 1)
    strided = _plan(ALL["extra1_conv0"])
    assert strided.taps_per_stage == 1 and strided.k_steps == 512 // strided.row * 9
    assert strided.box_extent == (2 * strided.pitch, 2 * strided.rows)
    assert _plan(ALL["stride2_1x1"]).box_extent[0] == 2 * _plan(ALL["stride2_1x1"]).pitch


def test_tma_box_zero_fill_and_strides():
    src = torch.arange(2 * 5 * 6 * 32, dtype=torch.int32).reshape(2, 5, 6, 32)
    box = tma_box(src, (1, -1, 3, 16), (1, 4, 6, 16), (1, 2, 2, 1))
    assert tuple(box.shape) == (1, 2, 3, 16)
    for r, h in enumerate((-1, 1)):
        for c, w in enumerate((3, 5, 7)):
            want = src[1, h, w, 16:] if 0 <= h < 5 and 0 <= w < 6 else torch.zeros(16, dtype=torch.int32)
            assert torch.equal(box[0, r, c], want)


@pytest.mark.parametrize("row", [32, 64, 128])
@pytest.mark.parametrize("oc,k,ic", [(72, 3, 40), (64, 1, 256), (5, 3, 3)])
def test_pack_weights_layout(oc, k, ic, row):
    """Element [nb, chunk, tap, n, 16 * (u ^ swizzle(n)) + j] is w_q[64 nb + n, tap // k,
    tap % k, chunk * row + 16 u + j], zero past OC and IC."""
    g = torch.Generator().manual_seed(oc + ic + row)
    w_q = torch.randint(-127, 128, (oc, k, k, ic), generator=g, dtype=torch.int8)
    packed = cuda_int8.pack_weights(w_q, row)
    nb, chunks = -(-oc // N_BLOCK), -(-cuda_int8.padded_channels(ic) // row)
    assert tuple(packed.shape) == (nb, chunks, k * k, N_BLOCK, row) and packed.is_contiguous()
    dense = torch.zeros(nb * N_BLOCK, k * k, chunks * row, dtype=torch.int8)
    dense[:oc, :, :ic] = w_q.reshape(oc, k * k, ic)
    for n in range(N_BLOCK):
        swz = int(cuda_int8.swizzle_units(torch.tensor(n), row))
        for u in range(row // 16):
            got = packed[:, :, :, n, 16 * (u ^ swz):16 * (u ^ swz) + 16]
            want = dense.view(nb, N_BLOCK, k * k, chunks, row)[:, n, :, :, 16 * u:16 * u + 16]
            assert torch.equal(got, want.permute(0, 2, 1, 3))


def test_swizzle_units_is_the_address_swizzle():
    """Bits [7, 7 + log2(row / 16)) of a row's offset XOR its 16-byte unit index, the
    32/64/128-byte swizzles (CU_TENSOR_MAP_SWIZZLE_32B/64B/128B)."""
    for row, bits in ((32, 1), (64, 2), (128, 3)):
        for r in range(64):
            want = ((r * row) >> 7) & ((1 << bits) - 1)
            assert int(cuda_int8.swizzle_units(torch.tensor(r), row)) == want


def test_kernel_weights_packs_once_per_tensor():
    g = torch.Generator().manual_seed(0)
    w_q = torch.randint(-127, 128, (72, 3, 3, 40), generator=g, dtype=torch.int8)
    packed = cuda_int8.kernel_weights(w_q, 32)
    assert torch.equal(packed, cuda_int8.pack_weights(w_q, 32))
    assert cuda_int8.kernel_weights(w_q, 32) is packed  # made once, kept on the tensor
    assert cuda_int8.kernel_weights(w_q, 128) is not packed  # another row width
    assert cuda_int8.kernel_weights(w_q, 32) is packed
    w_q[0, 0, 0, 0] = 7  # an in-place change packs anew
    again = cuda_int8.kernel_weights(w_q, 32)
    assert again is not packed and torch.equal(again, cuda_int8.pack_weights(w_q, 32))


def test_plan_rows_at_ssd300():
    """3x3 halo mode keeps 32-byte rows (a stage of 64-byte rows fits only two deep);
    1x1 and stride-2 stages take 128-byte rows, three deep."""
    for name in ("block2_conv2", "block3_conv2", "extra0_conv1", "extra4_conv1"):
        assert _plan(ALL[name]).row == 32 and _plan(ALL[name]).stages == 5
    for name in ("extra0_conv2", "extra1_conv0", "extra1_conv1", "extra3_conv1"):
        assert _plan(ALL[name]).row == 128 and _plan(ALL[name]).stages == 3
    assert all(_plan(case, 4).stages >= 2 for case in SSD300)
    assert _plan(ALL["extra0_conv2"]).row == 128 and _plan(ALL["extra1_conv0"]).row == 128
    assert all(_plan(case).stages >= cuda_int8.MIN_STAGES for case in SSD300)


def test_quantized_input_pads_zero_channels():
    x = torch.randn(1, 3, 4, 40) * 3
    scale = torch.tensor(3.0 / 127)
    xq = quantized_input(x, scale)
    assert tuple(xq.shape) == (1, 3, 4, 64) and not bool(xq[..., 40:].any())
    assert torch.equal(xq[..., :40], cuda_int8.quantize_plain(x, scale))


def test_model_from_quantized_floats():
    """The model fed what the quantize kernel writes equals the whole plain int8 conv's
    accumulators: x float -> xq (zero channels past IC) -> tile walk."""
    case = ALL["oc200_ic40"]
    x_shape, w_shape, stride, pads = seam_args(*case)
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(x_shape, generator=g) * 3).to(torch.bfloat16)
    w_q = torch.randint(-127, 128, w_shape, generator=g, dtype=torch.int8)
    scale = torch.tensor(3.0 / 127)
    got, _ = conv_model(quantized_input(x, scale), w_q, stride, pads)
    want = cuda_int8.accumulate_plain(cuda_int8.quantize_plain(x, scale), w_q, stride, pads)
    assert torch.equal(got, want)


def test_kernel_fields_are_the_c_struct():
    """Int8Plan.kernel_ints fills csrc/int8_conv.cu's struct Plan field by field: the
    names and order of KERNEL_FIELDS are the struct's, and shift is MAX_TAPS ints."""
    source = (cuda_int8.SOURCE).read_text()
    body = re.search(r"struct Plan \{(.*?)\};", source, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = [re.sub(r"\[.*\]", "", n).strip() for decl in body.split(";") if decl.strip()
             for n in decl.strip().removeprefix("int ").split(",")]
    assert tuple(names) == cuda_int8.KERNEL_FIELDS
    assert f"kMaxTaps = {cuda_int8.MAX_TAPS};" in source
    for name in ("block3_conv2", "extra1_conv0", "ic3_stride2"):
        plan = _plan(ALL[name])
        fields = plan.kernel_fields(132)
        assert tuple(fields) == cuda_int8.KERNEL_FIELDS
        ints = plan.kernel_ints(132)
        assert len(ints) == len(cuda_int8.KERNEL_FIELDS) - 1 + cuda_int8.MAX_TAPS
        assert ints[cuda_int8.KERNEL_FIELDS.index("grid")] == min(132, plan.num_tiles)
        assert ints[-cuda_int8.MAX_TAPS:][:plan.taps_per_stage] == plan.shifts


def test_named_cases_refuse_repeats():
    assert list(named_cases(SEAMS)) == [s[0] for s in SEAMS]
    with pytest.raises(ValueError, match="named"):
        named_cases(SEAMS, (("stride2_even", 1, 2, 2, 32, 64, 1, 1, "SAME"),))
    with pytest.raises(ValueError, match="repeats"):
        named_cases(SEAMS, (("again", *SEAMS[0][1:]),))
