"""The pure-Python parts of the bf16 conv kernel's wrapper (ops/cuda_conv.py), on the CPU.

The kernel itself runs only on the card (tests/test_torch_cuda_conv.py); what it is
handed is checked here: the tile plan covers every output pixel of every image exactly
once, in the order the kernel walks its tiles, and fits shared memory; the weight
re-layout is undone by its inverse and is zero exactly where its docstring says.
"""

import itertools

import pytest
import torch

from ssd_object_detection_tpu_torch.ops.cuda_conv import (
    CHUNK, MAX_STAGES, N_BLOCK, SMEM_LIMIT, TILE_M, pack_weights, plan_conv,
)

torch.set_num_threads(1)

# (B, H, W, IC, OC, pool): the VGG trunk layers, ragged edges, tiny and wide images,
# channels off the chunk and the N-block
PLAN_CASES = [
    (2, 300, 300, 64, 64, True), (2, 150, 150, 128, 128, True), (2, 75, 75, 256, 256, False),
    (3, 19, 65, 40, 72, False), (2, 18, 64, 64, 200, True), (1, 10, 290, 16, 16, False),
    (1, 9, 40, 72, 64, False), (1, 7, 9, 3, 5, False), (2, 12, 20, 8, 16, True),
    (1, 2, 2, 8, 8, True), (1, 16, 16, 512, 64, False),
]


def _tiles(batch, h, w, oc, plan):
    """(nb, b, h0, w0) of every tile, decoded from the tile index as the kernel does."""
    tiles_h, tiles_w = plan.grid(h, w)
    n_blocks = -(-oc // N_BLOCK)
    for t in range(batch * tiles_h * tiles_w * n_blocks):
        nb, u = t % n_blocks, t // n_blocks
        tw, u = u % tiles_w, u // tiles_w
        th, b = u % tiles_h, u // tiles_h
        yield nb, b, th * plan.rows, tw * plan.cols


@pytest.mark.parametrize("batch,h,w,ic,oc,pool", PLAN_CASES)
def test_plan_covers_every_output_pixel_once(batch, h, w, ic, oc, pool):
    plan = plan_conv(h, w, pool)
    n_blocks = -(-oc // N_BLOCK)
    oh, ow, step = (h // 2, w // 2, 2) if pool else (h, w, 1)
    count = torch.zeros(n_blocks, batch, oh, ow, dtype=torch.int32)
    for nb, b, h0, w0 in _tiles(batch, h, w, oc, plan):
        assert b < batch and h0 < h and w0 < w  # no tile lies wholly outside an image
        if pool:
            assert h0 % 2 == 0 and w0 % 2 == 0
        count[nb, b, h0 // step:(h0 + plan.rows) // step, w0 // step:(w0 + plan.cols) // step] += 1
    assert bool((count == 1).all())


@pytest.mark.parametrize("batch,h,w,ic,oc,pool", PLAN_CASES)
def test_plan_fits_the_kernel(batch, h, w, ic, oc, pool):
    plan = plan_conv(h, w, pool)
    assert plan.rows * plan.pitch <= TILE_M and plan.cols >= 1
    assert plan.pitch <= 256 and plan.rows + 2 <= 256  # TMA box extents
    # tile pixels m < TILE_M read halo pixel m + 2P + 2 at tap (2, 2); the box fills
    # (R + 2) P pixels, the rest is zeroed slack; 8-pixel groups keep 128-byte alignment
    assert plan.halo_pixels >= TILE_M + 2 * plan.pitch + 2
    assert plan.halo_pixels >= (plan.rows + 2) * plan.pitch and plan.halo_pixels % 8 == 0
    assert 2 <= plan.stages and plan.smem_bytes <= SMEM_LIMIT
    # the kernel's layout: a staging tile per consumer warpgroup, the ring of stages (two
    # halo groups and a chunk's weights), full and empty barriers per stage, two turns
    staging = 2 * TILE_M * (N_BLOCK + 8) * 2
    stage = plan.halo_pixels * 32 + 9 * CHUNK * N_BLOCK * 2
    assert plan.smem_bytes == staging + plan.stages * stage + (2 * plan.stages + 2) * 8
    if pool:  # windows inside a tile
        assert plan.rows % 2 == 0 and plan.cols % 2 == 0


def test_plan_picks_full_rows_where_fewer_tiles():
    block3 = plan_conv(75, 75, False)
    assert (block3.pitch, block3.rows) == (77, 3)
    assert plan_conv(150, 150, True).pitch == 32
    assert plan_conv(10, 290, False).pitch == 32  # a full row exceeds 256 pixels


@pytest.mark.parametrize("h,w,pool,stages", [
    (300, 300, True, 5),  # block1: a deeper ring than its 4 chunks
    (150, 150, True, 5),  # block2: 8 chunks, so the warpgroups' turns keep the order
    (75, 75, False, 4),  # block3: 16 chunks, a longer halo per stage (pitch 77)
    (64, 64, False, 5),  # the ic512_pingpong seam case: 32 chunks
])
def test_plan_ring_depth(h, w, pool, stages):
    plan = plan_conv(h, w, pool)
    assert plan.stages == stages <= MAX_STAGES


def unpack_weights(packed: torch.Tensor, ic: int, oc: int) -> torch.Tensor:
    """The inverse of `pack_weights`: (NB, KC, 9, 8, 2, 8, 8) -> (3, 3, ic, oc)."""
    nb, kc, _, ng, _, _, _ = packed.shape
    w = packed.permute(2, 1, 4, 6, 0, 3, 5).reshape(3, 3, kc * CHUNK, nb * ng * 8)
    return w[:, :, :ic, :oc]


@pytest.mark.parametrize("ic,oc", [(16, 64), (40, 72), (3, 5), (72, 200)])
def test_pack_weights_inverse_and_padding(ic, oc):
    g = torch.Generator().manual_seed(ic * oc)
    kernel = torch.randn(3, 3, ic, oc, generator=g)
    packed = pack_weights(kernel)
    bn = N_BLOCK
    kc, nb = -(-ic // CHUNK), -(-oc // bn)
    assert tuple(packed.shape) == (nb, kc, 9, bn // 8, 2, 8, 8) and packed.is_contiguous()
    assert torch.equal(unpack_weights(packed, ic, oc), kernel)
    # element [nb, kc, tap, ng, kg, n, k] = kernel[tap // 3, tap % 3, ci, co], else 0
    for idx in itertools.product(*(range(s) for s in packed.shape)):
        blk, c, tap, ng, kg, n, k = idx
        ci, co = c * CHUNK + kg * 8 + k, blk * bn + ng * 8 + n
        want = kernel[tap // 3, tap % 3, ci, co] if ci < ic and co < oc else 0.0
        assert packed[idx] == want, idx
