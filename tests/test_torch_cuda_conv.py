"""The CUDA fused conv3x3 kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU and skip elsewhere. The file imports no JAX, so the
machine with the card (which has none) runs it as
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_conv.py`.

Tolerances: float32 atol 1e-5 of the output's scale (the kernel sums the 9*IC products
in another order than cuDNN with TF32 off); bf16 one bf16 ulp of the value beyond the
plain version's own rounding, plus that float32 order term (both sum in float32, then
round once to bf16).
"""

import pytest
import torch

from ssd_object_detection_tpu_torch.ops import cuda_conv
from ssd_object_detection_tpu_torch.ops.conv3x3 import conv3x3_bias_relu, conv3x3_plain


@pytest.fixture
def cuda_device():
    """The card; decided inside the fixture, never at import (xdist workers must
    collect identical tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, b, h, w, ic, oc, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, ic, generator=g).to(dtype)
    k = torch.randn(3, 3, ic, oc, generator=g) / (9 * ic) ** 0.5
    bias = torch.randn(oc, generator=g)
    return x.to(device), k.to(device), bias.to(device)


def assert_close_to_plain(got: torch.Tensor, want: torch.Tensor) -> None:
    """|got - want| <= 1e-5 of the output's scale, plus one ulp of the value in bf16."""
    got, want, low = got.float(), want.float(), got.dtype == torch.bfloat16
    tol = 1e-5 * max(want.abs().max().item(), 1.0)
    if low:
        tol = tol + torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    err = (got - want).abs()
    assert bool((err <= tol).all()), err.max().item()


SHAPES = {
    "tile_remainders": (2, 12, 20, 8, 16),  # H, W not multiples of the float32 16x16 tile
    "channel_remainders": (2, 34, 18, 40, 72),  # IC, OC not multiples of 32 / 64
    "odd_channels": (1, 7, 9, 3, 5),  # IC, OC not multiples of 8: padded x, masked stores
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("relu,pool", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_kernel_matches_plain(cuda_device, shape, relu, pool, dtype):
    b, h, w, ic, oc = SHAPES[shape]
    if pool and (h % 2 or w % 2):
        h, w = h + h % 2, w + w % 2
    x, k, bias = _inputs(cuda_device, b, h, w, ic, oc, dtype)
    before = cuda_conv.conv3x3_forward_cuda.launches
    got = conv3x3_bias_relu(x, k, bias, relu, pool)
    assert cuda_conv.conv3x3_forward_cuda.launches == before + 1
    want = conv3x3_plain(x, k, bias, relu, pool)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype and got.is_contiguous()
    assert_close_to_plain(got, want)


# (B, H, W, IC, OC, relu, pool): the seams of the bf16 wgmma kernel's tiles
# (ops/cuda_conv.py::plan_conv), each against the plain version.
EDGES = {
    "rows_cols_ragged_pool": (2, 18, 64, 16, 64, True, True),  # H % 8, W % 30 != 0
    "rows_ragged_full_row": (2, 19, 65, 16, 64, True, False),  # pitch 67 x 3 rows, H % 3
    "cols_ragged_pitch32": (1, 10, 290, 16, 16, False, False),  # W % 30 != 0
    "m_rounded_up": (1, 9, 40, 16, 64, True, False),  # 6 x 42 = 252 tile pixels of 256
    "ic40": (2, 20, 24, 40, 64, True, True),  # off the 16-channel chunk
    "ic72": (2, 20, 24, 72, 128, True, False),
    "oc72": (2, 16, 30, 64, 72, True, True),  # off the 64-channel N-block
    "oc200": (2, 16, 30, 64, 200, True, False),
    "batch3": (3, 17, 33, 32, 64, False, False),  # no tile may cross images
    "block1_b1": (1, 300, 300, 64, 64, True, True),
    "block2_b1": (1, 150, 150, 128, 128, True, True),
    "block3_b1": (1, 75, 75, 256, 256, True, False),
    "ic512_streamed64": (1, 10, 20, 512, 64, True, False),  # one tile of 32 chunks
    # 352 tiles of 32 chunks through a 5-stage ring, two or three per CTA: the consumer
    # warpgroups' turns keep each ring wait on the right phase
    "ic512_pingpong": (8, 64, 64, 512, 128, True, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("edge", list(EDGES))
def test_bf16_kernel_edges_match_plain(cuda_device, edge):
    b, h, w, ic, oc, relu, pool = EDGES[edge]
    x, k, bias = _inputs(cuda_device, b, h, w, ic, oc, torch.bfloat16, seed=2)
    before = cuda_conv.conv3x3_forward_cuda.launches
    got = conv3x3_bias_relu(x, k, bias, relu, pool)
    assert cuda_conv.conv3x3_forward_cuda.launches == before + 1
    want = conv3x3_plain(x, k, bias, relu, pool)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert_close_to_plain(got, want)


@pytest.mark.cuda
def test_bf16_kernel_takes_a_misaligned_base(cuda_device):
    """x at an odd bf16 offset: the wrapper copies it to an aligned base (the tensor
    map needs one); the result equals that of the aligned tensor."""
    x, k, bias = _inputs(cuda_device, 1, 8, 12, 16, 32, torch.bfloat16, seed=3)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0
    torch.testing.assert_close(conv3x3_bias_relu(shifted, k, bias, True, False),
                               conv3x3_bias_relu(x, k, bias, True, False), rtol=0, atol=0)


@pytest.mark.cuda
def test_backward_matches_plain_autograd(cuda_device):
    x, k, bias = _inputs(cuda_device, 2, 8, 12, 16, 8, torch.float32, seed=1)
    leaves = [t.clone().requires_grad_() for t in (x, k, bias)]
    ref = [t.clone().requires_grad_() for t in (x, k, bias)]
    (conv3x3_bias_relu(*leaves, True, True) ** 2).sum().backward()
    (conv3x3_plain(*ref, True, True) ** 2).sum().backward()
    for a, r in zip(leaves, ref):
        torch.testing.assert_close(a.grad, r.grad, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    x, k, bias = _inputs(cuda_device, 1, 8, 8, 8, 8, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_conv.conv3x3_forward_cuda(x.half(), k, bias)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_conv.conv3x3_forward_cuda(x.transpose(1, 2), k, bias)
    with pytest.raises(ValueError, match="even"):
        cuda_conv.conv3x3_forward_cuda(x[:, :7].contiguous(), k, bias, pool=True)
    with pytest.raises(ValueError, match="must be on"):
        cuda_conv.conv3x3_forward_cuda(x, k.cpu(), bias)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """Runs anywhere: a kernel that cannot be built raises; nothing falls back."""
    from ssd_object_detection_tpu_torch.ops import _cuda_build

    source = tmp_path / "probe.cu"
    source.write_text("// not built\n")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_build.build(source, _cuda_build.BASE_FLAGS)
    assert not _cuda_build.library_path(source, _cuda_build.BASE_FLAGS).exists()
    assert (_cuda_build.library_path(source, _cuda_build.BASE_FLAGS)
            != _cuda_build.library_path(source, _cuda_build.BASE_FLAGS + ("-fmad=false",)))
