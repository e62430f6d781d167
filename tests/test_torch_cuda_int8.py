"""The CUDA int8 conv kernels (csrc/int8_conv.cu) against their plain PyTorch version,
on the card.

These tests need an NVIDIA GPU and skip elsewhere. The file imports no JAX, so the
machine with the card runs it as
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_int8.py`.

Tolerances: none. The quantize step is bit-equal (IEEE division, round half to even),
the int32 accumulators are exact in any order, and the dequantize runs the plain
version's float32 operations in its order with no fused multiply-add.
"""

import pytest
import torch

from ssd_object_detection_tpu_torch.models.vgg import same_padding
from ssd_object_detection_tpu_torch.ops import cuda_int8


@pytest.fixture
def cuda_device():
    """The card; decided inside the fixture, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


SHAPES = {  # (B, H, W, IC, OC, kernel, stride, padding)
    "block3_conv2": (2, 75, 75, 256, 256, 3, 1, "SAME"),
    "ic_oc_off_the_tiles": (2, 17, 16, 40, 72, 3, 2, "SAME"),
    "odd_stride2": (1, 19, 19, 512, 256, 3, 2, "SAME"),
    "valid_3_to_1": (3, 3, 3, 256, 256, 3, 1, "VALID"),
    "pointwise_batch1": (1, 10, 10, 1024, 200, 1, 1, "SAME"),
    "ic3": (1, 7, 9, 3, 5, 3, 1, "SAME"),
}


def _case(device, b, h, w, ic, oc, k, s, padding, dtype, bias=True, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(b, h, w, ic, generator=g) * 3).to(dtype).to(device)
    w_q = torch.randint(-127, 128, (oc, k, k, ic), generator=g, dtype=torch.int8).to(device)
    w_scale = (torch.rand(oc, generator=g) * 0.01 + 1e-4).to(device)
    b_ = torch.randn(oc, generator=g).to(device) if bias else None
    x_scale = torch.tensor(3.0 / 127, device=device)
    pads = (0, 0, 0, 0) if padding == "VALID" else (*same_padding(h, k, s), *same_padding(w, k, s))
    return x, w_q, w_scale, b_, x_scale, (s, s), pads


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_kernels_match_plain(cuda_device, shape, dtype):
    x, w_q, w_scale, bias, x_scale, stride, pads = _case(cuda_device, *SHAPES[shape], dtype)
    ic = x.shape[-1]
    xq = cuda_int8.quantize_cuda(x, x_scale)
    want_xq = cuda_int8.quantize_plain(x, x_scale)
    assert torch.equal(xq[..., :ic], want_xq) and not bool(xq[..., ic:].any())
    acc = cuda_int8.conv_cuda(xq, cuda_int8.pack_weights(w_q), ic, stride, pads)
    want_acc = cuda_int8.accumulate_plain(want_xq, w_q, stride, pads)
    assert torch.equal(acc, want_acc)
    before = cuda_int8.int8_conv_cuda.launches
    got = torch.ops.ssd_torch.int8_conv(x, w_q, w_scale, bias, x_scale, *stride, *pads)
    torch.cuda.synchronize()
    assert cuda_int8.int8_conv_cuda.launches == before + 1
    assert torch.equal(got, cuda_int8.dequantize_plain(want_acc, x_scale, w_scale, bias, dtype))


@pytest.mark.cuda
def test_half_steps_round_to_even_on_the_card(cuda_device):
    x_scale = torch.tensor(2.0 ** -4, device=cuda_device)
    x = ((torch.arange(-140, 141, device=cuda_device) + 0.5) * x_scale).reshape(1, 1, -1, 1)
    x = x.expand(1, 1, -1, 64).contiguous()
    assert torch.equal(cuda_int8.quantize_cuda(x, x_scale), cuda_int8.quantize_plain(x, x_scale))


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x, w_q, w_scale, bias, x_scale, stride, pads = _case(cuda_device, *SHAPES["ic3"], torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_int8.quantize_cuda(x.permute(0, 2, 1, 3), x_scale)
    with pytest.raises(TypeError):
        cuda_int8.quantize_cuda(x.half(), x_scale)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_int8.int8_conv_cuda(x.cpu(), w_q, w_scale, bias, x_scale, stride, pads)
