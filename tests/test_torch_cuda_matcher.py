"""The CUDA matcher kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU and skip elsewhere. The file imports no JAX, so the
machine with the card (which has none) runs it as
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_matcher.py`.
"""

import numpy as np
import pytest
import torch

from ssd_object_detection_tpu_torch.ops import cuda_matcher
from ssd_object_detection_tpu_torch.ops.anchors import SSD512_SPEC, generate_anchors
from ssd_object_detection_tpu_torch.ops.matching import match_anchors


@pytest.fixture
def cuda_device():
    """The card; decided inside the fixture, never at import (xdist workers must
    collect identical tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, batch, max_gt, anchors, valid_p):
    rng = np.random.default_rng(seed)
    boxes = np.concatenate(
        [rng.uniform(0, 1, (batch, max_gt, 2)), rng.uniform(0.02, 0.6, (batch, max_gt, 2))], -1
    ).astype(np.float32)
    boxes[0, max_gt // 2:] = boxes[0, : max_gt - max_gt // 2]  # duplicated GTs tie
    cls = rng.integers(0, 80, (batch, max_gt)).astype(np.int32)
    valid = rng.uniform(size=(batch, max_gt)) < valid_p
    valid[-1] = False  # an image with no valid GT
    return cls, boxes, valid, anchors


CASES = {
    "golden": (np.int32([[0, 1]]), np.float32([[[15, 15, 13, 13], [15, 15, 14, 14]]]),
               np.ones((1, 2), bool),
               np.float32([[10, 10, 1, 1], [20, 20, 1.1, 1.1], [20, 20, 0.5, 0.5]])),
    "more_gts_than_anchors": _case(1, 2, 12, generate_anchors()[:5], 1.0),
    "ssd300_b32_g100": _case(2, 32, 100, generate_anchors(), 0.5),
    "ssd512_b4_g100": _case(3, 4, 100, generate_anchors(SSD512_SPEC), 0.2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_bit_equal_to_plain(cuda_device, name):
    args = [torch.from_numpy(x).to(cuda_device) for x in CASES[name]]
    before = cuda_matcher.match_anchors_cuda.launches
    got = cuda_matcher.match_anchors_cuda(*args)
    assert cuda_matcher.match_anchors_cuda.launches == before + 1
    want = match_anchors(*args)
    torch.cuda.synchronize()
    for field, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), field


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    cls, boxes, valid, anchors = (torch.from_numpy(x).to(cuda_device) for x in CASES["golden"])
    with pytest.raises(TypeError, match="int32"):
        cuda_matcher.match_anchors_cuda(cls.long(), boxes, valid, anchors)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_matcher.match_anchors_cuda(cls, boxes, valid, anchors.t().contiguous().t())
    with pytest.raises(ValueError, match="is on cpu"):
        cuda_matcher.match_anchors_cuda(cls.cpu(), boxes, valid, anchors)
