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
from ssd_object_detection_tpu_torch.ops.matcher_model import match_anchors_model, stress_cases
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


STRESS = stress_cases(generate_anchors(), generate_anchors(SSD512_SPEC))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STRESS))
def test_kernel_bit_equal_to_plain_on_stress_cases(cuda_device, name):
    """What strains the row cache and the cluster: conflicts at every step, more GTs
    than anchors, empty and ragged slices, every cluster size, a thresh below -1."""
    *arrays, thresh = STRESS[name]
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device) for x in arrays]
    got = cuda_matcher.match_anchors_cuda(*args, thresh)
    want = match_anchors(*args, thresh)
    torch.cuda.synchronize()
    for field, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), (field, int((g != w).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,cluster", [(1, 8), (16, 8), (17, 4), (33, 4), (34, 2), (66, 2),
                                           (67, 1), (140, 1)])
def test_every_cluster_size_launches_and_agrees(cuda_device, batch, cluster):
    """Batches on both sides of each cluster size's limit (8, 4, 2, 1 CTAs per image at
    20,001 anchors on 132 SMs): the plan's shape can be scheduled, and the result is the
    plain matcher's and the model's."""
    num_anchors = 20001
    cls, boxes, valid, anchors = _case(batch, batch, 20,
                                       generate_anchors(SSD512_SPEC)[:num_anchors], 0.4)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    launch = cuda_matcher.plan(batch, 20, num_anchors, sms)
    assert sms != 132 or launch.cluster == cluster
    assert cuda_matcher.max_active_clusters(launch, cuda_device) >= 1
    args = [torch.from_numpy(x).to(cuda_device) for x in (cls, boxes, valid, anchors)]
    got = cuda_matcher.match_anchors_cuda(*args)
    want = match_anchors(*args)
    model, _ = match_anchors_model(*(a.cpu() for a in args), cluster=launch.cluster)
    for field, g, w, m in zip(got._fields, got, want, model):
        assert torch.equal(g, w), field
        assert torch.equal(g.cpu(), m), field


@pytest.mark.cuda
def test_a_call_allocates_only_its_outputs(cuda_device):
    """No IoU or cache scratch: the peak above the inputs is the four outputs."""
    args = [torch.from_numpy(x).to(cuda_device) for x in CASES["ssd300_b32_g100"]]
    cuda_matcher.match_anchors_cuda(*args)  # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    got = cuda_matcher.match_anchors_cuda(*args)
    torch.cuda.synchronize()
    outputs = sum(t.numel() * t.element_size() for t in got)
    # the allocator rounds each of the four blocks up to 512 bytes
    assert torch.cuda.max_memory_allocated() - before <= outputs + 4 * 512


@pytest.mark.cuda
def test_empty_launch_of_the_plan_shape(cuda_device):
    launch = cuda_matcher.plan(32, 100, 8732)
    cuda_matcher.empty_launch(launch, cuda_device)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    cls, boxes, valid, anchors = (torch.from_numpy(x).to(cuda_device) for x in CASES["golden"])
    with pytest.raises(TypeError, match="int32"):
        cuda_matcher.match_anchors_cuda(cls.long(), boxes, valid, anchors)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_matcher.match_anchors_cuda(cls, boxes, valid, anchors.t().contiguous().t())
    with pytest.raises(ValueError, match="is on cpu"):
        cuda_matcher.match_anchors_cuda(cls.cpu(), boxes, valid, anchors)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_matcher.match_anchors_cuda(cls, boxes, valid, torch.cat([anchors, anchors]).flatten()[1:13].view(3, 4))
    with pytest.raises(ValueError, match="G >= 1"):
        cuda_matcher.match_anchors_cuda(cls[:, :0], boxes[:, :0], valid[:, :0], anchors)
    many = 6000  # more ground truths than any cluster's shared memory holds
    with pytest.raises(ValueError, match="bytes of shared memory"):
        cuda_matcher.match_anchors_cuda(
            torch.zeros((1, many), dtype=torch.int32, device=cuda_device),
            torch.zeros((1, many, 4), device=cuda_device),
            torch.zeros((1, many), dtype=torch.bool, device=cuda_device), anchors)
    # the C entry point itself refuses a plan that does not cover the columns
    lib = cuda_matcher._library()
    out = cuda_matcher.match_anchors_cuda(cls, boxes, valid, anchors)
    err = lib.ssd_match_anchors(
        boxes.data_ptr(), cls.data_ptr(), valid.data_ptr(), anchors.data_ptr(), 1, 2, 3, 0.5,
        out.gt_index.data_ptr(), out.cls.data_ptr(), out.box.data_ptr(), out.mask.data_ptr(),
        2, 128, 1, 4096, 0, torch.cuda.current_stream().cuda_stream)
    assert err != 0
