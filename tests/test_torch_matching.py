"""Port matcher against JAX `match_anchors` and the Pallas kernel (interpret mode).

Integer outputs (gt_index, cls, mask) must be bit-equal; `box` and the encoded loc of
`build_targets` agree to 1e-6 (the box is a copy of the GT, so it is in fact exact).
The cases are those of tests/test_pallas_matcher.py."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_object_detection_tpu.ops.matching import build_targets as jax_build_targets
from ssd_object_detection_tpu.ops.matching import match_anchors as jax_match_anchors
from ssd_object_detection_tpu.ops.pallas_matcher import match_anchors_pallas
from ssd_object_detection_tpu_torch.ops import cuda_matcher
from ssd_object_detection_tpu_torch.ops.matching import build_targets, match_anchors

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_case(seed, batch=3, n_gt=6, n_anchor=40, valid_p=0.7):
    rng = np.random.default_rng(seed)
    anchors = np.concatenate(
        [rng.uniform(0, 1, (n_anchor, 2)), rng.uniform(0.05, 0.5, (n_anchor, 2))], -1
    ).astype(np.float32)
    gt_boxes = np.concatenate(
        [rng.uniform(0, 1, (batch, n_gt, 2)), rng.uniform(0.05, 0.5, (batch, n_gt, 2))], -1
    ).astype(np.float32)
    gt_cls = rng.integers(0, 80, (batch, n_gt)).astype(np.int32)
    gt_valid = rng.uniform(size=(batch, n_gt)) < valid_p
    gt_valid[:, 0] = True
    return gt_cls, gt_boxes, gt_valid, anchors


def _large_case():
    """12,700 anchors at G=100, ~12% valid (the Pallas kernel's chunked-pass case)."""
    rng = np.random.default_rng(7)
    num_anchors, max_gt, batch = 12700, 100, 2
    anchors = np.concatenate(
        [rng.uniform(0.05, 0.95, (num_anchors, 2)), rng.uniform(0.03, 0.4, (num_anchors, 2))], -1
    ).astype(np.float32)
    gt_boxes = np.concatenate(
        [rng.uniform(0.2, 0.8, (batch, max_gt, 2)), rng.uniform(0.05, 0.4, (batch, max_gt, 2))], -1
    ).astype(np.float32)
    gt_cls = rng.integers(0, 80, (batch, max_gt)).astype(np.int32)
    gt_valid = rng.uniform(size=(batch, max_gt)) < 0.12
    return gt_cls, gt_boxes, gt_valid, anchors


def _golden_case():
    """Reference tests/utils/test_bbox.py golden bipartite case."""
    anchors = np.float32([[10, 10, 1, 1], [20, 20, 1.1, 1.1], [20, 20, 0.5, 0.5]])
    gt_boxes = np.float32([[[15, 15, 13, 13], [15, 15, 14, 14]]])
    return np.int32([[0, 1]]), gt_boxes, np.ones((1, 2), bool), anchors


def _zero_valid_case():
    anchors = np.float32([[0.5, 0.5, 0.2, 0.2], [0.2, 0.2, 0.1, 0.1]])
    return np.zeros((2, 3), np.int32), np.zeros((2, 3, 4), np.float32), np.zeros((2, 3), bool), anchors


def _nonaligned_case():
    gt_cls, gt_boxes, gt_valid, _ = _random_case(9, batch=2, n_gt=4)
    rng = np.random.default_rng(9)
    anchors = np.concatenate(
        [rng.uniform(0, 1, (130, 2)), rng.uniform(0.05, 0.5, (130, 2))], -1
    ).astype(np.float32)
    return gt_cls, gt_boxes, gt_valid, anchors


CASES = {
    **{f"seed{s}": (lambda s=s: _random_case(s)) for s in range(5)},
    "golden": _golden_case,
    "zero_valid": _zero_valid_case,
    "anchors130": _nonaligned_case,
    "anchors12700_g100": _large_case,
}


def _port(case):
    gt_cls, gt_boxes, gt_valid, anchors = case
    return match_anchors(
        torch.from_numpy(gt_cls), torch.from_numpy(gt_boxes), torch.from_numpy(gt_valid),
        torch.from_numpy(anchors),
    )


def _assert_same(got, want):
    np.testing.assert_array_equal(got.gt_index.numpy(), np.asarray(want.gt_index))
    np.testing.assert_array_equal(got.cls.numpy(), np.asarray(want.cls))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.box.numpy(), np.asarray(want.box), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matcher_equals_jax_match_anchors(name):
    case = CASES[name]()
    gt_cls, gt_boxes, gt_valid, anchors = (jnp.asarray(x) for x in case)
    want = jax.vmap(lambda c, b, v: jax_match_anchors(c, b, v, anchors))(gt_cls, gt_boxes, gt_valid)
    _assert_same(_port(case), want)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matcher_equals_pallas_interpret(name):
    case = CASES[name]()
    want = match_anchors_pallas(*(jnp.asarray(x) for x in case), interpret=True)
    _assert_same(_port(case), want)


def test_golden_assignment():
    res = _port(_golden_case())
    np.testing.assert_array_equal(res.box[0].numpy(), [[15, 15, 14, 14], [15, 15, 13, 13], [0, 0, 0, 0]])
    np.testing.assert_array_equal(res.cls[0].numpy(), [1, 0, 0])
    assert not _port(_zero_valid_case()).mask.any()


@pytest.mark.parametrize("variances", [None, (0.1, 0.2)])
def test_build_targets_equals_jax(variances):
    gt_cls, gt_boxes, gt_valid, anchors = _random_case(3, batch=4, n_gt=8, n_anchor=64)
    want = jax_build_targets(
        jnp.asarray(gt_cls), jnp.asarray(gt_boxes), jnp.asarray(gt_valid), jnp.asarray(anchors),
        variances=variances,
    )
    got = build_targets(
        torch.from_numpy(gt_cls), torch.from_numpy(gt_boxes), torch.from_numpy(gt_valid),
        torch.from_numpy(anchors), variances=variances,
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_cpu_tensors_dispatch_to_plain_matcher():
    case = _random_case(4)
    tensors = [torch.from_numpy(x) for x in case]
    before = cuda_matcher.match_anchors_cuda.launches
    got = cuda_matcher.match_anchors_cuda(*tensors)
    assert cuda_matcher.match_anchors_cuda.launches == before  # no kernel ran
    want = match_anchors(*tensors)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_matcher_imports_without_nvcc_or_triton():
    """Importing the wrapper builds nothing: no nvcc on PATH, triton blocked."""
    code = (
        "import sys; sys.modules['triton'] = None\n"
        "import ssd_object_detection_tpu_torch.ops.cuda_matcher as m\n"
        "import ssd_object_detection_tpu_torch.ops.matching\n"
        "from ssd_object_detection_tpu_torch.ops import _cuda_build\n"
        "assert not _cuda_build._loaded and m.match_anchors_cuda.launches == 0\n"
    )
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_wrapper_refuses_other_devices():
    """Only CPU (plain matcher) and CUDA (kernel) tensors have a route."""
    t = [torch.from_numpy(x).to("meta") for x in _random_case(0)]
    with pytest.raises(ValueError, match="no matcher for device meta"):
        cuda_matcher.match_anchors_cuda(*t)
