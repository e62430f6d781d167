"""Port geometry (anchors, boxes) against the JAX package on identical numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_object_detection_tpu.ops import anchors as jax_anchors
from ssd_object_detection_tpu.ops import boxes as jax_boxes
from ssd_object_detection_tpu_torch.ops import anchors as port_anchors
from ssd_object_detection_tpu_torch.ops import boxes as port_boxes

torch.set_num_threads(1)

# rtol 1e-6: the same float32 operations in the same order; only libm's log/exp may
# differ by an ulp between XLA and PyTorch.
RTOL = 1e-6


def _boxes(rng, shape):
    return np.concatenate(
        [rng.uniform(0, 1, shape + (2,)), rng.uniform(0.02, 0.6, shape + (2,))], -1
    ).astype(np.float32)


@pytest.mark.parametrize("name", ["SSD300_SPEC", "SSD512_SPEC"])
def test_anchors_equal(name):
    want = jax_anchors.generate_anchors(getattr(jax_anchors, name))
    got = port_anchors.generate_anchors(getattr(port_anchors, name))
    assert got.shape == want.shape == (getattr(port_anchors, name).num_anchors, 4)
    np.testing.assert_array_equal(got, want)  # the copy is verbatim numpy: exact


@pytest.mark.parametrize("legacy", [False, True])
def test_iou_pair_and_pairwise(legacy):
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, (3, 7)), _boxes(rng, (3, 7))
    np.testing.assert_allclose(
        port_boxes.iou_pair(torch.from_numpy(a), torch.from_numpy(b), legacy_clamp=legacy).numpy(),
        np.asarray(jax_boxes.iou_pair(jnp.asarray(a), jnp.asarray(b), legacy_clamp=legacy)),
        rtol=RTOL,
    )
    gt, anc = _boxes(rng, (2, 5)), _boxes(rng, (40,))
    np.testing.assert_allclose(
        port_boxes.pairwise_iou(torch.from_numpy(gt), torch.from_numpy(anc), legacy_clamp=legacy).numpy(),
        np.asarray(jax_boxes.pairwise_iou(jnp.asarray(gt), jnp.asarray(anc[None]), legacy_clamp=legacy)),
        rtol=RTOL,
    )


@pytest.mark.parametrize("variances", [None, (0.1, 0.2)])
def test_encode_decode(variances):
    rng = np.random.default_rng(1)
    gt, anc = _boxes(rng, (2, 30)), _boxes(rng, (30,))
    enc = port_boxes.encode_boxes(torch.from_numpy(gt), torch.from_numpy(anc)[None], variances)
    want = jax_boxes.encode_boxes(jnp.asarray(gt), jnp.asarray(anc)[None], variances)
    np.testing.assert_allclose(enc.numpy(), np.asarray(want), rtol=RTOL, atol=1e-7)
    pred = rng.normal(size=(2, 30, 4)).astype(np.float32) * 0.5
    dec = port_boxes.decode_boxes(torch.from_numpy(pred), torch.from_numpy(anc)[None], variances, 300.0)
    want = jax_boxes.decode_boxes(jnp.asarray(pred), jnp.asarray(anc)[None], variances, 300.0)
    np.testing.assert_allclose(dec.numpy(), np.asarray(want), rtol=RTOL)
    # round trip
    back = port_boxes.decode_boxes(enc, torch.from_numpy(anc)[None], variances)
    np.testing.assert_allclose(back.numpy(), gt, rtol=1e-5, atol=1e-6)


def test_format_converters():
    rng = np.random.default_rng(2)
    b = _boxes(rng, (4, 6))
    t = torch.from_numpy(b)
    for name in ("cxcywh_to_xyxy", "xyxy_to_cxcywh", "xywh_to_cxcywh"):
        np.testing.assert_allclose(
            getattr(port_boxes, name)(t).numpy(),
            np.asarray(getattr(jax_boxes, name)(jnp.asarray(b))),
            rtol=RTOL,
        )
