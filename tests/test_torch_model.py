"""Port SSD network against the flax one on identical weights (float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_object_detection_tpu.models.ssd import SSD as JaxSSD
from ssd_object_detection_tpu.models.ssd import SSD300_SPEC_MODEL as JAX_SSD300
from ssd_object_detection_tpu.models.ssd import ModelSpec as JaxModelSpec
from ssd_object_detection_tpu.models.vgg import VGG16Trunk as JaxVGG16Trunk
from ssd_object_detection_tpu.ops.anchors import AnchorSpec as JaxAnchorSpec
from ssd_object_detection_tpu_torch.models.convert import from_flax_params, to_flax_params
from ssd_object_detection_tpu_torch.models.ssd import SSD, SSD300_SPEC_MODEL, ModelSpec
from ssd_object_detection_tpu_torch.models.vgg import VGG16Trunk, same_padding
from ssd_object_detection_tpu_torch.ops.anchors import AnchorSpec

torch.set_num_threads(1)

# A tiny spec that hits every flax padding hazard: 44 -> trunk 11 (VALID pools) ->
# SAME max-pool on an ODD input (11 -> 6) -> stride-2 SAME conv on an EVEN input
# (6 -> 3, pads (0, 1)) -> VALID 3x3 (3 -> 1).
_TINY = dict(
    name="tiny-pad",
    blocks=(
        ((16, 3, 1, "SAME"), (16, 1, 1, "SAME")),
        ((24, 3, 2, "SAME"),),
        ((8, 1, 1, "SAME"), (16, 3, 1, "VALID")),
    ),
)
_TINY_ANCHORS = dict(
    image_size=44, feature_sizes=((6, 6), (3, 3), (1, 1)), scale_refs=(9, 18, 30, 42),
    aspect_ratios=((2,), (2, 3), (2,)),
)
PORT_TINY = ModelSpec(anchor_spec=AnchorSpec(**_TINY_ANCHORS), **_TINY)
JAX_TINY = JaxModelSpec(anchor_spec=JaxAnchorSpec(**_TINY_ANCHORS), **_TINY)
NUM_CLASSES = 5

# float32 forward: XLA's and oneDNN's convolutions sum in different orders, so values
# agree to rounding noise that grows with depth, not bit for bit.
RTOL, ATOL = 2e-4, 2e-5


def _port_model(spec, jax_params, num_classes, dtype=torch.float32):
    model = SSD(num_classes=num_classes, spec=spec, dtype=dtype)
    model.load_state_dict(from_flax_params(jax.tree.map(np.asarray, jax_params)))
    return model


def test_same_padding_matches_flax_hazards():
    assert same_padding(38, 3, 2) == (0, 1)  # extra1_conv0 38 -> 19
    assert same_padding(19, 3, 2) == (1, 1)  # extra2_conv1 19 -> 10
    assert same_padding(10, 3, 2) == (0, 1)  # extra3_conv1 10 -> 5
    assert same_padding(64, 3, 2, dilation=6) == (5, 6)  # SSD512 dilated extra1_conv0


def test_from_flax_params_round_trip():
    model = JaxSSD(num_classes=NUM_CLASSES, spec=JAX_TINY)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(1), jnp.zeros((1, 44, 44, 3))))
    state = from_flax_params(params)
    port = SSD(num_classes=NUM_CLASSES, spec=PORT_TINY)
    assert set(state) == set(port.state_dict())  # every layer name lines up
    port.load_state_dict(state)
    back = to_flax_params(port.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    assert state["vgg.block1_conv1.weight"].shape == (64, 3, 3, 3)  # HWIO -> OIHW


def test_tiny_forward_matches_flax():
    model = JaxSSD(num_classes=NUM_CLASSES, spec=JAX_TINY)
    params = model.init(jax.random.PRNGKey(2), jnp.zeros((1, 44, 44, 3)))
    x = np.random.default_rng(0).uniform(-1, 1, (2, 44, 44, 3)).astype(np.float32)
    want_loc, want_conf = model.apply(params, jnp.asarray(x))
    port = _port_model(PORT_TINY, params, NUM_CLASSES)
    with torch.no_grad():
        loc, conf = port(torch.from_numpy(x))
    assert loc.shape == want_loc.shape == (2, PORT_TINY.anchor_spec.num_anchors, 4)
    assert conf.dtype == loc.dtype == torch.float32
    np.testing.assert_allclose(loc.numpy(), np.asarray(want_loc), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(conf.numpy(), np.asarray(want_conf), rtol=RTOL, atol=ATOL)


def test_plain_stem_equals_jax_s2d_stem():
    """The port always runs the plain stem; JAX's space-to-depth stem is an exact
    rewrite of it, so the trunks agree to float32 conv rounding."""
    jax_trunk = JaxVGG16Trunk(s2d_stem=True)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    params = jax_trunk.init(jax.random.PRNGKey(3), jnp.asarray(x))
    want = np.asarray(jax_trunk.apply(params, jnp.asarray(x)))
    trunk = VGG16Trunk(s2d_stem=True)
    trunk.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = trunk(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 8, 8, 256)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_ssd300_batch1_forward_matches_flax():
    """Full SSD300 (real padding, all 8,732 anchors in order) on one image."""
    model = JaxSSD(num_classes=81, spec=JAX_SSD300)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 300, 300, 3)))
    x = np.random.default_rng(2).uniform(-1, 1, (1, 300, 300, 3)).astype(np.float32)
    want_loc, want_conf = jax.jit(model.apply)(params, jnp.asarray(x))
    port = _port_model(SSD300_SPEC_MODEL, params, 81)
    with torch.no_grad():
        loc, conf = port(torch.from_numpy(x))
    assert loc.shape == (1, 8732, 4) and conf.shape == (1, 8732, 81)
    np.testing.assert_allclose(loc.numpy(), np.asarray(want_loc), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(conf.numpy(), np.asarray(want_conf), rtol=RTOL, atol=ATOL)


def test_bf16_compute_keeps_f32_params_and_outputs():
    port = SSD(num_classes=NUM_CLASSES, spec=PORT_TINY, dtype=torch.bfloat16)
    port.init_weights(torch.Generator().manual_seed(0))
    loc, conf = port(torch.zeros(1, 44, 44, 3))
    assert loc.dtype == conf.dtype == torch.float32
    (loc.sum() + conf.sum()).backward()
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in port.parameters())
    low = SSD(num_classes=NUM_CLASSES, spec=PORT_TINY, dtype=torch.bfloat16, conf_f32=False)
    assert low(torch.zeros(1, 44, 44, 3))[1].dtype == torch.bfloat16


def test_other_trunks_raise():
    """The R34, MNV2 and micro trunks build (tests/test_torch_trunks.py); a trunk the JAX
    package does not have raises ValueError."""
    blocks = ((), ((8, 3, 2, "SAME"),), ((8, 3, 2, "SAME"),))
    for trunk in ("resnet34", "mobilenetv2", "micro"):
        SSD(spec=ModelSpec(name=trunk, anchor_spec=PORT_TINY.anchor_spec, blocks=blocks, trunk=trunk))
    spec = ModelSpec(name="r50", anchor_spec=PORT_TINY.anchor_spec, blocks=(), trunk="resnet50")
    with pytest.raises(ValueError, match="unknown trunk"):
        SSD(spec=spec)
