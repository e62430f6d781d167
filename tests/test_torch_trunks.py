"""The ResNet-34, MobileNetV2 and micro trunks of the port against flax, on identical
weights carried by models/convert.py; the six full-width specs; a train step of each
family; remat; GroupNorm and depthwise weights in both directions and `.msgpack` files.

Tolerances:
  - float32: within 1e-5 of the output's scale (convolutions and GroupNorm statistics
    sum in another order than XLA; measured <= 4.3e-6 at these sizes);
  - bf16: the port's output lies no farther from flax's bf16 output than flax's bf16
    output lies from flax's float32 output, in relative L2 norm, and the port's bf16
    lies within 1.25x that distance of flax's float32 (measured at most 1.17x). Per layer the two agree to one
    bf16 ulp on a few % of values (the float32 sums round to bf16 on either side of a
    boundary); through 13-16 blocks those flips grow to the size of bf16 rounding
    itself, so the yardstick is the rounding of the same network in bf16;
  - a train step: loss within rel 1e-5; each clipped gradient of the pyramid and the
    heads within rtol 1e-4 plus 1e-4 of that tensor's largest entry (float32 forward and
    backward in another order); each trunk gradient within 1e-2 in relative L2 norm.
    The trunk's derivative jumps at every ReLU / ReLU6 kink, and its activations carry
    the forward's ~4e-6 float32 difference: an input within that of a kink (the tiny
    MNV2 step has 0-8 a layer within 1e-5) takes the other side's derivative in one
    framework, which moves a weight gradient by up to 3e-3 of its scale (measured). Each
    block alone agrees to 1e-6 in every gradient (checked while porting);
  - remat: the same loss and gradients, bit for bit (the recomputed forward runs the
    same kernels on the same inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from ssd_object_detection_tpu.models.mobilenet import InvertedResidual as JaxInvertedResidual
from ssd_object_detection_tpu.models.mobilenet import MobileNetV2Trunk as JaxMobileNetV2Trunk
from ssd_object_detection_tpu.models.resnet import BasicBlock as JaxBasicBlock
from ssd_object_detection_tpu.models.resnet import ResNet34Trunk as JaxResNet34Trunk
from ssd_object_detection_tpu.models.ssd import MODEL_SPECS as JAX_SPECS
from ssd_object_detection_tpu.models.ssd import SSD as JaxSSD
from ssd_object_detection_tpu.models.ssd import ModelSpec as JaxModelSpec
from ssd_object_detection_tpu.ops.anchors import generate_anchors
from ssd_object_detection_tpu.train.step import StepConfig as JaxStepConfig
from ssd_object_detection_tpu.train.step import create_train_state as jax_create_state
from ssd_object_detection_tpu.train.step import make_train_step as jax_make_train_step
from ssd_object_detection_tpu_torch.data.synthetic import SyntheticDetectionDataset
from ssd_object_detection_tpu_torch.models.convert import (
    from_flax_params,
    params_from_bytes,
    save_params_msgpack,
    to_flax_params,
)
from ssd_object_detection_tpu_torch.models.mobilenet import InvertedResidual, MobileNetV2Trunk
from ssd_object_detection_tpu_torch.models.resnet import BasicBlock, ResNet34Trunk
from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS, SSD, ModelSpec
from ssd_object_detection_tpu_torch.ops.anchors import AnchorSpec
from ssd_object_detection_tpu_torch.train.step import StepConfig, TrainState, make_train_step
from tests.test_train_step import NUM_CLASSES, TINY_ANCHORS

torch.set_num_threads(1)

_ANCHORS = {f: getattr(TINY_ANCHORS, f)
            for f in ("image_size", "feature_sizes", "scale_refs", "aspect_ratios")}
# 64 px: every trunk emits 8x8 (tap 0), one strided block gives the 4x4 tap
_BLOCKS = {
    "resnet34": ((), ((128, 1, 1, "SAME"), (128, 3, 2, "SAME"))),
    "mobilenetv2": ((), ((128, 1, 1, "SAME"), (128, 3, 2, "SAME"))),
    "micro": (((128, 3, 2, "SAME"),), ((128, 3, 2, "SAME"),)),
}
# (micro: 64 -> 16 by its two stride-2 convs, then 8 and 4)


def _specs(trunk):
    port = ModelSpec(name=f"tiny-{trunk}", anchor_spec=AnchorSpec(**_ANCHORS),
                     blocks=_BLOCKS[trunk], trunk=trunk)
    jax_spec = JaxModelSpec(name=f"tiny-{trunk}", anchor_spec=TINY_ANCHORS,
                            blocks=_BLOCKS[trunk], trunk=trunk)
    return port, jax_spec


def _randomized(params, seed=1):
    """flax init leaves GroupNorm at scale 1, bias 0; perturb every leaf so the affine
    parameters and their layout are exercised."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32),
                        params)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _nchw(x, dtype):
    return torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype, memory_format=torch.channels_last)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _compare(jax_module_for, port_module_for, x):
    """flax (float32 and bf16) against the port (float32 and bf16) on one weight set."""
    params = _randomized(jax_module_for(jnp.float32).init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want32 = np.asarray(jax_module_for(jnp.float32).apply(params, jnp.asarray(x)))
    want16 = np.asarray(jax_module_for(jnp.bfloat16).apply(params, jnp.asarray(x)).astype(jnp.float32))
    state = from_flax_params(params)
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        module = port_module_for(dtype)
        module.load_state_dict(state)
        with torch.no_grad():
            outs[dtype] = _nhwc(module(_nchw(x, dtype)))
    got32, got16 = outs[torch.float32], outs[torch.bfloat16]
    assert got32.shape == want32.shape
    assert np.abs(got32 - want32).max() <= 1e-5 * np.abs(want32).max()
    noise = _rel(want16, want32)
    assert _rel(got16, want16) <= noise, (_rel(got16, want16), noise)
    assert _rel(got16, want32) <= 1.25 * noise, (_rel(got16, want32), noise)


# odd and even sizes: SAME pads (0, 1) on the even stride-2 steps, (1, 1) on odd ones
@pytest.mark.parametrize("size", [64, 67])
def test_resnet34_trunk_matches_flax(size):
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    _compare(lambda d: JaxResNet34Trunk(dtype=d), lambda d: ResNet34Trunk(dtype=d), x)


@pytest.mark.parametrize("size", [64, 67])
def test_mobilenetv2_trunk_matches_flax(size):
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    _compare(lambda d: JaxMobileNetV2Trunk(dtype=d), lambda d: MobileNetV2Trunk(dtype=d), x)


@pytest.mark.parametrize("in_ch,features,stride,size", [(64, 64, 1, 9), (64, 128, 2, 10),
                                                        (64, 128, 2, 9), (32, 32, 2, 8)])
def test_basic_block_matches_flax(in_ch, features, stride, size):
    x = np.random.default_rng(0).normal(size=(2, size, size, in_ch)).astype(np.float32)
    _compare(lambda d: JaxBasicBlock(features, stride=stride, dtype=d),
             lambda d: BasicBlock(in_ch, features, stride=stride, dtype=d), x)


@pytest.mark.parametrize("in_ch,features,expand,stride,size", [(32, 16, 1, 1, 9), (16, 24, 6, 2, 10),
                                                               (24, 24, 6, 1, 9), (24, 32, 6, 2, 7)])
def test_inverted_residual_matches_flax(in_ch, features, expand, stride, size):
    x = np.random.default_rng(1).normal(size=(2, size, size, in_ch)).astype(np.float32)
    _compare(lambda d: JaxInvertedResidual(features, expand=expand, stride=stride, dtype=d),
             lambda d: InvertedResidual(in_ch, features, expand, stride=stride, dtype=d), x)


@pytest.mark.parametrize("trunk", ["resnet34", "mobilenetv2", "micro"])
def test_tiny_ssd_of_each_trunk_matches_flax(trunk):
    """The whole SSD: trunk (tap 0 = trunk output for R34 and MNV2), pyramid, heads."""
    port_spec, jax_spec = _specs(trunk)
    x = np.random.default_rng(3).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jax_model = JaxSSD(num_classes=NUM_CLASSES, spec=jax_spec)
    params = _randomized(jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want_loc, want_conf = (np.asarray(a) for a in jax_model.apply(params, jnp.asarray(x)))
    port = SSD(num_classes=NUM_CLASSES, spec=port_spec)
    port.load_state_dict(from_flax_params(params))
    with torch.no_grad():
        loc, conf = port(torch.from_numpy(x))
    assert loc.shape == want_loc.shape == (2, TINY_ANCHORS.num_anchors, 4)
    for got, want in ((loc.numpy(), want_loc), (conf.numpy(), want_conf)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# the six specs of the JAX package, named here: other test files register tiny specs in
# the registries at import, so the registries' contents depend on the import order
_VARIANTS = ("ssd300", "ssd512", "ssd300_r34", "ssd512_r34", "ssd300_mnv2", "ssd512_mnv2")


@pytest.mark.parametrize("variant", _VARIANTS)
def test_full_width_specs_build_with_flax_shapes(variant):
    """Each JAX spec is in the port with the same blocks; the port's parameters have the
    shapes of flax's (abstract init), and a meta-device forward gives (1, D, 4) and
    (1, D, 81) for D = the spec's anchors."""
    spec = MODEL_SPECS[variant]
    jax_spec = JAX_SPECS[variant]
    assert (spec.trunk, spec.blocks) == (jax_spec.trunk, jax_spec.blocks)
    size = spec.image_size
    abstract = jax.eval_shape(JaxSSD(num_classes=81, spec=jax_spec).init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32))
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), abstract)
    want = {k: tuple(v.shape) for k, v in from_flax_params(zeros).items()}
    with torch.device("meta"):
        port = SSD(num_classes=81, spec=spec)
        loc, conf = port(torch.empty(1, size, size, 3))
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    d = spec.anchor_spec.num_anchors
    assert tuple(loc.shape) == (1, d, 4) and tuple(conf.shape) == (1, d, 81)


def _capture_grads(lr=0.0):
    """optax transform whose state becomes the clipped, averaged gradients and whose
    update is plain SGD at `lr`."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(lambda x: -lr * x, g), g),
    )


def _batch():
    ds = SyntheticDetectionDataset(num_images=4, image_size=64, max_gt=4, num_classes=8, seed=5)
    batch = next(ds.batches(batch_size=4))
    batch["image"] = np.round(batch["image"] * 255.0).astype(np.uint8)
    return batch


def _port_step(port, batch, lr=0.0):
    state = TrainState(model=port, optimizer=torch.optim.SGD(port.parameters(), lr=lr),
                       schedule=lambda step: lr)
    metrics = make_train_step(generate_anchors(TINY_ANCHORS), StepConfig())(state, batch)
    return metrics, {name: p.grad.clone() for name, p in port.named_parameters()}


@pytest.mark.parametrize("trunk", ["resnet34", "mobilenetv2"])
def test_train_step_of_each_family_matches_jax(trunk):
    """One float32 step from identical params and batch, plain SGD at 0.1: the loss terms,
    the clipped gradients (as tests/test_torch_train_step.py reads them) and the updated
    parameters (0.1 x the gradients' difference on top of float32 rounding: rtol 1e-5,
    atol 1e-6)."""
    port_spec, jax_spec = _specs(trunk)
    jax_model = JaxSSD(num_classes=NUM_CLASSES, spec=jax_spec)
    params = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    batch = _batch()
    tx = _capture_grads(lr=0.1)
    step = jax_make_train_step(jax_model.apply, generate_anchors(TINY_ANCHORS), tx, JaxStepConfig())
    new_state, want = step(jax_create_state(params, tx), batch)
    want_grads = from_flax_params(jax.tree.map(np.asarray, new_state.opt_state))
    want_params = from_flax_params(jax.tree.map(np.asarray, new_state.params))

    port = SSD(num_classes=NUM_CLASSES, spec=port_spec)
    port.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    metrics, grads = _port_step(port, batch, lr=0.1)
    for name, value in port.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want_params[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    for key in want:
        assert float(metrics[key]) == pytest.approx(float(want[key]), rel=1e-5), key
    assert set(grads) == set(want_grads)
    trunk = {"resnet34": "resnet.", "mobilenetv2": "mobilenet."}[trunk]
    for name, g in grads.items():
        want_g = want_grads[name].numpy()
        if name.startswith(trunk):
            assert _rel(g.numpy(), want_g) <= 1e-2, (name, _rel(g.numpy(), want_g))
        else:
            np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-4,
                                       atol=1e-4 * np.abs(want_g).max(), err_msg=name)


@pytest.mark.parametrize("trunk", ["resnet34", "mobilenetv2", "micro"])
def test_remat_gives_the_same_loss_and_gradients(trunk):
    port_spec, _ = _specs(trunk)
    batch = _batch()
    runs = []
    for remat in (False, True):
        port = SSD(num_classes=NUM_CLASSES, spec=port_spec, remat=remat)
        port.init_weights(torch.Generator().manual_seed(0))
        runs.append(_port_step(port, batch))
    (m0, g0), (m1, g1) = runs
    for key in m0:
        assert torch.equal(m0[key], m1[key]), key
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_remat_recomputes_the_trunk_only_under_grad():
    port_spec, _ = _specs("resnet34")
    port = SSD(num_classes=NUM_CLASSES, spec=port_spec, remat=True)
    calls = []
    port.resnet.register_forward_pre_hook(lambda *a: calls.append(torch.is_grad_enabled()))
    x = torch.zeros(1, 64, 64, 3)
    loc, conf = port(x)
    (loc.sum() + conf.sum()).backward()
    assert len(calls) == 2  # the forward, then its recomputation in the backward
    with torch.no_grad():
        port(x)
    assert len(calls) == 3


@pytest.mark.parametrize("trunk", ["resnet34", "mobilenetv2", "micro"])
def test_flax_torch_round_trip_of_each_family(trunk):
    """GroupNorm scale <-> weight (1-D), kernels HWIO <-> OIHW, depthwise (3, 3, 1, C)
    <-> (C, 1, 3, 3): flax -> torch -> flax is the identity, every leaf bit-equal."""
    port_spec, jax_spec = _specs(trunk)
    params = _randomized(JaxSSD(num_classes=NUM_CLASSES, spec=jax_spec).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3))))
    state = from_flax_params(params)
    port = SSD(num_classes=NUM_CLASSES, spec=port_spec)
    assert set(state) == set(port.state_dict())
    port.load_state_dict(state)
    back = dict(jax.tree_util.tree_leaves_with_path(to_flax_params(port.state_dict())))
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(leaves) == len(back)
    for path, leaf in leaves:
        np.testing.assert_array_equal(back[path], leaf)
    if trunk == "mobilenetv2":
        dw = params["params"]["mobilenet"]["stage1_block0"]["depthwise"]["kernel"]
        assert dw.shape == (3, 3, 1, 96)
        assert tuple(state["mobilenet.stage1_block0.depthwise.weight"].shape) == (96, 1, 3, 3)
        np.testing.assert_array_equal(state["mobilenet.stage1_block0.depthwise.weight"][5, 0].numpy(),
                                      dw[:, :, 0, 5])
    if trunk == "resnet34":
        np.testing.assert_array_equal(state["resnet.layer2_block0.proj_norm.weight"].numpy(),
                                      params["params"]["resnet"]["layer2_block0"]["proj_norm"]["scale"])


@pytest.mark.parametrize("trunk", ["resnet34", "mobilenetv2", "micro"])
def test_msgpack_files_load_in_both_packages(trunk, tmp_path):
    """A `.msgpack` written by flax loads into the port bit-equal, and the port's file
    restores in flax bit-equal."""
    port_spec, jax_spec = _specs(trunk)
    jax_model = JaxSSD(num_classes=NUM_CLASSES, spec=jax_spec)
    params = jax.device_get(_randomized(jax_model.init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)))))
    port = SSD(num_classes=NUM_CLASSES, spec=port_spec)
    params_from_bytes(port, serialization.to_bytes(params))
    for key, value in from_flax_params(params).items():
        assert torch.equal(port.state_dict()[key], value), key
    path = save_params_msgpack(port, str(tmp_path / "w.msgpack"))
    with open(path, "rb") as f:
        restored = serialization.from_bytes(params, f.read())
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(restored),
                              jax.tree_util.tree_leaves_with_path(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(p))
