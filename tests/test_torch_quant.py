"""int8 post-training quantization of the port (ops/quant.py, ops/cuda_int8.py's plain
version) against the JAX package's ops/quant.py, on the CPU.

Mirrors tests/test_quant.py and holds the port to JAX:
  - eligibility and execution order equal to JAX's discover_eligible (the full-width
    specs included: SSD512's dilated convs and MNV2's depthwise convs excluded, heads
    only with include_heads);
  - calibration values within rel 1e-5 of JAX's (the activations agree to the float32
    forward's tolerance, tests/test_torch_trunks.py; at bf16 they are equal);
  - quantize_weights bit-equal (the same numpy arithmetic);
  - the quantize step bit-equal to JAX's clip(round(x / x_scale)), exact .5 multiples
    included (round half to even);
  - int32 accumulators bit-equal to lax.conv_general_dilated(preferred_element_type=int32);
  - the dequantized conv within one float32 ulp of JAX's _int8_conv (measured equal);
  - the whole quantized forward of a tiny model on one QuantSpec: at most 0.1 % of the
    quantized activations differ, each by one step (an upstream float32 difference can
    move a value across a rounding boundary), and the outputs within 1e-4 relative L2
    of JAX's at float32, 2e-2 at bf16 (see the test for the chained R34 case);
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from ssd_object_detection_tpu.models.ssd import MODEL_SPECS as JAX_SPECS
from ssd_object_detection_tpu.models.ssd import SSD as JaxSSD
from ssd_object_detection_tpu.models.ssd import ModelSpec as JaxModelSpec
from ssd_object_detection_tpu.ops import quant as jq
from ssd_object_detection_tpu.ops.anchors import AnchorSpec as JaxAnchorSpec
from ssd_object_detection_tpu_torch.models.convert import from_flax_params
from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS, SSD, ModelSpec
from ssd_object_detection_tpu_torch.ops import cuda_int8, quant
from ssd_object_detection_tpu_torch.ops.anchors import AnchorSpec

torch.set_num_threads(1)

_ANCHORS = dict(image_size=64, feature_sizes=((16, 16), (8, 8)), scale_refs=(13, 26, 52),
                aspect_ratios=((2,), (2,)))
# extra0_conv0's input is the 64-channel micro trunk (not eligible at min_in_ch=128);
# extra1_conv0's is 160-channel (eligible); the taps (160, 192) make every head eligible
_MICRO_BLOCKS = (((160, 3, 1, "SAME"),), ((192, 3, 2, "SAME"),))
# a ResNet-34 spec whose eligible convs include projections (proj runs after conv2)
_R34_ANCHORS = dict(image_size=64, feature_sizes=((8, 8), (4, 4)), scale_refs=(13, 26, 45),
                    aspect_ratios=((2,), (2,)))
_R34_BLOCKS = ((), ((128, 1, 1, "SAME"), (128, 3, 2, "SAME")))
_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(trunk, blocks, anchors, dtype, seed=0):
    """(jax model, flax params, port model) on identical weights."""
    jdt, tdt = _DTYPES[dtype]
    jax_model = JaxSSD(num_classes=9, dtype=jdt, conf_f32=False, spec=JaxModelSpec(
        name="q", anchor_spec=JaxAnchorSpec(**anchors), trunk=trunk, blocks=blocks))
    params = jax_model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)))
    port = SSD(num_classes=9, dtype=tdt, conf_f32=False, spec=ModelSpec(
        name="q", anchor_spec=AnchorSpec(**anchors), trunk=trunk, blocks=blocks))
    port.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    return jax_model, params, port


def _micro(dtype="bfloat16"):
    return _pair("micro", _MICRO_BLOCKS, _ANCHORS, dtype)


def _r34(dtype="float32"):
    return _pair("resnet34", _R34_BLOCKS, _R34_ANCHORS, dtype)


def _images(n=2, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 64, 64, 3)).astype(np.float32)


def test_calibrate_selects_eligible_convs_only():
    jax_model, params, port = _micro()
    x = _images()
    stats = quant.calibrate(port, [torch.from_numpy(x)], min_in_ch=128)
    assert list(stats) == ["extra1_conv0"] and stats["extra1_conv0"] > 0
    assert stats == jq.calibrate(jax_model, params, [jnp.asarray(x)], min_in_ch=128)


@pytest.mark.parametrize("make", [_micro, _r34], ids=["micro", "resnet34"])
@pytest.mark.parametrize("heads", [False, True])
def test_discover_and_calibrate_match_jax(make, heads):
    """The same paths in JAX's execution order; calibrate's keys are those paths (JAX's
    jitted calibrate returns them sorted) and its values agree to float32 rounding."""
    jax_model, params, port = make()
    x = _images()
    want_order = jq.discover_eligible(jax_model, params, x.shape, include_heads=heads)
    assert quant.discover_eligible(port, x.shape, include_heads=heads) == want_order
    got = quant.calibrate(port, [torch.from_numpy(x), torch.from_numpy(_images(seed=1))],
                          include_heads=heads)
    want = jq.calibrate(jax_model, params, [jnp.asarray(x), jnp.asarray(_images(seed=1))],
                        include_heads=heads)
    assert tuple(got) == want_order and set(want) == set(got)
    for path, value in want.items():  # the float32 forward's tolerance (R34: 1.9e-6)
        assert got[path] == pytest.approx(value, rel=1e-5), path


def test_resnet34_projection_comes_after_conv2():
    _, _, port = _r34()
    order = quant.discover_eligible(port, (1, 64, 64, 3))
    assert order.index("resnet/layer3_block0/conv2") < order.index("resnet/layer3_block0/proj")


# counts on the JAX package (ROADMAP A13): without heads / with heads
_FULL_WIDTH_COUNTS = {"ssd300": (17, 29), "ssd300_r34": (30, 42), "ssd300_mnv2": (20, 30),
                      "ssd512": (None, None)}


@pytest.mark.parametrize("variant", sorted(_FULL_WIDTH_COUNTS))
def test_full_width_eligibility_matches_jax(variant):
    """Abstract traces only (eval_shape in JAX, the meta device in the port). SSD512's
    dilated convs and MNV2's depthwise convs never quantize."""
    spec = MODEL_SPECS[variant]
    shape = (1, spec.image_size, spec.image_size, 3)
    jax_model = JaxSSD(num_classes=81, spec=JAX_SPECS[variant])
    abstract = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                              jax.ShapeDtypeStruct(shape, jnp.float32))
    with torch.device("meta"):
        port = SSD(num_classes=81, spec=spec)
    for heads, count in zip((False, True), _FULL_WIDTH_COUNTS[variant]):
        got = quant.discover_eligible(port, shape, include_heads=heads)
        assert got == jq.discover_eligible(jax_model, abstract, shape, include_heads=heads)
        if count is not None:
            assert len(got) == count
        for path in got:
            conv = port.get_submodule(path.replace("/", "."))
            assert conv.groups == 1 and conv.dilation == (1, 1) and conv.in_channels >= 128
    if variant == "ssd512":
        assert "extra0_conv0" not in got and "extra1_conv0" not in got  # dilated
        assert "extra0_conv2" in got  # the 1x1 after them is not


def test_quantize_weights_bit_equal():
    for make in (_micro, _r34):
        jax_model, params, port = make("float32")
        stats = jq.calibrate(jax_model, params, [jnp.asarray(_images())], include_heads=True)
        want = jq.quantize_weights(params, stats)
        got = quant.quantize_weights(port, stats)
        assert list(got) == list(want)
        for path in want:
            for field in ("w_q", "w_scale", "bias", "x_scale"):
                a, b = got[path][field].numpy(), np.asarray(want[path][field])
                assert a.dtype == b.dtype and a.shape == b.shape, (path, field)
                np.testing.assert_array_equal(a, b, err_msg=f"{path} {field}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_step_bit_equal(dtype):
    """clip(round(x / x_scale), -127, 127): exact .5 multiples of the scale round half to
    even in both; the clip holds at +-127."""
    jdt, tdt = _DTYPES[dtype]
    rng = np.random.default_rng(0)
    x_scale = np.float32(2.0 ** -4)
    halves = (np.arange(-140, 141) + 0.5) * x_scale  # k + 0.5 steps, past the clip
    values = np.concatenate([halves, rng.normal(size=4000) * 5, [0.0, -0.0, 127 * x_scale]])
    x = np.array(jnp.asarray(values.astype(np.float32), jdt).astype(jnp.float32))
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(x, jdt).astype(jnp.float32) / x_scale),
                               -127, 127).astype(jnp.int8))
    got = cuda_int8.quantize_plain(torch.from_numpy(x).to(tdt), torch.tensor(x_scale)).numpy()
    np.testing.assert_array_equal(got, want)
    assert {-2, 0, 2} <= set(got[(np.abs(x / x_scale) % 1 == 0.5) & (np.abs(x) < 3 * x_scale)])


_CONVS = [  # (kernel, stride, padding, h, w, ic, oc)
    (1, 1, "SAME", 9, 9, 32, 24),
    (3, 1, "SAME", 10, 9, 16, 8),
    (3, 2, "SAME", 10, 10, 16, 8),  # even: pads (0, 1)
    (3, 2, "SAME", 9, 11, 16, 8),  # odd: pads (1, 1)
    (3, 1, "VALID", 3, 3, 64, 16),  # 3 -> 1
    (1, 2, "SAME", 8, 8, 24, 16),
]


def _pads(padding, h, w, k, s):
    from ssd_object_detection_tpu_torch.models.vgg import same_padding

    if padding == "VALID":
        return 0, 0, 0, 0
    return (*same_padding(h, k, s), *same_padding(w, k, s))


@pytest.mark.parametrize("k,s,padding,h,w,ic,oc", _CONVS)
def test_int32_accumulators_bit_equal(k, s, padding, h, w, ic, oc):
    rng = np.random.default_rng(k * 10 + s)
    xq = rng.integers(-127, 128, (2, h, w, ic), np.int8)
    wq = rng.integers(-127, 128, (k, k, ic, oc), np.int8)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq), (s, s), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
    got = cuda_int8.accumulate_plain(torch.from_numpy(xq), torch.from_numpy(wq).permute(3, 0, 1, 2),
                                     (s, s), _pads(padding, h, w, k, s))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,s,padding,h,w,ic,oc", _CONVS)
@pytest.mark.parametrize("use_bias", [True, False])
def test_dequantized_conv_within_one_ulp(k, s, padding, h, w, ic, oc, use_bias):
    """The operator (plain version on the CPU) against JAX's _int8_conv on one q."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, h, w, ic)) * 2).astype(np.float32)
    kernel = (rng.normal(size=(k, k, ic, oc)) * 0.1).astype(np.float32)
    bias = rng.normal(size=(oc,)).astype(np.float32)
    params = {"conv": {"kernel": kernel, "bias": bias}}
    q = jq.quantize_weights(params, {"conv": float(np.abs(x).max())})["conv"]
    module = fnn.Conv(oc, (k, k), strides=(s, s), padding=padding, use_bias=use_bias)
    want = np.asarray(jq._int8_conv(module, jnp.asarray(x), q))
    q = {key: torch.from_numpy(np.array(value)) for key, value in q.items()}
    got = quant.int8_conv(torch.from_numpy(x), q["w_q"].permute(3, 0, 1, 2), q["w_scale"],
                          q["bias"] if use_bias else None, q["x_scale"], (s, s),
                          _pads(padding, h, w, k, s)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))


def _record_quantized_inputs(monkeypatch):
    """[(x_scale, x)] of every int8 conv the port runs, in order (x NHWC, as the operator
    sees it)."""
    seen = []
    real = quant.int8_conv

    def recording(x, w_q, w_scale, bias, x_scale, *args):
        seen.append((float(x_scale), x.float().numpy().copy()))
        return real(x, w_q, w_scale, bias, x_scale, *args)

    monkeypatch.setattr(quant, "int8_conv", recording)
    return seen


def _jax_quantized_inputs(jax_model, q_apply, q_params, x):
    seen = []

    def capture(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and isinstance(context.module, fnn.Conv):
            q = q_params["quant"].get("/".join(context.module.path))
            if q is not None:
                seen.append((float(q["x_scale"]), np.asarray(args[0].astype(jnp.float32))))
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(capture):
        out = q_apply(q_params, jnp.asarray(x))
    return out, seen


def _steps(seen_a, seen_b):
    """Per int8 conv (execution order): the quantized values of two runs' inputs on the
    same scales -> [(values, how many differ, largest difference in steps)]."""
    out = []
    for (scale, a), (scale_b, b) in zip(seen_a, seen_b):
        assert scale == scale_b
        qa = np.clip(np.round(a / np.float32(scale)), -127, 127)
        qb = np.clip(np.round(b / np.float32(scale)), -127, 127)
        out.append((qa.size, int((qa != qb).sum()), float(np.abs(qa - qb).max())))
    return out


@pytest.mark.parametrize("make,dtype", [(_micro, "float32"), (_micro, "bfloat16"),
                                        (_r34, "float32")], ids=["micro-f32", "micro-bf16", "r34-f32"])
def test_quantized_forward_matches_jax(monkeypatch, make, dtype):
    """On one QuantSpec (JAX's), the port's int8 inputs against JAX's. In the micro model
    the int8 convs read float layers only: under 0.1 % of the quantized values differ,
    by one step at most. In R34 the 30 int8 convs run in a chain, and a value that
    crosses a rounding boundary moves its consumers' inputs by w * one step: JAX's own
    q_apply, fed the same images changed by 1e-7 relative, cascades to 14.5 % of the
    values (up to 6 steps) by the last conv. There the first int8 conv obeys the micro
    rule and the whole chain differs in no more than twice JAX's own cascade."""
    jax_model, params, port = make(dtype)
    x = _images(seed=4)
    q_apply, q_params = jq.quantize_ssd(jax_model, params, [jnp.asarray(x)], include_heads=True)
    qspec = {path: {k: torch.from_numpy(np.array(v)) for k, v in q.items()}
             for path, q in q_params["quant"].items()}
    q_port = quant.quantize_model(port, qspec)
    assert quant.quantized_convs(q_port) == len(qspec) > 0
    (want_loc, want_conf), want_in = _jax_quantized_inputs(jax_model, q_apply, q_params, x)
    got_in = _record_quantized_inputs(monkeypatch)
    with torch.no_grad():
        loc, conf = q_port(torch.from_numpy(x))
    assert len(got_in) == len(want_in) == len(qspec)
    steps = _steps(got_in, want_in)  # both in execution order
    chained = make is _r34
    for size, differ, largest in (steps[:1] if chained else steps):
        assert largest <= 1 and differ <= 1e-3 * size, (size, differ, largest)
    total, differ = sum(s[0] for s in steps), sum(s[1] for s in steps)
    outputs = [(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
               for got, want in ((loc, want_loc), (conf, want_conf))]
    if chained:  # against JAX's own cascade, outputs included
        nudged = (x * (1 + 1e-7 * np.random.default_rng(1).normal(size=x.shape))).astype(np.float32)
        own_out, own_in = _jax_quantized_inputs(jax_model, q_apply, q_params, nudged)
        own = sum(s[1] for s in _steps(own_in, want_in))
        assert differ <= 2 * own, (differ, own, total)
        for (got, want), mine in zip(outputs, own_out):
            mine = np.asarray(mine.astype(jnp.float32))
            assert np.linalg.norm(got - want) <= 2 * np.linalg.norm(mine - want)
        return
    assert differ <= 1e-3 * total
    for got, want in outputs:
        tol = 1e-4 if dtype == "float32" else 2e-2
        assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)


def test_quantized_outputs_close_to_float_and_keep_no_float_kernel():
    _, _, port = _micro()
    x = torch.from_numpy(_images())
    q_port, qspec = quant.quantize_ssd(port, [x])
    with torch.no_grad():
        ref, out = port(x), q_port(x)
    for a, b in zip(out, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        rel = float(torch.linalg.norm((a - b).float()) / (torch.linalg.norm(b.float()) + 1e-9))
        assert rel < 0.02, rel
    conv = q_port.extra1_conv0
    assert isinstance(conv, quant.QuantConv2d) and list(conv.parameters()) == []
    assert conv.w_q.dtype == torch.int8 and "extra1_conv0.weight" not in q_port.state_dict()
    assert isinstance(port.extra1_conv0, nn.Conv2d)  # the float model is untouched


def test_heads_eligible_only_when_included():
    _, _, port = _micro()
    stats = quant.calibrate(port, [torch.from_numpy(_images())], include_heads=True)
    assert set(stats) == {"extra1_conv0", "loc_head0", "conf_head0", "loc_head1", "conf_head1"}


def test_dilated_and_grouped_convs_excluded():
    x = torch.zeros(1, 256, 8, 8)
    plain = nn.Conv2d(256, 64, 3)
    assert quant._eligible(plain, "extra0_conv0", x, 128, True)
    assert not quant._eligible(nn.Conv2d(256, 64, 3, dilation=6), "extra0_conv0", x, 128, True)
    assert not quant._eligible(nn.Conv2d(256, 256, 3, groups=256), "d", x, 128, True)
    assert not quant._eligible(plain, "loc_head0", x, 128, False)
    with pytest.raises(ValueError, match="dilation"):
        quant.QuantConv2d(nn.Conv2d(256, 64, 3, dilation=2), {})


def test_quantize_synthetic_helper():
    _, _, port = _micro()
    shape = (2, 64, 64, 3)
    q_port, n = quant.quantize_synthetic(port, shape)
    assert n == len(quant.discover_eligible(port, shape)) == quant.quantized_convs(q_port)
    with torch.no_grad():
        loc, conf = q_port(torch.zeros(shape))
    assert loc.shape == (2, port.spec.anchor_spec.num_anchors, 4)


def test_int8_conv_exact_on_grid():
    """Weights on an int8 grid with the dyadic scale 2^-5 and every out-channel's absmax
    pinned to 127 * 2^-5: the scale is exactly 2^-5 and w_q * w_scale is the kernel."""
    _, _, port = _micro("float32")
    conv = port.extra1_conv0
    with torch.no_grad():
        w = conv.weight.numpy()
        snapped = np.clip(np.round(w / 2.0 ** -5), -127, 127) * 2.0 ** -5
        snapped[:, 0, 0, 0] = 127 * 2.0 ** -5
        conv.weight.copy_(torch.from_numpy(snapped.astype(np.float32)))
    q = quant.quantize_weights(port, {"extra1_conv0": 1.0})["extra1_conv0"]
    np.testing.assert_array_equal(q["w_scale"].numpy(), 2.0 ** -5)
    np.testing.assert_array_equal(q["w_q"].numpy().astype(np.float32) * q["w_scale"].numpy(),
                                  snapped.astype(np.float32).transpose(2, 3, 1, 0))


def test_operator_is_registered_with_a_fake_for_export():
    """torch.export captures the int8 conv as one `ssd_torch::int8_conv` node."""
    _, _, port = _micro()
    q_port, _ = quant.quantize_synthetic(port, (1, 64, 64, 3))
    with torch.no_grad():
        program = torch.export.export(q_port, (torch.zeros(1, 64, 64, 3),))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("ssd_torch.int8_conv.default") == 1
    with torch.no_grad():
        got = program.module()(torch.ones(1, 64, 64, 3))
        want = q_port(torch.ones(1, 64, 64, 3))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
