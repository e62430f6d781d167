"""The port's entry points and introspection: cli/dryrun.py (`entry`, `dryrun_multichip`),
cli/bench.py and utils/introspect.py, against the JAX package's where both compute the
same thing (the parameter count).

The dry run spawns 4 gloo ranks from tests/_torch_dp_worker.py, which blocks JAX in them.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from ssd_object_detection_tpu.models.ssd import SSD as JaxSSD
from ssd_object_detection_tpu.utils.introspect import param_summary as jax_param_summary
from ssd_object_detection_tpu_torch.cli import bench, dryrun
from ssd_object_detection_tpu_torch.models.convert import from_flax_params
from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS, SSD
from ssd_object_detection_tpu_torch.ops.conv3x3 import conv3x3_bias_relu
from ssd_object_detection_tpu_torch.ops.quant import quantize_synthetic, quantized_convs
from ssd_object_detection_tpu_torch.utils import introspect
from tests.test_torch_parallel import run_worker
from tests.test_torch_train_step import PORT_TINY
from tests.test_train_step import NUM_CLASSES, TINY_MODEL

torch.set_num_threads(1)
MODEL_SPECS.setdefault("tiny-test-torch", PORT_TINY)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "precision", "bf16_images_per_sec",
              "bf16_vs_baseline", "device", "power_limit"}


def test_dryrun_multichip_four_gloo_ranks(tmp_path):
    """Every leg runs; the (2, 2) leg's loss is within 1e-3 of the data-parallel loss, as
    the JAX dry run requires; the fused predict keeps 16 detections an image."""
    out = run_worker(["dryrun", 4], tmp_path)
    result = json.loads(next(line for line in out.splitlines() if line.startswith("DRYRUN "))[7:])
    assert [name for name, _ in result["legs"]] == [
        "build model + step", "dp train step", "step 2 + checkpoint resume + step 3",
        "dp x tp train step", "dp fused-infer"]
    assert np.isfinite(result["dp_loss"]) and result["positives"] > 0
    assert abs(result["tp_loss"] - result["dp_loss"]) < 1e-3
    assert 0 < result["detections"] <= 8 * 16
    assert "dryrun_multichip(4): ok, dp loss=" in out and "[dryrun] dp x tp train step" in out


def test_dryrun_on_cuda_without_enough_gpus_names_gloo(monkeypatch):
    """No fallback: fewer GPUs than ranks and no backend named is an error that names
    backend="gloo"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match='backend="gloo"'):
        dryrun.dryrun_multichip(4, device="cuda")


def test_entry_is_the_bf16_ssd300_forward():
    fn, (example,) = dryrun.entry(device="cpu")
    assert tuple(example.shape) == (8, 300, 300, 3) and example.dtype == torch.float32
    loc, conf = fn(example[:1])
    assert tuple(loc.shape) == (1, 8732, 4) and tuple(conf.shape) == (1, 8732, 81)
    assert bool(torch.isfinite(loc).all()) and bool(torch.isfinite(conf).all())


def test_bench_prints_one_json_line_with_every_key(capsys):
    result = bench.main(["--batch", "2", "--pipeline", "2", "--warmup", "1", "--iters", "1",
                         "--variant", "tiny-test-torch", "--device", "cpu"])
    lines = [line for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert json.loads(lines[-1]) == result
    assert set(result) == BENCH_KEYS
    assert result["value"] > 0 and result["bf16_images_per_sec"] > 0
    assert result["vs_baseline"] == round(result["value"] / 2000.0, 3)
    assert result["device"] == "cpu" and result["power_limit"] is None


def test_param_summary_total_equals_jax():
    params = JaxSSD(num_classes=NUM_CLASSES, spec=TINY_MODEL).init(jax.random.PRNGKey(0),
                                                                  jnp.zeros((1, 64, 64, 3)))
    model = SSD(num_classes=NUM_CLASSES, spec=PORT_TINY)
    model.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)))
    got, want = introspect.param_summary(model), jax_param_summary(params)
    assert got.splitlines()[-1].split()[-1] == want.splitlines()[-1].split()[-1]
    assert len(got.splitlines()) == len(want.splitlines())


@pytest.mark.parametrize("kernel,stride,padding", [(3, 1, 1), (3, 2, 1), (1, 1, 0)])
def test_flops_of_one_conv(kernel, stride, padding):
    """2 * B * Ho * Wo * KH * KW * IC * OC, exactly, for F.conv2d and the port's conv3x3
    operator."""
    b, h, w, ic, oc = 2, 9, 12, 16, 24
    x, weight = torch.randn(b, ic, h, w), torch.randn(oc, ic, kernel, kernel)
    ho, wo = (h + 2 * padding - kernel) // stride + 1, (w + 2 * padding - kernel) // stride + 1
    got = introspect.flops_analysis(lambda: F.conv2d(x, weight, stride=stride, padding=padding))
    assert got == {"flops": 2 * b * ho * wo * kernel * kernel * ic * oc}
    if kernel == 3 and stride == 1:
        nhwc = x.permute(0, 2, 3, 1).contiguous()
        got = introspect.flops_analysis(conv3x3_bias_relu, nhwc, weight.permute(2, 3, 1, 0), torch.zeros(oc))
        assert got == {"flops": 2 * b * h * w * 9 * ic * oc}


def test_flops_of_a_ptq_forward_count_its_int8_convs():
    """The float and PTQ forwards of the tiny SSD count the same FLOPs, the sum over its
    convs reckoned from the spec's shapes (chip_smoke.py's check on the card); with the
    int8 operator's formula unregistered the PTQ count drops its int8 convs."""
    model = SSD(num_classes=NUM_CLASSES, spec=PORT_TINY).init_weights(torch.Generator().manual_seed(0)).eval()
    shape = (2, 64, 64, 3)
    qmodel, n = quantize_synthetic(model, shape, include_heads=True)
    assert n == quantized_convs(qmodel) > 0
    x = torch.rand(shape) * 2 - 1
    want = chip_smoke.reckoned_conv_flops(PORT_TINY, 2, NUM_CLASSES)
    with torch.no_grad():
        assert introspect.flops_analysis(model, x) == {"flops": want}
        assert introspect.flops_analysis(qmodel, x) == {"flops": want}
        registry = torch.utils.flop_counter.flop_registry
        formula = registry.pop(torch.ops.ssd_torch.int8_conv)
        try:
            assert introspect.flops_analysis(qmodel, x)["flops"] < want
        finally:
            registry[torch.ops.ssd_torch.int8_conv] = formula


def test_trace_writes_a_chrome_trace(tmp_path):
    with introspect.trace(str(tmp_path / "trace")):
        torch.ones(4).add_(1)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("add_" in e.get("name", "") for e in events)
