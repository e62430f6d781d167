"""The int8 PTQ path through the port's detect, serving and CLI entry points on the CPU
(`--device cpu`): the quantized detect program under torch.export, artifacts and bundles
bit-equal to the live quantized path, detections against the JAX package's quantized
predict, and `cli.eval_synthetic --ptq` at a 1+1-step budget.

Tolerances: an exported program against the live model it was exported from, bit-equal
(one aten graph, the same operator); against JAX on one QuantSpec at float32, detection
counts and classes equal and scores and boxes within 2e-5 (the int8 inputs agree there,
tests/test_torch_quant.py, and the float layers keep the forward's tolerance).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ssd_object_detection_tpu.eval.predict import make_predict_fn as jax_make_predict_fn
from ssd_object_detection_tpu.ops import quant as jq
from ssd_object_detection_tpu.ops.anchors import generate_anchors
from ssd_object_detection_tpu_torch.cli import eval_synthetic
from ssd_object_detection_tpu_torch.eval.predict import make_predict_fn
from ssd_object_detection_tpu_torch.eval.serve import (
    DetectorService,
    artifact_precision,
    export_detector,
    export_fused_detector_bundle,
    load_detector,
)
from ssd_object_detection_tpu_torch.ops import quant
from tests.test_torch_quant import _images, _micro
from tests.test_torch_trainer import _tiny_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def quantized():
    """(jax model, flax params, port float model, port int8 model, JAX q_apply, q_params)
    on one QuantSpec, float32 compute."""
    jax_model, params, port = _micro("float32")
    x = _images(seed=2)
    q_apply, q_params = jq.quantize_ssd(jax_model, params, [jnp.asarray(x)], min_in_ch=128)
    qspec = {path: {k: torch.from_numpy(np.array(v)) for k, v in q.items()}
             for path, q in q_params["quant"].items()}
    return jax_model, params, port, quant.quantize_model(port, qspec), q_apply, q_params


def test_ptq_export_reload_matches_live_quantized_predict(quantized):
    """tests/test_serve.py's PTQ case: the quantized detector exports through the same
    contract and reloads bit-equal to the live quantized predict."""
    _, _, _, q_port, _, _ = quantized
    anchors = generate_anchors(q_port.spec.anchor_spec)
    blob = export_detector(q_port, anchors, batch_size=2, image_size=64, score_thresh=0.05)
    assert artifact_precision(blob) == "int8-ptq"
    images = torch.from_numpy((_images(seed=2) + 1.0) / 2.0)
    served = load_detector(blob, device="cpu")(images)
    live = make_predict_fn(q_port, anchors, score_thresh=0.05)(images)
    for a, b in zip(served, live):
        assert torch.equal(a, b)


def test_quantized_detections_match_jax(quantized):
    _, _, _, q_port, q_apply, q_params = quantized
    anchors = generate_anchors(q_port.spec.anchor_spec)
    images = ((_images(seed=2) + 1.0) / 2.0).astype(np.float32)
    want = jax_make_predict_fn(q_apply, anchors, score_thresh=0.05)(q_params, jnp.asarray(images))
    got = make_predict_fn(q_port, anchors, score_thresh=0.05)(torch.from_numpy(images))
    assert int(got.valid.sum()) > 0
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=2e-5)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=2e-5)


def test_quantized_bundle_serves_what_the_live_service_serves(quantized):
    _, _, _, q_port, _, _ = quantized
    anchors = generate_anchors(q_port.spec.anchor_spec)
    kw = dict(image_size=64, canvas_hw=(96, 96), score_thresh=0.05)
    bundle = export_fused_detector_bundle(q_port, anchors, batch_tiers=(1, 2), **kw)
    assert artifact_precision(bundle) == "int8-ptq"
    art = DetectorService.from_artifact(bundle, device="cpu")
    live = DetectorService(q_port, anchors, batch_size=2, batch_tiers=(1, 2), **kw)
    rng = np.random.default_rng(3)
    for n in (1, 2):
        images = [rng.integers(0, 256, (50 + 10 * i, 70, 3), np.uint8) for i in range(n)]
        assert json.dumps(art.detect_images(images)) == json.dumps(live.detect_images(images))


def test_float_artifacts_record_their_dtype(quantized):
    _, _, port, _, _, _ = quantized
    blob = export_detector(port, generate_anchors(port.spec.anchor_spec), batch_size=1,
                           image_size=64)
    assert artifact_precision(blob) == "float32"


def test_eval_synthetic_ptq_at_a_tiny_budget(capsys):
    """--ptq adds the float-vs-int8 gates of tools/eval_synthetic.py on the same weights
    and val split: "ptq" (heads float) and "ptq_heads"."""
    result = eval_synthetic.main([
        "--device", "cpu", "--warmup", "1", "--steps", "1", "--batch-size", "2",
        "--num-train", "2", "--num-val", "2", "--ptq",
    ])
    out = capsys.readouterr().out
    assert "ptq: quantized 17 convs" in out and "ptq_heads: quantized 29 convs" in out
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(json.dumps(result))
    for key in ("ptq", "ptq_heads"):
        gate = result[key]
        assert gate["mAP50_drop_vs_float"] == pytest.approx(
            result["mAP@0.5"] - gate["metrics"]["mAP@0.5"])
        assert gate["pass"] == (gate["mAP50_drop_vs_float"] <= 0.02)
    assert result["pass"] == (result["mAP@0.5"] > 0.9 and result["ptq"]["pass"]
                              and result["ptq_heads"]["pass"])


@pytest.fixture(scope="module")
def tiny_yaml(tmp_path_factory):
    root = tmp_path_factory.mktemp("ptq_cli")
    path = root / "tiny.yml"
    path.write_text(yaml.safe_dump(_tiny_config(root).to_dict()))
    return str(path)


@pytest.mark.parametrize("heads", [False, True])
def test_cli_export_ptq_bundle_equals_the_live_quantized_service(tiny_yaml, tmp_path, heads):
    """`cli.export --ptq` calibrates on --calib-batches batches of --batch-size; `cli.serve
    --ptq` on 4 batches of max(--batch-size, 8): at 4 x 8 both see the same synthetic
    images, so the artifact and the live service quantize alike and answer alike."""
    from ssd_object_detection_tpu_torch.cli import export as cli_export
    from ssd_object_detection_tpu_torch.cli import serve as cli_serve

    out = str(tmp_path / "bundle.zip")
    flags = ["--ptq"] + (["--ptq-heads"] if heads else [])
    cli_export.main([tiny_yaml, "--out", out, "--device", "cpu", "--fused", "--tiers", "1,2",
                     "--canvas", "96", "96", "--score-thresh", "0.05", "--batch-size", "8",
                     "--calib-batches", "4", *flags])
    args = dict(config=tiny_yaml, weights=None, artifact=out, names="none", batch_size=2,
                batch_tiers="1,2", score_thresh=0.05, iou_thresh=0.45, device="cpu",
                ptq=True, ptq_heads=heads)
    art, art_info = cli_serve.build_artifact_service(type("Args", (), args))
    live, live_info = cli_serve.build_service(type("Args", (), args))
    assert art_info["precision"] == live_info["precision"] == "int8-ptq"
    live._canvas_hw = (96, 96)
    images = [np.random.default_rng(4).integers(0, 256, (60, 90, 3), np.uint8),
              np.random.default_rng(5).integers(0, 256, (64, 64, 3), np.uint8)]

    def unnamed(dets):  # the artifact serves without the config's class-name table
        return json.dumps([[{k: v for k, v in d.items() if k != "class_name"} for d in per]
                           for per in dets])

    got, want = art.detect_images(images), live.detect_images(images)
    assert sum(map(len, want)) > 0 and unnamed(got) == unnamed(want)
