"""Port evaluation gate (eval/coco_map.py copy, eval/runner.py, cli/eval_synthetic.py)
against the JAX package.

Tolerances: none; the evaluator is a numpy copy and the runner feeds it the same
float32 boxes, so every metric must be equal.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ssd_object_detection_tpu.eval import coco_map as jax_coco_map
from ssd_object_detection_tpu.eval.runner import evaluate_batches as jax_evaluate_batches
from ssd_object_detection_tpu.ops.nms import Detections as JaxDetections
from ssd_object_detection_tpu_torch.cli import eval as cli_eval
from ssd_object_detection_tpu_torch.cli import eval_synthetic
from ssd_object_detection_tpu_torch.eval import coco_map
from ssd_object_detection_tpu_torch.eval.runner import evaluate_batches
from ssd_object_detection_tpu_torch.models.ssd import MODEL_SPECS
from ssd_object_detection_tpu_torch.ops.nms import Detections

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _scene(rng, num_classes, n_gt, n_det):
    gt = np.concatenate([rng.uniform(20, 200, (n_gt, 2)), rng.uniform(5, 80, (n_gt, 2))], -1)
    gt_xyxy = np.concatenate([gt[:, :2], gt[:, :2] + gt[:, 2:]], -1).astype(np.float32)
    det = gt_xyxy[rng.integers(0, n_gt, n_det)] + rng.normal(0, 4, (n_det, 4)).astype(np.float32)
    return dict(
        det_boxes=det.astype(np.float32), det_scores=rng.uniform(0, 1, n_det).astype(np.float32),
        det_classes=rng.integers(0, num_classes, n_det).astype(np.int32),
        gt_boxes=gt_xyxy, gt_classes=rng.integers(0, num_classes, n_gt).astype(np.int32),
        gt_ignore=rng.uniform(size=n_gt) < 0.1,
    )


def test_coco_map_copy_agrees_with_the_original():
    rng = np.random.default_rng(0)
    port, ref = coco_map.DetectionEvaluator(num_classes=5), jax_coco_map.DetectionEvaluator(num_classes=5)
    for _ in range(6):
        scene = _scene(rng, 5, int(rng.integers(1, 9)), int(rng.integers(0, 30)))
        port.add_image(**scene)
        ref.add_image(**scene)
    got, want = port.summarize(), ref.summarize()
    assert got == want and got["mAP@0.5"] > 0


def _fake_outputs(rng, batch, k, num_classes):
    boxes = np.concatenate(
        [rng.uniform(0.2, 0.8, (batch, k, 2)), rng.uniform(0.05, 0.3, (batch, k, 2))], -1
    ).astype(np.float32)
    scores = np.sort(rng.uniform(0, 1, (batch, k)).astype(np.float32), axis=1)[:, ::-1].copy()
    valid = scores > 0.3
    classes = np.where(valid, rng.integers(0, num_classes, (batch, k)), -1).astype(np.int32)
    return boxes, np.where(valid, scores, 0).astype(np.float32), classes, valid


@pytest.mark.parametrize("orig_size", [False, True])
def test_evaluate_batches_matches_jax(orig_size):
    rng = np.random.default_rng(1)
    batches, outputs = [], []
    for _ in range(3):
        b = {"image": np.zeros((4, 32, 32, 3), np.uint8),
             "gt_boxes": _fake_outputs(rng, 4, 6, 5)[0],
             "gt_cls": rng.integers(0, 5, (4, 6)).astype(np.int32),
             "gt_valid": rng.uniform(size=(4, 6)) < 0.7}
        if orig_size:
            b["orig_size"] = np.tile(np.int32([480, 640]), (4, 1))
        batches.append(b)
        out = _fake_outputs(rng, 4, 10, 5)
        out[0][:, :6] = b["gt_boxes"] + rng.normal(0, 0.01, (4, 6, 4)).astype(np.float32)
        outputs.append(out)
    lookup = {id(b["image"]): out for b, out in zip(batches, outputs)}

    def port_predict(images):
        return Detections(*(torch.from_numpy(a) for a in lookup[id(images)]))

    def jax_predict(params, images):
        return JaxDetections(*(jnp.asarray(a) for a in lookup[id(images)]))

    got = evaluate_batches(port_predict, batches, num_classes=5)
    want = jax_evaluate_batches(jax_predict, {}, batches, num_classes=5)
    assert got == want and got["mAP@0.5"] > 0
    assert evaluate_batches(port_predict, batches, num_classes=5, max_batches=1) == \
        jax_evaluate_batches(jax_predict, {}, batches, num_classes=5, max_batches=1)


def test_evaluate_batches_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="A12"):
        evaluate_batches(lambda images: None, [], mesh=object())


def test_eval_synthetic_runs_on_cpu_at_a_tiny_budget(capsys, tmp_path):
    out = tmp_path / "result.json"
    result = eval_synthetic.main([
        "--device", "cpu", "--warmup", "1", "--steps", "1", "--batch-size", "2",
        "--num-train", "2", "--num-val", "2", "--out", str(out),
    ])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(out.read_text()) == json.loads(json.dumps(result))
    assert {"mAP", "mAP@0.5", "pass", "train_seconds", "device"} <= set(printed)
    assert printed["device"] == "cpu" and 0.0 <= printed["mAP@0.5"] <= 1.0
    assert printed["train"]["steps"] == 1 and printed["val_images"] == 2


def test_eval_synthetic_refuses_what_is_not_ported():
    """Every variant of MODEL_SPECS is ported (and --ptq, tests/test_torch_quant_cli.py);
    a name outside the registry still raises."""
    with pytest.raises(ValueError, match="unknown --variant"):
        eval_synthetic.main(["--device", "cpu", "--variant", "ssd300_vgg19"])
    assert {"ssd300_r34", "ssd512_r34", "ssd300_mnv2", "ssd512_mnv2"} <= set(MODEL_SPECS)


_TINY_BUDGET = ["--device", "cpu", "--warmup", "1", "--steps", "1", "--batch-size", "2",
                "--num-train", "2", "--num-val", "2"]


def test_eval_synthetic_save_then_load_weights(tmp_path, capsys):
    """--save-weights exports what was trained; --load-weights evaluates it without
    training and scores exactly the same."""
    weights = tmp_path / "w.msgpack"
    trained = eval_synthetic.main([*_TINY_BUDGET, "--save-weights", str(weights)])
    assert weights.exists() and "exported" in capsys.readouterr().out
    loaded = eval_synthetic.main([*_TINY_BUDGET, "--load-weights", str(weights)])
    assert "training skipped" in capsys.readouterr().out
    assert loaded["train_seconds"] == 0.0
    assert loaded["metrics"] == trained["metrics"]
    restored = serialization.msgpack_restore(weights.read_bytes())
    assert set(restored) == {"params"} and "vgg" in restored["params"]


def test_cli_eval_prints_metrics_on_cpu(tmp_path, capsys):
    weights = tmp_path / "w.msgpack"
    eval_synthetic.main([*_TINY_BUDGET, "--save-weights", str(weights)])
    capsys.readouterr()
    got = cli_eval.main([str(ROOT / "config" / "synthetic.yml"), "--weights", str(weights),
                         "--max-batches", "1", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(got))
    assert {"mAP", "mAP@0.5", "AR@100"} <= set(printed) and 0.0 <= printed["mAP@0.5"] <= 1.0


@pytest.mark.parametrize("flags", [["--ptq"], ["--data-parallel", "2"]])
def test_cli_eval_refuses_what_is_not_ported(flags, tmp_path, capsys):
    """--data-parallel (ROADMAP A12) still raises; --ptq is ported and evaluates the
    int8 path, calibrated on the val split."""
    cfg = ROOT / "config" / "synthetic.yml"
    if flags[0] == "--data-parallel":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cli_eval.main([str(cfg), "--device", "cpu", *flags])
        return
    weights = tmp_path / "w.msgpack"
    eval_synthetic.main([*_TINY_BUDGET, "--save-weights", str(weights)])
    capsys.readouterr()
    got = cli_eval.main([str(cfg), "--weights", str(weights), "--max-batches", "1",
                         "--device", "cpu", "--calib-batches", "1", *flags])
    assert 0.0 <= got["mAP@0.5"] <= 1.0


def test_eval_synthetic_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_synthetic.main(["--warmup", "0", "--steps", "0"])
