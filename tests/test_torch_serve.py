"""Port serving (eval/serve.py, cli/serve.py, cli/export.py, cli/infer.py) on the CPU.

Mirrors tests/test_serve.py (its int8 PTQ case is in tests/test_torch_quant_serve.py) and
holds the port's DetectorService to the JAX package's on the same weights. Tolerances: against
JAX, detection counts and class ids equal, scores and pixel boxes within rtol 2e-4 /
atol 2e-5 (the forward tolerance of tests/test_torch_predict.py); an exported program
against the live path it was exported from, bit-equal.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from ssd_object_detection_tpu.eval.serve import DetectorService as JaxDetectorService
from ssd_object_detection_tpu_torch.eval.predict import make_fused_predict_fn, make_predict_fn
from ssd_object_detection_tpu_torch.eval.serve import (
    DetectorService,
    artifact_precision,
    export_detector,
    export_fused_detector,
    export_fused_detector_bundle,
    load_detector,
)
from ssd_object_detection_tpu_torch.ops.preprocess import pack_canvas
from tests.test_torch_predict import tiny_pair  # noqa: F401  (a fixture)
from tests.test_torch_trainer import _tiny_config

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_detections_equal(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_export_reload_matches_live_predict(tiny_pair):
    _, _, port, anchors = tiny_pair
    blob = export_detector(port, anchors, batch_size=2, image_size=64, score_thresh=0.05)
    assert isinstance(blob, bytes) and len(blob) > 1000
    detect = load_detector(blob, device="cpu")
    images = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    served = detect(images)
    live = make_predict_fn(port, anchors, score_thresh=0.05)(images)
    assert int(live.valid.sum()) > 0
    _assert_detections_equal(served, live)


def test_fused_export_reload_matches_live_fused_predict(tiny_pair):
    _, _, port, anchors = tiny_pair
    blob = export_fused_detector(port, anchors, batch_size=2, image_size=64, canvas_hw=(96, 96),
                                 score_thresh=0.05)
    detect = load_detector(blob, device="cpu")
    rng = np.random.default_rng(1)
    canvas, sizes = pack_canvas([rng.integers(0, 256, (80, 96, 3), np.uint8),
                                 rng.integers(0, 256, (64, 64, 3), np.uint8)], (96, 96))
    canvas, sizes = torch.from_numpy(canvas), torch.from_numpy(sizes)
    live = make_fused_predict_fn(port, anchors, image_size=64, score_thresh=0.05)(canvas, sizes)
    assert int(live.valid.sum()) > 0
    _assert_detections_equal(detect(canvas, sizes), live)


@pytest.mark.parametrize("n_images", [1, 3])
def test_detector_service_matches_jax(tiny_pair, n_images):
    """The same weights through both services, at a tier and at the full batch."""
    model, params, port, anchors = tiny_pair
    kw = dict(image_size=64, batch_size=3, canvas_hw=(96, 96), score_thresh=0.1,
              batch_tiers=(1,), label_names=[f"class_{i}" for i in range(8)])
    want_service = JaxDetectorService(model.apply, jax.tree.map(np.asarray, params), anchors, **kw)
    got_service = DetectorService(port, anchors, **kw)
    rng = np.random.default_rng(2)
    images = [rng.integers(0, 256, hw + (3,), np.uint8) for hw in ((80, 96), (64, 64), (33, 90))]
    want = want_service.detect_images(images[:n_images])
    got = got_service.detect_images(images[:n_images])
    assert sum(len(d) for d in got) > 3
    for g_dets, w_dets in zip(got, want):
        assert len(g_dets) == len(w_dets)
        g_dets = sorted(g_dets, key=lambda d: (d["class_id"], -d["score"]))
        w_dets = sorted(w_dets, key=lambda d: (d["class_id"], -d["score"]))
        assert [d["class_id"] for d in g_dets] == [d["class_id"] for d in w_dets]
        assert [d["class_name"] for d in g_dets] == [d["class_name"] for d in w_dets]
        np.testing.assert_allclose([d["score"] for d in g_dets], [d["score"] for d in w_dets],
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose([d["box_xyxy"] for d in g_dets], [d["box_xyxy"] for d in w_dets],
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("bundle", [False, True])
def test_artifact_is_bit_equal_to_the_live_service_at_each_tier(tiny_pair, bundle):
    _, _, port, anchors = tiny_pair
    kw = dict(image_size=64, canvas_hw=(96, 96), score_thresh=0.05)
    if bundle:
        blob = export_fused_detector_bundle(port, anchors, batch_tiers=(2, 1), **kw)
        tiers = [1, 2]
    else:
        blob = export_fused_detector(port, anchors, batch_size=2, **kw)
        tiers = [2]
    art = DetectorService.from_artifact(blob, device="cpu")
    assert art._tiers == tiers and art._canvas_hw == (96, 96)
    live = DetectorService(port, anchors, batch_size=2, batch_tiers=tiers, **kw)
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (48, 96, 3), np.uint8), rng.integers(0, 256, (96, 32, 3), np.uint8)]
    for n in (1, 2):
        assert art._pick_tier(n) == live._pick_tier(n)
        assert json.dumps(art.detect_images(images[:n])) == json.dumps(live.detect_images(images[:n]))


def test_artifact_refuses_another_device(tiny_pair, monkeypatch):
    """An artifact runs only on the device it was exported on; asking for another names both."""
    _, _, port, anchors = tiny_pair
    single = export_fused_detector(port, anchors, batch_size=1, image_size=64, canvas_hw=(96, 96))
    bundle = export_fused_detector_bundle(port, anchors, batch_tiers=(1,), image_size=64,
                                          canvas_hw=(96, 96))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for blob in (single, bundle):
        with pytest.raises(ValueError, match="exported on cpu .* asked to run on cuda"):
            DetectorService.from_artifact(blob, device="cuda")
    with pytest.raises(ValueError, match="exported on cpu"):
        load_detector(single, device="cuda")


def test_artifact_service_rejects_other_blobs(tiny_pair):
    _, _, port, anchors = tiny_pair
    plain = export_detector(port, anchors, batch_size=1, image_size=64)
    with pytest.raises(ValueError, match="fused"):
        DetectorService.from_artifact(plain, device="cpu")
    with pytest.raises(Exception):
        DetectorService.from_artifact(b"not an artifact", device="cpu")


def test_decode_image_bytes_without_cv2_names_it():
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None\n"
        "from ssd_object_detection_tpu_torch.eval import serve\n"
        "import numpy as np\n"
        "for call in (lambda: serve.decode_image_bytes(b'x'),\n"
        "             lambda: serve.DetectorService._fit_canvas(  # an image over the canvas\n"
        "                 type('S', (), {'_canvas_hw': (8, 8)})(), np.zeros((16, 16, 3), np.uint8))):\n"
        "    try:\n"
        "        call()\n"
        "    except ModuleNotFoundError as e:\n"
        "        assert e.name == 'cv2' and 'cv2' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('no error without cv2')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=ROOT), timeout=120)
    assert proc.returncode == 0, proc.stderr


# --- the CLIs ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_yaml(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    path = root / "tiny.yml"
    path.write_text(yaml.safe_dump(_tiny_config(root).to_dict()))
    return str(path)


def test_cli_export_bundle_serves_what_the_live_service_serves(tiny_yaml, tmp_path):
    from ssd_object_detection_tpu_torch.cli import export as cli_export
    from ssd_object_detection_tpu_torch.cli import serve as cli_serve

    out = str(tmp_path / "bundle.zip")
    cli_export.main([tiny_yaml, "--out", out, "--device", "cpu", "--fused", "--tiers", "1,2",
                     "--canvas", "96", "96", "--score-thresh", "0.05"])
    args = dict(config=tiny_yaml, weights=None, artifact=out, names="none", batch_size=2,
                batch_tiers="1,2", score_thresh=0.05, iou_thresh=0.45, device="cpu",
                ptq=False, ptq_heads=False)
    art, info = cli_serve.build_artifact_service(type("Args", (), args))
    assert info["batch_tiers"] == [1, 2] and info["device"] == "cpu"
    live, live_info = cli_serve.build_service(type("Args", (), args))
    assert live_info["model"] == "tiny-test-torch"
    live._canvas_hw = (96, 96)  # the CLI serves the default 640 canvas; the bundle holds 96
    images = [np.random.default_rng(4).integers(0, 256, (60, 90, 3), np.uint8)]
    got, want = art.detect_images(images), live.detect_images(images)
    assert [d["class_id"] for d in got[0]] == [d["class_id"] for d in want[0]]
    assert json.dumps([[d["score"] for d in g] for g in got]) == \
        json.dumps([[d["score"] for d in w] for w in want])


def test_cli_export_single_artifact_loads(tiny_yaml, tmp_path):
    from ssd_object_detection_tpu_torch.cli import export as cli_export

    out = str(tmp_path / "detector.pt2")
    cli_export.main([tiny_yaml, "--out", out, "--device", "cpu", "--batch-size", "2"])
    with open(out, "rb") as f:
        detect = load_detector(f.read(), device="cpu")
    det = detect(torch.zeros(2, 64, 64, 3))
    assert det.boxes.shape == (2, 100, 4) and det.valid.dtype == torch.bool


def test_cli_infer_writes_annotated_images(tiny_yaml, tmp_path, capsys):
    cv2 = pytest.importorskip("cv2")
    from ssd_object_detection_tpu_torch.cli import infer as cli_infer

    rng = np.random.default_rng(5)
    paths = []
    for i, hw in enumerate(((50, 70), (64, 64))):
        path = str(tmp_path / f"img{i}.jpg")
        cv2.imwrite(path, rng.integers(0, 256, hw + (3,), np.uint8))
        paths.append(path)
    results = cli_infer.main([tiny_yaml, "--images", *paths, "--out-dir", str(tmp_path / "out"),
                              "--device", "cpu", "--score-thresh", "0.05"])
    assert json.loads(capsys.readouterr().out) == results
    for path, res in zip(paths, results):
        drawn = cv2.imread(res["output"])
        assert drawn is not None and drawn.shape[:2] == cv2.imread(path).shape[:2]
        assert res["num_detections"] == len(res["detections"]) > 0


@pytest.mark.parametrize("cli,extra", [("serve", []), ("export", ["--out", "x.pt2"]),
                                       ("infer", ["--images", "a.jpg"])])
@pytest.mark.parametrize("flag", ["--ptq", "--ptq-heads"])
def test_cli_ptq_flags_raise(tiny_yaml, cli, extra, flag, tmp_path, monkeypatch):
    """The PTQ flags no longer raise: `--ptq` runs each CLI through the int8 path (the
    artifact and the service say "int8-ptq"), and `--ptq-heads` alone, as in the JAX
    tools, changes nothing (float)."""
    import importlib

    module = importlib.import_module(f"ssd_object_detection_tpu_torch.cli.{cli}")
    quantizing = flag == "--ptq"
    calls = []
    real = module.quantize_for_serving
    monkeypatch.setattr(module, "quantize_for_serving",
                        lambda model, calib, heads: calls.append(heads) or real(model, calib, heads))
    monkeypatch.chdir(tmp_path)
    if cli == "serve":
        args = dict(config=tiny_yaml, weights=None, batch_size=2, batch_tiers="1,2",
                    score_thresh=0.05, iou_thresh=0.45, device="cpu", ptq=quantizing,
                    ptq_heads=not quantizing)
        _, info = module.build_service(type("Args", (), args))
        assert info["precision"] == ("int8-ptq" if quantizing else "float32")
    elif cli == "export":
        module.main([tiny_yaml, "--device", "cpu", flag, "--calib-batches", "1", *extra])
        with open("x.pt2", "rb") as f:
            precision = artifact_precision(f.read())
        assert precision == ("int8-ptq" if quantizing else "float32")
    else:
        cv2 = pytest.importorskip("cv2")
        cv2.imwrite("a.jpg", np.random.default_rng(6).integers(0, 256, (40, 50, 3), np.uint8))
        results = module.main([tiny_yaml, "--device", "cpu", flag, *extra, "--out-dir", "out",
                               "--score-thresh", "0.05"])
        assert results[0]["image"] == "a.jpg"
    assert calls == ([False] if quantizing else [])
