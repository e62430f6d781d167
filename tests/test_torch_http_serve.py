"""Port DetectorService, BatchingFrontEnd and HTTP server contract (eval/serve.py,
cli/serve.py), case for case as tests/test_http_serve.py holds the JAX package's."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ssd_object_detection_tpu_torch.eval.serve import (
    BatchingFrontEnd,
    DetectorService,
    export_detector,
    export_fused_detector,
    export_fused_detector_bundle,
)
from ssd_object_detection_tpu_torch.models.ssd import SSD
from ssd_object_detection_tpu_torch.ops.anchors import generate_anchors
from tests.test_torch_train_step import PORT_TINY
from tests.test_train_step import NUM_CLASSES

torch.set_num_threads(1)
NAMES = [f"class_{i}" for i in range(NUM_CLASSES - 1)]


def _model():
    return SSD(num_classes=NUM_CLASSES, spec=PORT_TINY).init_weights(torch.Generator().manual_seed(0))


def _service(**kw):
    return DetectorService(_model(), generate_anchors(PORT_TINY.anchor_spec), image_size=64,
                           batch_size=2, canvas_hw=(96, 96), **kw)


@pytest.fixture(scope="module")
def service():
    return _service(score_thresh=0.05, label_names=NAMES)


def test_detect_images_contract(service):
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (48, 96, 3), np.uint8),  # fills the canvas width
            rng.integers(0, 256, (96, 32, 3), np.uint8)]  # tall and narrow
    results = service.detect_images(imgs)
    assert len(results) == 2 and sum(len(d) for d in results) > 0
    for dets, img in zip(results, imgs):
        h, w = img.shape[:2]
        scores = [d["score"] for d in dets]
        assert scores == sorted(scores, reverse=True)
        for d in dets:
            json.dumps(d)  # JSON-serializable
            x1, y1, x2, y2 = d["box_xyxy"]
            assert 0 <= x1 <= x2 <= w and 0 <= y1 <= y2 <= h
            assert 0 <= d["class_id"] < NUM_CLASSES - 1
            assert d["class_name"] == f"class_{d['class_id']}"
            assert d["score"] >= 0.05


def test_short_batch_padding_matches_full(service):
    """A 1-image request through the batch-2 program equals that image's detections from
    a 2-image request: the padding cannot leak."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (64, 64, 3), np.uint8)
    other = rng.integers(0, 256, (48, 80, 3), np.uint8)
    assert json.dumps(service.detect_images([img])[0]) == \
        json.dumps(service.detect_images([img, other])[0])


def test_batch_tiers_match_full_pad(service):
    """Tiers 1 and 2 return what the always-full-pad service returns: the tier changes
    only how much zero padding a request carries."""
    tiered = _service(score_thresh=0.05, label_names=NAMES, batch_tiers=(1,))
    assert tiered._tiers == [1, 2]
    assert tiered._pick_tier(1) == 1 and tiered._pick_tier(2) == 2
    tiered.warm()

    def assert_close(a, b):  # batch 1 and batch 2 may sum convolutions in another order
        assert len(a) == len(b)
        for da, db in zip(a, b):
            assert da["class_id"] == db["class_id"]
            assert da["score"] == pytest.approx(db["score"], abs=1e-4)
            assert da["box_xyxy"] == pytest.approx(db["box_xyxy"], abs=1e-2)

    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (48, 96, 3), np.uint8)
    other = rng.integers(0, 256, (96, 32, 3), np.uint8)
    assert_close(tiered.detect_images([img])[0], service.detect_images([img])[0])
    assert json.dumps(tiered.detect_images([img, other])) == \
        json.dumps(service.detect_images([img, other]))  # the same batch: byte-equal

    clamped = _service(batch_tiers=(0, 7, 1))  # out-of-range tiers are ignored
    assert clamped._tiers == [1, 2]


def test_oversized_input_downscaled(service):
    """Images larger than the canvas are downscaled on the host; boxes stay in the
    original frame."""
    pytest.importorskip("cv2")
    img = np.random.default_rng(2).integers(0, 256, (192, 256, 3), np.uint8)  # 2x the canvas
    dets = service.detect_images([img])[0]
    assert dets
    for d in dets:
        x1, y1, x2, y2 = d["box_xyxy"]
        assert 0 <= x1 <= x2 <= 256 and 0 <= y1 <= y2 <= 192


def test_batch_overflow_rejected(service):
    with pytest.raises(ValueError, match="batch size"):
        service.detect_images([np.zeros((16, 16, 3), np.uint8)] * 3)


def _serve(service):
    from ssd_object_detection_tpu_torch.cli.serve import make_server

    server = make_server(service, {"model": "tiny"}, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    server.frontend.close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def test_http_round_trip(service):
    cv2 = pytest.importorskip("cv2")
    server, thread = _serve(service)
    try:
        host, port = server.server_address
        with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["model"] == "tiny"

        img = np.random.default_rng(3).integers(0, 256, (48, 64, 3), np.uint8)
        ok, buf = cv2.imencode(".png", img[..., ::-1])
        assert ok
        req = urllib.request.Request(f"http://{host}:{port}/detect", data=buf.tobytes(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            payload = json.loads(r.read())
        # PNG is lossless: the HTTP answer is the service's answer for the same pixels
        assert payload["detections"] == json.loads(json.dumps(service.detect_images([img])[0]))
        assert payload["detections"] and all(set(d) >= {"box_xyxy", "score", "class_id"}
                                             for d in payload["detections"])

        bad = urllib.request.Request(f"http://{host}:{port}/detect", data=b"not an image",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:  # malformed body -> 400, no crash
            urllib.request.urlopen(bad, timeout=30)
        assert e.value.code == 400
    finally:
        _stop(server, thread)


@pytest.mark.parametrize("name", ["pam_rgb_37x23.pam", "pam_bits_37x23.pam", "pam_16bit_37x23.pam",
                                  "bigtiff_le_8x6.tif", "bigtiff_be_8x6.tif", "tiff_cv2_37x23.tif",
                                  "tiff_planar_37x23.tif", "tiff_tiles_rgba_37x23.tif", "tiff_sgilog_logluv_37x23.tif",
                                  "tiff_sgilog24_logluv_tiles_37x23.tif", "tiff_sgilog_logl_37x23.tif",
                                  "tiff_group4_37x23.tif", "tiff_ccitt_g3_2d_37x23.tif", "tiff_thunderscan_37x23.tif",
                                  "tiff_lzw_old_gray_37x23.tif",
                                  "tiff_jpeg_strips_420_67x45.tif", "tiff_jpeg_pil_ycbcr_37x23.tif",
                                  "tiff_invalid_lzma_37x23.tif", "tiff_ycbcr22_lzw_37x23.tif",
                                  "tiff_pil_lab_jpeg_37x23.tif", "tiff_jpeg_pil_cmyk_37x23.tif",
                                  "tiff_refused_ycbcr44_odd_units_33x17.tif"])
def test_http_pam_and_tiff_answered_or_refused(service, name):
    """A PAM, TIFF (CCITT, ThunderScan and old-style LZW among them), JPEG-in-TIFF or
    BigTIFF body is answered with 200 and the detections the service gives the pixels cv2
    decodes from it (the JAX package's decode_image_bytes, which returns detections for
    it), SGILog and uncompressed 4-sample tiles among them; a YCbCr TIFF of 4 x 4 units
    that are no whole number of scanlines, which cv2 reads and the port refuses, gets 415
    naming it; an LZMA TIFF, which cv2 returns None for (the JAX service answers 400),
    gets 400."""
    pytest.importorskip("cv2")
    import os

    from ssd_object_detection_tpu.eval.serve import decode_image_bytes as jax_decode
    from ssd_object_detection_tpu_torch.tools.make_image_fixtures import FIXTURES, INVALID, REFUSED

    data = open(os.path.join(FIXTURES, name), "rb").read()
    server, thread = _serve(service)
    try:
        host, port = server.server_address
        req = urllib.request.Request(f"http://{host}:{port}/detect", data=data, method="POST")
        if name in REFUSED or name in INVALID:
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=30)
            error = json.loads(e.value.read())["error"]
            if name in REFUSED:
                assert e.value.code == 415 and REFUSED[name] in error
            else:
                assert e.value.code == 400
                with pytest.raises(ValueError):
                    jax_decode(data)
            return
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            payload = json.loads(r.read())
        assert payload["detections"] == json.loads(json.dumps(service.detect_images([jax_decode(data)])[0]))
    finally:
        _stop(server, thread)

def test_http_jpeg_round_trip_without_cv2(service):
    """The server process cannot import cv2: a JPEG body and a PNG body are answered as
    the service answers the pixels cv2 decodes from them (the JAX package's
    decode_image_bytes), the JPEG over the canvas fitted on the way, and so are a
    progressive, a CMYK, a smoothed progressive and corrupt JPEG bodies, a BMP, a PPM, a
    Sun raster and a PFM body; what is still refused (AVIF, a 1-channel PFM) gets 415
    naming it, bytes that are no image 400."""
    import os
    import subprocess
    import sys

    from ssd_object_detection_tpu.eval.serve import decode_image_bytes as jax_decode
    from ssd_object_detection_tpu_torch.tools.make_image_fixtures import FIXTURES, REFUSED

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "sys.modules['cv2'] = None\n"
            "from tests.test_torch_http_serve import _service, NAMES\n"
            "from ssd_object_detection_tpu_torch.cli.serve import make_server\n"
            "server = make_server(_service(score_thresh=0.05, label_names=NAMES), {'model': 'tiny'}, port=0)\n"
            "print(server.server_address[1], flush=True)\n"
            "server.serve_forever()\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=dict(os.environ, PYTHONPATH=root))
    try:
        port = int(proc.stdout.readline())
        url = f"http://127.0.0.1:{port}/detect"
        for name in ("coco_500x333_444.jpg", "coco_480x640_exif6.jpg", "png_adam7_83x61.png",
                     "coco_640x480_progressive.jpg", "cmyk_83x61.jpg", "progressive_incomplete_83x61.jpg",
                     "corrupt_cut_eoi_500x333.jpg", "corrupt_ff00_run_500x333.jpg", "bmp_rle4_37x23.bmp",
                     "pxm_p6_16bit_37x23.ppm", "ras_32_37x23.ras", "pfm_rgb_37x23.pfm"):
            data = open(os.path.join(FIXTURES, name), "rb").read()
            with urllib.request.urlopen(urllib.request.Request(url, data=data, method="POST"), timeout=120) as r:
                payload = json.loads(r.read())
            want = service.detect_images([jax_decode(data)])[0]
            assert payload["detections"] == json.loads(json.dumps(want)), name
        refused = [(open(os.path.join(FIXTURES, n), "rb").read(), 415, text) for n, text in REFUSED.items()]
        for body, code_, text in refused + [(b"not an image", 400, "decode")]:
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"), timeout=30)
            assert e.value.code == code_ and text in json.loads(e.value.read())["error"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)


@pytest.mark.parametrize("method,path", [("GET", "/detect"), ("GET", "/"), ("POST", "/healthz"),
                                         ("POST", "/other")])
def test_http_unknown_routes_are_404(service, method, path):
    server, thread = _serve(service)
    try:
        host, port = server.server_address
        req = urllib.request.Request(f"http://{host}:{port}{path}", method=method,
                                     data=b"x" if method == "POST" else None)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 404 and "error" in json.loads(e.value.read())
    finally:
        _stop(server, thread)


def test_http_empty_body_is_400(service):
    server, thread = _serve(service)
    try:
        host, port = server.server_address
        req = urllib.request.Request(f"http://{host}:{port}/detect", data=b"", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400
    finally:
        _stop(server, thread)


def test_batching_frontend_coalesces_and_matches(service):
    """Concurrent submits return exactly what a direct detect_images returns, and
    concurrent requests share dispatches rather than one device call each."""
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, (64, 64, 3), np.uint8) for _ in range(4)]
    want = [service.detect_images([im])[0] for im in imgs]

    calls = []
    orig = service.detect_images

    def counting(images):
        calls.append(len(images))
        return orig(images)

    fe = BatchingFrontEnd(service, max_wait_ms=200.0)
    service.detect_images = counting
    try:
        results = [None] * 4
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, fe.submit(imgs[i])))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        service.detect_images = orig
        fe.close()

    for got, exp in zip(results, want):
        assert json.dumps(got) == json.dumps(exp)
    # 4 requests through a batch-2 service with a wide window: at most 3 dispatches (the
    # first may fire alone), and at least one carried 2 coalesced requests
    assert sum(calls) == 4 and len(calls) <= 3
    assert max(calls) == 2, calls


def test_batching_frontend_propagates_errors(service):
    fe = BatchingFrontEnd(service, max_wait_ms=1.0)
    try:
        with pytest.raises(Exception):
            fe.submit(np.zeros((2, 2), np.uint8))  # 2-D input: pack_canvas raises
        assert isinstance(fe.submit(np.zeros((16, 16, 3), np.uint8)), list)  # still serving
    finally:
        fe.close()


def test_artifact_service_round_trip(service):
    """export_fused_detector -> from_artifact serves what the live service serves."""
    blob = export_fused_detector(_model(), generate_anchors(PORT_TINY.anchor_spec), batch_size=2,
                                 image_size=64, canvas_hw=(96, 96), score_thresh=0.05)
    art = DetectorService.from_artifact(blob, label_names=NAMES, device="cpu")
    assert art._batch_size == 2 and art._canvas_hw == (96, 96)
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (48, 96, 3), np.uint8), rng.integers(0, 256, (96, 32, 3), np.uint8)]
    assert json.dumps(service.detect_images(imgs)) == json.dumps(art.detect_images(imgs))

    plain = export_detector(_model(), generate_anchors(PORT_TINY.anchor_spec), batch_size=1,
                            image_size=64)
    with pytest.raises(ValueError, match="fused"):
        DetectorService.from_artifact(plain, device="cpu")


def test_artifact_bundle_multi_tier(service):
    """A bundle recovers every tier and dispatches each request at the smallest one that
    fits; a lone submit with a huge window returns at once (tier-1 early dispatch)."""
    blob = export_fused_detector_bundle(_model(), generate_anchors(PORT_TINY.anchor_spec),
                                        batch_tiers=(1, 2), image_size=64, canvas_hw=(96, 96),
                                        score_thresh=0.05)
    assert blob[:4] == b"PK\x03\x04"  # a plain zip
    art = DetectorService.from_artifact(blob, label_names=NAMES, device="cpu")
    assert art._tiers == [1, 2] and art._batch_size == 2 and art._canvas_hw == (96, 96)

    rng = np.random.default_rng(6)
    imgs = [rng.integers(0, 256, (48, 96, 3), np.uint8), rng.integers(0, 256, (96, 32, 3), np.uint8)]
    live1 = service.detect_images(imgs[:1])  # the live program at batch 2
    got1 = art.detect_images(imgs[:1])  # the tier-1 program
    assert len(got1) == 1 and len(got1[0]) == len(live1[0])
    for a, b in zip(got1[0], live1[0]):
        assert a["class_id"] == b["class_id"]
        np.testing.assert_allclose(a["score"], b["score"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a["box_xyxy"], b["box_xyxy"], rtol=1e-3, atol=5e-2)
    assert json.dumps(art.detect_images(imgs)) == json.dumps(service.detect_images(imgs))

    fe = BatchingFrontEnd(art, max_wait_ms=5000.0)
    try:
        t0 = time.monotonic()
        assert isinstance(fe.submit(imgs[0]), list)
        assert time.monotonic() - t0 < 4.0, "tier-1 early dispatch did not fire"
    finally:
        fe.close()
