"""Serving: export the detect path as a portable artifact, and the request-level service
and batching front end over it. Port of ssd_object_detection_tpu/eval/serve.py.

The artifact is a `torch.export` program (`.pt2` bytes from `torch.export.save`) for one
fixed batch and input shape, with the params in it: a serving process needs torch and
the artifact bytes, not the model-building code or a weights file. The program is
exported on the device the model sits on and runs only there; the device is recorded in
the artifact, and loading it for another device raises. A bundle is a zip of one
`tier_XXXX.pt2` per batch tier and a `meta.json` (format, tiers, canvas, image size,
device), so an artifact service can dispatch each request at the smallest tier that
fits, as the live service does. The meta records the model's precision: "int8-ptq" for
a model from ops/quant.py::quantize_model, whose convs export as the
`ssd_torch::int8_conv` operator (importing this module registers it, so a quantized
artifact loads), else the compute dtype.

Host work per request is image decode (cv2, which only `decode_image_bytes` and the
downscale of an oversized image need) and canvas packing; the resize, normalization,
forward, decode and NMS run on the device as one program, and the four detection
tensors come back in one device-to-host copy.
"""

from __future__ import annotations

import io
import json
import logging
import queue
import threading
import time
import zipfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ssd_object_detection_tpu_torch.eval.predict import (
    Detector,
    FusedDetector,
    make_fused_predict_fn,
)
from ssd_object_detection_tpu_torch.eval.runner import _fetch_detections
from ssd_object_detection_tpu_torch.ops.nms import Detections
from ssd_object_detection_tpu_torch.ops.preprocess import pack_canvas
from ssd_object_detection_tpu_torch.ops.quant import quantized_convs  # registers the int8 op
from ssd_object_detection_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

ARTIFACT_FORMAT = "ssd_object_detection_tpu_torch.detector.v1"
BUNDLE_FORMAT = "ssd_object_detection_tpu_torch.fused_detector_bundle.v1"
_META = "meta.json"


def require_cv2():
    """The cv2 module, or a ModuleNotFoundError that names it."""
    try:
        import cv2
    except ImportError as e:
        raise ModuleNotFoundError(
            "cv2 (opencv-python) is needed to decode image bytes and to downscale images "
            "larger than the canvas, and is not installed; serve uint8 arrays that fit the "
            "canvas", name="cv2",
        ) from e
    return cv2


def model_precision(model: nn.Module) -> str:
    """"int8-ptq" when any conv of `model` runs int8, else its compute dtype's name."""
    if quantized_convs(model):
        return "int8-ptq"
    return str(getattr(model, "dtype", torch.float32)).removeprefix("torch.")


def _save(module: nn.Module, example: Tuple[torch.Tensor, ...], device: torch.device) -> bytes:
    """torch.export `module` at the shapes of `example`, on `device`, to .pt2 bytes."""
    with torch.no_grad():
        program = torch.export.export(module, example)
    program.example_inputs = None  # the artifact carries the weights, not a sample batch
    buf = io.BytesIO()
    meta = {"format": ARTIFACT_FORMAT, "device": str(device),
            "precision": model_precision(module.model)}
    torch.export.save(program, buf, extra_files={_META: json.dumps(meta)})
    return buf.getvalue()


def _model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def export_detector(
    model: nn.Module,
    anchors,
    batch_size: int,
    image_size: int,
    variances: Optional[Tuple[float, float]] = None,
    **nms_kwargs,
) -> bytes:
    """Serialize predict(images01) for a fixed batch and image size: the program takes
    (B, S, S, 3) float32 [0, 1] images on the model's device. Extra keywords (score_thresh,
    iou_thresh, ...) reach detect_from_logits, whose defaults hold otherwise."""
    device = _model_device(model)
    detector = Detector(model, anchors, dict(variances=variances, **nms_kwargs))
    spec = torch.zeros((batch_size, image_size, image_size, 3), dtype=torch.float32, device=device)
    blob = _save(detector, (spec,), device)
    logger.info("exported detector: %d bytes, device %s", len(blob), device)
    return blob


def export_fused_detector(
    model: nn.Module,
    anchors,
    batch_size: int,
    image_size: int,
    canvas_hw: Tuple[int, int] = (640, 640),
    variances: Optional[Tuple[float, float]] = None,
    resize_method: str = "matmul",
    **nms_kwargs,
) -> bytes:
    """Serialize the fused serving contract: the program takes a planar uint8 canvas
    (B, 3, Hc, Wc) and per-image (h, w) sizes (B, 2) int32 and runs resize ->
    normalize -> forward -> decode -> NMS. Extra keywords reach detect_from_logits."""
    device = _model_device(model)
    detector = FusedDetector(model, anchors, image_size, resize_method,
                             dict(variances=variances, **nms_kwargs))
    hc, wc = canvas_hw
    canvas = torch.zeros((batch_size, 3, hc, wc), dtype=torch.uint8, device=device)
    sizes = torch.tensor([[hc, wc]] * batch_size, dtype=torch.int32, device=device)
    blob = _save(detector, (canvas, sizes), device)
    logger.info("exported fused detector: %d bytes, device %s", len(blob), device)
    return blob


def _check_device(recorded: str, device: torch.device) -> None:
    have = torch.device(recorded)
    if have.type != device.type or (have.index is not None and device.index is not None
                                    and have.index != device.index):
        raise ValueError(f"the artifact was exported on {have} and runs only there; "
                         f"it was asked to run on {device}")


def _artifact_meta(blob: bytes) -> Dict:
    """The meta.json that _save wrote into a .pt2 archive (read without loading it)."""
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        names = [n for n in zf.namelist() if n.endswith(f"/extra/{_META}")]
        meta = json.loads(zf.read(names[0])) if names else {}
    if meta.get("format") != ARTIFACT_FORMAT:
        raise ValueError(f"not a detector artifact of this package (format {meta.get('format')!r})")
    return meta


def _load_program(blob: bytes, device: torch.device):
    _check_device(_artifact_meta(blob)["device"], device)
    return torch.export.load(io.BytesIO(blob))  # ssd_torch::int8_conv is registered above


def artifact_precision(blob: bytes) -> str:
    """The precision recorded in an artifact or bundle ("int8-ptq", "bfloat16", ...)."""
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        if _META in zf.namelist():
            return json.loads(zf.read(_META))["precision"]
    return _artifact_meta(blob)["precision"]


def _user_inputs(program) -> List:
    """The (shape, dtype) fake tensors of the program's user inputs, in order."""
    names = set(program.graph_signature.user_inputs)
    return [n.meta["val"] for n in program.graph.nodes if n.op == "placeholder" and n.name in names]


def _runner(program) -> Callable[..., Detections]:
    module = program.module()

    @torch.inference_mode()
    def run(*args) -> Detections:
        return Detections(*module(*args))

    return run


def load_detector(blob: bytes, device: str | torch.device = "cuda") -> Callable[..., Detections]:
    """Load an exported detector for `device`: detect(images01) or, for fused
    artifacts, detect(canvas_u8, sizes) -> Detections, on tensors on that device."""
    return _runner(_load_program(blob, resolve_device(device)))


def export_fused_detector_bundle(
    model: nn.Module,
    anchors,
    batch_tiers: Sequence[int],
    image_size: int,
    canvas_hw: Tuple[int, int] = (640, 640),
    variances: Optional[Tuple[float, float]] = None,
    **kwargs,
) -> bytes:
    """The fused serving contract at several batch sizes in one deployable blob: a zip of
    one export_fused_detector artifact per tier plus meta.json.
    DetectorService.from_artifact dispatches each request at the smallest bundled tier
    that fits, so a lone request uploads one canvas, not a full batch of them."""
    tiers = sorted({int(t) for t in batch_tiers})
    if not tiers or tiers[0] < 1:
        raise ValueError(f"batch_tiers must be positive ints, got {batch_tiers!r}")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
        for t in tiers:
            zf.writestr(f"tier_{t:04d}.pt2", export_fused_detector(
                model, anchors, batch_size=t, image_size=image_size, canvas_hw=canvas_hw,
                variances=variances, **kwargs))
        zf.writestr(_META, json.dumps({
            "format": BUNDLE_FORMAT, "tiers": tiers, "canvas_hw": list(canvas_hw),
            "image_size": image_size, "device": str(_model_device(model)),
            "precision": model_precision(model),
        }))
    out = buf.getvalue()
    logger.info("exported fused detector bundle: tiers=%s, %d bytes", tiers, len(out))
    return out


def _bundle_tiers(blob: bytes, device: torch.device) -> Optional[List[bytes]]:
    """The tier artifacts of a bundle, or None when `blob` is a single artifact."""
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        if _META not in zf.namelist():
            return None
        meta = json.loads(zf.read(_META))
        if meta.get("format") != BUNDLE_FORMAT:
            raise ValueError(f"unknown bundle format {meta.get('format')!r}")
        _check_device(meta["device"], device)
        names = sorted(n for n in zf.namelist() if n.endswith(".pt2"))
        if not names:
            raise ValueError("bundle zip contains no .pt2 tier entries")
        return [zf.read(n) for n in names]


class DetectorService:
    """Request-oriented wrapper over the fused predict path: raw RGB images in,
    JSON-ready detection dicts out (pixel boxes in the original image's frame).

    The model must already sit on its device: its params are placed there once, and
    every request runs the fused program there. Images land on a shared uint8 canvas
    (ops/preprocess.pack_canvas); a request of n images runs at the smallest batch tier
    that holds n, padded with zero images whose detections are sliced off. The four
    detection tensors come back in one device-to-host copy.

    Oversized inputs (larger than the canvas) are downscaled on the host keeping their
    aspect (cv2); boxes are reported in the original frame either way, because the
    model's boxes are relative.

    Determinism: with batch tiers, one image can run through programs of different
    batch sizes depending on concurrent load, so scores and boxes may differ at
    float-rounding level between calls. Serve one tier if bitwise stability across load
    levels matters.
    """

    def __init__(
        self,
        model: nn.Module,
        anchors,
        image_size: int,
        batch_size: int = 1,
        canvas_hw: Tuple[int, int] = (640, 640),
        variances: Optional[Tuple[float, float]] = None,
        score_thresh: float = 0.3,
        iou_thresh: float = 0.45,
        label_names: Optional[list] = None,
        batch_tiers: Optional[Sequence[int]] = None,
        **nms_kwargs,
    ):
        self._batch_size = int(batch_size)
        tiers = {self._batch_size}
        for t in batch_tiers or ():
            if 1 <= int(t) <= self._batch_size:
                tiers.add(int(t))
        self._tiers = sorted(tiers)
        self._canvas_hw = tuple(canvas_hw)
        self._label_names = label_names
        self._predict = make_fused_predict_fn(
            model, anchors, image_size=image_size, variances=variances,
            score_thresh=score_thresh, iou_thresh=iou_thresh, **nms_kwargs,
        )

    @classmethod
    def from_artifact(cls, blob: bytes, label_names: Optional[list] = None,
                      device: str | torch.device = "cuda") -> "DetectorService":
        """A service around an exported fused artifact: one export_fused_detector blob
        (one batch shape) or an export_fused_detector_bundle zip (one per tier). Params,
        NMS knobs, batch sizes and canvas are baked in; the batch and canvas of each
        program come from its input specs. Raises when the artifact was exported on
        another device than `device`."""
        device = resolve_device(device)
        blobs = _bundle_tiers(blob, device) or [blob]
        calls: Dict[int, Callable[..., Detections]] = {}
        canvas_hw = None
        for b in blobs:
            program = _load_program(b, device)
            inputs = _user_inputs(program)
            if len(inputs) != 2 or inputs[0].dtype != torch.uint8 or inputs[0].dim() != 4:
                raise ValueError(
                    "not a fused detector artifact: expected (canvas uint8 (B,3,H,W), sizes "
                    f"int32 (B,2)) inputs, got {[(tuple(x.shape), x.dtype) for x in inputs]}")
            batch, _, hc, wc = (int(d) for d in inputs[0].shape)
            if canvas_hw is not None and canvas_hw != (hc, wc):
                raise ValueError(f"bundle tiers disagree on canvas: {canvas_hw} vs {(hc, wc)}")
            canvas_hw = (hc, wc)
            calls[batch] = _runner(program)
        self = cls.__new__(cls)
        self._tiers = sorted(calls)
        self._batch_size = self._tiers[-1]
        self._canvas_hw = canvas_hw
        self._label_names = label_names

        def predict(canvas, sizes) -> Detections:
            return calls[canvas.shape[0]](canvas.to(device), sizes.to(device))

        self._predict = predict
        return self

    def _pick_tier(self, n: int) -> int:
        """Smallest batch tier that fits n images (n <= batch_size)."""
        return next(t for t in self._tiers if t >= n)

    def warm(self) -> None:
        """Run every batch tier once ahead of traffic."""
        for t in self._tiers:
            self.detect_images([np.zeros((8, 8, 3), np.uint8)] * t)

    def _fit_canvas(self, img: np.ndarray) -> np.ndarray:
        """Aspect-preserving host downscale of an image larger than the canvas."""
        hc, wc = self._canvas_hw
        h, w = img.shape[:2]
        if h <= hc and w <= wc:
            return img
        cv2 = require_cv2()
        scale = min(hc / h, wc / w)
        return cv2.resize(img, (max(1, int(w * scale)), max(1, int(h * scale))),
                          interpolation=cv2.INTER_AREA)

    def detect_images(self, images: Sequence[np.ndarray]) -> List[List[dict]]:
        """list of HWC uint8 RGB arrays (len <= batch_size) -> per-image lists of
        {"box_xyxy": [x1, y1, x2, y2] float pixels, "score": float, "class_id": int
        [, "class_name": str]} sorted by descending score."""
        if not len(images):
            return []
        if len(images) > self._batch_size:
            raise ValueError(f"{len(images)} images exceed the compiled batch size "
                             f"{self._batch_size}; split the request")
        orig_hw = [img.shape[:2] for img in images]
        fitted = [self._fit_canvas(img) for img in images]
        fitted += [np.zeros((8, 8, 3), np.uint8)] * (self._pick_tier(len(fitted)) - len(fitted))
        canvas, sizes = pack_canvas(fitted, self._canvas_hw)
        det = self._predict(torch.from_numpy(canvas), torch.from_numpy(sizes))
        boxes, scores, classes, valid = _fetch_detections(det)  # (B, K, 4) relative cxcywh

        results = []
        for i, (h, w) in enumerate(orig_hw):
            keep = valid[i]
            cx, cy, bw, bh = (boxes[i, keep, j] for j in range(4))
            x1 = np.clip((cx - bw / 2) * w, 0, w)
            y1 = np.clip((cy - bh / 2) * h, 0, h)
            x2 = np.clip((cx + bw / 2) * w, 0, w)
            y2 = np.clip((cy + bh / 2) * h, 0, h)
            kept_scores, kept_classes = scores[i, keep], classes[i, keep]
            dets = []
            for k in range(int(keep.sum())):
                d = {"box_xyxy": [float(x1[k]), float(y1[k]), float(x2[k]), float(y2[k])],
                     "score": float(kept_scores[k]), "class_id": int(kept_classes[k])}
                if self._label_names:
                    d["class_name"] = self._label_names[d["class_id"]]
                dets.append(d)
            dets.sort(key=lambda d: -d["score"])
            results.append(dets)
        return results

    def detect_encoded(self, data: bytes) -> List[dict]:
        """One JPEG/PNG request body -> detection list (see detect_images)."""
        return self.detect_images([decode_image_bytes(data)])[0]


def decode_image_bytes(data: bytes) -> np.ndarray:
    """JPEG/PNG bytes -> HWC uint8 RGB array, or ValueError. Needs cv2."""
    cv2 = require_cv2()
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("could not decode image bytes")
    return img[..., ::-1]  # BGR -> RGB


class BatchingFrontEnd:
    """Request coalescer in front of a DetectorService: concurrent callers block in
    submit(); one dispatcher thread drains up to `batch_size` queued images (waiting at
    most `max_wait_ms` after the first) and runs them as one batch. The service pads
    short batches, so a lone request still costs one dispatch; coalescing amortizes
    concurrency and never delays past max_wait_ms. Once the pending images exactly fill
    a batch tier and the queue is empty, it dispatches at once."""

    def __init__(self, service: DetectorService, max_wait_ms: float = 4.0):
        self._service = service
        self._max_wait = max_wait_ms / 1000.0
        self._tier_set = frozenset(service._tiers)
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, image: np.ndarray) -> List[dict]:
        """HWC uint8 RGB array -> detection list; blocks until the batch holding this
        request completes. Raises whatever detect_images raised."""
        done = threading.Event()
        slot: dict = {}
        self._queue.put((image, done, slot))
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def close(self) -> None:
        self._closed = True
        self._queue.put(None)  # wake the dispatcher
        self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._closed:
            first = self._queue.get()
            if first is None:
                continue
            pending = [first]
            deadline = time.monotonic() + self._max_wait
            while len(pending) < self._service._batch_size:
                if len(pending) in self._tier_set and self._queue.empty():
                    break  # the batch exactly fills a tier; do not wait more
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    break
                pending.append(item)
            try:
                results = self._service.detect_images([p[0] for p in pending])
                for (_, done, slot), res in zip(pending, results):
                    slot["result"] = res
                    done.set()
            except Exception as e:  # propagate to every waiter, keep serving
                for _, done, slot in pending:
                    slot["error"] = e
                    done.set()
