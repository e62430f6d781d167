"""HTTP inference server: JPEG/PNG in, JSON detections out.

`python -m ssd_object_detection_tpu_torch.cli.serve config.yml --weights w.msgpack
[--port 8000] [--device cuda]`, or `--artifact bundle.zip` to serve an exported fused
artifact (cli/export.py --fused) with no model code or weights file. Counterpart of
tools/serve.py, with its flags; `--device` (default cuda; raises without a GPU) takes
the place of the JAX tool's platform. `--ptq` and `--ptq-heads` (ROADMAP A13) raise.

Endpoints:
  GET  /healthz  -> {"status": "ok", "model": ..., "device": ...}
  POST /detect   body = encoded image bytes (JPEG/PNG; decoding needs cv2)
                 -> {"detections": [{"box_xyxy": [x1, y1, x2, y2] pixels,
                                     "score": s, "class_id": c, "class_name": n}]}

The device runs the fused detect path (eval/serve.DetectorService); the host decodes
and packs the canvas. Concurrent requests are coalesced into one batch
(eval/serve.BatchingFrontEnd): the dispatcher drains up to --batch-size queued images,
waiting at most --max-wait-ms after the first.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

from ssd_object_detection_tpu_torch.cli.common import (
    add_ptq_flags, build_model, class_names, device_name, refuse_ptq,
)
from ssd_object_detection_tpu_torch.config import load_config
from ssd_object_detection_tpu_torch.data.coco import COCO_NAMES
from ssd_object_detection_tpu_torch.eval.serve import (
    BatchingFrontEnd, DetectorService, decode_image_bytes,
)
from ssd_object_detection_tpu_torch.ops.anchors import generate_anchors
from ssd_object_detection_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def _tiers(text: str):
    return tuple(int(t) for t in text.split(",") if t)


def build_service(args):
    """Config + weights -> (DetectorService, info dict), the model built as cli/eval.py
    builds it, so served weights match evaluated weights exactly."""
    refuse_ptq(args)
    cfg = load_config(args.config)
    device = resolve_device(args.device)
    model, spec = build_model(cfg, args.weights, device)
    service = DetectorService(
        model, generate_anchors(spec.anchor_spec), image_size=spec.image_size,
        batch_size=args.batch_size, variances=cfg.model.loss.variances,
        score_thresh=args.score_thresh, iou_thresh=args.iou_thresh,
        label_names=class_names(cfg), batch_tiers=_tiers(args.batch_tiers),
    )
    info = {"model": cfg.model.variant, "precision": cfg.model.precision,
            "device": device_name(device)}
    return service, info


def build_artifact_service(args):
    """--artifact path -> (DetectorService.from_artifact, info dict). Params, NMS knobs,
    batch sizes and canvas are all in the artifact."""
    device = resolve_device(args.device)
    with open(args.artifact, "rb") as f:
        blob = f.read()
    names = COCO_NAMES if args.names == "coco" else None
    service = DetectorService.from_artifact(blob, label_names=names, device=device)
    if len(service._tiers) == 1 and set(_tiers(args.batch_tiers)) - set(service._tiers):
        logger.warning(
            "--batch-tiers %s ignored: this artifact holds a single batch shape (%d); export "
            "a multi-tier bundle (cli/export.py --fused --tiers) to serve with batch tiers",
            args.batch_tiers, service._batch_size,
        )
    info = {"model": os.path.basename(args.artifact), "precision": "artifact",
            "batch_tiers": service._tiers, "device": device_name(device)}
    return service, info


def make_server(service, info, host: str = "127.0.0.1", port: int = 0, max_wait_ms: float = 4.0):
    """ThreadingHTTPServer wired to a DetectorService through a BatchingFrontEnd; port 0
    picks a free port. `server.frontend` is the front end, for its owner to close()."""
    frontend = BatchingFrontEnd(service, max_wait_ms=max_wait_ms)

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok", **info})
            else:
                self._reply(404, {"error": "use GET /healthz or POST /detect"})

        def do_POST(self):
            if self.path != "/detect":
                self._reply(404, {"error": "use POST /detect"})
                return
            length = int(self.headers.get("Content-Length", 0))
            if not 0 < length <= 64 * 1024 * 1024:
                self._reply(400, {"error": "missing or oversized request body"})
                return
            data = self.rfile.read(length)
            try:
                dets = frontend.submit(decode_image_bytes(data))
            except ValueError as e:
                self._reply(400, {"error": str(e)})
                return
            self._reply(200, {"detections": dets})

        def log_message(self, fmt, *a):  # through logging, not stderr
            logger.info("%s %s", self.address_string(), fmt % a)

    class Server(ThreadingHTTPServer):
        # the default listen backlog of 5 refuses a burst of simultaneous connects
        # before a worker sees it; the coalescing front end is the admission control
        request_queue_size = 128

    server = Server((host, port), Handler)
    server.frontend = frontend
    return server


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="HTTP SSD detection server (PyTorch port)")
    p.add_argument("config", type=str, nargs="?", default=None,
                   help="model config YAML (omit when using --artifact)")
    p.add_argument("--weights", type=str, default=None)
    p.add_argument("--artifact", type=str, default=None,
                   help="serve an exported fused artifact or bundle (cli/export.py --fused) "
                        "instead of building the model from config + weights")
    p.add_argument("--names", type=str, default="coco", choices=["coco", "none"],
                   help="class-name table for --artifact serving")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--batch-tiers", type=str, default="1,4",
                   help="extra batch sizes below --batch-size; a request of n images runs "
                        "at the smallest tier >= n, so the canvas upload scales with load")
    p.add_argument("--max-wait-ms", type=float, default=4.0,
                   help="coalescing window after the first queued request; dispatch is "
                        "early when the pending requests exactly fill a batch tier and the "
                        "queue is empty")
    p.add_argument("--score-thresh", type=float, default=0.3)
    p.add_argument("--iou-thresh", type=float, default=0.45)
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    add_ptq_flags(p)
    args = p.parse_args(argv)
    if args.artifact:
        refuse_ptq(args)
        service, info = build_artifact_service(args)
    elif args.config:
        service, info = build_service(args)
    else:
        p.error("either a config YAML or --artifact is required")
    service.warm()  # every batch tier once before traffic
    server = make_server(service, info, args.host, args.port, max_wait_ms=args.max_wait_ms)
    logger.info("serving %s on http://%s:%d", info, *server.server_address)
    try:
        server.serve_forever()
    finally:
        server.frontend.close()
        server.server_close()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
