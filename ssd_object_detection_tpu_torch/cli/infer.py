"""CLI image inference: detect objects, save annotated copies, print the detections.

`python -m ssd_object_detection_tpu_torch.cli.infer config.yml --weights w.msgpack
--images a.jpg b.jpg --out-dir out/ [--device cuda]`

Counterpart of tools/infer.py. Reading, resizing and drawing the images need cv2,
which raises an error that names it where it is missing; drawing goes through
utils/viz.py. `--ptq` runs the int8 path (ops/quant.py), calibrated on the input images
themselves, as the JAX tool does (`--ptq-heads` quantizes the heads too).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import List, Optional, Sequence

import numpy as np

from ssd_object_detection_tpu_torch.cli.common import (
    add_ptq_flags, build_model, class_names, model_inputs, quantize_for_serving,
)
from ssd_object_detection_tpu_torch.config import load_config
from ssd_object_detection_tpu_torch.data.coco import coco_colors
from ssd_object_detection_tpu_torch.eval.predict import make_predict_fn
from ssd_object_detection_tpu_torch.eval.runner import _fetch_detections
from ssd_object_detection_tpu_torch.eval.serve import require_cv2
from ssd_object_detection_tpu_torch.ops.anchors import generate_anchors
from ssd_object_detection_tpu_torch.utils.device import resolve_device
from ssd_object_detection_tpu_torch.utils.viz import draw_bbox


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    parser = argparse.ArgumentParser(description="run ssd detection on images (PyTorch port)")
    parser.add_argument("config", type=str)
    parser.add_argument("--weights", type=str, default=None)
    parser.add_argument("--images", type=str, nargs="+", required=True)
    parser.add_argument("--out-dir", type=str, default="detections")
    parser.add_argument("--score-thresh", type=float, default=0.3)
    parser.add_argument("--iou-thresh", type=float, default=0.45)
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    add_ptq_flags(parser)
    args = parser.parse_args(argv)
    cv2 = require_cv2()

    cfg = load_config(args.config)
    model, spec = build_model(cfg, args.weights, resolve_device(args.device))
    size = spec.image_size
    names, colors = class_names(cfg), coco_colors()

    os.makedirs(args.out_dir, exist_ok=True)
    originals, batch = [], []
    for path in args.images:
        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if bgr is None:
            raise FileNotFoundError(path)
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        originals.append(rgb)
        batch.append(cv2.resize(rgb, (size, size)).astype(np.float32) / 255.0)

    if args.ptq:  # calibrated on the input images themselves
        model = quantize_for_serving(model, [model_inputs(np.stack(batch))], args.ptq_heads)
    predict = make_predict_fn(model, generate_anchors(spec.anchor_spec),
                              variances=cfg.model.loss.variances,
                              score_thresh=args.score_thresh, iou_thresh=args.iou_thresh)
    det_boxes, det_scores, det_classes, det_valid = _fetch_detections(predict(np.stack(batch)))
    results = []
    for i, path in enumerate(args.images):
        h, w = originals[i].shape[:2]
        valid = det_valid[i]
        boxes = det_boxes[i][valid] * np.array([w, h, w, h], np.float32)
        scores, classes = det_scores[i][valid], det_classes[i][valid]
        rendered = draw_bbox(originals[i], boxes, classes, names, colors, scores=scores)
        out_path = os.path.join(args.out_dir, os.path.basename(path))
        cv2.imwrite(out_path, cv2.cvtColor(rendered, cv2.COLOR_RGB2BGR))
        results.append({
            "image": path, "output": out_path, "num_detections": int(valid.sum()),
            "detections": [
                {"class": names[int(c)], "score": round(float(s), 4),
                 "box_cxcywh": [round(float(v), 1) for v in b]}
                for c, s, b in zip(classes, scores, boxes)
            ],
        })
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
