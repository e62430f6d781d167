"""CLI evaluator: `python -m ssd_object_detection_tpu_torch.cli.eval <config.yml> --weights W.msgpack`.

Counterpart of tools/eval.py: COCO-style mAP of exported weights (either package's
`.msgpack`) over the validation split, printed as one JSON line. The split is the
config's: synthetic (64 images, or `mini_batch.num_data`, in batches of 8) or COCO
val through the decode pipeline (batches of `train.batch_size`). Flags
`--max-batches`, `--score-thresh` (0.01), `--iou-thresh` (0.45) as in the JAX tool;
`--device` (default cuda; raises without a GPU) is the one it lacks. `--ptq` evaluates
through the int8 path, calibrated on `--calib-batches` (4) val batches of
`train.batch_size` (`--ptq-heads` quantizes the heads too).
`--data-parallel N > 1` (ROADMAP A12) is not ported and raises.
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import Dict, Optional, Sequence

from ssd_object_detection_tpu_torch.cli.common import (
    add_ptq_flags, build_model, calibration_batches, quantize_for_serving,
)
from ssd_object_detection_tpu_torch.config import load_config
from ssd_object_detection_tpu_torch.data.coco import open_split
from ssd_object_detection_tpu_torch.data.pipeline import CocoPipeline, PipelineConfig
from ssd_object_detection_tpu_torch.data.synthetic import SyntheticDetectionDataset
from ssd_object_detection_tpu_torch.eval.predict import make_predict_fn
from ssd_object_detection_tpu_torch.eval.runner import evaluate_batches
from ssd_object_detection_tpu_torch.ops.anchors import generate_anchors
from ssd_object_detection_tpu_torch.utils.device import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(description="evaluate ssd model (COCO-style mAP, PyTorch port)")
    parser.add_argument("config", type=str, help="yaml config file")
    parser.add_argument("--weights", type=str, default=None, help="msgpack params export")
    parser.add_argument("--max-batches", type=int, default=None)
    parser.add_argument("--score-thresh", type=float, default=0.01)
    parser.add_argument("--iou-thresh", type=float, default=0.45)
    parser.add_argument("--data-parallel", type=int, default=0, metavar="N",
                        help="not ported yet (ROADMAP A12)")
    add_ptq_flags(parser, calib_batches=True)
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    if args.data_parallel > 1:
        raise NotImplementedError("--data-parallel: sharded evaluation is not ported yet (ROADMAP A12)")

    cfg = load_config(args.config)
    device = resolve_device(args.device)
    eval_batch_size = 8 if cfg.data.dataset == "synthetic" else cfg.model.train.batch_size
    model, spec = build_model(cfg, args.weights, device)
    if args.ptq:
        calib = calibration_batches(cfg, spec, args.calib_batches, cfg.model.train.batch_size)
        model = quantize_for_serving(model, calib, args.ptq_heads)

    predict = make_predict_fn(
        model, generate_anchors(spec.anchor_spec), variances=cfg.model.loss.variances,
        iou_thresh=args.iou_thresh, score_thresh=args.score_thresh,
    )
    if cfg.data.dataset == "synthetic":
        ds = SyntheticDetectionDataset(
            num_images=cfg.data.mini_batch.num_data if cfg.data.mini_batch.enable else 64,
            image_size=spec.image_size,
            max_gt=min(cfg.data.max_gt, 8),
            num_classes=min(cfg.data.num_classes, 8),
        )
        batches = ds.batches(batch_size=eval_batch_size)
    else:
        index = open_split(
            cfg.data.dataset_root, "val",
            mini_batch=cfg.data.mini_batch.num_data if cfg.data.mini_batch.enable else 0,
        )
        batches = CocoPipeline(index, PipelineConfig(
            image_size=spec.image_size, max_gt=cfg.data.max_gt, batch_size=eval_batch_size,
            shuffle=False, num_workers=cfg.data.num_workers,
        ))

    metrics = evaluate_batches(predict, batches, num_classes=cfg.data.num_classes,
                               max_batches=args.max_batches)
    print(json.dumps(metrics), flush=True)
    return metrics


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
